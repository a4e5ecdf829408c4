"""Taxonomic profiling reports (.tre) from classification .rep files.

Port of ``ganon_tpu.report.report`` (a copy: it imports neither jax nor
pandas), the equivalent of the reference report generator
(``pirovc/ganon:src/ganon/report.py``): merges hierarchies,
redistributes LCA reads to leaves, corrects abundances by genome size,
computes cumulative lineage counts, filters (ranks, top-percentile,
min/max count, taxids, names), sorts, and emits tsv/csv/text/bioboxes.
"""

from __future__ import annotations

import copy
import pathlib
import sys
from dataclasses import dataclass, field
from math import ceil, floor

from ganon_tpu_torch import taxonomy as taxmod

DEFAULT_RANKS = [
    "domain", "phylum", "class", "order", "family", "genus", "species",
    "assembly",
]


@dataclass
class ReportConfig:
    input: list = field(default_factory=list)
    input_extension: str = "rep"
    output_prefix: str = ""
    db_prefix: list = field(default_factory=list)
    taxonomy: str = "ncbi"
    taxonomy_files: list = field(default_factory=list)
    genome_size_files: list = field(default_factory=list)
    report_type: str = "abundance"
    output_format: str = "tsv"
    sort: str = ""
    ranks: list = field(default_factory=list)
    min_count: float = 0
    max_count: float = 0
    taxids: list = field(default_factory=list)
    names: list = field(default_factory=list)
    names_with: list = field(default_factory=list)
    top_percentile: float = 0
    no_orphan: bool = False
    normalize: bool = False
    split_hierarchy: bool = False
    skip_hierarchy: list = field(default_factory=list)
    keep_hierarchy: list = field(default_factory=list)
    skip_genome_size: bool = False
    quiet: bool = True
    verbose: bool = False


def _log(msg, quiet):
    if not quiet:
        print(msg, file=sys.stderr)


def report(cfg: ReportConfig) -> bool:
    rep_files = _expand_inputs(cfg.input, cfg.input_extension)
    if not rep_files:
        raise ValueError("no .rep input files found")

    tax_kwargs = dict(root_node="1", root_name="root", root_rank="root")
    genome_sizes = {}
    if cfg.db_prefix:
        dbp = [p if p.endswith(".tax") else p + ".tax" for p in cfg.db_prefix]
        tax = taxmod.load_tax_files(dbp, **tax_kwargs)
        if cfg.report_type in ("abundance", "corr"):
            genome_sizes = taxmod.parse_genome_size_tax(dbp)
    else:
        if cfg.taxonomy == "skip":
            tax = taxmod.dummy_tax(**tax_kwargs)
        elif cfg.taxonomy.startswith("ncbi"):
            tax = taxmod.load_ncbi(files=cfg.taxonomy_files, **tax_kwargs)
        elif cfg.taxonomy.startswith("gtdb"):
            tax = taxmod.load_gtdb(files=cfg.taxonomy_files, **tax_kwargs)
        else:
            raise ValueError(f"unknown taxonomy: {cfg.taxonomy}")
        if cfg.report_type in ("abundance", "corr"):
            if cfg.skip_genome_size or not cfg.genome_size_files:
                leaves_sizes = {}
            else:
                leaves_sizes = taxmod.parse_genome_size_files(
                    cfg.genome_size_files, cfg.taxonomy
                )
            genome_sizes = taxmod.estimate_genome_sizes(
                tax.leaves(), tax, leaves_sizes
            )

    default_ranks = [tax.root_name] + DEFAULT_RANKS
    if cfg.ranks and cfg.ranks[0] == "all":
        fixed_ranks = []
    elif not cfg.ranks or cfg.ranks == [""]:
        fixed_ranks = default_ranks
    else:
        fixed_ranks = [tax.root_name] + list(cfg.ranks)

    any_rep = False
    for rep_file in rep_files:
        reports, counts = parse_rep(rep_file, cfg.normalize)
        if not reports:
            _log(f" - nothing to report for {rep_file}", cfg.quiet)
            continue
        if cfg.skip_hierarchy or cfg.keep_hierarchy:
            reports = remove_hierarchy(
                reports, counts, cfg.skip_hierarchy, cfg.keep_hierarchy, cfg.quiet
            )

        p = pathlib.Path(rep_file)
        rep_prefix = str(pathlib.Path(p.parent, p.stem))
        if cfg.output_prefix:
            out_prefix = (
                cfg.output_prefix
                if len(rep_files) == 1
                else cfg.output_prefix + str(p.stem)
            )
        else:
            out_prefix = rep_prefix

        if cfg.split_hierarchy:
            for h in reports:
                if h in cfg.skip_hierarchy:
                    continue
                of = out_prefix + "." + h + ".tre"
                if build_report(
                    {h: reports[h]}, counts, tax, genome_sizes, of,
                    fixed_ranks, default_ranks, cfg, rep_file,
                ):
                    any_rep = True
        else:
            of = out_prefix + ".tre"
            if build_report(
                reports, counts, tax, genome_sizes, of,
                fixed_ranks, default_ranks, cfg, rep_file,
            ):
                any_rep = True
    return any_rep


def _expand_inputs(inputs, extension):
    import glob
    import os

    ext = extension.lstrip(".")
    out = []
    for i in inputs:
        if os.path.isdir(i):
            out.extend(sorted(glob.glob(os.path.join(i, f"*.{ext}"))))
        elif os.path.isfile(i):
            out.append(i)
    return out


def parse_rep(rep_file, normalize=False):
    """Parse .rep rows + totals trailer (report.py:163-209)."""
    counts = {}
    reports = {}
    total_direct_matches = 0
    classified_reads = 0
    unclassified_reads = 0
    with open(rep_file) as f:
        for line in f:
            fields = line.rstrip("\n").split("\t")
            if fields[0] == "#total_classified":
                classified_reads = int(fields[1])
            elif fields[0] == "#total_unclassified":
                unclassified_reads = int(fields[1]) if not normalize else 0
            else:
                hierarchy, target = fields[0], fields[1]
                direct, unique, lca = int(fields[2]), int(fields[3]), int(fields[4])
                rep = reports.setdefault(hierarchy, {})
                counts.setdefault(hierarchy, {"matches": 0, "reads": 0})
                t = rep.setdefault(
                    target,
                    {"direct_matches": 0, "unique_reads": 0, "lca_reads": 0},
                )
                t["direct_matches"] += direct
                t["unique_reads"] += unique
                t["lca_reads"] += lca
                counts[hierarchy]["matches"] += direct
                counts[hierarchy]["reads"] += unique + lca
                total_direct_matches += direct
    counts["total"] = {
        "matches": total_direct_matches,
        "reads": classified_reads,
        "unclassified": unclassified_reads,
    }
    return reports, counts


def merge_reports(reports):
    merged = {}
    for rep in reports.values():
        for target, v in rep.items():
            m = merged.setdefault(
                target, {"unique_reads": 0, "lca_reads": 0, "direct_matches": 0}
            )
            m["unique_reads"] += v["unique_reads"]
            m["lca_reads"] += v["lca_reads"]
            m["direct_matches"] += v["direct_matches"]
    return merged


def count_targets(merged_rep, report_type):
    res = {}
    for target, v in merged_rep.items():
        c = (
            v["direct_matches"]
            if report_type == "matches"
            else v["unique_reads"] + v["lca_reads"]
        )
        if c:
            res[target] = c
    return res


def redistribute_shared_reads(merged_rep, tax):
    """Move lca_reads down to leaves proportionally to unique reads
    (fallback: direct matches); floor + ranked leftover top-up
    (report.py:507-575)."""
    for target in list(merged_rep.keys()):
        if merged_rep[target]["lca_reads"] <= 0:
            continue
        leaves = tax.leaves(target)
        if not leaves or leaves == [target]:
            continue
        redist_field = "unique_reads"
        total_leaves = 0
        leaves_unique = set()
        for leaf in leaves:
            if leaf in merged_rep and merged_rep[leaf]["unique_reads"] > 0:
                leaves_unique.add(leaf)
                total_leaves += merged_rep[leaf]["unique_reads"]
        if not leaves_unique:
            redist_field = "direct_matches"
            for leaf in leaves:
                if leaf in merged_rep and merged_rep[leaf]["direct_matches"] > 0:
                    leaves_unique.add(leaf)
                    total_leaves += merged_rep[leaf]["direct_matches"]
        if not leaves_unique:
            continue
        total_redist = 0
        for leaf in leaves_unique:
            red = floor(
                merged_rep[target]["lca_reads"]
                * (merged_rep[leaf][redist_field] / total_leaves)
            )
            total_redist += red
            merged_rep[leaf]["lca_reads"] += red
        left_overs = merged_rep[target]["lca_reads"] - total_redist
        if left_overs:
            for leaf in sorted(
                leaves_unique,
                key=lambda x: (
                    -merged_rep[x]["unique_reads"],
                    -merged_rep[x]["direct_matches"],
                    x,
                ),
            )[:left_overs]:
                merged_rep[leaf]["lca_reads"] += 1
        merged_rep[target]["lca_reads"] = 0


def cummulative_sum_tree(target_count, tax):
    cum = {}
    for target, count in target_count.items():
        for t in tax.lineage(target):
            cum[t] = cum.get(t, 0) + count
    return cum


def correct_genome_size(target_counts, genome_sizes, tax, default_ranks):
    """Genome-size abundance correction over default ranks
    (report.py:578-653)."""
    ranked_counts = {}
    lost_targets = {}
    total_rank_ratio = {r: 0 for r in default_ranks}
    total_rank_count = {r: 0 for r in default_ranks}
    root_gs = genome_sizes.get(tax.root_node, 1)
    for target, count in target_counts.items():
        closest = tax.closest_parent(target, ranks=default_ranks)
        ranked_counts[closest] = ranked_counts.get(closest, 0) + count
        if closest != target:
            lost_targets[target] = closest
        gs = genome_sizes.get(closest, root_gs)
        rank = tax.rank(closest)
        total_rank_ratio[rank] = total_rank_ratio.get(rank, 0) + count / gs
        total_rank_count[rank] = total_rank_count.get(rank, 0) + count

    corr_counts = {}
    for node in ranked_counts:
        rank = tax.rank(node)
        gs = genome_sizes.get(node, root_gs)
        corr_counts[node] = total_rank_count[rank] * (
            (ranked_counts[node] / gs) / total_rank_ratio[rank]
        )
    assert sum(target_counts.values()) == round(sum(corr_counts.values())), (
        "invalid number of counts after correction"
    )

    corr_tree = cummulative_sum_tree(corr_counts, tax)
    for target, closest in lost_targets.items():
        for t in tax.lineage(target, root_node=closest)[1:]:
            corr_tree[t] = corr_tree.get(t, 0) + target_counts[target] * (
                corr_counts[closest] / ranked_counts[closest]
            )
    return corr_tree


def filter_report(
    tree_cum_counts, tree_cum_perc, tax, fixed_ranks, default_ranks,
    orphan_nodes, cfg,
):
    filtered = {}
    rank_cutoff = {}
    if cfg.top_percentile:
        rank_perc = {r: [] for r in default_ranks}
        for node, perc in sorted(
            tree_cum_perc.items(), key=lambda x: x[1], reverse=True
        ):
            r = tax.rank(node)
            if r in default_ranks:
                rank_perc[r].append(perc)
        for rank, percs in rank_perc.items():
            top = ceil(cfg.top_percentile * len(percs))
            if top < len(percs):
                rank_cutoff[rank] = percs[top]

    for node, cum_count in tree_cum_counts.items():
        rank = tax.rank(node)
        if node == tax.root_node:
            filtered[node] = cum_count
            continue
        if node in orphan_nodes and cfg.no_orphan:
            continue
        if fixed_ranks and rank not in fixed_ranks:
            continue
        if rank in rank_cutoff and tree_cum_perc[node] <= rank_cutoff[rank]:
            continue
        if cfg.min_count:
            if cfg.min_count > 1 and cum_count < cfg.min_count:
                continue
            if cfg.min_count < 1 and tree_cum_perc[node] < cfg.min_count:
                continue
        if cfg.max_count:
            if cfg.max_count > 1 and cum_count > cfg.max_count:
                continue
            if cfg.max_count < 1 and tree_cum_perc[node] > cfg.max_count:
                continue
        if cfg.taxids and not any(t in cfg.taxids for t in tax.lineage(node)):
            continue
        if cfg.names and tax.name(node) not in cfg.names:
            continue
        if cfg.names_with and not any(n in tax.name(node) for n in cfg.names_with):
            continue
        filtered[node] = cum_count
    return filtered


def sort_report(filtered_cum_counts, tree_cum_perc, sort, fixed_ranks, tax,
                merged_rep):
    if not sort:
        if not fixed_ranks:
            nodes = sorted(filtered_cum_counts, key=lambda k: tax.lineage(k))
        else:
            sfr = fixed_ranks + [tax.undefined_rank]
            nodes = sorted(
                filtered_cum_counts,
                key=lambda k: (sfr.index(tax.rank(k)), -tree_cum_perc[k]),
            )
    elif sort == "lineage":
        nodes = sorted(filtered_cum_counts, key=lambda k: tax.lineage(k))
    elif sort == "rank":
        if not fixed_ranks:
            nodes = sorted(
                filtered_cum_counts,
                key=lambda k: (tax.rank(k), -tree_cum_perc[k]),
            )
        else:
            sfr = fixed_ranks + [tax.undefined_rank]
            nodes = sorted(
                filtered_cum_counts,
                key=lambda k: (sfr.index(tax.rank(k)), -tree_cum_perc[k]),
            )
    elif sort == "unique":
        nodes = sorted(
            filtered_cum_counts,
            key=lambda k: (
                -merged_rep[k]["unique_reads"] if k in merged_rep else 0,
                -tree_cum_perc[k],
            ),
        )
    elif sort == "count":
        nodes = sorted(filtered_cum_counts, key=lambda k: -filtered_cum_counts[k])
    else:
        raise ValueError(f"invalid sort: {sort}")
    nodes.insert(0, nodes.pop(nodes.index(tax.root_node)))
    return nodes


def remove_hierarchy(reports, counts, skip, keep, quiet):
    for h in list(reports.keys()):
        if h in skip or (keep and h not in keep):
            del reports[h]
    return reports


def build_report(
    reports, counts, full_tax, genome_sizes, output_file, fixed_ranks,
    default_ranks, cfg, rep_file,
):
    if cfg.report_type == "matches":
        total = counts["total"]["matches"]
    else:
        total = counts["total"]["reads"] + counts["total"]["unclassified"]
    if not total:
        return False

    merged_rep = (
        list(reports.values())[0] if len(reports) == 1 else merge_reports(reports)
    )

    tax = copy.deepcopy(full_tax)
    tax.filter(list(merged_rep.keys()))
    orphan_nodes = set()
    for node in merged_rep.keys():
        if tax.latest(node) == tax.undefined_node:
            tax.add(node, tax.root_node)
            orphan_nodes.add(node)
    tax.check_consistency()
    tax.build_lineages()

    if cfg.report_type in ("abundance", "dist"):
        redistribute_shared_reads(merged_rep, tax)

    target_counts = count_targets(merged_rep, cfg.report_type)
    tree_cum_counts = cummulative_sum_tree(target_counts, tax)

    if cfg.report_type in ("abundance", "corr"):
        corr = correct_genome_size(target_counts, genome_sizes, tax, default_ranks)
        tree_cum_perc = {n: c / total for n, c in corr.items()}
    else:
        tree_cum_perc = {n: c / total for n, c in tree_cum_counts.items()}

    filtered_cum_counts = filter_report(
        tree_cum_counts, tree_cum_perc, tax, fixed_ranks, default_ranks,
        orphan_nodes, cfg,
    )
    if not filtered_cum_counts:
        return False

    sorted_nodes = sort_report(
        filtered_cum_counts, tree_cum_perc, cfg.sort, fixed_ranks, tax, merged_rep
    )

    out = open(output_file, "w")
    output_rows = []
    sep = "," if cfg.output_format == "csv" else "\t"

    if cfg.report_type != "matches" and not cfg.normalize:
        unc = counts["total"]["unclassified"]
        line = [
            "unclassified", "-", "-", "unclassified", "0", "0", "0",
            str(unc), "%.5f" % ((unc / total) * 100),
        ]
        if cfg.output_format in ("tsv", "csv"):
            out.write(sep.join(line) + "\n")
        elif cfg.output_format == "text":
            output_rows.append(line)

    if cfg.output_format == "bioboxes":
        out.write("@Version:0.10.0\n")
        out.write(f"@SampleID:{rep_file} {','.join(reports.keys())}\n")
        out.write("@Ranks:" + "|".join(fixed_ranks[1:]) + "\n")
        out.write("@Taxonomy:" + ",".join(str(s) for s in tax.sources) + "\n")
        out.write("@@TAXID\tRANK\tTAXPATH\tTAXPATHSN\tPERCENTAGE\n")

    for node in sorted_nodes:
        cum_count = filtered_cum_counts[node]
        cum_perc = tree_cum_perc[node] * 100
        unique = shared = 0
        if node in merged_rep:
            unique = merged_rep[node]["unique_reads"]
            if cfg.report_type == "matches":
                shared = (
                    merged_rep[node]["direct_matches"]
                    - merged_rep[node]["unique_reads"]
                )
            else:
                shared = merged_rep[node]["lca_reads"]
        children = cum_count - unique - shared
        rank = tax.rank(node)

        if fixed_ranks:
            ridx = fixed_ranks.index(rank)
            lineage = tax.lineage(node, ranks=fixed_ranks[: ridx + 1])
        else:
            lineage = tax.lineage(node)

        if cfg.output_format == "bioboxes":
            if node == tax.root_node:
                continue
            if fixed_ranks:
                ridx = fixed_ranks.index(rank)
                name_lineage = tax.name_lineage(node, ranks=fixed_ranks[: ridx + 1])
            else:
                name_lineage = tax.name_lineage(node)
            row = [
                node, rank, "|".join(lineage[1:]), "|".join(name_lineage[1:]),
                "%g" % cum_perc,
            ]
            out.write("\t".join(row) + "\n")
        else:
            row = [
                rank, node, "|".join(lineage), tax.name(node), str(unique),
                str(shared), str(children), str(cum_count), "%.5f" % cum_perc,
            ]
            if cfg.output_format == "text":
                output_rows.append(row)
            else:
                out.write(sep.join(row) + "\n")

    if cfg.output_format == "text" and output_rows:
        widths = [
            max(len(r[i]) for r in output_rows)
            for i in range(len(output_rows[0]))
        ]
        for row in output_rows:
            out.write(
                "\t".join(f.ljust(widths[i]) for i, f in enumerate(row)) + "\n"
            )
    out.close()
    return True
