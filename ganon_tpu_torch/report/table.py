"""Multi-sample tables from .tre reports.

Port of ``ganon_tpu.report.table`` (a copy), the equivalent of the
reference table generator (``pirovc/ganon:src/ganon/table.py``): merges
many .tre files into one
samples x taxa matrix with count/percentage values, min/max/taxid/name
filters, top-sample/top-all/min-frequency selection, multi-rank count
de-cumulation, and optional transpose/zero-trim.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field


@dataclass
class TableConfig:
    input: list = field(default_factory=list)
    input_extension: str = "tre"
    output_file: str = ""
    output_format: str = "tsv"  # tsv | csv
    output_value: str = "counts"  # counts | percentage
    rank: str = ""
    header: str = "name"  # name | taxid | lineage
    unclassified_label: str = ""
    filtered_label: str = ""
    skip_zeros: bool = False
    transpose: bool = False
    no_root: bool = False
    min_count: float = 0
    max_count: float = 0
    taxids: list = field(default_factory=list)
    names: list = field(default_factory=list)
    names_with: list = field(default_factory=list)
    top_sample: int = 0
    top_all: int = 0
    min_frequency: float = 0
    quiet: bool = True
    verbose: bool = False


def table(cfg: TableConfig) -> bool:
    from ganon_tpu_torch.report.report import _expand_inputs

    tre_files = _expand_inputs(cfg.input, cfg.input_extension)
    if not tre_files:
        raise ValueError("no .tre input files found")

    reports, total_taxa = parse_reports(tre_files, cfg.rank)
    root_nodes = {rep["root_node"] for rep in reports.values()}
    if len(root_nodes) > 1:
        raise ValueError("input files should share the same root node")
    root_node = root_nodes.pop()

    filter_reports(reports, cfg, root_node)
    if cfg.top_sample:
        select_top_sample(reports, cfg.top_sample, root_node)
    elif cfg.top_all:
        select_top_all(reports, cfg.top_all, root_node)
    if cfg.min_frequency:
        mf = (
            int(len(reports) * cfg.min_frequency)
            if cfg.min_frequency < 1
            else cfg.min_frequency
        )
        select_frequency(reports, mf)

    if not cfg.rank:
        adjust_counts_ranks(reports, cfg.no_root, root_node)
    if cfg.no_root:
        for rep in reports.values():
            for t in rep["count"]:
                if rep["lineage"][t] and rep["lineage"][t][0] == root_node:
                    del rep["lineage"][t][0]

    out_table = build_table(reports, cfg)
    if cfg.skip_zeros:
        out_table = trim_table(out_table)
        out_table = transpose(trim_table(transpose(out_table)))
    if not cfg.transpose:
        out_table = transpose(out_table)

    sep = "\t" if cfg.output_format == "tsv" else ","
    with open(cfg.output_file, "w") as f:
        for line in out_table:
            f.write(sep.join(str(v) for v in line) + "\n")
    return True


def parse_reports(tre_files, rank):
    reports = {}
    total_taxa = set()
    for tre_file in tre_files:
        count, lineage, name, total, unclassified, root_node = parse_tre_rank(
            tre_file, rank
        )
        total_taxa.update(count.keys())
        reports[tre_file] = {
            "label": tre_file,
            "count": count,
            "lineage": lineage,
            "name": name,
            "total": total,
            "unclassified": unclassified,
            "filtered": 0,
            "root_node": root_node,
        }
    return reports, len(total_taxa)


def parse_tre_rank(tre_file, selected_rank):
    count, lineage, name = {}, {}, {}
    unclassified = classified = 0
    root_node = "1"
    with open(tre_file) as f:
        for line in f:
            fields = line.rstrip("\n").split("\t")
            rank, taxid, lin, taxa_name = fields[0], fields[1], fields[2], fields[3]
            cum_assign = fields[7]
            if rank == "unclassified":
                unclassified = int(cum_assign)
                continue
            elif rank == "root":
                classified = int(cum_assign)
                root_node = taxid
                if selected_rank:
                    continue
            elif selected_rank and rank != selected_rank:
                continue
            lineage[taxid] = lin.split("|")
            name[taxid] = taxa_name
            count[taxid] = int(cum_assign)
    return count, lineage, name, unclassified + classified, unclassified, root_node


def _drop(rep, taxid):
    rep["filtered"] += rep["count"][taxid]
    del rep["count"][taxid]
    del rep["lineage"][taxid]
    del rep["name"][taxid]


def filter_reports(reports, cfg, root_node):
    kept = set()
    for rep in reports.values():
        for taxid in list(rep["count"]):
            count = rep["count"][taxid]
            filtered = False
            if cfg.min_count:
                if cfg.min_count > 1 and count < cfg.min_count:
                    filtered = True
                elif cfg.min_count < 1 and (count / rep["total"]) < cfg.min_count:
                    filtered = True
            if cfg.max_count:
                if cfg.max_count > 1 and count > cfg.max_count:
                    filtered = True
                elif cfg.max_count < 1 and (count / rep["total"]) > cfg.max_count:
                    filtered = True
            if cfg.taxids and not any(t in cfg.taxids for t in rep["lineage"][taxid]):
                filtered = True
            elif cfg.names and rep["name"][taxid] not in cfg.names:
                filtered = True
            elif cfg.names_with and not any(
                n in rep["name"][taxid] for n in cfg.names_with
            ):
                filtered = True
            if filtered and taxid != root_node:
                _drop(rep, taxid)
            else:
                kept.add(taxid)
    return len(kept)


def select_top_sample(reports, top_sample, root_node):
    kept = {root_node}
    for rep in reports.values():
        i = 0
        for taxid, count in sorted(
            rep["count"].items(), key=lambda x: x[1], reverse=True
        ):
            if taxid == root_node:
                continue
            if i < top_sample:
                kept.add(taxid)
                i += 1
                continue
            _drop(rep, taxid)
    return len(kept)


def select_top_all(reports, top_all, root_node):
    total_counts = get_total_counts(reports)
    top = {root_node}
    i = 0
    for taxid in sorted(
        total_counts, key=lambda k: total_counts[k]["sum_percentage"], reverse=True
    ):
        if taxid == root_node:
            continue
        if i < top_all:
            top.add(taxid)
            i += 1
    kept = set()
    for rep in reports.values():
        for taxid in list(rep["count"]):
            if taxid in top:
                kept.add(taxid)
            else:
                _drop(rep, taxid)
    return len(kept)


def select_frequency(reports, min_frequency):
    ok = {
        t for t, v in get_total_counts(reports).items()
        if v["frequency"] >= min_frequency
    }
    kept = set()
    for rep in reports.values():
        for taxid in list(rep["count"]):
            if taxid in ok:
                kept.add(taxid)
            else:
                _drop(rep, taxid)
    return len(kept)


def get_total_counts(reports):
    total = {}
    for rep in reports.values():
        for taxid, count in rep["count"].items():
            e = total.setdefault(taxid, {"sum_percentage": 0, "frequency": 0})
            e["sum_percentage"] += count / rep["total"]
            e["frequency"] += 1
    return total


def adjust_counts_ranks(reports, no_root, root_node):
    """De-cumulate multi-rank counts (table.py:312-335)."""
    for rep in reports.values():
        for t in sorted(
            rep["lineage"], key=lambda k: len(rep["lineage"][k]), reverse=True
        ):
            for parent in rep["lineage"][t][:-1]:
                if parent in rep["count"]:
                    rep["count"][parent] -= rep["count"][t]
        if no_root:
            rep["unclassified"] += rep["count"][root_node]
            del rep["count"][root_node]
            del rep["lineage"][root_node]
            del rep["name"][root_node]


def build_table(reports, cfg):
    total_counts = get_total_counts(reports)
    sorted_taxids = sorted(total_counts.keys())

    if cfg.header == "taxid":
        header = [""] + list(sorted_taxids)
    elif cfg.header == "lineage":
        lineages = {}
        for rep in reports.values():
            lineages.update(rep["lineage"])
        header = [""] + ["|".join(lineages[t]) for t in sorted_taxids]
    else:
        names = {}
        for rep in reports.values():
            names.update(rep["name"])
        header = [""] + [names[t] for t in sorted_taxids]
    if cfg.unclassified_label:
        header.append(cfg.unclassified_label)
    if cfg.filtered_label and cfg.filtered_label != cfg.unclassified_label:
        header.append(cfg.filtered_label)

    out_table = [header]
    for file in sorted(reports):
        rep = reports[file]
        line = [rep["label"]]
        for taxid in sorted_taxids:
            v = rep["count"].get(taxid, 0)
            if cfg.output_value == "percentage":
                v = v / rep["total"]
            line.append(v)
        unc = (
            rep["unclassified"] / rep["total"]
            if cfg.output_value == "percentage"
            else rep["unclassified"]
        )
        fil = (
            rep["filtered"] / rep["total"]
            if cfg.output_value == "percentage"
            else rep["filtered"]
        )
        if cfg.unclassified_label and cfg.unclassified_label != cfg.filtered_label:
            line.append(unc)
        if cfg.filtered_label:
            if cfg.filtered_label == cfg.unclassified_label:
                line.append(unc + fil)
            else:
                line.append(fil)
        out_table.append(line)
    return out_table


def trim_table(tbl):
    out = [tbl[0]]
    for line in tbl[1:]:
        vals = line[1:]
        if vals and max(vals) > 0:
            out.append(line)
    return out


def transpose(tbl):
    return list(map(list, zip(*tbl)))
