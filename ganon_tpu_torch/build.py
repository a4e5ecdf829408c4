"""``build-custom`` and ``update`` orchestration without pandas.

Port of ``ganon_tpu.build``: parse the input files or sequences, resolve
their taxonomy (NCBI, GTDB or custom; ``--convert-taxonomy`` to another),
write ``.tax``, ``target_info.tsv`` and ``.info.tsv``, run the build
(:func:`~ganon_tpu_torch.index.builder.run_build` on the card, or
:func:`~ganon_tpu_torch.index.hibf.run_build_hibf`), keep resume states
and save the configuration; ``update`` rebuilds a database from its saved
configuration, on a new snapshot when it was made by ``build``. The files
equal the JAX package's byte for byte.

What is not local is fetched as the JAX package fetches it: the NCBI
taxdump, the GTDB taxonomy and the genome-size files through
:mod:`ganon_tpu_torch.acquire` (``local_dir`` points them at a local copy
of the repository tree), the assembly_summary and accession2taxid
prefixes from ``--ncbi-url`` (``file://`` URLs work), and sequence
information from NCBI e-utils (:mod:`ganon_tpu_torch.eutils`; the
``eutils_url`` environment variable names the endpoint). One difference
by design: the taxonomy ``--convert-taxonomy`` fetches lands in the
build's folder, where the JAX package writes it to the working directory.

The table the JAX package keeps as a DataFrame indexed by target is an
ordered ``{target: row}`` dict here, each row a dict of the other
:data:`INFO_COLS` with ``None`` for a missing value; the pandas steps
are written out (``dropna``, ``drop_duplicates``, the inner merge on
target, ``DataFrame.update``'s non-null writes, ``apply``, ``to_csv``'s
empty NaN).
"""

from __future__ import annotations

import csv
import gzip
import os
import pickle
import re
import shutil

import numpy as np
import torch

from ganon_tpu_torch import taxonomy as taxmod
from ganon_tpu_torch import trace
from ganon_tpu_torch.index.builder import BuildConfig, run_build
from ganon_tpu_torch.util import (
    check_file,
    clear_states,
    download,
    load_state,
    print_log,
    rm_files,
    save_state,
    set_output_folder,
    validate_input_files,
)

INFO_COLS = ["file", "target", "node", "specialization", "specialization_name"]
CHOICES_LEVEL = ["assembly", "custom"]
CHOICES_INPUT_TARGET = ["file", "sequence"]
ASSEMBLY_SUMMARY_PREFIXES = (
    "refseq", "genbank", "refseq_historical", "genbank_historical",
)
ACC2TXID_PREFIXES = (
    "nucl_gb", "nucl_wgs", "nucl_est", "nucl_gss", "pdb", "prot",
    "dead_nucl", "dead_wgs", "dead_prot",
)
ASSEMBLY_ACCESSION_RE = re.compile(r"GC[A|F]_[0-9]+\.[0-9]+")
# strings pandas.read_csv reads as NaN by default
_NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})


def _na(v) -> str | None:
    return None if v is None or v in _NA_STRINGS else v


def _tsv_rows(path: str, skip: int = 0):
    """Tab-split lines of a (gzip) text file: non-blank lines after the
    first ``skip``."""
    op = gzip.open if str(path).endswith(".gz") else open
    with op(path, "rt") as f:
        for i, line in enumerate(f):
            if i < skip:
                continue
            line = line.rstrip("\r\n")
            if line:
                yield line.split("\t")


# --------------------------------------------------------------------------
# input parsing


def _new_row(file=None, target=None) -> dict:
    return {"file": file, "target": target, "node": None,
            "specialization": None, "specialization_name": None}


def parse_input_file(input_file, input_target, quiet=True) -> list[dict]:
    """--input-file TSV with 1..5 columns (build_update.py:586-610)."""
    rows = []
    ncols = None
    for fields in _tsv_rows(input_file):
        if ncols is None:
            ncols = len(fields)
        if len(fields) > ncols:
            raise ValueError(f"{input_file}: expected {ncols} fields, saw "
                             f"{len(fields)}")
        row = _new_row()
        for col, v in zip(INFO_COLS, fields):
            row[col] = _na(v)
        rows.append(row)
    if all(r["target"] is None for r in rows) and input_target == "file":
        for r in rows:
            r["target"] = os.path.basename(r["file"])
    files = list(dict.fromkeys(r["file"] for r in rows))
    valid = set(validate_input_files(files, "", quiet))
    if len(files) - len(valid) > 0:
        rows = [r for r in rows if r["file"] in valid]
        print_log(f" - {len(files) - len(valid)} invalid files skipped",
                  quiet)
    return rows


def parse_file_accession(input_files) -> list[dict]:
    """Assembly accession from the file name, else its basename
    (tax_util.py:55-74)."""
    rows = []
    for file in input_files:
        m = ASSEMBLY_ACCESSION_RE.search(file)
        rows.append(_new_row(file, m.group() if m else os.path.basename(file)))
    return rows


def parse_sequence_accession(input_files, build_output_folder) -> list[dict]:
    """One fasta per sequence; target = the id up to the first space
    (tax_util.py:11-52)."""
    from ganon_tpu_torch.io.sequence import SequenceReader

    rows = []
    n_folders = 10
    for sub in range(n_folders):
        os.makedirs(os.path.join(build_output_folder, str(sub)), exist_ok=True)
    i = 0
    for file in input_files:
        for header, seq in SequenceReader(file):
            seqid = header.split(" ")[0]
            out = os.path.join(build_output_folder, str(i % n_folders),
                               seqid + ".fna")
            with open(out, "w") as f:
                f.write(f">{header}\n{seq}\n")
            rows.append(_new_row(out, seqid))
            i += 1
    return rows


def load_input(cfg, input_files, build_output_folder) -> dict[str, dict]:
    """{target: row} from --input-file or --input (build_update.py:
    611-694), unique targets in first-appearance order."""
    if cfg.input_file:
        rows = parse_input_file(cfg.input_file, cfg.input_target, cfg.quiet)
        if cfg.input_target == "sequence":
            seqs = parse_sequence_accession(
                list(dict.fromkeys(r["file"] for r in rows)),
                build_output_folder)
            by_target: dict = {}
            for s in seqs:
                by_target.setdefault(s["target"], []).append(s["file"])
            # an inner merge on target: left order, then right order
            rows = [dict(r, file=f) for r in rows
                    for f in by_target.get(r["target"], ())]
    elif cfg.input_target == "sequence":
        rows = parse_sequence_accession(input_files, build_output_folder)
    else:
        rows = parse_file_accession(input_files)

    info: dict[str, dict] = {}
    for r in rows:
        if r["target"] is None or r["target"] in info:
            continue
        info[r["target"]] = {c: r[c] for c in INFO_COLS if c != "target"}
    print_log(f" - {len(info)} unique entries", cfg.quiet)
    return info


def _update(info: dict, other: dict) -> None:
    """``DataFrame.update``: non-null values of ``other`` ({target:
    {col: value}}) overwrite ``info``'s, for targets and columns it has."""
    for target, vals in other.items():
        row = info.get(target)
        if row is None:
            continue
        for col, v in vals.items():
            if col in row and v is not None:
                row[col] = v


# --------------------------------------------------------------------------
# taxonomy resolution


def load_taxonomy(cfg, build_output_folder=None):
    """The taxonomy of ``cfg.taxonomy``: from ``--taxonomy-files``, else
    the NCBI taxdump or the GTDB files fetched into the build folder."""
    from ganon_tpu_torch import acquire

    tax_ver = cfg.taxonomy.split("-")
    folder = build_output_folder or "."
    if tax_ver[0] == "ncbi":
        tax = taxmod.load_ncbi(files=cfg.taxonomy_files or [
            acquire.fetch_taxdump(folder, cfg.quiet)])
    elif tax_ver[0] == "gtdb":
        tax = taxmod.load_gtdb(files=cfg.taxonomy_files
                               or acquire.fetch_gtdb_tax(folder, cfg.quiet))
    else:
        raise ValueError(f"unknown taxonomy: {cfg.taxonomy}")
    if cfg.level not in [None, "", "leaves"] + CHOICES_LEVEL:
        if cfg.level not in tax.ranks():
            print_log(
                f" - {cfg.level} not found in taxonomic ranks, changing to "
                "--level 'leaves'",
                cfg.quiet,
            )
            cfg.level = "leaves"
    return tax


def _local_or_fetched(cfg, entries, prefixes, url_of, folder) -> list[str]:
    """``entries`` with each prefix of ``prefixes`` replaced by the file
    fetched from ``--ncbi-url`` (``url_of(base, prefix)``), the fetched
    files last; only the non-empty files."""
    files, urls = [], []
    base = getattr(cfg, "ncbi_url", "https://ftp.ncbi.nlm.nih.gov/").rstrip(
        "/")
    for entry in entries:
        if entry in prefixes:
            urls.append(url_of(base, entry))
        else:
            files.append(entry)
    if urls:
        files.extend(download(urls, folder or "."))
    return [f for f in files if check_file(f)]


def get_file_info(cfg, info, tax, build_output_folder=None) -> None:
    """Taxids (and the assembly specialization) of file accessions
    (tax_util.get_file_info:227-281): assembly_summary files or prefixes
    for NCBI, the taxonomy files' accessions for GTDB."""
    if cfg.taxonomy.startswith("gtdb"):
        _update(info, get_gtdb_target_node(tax, cfg.level))
        return
    files = _local_or_fetched(
        cfg, cfg.ncbi_file_info, ASSEMBLY_SUMMARY_PREFIXES,
        lambda base, e: (f"{base}/genomes/{e.split('_')[0]}"
                         f"/assembly_summary_{e}.txt"),
        build_output_folder)
    if not files:
        raise ValueError(
            "no valid assembly_summary file(s) via --ncbi-file-info"
        )
    counts = parse_assembly_summary(info, files, cfg.level)
    for f, cnt in counts.items():
        print_log(f" - {cnt} entries found in {os.path.basename(f)}", cfg.quiet)


def get_gtdb_target_node(tax, level) -> dict:
    """{accession: {node[, specialization, specialization_name]}} from the
    GTDB taxonomy files (tax_util.get_gtdb_target_node:283-315)."""
    rows = {}
    for source in getattr(tax, "sources", []):
        for fields in _tsv_rows(source):
            if len(fields) < 2:
                continue
            acc = fields[0]
            acc = acc[3:] if acc[:3] in ("RS_", "GB_") else acc
            rows[acc] = {"node": fields[1].split(";")[-1].strip()}
    if level == "assembly":
        for acc, r in rows.items():
            r["specialization"] = acc
            r["specialization_name"] = tax.name(r["node"])
    return rows


MAX_SEQS_EUTILS = 50000


def get_sequence_info(cfg, info, build_output_folder=None) -> None:
    """Taxids (and the assembly specialization) of sequence accessions
    (tax_util.get_sequence_info:318-437): NCBI e-utils when asked, or by
    default for at most :data:`MAX_SEQS_EUTILS` sequences; else
    accession2taxid files or prefixes, then e-utils for ``--level
    assembly``."""
    from ganon_tpu_torch.eutils import run_eutils

    if not cfg.ncbi_sequence_info:
        mode = (["eutils"] if len(info) <= MAX_SEQS_EUTILS
                else ["nucl_gb", "nucl_wgs"])
    elif "eutils" in cfg.ncbi_sequence_info:
        mode = ["eutils"]
    else:
        mode = list(cfg.ncbi_sequence_info)

    folder = build_output_folder or "."
    if mode[0] == "eutils":
        print_log("Retrieving sequence information from NCBI e-utils",
                  cfg.quiet)
        _update(info, run_eutils(info, folder, skip_taxid=False,
                                 level=cfg.level, quiet=cfg.quiet))
        return
    files = _local_or_fetched(
        cfg, mode, ACC2TXID_PREFIXES,
        lambda base, e: (f"{base}/pub/taxonomy/accession2taxid/"
                         f"{e}.accession2taxid.gz"),
        build_output_folder)
    if not files:
        raise ValueError(
            "no valid accession2taxid file(s) via --ncbi-sequence-info"
        )
    counts = parse_acc2txid(info, files)
    for f, cnt in counts.items():
        print_log(f" - {cnt} entries found in {os.path.basename(f)}", cfg.quiet)
    if cfg.level == "assembly":
        print_log("Retrieving assembly information from NCBI e-utils",
                  cfg.quiet)
        _update(info, run_eutils(info, folder, skip_taxid=True,
                                 level="assembly", quiet=cfg.quiet))


def parse_acc2txid(info, acc2txid_files) -> dict:
    """accession.version -> taxid (tax_util.py:440-482); taxid "0" rows
    are dropped, later files overwrite earlier ones."""
    count = {}
    unique_acc = set(info)
    for acc2txid in acc2txid_files:
        count[acc2txid] = 0
        for fields in _tsv_rows(acc2txid, skip=1):
            if len(fields) < 3 or fields[1] not in unique_acc:
                continue
            if fields[2] == "0":
                continue
            _update(info, {fields[1]: {"node": fields[2]}})
            count[acc2txid] += 1
            if sum(count.values()) == len(unique_acc):
                break
    return count


def parse_assembly_summary(info, assembly_summary_files, level) -> dict:
    """Assembly accession -> taxid (and the assembly specialization)
    (tax_util.py:485-552)."""
    count = {}
    unique_acc = set(info)
    for summary in assembly_summary_files:
        header_lines = 0
        with open(summary) as f:
            for line in f:
                if line[0] == "#":
                    header_lines += 1
                else:
                    break
        found = {}
        for fields in _tsv_rows(summary, skip=header_lines):
            fields = fields + [""] * (9 - len(fields))
            if fields[0] not in unique_acc:
                continue
            row = {"node": fields[5]}
            if level == "assembly":
                organism = _na(fields[7])
                infra = _na(fields[8])
                infra = "" if infra is None else re.sub(r"^[a-z]+=", "", infra)
                row["specialization_name"] = (
                    organism if organism.endswith(infra)
                    else organism + " " + infra)
                row["specialization"] = fields[0]
            found[fields[0]] = row
        count[summary] = len(found)
        if not found:
            continue
        _update(info, found)
        if sum(count.values()) == len(unique_acc):
            break
    return count


def _convert_nodes(info, tax, cfg, build_output_folder=None):
    """Convert the node column to ``--convert-taxonomy``
    (build_update.py:874-955); returns the target taxonomy.

    ncbi->ncbi resolves the ids again on the newer taxdump; the GTDB
    directions map through per-assembly conversion files
    (``taxonomy.parse_gtdb_conversion_file``) and fold a node that maps
    to several with an LCA on the target taxonomy.
    """
    from ganon_tpu_torch import acquire

    tax_from = cfg.taxonomy.split("-")[0]
    tax_to = cfg.convert_taxonomy.split("-")[0]
    conv_files = list(getattr(cfg, "convert_taxonomy_files", []) or [])
    gtdb_files = list(getattr(cfg, "convert_gtdb_files", []) or [])

    if tax_from == "ncbi" and tax_to == "ncbi" and not cfg.taxonomy_files:
        return tax  # already resolved on the latest fetched taxdump
    print_log(
        f" - converting taxonomy [{cfg.taxonomy} -> {cfg.convert_taxonomy}]",
        cfg.quiet,
    )

    def load_target(kind):
        folder = build_output_folder or "."
        if kind == "ncbi":
            return taxmod.load_ncbi(files=conv_files or [
                acquire.fetch_taxdump(folder, cfg.quiet)])
        return taxmod.load_gtdb(files=conv_files
                                or acquire.fetch_gtdb_tax(folder, cfg.quiet))

    def set_nodes(fn):
        for row in info.values():
            n = row["node"]
            row["node"] = (fn(n) if n else None) or None

    if tax_from == "ncbi" and tax_to == "ncbi":
        target_tax = load_target("ncbi")
        set_nodes(target_tax.latest)
        return target_tax

    if not gtdb_files:
        raise ValueError(
            "--convert-gtdb-files is required to convert "
            f"[{cfg.taxonomy} -> {cfg.convert_taxonomy}] offline"
        )
    if tax_from == "gtdb" and tax_to == "gtdb":
        target_tax = load_target("gtdb")
        mapping = taxmod.gtdb_conversion_map(gtdb_files[0], gtdb_files[1])
    elif tax_from == "gtdb" and tax_to == "ncbi":
        target_tax = load_target("ncbi")
        # each assembly's ncbi taxid projected to its ancestor at the gtdb
        # node's rank before the LCA fold (no ancestor at that rank: it
        # abstains); old taxdumps call the top rank superkingdom
        mapping = {}
        for node, taxids in taxmod.gtdb_to_ncbi_map(gtdb_files[0]).items():
            rank = taxmod.GTDB_RANKS.get(node[0])
            ranks = ("domain", "superkingdom") if rank == "domain" else (rank,)
            projected = set()
            for t in taxids:
                t = target_tax.latest(t)
                for r in ranks:
                    p = target_tax.parent_rank(t, r) if t else None
                    if p:
                        projected.add(p)
                        break
            mapping[node] = projected
    else:  # ncbi -> gtdb: a direct taxid match only
        target_tax = load_target("gtdb")
        mapping = taxmod.ncbi_to_gtdb_map(gtdb_files[0])

    def fold(n):
        nodes = sorted(mapping.get(n, ()))
        return target_tax.lca(nodes) if nodes else None

    set_nodes(fold)
    return target_tax


def validate_taxonomy(info, tax, cfg, build_output_folder=None):
    """Validate nodes on the taxonomy, convert them to
    ``--convert-taxonomy`` (which then becomes ``cfg.taxonomy``) and apply
    the --level rank projection (build_update.py:860-1001); returns the
    taxonomy the nodes are now on."""
    for row in info.values():
        n = row["node"]
        row["node"] = (tax.latest(n) if n is not None else None) or None
    if getattr(cfg, "convert_taxonomy", ""):
        tax = _convert_nodes(info, tax, cfg, build_output_folder)
        cfg.taxonomy = cfg.convert_taxonomy
    if cfg.level and cfg.level not in ["leaves"] + CHOICES_LEVEL:
        for row in info.values():
            n = row["node"]
            row["node"] = (tax.parent_rank(n, cfg.level) if n else None) or None
    na_entries = sum(row["node"] is None for row in info.values())
    if cfg.keep_invalid_taxa:
        for row in info.values():
            if row["node"] is None:
                row["node"] = tax.root_node
        if na_entries:
            print_log(
                f" - {na_entries} entries without valid taxonomic nodes kept "
                "at the root node",
                cfg.quiet,
            )
    elif na_entries > 0:
        print_log(
            f" - {na_entries} entries without valid taxonomic nodes skipped",
            cfg.quiet,
        )
        for target in [t for t, r in info.items() if r["node"] is None]:
            del info[target]
    return tax


def validate_specialization(info, quiet) -> None:
    """Each specialization must have exactly one parent node
    (build_update.py:800-856): a specialization that is missing or has
    several nodes becomes its target."""
    if all(r["specialization"] is None for r in info.values()):
        print_log(" - No specialization provided/retrieved", quiet)
    else:
        nodes_of: dict = {}
        for r in info.values():
            nodes_of.setdefault(r["specialization"], set()).add(r["node"])
        multi = {s for s, nodes in nodes_of.items() if len(nodes) > 1}
        for target, r in info.items():
            if r["specialization"] is None or r["specialization"] in multi:
                r["specialization"] = target
                r["specialization_name"] = target
    for target in [t for t, r in info.items() if r["specialization"] is None]:
        del info[target]
    for r in info.values():
        if r["specialization_name"] is None:
            r["specialization_name"] = r["specialization"]


# --------------------------------------------------------------------------
# writers


def write_tax(tax_file, info, tax, genome_sizes, user_bins_col, level,
              input_target) -> None:
    """.tax with the specialization nodes and the genome_size column
    (build_update.py:736-778)."""
    if user_bins_col != "node":
        tax_rank = level if level else input_target
        for target, row in info.items():
            spec = user_bins_col == "specialization"
            tax_node = row["specialization"] if spec else target
            tax_name = row["specialization_name"] if spec else target
            if tax.latest(tax_node) == tax.undefined_node:
                tax.add(tax_node, row["node"], name=tax_name, rank=tax_rank)
            else:
                assert tax.parent(tax_node) == row["node"]
    rm_files(tax_file)
    root_gs = genome_sizes.get(tax.root_node, 1)
    with open(tax_file, "w") as f:
        for node in tax.nodes():
            gs = genome_sizes.get(node)
            if gs is None:
                gs = genome_sizes.get(tax.parent(node), root_gs)
            f.write(
                f"{node}\t{tax.parent(node)}\t{tax.rank(node)}\t"
                f"{tax.name(node)}\t{gs}\n"
            )


def _text(v) -> str:
    """A value as pandas formats an object cell: missing is ``nan``."""
    return "nan" if v is None else str(v)


def write_target_info(info, user_bins_col, target_info_file) -> None:
    with open(target_info_file, "w") as f:
        for target, row in info.items():
            t = row[user_bins_col] if user_bins_col != "target" else target
            f.write(f"{_text(row['file'])}\t{_text(t)}\n")


def write_info_file(info, filename) -> None:
    """``to_csv(sep="\\t")`` of the table: missing values empty."""
    with open(filename, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n",
                       quoting=csv.QUOTE_MINIMAL)
        for target, row in info.items():
            w.writerow(["" if v is None else v for v in
                        (row["file"], target, row["node"],
                         row["specialization"], row["specialization_name"])])


def _leaf_sizes(cfg, build_output_folder) -> dict:
    """Leaf genome sizes from --genome-size-files, else from the files
    fetched for the taxonomy (tax_util.py:77-105); {} (every size 1) when
    they cannot be had."""
    from ganon_tpu_torch.acquire import fetch_genome_size_files

    files = cfg.genome_size_files
    if not files:
        try:
            files = fetch_genome_size_files(cfg.taxonomy, build_output_folder,
                                            cfg.quiet)
        except (OSError, ValueError) as e:  # not found, or no source
            print_log(f" - genome size files unavailable ({e}); using size 1",
                      cfg.quiet)
            files = []
    return taxmod.parse_genome_size_files(files, cfg.taxonomy) if files else {}


# --------------------------------------------------------------------------
# main orchestration


def check_device(device) -> None:
    """Raise for ``"cuda"`` without CUDA: no entry point falls back to the
    CPU, and each checks before it writes any file."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")


def build_custom(cfg, which_call: str = "build_custom",
                 device="cuda") -> bool:
    """ganon build-custom: parse, resolve taxonomy, write the tables,
    build on ``device`` and save the configuration."""
    check_device(device)
    files_output_folder = set_output_folder(cfg.db_prefix)
    build_output_folder = os.path.join(files_output_folder, "build/")
    target_info_file = os.path.join(build_output_folder, "target_info.tsv")

    if which_call == "build_custom" and cfg.restart:
        shutil.rmtree(files_output_folder, ignore_errors=True)

    if load_state(which_call + "_parse", files_output_folder):
        print_log("Parse finished - skipping", cfg.quiet)
    else:
        with trace.span("build.prepare"):
            tax = None
            input_files = []
            shutil.rmtree(build_output_folder, ignore_errors=True)
            os.makedirs(build_output_folder, exist_ok=True)

            if cfg.input:
                input_files = validate_input_files(
                    cfg.input, cfg.input_extension, cfg.quiet,
                    input_recursive=cfg.input_recursive,
                )
                if not input_files:
                    raise ValueError("No valid input files found")

            if cfg.taxonomy != "skip":
                tax = load_taxonomy(cfg, build_output_folder)

            info = load_input(cfg, input_files, build_output_folder)
            user_bins_col = "target"
            if cfg.level in CHOICES_LEVEL:
                user_bins_col = "specialization"
            elif cfg.level and cfg.level not in CHOICES_INPUT_TARGET:
                user_bins_col = "node"

            if not info:
                raise ValueError("Unable to parse input files")

            if (tax or cfg.level == "assembly") and not cfg.input_file:
                if cfg.input_target == "sequence":
                    get_sequence_info(cfg, info, build_output_folder)
                else:
                    get_file_info(cfg, info, tax, build_output_folder)

            if tax:
                tax = validate_taxonomy(info, tax, cfg, build_output_folder)
                if not info:
                    raise ValueError("Unable to match taxonomy to targets")

            if cfg.level in CHOICES_LEVEL:
                validate_specialization(info, cfg.quiet)
                if not info:
                    raise ValueError("Unable to match specialization to targets")

            if tax:
                unique_nodes = np.array(
                    list(dict.fromkeys(r["node"] for r in info.values())),
                    dtype=object)
                node_set = set(unique_nodes.tolist())
                if (
                    user_bins_col == "target" and any(t in node_set for t in info)
                ) or (
                    user_bins_col == "specialization"
                    and any(r["specialization"] in node_set
                            for r in info.values())
                ):
                    raise ValueError(
                        f"{user_bins_col} overlaps with taxonomic identifiers"
                    )
                leaves_sizes = ({} if cfg.skip_genome_size else
                                _leaf_sizes(cfg, build_output_folder))
                genome_sizes = taxmod.estimate_genome_sizes(
                    unique_nodes, tax, leaves_sizes
                )
                tax.filter(unique_nodes)
                write_tax(
                    cfg.db_prefix + ".tax", info, tax, genome_sizes, user_bins_col,
                    cfg.level, cfg.input_target,
                )

            if cfg.write_info_file:
                write_info_file(info, cfg.db_prefix + ".info.tsv")

            write_target_info(info, user_bins_col, target_info_file)
            save_state(which_call + "_parse", files_output_folder)

    if load_state(which_call + "_run", files_output_folder):
        print_log("Build finished - skipping", cfg.quiet)
    else:
        tpu_sizing = getattr(cfg, "tpu_sizing", "auto") != "off"
        defaulted = getattr(cfg, "hash_functions_defaulted", False)
        if cfg.filter_type == "hibf":
            from ganon_tpu_torch.index.hibf import run_build_hibf

            run_build_hibf(
                target_info_file=target_info_file,
                output_file=cfg.db_prefix + ".hibf",
                kmer_size=cfg.kmer_size,
                window_size=cfg.window_size,
                hash_functions=cfg.hash_functions,
                max_fp=cfg.max_fp,
                min_length=cfg.min_length,
                threads=getattr(cfg, "threads", 1) or 1,
                tpu_sizing=tpu_sizing and (cfg.hash_functions == 0
                                           or defaulted),
                filter_format=getattr(cfg, "filter_format", "tpu"),
                layout=getattr(cfg, "hibf_layout", "auto"),
                quiet=cfg.quiet,
                device=device,
            )
        else:
            run_build(BuildConfig(
                input_file=target_info_file,
                output_file=cfg.db_prefix + ".ibf",
                kmer_size=cfg.kmer_size,
                window_size=cfg.window_size,
                max_fp=cfg.max_fp if cfg.max_fp else 0,
                filter_size=cfg.filter_size if cfg.filter_size else 0,
                hash_functions=cfg.hash_functions,
                mode=cfg.mode,
                min_length=cfg.min_length,
                threads=getattr(cfg, "threads", 1) or 1,
                tpu_sizing=tpu_sizing,
                hash_functions_defaulted=defaulted,
                quiet=cfg.quiet,
                verbose=cfg.verbose,
                filter_format=getattr(cfg, "filter_format", "tpu"),
                device=str(device),
            ))
        save_state(which_call + "_run", files_output_folder)

    ext = ["hibf" if cfg.filter_type == "hibf" else "ibf"]
    if cfg.taxonomy != "skip":
        ext.append("tax")
    if all(check_file(cfg.db_prefix + "." + e) for e in ext):
        save_config(cfg, os.path.join(files_output_folder, "config.pkl"))
        if not cfg.keep_files:
            # keep config.pkl for updates; remove the build folder
            shutil.rmtree(
                os.path.join(files_output_folder, "build/"), ignore_errors=True
            )
        clear_states(which_call, files_output_folder)
        print_log("Build finished successfully", cfg.quiet)
        return True
    raise ValueError("build failed - one or more database files not found")


def update(cfg, device="cuda") -> bool:
    """Update a database made by ``build`` or ``build-custom``
    (build_update.py:143-280): the saved build's parameters fill those the
    update leaves unset; a database made by ``build`` (its folder holds an
    acquisition ``history.tsv``) gets a new snapshot with the recorded
    selection and is rebuilt from it, any other is rebuilt from the given
    ``--input``; with ``--output-db-prefix`` the snapshots, history,
    summary link and configuration move to the new prefix's folder."""
    check_device(device)
    files_output_folder = set_output_folder(cfg.db_prefix)
    config_file = os.path.join(files_output_folder, "config.pkl")
    if not check_file(config_file):
        raise ValueError(
            f"no saved build configuration found at {config_file}; "
            "run build/build-custom with the same --db-prefix first"
        )
    saved = load_config(config_file)
    for key in (
        "kmer_size", "window_size", "hash_functions", "max_fp", "filter_size",
        "mode", "min_length", "taxonomy", "taxonomy_files", "level",
        "input_target", "filter_type", "genome_size_files",
    ):
        unset = getattr(cfg, key, None) in (None, "", [], 0)
        if key == "hash_functions":
            # a defaulted -s 4 must not shadow the saved build's value
            unset = unset or getattr(cfg, "hash_functions_defaulted", False)
        if key in saved and unset:
            setattr(cfg, key, saved[key])
            if key == "hash_functions":
                cfg.hash_functions_defaulted = saved.get(
                    "hash_functions_defaulted", False)

    acquired = False
    if check_file(os.path.join(files_output_folder, "history.tsv")):
        from ganon_tpu_torch import acquire

        if load_state("update_download", files_output_folder):
            print_log("Download finished - skipping", cfg.quiet)
        else:
            print_log("Downloading updated files", cfg.quiet)
            acquire.acquire_update(files_output_folder,
                                   threads=getattr(cfg, "threads", 1) or 1,
                                   quiet=cfg.quiet)
            save_state("update_download", files_output_folder)
        version = acquire.current_version(files_output_folder)
        cfg.input = [os.path.join(files_output_folder, version, "files")]
        cfg.input_extension = "fna.gz"
        cfg.input_recursive = True
        cfg.input_target = "file"
        cfg.ncbi_file_info = [
            os.path.join(files_output_folder, "assembly_summary.txt")]
        acquired = True

    if cfg.output_db_prefix:
        cfg.db_prefix = cfg.output_db_prefix
    ok = build_custom(cfg, which_call="update", device=device)
    if ok:
        clear_states("update", files_output_folder)
        if acquired and cfg.output_db_prefix:
            _move_acquisition(files_output_folder,
                              set_output_folder(cfg.output_db_prefix))
    return ok


def _move_acquisition(old_folder: str, new_folder: str) -> None:
    """Move the snapshots, history and summary link to ``new_folder``
    (which keeps its own ``config.pkl``), point that configuration at the
    moved snapshot and remove ``old_folder``."""
    os.makedirs(new_folder, exist_ok=True)
    for entry in os.listdir(old_folder):
        dst = os.path.join(new_folder, entry)
        if entry == "config.pkl" or os.path.lexists(dst):
            continue
        shutil.move(os.path.join(old_folder, entry), dst)
    new_config = load_config(os.path.join(new_folder, "config.pkl"))
    version = os.path.basename(os.path.dirname(new_config["input"][0]))
    new_config["input"] = [os.path.join(new_folder, version, "files")]
    new_config["ncbi_file_info"] = [
        os.path.join(new_folder, "assembly_summary.txt")]
    with open(os.path.join(new_folder, "config.pkl"), "wb") as f:
        pickle.dump(new_config, f)
    shutil.rmtree(old_folder, ignore_errors=True)


def save_config(cfg, config_file) -> None:
    v = {k: val for k, val in vars(cfg).items() if not k.startswith("_")}
    with open(config_file, "wb") as f:
        pickle.dump(v, f)


def load_config(config_file):
    with open(config_file, "rb") as f:
        return pickle.load(f)
