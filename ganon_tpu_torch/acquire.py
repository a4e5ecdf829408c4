"""Reference-genome acquisition without pandas: the genome_updater part.

Port of ``ganon_tpu.acquire``. The reference shells out to
genome_updater.sh to download RefSeq/GenBank assemblies by organism
group, taxid, assembly level, RefSeq category or top-N, and to keep
versioned snapshots with incremental updates
(``pirovc/ganon:src/ganon/build_update.py:68-93,177-188``). This module
keeps the same on-disk contract, and its files equal the JAX package's
byte for byte:

* a snapshot folder ``{out}/{YYYY-MM-DD_HH-MM-SS}/files/`` with the
  downloaded ``*_genomic.fna.gz`` (files the previous snapshot holds are
  hard-linked, not fetched again);
* ``{version}/assembly_summary.txt`` with the selected rows,
  ``{version}/changes.tsv`` (``A``/``R`` rows against the previous
  snapshot) and a top-level ``assembly_summary.txt`` symlink into the
  current version, read back with ``os.readlink``;
* an append-only ``history.tsv`` of every snapshot's selection, whose last
  row ``update`` re-reads (editing it changes what an update fetches);
* the ``local_dir`` environment variable points every NCBI and GTDB fetch
  at a local copy of the repository tree.

A summary is a list of rows, each a dict of column name to ``str`` in the
file's column order. pandas' reading is written out:
``read_csv(sep="\\t", comment="#", header=None, dtype=str,
keep_default_na=False)`` (:func:`read_table`), the first 23 columns
(``.iloc[:, :23]``), ``concat`` (a column a file lacks is ``None``, which
the writer leaves empty and no filter matches), ``drop_duplicates``
keeping the first row, ``_select_top``'s stable three-key sort with
``groupby(...).head(top)`` and ``sort_index()``, and ``to_csv`` with
QUOTE_MINIMAL.

One difference by design: a snapshot is never reused. The JAX package
names a snapshot by the second it starts in, so an update in the same
second as the build writes into the build's folder, keeps the removed
assemblies' files there and builds from them; the port waits for the
next free name.
"""

from __future__ import annotations

import csv
import gzip
import hashlib
import os
import re
import shutil
import tarfile
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

from ganon_tpu_torch.util import print_log

NCBI_BASE = "https://ftp.ncbi.nlm.nih.gov"
GTDB_BASE = "https://data.gtdb.ecogenomic.org"
VERSION_FORMAT = "%Y-%m-%d_%H-%M-%S"

ASSEMBLY_SUMMARY_COLS = [
    "assembly_accession", "bioproject", "biosample", "wgs_master",
    "refseq_category", "taxid", "species_taxid", "organism_name",
    "infraspecific_name", "isolate", "version_status", "assembly_level",
    "release_type", "genome_rep", "seq_rel_date", "asm_name", "submitter",
    "gbrs_paired_asm", "paired_asm_comp", "ftp_path", "excluded_from_refseq",
    "relation_to_type_material", "asm_not_live_date",
]

HISTORY_COLS = [
    "version", "source", "organism_group", "taxid", "complete_genomes",
    "reference_genomes", "top", "gtdb", "assembly_levels",
    "date_start", "date_end",
]


def _base(kind: str) -> str:
    """Repository base URL or path; ``local_dir`` (the genome_updater
    contract) points both the NCBI and the GTDB tree at a local folder."""
    local = os.environ.get("local_dir")
    if local:
        return local.rstrip("/")
    return NCBI_BASE if kind == "ncbi" else GTDB_BASE


def _fetch(url: str, dest: str, quiet: bool = True, retries: int = 3) -> str:
    """Fetch a repository file to ``dest`` (a copy when the base is local).

    Remote fetches stream into ``dest + '.part'`` and are renamed on
    success, so an interrupted download never looks complete; failures
    retry with backoff (3 tries, as the reference's tools do).
    """
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    if os.path.isfile(url):
        shutil.copyfile(url, dest)
        return dest
    if not url.startswith(("http://", "https://", "ftp://")):
        raise FileNotFoundError(url)
    print_log("Downloading " + url, quiet)
    part = dest + ".part"
    last: Exception | None = None
    for attempt in range(max(retries, 1)):
        try:
            urllib.request.urlretrieve(url, part)
            os.replace(part, dest)
            return dest
        except Exception as e:  # noqa: BLE001 - the network layer: retry all
            last = e
            if os.path.exists(part):
                os.remove(part)
            if attempt + 1 < retries:
                time.sleep(2**attempt)
    raise last


def _md5_expected(ftp_path: str, name: str, quiet: bool) -> str | None:
    """The md5 of ``name`` in the assembly's md5checksums.txt, or None
    when the repository has no checksums (then nothing is checked)."""
    try:
        with tempfile.TemporaryDirectory() as td:
            p = _fetch(_remap(ftp_path) + "/md5checksums.txt",
                       os.path.join(td, "md5checksums.txt"),
                       quiet=True, retries=1)
            with open(p) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2 and os.path.basename(parts[-1]) == name:
                        return parts[0]
    except OSError:  # no checksum file (urllib's errors are OSErrors)
        return None
    return None


def _md5_of(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while chunk := f.read(1 << 20):
            h.update(chunk)
    return h.hexdigest()


def _remap(ftp_path: str) -> str:
    """An assembly_summary ftp_path rewritten against ``local_dir``."""
    local = os.environ.get("local_dir")
    if not local:
        return ftp_path
    for base in (NCBI_BASE, "ftp://ftp.ncbi.nlm.nih.gov",
                 "http://ftp.ncbi.nlm.nih.gov"):
        if ftp_path.startswith(base):
            return local.rstrip("/") + ftp_path[len(base):]
    return ftp_path


# --------------------------------------------------------------------------
# the assembly_summary table

_EOL = re.compile(r"(\r\n|\r|\n)")
(_START_RECORD, _SPACES, _START_FIELD, _IN_FIELD, _IN_QUOTED,
 _QUOTE_IN_QUOTED, _EAT_COMMENT, _EAT_LINE) = range(8)


def _records(text: str, comment: str = "#", sep: str = "\t",
             quote: str = '"'):
    """The records pandas' C tokenizer makes of ``text`` (``sep``,
    ``comment``, ``quotechar`` and doubled quotes; blank lines and lines
    of spaces skipped; a comment cuts the rest of a line, also inside an
    unquoted field; quoted fields may hold separators, ``#`` and line
    ends). Lines without a quote that start with no space take a split."""
    parts = _EOL.split(text)
    state = _START_RECORD
    fields: list[str] = []
    buf: list[str] = []
    for i in range(0, len(parts), 2):
        line = parts[i]
        eol = parts[i + 1] if i + 1 < len(parts) else ""
        if (state == _START_RECORD and quote not in line
                and not line.startswith(" ")):
            if not line or line.startswith(comment):
                continue
            cut = line.find(comment)
            yield (line if cut < 0 else line[:cut]).split(sep)
            continue
        for c in [*line, eol] if eol else line:
            nl = c == eol
            while True:  # a state that hands the character on loops once
                if state == _START_RECORD:
                    if c == comment:
                        state = _EAT_LINE
                    elif c == " ":
                        buf.append(c)
                        state = _SPACES
                    elif not nl:
                        state = _START_FIELD
                        continue
                elif state == _EAT_LINE:
                    if nl:
                        state = _START_RECORD
                elif state == _SPACES:  # a line of spaces is skipped
                    if nl:
                        buf, state = [], _START_RECORD
                    elif c == " ":
                        buf.append(c)
                    else:
                        state = _IN_FIELD
                        continue
                elif state == _START_FIELD:
                    if c == quote:
                        state = _IN_QUOTED
                    elif nl or c == sep or c == comment:
                        fields.append("")
                        if nl:
                            yield fields
                            fields, state = [], _START_RECORD
                        elif c == comment:
                            state = _EAT_COMMENT
                    else:
                        buf.append(c)
                        state = _IN_FIELD
                elif state == _IN_QUOTED:
                    if c == quote:
                        state = _QUOTE_IN_QUOTED
                    else:
                        buf.append(c)
                elif state in (_IN_FIELD, _QUOTE_IN_QUOTED):
                    if state == _QUOTE_IN_QUOTED and c == quote:
                        buf.append(c)
                        state = _IN_QUOTED
                    elif nl or c == sep or (state == _IN_FIELD
                                            and c == comment):
                        fields.append("".join(buf))
                        buf = []
                        if nl:
                            yield fields
                            fields, state = [], _START_RECORD
                        else:
                            state = _START_FIELD if c == sep else _EAT_COMMENT
                    else:
                        buf.append(c)
                        state = _IN_FIELD
                elif state == _EAT_COMMENT and nl:
                    yield fields
                    fields, state = [], _START_RECORD
                break
    if state == _IN_QUOTED:
        raise ValueError("EOF inside a quoted field")
    if state in (_START_FIELD, _IN_FIELD, _QUOTE_IN_QUOTED):
        fields.append("".join(buf))
        yield fields
    elif state == _EAT_COMMENT:
        yield fields


def read_table(text: str) -> list[list[str]]:
    """``pd.read_csv(sep="\\t", comment="#", header=None, dtype=str,
    keep_default_na=False)`` of ``text`` as rows of str: the first record
    sets the width, shorter records are padded with ``""`` and a longer
    one raises, as pandas does. Lone carriage returns are not covered."""
    rows: list[list[str]] = []
    width = None
    for rec in _records(text):
        if width is None:
            width = len(rec)
        elif len(rec) > width:
            raise ValueError(f"Expected {width} fields in record "
                             f"{len(rows) + 1}, saw {len(rec)}")
        rows.append(rec + [""] * (width - len(rec)))
    if width is None:
        raise ValueError("No columns to parse from file")
    return rows


def read_assembly_summary(path: str) -> list[dict]:
    """The rows of an assembly_summary file, keyed by the first 23
    column names."""
    with open(path, encoding="utf-8", newline="") as f:
        rows = read_table(f.read())
    cols = ASSEMBLY_SUMMARY_COLS[: len(rows[0])]
    return [dict(zip(cols, r)) for r in rows]


def _columns(summary: list[dict]) -> list[str]:
    return list(summary[0]) if summary else []


def _load_summaries(sources, organism_groups, workdir, quiet) -> list[dict]:
    """Every assembly_summary.txt of the selection's scope, one row per
    accession (the first)."""
    frames = []
    for source in sources:
        base = _base("ncbi")
        if organism_groups:
            for group in organism_groups:
                url = f"{base}/genomes/{source}/{group}/assembly_summary.txt"
                frames.append(read_assembly_summary(_fetch(url, os.path.join(
                    workdir, f"assembly_summary_{source}_{group}.txt"),
                    quiet)))
        else:
            url = f"{base}/genomes/{source}/assembly_summary_{source}.txt"
            frames.append(read_assembly_summary(_fetch(url, os.path.join(
                workdir, f"assembly_summary_{source}.txt"), quiet)))
    # concat: the union of the columns (prefixes of one list), None where
    # a file lacks one
    cols = max((_columns(f) for f in frames), key=len, default=[])
    summary, seen = [], set()
    for rows in frames:
        for r in rows:
            if r["assembly_accession"] in seen:
                continue
            seen.add(r["assembly_accession"])
            summary.append({c: r.get(c) for c in cols})
    return summary


def _filter_taxids(summary, taxids, workdir, quiet) -> list[dict]:
    """Assemblies whose lineage passes through any of ``taxids``
    (genome_updater's -T, from taxidlineage.dmp of the NCBI
    new_taxdump)."""
    url = f"{_base('ncbi')}/pub/taxonomy/new_taxdump/new_taxdump.tar.gz"
    local = _fetch(url, os.path.join(workdir, "new_taxdump.tar.gz"), quiet)
    wanted = {str(t) for t in taxids}
    ok = set()
    with tarfile.open(local, "r:gz") as tar:
        with tar.extractfile("taxidlineage.dmp") as f:
            for raw in f:
                fields = [x.strip() for x in raw.decode().split("|")]
                node, lineage = fields[0], fields[1].split()
                if node in wanted or any(t in wanted for t in lineage):
                    ok.add(node)
    return [r for r in summary if r["taxid"] in ok]


def _filter_gtdb(summary, workdir, quiet) -> list[dict]:
    """Assemblies of the current GTDB release (genome_updater's -M gtdb)."""
    accs = set()
    for name in ("ar53_taxonomy.tsv.gz", "bac120_taxonomy.tsv.gz"):
        try:
            local = _fetch(f"{_base('gtdb')}/releases/latest/{name}",
                           os.path.join(workdir, name), quiet)
        except FileNotFoundError:
            continue
        with gzip.open(local, "rt") as f:
            for line in f:
                acc = line.split("\t", 1)[0]
                # GTDB prefixes RS_ (RefSeq) and GB_ (GenBank)
                accs.add(acc[3:] if acc[:3] in ("RS_", "GB_") else acc)
    return [r for r in summary if r["assembly_accession"] in accs]


def _select_top(summary: list[dict], top: int) -> list[dict]:
    """Top N assemblies a species, ranked as genome_updater does: RefSeq
    category, then assembly level, then the newest release date; ties
    keep the file order, and the rows kept stay in it."""
    cat_rank = {"reference genome": 0, "representative genome": 1}
    lvl_rank = {"Complete Genome": 0, "Chromosome": 1, "Scaffold": 2,
                "Contig": 3}
    # a stable sort by date, newest first (a missing date last), then a
    # stable sort by category and level: pandas' stable three-key sort
    order = sorted(range(len(summary)), reverse=True, key=lambda i: (
        summary[i]["seq_rel_date"] is not None,
        summary[i]["seq_rel_date"] or ""))
    order.sort(key=lambda i: (cat_rank.get(summary[i]["refseq_category"], 2),
                              lvl_rank.get(summary[i]["assembly_level"], 4)))
    taken: dict = {}
    keep = []
    for i in order:
        sp = summary[i]["species_taxid"]
        if sp is None:  # groupby drops a missing key
            continue
        taken[sp] = taken.get(sp, 0) + 1
        if taken[sp] <= top:
            keep.append(i)
    return [summary[i] for i in sorted(keep)]


def _date(v):
    return None if v is None else v.replace("-", "/")


def select_assemblies(
    sources,
    organism_groups=(),
    taxids=(),
    complete_genomes=False,
    reference_genomes=False,
    top=0,
    gtdb=False,
    assembly_levels=(),
    date_start="",
    date_end="",
    workdir=".",
    quiet=True,
) -> list[dict]:
    summary = _load_summaries(sources, organism_groups, workdir, quiet)
    summary = [r for r in summary if r["version_status"] == "latest"
               and r["ftp_path"] != "na"]
    if taxids:
        summary = _filter_taxids(summary, taxids, workdir, quiet)
    if complete_genomes:
        summary = [r for r in summary
                   if r["assembly_level"] == "Complete Genome"]
    if assembly_levels:
        # genome_updater -l takes a list of levels, in any case
        levels = {lv.lower() for lv in assembly_levels}
        summary = [r for r in summary if r["assembly_level"] is not None
                   and r["assembly_level"].lower() in levels]
    if reference_genomes:
        summary = [r for r in summary
                   if r["refseq_category"] == "reference genome"]
    # genome_updater -D start:end; seq_rel_date is YYYY/MM/DD, so strings
    # order as dates; a missing date passes neither bound
    if date_start:
        lo = date_start.replace("-", "/")
        summary = [r for r in summary if _date(r["seq_rel_date"]) is not None
                   and _date(r["seq_rel_date"]) >= lo]
    if date_end:
        hi = date_end.replace("-", "/")
        summary = [r for r in summary if _date(r["seq_rel_date"]) is not None
                   and _date(r["seq_rel_date"]) <= hi]
    if gtdb:
        summary = _filter_gtdb(summary, workdir, quiet)
    if top:
        summary = _select_top(summary, top)
    return summary


# --------------------------------------------------------------------------
# snapshots


def _download_rows(summary: list[dict], files_folder: str,
                   previous_files: str | None, threads: int, quiet: bool):
    """Fetch ``{ftp_path}/{asm}_genomic.fna.gz`` for each row, hard-linking
    the files the previous snapshot holds; a file whose md5 disagrees with
    the repository's checksums is fetched once more, then raises."""
    os.makedirs(files_folder, exist_ok=True)

    def fetch_one(ftp_path: str):
        name = os.path.basename(ftp_path) + "_genomic.fna.gz"
        dest = os.path.join(files_folder, name)
        if os.path.isfile(dest):
            return dest
        if previous_files:
            prev = os.path.join(previous_files, name)
            if os.path.isfile(prev):
                os.link(prev, dest)
                return dest
        _fetch(_remap(ftp_path) + "/" + name, dest, quiet)
        expect = _md5_expected(ftp_path, name, quiet)
        if expect is not None and _md5_of(dest) != expect:
            os.remove(dest)
            _fetch(_remap(ftp_path) + "/" + name, dest, quiet)
            got = _md5_of(dest)
            if got != expect:
                os.remove(dest)
                raise IOError(
                    f"md5 mismatch for {name}: expected {expect}, got {got}")
        return dest

    with ThreadPoolExecutor(max_workers=max(1, threads)) as pool:
        return list(pool.map(fetch_one, [r["ftp_path"] for r in summary]))


def _write_summary(summary: list[dict], path: str) -> None:
    """Two header lines, then the rows as ``to_csv(sep="\\t")`` writes
    them: QUOTE_MINIMAL, a missing value empty."""
    cols = _columns(summary)
    with open(path, "w", newline="") as f:
        f.write("# ganon-tpu acquire\n# "
                + "\t".join(ASSEMBLY_SUMMARY_COLS[: len(cols)]) + "\n")
        w = csv.writer(f, delimiter="\t", lineterminator="\n",
                       quoting=csv.QUOTE_MINIMAL)
        for r in summary:
            w.writerow(["" if r[c] is None else r[c] for c in cols])


def _append_history(output_folder: str, row: dict) -> None:
    path = os.path.join(output_folder, "history.tsv")
    new = not os.path.isfile(path)
    with open(path, "a") as f:
        if new:
            f.write("\t".join(HISTORY_COLS) + "\n")
        f.write("\t".join(str(row.get(c, "")) for c in HISTORY_COLS) + "\n")


def read_history(output_folder: str) -> list[dict]:
    rows = []
    with open(os.path.join(output_folder, "history.tsv")) as f:
        header = f.readline().rstrip("\n").split("\t")
        for line in f:
            rows.append(dict(zip(header, line.rstrip("\n").split("\t"))))
    return rows


def current_version(output_folder: str) -> str:
    """The current snapshot's folder name, from the top-level symlink."""
    return os.path.dirname(os.readlink(
        os.path.join(output_folder, "assembly_summary.txt")))


def _new_version(output_folder: str) -> str:
    """The snapshot name of this second, or of the first second whose
    folder does not exist yet."""
    version = time.strftime(VERSION_FORMAT)
    while os.path.lexists(os.path.join(output_folder, version)):
        time.sleep(0.1)
        version = time.strftime(VERSION_FORMAT)
    return version


def acquire(
    output_folder: str,
    sources,
    organism_groups=(),
    taxids=(),
    complete_genomes=False,
    reference_genomes=False,
    top=0,
    gtdb=False,
    assembly_levels=(),
    date_start="",
    date_end="",
    threads: int = 1,
    quiet: bool = True,
) -> str:
    """Make one snapshot; returns its folder name."""
    os.makedirs(output_folder, exist_ok=True)
    version = _new_version(output_folder)
    version_folder = os.path.join(output_folder, version)
    os.makedirs(version_folder)

    summary = select_assemblies(
        sources, organism_groups, taxids, complete_genomes,
        reference_genomes, top, gtdb, assembly_levels, date_start, date_end,
        workdir=version_folder, quiet=quiet,
    )
    print_log(f" - {len(summary)} assemblies selected", quiet)
    if not summary:
        raise ValueError("no assemblies match the given selection")

    previous_files = None
    previous_summary = None
    top_link = os.path.join(output_folder, "assembly_summary.txt")
    if os.path.islink(top_link):
        prev_version = current_version(output_folder)
        previous_files = os.path.join(output_folder, prev_version, "files")
        prev_sum_path = os.path.join(output_folder, prev_version,
                                     "assembly_summary.txt")
        if os.path.isfile(prev_sum_path):
            previous_summary = read_assembly_summary(prev_sum_path)

    _download_rows(summary, os.path.join(version_folder, "files"),
                   previous_files, threads, quiet)
    _write_summary(summary,
                   os.path.join(version_folder, "assembly_summary.txt"))
    _write_changes(summary, previous_summary, version_folder, quiet)

    if os.path.islink(top_link) or os.path.isfile(top_link):
        os.remove(top_link)
    os.symlink(os.path.join(version, "assembly_summary.txt"), top_link)

    _append_history(output_folder, {
        "version": version,
        "source": ",".join(sources),
        "organism_group": ",".join(organism_groups or []),
        "taxid": ",".join(str(t) for t in (taxids or [])),
        "complete_genomes": int(bool(complete_genomes)),
        "reference_genomes": int(bool(reference_genomes)),
        "top": int(top or 0),
        "gtdb": int(bool(gtdb)),
        "assembly_levels": ",".join(assembly_levels or []),
        "date_start": date_start,
        "date_end": date_end,
    })
    return version


def acquire_update(output_folder: str, threads: int = 1,
                   quiet: bool = True) -> str:
    """A new snapshot with the last history.tsv row's selection."""
    last = read_history(output_folder)[-1]

    def split(v):
        return [x for x in v.split(",") if x]

    return acquire(
        output_folder,
        sources=split(last["source"]) or ["refseq"],
        organism_groups=split(last["organism_group"]),
        taxids=split(last["taxid"]),
        complete_genomes=bool(int(last.get("complete_genomes") or 0)),
        reference_genomes=bool(int(last.get("reference_genomes") or 0)),
        top=int(last.get("top") or 0),
        gtdb=bool(int(last.get("gtdb") or 0)),
        assembly_levels=split(last.get("assembly_levels") or ""),
        date_start=last.get("date_start") or "",
        date_end=last.get("date_end") or "",
        threads=threads,
        quiet=quiet,
    )


def _write_changes(summary, previous_summary, version_folder: str,
                   quiet: bool) -> None:
    """``changes.tsv``: ``A <tab> accession`` for each accession new
    against the previous snapshot, then ``R`` for each one gone, both
    sorted."""
    cur = {r["assembly_accession"] for r in summary}
    prev = ({r["assembly_accession"] for r in previous_summary}
            if previous_summary is not None else set())
    added = sorted(cur - prev)
    removed = sorted(prev - cur)
    with open(os.path.join(version_folder, "changes.tsv"), "w") as f:
        for a in added:
            f.write(f"A\t{a}\n")
        for a in removed:
            f.write(f"R\t{a}\n")
    if prev:
        print_log(f" - {len(added)} added, {len(removed)} removed vs "
                  "previous snapshot", quiet)


def rollback(output_folder: str, version: str | None = None) -> str:
    """Point the snapshot symlink at an earlier version (genome_updater
    -B; by default the one before the current in history.tsv) and append
    that version's history row, so a later ``update`` selects as it did.
    Returns the new current version."""
    history = read_history(output_folder)
    versions = [r["version"] for r in history]
    cur = current_version(output_folder)
    if version is None:
        # earlier by position in the history, not by name (a rollback
        # appends an old name at the end)
        try:
            i = len(versions) - 1 - versions[::-1].index(cur)
        except ValueError:
            i = len(versions)
        earlier = [v for v in versions[:i] if v != cur]
        if not earlier:
            raise ValueError("no earlier snapshot to roll back to")
        version = earlier[-1]
    if version not in versions:
        raise ValueError(f"unknown snapshot version {version}")
    target_summary = os.path.join(version, "assembly_summary.txt")
    if not os.path.isfile(os.path.join(output_folder, target_summary)):
        raise ValueError(f"snapshot {version} has no assembly_summary.txt")
    top_link = os.path.join(output_folder, "assembly_summary.txt")
    if os.path.islink(top_link) or os.path.exists(top_link):
        os.remove(top_link)
    os.symlink(target_summary, top_link)
    _append_history(output_folder,
                    next(r for r in history if r["version"] == version))
    return version


# --------------------------------------------------------------------------
# taxonomy and genome-size files


def fetch_taxdump(workdir: str, quiet: bool = True) -> str:
    """The NCBI new_taxdump archive (the taxonomy when no
    --taxonomy-files are given)."""
    return _fetch(
        f"{_base('ncbi')}/pub/taxonomy/new_taxdump/new_taxdump.tar.gz",
        os.path.join(workdir, "new_taxdump.tar.gz"), quiet)


def _fetch_gtdb(names, workdir, quiet) -> list[str]:
    out = []
    for name in names:
        try:
            out.append(_fetch(f"{_base('gtdb')}/releases/latest/{name}",
                              os.path.join(workdir, name), quiet))
        except FileNotFoundError:
            pass
    return out


def fetch_genome_size_files(taxonomy: str, workdir: str,
                            quiet: bool = True) -> list[str]:
    """The genome-size files (reference tax_util.py:77-105): NCBI's
    species_genome_size, or the GTDB metadata."""
    if taxonomy.startswith("ncbi"):
        return [_fetch(
            f"{_base('ncbi')}/genomes/ASSEMBLY_REPORTS/"
            "species_genome_size.txt.gz",
            os.path.join(workdir, "species_genome_size.txt.gz"), quiet)]
    if taxonomy.startswith("gtdb"):
        out = _fetch_gtdb(("ar53_metadata.tsv.gz", "bac120_metadata.tsv.gz"),
                          workdir, quiet)
        if not out:
            raise FileNotFoundError("no GTDB metadata files found")
        return out
    raise ValueError(f"no genome size source for taxonomy {taxonomy}")


def fetch_gtdb_tax(workdir: str, quiet: bool = True) -> list[str]:
    """The GTDB taxonomy files of the current release."""
    out = _fetch_gtdb(("ar53_taxonomy.tsv.gz", "bac120_taxonomy.tsv.gz"),
                      workdir, quiet)
    if not out:
        raise FileNotFoundError("no GTDB taxonomy files found")
    return out
