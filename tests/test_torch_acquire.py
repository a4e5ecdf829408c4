"""``ganon_tpu_torch.acquire`` against ``ganon_tpu.acquire``, on the CPU.

A fake repository tree (``ncbi_tree``) in a temporary folder, served
through ``local_dir``: RefSeq and GenBank trees of two organism groups
each, one accession in both sources, the 38 columns of today's
assembly_summary files, a ``#`` inside a field, a ragged row, a quoted
field, ``replaced`` and ``na`` rows, top-N ties on all three sort keys,
dates with ``-`` and ``/``, the new_taxdump's taxidlineage.dmp and a
GTDB ``releases/latest``. Each case runs the JAX function and the port's
on the same inputs: the selected rows equal the DataFrame's, and the
snapshot files (assembly_summary.txt, history.tsv, changes.tsv, the
downloaded files and their hard links) are byte-equal. ``time.strftime``
is a counter, so snapshot names are equal between the packages and
distinct between calls.
"""

import io
import os
import random
import shutil
import time

import pytest

import ganon_tpu.acquire as jacq
import ganon_tpu_torch.acquire as pacq
from ncbi_tree import (
    Assembly, write_genome_sizes, write_genomes, write_gtdb, write_summaries,
    write_taxdump,
)

A = Assembly
BACT = [
    A("GCF_000001.1", "11", "11", category="reference genome",
      date="2020/01/05"),
    A("GCF_000002.1", "12", "11", date="2020-03-01"),
    A("GCF_000003.1", "13", "11", date="2020/03/01"),
    A("GCF_000004.1", "14", "11", date="2020/03/01"),  # ties 3 on every key
    A("GCF_000005.1", "21", "21", level="Scaffold",
      category="representative genome", date="2019/12/31"),
    A("GCF_000006.1", "22", "21", level="Contig", date="2021/01/01"),
    A("GCF_000007.1", "12", "11", status="replaced"),
    A("GCF_000008.1", "13", "11", ftp_na=True),
    # a "#" in column 22 cuts the rest of the line
    A("GCF_000009.1", "31", "31", level="Chromosome", date="2018/05/05",
      extra={"relation_to_type_material": "type#material"}),
    A("GCF_000010.1", "31", "31", date="2020/02/02", ragged=25),
    A("GCF_000011.1", "22", "21", level="Contig", date="2021/01/01",
      extra={"isolate": 'iso"late', "asm_submitter": '"Lab\tOne"'}),
    A("GCF_000012.1", "14", "11", date="2020/03/01"),  # a third tie
]
ARCH = [
    A("GCF_000013.1", "41", "41", group="archaea",
      category="reference genome", date="2022/01/01"),
    A("GCF_000014.1", "42", "41", group="archaea", level="Contig",
      date="2022-01-01"),
]
GENBANK = [
    # the same accession as RefSeq's first row, other fields
    A("GCF_000001.1", "11", "11", source="genbank", date="2023/01/01"),
    A("GCA_000015.1", "51", "51", source="genbank"),
    A("GCA_000016.1", "41", "41", source="genbank", group="archaea",
      level="Chromosome"),
]
NODES = [("1", "1", "no rank"), ("2", "1", "superkingdom"),
         ("2157", "1", "superkingdom"), ("10", "2", "genus"),
         ("20", "2", "genus"), ("30", "2", "genus"), ("50", "2", "genus"),
         ("40", "2157", "genus"), ("11", "10", "species"),
         ("21", "20", "species"), ("31", "30", "species"),
         ("41", "40", "species"), ("51", "50", "species"),
         ("12", "11", "strain"), ("13", "11", "strain"),
         ("14", "11", "strain"), ("22", "21", "strain"),
         ("42", "41", "strain")]
GTDB_BAC = {"GCF_000001.1": "d__Bacteria;g__Ten;s__Ten one",
            "GCF_000005.1": "d__Bacteria;g__Twenty;s__Twenty one",
            "GCA_000015.1": "d__Bacteria;g__Fifty;s__Fifty one"}
GTDB_ARC = {"GCF_000013.1": "d__Archaea;g__Forty;s__Forty one"}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ncbi_tree"))
    every = BACT + ARCH + GENBANK
    write_summaries(root, every)
    write_genomes(root, every)
    write_taxdump(root, NODES)
    write_genome_sizes(root, {"11": 4_000_000, "21": 5_000_000})
    write_gtdb(root, GTDB_BAC, "bac120",
               sizes={a: 3_000_000 for a in GTDB_BAC})
    write_gtdb(root, GTDB_ARC, "ar53")
    # a second state of the tree: a row replaced, a replaced row back, and
    # one assembly new
    root2 = str(tmp_path_factory.mktemp("ncbi_tree2"))
    changed = [
        A(a.acc, a.taxid, a.species, source=a.source, group=a.group,
          status={"GCF_000002.1": "replaced", "GCF_000007.1": "latest"}.get(
              a.acc, a.status),
          level=a.level, category=a.category, date=a.date, ftp_na=a.ftp_na,
          extra=a.extra, ragged=a.ragged)
        for a in every
    ] + [A("GCF_000017.1", "21", "21", date="2024/01/01")]
    write_summaries(root2, changed)
    write_genomes(root2, changed)
    write_taxdump(root2, NODES)
    return {"root": root, "root2": root2}


@pytest.fixture
def versions(monkeypatch):
    """``time.strftime`` for the snapshot format as a counter;
    ``reset()`` starts it again (for the second package)."""
    real = time.strftime
    state = {"n": 0, "names": None}

    def fake(fmt, *a):
        if fmt != pacq.VERSION_FORMAT:
            return real(fmt, *a)
        if state["names"] is not None:
            return state["names"].pop(0)
        state["n"] += 1
        return f"2026-01-01_00-00-{state['n']:02d}"

    def reset(names=None):
        state["n"] = 0
        state["names"] = list(names) if names is not None else None

    monkeypatch.setattr(time, "strftime", fake)
    return reset


@pytest.fixture
def local(tree, monkeypatch):
    monkeypatch.setenv("local_dir", tree["root"])
    return tree


def _records(df):
    return [{k: (None if v != v else v) for k, v in r.items()}
            for r in df.to_dict("records")]


def _summary_bytes(write, rows, path):
    write(rows, path)
    with open(path, "rb") as f:
        return f.read()


# --------------------------------------------------------------------------
# reading


@pytest.mark.parametrize("rel", [
    "genomes/refseq/bacteria/assembly_summary.txt",
    "genomes/refseq/archaea/assembly_summary.txt",
    "genomes/genbank/bacteria/assembly_summary.txt",
    "genomes/genbank/archaea/assembly_summary.txt",
    "genomes/refseq/assembly_summary_refseq.txt",
    "genomes/genbank/assembly_summary_genbank.txt",
])
def test_read_assembly_summary_matches_jax(tree, rel):
    path = os.path.join(tree["root"], rel)
    want = _records(jacq.read_assembly_summary(path))
    got = pacq.read_assembly_summary(path)
    assert got == want
    assert len(got[0]) == 23


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tokenizer_matches_pandas(seed):
    """Random text of tabs, newlines (also CRLF), "#", quotes and spaces:
    the rows pandas reads, or an error in both."""
    rng = random.Random(seed)
    alpha = ["A", "b", "\t", "\n", "#", '"', " ", "\r\n"]
    for _ in range(1500):
        t = "".join(rng.choice(alpha) for _ in range(rng.randint(0, 16)))
        try:
            want = jacq.read_assembly_summary(io.StringIO(t)).values.tolist()
        except ValueError:
            want = "error"
        try:
            got = [r[:23] for r in pacq.read_table(t)]
        except ValueError:
            got = "error"
        assert got == want, repr(t)


# --------------------------------------------------------------------------
# selection

SELECTIONS = {
    "source_file": dict(sources=["refseq"]),
    "groups": dict(sources=["refseq"], organism_groups=["bacteria",
                                                        "archaea"]),
    "two_sources": dict(sources=["refseq", "genbank"],
                        organism_groups=["bacteria", "archaea"]),
    "two_sources_genbank_first": dict(sources=["genbank", "refseq"],
                                      organism_groups=["bacteria",
                                                       "archaea"]),
    "complete": dict(sources=["refseq"], complete_genomes=True),
    "levels": dict(sources=["refseq", "genbank"],
                   assembly_levels=["complete genome", "SCAFFOLD"]),
    "reference": dict(sources=["refseq"], reference_genomes=True),
    "dates": dict(sources=["refseq"], date_start="2020-01-05",
                  date_end="2020/03/01"),
    "date_end": dict(sources=["refseq", "genbank"], date_end="2020-01-01"),
    "gtdb": dict(sources=["refseq", "genbank"], gtdb=True),
    "top1": dict(sources=["refseq"], top=1),
    "top2": dict(sources=["refseq", "genbank"], top=2),
    "top3_ties": dict(sources=["refseq"], organism_groups=["bacteria"],
                      top=3),
    "taxids": dict(sources=["refseq", "genbank"], taxids=["10", "40"]),
    "combined": dict(sources=["refseq", "genbank"], complete_genomes=True,
                     top=1, date_start="2020/01/01"),
}


@pytest.mark.parametrize("case", sorted(SELECTIONS))
def test_select_assemblies_matches_jax(local, tmp_path, case):
    kw = SELECTIONS[case]
    want = jacq.select_assemblies(workdir=str(tmp_path / "j"), **kw)
    got = pacq.select_assemblies(workdir=str(tmp_path / "p"), **kw)
    assert got == _records(want)
    assert got, "every selection keeps some rows"
    assert (_summary_bytes(pacq._write_summary, got, str(tmp_path / "p.txt"))
            == _summary_bytes(jacq._write_summary, want,
                              str(tmp_path / "j.txt")))


def test_top_ties_keep_file_order(local, tmp_path):
    """Three rows of species 11 tie on category, level and date: top 2
    keeps the reference genome and the first of the ties."""
    got = pacq.select_assemblies(["refseq"], ["bacteria"], top=2,
                                 workdir=str(tmp_path))
    sp11 = [r["assembly_accession"] for r in got if r["species_taxid"] == "11"]
    assert sp11 == ["GCF_000001.1", "GCF_000003.1"]


# --------------------------------------------------------------------------
# snapshots


def _tree(folder):
    """{relative path: bytes or ('link', target)} and the groups of paths
    sharing an inode."""
    files, inodes = {}, {}
    for root, dirs, names in os.walk(folder):
        for n in names:
            p = os.path.join(root, n)
            rel = os.path.relpath(p, folder)
            if os.path.islink(p):
                files[rel] = ("link", os.readlink(p))
                continue
            with open(p, "rb") as f:
                files[rel] = f.read()
            inodes.setdefault(os.stat(p).st_ino, []).append(rel)
    return files, sorted(sorted(g) for g in inodes.values() if len(g) > 1)


def _run_both(tmp_path, versions, steps, names=None):
    """``steps(module, out)`` for the JAX package, then the port, each in
    its own folder with the snapshot counter reset."""
    out = []
    for mod, sub in ((jacq, "j"), (pacq, "p")):
        versions(names)
        folder = str(tmp_path / sub)
        steps(mod, folder)
        out.append(_tree(folder))
    return out


def test_acquire_and_update_match_jax(local, tmp_path, monkeypatch, versions):
    """A snapshot of refseq bacteria; the history edited to add archaea;
    then the tree changes (one row replaced, one back, one new): three
    snapshots, byte-equal, the kept files hard links to the last
    snapshot's."""
    def steps(mod, out):
        monkeypatch.setenv("local_dir", local["root"])
        v1 = mod.acquire(out, sources=["refseq"], organism_groups=["bacteria"],
                         threads=2)
        hist = os.path.join(out, "history.tsv")
        with open(hist) as f:
            text = f.read()
        with open(hist, "w") as f:
            f.write(text.replace("\tbacteria\t", "\tbacteria,archaea\t"))
        v2 = mod.acquire_update(out, threads=2)
        monkeypatch.setenv("local_dir", local["root2"])
        v3 = mod.acquire_update(out, threads=3)
        assert len({v1, v2, v3}) == 3
        assert mod.current_version(out) == v3

    (want, want_links), (got, got_links) = _run_both(tmp_path, versions, steps)
    assert got == want
    assert got_links == want_links
    changes = got["2026-01-01_00-00-03/changes.tsv"].decode().splitlines()
    assert changes == ["A\tGCF_000007.1", "A\tGCF_000017.1",
                       "R\tGCF_000002.1"]
    kept = [g for g in got_links if any(p.startswith("2026-01-01_00-00-03")
                                        for p in g)]
    assert len(kept) == 11  # every file the third snapshot kept


def test_acquire_filters_snapshot_matches_jax(local, tmp_path, versions):
    """Every filter at once (taxids, levels, dates, top) on both sources."""
    def steps(mod, out):
        mod.acquire(out, sources=["refseq", "genbank"],
                    organism_groups=["bacteria", "archaea"],
                    taxids=["10", "40"], top=2,
                    assembly_levels=["Complete Genome", "Chromosome"],
                    date_start="2019-01-01", date_end="2022/01/01")

    (want, _), (got, _) = _run_both(tmp_path, versions, steps)
    assert got == want


def test_rollback_matches_jax(local, tmp_path, versions):
    def steps(mod, out):
        v1 = mod.acquire(out, sources=["refseq"], organism_groups=["archaea"])
        v2 = mod.acquire(out, sources=["refseq"],
                         organism_groups=["archaea", "bacteria"])
        assert mod.rollback(out) == v1
        assert mod.read_history(out)[-1]["organism_group"] == "archaea"
        assert mod.rollback(out, v2) == v2
        with pytest.raises(ValueError, match="unknown snapshot"):
            mod.rollback(out, "1999-01-01_00-00-00")

    (want, _), (got, _) = _run_both(tmp_path, versions, steps)
    assert got == want


def test_acquire_empty_selection_raises(local, tmp_path, versions):
    for mod in (jacq, pacq):
        with pytest.raises(ValueError, match="no assemblies"):
            mod.acquire(str(tmp_path / mod.__name__), sources=["refseq"],
                        taxids=["999"])


def test_snapshot_in_the_same_second_is_new(local, tmp_path, versions):
    """The JAX package reuses a snapshot named by the same second (its
    history names it twice); the port waits for the next free name."""
    versions(["2026-01-01_00-00-01"] * 2)
    out = str(tmp_path / "j")
    jacq.acquire(out, sources=["refseq"], organism_groups=["archaea"])
    jacq.acquire(out, sources=["refseq"], organism_groups=["bacteria"])
    assert [r["version"] for r in jacq.read_history(out)] == [
        "2026-01-01_00-00-01"] * 2
    # the archaea files stay in the reused snapshot
    files = os.listdir(os.path.join(out, "2026-01-01_00-00-01", "files"))
    assert any(f.startswith("GCF_000013.1") for f in files)

    versions(["2026-01-01_00-00-01"] * 2 + ["2026-01-01_00-00-02"])
    out = str(tmp_path / "p")
    pacq.acquire(out, sources=["refseq"], organism_groups=["archaea"])
    v2 = pacq.acquire(out, sources=["refseq"], organism_groups=["bacteria"])
    assert v2 == "2026-01-01_00-00-02"
    files = os.listdir(os.path.join(out, v2, "files"))
    assert not any(f.startswith("GCF_000013.1") for f in files)


# --------------------------------------------------------------------------
# downloads


@pytest.mark.parametrize("md5", ["good", "bad", "none"])
def test_download_md5_matches_jax(tmp_path, monkeypatch, md5):
    """A checksum that disagrees raises IOError (after one more fetch)
    and leaves no file; a right one, or none, passes."""
    root = str(tmp_path / "repo")
    rows = [A("GCF_000001.1", "11"), A("GCF_000002.1", "12")]
    write_genomes(root, rows, md5=None if md5 == "none" else {
        "GCF_000002.1": "0" * 32 if md5 == "bad" else "good"})
    monkeypatch.setenv("local_dir", root)
    summary = [{"ftp_path": a.ftp_path} for a in rows]
    import pandas as pd

    for mod, table in ((jacq, pd.DataFrame(summary)), (pacq, summary)):
        out = tmp_path / mod.__name__
        if md5 == "bad":
            with pytest.raises(IOError, match="md5 mismatch"):
                mod._download_rows(table, str(out), None, 2, True)
            assert not (out / (rows[1].name + "_genomic.fna.gz")).exists()
        else:
            mod._download_rows(table, str(out), None, 2, True)
            assert sorted(os.listdir(out)) == sorted(
                a.name + "_genomic.fna.gz" for a in rows)


def test_fetch_retries_and_is_atomic(tmp_path, monkeypatch):
    """A remote fetch retries with backoff and never leaves a partial
    file; both packages call urlretrieve the same number of times."""
    calls = {}

    def flaky(url, part):
        calls[url] = calls.get(url, 0) + 1
        with open(part, "w") as f:
            f.write("partial" if calls[url] < 3 else "payload")
        if calls[url] < 3 or "always" in url:
            raise IOError("connection reset")

    monkeypatch.setattr(pacq.urllib.request, "urlretrieve", flaky)
    monkeypatch.setattr(time, "sleep", lambda s: None)
    for mod in (jacq, pacq):
        name = mod.__name__
        dest = tmp_path / f"{name}.txt"
        mod._fetch(f"https://example.org/{name}.txt", str(dest))
        assert dest.read_text() == "payload"
        assert not (tmp_path / f"{name}.txt.part").exists()
        with pytest.raises(IOError):
            mod._fetch(f"https://example.org/always/{name}", str(tmp_path / "g"))
        assert not (tmp_path / "g").exists() and not (tmp_path / "g.part").exists()
    assert sorted(calls.values()) == [3, 3, 3, 3]
    with pytest.raises(FileNotFoundError):
        pacq._fetch(str(tmp_path / "missing"), str(tmp_path / "x"))


def test_fetch_helpers_match_jax(local, tmp_path, monkeypatch):
    def run(mod, d):
        out = [mod.fetch_taxdump(d), mod.fetch_genome_size_files("ncbi", d),
               mod.fetch_genome_size_files("gtdb-226", d),
               mod.fetch_gtdb_tax(d)]
        with pytest.raises(ValueError, match="no genome size source"):
            mod.fetch_genome_size_files("skip", d)
        return [[os.path.relpath(p, d) for p in (o if isinstance(o, list)
                                                 else [o])] for o in out]

    want = run(jacq, str(tmp_path / "j"))
    got = run(pacq, str(tmp_path / "p"))
    assert got == want
    assert got[3] == ["ar53_taxonomy.tsv.gz", "bac120_taxonomy.tsv.gz"]
    for rel in sum(got, []):
        with open(tmp_path / "j" / rel, "rb") as a, \
                open(tmp_path / "p" / rel, "rb") as b:
            assert a.read() == b.read()
    # a tree without GTDB files
    empty = tmp_path / "empty"
    shutil.copytree(os.path.join(local["root"], "pub"), empty / "pub")
    monkeypatch.setenv("local_dir", str(empty))
    for mod in (jacq, pacq):
        with pytest.raises(FileNotFoundError, match="GTDB taxonomy"):
            mod.fetch_gtdb_tax(str(tmp_path / "x"))
        with pytest.raises(FileNotFoundError, match="GTDB metadata"):
            mod.fetch_genome_size_files("gtdb", str(tmp_path / "x"))
