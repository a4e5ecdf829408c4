"""``build`` and ``update`` through the port against the JAX package.

A fake repository tree (``ncbi_tree``) served through ``local_dir``:
RefSeq bacteria, archaea and viral assemblies with random genomes, a
replaced and an ``na`` row, the new_taxdump and the species genome sizes;
and a second state of the tree (one assembly replaced, one back, one
new). Each case runs ``ganon_tpu.cli.main`` and then the port's
``main(..., device="cpu")`` at the same database prefix and compares every
file under it: the filter (npz by arrays and header), ``.tax``,
``.info.tsv``, ``target_info.tsv``, ``config.pkl`` (as dicts), each
snapshot's assembly_summary.txt, changes.tsv and files, history.tsv and
the summary link. ``time.strftime`` is a counter, so snapshot names are
equal between the packages and distinct between calls.
"""

import io
import os
import pickle
import shutil
import time

import numpy as np
import pytest

from ganon_tpu.cli import main as jax_main
from ganon_tpu.config import Config as JaxConfig
from ganon_tpu_torch.acquire import VERSION_FORMAT
from ganon_tpu_torch.cli import main as port_main
from ganon_tpu_torch.config import Config as PortConfig
from ncbi_tree import (
    Assembly, write_genome_sizes, write_genomes, write_summaries,
    write_taxdump,
)

NODES = [("1", "1", "no rank"), ("2", "1", "superkingdom"),
         ("2157", "1", "superkingdom"), ("10239", "1", "superkingdom"),
         ("10", "2", "genus"), ("20", "2", "genus"), ("40", "2157", "genus"),
         ("60", "10239", "genus"), ("11", "10", "species"),
         ("12", "10", "species"), ("21", "20", "species"),
         ("41", "40", "species"), ("61", "60", "species"),
         ("111", "11", "strain")]


def _assemblies(rng, changed=False):
    def g(n):
        return "".join("ACGT"[b] for b in rng.integers(0, 4, size=n))

    status = {"GCF_000002.1": "replaced", "GCF_000007.1": "latest"} \
        if changed else {}
    rows = [
        ("GCF_000001.1", "11", "11", "bacteria"),
        ("GCF_000002.1", "111", "11", "bacteria"),
        ("GCF_000003.1", "12", "12", "bacteria"),
        ("GCF_000004.1", "21", "21", "bacteria"),
        ("GCF_000005.1", "21", "21", "bacteria"),
        ("GCF_000007.1", "12", "12", "bacteria"),
        ("GCF_000008.1", "11", "11", "bacteria"),
        ("GCF_000011.1", "41", "41", "archaea"),
        ("GCF_000012.1", "41", "41", "archaea"),
        ("GCF_000013.1", "61", "61", "viral"),
    ]
    out = []
    for i, (acc, taxid, sp, group) in enumerate(rows):
        st = status.get(acc, "replaced" if acc == "GCF_000007.1" else
                        "latest")
        out.append(Assembly(acc, taxid, sp, group=group, status=st,
                            organism=f"Org {taxid}", infra=f"strain=S{i}",
                            seq=g(2500 + 700 * (i % 5)),
                            ftp_na=acc == "GCF_000008.1"))
    if changed:
        out.append(Assembly("GCF_000009.1", "12", "12", seq=g(3100),
                            organism="Org 12", infra="strain=S9"))
    return out


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    out = {}
    for name, changed in (("v1", False), ("v2", True)):
        root = str(tmp_path_factory.mktemp(f"repo_{name}"))
        # the same seed: an assembly's genome is the same in both states
        rows = _assemblies(np.random.default_rng(7), changed)
        write_summaries(root, rows)
        write_genomes(root, rows)
        write_taxdump(root, NODES)
        write_genome_sizes(root, {"11": 4_100_000, "12": 4_200_000,
                                  "21": 5_000_000, "41": 2_000_000})
        out[name] = root
    return out


@pytest.fixture
def versions(monkeypatch):
    real = time.strftime
    state = {"n": 0, "names": None}

    def fake(fmt, *a):
        if fmt != VERSION_FORMAT:
            return real(fmt, *a)
        if state["names"]:
            return state["names"].pop(0)
        state["n"] += 1
        return f"2026-02-02_00-00-{state['n']:02d}"

    def reset(names=None):
        state["n"] = 0
        state["names"] = list(names) if names else None

    monkeypatch.setattr(time, "strftime", fake)
    return reset


def _outputs(prefix):
    """{relative name: bytes, or ("link", target) for a symlink} of every
    file under ``prefix``."""
    out = {}
    base = os.path.dirname(prefix)
    for root, _, names in os.walk(base):
        for n in names:
            p = os.path.join(root, n)
            if not p.startswith(prefix):
                continue
            if os.path.islink(p):
                out[os.path.relpath(p, base)] = ("link", os.readlink(p))
                continue
            with open(p, "rb") as f:
                out[os.path.relpath(p, base)] = f.read()
    return out


def _same_filter(a, b):
    if not a.startswith(b"PK"):
        return a == b
    za, zb = np.load(io.BytesIO(a)), np.load(io.BytesIO(b))
    return sorted(za.files) == sorted(zb.files) and all(
        np.array_equal(za[k], zb[k]) for k in za.files)


def _compare(want, got):
    assert sorted(want) == sorted(got)
    for name in want:
        if name.endswith("config.pkl"):
            assert pickle.loads(want[name]) == pickle.loads(got[name]), name
        elif name.endswith((".ibf", ".hibf")):
            assert _same_filter(want[name], got[name]), name
        else:
            assert want[name] == got[name], name


def _both(tmp_path, versions, steps, names=None, port_names=None):
    """``steps(make, run, prefix)`` for the JAX package, then the port,
    at one prefix (``make(which, **params)`` makes a Config); returns both
    outputs."""
    prefix = str(tmp_path / "db" / "x")
    res = []
    for config, run, nm in (
            (JaxConfig, lambda c: jax_main(cfg=c), names),
            (PortConfig, lambda c: port_main(cfg=c, device="cpu"),
             port_names or names)):
        shutil.rmtree(tmp_path / "db", ignore_errors=True)
        os.makedirs(tmp_path / "db")
        versions(nm)

        def make(which, **params):
            params = {"quiet": True, "keep_files": True,
                      "write_info_file": True, **params}
            if which != "update":
                params.setdefault("db_prefix", prefix)
            return config(which, **params)

        steps(make, run, prefix)
        res.append(_outputs(prefix))
    return res


def _info_targets(out, prefix_name="x"):
    return [ln.split(b"\t")[1] for ln in out[prefix_name + ".info.tsv"]
            .splitlines()]


def _edit_history(prefix, old, new):
    hist = prefix + "_files/history.tsv"
    with open(hist) as f:
        text = f.read()
    assert old in text
    with open(hist, "w") as f:
        f.write(text.replace(old, new))


BUILD = dict(source=["refseq"], threads=2, kmer_size=15, window_size=19)


def test_update_after_history_edit(trees, tmp_path, monkeypatch, versions):
    """build archaea+bacteria with the taxonomy and genome sizes fetched,
    history.tsv edited to add viral, update: the reference's own update
    test."""
    monkeypatch.setenv("local_dir", trees["v1"])

    def steps(make, run, prefix):
        assert run(make("build", organism_group=["archaea", "bacteria"],
                        **BUILD))
        _edit_history(prefix, "\tarchaea,bacteria\t",
                      "\tarchaea,bacteria,viral\t")
        assert run(make("update", db_prefix=prefix, threads=2))

    want, got = _both(tmp_path, versions, steps)
    _compare(want, got)
    assert len(_info_targets(got)) == 8
    assert any(n.endswith(".tax") for n in got)
    assert "x_files/2026-02-02_00-00-02/changes.tsv" in got


def test_update_after_the_tree_changes(trees, tmp_path, monkeypatch,
                                       versions):
    """build bacteria at --level species; the repository changes (one
    assembly replaced, one back, one new); update: changes.tsv holds
    them, the kept files are hard links to the first snapshot's."""
    def steps(make, run, prefix):
        monkeypatch.setenv("local_dir", trees["v1"])
        assert run(make("build", organism_group=["bacteria"], level="species",
                        **BUILD))
        monkeypatch.setenv("local_dir", trees["v2"])
        assert run(make("update", db_prefix=prefix, threads=2))
        v1, v2 = (prefix + f"_files/2026-02-02_00-00-0{i}/files" for i in
                  (1, 2))
        kept = sorted(set(os.listdir(v1)) & set(os.listdir(v2)))
        assert len(kept) == 4
        for f in kept:
            assert (os.stat(os.path.join(v1, f)).st_ino
                    == os.stat(os.path.join(v2, f)).st_ino)

    want, got = _both(tmp_path, versions, steps)
    _compare(want, got)
    assert got["x_files/2026-02-02_00-00-02/changes.tsv"] == (
        b"A\tGCF_000007.1\nA\tGCF_000009.1\nR\tGCF_000002.1\n")


def test_update_to_output_db_prefix(trees, tmp_path, monkeypatch, versions):
    """--output-db-prefix moves the snapshots, history, link and config to
    the new prefix's folder."""
    monkeypatch.setenv("local_dir", trees["v1"])

    def steps(make, run, prefix):
        assert run(make("build", organism_group=["archaea", "bacteria"],
                        taxonomy="skip", **BUILD))
        _edit_history(prefix, "\tarchaea,bacteria\t",
                      "\tarchaea,bacteria,viral\t")
        assert run(make("update", db_prefix=prefix, taxonomy="skip",
                        output_db_prefix=prefix + "2"))
        assert not os.path.exists(prefix + "_files")

    want, got = _both(tmp_path, versions, steps)
    _compare(want, got)
    saved = pickle.loads(got["x2_files/config.pkl"])
    assert saved["input"][0].endswith("x2_files/2026-02-02_00-00-02/files")
    assert len(_info_targets(got, "x2")) == 8
    assert "x2_files/history.tsv" in got


def test_update_without_history(trees, tmp_path, versions):
    """A build-custom database updates from the given --input (no
    acquisition)."""
    files = sorted(
        os.path.join(r, n) for r, _, ns in os.walk(trees["v1"]) for n in ns
        if n.endswith("_genomic.fna.gz"))

    def steps(make, run, prefix):
        assert run(make("build-custom", input=files[:4], taxonomy="skip",
                        kmer_size=15, window_size=19))
        assert run(make("update", db_prefix=prefix, input=files,
                        taxonomy="skip"))

    want, got = _both(tmp_path, versions, steps)
    _compare(want, got)
    assert len(_info_targets(got)) == len(files)
    assert not any("history.tsv" in n for n in got)


def test_build_resumes_after_download(trees, tmp_path, monkeypatch,
                                      versions, capfd):
    """With the download state left behind, a second build skips the
    download ("Download finished - skipping") and makes no snapshot."""
    monkeypatch.setenv("local_dir", trees["v1"])

    def steps(make, run, prefix):
        assert run(make("build", organism_group=["archaea"], **BUILD))
        open(prefix + "_files/.build_download", "w").close()
        monkeypatch.setenv("local_dir", trees["v2"])  # would change it
        assert run(make("build", organism_group=["archaea", "viral"],
                        **{**BUILD, "quiet": False}))
        monkeypatch.setenv("local_dir", trees["v1"])
        assert sorted(d for d in os.listdir(prefix + "_files")
                      if d.startswith("2026")) == ["2026-02-02_00-00-01"]

    want, got = _both(tmp_path, versions, steps)
    _compare(want, got)
    assert capfd.readouterr().err.count("Download finished - skipping") == 2


def test_build_and_update_in_the_same_second(trees, tmp_path, monkeypatch,
                                             versions):
    """An update named by the build's second: the JAX package reuses the
    build's snapshot, whose folder keeps the replaced assembly's file, and
    builds it into the database (a fault of the reference, ROADMAP queue
    3); the port makes a new snapshot and equals the JAX package's update
    a second later."""
    def steps(make, run, prefix):
        monkeypatch.setenv("local_dir", trees["v1"])
        assert run(make("build", organism_group=["bacteria"], taxonomy="skip",
                        **BUILD))
        monkeypatch.setenv("local_dir", trees["v2"])
        assert run(make("update", db_prefix=prefix, taxonomy="skip"))

    same = ["2026-02-02_00-00-01"] * 2
    fault, _ = _both(tmp_path, versions, steps, names=same)
    want, got = _both(tmp_path, versions, steps,
                      names=["2026-02-02_00-00-01", "2026-02-02_00-00-02"],
                      port_names=same + ["2026-02-02_00-00-02"])
    _compare(want, got)
    assert b"GCF_000002.1" in _info_targets(fault)
    assert b"GCF_000002.1" not in _info_targets(got)
    assert sorted(_info_targets(fault)) == sorted(
        _info_targets(got) + [b"GCF_000002.1"])
