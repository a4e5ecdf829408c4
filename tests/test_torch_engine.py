"""The port's engine against ``ganon_tpu``'s on the same seeded databases.

One ClassifyConfig drives both engines (the port runs with
``device="cpu"``, the plain versions of its kernels). Every output file
(``.rep``, ``.all``, ``.one``, ``.unc``, per level where there are
several) must be equal after sorting rows (row order is not canonical)
and ``.sta`` byte for byte.
"""

import os
import random

import pytest

import ganon_tpu  # noqa: F401  (turns on jax x64)
from ganon_tpu.classify.engine import ClassifyConfig as JaxConfig
from ganon_tpu.classify.engine import run_classify as jax_run_classify
from ganon_tpu_torch.classify import engine as port_engine
from ganon_tpu_torch.classify.engine import ClassifyConfig, run_classify
from tests.test_classify import build_db, read_tsv, write_fastq, write_tax
from tests.test_fuzz_equivalence import _mk_case


def _revcomp(s):
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def _families(rng, n_targets, n_families, core, own):
    """Targets sharing a per-family core segment, so reads from the core
    match several targets (multi-matches, LCA, top-K overflow)."""
    cores = ["".join(rng.choice("ACGT") for _ in range(core))
             for _ in range(n_families)]
    return {
        f"T{t:02d}": cores[t % n_families]
        + "".join(rng.choice("ACGT") for _ in range(own))
        for t in range(n_targets)
    }


def _paired_reads(rng, refs, n, w):
    r1, r2 = {}, {}
    names = sorted(refs)
    for i in range(n):
        t = names[rng.randrange(len(names))]
        ln = rng.choice([150, 150, 120, rng.randint(w, 150), w - 3])
        s1 = rng.randrange(len(refs[t]) - 150)
        s2 = rng.randrange(len(refs[t]) - 150)
        r1[f"q{i}|{t}"] = refs[t][s1:s1 + ln]
        r2[f"q{i}|{t}"] = _revcomp(refs[t][s2:s2 + rng.choice([150, 10])])
    for i in range(8):
        r1[f"junk{i}"] = "".join(rng.choice("ACGT") for _ in range(150))
        r2[f"junk{i}"] = "".join(rng.choice("ACGT") for _ in range(150))
    return r1, r2


def _tax(path, refs, n_genera):
    rows = [("1", "0", "no rank", "root")]
    rows += [(f"G{g}", "1", "genus", f"G{g}") for g in range(n_genera)]
    rows += [(t, f"G{i % n_genera}", "species", t)
             for i, t in enumerate(sorted(refs))]
    return write_tax(path, rows)


def run_both(tmp_path, monkeypatch, jax_kw=None, **kw):
    """Run both engines on one config; every output file (per level and
    per prefix) must agree: sorted rows, ``.sta`` byte for byte.
    ``jax_kw`` overrides fields of the JAX engine's config only.
    Returns the port's output prefix and how often it dispatched a batch
    and took the exact fallback."""
    calls = {"dispatch": 0, "fallback": 0}
    for fn, key in (("_dispatch_batch_fast", "dispatch"),
                    ("_classify_batch", "fallback")):
        def counted(*a, _f=getattr(port_engine, fn), _k=key, **k):
            calls[_k] += 1
            return _f(*a, **k)
        monkeypatch.setattr(port_engine, fn, counted)
    outs = {}
    for name, cfg in (("jax", JaxConfig(use_mesh=False,
                                        **{**kw, **(jax_kw or {})})),
                      ("port", ClassifyConfig(device="cpu", **kw))):
        d = tmp_path / name
        d.mkdir()
        cfg.output_prefix = str(d / "out")
        (jax_run_classify if name == "jax" else run_classify)(cfg)
        outs[name] = d
    files = sorted(os.listdir(outs["jax"]))
    assert sorted(os.listdir(outs["port"])) == files
    for fn in files:
        a, b = outs["jax"] / fn, outs["port"] / fn
        if fn.endswith(".sta"):
            assert b.read_bytes() == a.read_bytes(), fn
        else:
            assert (sorted(map(tuple, read_tsv(b)))
                    == sorted(map(tuple, read_tsv(a)))), fn
    return str(outs["port"] / "out"), calls


@pytest.fixture(scope="module")
def family_db(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("family")
    rng = random.Random(1234)
    refs = _families(rng, 12, 3, core=500, own=900)
    db = build_db(tmp, refs, k=19, w=31, max_fp=0.05)
    r1, r2 = _paired_reads(rng, refs, 160, w=31)
    write_fastq(tmp / "r1.fq", r1)
    write_fastq(tmp / "r2.fq", r2)
    return dict(ibf=[db], tax=[_tax(tmp / "db.tax", refs, 3)],
                paired_reads=[str(tmp / "r1.fq"), str(tmp / "r2.fq")])


@pytest.mark.parametrize("thresholds", [
    dict(rel_cutoff=[0.75], rel_filter=[0.1], fpr_query=[1e-5]),
    dict(rel_cutoff=[0.25], rel_filter=[1.0], fpr_query=[1.0]),
], ids=["cli-defaults", "rel-filter-1"])
def test_engine_matches_jax_with_lca(tmp_path, monkeypatch, family_db,
                                    thresholds):
    port, _ = run_both(tmp_path, monkeypatch, **family_db, **thresholds,
                       output_lca=True, output_all=True,
                       output_unclassified=True, output_stats=True)
    assert read_tsv(port + ".one")  # the case classifies reads


@pytest.mark.parametrize("top_k,fpr", [(128, 1.0), (4, 1e-2)],
                         ids=["escalate-32-to-128", "overflow-full-matrix"])
def test_engine_matches_jax_topk(tmp_path_factory, tmp_path, monkeypatch,
                                 top_k, fpr):
    """40 targets share one core: core reads match all of them, past the
    starting top-K width of 32 (escalation) or past top_k_matches (the
    full-matrix host path)."""
    tmp = tmp_path_factory.mktemp("topk")
    rng = random.Random(77)
    refs = _families(rng, 40, 1, core=400, own=150)
    db = build_db(tmp, refs, k=15, w=31, max_fp=0.05)
    reads = {f"core{i}": refs["T00"][s:s + 120]
             for i, s in enumerate(range(0, 280, 20))}
    reads.update({f"own{i}": refs[f"T{i:02d}"][420:540] for i in range(10)})
    write_fastq(tmp / "r.fq", reads)
    port, calls = run_both(
        tmp_path, monkeypatch, ibf=[db], single_reads=[str(tmp / "r.fq")],
        rel_cutoff=[0.5], rel_filter=[1.0], fpr_query=[fpr],
        top_k_matches=top_k, output_all=True, output_unclassified=True,
        output_stats=True)
    n_core = sum(1 for r in read_tsv(port + ".all")
                 if r[0] == "core0")
    assert n_core > 32
    if top_k > 32:  # one batch, dispatched again at the wider K
        assert calls == {"dispatch": 2, "fallback": 0}
    else:  # past top_k_matches: the exact full-matrix path
        assert calls["fallback"] >= 1


def test_engine_matches_jax_compaction_overflow(tmp_path, monkeypatch):
    """k=19, w=20 emits densely: reads overflow the compaction width and
    take the uncompacted fallback."""
    rng = random.Random(5)
    refs = _families(rng, 6, 2, core=300, own=700)
    db = build_db(tmp_path, refs, k=19, w=20, max_fp=0.05)
    r1, r2 = _paired_reads(rng, refs, 60, w=20)
    write_fastq(tmp_path / "r1.fq", r1)
    write_fastq(tmp_path / "r2.fq", r2)
    _, calls = run_both(
        tmp_path, monkeypatch, ibf=[db],
        paired_reads=[str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")],
        rel_cutoff=[0.3], rel_filter=[0.2], fpr_query=[1.0],
        output_all=True, output_unclassified=True, output_stats=True)
    assert calls["fallback"] >= 1


@pytest.mark.parametrize("seed", [202, 505])
def test_engine_matches_jax_short_reads(tmp_path, monkeypatch, seed):
    """The fuzz generator: 18-70 bp reads, junk and reads below w."""
    rng = random.Random(seed)
    k = rng.choice([8, 10, 12])
    w = k + rng.choice([0, 2, 4])
    paired = seed == 505
    refs, reads1, reads2 = _mk_case(rng, n_targets=6, ref_len=400,
                                    n_reads=40, paired=paired)
    db = build_db(tmp_path, refs, k=k, w=w, max_fp=0.05)
    write_fastq(tmp_path / "r1.fq", reads1)
    files = dict(single_reads=[str(tmp_path / "r1.fq")])
    if paired:
        write_fastq(tmp_path / "r2.fq", reads2)
        files = dict(paired_reads=[str(tmp_path / "r1.fq"),
                                   str(tmp_path / "r2.fq")])
    run_both(tmp_path, monkeypatch, ibf=[db], **files, rel_cutoff=[0.3],
              rel_filter=[0.5], fpr_query=[1e-2], output_all=True,
              output_unclassified=True, output_stats=True)


def test_device_thresholding_off_matches_jax(tmp_path, monkeypatch,
                                             family_db):
    _, calls = run_both(
        tmp_path, monkeypatch, **family_db, rel_cutoff=[0.5],
        rel_filter=[0.1], fpr_query=[1e-5], device_thresholding=False,
        output_lca=True, output_all=True, output_stats=True)
    assert calls["fallback"] >= 1
