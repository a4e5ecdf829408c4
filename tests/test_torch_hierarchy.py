"""Hierarchies and multi-database levels: the port against ``ganon_tpu``.

The device level: ``classify_batch_packed_multi`` (extract, per-filter
count + merge into union counts and winners, select with the winners
payload) returns the JAX function's int32 buffer exactly
(``match_cap=0``), with overlapping union targets, ties between filters,
winners that rel-filter drops and K below and above the match counts.

The engine: one ClassifyConfig drives both engines (the port with
``device="cpu"``, the plain versions of its kernels); every output file
of every level must be equal after sorting rows, ``.sta`` byte for byte.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ganon_tpu  # noqa: F401  (turns on jax x64)
from ganon_tpu.classify import device as jdev
from ganon_tpu.index.ibf import build_ibf as jax_build_ibf
from ganon_tpu_torch.classify import device as tdev
from ganon_tpu_torch.classify import engine as port_engine
from ganon_tpu_torch.classify.engine import ClassifyConfig, run_classify
from ganon_tpu_torch.index.builder import _HashExtractor
from ganon_tpu_torch.index.ibf import IBF
from tests.test_classify import build_db, read_tsv, write_fastq, write_tax
from tests.test_torch_device import _batch
from tests.test_torch_engine import run_both


def _rand(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def _revcomp(s):
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def _reads(rng, pools, n, w, prefix="q"):
    """Paired reads from the given {name: seq} pools (mixed lengths, a
    few below w) plus junk."""
    r1, r2 = {}, {}
    names = sorted(pools)
    for i in range(n):
        t = names[i % len(names)]
        s = pools[t]
        ln = rng.choice([150, 150, 110, rng.randint(w, 150), w - 3])
        a = rng.randrange(len(s) - 150)
        b = rng.randrange(len(s) - 150)
        r1[f"{prefix}{i}|{t}"] = s[a:a + ln]
        r2[f"{prefix}{i}|{t}"] = _revcomp(s[b:b + rng.choice([150, 10])])
    for i in range(6):
        r1[f"junk{i}"], r2[f"junk{i}"] = _rand(rng, 150), _rand(rng, 150)
    return r1, r2


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """Three flat databases: A (host-like, 4 targets), B and C sharing
    targets with A and each other (same genome: ties; other genome: the
    content differs), with a .tax each, and paired reads over all."""
    tmp = tmp_path_factory.mktemp("hier")
    rng = random.Random(4242)
    shared = _rand(rng, 900)
    core = _rand(rng, 400)
    refs_a = {f"H{i}": _rand(rng, 900) for i in range(3)}
    refs_a["AMB"] = shared
    refs_b = {f"B{i}": core + _rand(rng, 500) for i in range(3)}
    refs_b["AMB"] = shared  # same genome as in A: ties
    refs_b["X"] = _rand(rng, 900)
    refs_c = {"X": _rand(rng, 300) + refs_b["X"][300:], "C0": _rand(rng, 900)}
    out = {}
    for name, refs, fp in (("A", refs_a, 0.05), ("B", refs_b, 0.01),
                           ("C", refs_c, 0.05)):
        out[name] = build_db(tmp, refs, name=name, k=19, w=31, max_fp=fp)
        rows = [("1", "0", "no rank", "root"), ("G", "1", "genus", "G")]
        rows += [(t, "G", "species", t) for t in sorted(refs)]
        out[name + "_tax"] = write_tax(tmp / f"{name}.tax", rows)
    pools = {**refs_a, **refs_b, **{"X2": refs_c["X"], "C0": refs_c["C0"]}}
    r1, r2 = _reads(rng, pools, 120, 31)
    write_fastq(tmp / "r1.fq", r1)
    write_fastq(tmp / "r2.fq", r2)
    out["reads"] = [str(tmp / "r1.fq"), str(tmp / "r2.fq")]
    return out


# --------------------------------------------------------------------------
# device level: classify_batch_packed_multi


def _flat_filters(seed, k, w, n_filters):
    """Flat filters with overlapping target names: ``S`` is the same
    genome in every filter (ties), ``D`` a different genome per filter;
    ``P{f}`` (and ``Q`` in filter 0) share half a genome, so reads match
    several union columns. Filter 2 holds ``S`` alone."""
    rng = np.random.default_rng(seed)

    def genome(n=2500):
        return rng.integers(0, 4, size=n, dtype=np.uint8)

    shared, fam = genome(), genome(1250)
    genomes, jfs, tfs, names = [], [], [], []
    for f in range(n_filters):
        gs = {"S": shared, "D": genome(),
              f"P{f}": np.concatenate([fam, genome(1250)])}
        if f == 0:
            gs["Q"] = np.concatenate([fam, genome(1250)])
        if f == 2:
            gs = {"S": shared}
        ex = _HashExtractor(k, w, device="cpu")
        for t, g in gs.items():
            ex.add_encoded(t, g)
        ibf = jax_build_ibf(ex.finish(), kmer_size=k, window_size=w,
                            max_fp=(0.05, 0.01, 0.2)[f])
        jfs.append(jdev.DeviceFilter(ibf))
        tfs.append(tdev.DeviceFilter(IBF.from_arrays(
            ibf.bits, ibf.ibf_config.to_dict(), ibf.hashes_count,
            ibf.bin_map), "cpu"))
        genomes += list(gs.values())
        names.append(list(ibf.targets()))
    union, cols = [], []
    for tn in names:
        c = []
        for t in tn:
            if t not in union:
                union.append(t)
            c.append(union.index(t))
        cols.append(np.asarray(c, np.int32))
    return np.stack(genomes), jfs, tfs, union, cols


@pytest.mark.parametrize("n_filters", [2, 3])
@pytest.mark.parametrize("top_k,emit,cuts", [
    (2, True, ((0.25, 0.1, 0.5), 0.1)),
    (64, False, ((0.05, 0.6, 0.0), 1.0)),
    (1, False, ((0.3, 0.3, 0.3), 0.0)),
], ids=["k2", "k-all", "k1"])
def test_classify_batch_packed_multi_matches_jax(n_filters, top_k, emit,
                                                 cuts):
    k, w = 19, 31
    genomes, jfs, tfs, union, cols = _flat_filters(9, k, w, n_filters)
    rel_cutoffs, rel_filter = cuts[0][:n_filters], cuts[1]
    rng = np.random.default_rng(n_filters + top_k)
    batch = _batch(rng, genomes, 200, True, w)
    inbuf, L1, L2 = jdev.pack_batch_direct(batch, 256)
    U = len(union)
    K = min(top_k, U)
    want = np.asarray(jdev.classify_batch_packed_multi(
        tuple(f.tbl8 for f in jfs), tuple(f.byte_starts for f in jfs),
        tuple(f.byte_ends for f in jfs),
        tuple(jnp.asarray(c) for c in cols), jnp.asarray(inbuf),
        jnp.asarray(rel_cutoffs, dtype=jnp.float64), rel_filter, 65535,
        k=k, w=w, L1=L1, L2=L2,
        sub_params=tuple((f.ibf_config.bin_size_bits,
                          f.ibf_config.hash_functions) for f in jfs),
        num_union=U, top_k=K, match_cap=0, emit_matches_t=emit,
    ))
    got = tdev.classify_batch_packed_multi(
        tfs, [torch.from_numpy(c) for c in cols], torch.from_numpy(inbuf),
        list(rel_cutoffs), rel_filter, 65535, k=k, w=w, L1=L1, L2=L2,
        num_union=U, top_k=K, emit_matches_t=emit,
    )
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    res = tdev.unpack_batch_result(got.numpy(), 256, K, U,
                                   has_matches_t=emit, has_win=True)
    nm = res["n_matches"]
    assert nm.any()
    if top_k < 64:
        assert (nm > K).any()  # K below some reads' match counts
    else:
        # K = U: at or above every read's match count, with padding
        assert (nm <= K).all() and (nm < K).any()
    # some matches were won by a later filter, and where every filter's
    # candidate for S (its count past its own cutoff) is alike, a tie, the
    # first filter keeps it
    valid = np.arange(K)[None, :] < np.minimum(nm, K)[:, None]
    assert (res["top_win"][valid] > 0).any()
    h, n, _ = tdev._extract_compact(torch.from_numpy(inbuf), k=k, w=w,
                                    L1=L1, L2=L2)
    cand = []
    for f, c, rc in zip(tfs, cols, rel_cutoffs):
        cs = f.counts(h, n).numpy()[:, list(c).index(union.index("S"))]
        cut = np.maximum(np.ceil(n.numpy() * rc), 1)
        cand.append(np.where(cs >= cut, cs, 0))
    cand = np.stack(cand, axis=1)
    tie = (cand == cand[:, :1]).all(axis=1)
    s_hits = valid & (res["top_idx"] == union.index("S")) & tie[:, None]
    assert s_hits.any() and (res["top_win"][s_hits] == 0).all()
    if rel_filter < 1.0 and emit:
        assert res["disc_t"].any()  # winners the rel-filter then dropped


def test_merge_plain_strict_greater_first_wins():
    """Two filters over overlapping union columns: ties keep filter 0,
    a larger later count takes over, cutoffs and invalid reads give 0."""
    n = torch.tensor([10, 10, 0, 70000], dtype=torch.int32)
    uc = torch.zeros((4, 3), dtype=torch.int32)
    uw = torch.zeros_like(uc)
    c0 = torch.tensor([[5, 7], [2, 9], [3, 3], [9, 9]], dtype=torch.int32)
    c1 = torch.tensor([[5, 8], [9, 1], [3, 3], [9, 9]], dtype=torch.int32)
    tdev.merge(c0, n, 0.3, 65535, torch.tensor([0, 1], dtype=torch.int32), 0,
               uc, uw)
    tdev.merge(c1, n, 0.3, 65535, torch.tensor([1, 2], dtype=torch.int32), 1,
               uc, uw)
    assert uc.tolist() == [[5, 7, 8], [0, 9, 0], [0, 0, 0], [0, 0, 0]]
    assert uw.tolist() == [[0, 0, 1], [0, 0, 0], [0, 0, 0], [0, 0, 0]]
    tdev.merge(c1, n, 0.3, 65535, torch.tensor([0, 1], dtype=torch.int32), 2,
               uc, uw)  # equal 5 at col 0 stays; 8 > 7 at col 1 wins
    assert uc[0].tolist() == [5, 8, 8] and uw[0].tolist() == [0, 2, 1]
    assert uc[1].tolist() == [9, 9, 0] and uw[1].tolist() == [2, 0, 0]


# --------------------------------------------------------------------------
# engine level


@pytest.mark.parametrize("fpr,single", [(1e-5, False), (1.0, True)],
                         ids=["fpr-on", "fpr-off-output-single"])
def test_two_level_hierarchy_matches_jax(tmp_path, monkeypatch, dbs, fpr,
                                         single):
    port, _ = run_both(
        tmp_path, monkeypatch, ibf=[dbs["A"], dbs["B"]],
        tax=[dbs["A_tax"], dbs["B_tax"]], hierarchy_labels=["1_a", "2_b"],
        paired_reads=dbs["reads"], rel_cutoff=[0.5, 0.75],
        rel_filter=[0.1, 0.5], fpr_query=[fpr], output_lca=True,
        output_all=True, output_unclassified=True, output_stats=True,
        output_single=single,
    )
    if not single:
        assert read_tsv(port + ".1_a.all") and read_tsv(port + ".2_b.all")


@pytest.mark.parametrize("fpr", [1e-5, 1.0], ids=["fpr-on", "fpr-off"])
def test_two_filters_one_level_matches_jax(tmp_path, monkeypatch, dbs, fpr):
    _, calls = run_both(
        tmp_path, monkeypatch, ibf=[dbs["B"], dbs["C"]],
        tax=[dbs["B_tax"], dbs["C_tax"]], paired_reads=dbs["reads"],
        rel_cutoff=[0.3, 0.6], rel_filter=[0.2], fpr_query=[fpr],
        output_lca=True, output_all=True, output_unclassified=True,
        output_stats=True,
    )
    assert calls["fallback"] == 0  # the multi-filter fast path ran


def test_three_databases_two_levels_matches_jax(tmp_path, monkeypatch, dbs):
    """The CLI's shape: ``--db-prefix A B C --hierarchy-labels 1_x 2_y
    2_y``, small batches so leftovers coalesce across many dispatches."""
    port, calls = run_both(
        tmp_path, monkeypatch, ibf=[dbs["A"], dbs["B"], dbs["C"]],
        hierarchy_labels=["1_x", "2_y", "2_y"], paired_reads=dbs["reads"],
        rel_cutoff=[0.75], rel_filter=[0.1], fpr_query=[1e-5], n_reads=16,
        output_all=True, output_unclassified=True, output_stats=True,
    )
    assert read_tsv(port + ".2_y.all")
    assert calls["dispatch"] > 2 and calls["fallback"] == 0


def test_multi_level_topk_escalation_matches_jax(tmp_path, monkeypatch):
    """40 targets share one core across two databases: core reads match
    more than the starting width of 32 on the multi level."""
    rng = random.Random(77)
    core = _rand(rng, 400)
    refs1 = {f"T{i:02d}": core + _rand(rng, 150) for i in range(20)}
    refs2 = {f"U{i:02d}": core + _rand(rng, 150) for i in range(20)}
    db1 = build_db(tmp_path, refs1, name="m1", k=15, w=31, max_fp=0.05)
    db2 = build_db(tmp_path, refs2, name="m2", k=15, w=31, max_fp=0.05)
    reads = {f"core{i}": core[s:s + 120]
             for i, s in enumerate(range(0, 280, 20))}
    reads.update({f"own{i}": refs2[f"U{i:02d}"][420:540] for i in range(10)})
    write_fastq(tmp_path / "r.fq", reads)
    jax_calls = {}
    port, calls = run_both(
        tmp_path, monkeypatch, ibf=[db1, db2],
        single_reads=[str(tmp_path / "r.fq")], rel_cutoff=[0.5],
        rel_filter=[1.0], fpr_query=[1.0], output_all=True,
        output_unclassified=True, output_stats=True, jax_calls=jax_calls)
    assert sum(1 for r in read_tsv(port + ".all") if r[0] == "core0") > 32
    # the wider K's dispatch follows the ragged stream's cap overflow
    assert calls == jax_calls == {"dispatch": 3, "fallback": 0}


@pytest.mark.parametrize("thresholding", [True, False],
                         ids=["compaction-overflow", "device-thresholding-off"])
def test_multi_level_exact_fallback_matches_jax(tmp_path, monkeypatch,
                                                thresholding):
    """k=19, w=20 emits densely: reads overflow the compaction width, and
    the multi-filter level takes the exact host union path (as it does
    with device thresholding off), under a second level."""
    rng = random.Random(5)
    shared = _rand(rng, 1200)
    refs1 = {f"A{i}": _rand(rng, 1200) for i in range(3)} | {"S": shared}
    refs2 = {f"B{i}": _rand(rng, 1200) for i in range(2)} | {"S": shared}
    refs3 = {"Z": _rand(rng, 1200)}
    dbs_ = [build_db(tmp_path, r, name=n, k=19, w=20, max_fp=0.05)
            for n, r in (("o1", refs1), ("o2", refs2), ("o3", refs3))]
    r1, r2 = _reads(rng, refs1 | refs2 | refs3, 60, 20)
    write_fastq(tmp_path / "r1.fq", r1)
    write_fastq(tmp_path / "r2.fq", r2)
    _, calls = run_both(
        tmp_path, monkeypatch, ibf=dbs_, hierarchy_labels=["a", "a", "b"],
        paired_reads=[str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")],
        rel_cutoff=[0.3, 0.5, 0.3], rel_filter=[0.2, 0.0],
        fpr_query=[1e-3, 1.0], device_thresholding=thresholding,
        output_all=True, output_unclassified=True, output_stats=True)
    assert calls["fallback"] >= 1


def test_cli_passes_several_databases(tmp_path, monkeypatch, dbs):
    """``ganon_tpu_torch.cli`` with several --db-prefix, --hierarchy-labels,
    per-filter --rel-cutoff and per-level --rel-filter / --fpr-query
    writes what ``run_classify`` writes for the same ClassifyConfig (the
    CLI's config is moved to the CPU here: the CLI runs on CUDA)."""
    from ganon_tpu_torch import cli

    seen = []

    def on_cpu(cfg, _run=port_engine.run_classify):
        seen.append(cfg)
        cfg.device = "cpu"
        return _run(cfg)

    monkeypatch.setattr(port_engine, "run_classify", on_cpu)
    prefixes = [p[:-4] for p in (dbs["A"], dbs["B"], dbs["C"])]
    out = str(tmp_path / "cli")
    cli.main("classify", db_prefix=prefixes, paired_reads=dbs["reads"],
             hierarchy_labels=["1_x", "2_y", "2_y"],
             rel_cutoff=[0.5, 0.3, 0.6], rel_filter=[0.1, 0.2],
             fpr_query=[1e-5, 1.0], output_prefix=out, output_all=True,
             output_unclassified=True, multiple_matches="lca",
             output_one=True, skip_report=True, quiet=True)
    assert [c.hierarchy_labels for c in seen] == [["1_x", "2_y", "2_y"]]
    ref = str(tmp_path / "ref")
    run_classify(ClassifyConfig(
        ibf=[dbs["A"], dbs["B"], dbs["C"]],
        tax=[dbs["A_tax"], dbs["B_tax"], dbs["C_tax"]],
        hierarchy_labels=["1_x", "2_y", "2_y"], paired_reads=dbs["reads"],
        rel_cutoff=[0.5, 0.3, 0.6], rel_filter=[0.1, 0.2],
        fpr_query=[1e-5, 1.0], output_prefix=ref, output_all=True,
        output_lca=True, output_unclassified=True, device="cpu"))
    for ext in (".1_x.all", ".2_y.all", ".1_x.one", ".2_y.one", ".unc",
                ".rep"):
        assert sorted(read_tsv(out + ext)) == sorted(read_tsv(ref + ext)), ext
    assert read_tsv(out + ".2_y.all")
