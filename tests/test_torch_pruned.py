"""Merged-bin pruned forests: the port against ``ganon_tpu``.

The build (``build_pruned``, on the host and through the plain version of
the scatter kernel's pruned mode) gives the JAX build's tables; each
package loads the npz and raw files the other writes; the gate and fine
stages and the probe-all counts equal the JAX programs' on the same
hashes; ``classify_batch_packed_pruned`` (extract, gate, fine, select in
lanes mode) returns the JAX function's int32 buffer exactly
(``match_cap=0, pair_cap=0``); and the engine classifies a pruned level,
alone, in a hierarchy or beside a flat filter, at more than 65,535
targets, on the fast path and on the exact fallbacks, to the JAX
engine's outputs (sorted rows, ``.sta`` byte-equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ganon_tpu  # noqa: F401  (turns on jax x64)
from ganon_tpu.classify import device as jdev
from ganon_tpu.index.pruned import PrunedForest as JaxPrunedForest
from ganon_tpu.index.pruned import build_pruned as jax_build_pruned
from ganon_tpu.ops.ibf_query import ibf_row_indices as jax_row_indices
from ganon_tpu_torch.classify import device as tdev
from ganon_tpu_torch.index.builder import _HashExtractor
from ganon_tpu_torch.index.pruned import PrunedForest, build_pruned
from ganon_tpu_torch.ops import pruned_query as pq
from tests.test_classify import build_db, read_tsv, write_fastq, write_tax
from tests.test_torch_device import _batch
from tests.test_torch_engine import run_both

K, W = 19, 31


def _hashes(genomes: dict):
    ex = _HashExtractor(K, W, device="cpu")
    for t, g in genomes.items():
        ex.add_encoded(t, g)
    return ex.finish()


def _genomes(seed, n, lo=1200, hi=3000, core=0, n_core=0):
    """Random genomes of mixed lengths (groups get different bin sizes);
    the first ``n_core`` start with one shared ``core`` segment."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 4, size=core, dtype=np.uint8)
    out = {}
    for i in range(n):
        g = rng.integers(0, 4, size=int(rng.integers(lo, hi)), dtype=np.uint8)
        if i < n_core:
            g = np.concatenate([shared, g])
        out[f"P{i:03d}"] = g
    return out


def _assert_same_forest(a, b):
    assert np.array_equal(np.asarray(a.fine), np.asarray(b.fine))
    assert np.array_equal(np.asarray(a.coarse), np.asarray(b.coarse))
    assert a.targets() == b.targets()
    assert a.hashes_count == b.hashes_count
    for name in ("grp_bin_size", "grp_row_off", "grp_ntargets"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    for name in ("coarse_bin_size", "group_size", "fine_h", "coarse_h",
                 "max_fp", "coarse_fp"):
        assert getattr(a, name) == getattr(b, name), name
    assert a.ibf_config.to_dict() == b.ibf_config.to_dict()
    assert a.target_fpr() == b.target_fpr()


@pytest.fixture(scope="module")
def genomes():
    return _genomes(5, 300, lo=800, hi=2200, core=500, n_core=6)


@pytest.fixture(scope="module")
def hashes(genomes):
    return _hashes(genomes)


@pytest.fixture(scope="module", params=[16, 64], ids=["gs16", "gs64"])
def forest(request, hashes):
    """(JAX forest, the port's DevicePrunedForest on the CPU, JAX's
    DevicePrunedForest) at one group size."""
    jp = jax_build_pruned(hashes, kmer_size=K, window_size=W, max_fp=0.05,
                          group_size=request.param)
    return jp, tdev.DevicePrunedForest(jp, "cpu"), jdev.DevicePrunedForest(jp)


# --------------------------------------------------------------------------
# build and files


@pytest.mark.parametrize("gs", [16, 64])
@pytest.mark.parametrize("fine_h,coarse_h", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_build_pruned_matches_jax(hashes, gs, fine_h, coarse_h):
    kw = dict(kmer_size=K, window_size=W, max_fp=0.05, fine_h=fine_h,
              coarse_h=coarse_h, group_size=gs)
    want = jax_build_pruned(hashes, **kw)
    assert want.num_groups > 2
    for device in (False, "cpu"):  # host sort-reduce; plain pruned scatter
        _assert_same_forest(build_pruned(hashes, device=device, **kw), want)


@pytest.mark.parametrize("raw", [False, True], ids=["npz", "raw"])
def test_pruned_files_cross_load(tmp_path, hashes, raw):
    jp = jax_build_pruned(hashes, kmer_size=K, window_size=W, group_size=16)
    a, b = str(tmp_path / "jax.hibf"), str(tmp_path / "port.hibf")
    (jp.save_raw if raw else jp.save)(a)
    port = PrunedForest.load(a)
    _assert_same_forest(port, jp)
    (port.save_raw if raw else port.save)(b)
    _assert_same_forest(JaxPrunedForest.load(b), jp)
    if raw:
        assert open(a, "rb").read() == open(b, "rb").read()
    for path in (a, b):  # either package's file opens on the device
        f = tdev.load_device_filter(path, "cpu")
        assert isinstance(f, tdev.DevicePrunedForest)
        assert f.targets == jp.targets()
        assert f.num_groups == jp.num_groups


# --------------------------------------------------------------------------
# gate, fine, probe-all


def _read_hashes(genomes, seed, n=200, chimeric=True):
    """Compacted read hashes (port extract) of a batch of paired reads:
    sampled, junk and short reads, some chimeric across two targets."""
    rng = np.random.default_rng(seed)
    pool = np.stack([np.resize(g, 1500) for g in genomes.values()])
    batch = _batch(rng, pool, n, True, W)
    if chimeric:  # mate 2 from another target: reads in two groups
        other = rng.integers(0, len(pool), size=n)
        for i in range(0, n, 3):
            p = int(rng.integers(0, 1500 - 150))
            batch.codes2[i] = 3 - pool[other[i], p:p + 150][::-1]
    inbuf, L1, L2 = tdev.pack_batch_direct(batch, n)
    return tdev._extract_compact(torch.from_numpy(inbuf), k=K, w=W, L1=L1,
                                 L2=L2)


def _jax_gate(jf, hashes, n, rel_cutoff, hashes_limit, S, overflow):
    """The JAX program's coarse stage (classify_batch_packed_pruned,
    device.py:1168-1192) on given hashes."""
    h = jnp.asarray(hashes.numpy().view(np.uint64))
    nj = jnp.asarray(n.numpy())
    mask = jnp.arange(h.shape[1])[None, :] < nj[:, None]
    crows = jax_row_indices(h, bin_size=jf.coarse_bin_size,
                            hash_functions=jf.coarse_h)
    gcounts = jdev.bulk_group_counts(jf.ctbl, crows, mask,
                                     num_groups=jf.num_groups)
    cutoff = jnp.maximum(jnp.ceil(nj.astype(jnp.float64) * rel_cutoff),
                         1.0).astype(jnp.int32)
    valid = (nj > 0) & (nj <= hashes_limit)
    surv = (gcounts >= cutoff[:, None]) & valid[:, None]
    ovf = jnp.asarray(overflow.numpy().astype(bool)) | (surv.sum(axis=1) > S)
    keyed = jnp.where(surv, gcounts, -1)
    rows_b = jnp.arange(h.shape[0])
    sel, ok_ = [], []
    for _ in range(S):
        j = jnp.argmax(keyed, axis=1)
        ok = jnp.take_along_axis(keyed, j[:, None], axis=1)[:, 0] >= 0
        sel.append(jnp.where(ok, j, 0))
        ok_.append(ok)
        keyed = keyed.at[rows_b, j].set(-1)
    return (np.asarray(jnp.stack(sel, 1)), np.asarray(jnp.stack(ok_, 1)),
            np.asarray(ovf), np.asarray(surv), np.asarray(gcounts))


@pytest.mark.parametrize("S", [1, 2, 3])
@pytest.mark.parametrize("cut", [0.1, 0.3])
def test_gate_matches_jax(genomes, forest, S, cut):
    jp, tf, jf = forest
    h, n, ovf = _read_hashes(genomes, S * 10 + int(cut * 10))
    n = n.clone()
    n[:3] = torch.tensor([0, 70000, h.shape[1] + 9])  # invalid, over the
    # limit, and a read with more hashes than compaction slots
    want = _jax_gate(jf, h, n, cut, 65535, S, ovf)
    got = pq.gate(tf.ctbl, h, n, coarse_bin_size=tf.coarse_bin_size,
                  coarse_h=tf.coarse_h, num_groups=tf.num_groups,
                  rel_cutoff=cut, hashes_limit=65535, max_groups=S,
                  overflow=ovf, want_surv=True)
    for a, b in zip(got, want[:4]):
        assert np.array_equal(a.numpy().astype(b.dtype), b)
    surv, gcounts = want[3], want[4]
    n_surv = surv.sum(1)
    assert (n_surv == 0).any() and (n_surv == S).any()
    if cut < 0.2:  # a low cutoff lets more groups than slots survive
        assert (n_surv > S).any() and want[2][3:].any()
    # the tie rule is exercised: a chosen slot ties another survivor
    chosen = np.take_along_axis(gcounts, want[0], 1)
    assert any((gcounts[b][surv[b]] == c).sum() > 1
               for b in range(len(n)) for c in chosen[b][want[1][b]])


def test_gate_tie_rule_on_random_tables(forest):
    """A dense random coarse table makes equal group counts common: the
    top-S order is descending count, then the lower group id."""
    jp, tf, jf = forest
    rng = np.random.default_rng(1)
    G, R = 37, 512
    ctbl8 = rng.integers(0, 256, size=(R, -(-G // 8)), dtype=np.uint8)
    jctbl = jnp.asarray(jdev.table_as_u32(ctbl8))
    tctbl = torch.from_numpy(jdev.table_as_u32(ctbl8).view(np.uint8))
    B, M = 300, 24
    h = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, size=(B, M)))
    n = torch.from_numpy(rng.integers(0, M + 4, size=B).astype(np.int32))
    ovf = torch.zeros(B, dtype=torch.uint8)

    class J:
        ctbl, coarse_bin_size, coarse_h, num_groups = jctbl, R, 2, G

    for S in (1, 3):
        want = _jax_gate(J, h, n, 0.25, 65535, S, ovf)
        got = pq.gate(tctbl, h, n, coarse_bin_size=R, coarse_h=2,
                      num_groups=G, rel_cutoff=0.25, hashes_limit=65535,
                      max_groups=S, overflow=ovf, want_surv=True)
        for a, b in zip(got, want[:4]):
            assert np.array_equal(a.numpy().astype(b.dtype), b)
        gc = want[4]
        assert any(len(np.unique(r)) < len(r) for r in gc)  # ties exist


def _jax_fine_dense(jf, hashes, n, gsel, slot_ok):
    """The JAX program's dense fine stage (device.py:1194-1253)."""
    h = jnp.asarray(hashes.numpy().view(np.uint64))
    nj = jnp.asarray(n.numpy())
    mask = jnp.arange(h.shape[1])[None, :] < nj[:, None]
    gsel = jnp.asarray(gsel)
    slot_ok = jnp.asarray(slot_ok)
    frows = jdev._pruned_fine_rows(
        h, jf.grp_bin_size[gsel].astype(jnp.uint64),
        jf.grp_shift[gsel].astype(jnp.uint64), jf.grp_row_off[gsel],
        fine_h=jf.fine_h)
    member = jf.ftbl[frows[..., 0]]
    for s in range(1, jf.fine_h):
        member = member & jf.ftbl[frows[..., s]]
    fmask = mask[:, None, :, None] & slot_ok[:, :, None, None]
    member = jnp.where(fmask, member, member.dtype.type(0))
    planes = jdev._bit_expand(member, 32)[..., :jf.group_size]
    counts = jnp.sum(planes.astype(jnp.int32), axis=2)
    return np.asarray(jnp.minimum(counts, nj[:, None, None]))


@pytest.mark.parametrize("S", [1, 3])
def test_fine_matches_jax(genomes, forest, S):
    jp, tf, jf = forest
    h, n, ovf = _read_hashes(genomes, 40 + S)
    gsel, ok, _, _ = pq.gate(
        tf.ctbl, h, n, coarse_bin_size=tf.coarse_bin_size,
        coarse_h=tf.coarse_h, num_groups=tf.num_groups, rel_cutoff=0.2,
        hashes_limit=65535, max_groups=S)
    got = pq.fine_counts(tf.ftbl, h, n, tf.grp_row_off, tf.grp_bin_size,
                         tf.grp_shift, fine_h=tf.fine_h,
                         group_size=tf.group_size, gsel=gsel, slot_ok=ok)
    want = _jax_fine_dense(jf, h, n, gsel.numpy(), ok.numpy().astype(bool))
    assert got.shape == (len(n), S, tf.group_size)
    assert np.array_equal(got.numpy(), want)
    assert (want > 0).any()


@pytest.mark.parametrize("gated", [True, False], ids=["gated", "ungated"])
def test_probe_all_matches_jax(genomes, forest, gated):
    """counts_gated (gate survive mask + fine probe-all) and the ungated
    counts equal ``_pruned_all_counts``; gating only ever removes."""
    jp, tf, jf = forest
    h, n, _ = _read_hashes(genomes, 77)
    hj = jnp.asarray(h.numpy().view(np.uint64))
    mj = jnp.asarray(np.arange(h.shape[1])[None, :] < n.numpy()[:, None])
    nj = jnp.asarray(n.numpy())
    if gated:
        got = tf.counts_gated(h, n, 0.25)
        want = np.asarray(jf.counts_gated(hj, mj, nj, 0.25))
        assert (got.numpy() <= tf.counts(h, n).numpy()).all()
    else:
        got = tf.counts(h, n)
        want = np.asarray(jf.counts(hj, mj, nj))
    assert got.dtype == torch.int32 and got.shape == (len(n), tf.num_targets)
    assert np.array_equal(got.numpy(), want)
    assert (want > 0).any()


# --------------------------------------------------------------------------
# the packed batch


@pytest.mark.parametrize("cuts", [(0.25, 0.1), (0.05, 1.0)],
                         ids=["cut25-filter10", "cut05-filter100"])
@pytest.mark.parametrize("S", [1, 2, 3])
@pytest.mark.parametrize("top_k", [4, 128])
@pytest.mark.parametrize("emit", [True, False], ids=["mt", "no-mt"])
def test_classify_batch_packed_pruned_matches_jax(genomes, forest, cuts, S,
                                                  top_k, emit):
    jp, tf, jf = forest
    rng = np.random.default_rng(S + top_k)
    pool = np.stack([np.resize(g, 1500) for g in genomes.values()])
    batch = _batch(rng, pool, 200, True, W)
    inbuf, L1, L2 = jdev.pack_batch_direct(batch, 256)
    kk = min(top_k, S * tf.group_size)
    want = np.asarray(jdev.classify_batch_packed_pruned(
        jf.ctbl, jf.ftbl, jf.grp_row_off, jf.grp_bin_size, jf.grp_shift,
        jf.grp_ntargets, jnp.asarray(inbuf), cuts[0], cuts[1], 65535,
        k=K, w=W, L1=L1, L2=L2, coarse_bin_size=jf.coarse_bin_size,
        coarse_h=jf.coarse_h, fine_h=jf.fine_h, max_groups=S,
        group_size=jf.group_size, num_targets=jf.num_targets, top_k=kk,
        match_cap=0, emit_matches_t=emit, pair_cap=0,
    ))
    got = tdev.classify_batch_packed_pruned(
        tf, torch.from_numpy(inbuf), cuts[0], cuts[1], 65535, k=K, w=W,
        L1=L1, L2=L2, max_groups=S, top_k=kk, emit_matches_t=emit)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    res = tdev.unpack_batch_result(got.numpy(), 256, kk, tf.num_targets,
                                   has_matches_t=emit, n_extra=-(-S // 2))
    assert res["n_matches"].any()  # the case classifies something
    if S % 2:  # the high half of the last group word is 0xFFFF
        assert (res["extra_rows"][-1] >> 16 == 0xFFFF).all()


# --------------------------------------------------------------------------
# the engine

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _seq(codes):
    return ACGT[codes].tobytes().decode()


def _pairs(rng, genomes, n, prefix="q", chimeric_every=0, junk_every=10):
    """Paired 150 bp reads named ``{prefix}{i}|{target}``: mate 2 is a
    reverse complement; every ``chimeric_every``-th pair takes mate 2
    from another target, every ``junk_every``-th is random."""
    names = sorted(genomes)
    r1, r2 = {}, {}
    for i in range(n):
        t = names[int(rng.integers(len(names)))]
        g = genomes[t]
        if junk_every and i % junk_every == junk_every - 1:
            t = "junk"
            a = b = rng.integers(0, 4, size=150, dtype=np.uint8)
        else:
            p1, p2 = rng.integers(0, len(g) - 150, size=2)
            a = g[p1:p1 + 150]
            if chimeric_every and i % chimeric_every == 0:
                g = genomes[names[int(rng.integers(len(names)))]]
                p2 = int(rng.integers(0, len(g) - 150))
            b = 3 - g[p2:p2 + 150][::-1]
        r1[f"{prefix}{i}|{t}"] = _seq(a)
        r2[f"{prefix}{i}|{t}"] = _seq(b)
    return r1, r2


@pytest.fixture(scope="module")
def pruned_db(tmp_path_factory, genomes, hashes):
    """``pruned.hibf`` (the JAX build, group size 16) with a ``.tax`` of 8
    genera, a flat ``flat.ibf`` of 6 other targets, and paired reads over
    both (some chimeric across two pruned targets, some junk)."""
    tmp = tmp_path_factory.mktemp("pruned")
    jp = jax_build_pruned(hashes, kmer_size=K, window_size=W, max_fp=0.05,
                          group_size=16)
    jp.save(str(tmp / "pruned.hibf"))
    names = sorted(genomes)
    rows = [("1", "0", "no rank", "root")]
    rows += [(f"G{g}", "1", "genus", f"G{g}") for g in range(8)]
    rows += [(t, f"G{i % 8}", "species", t) for i, t in enumerate(names)]
    tax = write_tax(tmp / "pruned.tax", rows)
    rng = np.random.default_rng(12)
    flat = {f"F{i}": rng.integers(0, 4, size=1500, dtype=np.uint8)
            for i in range(6)}
    flat_db = build_db(tmp, {t: _seq(g) for t, g in flat.items()},
                       name="flat", k=K, w=W, max_fp=0.05)
    r1, r2 = _pairs(rng, genomes, 240, chimeric_every=4)
    f1, f2 = _pairs(rng, flat, 60, prefix="f", junk_every=0)
    write_fastq(tmp / "r1.fq", r1 | f1)
    write_fastq(tmp / "r2.fq", r2 | f2)
    return dict(db=str(tmp / "pruned.hibf"), tax=tax, flat=flat_db,
                reads=[str(tmp / "r1.fq"), str(tmp / "r2.fq")])


def _listed(path):
    """{read id: set of listed targets} of a ``.all`` file."""
    out = {}
    for rid, t, _ in read_tsv(path):
        out.setdefault(rid, set()).add(t)
    return out


ENGINE_CASES = {
    "defaults": dict(),
    "cli-defaults-lca-fpr": dict(rel_cutoff=[0.75], rel_filter=[0.1],
                                 fpr_query=[1e-5], output_lca=True),
    "probe-all-fallback": dict(pruned_max_groups=1, rel_cutoff=[0.1],
                               rel_filter=[0.2]),
    "device-thresholding-off": dict(device_thresholding=False,
                                    rel_cutoff=[0.3], fpr_query=[1e-3]),
    "jax-pair-spill": dict(pruned_pair_frac=0.01, rel_cutoff=[0.1]),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_pruned_engine_matches_jax(tmp_path, monkeypatch, pruned_db, case):
    jax_calls = {}
    kw = ENGINE_CASES[case]
    port, calls = run_both(
        tmp_path, monkeypatch, ibf=[pruned_db["db"]], tax=[pruned_db["tax"]],
        paired_reads=pruned_db["reads"], output_all=True,
        output_unclassified=True, output_stats=True, jax_calls=jax_calls,
        **kw)
    listed = _listed(port + ".all")
    assert len(listed) > 100
    if case in ("defaults", "cli-defaults-lca-fpr"):
        # (a batch with a compaction or group overflow also runs exactly)
        assert calls["dispatch"] >= 1
        # error-free pairs list their own target (gating never drops a
        # true-hash match)
        for rid, ts in listed.items():
            t = rid.split("|")[1]
            if (rid.startswith("q") and t != "junk"
                    and int(rid[1:].split("|")[0]) % 4):
                assert t in ts, rid
    if case == "probe-all-fallback":
        assert calls["fallback"] >= 1
    if case == "device-thresholding-off":
        assert calls["fallback"] == calls["dispatch"]
    if case == "jax-pair-spill":
        # both engines retried the spilled batch with dense slots
        assert calls == jax_calls and calls["dispatch"] > 1


def test_pruned_engine_topk_escalation(tmp_path_factory, tmp_path,
                                       monkeypatch):
    """4,200 tiny targets start the level at K = 4; 40 targets sharing a
    core (one group) give core reads 40 matches, so the batch goes out
    again at K = min(top_k_matches, S * gs), still on the fast path."""
    tmp = tmp_path_factory.mktemp("wide")
    fam = _genomes(9, 40, lo=600, hi=900, core=700, n_core=40)
    th = _hashes(fam)
    base = np.arange(4200, dtype=np.uint64) * np.uint64(1 << 33)
    th.update({f"D{i}": base[i] + np.arange(20, dtype=np.uint64)
               for i in range(4200)})
    db = str(tmp / "wide.hibf")
    jax_build_pruned(th, kmer_size=K, window_size=W, max_fp=0.05).save(db)
    rng = np.random.default_rng(3)
    core = next(iter(fam.values()))[:700]
    reads = {f"c{i}": _seq(core[s:s + 150])
             for i, s in enumerate(range(0, 550, 25))}
    r1, _ = _pairs(rng, fam, 30, junk_every=0)
    write_fastq(tmp / "r.fq", reads | r1)
    jax_calls = {}
    port, calls = run_both(
        tmp_path, monkeypatch, ibf=[db], single_reads=[str(tmp / "r.fq")],
        rel_cutoff=[0.5], rel_filter=[1.0], output_all=True,
        output_unclassified=True, output_stats=True, jax_calls=jax_calls)
    assert len(_listed(port + ".all")["c0"]) == 40
    # the wider K's dispatch follows the ragged stream's cap overflow
    assert calls == jax_calls == {"dispatch": 3, "fallback": 0}


@pytest.fixture(scope="module")
def big_db(tmp_path_factory):
    """The shape of tests/test_pruned.py's 66k-target case: 65,990
    dummies of 150 synthetic hashes and 10 real targets, whose fewer
    minimizers sort them to global ids above 0xFFFF."""
    tmp = tmp_path_factory.mktemp("big")
    rng = np.random.default_rng(43)
    base = np.arange(65_990, dtype=np.uint64) * np.uint64(1 << 33)
    th = {f"D{i}": base[i] + np.arange(150, dtype=np.uint64)
          for i in range(65_990)}
    real = {f"R{t}": rng.integers(0, 4, size=600, dtype=np.uint8)
            for t in range(10)}
    th.update(_hashes(real))
    pf = build_pruned(th, kmer_size=K, window_size=W, max_fp=0.05,
                      device=False)
    targets = pf.targets()
    assert all(targets.index(t) > 0xFFFF for t in real)
    db = str(tmp / "big.hibf")
    pf.save_raw(db)
    reads = {}
    for i in range(60):
        t = f"R{int(rng.integers(10))}"
        s = int(rng.integers(0, 600 - 300))
        reads[f"q{i}|{t}"] = _seq(real[t][s:s + 300])
    write_fastq(tmp / "r.fq", reads)
    return db, str(tmp / "r.fq")


@pytest.mark.parametrize("cut,thresholding", [
    (0.5, True), (0.2, True), (0.2, False),
], ids=["fast", "group-overflow", "thresholding-off"])
def test_pruned_engine_beyond_u16_targets(tmp_path, monkeypatch, big_db,
                                          cut, thresholding):
    """At cutoff 0.2 the coarse gate of 1,032 groups lets more than S
    groups through for some reads: the batch runs exactly, on the host's
    full-matrix path (no 16-bit select past 0xFFFF targets)."""
    db, reads = big_db
    port, calls = run_both(
        tmp_path, monkeypatch, ibf=[db], single_reads=[reads],
        rel_cutoff=[cut], device_thresholding=thresholding, output_all=True,
        output_unclassified=True, output_stats=True)
    listed = _listed(port + ".all")
    assert len(listed) == 60
    for rid, ts in listed.items():
        assert rid.split("|")[1] in ts, rid
    assert (calls["fallback"] == 0) == (cut == 0.5)


def test_pruned_then_flat_hierarchy_matches_jax(tmp_path, monkeypatch,
                                                pruned_db):
    port, _ = run_both(
        tmp_path, monkeypatch, ibf=[pruned_db["db"], pruned_db["flat"]],
        hierarchy_labels=["1_pruned", "2_flat"],
        paired_reads=pruned_db["reads"], rel_cutoff=[0.75],
        rel_filter=[0.1], fpr_query=[1e-5], output_all=True,
        output_unclassified=True, output_stats=True)
    assert read_tsv(port + ".1_pruned.all") and read_tsv(port + ".2_flat.all")


def test_pruned_beside_flat_on_one_level_matches_jax(tmp_path, monkeypatch,
                                                     pruned_db):
    """A level of a pruned forest and a flat filter has no fast path:
    every batch takes the exact host union path, as in the JAX package."""
    port, calls = run_both(
        tmp_path, monkeypatch, ibf=[pruned_db["db"], pruned_db["flat"]],
        paired_reads=pruned_db["reads"], rel_cutoff=[0.5, 0.3],
        rel_filter=[0.2], fpr_query=[1e-3], output_all=True,
        output_unclassified=True, output_stats=True)
    assert calls["fallback"] >= 1 and calls["fallback"] == calls["dispatch"]
    listed = _listed(port + ".all")
    assert any(r.startswith("f") for r in listed)
    assert any(r.startswith("q") for r in listed)
