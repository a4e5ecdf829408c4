"""Device meshes (K17): the port against ``ganon_tpu``'s mesh code.

The port runs on virtual CPU meshes (``parallel.mesh.local_devices``
replaced by eight ``cpu`` entries), the JAX package on the eight CPU
devices ``tests/conftest.py`` forces. Inputs come from numpy seeds; every
comparison is exact (counts and bits are integers, tolerance 0):

* ``choose_batch_axis`` and ``make_mesh``'s shapes;
* ``ShardedClassifier.counts`` at meshes (1, 2), (2, 2) and (2, 4): a
  target over two and three shards whose unclamped sum passes n (the
  clamp after the sum), T not divisible by the shards, B not divisible
  by the batch axis, reads without hashes;
* the engine on a (2, 4) mesh against the JAX engine on its mesh, for a
  flat IBF, a native forest, a raptor archive, a pruned forest
  (replicated) and a two-level hierarchy whose second level holds two
  filters (sorted rows, ``.sta`` byte for byte);
* ``BinShardedPrunedForest.counts_gated`` with pad groups;
* the device build's mesh scatter (1-D, 2-D flattened, a bin size the
  shards do not divide) and its round-robin of groups over devices.
"""

import random

import jax
import numpy as np
import pytest
import torch

import ganon_tpu  # noqa: F401  (turns on jax x64)
from ganon_tpu.classify.engine import ClassifyConfig as JaxConfig
from ganon_tpu.classify.engine import run_classify as jax_run_classify
from ganon_tpu.index import sizing as jsizing
from ganon_tpu.index.device_build import DeviceBuildPipeline as JaxPipeline
from ganon_tpu.index.hibf import build_hibf as jax_build_hibf
from ganon_tpu.index.ibf import IBF as JaxIBF
from ganon_tpu.index.ibf import build_ibf as jax_build_ibf
from ganon_tpu.index.pruned import PrunedForest as JaxPruned
from ganon_tpu.index.pruned import build_pruned as jax_build_pruned
from ganon_tpu.parallel import mesh as jmesh
from ganon_tpu.parallel.pruned_shard import (
    BinShardedPrunedForest as JaxBinSharded,
)
from ganon_tpu_torch.classify import device as tdev
from ganon_tpu_torch.classify.engine import ClassifyConfig, run_classify
from ganon_tpu_torch.index import device_build as tdb
from ganon_tpu_torch.index import sizing as tsizing
from ganon_tpu_torch.index.builder import _HashExtractor
from ganon_tpu_torch.index.ibf import IBF
from ganon_tpu_torch.index.pruned import PrunedForest
from ganon_tpu_torch.ops import ibf_query as q
from ganon_tpu_torch.parallel import mesh as pmesh
from ganon_tpu_torch.parallel.pruned_shard import BinShardedPrunedForest
from raptor_layout import write_raptor_layout
from tests.test_classify import build_db, read_tsv, write_fastq
from tests.test_torch_build import _feed, _mkinput
from tests.test_torch_hierarchy import _reads

K, W = 19, 31
CPU = torch.device("cpu")


def _cpu_mesh(batch, bins):
    return pmesh.make_mesh([CPU] * (batch * bins), batch_axis=batch)


def _hashes(genomes):
    ex = _HashExtractor(K, W, device="cpu")
    for t, g in genomes.items():
        ex.add_encoded(t, g)
    return ex.finish()


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 16, 32])
def test_mesh_shapes_match_jax(n):
    b = pmesh.choose_batch_axis(n)
    assert b == jmesh.choose_batch_axis(n)
    mesh = pmesh.make_mesh([CPU] * n)
    assert mesh.shape == {"batch": b, "bins": n // b}
    assert mesh.size == b * (n // b) and len(mesh.flat) == mesh.size
    if n <= len(jax.devices()):  # conftest's eight virtual devices
        assert dict(jmesh.make_mesh(jax.devices()[:n]).shape) == mesh.shape


# --------------------------------------------------------------------------
# ShardedClassifier


@pytest.fixture(scope="module")
def flat(tmp_path_factory):
    """9 targets: eight of 3 kbp and T05 of 600 kbp, split over 7 bytes
    of technical bins in the middle of the table, so it crosses shard
    edges at 2 and 4 shards. The JAX build, saved and loaded by both
    packages."""
    rng = np.random.default_rng(71)
    genomes = {f"T{i:02d}": rng.integers(
        0, 4, size=600_000 if i == 5 else 3000, dtype=np.uint8)
        for i in range(9)}
    path = str(tmp_path_factory.mktemp("flat") / "db.ibf")
    jax_build_ibf(_hashes(genomes), kmer_size=K, window_size=W,
                  max_fp=0.05).save(path)
    return genomes, path


def _codes(rng, genomes, B=37, L=150):
    """[B, L] reads: half from the large target, the rest from the
    others, random, short (n = 0) and empty."""
    names = sorted(genomes)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    lengths = np.full(B, L, np.int32)
    for b in range(B):
        t = "T05" if b % 2 == 0 else names[b % len(names)]
        if b % 7 != 6:
            s = int(rng.integers(0, len(genomes[t]) - L))
            codes[b] = genomes[t][s:s + L]
    lengths[3], lengths[8] = 20, 0
    return codes, lengths


@pytest.mark.parametrize("batch,bins", [(1, 2), (2, 2), (2, 4)])
def test_sharded_classifier_matches_jax(flat, batch, bins):
    genomes, path = flat
    codes, lengths = _codes(np.random.default_rng(batch * 10 + bins), genomes)
    jm = jmesh.make_mesh(jax.devices()[:batch * bins], batch_axis=batch)
    want_c, want_n = jmesh.ShardedClassifier(JaxIBF.load(path), jm).counts(
        codes, lengths)
    ibf = IBF.load(path)
    sc = pmesh.ShardedClassifier(ibf, _cpu_mesh(batch, bins))
    got_c, got_n = sc.counts(codes, lengths)
    assert np.array_equal(got_c.numpy(), np.asarray(want_c))
    assert np.array_equal(got_n.numpy(), np.asarray(want_n))
    assert got_n[8] == 0 and got_n[3] == 0
    # not vacuous: a target spans several shards, T does not divide them,
    # and its unclamped sum passes n, so a clamp before the sum would show
    shards = sc.f.table.shards[0]
    spans = [(s.t_lo, s.t_hi) for s in shards]
    assert any(hi - lo > 0 and hi > spans[j + 1][0]
               for j, (lo, hi) in enumerate(spans[:-1]))
    assert sc.num_targets % bins
    plain = tdev.DeviceFilter(ibf, "cpu")
    L4 = 152
    inbuf = np.zeros((len(lengths), L4 // 4 + 4), np.uint8)
    inbuf[:, :L4 // 4] = tdev.pack_codes_2bit(codes)
    inbuf[:, L4 // 4:] = lengths.astype("<i4").view(np.uint8).reshape(-1, 4)
    h, n, _ = q.extract(torch.from_numpy(inbuf), L1=L4, L2=0, k=K, w=W,
                        mc=L4 - W + 1)
    raw = q.bulk_target_counts_packed_plain(
        plain.tbl8, plain.byte_starts, plain.byte_ends, h, n,
        bin_size=ibf.ibf_config.bin_size_bits,
        hash_functions=ibf.ibf_config.hash_functions, clamp=False)
    assert (raw > n[:, None]).any()
    assert torch.equal(got_c, torch.minimum(raw, n[:, None]))


@pytest.fixture(scope="module")
def split3(tmp_path_factory):
    """4 targets: T05 of 600 kbp between three of 3 kbp (T00, T01 before
    it, T06 after), so that at 3 shards its technical bins cover the
    middle shard and reach into both others. The JAX build, saved and
    loaded by both packages."""
    rng = np.random.default_rng(73)
    genomes = {f"T{i:02d}": rng.integers(
        0, 4, size=600_000 if i == 5 else 3000, dtype=np.uint8)
        for i in (0, 1, 5, 6)}
    path = str(tmp_path_factory.mktemp("split3") / "db.ibf")
    jax_build_ibf(_hashes(genomes), kmer_size=K, window_size=W,
                  max_fp=0.05).save(path)
    return genomes, path


def test_sharded_table_forest_mode_writes_only_its_columns(split3):
    """``ShardedTable.counts`` in forest mode at an odd ``col0`` over 3
    shards, a target split across all three, into a matrix filled with 7
    beforehand: its columns equal ``ganon_tpu``'s sharded counts, every
    other column still holds 7 (the caller's matrix is not cleared)."""
    genomes, path = split3
    codes, lengths = _codes(np.random.default_rng(74), genomes)
    jm = jmesh.make_mesh(jax.devices()[:3], batch_axis=1)
    want_c, _ = jmesh.ShardedClassifier(JaxIBF.load(path), jm).counts(
        codes, lengths)
    ibf = IBF.load(path)
    f = tdev.DeviceFilter(ibf, "cpu", mesh=_cpu_mesh(1, 3))
    shards = f.table.shards[0]
    T = f.num_targets
    assert any(sum(s.t_lo <= t < s.t_hi for s in shards) == 3
               for t in range(T))
    L4 = 152
    inbuf = np.zeros((len(lengths), L4 // 4 + 4), np.uint8)
    inbuf[:, :L4 // 4] = tdev.pack_codes_2bit(codes)
    inbuf[:, L4 // 4:] = lengths.astype("<i4").view(np.uint8).reshape(-1, 4)
    h, n, _ = q.extract(torch.from_numpy(inbuf), L1=L4, L2=0, k=K, w=W,
                        mc=L4 - W + 1)
    col0 = 3
    out = torch.full((len(lengths), col0 + T + 2), 7, dtype=torch.int32)
    got = f.table.counts(0, h, n, out=out, col0=col0)
    assert got is out
    assert np.array_equal(out[:, col0:col0 + T].numpy(), np.asarray(want_c))
    assert np.asarray(want_c).any()
    assert (out[:, :col0] == 7).all() and (out[:, col0 + T:] == 7).all()


def test_sharded_table_fills_partials_only_for_the_tile_walk():
    """The partials' buffer skips its zero fill unless a shard takes
    count's tile walk (rows of 256 words or more outside the ring route's
    96-512) with an empty byte range, the one case where count leaves a
    cell unstored."""
    mesh = _cpu_mesh(1, 2)
    for W8, widths, fill in ((64, [8, 8, 16], False),
                             (8192, [8, 8, 16], False),
                             (64, [8, 0, 16], False),
                             (4096, [8, 0, 16], False),  # the ring route
                             (8192, [8, 0, 16], True)):
        ends = np.cumsum(widths).astype(np.int32)
        starts = np.concatenate([[0], ends[:-1]]).astype(np.int32)
        tbl8 = torch.zeros((16, W8), dtype=torch.uint8)
        table = tdev.ShardedTable(
            q.shard_table(tbl8, torch.from_numpy(starts),
                          torch.from_numpy(ends), 2, mesh.devices[0]),
            len(widths), mesh, bin_size=16, hash_functions=1)
        assert table.fill_parts == fill, (W8, widths)
        assert all(s.device.type == "cpu" for s in table.spans)


def test_sharded_filter_from_packed_table(flat):
    """``with_mesh`` cuts the cached filter's table (no repack) and counts
    as the single-device filter; the cache keys on the mesh."""
    _, path = flat
    mesh = _cpu_mesh(2, 4)
    plain = tdev.load_device_filter(path, "cpu")
    meshed = tdev.load_device_filter(path, "cpu", mesh)
    assert meshed is not plain and meshed.mesh is mesh
    assert plain.mesh is None and plain.tbl8 is not None
    assert tdev.load_device_filter(path, "cpu", mesh) is meshed
    assert tdev.load_device_filter(path, "cpu") is plain
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, size=(9, 40)))
    n = torch.from_numpy(rng.integers(0, 41, size=9).astype(np.int32))
    assert torch.equal(meshed.counts(h, n), plain.counts(h, n))


def test_sharded_filter_uncached_cut_from_host(flat, monkeypatch):
    """With nothing cached, a meshed load repacks each column shard on its
    own device from the bit-matrix: no single-device filter and no whole
    table are made, the shards equal the cut of one device's table, and
    the counts equal one device's."""
    _, path = flat
    monkeypatch.setattr(tdev, "_FILTER_CACHE", {})
    windows = []

    def spy(bits, plan, *, _real=q.repack_table, **k):
        windows.append((k.get("c0", 0), k.get("width")))
        return _real(bits, plan, **k)

    monkeypatch.setattr(q, "repack_table", spy)
    monkeypatch.setattr(tdev, "shard_table", None)  # nothing cuts a table
    mesh = _cpu_mesh(2, 4)
    meshed = tdev.load_device_filter(path, "cpu", mesh)
    assert len(tdev._FILTER_CACHE) == 1 and meshed.tbl8 is None
    # one repack a shard, each its own window; every batch row copies them
    ws = meshed.table.shards[0][0].tbl8.shape[1]
    assert windows == [(j * ws, ws) for j in range(4)]
    monkeypatch.undo()
    plain = tdev.DeviceFilter(IBF.load(path), "cpu")
    cut = q.shard_table(plain.tbl8, plain.byte_starts, plain.byte_ends, 4)
    for row in meshed.table.shards:
        for s, c in zip(row, cut):
            assert torch.equal(s.tbl8, c.tbl8)
            assert torch.equal(s.byte_starts, c.byte_starts)
            assert torch.equal(s.byte_ends, c.byte_ends)
            assert (s.c0, s.t_lo, s.t_hi) == (c.c0, c.t_lo, c.t_hi)
    rng = np.random.default_rng(6)
    h = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, size=(11, 40)))
    n = torch.from_numpy(rng.integers(0, 41, size=11).astype(np.int32))
    assert torch.equal(meshed.counts(h, n), plain.counts(h, n))


# --------------------------------------------------------------------------
# the engine on a (2, 4) mesh against the JAX engine on its own


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """A flat IBF (one target over several shards), a native forest, a
    raptor archive and a pruned forest of the same skewed genomes, two
    small flat databases for a second level, and paired reads."""
    tmp = tmp_path_factory.mktemp("meshdbs")
    rng = np.random.default_rng(9)
    lengths = [1500 + 100 * i for i in range(20)] + [
        4000, 6000, 7000, 16000, 20000, 60000]
    genomes = {f"F{i}": rng.integers(0, 4, size=n, dtype=np.uint8)
               for i, n in enumerate(lengths)}
    th = _hashes(genomes)
    out = {"hashes": th,
           "flat": str(tmp / "flat.ibf"), "forest": str(tmp / "forest.hibf"),
           "raptor": str(tmp / "raptor.hibf"),
           "pruned": str(tmp / "pruned.hibf")}
    jax_build_ibf(th, kmer_size=K, window_size=W, max_fp=0.05).save(
        out["flat"])
    forest = jax_build_hibf(th, kmer_size=K, window_size=W, max_fp=0.05)
    assert len(forest.subs) > 1
    forest.save(out["forest"])
    names = sorted(genomes)
    write_raptor_layout(th, [(("F25", "F24", "F0"), [1]), (names[:6], [])],
                        out["raptor"], kmer_size=K, window_size=W,
                        max_fp=0.05, device="cpu")
    jax_build_pruned(th, kmer_size=K, window_size=W, max_fp=0.05,
                     group_size=8).save(out["pruned"])
    r = random.Random(3)
    refs1 = {f"R{i}": "".join(r.choice("ACGT") for _ in range(1200))
             for i in range(3)}
    refs2 = {"R0": refs1["R0"], "S0": "".join(r.choice("ACGT")
                                              for _ in range(1200))}
    out["refs1"] = build_db(tmp, refs1, name="refs1", k=K, w=W, max_fp=0.05)
    out["refs2"] = build_db(tmp, refs2, name="refs2", k=K, w=W, max_fp=0.01)
    pools = {t: "".join("ACGT"[c] for c in g) for t, g in genomes.items()}
    pools.update(refs1)
    pools["S0"] = refs2["S0"]
    r1, r2 = _reads(r, pools, 90, W)
    write_fastq(tmp / "r1.fq", r1)
    write_fastq(tmp / "r2.fq", r2)
    out["reads"] = [str(tmp / "r1.fq"), str(tmp / "r2.fq")]
    return out


CASES = {
    "flat": dict(dbs=["flat"], rel_cutoff=[0.5]),
    "forest": dict(dbs=["forest"], rel_cutoff=[0.5]),
    "raptor": dict(dbs=["raptor"], rel_cutoff=[0.5]),
    "pruned": dict(dbs=["pruned"], rel_cutoff=[0.3]),
    "hierarchy": dict(dbs=["forest", "refs1", "refs2"], rel_cutoff=[0.75],
                      hierarchy_labels=["1_host", "2_refs", "2_refs"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_on_mesh_matches_jax(tmp_path, monkeypatch, capfd, dbs, case):
    kw = dict(CASES[case])
    kw["ibf"] = [dbs[d] for d in kw.pop("dbs")]
    kw.update(paired_reads=dbs["reads"], rel_filter=[0.1], fpr_query=[1e-5],
              output_all=True, output_unclassified=True, output_stats=True)
    monkeypatch.setattr(pmesh, "local_devices", lambda: [CPU] * 8)
    calls = {"combine": 0, "rows": 0}
    for name, key in (("combine", "combine"), ("split_rows", "rows")):
        def counted(*a, _f=getattr(tdev, name), _k=key, **k):
            calls[_k] += 1
            return _f(*a, **k)
        monkeypatch.setattr(tdev, name, counted)
    outs = {}
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        if name == "jax":  # its (2, 4) mesh over the eight CPU devices
            jax_run_classify(JaxConfig(output_prefix=str(d / "out"), **kw))
        else:
            run_classify(ClassifyConfig(output_prefix=str(d / "out"),
                                        device="cpu", quiet=False, **kw))
        outs[name] = d
    assert " - device mesh {'batch': 2, 'bins': 4} over 8 devices" in (
        capfd.readouterr().err)
    files = sorted(p.name for p in outs["jax"].iterdir())
    assert sorted(p.name for p in outs["port"].iterdir()) == files
    for fn in files:
        a, b = outs["jax"] / fn, outs["port"] / fn
        if fn.endswith(".sta"):
            assert b.read_bytes() == a.read_bytes(), fn
        else:
            assert (sorted(map(tuple, read_tsv(b)))
                    == sorted(map(tuple, read_tsv(a)))), fn
    assert read_tsv(outs["port"] / files[0])
    assert calls["rows"] > 0
    if case != "pruned":  # the pruned forest's tables are replicated
        assert calls["combine"] > 0


# --------------------------------------------------------------------------
# the bins-sharded pruned forest


@pytest.mark.parametrize("rel_cutoff", [0.2, 0.5])
def test_bin_sharded_pruned_matches_jax(dbs, rel_cutoff):
    """26 targets in groups of 8: 4 groups over 3 shards, so two shards
    carry a pad group; B not divisible by the batch axis."""
    pf = PrunedForest.load(dbs["pruned"])
    jpf = JaxPruned.load(dbs["pruned"])
    batch, bins = 2, 3
    assert pf.num_groups == 4
    rng = np.random.default_rng(int(rel_cutoff * 100))
    B, M = 29, 64
    hashes = np.zeros((B, M), np.uint64)
    mask = np.zeros((B, M), bool)
    targets = pf.targets()
    for b in range(B):
        if b % 5 == 4:
            hs = rng.integers(0, 2**62, size=30, dtype=np.uint64)
        elif b % 9 == 8:
            hs = np.zeros(0, np.uint64)
        else:
            hs = dbs["hashes"][targets[int(rng.integers(0, len(targets)))]][:40]
        hashes[b, :len(hs)] = hs
        mask[b, :len(hs)] = True
    nh = mask.sum(1).astype(np.int32)
    jm = jmesh.make_mesh(jax.devices()[:batch * bins], batch_axis=batch)
    want = JaxBinSharded(jpf, jm).counts_gated(hashes, mask, nh, rel_cutoff)
    ht = torch.from_numpy(hashes.view(np.int64))
    nt = torch.from_numpy(nh)
    got = BinShardedPrunedForest(pf, _cpu_mesh(batch, bins)).counts_gated(
        ht, nt, rel_cutoff)
    assert np.array_equal(got.numpy(), want)
    assert want.any()
    single = tdev.DevicePrunedForest(pf, "cpu").counts_gated(ht, nt,
                                                             rel_cutoff)
    assert torch.equal(got, single)


# --------------------------------------------------------------------------
# the device build: mesh scatter and the round-robin of groups


def _build(pipe, seq_files, odd_rows=False, mesh=None):
    try:
        _feed(pipe, seq_files)
        pipe.finish_counts()
        counts = {t: c for t, c in pipe.hashes_count().items() if c}
        sizing = tsizing if isinstance(pipe, tdb.DeviceBuildPipeline) \
            else jsizing
        icfg = sizing.size_filter(counts, kmer_size=K, window_size=W,
                                  max_fp=0.05)
        if odd_rows:  # the shards do not divide the rows
            icfg.bin_size_bits |= 1
        if isinstance(pipe, tdb.DeviceBuildPipeline):
            return pipe.scatter(icfg, tsizing.split_target_bins(icfg, counts),
                                mesh=mesh), icfg
        return pipe.scatter(icfg, mesh=mesh), icfg
    finally:
        pipe.close()


@pytest.fixture(scope="module")
def build_input():
    return _mkinput(np.random.default_rng(17))


@pytest.mark.parametrize("case", ["bins8", "batch2_bins4", "bins3_odd_rows"])
def test_mesh_scatter_matches_jax(build_input, case):
    if case == "bins8":
        mesh, jm = _cpu_mesh(1, 8), jax.sharding.Mesh(
            np.asarray(jax.devices()).reshape(-1), ("bins",))
    elif case == "batch2_bins4":
        mesh, jm = _cpu_mesh(2, 4), jmesh.make_mesh(jax.devices())
    else:
        mesh, jm = _cpu_mesh(1, 3), jax.sharding.Mesh(
            np.asarray(jax.devices()[:3]), ("bins",))
    odd = case == "bins3_odd_rows"
    want, wcfg = _build(JaxPipeline(K, W), build_input, odd, mesh=jm)
    got, gcfg = _build(tdb.DeviceBuildPipeline(K, W, device="cpu"),
                       build_input, odd, mesh=mesh)
    assert gcfg.bin_size_bits == wcfg.bin_size_bits
    if odd:
        assert gcfg.bin_size_bits % 3
    assert got.dtype == np.uint32 and np.array_equal(got, want)
    single, _ = _build(tdb.DeviceBuildPipeline(K, W, device="cpu"),
                       build_input, odd)
    assert np.array_equal(got, single)


def test_round_robin_groups_match_one_device(build_input, monkeypatch):
    """Groups round-robin over four devices (and scatter over a mesh of
    them): the counts and bits equal one device's."""
    monkeypatch.setattr(tdb, "GROUP_BASES", 6000)
    one_pipe = tdb.DeviceBuildPipeline(K, W, device="cpu")
    one, _ = _build(one_pipe, build_input)
    monkeypatch.setattr(pmesh, "local_devices", lambda: [CPU] * 4)
    pipe = tdb.DeviceBuildPipeline(K, W, device="cpu")
    got, _ = _build(pipe, build_input, mesh=_cpu_mesh(1, 4))
    assert one_pipe.devices == [CPU] and pipe.devices == [CPU] * 4
    assert len(pipe.groups) > 2
    assert np.array_equal(got, one)
