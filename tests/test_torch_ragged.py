"""The JAX engine's default transfer settings through the port, exactly.

The ragged match stream (``match_cap``) of every packed batch program
(flat, forest, raptor, multi-filter and pruned levels) at an ample cap
and at one the batch overflows, the pruned forest's (read, slot) pair
compaction at ``pair_cap`` 0, 8 and ``B * S`` (``tests/test_pruned.py``'s
caps), and ``sort_probes``: seeded batches go through the JAX package's
device programs and the port's device functions (plain versions, on the
CPU), whose int32 buffers must be equal. Then the port's engine on the
JAX package's ragged escalation cases (``tests/test_compact_path.py``):
the same files and the same dispatches as the JAX engine's. The gather
probe's plain version against the Pallas kernel's arithmetic.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ganon_tpu  # noqa: F401  (turns on jax x64)
from ganon_tpu.classify import device as jdev
from ganon_tpu.index.hibf import RaptorHIBF as JaxRaptorHIBF
from ganon_tpu.index.hibf import build_hibf as jax_build_hibf
from ganon_tpu.index.pruned import build_pruned as jax_build_pruned
from ganon_tpu_torch.classify import device as tdev
from ganon_tpu_torch.index.hibf import HIBF
from ganon_tpu_torch.index.ibf import IBF
from ganon_tpu_torch.ops import probe
from tests.test_classify import build_db, read_tsv, write_fastq
from tests.test_torch_device import _batch, _database
from tests.test_torch_engine import run_both
from tests.test_torch_forest import _genomes as forest_genomes
from tests.test_torch_forest import _hashes as forest_hashes
from tests.test_torch_hierarchy import _flat_filters
from tests.test_torch_pruned import _genomes as pruned_genomes
from tests.test_torch_pruned import _hashes as pruned_hashes
from tests.test_torch_raptor import _genomes as raptor_genomes
from tests.test_torch_raptor import _write_layout

K, W = 19, 31
B_PAD = 256
TOP_K = 8
CUTS = (0.05, 1.0)  # loose: most reads carry several matches


def _pool(genomes):
    longest = max(len(g) for g in genomes)
    return np.stack([np.resize(g, longest) for g in genomes])[:, :1500]


def _flat(tmp):
    genomes, ibf = _database(K, W, seed=3)
    port = IBF.from_arrays(ibf.bits, ibf.ibf_config.to_dict(),
                           ibf.hashes_count, ibf.bin_map)
    jf, tf = jdev.DeviceFilter(ibf), tdev.DeviceFilter(port, "cpu")
    cfg = jf.ibf_config

    def jax_run(inbuf, L1, L2, cap, **kw):
        return jdev.classify_batch_packed(
            jf.tbl8, jf.byte_starts, jf.byte_ends, inbuf, *CUTS, 65535, k=K,
            w=W, L1=L1, L2=L2, bin_size=cfg.bin_size_bits,
            hash_functions=cfg.hash_functions, top_k=TOP_K, pack16=True,
            match_cap=cap, **kw)

    def port_run(inbuf, L1, L2, cap, **kw):
        return tdev.classify_batch_packed(
            tf, inbuf, *CUTS, 65535, k=K, w=W, L1=L1, L2=L2, top_k=TOP_K,
            match_cap=cap, **kw)

    return genomes, jax_run, port_run, dict(T=tf.num_targets)


def _forest(tmp):
    genomes = forest_genomes(31)
    jhibf = jax_build_hibf(forest_hashes(genomes), kmer_size=K,
                           window_size=W, max_fp=0.05)
    path = str(tmp / "f.hibf")
    jhibf.save(path)
    jf, tf = jdev.DeviceHIBF(jhibf), tdev.DeviceHIBF(HIBF.load(path), "cpu")

    def jax_run(inbuf, L1, L2, cap):
        return jdev.classify_batch_packed_forest(
            tuple(s.tbl8 for s in jf.subs),
            tuple(s.byte_starts for s in jf.subs),
            tuple(s.byte_ends for s in jf.subs), inbuf, *CUTS, 65535, k=K,
            w=W, L1=L1, L2=L2,
            sub_params=tuple((s.ibf_config.bin_size_bits,
                              s.ibf_config.hash_functions) for s in jf.subs),
            top_k=TOP_K, pack16=True, match_cap=cap)

    def port_run(inbuf, L1, L2, cap):
        return tdev.classify_batch_packed_forest(
            tf, inbuf, *CUTS, 65535, k=K, w=W, L1=L1, L2=L2, top_k=TOP_K,
            match_cap=cap)

    return list(genomes.values()), jax_run, port_run, dict(T=tf.num_targets)


def _raptor(tmp):
    codes, hashes = raptor_genomes()
    path = str(tmp / "r.hibf")
    _write_layout(path, hashes, "user-bin-in-two-ibfs")
    jf = jdev.DeviceRaptorHIBF(JaxRaptorHIBF.load(path))
    tf = tdev.load_device_filter(path, "cpu")

    def jax_run(inbuf, L1, L2, cap):
        return jdev.classify_batch_packed_raptor(
            tuple(s["tbl8"] for s in jf.subs),
            tuple(s["byte_starts"] for s in jf.subs),
            tuple(s["byte_ends"] for s in jf.subs),
            tuple(jnp.asarray(s["cols"]) for s in jf.subs), inbuf, *CUTS,
            65535, k=K, w=W, L1=L1, L2=L2,
            sub_params=tuple((s["bin_size"], s["hash_funs"])
                             for s in jf.subs),
            num_targets=tf.num_targets, top_k=TOP_K, pack16=True,
            match_cap=cap)

    def port_run(inbuf, L1, L2, cap):
        return tdev.classify_batch_packed(
            tf, inbuf, *CUTS, 65535, k=K, w=W, L1=L1, L2=L2, top_k=TOP_K,
            match_cap=cap)

    return list(codes.values()), jax_run, port_run, dict(T=tf.num_targets)


def _multi(tmp):
    genomes, jfs, tfs, union, cols = _flat_filters(9, K, W, 2)
    cuts = (0.05, 0.2)

    def jax_run(inbuf, L1, L2, cap):
        return jdev.classify_batch_packed_multi(
            tuple(f.tbl8 for f in jfs), tuple(f.byte_starts for f in jfs),
            tuple(f.byte_ends for f in jfs),
            tuple(jnp.asarray(c) for c in cols), inbuf,
            jnp.asarray(cuts, dtype=jnp.float64), 1.0, 65535, k=K, w=W,
            L1=L1, L2=L2,
            sub_params=tuple((f.ibf_config.bin_size_bits,
                              f.ibf_config.hash_functions) for f in jfs),
            num_union=len(union), top_k=TOP_K, match_cap=cap)

    def port_run(inbuf, L1, L2, cap):
        return tdev.classify_batch_packed_multi(
            tfs, tdev.merge_colmap(cols, len(union)), inbuf, list(cuts), 1.0,
            65535, k=K, w=W, L1=L1, L2=L2, num_union=len(union),
            top_k=TOP_K, match_cap=cap)

    return list(genomes), jax_run, port_run, dict(T=len(union), has_win=True)


def _pruned_forest():
    genomes = pruned_genomes(5, 120, lo=800, hi=2200, core=500, n_core=6)
    jp = jax_build_pruned(pruned_hashes(genomes), kmer_size=K, window_size=W,
                          max_fp=0.05, group_size=16)
    return (list(genomes.values()), tdev.DevicePrunedForest(jp, "cpu"),
            jdev.DevicePrunedForest(jp))


def _pruned_runs(tf, jf, S=2):
    def jax_run(inbuf, L1, L2, cap, pair_cap=0):
        return jdev.classify_batch_packed_pruned(
            jf.ctbl, jf.ftbl, jf.grp_row_off, jf.grp_bin_size, jf.grp_shift,
            jf.grp_ntargets, inbuf, 0.1, 0.5, 65535, k=K, w=W, L1=L1, L2=L2,
            coarse_bin_size=jf.coarse_bin_size, coarse_h=jf.coarse_h,
            fine_h=jf.fine_h, max_groups=S, group_size=jf.group_size,
            num_targets=jf.num_targets, top_k=TOP_K, match_cap=cap,
            pair_cap=pair_cap)

    def port_run(inbuf, L1, L2, cap, pair_cap=0):
        return tdev.classify_batch_packed_pruned(
            tf, inbuf, 0.1, 0.5, 65535, k=K, w=W, L1=L1, L2=L2,
            max_groups=S, top_k=TOP_K, match_cap=cap, pair_cap=pair_cap)

    return jax_run, port_run


def _pruned(tmp):
    genomes, tf, jf = _pruned_forest()
    return (genomes, *_pruned_runs(tf, jf),
            dict(T=tf.num_targets, n_extra=1))


KINDS = {"flat": _flat, "forest": _forest, "raptor": _raptor,
         "multi": _multi, "pruned": _pruned}


@pytest.fixture(scope="module", params=list(KINDS))
def kind(request, tmp_path_factory):
    genomes, jax_run, port_run, info = KINDS[request.param](
        tmp_path_factory.mktemp(request.param))
    batch = _batch(np.random.default_rng(17), _pool(genomes), 200, True, W)
    inbuf, L1, L2 = tdev.pack_batch_direct(batch, B_PAD)
    dense = port_run(torch.from_numpy(inbuf), L1, L2, 0).numpy()
    return request.param, inbuf, L1, L2, jax_run, port_run, info, dense


@pytest.mark.parametrize("cap", ["ample", "overflow"])
def test_ragged_stream_matches_jax(kind, cap):
    """The ragged buffer equals JAX's at a cap that holds the stream and
    at one it overflows; unpacked, the ample one gives the dense
    layout's matches."""
    name, inbuf, L1, L2, jax_run, port_run, info, dense = kind
    T = info["T"]
    Kb = min(TOP_K, T if name != "pruned" else 2 * 16)
    has_win, n_extra = info.get("has_win", False), info.get("n_extra", 0)
    res_d = tdev.unpack_batch_result(dense, B_PAD, Kb, T, has_win=has_win,
                                     n_extra=n_extra)
    total = int(np.minimum(res_d["n_matches"], Kb).sum())
    assert total > B_PAD  # more than 1 slot a read: a cap of 2 slots...
    C = total + 5 if cap == "ample" else total // 2
    want = np.asarray(jax_run(jnp.asarray(inbuf), L1, L2, C))
    got = port_run(torch.from_numpy(inbuf), L1, L2, C)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    res = tdev.unpack_batch_result_ragged(got.numpy(), B_PAD, C, T, Kb,
                                          has_win, n_extra=n_extra)
    assert res["cap_overflow"] == (cap == "overflow")
    for key in ("n_matches", "max_count", "overflow", "disc_t",
                "matches_t", "seqs_classified"):
        assert np.array_equal(res[key], res_d[key]), key
    assert all(np.array_equal(a, b) for a, b in zip(res["extra_rows"],
                                                    res_d["extra_rows"]))
    if cap == "ample":
        Km = res["top_vals"].shape[1]
        valid = np.arange(Km)[None, :] < np.minimum(res["n_matches"],
                                                    Kb)[:, None]
        for key in ("top_vals", "top_idx") + (("top_win",) if has_win
                                              else ()):
            assert np.array_equal(res[key][valid], res_d[key][:, :Km][valid])


@pytest.fixture(scope="module")
def pruned_case():
    genomes, tf, jf = _pruned_forest()
    batch = _batch(np.random.default_rng(23), _pool(genomes), 64, False, W)
    inbuf, L1, L2 = tdev.pack_batch_direct(batch, 64)
    return inbuf, L1, L2, tf.num_targets, _pruned_runs(tf, jf)


@pytest.mark.parametrize("pair_cap", [0, 64 * 2, 8],
                         ids=["dense", "B-times-S", "cap-8"])
def test_pair_compaction_matches_jax(pruned_case, pair_cap):
    """The pruned buffer at pair caps 0, B * S and 8 (a cap the batch's
    pairs spill past: the spilled reads carry the overflow flag, the
    others keep the dense stage's matches)."""
    inbuf, L1, L2, T, (jax_run, port_run) = pruned_case
    want = np.asarray(jax_run(jnp.asarray(inbuf), L1, L2, 0,
                              pair_cap=pair_cap))
    got = port_run(torch.from_numpy(inbuf), L1, L2, 0, pair_cap=pair_cap)
    assert np.array_equal(got.numpy(), want)
    dense = port_run(torch.from_numpy(inbuf), L1, L2, 0).numpy()
    if pair_cap != 8:
        assert np.array_equal(got.numpy(), dense)
        return
    rt = tdev.unpack_batch_result(got.numpy(), 64, TOP_K, T, n_extra=1)
    rd = tdev.unpack_batch_result(dense, 64, TOP_K, T, n_extra=1)
    keep = ~rt["overflow"]
    assert rt["overflow"].any() and keep.any()
    for key in ("top_idx", "top_vals", "n_matches"):
        assert np.array_equal(rd[key][keep], rt[key][keep]), key


def test_sort_probes_matches_jax():
    """classify_batch_packed with sort_probes: JAX's buffer, which is
    its unsorted buffer too."""
    genomes, jax_run, port_run, _ = _flat(None)
    batch = _batch(np.random.default_rng(29), genomes, 100, True, W)
    inbuf, L1, L2 = tdev.pack_batch_direct(batch, 128)
    want = np.asarray(jax_run(jnp.asarray(inbuf), L1, L2, 0,
                              sort_probes=True))
    got = port_run(torch.from_numpy(inbuf), L1, L2, 0, sort_probes=True)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        port_run(torch.from_numpy(inbuf), L1, L2, 0).numpy(), want)


def test_engine_ragged_cap_escalation_matches_jax(tmp_path, monkeypatch):
    """``test_ragged_match_cap_escalation``'s case: every read matches
    all 40 identical targets, the stream (2 slots a read) overflows and
    the slots escalate; the port writes JAX's files after the same
    dispatches."""
    rng = random.Random(9)
    seq = "".join(rng.choice("ACGT") for _ in range(120))
    db = build_db(tmp_path, {f"S{i}": seq for i in range(40)}, k=10, w=12,
                  max_fp=0.001)
    write_fastq(tmp_path / "r.fq", {f"r{j}": seq[5:80] for j in range(10)})
    jax_calls = {}
    port, calls = run_both(tmp_path, monkeypatch, ibf=[db],
                           single_reads=[str(tmp_path / "r.fq")],
                           rel_cutoff=[0.3], output_all=True,
                           jax_calls=jax_calls)
    assert len(read_tsv(port + ".all")) == 400
    assert calls == jax_calls and calls["dispatch"] > 1


def test_engine_multi_ragged_cap_escalation_matches_jax(tmp_path,
                                                        monkeypatch):
    """``test_multi_filter_ragged_cap_escalation``'s case: two databases
    of the same 20 copies, 40 union matches a read on the multi-filter
    fast path, whose winners ride a second stream."""
    rng = random.Random(13)
    seq = "".join(rng.choice("ACGT") for _ in range(120))
    dbs = [build_db(tmp_path, {f"{p}{i}": seq for i in range(20)},
                    name=f"db{j}", k=10, w=12, max_fp=0.001)
           for j, p in enumerate("AB")]
    write_fastq(tmp_path / "r.fq", {f"r{j}": seq[5:80] for j in range(10)})
    jax_calls = {}
    port, calls = run_both(tmp_path, monkeypatch, ibf=dbs,
                           single_reads=[str(tmp_path / "r.fq")],
                           rel_cutoff=[0.3], output_all=True,
                           jax_calls=jax_calls)
    assert len(read_tsv(port + ".all")) == 400
    assert calls == jax_calls and calls["dispatch"] > 1


def test_gather_probe_plain_matches_the_pallas_arithmetic():
    """The probe's plain version against the Pallas kernel's sum, in
    numpy: lanes 8 (r & 15) + j gain the popcount of word j of row r."""
    rng = np.random.default_rng(41)
    tbl = rng.integers(0, 256, size=(probe.R, probe.W8), dtype=np.uint8)
    rows = rng.integers(0, probe.R, size=5000).astype(np.int32)
    words = tbl.view(np.uint32)[rows]  # [N, 8]
    pc = np.unpackbits(words.view(np.uint8), axis=1).reshape(
        len(rows), 8, 32).sum(axis=2)
    want = np.zeros((16, 8), np.int64)
    np.add.at(want, rows & 15, pc)
    got = probe.gather_probe(torch.from_numpy(tbl), torch.from_numpy(rows))
    assert got.dtype == torch.int32 and got.shape == (1, 128)
    assert np.array_equal(got.numpy().reshape(16, 8), want)
