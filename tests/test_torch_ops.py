"""The port's plain torch ops against the JAX package, exactly.

Every op is integer or bitwise (the threshold cutoffs are float64 on
both sides), so every comparison is exact: no tolerance. Inputs come
from ``numpy.random.default_rng`` seeds and go to both packages as numpy
arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ganon_tpu  # noqa: F401  (turns on jax x64 for the u64 reference)
from ganon_tpu.classify import device as jdev
from ganon_tpu.ops import ibf_query as jq
from ganon_tpu.ops import minimizers as jm
from ganon_tpu_torch.classify import device as tdev
from ganon_tpu_torch.ops import ibf_query as tq
from ganon_tpu_torch.ops import winnow as tm


def _u64(rng, n):
    v = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    v[:4] = [0, 2**63, 2**64 - 1, 2**63 - 1]  # top-bit edge values
    return v


def test_u64_helpers_match_numpy_uint64():
    rng = np.random.default_rng(1)
    a, b = _u64(rng, 4096), _u64(rng, 4096)[::-1].copy()
    ta, tb = tm.u64_to_torch(a), tm.u64_to_torch(b)
    for s in (0, 1, 2, 31, 32, 33, 62, 63):
        assert np.array_equal(tm.torch_to_u64(tm.lsr(ta, s)), a >> np.uint64(s))
    assert np.array_equal(tm.ule(ta, tb).numpy(), a <= b)
    assert np.array_equal(tm.torch_to_u64(tm.umin(ta, tb)), np.minimum(a, b))
    with np.errstate(over="ignore"):
        assert np.array_equal(tm.torch_to_u64(ta * tb), a * b)
        assert np.array_equal(tm.torch_to_u64(ta ^ tb), a ^ b)
    assert all(tm.as_i64(int(x)) == int(x.view(np.int64)) for x in a[:64])


@pytest.mark.parametrize("bin_size", [1000, 1024, 2**20 + 7, 2**31 + 11])
def test_ibf_row_indices_matches_jax_and_numpy(bin_size):
    rng = np.random.default_rng(bin_size)
    h = _u64(rng, 2048)
    th = tm.u64_to_torch(h)
    for hf in range(1, 6):
        got = tq.ibf_row_indices(th, bin_size=bin_size, hash_functions=hf)
        want_np = jq.ibf_row_indices_np(h, bin_size=bin_size,
                                        hash_functions=hf)
        want_jax = np.asarray(jq.ibf_row_indices(
            jnp.asarray(h), bin_size=bin_size, hash_functions=hf))
        assert np.array_equal(got.numpy(), want_np)
        assert np.array_equal(got.numpy(), want_jax)


@pytest.mark.parametrize("k,w", [(19, 31), (15, 15), (19, 20)])
def test_minimizers_masked_matches_jax_and_golden(k, w):
    rng = np.random.default_rng(k * 100 + w)
    L = 96
    seqs = ["".join(rng.choice(list("ACGT"), size=L)) for _ in range(14)]
    # non-ACGT bytes encode as A (lowercase and U are handled too)
    seqs[0] = "ACGTNNacgtuRYK" * 7
    codes, _ = tm.encode_seqs(seqs, max_len=L)
    jcodes, _ = jm.encode_seqs(seqs, max_len=L)
    assert np.array_equal(codes, jcodes)
    lens = np.array([L, 0, w - 1, w, w + 1, 2 * w - 1, L - 1]
                    + list(rng.integers(0, L + 1, size=7)), dtype=np.int32)
    mv, em, n = jm.minimizers_masked_jax(jnp.asarray(codes),
                                         jnp.asarray(lens), k=k, w=w)
    tmv, tem, tn = tm.minimizers_masked(torch.from_numpy(codes),
                                        torch.from_numpy(lens), k=k, w=w)
    assert np.array_equal(tm.torch_to_u64(tmv), np.asarray(mv))
    assert np.array_equal(tem.numpy(), np.asarray(em))
    assert np.array_equal(tn.numpy(), np.asarray(n))
    for i, s in enumerate(seqs):
        want = jm.minimizers_golden(s[: lens[i]], k, w)
        assert tm.torch_to_u64(tmv[i][tem[i]]).tolist() == want


@pytest.mark.parametrize("mc", [4, 24, 40])
def test_compact_hashes_matches_jax_with_overflow(mc):
    rng = np.random.default_rng(mc)
    B, M = 16, 40
    h = _u64(rng, B * M).reshape(B, M)
    mask = rng.random((B, M)) < 0.3
    mask[0] = True  # overflows whenever mc < M
    jh, jmask, jovf = jq.compact_hashes(jnp.asarray(h), jnp.asarray(mask),
                                        max_compact=mc)
    th, tn, tovf = tq.compact_hashes(tm.u64_to_torch(h), torch.from_numpy(mask),
                                     max_compact=mc)
    assert np.array_equal(tm.torch_to_u64(th), np.asarray(jh))
    assert np.array_equal(tn.numpy(), mask.sum(axis=1))
    assert np.array_equal(tovf.numpy(), np.asarray(jovf))
    assert tovf[0] == (mc < M)


def _random_table(rng, R, n_targets, bins_per_target):
    """A random interleaved bit-matrix and its packed query table."""
    n_bins = sum(bins_per_target)
    W = -(-n_bins // 64) * 2
    bits = rng.integers(0, 2**32, size=(R, W), dtype=np.uint32)
    b2t = np.full(W * 32, n_targets, dtype=np.int32)
    b2t[:n_bins] = np.repeat(np.arange(n_targets), bins_per_target)
    packed = jq.pack_table_u8(bits, b2t, n_targets)
    for a, b in zip(packed, tq.pack_table_u8(bits, b2t, n_targets)):
        assert np.array_equal(a, b)
    return packed


@pytest.mark.parametrize("hf", [1, 3])
def test_bulk_target_counts_matches_jax_u8_and_u32(hf):
    rng = np.random.default_rng(hf)
    R, T = 997, 21
    tbl8, bs, be = _random_table(rng, R, T, rng.integers(1, 12, size=T))
    B, M = 24, 48
    h = _u64(rng, B * M).reshape(B, M)
    n = rng.integers(0, M + 8, size=B).astype(np.int32)  # some overflow M
    mask = np.arange(M)[None, :] < n[:, None]
    rows = jq.ibf_row_indices(jnp.asarray(h), bin_size=R, hash_functions=hf)
    want8 = np.asarray(jq.bulk_target_counts_u8(
        jnp.asarray(tbl8), rows, jnp.asarray(mask), jnp.asarray(bs),
        jnp.asarray(be)))
    want32 = np.asarray(jq.bulk_target_counts_u32(
        jnp.asarray(jq.table_as_u32(tbl8)), rows, jnp.asarray(mask),
        jnp.asarray(bs), jnp.asarray(be)))
    assert np.array_equal(want8, want32)
    want = np.minimum(want8, n[:, None])
    tbl = torch.from_numpy(tq.table_as_u32(tbl8).view(np.uint8))
    got = tq.bulk_target_counts_packed(
        tbl, torch.from_numpy(bs), torch.from_numpy(be), tm.u64_to_torch(h),
        torch.from_numpy(n), bin_size=R, hash_functions=hf)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def _counts_case(rng, B, T):
    n = rng.integers(0, 60, size=B).astype(np.int32)
    n[:3] = [0, 1, 70000 % 65536]  # empty read, a single hash, a big one
    counts = (rng.random((B, T)) ** 4 * (n[:, None] + 1)).astype(np.int32)
    counts = np.minimum(counts, n[:, None])
    hot = rng.integers(0, T, size=B)
    counts[np.arange(B), hot] = n  # one full-score target per read
    return counts, n


@pytest.mark.parametrize("T,top_k", [(64, 8), (4096, 4)])
@pytest.mark.parametrize("emit", [True, False])
def test_threshold_topk_and_pack_match_jax(T, top_k, emit):
    """Both JAX top-K tiers: the full sort (T < 4096) and the iterative
    argmax (k <= 8, T >= 4096)."""
    rng = np.random.default_rng(T + top_k + emit)
    B = 48
    counts, n = _counts_case(rng, B, T)
    args = (0.3, 0.4, 55)  # reads with n > 55 are over the limit
    jres = jdev.threshold_topk(jnp.asarray(counts), jnp.asarray(n), *args,
                               top_k=top_k, sort16=True, emit_matches_t=emit)
    tres = tdev.threshold_topk(torch.from_numpy(counts), torch.from_numpy(n),
                               *args, top_k=top_k, emit_matches_t=emit)
    assert set(jres) == set(tres)
    for key in tres:
        assert np.array_equal(np.asarray(tres[key]), np.asarray(jres[key])), key
    ovf = (rng.random(B) < 0.1).astype(np.uint8)
    want = np.asarray(jdev._pack_result(
        jres, jnp.asarray(n), jnp.asarray(ovf.astype(bool)), pack16=True,
        match_cap=0))
    got = tdev.select(torch.from_numpy(counts), torch.from_numpy(n),
                      torch.from_numpy(ovf), *args, top_k=top_k,
                      emit_matches_t=emit)
    assert np.array_equal(got.numpy(), want)
