"""The port's ``ops`` library API (K18) against ``ganon_tpu.ops``, exactly.

Seeded numpy inputs go through the JAX package's exported functions and
the port's counterparts (their plain torch versions, on the CPU); every
output is an integer, so every comparison is exact. The bit-matrix is an
IBF the JAX package builds (as ``tests/test_ibf.py`` builds it), with
padding bins past the last target's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ganon_tpu  # noqa: F401  (turns on jax x64 for the u64 reference)
import ganon_tpu.ops as jops
import ganon_tpu_torch.ops as tops
from ganon_tpu.index import build_ibf
from ganon_tpu_torch.ops.winnow import torch_to_u64, u64_to_torch

K, W = 19, 31


def test_exports_cover_the_jax_api():
    """``from ganon_tpu_torch.ops import *`` gives a counterpart of every
    name JAX exports (``minimizers`` for ``minimizers_jax``)."""
    names = {}
    exec("from ganon_tpu_torch.ops import *", names)
    want = {"minimizers" if n == "minimizers_jax" else n
            for n in jops.__all__}
    assert want <= set(names) and set(tops.__all__) == want
    assert tops.adjust_seed(K) == jops.adjust_seed(K)
    seqs = ["ACGTNacgu", "", "GATTACA" * 9]
    assert all(np.array_equal(a, b) for a, b in zip(
        tops.encode_seqs(seqs), jops.encode_seqs(seqs)))
    assert tops.minimizers_golden(seqs[2], 5, 9) == jops.minimizers_golden(
        seqs[2], 5, 9)


@pytest.mark.parametrize("L,mm", [(150, 200), (203, 200), (203, 7),
                                  (30, 16)],
                         ids=["L150", "L203-not-x4", "past-max", "L-below-w"])
def test_minimizers_matches_jax(L, mm):
    """Rows shorter than w, lengths past L, L not a multiple of 4, more
    emissions than max_minimizers, a batch narrower than w."""
    rng = np.random.default_rng(L + mm)
    B = 24
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    lens = rng.integers(0, L + 40, size=B).astype(np.int32)
    lens[:4] = [0, W - 1, W, L]
    want_h, want_n = jops.minimizers_jax(jnp.asarray(codes),
                                         jnp.asarray(lens), k=K, w=W,
                                         max_minimizers=mm)
    got_h, got_n = tops.minimizers(torch.from_numpy(codes),
                                   torch.from_numpy(lens), k=K, w=W,
                                   max_minimizers=mm)
    assert got_h.dtype == torch.int64 and got_h.shape == (B, mm)
    assert np.array_equal(torch_to_u64(got_h), np.asarray(want_h))
    assert np.array_equal(got_n.numpy(), np.asarray(want_n))
    if L >= W:
        assert got_n.numpy().max() > 0
    if mm == 7:
        assert (got_n.numpy() > mm).any()


@pytest.fixture(scope="module")
def jibf():
    """A JAX-built IBF of 9 targets (one large enough to take several
    bins) and reads' hashes: the targets' own, foreign ones, masked and
    empty rows."""
    rng = np.random.default_rng(5)
    th = {}
    for i in range(9):
        n = 3000 if i == 4 else int(rng.integers(50, 700))
        th[f"T{i}"] = np.unique(rng.integers(0, 2**62, size=n,
                                             dtype=np.uint64))
    ibf = build_ibf(th, kmer_size=K, window_size=W, max_fp=0.05)
    assert ibf.bits.shape[1] * 32 > ibf.ibf_config.n_bins  # padding bins
    B, M = 12, 90
    hashes = rng.integers(0, 2**64, size=(B, M), dtype=np.uint64)
    for b in range(8):
        own = th[f"T{b}"]
        hashes[b, :60] = own[rng.integers(0, len(own), size=60)]
    mask = rng.random((B, M)) < 0.8
    mask[9] = False  # an empty row
    rows = np.asarray(jops.ibf_row_indices(
        jnp.asarray(hashes), bin_size=ibf.ibf_config.bin_size_bits,
        hash_functions=ibf.ibf_config.hash_functions))
    return ibf, hashes, rows, mask


def test_ibf_row_indices_match_jax(jibf):
    ibf, hashes, rows, _ = jibf
    got = tops.ibf_row_indices(u64_to_torch(hashes),
                               bin_size=ibf.ibf_config.bin_size_bits,
                               hash_functions=ibf.ibf_config.hash_functions)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), rows)


def _port_args(ibf, rows, mask):
    return (torch.from_numpy(ibf.bits.view(np.int32).copy()),
            torch.from_numpy(rows.astype(np.int32)), torch.from_numpy(mask))


def test_bulk_count_bins_matches_jax(jibf):
    ibf, _, rows, mask = jibf
    want = np.asarray(jops.bulk_count_bins(jnp.asarray(ibf.bits),
                                           jnp.asarray(rows),
                                           jnp.asarray(mask)))
    got = tops.bulk_count_bins(*_port_args(ibf, rows, mask))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert want[:8].sum() > 0 and not want[9].any()
    # M = 0: every count is zero
    empty = tops.bulk_count_bins(*_port_args(ibf, rows[:, :0], mask[:, :0]))
    assert empty.shape == want.shape and not empty.any()


def test_target_counts_matches_jax(jibf):
    """The IBF's bin map (padding bins carry id T), and ids out of range
    (negative, T and past it), all dropped as JAX's one_hot drops them."""
    ibf, _, rows, mask = jibf
    T = len(ibf.targets())
    bins = np.asarray(jops.bulk_count_bins(
        jnp.asarray(ibf.bits), jnp.asarray(rows),
        jnp.asarray(mask))).astype(np.int32)
    b2t = ibf.bin_to_target_ids()  # [32 n_words], padding bins T
    assert (b2t == T).any()
    odd = b2t.copy()
    odd[::7] = -1
    odd[3::11] = T + 5
    for ids in (b2t, odd):
        want = np.asarray(jops.target_counts(jnp.asarray(bins),
                                             jnp.asarray(ids), num_targets=T))
        got = tops.target_counts(torch.from_numpy(bins),
                                 torch.from_numpy(ids), num_targets=T)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
        assert want.sum() > 0


@pytest.mark.parametrize("shuffle", [False, True],
                         ids=["identity-perm", "shuffled-perm"])
def test_bulk_target_counts_matches_jax(jibf, shuffle):
    """The segments of the IBF's bin map (perm None) and of a shuffled
    map (a permutation), equal to JAX's and to the two-step form."""
    ibf, _, rows, mask = jibf
    T = len(ibf.targets())
    b2t = ibf.bin_to_target_ids()
    if shuffle:
        np.random.default_rng(8).shuffle(b2t)
    perm, starts, ends = jops.target_segments(b2t, T)
    tperm, tstarts, tends = tops.target_segments(b2t, T)
    assert (perm is None) == (not shuffle) == (tperm is None)
    assert np.array_equal(starts, tstarts) and np.array_equal(ends, tends)
    want = np.asarray(jops.bulk_target_counts(
        jnp.asarray(ibf.bits), jnp.asarray(rows), jnp.asarray(mask),
        jnp.asarray(starts), jnp.asarray(ends),
        None if perm is None else jnp.asarray(perm)))
    args = _port_args(ibf, rows, mask)
    got = tops.bulk_target_counts(
        *args, torch.from_numpy(tstarts), torch.from_numpy(tends),
        None if tperm is None else torch.from_numpy(tperm.astype(np.int32)))
    assert np.array_equal(got.numpy(), want)
    two_step = tops.target_counts(tops.bulk_count_bins(*args),
                                  torch.from_numpy(b2t), num_targets=T)
    assert np.array_equal(two_step.numpy(), want) and want.sum() > 0
