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
from ganon_tpu_torch.ops import library as lib
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


def _random_matrix(rng, R, W, density):
    """int32 ``[R, W]`` of random bits, each set with ``density``."""
    planes = rng.random((R, W, 32)) < density
    words = (planes.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        axis=2)
    return words.astype(np.uint32)


# (W, M, S, mask density, bit density): reads of more than 32 valid hashes
# under a mask with holes, S at 1 and at the kernel's 8, row widths off the
# kernel's 4-word tile and its 16-word span, a row past the one-launch
# bulk_target_counts route (bins_target_fused)
_BINS_CASES = {
    "over-32-holes": (33, 100, 2, 0.6, 0.5),
    "S1": (32, 40, 1, 0.5, 0.3),
    "S8": (12, 50, 8, 0.8, 0.9),
    "W7-off-tile": (7, 45, 3, 0.7, 0.7),
    "W2000-past-fused": (2000, 40, 2, 0.5, 0.5),
}


@pytest.mark.parametrize("case", list(_BINS_CASES), ids=list(_BINS_CASES))
def test_bins_shapes_match_jax(case):
    """bulk_count_bins and bulk_target_counts (a shuffled bin map, so a
    permutation) against JAX's at the kernels' edge shapes."""
    W, M, S, mdens, bdens = _BINS_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    R, B = 61, 5
    bits = _random_matrix(rng, R, W, bdens)
    rows = rng.integers(0, R, size=(B, M, S)).astype(np.int32)
    mask = rng.random((B, M)) < mdens
    mask[1] = True  # every slot
    mask[2] = False  # none
    mask[3, :M // 2] = False  # valid slots after a hole only
    if case == "over-32-holes":
        assert mask[0].sum() > 32 and not mask[0, :mask[0].sum()].all()
    want = np.asarray(jops.bulk_count_bins(jnp.asarray(bits),
                                           jnp.asarray(rows),
                                           jnp.asarray(mask)))
    args = (torch.from_numpy(bits.view(np.int32)), torch.from_numpy(rows),
            torch.from_numpy(mask))
    got = tops.bulk_count_bins(*args)
    assert np.array_equal(got.numpy(), want)
    assert want[0].sum() > 0 and not want[2].any()
    T = 9
    b2t = rng.integers(0, T + 1, size=W * 32).astype(np.int32)  # T: padding
    perm, starts, ends = tops.target_segments(b2t, T)
    assert perm is not None
    want_t = np.asarray(jops.bulk_target_counts(
        jnp.asarray(bits), jnp.asarray(rows), jnp.asarray(mask),
        jnp.asarray(starts), jnp.asarray(ends), jnp.asarray(perm)))
    got_t = tops.bulk_target_counts(*args, torch.from_numpy(starts),
                                    torch.from_numpy(ends),
                                    torch.from_numpy(perm.astype(np.int32)))
    assert np.array_equal(got_t.numpy(), want_t) and want_t.sum() > 0
    assert lib.bins_target_fused(W) == (W <= 1816)


@pytest.mark.parametrize("with_perm", [False, True],
                         ids=["identity", "perm"])
def test_bulk_target_counts_reversed_ranges_match_jax(jibf, with_perm):
    """Hand-made ranges: some with ends < starts (JAX's cumsum difference
    reads minus the sum over [ends, starts)), empty ones, the whole row."""
    ibf, _, rows, mask = jibf
    TB = ibf.bits.shape[1] * 32
    rng = np.random.default_rng(21 + with_perm)
    starts = rng.integers(0, TB + 1, size=40).astype(np.int32)
    ends = rng.integers(0, TB + 1, size=40).astype(np.int32)
    starts[:3], ends[:3] = [0, TB, 17], [TB, 0, 17]
    assert (ends < starts).sum() > 5 and (ends > starts).sum() > 5
    perm = rng.permutation(TB).astype(np.int32) if with_perm else None
    want = np.asarray(jops.bulk_target_counts(
        jnp.asarray(ibf.bits), jnp.asarray(rows), jnp.asarray(mask),
        jnp.asarray(starts), jnp.asarray(ends),
        None if perm is None else jnp.asarray(perm)))
    got = tops.bulk_target_counts(
        *_port_args(ibf, rows, mask), torch.from_numpy(starts),
        torch.from_numpy(ends),
        None if perm is None else torch.from_numpy(perm))
    assert np.array_equal(got.numpy(), want)
    assert (want < 0).any() and (want > 0).any()


@pytest.mark.parametrize("n_words,fused", [
    (32, True),        # chip_smoke.py's db: 1024 targets
    (1815, True), (1816, True), (1817, False),  # the limit, 227 KB a block
    (2188, False),     # 70,000 targets
    (0, False),
], ids=["db-32", "limit-1", "limit", "limit+1", "T70000-2188", "empty"])
def test_bins_target_route_by_shape(n_words, fused):
    """The card's bulk_target_counts route is a rule on the row width
    alone: one launch while a read's 32 n_words int32 counts fit a block's
    shared memory, bins into scratch and the segment pass past it."""
    assert lib.bins_target_fused(n_words) is fused
    assert lib.BINS_TARGET_SHARED_BYTES == 227 * 1024


def _tile_sums(bins, ids, T):
    """What the card's tsum computes, tile by tile: each tile of
    ``tsum_tiles(T)`` sums the bins of its window (``target_windows``;
    the whole row at one tile) whose ids fall in it."""
    tiles, width = lib.tsum_tiles(T)
    win = (lib.target_windows(torch.from_numpy(ids), T, width).numpy()
           if tiles > 1 else np.array([[0, ids.size]]))
    out = np.empty((bins.shape[0], T), np.int64)
    for k, (lo, hi) in enumerate(win):
        t0, t1 = k * width, min(T, (k + 1) * width)
        acc = np.zeros((bins.shape[0], t1 - t0), np.int64)
        j = np.arange(lo, hi)
        j = j[(ids[j] >= t0) & (ids[j] < t1)]
        np.add.at(acc, (slice(None), ids[j] - t0), bins[:, j])
        out[:, t0:t1] = acc
    return out


# (T, TB, map): the tile edges of the card's tsum (12,288 targets a tile:
# one target, one under, at, one over), T = 70,000 ascending (padding bins
# carry T) and shuffled, ids far out of range, every bin on one target, a
# tile with no bin
_TSUM_CASES = {
    "T1": (1, 40, "edges"),
    "T12287-under-tile": (12_287, 96, "edges"),
    "T12288-at-tile": (12_288, 96, "edges"),
    "T12289-over-tile": (12_289, 96, "edges"),
    "T70000-ascending": (70_000, 128, "ascending"),
    "T70000-shuffled": (70_000, 128, "shuffled"),
    "out-of-range": (24_577, 64, "out"),
    "one-target": (30_000, 64, "one"),
    "empty-tile": (36_864, 96, "gap"),
}


@pytest.mark.parametrize("case", list(_TSUM_CASES), ids=list(_TSUM_CASES))
def test_target_counts_tiles_match_jax(case):
    """target_counts against JAX's one-hot matmul at the card's tile edges
    and maps, and the card's tile-by-tile sums over the plan's windows
    equal to both."""
    T, TB, kind = _TSUM_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    width = lib.tsum_tiles(T)[1]
    if kind == "edges":  # ids around every tile edge, and out of range
        edges = np.arange(0, T + 1, width)
        near = np.concatenate([edges - 1, edges, edges + 1, [T - 1, T, -1]])
        ids = rng.choice(near, size=TB)
    elif kind in ("ascending", "shuffled"):
        ids = np.sort(rng.integers(0, T, size=TB))
        ids[-16:] = T  # padding bins
        if kind == "shuffled":
            rng.shuffle(ids)
    elif kind == "out":
        ids = rng.integers(0, T, size=TB)
        ids[::3] = rng.choice([-1, -2**31, T, T + 7, 2**31 - 1], size=len(
            ids[::3]))
    elif kind == "one":
        ids = np.full(TB, T // 2)
    else:  # no bin in the middle tile
        ids = rng.integers(0, T, size=TB)
        ids[(ids >= width) & (ids < 2 * width)] = 0
    ids = ids.astype(np.int32)
    bins = rng.integers(0, 40, size=(4, TB)).astype(np.int32)
    bins[rng.random(bins.shape) < 0.3] = 0
    want = np.asarray(jops.target_counts(jnp.asarray(bins), jnp.asarray(ids),
                                         num_targets=T))
    got = tops.target_counts(torch.from_numpy(bins), torch.from_numpy(ids),
                             num_targets=T)
    assert np.array_equal(got.numpy(), want) and want.sum() > 0
    assert np.array_equal(_tile_sums(bins, ids, T), want)


@pytest.mark.parametrize("T,tiles,width", [
    (1, 1, 4), (3, 1, 4), (1024, 1, 1024),  # db: one warp a read
    (12_287, 1, 12_288), (12_288, 1, 12_288),  # one tile, 48 KB of sums
    (12_289, 2, 6148), (24_577, 3, 8196),  # balanced tiles past it
    (70_000, 6, 11_668), (10**7, 814, 12_288),
], ids=["T1", "T3", "db-1024", "T12287", "T12288", "T12289", "T24577",
        "T70000", "T1e7"])
def test_tsum_tiles_by_targets(T, tiles, width):
    """The card's tsum tiles are a rule on T alone: as few tiles as hold
    12,288 targets each, balanced, widths a multiple of 4; the plan runs
    only past one tile."""
    assert lib.tsum_tiles(T) == (tiles, width)
    assert width % 4 == 0 and width <= lib.TSUM_TILE_TARGETS
    assert (tiles - 1) * width < T <= tiles * width


def test_target_windows_plain():
    """A tile's window runs from its first bin to one past its last, over
    an unsorted map (other tiles' bins inside it), and is [0, 0] for a
    tile with no bin."""
    ids = torch.tensor([5, -1, 0, 9, 4, 12, 3, 8, 99], dtype=torch.int32)
    win = lib.target_windows(ids, 14, 4)
    assert win.dtype == torch.int32
    assert win.tolist() == [[2, 7], [0, 5], [3, 8], [5, 6]]
    assert lib.target_windows(ids, 24, 8).tolist() == [[0, 7], [3, 8],
                                                       [0, 0]]
