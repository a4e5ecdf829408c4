"""The CUDA kernels against their plain torch versions, on the card.

Edge shapes beyond the main path: windows of one k-mer, k = 32, long
reads, overflowing compaction, table rows spanning several count tiles,
more hashes than one shared-memory chunk, wide target sets and large K;
count into a column range of a wider matrix (forest mode), merge of a
level in one launch (two past 16 filters) with ties and a one-target
filter into garbage-filled union rows off 16 bytes, select with winners at K = 1 and
K = T; select in its 32-bit mode at B = 0, T = 65,536 and 65,537,
counts at 2^31 - 1 and with every or no target final. The pruned
forest's modes: gate, fine (dense and probe-all),
select in lanes mode and scatter in pruned mode (a flush of runs out of
group order in one launch, groups over several slices, h up to 5 on both
tables, into tables that hold bits), at group counts that
are not multiples of 8 or 32, at the gate's 1024-group tile and one group
past it (and at 9001 groups), S 2 and 32 at 128 groups, coarse_h and
fine_h 5, group sizes 8, 16 (padded rows), 40 (a partial word), 256 (the
fine kernel's lane tile) and 264 (past it), a partly full last group,
ties at S 3 and 32, reads with no survivor, exactly S and more than S
survivors, reads without hashes, reads at the hashes limit and more
hashes than slots (several 32-hash rounds, a partial last one). Count in column-max mode (raptor subs): a
target over three tiles, h = 1 and 5 in one layout, a one-target sub, a
user bin in two subs with equal and unequal counts, a column no sub
writes; the raptor batch on the card against the CPU; build_pruned's
default build on the card. The two-pass build's kernels: sort at N = 0,
1, one block, one entry past a block and up to ~4000 blocks (the
look-back spans more blocks than the card has SMs), all-equal values,
values >= 2^63, one file and 2^16 files, and its digit histograms and
pass plan (38-bit values, every digit constant); pack with empty and
full rows, at B = 1 and B off its 32-row tile, twice on one stream;
dedup in both modes (counts only; flags, ranks and counts in one
chained scan) with files that have no entries, duplicates across tile
and warp edges, a file over many tiles and a tile of many files, keys
past num_files, N = 0 and 1; the fused ranked scatter (flags, ranks,
bins and bits in one call) with a target over several bins at h = 1 to
5, nhb 1 and 100,000, into a matrix that already holds bits, and past
the item budget (several calls, the rank carried between them; span and
flat modes too); the whole pipeline and run_build on the card against
the CPU.
The device mesh's modes (K17): count in shard mode and combine with a
target over three shards and with one shard (equal to the flat count),
on poisoned buffers (neither is filled by the caller), combine in
column-max mode, at T and block rows off its 16-byte quads, in forest
mode at col0 and ldc off 4, at its 32 shards and past them (raises), fine in shard mode over a shard of pad
groups only, and the ranked scatter in span mode with every entry
outside the span; a mesh of the card and the CPU, so inputs and partials
cross devices. The ops library (K18): minimizers at L not a multiple of
4 and past max_minimizers, bins with a row wider than a block and with
M = 0, more than 32 valid hashes under a mask with holes, S 1 and 8,
rows off its 4-word tile and 16-word span, tsum with ids out of range,
at and around its 12,288-target tile (one tile, two), at 70,000 targets
with an ascending and a shuffled map, every bin on one target, a tile
with no bin, rows off 16 bytes and B = 1, bins_target with and without a
permutation, with reversed ranges, in one launch up to 1816 words a row
and in two past it; the ragged stream at a cap
of 1, inside the first block, overflowing and exact caps (winners,
group words) over up to 274 blocks, each call twice on the stream's
status buffer; pairs with every read
spilling; probe_sort with equal keys at both routes' edges (M 1 to
4096, n = 0 and past M, bin_size near 2^46); the gather probe at N 0 to
2^20 (the warp step's edges), R 16, one group, the int32 wrap at 2^26 +
5 probes, rows off 16 bytes, two streams, garbage in the allocator; the
transfer settings (ragged, pair caps, sort_probes) on the card against
the CPU.
The tiled extract at the build's shape, over many 512-window tiles, at
B 1, with short mates, w == k, k 32 and runs of one base, with and
without the zero tail; pairs over 274 blocks at S 1-9 and on rows off
word alignment; ragged, extract, pairs and dedup's rank mode sharing
one stream's status words, and a second stream's. Extract's wide-window
route at the widest window the tiles hold and one past it (k 19 and 32),
paired and single-end; select in every mode with 2048 and 2049 kept entries (the
list's capacity and the passes over the row), T % 4 != 0 and K past and
below the finals; count at rows of 1 to 256 words, h 1-5, in flat,
forest, shard and column-max modes; every raptor sub in one launch
against one launch a sub; count's ring route at the flat arc_cg_ibf
table's 160-word rows and on both sides of its band's edges.
The filter load's repack: the whole table and column windows at db's
one-bin-a-target shape (row runs of 63, 65 and 1 rows), the wide
filter's 2188-word rows, uneven, shuffled and dropped bins and a W8 off
4, into garbage-filled memory; rows of 2 and 3 words, a view 12 bytes
off 16, fewer rows than a ring stage and one past three stages, runs cut
at source-word edges, a shuffled wide layout read in place, windows off
the 16-byte grid, and 200 calls on two streams; a table past 2^31 bytes;
a refused launch raises; and flat, forest and raptor loads on the card
(alone and on a mesh of views) with the host repacks made to raise,
equal to the CPU's loads.
Each test skips on a host without CUDA (the kernels have no CPU mode);
on the H100 run ``python -m pytest --noconftest tests/test_torch_cuda.py -q``
(the suite's ``conftest.py`` imports jax, which that machine lacks).
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from ganon_tpu_torch import kernels, trace
from ganon_tpu_torch.classify import device as dev
from ganon_tpu_torch.index.ibf import _scatter_bits, scatter_hashes
from ganon_tpu_torch.index.pruned import scatter_pruned, scatter_pruned_plain
from ganon_tpu_torch.ops import build_ops as bo
from ganon_tpu_torch.ops import ibf_query as q
from ganon_tpu_torch.ops import pruned_query as pq

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inbuf(rng, B, L1, L2, w):
    row = L1 // 4 + L2 // 4 + 4 + (4 if L2 else 0)
    buf = rng.integers(0, 256, size=(B, row), dtype=np.uint8)
    lens = [rng.integers(0, L + 1, size=B).astype("<i4") for L in (L1, L2)]
    for lv, L in zip(lens, (L1, L2)):
        lv[:4] = [0, w - 1, w, L]
    o = L1 // 4 + L2 // 4
    buf[:, o:o + 4] = lens[0].view(np.uint8).reshape(B, 4)
    if L2:
        buf[:, o + 4:o + 8] = lens[1].view(np.uint8).reshape(B, 4)
    return torch.from_numpy(buf)


@pytest.mark.parametrize("k,w,L1,L2", [
    (4, 4, 128, 128), (15, 15, 160, 0), (19, 20, 160, 160),
    (19, 31, 160, 160), (32, 40, 256, 0), (19, 31, 1024, 0),
])
def test_extract_kernel_matches_plain(cuda, k, w, L1, L2):
    rng = np.random.default_rng(k + w + L1 + L2)
    inbuf = _inbuf(rng, 300, L1, L2, w).to(cuda)
    m = (L1 - w + 1) + (L2 - w + 1 if L2 else 0)
    for mc in (dev.compact_width(m), m):
        got = q.extract(inbuf, L1=L1, L2=L2, k=k, w=w, mc=mc)
        want = q.extract_plain(inbuf, L1=L1, L2=L2, k=k, w=w, mc=mc)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _set_lens(inbuf, L1, L2, len1, len2=0):
    """Write the length fields of a packed batch (numpy u8 rows)."""
    o = L1 // 4 + L2 // 4
    B = inbuf.shape[0]
    for at, lens in ((o, len1), (o + 4, len2)) if L2 else ((o, len1),):
        inbuf[:, at:at + 4] = np.broadcast_to(
            np.asarray(lens, "<i4"), (B,)).copy().view(np.uint8).reshape(B, 4)


def _extract_case(case):
    """(inbuf numpy, L1, L2, k, w, mcs) of an extract edge case; the first
    width of the cases past "one_read" overflows some read."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "build":  # the build's pieces, 16 tiles a card's SM
        k, w, L1, L2, B = 19, 31, 2048, 0, 4096
        buf = _inbuf(rng, B, L1, L2, w).numpy()
        lens = np.full(B, L1, np.int64)
        lens[::7] = rng.integers(w, L1, size=len(lens[::7]))
        _set_lens(buf, L1, L2, lens)
        return buf, L1, L2, k, w, (L1 - w + 1,)
    if case == "one_read":
        k, w, L1, L2 = 19, 31, 1024, 1024
        buf = _inbuf(rng, 4, L1, L2, w).numpy()[:1].copy()
        _set_lens(buf, L1, L2, 1000, 700)
        return buf, L1, L2, k, w, (2 * (L1 - w + 1),)
    if case == "several_tiles":  # segment boundaries inside windows
        k, w, L1, L2 = 19, 31, 65_536, 0
        buf = _inbuf(rng, 4, L1, L2, w).numpy()[:3].copy()
        _set_lens(buf, L1, L2, [L1, 40_000, 511 + w])
        return buf, L1, L2, k, w, (5000, L1 - w + 1)
    if case == "short_mates":  # len1 < w with a long mate 2; mate 2 < w
        k, w, L1, L2 = 19, 31, 160, 160
        buf = _inbuf(rng, 7, L1, L2, w).numpy()
        _set_lens(buf, L1, L2, [w - 1, 0, 150, 150, w, 160, 160],
                  [150, 150, w - 1, 0, w, 160, 160])
        buf[6, :80] = 0x00  # a run of one base: its read overflows 20
        return buf, L1, L2, k, w, (20, 260)
    if case == "w_equals_k":
        k, w, L1, L2 = 21, 21, 1100, 0
        buf = _inbuf(rng, 40, L1, L2, w).numpy()
        return buf, L1, L2, k, w, (dev.compact_width(L1 - w + 1), L1 - w + 1)
    if case == "k32":
        k, w, L1, L2 = 32, 45, 1600, 800
        buf = _inbuf(rng, 40, L1, L2, w).numpy()
        return buf, L1, L2, k, w, (200, 2344)
    if case == "equal_bases":  # one base repeated: ties on every window
        k, w, L1, L2 = 19, 31, 1200, 160
        buf = _inbuf(rng, 8, L1, L2, w).numpy()
        buf[:4, :L1 // 4 + L2 // 4] = 0x00
        buf[4:, :L1 // 4 + L2 // 4] = 0xAA
        buf[6:, 100:140] = 0xE4  # a stretch of ACGT repeats among them
        _set_lens(buf, L1, L2, [L1, 700, 31, L1, L1, 500, L1, 1000],
                  [160, 31, 100, 0, 160, 160, 45, 160])
        m = (L1 - w + 1) + (L2 - w + 1)
        return buf, L1, L2, k, w, (dev.compact_width(m), m)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["build", "one_read", "several_tiles",
                                  "short_mates", "w_equals_k", "k32",
                                  "equal_bases"])
def test_extract_kernel_edge_shapes(cuda, case):
    """The tiled extract kernel bit for bit against its plain version: the
    build's shape (several blocks an SM), B 1, reads of many 512-window
    tiles (the segmented scan across blocks), mate 1 shorter than w beside
    a long mate 2 and mate 2 shorter than w, w == k, k 32, runs of one
    base (ties on every window); at a compacted width that overflows
    (n > mc) and at every window position; then without the zero tail,
    the first n[b] slots of each row against the plain version's."""
    buf, L1, L2, k, w, mcs = _extract_case(case)
    inbuf = torch.from_numpy(buf).to(cuda)
    for i, mc in enumerate(mcs):
        want = q.extract_plain(inbuf, L1=L1, L2=L2, k=k, w=w, mc=mc)
        got = q.extract(inbuf, L1=L1, L2=L2, k=k, w=w, mc=mc)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), mc
        assert bool(want[2].any()) == (len(mcs) == 2 and i == 0)
        h, n, o = q.extract(inbuf, L1=L1, L2=L2, k=k, w=w, mc=mc,
                            zero_tail=False)
        keep = torch.arange(mc, device=cuda)[None, :] < n[:, None]
        assert torch.equal(n, want[1]) and torch.equal(o, want[2])
        assert torch.equal(h[keep], want[0][keep])


@pytest.mark.parametrize("hf", [1, 2, 5])
def test_count_kernel_matches_plain_across_tiles(cuda, hf):
    rng = np.random.default_rng(hf)
    R, T = 2048, 2600  # W8 ~ 2 x 8 KB tiles, ragged widths
    widths = rng.integers(0, 30, size=T)
    tbl8 = torch.from_numpy(rng.integers(
        0, 256, size=(R, -(-int(((widths + 7) // 8).sum()) // 4) * 4),
        dtype=np.uint8))
    ends = np.cumsum((widths + 7) // 8).astype(np.int32)
    starts = np.concatenate([[0], ends[:-1]]).astype(np.int32)
    B, M = 64, 300  # more hashes than one shared-memory chunk
    h = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, size=(B, M)))
    n = torch.from_numpy(rng.integers(0, M + 50, size=B).astype(np.int32))
    args = [x.to(cuda) for x in (tbl8, torch.from_numpy(starts),
                                 torch.from_numpy(ends), h, n)]
    got = q.bulk_target_counts_packed(*args, bin_size=R, hash_functions=hf)
    want = q.bulk_target_counts_packed_plain(*args, bin_size=R,
                                             hash_functions=hf)
    assert torch.equal(got, want)


@pytest.mark.parametrize("T,top_k", [(5, 128), (300, 4), (5000, 128)])
@pytest.mark.parametrize("emit", [True, False])
def test_select_kernel_matches_plain(cuda, T, top_k, emit):
    rng = np.random.default_rng(T + top_k)
    B = 257
    n = rng.integers(0, 80, size=B).astype(np.int32)
    counts = np.minimum(rng.integers(0, 80, size=(B, T)),
                        n[:, None]).astype(np.int32)
    counts[:, : T // 2] = n[:, None]  # ties and many final matches
    ovf = (rng.random(B) < 0.2).astype(np.uint8)
    c, nn, o = (torch.from_numpy(x).to(cuda) for x in (counts, n, ovf))
    for cuts in ((0.2, 0.0, 65535), (0.75, 1.0, 70), (0.0, 0.5, 65535)):
        got = dev.select(c, nn, o, *cuts, top_k=top_k, emit_matches_t=emit)
        want = dev._pack_result(
            dev.threshold_topk(c, nn, *cuts, top_k=top_k,
                               emit_matches_t=emit),
            nn, o.to(torch.int32))
        assert torch.equal(got, want)


def _select32_case(rng, B, T, case):
    """Counts, n_hashes and overflow of one 32-bit select edge case."""
    n = rng.integers(60_000, 200_000, size=B).astype(np.int32)
    counts = np.minimum(rng.integers(0, 200_000, size=(B, T)),
                        n[:, None]).astype(np.int32)
    if case == "max-count":  # counts and n at 2^31 - 1
        n[:] = np.iinfo(np.int32).max
        counts[:, ::3] = np.iinfo(np.int32).max
        counts[:, 1::3] = np.iinfo(np.int32).max - 1
    elif case == "all-final":
        counts[:] = n[:, None]
    elif case == "none-final":
        counts[:] = 0
    else:  # ties on both sides of 0xFFFF and at the last target
        for t in {7, min(0xFFFF, T - 1), T - 1, T // 2}:
            counts[:, t] = n
    if B:
        n[0] = 0  # a read without hashes
    ovf = (rng.random(B) < 0.2).astype(np.uint8)
    return counts, n, ovf


@pytest.mark.parametrize("B,T,case", [
    (0, 300, "ties"), (33, 300, "ties"), (65, 1000, "all-final"),
    (65, 1000, "none-final"), (40, 65_536, "ties"), (40, 65_537, "ties"),
    (17, 70_000, "max-count"), (17, 70_000, "all-final"),
])
@pytest.mark.parametrize("top_k", [1, 4, 128])
def test_select32_kernel_matches_plain(cuda, B, T, case, top_k):
    """The 32-bit mode (``pack16=False``) against its plain version: B =
    0, T not a multiple of 256, T = 65,536 and 65,537, counts at 2^31 -
    1, every target final, no target final, K above the matches."""
    rng = np.random.default_rng(B + T + top_k)
    counts, n, ovf = _select32_case(rng, B, T, case)
    c, nn, o = (torch.from_numpy(x).to(cuda) for x in (counts, n, ovf))
    before = kernels.LAUNCHES["select32"]
    for cuts in ((0.75, 0.1, (1 << 32) - 1), (0.0, 1.0, 150_000),
                 (0.2, 0.0, (1 << 32) - 1)):
        for emit in (True, False):
            got = dev.select(c, nn, o, *cuts, top_k=top_k,
                             emit_matches_t=emit, pack16=False)
            want = dev._pack_result(
                dev.threshold_topk(c, nn, *cuts, top_k=top_k,
                                   emit_matches_t=emit, pack16=False),
                nn, o.to(torch.int32), pack16=False)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
    assert kernels.LAUNCHES["select32"] - before == (6 if B else 0)


@pytest.mark.parametrize("hf", [1, 4])
def test_scatter_kernel_matches_plain(cuda, hf):
    rng = np.random.default_rng(hf)
    R, W, N = 5003, 6, 20001
    hashes = rng.integers(-2**63, 2**63 - 1, size=N)
    hashes[N // 2:2 * (N // 2)] = hashes[: N // 2]  # duplicate pairs
    h = torch.from_numpy(hashes).to(cuda)
    bins = torch.from_numpy(rng.integers(0, W * 32, size=N).astype(np.int32)).to(cuda)
    # a matrix that already holds bits: the scatter ORs, never overwrites
    a = torch.from_numpy(rng.integers(-2**31, 2**31, size=(R, W)).astype(
        np.int32) & (rng.random((R, W)) < 0.1)).to(cuda)
    b = a.clone()
    c = a.clone()
    before = kernels.LAUNCHES["scatter"]
    scatter_hashes(a, h, bins, bin_size=R, hash_functions=hf)
    scatter_hashes(c, h, bins, bin_size=R, hash_functions=hf,
                   word_cols=(0, W))
    _scatter_bits(b, h, bins, bin_size=R, hash_functions=hf)
    assert kernels.LAUNCHES["scatter"] == before + 2
    assert torch.equal(a, b) and torch.equal(c, b)


@pytest.mark.parametrize("col0", [0, 37])
def test_count_kernel_forest_mode_matches_plain(cuda, col0):
    """Counts written into columns col0.. of a wider matrix, with the
    other columns left as they were."""
    rng = np.random.default_rng(col0)
    R, T, ldc = 1024, 300, 400
    widths = rng.integers(1, 20, size=T)
    tbl8 = torch.from_numpy(rng.integers(
        0, 256, size=(R, -(-int(((widths + 7) // 8).sum()) // 4) * 4),
        dtype=np.uint8))
    ends = np.cumsum((widths + 7) // 8).astype(np.int32)
    starts = np.concatenate([[0], ends[:-1]]).astype(np.int32)
    B, M = 70, 60
    h = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, size=(B, M)))
    n = torch.from_numpy(rng.integers(0, M + 5, size=B).astype(np.int32))
    args = [x.to(cuda) for x in (tbl8, torch.from_numpy(starts),
                                 torch.from_numpy(ends), h, n)]
    fill = torch.full((B, ldc), -7, dtype=torch.int32, device=cuda)
    fill[:, col0:col0 + T] = 0
    got, want = fill.clone(), fill.clone()
    before = kernels.LAUNCHES["count_forest"]
    q.bulk_target_counts_packed(*args, bin_size=R, hash_functions=2, out=got,
                                col0=col0)
    q.bulk_target_counts_packed_plain(*args, bin_size=R, hash_functions=2,
                                      out=want, col0=col0)
    assert kernels.LAUNCHES["count_forest"] == before + 1
    assert torch.equal(got, want)
    assert (got[:, col0 + T:] == -7).all()


def _offset_view(shape, offset, fill, device):
    """A contiguous int32 tensor of ``shape`` that starts ``offset``
    elements into its buffer (rows off 16 bytes), filled with ``fill``."""
    n = int(np.prod(shape))
    buf = torch.full((n + 4,), fill, dtype=torch.int32, device=device)
    return buf[offset:offset + n].view(*shape)


@pytest.mark.parametrize("F,U", [(1, 50), (2, 50), (3, 50), (16, 1473),
                                 (20, 1473)])
def test_merge_kernel_matches_plain(cuda, F, U):
    """A level in one launch (two past MERGE_MAX_FILTERS, the second
    merging into the first's): ties with an earlier filter keep it, a
    one-target filter, cutoffs, invalid reads and an over-limit read;
    union counts and winners prefilled with garbage, rows off 16 bytes
    (U not a multiple of 4, the buffers at other offsets), counts rows off
    16 bytes too."""
    rng = np.random.default_rng(F * 7 + U)
    B = 300
    n = rng.integers(0, 60, size=B).astype(np.int32)
    n[:3] = [0, 70, 1]
    colss = [rng.permutation(U)[:int(rng.integers(1, U + 1))]
             for _ in range(F)]
    colss[min(1, F - 1)] = np.array([7])
    colss[0] = np.arange(U)[:max(U - 3, 1)]  # the union's head, in order
    base = np.minimum(rng.integers(0, 60, size=(B, U)), n[:, None])
    counts, rcs = [], list(rng.random(F) * 0.6)
    for f, cols in enumerate(colss):
        c = base[:, cols].copy()  # ties: every filter reads the same base
        c[rng.random(c.shape) < 0.3] += 1
        c = np.minimum(c, n[:, None]).astype(np.int32)
        view = _offset_view(c.shape, f % 3, -1, cuda)
        view.copy_(torch.from_numpy(c))
        counts.append(view)
    nn = torch.from_numpy(n).to(cuda)
    colmap = dev.merge_colmap(colss, U, cuda)
    for offs in ((0, 0), (1, 3), (2, 1)):
        got_c = _offset_view((B, U), offs[0], -5, cuda)
        got_w = _offset_view((B, U), offs[1], 99, cuda)
        want_c = torch.full((B, U), -5, dtype=torch.int32, device=cuda)
        want_w = torch.full_like(want_c, 99)
        before = kernels.LAUNCHES["merge"]
        dev.merge(counts, nn, rcs, 65, colmap, got_c, got_w)
        assert kernels.LAUNCHES["merge"] == before + -(
            -F // dev.MERGE_MAX_FILTERS)
        dev.merge_plain(counts, nn, rcs, 65, colmap, want_c, want_w)
        torch.cuda.synchronize()
        assert torch.equal(got_c, want_c) and torch.equal(got_w, want_w)
    if F > 2:
        assert (got_w == 1).any() and (got_w == F - 1).any()
        # in two calls, the second from f0 into what the first wrote
        got_c.fill_(-5)
        got_w.fill_(99)
        cut = F // 2
        before = kernels.LAUNCHES["merge"]
        dev.merge(counts[:cut], nn, rcs[:cut], 65, colmap, got_c, got_w)
        dev.merge(counts[cut:], nn, rcs[cut:], 65, colmap, got_c, got_w,
                  f0=cut)
        assert kernels.LAUNCHES["merge"] == before + 2
        torch.cuda.synchronize()
        assert torch.equal(got_c, want_c) and torch.equal(got_w, want_w)


@pytest.mark.parametrize("top_k", [1, 5000])
def test_select_kernel_winners_matches_plain(cuda, top_k):
    rng = np.random.default_rng(top_k)
    B, T = 129, 600
    n = rng.integers(0, 80, size=B).astype(np.int32)
    counts = np.minimum(rng.integers(0, 80, size=(B, T)),
                        n[:, None]).astype(np.int32)
    counts[:, : T // 3] = n[:, None]
    counts[rng.random((B, T)) < 0.5] = 0
    win = rng.integers(0, 4, size=(B, T)).astype(np.int32)
    ovf = (rng.random(B) < 0.2).astype(np.uint8)
    c, nn, o, wn = (torch.from_numpy(x).to(cuda)
                    for x in (counts, n, ovf, win))
    for cuts in ((0.0, 0.1, 65535), (0.0, 1.0, 70)):
        for emit in (True, False):
            got = dev.select(c, nn, o, *cuts, top_k=top_k,
                             emit_matches_t=emit, uwin=wn)
            want = dev._pack_result(
                dev.threshold_topk(c, nn, *cuts, top_k=top_k,
                                   emit_matches_t=emit, winners=wn),
                nn, o.to(torch.int32))
            assert torch.equal(got, want)


def _gate_inputs(rng, G, R, B, M, hf, S):
    """A random coarse table of G groups (rows padded to x4 bytes), read
    hashes and hash counts: n = 0, n at the limit (64), n above it and n
    above M among them. Most groups are sparse; S - 1 are dense and three
    near the cutoffs, so reads keep fewer than, exactly and more than S."""
    W8 = -(-(-(-G // 8)) // 4) * 4
    dens = np.full(W8 * 8, 0.05)
    hot = rng.permutation(G)[:S + 2]
    dens[hot[:S - 1]] = 0.95
    dens[hot[S - 1:]] = 0.45
    ctbl = (rng.random((R, W8 * 8)) < dens ** (1 / hf)).astype(np.uint8)
    ctbl = np.packbits(ctbl, axis=1, bitorder="little")
    h = rng.integers(-2**63, 2**63 - 1, size=(B, M))
    n = rng.integers(0, M + 8, size=B).astype(np.int32)
    n[:4] = [0, 64, 65, M + 5]
    return torch.from_numpy(ctbl), torch.from_numpy(h), torch.from_numpy(n)


# G = 128 is the pruned forest's shape; 1024 and 1025 groups are one
# group tile of the kernel and one group past it
@pytest.mark.parametrize("G,S,hf", [
    (37, 2, 2), (200, 3, 1), (9001, 4, 1), (128, 2, 1), (128, 32, 1),
    (1024, 3, 2), (1025, 3, 1), (37, 2, 5)])
def test_gate_kernel_matches_plain(cuda, G, S, hf):
    rng = np.random.default_rng(G + S)
    R, B, M = 777, 300, 90
    ctbl, h, n = (x.to(cuda) for x in _gate_inputs(rng, G, R, B, M, hf, S))
    ovf = torch.from_numpy((rng.random(B) < 0.1).astype(np.uint8)).to(cuda)
    seen = set()
    for cut, limit, s in ((0.3, 64, S), (0.6, 64, S), (0.2, pq.NO_HASHES_LIMIT, 0)):
        kw = dict(coarse_bin_size=R, coarse_h=hf, num_groups=G, rel_cutoff=cut,
                  hashes_limit=limit, max_groups=s, want_surv=True)
        before = kernels.LAUNCHES["gate"]
        got = pq.gate(ctbl, h, n, overflow=ovf, **kw)
        want = pq.gate_plain(ctbl, h, n, overflow=ovf, **kw)
        assert kernels.LAUNCHES["gate"] == before + 1
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        if s:  # reads with no, fewer than S, exactly S, more than S groups
            n_surv = want[3].sum(dim=1)
            seen.update(int(v) for v in torch.sign(n_surv - s).unique())
            seen.update([2] if (n_surv == 0).any() else [])
    assert seen == {-1, 0, 1, 2}


@pytest.mark.parametrize("S", [3, 32])
def test_gate_kernel_ties(cuda, S):
    """Every group's coarse bit set in every row: all survivors tie, and
    the slots take the lowest group ids."""
    G, R, B, M = 45, 64, 40, 30
    ctbl = torch.full((R, 8), 0xFF, dtype=torch.uint8, device=cuda)
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, size=(B, M))).to(cuda)
    n = torch.full((B,), M, dtype=torch.int32, device=cuda)
    kw = dict(coarse_bin_size=R, coarse_h=1, num_groups=G, rel_cutoff=0.5,
              hashes_limit=65535, max_groups=S)
    got = pq.gate(ctbl, h, n, **kw)
    want = pq.gate_plain(ctbl, h, n, **kw)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert (got[0] == torch.arange(S, device=cuda)).all()


def _fine_inputs(rng, G, gs, nt_last, B, M):
    """A fine table of G groups of random bin sizes (rows padded to x4
    bytes), its group arrays and read hashes."""
    bsz = rng.integers(50, 400, size=G).astype(np.int64)
    off = np.concatenate([[0], np.cumsum(bsz)[:-1]]).astype(np.int64)
    W8 = -(-(gs // 8) // 4) * 4
    ftbl = rng.integers(0, 256, size=(int(bsz.sum()), W8), dtype=np.uint8)
    ftbl &= rng.integers(0, 256, size=ftbl.shape, dtype=np.uint8)  # sparser
    shift = np.array([q.clz64(int(b)) for b in bsz], np.int32)
    h = rng.integers(-2**63, 2**63 - 1, size=(B, M))
    n = rng.integers(0, M + 8, size=B).astype(np.int32)
    n[:3] = [0, 1, M + 5]
    t = [torch.from_numpy(x) for x in (ftbl, h, n, off, bsz, shift)]
    T = (G - 1) * gs + nt_last
    return t, T


# group sizes of one word, a partial second word (40), the kernel's
# widest lane tile (256) and one word past it (264); fine_h 5
@pytest.mark.parametrize("G,gs,hf", [
    (13, 16, 2), (70, 64, 1), (13, 8, 1), (21, 40, 3), (9, 256, 2),
    (5, 264, 1), (13, 64, 5)])
def test_fine_kernel_matches_plain(cuda, G, gs, hf):
    rng = np.random.default_rng(G * gs)
    B, M, S = 200, 300, 3
    (ftbl, h, n, off, bsz, shift), T = (
        _fine_inputs(rng, G, gs, gs // 2 + 1, B, M))
    ftbl, h, n, off, bsz, shift = (
        x.to(cuda) for x in (ftbl, h, n, off, bsz, shift))
    gsel = torch.from_numpy(rng.integers(0, G, size=(B, S)).astype(np.int32)
                            ).to(cuda)
    ok = torch.from_numpy((rng.random((B, S)) < 0.7).astype(np.uint8)).to(cuda)
    surv = torch.from_numpy((rng.random((B, G)) < 0.4).astype(np.uint8)
                            ).to(cuda)
    args = (ftbl, h, n, off, bsz, shift)
    kw = dict(fine_h=hf, group_size=gs)
    before = dict(kernels.LAUNCHES)
    for extra in (dict(gsel=gsel, slot_ok=ok),
                  dict(surv=surv, num_targets=T), dict(num_targets=T)):
        got = pq.fine_counts(*args, **kw, **extra)
        want = pq.fine_counts_plain(*args, **kw, **extra)
        assert torch.equal(got, want)
        assert (want > 0).any()
    assert kernels.LAUNCHES["fine"] == before["fine"] + 1
    assert kernels.LAUNCHES["fine_all"] == before["fine_all"] + 2


@pytest.mark.parametrize("S,gs,top_k", [(1, 64, 4), (3, 16, 48), (2, 64, 128)])
@pytest.mark.parametrize("emit", [True, False])
def test_select_lanes_kernel_matches_plain(cuda, S, gs, top_k, emit):
    rng = np.random.default_rng(S * gs + top_k)
    B, G = 257, 9
    C = S * gs
    nt = np.full(G, gs, np.int32)
    nt[-1] = gs // 2 - 3  # a partly full last group
    T = int(nt.sum())
    n = rng.integers(0, 80, size=B).astype(np.int32)
    n[:3] = [0, 80, 81]
    counts = np.minimum(rng.integers(0, 80, size=(B, C)), n[:, None])
    counts[:, : C // 2] = n[:, None]  # ties and many final lanes
    gsel = np.stack([rng.permutation(G)[:S] for _ in range(B)]).astype(np.int32)
    gsel[: B // 3, 0] = G - 1
    ok = (rng.random((B, S)) < 0.8).astype(np.uint8)
    ovf = (rng.random(B) < 0.2).astype(np.uint8)
    c, nn, o, gs_d, ok_d, nt_d = (
        torch.from_numpy(x).to(cuda)
        for x in (counts.astype(np.int32), n, ovf, gsel, ok, nt))
    K = min(top_k, C)
    for cuts in ((0.2, 0.0, 65535), (0.75, 1.0, 80), (0.0, 0.5, 65535)):
        args = (c, nn, o, gs_d, ok_d, nt_d, *cuts)
        before = kernels.LAUNCHES["select_lanes"]
        got = dev.select_lanes(*args, group_size=gs, num_targets=T, top_k=K,
                               emit_matches_t=emit)
        assert kernels.LAUNCHES["select_lanes"] == before + 1
        want = dev._pack_result(
            dev.threshold_topk(c, nn, *cuts, top_k=K, emit_matches_t=emit,
                               lanes=(gs_d, ok_d, nt_d, gs, T)),
            nn, o.to(torch.int32), dev.group_words(gs_d, ok_d))
        assert torch.equal(got, want)


@pytest.mark.parametrize("fh,ch,gs,slice_bytes,plan", [
    (1, 1, 64, None, "default"), (3, 2, 40, None, "skewed"),
    (5, 5, 8, 1024, "slices"), (2, 4, 256, 4096, "slices"),
    (1, 3, 64, 512, "slices"), (5, 5, 8, 1024, "default"),
    (2, 3, 64, 4096, "default")])
def test_scatter_pruned_kernel_matches_plain(cuda, monkeypatch, fh, ch, gs,
                                             slice_bytes, plan):
    """A flush in one launch: runs out of group order (a group's runs
    apart, empty runs, duplicate hashes), word columns over several
    slices, rows of 1, 2 and 8 words, h up to 5 on each table, into
    tables (staged by word column) that already hold bits. ``slices``:
    every column in slices; ``default``: at small slices, columns past
    MAX_COLUMN_SLICES have their fine bits set by the coarse blocks in
    the same flush; ``skewed``: half the runs in one group, whose columns
    hold more than 1 / COLUMN_SHARE of the flush, so those too."""
    from ganon_tpu_torch.index import pruned as tp

    if slice_bytes:
        monkeypatch.setattr(tp, "SLICE_BYTES", slice_bytes)
    if plan == "slices":
        monkeypatch.setattr(tp, "MAX_COLUMN_SLICES", 10**9)
        monkeypatch.setattr(tp, "COLUMN_SHARE", 1)
    rng = np.random.default_rng(fh * 10 + ch + gs)
    G, nr = 13, 300
    bsz = rng.integers(64, 3000, size=G).astype(np.int64)
    bsz[2] = 40000
    off = np.concatenate([[0], np.cumsum(bsz)[:-1]]).astype(np.int64)
    sizes = rng.integers(0, 900, size=nr)
    sizes[5:9] = 0
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    runs = np.stack([starts, rng.integers(0, G, size=nr),
                     rng.integers(0, gs, size=nr)], axis=1)
    if plan == "skewed":
        runs[::2, 1] = 2
    hashes = rng.integers(-2**63, 2**63 - 1, size=int(sizes.sum()))
    hashes[-500:] = hashes[:500]
    h = torch.from_numpy(hashes).to(cuda)
    Wf, Wc, Rc = -(-gs // 32), 1, 20000
    # the tables staged by word column, holding bits already
    fine = torch.from_numpy(rng.integers(-2**31, 2**31, size=(
        Wf, int(bsz.sum()))).astype(np.int32) & 0x01010101).to(cuda)
    coarse = torch.from_numpy(rng.integers(-2**31, 2**31, size=(
        Wc, Rc)).astype(np.int32) & 0x00100100).to(cuda)
    got = (fine.clone(), coarse.clone())
    want = (fine.clone(), coarse.clone())
    kw = dict(grp_bin_size=bsz, grp_row_off=off, fine_h=fh, coarse_h=ch)
    before = kernels.LAUNCHES["scatter_pruned"]
    scatter_pruned(*got, h, runs, **kw)
    assert kernels.LAUNCHES["scatter_pruned"] == before + 1
    scatter_pruned_plain(*want, h, runs, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(got[0], fine) and not torch.equal(got[1], coarse)
    meta, nr, nfb, _ = tp.pruned_plan(runs, len(hashes), bsz, off, Wf)
    by_atomic = meta[4 * nr + 1:5 * nr + 1] > 0
    if plan == "slices":
        assert nfb > G * Wf and not by_atomic.any()  # several a column
    elif slice_bytes or plan == "skewed":
        assert by_atomic.any() and not by_atomic.all()


def test_pruned_batch_cuda_matches_cpu(cuda):
    """classify_batch_packed_pruned and the probe-all counts: the kernels
    on the card give the plain versions' outputs on the CPU."""
    from ganon_tpu_torch.index.builder import _HashExtractor
    from ganon_tpu_torch.index.pruned import build_pruned
    from ganon_tpu_torch.io.pipeline import EncodedBatch

    rng = np.random.default_rng(7)
    genomes = rng.integers(0, 4, size=(150, 2000), dtype=np.uint8)
    ex = _HashExtractor(19, 31, device="cpu")
    for t, g in enumerate(genomes):
        ex.add_encoded(f"T{t}", g)
    pf = build_pruned(ex.finish(), kmer_size=19, window_size=31, group_size=16)
    fc = dev.DevicePrunedForest(pf, "cpu")
    fg = fc.to(cuda)
    B, L = 128, 150
    tgt = rng.integers(0, len(genomes), size=B)
    pos = rng.integers(0, 2000 - L, size=(2, B))
    idx = np.arange(L)
    r1 = genomes[tgt[:, None], pos[0][:, None] + idx]
    r2 = 3 - genomes[tgt[:, None], pos[1][:, None] + idx][:, ::-1]
    r2[::4] = rng.integers(0, 4, size=r2[::4].shape)  # mates of other origin
    lens = np.full(B, L, np.int32)
    batch = EncodedBatch(prefix="", paired=True, ids=[str(i) for i in range(B)],
                         codes1=r1.astype(np.uint8), len1=lens,
                         codes2=np.ascontiguousarray(r2, dtype=np.uint8),
                         len2=lens)
    inbuf, L1, L2 = dev.pack_batch_direct(batch, B)
    for S in (1, 2, 3):
        outs = [dev.classify_batch_packed_pruned(
            f, torch.from_numpy(inbuf).to(f.device), 0.1, 0.5, 65535, k=19,
            w=31, L1=L1, L2=L2, max_groups=S, top_k=8) for f in (fc, fg)]
        assert torch.equal(outs[0], outs[1].cpu())
    hc, nc, _ = dev._extract_compact(torch.from_numpy(inbuf), k=19, w=31,
                                     L1=L1, L2=L2)
    hg, ng = hc.to(cuda), nc.to(cuda)
    assert torch.equal(fc.counts_gated(hc, nc, 0.2),
                       fg.counts_gated(hg, ng, 0.2).cpu())
    assert torch.equal(fc.counts(hc, nc), fg.counts(hg, ng).cpu())


def _sub_table(rng, R, widths):
    """A random u8 table and the byte ranges of targets of the given
    byte widths (W8 padded to whole u32 words)."""
    ends = np.cumsum(widths).astype(np.int32)
    starts = np.concatenate([[0], ends[:-1]]).astype(np.int32)
    W8 = -(-int(ends[-1]) // 4) * 4
    tbl8 = rng.integers(0, 256, size=(R, W8), dtype=np.uint8)
    return [torch.from_numpy(x) for x in (tbl8, starts, ends)]


def test_count_kernel_column_max_mode_matches_plain(cuda):
    """Raptor subs max-merged into one matrix: a target spanning three 8 KB
    tiles, h = 1 and h = 5 in one layout, a one-target sub, a user bin in
    two subs with equal counts (the same sub twice) and with unequal
    counts, and a column no sub writes (it stays 0)."""
    rng = np.random.default_rng(12)
    T = 40
    subs = []  # (tbl8, starts, ends, bin_size, h, cols)
    widths = np.array([3, 20000, 5, 1, 9000, 8, 8, 700])
    subs.append((*_sub_table(rng, 512, widths), 512, 1,
                 np.array([0, 5, 6, 7, 9, 10, 11, 12])))
    subs.append(subs[0])  # equal counts in every shared column
    subs.append((*_sub_table(rng, 300, np.array([40])), 300, 5,
                 np.array([5])))  # T_sub = 1, h = 5, shares column 5
    widths = rng.integers(1, 30, size=20)
    subs.append((*_sub_table(rng, 2000, widths), 1999, 2,
                 np.sort(rng.choice(np.arange(1, T - 1), 20, replace=False))))
    B, M = 64, 300
    h = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, size=(B, M))).to(cuda)
    n = torch.from_numpy(rng.integers(0, M + 50, size=B).astype(np.int32))
    n[:3] = torch.tensor([0, 1, M])
    n = n.to(cuda)
    got = torch.zeros((B, T), dtype=torch.int32, device=cuda)
    want = torch.zeros_like(got)
    before = kernels.LAUNCHES["count_raptor"]
    for tbl8, starts, ends, bin_size, hf, cols in subs:
        args = [x.to(cuda) for x in (tbl8, starts, ends)] + [h, n]
        c = torch.from_numpy(cols.astype(np.int32)).to(cuda)
        q.bulk_target_counts_packed(*args, bin_size=bin_size,
                                    hash_functions=hf, out=got, cols=c)
        q.bulk_target_counts_packed_plain(*args, bin_size=bin_size,
                                          hash_functions=hf, out=want, cols=c)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert kernels.LAUNCHES["count_raptor"] == before + len(subs)
    untouched = sorted(set(range(T)) - {int(c) for *_, cs in subs
                                        for c in cs})
    assert untouched and (got[:, untouched] == 0).all()
    assert (got[:, 5] > 0).any()  # the 20000-byte target's column counts


def test_count_kernel_flat_target_spanning_tiles(cuda):
    """Flat mode with one target over three tiles and zero-width targets
    at tile edges: the carried partial sums give the plain version's."""
    rng = np.random.default_rng(21)
    widths = np.array([8192 - 4, 0, 4, 0, 17000, 0, 3, 8])
    tbl8, starts, ends = _sub_table(rng, 700, widths)
    B, M = 40, 200
    h = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, size=(B, M)))
    n = torch.from_numpy(rng.integers(0, M + 5, size=B).astype(np.int32))
    args = [x.to(cuda) for x in (tbl8, starts, ends, h, n)]
    for hf in (1, 3):
        got = q.bulk_target_counts_packed(*args, bin_size=700,
                                          hash_functions=hf)
        want = q.bulk_target_counts_packed_plain(*args, bin_size=700,
                                                 hash_functions=hf)
        assert torch.equal(got, want)


def test_raptor_batch_cuda_matches_cpu(cuda, tmp_path):
    """classify_batch_packed on a raptor filter and DeviceRaptorHIBF.counts:
    the kernels on the card give the plain versions' outputs on the CPU, on
    a layout with user bins in two IBFs and a split user bin."""
    from ganon_tpu_torch.index.builder import _HashExtractor
    from ganon_tpu_torch.index.hibf import RaptorHIBF
    from ganon_tpu_torch.io.pipeline import EncodedBatch
    from raptor_layout import write_raptor_layout

    rng = np.random.default_rng(8)
    lengths = [1500, 1700, 2500, 3000, 20000]
    genomes = [rng.integers(0, 4, size=n, dtype=np.uint8) for n in lengths]
    ex = _HashExtractor(19, 31, device="cpu")
    for t, g in enumerate(genomes):
        ex.add_encoded(f"T{t}", g)
    path = str(tmp_path / "r.hibf")
    write_raptor_layout(ex.finish(), [(("T4", "T0", "T1"), [1]),
                                      (("T0", "T2", "T3"), [])],
                        path, kmer_size=19, window_size=31,
                        hash_functions=[0, 5], device="cpu")
    fc = dev.DeviceRaptorHIBF(RaptorHIBF.load(path), "cpu")
    fg = fc.to(cuda)
    B, L = 128, 150
    tgt = rng.integers(0, len(genomes), size=B)
    r1 = np.stack([genomes[t][p:p + L] for t, p in
                   zip(tgt, rng.integers(0, 1500 - L, size=B))])
    r2 = 3 - r1[:, ::-1]
    lens = np.full(B, L, np.int32)
    batch = EncodedBatch(prefix="", paired=True, ids=[str(i) for i in range(B)],
                         codes1=r1.astype(np.uint8), len1=lens,
                         codes2=np.ascontiguousarray(r2, dtype=np.uint8),
                         len2=lens)
    inbuf, L1, L2 = dev.pack_batch_direct(batch, B)
    outs = [dev.classify_batch_packed(
        f, torch.from_numpy(inbuf).to(f.device), 0.25, 0.5, 65535, k=19,
        w=31, L1=L1, L2=L2, top_k=8) for f in (fc, fg)]
    assert torch.equal(outs[0], outs[1].cpu())
    hc, nc, _ = dev._extract_compact(torch.from_numpy(inbuf), k=19, w=31,
                                     L1=L1, L2=L2)
    assert torch.equal(fc.counts(hc, nc), fg.counts(hc.to(cuda),
                                                    nc.to(cuda)).cpu())


def test_build_pruned_default_builds_on_the_card(cuda):
    """build_pruned() with no device sets the tables with the scatter
    kernel in pruned mode, byte-equal to the host path (device=False)."""
    from ganon_tpu_torch.index.pruned import build_pruned

    rng = np.random.default_rng(4)
    th = {f"T{t}": np.unique(rng.integers(0, 2**63, size=300 + 7 * t,
                                          dtype=np.uint64))
          for t in range(40)}
    before = kernels.LAUNCHES["scatter_pruned"]
    pf = build_pruned(th, kmer_size=19, window_size=31, group_size=16)
    assert kernels.LAUNCHES["scatter_pruned"] > before
    host = build_pruned(th, kmer_size=19, window_size=31, group_size=16,
                        device=False)
    assert np.array_equal(pf.fine, host.fine)
    assert np.array_equal(pf.coarse, host.coarse)


# --- the two-pass build: pack, sort, dedup, scatter in ranked mode -----------


def _entries(rng, N, R, equal=False, high=False, bits=64):
    key = rng.integers(0, R, size=N).astype(np.int32)
    val = rng.integers(0, 1 << 64, size=N, dtype=np.uint64)
    if bits < 64:
        val &= np.uint64((1 << bits) - 1)
    if equal:
        val[:] = val[0]
    if high:
        val |= np.uint64(1 << 63)
    val[rng.integers(0, max(N, 1), size=N // 4)] = val[: N // 4]  # dups
    return torch.from_numpy(key), torch.from_numpy(val.view(np.int64))


def _to(dev_, *ts):
    return [t.to(dev_) for t in ts]


@pytest.mark.parametrize("N,R,equal,high", [
    (0, 1, False, False), (1, 1, False, False), (4096, 3, False, False),
    (300_000, 97, False, False), (50_000, 5, True, False),
    (70_000, 11, False, True), (40_000, 1, False, False),
    (200_000, 1 << 16, False, False), (4097, 7, False, False),
    (2_000_000, 133, False, False), (12_300_000, 133, False, False),
    (50_001, 1, True, False),
])
def test_sort_kernel_matches_plain(cuda, N, R, equal, high):
    rng = np.random.default_rng(N + R)
    key, val = _entries(rng, N, R, equal=equal, high=high)
    kb = max(R - 1, 0).bit_length()
    want_k, want_v = bo.sort_entries(key, val, key_bits=kb)
    dk, dv = _to(cuda, key, val)
    got_k, got_v = bo.sort_entries(dk, dv, key_bits=kb)
    torch.cuda.synchronize()
    assert torch.equal(got_k.cpu(), want_k)
    assert torch.equal(got_v.cpu(), want_v)
    assert torch.equal(dk.cpu(), key) and torch.equal(dv.cpu(), val)


@pytest.mark.parametrize("N,R,bits,high,passes", [
    (300_000, 133, 38, False, 6), (50_000, 1, 64, False, 8),
    (50_000, 1, 0, False, 0), (4097, 300, 38, False, 7),
    (100_000, 40, 38, True, 6), (70_000, 3, 64, False, 9),
])
def test_sort_kernel_skips_constant_digits(cuda, N, R, bits, high, passes):
    """The sort's digit histograms on the card equal the plain ones, the
    plan skips the constant digits (38-bit values: value digits 5-7; one
    file: the key digit; every digit constant: a copy), and the result
    equals the plain sort's, the inputs untouched."""
    rng = np.random.default_rng(N + bits)
    key, val = _entries(rng, N, R, equal=bits == 0, high=high,
                        bits=max(bits, 1))
    kb = max(R - 1, 0).bit_length()
    dk, dv = _to(cuda, key, val)
    hist = bo.sort_digit_histograms(dk, dv, key_bits=kb)
    want_h = bo.sort_digit_histograms_plain(key, val, key_bits=kb)
    assert torch.equal(hist.cpu(), want_h)
    assert len(bo.sort_pass_plan(want_h[0], key_bits=kb)) == passes
    want_k, want_v = bo.sort_entries(key, val, key_bits=kb)
    before = dict(kernels.LAUNCHES)
    got_k, got_v = bo.sort_entries(dk, dv, key_bits=kb)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sort"] == before["sort"] + 1
    assert kernels.LAUNCHES["sort_hist"] == before["sort_hist"] + 1
    assert torch.equal(got_k.cpu(), want_k)
    assert torch.equal(got_v.cpu(), want_v)
    assert torch.equal(dk.cpu(), key) and torch.equal(dv.cpu(), val)


@pytest.mark.parametrize("B,mc", [(1, 8), (700, 130), (20_000, 33)])
def test_pack_kernel_matches_plain(cuda, B, mc):
    rng = np.random.default_rng(B)
    hashes = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62,
                                           size=(B, mc)))
    nrows = torch.from_numpy(rng.integers(0, mc + 1, size=B).astype(np.int32))
    nrows[: B // 3] = 0
    keys = torch.from_numpy(rng.integers(0, 50, size=B).astype(np.int32))
    total = int(nrows.sum())
    outs = {}
    for d in ("cpu", cuda):
        ok, ov = bo.pack_entries(hashes.to(d), nrows.to(d), keys.to(d), total)
        outs[str(d)] = (ok.cpu(), ov.cpu())
    torch.cuda.synchronize()
    a, b = outs["cpu"], outs[str(cuda)]
    assert a[0].numel() == total
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("B,mc", [(1, 2048), (33, 64), (16_389, 130)])
def test_pack_kernel_edges(cuda, B, mc):
    """pack at B = 1 and B not a multiple of its 32-row tile, rows with
    n = 0 and n = mc (and n past mc, read as mc), twice in a row on one
    stream (the tile counter and the status words left by the first call
    serve the second); one launch a call."""
    rng = np.random.default_rng(B + mc)
    hashes = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1,
                                           size=(B, mc)))
    nrows = torch.from_numpy(rng.integers(0, mc + 1, size=B).astype(np.int32))
    nrows[::3] = mc
    nrows[1::5] = 0
    keys = torch.from_numpy(rng.integers(0, 1 << 16, size=B).astype(np.int32))
    total = int(nrows.sum())
    want = bo.pack_entries(hashes, nrows, keys, total)
    args = _to(cuda, hashes, nrows, keys)
    before = kernels.LAUNCHES["pack"]
    got = [bo.pack_entries(*args, total) for _ in range(2)]
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pack"] == before + 2
    for g in got:
        assert all(torch.equal(a.cpu(), b) for a, b in zip(g, want))
    over = nrows.clone()
    over[0] = mc + 7  # read as mc, as the plain version's mask does
    got = bo.pack_entries(hashes.to(cuda), over.to(cuda), keys.to(cuda),
                          total - int(nrows[0]) + mc)
    want = bo.pack_entries_plain(hashes, over, keys,
                                 total - int(nrows[0]) + mc)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


def _dedup_case(rng, case):
    """Sorted entries of a dedup edge case and its num_files (keys at or
    past it are never first occurrences)."""
    if case == "empty":
        return bo.sort_entries(*_entries(rng, 0, 4), key_bits=3) + (4,)
    if case == "one":
        return bo.sort_entries(*_entries(rng, 1, 1), key_bits=1) + (1,)
    if case == "tile_edge":
        # runs of equal entries across every 4096-entry tile edge and
        # 512-entry warp edge
        key, val = _entries(rng, 3 * 4096 + 17, 3)
        sk, sv = bo.sort_entries(key, val, key_bits=2)
        for edge in range(512, sk.numel(), 512):
            sk[edge - 3:edge + 3] = sk[edge - 3]
            sv[edge - 3:edge + 3] = sv[edge - 3]
        return sk, sv, 3
    if case == "long_file":
        # one file over ~70 tiles, then a tile of 200 files of one entry
        key = np.concatenate([np.zeros(290_001, np.int32),
                              np.arange(1, 201, dtype=np.int32)])
        val = rng.integers(0, 1 << 20, size=key.size).astype(np.int64)
        return bo.sort_entries(torch.from_numpy(key), torch.from_numpy(val),
                               key_bits=8) + (201,)
    if case == "keys_past_R":
        key, val = _entries(rng, 100_003, 40)
        return bo.sort_entries(key, val, key_bits=6) + (25,)
    N, R = case
    key, val = _entries(rng, N, R // 2)  # half the files have nothing
    return bo.sort_entries(key, val, key_bits=R.bit_length()) + (R,)


@pytest.mark.parametrize("case", [
    (10_000, 40), (123_457, 1000), "empty", "one", "tile_edge", "long_file",
    "keys_past_R"])
def test_dedup_kernel_matches_plain(cuda, case):
    """Both modes against the plain version: the rank mode's flags, ranks
    and counts in one launch, and the counts mode (the build's pass 1),
    which returns no [N] array. Files with no entries keep count 0."""
    rng = np.random.default_rng(7)
    sk, sv, R = _dedup_case(rng, case)
    want_c = torch.zeros(R, dtype=torch.int32)
    want = bo.dedup(sk, sv, num_files=R, counts=want_c)
    dk, dv = _to(cuda, sk, sv)
    got_c = torch.full((R,), 5, dtype=torch.int32, device=cuda)
    before = dict(kernels.LAUNCHES)
    got = bo.dedup(dk, dv, num_files=R, counts=got_c)
    cnt_c = torch.full((R,), 5, dtype=torch.int32, device=cuda)
    no_rank = bo.dedup(dk, dv, num_files=R, counts=cnt_c, want_rank=False)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got_c.cpu() - 5, want_c)
    assert no_rank == (None, None)
    assert torch.equal(cnt_c.cpu() - 5, want_c)
    launched = sk.numel() > 0
    assert kernels.LAUNCHES["dedup_rank"] == before["dedup_rank"] + launched
    assert kernels.LAUNCHES["dedup"] == before["dedup"] + launched
    if isinstance(case, tuple):
        assert (want_c[R // 2:] == 0).all()
    if case == "keys_past_R":
        assert not want[0][sk >= R].any() and want[0].any()


def _ranked_params(counts, mhb):
    """params of targets of two files each, split over bins of mhb hashes."""
    c = counts.numpy()
    R = c.size
    params = np.zeros((4, R), dtype=np.int32)
    binno = 0
    for f in range(0, R, 2):
        tot = int(c[f] + c[f + 1])
        nb = -(-tot // mhb) if tot else 0
        nhb = min(-(-tot // nb), mhb) if nb else 1
        params[:3, f], params[:3, f + 1] = (binno, nhb, 0), (binno, nhb, c[f])
        binno += nb
    params[3] = np.concatenate([[0], np.cumsum(c)[:-1]])
    return torch.from_numpy(params), binno


@pytest.mark.parametrize("hf,mhb", [(1, 50), (2, 1), (3, 100_000), (4, 7),
                                    (5, 400)])
def test_scatter_ranked_kernel_matches_plain(cuda, hf, mhb):
    """The fused pass 2 (flags, ranks, bins and bits in one call) against
    dedup_plain then scatter_ranked_plain: targets of two files each,
    split over bins of mhb hashes, into a matrix that already holds bits
    (an overwrite would show); tiles over every word column and over the
    bins' columns only (ranked_word_cols)."""
    rng = np.random.default_rng(hf)
    R, N, bin_size = 64, 60_001, 20_011
    key, val = _entries(rng, N, R)
    sk, sv = bo.sort_entries(key, val, key_bits=6)
    counts = torch.zeros(R, dtype=torch.int32)
    uniq, rank = bo.dedup(sk, sv, num_files=R, counts=counts)
    params, binno = _ranked_params(counts, mhb)
    n_words = -(-binno // 32)
    old = torch.from_numpy(rng.integers(-2**31, 2**31, size=(
        bin_size, n_words)).astype(np.int32)
        & (rng.random((bin_size, n_words)) < 0.05))
    want = old.clone()
    bo.scatter_ranked_plain(want, sk, sv, uniq, rank, params,
                            bin_size=bin_size, hash_functions=hf)
    fused = old.clone()
    bo.scatter_ranked(fused, sk, sv, None, None, params, bin_size=bin_size,
                      hash_functions=hf)
    before = dict(kernels.LAUNCHES)
    for cols in (None, bo.ranked_word_cols(params.numpy(), counts.numpy())):
        got = old.to(cuda)
        bo.scatter_ranked(got, *_to(cuda, sk, sv), None, None,
                          params.to(cuda), bin_size=bin_size,
                          hash_functions=hf, word_cols=cols)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), cols
    assert binno > R // 2 or mhb > N  # some target over several bins
    assert torch.equal(fused, want)
    assert kernels.LAUNCHES["scatter_ranked"] == before["scatter_ranked"] + 2
    with pytest.raises(ValueError, match="itself"):
        bo.scatter_ranked(got, *_to(cuda, sk, sv, uniq, rank, params),
                          bin_size=bin_size, hash_functions=hf)


@pytest.mark.parametrize("hf,tiles", [(1, False), (3, False), (2, True)])
def test_scatter_past_the_item_budget_matches_plain(cuda, hf, tiles,
                                                    monkeypatch):
    """Calls cut at a small item budget: the ranked scatter carries the
    rank from call to call (and the flag compare across the cut), the
    span mode and the flat scatter cut their inputs too; N not a
    multiple of the tile. With small tiles (64 words, 16 a call) the rows
    are cut into windows too, and a band wider than a tile spans
    several column blocks."""
    monkeypatch.setattr(bo, "ITEM_BUDGET", 3 * 4096)
    if tiles:
        monkeypatch.setattr(bo, "TILE_WORDS", 64)
        monkeypatch.setattr(bo, "MAX_TILES", 16)
    rng = np.random.default_rng(40 + hf)
    R, N, bin_size = 16, 50_003, 9001
    key, val = _entries(rng, N, R, bits=20)
    sk, sv = bo.sort_entries(key, val, key_bits=4)
    counts = torch.zeros(R, dtype=torch.int32)
    bo.dedup(sk, sv, num_files=R, counts=counts)
    params, binno = _ranked_params(counts, 900)
    n_words = -(-binno // 32)
    want = torch.zeros((bin_size, n_words), dtype=torch.int32)
    bo.scatter_ranked_plain(want, sk, sv, None, None, params,
                            bin_size=bin_size, hash_functions=hf)
    d_args = (*_to(cuda, sk, sv), None, None, params.to(cuda))
    before = dict(kernels.LAUNCHES)
    got = torch.zeros_like(want, device=cuda)
    bo.scatter_ranked(got, *d_args, bin_size=bin_size, hash_functions=hf)
    calls = -(-N // bo.scatter_chunk(hf)) * len(
        bo.scatter_windows(bin_size, n_words)[4])
    assert calls > 2
    assert kernels.LAUNCHES["scatter_ranked"] == before["scatter_ranked"] + calls
    span = torch.zeros((3000, n_words), dtype=torch.int32, device=cuda)
    bo.scatter_ranked(span, *d_args, bin_size=bin_size, hash_functions=hf,
                      w0=4000 * n_words)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(span.cpu(), want[4000:7000])
    h = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, size=N))
    bins = torch.from_numpy(rng.integers(40, 32 * 70, size=N).astype(
        np.int32))
    a = torch.zeros((bin_size, 72), dtype=torch.int32)
    _scatter_bits(a, h, bins, bin_size=bin_size, hash_functions=hf)
    for cols in (None, (1, 70)):
        b = torch.zeros((bin_size, 72), dtype=torch.int32, device=cuda)
        scatter_hashes(b, h.to(cuda), bins.to(cuda), bin_size=bin_size,
                       hash_functions=hf, word_cols=cols)
        torch.cuda.synchronize()
        assert torch.equal(b.cpu(), a), cols


@pytest.mark.parametrize("mode", ["flat", "ranked", "span"])
def test_scatter_bits_do_not_depend_on_word_cols(cuda, mode, monkeypatch):
    """word_cols bounds the card's tiles and is only a hint: a bit whose
    column lies outside the band is set with an atomicOr, so every band
    gives the plain version's bits (into a matrix that already holds
    bits): the bins' own band, bands that leave bins out on either side,
    one that holds none, and all columns; also with small tiles, whose
    rows are cut into windows."""
    rng = np.random.default_rng(46)
    R, N, bin_size, hf = 16, 30_001, 4001, 3
    sk, sv = bo.sort_entries(*_entries(rng, N, R, bits=20), key_bits=4)
    counts = torch.zeros(R, dtype=torch.int32)
    uniq, rank = bo.dedup(sk, sv, num_files=R, counts=counts)
    params, binno = _ranked_params(counts, 300)
    n_words = -(-binno // 32) + 2
    c0, c1 = bo.ranked_word_cols(params.numpy(), counts.numpy())
    assert c1 - c0 >= 2
    u, bins = bo._ranked_bins(sk, uniq, rank, params)
    rows = 2000 if mode == "span" else bin_size
    old = torch.from_numpy(rng.integers(-2**31, 2**31, size=(
        rows, n_words)).astype(np.int32) & (rng.random((rows, n_words))
                                            < 0.05))

    def run(bits, cols):
        if mode == "flat":
            scatter_hashes(bits, *_to(bits.device, sv[u].contiguous(),
                                      bins.to(torch.int32)),
                           bin_size=bin_size, hash_functions=hf,
                           word_cols=cols)
        else:
            bo.scatter_ranked(bits, *_to(bits.device, sk, sv), None, None,
                              params.to(bits.device), bin_size=bin_size,
                              hash_functions=hf, word_cols=cols,
                              w0=1000 * n_words if mode == "span" else None)
        return bits

    want = run(old.clone(), None)
    assert not torch.equal(want, old)
    for small in (False, True):
        if small:
            monkeypatch.setattr(bo, "TILE_WORDS", 64)
            monkeypatch.setattr(bo, "MAX_TILES", 16)
        for cols in ((c0, c1), (c0 + 1, c1), (c0, c1 - 1), (c1, n_words),
                     None):
            got = run(old.to(cuda), cols)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (small, cols)


class _EndOfMapping:
    """Card memory whose end is followed by reserved, unmapped addresses
    (CUDA's virtual memory management: cuMemAddressReserve, cuMemCreate,
    cuMemMap): a kernel that reads one byte past a tensor placed at the
    end faults instead of reading a neighbour."""

    def __init__(self, n_maps):
        class Loc(ctypes.Structure):
            _fields_ = [("type", ctypes.c_int), ("id", ctypes.c_int)]

        class Flags(ctypes.Structure):
            _fields_ = [("compressionType", ctypes.c_ubyte),
                        ("gpuDirectRDMACapable", ctypes.c_ubyte),
                        ("usage", ctypes.c_ushort),
                        ("reserved", ctypes.c_ubyte * 4)]

        class Prop(ctypes.Structure):
            _fields_ = [("type", ctypes.c_int),
                        ("requestedHandleTypes", ctypes.c_int),
                        ("location", Loc), ("win32HandleMetaData",
                                            ctypes.c_void_p),
                        ("allocFlags", Flags)]

        class Access(ctypes.Structure):
            _fields_ = [("location", Loc), ("flags", ctypes.c_int)]

        torch.zeros(1, device="cuda")  # the primary context, current
        self.cu = cu = ctypes.CDLL("libcuda.so.1")
        u64 = ctypes.c_uint64

        def ok(r, what):
            if r:
                raise RuntimeError(f"{what}: CUresult {r}")

        dev_id = torch.cuda.current_device()
        prop = Prop(type=1, location=Loc(type=1, id=dev_id))  # pinned, device
        g = ctypes.c_size_t()
        ok(cu.cuMemGetAllocationGranularity(ctypes.byref(g),
                                            ctypes.byref(prop), 0),
           "cuMemGetAllocationGranularity")
        self.G = G = g.value
        self.maps = []
        for _ in range(n_maps):
            base, handle = u64(), u64()
            # two granules reserved, the first mapped
            ok(cu.cuMemAddressReserve(ctypes.byref(base), ctypes.c_size_t(
                2 * G), ctypes.c_size_t(G), u64(0), u64(0)),
               "cuMemAddressReserve")
            ok(cu.cuMemCreate(ctypes.byref(handle), ctypes.c_size_t(G),
                              ctypes.byref(prop), u64(0)), "cuMemCreate")
            ok(cu.cuMemMap(base, ctypes.c_size_t(G), ctypes.c_size_t(0),
                           handle, u64(0)), "cuMemMap")
            acc = Access(location=Loc(type=1, id=dev_id), flags=3)
            ok(cu.cuMemSetAccess(base, ctypes.c_size_t(G), ctypes.byref(acc),
                                 ctypes.c_size_t(1)), "cuMemSetAccess")
            self.maps.append((base, handle))

    def at_end(self, i, src):
        """A card tensor equal to the 1-D ``src`` whose last byte is the
        last mapped byte of mapping ``i``."""
        typestr = {torch.int32: "<i4", torch.int64: "<i8"}[src.dtype]
        nbytes = src.numel() * src.element_size()
        assert nbytes <= self.G

        class Cai:
            __cuda_array_interface__ = {
                "shape": (src.numel(),), "typestr": typestr,
                "data": (self.maps[i][0].value + self.G - nbytes, False),
                "strides": None, "version": 3}

        t = torch.as_tensor(Cai(), device="cuda")
        t.copy_(src)
        return t

    def free(self):
        torch.cuda.synchronize()
        for base, handle in self.maps:
            self.cu.cuMemUnmap(base, ctypes.c_size_t(self.G))
            self.cu.cuMemRelease(handle)
            self.cu.cuMemAddressFree(base, ctypes.c_size_t(2 * self.G))


def end_of_mapping_checks():
    """dedup's two modes and the scatter's flat, ranked (whole, and cut
    at a small item budget) and span modes on entries that end where the
    card's mapped memory ends, each against its plain version. The last
    tile holds one whole warp run and four entries, so six warps' runs
    start past the end."""
    N, R, bin_size, hf = 3 * 4096 + 516, 6, 3001, 2
    rng = np.random.default_rng(47)
    sk, sv = bo.sort_entries(*_entries(rng, N, R, bits=16), key_bits=3)
    # keys of file R - 1 lie past num_files
    want_c = torch.zeros(R - 1, dtype=torch.int32)
    want = bo.dedup(sk, sv, num_files=R - 1, counts=want_c)
    mem = _EndOfMapping(2)
    dk, dv = mem.at_end(0, sk), mem.at_end(1, sv)
    assert dk.data_ptr() % 16 == 0 and dv.data_ptr() % 16 == 0
    got_c = torch.zeros(R - 1, dtype=torch.int32, device="cuda")
    got = bo.dedup(dk, dv, num_files=R - 1, counts=got_c)
    cnt = torch.zeros_like(got_c)
    bo.dedup(dk, dv, num_files=R - 1, counts=cnt, want_rank=False)
    torch.cuda.synchronize()
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    assert torch.equal(got_c.cpu(), want_c)
    assert torch.equal(cnt.cpu(), want_c)
    counts = torch.zeros(R, dtype=torch.int32)
    bo.dedup(sk, sv, num_files=R, counts=counts)
    params, binno = _ranked_params(counts, 500)
    n_words = -(-binno // 32)
    plain = torch.zeros((bin_size, n_words), dtype=torch.int32)
    bo.scatter_ranked_plain(plain, sk, sv, None, None, params,
                            bin_size=bin_size, hash_functions=hf)
    for budget in (bo.ITEM_BUDGET, 3 * 4096):
        keep, bo.ITEM_BUDGET = bo.ITEM_BUDGET, budget
        try:
            bits = torch.zeros((bin_size, n_words), dtype=torch.int32,
                               device="cuda")
            bo.scatter_ranked(bits, dk, dv, None, None, params.cuda(),
                              bin_size=bin_size, hash_functions=hf)
            span = torch.zeros((1000, n_words), dtype=torch.int32,
                               device="cuda")
            bo.scatter_ranked(span, dk, dv, None, None, params.cuda(),
                              bin_size=bin_size, hash_functions=hf,
                              w0=1500 * n_words)
            torch.cuda.synchronize()
        finally:
            bo.ITEM_BUDGET = keep
        assert torch.equal(bits.cpu(), plain), budget
        assert torch.equal(span.cpu(), plain[1500:2500]), budget
    pb = torch.from_numpy(rng.integers(0, 32 * n_words, size=N).astype(
        np.int32))
    flat = torch.zeros((bin_size, n_words), dtype=torch.int32)
    _scatter_bits(flat, sv, pb, bin_size=bin_size, hash_functions=hf)
    del dk, dv
    mem2 = _EndOfMapping(2)
    hb, hh = mem2.at_end(0, pb), mem2.at_end(1, sv)
    bits = torch.zeros((bin_size, n_words), dtype=torch.int32, device="cuda")
    scatter_hashes(bits, hh, hb, bin_size=bin_size, hash_functions=hf)
    torch.cuda.synchronize()
    assert torch.equal(bits.cpu(), flat)
    del hb, hh
    mem.free()
    mem2.free()
    print("end-of-mapping checks passed")


def test_entries_at_the_end_of_mapped_memory(cuda):
    """No kernel of the build's write path reads past its entries: they
    end where mapped card memory ends (a read past them faults), in a
    child process so a fault cannot spoil this one's context."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import runpy, sys; sys.path.insert(0, {r!r}); runpy.run_path("
            "{f!r})['end_of_mapping_checks']()").format(
                r=root, f=os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert "end-of-mapping checks passed" in out.stdout


@pytest.mark.parametrize("cache", [None, 0])
def test_device_build_pipeline_cuda_matches_cpu(cuda, cache, monkeypatch):
    """The pipeline on the card equals its plain run: several groups, a
    file in two targets' worth of pieces, every entry re-extracted at a
    cache budget of 0."""
    from ganon_tpu_torch.index import device_build as tdb
    from ganon_tpu_torch.index import sizing

    monkeypatch.setattr(tdb, "GROUP_BASES", 50_000)
    rng = np.random.default_rng(5)
    files = [(f"T{t % 7}", t // 7, rng.integers(0, 4, size=n, dtype=np.uint8))
             for t, n in enumerate(rng.integers(10, 40_000, size=30))]
    files.sort(key=lambda x: (int(x[0][1:]), x[1]))
    out = {}
    for d in ("cpu", "cuda"):
        kernels.reset_launches()
        pipe = tdb.DeviceBuildPipeline(19, 31, device=d,
                                       device_cache_bytes=cache)
        try:
            for t, fi, g in files:
                pipe.add_sequence((t, fi), g)
            pipe.finish_counts()
            hc = {t: c for t, c in pipe.hashes_count().items() if c}
            icfg = sizing.size_filter(hc, kmer_size=19, window_size=31,
                                      max_fp=0.05)
            out[d] = (hc, pipe.scatter(icfg, sizing.split_target_bins(
                icfg, hc)), len(pipe.groups))
        finally:
            pipe.close()
        if d == "cuda":
            assert all(kernels.LAUNCHES[x] > 0 for x in (
                "extract_build", "pack", "sort", "dedup", "scatter_ranked"))
    assert out["cpu"][2] > 2
    assert out["cpu"][0] == out["cuda"][0]
    assert np.array_equal(out["cpu"][1], out["cuda"][1])


def test_run_build_cuda_matches_cpu(cuda, tmp_path):
    """run_build's reference-format file on the card equals the CPU's."""
    from ganon_tpu_torch.index.builder import BuildConfig, run_build

    rng = np.random.default_rng(9)
    rows = []
    for t in range(12):
        for fi in range(2):
            p = tmp_path / f"t{t}_{fi}.fna"
            n = 200_000 if t == 0 else 20_000
            p.write_text(">s\n" + "".join(
                "ACGT"[b] for b in rng.integers(0, 4, size=n)) + "\n")
            rows.append(f"{p}\tT{t}\n")
    ti = tmp_path / "ti.tsv"
    ti.write_text("".join(rows))
    data = {}
    for d in ("cpu", "cuda"):
        out = tmp_path / f"{d}.ibf"
        ibf = run_build(BuildConfig(input_file=str(ti), output_file=str(out),
                                    filter_format="reference", device=d))
        data[d] = out.read_bytes()
    assert len(ibf.bin_map) > len(ibf.hashes_count)  # T0 over several bins
    assert data["cpu"] == data["cuda"]


# --- the device mesh's modes (K17): count_shard, combine, fine_shard,
# scatter_span ----------------------------------------------------------------


def _shard_counts(sh_list, h, n, R, hf, T, fn_count, fn_combine):
    """Every shard's unclamped partials into one buffer, then combine."""
    B = h.shape[0]
    widths = [s.t_hi - s.t_lo for s in sh_list]
    # poisoned, not zeroed: count in shard mode and combine in flat mode
    # store every cell, so the caller fills neither buffer
    parts = torch.full((B * sum(widths),), -1, dtype=torch.int32,
                       device=h.device)
    off = 0
    for s, w in zip(sh_list, widths):
        if w:
            fn_count(s.tbl8, s.byte_starts, s.byte_ends, h, n, bin_size=R,
                     hash_functions=hf, out=parts[off:off + B * w].view(B, w),
                     clamp=False)
        off += B * w
    lo, hi = (torch.tensor([getattr(s, a) for s in sh_list], dtype=torch.int32)
              for a in ("t_lo", "t_hi"))
    out = torch.full((B, T), -1, dtype=torch.int32, device=h.device)
    return fn_combine(parts, lo, hi, n, out, num_targets=T)


@pytest.mark.parametrize("nb", [1, 3, 4])
def test_count_shard_and_combine_match_plain(cuda, nb):
    """A target spanning three shards (a wide middle target) and nb = 1,
    which equals the flat count; kernels against plain versions."""
    rng = np.random.default_rng(nb)
    R, hf = 1024, 2
    widths = np.array([3, 5, 250, 2, 7, 1, 9], dtype=np.int64)  # bins
    pad = (widths + 7) // 8 * 8
    ends = (np.cumsum(pad) // 8).astype(np.int32)
    starts = np.concatenate([[0], ends[:-1]]).astype(np.int32)
    W8 = -(-int(ends[-1]) // 4) * 4
    tbl8 = torch.from_numpy(rng.integers(0, 256, size=(R, W8), dtype=np.uint8))
    T = len(widths)
    B, M = 100, 180
    h = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, size=(B, M)))
    n = torch.from_numpy(rng.integers(0, M + 20, size=B).astype(np.int32))
    n[:2] = 0
    shards = q.shard_table(tbl8, torch.from_numpy(starts),
                           torch.from_numpy(ends), nb)
    if nb == 3:
        assert sum(s.t_lo <= 2 < s.t_hi for s in shards) == 3
    want = _shard_counts(shards, h, n, R, hf, T, q.bulk_target_counts_packed,
                         q.combine)
    flat = q.bulk_target_counts_packed_plain(
        tbl8, torch.from_numpy(starts), torch.from_numpy(ends), h, n,
        bin_size=R, hash_functions=hf)
    assert torch.equal(want, flat)  # the clamp after the sum
    dshards = [s.to(cuda) for s in shards]
    dh, dn = _to(cuda, h, n)
    before = dict(kernels.LAUNCHES)
    got = _shard_counts(dshards, dh, dn, R, hf, T,
                        q.bulk_target_counts_packed, q.combine)
    plain = _shard_counts(dshards, dh, dn, R, hf, T,
                          q.bulk_target_counts_packed_plain, q.combine_plain)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want) and torch.equal(plain.cpu(), want)
    assert kernels.LAUNCHES["count_shard"] - before["count_shard"] == sum(
        s.t_hi > s.t_lo for s in shards)
    assert kernels.LAUNCHES["combine"] == before["combine"] + 1


def test_combine_column_max_mode_matches_plain(cuda):
    rng = np.random.default_rng(3)
    B, T, nb = 64, 40, 3
    spans = [(0, 15), (14, 30), (29, 40)]
    lo = torch.tensor([a for a, _ in spans], dtype=torch.int32)
    hi = torch.tensor([b for _, b in spans], dtype=torch.int32)
    parts = torch.from_numpy(rng.integers(0, 50, size=B * sum(
        b - a for a, b in spans)).astype(np.int32))
    n = torch.from_numpy(rng.integers(0, 80, size=B).astype(np.int32))
    cols = torch.from_numpy(rng.permutation(60)[:T].astype(np.int32))
    base = torch.from_numpy(rng.integers(0, 60, size=(B, 60)).astype(np.int32))
    want = q.combine_plain(parts, lo, hi, n, base.clone(), num_targets=T,
                           cols=cols)
    got = q.combine(parts.to(cuda), lo, hi, *_to(cuda, n, base),
                    num_targets=T, cols=cols.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def _combine_spans(rng, nb, T):
    """nb sorted spans over T targets that overlap at boundary targets:
    shard 0 starts at 0, the last ends at T; a middle shard may be empty
    or one target wide (so a target can sit in three shards or more),
    and may leave a gap (a target no shard holds)."""
    cuts = np.sort(rng.integers(0, T + 1, size=nb - 1))
    lo = np.concatenate([[0], cuts]).astype(np.int64)
    hi = np.concatenate([cuts, [T]]).astype(np.int64)
    for j in range(nb - 1):
        r = rng.random()
        if r < 0.5:  # the next shard's first target is split
            hi[j] = min(hi[j] + 1, T)
        elif r < 0.6 and lo[j + 1] < hi[j + 1]:  # a gap
            lo[j + 1] += 1
    hi = np.maximum.accumulate(np.maximum(hi, lo))
    return (torch.from_numpy(lo.astype(np.int32)),
            torch.from_numpy(hi.astype(np.int32)))


@pytest.mark.parametrize("case", ["t_odd", "forest", "nb1", "nb_max",
                                  "nb_max_cols", "three_shards"])
def test_combine_kernel_edges(cuda, case):
    """combine against its plain version on poisoned buffers: T not a
    multiple of the kernel's 4 targets a thread (and a row start off
    16 bytes), forest mode at col0 and ldc not multiples of 4 (the
    columns outside untouched), nb = 1, nb at COMBINE_MAX_SHARDS (flat
    and column-max) and a target in three shards; parts offset by one
    element so no block row is 16-byte aligned in one case."""
    rng = np.random.default_rng(len(case))
    nb, T, B, col0, ldc = {
        "t_odd": (4, 1027, 300, 0, 1027),
        "forest": (3, 41, 257, 5, 59),
        "nb1": (1, 13, 100, 0, 13),
        "nb_max": (q.COMBINE_MAX_SHARDS, 301, 129, 0, 301),
        "nb_max_cols": (q.COMBINE_MAX_SHARDS, 150, 64, 0, 211),
        "three_shards": (4, 40, 97, 1, 42),
    }[case]
    if case == "three_shards":
        lo = torch.tensor([0, 10, 10, 11], dtype=torch.int32)
        hi = torch.tensor([11, 11, 12, 40], dtype=torch.int32)
    else:
        lo, hi = _combine_spans(rng, nb, T)
    width = int((hi - lo).sum())
    skew = 1 if case == "t_odd" else 0
    parts = torch.from_numpy(rng.integers(0, 60, size=skew + B * width)
                             .astype(np.int32))
    n = torch.from_numpy(rng.integers(0, 150, size=B).astype(np.int32))
    cols = (torch.from_numpy(rng.permutation(ldc)[:T].astype(np.int32))
            if case == "nb_max_cols" else None)
    base = (torch.from_numpy(rng.integers(0, 60, size=(B, ldc))
                             .astype(np.int32)) if cols is not None
            else torch.full((B, ldc), -1, dtype=torch.int32))
    want = q.combine_plain(parts[skew:], lo, hi, n, base.clone(),
                           num_targets=T, col0=col0, cols=cols)
    dparts = parts.to(cuda)[skew:]
    before = kernels.LAUNCHES["combine"]
    got = q.combine(dparts, lo, hi, *_to(cuda, n, base), num_targets=T,
                    col0=col0, cols=None if cols is None else cols.to(cuda))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["combine"] == before + 1
    assert torch.equal(got.cpu(), want)
    if cols is None:
        assert (want[:, :col0] == -1).all() and (
            want[:, col0 + T:] == -1).all()
        assert (want[:, col0:col0 + T] >= 0).all()
    if case == "three_shards":
        assert int(((lo <= 10) & (10 < hi)).sum()) == 3


def test_combine_kernel_rejects_its_limits(cuda):
    """Past COMBINE_MAX_SHARDS shards or with spans on the card the
    wrapper raises; with spans out of order, past T or past the partials
    the launch raises; it takes no slower route."""
    B, T, nb = 8, 40, q.COMBINE_MAX_SHARDS + 1
    lo = torch.arange(nb, dtype=torch.int32)
    hi = lo + 1
    parts = torch.zeros(B * nb, dtype=torch.int32, device=cuda)
    n = torch.ones(B, dtype=torch.int32, device=cuda)
    out = torch.zeros((B, T), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="at most"):
        q.combine(parts, lo, hi, n, out, num_targets=T)
    before = kernels.LAUNCHES["combine"]
    for a, b in (([2, 0], [4, 4]), ([0, 2], [4, 3]), ([0, 30], [30, 41]),
                 ([0, 0], [40, 40])):  # the last: 2 x 40 x B partials
        with pytest.raises(RuntimeError, match="combine"):
            q.combine(parts, torch.tensor(a, dtype=torch.int32),
                      torch.tensor(b, dtype=torch.int32), n, out,
                      num_targets=T)
    assert kernels.LAUNCHES["combine"] == before
    with pytest.raises(ValueError, match="host"):
        q.combine(parts, lo[:2].to(cuda), hi[:2].to(cuda), n, out,
                  num_targets=T)


@pytest.mark.parametrize("gs", [16, 40])
@pytest.mark.parametrize("pads_only", [False, True])
def test_fine_shard_matches_plain(cuda, pads_only, gs):
    """A shard of real groups and pad groups, and a shard made only of pad
    groups (it writes nothing)."""
    rng = np.random.default_rng(11)
    G, B, M = 10, 120, 200
    (ftbl, h, n, off, bsz, shift), T = _fine_inputs(rng, G, gs, 5, B, M)
    gid = torch.tensor([-1, -1] if pads_only else [1, 4, 9, -1],
                       dtype=torch.int32)
    loc = torch.clamp(gid, min=0).to(torch.int64)
    surv = torch.from_numpy((rng.random((B, G)) < 0.6).astype(np.uint8))
    args = (ftbl, h, n, off[loc], bsz[loc], shift[loc], gid)
    kw = dict(fine_h=2, group_size=gs, num_groups=G, surv=surv)
    sentinel = torch.full((B, T), -7, dtype=torch.int32)
    want = pq.fine_shard_plain(*args, **kw, out=sentinel.clone())
    before = kernels.LAUNCHES["fine_shard"]
    got = pq.fine_shard(*_to(cuda, *args), **{**kw, "surv": surv.to(cuda)},
                        out=sentinel.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert kernels.LAUNCHES["fine_shard"] == before + 1
    if pads_only:
        assert (want == -7).all()
    else:
        assert (want[:, 4 * gs:5 * gs] >= 0).all() and (want > 0).any()


def test_scatter_span_matches_plain(cuda):
    """Spans of the fused ranked scatter: their union is the whole
    matrix, and a span every entry misses stays zero (entries before it
    dropped, not wrapped)."""
    rng = np.random.default_rng(21)
    R, N, bin_size, hf = 8, 20_000, 4001, 3
    key, val = _entries(rng, N, R)
    sk, sv = bo.sort_entries(key, val, key_bits=3)
    counts = torch.zeros(R, dtype=torch.int32)
    uniq, rank = bo.dedup(sk, sv, num_files=R, counts=counts)
    c = counts.numpy()
    params = np.zeros((4, R), dtype=np.int32)
    params[0] = np.arange(R) * 2
    params[1] = np.maximum(-(-c // 2), 1)
    params[3] = np.concatenate([[0], np.cumsum(c)[:-1]])
    params = torch.from_numpy(params)
    n_words = 1
    full = torch.zeros((bin_size, n_words), dtype=torch.int32)
    bo.scatter_ranked(full, sk, sv, uniq, rank, params, bin_size=bin_size,
                      hash_functions=hf)
    d_args = (*_to(cuda, sk, sv), None, None, params.to(cuda))
    rows = 1000
    got = []
    for r0 in range(0, bin_size, rows):
        rc = min(rows, bin_size - r0)
        want = torch.zeros((rc, n_words), dtype=torch.int32)
        bo.scatter_ranked_plain(want, sk, sv, uniq, rank, params,
                                bin_size=bin_size, hash_functions=hf,
                                w0=r0 * n_words)
        g = torch.zeros((rc, n_words), dtype=torch.int32, device=cuda)
        bo.scatter_ranked(g, *d_args, bin_size=bin_size, hash_functions=hf,
                          w0=r0 * n_words)
        torch.cuda.synchronize()
        assert torch.equal(g.cpu(), want)
        got.append(want)
    assert torch.equal(torch.cat(got), full)
    # entries land only in words below bin_size rows: a span past them
    past = torch.zeros((rows, n_words), dtype=torch.int32, device=cuda)
    before = kernels.LAUNCHES["scatter_span"]
    bo.scatter_ranked(past, *d_args, bin_size=bin_size, hash_functions=hf,
                      w0=bin_size * n_words)
    torch.cuda.synchronize()
    assert not past.any()
    assert kernels.LAUNCHES["scatter_span"] == before + 1


def test_mixed_mesh_moves_partials_across_devices(cuda):
    """A (2, 2) mesh of the card and the CPU: each batch row has a shard
    on the other device, so the inputs go over to it and its partials
    (the count shards' and the pruned shards' columns) come back to the
    row's first device, in both directions. The counts equal an all-CPU
    mesh's and the single-device filter's."""
    from ganon_tpu_torch.index.builder import _HashExtractor
    from ganon_tpu_torch.index.ibf import build_ibf
    from ganon_tpu_torch.index.pruned import build_pruned
    from ganon_tpu_torch.parallel.mesh import Mesh, ShardedClassifier
    from ganon_tpu_torch.parallel.pruned_shard import BinShardedPrunedForest

    rng = np.random.default_rng(13)
    sizes = [2000] * 20 + [200_000]
    genomes = {f"T{t:02d}": rng.integers(0, 4, size=n, dtype=np.uint8)
               for t, n in enumerate(sizes)}
    ex = _HashExtractor(19, 31, device="cpu")
    for t, g in genomes.items():
        ex.add_encoded(t, g)
    th = ex.finish()
    ibf = build_ibf(th, kmer_size=19, window_size=31, device="cpu")
    cpu, c0 = torch.device("cpu"), torch.device("cuda",
                                                torch.cuda.current_device())
    mixed = Mesh([[c0, cpu], [cpu, c0]])
    B, L = 61, 150
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    names = sorted(genomes)
    for b in range(0, B, 2):
        g = genomes[names[b % len(names)]]
        s = int(rng.integers(0, len(g) - L))
        codes[b] = g[s:s + L]
    lengths = np.full(B, L, np.int32)
    lengths[5] = 0
    before = dict(kernels.LAUNCHES)
    got_c, got_n = ShardedClassifier(ibf, mixed).counts(codes, lengths)
    launched = {k: kernels.LAUNCHES[k] - before[k]
                for k in ("count_shard", "combine")}
    want_c, want_n = ShardedClassifier(
        ibf, Mesh([[cpu, cpu], [cpu, cpu]])).counts(codes, lengths)
    assert got_c.device == c0
    assert torch.equal(got_c.cpu(), want_c) and torch.equal(got_n.cpu(), want_n)
    assert want_c.any()
    assert launched["count_shard"] >= 2 and launched["combine"] == 1

    pf = build_pruned(th, kmer_size=19, window_size=31, group_size=8)
    assert pf.num_groups % 2  # a pad group on one shard
    fc = dev.DevicePrunedForest(pf, "cpu")
    L4 = -(-L // 4) * 4
    inbuf = np.zeros((B, L4 // 4 + 4), np.uint8)
    inbuf[:, :L4 // 4] = dev.pack_codes_2bit(codes)
    inbuf[:, L4 // 4:] = lengths.view(np.uint8).reshape(B, 4)
    h, n, _ = q.extract(torch.from_numpy(inbuf), L1=L4, L2=0, k=19, w=31,
                        mc=L4 - 31 + 1)
    before = kernels.LAUNCHES["fine_shard"]
    got = BinShardedPrunedForest(pf, mixed).counts_gated(h, n, 0.3)
    assert kernels.LAUNCHES["fine_shard"] == before + 2
    want = fc.counts_gated(h, n, 0.3)
    assert torch.equal(got, want) and want.any()


# --------------------------------------------------------------------------
# the ops library (K18), the ragged stream, pair compaction, sort_probes
# and the gather probe


def test_minimizers_kernel_matches_plain(cuda):
    """The library's minimizers (extract in single-end mode): L not a
    multiple of 4, rows shorter than w, lengths past L, more emissions
    than max_minimizers, a batch narrower than w."""
    from ganon_tpu_torch.ops import library as lib

    rng = np.random.default_rng(31)
    codes = torch.from_numpy(rng.integers(0, 4, size=(64, 203),
                                          dtype=np.uint8))
    lens = torch.from_numpy(rng.integers(0, 260, size=64).astype(np.int32))
    lens[:3] = torch.tensor([0, 30, 31])
    for mm in (5, 40, 400):
        before = kernels.LAUNCHES["minimizers"]
        got = lib.minimizers(codes.to(cuda), lens.to(cuda), k=19, w=31,
                             max_minimizers=mm)
        want = lib.minimizers_plain(codes.to(cuda), lens.to(cuda), k=19,
                                    w=31, max_minimizers=mm)
        assert kernels.LAUNCHES["minimizers"] == before + 1
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (want[1] > 5).any()
    h, n = lib.minimizers(codes[:, :20].to(cuda), lens.to(cuda), k=19, w=31,
                          max_minimizers=8)
    assert not h.any() and not n.any()


def test_bins_kernels_match_plain(cuda):
    """bins with a row wider than a block (n_words 300) and with M = 0;
    tsum with ids out of range, in one tile and past it (T = 13,000),
    at its tile edges, at T = 70,000 with ascending and shuffled maps, on
    one target, with an empty tile, off 16 bytes and at B = 1 (each
    with its launches: the plan only past one tile); bins_target with and without a permutation, equal to
    target_counts of the per-bin counts; both at the edges of bins.cu's
    warp design and both bins_target routes."""
    from ganon_tpu_torch.ops import library as lib

    rng = np.random.default_rng(32)
    for W, M in ((300, 70), (3, 0), (5, 300)):
        R, B, S = 1000, 20, 3
        bits = torch.from_numpy(rng.integers(-2**31, 2**31, size=(R, W),
                                             dtype=np.int64).astype(np.int32))
        rows = torch.from_numpy(rng.integers(0, R, size=(B, M, S)).astype(
            np.int32))
        mask = torch.from_numpy(rng.random((B, M)) < 0.7)
        mask[0] = False
        args = [x.to(cuda) for x in (bits, rows, mask)]
        got = lib.bulk_count_bins(*args)
        assert torch.equal(got, lib.bulk_count_bins_plain(*args))
        for T in (7, 13000):
            b2t = torch.from_numpy(rng.integers(-2, T + 2, size=W * 32).astype(
                np.int32)).to(cuda)
            tc = lib.target_counts(got, b2t, num_targets=T)
            assert torch.equal(tc, lib.target_counts_plain(got, b2t,
                                                           num_targets=T))
        b2t_np = np.sort(rng.integers(0, 8, size=W * 32)).astype(np.int32)
        for shuffle in (False, True):
            if shuffle:
                rng.shuffle(b2t_np)
            perm, starts, ends = lib.target_segments(b2t_np, 7)
            seg = [torch.from_numpy(x).to(cuda) for x in (starts, ends)]
            pt = None if perm is None else torch.from_numpy(
                perm.astype(np.int32)).to(cuda)
            btc = lib.bulk_target_counts(*args, *seg, pt)
            assert torch.equal(btc, lib.bulk_target_counts_plain(*args, *seg,
                                                                 pt))
            assert torch.equal(btc, lib.target_counts(
                got, torch.from_numpy(b2t_np).to(cuda), num_targets=7))
    # more than 32 valid hashes under a mask with holes, S 1 and 8, rows
    # off the 4-word tile and the 16-word span, bins_target's one-launch
    # route up to its limit (1816 words: one read a block, 227 KB) and
    # the two-launch route past it (1817, and T = 70,000's 2188 words);
    # ranges with ends < starts, B off the fused route's reads a block
    for W, M, S, dens in ((33, 100, 2, 0.5), (32, 40, 1, 0.3),
                          (12, 50, 8, 0.9), (7, 45, 3, 0.7),
                          (100, 33, 2, 0.5), (1816, 40, 2, 0.5),
                          (1817, 40, 2, 0.5), (2188, 70, 1, 0.2)):
        R, B = 61, 21
        planes = rng.random((R, W, 32)) < dens
        bits = torch.from_numpy((planes.astype(np.uint64) << np.arange(
            32, dtype=np.uint64)).sum(axis=2).astype(np.uint32).view(
                np.int32)).to(cuda)
        rows = torch.from_numpy(rng.integers(0, R, size=(B, M, S)).astype(
            np.int32)).to(cuda)
        mask_np = rng.random((B, M)) < 0.6
        mask_np[1], mask_np[2], mask_np[3, :M // 2] = True, False, False
        mask = torch.from_numpy(mask_np).to(cuda)
        got = lib.bulk_count_bins(bits, rows, mask)
        assert torch.equal(got, lib.bulk_count_bins_plain(bits, rows, mask))
        assert got[0].any() and not got[2].any()
        TB = W * 32
        starts = rng.integers(0, TB + 1, size=300).astype(np.int32)
        ends = rng.integers(0, TB + 1, size=300).astype(np.int32)
        starts[:3], ends[:3] = [0, TB, 5], [TB, 0, 5]
        seg = [torch.from_numpy(x).to(cuda) for x in (starts, ends)]
        for pt in (None, torch.from_numpy(
                rng.permutation(TB).astype(np.int32)).to(cuda)):
            before = kernels.LAUNCHES["bins_target"]
            btc = lib.bulk_target_counts(bits, rows, mask, *seg, pt)
            assert kernels.LAUNCHES["bins_target"] == before + 1
            want = lib.bulk_target_counts_plain(bits, rows, mask, *seg, pt)
            assert torch.equal(btc, want) and (want < 0).any()
        assert lib.bins_target_fused(W) == (W <= 1816)
    # tsum at its tile edges (1 target, one under, at and one over 12,288),
    # T = 70,000 with an ascending map (16 padding bins last) and a
    # shuffled one, ids below 0 and at or past T, every bin on one target,
    # a tile with no bin, TB off 4 and rows at an odd offset, B = 1

    def tsum(bc, b2t, T):
        before = dict(kernels.LAUNCHES)
        got = lib.target_counts(bc, b2t, num_targets=T)
        tiles, width = lib.tsum_tiles(T)
        assert kernels.LAUNCHES["tsum"] == before["tsum"] + 1
        assert (kernels.LAUNCHES["tsum_plan"]
                == before["tsum_plan"] + (tiles > 1))
        assert torch.equal(got, lib.target_counts_plain(bc, b2t,
                                                        num_targets=T))
        if tiles > 1:
            assert torch.equal(lib.target_windows(b2t, T, width),
                               lib.target_windows_plain(b2t, T, width))
        return got

    def counts(B, TB):
        c = rng.integers(0, 50, size=(B, TB)).astype(np.int32)
        c[rng.random((B, TB)) < 0.3] = 0
        return torch.from_numpy(c).to(cuda)

    def ids(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(cuda)

    for T in (1, 12287, 12288, 12289):
        TB = T + 16 + 100 * (T == 1)
        m = np.minimum(np.arange(TB) % (T + 8), T)  # some targets twice
        m[::5], m[1::7] = -3, T + 2
        for B in (1, 5):
            assert tsum(counts(B, TB), ids(m), T).any()
    T, TB = 70_000, 70_016
    bc = counts(9, TB)
    asc = np.minimum(np.arange(TB), T)
    assert tsum(bc, ids(asc), T).any()
    assert tsum(bc, ids(rng.permutation(asc)), T).any()
    one = tsum(bc, ids(np.full(TB, 40_000)), T)
    assert torch.equal(one[:, 40_000], bc.sum(dim=1, dtype=torch.int32))
    assert one.sum() == one[:, 40_000].sum()
    width = lib.tsum_tiles(T)[1]
    gap = asc.copy()
    gap[(gap >= 2 * width) & (gap < 3 * width)] = -1
    assert not tsum(bc, ids(gap), T)[:, 2 * width:3 * width].any()
    tsum(counts(3, TB + 1), ids(np.minimum(np.arange(TB + 1), T)), T)
    for TB in (1029, 1024):  # rows (and the map) one int past 16 bytes
        rows = counts(1, 3 * TB + 1)[0, 1:].view(3, TB)
        m = ids(rng.integers(-2, 1030, size=TB + 1))[1:]
        assert rows.is_contiguous() and rows.data_ptr() % 16
        tsum(rows, m, 1024)
        tsum(rows, m, 13_000)


def _dense_buffer(rng, B, K, has_win, n_extra, T):
    """A dense pack16 result buffer of random entries, n_matches past K
    included."""
    parts = [rng.integers(-2**31, 2**31, size=B * K)]
    if has_win:
        parts.append(rng.integers(0, 3, size=B * K))
    nm = rng.integers(0, K + 3, size=B)
    nm[rng.random(B) < 0.5] = 0
    parts += [nm, rng.integers(0, 0xFFFF, size=B),
              rng.integers(0, 0x3FFFF, size=B), rng.integers(0, 2, size=B)]
    parts += [rng.integers(-2**31, 2**31, size=B) for _ in range(n_extra)]
    parts.append(rng.integers(0, 1000, size=2 * T + 3))
    return torch.from_numpy(np.concatenate(parts).astype(np.int32))


@pytest.mark.parametrize("has_win,n_extra", [(False, 0), (True, 0),
                                             (False, 2)],
                         ids=["flat", "winners", "group-words"])
def test_ragged_kernel_matches_plain(cuda, has_win, n_extra):
    """The ragged stream at a cap of 1, a cap inside the first block's
    entries, a cap that overflows, a total exactly at the cap and an ample
    cap, n_matches past K, at B = 3000 and B = 70,000 (K 4: the chained
    scan over 274 blocks), with and without winners and extra rows; every
    call twice, so the second finds the first's status words (of an
    earlier epoch) in the stream's buffer, and B = 3000 again after the
    larger call."""
    rng = np.random.default_rng(33 + has_win + n_extra)
    for B, K in ((5, 4), (3000, 8), (70_000, 4), (3000, 8)):
        dense = _dense_buffer(rng, B, K, has_win, n_extra, 11).to(cuda)
        valid = torch.clamp(dense[B * K * (1 + has_win):][:B], min=0, max=K)
        total = int(valid.sum())
        first_block = max(1, int(valid[:dev.RAGGED_READS].sum()) // 2)
        for cap in (1, first_block, max(1, total // 2), total, total + 5):
            kw = dict(has_win=has_win, n_extra=n_extra)
            want = dev.ragged_plain(dense, B, K, cap, **kw)
            for _ in range(2):
                got = dev.ragged(dense, B, K, cap, **kw)
                assert torch.equal(got, want), (B, cap)
            res = dev.unpack_batch_result_ragged(
                got.cpu().numpy(), B, cap, 11, K, has_win, n_extra=n_extra)
            assert res["cap_overflow"] == (total > cap)


def test_pairs_kernel_matches_plain(cuda):
    """Pair compaction: a cap of 0 (every read with a live slot spills),
    caps inside and past the pairs, B = 5000 (20 scan blocks)."""
    rng = np.random.default_rng(34)
    for B, S in ((7, 2), (5000, 3)):
        ok = torch.from_numpy((rng.random((B, S)) < 0.6).astype(np.uint8))
        ovf = torch.from_numpy((rng.random(B) < 0.1).astype(np.uint8))
        n_pairs = int(ok.sum())
        for cap in (0, 1, n_pairs // 2, n_pairs + 3):
            got = pq.pair_live(ok.to(cuda), ovf.to(cuda), cap)
            want = pq.pair_live_plain(ok.to(cuda), ovf.to(cuda), cap)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), cap
        spill = pq.pair_live(ok.to(cuda), ovf.to(cuda), 0)[1].bool().cpu()
        assert torch.equal(spill, ovf.bool() | ok.bool().any(dim=1))


@pytest.mark.parametrize("S", list(range(1, 10)))
def test_pairs_kernel_many_tiles(cuda, S):
    """The chained scan over 274 blocks (B = 70,000) at S 1-8 (one word a
    row where S is 1, 2, 4 or 8) and S 9 (bytes), overflow bytes other
    than 0 and 1, caps 0, 1, inside and past the pairs; rows at an odd
    offset (no word loads); the inputs left as they were."""
    rng = np.random.default_rng(340 + S)
    B = 70_000
    ok_np = (rng.random((B, S)) < 0.5).astype(np.uint8)
    ok_np[ok_np > 0] = rng.integers(1, 256, size=int(ok_np.sum()))
    ovf_np = (rng.random(B) < 0.1).astype(np.uint8) * 3
    ok, ovf = torch.from_numpy(ok_np).to(cuda), torch.from_numpy(ovf_np).to(
        cuda)
    n_pairs = int((ok_np != 0).sum())
    flat = torch.zeros(B * S + 1, dtype=torch.uint8, device=cuda)
    flat[1:] = ok.reshape(-1)
    shifted = flat[1:].view(B, S)  # contiguous, one byte off alignment
    for cap in (0, 1, n_pairs // 3, n_pairs, n_pairs + 5):
        want = pq.pair_live_plain(ok, ovf, cap)
        for slots in (ok, shifted):
            got = pq.pair_live(slots, ovf, cap)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), cap
    assert torch.equal(ok.cpu(), torch.from_numpy(ok_np))
    assert torch.equal(ovf.cpu(), torch.from_numpy(ovf_np))


def test_scans_share_status_words(cuda):
    """ragged, pairs, extract, pack and dedup's rank mode (alone and
    inside the ranked scatter) take their status words from one buffer a
    stream, and gather_probe its ticket counter: a pack call between a
    ragged call and an extract call of more blocks, two pairs calls in a
    row after them, dedup's ranks, a ranked scatter, pack and
    gather_probe between them, then pairs, gather_probe, ragged, pack,
    gather_probe and dedup on a second stream (a buffer of its own), each
    equal to its plain version; one launch a pairs call."""
    from ganon_tpu_torch.ops import probe

    rng = np.random.default_rng(36)
    sk, sv = bo.sort_entries(*_entries(rng, 30_001, 10), key_bits=4)
    want_d = bo.dedup_plain(sk, sv, num_files=10)
    dk, dv = _to(cuda, sk, sv)
    sparams, sbins = _ranked_params(
        torch.bincount(sk[want_d[0].bool()].to(torch.int64),
                       minlength=10).to(torch.int32), 300)
    want_s = torch.zeros((1009, -(-sbins // 32)), dtype=torch.int32)
    bo.scatter_ranked_plain(want_s, sk, sv, *want_d, sparams, bin_size=1009,
                            hash_functions=2)
    B, K = 3000, 8
    dense = _dense_buffer(rng, B, K, False, 0, 11).to(cuda)
    ok = torch.from_numpy((rng.random((9000, 2)) < 0.6).astype(
        np.uint8)).to(cuda)
    ovf = torch.zeros(9000, dtype=torch.uint8, device=cuda)
    buf, L1, L2, k, w, mcs = _extract_case("one_read")
    inbuf = torch.from_numpy(np.repeat(buf, 300, axis=0)).to(cuda)
    cap = int(ok.sum()) // 2
    want_p = pq.pair_live_plain(ok, ovf, cap)
    want_r = dev.ragged_plain(dense, B, K, 100)
    want_x = q.extract_plain(inbuf, L1=L1, L2=L2, k=k, w=w, mc=mcs[0])
    ph = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, size=(2500, 40)))
    pn = torch.from_numpy(rng.integers(0, 41, size=2500).astype(np.int32))
    pkeys = torch.from_numpy(rng.integers(0, 9, size=2500).astype(np.int32))
    ptotal = int(pn.sum())
    want_pk = bo.pack_entries_plain(ph, pn, pkeys, ptotal)
    pargs = (*_to(cuda, ph, pn, pkeys), ptotal)
    gtbl = torch.from_numpy(rng.integers(0, 256, size=(1 << 12, 32),
                                         dtype=np.uint8))
    grows = torch.from_numpy(rng.integers(0, 1 << 12, size=50_000).astype(
        np.int32))
    want_g = probe.gather_probe_plain(gtbl, grows)
    gargs = _to(cuda, gtbl, grows)

    def pack_ok():
        got_pk = bo.pack_entries(*pargs)
        return all(torch.equal(a.cpu(), b) for a, b in zip(got_pk, want_pk))

    assert torch.equal(dev.ragged(dense, B, K, 100), want_r)
    assert pack_ok()
    got_x = q.extract(inbuf, L1=L1, L2=L2, k=k, w=w, mc=mcs[0])
    before = kernels.LAUNCHES["pairs"]
    for _ in range(2):
        got = pq.pair_live(ok, ovf, cap)
        assert all(torch.equal(a, b) for a, b in zip(got, want_p))
        assert pack_ok()
        got_d = bo.dedup(dk, dv, num_files=10)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got_d, want_d))
        got_s = torch.zeros_like(want_s, device=cuda)
        bo.scatter_ranked(got_s, dk, dv, None, None, sparams.to(cuda),
                          bin_size=1009, hash_functions=2)
        assert torch.equal(got_s.cpu(), want_s)
        assert torch.equal(probe.gather_probe(*gargs).cpu(), want_g)
    assert kernels.LAUNCHES["pairs"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got_x, want_x))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = pq.pair_live(ok, ovf, cap)
        got_g = probe.gather_probe(*gargs)
        got_r = dev.ragged(dense, B, K, 100)
        got_pk = bo.pack_entries(*pargs)
        got_g2 = probe.gather_probe(*gargs)
        got_d = bo.dedup(dk, dv, num_files=10)
    side.synchronize()
    assert torch.equal(got_g.cpu(), want_g) and torch.equal(got_g2.cpu(),
                                                            want_g)
    assert all(torch.equal(a, b) for a, b in zip(got, want_p))
    assert torch.equal(got_r, want_r)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got_pk, want_pk))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got_d, want_d))
    keys = {key for key in kernels._SCAN_STATUS if key[0] == "cuda"}
    assert len(keys) >= 2


def test_probe_sort_kernel_matches_plain(cuda):
    """probe_sort with equal keys (a hash repeated), n = 0, n past M, M
    not a power of two, and M = 4096; both routes at their edges (M 1,
    31, 32, 33, 56, 64, 256, 257, 4096) and bin_size near 2^46."""
    rng = np.random.default_rng(35)
    for B, M in ((40, 56), (3, 4096)):
        h = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, size=(B, M)))
        h[0, :] = h[0, 0]
        n = torch.from_numpy(rng.integers(0, M + 9, size=B).astype(np.int32))
        n[1] = 0
        hg, ng = h.to(cuda), n.to(cuda)
        for bin_size in (97, 1 << 30):
            got = q.probe_sort(hg, ng, bin_size=bin_size)
            assert torch.equal(got, q.probe_sort_plain(hg, ng,
                                                       bin_size=bin_size))
    # both routes at their edges (a warp a read up to 256 slots, 1 to 8
    # keys a lane; a block a read past it), B off the warp route's 8 reads
    # a block, n = 0 and past M, repeated hashes, bin_size near 2^46
    for M in (1, 31, 32, 33, 56, 64, 256, 257, 4096):
        B = 3 if M == 4096 else 21
        h = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, size=(B, M)))
        h[0, :] = h[0, 0]
        h[2, M // 2:] = h[2, 0]
        n = torch.from_numpy(rng.integers(0, M + 1, size=B).astype(np.int32))
        n[1], n[-1] = 0, M + 5
        hg, ng = h.to(cuda), n.to(cuda)
        for bin_size in (97, 2_787_889, (1 << 46) - 1):
            before = kernels.LAUNCHES["probe_sort"]
            got = q.probe_sort(hg, ng, bin_size=bin_size)
            assert kernels.LAUNCHES["probe_sort"] == before + 1
            assert torch.equal(got, q.probe_sort_plain(hg, ng,
                                                       bin_size=bin_size))


@pytest.mark.parametrize("case", ["n_edges", "r16", "one_group", "wrap",
                                  "streams", "garbage", "rows_off_16",
                                  "repeat"])
def test_gather_probe_kernel_matches_plain(cuda, case):
    """The Pallas probe's port at its own shapes and at a few probes: N
    at the warp step's edges (0, 1, 31, 32, 33, 4097 and NPROBE), the
    smallest table (R 16), every probe in one group (the most
    contention), an all-ones table with 2^26 + 5 probes in one group
    against the closed form (32 N) mod 2^32 (the int32 sum wraps),
    back-to-back calls on one stream and calls on two streams, the
    allocator's memory filled with garbage first (a store the kernel
    misses shows), rows off 16 bytes, 600 back-to-back calls (the last
    block's ticket orders every partial before its sum); one launch a
    call."""
    from ganon_tpu_torch.ops import probe

    rng = np.random.default_rng(36)

    def table(R):
        return torch.from_numpy(rng.integers(0, 256, size=(R, 32),
                                             dtype=np.uint8)).to(cuda)

    def rows_of(R, n, group=None):
        if group is None:
            r = rng.integers(0, R, size=n)
        else:
            r = rng.integers(0, R // 16, size=n) * 16 + group
        return torch.from_numpy(r.astype(np.int32)).to(cuda)

    def check(tbl, rows):
        before = kernels.LAUNCHES["gather_probe"]
        got = probe.gather_probe(tbl, rows)
        assert kernels.LAUNCHES["gather_probe"] == before + 1
        assert torch.equal(got, probe.gather_probe_plain(tbl, rows)), (
            tbl.shape, rows.numel())

    if case == "n_edges":
        tbl = table(probe.R)
        for n in (0, 1, 31, 32, 33, 4097, probe.NPROBE):
            check(tbl, rows_of(probe.R, n))
    elif case == "r16":
        tbl = table(16)
        for n in (1, 33, 4097, probe.NPROBE):
            check(tbl, rows_of(16, n))
    elif case == "one_group":
        tbl = table(probe.R)
        for n in (33, probe.NPROBE):
            check(tbl, rows_of(probe.R, n, group=7))
    elif case == "wrap":
        n = (1 << 26) + 5
        tbl = torch.full((probe.R, 32), 0xFF, dtype=torch.uint8, device=cuda)
        rows = torch.randint(0, probe.R // 16, (n,), device=cuda,
                             dtype=torch.int32) * 16 + 3
        before = kernels.LAUNCHES["gather_probe"]
        got = probe.gather_probe(tbl, rows)
        assert kernels.LAUNCHES["gather_probe"] == before + 1
        want = torch.zeros((16, 8), dtype=torch.int64)
        want[3] = 32 * n
        want = ((want + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)
        assert int(want[3, 0]) < 0  # the sum passed 2^31 and wrapped
        assert torch.equal(got.cpu(), want.reshape(1, 128))
    elif case == "streams":
        tbl = table(probe.R)
        rows = [rows_of(probe.R, n) for n in (probe.NPROBE, 4097, 33, 70_001)]
        wants = [probe.gather_probe_plain(tbl, r) for r in rows]
        before = kernels.LAUNCHES["gather_probe"]
        gots = [probe.gather_probe(tbl, r) for r in rows]  # back to back
        assert kernels.LAUNCHES["gather_probe"] == before + len(rows)
        assert all(torch.equal(a, b) for a, b in zip(gots, wants))
        sides = [torch.cuda.Stream() for _ in range(2)]
        for _ in range(3):
            outs = []
            for i, side in enumerate(sides):
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    outs.append([probe.gather_probe(tbl, r)
                                 for r in rows[i::2]])
            for side in sides:
                side.synchronize()
            for i, got in enumerate(outs):
                assert all(torch.equal(a, b)
                           for a, b in zip(got, wants[i::2]))
    elif case == "garbage":
        tbl = table(probe.R)
        rows = rows_of(probe.R, probe.NPROBE)
        want = probe.gather_probe_plain(tbl, rows)
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        for n in (probe.NPROBE, 33, 0):
            r = rows[:n]
            # blocks of the scratch's and the output's sizes, filled with
            # -1 and given back to the allocator, which hands them out
            # again unchanged
            junk = [torch.full(shape, -1, dtype=torch.int32, device=cuda)
                    for shape in ((sms, 128), (1, 128)) * 4]
            del junk
            got = probe.gather_probe(tbl, r)
            if n == probe.NPROBE:
                assert torch.equal(got, want)
            else:
                assert torch.equal(got, probe.gather_probe_plain(tbl, r))
    elif case == "rows_off_16":
        tbl = table(probe.R)
        flat = rows_of(probe.R, 4097 + 3)
        for off in (1, 2, 3):
            check(tbl, flat[off:off + 4097])  # contiguous, off 16 bytes
    else:
        tbl = table(probe.R)
        rows = [rows_of(probe.R, n) for n in (4097, 65_536, probe.NPROBE)]
        wants = [probe.gather_probe_plain(tbl, r) for r in rows]
        gots = [probe.gather_probe(tbl, rows[i % 3]) for i in range(600)]
        bad = [i for i, got in enumerate(gots)
               if not torch.equal(got, wants[i % 3])]
        assert not bad, bad[:10]


def test_transfer_settings_cuda_match_cpu(cuda):
    """A flat filter with sort_probes and the ragged stream (a cap that
    overflows, and an ample one), and a pruned forest at pair caps 0,
    8 and B * S: the card's buffers equal the CPU's."""
    from ganon_tpu_torch.index.builder import _HashExtractor
    from ganon_tpu_torch.index.ibf import build_ibf
    from ganon_tpu_torch.index.pruned import build_pruned
    from ganon_tpu_torch.io.pipeline import EncodedBatch

    rng = np.random.default_rng(37)
    genomes = rng.integers(0, 4, size=(150, 2000), dtype=np.uint8)
    ex = _HashExtractor(19, 31, device="cpu")
    for t, g in enumerate(genomes):
        ex.add_encoded(f"T{t}", g)
    th = ex.finish()
    B, L = 128, 150
    tgt = rng.integers(0, len(genomes), size=B)
    pos = rng.integers(0, 2000 - L, size=B)
    r1 = genomes[tgt[:, None], pos[:, None] + np.arange(L)].astype(np.uint8)
    lens = np.full(B, L, np.int32)
    batch = EncodedBatch(prefix="", paired=False,
                         ids=[str(i) for i in range(B)], codes1=r1,
                         len1=lens)
    inbuf, L1, L2 = dev.pack_batch_direct(batch, B)
    kw = dict(k=19, w=31, L1=L1, L2=L2, top_k=8)
    fc = dev.DeviceFilter(build_ibf(th, kmer_size=19, window_size=31,
                                    device="cpu"), "cpu")
    fg = fc.to(cuda)
    for cap, sp in ((0, True), (3, False), (B * 8, True)):
        outs = [dev.classify_batch_packed(
            f, torch.from_numpy(inbuf).to(f.device), 0.05, 1.0, 65535,
            match_cap=cap, sort_probes=sp, **kw) for f in (fc, fg)]
        assert torch.equal(outs[0], outs[1].cpu()), (cap, sp)
    pf = build_pruned(th, kmer_size=19, window_size=31, group_size=16)
    pc = dev.DevicePrunedForest(pf, "cpu")
    pg = pc.to(cuda)
    for pair_cap in (0, 8, B * 2):
        outs = [dev.classify_batch_packed_pruned(
            f, torch.from_numpy(inbuf).to(f.device), 0.1, 0.5, 65535,
            max_groups=2, match_cap=B, pair_cap=pair_cap, **kw)
            for f in (pc, pg)]
        assert torch.equal(outs[0], outs[1].cpu()), pair_cap


# --------------------------------------------------------------------------
# the wide-window extract route, select as one read of the row, count for
# narrow rows and every raptor sub in one launch


@pytest.mark.parametrize("k,L2", [(19, 20_000), (19, 0), (32, 20_000)])
def test_extract_wide_window_matches_plain(cuda, k, L2):
    """At the widest w the tiled kernel holds (k 19: 18,103) and one past
    it (18,104, the wide route, counted as extract_wide), paired and
    single-end, and at k 32, reads of 20-40 kbp: n, overflow and hashes
    equal the plain version's with the zero tail (at a width that
    overflows and at every position), and without it the first n slots
    of each row."""
    rng = np.random.default_rng(L2 + k)
    L1, B = 40_000, 48
    first = next(w for w in range(k, 40_000) if q.extract_is_wide(k, w))
    assert k != 19 or first == 18_104
    for w in (first - 1, first):
        buf = _inbuf(rng, B, L1, L2, w).numpy()
        len1 = rng.integers(20_000, L1 + 1, size=B)
        len1[:3] = [w - 1, w, L1]
        len2 = rng.integers(20_000 if L2 else 0, L2 + 1, size=B)
        _set_lens(buf, L1, L2, len1, len2)
        inbuf = torch.from_numpy(buf).to(cuda)
        m = (L1 - w + 1) + (L2 - w + 1 if L2 else 0)
        wide = q.extract_is_wide(k, w)
        assert wide == (w == first)
        for mc in (2, m):
            before = dict(kernels.LAUNCHES)
            got = q.extract(inbuf, L1=L1, L2=L2, k=k, w=w, mc=mc)
            want = q.extract_plain(inbuf, L1=L1, L2=L2, k=k, w=w, mc=mc)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["extract_wide"] - before[
                "extract_wide"] == int(wide)
            assert kernels.LAUNCHES["extract"] - before["extract"] == int(
                not wide)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (w, mc)
            assert bool(want[2].any()) == (mc == 2)
            h, n, o = q.extract(inbuf, L1=L1, L2=L2, k=k, w=w, mc=mc,
                                zero_tail=False)
            keep = torch.arange(mc, device=cuda)[None, :] < n[:, None]
            assert torch.equal(n, want[1]) and torch.equal(o, want[2])
            assert torch.equal(h[keep], want[0][keep])
        assert (want[1][3:] >= 1).all() and (want[1] > 2).any()


def _kept_counts(rng, B, C, n, cutoff, kept, live=None):
    """int32 counts [B, C]: row b keeps exactly kept[b] live entries
    (count >= cutoff[b], up to n[b]); the others stay below the cutoff,
    and each row has a few entries at its top count."""
    counts = np.zeros((B, C), np.int64)
    for b in range(B):
        counts[b] = rng.integers(0, max(int(cutoff[b]), 1), size=C)
        cand = np.flatnonzero(live[b]) if live is not None else np.arange(C)
        counts[b, np.setdiff1d(np.arange(C), cand)] = rng.integers(
            0, int(n[b]) + 1, size=C - len(cand))  # dead lanes: anything
        sel = rng.choice(cand, size=min(int(kept[b]), len(cand)),
                         replace=False)
        top = max(int(n[b]), int(cutoff[b]))  # an invalid read: n = 0
        counts[b, sel] = rng.integers(int(cutoff[b]), top + 1, size=len(sel))
        counts[b, sel[:3]] = top
    return counts.astype(np.int32)


@pytest.mark.parametrize("mode", ["select", "winners", "select32", "lanes"])
def test_select_kernel_at_the_list_capacity(cuda, mode):
    """select in every mode with rows that keep exactly 2048 entries (the
    list's capacity: one read of the row) and 2049 (the passes over the
    row), a row keeping none, an invalid read, at T % 4 != 0 (rows off
    16-byte alignment), with K past the finals (the non-final fill) and
    with K below them; equal to the plain version."""
    rng = np.random.default_rng(len(mode))
    B, cap = 24, 2048
    if mode == "lanes":
        S, gs = 31, 67
        C = S * gs  # 2077
        G = 40
        nt = np.full(G, gs, np.int32)
        nt[-1] = 5  # a partly full group
        gsel = np.stack([rng.permutation(G)[:S] for _ in range(B)]
                        ).astype(np.int32)
        gsel[:4, 0] = G - 1
        ok = (rng.random((B, S)) < 0.97).astype(np.uint8)
        ok[:8] = 1
        gsel[:8] = np.arange(S)  # rows whose every lane is live
        live = (np.arange(gs)[None, None, :]
                < np.where(ok.astype(bool), nt[gsel], 0)[:, :, None]
                ).reshape(B, C)
    else:
        C = 4099 if mode == "select32" else 2051
        live = None
    assert C % 4 != 0
    n = rng.integers(50, 120, size=B)
    if mode == "select32":
        n = rng.integers(100_000, 200_000, size=B)
    n[0] = 0  # an invalid read
    rel_cutoff = 0.25
    cutoff = np.maximum(np.ceil(n * rel_cutoff), 1).astype(np.int64)
    kept = rng.integers(0, 40, size=B)
    kept[1:6] = [cap, cap + 1, cap, cap + 1, 0]  # (lanes: every lane live)
    counts = _kept_counts(rng, B, C, n, cutoff, kept, live)
    n32 = n.astype(np.int32)
    ovf = (rng.random(B) < 0.2).astype(np.uint8)
    c, nn, o = (torch.from_numpy(x).to(cuda) for x in (counts, n32, ovf))
    kept_rows = ((counts >= cutoff[:, None])
                 & (live if live is not None else True)).sum(1)
    assert {cap, cap + 1} <= set(kept_rows.tolist())
    limit = (1 << 32) - 1 if mode == "select32" else 65535
    for top_k in (4, 96):
        for rel_filter in (0.0, 1.0):
            cuts = (rel_cutoff, rel_filter, limit)
            for emit in (True, False):
                if mode == "lanes":
                    gs_d, ok_d, nt_d = (torch.from_numpy(x).to(cuda)
                                        for x in (gsel, ok, nt))
                    T = int(G * gs)
                    got = dev.select_lanes(c, nn, o, gs_d, ok_d, nt_d, *cuts,
                                           group_size=gs, num_targets=T,
                                           top_k=top_k, emit_matches_t=emit)
                    want = dev._pack_result(
                        dev.threshold_topk(c, nn, *cuts, top_k=top_k,
                                           emit_matches_t=emit,
                                           lanes=(gs_d, ok_d, nt_d, gs, T)),
                        nn, o.to(torch.int32), dev.group_words(gs_d, ok_d))
                elif mode == "winners":
                    wn = torch.from_numpy(rng.integers(
                        0, 4, size=(B, C)).astype(np.int32)).to(cuda)
                    got = dev.select(c, nn, o, *cuts, top_k=top_k,
                                     emit_matches_t=emit, uwin=wn)
                    want = dev._pack_result(
                        dev.threshold_topk(c, nn, *cuts, top_k=top_k,
                                           emit_matches_t=emit, winners=wn),
                        nn, o.to(torch.int32))
                else:
                    p16 = mode == "select"
                    got = dev.select(c, nn, o, *cuts, top_k=top_k,
                                     emit_matches_t=emit, pack16=p16)
                    want = dev._pack_result(
                        dev.threshold_topk(c, nn, *cuts, top_k=top_k,
                                           emit_matches_t=emit, pack16=p16),
                        nn, o.to(torch.int32), pack16=p16)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (top_k, rel_filter, emit)


def _narrow_table(rng, R, W32):
    """A u8 table of W32 u32 words a row and byte ranges covering it:
    targets of 1 byte (four in one word), zero-width targets, and targets
    spanning several words."""
    W8 = 4 * W32
    widths = []
    while sum(widths) < W8:
        widths.append(int(rng.choice([0, 1, 1, 1, 2, 5, 9, 13])))
    widths[-1] -= sum(widths) - W8
    if W32 >= 2:
        widths[:5] = [1, 1, 1, 1, 0]
        widths[-1] += W8 - sum(widths)
    widths = np.array(widths)
    assert widths.sum() == W8 and (widths >= 0).all()
    ends = np.cumsum(widths).astype(np.int32)
    starts = np.concatenate([[0], ends[:-1]]).astype(np.int32)
    tbl8 = rng.integers(0, 256, size=(R, W8), dtype=np.uint8)
    return [torch.from_numpy(x) for x in (tbl8, starts, ends)]


@pytest.mark.parametrize("W32", [1, 7, 16, 17, 63, 64, 65, 255, 256])
def test_count_kernel_narrow_rows_match_plain(cuda, W32):
    """count at rows of W32 words (narrow below 256: groups of threads a
    hash; 256: the ring route, but in column-max mode the tile walk), h
    1-5, more hashes than a shared-memory chunk, in flat, forest, shard
    (clamp off) and column-max modes, equal to the plain version; one
    launch each, under its mode's counter (the flat mode's on the ring
    route: count_ring)."""
    rng = np.random.default_rng(W32)
    R, B, M = 509, 70, 150
    tbl8, starts, ends = (x.to(cuda) for x in _narrow_table(rng, R, W32))
    T = starts.shape[0]
    h = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, size=(B, M))).to(
        cuda)
    n = torch.from_numpy(rng.integers(0, M + 30, size=B).astype(np.int32))
    n[:3] = torch.tensor([0, 1, M])
    n = n.to(cuda)
    ldc, col0 = T + 11, 7
    cols = torch.from_numpy(np.sort(rng.choice(ldc, T, replace=False)).astype(
        np.int32)).to(cuda)
    for hf in range(1, 6):
        args = (tbl8, starts, ends, h, n)
        kw = dict(bin_size=R - hf, hash_functions=hf)
        before = dict(kernels.LAUNCHES)
        flat = q.bulk_target_counts_packed(*args, **kw)
        assert torch.equal(flat, q.bulk_target_counts_packed_plain(*args,
                                                                   **kw))
        part = q.bulk_target_counts_packed(*args, clamp=False, **kw)
        assert torch.equal(part, q.bulk_target_counts_packed_plain(
            *args, clamp=False, **kw))
        # forest mode into columns col0.. of a wider matrix; column-max
        # mode over earlier values
        fill = torch.full((B, ldc), -3, dtype=torch.int32, device=cuda)
        fill[:, col0:col0 + T] = 0
        prior = torch.from_numpy(rng.integers(0, 4, size=(B, ldc)).astype(
            np.int32)).to(cuda)
        outs = []
        for fn in (q.bulk_target_counts_packed,
                   q.bulk_target_counts_packed_plain):
            fo, mo = fill.clone(), prior.clone()
            fn(*args, out=fo, col0=col0, **kw)
            fn(*args, out=mo, cols=cols, **kw)
            outs.append((fo, mo))
        (fk, mk), (fp, mp) = outs
        torch.cuda.synchronize()
        assert torch.equal(fk, fp) and torch.equal(mk, mp), hf
        assert (fk[:, :col0] == -3).all() and (fk[:, col0 + T:] == -3).all()
        assert (part >= flat).all() and (flat > 0).any()
        flat_counter = ("count_ring" if q.count_route(tbl8) == "ring"
                        else "count")
        for name in (flat_counter, "count_shard", "count_forest",
                     "count_raptor"):
            assert kernels.LAUNCHES[name] == before[name] + 1, name


@pytest.mark.parametrize("case,W32,hf", [
    ("cell", 160, 1), ("cell", 160, 3), ("cell", 160, 5),
    ("ranges", 160, 2), ("edges", 160, 1), ("forest", 160, 2),
    ("ranges", 92, 1), ("ranges", 96, 1), ("ranges", 252, 4),
    ("ranges", 256, 2), ("ranges", 512, 1), ("ranges", 516, 1),
    ("ranges", 130, 1), ("offset", 160, 1),
])
def test_count_kernel_ring_route_matches_plain(cuda, case, W32, hf):
    """count on its ring route (rows of 96 to 512 words) against the
    plain version: the arc_cg_ibf table's 640 one-byte targets at h 1, 3
    and 5; targets of several bytes and empty ranges, also with the clamp
    off (shard mode); reads with n = 0, n past M and more hashes than a
    shared-memory chunk and a packed byte sum hold; forest mode at col0 >
    0 over other columns; widths on both sides of each edge, rows off
    whole 16-byte words and a table off the 16-byte grid (those on their
    old routes). Every cell of the flat output is stored (it comes from
    garbage-filled memory); one launch under its mode's counter
    (count_ring for the flat mode on the ring route), and the recorder's
    count.ring_launches on the ring route."""
    rng = np.random.default_rng([W32, hf, len(case)])
    R, B = 4093, 300
    M = 400 if case == "edges" else 48
    if case == "cell":
        W8 = 4 * W32
        tbl8 = torch.from_numpy(rng.integers(0, 256, size=(R, W8),
                                             dtype=np.uint8))
        starts = torch.arange(W8, dtype=torch.int32)
        ends = starts + 1
    else:
        tbl8, starts, ends = _narrow_table(rng, R, W32)
    T = starts.shape[0]
    h = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, size=(B, M)))
    n = torch.from_numpy(rng.integers(35, 46, size=B).astype(np.int32))
    if case == "edges":
        n = torch.from_numpy(rng.integers(0, M + 60, size=B).astype(np.int32))
        n[:4] = torch.tensor([0, M, M + 1, 200])
    else:
        n[:2] = torch.tensor([0, M + 9])
    tbl8 = tbl8.to(cuda)
    if case == "offset":  # the same rows 4 bytes off the 16-byte grid
        buf = torch.empty(tbl8.numel() + 4, dtype=torch.uint8, device=cuda)
        buf[4:] = tbl8.reshape(-1)
        tbl8 = buf[4:].view(tbl8.shape)
    args = (tbl8, starts.to(cuda), ends.to(cuda), h.to(cuda), n.to(cuda))
    kw = dict(bin_size=R - hf, hash_functions=hf)
    route = q.count_route(tbl8)
    assert route == ("ring" if 96 <= W32 <= 512 and W32 % 4 == 0
                     and case != "offset" else
                     "narrow" if W32 < 256 else "tiles")
    before = dict(kernels.LAUNCHES)
    with trace.span("cmd.count_test") as top:
        if case == "forest":
            ldc, col0 = T + 50, 37
            got = torch.full((B, ldc), -5, dtype=torch.int32, device=cuda)
            want = got.clone()
            q.bulk_target_counts_packed(*args, out=got, col0=col0, **kw)
            q.bulk_target_counts_packed_plain(*args, out=want, col0=col0,
                                              **kw)
            assert (got[:, :col0] == -5).all()
            assert (got[:, col0 + T:] == -5).all()
        else:
            torch.full((B, T), -5, dtype=torch.int32, device=cuda)  # garbage
            got = q.bulk_target_counts_packed(*args, **kw)
            want = q.bulk_target_counts_packed_plain(*args, **kw)
    assert top.root.counters.get("count.ring_launches", 0) == (
        route == "ring")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if case == "forest":
        want = want[:, col0:col0 + T]
    assert (want[0] == 0).all() and (want > 0).any()
    counter = ("count_forest" if case == "forest" else
               "count_ring" if route == "ring" else "count")
    for name in ("count", "count_forest", "count_ring", "count_shard"):
        assert kernels.LAUNCHES[name] == before[name] + (name == counter), name
    if case == "ranges":  # shard mode: the partial sums, the clamp off
        part = q.bulk_target_counts_packed(*args, clamp=False, **kw)
        assert torch.equal(part, q.bulk_target_counts_packed_plain(
            *args, clamp=False, **kw))
        assert kernels.LAUNCHES["count_shard"] == before["count_shard"] + 1


def test_raptor_target_counts_one_launch_matches_per_sub(cuda):
    """Every sub of the column-max layout above in one launch (a target
    over three tiles beside subs of a few words, h 1, 5 and 2, a user bin
    in two subs with equal and unequal counts, a column no sub writes),
    against the per-sub loop on the card and the plain version; the
    output needs no zeroing, and the launch counts once."""
    rng = np.random.default_rng(12)
    T = 40
    subs = []
    widths = np.array([3, 20000, 5, 1, 9000, 8, 8, 700])
    subs.append((*_sub_table(rng, 512, widths), 512, 1,
                 np.array([0, 5, 6, 7, 9, 10, 11, 12])))
    subs.append(subs[0])
    subs.append((*_sub_table(rng, 300, np.array([40])), 300, 5,
                 np.array([5])))
    widths = rng.integers(1, 30, size=20)
    subs.append((*_sub_table(rng, 2000, widths), 1999, 2,
                 np.sort(rng.choice(np.arange(1, T - 1), 20, replace=False))))
    rsubs = [dev.RaptorSub(tbl8=tb.to(cuda), byte_starts=s.to(cuda),
                           byte_ends=e.to(cuda), bin_size=bs, hash_funs=hf,
                           cols=torch.from_numpy(c.astype(np.int32)).to(cuda))
             for tb, s, e, bs, hf, c in subs]
    B, M = 64, 300
    h = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, size=(B, M))).to(cuda)
    n = torch.from_numpy(rng.integers(0, M + 50, size=B).astype(np.int32))
    n[:3] = torch.tensor([0, 1, M])
    n = n.to(cuda)
    loop = torch.zeros((B, T), dtype=torch.int32, device=cuda)
    for s in rsubs:
        q.bulk_target_counts_packed(
            s.tbl8, s.byte_starts, s.byte_ends, h, n, bin_size=s.bin_size,
            hash_functions=s.hash_funs, out=loop, cols=s.cols)
    desc = q.sub_descriptors(rsubs)
    assert desc.device == h.device
    before = kernels.LAUNCHES["count_raptor"]
    got = q.raptor_target_counts(rsubs, h, n, num_targets=T, desc=desc)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["count_raptor"] == before + 1
    want = q.raptor_target_counts_plain(rsubs, h, n, num_targets=T)
    assert torch.equal(got, loop) and torch.equal(got, want)
    untouched = sorted(set(range(T)) - {int(c) for *_, cs in subs
                                        for c in cs})
    assert untouched and (got[:, untouched] == 0).all()
    assert (got[:, 5] > 0).any()
    # a second call into fresh memory, and the descriptors made in the call
    again = q.raptor_target_counts(rsubs, h, n, num_targets=T)
    assert torch.equal(again, want)
    assert q.raptor_target_counts(rsubs, h[:0], n[:0],
                                  num_targets=T).shape == (0, T)


def _repack_case(case):
    """(bits u32 [R, W], bin_to_target, T) of a repack edge shape."""
    rng = np.random.default_rng(sum(map(ord, case)))
    R = {"rows_63": 63, "rows_65": 65, "one_row": 1}.get(case, 300)
    if case in ("one_bin", "rows_63", "rows_65", "one_row"):
        T = 1024  # db's shape: one bin a target, 8x padding
        b2t = np.arange(T, dtype=np.int32)
    elif case == "wide":  # the wide filter's 2188-word rows
        T = 70_000
        b2t = np.full(2188 * 32, T, dtype=np.int32)
        b2t[:T] = np.arange(T)
    elif case in ("uneven", "shuffled", "dropped"):
        T = 300
        widths = rng.integers(0 if case == "dropped" else 1, 41, size=T)
        n = int(widths.sum())
        b2t = np.full(-(-n // 32) * 32 + 32, T, dtype=np.int32)
        b2t[:n] = np.repeat(np.arange(T), widths)
        if case == "shuffled":
            b2t = rng.permutation(b2t)
        if case == "dropped":
            b2t[rng.random(len(b2t)) < 0.2] = T
    elif case == "w8_odd":
        T = 5
        b2t = np.full(32, T, dtype=np.int32)
        b2t[:T] = np.arange(T)
    elif case == "two_words":  # a 64-bin forest or raptor sub
        T = 64
        b2t = np.arange(T, dtype=np.int32)
    elif case == "three_words":  # uneven targets over 3-word rows
        T = 40
        b2t = np.full(96, T, dtype=np.int32)
        cuts = np.sort(rng.choice(np.arange(1, 90), T - 1, replace=False))
        b2t[:90] = np.repeat(np.arange(T), np.diff(np.r_[0, cuts, 90]))
    elif case == "cross_words":  # 20 bins a target from bin 5: runs cut
        T = 30                   # at source-word edges
        b2t = np.full(640, T, dtype=np.int32)
        b2t[5:605] = np.repeat(np.arange(T), 20)
    elif case == "shuffled_wide":  # tiles name words all over 2188
        T = 2000
        b2t = np.full(2188 * 32, T, dtype=np.int32)
        b2t[:T] = np.arange(T)
        b2t = rng.permutation(b2t)
    else:
        raise KeyError(case)
    bits = rng.integers(0, 2**32, size=(R, len(b2t) // 32), dtype=np.uint32)
    return bits, b2t, T


@pytest.mark.parametrize("case", ["one_bin", "rows_63", "rows_65", "one_row",
                                  "wide", "uneven", "shuffled", "dropped",
                                  "w8_odd"])
def test_repack_kernel_matches_plain(cuda, case):
    """The whole table and column windows (2, 4 and 8 shards, one past
    the table) against the plain version on the same card tensors, into
    memory the allocator last held garbage in (the kernel stores every
    word); one launch a call."""
    bits, b2t, T = _repack_case(case)
    plan = q.repack_plan(b2t, T)
    dbits = q.bits_tensor(bits).to(cuda)
    windows = [(0, None), (plan.W8p, 8)]
    for nb in (2, 4, 8):
        ws = -(-plan.W8p // (4 * nb)) * 4
        windows += [(j * ws, ws) for j in range(nb)]
    for c0, width in windows:
        junk = torch.full((len(bits) * plan.W8p + 4096,), 0xA5,
                          dtype=torch.uint8, device=cuda)
        del junk
        before = kernels.LAUNCHES["repack"]
        got = q.repack_table(dbits, plan, c0=c0, width=width)
        want = q.repack_table_plain(dbits, plan, c0=c0, width=width)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["repack"] == before + 1
        assert got.shape == want.shape and torch.equal(got, want), (c0, width)
    cpu = q.repack_table(q.bits_tensor(bits), plan)
    assert torch.equal(q.repack_table(dbits, plan).cpu(), cpu)


def _repack_windows(plan):
    """The whole table, one window past it, and the windows of 2, 3, 4
    and 8 shards (3 cuts most tables off the 16-byte grid)."""
    windows = [(0, None), (plan.W8p, 8)]
    for nb in (2, 3, 4, 8):
        ws = -(-plan.W8p // (4 * nb)) * 4
        windows += [(j * ws, ws) for j in range(nb)]
    return windows


@pytest.mark.parametrize("case", ["two_words", "three_words", "view_off_16",
                                  "below_a_stage", "stage_plus_one",
                                  "cross_words", "shuffled_wide"])
def test_repack_kernel_edge_cases(cuda, case):
    """Source rows of 2 and 3 words; a view of 3-word rows one row in (12
    bytes past a 16-byte boundary); fewer rows than one ring stage holds,
    and one row past three stages; runs cut at source-word edges; a
    shuffled wide layout whose column tiles name more words than a stage
    holds (read in place). Each window against the plain version on the
    same card tensors, into memory last filled with garbage, one launch
    a call."""
    layout = {"view_off_16": "three_words", "below_a_stage": "one_bin",
              "stage_plus_one": "one_bin"}.get(case, case)
    bits, b2t, T = _repack_case(layout)
    plan = q.repack_plan(b2t, T)
    W = bits.shape[1]
    if case in ("below_a_stage", "stage_plus_one"):
        rows = q.repack_geometry(plan, 1 << 20, W, 0, plan.W8p // 4).nrb * \
            q._REPACK_ROWS
        R = rows - 5 if case == "below_a_stage" else 3 * rows + 1
        bits = np.random.default_rng(R).integers(0, 2**32, size=(R, W),
                                                 dtype=np.uint32)
    dbits = q.bits_tensor(bits).to(cuda)
    if case == "view_off_16":
        dbits = dbits[1:]
        assert dbits.data_ptr() % 16 == 12 and dbits.is_contiguous()
    R = dbits.shape[0]
    modes = set(q.repack_geometry(plan, R, W, 0, plan.W8p // 4).tiles[:, 7])
    if case == "shuffled_wide":
        assert q.REPACK_DIRECT in modes
    elif case == "cross_words":
        assert (plan.run_len < 20).any() and (plan.run_bit == 0).any()
    for c0, width in _repack_windows(plan):
        junk = torch.full((R * plan.W8p + 4096,), 0xA5, dtype=torch.uint8,
                          device=cuda)
        del junk
        before = kernels.LAUNCHES["repack"]
        got = q.repack_table(dbits, plan, c0=c0, width=width)
        want = q.repack_table_plain(dbits, plan, c0=c0, width=width)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["repack"] == before + 1
        assert got.shape == want.shape and torch.equal(got, want), (c0, width)


def test_repack_kernel_back_to_back_on_two_streams(cuda):
    """200 calls queued back to back, alternating between two streams
    (the ring's copy groups and barriers of many launches in flight at
    once), each equal to the plain version of its window."""
    bits, b2t, T = _repack_case("uneven")
    plan = q.repack_plan(b2t, T)
    dbits = q.bits_tensor(bits).to(cuda)
    windows = _repack_windows(plan)
    want = [q.repack_table_plain(dbits, plan, c0=c0, width=width)
            for c0, width in windows]
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(cuda))
    before = kernels.LAUNCHES["repack"]
    got = []
    for i in range(200):
        with torch.cuda.stream(streams[i % 2]):
            c0, width = windows[i % len(windows)]
            got.append(q.repack_table(dbits, plan, c0=c0, width=width))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["repack"] == before + 200
    for i, g in enumerate(got):
        assert torch.equal(g, want[i % len(windows)]), i


def test_repack_kernel_past_2_31_bytes(cuda):
    """A table past 2^31 bytes (64-bit offsets): 2^20 + 3 rows of 2048
    targets, one bin each; the rows past 2^31 bytes and a sample of the
    rest against the plain version."""
    T, R = 2048, (1 << 20) + 3
    g = torch.Generator(device=cuda).manual_seed(5)
    dbits = torch.randint(-2**31, 2**31 - 1, (R, T // 32), generator=g,
                          dtype=torch.int32, device=cuda)
    plan = q.repack_plan(np.arange(T, dtype=np.int32), T)
    got = q.repack_table(dbits, plan)
    assert got.numel() > 2**31
    rows = torch.cat([torch.arange(0, R, 4099, device=cuda),
                      torch.arange(R - 70, R, device=cuda)])
    want = q.repack_table_plain(dbits[rows].contiguous(), plan)
    torch.cuda.synchronize()
    assert torch.equal(got[rows], want)
    del got
    torch.cuda.empty_cache()


def test_repack_launch_failure_raises(cuda):
    """A plan the C entry refuses (its map not whole u32 words of
    destination bits) raises on the launch; nothing falls back."""
    bits, b2t, T = _repack_case("uneven")
    plan = q.repack_plan(b2t, T)
    bad = dataclasses.replace(plan, src_of_dst=plan.src_of_dst[:-8])
    dbits = q.bits_tensor(bits).to(cuda)
    before = kernels.LAUNCHES["repack"]
    with pytest.raises(RuntimeError, match="repack"):
        q.repack_table(dbits, bad)
    assert kernels.LAUNCHES["repack"] == before
    with pytest.raises(ValueError, match="whole u32 words"):
        q.repack_table(dbits, plan, c0=2)


def test_filter_loads_on_cuda_never_repack_on_the_host(cuda, tmp_path,
                                                       monkeypatch):
    """Flat, forest and raptor loads on the card, alone and on a mesh of
    views of the card, with the host repacks (``pack_table_u8`` and the
    plain repack) made to raise: each load launches ``repack`` and its
    tables equal the same load's on the CPU."""
    from ganon_tpu_torch.index.builder import _HashExtractor
    from ganon_tpu_torch.index.hibf import build_hibf
    from ganon_tpu_torch.index.ibf import build_ibf
    from ganon_tpu_torch.parallel.mesh import Mesh
    from raptor_layout import write_raptor_layout

    rng = np.random.default_rng(21)
    sizes = (1500, 1700, 2500, 3000, 6000, 7000, 16000, 60000)
    genomes = {f"T{t}": rng.integers(0, 4, size=n, dtype=np.uint8)
               for t, n in enumerate(sizes)}
    ex = _HashExtractor(19, 31, device="cpu")
    for t, gn in genomes.items():
        ex.add_encoded(t, gn)
    th = ex.finish()
    paths = {"flat": str(tmp_path / "db.ibf"),
             "forest": str(tmp_path / "f.hibf"),
             "raptor": str(tmp_path / "r.hibf")}
    build_ibf(th, kmer_size=19, window_size=31, device="cpu").save_raw(
        paths["flat"])
    build_hibf(th, kmer_size=19, window_size=31, max_fp=0.05,
               device="cpu").save(paths["forest"])
    names = sorted(th)
    write_raptor_layout(th, [(names[:3], [1]), (names[3:], [])],
                        paths["raptor"], kmer_size=19, window_size=31,
                        device="cpu")

    def tables(f):
        subs = getattr(f, "subs", [f])
        out = []
        for s in subs:
            if s.tbl8 is not None:
                out.append([s.tbl8.cpu()])
            else:
                out.append([sh.tbl8.cpu() for row in s.table.shards
                            for sh in row])
        return out

    c0 = torch.device("cuda", torch.cuda.current_device())
    cpu = torch.device("cpu")
    want = {}
    for key, path in paths.items():
        for m in (None, (2, 2)):
            mesh = m and Mesh([[cpu] * 2] * 2)
            want[key, m] = tables(dev._open_filter(path, cpu, mesh))

    def refuse(*a, **k):
        raise AssertionError("a host repack ran on a card load")

    monkeypatch.setattr(q, "repack_table_plain", refuse)
    monkeypatch.setattr(q, "pack_table_u8", refuse)
    for key, path in paths.items():
        for m in (None, (2, 2)):
            mesh = m and Mesh([[c0] * 2] * 2)
            before = kernels.LAUNCHES["repack"]
            f = dev._open_filter(path, c0, mesh)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["repack"] > before, (key, m)
            got = tables(f)
            assert len(got) == len(want[key, m])
            for a, b in zip(got, want[key, m]):
                assert all(torch.equal(x, y) for x, y in zip(a, b)), (key, m)
