"""The CUDA kernels against their plain torch versions, on the card.

Edge shapes beyond the main path: windows of one k-mer, k = 32, long
reads, overflowing compaction, table rows spanning several count tiles,
more hashes than one shared-memory chunk, wide target sets and large K;
count into a column range of a wider matrix (forest mode), merge with
ties and with a one-target filter, select with winners at K = 1 and
K = T; select in its 32-bit mode at B = 0, T = 65,536 and 65,537,
counts at 2^31 - 1 and with every or no target final. The pruned
forest's modes: gate, fine (dense and probe-all),
select in lanes mode and scatter in pruned mode, at group counts that
are not multiples of 8 or 32 (and past one gate counter tile), group
size 16 (padded rows), a partly full last group, ties, reads with no
survivor, exactly S and more than S survivors, reads without hashes and
reads at the hashes limit. Count in column-max mode (raptor subs): a
target over three tiles, h = 1 and 5 in one layout, a one-target sub, a
user bin in two subs with equal and unequal counts, a column no sub
writes; the raptor batch on the card against the CPU; build_pruned's
default build on the card. The two-pass build's kernels: sort at N = 0,
1, one block, one entry past a block and up to ~4000 blocks (the
look-back spans more blocks than the card has SMs), all-equal values,
values >= 2^63, one file and 2^16 files, and its digit histograms and
pass plan (38-bit values, every digit constant); pack with empty rows;
dedup with files that have no entries; scatter in ranked mode with a
target over several bins at h = 1 and 5; the whole pipeline and
run_build on the card against the CPU.
The device mesh's modes (K17): count in shard mode and combine with a
target over three shards and with one shard (equal to the flat count),
combine in column-max mode, fine in shard mode over a shard of pad
groups only, and the ranked scatter in span mode with every entry
outside the span; a mesh of the card and the CPU, so inputs and partials
cross devices. The ops library (K18): minimizers at L not a multiple of
4 and past max_minimizers, bins with a row wider than a block and with
M = 0, tsum with ids out of range and past its shared-memory width,
bins_target with and without a permutation; the ragged stream at a cap
of 1, inside the first block, overflowing and exact caps (winners,
group words) over up to 274 blocks, each call twice on the stream's
status buffer; pairs with every read
spilling; probe_sort with equal keys; the gather probe; the transfer
settings (ragged, pair caps, sort_probes) on the card against the CPU.
The tiled extract at the build's shape, over many 512-window tiles, at
B 1, with short mates, w == k, k 32 and runs of one base, with and
without the zero tail; pairs over 274 blocks at S 1-9 and on rows off
word alignment; ragged, extract and pairs sharing one stream's status
words, and a second stream's. Extract's wide-window route at the widest
window the tiles hold and one past it (k 19 and 32), paired and
single-end; select in every mode with 2048 and 2049 kept entries (the
list's capacity and the passes over the row), T % 4 != 0 and K past and
below the finals; count at rows of 1 to 256 words, h 1-5, in flat,
forest, shard and column-max modes; every raptor sub in one launch
against one launch a sub.
Each test skips on a host without CUDA (the kernels have no CPU mode);
on the H100 run ``python -m pytest --noconftest tests/test_torch_cuda.py -q``
(the suite's ``conftest.py`` imports jax, which that machine lacks).
"""

import numpy as np
import pytest
import torch

from ganon_tpu_torch import kernels
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
    R, W, N = 5003, 6, 20000
    hashes = rng.integers(-2**63, 2**63 - 1, size=N)
    hashes[N // 2:] = hashes[: N // 2]  # duplicate pairs
    h = torch.from_numpy(hashes).to(cuda)
    bins = torch.from_numpy(rng.integers(0, W * 32, size=N).astype(np.int32)).to(cuda)
    a = torch.zeros((R, W), dtype=torch.int32, device=cuda)
    b = torch.zeros_like(a)
    before = kernels.LAUNCHES["scatter"]
    scatter_hashes(a, h, bins, bin_size=R, hash_functions=hf)
    _scatter_bits(b, h, bins, bin_size=R, hash_functions=hf)
    assert kernels.LAUNCHES["scatter"] == before + 1
    assert torch.equal(a, b)


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


def test_merge_kernel_matches_plain(cuda):
    """Three filters in order: a tie with an earlier filter keeps it, a
    one-target filter, cutoffs, invalid reads and an over-limit read."""
    rng = np.random.default_rng(3)
    B, U = 300, 50
    n = rng.integers(0, 60, size=B).astype(np.int32)
    n[:3] = [0, 70, 1]
    colss = [rng.permutation(U)[:40], np.array([7]), rng.permutation(U)[:25]]
    base = np.minimum(rng.integers(0, 60, size=(B, U)), n[:, None])
    got_c = torch.zeros((B, U), dtype=torch.int32, device=cuda)
    got_w, want_c, want_w = (torch.zeros_like(got_c) for _ in range(3))
    nn = torch.from_numpy(n).to(cuda)
    for f, (cols, rc) in enumerate(zip(colss, (0.2, 0.5, 0.0))):
        c = base[:, cols].copy()  # ties: every filter reads the same base
        c[rng.random(c.shape) < 0.3] += 1
        c = np.minimum(c, n[:, None]).astype(np.int32)
        c_d = torch.from_numpy(c).to(cuda)
        cols_d = torch.from_numpy(cols.astype(np.int32)).to(cuda)
        dev.merge(c_d, nn, rc, 65, cols_d, f, got_c, got_w)
        dev.merge_plain(c_d, nn, rc, 65, cols_d, f, want_c, want_w)
        torch.cuda.synchronize()
        assert torch.equal(got_c, want_c) and torch.equal(got_w, want_w)
    assert (got_w == 1).any() and (got_w == 2).any()


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


@pytest.mark.parametrize("G,S,hf", [(37, 2, 2), (200, 3, 1), (9001, 4, 1)])
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


def test_gate_kernel_ties(cuda):
    """Every group's coarse bit set in every row: all survivors tie, and
    the slots take the lowest group ids."""
    G, R, B, M = 45, 64, 40, 30
    ctbl = torch.full((R, 8), 0xFF, dtype=torch.uint8, device=cuda)
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, size=(B, M))).to(cuda)
    n = torch.full((B,), M, dtype=torch.int32, device=cuda)
    kw = dict(coarse_bin_size=R, coarse_h=1, num_groups=G, rel_cutoff=0.5,
              hashes_limit=65535, max_groups=3)
    got = pq.gate(ctbl, h, n, **kw)
    want = pq.gate_plain(ctbl, h, n, **kw)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert (got[0] == torch.tensor([0, 1, 2], device=cuda)).all()


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


@pytest.mark.parametrize("G,gs,hf", [(13, 16, 2), (70, 64, 1)])
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


@pytest.mark.parametrize("hf", [1, 3])
def test_scatter_pruned_kernel_matches_plain(cuda, hf):
    """Fine mode (a parameter set per group, the lane as the bit) and
    coarse mode (one set of all rows, the group as the bit), duplicates
    included."""
    rng = np.random.default_rng(hf)
    G, gs, N = 11, 16, 30000
    bsz = rng.integers(64, 900, size=G).astype(np.int64)
    off = np.concatenate([[0], np.cumsum(bsz)[:-1]]).astype(np.int64)
    shift = np.array([q.clz64(int(b)) for b in bsz], np.int32)
    hashes = rng.integers(-2**63, 2**63 - 1, size=N)
    hashes[N // 2:] = hashes[: N // 2]
    grp = rng.integers(0, G, size=N).astype(np.int32)
    lane = rng.integers(0, gs, size=N).astype(np.int32)
    h, g, j = (torch.from_numpy(x).to(cuda) for x in (hashes, grp, lane))
    fine = (torch.from_numpy(bsz).to(cuda), torch.from_numpy(shift).to(cuda),
            torch.from_numpy(off).to(cuda))
    Rc = 4000
    coarse = (torch.tensor([Rc], dtype=torch.int64, device=cuda),
              torch.tensor([q.clz64(Rc)], dtype=torch.int32, device=cuda),
              torch.zeros(1, dtype=torch.int64, device=cuda))
    for R, W, gg, bit, params in ((int(bsz.sum()), 1, g, j, fine),
                                  (Rc, 1, None, g, coarse)):
        a = torch.zeros((R, W), dtype=torch.int32, device=cuda)
        b = torch.zeros_like(a)
        before = kernels.LAUNCHES["scatter_pruned"]
        scatter_pruned(a, h, gg, bit, *params, hf)
        scatter_pruned_plain(b, h, gg, bit, *params, hf)
        assert kernels.LAUNCHES["scatter_pruned"] == before + 1
        assert torch.equal(a, b) and a.any()


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


@pytest.mark.parametrize("N,R", [(0, 4), (10_000, 40), (123_457, 1000)])
def test_dedup_kernel_matches_plain(cuda, N, R):
    """Files with no entries keep count 0; ranks scan every entry."""
    rng = np.random.default_rng(N + R)
    key, val = _entries(rng, N, R // 2)  # half the files have nothing
    kb = R.bit_length()
    sk, sv = bo.sort_entries(key, val, key_bits=kb)
    want_c = torch.zeros(R, dtype=torch.int32)
    want = bo.dedup(sk, sv, num_files=R, counts=want_c)
    dk, dv = _to(cuda, sk, sv)
    got_c = torch.zeros(R, dtype=torch.int32, device=cuda)
    got = bo.dedup(dk, dv, num_files=R, counts=got_c)
    no_rank = bo.dedup(dk, dv, num_files=R, want_rank=False)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got_c.cpu(), want_c)
    assert no_rank[1] is None and torch.equal(no_rank[0].cpu(), want[0])
    assert (want_c[R // 2:] == 0).all()


@pytest.mark.parametrize("hf,mhb", [(1, 50), (5, 400), (3, 100_000)])
def test_scatter_ranked_kernel_matches_plain(cuda, hf, mhb):
    """Targets of two files each, split over bins of mhb hashes."""
    rng = np.random.default_rng(hf)
    R, N, bin_size = 64, 60_000, 20_011
    key, val = _entries(rng, N, R)
    sk, sv = bo.sort_entries(key, val, key_bits=6)
    counts = torch.zeros(R, dtype=torch.int32)
    uniq, rank = bo.dedup(sk, sv, num_files=R, counts=counts)
    c = counts.numpy()
    params = np.zeros((4, R), dtype=np.int32)
    binno = 0
    for f in range(0, R, 2):
        tot = int(c[f] + c[f + 1])
        nb = -(-tot // mhb) if tot else 0
        nhb = min(-(-tot // nb), mhb) if nb else 1
        params[:3, f], params[:3, f + 1] = (binno, nhb, 0), (binno, nhb, c[f])
        binno += nb
    params[3] = np.concatenate([[0], np.cumsum(c)[:-1]])
    n_words = -(-binno // 32)
    want = torch.zeros((bin_size, n_words), dtype=torch.int32)
    bo.scatter_ranked(want, sk, sv, uniq, rank, torch.from_numpy(params),
                      bin_size=bin_size, hash_functions=hf)
    got = torch.zeros_like(want, device=cuda)
    bo.scatter_ranked(got, *_to(cuda, sk, sv, uniq, rank,
                                torch.from_numpy(params)),
                      bin_size=bin_size, hash_functions=hf)
    torch.cuda.synchronize()
    assert binno > R // 2 or mhb > N  # some target over several bins
    assert torch.equal(got.cpu(), want)


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
    parts = torch.zeros(B * sum(widths), dtype=torch.int32, device=h.device)
    off = 0
    for s, w in zip(sh_list, widths):
        if w:
            fn_count(s.tbl8, s.byte_starts, s.byte_ends, h, n, bin_size=R,
                     hash_functions=hf, out=parts[off:off + B * w].view(B, w),
                     clamp=False)
        off += B * w
    lo, hi = (torch.tensor([getattr(s, a) for s in sh_list], dtype=torch.int32,
                           device=h.device) for a in ("t_lo", "t_hi"))
    out = torch.zeros((B, T), dtype=torch.int32, device=h.device)
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
    got = q.combine(*_to(cuda, parts, lo, hi, n, base), num_targets=T,
                    cols=cols.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("pads_only", [False, True])
def test_fine_shard_matches_plain(cuda, pads_only):
    """A shard of real groups and pad groups, and a shard made only of pad
    groups (it writes nothing)."""
    rng = np.random.default_rng(11)
    G, gs, B, M = 10, 16, 120, 200
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
    """Spans of a ranked scatter: their union is the whole matrix, and a
    span every entry misses stays zero (entries before it dropped, not
    wrapped)."""
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
    d_args = _to(cuda, sk, sv, uniq, rank, params)
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
    tsum with ids out of range, in shared memory and past it
    (T = 13,000); bins_target with and without a permutation, equal to
    target_counts of the per-bin counts."""
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
    """ragged, pairs and extract take their status words from one buffer
    a stream: two pairs calls in a row after a ragged call and an extract
    call of more blocks, then pairs on a second stream (a buffer of its
    own), each equal to its plain version; one launch a pairs call."""
    rng = np.random.default_rng(36)
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
    assert torch.equal(dev.ragged(dense, B, K, 100), want_r)
    got_x = q.extract(inbuf, L1=L1, L2=L2, k=k, w=w, mc=mcs[0])
    before = kernels.LAUNCHES["pairs"]
    for _ in range(2):
        got = pq.pair_live(ok, ovf, cap)
        assert all(torch.equal(a, b) for a, b in zip(got, want_p))
    assert kernels.LAUNCHES["pairs"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got_x, want_x))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = pq.pair_live(ok, ovf, cap)
        got_r = dev.ragged(dense, B, K, 100)
    side.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want_p))
    assert torch.equal(got_r, want_r)
    keys = {key for key in kernels._SCAN_STATUS if key[0] == "cuda"}
    assert len(keys) >= 2


def test_probe_sort_kernel_matches_plain(cuda):
    """probe_sort with equal keys (a hash repeated), n = 0, n past M, M
    not a power of two, and M = 4096."""
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


def test_gather_probe_kernel_matches_plain(cuda):
    """The Pallas probe's port at its own shapes and at a few probes."""
    from ganon_tpu_torch.ops import probe

    rng = np.random.default_rng(36)
    tbl = torch.from_numpy(rng.integers(0, 256, size=(probe.R, 32),
                                        dtype=np.uint8)).to(cuda)
    for n in (5, probe.NPROBE):
        rows = torch.from_numpy(rng.integers(0, probe.R, size=n).astype(
            np.int32)).to(cuda)
        assert torch.equal(probe.gather_probe(tbl, rows),
                           probe.gather_probe_plain(tbl, rows))


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
    hash; 256: the tile walk), h 1-5, more hashes than a shared-memory
    chunk, in flat, forest, shard (clamp off) and column-max modes, equal
    to the plain version; one launch each, under its mode's counter."""
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
        for name in ("count", "count_shard", "count_forest", "count_raptor"):
            assert kernels.LAUNCHES[name] == before[name] + 1, name


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
