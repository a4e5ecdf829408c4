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
1, one block and many blocks, all-equal values, values >= 2^63, one file
and 2^16 files; pack with empty rows; dedup with files that have no
entries; scatter in ranked mode with a target over several bins at h = 1
and 5; the whole pipeline and run_build on the card against the CPU.
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
    got = q.target_counts(*args, bin_size=R, hash_functions=hf)
    want = q.bulk_target_counts(*args, bin_size=R, hash_functions=hf)
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
    q.target_counts(*args, bin_size=R, hash_functions=2, out=got, col0=col0)
    q.bulk_target_counts(*args, bin_size=R, hash_functions=2, out=want,
                         col0=col0)
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
        q.target_counts(*args, bin_size=bin_size, hash_functions=hf,
                        out=got, cols=c)
        q.bulk_target_counts(*args, bin_size=bin_size, hash_functions=hf,
                             out=want, cols=c)
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
        got = q.target_counts(*args, bin_size=700, hash_functions=hf)
        want = q.bulk_target_counts(*args, bin_size=700, hash_functions=hf)
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


def _entries(rng, N, R, equal=False, high=False):
    key = rng.integers(0, R, size=N).astype(np.int32)
    val = rng.integers(0, 1 << 64, size=N, dtype=np.uint64)
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
    (200_000, 1 << 16, False, False),
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
