"""The five CUDA kernels against their plain torch versions, on the card.

Edge shapes beyond the main path: windows of one k-mer, k = 32, long
reads, overflowing compaction, table rows spanning several count tiles,
more hashes than one shared-memory chunk, wide target sets and large K;
count into a column range of a wider matrix (forest mode), merge with
ties and with a one-target filter, select with winners at K = 1 and
K = T.
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
from ganon_tpu_torch.ops import ibf_query as q

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
