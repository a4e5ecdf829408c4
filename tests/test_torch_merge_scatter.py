"""The level merge (K13) and the pruned build's flush (K16): the port
against ``ganon_tpu``.

``merge`` takes a level's filters at once, through the inverse column map
(``merge_colmap``), and writes every union entry: its plain version, fed
the port's per-filter counts, gives the union counts and winners of
``ganon_tpu.classify.device.classify_batch_packed_multi`` (read back from
the JAX buffer at K = U with every kept entry final), exactly, at 1, 2, 3
and 20 filters (20 is past ``MERGE_MAX_FILTERS``, the kernel's filters a
launch), with ties between filters, a one-target filter, reads without
hashes and over the hashes limit, and a union whose width is not a
multiple of 4; the whole buffers are equal too.

``scatter_pruned`` takes a flush as runs, one a target ``(start, group,
lane)``: its plain version sets the tables of JAX's jitted pruned scatter
(``_pruned_scatter_jit`` through ``_device_scatter_table``, per-pair
arrays), byte for byte once its tables (staged by word column) are
transposed back, with runs out of group order and 1-3 hash functions on
each table; ``pruned_plan`` (the kernel's slices and run CSR) tiles the
rows of every group's word columns, several slices a column included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ganon_tpu  # noqa: F401  (turns on jax x64)
from ganon_tpu.classify import device as jdev
from ganon_tpu.index.ibf import build_ibf as jax_build_ibf
from ganon_tpu.index.pruned import _device_scatter_table
from ganon_tpu_torch.classify import device as tdev
from ganon_tpu_torch.index import pruned as tpruned
from ganon_tpu_torch.index.builder import _HashExtractor
from ganon_tpu_torch.index.ibf import IBF
from ganon_tpu_torch.ops.ibf_query import clz64
from tests.test_torch_device import _batch

K, W = 19, 31


def _level(seed, n_filters):
    """``n_filters`` flat filters over a pool of named genomes: ``S`` in
    every filter (the same genome: ties), ``V`` a variant genome of its
    own in each filter that holds it (a later filter can win), filter 1
    a one-target filter, the rest random subsets. Returns the reads'
    genomes, JAX's and the port's filters, the union and the columns."""
    rng = np.random.default_rng(seed)

    def genome(n=2000):
        return rng.integers(0, 4, size=n, dtype=np.uint8)

    pool = {name: genome() for name in "SABCDEXY"}
    sets = [["S", "A", "B", "V", "E"], ["S"], ["C", "V", "S", "D"]]
    for _ in range(3, n_filters):
        sets.append(["S", *rng.choice(list("ABCDEXYV"), size=int(
            rng.integers(1, 5)), replace=False)])
    sets = sets[:n_filters]
    genomes, jfs, tfs, union, cols = [], [], [], [], []
    for f, names in enumerate(sets):
        ex = _HashExtractor(K, W, device="cpu")
        for t in names:
            g = (np.concatenate([pool["S"][:1000], genome(1000)])
                 if t == "V" else pool[t])
            ex.add_encoded(t, g)
            genomes.append(g)
        ibf = jax_build_ibf(ex.finish(), kmer_size=K, window_size=W,
                            max_fp=(0.05, 0.01, 0.2)[f % 3])
        jfs.append(jdev.DeviceFilter(ibf))
        tfs.append(tdev.DeviceFilter(IBF.from_arrays(
            ibf.bits, ibf.ibf_config.to_dict(), ibf.hashes_count,
            ibf.bin_map), "cpu"))
        c = []
        for t in ibf.targets():
            if t not in union:
                union.append(t)
            c.append(union.index(t))
        cols.append(np.asarray(c, np.int32))
    return np.stack(genomes), jfs, tfs, union, cols


@pytest.mark.parametrize("n_filters", [1, 2, 3, 20])
def test_level_merge_matches_jax_union(n_filters):
    genomes, jfs, tfs, union, cols = _level(31 + n_filters, n_filters)
    U = len(union)
    assert U % 4 and (n_filters < 20 or n_filters > tdev.MERGE_MAX_FILTERS)
    rng = np.random.default_rng(n_filters)
    batch = _batch(rng, genomes, 160, True, W)
    batch.len1[6:8] = batch.len2[6:8] = 0  # two reads without hashes
    batch.codes1[6:8] = batch.codes2[6:8] = 0
    inbuf, L1, L2 = jdev.pack_batch_direct(batch, 160)
    h, n, _ = tdev._extract_compact(torch.from_numpy(inbuf), k=K, w=W,
                                    L1=L1, L2=L2)
    # reads without hashes, and over the limit
    limit = int(np.median(n.numpy()))
    assert (n == 0).any() and (n > limit).any()
    rel_cutoffs = list(np.linspace(0.1, 0.6, n_filters))
    want = np.asarray(jdev.classify_batch_packed_multi(
        tuple(f.tbl8 for f in jfs), tuple(f.byte_starts for f in jfs),
        tuple(f.byte_ends for f in jfs),
        tuple(jnp.asarray(c) for c in cols), jnp.asarray(inbuf),
        jnp.asarray(rel_cutoffs, dtype=jnp.float64), 1.0, limit, k=K, w=W,
        L1=L1, L2=L2,
        sub_params=tuple((f.ibf_config.bin_size_bits,
                          f.ibf_config.hash_functions) for f in jfs),
        num_union=U, top_k=U, match_cap=0, emit_matches_t=True,
    ))
    # with K = U and rel_filter 1 every nonzero union entry is in the
    # list: JAX's union counts and winners (0 and 0 elsewhere)
    res = tdev.unpack_batch_result(want, 160, U, U, has_win=True)
    jc = np.zeros((160, U), np.int32)
    jw = np.zeros((160, U), np.int32)
    for b in range(160):
        m = res["n_matches"][b]
        jc[b, res["top_idx"][b, :m]] = res["top_vals"][b, :m]
        jw[b, res["top_idx"][b, :m]] = res["top_win"][b, :m]
    counts = [f.counts(h, n) for f in tfs]
    uc = torch.full((160, U), -9, dtype=torch.int32)
    uw = torch.full_like(uc, 77)
    tdev.merge(counts, n, rel_cutoffs, limit, tdev.merge_colmap(cols, U),
               uc, uw)
    assert np.array_equal(uc.numpy(), jc)
    assert np.array_equal(uw.numpy(), jw)
    if n_filters > 1:
        # S is the same genome in every filter: a read of it ties at n,
        # and the first filter keeps it
        s, nn = union.index("S"), n.numpy()
        tie = jc[:, s] == nn
        assert tie.any() and not jw[tie, s].any()
    if n_filters > 2:
        assert jw.max() > 0  # a later filter's variant wins somewhere
    assert not jc[(n.numpy() == 0) | (n.numpy() > limit)].any()
    got = tdev.classify_batch_packed_multi(
        tfs, tdev.merge_colmap(cols, U), torch.from_numpy(inbuf),
        rel_cutoffs, 1.0, limit, k=K, w=W, L1=L1, L2=L2, num_union=U,
        top_k=U, emit_matches_t=True)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("split", [1, 2, 5])
def test_level_merge_in_parts_equals_one_merge(split):
    """A level merged in two calls, the second from f0 = split into what
    the first wrote (as classify_batch_packed_multi merges each launch's
    filters after their counts), equals one merge of every filter."""
    rng = np.random.default_rng(split)
    B, U, F = 40, 23, 6
    n = torch.from_numpy(rng.integers(0, 30, size=B).astype(np.int32))
    cols = [rng.permutation(U)[:int(rng.integers(1, U + 1))]
            for _ in range(F)]
    colmap = tdev.merge_colmap(cols, U)
    counts = [torch.minimum(torch.from_numpy(rng.integers(
        0, 30, size=(B, len(c))).astype(np.int32)), n[:, None])
        for c in cols]
    rcs = list(rng.random(F) * 0.5)
    want = [torch.empty((B, U), dtype=torch.int32) for _ in range(2)]
    tdev.merge(counts, n, rcs, 25, colmap, *want)
    got = [torch.full((B, U), -3, dtype=torch.int32) for _ in range(2)]
    tdev.merge(counts[:split], n, rcs[:split], 25, colmap, *got)
    tdev.merge(counts[split:], n, rcs[split:], 25, colmap, *got, f0=split)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (want[1] >= split).any() and want[0].any()
    with pytest.raises(ValueError):  # filters past the map's rows
        tdev.merge(counts[split:], n, rcs[split:], 25, colmap, *got,
                   f0=split + 1)


def test_merge_colmap_refuses_repeats_and_range():
    with pytest.raises(ValueError):
        tdev.merge_colmap([[0, 1, 1]], 3)
    with pytest.raises(ValueError):
        tdev.merge_colmap([[0, 3]], 3)
    m = tdev.merge_colmap([[2, 0], [1]], 3)
    assert m.tolist() == [[1, -1, 0], [-1, 0, -1]]


def _flush(seed, G, gs, n_runs):
    """A flush of ``n_runs`` target runs over ``G`` groups of ``gs`` lanes,
    in no group order (a group's runs apart, empty runs), with the
    groups' bin sizes and row offsets and the coarse bin size."""
    rng = np.random.default_rng(seed)
    bsz = rng.integers(64, 3000, size=G).astype(np.int64)
    bsz[0] = 9000  # past a slice at small slices
    off = np.concatenate([[0], np.cumsum(bsz)[:-1]]).astype(np.int64)
    sizes = rng.integers(0, 400, size=n_runs)
    sizes[3] = 0
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    runs = np.stack([starts, rng.integers(0, G, size=n_runs),
                     rng.integers(0, gs, size=n_runs)], axis=1)
    runs[:4, 1] = [2, 0, 2, 0]
    hashes = rng.integers(0, 2**64, size=int(sizes.sum()), dtype=np.uint64)
    hashes[-50:] = hashes[:50]  # duplicates
    return runs, hashes, bsz, off, 4000


def _jax_table(rows, width, hashes, bsz, off, bit, h):
    """JAX's jitted pruned scatter of per-pair arrays, as its device build
    calls it (row widths padded to x4 bytes, sliced back)."""
    w4 = width + (-width % 4)
    chunk = (hashes, bsz.astype(np.uint32),
             np.asarray([clz64(int(b)) for b in bsz], np.uint32),
             off.astype(np.uint32), bit.astype(np.uint32))
    return _device_scatter_table(rows, w4, iter([chunk]), h)[:, :width]


@pytest.mark.parametrize("fine_h,coarse_h", [(1, 1), (2, 3), (3, 2)])
def test_scatter_pruned_runs_match_jax(fine_h, coarse_h):
    G, gs = 11, 40  # 5 bytes a row: padded to 8
    runs, hashes, bsz, off, Rc = _flush(fine_h * 10 + coarse_h, G, gs, 60)
    R, Wf, Wc = int(bsz.sum()), gs // 8, -(-G // 8)
    # the tables staged by word column
    fine_t = torch.zeros((2, R), dtype=torch.int32)
    coarse_t = torch.zeros((1, Rc), dtype=torch.int32)
    tpruned.scatter_pruned(fine_t, coarse_t, torch.from_numpy(
        hashes.view(np.int64)), runs, grp_bin_size=bsz, grp_row_off=off,
        fine_h=fine_h, coarse_h=coarse_h)
    sizes = np.diff(np.append(runs[:, 0], len(hashes)))
    grp = np.repeat(runs[:, 1], sizes)
    lane = np.repeat(runs[:, 2], sizes)
    want_f = _jax_table(R, Wf, hashes, bsz[grp], off[grp], lane, fine_h)
    want_c = _jax_table(Rc, Wc, hashes, np.full(len(grp), Rc),
                        np.zeros(len(grp), np.int64), grp, coarse_h)
    got_f = fine_t.t().contiguous().numpy().view(np.uint8).reshape(
        R, -1)[:, :Wf]
    got_c = coarse_t.t().contiguous().numpy().view(np.uint8).reshape(
        Rc, -1)[:, :Wc]
    assert np.array_equal(got_f, want_f) and want_f.any()
    assert np.array_equal(got_c, want_c) and want_c.any()


@pytest.mark.parametrize("slice_bytes,max_slices,share", [
    (64, 10**9, 1), (4096, 10**9, 1), (tpruned.SLICE_BYTES, 10**9, 1),
    (4096, None, None), (1024, None, None), (tpruned.SLICE_BYTES, 10**9, 12)])
def test_pruned_plan_tiles_every_group(monkeypatch, slice_bytes, max_slices,
                                       share):
    """The kernel's slices cover the rows of each (group, word column) a
    run names, in order, with that pair's runs (and no empty run) in its
    span of the run CSR; a column that would need more than
    MAX_COLUMN_SLICES slices, or holds more than 1 / COLUMN_SHARE of the
    flush's hashes, has none, and its runs carry its group's fine bin
    size and first row for the coarse blocks instead."""
    monkeypatch.setattr(tpruned, "SLICE_BYTES", slice_bytes)
    if max_slices:
        monkeypatch.setattr(tpruned, "MAX_COLUMN_SLICES", max_slices)
        monkeypatch.setattr(tpruned, "COLUMN_SHARE", share)
    max_slices, share = tpruned.MAX_COLUMN_SLICES, tpruned.COLUMN_SHARE
    runs, hashes, bsz, off, _ = _flush(5, 7, 64, 40)
    N = len(hashes)
    meta, nr, nfb, srows = tpruned.pruned_plan(runs, N, bsz, off, 2)
    assert srows == slice_bytes // 4
    sizes = np.diff(np.append(runs[:, 0], N))
    live, sizes = runs[sizes > 0], sizes[sizes > 0]
    assert nr == len(live)
    start, grp = meta[:nr + 1], meta[nr + 1:2 * nr + 1]
    lane, order = meta[2 * nr + 1:3 * nr + 1], meta[3 * nr + 1:4 * nr + 1]
    fbsz, foff = meta[4 * nr + 1:5 * nr + 1], meta[5 * nr + 1:6 * nr + 1]
    assert start[-1] == N and np.array_equal(start[:-1], live[:, 0])
    assert np.array_equal(grp, live[:, 1]) and np.array_equal(lane, live[:, 2])
    sl = meta[6 * nr + 1:].reshape(nfb, 8)
    col = live[:, 2] >> 5
    by_atomic = np.zeros(nr, dtype=bool)
    for g, c in {(g, c) for g, c in zip(live[:, 1], col)}:
        mine = sl[((sl[:, 3] - sl[:, 1]) == off[g]) & (sl[:, 6] == c)]
        runs_gc = (live[:, 1] == g) & (col == c)
        if (-(-bsz[g] // srows) > max_slices
                or sizes[runs_gc].sum() * share > N):
            assert not len(mine)
            by_atomic |= runs_gc
            continue
        assert (mine[:, 0] == bsz[g]).all()
        assert mine[0, 1] == 0 and (mine[:, 2] <= srows).all()
        assert np.array_equal(mine[1:, 1], mine[:-1, 1] + mine[:-1, 2])
        assert mine[-1, 1] + mine[-1, 2] == bsz[g]
        lo, hi = mine[0, 4], mine[0, 5]
        assert sorted(order[lo:hi]) == list(np.flatnonzero(runs_gc))
    assert np.array_equal(fbsz, np.where(by_atomic, bsz[grp], 0))
    assert np.array_equal(foff, np.where(by_atomic, off[grp], 0))
    if share == 1 and max_slices > 10**6:
        assert not by_atomic.any()
        if slice_bytes == 64:  # a column over several slices
            assert (sl[:, 0] == 9000).sum() > 2
    else:  # columns on both sides
        assert by_atomic.any() and not by_atomic.all()
