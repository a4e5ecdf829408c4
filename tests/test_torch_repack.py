"""The filter load's repack: the port against ``ganon_tpu``.

``ops.ibf_query.repack_plan`` with ``repack_table`` (its plain version on
the CPU) and the port's ``pack_table_u8`` give, byte for byte, the JAX
package's ``pack_table_u8`` + ``table_as_u32`` table and byte ranges on
seeded matrices: one bin a target (db's shape, 8x padding), uneven
widths of 1-40 bins, empty targets, a shuffled ``bin_to_target``,
padding and dropped ids, a raptor sub's map with merged bins, and a W8
that is not a multiple of 4; column windows ``[c0, c0 + ws)`` for 2, 4
and 8 shards equal ``shard_table``'s cut of the JAX-packed table. The
loaders' tables on the CPU (``DeviceFilter``, ``DeviceHIBF``'s subs,
``DeviceRaptorHIBF``'s subs, and the shards of each on a CPU mesh)
equal the JAX loaders' packed tables. All exact (tolerance 0: bytes).
The kernel itself runs in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import ganon_tpu  # noqa: F401  (turns on jax x64)
from ganon_tpu.classify import device as jdev
from ganon_tpu.index.hibf import RaptorHIBF as JaxRaptorHIBF
from ganon_tpu.index.hibf import build_hibf as jax_build_hibf
from ganon_tpu.index.ibf import IBF as JaxIBF
from ganon_tpu.index.ibf import build_ibf as jax_build_ibf
from ganon_tpu.ops import ibf_query as jq
from ganon_tpu_torch.classify import device as tdev
from ganon_tpu_torch.index.builder import _HashExtractor
from ganon_tpu_torch.index.hibf import HIBF, RaptorHIBF
from ganon_tpu_torch.index.ibf import IBF
from ganon_tpu_torch.ops import ibf_query as q
from ganon_tpu_torch.parallel import mesh as pmesh
from raptor_layout import write_raptor_layout

K, W = 19, 31
CPU = torch.device("cpu")


def _uneven(rng, T, lo, hi):
    widths = rng.integers(lo, hi + 1, size=T)
    n = int(widths.sum())
    Wd = -(-max(n, 1) // 32) + 1  # a spare word of padding bins
    b2t = np.full(Wd * 32, T, dtype=np.int32)
    b2t[:n] = np.repeat(np.arange(T), widths)
    return b2t


def _case(name):
    """(bits u32 [R, W], bin_to_target, T) of one layout, seeded."""
    rng = np.random.default_rng(sum(map(ord, name)))
    R = 211
    if name == "one-bin-a-target":
        T = 300
        b2t = np.full(-(-T // 32) * 32, T, dtype=np.int32)
        b2t[:T] = np.arange(T)
    elif name == "uneven-1-40":
        T = 37
        b2t = _uneven(rng, T, 1, 40)
    elif name == "empty-targets":
        T = 29
        widths = rng.integers(0, 12, size=T)
        widths[[0, 7, 8, T - 1]] = 0
        n = int(widths.sum())
        b2t = np.full(-(-n // 32) * 32, T, dtype=np.int32)
        b2t[:n] = np.repeat(np.arange(T), widths)
    elif name == "shuffled":
        T = 33
        b2t = rng.permutation(_uneven(rng, T, 1, 40))
    elif name == "padding-and-dropped":
        T = 41
        b2t = _uneven(rng, T, 1, 20)
        b2t[rng.random(len(b2t)) < 0.2] = T  # dropped bins inside ranges
    elif name == "raptor-merged":
        # a raptor sub: technical bins' file positions (-1: merged or
        # empty), the used positions as local targets, as the loader does
        tb = 5 * 32
        fpos = np.full(tb, -1, dtype=np.int64)
        users = rng.choice(60, size=17, replace=False)
        owner = rng.choice(users, size=120)
        fpos[:120] = owner
        fpos[rng.random(tb) < 0.15] = -1  # merged bins among the users'
        used = np.unique(fpos[fpos >= 0])
        b2t = np.searchsorted(used, fpos).astype(np.int32)
        b2t[fpos < 0] = len(used)
        T = len(used)
    elif name == "w8-not-multiple-of-4":
        T = 5
        b2t = np.full(32, T, dtype=np.int32)
        b2t[:T] = np.arange(T)
    else:
        raise KeyError(name)
    bits = rng.integers(0, 2**32, size=(R, len(b2t) // 32), dtype=np.uint32)
    return bits, b2t, T


CASES = ("one-bin-a-target", "uneven-1-40", "empty-targets", "shuffled",
         "padding-and-dropped", "raptor-merged", "w8-not-multiple-of-4")


def _jax_table(bits, b2t, T):
    """The JAX package's packed table as u32 words (bytes, ``W8p``)."""
    tbl8, bs, be = jq.pack_table_u8(bits, b2t, T)
    return jq.table_as_u32(tbl8).view(np.uint8), tbl8, bs, be


@pytest.mark.parametrize("name", CASES)
def test_repack_matches_jax_pack_table(name):
    bits, b2t, T = _case(name)
    want32, want8, bs, be = _jax_table(bits, b2t, T)
    if name == "w8-not-multiple-of-4":
        assert want8.shape[1] % 4 and want32.shape[1] % 4 == 0
    if name == "empty-targets":
        assert (be == bs).sum() >= 4
    plan = q.repack_plan(b2t, T)
    assert (plan.W8, plan.W8p) == (want8.shape[1], want32.shape[1])
    assert np.array_equal(plan.byte_starts, bs)
    assert np.array_equal(plan.byte_ends, be)
    assert plan.byte_starts.dtype == plan.byte_ends.dtype == np.int32
    src = plan.src_of_dst
    assert src.dtype == np.int32 and len(src) == plan.W8p * 8
    # every kept bin exactly once; dropped ids nowhere
    kept = np.flatnonzero(b2t < T)
    assert np.array_equal(np.sort(src[src >= 0]), kept)
    bt = q.bits_tensor(bits)
    got = q.repack_table(bt, plan)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want32)
    assert torch.equal(q.repack_table_plain(bt, plan), got)
    # the port's host function keeps JAX's outputs
    for a, b in zip(q.pack_table_u8(bits, b2t, T), (want8, bs, be)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("nb", [2, 4, 8])
@pytest.mark.parametrize("name", CASES)
def test_repack_windows_match_shard_cut(name, nb):
    """Column windows of the padded layout equal ``shard_table``'s cut of
    the JAX-packed table, the zero bytes past ``W8p`` included, and
    ``repack_shards`` gives the cut's spans and clipped ranges."""
    bits, b2t, T = _case(name)
    want32, _, bs, be = _jax_table(bits, b2t, T)
    cut = q.shard_table(torch.from_numpy(want32), torch.from_numpy(bs),
                        torch.from_numpy(be), nb)
    plan = q.repack_plan(b2t, T)
    bt = q.bits_tensor(bits)
    ws = cut[0].tbl8.shape[1]
    for c in cut:
        assert torch.equal(q.repack_table(bt, plan, c0=c.c0, width=ws),
                           c.tbl8)
    for s, c in zip(q.repack_shards(bt, plan, nb, [CPU] * nb), cut):
        assert torch.equal(s.tbl8, c.tbl8)
        assert torch.equal(s.byte_starts, c.byte_starts)
        assert torch.equal(s.byte_ends, c.byte_ends)
        assert (s.c0, s.t_lo, s.t_hi) == (c.c0, c.t_lo, c.t_hi)
    # an odd window inside a shard, for the plain version's any-c0 path
    c0, width = 1, max(1, plan.W8p - 3)
    assert np.array_equal(
        q.repack_table_plain(bt, plan, c0=c0, width=width).numpy(),
        np.pad(want32, ((0, 0), (0, 8)))[:, c0:c0 + width])


@pytest.mark.parametrize("rows", [1, 7, None])
def test_plain_repack_chunks_give_one_table(monkeypatch, rows):
    """The plain version's chunking (its byte budget of temporaries: a row,
    seven rows, or the whole matrix a chunk) never changes the table."""
    bits, b2t, T = _case("padding-and-dropped")
    want32 = _jax_table(bits, b2t, T)[0]
    plan = q.repack_plan(b2t, T)
    kept = int((plan.src_of_dst >= 0).sum())
    monkeypatch.setattr(q, "_PLAIN_REPACK_BYTES",
                        16 * kept * (rows or len(bits)))
    got = q.repack_table_plain(q.bits_tensor(bits), plan)
    assert np.array_equal(got.numpy(), want32)


def test_repack_refuses_bad_inputs():
    bits, b2t, T = _case("uneven-1-40")
    plan = q.repack_plan(b2t, T)
    bt = q.bits_tensor(bits)
    with pytest.raises(ValueError, match="whole u32 words"):
        q.repack_table(bt, plan, c0=2, width=8)
    with pytest.raises(ValueError, match="whole u32 words"):
        q.repack_table(bt, plan, width=6)
    with pytest.raises(ValueError, match="int32"):
        q.repack_table(bt.to(torch.int64), plan)
    with pytest.raises(ValueError, match="reads bin"):
        q.repack_table(bt[:, :1].contiguous(), plan)
    with pytest.raises(ValueError, match="32-bit words"):
        q.bits_tensor(bits.astype(np.uint64))
    # a window past the table is all zeros, and no rows give no rows
    assert not q.repack_table(bt, plan, c0=plan.W8p, width=8).any()
    assert q.repack_table(bt[:0], plan).shape == (0, plan.W8p)


def test_bits_tensor_aliases_a_read_only_memmap(tmp_path):
    bits, b2t, T = _case("one-bin-a-target")
    path = tmp_path / "bits.u32"
    bits.tofile(path)
    mm = np.memmap(path, mode="r", dtype=np.uint32, shape=bits.shape)
    bt = q.bits_tensor(mm)
    assert bt.dtype == torch.int32 and np.array_equal(
        bt.numpy().view(np.uint32), bits)
    assert np.array_equal(q.repack_table(bt, q.repack_plan(b2t, T)).numpy(),
                          _jax_table(bits, b2t, T)[0])


# --------------------------------------------------------------------------
# the plan's runs and tile spans, and a numpy walk of the kernel


def _windows(plan, nbs=(2, 4, 8)):
    """The whole table, one window past it, and every window of 2, 4 and
    8 shards, as (c0, width) in bytes."""
    out = [(0, plan.W8p), (plan.W8p, 8)]
    for nb in nbs:
        ws = -(-plan.W8p // (4 * nb)) * 4
        out += [(j * ws, ws) for j in range(nb)]
    return out


def _rebuild(plan):
    """src_of_dst from the runs alone."""
    src = np.full(plan.W8p * 8, -1, dtype=np.int64)
    col = np.repeat(np.arange(len(plan.col_runs) - 1), np.diff(plan.col_runs))
    for c, w, b, d, n in zip(col, plan.run_word, plan.run_bit, plan.run_dst,
                             plan.run_len):
        src[c * 32 + d:c * 32 + d + n] = w * 32 + b + np.arange(n)
    return src


@pytest.mark.parametrize("name", CASES)
def test_runs_and_spans_rebuild_the_map(name):
    """The runs rebuild ``src_of_dst`` exactly; each stays inside one
    source and one destination word, ordered by source word within its
    column; each plan tile's span is the least interval holding its
    runs' words; and each window's tiles of the kernel geometry own every
    column once, hold exactly its columns' runs, and span their words."""
    bits, b2t, T = _case(name)
    plan = q.repack_plan(b2t, T)
    assert np.array_equal(_rebuild(plan), plan.src_of_dst)
    for a in (plan.run_word, plan.run_bit, plan.run_dst, plan.run_len,
              plan.col_runs, plan.tile_lo, plan.tile_hi):
        assert a.dtype == np.int32
    assert (plan.run_len >= 1).all()
    assert (plan.run_bit + plan.run_len <= 32).all()
    assert (plan.run_dst + plan.run_len <= 32).all()
    assert len(plan.col_runs) == plan.W8p // 4 + 1
    # the kernel's form: a run's first source bit rotated onto its first
    # destination bit, its mask the run's bits
    kr = plan.kernel_runs
    assert kr.dtype == np.int32 and kr.shape == (len(plan.run_word), 2)
    assert np.array_equal(kr[:, 0] >> 5, plan.run_word)
    rot = (kr[:, 0] & 31).astype(np.int64)
    first = np.left_shift(1, plan.run_bit.astype(np.int64))
    rotated = ((first >> rot) | (first << ((32 - rot) & 31))) & 0xFFFFFFFF
    mask = kr[:, 1].view(np.uint32).astype(np.int64)
    assert np.array_equal(rotated & mask, 1 << plan.run_dst.astype(np.int64))
    assert np.array_equal(mask >> plan.run_dst,
                          (1 << plan.run_len.astype(np.int64)) - 1)
    col = np.repeat(np.arange(plan.W8p // 4), np.diff(plan.col_runs))
    key = col.astype(np.int64) << 40 | plan.run_word.astype(np.int64) << 5 \
        | plan.run_dst
    assert (np.diff(key) > 0).all()
    tw = q.REPACK_TILE_WORDS
    assert len(plan.tile_lo) == -(-(plan.W8p // 4) // tw)
    for t in range(len(plan.tile_lo)):
        words = plan.run_word[(col >= t * tw) & (col < (t + 1) * tw)]
        want = (words.min(), words.max() + 1) if len(words) else (0, 0)
        assert (plan.tile_lo[t], plan.tile_hi[t]) == want
    R, W = bits.shape
    for c0, width in _windows(plan):
        c0w, wc = c0 // 4, width // 4
        geo = q.repack_geometry(plan, R, W, c0w, wc)
        xa, xb, xd, ra, rb, lo, span, mode = geo.tiles.T
        assert xa[0] == 0 and xb[-1] == wc and (xa[1:] == xb[:-1]).all()
        assert (xd >= xb).all() and (xd <= np.minimum(xb + 3, wc)).all()
        n_cols = plan.W8p // 4
        for t in range(len(xa)):
            cols = np.arange(c0w + xa[t], c0w + xd[t])
            cols = cols[cols < n_cols]
            runs = np.flatnonzero(np.isin(col, cols))
            assert np.array_equal(runs, np.arange(ra[t], rb[t]))
            words = plan.run_word[runs]
            assert (words >= lo[t]).all() and (words < lo[t] + span[t]).all()
            assert (mode[t] == q.REPACK_DIRECT) == (
                not len(runs) or mode[t] == q.REPACK_DIRECT)
        assert geo.desc_cap >= (rb - ra).max()
        assert geo.col_cap >= (xd - xa).max() + 1
        assert geo.cq * geo.nrb <= q._REPACK_THREADS


def _walk(bits, plan, c0, width, off0=0):
    """A numpy walk of ``csrc/repack.cu`` over ``[c0, c0 + width)``: for
    each column tile and row tile, the source words copied into a stage
    of garbage as the kernel stages them (a row segment 16-byte aligned
    as in memory, whole rows, or none: read in place), ``off0`` the
    source pointer's word offset in its 16 bytes; then each thread's
    quad of words over its rows, OR-ing its columns' runs (a rotation and
    a mask each), and its stores (16 bytes where the quad is whole and
    aligned). Returns the table, every word stored exactly once."""
    R, W = bits.shape
    c0w, wc = c0 // 4, width // 4
    flat = bits.reshape(-1).astype(np.uint32)
    out = np.full(R * wc, 0xDEADBEEF, dtype=np.uint32)
    stored = np.zeros(R * wc, dtype=np.int64)
    geo = q.repack_geometry(plan, R, W, c0w, wc)
    n_cols = len(plan.col_runs) - 1
    rot = ((plan.run_bit - plan.run_dst) & 31).astype(np.uint32)
    mask = (((np.uint64(1) << plan.run_len.astype(np.uint64)) - np.uint64(1))
            << plan.run_dst.astype(np.uint64)).astype(np.uint32)
    rows = q._REPACK_ROWS
    rt_rows = geo.nrb * rows
    tid = np.arange(geo.cq * geo.nrb)
    s, b = tid % geo.cq, tid // geo.cq
    h = (-(b * wc)) & 3
    k = np.arange(rows)
    for xa, xb, xd, ra, rb, lo, span, mode in geo.tiles.astype(np.int64):
        assert rb - ra <= geo.desc_cap and xd - xa + 1 <= geo.col_cap
        dw = plan.run_word[ra:rb].astype(np.int64) - lo
        off = plan.col_runs[np.minimum(c0w + xa + np.arange(xd - xa + 1),
                                       n_cols)].astype(np.int64) - ra
        qa = np.where((xa == 0) & (h > 0), -1, -((h - xa) // 4))
        qq = qa + s
        live = qq < -((h - xb) // 4)
        x0 = h + 4 * qq
        for r0 in range(0, R, rt_rows):
            nrows = min(rt_rows, R - r0)
            rr = b[:, None] + k[None, :] * geo.nrb  # [threads, rows]
            ok = rr < nrows
            stage = np.full(geo.stage_words, 0xA5A5A5A5, dtype=np.uint32)
            if mode == q.REPACK_SEGMENTS:
                pitch = (span + 6) // 4 * 4
                for i in range(nrows):
                    a = off0 + (r0 + i) * W + lo
                    d = i * pitch + (a & 3)
                    assert d + span <= (i + 1) * pitch
                    g = (r0 + i) * W + lo
                    stage[d:d + span] = flat[g:g + span]
                base = rr * pitch + ((off0 + (r0 + rr) * W + lo) & 3)
            elif mode == q.REPACK_SLAB:
                a = off0 + r0 * W
                assert (a & 3) + nrows * W <= geo.stage_words
                stage[(a & 3):(a & 3) + nrows * W] = \
                    flat[r0 * W:(r0 + nrows) * W]
                base = (a & 3) + rr * W + lo
            else:
                base = np.minimum(r0 + rr, R - 1) * W + lo
            src = flat if mode == q.REPACK_DIRECT else stage
            for j in range(4):
                x = x0 + j
                valid = live & (x >= 0) & (x < wc)
                i = np.where(valid, x - xa, 0)
                p0, p1 = off[i], off[i + 1]
                acc = np.zeros((len(tid), rows), dtype=np.uint32)
                for m in range(int((p1 - p0)[valid].max(initial=0))):
                    p = p0 + m
                    on = valid & (p < p1)
                    pc = np.where(on, p, 0)
                    idx = base + dw[pc][:, None] if len(dw) else base
                    assert (idx[on][ok[on]] >= 0).all()
                    v = src[np.where(ok & on[:, None], idx, 0)]
                    rr_ = rot[ra + pc][:, None]
                    v = (v >> rr_) | (v << ((32 - rr_) & 31))
                    acc |= np.where(on[:, None], v & mask[ra + pc][:, None],
                                    0).astype(np.uint32)
                at = ((r0 + rr) * wc + x[:, None])[valid[:, None] & ok]
                out[at] = acc[valid[:, None] & ok]
                np.add.at(stored, at, 1)
            # a whole quad's four words lie in one aligned 16 bytes
            whole = live & (x0 >= 0) & (x0 + 4 <= wc)
            assert (((r0 + rr) * wc + x0[:, None])[whole[:, None] & ok]
                    % 4 == 0).all()
    assert (stored == 1).all()
    return out.view(np.uint8).reshape(R, width)


@pytest.mark.parametrize("name", CASES)
def test_kernel_walk_matches_plain_and_jax(name):
    """The kernel's algorithm, walked in numpy on the plan's runs, tiles
    and staged spans, equals the plain version on the whole table, one
    window past it and every 2, 4 and 8 shard window, at each offset of
    the source pointer in its 16 bytes; the whole table is the JAX
    package's ``pack_table_u8`` + ``table_as_u32``."""
    bits, b2t, T = _case(name)
    plan = q.repack_plan(b2t, T)
    bt = q.bits_tensor(bits)
    assert np.array_equal(_walk(bits.view(np.int32), plan, 0, plan.W8p),
                          _jax_table(bits, b2t, T)[0])
    for i, (c0, width) in enumerate(_windows(plan)):
        want = q.repack_table_plain(bt, plan, c0=c0, width=width).numpy()
        got = _walk(bits.view(np.int32), plan, c0, width, off0=i % 4)
        assert np.array_equal(got, want), (c0, width)


def _layout(kind, rng):
    """(bin_to_target, T) of the walk's further layouts."""
    if kind == "two-word-rows":  # a 64-bin forest or raptor sub
        return np.arange(64, dtype=np.int32), 64
    if kind == "three-word-rows":
        T = 40
        b2t = np.full(96, T, dtype=np.int32)
        b2t[:90] = np.repeat(np.arange(T), np.diff(
            np.r_[0, np.sort(rng.choice(np.arange(1, 90), T - 1,
                                        replace=False)), 90]))
        return b2t, T
    if kind == "runs-cross-words":  # 20 bins a target from bin 5 on
        T = 30
        b2t = np.full(640, T, dtype=np.int32)
        b2t[5:605] = np.repeat(np.arange(T), 20)
        return b2t, T
    if kind == "one-bin-wide":  # db's shape over several column tiles
        T = 2000
        b2t = np.full(2016, T, dtype=np.int32)
        b2t[:T] = np.arange(T)
        return b2t, T
    if kind == "shuffled-wide":  # a column tile names words all over a row
        T = 2000
        b2t = np.full(2188 * 32, T, dtype=np.int32)
        b2t[:T] = np.arange(T)
        return rng.permutation(b2t), T
    raise KeyError(kind)


@pytest.mark.parametrize("rows", ["below-a-stage", "one-past-stages"])
@pytest.mark.parametrize("kind", ["two-word-rows", "three-word-rows",
                                  "runs-cross-words", "one-bin-wide",
                                  "shuffled-wide"])
def test_kernel_walk_edge_layouts(kind, rows):
    """The walk on rows of 2 and 3 words (staged whole, off 16 bytes),
    runs cut at source-word edges, db's shape over four column tiles (row
    segments; 3 shards cut it off the 16-byte grid, so quads straddle the
    tiles' edges), and a shuffled layout whose tiles name more words than
    a stage holds (read in place); with fewer rows than a stage holds and
    one row past a whole number of stages."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    b2t, T = _layout(kind, rng)
    plan = q.repack_plan(b2t, T)
    W = len(b2t) // 32
    geo = q.repack_geometry(plan, 1 << 20, W, 0, plan.W8p // 4)
    stage = geo.nrb * q._REPACK_ROWS
    R = stage - 3 if rows == "below-a-stage" else 2 * stage + 1
    bits = rng.integers(0, 2**32, size=(R, W), dtype=np.uint32)
    modes = set(q.repack_geometry(plan, R, W, 0, plan.W8p // 4).tiles[:, 7])
    if kind == "shuffled-wide":
        assert q.REPACK_DIRECT in modes
    if kind == "runs-cross-words":
        assert (plan.run_len < 20).any() and (plan.run_bit == 0).any()
    if kind == "one-bin-wide":
        assert modes == {q.REPACK_SEGMENTS}
    bt = q.bits_tensor(bits)
    for i, (c0, width) in enumerate(_windows(plan, (3,))):
        want = q.repack_table_plain(bt, plan, c0=c0, width=width).numpy()
        got = _walk(bits.view(np.int32), plan, c0, width, off0=(i + 3) % 4)
        assert np.array_equal(got, want), (c0, width)


# --------------------------------------------------------------------------
# the loaders' tables against the JAX loaders\'


def _hashes(genomes):
    ex = _HashExtractor(K, W, device="cpu")
    for t, g in genomes.items():
        ex.add_encoded(t, g)
    return ex.finish()


def _genomes(lengths, seed):
    rng = np.random.default_rng(seed)
    return {f"T{i:02d}": rng.integers(0, 4, size=n, dtype=np.uint8)
            for i, n in enumerate(lengths)}


def _bytes(tbl, W8p):
    """A JAX loader's table (u8 or u32, as its policy chose) as the u8
    bytes of the padded layout."""
    a = np.asarray(tbl)
    a = a.view(np.uint8) if a.dtype == np.uint32 else a
    return np.pad(a, ((0, 0), (0, W8p - a.shape[1])))


def _cpu_mesh(batch, bins):
    return pmesh.make_mesh([CPU] * (batch * bins), batch_axis=batch)


def _assert_table(t_tbl8, t_bs, t_be, j_tbl8, j_bs, j_be):
    W8p = t_tbl8.shape[1]
    assert np.array_equal(t_tbl8.numpy(), _bytes(j_tbl8, W8p))
    assert np.array_equal(t_bs.numpy(), np.asarray(j_bs))
    assert np.array_equal(t_be.numpy(), np.asarray(j_be))


def _assert_shards(table, j_tbl8, j_bs, j_be):
    """Every batch row's shards equal ``shard_table``'s cut of the JAX
    loader's packed table."""
    nb = len(table.shards[0])
    W8p = -(-np.asarray(j_tbl8).view(np.uint8).shape[1] // 4) * 4
    cut = q.shard_table(torch.from_numpy(_bytes(j_tbl8, W8p)),
                        torch.from_numpy(np.array(j_bs)),
                        torch.from_numpy(np.array(j_be)), nb)
    for row in table.shards:
        for s, c in zip(row, cut):
            assert torch.equal(s.tbl8, c.tbl8)
            assert torch.equal(s.byte_starts, c.byte_starts)
            assert torch.equal(s.byte_ends, c.byte_ends)
            assert (s.c0, s.t_lo, s.t_hi) == (c.c0, c.t_lo, c.t_hi)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A flat IBF (one target over several bins), a native forest and a
    raptor archive (merged bins in its root), each built by the JAX
    package or the port's writer and saved."""
    tmp = tmp_path_factory.mktemp("repack")
    flat = _hashes(_genomes([3000] * 8 + [40_000], 3))
    out = {"flat": str(tmp / "db.ibf"), "forest": str(tmp / "f.hibf"),
           "raptor": str(tmp / "r.hibf")}
    jax_build_ibf(flat, kmer_size=K, window_size=W, max_fp=0.05).save(
        out["flat"])
    skew = _hashes(_genomes((1500, 1700, 2500, 3000, 6000, 7000, 16000,
                             20000), 31))
    forest = jax_build_hibf(skew, kmer_size=K, window_size=W, max_fp=0.05)
    assert len(forest.subs) > 1
    forest.save(out["forest"])
    names = sorted(skew)
    write_raptor_layout(skew, [(names[6:] + names[:2], [1, 2]),
                               (names[2:5], []), (names[5:], [])],
                        out["raptor"], kmer_size=K, window_size=W,
                        max_fp=0.05, device="cpu")
    return out


@pytest.mark.parametrize("mesh", [None, (2, 4)], ids=["one", "mesh2x4"])
def test_device_filter_table_matches_jax_loader(files, mesh):
    jf = jdev.DeviceFilter(JaxIBF.load(files["flat"]))
    tf = tdev.DeviceFilter(IBF.load(files["flat"]), "cpu",
                           mesh=mesh and _cpu_mesh(*mesh))
    if mesh is None:
        _assert_table(tf.tbl8, tf.byte_starts, tf.byte_ends, jf.tbl8,
                      jf.byte_starts, jf.byte_ends)
    else:
        assert tf.tbl8 is None
        _assert_shards(tf.table, jf.tbl8, jf.byte_starts, jf.byte_ends)


@pytest.mark.parametrize("mesh", [None, (1, 2)], ids=["one", "mesh1x2"])
def test_device_hibf_sub_tables_match_jax_loader(files, mesh):
    from ganon_tpu.index.hibf import HIBF as JaxHIBF

    jf = jdev.DeviceHIBF(JaxHIBF.load(files["forest"]))
    tf = tdev.DeviceHIBF(HIBF.load(files["forest"]), "cpu",
                         mesh=mesh and _cpu_mesh(*mesh))
    assert len(tf.subs) == len(jf.subs) > 1
    for ts, js in zip(tf.subs, jf.subs):
        if mesh is None:
            _assert_table(ts.tbl8, ts.byte_starts, ts.byte_ends, js.tbl8,
                          js.byte_starts, js.byte_ends)
        else:
            _assert_shards(ts.table, js.tbl8, js.byte_starts, js.byte_ends)


@pytest.mark.parametrize("mesh", [None, (2, 2)], ids=["one", "mesh2x2"])
def test_device_raptor_sub_tables_match_jax_loader(files, mesh):
    jf = jdev.DeviceRaptorHIBF(JaxRaptorHIBF.load(files["raptor"]))
    tf = tdev.DeviceRaptorHIBF(RaptorHIBF.load(files["raptor"]), "cpu",
                               mesh=mesh and _cpu_mesh(*mesh))
    assert len(tf.subs) == len(jf.subs) == 3
    for ts, js in zip(tf.subs, jf.subs):
        assert np.array_equal(ts.cols.numpy(), js["cols"])
        if mesh is None:
            _assert_table(ts.tbl8, ts.byte_starts, ts.byte_ends, js["tbl8"],
                          js["byte_starts"], js["byte_ends"])
        else:
            assert ts.tbl8 is None
            _assert_shards(ts.table, js["tbl8"], js["byte_starts"],
                           js["byte_ends"])
