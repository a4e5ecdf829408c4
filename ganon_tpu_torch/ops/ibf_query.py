"""Interleaved Bloom filter bit-matrix: hash family and bulk-count query.

Port of ``ganon_tpu.ops.ibf_query``. The IBF is a dense bit-matrix
``uint32[bin_size, n_words]`` (bin ``b`` in word ``b // 32``, bit
``b % 32``). Hash family (build and query must agree)::

    g  = ((h * seed_i) ^ ((h * seed_i) >> hash_shift)) * GOLDEN   (mod 2^64)
    row = mulhi64(g, bin_size)          # fastrange to [0, bin_size)

with ``hash_shift = clz64(bin_size)``. The query table is
``pack_table_u8``'s byte-aligned layout: every target's technical bins
occupy a contiguous byte range, so per-target counts are per-byte
popcounts summed over that range.

This module holds the classify kernels' wrappers:

* :func:`extract` — 2-bit unpack, canonical minimizers, mate join and
  compaction (``csrc/extract.cu``); plain version :func:`extract_plain`.
* :func:`bulk_target_counts_packed` — hash rows, gather + AND, byte
  popcount, per-target segment sum and clamp (``csrc/count.cu``; flat,
  forest and column-max modes, and shard mode with the clamp off); plain
  version :func:`bulk_target_counts_packed_plain`.
* :func:`raptor_target_counts` — every sub of a raptor archive in
  column-max mode in one launch (``csrc/count.cu``); plain version
  :func:`raptor_target_counts_plain`.
* :func:`combine` — the column shards' partial counts summed and clamped
  (``csrc/shard.cu``); plain version :func:`combine_plain`.
* :func:`probe_sort` — each read's hashes ordered by their first row
  (``csrc/psort.cu``, the ``sort_probes`` branch); plain version
  :func:`probe_sort_plain`.

:func:`shard_table` splits a packed table into the column shards of a
device mesh's ``bins`` axis (K17).

A wrapper given CPU tensors runs the plain torch version; given CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ganon_tpu_torch import kernels
from ganon_tpu_torch.ops.winnow import as_i64, lsr, minimizers_masked

# 2^64 / golden ratio — spreads the xor-folded value over the full range.
GOLDEN = 0x9E3779B97F4A7C15
# seqan3 IBF hash seeds (fixed family constants, max 5 hash functions)
HASH_SEEDS = (
    13572355802537770549,  # 2**64 / (e/2)
    13043817825332782213,  # 2**64 / sqrt(2)
    10650232656628343401,  # 2**64 / sqrt(5)
    16499269484942379435,  # 2**64 / (sqrt(3)/2)
    4893150838803335377,  # 2**64 / (3/(2*sqrt(e)))
)
MAX_HASH_FUNCTIONS = 5
_M32 = 0xFFFFFFFF


def clz64(x: int) -> int:
    """Count leading zeros of a 64-bit value (host-side, static)."""
    assert 0 < x < 1 << 64
    return 64 - x.bit_length()


def ibf_row_indices_np(hashes: np.ndarray, *, bin_size: int, hash_functions: int):
    """NumPy twin of :func:`ibf_row_indices` (used by the host-side builder)."""
    h = hashes.astype(np.uint64)
    shift = np.uint64(clz64(bin_size))
    rows = np.empty(h.shape + (hash_functions,), dtype=np.int64)
    with np.errstate(over="ignore"):
        for i in range(hash_functions):
            g = h * np.uint64(HASH_SEEDS[i])
            g = g ^ (g >> shift)
            g = g * np.uint64(GOLDEN)
            # mulhi via 32-bit limbs
            m32 = np.uint64(0xFFFFFFFF)
            s32 = np.uint64(32)
            ah, al = g >> s32, g & m32
            b = np.uint64(bin_size)
            bh, bl = b >> s32, b & m32
            lo = al * bl
            m1 = ah * bl
            m2 = al * bh
            carry = ((lo >> s32) + (m1 & m32) + (m2 & m32)) >> s32
            rows[..., i] = (ah * bh + (m1 >> s32) + (m2 >> s32) + carry).astype(
                np.int64
            )
    return rows


def pack_table_u8(bits: np.ndarray, bin_to_target: np.ndarray,
                  num_targets: int, row_chunk: int = 4096):
    """Repack the interleaved bit-matrix into the byte-aligned query layout.

    Layout: ``uint8[bin_size, W8]`` with every target's technical bins
    moved to a byte-aligned contiguous range (padding bins are zero).
    Returns ``(tbl8, byte_starts, byte_ends)`` with int32 [T] byte ranges.
    The on-disk format keeps the compact interleaved u32 layout; this
    expansion costs at most 7 padding bins per target and happens once
    at load.
    """
    b2t = np.asarray(bin_to_target)
    R = bits.shape[0]
    order = np.argsort(b2t, kind="stable")
    sorted_t = b2t[order]
    starts = np.searchsorted(sorted_t, np.arange(num_targets), side="left")
    ends = np.searchsorted(sorted_t, np.arange(num_targets), side="right")
    widths = ends - starts
    pad_w = (widths + 7) // 8 * 8
    pstarts = np.concatenate([[0], np.cumsum(pad_w)[:-1]])
    TBP = int(np.sum(pad_w))
    W8 = max(TBP // 8, 1)

    # destination bit position for every real source bin; real bins sort
    # before padding bins (id == num_targets), so they occupy [0, n_real)
    n_real = int(widths.sum())
    src_bins = order[:n_real]
    local = np.arange(n_real, dtype=np.int64) - np.repeat(starts, widths)
    dst_bits = np.repeat(pstarts, widths) + local

    tbl8 = np.zeros((R, W8), dtype=np.uint8)
    for r0 in range(0, R, row_chunk):
        r1 = min(r0 + row_chunk, R)
        chunk_bytes = bits[r0:r1].view(np.uint8).reshape(r1 - r0, -1)
        unpacked = np.unpackbits(chunk_bytes, axis=1, bitorder="little")
        out = np.zeros((r1 - r0, W8 * 8), dtype=np.uint8)
        out[:, dst_bits] = unpacked[:, src_bins]
        tbl8[r0:r1] = np.packbits(out, axis=1, bitorder="little")
    byte_starts = (pstarts // 8).astype(np.int32)
    byte_ends = ((pstarts + pad_w) // 8).astype(np.int32)
    return tbl8, byte_starts, byte_ends


def table_as_u32(tbl8: np.ndarray) -> np.ndarray:
    """View the u8 query table as little-endian u32 words (pads W8 to x4).

    Same bytes, same target byte ranges — only the element type changes.
    The ``count`` kernel reads rows as u32 words, so the device table is
    stored with ``W8`` padded this way.
    """
    R, W8 = tbl8.shape
    W8p = -(-W8 // 4) * 4
    if W8p != W8:
        tbl8 = np.pad(tbl8, ((0, 0), (0, W8p - W8)))
    return np.ascontiguousarray(tbl8).view(np.uint32)


# --- plain torch versions ------------------------------------------------------


def _mulhi64(a: torch.Tensor, b) -> torch.Tensor:
    """High 64 bits of the unsigned product ``a * b`` (32-bit limbs).

    ``a`` holds u64 bit patterns in int64; ``b`` is a non-negative int or
    int64 tensor. Every intermediate stays below 2^63 or is only shifted
    logically, so no sign bit leaks in.
    """
    ah, al = lsr(a, 32), a & _M32
    bh, bl = b >> 32, b & _M32
    lo = al * bl
    m1 = ah * bl
    m2 = al * bh
    carry = lsr(lsr(lo, 32) + (m1 & _M32) + (m2 & _M32), 32)
    return ah * bh + lsr(m1, 32) + lsr(m2, 32) + carry


def ibf_row_indices(hashes: torch.Tensor, *, bin_size: int,
                    hash_functions: int) -> torch.Tensor:
    """Row indices into the bit-matrix for each hash and hash function.

    ``hashes`` int64 ``[...]`` (u64 bit patterns) -> int64
    ``[..., hash_functions]`` rows in ``[0, bin_size)``.
    """
    shift = clz64(bin_size)
    rows = []
    for i in range(hash_functions):
        g = hashes * as_i64(HASH_SEEDS[i])
        g = g ^ lsr(g, shift)
        g = g * as_i64(GOLDEN)
        rows.append(_mulhi64(g, bin_size))
    return torch.stack(rows, dim=-1)


def ibf_row_dyn(hashes: torch.Tensor, i: int, bin_size: torch.Tensor,
                shift: torch.Tensor) -> torch.Tensor:
    """Row of hash function ``i`` with per-element ``bin_size`` (int64,
    positive) and ``shift`` (int64, ``clz64(bin_size)`` in 1..63), all
    broadcast together: the pruned forest's dynamic fastrange, where each
    group has its own bin size."""
    g = hashes * as_i64(HASH_SEEDS[i])
    # logical right shift by a tensor: clear the bits the sign filled in
    keep = torch.bitwise_left_shift(torch.ones_like(shift), 64 - shift) - 1
    g = g ^ ((g >> shift) & keep)
    g = g * as_i64(GOLDEN)
    return _mulhi64(g, bin_size)


def compact_hashes(hashes: torch.Tensor, mask: torch.Tensor, *,
                   max_compact: int):
    """Stable partition of the emitted hashes into ``max_compact`` slots.

    Plain version of ``ganon_tpu.ops.ibf_query.compact_hashes``: emitted
    values keep their position order; slots past the emission count are
    0. Returns ``(hashes int64 [B, max_compact], n int32 [B],
    overflow bool [B])``; an overflowing read keeps its first
    ``max_compact`` emissions.
    """
    B = hashes.shape[0]
    n = mask.sum(dim=1, dtype=torch.int32)
    pos = torch.cumsum(mask.to(torch.int64), dim=1) - 1
    # non-emitted and past-capacity entries land in a discarded column
    dst = torch.where(mask & (pos < max_compact), pos,
                      torch.full_like(pos, max_compact))
    out = torch.zeros((B, max_compact + 1), dtype=torch.int64,
                      device=hashes.device)
    out.scatter_(1, dst, torch.where(mask, hashes, torch.zeros_like(hashes)))
    return out[:, :max_compact].contiguous(), n, n > max_compact


def unpack_batch_input(inbuf: torch.Tensor, L1: int, L2: int):
    """Split the per-batch input buffer of ``classify.device.pack_batch_direct``.

    ``[B, L1/4 | L2/4 | 4 (len1 le-i32) | 4 (len2 le-i32)]`` u8 ->
    ``(codes1 [B, L1], len1 int32 [B], codes2 | None, len2 | None)``
    with codes as dna4 ranks.
    """
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=inbuf.device)
    B = inbuf.shape[0]

    def codes(o, L):
        packed = inbuf[:, o : o + L // 4]
        return ((packed[:, :, None] >> shifts) & 3).reshape(B, L)

    def lens(o):
        return inbuf[:, o : o + 4].contiguous().view(torch.int32).reshape(B)

    o2 = L1 // 4
    ol = o2 + L2 // 4
    if not L2:
        return codes(0, L1), lens(ol), None, None
    return codes(0, L1), lens(ol), codes(o2, L2), lens(ol + 4)


def extract_plain(inbuf: torch.Tensor, *, L1: int, L2: int, k: int, w: int,
                  mc: int):
    """Plain version of the ``extract`` kernel (see :func:`extract`)."""
    codes1, len1, codes2, len2 = unpack_batch_input(inbuf, L1, L2)
    m1 = max(L1 - w + 1, 1)
    h1, e1, n1 = minimizers_masked(codes1, len1, k=k, w=w)
    hashes, mask, n = h1[:, :m1], e1[:, :m1], n1
    if L2:
        m2 = max(L2 - w + 1, 1)
        h2, e2, n2 = minimizers_masked(codes2, len2, k=k, w=w)
        hashes = torch.cat([hashes, h2[:, :m2]], dim=1)
        mask = torch.cat([mask, e2[:, :m2]], dim=1)
        n = n + n2
    read_ok = len1 >= w
    mask = mask & read_ok[:, None]
    hc, n, overflow = compact_hashes(hashes, mask, max_compact=mc)
    return hc, n, overflow.to(torch.uint8)


# windows a tile of the extract kernel (csrc/extract.cu kWindows)
EXTRACT_WINDOWS = 512
# shared memory a block may take on the H100 (227 KB)
_SMEM_LIMIT = 232_448


def extract_tiles(L1: int, L2: int, w: int) -> int:
    """Tiles (blocks) a read of the ``extract`` kernel: mate 1's
    ``EXTRACT_WINDOWS``-window tiles (at least one) and mate 2's."""
    tiles = max(-(-max(L1 - w + 1, 0) // EXTRACT_WINDOWS), 1)
    if L2:
        tiles += -(-max(L2 - w + 1, 0) // EXTRACT_WINDOWS)
    return tiles


def extract_smem(k: int, w: int) -> int:
    """Dynamic shared memory of an ``extract`` block at ``(k, w)``:
    values and argmins of ``EXTRACT_WINDOWS + w - k + 1`` positions, the
    tile's emissions and packed bases (csrc/extract.cu smem_bytes)."""
    np_ = EXTRACT_WINDOWS + w - k + 1
    n_words = (np_ + 30) // 32 + 2
    return 8 * np_ + 8 * EXTRACT_WINDOWS + 8 * n_words + -(-4 * np_ // 8) * 8


def extract_is_wide(k: int, w: int) -> bool:
    """Whether ``extract`` on the card takes the wide-window route at
    ``(k, w)``: a tile's shared memory (:func:`extract_smem`, plus the
    kernel's static 512 bytes) would pass the card's 227 KB."""
    return extract_smem(k, w) + 512 > _SMEM_LIMIT


def extract(inbuf: torch.Tensor, *, L1: int, L2: int, k: int, w: int,
            mc: int, counter: str | None = None, zero_tail: bool = True):
    """Minimizers of a packed (paired or single-end) batch, compacted.

    Replaces ``ganon_tpu.classify.device._unpack_batch_input`` +
    ``unpack_codes_2bit`` + ``extract_hashes`` + ``compact_hashes``
    (and, with ``L2 == 0`` and ``mc`` = every window position, the
    build's ``_extract_packed``). ``inbuf`` u8 ``[B, L1/4 + L2/4 + 4 (+4)]``;
    ``L2 == 0`` means single-end. A read whose mate 1 is shorter than
    ``w`` yields nothing; mate 2 counts only when ``len2 >= w``.

    Returns ``(hashes int64 [B, mc], n_hashes int32 [B], overflow u8 [B])``:
    the emitted values in position order (mate 1, then mate 2), zeros
    past ``min(n, mc)``; ``overflow`` marks ``n > mc``. ``counter``
    names the launch count (default ``extract``; the build's pieces count
    as ``extract_build``). ``zero_tail=False`` leaves the slots past
    ``min(n, mc)`` unwritten on the card (the build reads only the first
    ``n`` of each row); the plain version zeroes them either way.

    Windows too wide for a tile's shared memory (:func:`extract_is_wide`,
    ``w - k + 1`` past about 18,000) take the wide-window route on the
    card: one warp a read (``csrc/extract.cu`` ``ganon_extract_wide``),
    counted as ``extract_wide`` whoever calls; the outputs are the same.
    """
    if L1 % 4 or L2 % 4 or L1 <= 0 or L2 < 0:
        raise ValueError(f"L1={L1}, L2={L2}: lengths must be multiples of 4")
    if not 0 < k <= 32 or w < k:
        raise ValueError(f"invalid k={k}, w={w}")
    row = L1 // 4 + L2 // 4 + 4 + (4 if L2 else 0)
    if inbuf.dtype != torch.uint8 or inbuf.dim() != 2 or inbuf.shape[1] != row:
        raise ValueError(f"inbuf must be u8 [B, {row}], got "
                         f"{inbuf.dtype} {tuple(inbuf.shape)}")
    if mc <= 0:
        raise ValueError("mc must be positive")
    if inbuf.device.type == "cpu":
        return extract_plain(inbuf, L1=L1, L2=L2, k=k, w=w, mc=mc)
    kernels.check_cuda(inbuf)
    B = inbuf.shape[0]
    wide = extract_is_wide(k, w)
    # the wide route writes only the first min(n, mc) slots of a row
    hashes = (torch.zeros if wide and zero_tail else torch.empty)(
        (B, mc), dtype=torch.int64, device=inbuf.device)
    n = torch.empty((B,), dtype=torch.int32, device=inbuf.device)
    overflow = torch.empty((B,), dtype=torch.uint8, device=inbuf.device)
    if B == 0:
        return hashes, n, overflow
    if wide:
        kernels.launch("extract_wide", inbuf, B, row, L1, L2, k, w, mc,
                       hashes, n, overflow)
        return hashes, n, overflow
    # a zero tail takes one more read's tiles (stripes of the last tail)
    tiles = (B + bool(zero_tail)) * extract_tiles(L1, L2, w)
    if tiles >= 1 << 31:
        raise ValueError(f"{tiles} extract tiles: past the grid's 2^31")
    status, epoch = kernels.scan_status(inbuf.device, tiles)
    kernels.launch(
        "extract", inbuf, B, row, L1, L2, k, w, mc, int(zero_tail), status,
        epoch, hashes, n, overflow, counter=counter,
    )
    return hashes, n, overflow


# member bytes the plain count gathers at once
_PLAIN_GATHER_BYTES = 64 << 20
# hashes whose per-byte popcounts (<= 8 each) one int32 word sums without
# a carry between bytes or into the sign bit (15 * 8 = 120 < 128)
_PLAIN_SUM_GROUP = 15


def _popcount_bytes_i32(x: torch.Tensor) -> torch.Tensor:
    """Popcount of each byte of int32 words, in place (each byte of the
    result holds its own count; the masks drop the sign fill)."""
    t = torch.empty_like(x)  # one scratch buffer, reused
    x -= torch.bitwise_right_shift(x, 1, out=t).bitwise_and_(0x55555555)
    torch.bitwise_right_shift(x, 2, out=t).bitwise_and_(0x33333333)
    x.bitwise_and_(0x33333333).add_(t)
    x += torch.bitwise_right_shift(x, 4, out=t)
    return x.bitwise_and_(0x0F0F0F0F)


def bulk_target_counts_packed_plain(
        tbl8: torch.Tensor, byte_starts: torch.Tensor,
        byte_ends: torch.Tensor, hashes: torch.Tensor,
        n_hashes: torch.Tensor, *, bin_size: int, hash_functions: int,
        out: torch.Tensor | None = None, col0: int = 0,
        cols: torch.Tensor | None = None,
        clamp: bool = True) -> torch.Tensor:
    """Plain version of the ``count`` kernel (see
    :func:`bulk_target_counts_packed`).

    ``counts[b, t] = min(n_hashes[b], sum_m popcount(AND_s
    tbl8[row_s(h[b, m]), byte_starts[t]:byte_ends[t]]))`` over the first
    ``min(n_hashes[b], M)`` slots (without the ``min`` when ``clamp`` is
    false); written into ``out[:, col0:col0 + T]``
    when ``out`` is given, or max-merged into ``out[:, cols]`` with
    ``cols`` (``out`` returned either way). ``tbl8``'s ``W8`` is a
    multiple of 4, as :func:`bulk_target_counts_packed` requires.
    """
    B, M = hashes.shape
    W8 = tbl8.shape[1]
    dev = hashes.device
    tbl32 = tbl8.view(torch.int32)  # the same bytes, four at a time
    cw = torch.zeros((B, W8), dtype=torch.int64, device=dev)
    acc = torch.zeros((B, W8 // 4), dtype=torch.int32, device=dev)
    n = n_hashes.to(torch.int64)
    m_used = min(M, int(n.max())) if B else 0
    # the member words of the valid (read, slot) pairs only, 64 MB at a
    # time (a whole [B, M, W8] gather of long reads or wide filters takes
    # tens of GB), a group of slots at a time: a read adds at most
    # _PLAIN_SUM_GROUP words of byte popcounts into its row of acc
    chunk = max(1, _PLAIN_GATHER_BYTES // W8)
    for g0 in range(0, m_used, _PLAIN_SUM_GROUP):
        sl = hashes[:, g0:g0 + _PLAIN_SUM_GROUP]
        valid = (torch.arange(g0, g0 + sl.shape[1], device=dev)[None, :]
                 < n[:, None])
        bi, mi = valid.nonzero(as_tuple=True)
        hv = sl[bi, mi]
        acc.zero_()
        for c0 in range(0, len(hv), chunk):
            rows = ibf_row_indices(hv[c0:c0 + chunk], bin_size=bin_size,
                                   hash_functions=hash_functions)
            member = tbl32[rows[:, 0]]  # [pairs, W8 / 4]
            for s in range(1, hash_functions):
                member &= tbl32[rows[:, s]]
            acc.index_add_(0, bi[c0:c0 + chunk], _popcount_bytes_i32(member))
        cw += acc.view(torch.uint8)  # [B, W8] byte sums
    cs = torch.nn.functional.pad(torch.cumsum(cw, dim=1), (1, 0))
    counts = cs[:, byte_ends.to(torch.int64)] - cs[:, byte_starts.to(torch.int64)]
    if clamp:
        counts = torch.minimum(counts, n_hashes[:, None].to(torch.int64))
    counts = counts.to(torch.int32)
    if out is None:
        return counts
    if cols is not None:
        idx = cols.to(torch.int64)
        out[:, idx] = torch.maximum(out[:, idx], counts)
    else:
        out[:, col0:col0 + counts.shape[1]] = counts
    return out


def bulk_target_counts_packed(
        tbl8: torch.Tensor, byte_starts: torch.Tensor,
        byte_ends: torch.Tensor, hashes: torch.Tensor,
        n_hashes: torch.Tensor, *, bin_size: int, hash_functions: int,
        out: torch.Tensor | None = None, col0: int = 0,
        cols: torch.Tensor | None = None,
        clamp: bool = True) -> torch.Tensor:
    """Per-target clamped counts of compacted hashes: int32 ``[B, T]``.

    The counterpart of ``ganon_tpu.ops.ibf_query.
    bulk_target_counts_packed`` (its name, and not the ``ops`` API's
    ``bulk_target_counts``, which counts the interleaved matrix:
    :mod:`ganon_tpu_torch.ops.bins`).

    Replaces ``ganon_tpu.ops.ibf_query.ibf_row_indices`` +
    ``bulk_target_counts_u8``/``_u32`` + ``_segment_matmul`` and the
    clamp of ``classify.device.classify_counts_fused``. ``tbl8`` is the
    ``pack_table_u8`` table with ``W8`` padded to a multiple of 4
    (``table_as_u32``'s padding); slots ``>= min(n_hashes, M)`` of
    ``hashes`` are ignored.

    Forest mode: with ``out`` (int32 ``[B, ldc]``, zero in the written
    columns) the counts go straight into ``out[:, col0:col0 + T]`` and
    ``out`` is returned, so a forest's sub-IBFs share one matrix.

    Column-max mode (a raptor sub-IBF, ``DeviceRaptorHIBF.counts``):
    with ``out`` and ``cols`` (int32 ``[T]``, distinct columns of
    ``out``) each count is max-merged, ``out[:, cols[t]] =
    max(out[:, cols[t]], counts[:, t])``; ``col0`` must be 0.

    Shard mode (K17, one column shard of :func:`shard_table`):
    ``clamp=False`` writes the unclamped partial sums, which
    :func:`combine` adds over the shards before it clamps.
    """
    if tbl8.dtype != torch.uint8 or tbl8.dim() != 2 or tbl8.shape[1] % 4:
        raise ValueError("tbl8 must be u8 [R, W8] with W8 % 4 == 0")
    if hashes.dtype != torch.int64 or hashes.dim() != 2:
        raise ValueError("hashes must be int64 [B, M]")
    if n_hashes.dtype != torch.int32 or n_hashes.shape != hashes.shape[:1]:
        raise ValueError("n_hashes must be int32 [B]")
    T = byte_starts.shape[0]
    if (byte_starts.dtype != torch.int32 or byte_ends.dtype != torch.int32
            or byte_ends.shape != (T,)):
        raise ValueError("byte_starts/byte_ends must be int32 [T]")
    if not 1 <= hash_functions <= MAX_HASH_FUNCTIONS or bin_size > tbl8.shape[0]:
        raise ValueError("invalid hash_functions or bin_size")
    B, M = hashes.shape
    if out is not None and (
        out.dtype != torch.int32 or out.dim() != 2 or out.shape[0] != B
        or not 0 <= col0 <= out.shape[1] - T or not out.is_contiguous()
    ):
        raise ValueError(f"out must be contiguous int32 [{B}, >= col0 + {T}]")
    if cols is not None and (out is None or col0 != 0
                             or cols.dtype != torch.int32
                             or cols.shape != (T,) or not clamp):
        raise ValueError(f"column-max mode takes out, col0 = 0, int32 "
                         f"cols [{T}] and the clamp")
    if tbl8.device.type == "cpu":
        return bulk_target_counts_packed_plain(
            tbl8, byte_starts, byte_ends, hashes, n_hashes,
            bin_size=bin_size, hash_functions=hash_functions, out=out,
            col0=col0, cols=cols, clamp=clamp,
        )
    counter = ("count_shard" if not clamp else "count" if out is None else
               "count_forest" if cols is None else "count_raptor")
    if out is None:
        out, col0 = torch.zeros((B, T), dtype=torch.int32,
                                device=hashes.device), 0
    kernels.check_cuda(tbl8, byte_starts, byte_ends, hashes, n_hashes, out,
                       *([] if cols is None else [cols]))
    if B == 0 or T == 0:
        return out
    kernels.launch(
        "count", tbl8, tbl8.shape[0], tbl8.shape[1], byte_starts, byte_ends,
        T, hashes, B, M, n_hashes, bin_size, hash_functions, clz64(bin_size),
        out, out.shape[1], col0, cols, int(clamp), counter=counter,
    )
    return out


# --- every sub of a raptor archive in one launch (K12) ---------------------

# the int64 fields of a row of :func:`sub_descriptors` (csrc/count.cu
# struct Table); the three tables and cols are data pointers
SUB_DESC_FIELDS = ("tbl8", "W32", "byte_starts", "byte_ends", "T",
                   "bin_size", "hash_functions", "shift", "cols")


def sub_descriptors(subs) -> torch.Tensor:
    """int64 ``[S, 9]`` descriptors of a raptor archive's sub tables, on
    their device, one row a sub in :data:`SUB_DESC_FIELDS` order.

    ``subs``: objects with ``tbl8`` (u8 ``[R, W8]``, ``W8 % 4 == 0``),
    ``byte_starts``/``byte_ends``/``cols`` (int32 ``[T]``), ``bin_size``
    and ``hash_funs`` (``classify.device.RaptorSub``), all on one device.
    The rows hold the tensors' data pointers: the caller keeps the
    tensors alive as long as the array, and makes it anew when they move.
    """
    rows = []
    for sub in subs:
        tbl8, T = sub.tbl8, sub.byte_starts.shape[0]
        if tbl8.dtype != torch.uint8 or tbl8.dim() != 2 or tbl8.shape[1] % 4:
            raise ValueError("tbl8 must be u8 [R, W8] with W8 % 4 == 0")
        if any(x.dtype != torch.int32 or x.shape != (T,)
               for x in (sub.byte_starts, sub.byte_ends, sub.cols)):
            raise ValueError("byte_starts, byte_ends and cols must be int32 "
                             "[T]")
        if (not 1 <= sub.hash_funs <= MAX_HASH_FUNCTIONS
                or not 0 < sub.bin_size <= tbl8.shape[0]):
            raise ValueError("invalid hash_functions or bin_size")
        rows.append([tbl8.data_ptr(), tbl8.shape[1] // 4,
                     sub.byte_starts.data_ptr(), sub.byte_ends.data_ptr(), T,
                     sub.bin_size, sub.hash_funs, clz64(sub.bin_size),
                     sub.cols.data_ptr()])
    device = subs[0].tbl8.device if subs else "cpu"
    return torch.tensor(rows, dtype=torch.int64,
                        device=device).reshape(len(rows), 9)


def raptor_target_counts_plain(subs, hashes: torch.Tensor,
                               n_hashes: torch.Tensor, *,
                               num_targets: int) -> torch.Tensor:
    """Plain version of :func:`raptor_target_counts`: a zeroed
    ``[B, num_targets]`` matrix and every sub max-merged into it by
    :func:`bulk_target_counts_packed_plain`."""
    out = torch.zeros((hashes.shape[0], num_targets), dtype=torch.int32,
                      device=hashes.device)
    for sub in subs:
        bulk_target_counts_packed_plain(
            sub.tbl8, sub.byte_starts, sub.byte_ends, hashes, n_hashes,
            bin_size=sub.bin_size, hash_functions=sub.hash_funs, out=out,
            cols=sub.cols)
    return out


def raptor_target_counts(subs, hashes: torch.Tensor, n_hashes: torch.Tensor,
                         *, num_targets: int,
                         desc: torch.Tensor | None = None) -> torch.Tensor:
    """Clamped counts of a raptor archive: int32 ``[B, num_targets]``,
    each user bin the largest of its subs' counts (0 in no sub).

    The exact path of ``ganon_tpu.classify.device.DeviceRaptorHIBF.
    counts``: every sub in column-max mode, in one launch on the card
    (``csrc/count.cu`` ``ganon_count_raptor``, counted as
    ``count_raptor``) that writes every cell, so no zeroed matrix. ``subs``
    as :func:`sub_descriptors` takes them; ``desc`` is their descriptor
    array (made here when not given).
    """
    if hashes.dtype != torch.int64 or hashes.dim() != 2:
        raise ValueError("hashes must be int64 [B, M]")
    if n_hashes.dtype != torch.int32 or n_hashes.shape != hashes.shape[:1]:
        raise ValueError("n_hashes must be int32 [B]")
    if hashes.device.type == "cpu":
        return raptor_target_counts_plain(subs, hashes, n_hashes,
                                          num_targets=num_targets)
    if desc is None:
        desc = sub_descriptors(subs)
    if desc.dtype != torch.int64 or desc.shape != (len(subs), 9):
        raise ValueError(f"desc must be int64 [{len(subs)}, 9]")
    kernels.check_cuda(hashes, n_hashes, desc, *(
        x for sub in subs
        for x in (sub.tbl8, sub.byte_starts, sub.byte_ends, sub.cols)))
    B, M = hashes.shape
    out = torch.empty((B, num_targets), dtype=torch.int32,
                      device=hashes.device)
    if B == 0 or num_targets == 0:
        return out
    if not subs:
        return out.zero_()
    kernels.launch(
        "count_raptor", desc, len(subs), max(s.hash_funs for s in subs),
        max(s.tbl8.shape[1] // 4 for s in subs), hashes, B, M, n_hashes, out,
        num_targets)
    return out


# --- the probe order of a read (sort_probes) --------------------------------

# the largest compaction width probe_sort takes (csrc/psort.cu kMaxM)
PROBE_SORT_MAX_M = 4096


def _probe_keys(hashes: torch.Tensor, n_hashes: torch.Tensor, *,
                bin_size: int) -> torch.Tensor:
    """int64 ``[B, M]`` keys of :func:`probe_sort`: ``row0 << 16 | slot``
    for the first ``min(n, M)`` slots, ``2^62 | slot`` past them."""
    B, M = hashes.shape
    row0 = ibf_row_indices(hashes, bin_size=bin_size, hash_functions=1)[..., 0]
    slot = torch.arange(M, device=hashes.device)
    valid = slot[None, :] < n_hashes[:, None].to(torch.int64)
    return torch.where(valid, (row0 << 16) | slot, (1 << 62) | slot)


def probe_sort_plain(hashes: torch.Tensor, n_hashes: torch.Tensor, *,
                     bin_size: int) -> torch.Tensor:
    """Plain version of the ``probe_sort`` kernel (see :func:`probe_sort`):
    ``torch.sort(stable=True)`` of the same keys."""
    order = torch.sort(_probe_keys(hashes, n_hashes, bin_size=bin_size),
                       dim=1, stable=True).indices
    return torch.gather(hashes, 1, order)


def probe_sort(hashes: torch.Tensor, n_hashes: torch.Tensor, *,
               bin_size: int) -> torch.Tensor:
    """Each read's compacted hashes ordered by their first hash
    function's row: int64 ``[B, M]``.

    Replaces the ``sort_probes`` branch of ``ganon_tpu.classify.device.
    classify_batch_packed`` (``device.py:375-410``), which sorts each
    read's hashes by ``ibf_row_indices(...)[..., 0]`` before the count so
    that neighbouring probes gather neighbouring rows. The first ``min(n,
    M)`` slots (those :func:`bulk_target_counts_packed` reads) order by
    ``(row0, slot)``; the slots past them keep their order after them.
    The counts of the sorted hashes equal the unsorted ones. ``M`` is at
    most :data:`PROBE_SORT_MAX_M`.
    """
    if hashes.dtype != torch.int64 or hashes.dim() != 2:
        raise ValueError("hashes must be int64 [B, M]")
    if n_hashes.dtype != torch.int32 or n_hashes.shape != hashes.shape[:1]:
        raise ValueError("n_hashes must be int32 [B]")
    B, M = hashes.shape
    if not 0 < M <= PROBE_SORT_MAX_M or not 0 < bin_size < 1 << 46:
        raise ValueError(f"probe_sort takes 0 < M <= {PROBE_SORT_MAX_M} and "
                         "bin_size < 2^46")
    if hashes.device.type == "cpu":
        return probe_sort_plain(hashes, n_hashes, bin_size=bin_size)
    kernels.check_cuda(hashes, n_hashes)
    out = torch.empty_like(hashes)
    if B:
        kernels.launch("probe_sort", hashes, B, M, n_hashes, bin_size,
                       clz64(bin_size), out)
    return out


# --- column shards of a packed table (K17) ---------------------------------


@dataclass
class TableShard:
    """One column shard of a packed table: the byte columns ``[c0, c0 +
    W8s)`` of every row (``tbl8``, u8 ``[R, W8s]``, ``W8s`` a multiple of
    4) and the targets ``t_lo .. t_hi - 1`` whose byte ranges meet them,
    clipped to the shard and rebased (int32 ``[t_hi - t_lo]``)."""

    tbl8: torch.Tensor
    byte_starts: torch.Tensor
    byte_ends: torch.Tensor
    c0: int
    t_lo: int
    t_hi: int

    def to(self, device) -> "TableShard":
        return TableShard(self.tbl8.to(device), self.byte_starts.to(device),
                          self.byte_ends.to(device), self.c0, self.t_lo,
                          self.t_hi)


def shard_table(tbl8: torch.Tensor, byte_starts, byte_ends, nb: int,
                devices=None) -> list[TableShard]:
    """Split a packed table into ``nb`` column shards (K17).

    Port of the column sharding of ``ganon_tpu.classify.device.
    DeviceFilter`` with a mesh (``device.py:749-768``): ``W8`` is padded
    with zero bytes to a multiple of ``4 * nb`` (JAX's alignment for its
    u32 regime; the port always reads u32 words) and cut into ``nb`` equal
    slices, so the table is never repacked on the host. Shard ``j`` is
    allocated on ``devices[j]`` (default: ``tbl8``'s device) and its slice
    copied straight there from ``tbl8`` (a host table or one on a card),
    so no device holds more than its own shards beside ``tbl8``. A target
    whose byte range crosses a shard edge appears in both shards, each
    with its part of the range.
    """
    R, W8 = tbl8.shape
    ws = -(-W8 // (4 * nb)) * 4
    if devices is None:
        devices = [tbl8.device] * nb
    bs = np.asarray(torch.as_tensor(byte_starts).cpu(), dtype=np.int64)
    be = np.asarray(torch.as_tensor(byte_ends).cpu(), dtype=np.int64)
    shards = []
    for j, d in zip(range(nb), devices):
        c0 = j * ws
        # the targets whose ranges meet [c0, c0 + ws): ends past c0,
        # starts before c0 + ws (the ranges ascend)
        t_lo = int(np.searchsorted(be, c0, side="right"))
        t_hi = int(np.searchsorted(bs, c0 + ws, side="left"))
        part = torch.zeros((R, ws), dtype=torch.uint8, device=d)
        w = max(0, min(ws, W8 - c0))
        if w:
            part[:, :w].copy_(tbl8[:, c0:c0 + w])
        shards.append(TableShard(
            part,
            torch.from_numpy(np.clip(bs[t_lo:t_hi] - c0, 0, ws).astype(
                np.int32)).to(d),
            torch.from_numpy(np.clip(be[t_lo:t_hi] - c0, 0, ws).astype(
                np.int32)).to(d),
            c0, t_lo, t_hi))
    return shards


def _check_combine(parts, t_lo, t_hi, n_hashes, out, col0, cols):
    nb = t_lo.shape[0] if t_lo.dim() == 1 else -1
    if (t_lo.dtype != torch.int32 or t_hi.dtype != torch.int32 or nb < 1
            or t_hi.shape != (nb,)):
        raise ValueError("t_lo and t_hi must be int32 [nb], nb >= 1")
    if n_hashes.dtype != torch.int32 or n_hashes.dim() != 1:
        raise ValueError("n_hashes must be int32 [B]")
    B = n_hashes.shape[0]
    if parts.dtype != torch.int32 or parts.dim() != 1:
        raise ValueError("parts must be flat int32")
    if out.dtype != torch.int32 or out.dim() != 2 or out.shape[0] != B or (
            not out.is_contiguous()):
        raise ValueError(f"out must be contiguous int32 [{B}, ldc]")
    if cols is not None and (col0 != 0 or cols.dtype != torch.int32
                             or cols.dim() != 1):
        raise ValueError("column-max mode takes col0 = 0 and int32 cols [T]")


def combine_plain(parts: torch.Tensor, t_lo: torch.Tensor,
                  t_hi: torch.Tensor, n_hashes: torch.Tensor,
                  out: torch.Tensor, *, num_targets: int, col0: int = 0,
                  cols: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the ``combine`` kernel (see :func:`combine`)."""
    B = n_hashes.shape[0]
    acc = torch.zeros((B, num_targets), dtype=torch.int64, device=out.device)
    off = 0
    for lo, hi in zip(t_lo.tolist(), t_hi.tolist()):
        acc[:, lo:hi] += parts[off:off + B * (hi - lo)].view(B, hi - lo)
        off += B * (hi - lo)
    counts = torch.minimum(acc, n_hashes[:, None].to(torch.int64)).to(
        torch.int32)
    if cols is not None:
        idx = cols.to(torch.int64)
        out[:, idx] = torch.maximum(out[:, idx], counts)
    else:
        out[:, col0:col0 + num_targets] = counts
    return out


def combine(parts: torch.Tensor, t_lo: torch.Tensor, t_hi: torch.Tensor,
            n_hashes: torch.Tensor, out: torch.Tensor, *, num_targets: int,
            col0: int = 0, cols: torch.Tensor | None = None) -> torch.Tensor:
    """Sum the column shards' partial counts of each read, then clamp.

    The cross-shard step of K17 (``ganon_tpu.parallel.mesh.
    ShardedClassifier.counts``: JAX all-gathers the per-byte counts before
    the segment sum and the clamp). ``parts`` (flat int32) holds one
    block per shard ``j``, row-major ``[B, t_hi[j] - t_lo[j]]`` over its
    targets ``t_lo[j] .. t_hi[j] - 1`` (int32 ``[nb]``), blocks in shard
    order; ``counts[b, t] = min(n_hashes[b], sum of the partials of
    (b, t))``, the clamp after the sum. Written into ``out[:, col0:col0 +
    num_targets]``, or max-merged into ``out[:, cols]`` with ``cols``
    (column-max mode, a raptor sub); ``out`` is returned.
    """
    _check_combine(parts, t_lo, t_hi, n_hashes, out, col0, cols)
    B = n_hashes.shape[0]
    if cols is None and not 0 <= col0 <= out.shape[1] - num_targets:
        raise ValueError("out must hold columns col0 .. col0 + num_targets")
    if cols is not None and cols.shape != (num_targets,):
        raise ValueError(f"cols must be int32 [{num_targets}]")
    if out.device.type == "cpu":
        return combine_plain(parts, t_lo, t_hi, n_hashes, out,
                             num_targets=num_targets, col0=col0, cols=cols)
    kernels.check_cuda(parts, t_lo, t_hi, n_hashes, out,
                       *([] if cols is None else [cols]))
    if B == 0 or num_targets == 0:
        return out
    kernels.launch("combine", parts, t_lo, t_hi, t_lo.shape[0], B,
                   num_targets, n_hashes, out, out.shape[1], col0, cols)
    return out
