"""The ``ops`` library API over the interleaved bit-matrix (K18).

Counterparts of the JAX package's exported ``ganon_tpu.ops`` functions
that no classify or build path calls: the library a user imports to
extract minimizers and count them against an IBF's bit-matrix as saved
(``IBF.bits``, u32 ``[bin_size, n_words]``, bin ``j`` in word ``j // 32``,
bit ``j % 32``), without the classify path's byte-aligned repack.

* :func:`minimizers` — ``ganon_tpu.ops.minimizers.minimizers_jax``: the
  ``extract`` kernel in single-end mode (``csrc/extract.cu``, counted as
  ``minimizers``); plain version :func:`minimizers_plain`.
* :func:`ibf_row_indices` — int32 rows, as JAX returns them (torch ops on
  any device; the kernels inline the hash family, ``csrc/ibf_hash.cuh``).
* :func:`bulk_count_bins` — per-bin hit counts (``csrc/bins.cu`` mode
  ``bins``); plain version :func:`bulk_count_bins_plain`.
* :func:`target_counts` — per-bin counts summed per target (mode
  ``tsum``); plain version :func:`target_counts_plain`.
* :func:`bulk_target_counts` — both at once over permuted bin ranges
  (mode ``bins_target``); plain version :func:`bulk_target_counts_plain`.
* :func:`target_segments` — the host-side ``(perm, starts, ends)``.

The bit-matrix is held as int32 (u32 bit patterns), the port's
convention; hashes are u64 bit patterns in int64. A wrapper given CPU
tensors runs the plain torch version; given CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ganon_tpu_torch import kernels
from ganon_tpu_torch.ops import ibf_query as q
from ganon_tpu_torch.ops.winnow import minimizers_masked

# gathered member words the plain per-bin count holds at once
_PLAIN_MEMBER_WORDS = 1 << 24


# --- minimizers (K18a) ----------------------------------------------------


def _single_end_input(codes: torch.Tensor, lengths: torch.Tensor):
    """``extract``'s single-end input ``[B, L4/4 | 4 (len le-i32)]``:
    the ranks 2-bit packed with ``L`` rounded up to ``L4``, a multiple of
    4 (the padding lies past every length), and the lengths cut to ``L``
    (``minimizers_jax`` sees no base past column ``L``)."""
    B, L = codes.shape
    L4 = max(4, -(-L // 4) * 4)
    c = torch.zeros((B, L4), dtype=torch.uint8, device=codes.device)
    c[:, :L] = codes.to(torch.uint8) & 3
    c = c.view(B, L4 // 4, 4)
    packed = c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) | (
        c[:, :, 3] << 6)
    lens = lengths.to(torch.int32).clamp(0, L).contiguous()
    inbuf = torch.cat([packed, lens.view(torch.uint8).view(B, 4)], dim=1)
    return inbuf.contiguous(), L4


def minimizers_plain(codes: torch.Tensor, lengths: torch.Tensor, *, k: int,
                     w: int, max_minimizers: int):
    """Plain version of :func:`minimizers`: ``minimizers_masked`` plus
    ``compact_hashes``."""
    minval, emit, n = minimizers_masked(codes, lengths, k=k, w=w)
    if max_minimizers <= 0:
        return minval[:, :0], n
    hashes, _, _ = q.compact_hashes(minval, emit, max_compact=max_minimizers)
    return hashes, n


def minimizers(codes: torch.Tensor, lengths: torch.Tensor, *, k: int, w: int,
               max_minimizers: int):
    """Minimizers of a padded batch, compacted.

    Counterpart of ``ganon_tpu.ops.minimizers.minimizers_jax``: ``codes``
    u8/int ``[B, L]`` dna4 ranks, ``lengths`` int32 ``[B]``. Returns
    ``(hashes int64 [B, max_minimizers], n_hashes int32 [B])``: the
    emitted values (u64 bit patterns) in position order, zero past
    ``min(n, max_minimizers)``; ``n_hashes`` counts every emission, those
    past ``max_minimizers`` too. A row shorter than ``w`` (and every row
    when ``L < w``) emits nothing. On a CUDA tensor this is the
    ``extract`` kernel in single-end mode.
    """
    if codes.dim() != 2 or lengths.shape != codes.shape[:1]:
        raise ValueError("codes must be [B, L] and lengths [B]")
    if not 0 < k <= 32 or w < k:
        raise ValueError(f"invalid k={k}, w={w}")
    if codes.device.type == "cpu":
        return minimizers_plain(codes, lengths, k=k, w=w,
                                max_minimizers=max_minimizers)
    kernels.check_cuda(codes, lengths)
    inbuf, L4 = _single_end_input(codes, lengths)
    hashes, n, _ = q.extract(inbuf, L1=L4, L2=0, k=k, w=w,
                             mc=max(max_minimizers, 1), counter="minimizers")
    return hashes[:, :max(max_minimizers, 0)], n


# --- the hash family and target segments ----------------------------------


def ibf_row_indices(hashes: torch.Tensor, *, bin_size: int,
                    hash_functions: int) -> torch.Tensor:
    """Row indices into the bit-matrix, int32 ``[..., hash_functions]``.

    Counterpart of ``ganon_tpu.ops.ibf_query.ibf_row_indices`` (rows in
    ``[0, bin_size)``; ``hashes`` int64 u64 bit patterns); torch ops on
    the hashes' device.
    """
    return q.ibf_row_indices(hashes, bin_size=bin_size,
                             hash_functions=hash_functions).to(torch.int32)


def target_segments(bin_to_target: np.ndarray, num_targets: int):
    """Static ``(perm, starts, ends)`` for :func:`bulk_target_counts`.

    Copy of ``ganon_tpu.ops.ibf_query.target_segments``: ``perm`` orders
    the technical bins so every target's bins are contiguous (``None``
    when that is the identity); target ``t`` owns the permuted bins
    ``[starts[t], ends[t])`` (int32 ``[T]``).
    """
    b2t = np.asarray(bin_to_target)
    order = np.argsort(b2t, kind="stable")
    perm = None if np.array_equal(order, np.arange(len(b2t))) else order
    sorted_t = b2t[order]
    starts = np.searchsorted(sorted_t, np.arange(num_targets), side="left")
    ends = np.searchsorted(sorted_t, np.arange(num_targets), side="right")
    return perm, starts.astype(np.int32), ends.astype(np.int32)


# --- per-bin and per-target counts (K18b-d) -------------------------------


def _check_bins(bits, rows, hash_mask):
    if bits.dtype != torch.int32 or bits.dim() != 2:
        raise ValueError("bits must be int32 [bin_size, n_words]")
    if rows.dtype != torch.int32 or rows.dim() != 3 or rows.shape[2] < 1:
        raise ValueError("rows must be int32 [B, M, S], S >= 1")
    if hash_mask.dtype != torch.bool or hash_mask.shape != rows.shape[:2]:
        raise ValueError("hash_mask must be bool [B, M]")


def bulk_count_bins_plain(bits: torch.Tensor, rows: torch.Tensor,
                          hash_mask: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`bulk_count_bins`: the member words
    gathered a chunk of reads at a time, then summed one bit plane at a
    time (never JAX's whole ``[B, M, W, 32]`` expansion)."""
    B, M, S = rows.shape
    W = bits.shape[1]
    out = torch.zeros((B, W, 32), dtype=torch.int32, device=bits.device)
    step = max(1, _PLAIN_MEMBER_WORDS // max(1, M * W))
    r64 = rows.to(torch.int64)
    for b0 in range(0, B, step):
        rr = r64[b0:b0 + step]
        member = bits[rr[:, :, 0]]  # [b, M, W]
        for s in range(1, S):
            member = member & bits[rr[:, :, s]]
        member = member * hash_mask[b0:b0 + step, :, None]
        for i in range(32):
            out[b0:b0 + step, :, i] = ((member >> i) & 1).sum(
                dim=1, dtype=torch.int32)
    return out.reshape(B, W * 32)


def bulk_count_bins(bits: torch.Tensor, rows: torch.Tensor,
                    hash_mask: torch.Tensor) -> torch.Tensor:
    """Per-bin hit counts of a batch: int32 ``[B, n_words * 32]``.

    Counterpart of ``ganon_tpu.ops.ibf_query.bulk_count_bins``:
    ``counts[b, 32 w + i]`` is the number of valid hashes
    (``hash_mask[b, m]``) whose ``S`` rows ``rows[b, m, :]`` (int32, in
    ``[0, bin_size)``) all have bit ``i`` of word ``w`` set in ``bits``
    (int32 ``[bin_size, n_words]``); padding bins are counted.
    """
    _check_bins(bits, rows, hash_mask)
    if bits.device.type == "cpu":
        return bulk_count_bins_plain(bits, rows, hash_mask)
    kernels.check_cuda(bits, rows, hash_mask)
    B, M, S = rows.shape
    W = bits.shape[1]
    out = torch.empty((B, W * 32), dtype=torch.int32, device=bits.device)
    if B and W:
        kernels.launch("bins", bits, bits.shape[0], W, rows, B, M, S,
                       hash_mask, out)
    return out


def _check_tsum(bin_counts, bin_to_target, num_targets):
    if bin_counts.dtype != torch.int32 or bin_counts.dim() != 2:
        raise ValueError("bin_counts must be int32 [B, technical_bins]")
    if (bin_to_target.dtype != torch.int32
            or bin_to_target.shape != bin_counts.shape[1:]):
        raise ValueError("bin_to_target must be int32 [technical_bins]")
    if num_targets < 1:
        raise ValueError("num_targets must be positive")


def target_counts_plain(bin_counts: torch.Tensor, bin_to_target: torch.Tensor,
                        *, num_targets: int) -> torch.Tensor:
    """Plain version of :func:`target_counts` (an ``index_add_`` over the
    bins; ids outside ``[0, T)`` go to a dropped column)."""
    T = num_targets
    ids = bin_to_target.to(torch.int64)
    ids = torch.where((ids >= 0) & (ids < T), ids, T)
    out = torch.zeros((bin_counts.shape[0], T + 1), dtype=torch.int64,
                      device=bin_counts.device)
    out.index_add_(1, ids, bin_counts.to(torch.int64))
    return out[:, :T].to(torch.int32)


def target_counts(bin_counts: torch.Tensor, bin_to_target: torch.Tensor, *,
                  num_targets: int) -> torch.Tensor:
    """Per-target sums of per-bin counts: int32 ``[B, num_targets]``.

    Counterpart of ``ganon_tpu.ops.ibf_query.target_counts`` (a one-hot
    f32 matmul at HIGHEST precision there, exact below 2^24; integer sums
    here): ``out[b, t]`` sums ``bin_counts[b, j]`` over the bins with
    ``bin_to_target[j] == t``; a bin whose id lies outside ``[0,
    num_targets)`` (the padding bins carry ``num_targets``) is dropped.
    """
    _check_tsum(bin_counts, bin_to_target, num_targets)
    if bin_counts.device.type == "cpu":
        return target_counts_plain(bin_counts, bin_to_target,
                                   num_targets=num_targets)
    kernels.check_cuda(bin_counts, bin_to_target)
    B, TB = bin_counts.shape
    out = torch.zeros((B, num_targets), dtype=torch.int32,
                      device=bin_counts.device)
    if B:
        kernels.launch("tsum", bin_counts, B, TB, bin_to_target, num_targets,
                       out)
    return out


def bulk_target_counts_plain(bits: torch.Tensor, rows: torch.Tensor,
                             hash_mask: torch.Tensor, starts: torch.Tensor,
                             ends: torch.Tensor,
                             perm: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of :func:`bulk_target_counts`: JAX's permute,
    prefix sum and difference."""
    cb = bulk_count_bins_plain(bits, rows, hash_mask)
    if perm is not None:
        cb = cb[:, perm.to(torch.int64)]
    cs = torch.nn.functional.pad(torch.cumsum(cb, dim=1, dtype=torch.int32),
                                 (1, 0))
    return cs[:, ends.to(torch.int64)] - cs[:, starts.to(torch.int64)]


def bulk_target_counts(bits: torch.Tensor, rows: torch.Tensor,
                       hash_mask: torch.Tensor, starts: torch.Tensor,
                       ends: torch.Tensor,
                       perm: torch.Tensor | None = None) -> torch.Tensor:
    """Per-target hit counts over permuted bin ranges: int32 ``[B, T]``.

    Counterpart of ``ganon_tpu.ops.ibf_query.bulk_target_counts``: the
    per-bin counts of :func:`bulk_count_bins`, permuted by ``perm``
    (int32, column ``j`` takes bin ``perm[j]``) when it is given, summed
    over ``[starts[t], ends[t])`` (int32 ``[T]``, indices into the
    permuted bins; :func:`target_segments` makes all three). Equals
    ``target_counts(bulk_count_bins(...))`` for the segments of a bin
    map.
    """
    _check_bins(bits, rows, hash_mask)
    T = starts.shape[0] if starts.dim() == 1 else -1
    if (starts.dtype != torch.int32 or ends.dtype != torch.int32 or T < 1
            or ends.shape != (T,)):
        raise ValueError("starts/ends must be int32 [T], T >= 1")
    if perm is not None and (perm.dtype != torch.int32 or perm.dim() != 1):
        raise ValueError("perm must be int32 [technical_bins]")
    if bits.device.type == "cpu":
        return bulk_target_counts_plain(bits, rows, hash_mask, starts, ends,
                                        perm)
    kernels.check_cuda(bits, rows, hash_mask, starts, ends,
                       *([] if perm is None else [perm]))
    B, M, S = rows.shape
    W = bits.shape[1]
    out = torch.empty((B, T), dtype=torch.int32, device=bits.device)
    if B:
        scratch = torch.empty((B, W * 32), dtype=torch.int32,
                              device=bits.device)
        kernels.launch("bins_target", bits, bits.shape[0], W, rows, B, M, S,
                       hash_mask, scratch, perm, starts, ends, T, out)
    return out
