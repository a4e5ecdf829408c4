"""The two-pass device build's kernels: pack, sort, dedup, ranked scatter.

Port of the device programs of ``ganon_tpu.index.device_build`` (K10)
and of ``ganon_tpu.ops.bigsort.sort_flat`` (K19), which its
``close_sort`` calls. A build group's entries are ``(file key, value)``
pairs: ``key`` int32 ``[N]`` (a file's index in its group) and ``val``
int64 ``[N]`` (u64 minimizer bit patterns), exactly as many as there are
(the caller fetches each extract launch's total once). Positions, ranks
and radix offsets are int32 on the card, so ``N`` is at most
``MAX_ENTRIES``; every wrapper raises past it before any launch.

* :func:`pack_entries` — extract rows to entries (``csrc/sort.cu``);
* :func:`sort_entries` — stable order by (key, unsigned value), an LSD
  radix sort that runs only the digits :func:`sort_pass_plan` keeps
  (``csrc/sort.cu``);
* :func:`dedup` — first-occurrence flags, ranks and per-file distinct
  counts (``csrc/dedup.cu``);
* :func:`scatter_ranked` — technical bin from the rank and the per-file
  split parameters, then the bits (``csrc/scatter.cu`` ranked mode; in
  span mode into one shard's row range of the matrix, K17).

A wrapper given CPU tensors runs the plain torch version beside it;
given CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ganon_tpu_torch import kernels
from ganon_tpu_torch.ops.ibf_query import clz64, ibf_row_indices
from ganon_tpu_torch.ops.winnow import ukey

# entries per radix pass tile and per scan block (csrc/sort.cu kTile,
# kScanTile): the scratch sizes below follow from them
SORT_TILE = 3072
SCAN_TILE = 2048
RADIX = 256
# the sort's status words past its tiles' (the passes' tile counters)
_SORT_COUNTERS = 16
# the most entries one call takes: int32 positions, ranks and offsets
MAX_ENTRIES = 2**31 - 1


def check_entry_count(n: int) -> None:
    """Raise unless ``n`` entries fit the kernels' int32 indices."""
    if n > MAX_ENTRIES:
        raise ValueError(
            f"{n} build entries in one group: the build kernels index at "
            f"most {MAX_ENTRIES} (int32); a group is one file or more, so "
            "split the input file that holds them")


def _scan_scratch(M: int, device) -> torch.Tensor:
    return torch.empty((max(-(-M // SCAN_TILE), 1),), dtype=torch.int64,
                       device=device)


def _check_entries(key: torch.Tensor, val: torch.Tensor):
    if key.dtype != torch.int32 or val.dtype != torch.int64:
        raise ValueError("entries must be int32 keys and int64 values")
    if key.dim() != 1 or key.shape != val.shape:
        raise ValueError("key and val must be [N]")
    check_entry_count(key.shape[0])


# --- pack --------------------------------------------------------------------


def pack_entries_plain(hashes, n_rows, keys, total: int):
    """Plain version of :func:`pack_entries`."""
    B, mc = hashes.shape
    mask = torch.arange(mc, device=hashes.device)[None, :] < n_rows[:, None]
    val = hashes[mask]
    if val.numel() != total:
        raise ValueError(f"total {total} != the rows' {val.numel()} slots")
    return keys[:, None].expand(B, mc)[mask].contiguous(), val


def pack_entries(hashes: torch.Tensor, n_rows: torch.Tensor,
                 keys: torch.Tensor, total: int):
    """The first ``n_rows[b]`` slots of every extract row ``b``, tagged
    with file key ``keys[b]``, as new entries ``(key, val)`` of ``total``
    slots, the caller's ``sum(n_rows)``.

    Replaces the flatten and valid-slot mask of
    ``ganon_tpu.index.device_build.close_sort``. ``hashes`` int64
    ``[B, mc]`` with ``n_rows`` int32 ``[B]`` at most ``mc`` (the build
    extracts at a capacity of every window position).
    """
    if hashes.dtype != torch.int64 or hashes.dim() != 2:
        raise ValueError("hashes must be int64 [B, mc]")
    B, mc = hashes.shape
    if n_rows.dtype != torch.int32 or keys.dtype != torch.int32 or \
            n_rows.shape != (B,) or keys.shape != (B,):
        raise ValueError("n_rows and keys must be int32 [B]")
    check_entry_count(total)
    if hashes.device.type == "cpu":
        return pack_entries_plain(hashes, n_rows, keys, total)
    kernels.check_cuda(hashes, n_rows, keys)
    out_key = torch.empty((total,), dtype=torch.int32, device=hashes.device)
    out_val = torch.empty((total,), dtype=torch.int64, device=hashes.device)
    if B and total:
        offs = torch.empty((B,), dtype=torch.int32, device=hashes.device)
        kernels.launch("pack", hashes, B, mc, n_rows, keys, offs,
                       _scan_scratch(B, hashes.device), out_key, out_val,
                       total)
    return out_key, out_val


# --- sort --------------------------------------------------------------------


def sort_entries_plain(key, val, *, key_bits: int):
    """Plain version of :func:`sort_entries`: two stable ``torch.sort``
    passes, the value's by its unsigned order first."""
    o = torch.sort(ukey(val), stable=True).indices
    key, val = key[o], val[o]
    o = torch.sort(key, stable=True).indices
    return key[o], val[o]


def sort_digits(key_bits: int) -> int:
    """The radix sort's digit count: 8 value bytes, then the key's."""
    return 8 + -(-key_bits // 8)


def sort_digit(key: torch.Tensor, val: torch.Tensor, d: int) -> torch.Tensor:
    """Digit ``d`` (int64) of every entry: 0-7 the value's bytes from the
    lowest (the u64 bit pattern), 8 and up the key's."""
    if d < 8:
        return (val >> (8 * d)) & 255
    return (key.to(torch.int64) >> (8 * (d - 8))) & 255


def sort_digit_histograms_plain(key, val, *, key_bits: int) -> torch.Tensor:
    """Plain version of :func:`sort_digit_histograms`."""
    counts = torch.stack([
        torch.bincount(sort_digit(key, val, d), minlength=RADIX)
        for d in range(sort_digits(key_bits))])
    return torch.stack([counts, torch.cumsum(counts, 1) - counts]).to(
        torch.int32)


def sort_digit_histograms(key: torch.Tensor, val: torch.Tensor, *,
                          key_bits: int) -> torch.Tensor:
    """The sort's first step: int32 ``[2, D, 256]``, ``[0, d]`` the
    entries' histogram of digit ``d`` (:func:`sort_digit`, D =
    :func:`sort_digits`), ``[1, d]`` its exclusive scan (the digit's first
    slot in a pass)."""
    _check_entries(key, val)
    if key.device.type == "cpu":
        return sort_digit_histograms_plain(key, val, key_bits=key_bits)
    kernels.check_cuda(key, val)
    D = sort_digits(key_bits)
    hist = torch.empty((2, D, RADIX), dtype=torch.int32, device=key.device)
    kernels.launch("sort_hist", key, val, key.shape[0], D, hist)
    return hist


def sort_pass_plan(hist: torch.Tensor, *, key_bits: int) -> list[int]:
    """The digits whose passes the radix sort runs, lowest first (0-7 the
    value's bytes, 8 and up the key's), from the ``[D, 256]`` digit
    histograms of its entries.

    A digit that puts every entry in one bucket leaves a stable order as
    it is, so its pass is skipped; with no entry or one, nothing runs.
    """
    # numpy: this runs on the host between the card's histograms and its
    # passes, where torch's per-op cost on a small tensor adds up
    hist = np.asarray(torch.as_tensor(hist).cpu(), dtype=np.int64)
    hist = hist.reshape(-1, RADIX)
    if hist.shape[0] != sort_digits(key_bits):
        raise ValueError(f"{hist.shape[0]} digit histograms for key_bits "
                         f"{key_bits}: want {sort_digits(key_bits)}")
    n = int(hist[0].sum())
    return [d for d, m in enumerate(hist.max(axis=1).tolist()) if m < n]


def sort_entries(key: torch.Tensor, val: torch.Tensor, *, key_bits: int):
    """The entries ordered by (key, value), the value compared as
    UNSIGNED 64-bit, stable; returns new ``(key, val)`` tensors and
    leaves the inputs alone.

    Replaces ``ganon_tpu.ops.bigsort.sort_flat`` as
    ``device_build.close_sort`` calls it (lexicographic (key, hi, lo) with
    u32 halves). ``key_bits``: keys are below ``2**key_bits``. On the card
    the digit histograms come first; their counts are fetched (one wait
    on the card a call) so that :func:`sort_pass_plan` picks the passes.
    Card memory: the three entry buffers (input, A, B) and 256 int64
    status words a 3072 entries (2/3 byte an entry).
    """
    _check_entries(key, val)
    if not 0 <= key_bits <= 31:
        raise ValueError(f"key_bits {key_bits} outside 0..31")
    if key.device.type == "cpu":
        return sort_entries_plain(key, val, key_bits=key_bits)
    kernels.check_cuda(key, val)
    N = key.shape[0]
    key_a, val_a = torch.empty_like(key), torch.empty_like(val)
    if N == 0:
        return key_a, val_a
    hist = sort_digit_histograms(key, val, key_bits=key_bits)
    digits = sort_pass_plan(hist[0], key_bits=key_bits)
    # the passes alternate A and B
    key_b, val_b = ((torch.empty_like(key), torch.empty_like(val))
                    if len(digits) > 1 else (None, None))
    status = torch.empty((-(-N // SORT_TILE) * RADIX + _SORT_COUNTERS,),
                         dtype=torch.int64, device=key.device)
    kernels.launch("sort", key, val, N, sum(1 << d for d in digits), hist[1],
                   key_a, val_a, key_b, val_b, status)
    if digits and len(digits) % 2 == 0:
        return key_b, val_b
    return key_a, val_a


# --- dedup -------------------------------------------------------------------


def dedup_plain(key, val, *, num_files: int, counts=None,
                want_rank: bool = True):
    """Plain version of :func:`dedup`."""
    first = torch.ones(key.shape, dtype=torch.bool, device=key.device)
    first[1:] = (key[1:] != key[:-1]) | (val[1:] != val[:-1])
    u = first & (key < num_files)
    uniq = u.to(torch.int32)
    if counts is not None:
        counts += torch.bincount(key[u].to(torch.int64),
                                 minlength=num_files)[:num_files].to(
                                     torch.int32)
    if not want_rank:
        return uniq, None
    rank = (torch.cumsum(uniq, 0, dtype=torch.int32) - uniq).to(torch.int32)
    return uniq, rank


def dedup(key: torch.Tensor, val: torch.Tensor, *, num_files: int,
          counts: torch.Tensor | None = None, want_rank: bool = True):
    """First occurrences of sorted entries, their ranks and file counts.

    Over entries sorted by :func:`sort_entries`: ``uniq[i]`` (int32
    ``[N]``) is 1 where entry ``i`` differs from entry ``i - 1`` and its
    key is below ``num_files``; ``rank`` (int32 ``[N]``, or None without
    ``want_rank``) is the exclusive scan of ``uniq``; with ``counts``
    (int32 ``[num_files]``) each file's distinct entries are added to its
    slot. Returns ``(uniq, rank)``.

    Replaces ``device_build.close_sort``'s first-occurrence mask,
    ``close_counts_sorted`` and the rank of ``_entry_coords``.
    """
    _check_entries(key, val)
    if counts is not None and (counts.dtype != torch.int32
                               or counts.shape != (num_files,)):
        raise ValueError(f"counts must be int32 [{num_files}]")
    if key.device.type == "cpu":
        return dedup_plain(key, val, num_files=num_files, counts=counts,
                           want_rank=want_rank)
    kernels.check_cuda(key, val, *([] if counts is None else [counts]))
    N = key.shape[0]
    uniq = torch.empty((N,), dtype=torch.int32, device=key.device)
    rank = torch.empty_like(uniq) if want_rank else None
    if N == 0:
        return uniq, rank
    kernels.launch("dedup", key, val, N, num_files, uniq, rank, counts,
                   _scan_scratch(N, key.device))
    return uniq, rank


# --- ranked scatter ----------------------------------------------------------


def _ranked_bins(key, uniq, rank, params):
    """(selected entry mask, their technical bins) of the ranked split."""
    u = uniq.bool()
    f = key[u].to(torch.int64)
    p = params.to(torch.int64)
    idx = rank[u].to(torch.int64) - p[3, f] + p[2, f]
    return u, p[0, f] + torch.div(idx, torch.clamp(p[1, f], min=1),
                                  rounding_mode="floor")


def scatter_ranked_plain(bits, key, val, uniq, rank, params, *,
                         bin_size: int, hash_functions: int,
                         w0: int | None = None) -> None:
    """Plain version of :func:`scatter_ranked` (and of its span mode)."""
    from ganon_tpu_torch.index.ibf import _scatter_bits

    u, bins = _ranked_bins(key, uniq, rank, params)
    if w0 is None:
        _scatter_bits(bits, val[u], bins.to(torch.int32), bin_size=bin_size,
                      hash_functions=hash_functions)
        return
    # span mode: the words of [w0, w0 + span) only, rebased; words before
    # the span are dropped as well as those past it
    R, W = bits.shape
    rows = ibf_row_indices(val[u], bin_size=bin_size,
                           hash_functions=hash_functions)  # [N, h]
    at = rows * W + (bins >> 5)[:, None] - w0
    flat = (at * 32 + (bins & 31)[:, None])[(at >= 0) & (at < R * W)]
    flat = torch.unique(flat)
    delta = torch.zeros(R * W, dtype=torch.int64, device=bits.device)
    delta.index_add_(0, flat >> 5, torch.ones_like(flat) << (flat & 31))
    delta = torch.where(delta >= 1 << 31, delta - (1 << 32), delta)
    bits |= delta.to(torch.int32).reshape(R, W)


def scatter_ranked(bits: torch.Tensor, key: torch.Tensor, val: torch.Tensor,
                   uniq: torch.Tensor, rank: torch.Tensor,
                   params: torch.Tensor, *, bin_size: int,
                   hash_functions: int, w0: int | None = None) -> None:
    """OR every distinct entry into the bit-matrix at its technical bin.

    Entry ``i`` with ``uniq[i]`` of file ``f = key[i]`` has index ``idx =
    rank[i] - key_start[f] + offset[f]`` in its target's order and lands
    in bin ``bin_base[f] + idx // max(nhb[f], 1)``; ``params`` int32
    ``[4, R]`` holds ``bin_base, nhb, offset, key_start`` per file.
    ``bits`` int32 ``[bin_size, n_words]`` is updated in place.

    Replaces ``device_build.scatter_sorted`` (``_entry_coords`` and
    ``_scatter_span``).

    Span mode (K17, a shard of ``device_build.make_scatter_mesh``): with
    ``w0``, ``bits`` (int32 ``[rows, n_words]``) is the word span ``[w0,
    w0 + rows * n_words)`` of the ``[bin_size, n_words]`` matrix; a bit
    whose word falls outside it is dropped, the rest are rebased by
    ``w0``.
    """
    _check_entries(key, val)
    if bits.dtype != torch.int32 or bits.dim() != 2 or not bits.is_contiguous():
        raise ValueError("bits must be a contiguous int32 [R, W] tensor")
    if uniq.dtype != torch.int32 or rank.dtype != torch.int32 or \
            uniq.shape != key.shape or rank.shape != key.shape:
        raise ValueError("uniq and rank must be int32 [N]")
    if params.dtype != torch.int32 or params.dim() != 2 or params.shape[0] != 4:
        raise ValueError("params must be int32 [4, R]")
    if (w0 is None and bin_size != bits.shape[0]) or (
            w0 is not None and w0 < 0) or not 1 <= hash_functions <= 5:
        raise ValueError("bin_size must equal the rows of bits (w0 >= 0 in "
                         "span mode); h in 1..5")
    if bits.device.type == "cpu":
        scatter_ranked_plain(bits, key, val, uniq, rank, params,
                             bin_size=bin_size, hash_functions=hash_functions,
                             w0=w0)
        return
    params = params.contiguous()
    kernels.check_cuda(bits, key, val, uniq, rank, params)
    N = key.shape[0]
    if N == 0:
        return
    kernels.launch("scatter_ranked", bits, bits.shape[0], bits.shape[1], key,
                   val, uniq, rank, N, params, params.shape[1], bin_size,
                   hash_functions, clz64(bin_size), w0 or 0,
                   counter="scatter_ranked" if w0 is None else "scatter_span")
