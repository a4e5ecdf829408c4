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
* :func:`dedup` — per-file distinct counts (pass 1), or first-occurrence
  flags and ranks (``csrc/dedup.cu``);
* :func:`scatter_ranked` — first occurrences, their ranks, their
  technical bins from the per-file split parameters, then the bits
  (``csrc/scatter.cu`` ranked mode, one call from the entries to the
  matrix; in span mode into one shard's row range of it, K17).

A wrapper given CPU tensors runs the plain torch version beside it;
given CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ganon_tpu_torch import kernels
from ganon_tpu_torch.ops.ibf_query import clz64, ibf_row_indices
from ganon_tpu_torch.ops.winnow import ukey

# entries per radix pass tile (csrc/sort.cu kTile), per dedup and scatter
# tile (csrc/dedup.cuh kTile): the scratch sizes below follow from them;
# extract rows per pack tile (csrc/sort.cu kPackRows): pack's status words
SORT_TILE = 3072
DEDUP_TILE = 4096
PACK_ROWS = 32
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
    extracts at a capacity of every window position). On the card: one
    launch on the stream's chained-scan status words
    (:func:`kernels.scan_status`), no allocation but the outputs.
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
    if mc * PACK_ROWS > MAX_ENTRIES:
        raise ValueError(f"rows of {mc} slots: a pack tile of {PACK_ROWS} "
                         "rows indexes its slots in int32")
    out_key = torch.empty((total,), dtype=torch.int32, device=hashes.device)
    out_val = torch.empty((total,), dtype=torch.int64, device=hashes.device)
    if B and total:
        status, epoch = kernels.scan_status(hashes.device,
                                            -(-B // PACK_ROWS))
        kernels.launch("pack", hashes, B, mc, n_rows, keys, status, epoch,
                       out_key, out_val, total)
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
    if counts is not None:
        counts += torch.bincount(key[u].to(torch.int64),
                                 minlength=num_files)[:num_files].to(
                                     torch.int32)
    if not want_rank:
        return None, None
    uniq = u.to(torch.int32)
    rank = (torch.cumsum(uniq, 0, dtype=torch.int32) - uniq).to(torch.int32)
    return uniq, rank


def vector_aligned(*ts):
    """The tensors, each copied where its data is not 16-byte aligned (the
    kernels' vector loads; a fresh allocation always is)."""
    return [t.clone() if t.data_ptr() % 16 else t for t in ts]


def dedup(key: torch.Tensor, val: torch.Tensor, *, num_files: int,
          counts: torch.Tensor | None = None, want_rank: bool = True):
    """First occurrences of sorted entries, their ranks and file counts.

    Over entries sorted by :func:`sort_entries`, entry ``i`` is a first
    occurrence where it differs from entry ``i - 1`` and its key is below
    ``num_files``. With ``counts`` (int32 ``[num_files]``) each file's
    first occurrences are added to its slot. With ``want_rank`` returns
    ``(uniq, rank)``: int32 ``[N]`` flags and their exclusive scan (one
    chained-scan launch on the card, counted as ``dedup_rank``); without,
    the counts mode, which needs ``counts``, writes nothing of size N and
    returns ``(None, None)`` (the build's pass 1).

    Replaces ``device_build.close_sort``'s first-occurrence mask,
    ``close_counts_sorted`` and the rank of ``_entry_coords``.
    """
    _check_entries(key, val)
    if counts is not None and (counts.dtype != torch.int32
                               or counts.shape != (num_files,)):
        raise ValueError(f"counts must be int32 [{num_files}]")
    if not want_rank and counts is None:
        raise ValueError("dedup without ranks computes only the counts: "
                         "pass counts")
    if key.device.type == "cpu":
        return dedup_plain(key, val, num_files=num_files, counts=counts,
                           want_rank=want_rank)
    kernels.check_cuda(key, val, *([] if counts is None else [counts]))
    N = key.shape[0]
    uniq = torch.empty((N,), dtype=torch.int32, device=key.device) \
        if want_rank else None
    rank = torch.empty_like(uniq) if want_rank else None
    if N == 0:
        return uniq, rank
    key, val = vector_aligned(key, val)
    if not want_rank:
        kernels.launch("dedup", key, val, N, num_files, None, None, counts,
                       None, 0)
        return None, None
    status, epoch = kernels.scan_status(key.device, -(-N // DEDUP_TILE))
    kernels.launch("dedup", key, val, N, num_files, uniq, rank, counts,
                   status, epoch, counter="dedup_rank")
    return uniq, rank


# --- the scatters' tiles (csrc/scatter.cu) ------------------------------------

# the most bit inserts one scatter call takes (int32 items of scratch, 128
# MB): larger inputs are cut into calls of at most this many
ITEM_BUDGET = 1 << 25
# words of a tile, ORed in one block's shared memory (96 KB), and the most
# tiles a call (csrc/scatter.cu kMaxTiles): more rows are cut into windows
TILE_WORDS = 24576
MAX_TILES = 4096
# a block's dynamic shared memory in words (csrc/scatter.cu
# kMaxTileBytes): apply holds a tile and two words a stage block of its
# call
_SMEM_WORDS = (232448 - 512) // 4


def scatter_chunk(hash_functions: int) -> int:
    """Entries or pairs a scatter call takes at most: ``ITEM_BUDGET``
    bit inserts, a whole number of 4096-entry blocks, as many blocks as
    apply's shared memory holds beside a tile."""
    blocks = min(ITEM_BUDGET // hash_functions // DEDUP_TILE,
                 (_SMEM_WORDS - TILE_WORDS - 1) // 2)
    return max(blocks, 1) * DEDUP_TILE


def scatter_windows(rows: int, n_words: int, word_cols=None):
    """``(c0, band, cw, rpt, windows)``: the word columns ``[c0, c0 +
    band)`` a scatter covers (``word_cols``, or every column), its tiles
    of ``rpt`` rows by ``cw`` of them (``TILE_WORDS`` words at most) and
    its windows of rows ``[(r0, r1), ...]``, each of at most
    ``MAX_TILES`` tiles (a call each)."""
    c0, c1 = (0, n_words) if word_cols is None else word_cols
    if not 0 <= c0 < c1 <= n_words:
        raise ValueError(f"word_cols {word_cols} outside the matrix's "
                         f"{n_words} word columns")
    band = c1 - c0
    cw = min(band, TILE_WORDS)
    rpt = TILE_WORDS // cw
    step = MAX_TILES // -(-band // cw) * rpt
    if not step:
        raise ValueError(f"{band} word columns: a row past the "
                         "scatter's tiles")
    return c0, band, cw, rpt, [(r, min(r + step, rows))
                               for r in range(0, rows, step)]


def _scratch_sizes(n: int, hash_functions: int, rows: int, n_words: int,
                   word_cols=None):
    """(loc, items) int32 words of scatter calls of up to
    ``scatter_chunk`` of ``n`` inputs (``scatter_windows``' tiles)."""
    blocks = -(-min(n, scatter_chunk(hash_functions)) // DEDUP_TILE)
    c0, band, cw, rpt, windows = scatter_windows(rows, n_words, word_cols)
    tiles = -(-band // cw) * -(-(windows[0][1] - windows[0][0]) // rpt)
    return (tiles + 1) * blocks, blocks * DEDUP_TILE * hash_functions


def scatter_scratch_bytes(n: int, hash_functions: int, rows: int,
                          n_words: int) -> int:
    """Card bytes a scatter of ``n`` pairs or entries into ``rows`` rows of
    ``n_words`` words allocates besides the matrix, at most (every word
    column): its tiles' first slots a block and its items."""
    return 4 * sum(_scratch_sizes(n, hash_functions, rows, n_words))


def scatter_scratch(n: int, hash_functions: int, rows: int, n_words: int,
                    word_cols, device):
    """(loc, items): a scatter's scratch for calls of up to
    ``scatter_chunk`` of ``n`` inputs into ``rows`` rows of ``n_words``
    words, bins in ``word_cols``."""
    return tuple(torch.empty((max(m, 1),), dtype=torch.int32, device=device)
                 for m in _scratch_sizes(n, hash_functions, rows, n_words,
                                         word_cols))


def ranked_word_cols(params, counts) -> tuple[int, int] | None:
    """The word columns ``[c0, c1)`` the ranked scatter's bins lie in, from
    the host's ``params`` ([4, R]) and the files' distinct ``counts``
    ([R]): file f's first occurrences have indices offset[f] ..
    offset[f] + counts[f] - 1. None when no file has one."""
    p = np.asarray(params, dtype=np.int64)
    c = np.asarray(counts, dtype=np.int64)
    has = c > 0
    if not has.any():
        return None
    nhb = np.maximum(p[1], 1)
    lo = (p[0] + p[2] // nhb)[has].min()
    hi = (p[0] + (p[2] + c - 1) // nhb)[has].max()
    return int(lo) >> 5, (int(hi) >> 5) + 1


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
    """Plain version of :func:`scatter_ranked` (and of its span mode):
    with ``uniq`` and ``rank`` None, :func:`dedup_plain`'s first."""
    from ganon_tpu_torch.index.ibf import _scatter_bits

    if uniq is None:
        uniq, rank = dedup_plain(key, val, num_files=params.shape[1])
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
                   uniq: torch.Tensor | None, rank: torch.Tensor | None,
                   params: torch.Tensor, *, bin_size: int,
                   hash_functions: int, w0: int | None = None,
                   word_cols: tuple[int, int] | None = None) -> None:
    """OR every first occurrence of the sorted entries into the
    bit-matrix at its technical bin.

    First occurrences and ranks are :func:`dedup`'s (``uniq`` and
    ``rank``, int32 ``[N]``; None, as the card takes them: computed in
    the same call). Entry ``i`` with ``uniq[i]`` of file ``f = key[i]``
    has index ``idx = rank[i] - key_start[f] + offset[f]`` in its target's
    order and lands in bin ``bin_base[f] + idx // max(nhb[f], 1)``;
    ``params`` int32 ``[4, R]`` holds ``bin_base, nhb, offset, key_start``
    per file. ``bits`` int32 ``[bin_size, n_words]`` is updated in place.
    ``word_cols``: the word columns ``[c0, c1)`` the bins lie in
    (:func:`ranked_word_cols`; None: all), a hint: the card's tiles cover
    those columns only, and a bit outside them is set with an
    ``atomicOr`` straight into the matrix, so the bits never depend on
    it (the plain version ignores it).

    Replaces ``device_build.scatter_sorted`` (``_entry_coords`` and
    ``_scatter_span``) with ``close_sort``'s first-occurrence mask.

    Span mode (K17, a shard of ``device_build.make_scatter_mesh``): with
    ``w0``, the first word of a row, ``bits`` (int32 ``[rows,
    n_words]``) is the word span ``[w0, w0 + rows * n_words)`` of the
    ``[bin_size, n_words]`` matrix; a bit whose word falls outside it is
    dropped, the rest are rebased by ``w0``.

    On the card one launch (counted as ``scatter_ranked``, or
    ``scatter_span``) a call of up to :func:`scatter_chunk` entries and a
    window of :func:`scatter_windows`, with :func:`scatter_scratch` of
    scratch.
    """
    _check_entries(key, val)
    if bits.dtype != torch.int32 or bits.dim() != 2 or not bits.is_contiguous():
        raise ValueError("bits must be a contiguous int32 [R, W] tensor")
    if (uniq is None) != (rank is None) or (uniq is not None and (
            uniq.dtype != torch.int32 or rank.dtype != torch.int32
            or uniq.shape != key.shape or rank.shape != key.shape)):
        raise ValueError("uniq and rank must be int32 [N], or both None")
    if params.dtype != torch.int32 or params.dim() != 2 or params.shape[0] != 4:
        raise ValueError("params must be int32 [4, R]")
    rows, W = bits.shape
    if (w0 is None and bin_size != rows) or (
            w0 is not None and (w0 < 0 or w0 % max(W, 1))) or \
            not 1 <= hash_functions <= 5:
        raise ValueError("bin_size must equal the rows of bits (in span "
                         "mode w0 >= 0, the first word of a row); h in 1..5")
    if bits.device.type == "cpu":
        scatter_ranked_plain(bits, key, val, uniq, rank, params,
                             bin_size=bin_size, hash_functions=hash_functions,
                             w0=w0)
        return
    if uniq is not None:
        raise ValueError("the card's ranked scatter computes the first "
                         "occurrences and ranks itself: pass uniq and rank "
                         "as None")
    params = params.contiguous()
    kernels.check_cuda(bits, key, val, params)
    N = key.shape[0]
    if N == 0 or bits.numel() == 0:
        return
    key, val = vector_aligned(key, val)
    c0, band, cw, rpt, windows = scatter_windows(rows, W, word_cols)
    loc, items = scatter_scratch(N, hash_functions, rows, W, word_cols,
                                 bits.device)
    step = scatter_chunk(hash_functions)
    starts = range(0, N, step)
    row0 = (w0 or 0) // max(W, 1)
    # carry[c]: first occurrences before call c + 1's entries (call 0's: 0)
    carry = torch.empty((len(starts),), dtype=torch.int64, device=key.device)
    for r0, r1 in windows:
        for c, s in enumerate(starts):
            e = min(s + step, N)
            status, epoch = kernels.scan_status(key.device,
                                                -(-(e - s) // DEDUP_TILE))
            kernels.launch(
                "scatter_ranked", bits[r0:r1], r1 - r0, W, row0 + r0, key,
                val, s, e, params, params.shape[1], bin_size, hash_functions,
                clz64(bin_size), c0, band, cw, rpt, status, epoch,
                carry[c - 1:c] if c else None,
                carry[c:c + 1] if e < N else None, loc, items,
                counter="scatter_ranked" if w0 is None else "scatter_span")
