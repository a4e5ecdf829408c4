"""Device-side classify compute: extract, count, (merge,) select.

Port of ``ganon_tpu.classify.device`` for flat IBFs, native HIBF forests
and levels of several flat filters. A batch costs one host->device
buffer (:func:`pack_batch_direct`), the kernels of its filter kind and
one int32 result buffer, whose dense layout :func:`unpack_batch_result`
splits:

* a flat IBF: ``extract`` -> ``count`` -> ``select``
  (:func:`classify_batch_packed`);
* a forest (:class:`DeviceHIBF`): ``extract``, then ``count`` once per
  sub-IBF into its columns of one matrix, then ``select``
  (:func:`classify_batch_packed_forest`);
* several flat filters on one level: ``extract``, then per filter
  ``count`` and ``merge`` into the union counts and winners, then
  ``select`` with the winners payload (:func:`classify_batch_packed_multi`).

Every function takes tensors on one explicit device; on the CPU the
kernels' plain torch versions run. Not ported yet: raptor and pruned
``.hibf`` files (:func:`load_device_filter` raises naming their ROADMAP
items), the 32-bit counter layout, multi-GPU meshes.
"""

from __future__ import annotations

import copy
import os
import zipfile

import numpy as np
import torch

from ganon_tpu_torch import kernels
from ganon_tpu_torch.ops.ibf_query import (
    extract,
    pack_table_u8,
    table_as_u32,
    target_counts,
)


def bucket_len(n: int, minimum: int = 128) -> int:
    """Round a length up to the next bucket.

    Multiples of 32 up to 256, multiples of 64 up to 1024, powers of two
    beyond. The bucket sets the compaction width (and so every gather's
    probe count), so it is kept as the JAX package chose it.
    """
    if n <= minimum:
        return minimum
    if n <= 256:
        return -(-n // 32) * 32
    if n <= 1024:
        return -(-n // 64) * 64
    b = 1024
    while b < n:
        b *= 2
    return b


def compact_width(m_total: int) -> int:
    """Compacted hash capacity for a read of ``m_total`` window positions.

    Emission density for typical (k, w) is ~2/(w-k+2) (~1/7 at 19/31), so
    a fifth of the positions covers >3x the expectation; overflowing
    reads fall back to the uncompacted path, so counts stay exact.
    """
    return min(m_total, max(32, -(-m_total // 5 // 8) * 8))


def pack_codes_2bit(codes: np.ndarray) -> np.ndarray:
    """Host-side 2-bit packing of dna4 ranks (4 bases per byte)."""
    B, L = codes.shape
    Lp = -(-L // 4)
    if Lp * 4 != L:
        codes = np.pad(codes, ((0, 0), (0, Lp * 4 - L)))
    c = codes.reshape(B, Lp, 4)
    return (c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4)
            | (c[:, :, 3] << 6)).astype(np.uint8)


def pack_batch_direct(batch, batch_pad: int):
    """2-bit-pack an EncodedBatch straight into the padded device input.

    Layout (u8): ``[batch_pad, L1/4 | L2/4 | 4 (len1 le-i32) |
    4 (len2 le-i32)]`` with bucketed ``L1``/``L2``; single-end batches
    drop the mate-2 columns. Returns ``(inbuf, L1, L2)`` with ``L2 = 0``
    for single-end.
    """
    L1 = bucket_len(max(batch.codes1.shape[1], 1))
    L1p = L1 // 4  # bucket lengths are multiples of 32
    L2 = bucket_len(max(batch.codes2.shape[1], 1)) if batch.paired else 0
    L2p = L2 // 4
    width = L1p + L2p + 4 + (4 if batch.paired else 0)
    buf = np.zeros((batch_pad, width), np.uint8)

    def pack_into(dst, codes):
        b, L = codes.shape
        L4 = -(-L // 4) * 4
        if L4 != L:
            codes = np.pad(codes, ((0, 0), (0, L4 - L)))
        c = codes.reshape(b, L4 // 4, 4)
        dst[:b, : L4 // 4] = (
            c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4)
            | (c[:, :, 3] << 6)
        )

    def lens_into(dst, lengths):
        lens = np.zeros((batch_pad,), dtype="<i4")
        lens[: len(lengths)] = lengths
        dst[:] = lens.view(np.uint8).reshape(batch_pad, 4)

    o = 0
    pack_into(buf[:, o:o + L1p], batch.codes1)
    o += L1p
    if batch.paired:
        pack_into(buf[:, o:o + L2p], batch.codes2)
        o += L2p
    lens_into(buf[:, o:o + 4], batch.len1)
    o += 4
    if batch.paired:
        lens_into(buf[:, o:o + 4], batch.len2)
    return buf, L1, L2


def extract_hashes(inbuf: torch.Tensor, *, k: int, w: int, L1: int, L2: int,
                   mc: int | None = None):
    """Minimizers of a packed batch, compacted to ``mc`` slots per read.

    ``mc`` defaults to every window position (``m1 + m2``), which never
    overflows. Returns ``(hashes int64 [B, mc], n_hashes int32 [B],
    overflow u8 [B])``.
    """
    m1 = max(L1 - w + 1, 1)
    m2 = max(L2 - w + 1, 1) if L2 else 0
    return extract(inbuf, L1=L1, L2=L2, k=k, w=w,
                   mc=m1 + m2 if mc is None else mc)


def threshold_topk(counts: torch.Tensor, n_hashes: torch.Tensor,
                   rel_cutoff: float, rel_filter: float, hashes_limit: int, *,
                   top_k: int, emit_matches_t: bool = True,
                   winners: torch.Tensor | None = None) -> dict:
    """Plain version of the ``select`` kernel's thresholds and top-K.

    Reference threshold semantics (GanonClassify.cpp:719-758) with the
    cutoff math in float64. The top ``K = min(top_k, T)`` entries are
    ordered by the key ``count << 16 | (0xFFFF - idx)`` over the
    finally-kept counts (0 elsewhere), held in int64: descending count,
    ascending index on ties. ``winners`` (int32 ``[B, T]``, the winning
    filter per union column) adds ``top_win``, each entry's
    ``winners[b, top_idx]``. Returns the dict of
    ``ganon_tpu.classify.device.threshold_topk`` (int32 arrays; the three
    scalars as int64).
    """
    T = counts.shape[1]
    c = counts.to(torch.int64)
    n = n_hashes.to(torch.int64)
    nh = n_hashes.to(torch.float64)
    cutoff = torch.clamp(torch.ceil(nh * rel_cutoff), min=1.0).to(torch.int64)
    valid = (n > 0) & (n <= hashes_limit)
    kept = (c >= cutoff[:, None]) & valid[:, None]
    max_count = torch.where(kept, c, 0).max(dim=1).values
    big = torch.iinfo(torch.int32).max
    min_count = torch.minimum(n, torch.where(kept, c, big).min(dim=1).values)
    thr = (
        max_count.to(torch.float64)
        - torch.ceil((max_count - min_count).to(torch.float64) * rel_filter)
    ).to(torch.int64)
    final = kept & (c >= thr[:, None])
    n_matches = final.sum(dim=1)
    fvals = torch.where(final, c, 0)
    k = min(top_k, T)
    idx = torch.arange(T, device=counts.device)
    key = (fvals << 16) | (0xFFFF - idx)
    top = torch.topk(key, k, dim=1).values  # keys are unique per row
    classified = n_matches > 0
    out = {
        "top_vals": (top >> 16).to(torch.int32),
        "top_idx": (0xFFFF - (top & 0xFFFF)).to(torch.int32),
        "n_matches": n_matches.to(torch.int32),
        "max_count": max_count.to(torch.int32),
        "disc_t": (kept & ~final).sum(dim=0).to(torch.int32),
        "seqs_classified": classified.sum(),
        "kmers_from_classified": torch.where(classified, n, 0).sum(),
        "kmers_matches": torch.where(classified, max_count, 0).sum(),
    }
    if emit_matches_t:
        out["matches_t"] = final.sum(dim=0).to(torch.int32)
    if winners is not None:
        out["top_win"] = torch.gather(
            winners, 1, out["top_idx"].to(torch.int64)).to(torch.int32)
    return out


def _pack_result(res: dict, n_hashes: torch.Tensor,
                 overflow: torch.Tensor) -> torch.Tensor:
    """Dense pack16 layout of ``ganon_tpu.classify.device._pack_result``
    (``match_cap=0``; ``with_win`` when ``res`` holds ``top_win``).

    ``[B*K] (count << 16 | target) | [B*K] winners (with top_win) |
    [B] n_matches | [B] max_count | [B] n_hashes | [B] overflow |
    [T] disc_t | [T] matches_t (when emitted) | 3 scalars``, all int32.
    """
    m = (res["top_vals"].to(torch.int64) << 16) | res["top_idx"].to(torch.int64)
    m = torch.where(m >= 1 << 31, m - (1 << 32), m)  # the int32 bit pattern
    parts = [m.reshape(-1)]
    if "top_win" in res:
        parts.append(res["top_win"])
    parts += [res["n_matches"], res["max_count"], n_hashes, overflow,
              res["disc_t"]]
    if "matches_t" in res:
        parts.append(res["matches_t"])
    parts.append(torch.stack([res["seqs_classified"],
                              res["kmers_from_classified"],
                              res["kmers_matches"]]))
    return torch.cat([p.reshape(-1).to(torch.int32) for p in parts])


def select(counts: torch.Tensor, n_hashes: torch.Tensor,
           overflow: torch.Tensor, rel_cutoff: float, rel_filter: float,
           hashes_limit: int, *, top_k: int, emit_matches_t: bool = True,
           uwin: torch.Tensor | None = None) -> torch.Tensor:
    """Thresholds, top-K and tallies of a counts matrix, packed (int32).

    Replaces ``ganon_tpu.classify.device.threshold_topk`` (``sort16``) +
    the dense pack16 branch of ``_pack_result``; unpack with
    :func:`unpack_batch_result`. Counts, target ids and ``hashes_limit``
    must fit 16 bits. ``uwin`` (int32 ``[B, T]``) adds the winners block
    of a multi-filter level (``with_win``).
    """
    B, T = counts.shape
    if counts.dtype != torch.int32 or n_hashes.dtype != torch.int32:
        raise ValueError("counts and n_hashes must be int32")
    if n_hashes.shape != (B,) or overflow.shape != (B,):
        raise ValueError("n_hashes and overflow must be [B]")
    if overflow.dtype != torch.uint8:
        raise ValueError("overflow must be u8")
    if T > 0xFFFF or hashes_limit > 0xFFFF:
        raise ValueError("the packed layout needs T and hashes_limit <= 0xFFFF")
    if uwin is not None and (uwin.dtype != torch.int32
                             or uwin.shape != counts.shape):
        raise ValueError("uwin must be int32 [B, T]")
    K = min(top_k, T)
    if counts.device.type == "cpu":
        res = threshold_topk(counts, n_hashes, rel_cutoff, rel_filter,
                             hashes_limit, top_k=top_k,
                             emit_matches_t=emit_matches_t, winners=uwin)
        return _pack_result(res, n_hashes, overflow.to(torch.int32))
    kernels.check_cuda(counts, n_hashes, overflow,
                       *([] if uwin is None else [uwin]))
    size = (B * K * (1 if uwin is None else 2) + 4 * B
            + T * (2 if emit_matches_t else 1) + 3)
    packed = torch.zeros((size,), dtype=torch.int32, device=counts.device)
    if B == 0:
        return packed
    kernels.launch(
        "select", counts, B, T, n_hashes, overflow, float(rel_cutoff),
        float(rel_filter),
        int(hashes_limit), K, int(bool(emit_matches_t)), uwin, packed,
        counter="select" if uwin is None else "select_winners",
    )
    return packed


def merge_plain(counts: torch.Tensor, n_hashes: torch.Tensor,
                rel_cutoff: float, hashes_limit: int, cols: torch.Tensor,
                f: int, ucounts: torch.Tensor, uwin: torch.Tensor) -> None:
    """Plain version of the ``merge`` kernel (see :func:`merge`)."""
    n = n_hashes.to(torch.int64)
    cutoff = torch.clamp(torch.ceil(n_hashes.to(torch.float64) * rel_cutoff),
                         min=1.0).to(torch.int64)
    valid = (n > 0) & (n <= hashes_limit)
    cand = torch.where((counts >= cutoff[:, None]) & valid[:, None], counts,
                       torch.zeros_like(counts))
    idx = cols.to(torch.int64)
    cur = ucounts[:, idx]
    better = cand > cur
    ucounts[:, idx] = torch.where(better, cand, cur)
    uwin[:, idx] = torch.where(better, torch.full_like(cur, f), uwin[:, idx])


def merge(counts: torch.Tensor, n_hashes: torch.Tensor, rel_cutoff: float,
          hashes_limit: int, cols: torch.Tensor, f: int,
          ucounts: torch.Tensor, uwin: torch.Tensor) -> None:
    """Merge filter ``f``'s clamped counts into the level's union, in place.

    Replaces the per-filter step of ``ganon_tpu.classify.device.
    classify_batch_packed_multi``: the filter's own rel-cutoff (float64,
    floor 1) on valid reads (``0 < n <= hashes_limit``), the scatter of
    its ``[B, T_f]`` counts into union columns ``cols`` (int32 ``[T_f]``,
    no repeats), and a strict-greater max into ``ucounts`` that records
    ``f`` in ``uwin`` (both int32 ``[B, U]``, zeroed before the first
    filter). Called in filter order, the first filter wins ties.
    """
    B, Tf = counts.shape
    U = ucounts.shape[1] if ucounts.dim() == 2 else -1
    if (counts.dtype != torch.int32 or n_hashes.dtype != torch.int32
            or cols.dtype != torch.int32 or ucounts.dtype != torch.int32
            or uwin.dtype != torch.int32):
        raise ValueError("merge takes int32 tensors")
    if (n_hashes.shape != (B,) or cols.shape != (Tf,)
            or ucounts.shape != (B, U) or uwin.shape != (B, U)):
        raise ValueError("shapes: counts [B, T_f], n [B], cols [T_f], "
                         "ucounts/uwin [B, U]")
    if counts.device.type == "cpu":
        merge_plain(counts, n_hashes, rel_cutoff, hashes_limit, cols, f,
                    ucounts, uwin)
        return
    kernels.check_cuda(counts, n_hashes, cols, ucounts, uwin)
    if B == 0 or Tf == 0:
        return
    kernels.launch("merge", counts, B, Tf, n_hashes, float(rel_cutoff),
                   int(hashes_limit), cols, int(f), ucounts, uwin, U)


def _extract_compact(inbuf: torch.Tensor, *, k: int, w: int, L1: int,
                     L2: int):
    """``extract`` at the compaction width of the bucketed mate widths."""
    m1 = max(L1 - w + 1, 1)
    m2 = max(L2 - w + 1, 1) if L2 else 0
    return extract_hashes(inbuf, k=k, w=w, L1=L1, L2=L2,
                          mc=compact_width(m1 + m2))


def classify_batch_packed(f: "DeviceFilter | DeviceHIBF",
                          inbuf: torch.Tensor,
                          rel_cutoff: float, rel_filter: float,
                          hashes_limit: int, *, k: int, w: int, L1: int,
                          L2: int, top_k: int,
                          emit_matches_t: bool = True) -> torch.Tensor:
    """One batch through extract -> count -> select: one int32 buffer.

    Port of ``ganon_tpu.classify.device.classify_batch_packed`` with
    ``pack16=True, match_cap=0``: the compaction width is
    ``compact_width(m1 + m2)`` of the bucketed mate widths; overflowing
    reads carry ``overflow`` and are re-run by the engine uncompacted.
    ``f`` may be a forest (:func:`classify_batch_packed_forest`).
    """
    hashes, n_hashes, overflow = _extract_compact(inbuf, k=k, w=w, L1=L1,
                                                  L2=L2)
    counts = f.counts(hashes, n_hashes)
    return select(counts, n_hashes, overflow, rel_cutoff, rel_filter,
                  hashes_limit, top_k=top_k, emit_matches_t=emit_matches_t)


def classify_batch_packed_forest(f: "DeviceHIBF", inbuf: torch.Tensor,
                                 rel_cutoff: float, rel_filter: float,
                                 hashes_limit: int, *, k: int, w: int,
                                 L1: int, L2: int, top_k: int,
                                 emit_matches_t: bool = True) -> torch.Tensor:
    """One batch against a native HIBF forest: one int32 buffer.

    Port of ``ganon_tpu.classify.device.classify_batch_packed_forest``
    (``pack16=True, match_cap=0``): ``extract`` once, ``count`` once per
    sub-IBF straight into its column range of one ``[B, T]`` matrix (the
    forest's target order is the concatenation of its subs'), then
    ``select`` on the whole matrix. Same layout as
    :func:`classify_batch_packed`.
    """
    if not (isinstance(f, DeviceHIBF) and f.contiguous):
        raise ValueError("the packed forest path needs a DeviceHIBF whose "
                         "target order is its subs' concatenation")
    return classify_batch_packed(
        f, inbuf, rel_cutoff, rel_filter, hashes_limit, k=k, w=w, L1=L1,
        L2=L2, top_k=top_k, emit_matches_t=emit_matches_t)


def classify_batch_packed_multi(filters: list, cols: list, inbuf: torch.Tensor,
                                rel_cutoffs: list, rel_filter: float,
                                hashes_limit: int, *, k: int, w: int, L1: int,
                                L2: int, num_union: int, top_k: int,
                                emit_matches_t: bool = True) -> torch.Tensor:
    """One batch against several flat filters of one level: one buffer.

    Port of ``ganon_tpu.classify.device.classify_batch_packed_multi``
    (``match_cap=0``): ``extract`` once; per filter ``count`` and
    ``merge`` (its own rel-cutoff, strict-greater union max, first filter
    wins ties) into ``[B, U]`` union counts and winners; then ``select``
    with ``rel_cutoff = 0`` (the cutoffs are applied, and its floor of 1
    drops the zeros) and the winners payload. ``cols[i]`` maps filter
    ``i``'s targets to union columns (int32, on the filters' device).
    Layout: ``[B*K] matches | [B*K] winners | [B] n_matches | ...``; the
    rel-filter's min count is taken over the final union, as the JAX
    package does (a deliberate difference from the C++ reference).
    """
    hashes, n_hashes, overflow = _extract_compact(inbuf, k=k, w=w, L1=L1,
                                                  L2=L2)
    B = hashes.shape[0]
    ucounts = torch.zeros((B, num_union), dtype=torch.int32,
                          device=hashes.device)
    uwin = torch.zeros_like(ucounts)
    for fi, (f, c, rc) in enumerate(zip(filters, cols, rel_cutoffs)):
        merge(f.counts(hashes, n_hashes), n_hashes, rc, hashes_limit, c, fi,
              ucounts, uwin)
    return select(ucounts, n_hashes, overflow, 0.0, rel_filter, hashes_limit,
                  top_k=top_k, emit_matches_t=emit_matches_t, uwin=uwin)


def unpack_batch_result(packed: np.ndarray, B: int, K: int, T: int,
                        has_matches_t: bool = True,
                        has_win: bool = False) -> dict:
    """Split a packed batch result back into the result dict
    (``top_win`` is None unless ``has_win``)."""
    o = 0

    def take(n, shape=None):
        nonlocal o
        v = packed[o:o + n]
        o += n
        return v.reshape(shape) if shape is not None else v

    m = take(B * K, (B, K)).view(np.uint32)
    out = {
        "top_vals": (m >> 16).astype(np.int32),
        "top_idx": (m & 0xFFFF).astype(np.int32),
        "top_win": take(B * K, (B, K)) if has_win else None,
        "n_matches": take(B),
        "max_count": take(B),
        "n_hashes": take(B),
        "overflow": take(B).astype(bool),
        "disc_t": take(T),
    }
    if has_matches_t:
        out["matches_t"] = take(T)
    scalars = take(3)
    out["seqs_classified"] = scalars[0]
    out["kmers_from_classified"] = scalars[1]
    out["kmers_matches"] = scalars[2]
    return out


def _resolve_device(device) -> torch.device:
    """``device`` with the CUDA index filled in; raises without CUDA."""
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    return d


class DeviceFilter:
    """A flat IBF resident on one device, ready for batched counting.

    The interleaved bit-matrix is repacked once (``pack_table_u8``, W8
    padded to whole u32 words because the ``count`` kernel reads words)
    and moved to ``device``; nothing else is copied per batch.
    """

    def __init__(self, ibf, device="cuda"):
        self.device = _resolve_device(device)
        self.ibf_config = ibf.ibf_config
        self.targets = ibf.targets()
        self.num_targets = len(self.targets)
        tbl8, byte_starts, byte_ends = pack_table_u8(
            ibf.bits, ibf.bin_to_target_ids(), self.num_targets
        )
        self.tbl8 = torch.from_numpy(table_as_u32(tbl8).view(np.uint8)).to(
            self.device)
        self.byte_starts = torch.from_numpy(byte_starts).to(self.device)
        self.byte_ends = torch.from_numpy(byte_ends).to(self.device)
        self.target_fpr = ibf.target_fpr()

    def to(self, device) -> "DeviceFilter":
        """The same filter with its tables on ``device`` (no repack)."""
        out = copy.copy(self)
        out.device = _resolve_device(device)
        for name in ("tbl8", "byte_starts", "byte_ends"):
            setattr(out, name, getattr(self, name).to(out.device))
        return out

    def counts(self, hashes: torch.Tensor, n_hashes: torch.Tensor, *,
               out: torch.Tensor | None = None, col0: int = 0) -> torch.Tensor:
        """Clamped per-target counts (int32 ``[B, T]``) of compacted hashes
        (into ``out[:, col0:col0 + T]`` when given: forest mode)."""
        return target_counts(
            self.tbl8, self.byte_starts, self.byte_ends, hashes, n_hashes,
            bin_size=self.ibf_config.bin_size_bits,
            hash_functions=self.ibf_config.hash_functions, out=out, col0=col0,
        )


class DeviceHIBF:
    """A native size-stratified IBF forest on one device.

    Port of ``ganon_tpu.classify.device.DeviceHIBF``: each sub-IBF is a
    :class:`DeviceFilter`; ``sub_cols`` maps each sub's targets to the
    forest's columns, which are the concatenation of the subs' targets
    (``contiguous``, true for every forest ``build_hibf`` writes). Same
    interface as :class:`DeviceFilter`.
    """

    def __init__(self, hibf, device="cuda"):
        self.device = _resolve_device(device)
        self.ibf_config = hibf.ibf_config
        self.targets = hibf.targets()
        self.num_targets = len(self.targets)
        tid = {t: i for i, t in enumerate(self.targets)}
        self.subs = [DeviceFilter(s, self.device) for s in hibf.subs]
        self.sub_cols = [
            np.asarray([tid[t] for t in s.targets], dtype=np.int32)
            for s in self.subs
        ]
        off = 0
        self.contiguous = True
        for cols in self.sub_cols:
            if not np.array_equal(cols, np.arange(off, off + len(cols))):
                self.contiguous = False
                break
            off += len(cols)
        self.target_fpr = hibf.target_fpr()

    def to(self, device) -> "DeviceHIBF":
        """The same forest with its tables on ``device`` (no repack)."""
        out = copy.copy(self)
        out.device = _resolve_device(device)
        out.subs = [s.to(out.device) for s in self.subs]
        return out

    def counts(self, hashes: torch.Tensor, n_hashes: torch.Tensor) -> torch.Tensor:
        """Clamped counts (int32 ``[B, T]``): each sub counts into its
        columns of one matrix (``count`` in forest mode)."""
        out = torch.zeros((hashes.shape[0], self.num_targets),
                          dtype=torch.int32, device=hashes.device)
        for sub, cols in zip(self.subs, self.sub_cols):
            if not len(cols):
                continue
            if self.contiguous:
                sub.counts(hashes, n_hashes, out=out, col0=int(cols[0]))
            else:
                idx = torch.from_numpy(cols.astype(np.int64)).to(out.device)
                out[:, idx] = sub.counts(hashes, n_hashes)
        return out


# filters of recently opened files, keyed by (path, mtime, size) as the
# JAX package memoizes them: repacking a multi-GB filter costs tens of
# seconds and uploading it a fraction of one, and runs in one process
# (tests, benchmarks, a hierarchy's several databases) reopen the same
# files. Four, as the JAX package keeps.
_FILTER_CACHE: dict = {}
_FILTER_CACHE_CAP = 4


def _open_filter(path: str, device):
    """A fresh device filter for ``path`` (flat ``.ibf`` or native forest)."""
    from ganon_tpu_torch.index.hibf import (
        HIBF, is_pruned_file, is_raptor_hibf,
    )
    from ganon_tpu_torch.index.ibf import IBF

    if not path.endswith(".hibf"):
        return DeviceFilter(IBF.load(path), device)
    if is_pruned_file(path):
        raise NotImplementedError(
            f"{path}: pruned HIBF forests are not ported yet (ROADMAP "
            "queue 1, item 9 'Pruned forest')"
        )
    if not zipfile.is_zipfile(path) and is_raptor_hibf(path):
        raise NotImplementedError(
            f"{path}: raptor-format HIBF files are not ported yet (ROADMAP "
            "queue 1, item 5c 'The cereal codec', then item 8's raptor "
            "half); convert with ganon_tpu or build a native forest"
        )
    return DeviceHIBF(HIBF.load(path), device)


def load_device_filter(path: str, device="cuda"):
    """Open a flat ``.ibf`` or a native forest ``.hibf`` on ``device``.

    Both come as npz or raw containers. ``.hibf`` files are sniffed as
    the JAX package does: a pruned forest or a raptor archive raises
    NotImplementedError naming its ROADMAP item; anything else opens as
    a :class:`DeviceHIBF`.
    """
    device = _resolve_device(device)
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
    f = _FILTER_CACHE.pop(key, None)
    if f is None:
        f = _open_filter(path, device)
    elif f.device != device:
        f = f.to(device)
    while len(_FILTER_CACHE) >= _FILTER_CACHE_CAP:
        _FILTER_CACHE.pop(next(iter(_FILTER_CACHE)))
    _FILTER_CACHE[key] = f
    return f
