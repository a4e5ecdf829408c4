"""Device-side classify compute for one flat IBF: extract, count, select.

Port of the flat subset of ``ganon_tpu.classify.device``. A batch costs
one host->device buffer (:func:`pack_batch_direct`), three kernels
(``extract`` -> ``count`` -> ``select``, :func:`classify_batch_packed`)
and one int32 result buffer, whose dense layout
:func:`unpack_batch_result` splits. Every function takes tensors on one
explicit device; on the CPU the kernels' plain torch versions run.
"""

from __future__ import annotations

import copy
import os

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
                   top_k: int, emit_matches_t: bool = True) -> dict:
    """Plain version of the ``select`` kernel's thresholds and top-K.

    Reference threshold semantics (GanonClassify.cpp:719-758) with the
    cutoff math in float64. The top ``K = min(top_k, T)`` entries are
    ordered by the key ``count << 16 | (0xFFFF - idx)`` over the
    finally-kept counts (0 elsewhere), held in int64: descending count,
    ascending index on ties. Returns the dict of
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
    return out


def _pack_result(res: dict, n_hashes: torch.Tensor,
                 overflow: torch.Tensor) -> torch.Tensor:
    """Dense pack16 layout of ``ganon_tpu.classify.device._pack_result``.

    ``[B*K] (count << 16 | target) | [B] n_matches | [B] max_count |
    [B] n_hashes | [B] overflow | [T] disc_t | [T] matches_t (when
    emitted) | 3 scalars``, all int32.
    """
    m = (res["top_vals"].to(torch.int64) << 16) | res["top_idx"].to(torch.int64)
    m = torch.where(m >= 1 << 31, m - (1 << 32), m)  # the int32 bit pattern
    parts = [m.reshape(-1), res["n_matches"], res["max_count"], n_hashes,
             overflow, res["disc_t"]]
    if "matches_t" in res:
        parts.append(res["matches_t"])
    parts.append(torch.stack([res["seqs_classified"],
                              res["kmers_from_classified"],
                              res["kmers_matches"]]))
    return torch.cat([p.reshape(-1).to(torch.int32) for p in parts])


def select(counts: torch.Tensor, n_hashes: torch.Tensor,
           overflow: torch.Tensor, rel_cutoff: float, rel_filter: float,
           hashes_limit: int, *, top_k: int,
           emit_matches_t: bool = True) -> torch.Tensor:
    """Thresholds, top-K and tallies of a counts matrix, packed (int32).

    Replaces ``ganon_tpu.classify.device.threshold_topk`` (``sort16``) +
    the dense pack16 branch of ``_pack_result``; unpack with
    :func:`unpack_batch_result`. Counts, target ids and ``hashes_limit``
    must fit 16 bits.
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
    K = min(top_k, T)
    if counts.device.type == "cpu":
        res = threshold_topk(counts, n_hashes, rel_cutoff, rel_filter,
                             hashes_limit, top_k=top_k,
                             emit_matches_t=emit_matches_t)
        return _pack_result(res, n_hashes, overflow.to(torch.int32))
    kernels.check_cuda(counts, n_hashes, overflow)
    size = B * K + 4 * B + T * (2 if emit_matches_t else 1) + 3
    packed = torch.zeros((size,), dtype=torch.int32, device=counts.device)
    if B == 0:
        return packed
    kernels.launch(
        "select", counts, B, T, n_hashes, overflow, float(rel_cutoff),
        float(rel_filter),
        int(hashes_limit), K, int(bool(emit_matches_t)), packed,
    )
    return packed


def classify_batch_packed(f: "DeviceFilter", inbuf: torch.Tensor,
                          rel_cutoff: float, rel_filter: float,
                          hashes_limit: int, *, k: int, w: int, L1: int,
                          L2: int, top_k: int,
                          emit_matches_t: bool = True) -> torch.Tensor:
    """One batch through extract -> count -> select: one int32 buffer.

    Port of ``ganon_tpu.classify.device.classify_batch_packed`` with
    ``pack16=True, match_cap=0``: the compaction width is
    ``compact_width(m1 + m2)`` of the bucketed mate widths; overflowing
    reads carry ``overflow`` and are re-run by the engine uncompacted.
    """
    m1 = max(L1 - w + 1, 1)
    m2 = max(L2 - w + 1, 1) if L2 else 0
    hashes, n_hashes, overflow = extract_hashes(
        inbuf, k=k, w=w, L1=L1, L2=L2, mc=compact_width(m1 + m2)
    )
    counts = f.counts(hashes, n_hashes)
    return select(counts, n_hashes, overflow, rel_cutoff, rel_filter,
                  hashes_limit, top_k=top_k, emit_matches_t=emit_matches_t)


def unpack_batch_result(packed: np.ndarray, B: int, K: int, T: int,
                        has_matches_t: bool = True) -> dict:
    """Split a :func:`classify_batch_packed` fetch back into the result dict."""
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

    def counts(self, hashes: torch.Tensor, n_hashes: torch.Tensor) -> torch.Tensor:
        """Clamped per-target counts (int32 ``[B, T]``) of compacted hashes."""
        return target_counts(
            self.tbl8, self.byte_starts, self.byte_ends, hashes, n_hashes,
            bin_size=self.ibf_config.bin_size_bits,
            hash_functions=self.ibf_config.hash_functions,
        )


# filters of recently opened files, keyed by (path, mtime, size) as the
# JAX package memoizes them: repacking a multi-GB filter costs tens of
# seconds and uploading it a fraction of one, and runs in one process
# (tests, benchmarks) reopen the same file
_FILTER_CACHE: dict = {}
_FILTER_CACHE_CAP = 2


def load_device_filter(path: str, device="cuda") -> DeviceFilter:
    """Open a flat ``.ibf`` (npz or raw container) on ``device``."""
    from ganon_tpu_torch.index.ibf import IBF

    if path.endswith(".hibf"):
        raise NotImplementedError(
            f"{path}: HIBF filters are not ported yet (ROADMAP queue 1, "
            "item 8 'HIBF'; pruned forests item 9)"
        )
    device = _resolve_device(device)
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
    f = _FILTER_CACHE.pop(key, None)
    if f is None:
        f = DeviceFilter(IBF.load(path), device)
    elif f.device != device:
        f = f.to(device)
    while len(_FILTER_CACHE) >= _FILTER_CACHE_CAP:
        _FILTER_CACHE.pop(next(iter(_FILTER_CACHE)))
    _FILTER_CACHE[key] = f
    return f
