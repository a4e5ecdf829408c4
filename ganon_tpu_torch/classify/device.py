"""Device-side classify compute: extract, count, (merge,) select.

Port of ``ganon_tpu.classify.device`` for flat IBFs, native HIBF forests,
merged-bin pruned forests and levels of several flat filters. A batch
costs one host->device
buffer (:func:`pack_batch_direct`), the kernels of its filter kind and
one int32 result buffer, whose dense layout :func:`unpack_batch_result`
splits (and whose ragged match stream, the JAX engine's default
transfer, :func:`ragged` makes and :func:`unpack_batch_result_ragged`
splits):

* a flat IBF: ``extract`` -> ``count`` -> ``select``
  (:func:`classify_batch_packed`);
* a forest (:class:`DeviceHIBF`): ``extract``, then ``count`` once per
  sub-IBF into its columns of one matrix, then ``select``
  (:func:`classify_batch_packed_forest`);
* a raptor ``.hibf`` (:class:`DeviceRaptorHIBF`): ``extract``, then
  ``count`` in column-max mode over every sub-IBF in one launch
  (a user bin may sit in several sub-IBFs), then ``select``
  (:func:`classify_batch_packed`, through :meth:`DeviceRaptorHIBF.counts`);
* several flat filters on one level: ``extract``, then per filter
  ``count``, then one ``merge`` of the level into the union counts and
  winners, then ``select`` with the winners payload
  (:func:`classify_batch_packed_multi`);
* a pruned forest (:class:`DevicePrunedForest`): ``extract``, ``gate``
  (coarse group counts, top-S surviving groups), ``fine`` on those
  groups' lanes, then ``select`` in lanes mode with the group words
  (:func:`classify_batch_packed_pruned`); its exact fallback counts every
  group through ``gate`` and ``fine`` in probe-all mode
  (:meth:`DevicePrunedForest.counts_gated`).

A flat filter, forest or raptor archive of more than 65,535 targets, or
a ``hashes_limit`` above 65,535 (``--longreads``), takes ``select``'s
32-bit mode (``pack16=False``: counts and target ids in two blocks).
Every function takes tensors on one explicit device; on the CPU the
kernels' plain torch versions run.

Device meshes (K17, :class:`ganon_tpu_torch.parallel.mesh.Mesh`): with
``mesh`` a filter's batch rows split over the mesh's ``batch`` axis
(:meth:`DeviceFilter.put_batch`), each row extracting on its first
device. A flat filter's packed table is column-sharded over the ``bins``
axis (:class:`ShardedTable`: ``count`` per shard with the clamp off, then
``combine`` sums and clamps on the row's first device); a forest shards
every sub, a raptor archive every sub's table (sum, clamp, then the
column max); a pruned forest replicates both tables on each row. Every
row's results are gathered on the filter's home device (``device``) for
``select``. A filter is cut into its shards from its packed table on the
card (``with_mesh``), never by a second host repack.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import warnings
import zipfile

import numpy as np
import torch

from ganon_tpu_torch import kernels, trace
from ganon_tpu_torch.ops.ibf_query import (
    bits_tensor,
    bulk_target_counts_packed,
    clz64,
    combine,
    count_writes_every_cell,
    extract,
    probe_sort,
    raptor_target_counts,
    repack_plan,
    repack_shards,
    repack_table,
    shard_table,
    sub_descriptors,
    table_as_u32,
)
from ganon_tpu_torch.ops.pruned_query import (
    MAX_GROUPS,
    NO_HASHES_LIMIT,
    fine_counts,
    gate,
    pair_live,
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


def _lane_live(gsel: torch.Tensor, slot_ok: torch.Tensor,
               grp_ntargets: torch.Tensor, group_size: int) -> torch.Tensor:
    """bool ``[B, S*gs]``: the live lanes of the chosen groups."""
    nt = torch.where(slot_ok.bool(), grp_ntargets[gsel.to(torch.int64)], 0)
    lane = torch.arange(group_size, device=gsel.device)
    return (lane[None, None, :] < nt[:, :, None]).reshape(gsel.shape[0], -1)


def threshold_topk(counts: torch.Tensor, n_hashes: torch.Tensor,
                   rel_cutoff: float, rel_filter: float, hashes_limit: int, *,
                   top_k: int, emit_matches_t: bool = True,
                   winners: torch.Tensor | None = None,
                   lanes: tuple | None = None, pack16: bool = True) -> dict:
    """Plain version of the ``select`` kernel's thresholds and top-K.

    Reference threshold semantics (GanonClassify.cpp:719-758) with the
    cutoff math in float64. The top ``K = min(top_k, T)`` entries are
    ordered by the key ``count << 16 | (0xFFFF - idx)`` over the
    finally-kept counts (0 elsewhere), held in int64: descending count,
    ascending index on ties. ``pack16=False`` (the 32-bit mode, JAX's
    ``sort16=False`` and its ``lax.top_k``) keys ``count << 32 |
    (0xFFFFFFFF - idx)``: the same order for counts and ids past 16
    bits (counts stay below 2^31, so the key stays positive). ``winners`` (int32 ``[B, T]``, the winning
    filter per union column) adds ``top_win``, each entry's
    ``winners[b, top_idx]``. Returns the dict of
    ``ganon_tpu.classify.device.threshold_topk`` (int32 arrays; the three
    scalars as int64).

    Lanes mode (``ganon_tpu.classify.device.threshold_topk_ids`` with the
    pruned kernel's group tallies): ``lanes = (gsel, slot_ok,
    grp_ntargets, group_size, num_targets)`` makes the columns the
    ``C = S * group_size`` lanes of the chosen groups. Dead lanes are
    never kept and take the sentinel id ``C`` in the key; ``disc_t`` and
    ``matches_t`` are ``[num_targets]``, added at ``gsel * gs + lane``.
    """
    T = counts.shape[1]
    c = counts.to(torch.int64)
    n = n_hashes.to(torch.int64)
    nh = n_hashes.to(torch.float64)
    cutoff = torch.clamp(torch.ceil(nh * rel_cutoff), min=1.0).to(torch.int64)
    valid = (n > 0) & (n <= hashes_limit)
    kept = (c >= cutoff[:, None]) & valid[:, None]
    idx = torch.arange(T, device=counts.device)
    ids = idx[None, :]
    if lanes is not None:
        gsel, slot_ok, grp_ntargets, gs, num_targets = lanes
        live = _lane_live(gsel, slot_ok, grp_ntargets, gs)
        kept = kept & live
        ids = torch.where(live, idx[None, :], T)
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
    bits = 16 if pack16 else 32
    mask = (1 << bits) - 1
    key = (fvals << bits) | (mask - ids)
    # keys are unique per row but for the sentinel entries, which are equal
    top = torch.topk(key, k, dim=1).values
    classified = n_matches > 0
    out = {
        "top_vals": (top >> bits).to(torch.int32),
        "top_idx": (mask - (top & mask)).to(torch.int32),
        "n_matches": n_matches.to(torch.int32),
        "max_count": max_count.to(torch.int32),
        "seqs_classified": classified.sum(),
        "kmers_from_classified": torch.where(classified, n, 0).sum(),
        "kmers_matches": torch.where(classified, max_count, 0).sum(),
    }
    disc = kept & ~final
    if lanes is None:
        out["disc_t"] = disc.sum(dim=0).to(torch.int32)
        if emit_matches_t:
            out["matches_t"] = final.sum(dim=0).to(torch.int32)
    else:
        # global target of each lane (live lanes only carry a tally)
        B = counts.shape[0]
        g = gsel.to(torch.int64)[:, :, None] * gs + torch.arange(
            gs, device=counts.device)
        tgt = g.reshape(B, -1)
        for name, m in (("disc_t", disc), ("matches_t", final)):
            if name == "matches_t" and not emit_matches_t:
                continue
            t = torch.zeros((num_targets,), dtype=torch.int64,
                            device=counts.device)
            t.index_add_(0, tgt[m], torch.ones_like(tgt[m]))
            out[name] = t.to(torch.int32)
    if winners is not None:
        out["top_win"] = torch.gather(
            winners, 1, out["top_idx"].to(torch.int64)).to(torch.int32)
    return out


def _pack_result(res: dict, n_hashes: torch.Tensor,
                 overflow: torch.Tensor, extra_rows: tuple = (), *,
                 pack16: bool = True) -> torch.Tensor:
    """Dense layout of ``ganon_tpu.classify.device._pack_result``
    (``match_cap=0``; ``with_win`` when ``res`` holds ``top_win``).

    ``[B*K] (count << 16 | target) | [B*K] winners (with top_win) |
    [B] n_matches | [B] max_count | [B] n_hashes | [B] overflow |
    [B] per extra row | [T] disc_t | [T] matches_t (when emitted) |
    3 scalars``, all int32; ``pack16=False`` ships ``[B*K] counts |
    [B*K] targets`` in place of the packed block.
    """
    if pack16:
        m = ((res["top_vals"].to(torch.int64) << 16)
             | res["top_idx"].to(torch.int64))
        m = torch.where(m >= 1 << 31, m - (1 << 32), m)  # int32 bit pattern
        parts = [m.reshape(-1)]
    else:
        parts = [res["top_vals"].reshape(-1), res["top_idx"].reshape(-1)]
    if "top_win" in res:
        parts.append(res["top_win"])
    parts += [res["n_matches"], res["max_count"], n_hashes, overflow,
              *extra_rows, res["disc_t"]]
    if "matches_t" in res:
        parts.append(res["matches_t"])
    parts.append(torch.stack([res["seqs_classified"],
                              res["kmers_from_classified"],
                              res["kmers_matches"]]))
    return torch.cat([p.reshape(-1).to(torch.int32) for p in parts])


def select(counts: torch.Tensor, n_hashes: torch.Tensor,
           overflow: torch.Tensor, rel_cutoff: float, rel_filter: float,
           hashes_limit: int, *, top_k: int, emit_matches_t: bool = True,
           uwin: torch.Tensor | None = None,
           pack16: bool = True) -> torch.Tensor:
    """Thresholds, top-K and tallies of a counts matrix, packed (int32).

    Replaces ``ganon_tpu.classify.device.threshold_topk`` + the dense
    branch of ``_pack_result``; unpack with :func:`unpack_batch_result`.
    With ``pack16`` (``sort16``) counts, target ids and ``hashes_limit``
    must fit 16 bits; ``uwin`` (int32 ``[B, T]``) adds the winners block
    of a multi-filter level (``with_win``). ``pack16=False`` launches the
    32-bit mode (``sort16=False``): counts and ids ship in two blocks, and
    there is no winners block, as in the JAX package.
    """
    B, T = counts.shape
    if counts.dtype != torch.int32 or n_hashes.dtype != torch.int32:
        raise ValueError("counts and n_hashes must be int32")
    if n_hashes.shape != (B,) or overflow.shape != (B,):
        raise ValueError("n_hashes and overflow must be [B]")
    if overflow.dtype != torch.uint8:
        raise ValueError("overflow must be u8")
    if pack16 and (T > 0xFFFF or hashes_limit > 0xFFFF):
        raise ValueError("the packed layout needs T and hashes_limit <= 0xFFFF")
    if not pack16 and uwin is not None:
        raise ValueError("the winners payload needs the packed layout")
    if uwin is not None and (uwin.dtype != torch.int32
                             or uwin.shape != counts.shape):
        raise ValueError("uwin must be int32 [B, T]")
    K = min(top_k, T)
    if counts.device.type == "cpu":
        res = threshold_topk(counts, n_hashes, rel_cutoff, rel_filter,
                             hashes_limit, top_k=top_k,
                             emit_matches_t=emit_matches_t, winners=uwin,
                             pack16=pack16)
        return _pack_result(res, n_hashes, overflow.to(torch.int32),
                            pack16=pack16)
    kernels.check_cuda(counts, n_hashes, overflow,
                       *([] if uwin is None else [uwin]))
    size = (B * K * (1 if uwin is None and pack16 else 2) + 4 * B
            + T * (2 if emit_matches_t else 1) + 3)
    packed = torch.zeros((size,), dtype=torch.int32, device=counts.device)
    if B == 0:
        return packed
    if not pack16:
        kernels.launch(
            "select32", counts, B, T, n_hashes, overflow, float(rel_cutoff),
            float(rel_filter), int(hashes_limit), K,
            int(bool(emit_matches_t)), packed)
        return packed
    kernels.launch(
        "select", counts, B, T, n_hashes, overflow, float(rel_cutoff),
        float(rel_filter),
        int(hashes_limit), K, int(bool(emit_matches_t)), uwin, packed,
        counter="select" if uwin is None else "select_winners",
    )
    return packed


def _dense_tail(B: int, K: int, has_win: bool, n_extra: int,
                size: int) -> int:
    """Elements after the extra rows of a dense pack16 buffer (the
    tallies and the 3 scalars)."""
    return size - B * K * (2 if has_win else 1) - (4 + n_extra) * B


def ragged_plain(dense: torch.Tensor, B: int, K: int, match_cap: int, *,
                 has_win: bool = False, n_extra: int = 0) -> torch.Tensor:
    """Plain version of the ``ragged`` kernel (see :func:`ragged`)."""
    C = match_cap
    tail = _dense_tail(B, K, has_win, n_extra, dense.numel())
    d = dense.to(torch.int64)
    o = B * K * (2 if has_win else 1)
    nm, maxc, nh, ovf = (d[o + i * B:o + (i + 1) * B] for i in range(4))
    vmask = (torch.arange(K, device=dense.device)[None, :]
             < nm[:, None]).reshape(-1)
    pos = torch.cumsum(vmask.to(torch.int64), 0) - 1
    dst = torch.where(vmask & (pos < C), pos, C)
    parts = []
    for blk in range(2 if has_win else 1):
        comp = torch.zeros((C + 1,), dtype=torch.int32, device=dense.device)
        comp.scatter_(0, dst, dense[blk * B * K:(blk + 1) * B * K])
        parts.append(comp[:C])
    w1 = (maxc << 16) | nm
    w2 = (torch.clamp(nh, max=0x1FFFF) << 1) | (ovf & 1)
    for w in (w1, w2):
        parts.append(torch.where(w >= 1 << 31, w - (1 << 32), w).to(
            torch.int32))
    parts.append(dense[o + 4 * B:o + (4 + n_extra) * B + tail])
    return torch.cat(parts)


# reads a block of the ragged kernel's chained scan (csrc/scan.cu
# kRaggedReads): its status words come from kernels.scan_status
RAGGED_READS = 256


def ragged(dense: torch.Tensor, B: int, K: int, match_cap: int, *,
           has_win: bool = False, n_extra: int = 0) -> torch.Tensor:
    """The ragged match stream of a dense pack16 result buffer (int32).

    Port of ``ganon_tpu.classify.device._pack_result`` with ``match_cap >
    0`` (``device.py:280-309``), applied to the dense buffer of
    :func:`select` or :func:`select_lanes` (``[B*K]`` matches, ``[B*K]``
    winners with ``has_win``, the four ``[B]`` rows, ``n_extra`` extra
    rows, the tallies and scalars). Layout: ``[C] (count << 16 | target)``
    of the valid entries (``k < n_matches``) row by row, those past ``C =
    match_cap`` dropped | ``[C]`` winners with ``has_win`` | ``[B]
    max_count << 16 | n_matches`` | ``[B] min(n_hashes, 0x1FFFF) << 1 |
    overflow`` | the extra rows | the tallies and scalars. Unpack with
    :func:`unpack_batch_result_ragged`, which reports the cap overflow.
    """
    if dense.dtype != torch.int32 or dense.dim() != 1:
        raise ValueError("dense must be a flat int32 buffer")
    if K < 1 or match_cap < 1 or n_extra < 0:
        raise ValueError("ragged takes K >= 1, match_cap >= 1, n_extra >= 0")
    tail = _dense_tail(B, K, has_win, n_extra, dense.numel())
    if tail < 3:
        raise ValueError("dense is shorter than its layout")
    if dense.device.type == "cpu":
        return ragged_plain(dense, B, K, match_cap, has_win=has_win,
                            n_extra=n_extra)
    kernels.check_cuda(dense)
    C = match_cap
    if not B:
        out = torch.zeros((C * (2 if has_win else 1) + tail,),
                          dtype=torch.int32, device=dense.device)
        out[C * (2 if has_win else 1):] = dense
        return out
    if B * K >= 1 << 31:
        raise ValueError("ragged takes B * K below 2^31")
    # the kernel writes every word (the stream slots it leaves read 0)
    out = torch.empty((C * (2 if has_win else 1) + (2 + n_extra) * B + tail,),
                      dtype=torch.int32, device=dense.device)
    status, epoch = kernels.scan_status(dense.device, -(-B // RAGGED_READS))
    kernels.launch("ragged", dense, B, K, int(has_win), n_extra, tail, C,
                   status, epoch, out,
                   counter="ragged_winners" if has_win else "ragged")
    return out


def _ragged_or_dense(packed: torch.Tensor, B: int, K: int, match_cap: int,
                     **kw) -> torch.Tensor:
    """``packed`` as it is at ``match_cap == 0``, else its ragged stream."""
    if not match_cap:
        return packed
    return ragged(packed, B, K, match_cap, **kw)


def group_words(gsel: torch.Tensor, slot_ok: torch.Tensor) -> tuple:
    """The pruned result's ``ceil(S/2)`` int32 ``[B]`` rows of chosen
    groups: ``gsel[2i] | gsel[2i+1] << 16``, 0xFFFF for a dead slot and
    for the missing high half of an odd S."""
    g = torch.where(slot_ok.bool(), gsel.to(torch.int64), 0xFFFF)
    S = g.shape[1]
    words = []
    for i in range(-(-S // 2)):
        hi = g[:, 2 * i + 1] if 2 * i + 1 < S else 0xFFFF
        w = g[:, 2 * i] | (hi << 16)
        words.append(torch.where(w >= 1 << 31, w - (1 << 32), w))
    return tuple(w.to(torch.int32) for w in words)


def select_lanes(counts: torch.Tensor, n_hashes: torch.Tensor,
                 overflow: torch.Tensor, gsel: torch.Tensor,
                 slot_ok: torch.Tensor, grp_ntargets: torch.Tensor,
                 rel_cutoff: float, rel_filter: float, hashes_limit: int, *,
                 group_size: int, num_targets: int, top_k: int,
                 emit_matches_t: bool = True) -> torch.Tensor:
    """Thresholds, top-K, group tallies and group words of a pruned
    forest's lane counts, packed (int32).

    Replaces ``ganon_tpu.classify.device.threshold_topk_ids``
    (``tallies=False``) and the lane ids, group-indexed tallies, group
    words and ``_pack_result(extra_rows=...)`` of
    ``classify_batch_packed_pruned``. ``counts`` int32 ``[B, C]`` with
    ``C = S * group_size`` (the ``fine`` kernel's ``[B, S, gs]``),
    ``gsel``/``slot_ok`` the gate's ``[B, S]``, ``grp_ntargets`` int32
    ``[G]``. Top entries are lane ids (``slot * gs + j``, sentinel ``C``
    for dead lanes); ``disc_t``/``matches_t`` are ``[num_targets]``.
    Layout: :func:`_pack_result` with ``ceil(S/2)`` extra rows.
    """
    B, C = counts.shape
    S = gsel.shape[1] if gsel.dim() == 2 else -1
    if counts.dtype != torch.int32 or n_hashes.dtype != torch.int32:
        raise ValueError("counts and n_hashes must be int32")
    if n_hashes.shape != (B,) or overflow.shape != (B,) or (
            overflow.dtype != torch.uint8):
        raise ValueError("n_hashes int32 [B], overflow u8 [B]")
    if (gsel.dtype != torch.int32 or gsel.shape != (B, S)
            or slot_ok.dtype != torch.uint8 or slot_ok.shape != (B, S)
            or grp_ntargets.dtype != torch.int32):
        raise ValueError("gsel int32 [B, S], slot_ok u8 [B, S], "
                         "grp_ntargets int32 [G]")
    if not 1 <= S <= MAX_GROUPS or C != S * group_size:
        raise ValueError(f"counts must be [B, S * group_size], S <= {MAX_GROUPS}")
    if C > 0xFFFF or hashes_limit > 0xFFFF:
        raise ValueError("the packed layout needs C and hashes_limit <= 0xFFFF")
    K = min(top_k, C)
    if counts.device.type == "cpu":
        res = threshold_topk(
            counts, n_hashes, rel_cutoff, rel_filter, hashes_limit, top_k=K,
            emit_matches_t=emit_matches_t,
            lanes=(gsel, slot_ok, grp_ntargets, group_size, num_targets))
        return _pack_result(res, n_hashes, overflow.to(torch.int32),
                            group_words(gsel, slot_ok))
    kernels.check_cuda(counts, n_hashes, overflow, gsel, slot_ok,
                       grp_ntargets)
    size = (B * K + (4 + -(-S // 2)) * B
            + num_targets * (2 if emit_matches_t else 1) + 3)
    packed = torch.zeros((size,), dtype=torch.int32, device=counts.device)
    if B == 0:
        return packed
    kernels.launch(
        "select_lanes", counts, B, C, n_hashes, overflow, float(rel_cutoff),
        float(rel_filter), int(hashes_limit), K, int(bool(emit_matches_t)),
        gsel, slot_ok, grp_ntargets, S, group_size, num_targets, packed,
    )
    return packed


# filters a merge launch takes (csrc/merge.cu kMaxFilters); a level of
# more takes further launches, each merging into what the one before wrote
MERGE_MAX_FILTERS = 16


def merge_colmap(cols: list, num_union: int, device=None) -> torch.Tensor:
    """A level's inverse column map for :func:`merge`: int32 ``[F, U]``,
    filter ``f``'s local target at union column ``u``, or -1 where ``f``
    does not hold ``u``. ``cols[f]`` maps filter ``f``'s targets to union
    columns (no column twice); a level's columns are fixed, so the map is
    built once a level, not a batch."""
    m = np.full((len(cols), num_union), -1, dtype=np.int32)
    for f, c in enumerate(cols):
        c = np.asarray(c.cpu() if isinstance(c, torch.Tensor) else c,
                       dtype=np.int64)
        if c.size and (c.min() < 0 or c.max() >= num_union
                       or np.unique(c).size != c.size):
            raise ValueError(f"filter {f}: union columns must be distinct "
                             f"and in [0, {num_union})")
        m[f, c] = np.arange(c.size, dtype=np.int32)
    return torch.from_numpy(m).to(device or "cpu")


def merge_plain(counts: list, n_hashes: torch.Tensor, rel_cutoffs: list,
                hashes_limit: int, colmap: torch.Tensor,
                ucounts: torch.Tensor, uwin: torch.Tensor, *,
                f0: int = 0) -> None:
    """Plain version of the ``merge`` kernel (see :func:`merge`)."""
    n = n_hashes.to(torch.int64)
    valid = ((n > 0) & (n <= hashes_limit))[:, None]
    best = torch.zeros_like(ucounts) if f0 == 0 else ucounts.clone()
    win = torch.zeros_like(uwin) if f0 == 0 else uwin.clone()
    for f, (c, rc) in enumerate(zip(counts, rel_cutoffs), start=f0):
        cutoff = torch.clamp(torch.ceil(n_hashes.to(torch.float64) * rc),
                             min=1.0).to(torch.int64)
        cand = torch.where((c >= cutoff[:, None]) & valid, c,
                           torch.zeros_like(c))
        m = colmap[f].to(torch.int64)
        has = (m >= 0) & (m < c.shape[1])
        cu = torch.zeros_like(best)
        cu[:, has] = cand[:, m[has]]
        better = cu > best
        best = torch.where(better, cu, best)
        win = torch.where(better, torch.full_like(win, f), win)
    ucounts.copy_(best)
    uwin.copy_(win)


def merge(counts: list, n_hashes: torch.Tensor, rel_cutoffs: list,
          hashes_limit: int, colmap: torch.Tensor, ucounts: torch.Tensor,
          uwin: torch.Tensor, *, f0: int = 0) -> None:
    """Merge a level's filters' clamped counts into its union counts and
    winners, writing every entry of ``ucounts`` and ``uwin``.

    Replaces the union step of ``ganon_tpu.classify.device.
    classify_batch_packed_multi``: for filter ``f`` in order, its own
    rel-cutoff (float64, floor 1) on valid reads (``0 < n <=
    hashes_limit``), its ``counts[f]`` (int32 ``[B, T_f]``) placed at the
    union columns of ``colmap`` (:func:`merge_colmap`, int32 ``[F, U]``),
    and a strict-greater max into ``ucounts`` that records ``f`` in
    ``uwin`` (both int32 ``[B, U]``; neither needs a fill), so the first
    filter wins ties and a column no filter passes holds count 0 and
    winner 0. ``counts`` may be the level's filters ``f0 ..`` alone: with
    ``f0 > 0`` they merge into what ``ucounts`` and ``uwin`` hold from
    filters ``0 .. f0 - 1``. On the card one launch takes up to
    :data:`MERGE_MAX_FILTERS` filters; more take further launches.
    """
    F = len(counts)
    B = n_hashes.shape[0] if n_hashes.dim() == 1 else -1
    U = colmap.shape[1] if colmap.dim() == 2 else -1
    if (not F or len(rel_cutoffs) != F or f0 < 0
            or colmap.shape[0] < f0 + F):
        raise ValueError("merge takes F >= 1 counts, F rel-cutoffs and a "
                         "[f0 + F, U] column map or larger")
    if any(t.dtype != torch.int32
           for t in (n_hashes, colmap, ucounts, uwin, *counts)):
        raise ValueError("merge takes int32 tensors")
    if (B < 0 or ucounts.shape != (B, U) or uwin.shape != (B, U)
            or any(c.dim() != 2 or c.shape[0] != B or c.shape[1] > U
                   for c in counts)):
        raise ValueError("shapes: counts [B, T_f] (T_f <= U), n [B], "
                         "ucounts/uwin [B, U]")
    if ucounts.device.type == "cpu":
        merge_plain(counts, n_hashes, rel_cutoffs, hashes_limit, colmap,
                    ucounts, uwin, f0=f0)
        return
    kernels.check_cuda(n_hashes, colmap, ucounts, uwin, *counts)
    if B == 0 or U == 0:
        return
    for c0 in range(0, F, MERGE_MAX_FILTERS):
        part = counts[c0:c0 + MERGE_MAX_FILTERS]
        # host arrays, passed to the kernel by value (their addresses)
        ptrs = np.array([c.data_ptr() for c in part], dtype=np.int64)
        tfs = np.array([c.shape[1] for c in part], dtype=np.int32)
        rcs = np.array(rel_cutoffs[c0:c0 + MERGE_MAX_FILTERS],
                       dtype=np.float64)
        kernels.launch("merge", n_hashes, B, ptrs.ctypes.data,
                       tfs.ctypes.data, rcs.ctypes.data, len(part), f0 + c0,
                       int(hashes_limit), colmap, U, int(f0 + c0 == 0),
                       ucounts, uwin)


def split_rows(x, mesh) -> list:
    """The rows of ``x`` (a tensor or a host array) split over the
    mesh's ``batch`` axis in near-equal contiguous parts, each on its
    batch row's first device."""
    parts = torch.tensor_split(torch.as_tensor(x), mesh.shape["batch"])
    return [p.to(row[0], non_blocking=True)
            for p, row in zip(parts, mesh.devices)]


def gather_rows(parts: list, device) -> torch.Tensor:
    """The batch rows' results concatenated on ``device``."""
    return torch.cat([p.to(device, non_blocking=True) for p in parts])


def _mesh_counts(f, hashes: torch.Tensor, n_hashes: torch.Tensor,
                 row_fn) -> torch.Tensor:
    """``row_fn(i, hashes_i, n_i)`` on every batch row of ``f.mesh``,
    gathered on ``hashes``' device."""
    rows = zip(split_rows(hashes, f.mesh), split_rows(n_hashes, f.mesh))
    return gather_rows([row_fn(i, h, n) for i, (h, n) in enumerate(rows)],
                       hashes.device)


def _extract_compact(inbuf: torch.Tensor, *, k: int, w: int, L1: int,
                     L2: int):
    """``extract`` at the compaction width of the bucketed mate widths."""
    m1 = max(L1 - w + 1, 1)
    m2 = max(L2 - w + 1, 1) if L2 else 0
    return extract_hashes(inbuf, k=k, w=w, L1=L1, L2=L2,
                          mc=compact_width(m1 + m2))


def classify_batch_packed(f: "DeviceFilter | DeviceHIBF | DeviceRaptorHIBF",
                          inbuf: torch.Tensor,
                          rel_cutoff: float, rel_filter: float,
                          hashes_limit: int, *, k: int, w: int, L1: int,
                          L2: int, top_k: int, emit_matches_t: bool = True,
                          pack16: bool = True, match_cap: int = 0,
                          sort_probes: bool = False) -> torch.Tensor:
    """One batch through extract -> count -> select: one int32 buffer.

    Port of ``ganon_tpu.classify.device.classify_batch_packed``
    (``pack16=False``: ``select``'s 32-bit mode, for more than 65,535
    targets or a ``hashes_limit`` above 65,535): the compaction width is
    ``compact_width(m1 + m2)`` of the bucketed mate widths; overflowing
    reads carry ``overflow`` and are re-run by the engine uncompacted.
    ``f`` may be a forest (:func:`classify_batch_packed_forest`) or a
    raptor ``.hibf``: then this is the port of
    ``classify_batch_packed_raptor``, whose ``f.counts`` runs ``count`` in
    column-max mode once per sub-IBF into one ``[B, T]`` matrix zeroed for
    the batch (JAX's ``counts.at[:, cols].max(c)`` and final clamp).

    ``match_cap > 0`` (with ``pack16``) ships the ragged match stream of
    :func:`ragged` (the JAX engine's default transfer); 0 the dense
    layout. ``sort_probes`` (a flat filter on one device) orders each
    read's hashes by their first row before ``count``
    (:func:`~ganon_tpu_torch.ops.ibf_query.probe_sort`); the buffer is the
    same.
    """
    if match_cap and not pack16:
        raise ValueError("the ragged match stream needs pack16")
    if sort_probes and (type(f) is not DeviceFilter or f.mesh is not None):
        raise ValueError("sort_probes takes a flat filter on one device")
    if f.mesh is None:
        hashes, n_hashes, overflow = _extract_compact(inbuf, k=k, w=w,
                                                      L1=L1, L2=L2)
        if sort_probes:
            hashes = probe_sort(hashes, n_hashes,
                                bin_size=f.ibf_config.bin_size_bits)
        counts = f.counts(hashes, n_hashes)
    else:
        # each batch row extracts and counts on its devices; the counts
        # are gathered on the home device for select
        rows = []
        for i, x in enumerate(_mesh_batch(f, inbuf)):
            h, n, o = _extract_compact(x, k=k, w=w, L1=L1, L2=L2)
            rows.append((f.row_counts(i, h, n), n, o))
        counts, n_hashes, overflow = (gather_rows(list(p), f.device)
                                      for p in zip(*rows))
    packed = select(counts, n_hashes, overflow, rel_cutoff, rel_filter,
                    hashes_limit, top_k=top_k, emit_matches_t=emit_matches_t,
                    pack16=pack16)
    return _ragged_or_dense(packed, counts.shape[0],
                            min(top_k, counts.shape[1]), match_cap)


def _mesh_batch(f, inbuf) -> list:
    """A meshed filter's batch rows: ``put_batch``'s list as it is, or
    a whole batch split now."""
    return inbuf if isinstance(inbuf, list) else f.put_batch(inbuf)


def classify_batch_packed_forest(f: "DeviceHIBF", inbuf: torch.Tensor,
                                 rel_cutoff: float, rel_filter: float,
                                 hashes_limit: int, *, k: int, w: int,
                                 L1: int, L2: int, top_k: int,
                                 emit_matches_t: bool = True,
                                 pack16: bool = True,
                                 match_cap: int = 0) -> torch.Tensor:
    """One batch against a native HIBF forest: one int32 buffer.

    Port of ``ganon_tpu.classify.device.classify_batch_packed_forest``:
    ``extract`` once, ``count`` once per
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
        L2=L2, top_k=top_k, emit_matches_t=emit_matches_t, pack16=pack16,
        match_cap=match_cap)


def classify_batch_packed_multi(filters: list, colmap: torch.Tensor,
                                inbuf: torch.Tensor,
                                rel_cutoffs: list, rel_filter: float,
                                hashes_limit: int, *, k: int, w: int, L1: int,
                                L2: int, num_union: int, top_k: int,
                                emit_matches_t: bool = True,
                                match_cap: int = 0) -> torch.Tensor:
    """One batch against several flat filters of one level: one buffer.

    Port of ``ganon_tpu.classify.device.classify_batch_packed_multi``:
    ``extract`` once; per filter ``count``, and a ``merge`` of the level
    (each filter's own rel-cutoff, strict-greater union max, first filter
    wins ties) into ``[B, U]`` union counts and winners, one launch after
    each :data:`MERGE_MAX_FILTERS` filters' counts; then
    ``select`` with ``rel_cutoff = 0`` (the cutoffs are applied, and its
    floor of 1 drops the zeros) and the winners payload. ``colmap`` is
    the level's inverse column map (:func:`merge_colmap` of the filters'
    union columns, int32 ``[F, U]``, built once a level).
    Layout: ``[B*K] matches | [B*K] winners | [B] n_matches | ...``, or
    with ``match_cap > 0`` the ragged stream and its winners stream
    (:func:`ragged`); the rel-filter's min count is taken over the final
    union, as the JAX package does (a deliberate difference from the C++
    reference).
    """
    # with a mesh, every filter of the level is sharded over the same one
    mesh = filters[0].mesh
    rows = [inbuf] if mesh is None else _mesh_batch(filters[0], inbuf)
    parts = []
    for i, x in enumerate(rows):
        hashes, n_hashes, overflow = _extract_compact(x, k=k, w=w, L1=L1,
                                                      L2=L2)
        B = hashes.shape[0]
        ucounts = torch.empty((B, num_union), dtype=torch.int32,
                              device=hashes.device)
        uwin = torch.empty_like(ucounts)
        cmap = colmap.to(hashes.device)
        for f0 in range(0, len(filters), MERGE_MAX_FILTERS):
            # a merge launch's filters counted at once: their [B, T_f]
            # counts, sum_f B * T_f * 4 bytes, stay alive until it (50 MB
            # at 8192 reads and 1024 + 512 targets)
            fs = filters[f0:f0 + MERGE_MAX_FILTERS]
            counts = [f.counts(hashes, n_hashes) if mesh is None
                      else f.row_counts(i, hashes, n_hashes) for f in fs]
            merge(counts, n_hashes, rel_cutoffs[f0:f0 + len(fs)],
                  hashes_limit, cmap, ucounts, uwin, f0=f0)
            del counts
        parts.append((ucounts, uwin, n_hashes, overflow))
    if mesh is not None:
        parts = [tuple(gather_rows(list(p), filters[0].device)
                       for p in zip(*parts))]
    ucounts, uwin, n_hashes, overflow = parts[0]
    packed = select(ucounts, n_hashes, overflow, 0.0, rel_filter,
                    hashes_limit, top_k=top_k, emit_matches_t=emit_matches_t,
                    uwin=uwin)
    return _ragged_or_dense(packed, ucounts.shape[0],
                            min(top_k, num_union), match_cap, has_win=True)


def classify_batch_packed_pruned(f: "DevicePrunedForest",
                                 inbuf: torch.Tensor, rel_cutoff: float,
                                 rel_filter: float, hashes_limit: int, *,
                                 k: int, w: int, L1: int, L2: int,
                                 max_groups: int, top_k: int,
                                 emit_matches_t: bool = True,
                                 match_cap: int = 0,
                                 pair_cap: int = 0) -> torch.Tensor:
    """One batch against a merged-bin pruned forest: one int32 buffer.

    Port of ``ganon_tpu.classify.device.classify_batch_packed_pruned``:
    ``extract`` (compacted), the ``gate`` (coarse counts, the top ``S =
    max_groups`` surviving groups; ``n_surv > S`` sets the read's
    overflow, so the engine re-runs it on the exact probe-all path),
    ``fine`` on the chosen groups, then ``select`` in lanes mode.

    ``0 < pair_cap < B * S`` compacts the (read, slot) pairs as JAX does
    (:func:`~ganon_tpu_torch.ops.pruned_query.pair_live` over the whole
    batch, a mesh's rows gathered for the scan): a pair past the cap adds
    zero to its slot's counts, and a read whose pairs spill past it gets
    its overflow flag (the engine retries the batch with dense slots);
    its lanes and group words stay those of the gate. A dead slot costs
    ``fine`` nothing here, so the cap saves only the spilled pairs' work;
    ``pair_cap = 0`` (or at least ``B * S``) is the dense stage.

    Layout: :func:`unpack_batch_result` with ``K = min(top_k, S *
    group_size)``, ``T = num_targets`` and ``n_extra = ceil(S/2)``, or
    with ``match_cap > 0`` the ragged stream (:func:`ragged`); top
    entries carry lane ids.
    """
    if f.mesh is None:
        rows, forests = [inbuf], [f]
    else:  # both tables replicated on each batch row's first device
        rows, forests = _mesh_batch(f, inbuf), f.rows
    stage = []
    for x, fr in zip(rows, forests):
        hashes, n_hashes, overflow = _extract_compact(x, k=k, w=w, L1=L1,
                                                      L2=L2)
        gsel, slot_ok, overflow, _ = gate(
            fr.ctbl, hashes, n_hashes, coarse_bin_size=fr.coarse_bin_size,
            coarse_h=fr.coarse_h, num_groups=fr.num_groups,
            rel_cutoff=rel_cutoff, hashes_limit=hashes_limit,
            max_groups=max_groups, overflow=overflow)
        stage.append((hashes, n_hashes, overflow, gsel, slot_ok))
    lives = [st[4] for st in stage]
    sizes = [st[0].shape[0] for st in stage]
    if 0 < pair_cap < sum(sizes) * max_groups:
        # the pair positions run over the whole batch, as in JAX
        live, ovf = pair_live(gather_rows(lives, f.device),
                              gather_rows([st[2] for st in stage], f.device),
                              pair_cap)
        lives = [lv.to(st[0].device) for lv, st in zip(live.split(sizes),
                                                        stage)]
        stage = [(h, n, ov.to(h.device), g, ok) for (h, n, _, g, ok), ov in
                 zip(stage, ovf.split(sizes))]
    parts = []
    for (hashes, n_hashes, overflow, gsel, slot_ok), live, fr in zip(
            stage, lives, forests):
        counts = fine_counts(
            fr.ftbl, hashes, n_hashes, fr.grp_row_off, fr.grp_bin_size,
            fr.grp_shift, fine_h=fr.fine_h, group_size=fr.group_size,
            gsel=gsel, slot_ok=live)
        parts.append((counts.reshape(counts.shape[0], -1), n_hashes,
                      overflow, gsel, slot_ok))
    if f.mesh is not None:
        parts = [tuple(gather_rows(list(p), f.device) for p in zip(*parts))]
    counts, n_hashes, overflow, gsel, slot_ok = parts[0]
    packed = select_lanes(
        counts, n_hashes, overflow, gsel, slot_ok, f.grp_ntargets,
        rel_cutoff, rel_filter, hashes_limit, group_size=f.group_size,
        num_targets=f.num_targets, top_k=top_k,
        emit_matches_t=emit_matches_t)
    return _ragged_or_dense(packed, counts.shape[0],
                            min(top_k, counts.shape[1]), match_cap,
                            n_extra=-(-max_groups // 2))


def unpack_batch_result(packed: np.ndarray, B: int, K: int, T: int,
                        has_matches_t: bool = True,
                        has_win: bool = False, n_extra: int = 0,
                        pack16: bool = True) -> dict:
    """Split a packed batch result back into the result dict
    (``top_win`` is None unless ``has_win``; ``extra_rows`` holds the
    ``n_extra`` u32 ``[B]`` rows after the overflow block; ``pack16=False``
    reads the 32-bit mode's two blocks of counts and ids)."""
    o = 0

    def take(n, shape=None):
        nonlocal o
        v = packed[o:o + n]
        o += n
        return v.reshape(shape) if shape is not None else v

    if pack16:
        m = take(B * K, (B, K)).view(np.uint32)
        top_vals = (m >> 16).astype(np.int32)
        top_idx = (m & 0xFFFF).astype(np.int32)
    else:
        top_vals = take(B * K, (B, K))
        top_idx = take(B * K, (B, K))
    out = {
        "top_vals": top_vals,
        "top_idx": top_idx,
        "top_win": take(B * K, (B, K)) if has_win else None,
        "n_matches": take(B),
        "max_count": take(B),
        "n_hashes": take(B),
        "overflow": take(B).astype(bool),
        "extra_rows": [take(B).view(np.uint32) for _ in range(n_extra)],
        "disc_t": take(T),
    }
    if has_matches_t:
        out["matches_t"] = take(T)
    scalars = take(3)
    out["seqs_classified"] = scalars[0]
    out["kmers_from_classified"] = scalars[1]
    out["kmers_matches"] = scalars[2]
    return out


def unpack_batch_result_ragged(packed: np.ndarray, B: int, C: int, T: int,
                               K: int, has_win: bool = False,
                               n_extra: int = 0,
                               has_matches_t: bool = True) -> dict:
    """Split a ragged result buffer (:func:`ragged`) back into the result
    dict.

    Host copy of ``ganon_tpu.classify.device.unpack_batch_result_ragged``:
    the ``[B, Km]`` ``top_vals``/``top_idx`` (``Km`` the largest
    ``min(n_matches, K)``, at least 1) are rebuilt from the row-major
    stream; the raw ``n_matches`` rides in ``w1``, so the caller's top-K
    escalation still sees it. ``cap_overflow`` is set when the stream
    outgrew ``C`` (entries were dropped; the matrices are then not
    rebuilt and the batch must be re-dispatched with a larger cap).
    """
    o = 0

    def take(n):
        nonlocal o
        v = packed[o:o + n]
        o += n
        return v

    comp = take(C).view(np.uint32)
    comp_win = take(C) if has_win else None
    w1 = take(B).view(np.uint32)
    w2 = take(B).view(np.uint32)
    n_matches = (w1 & 0xFFFF).astype(np.int32)
    out = {
        "n_matches": n_matches,
        "max_count": (w1 >> 16).astype(np.int32),
        "n_hashes": (w2 >> 1).astype(np.int32),
        "overflow": (w2 & 1).astype(bool),
        "top_win": None,
        "extra_rows": [take(B).view(np.uint32) for _ in range(n_extra)],
        "disc_t": take(T),
    }
    if has_matches_t:
        out["matches_t"] = take(T)
    scalars = take(3)
    out["seqs_classified"] = scalars[0]
    out["kmers_from_classified"] = scalars[1]
    out["kmers_matches"] = scalars[2]
    nm_eff = np.minimum(n_matches, K)
    total = int(nm_eff.sum())
    out["cap_overflow"] = total > C
    if not out["cap_overflow"]:
        Km = max(1, int(nm_eff.max()) if B else 1)
        tv = np.zeros((B, Km), dtype=np.int32)
        ti = np.zeros((B, Km), dtype=np.int32)
        tw = np.zeros((B, Km), dtype=np.int32) if has_win else None
        if total:
            ii = np.repeat(np.arange(B), nm_eff)
            off = np.zeros(B, dtype=np.int64)
            off[1:] = np.cumsum(nm_eff[:-1])
            jj = np.arange(total) - off[ii]
            vals = comp[:total]
            tv[ii, jj] = (vals >> 16).astype(np.int32)
            ti[ii, jj] = (vals & 0xFFFF).astype(np.int32)
            if has_win:
                tw[ii, jj] = comp_win[:total]
        out["top_vals"] = tv
        out["top_idx"] = ti
        if has_win:
            out["top_win"] = tw
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


class ShardedTable:
    """A packed query table column-sharded over a mesh (K17).

    Port of the ``P(None, "bins")`` table of ``ganon_tpu.classify.device.
    DeviceFilter`` with a mesh (``device.py:749-768``). ``shards`` are the
    first batch row's :class:`~ganon_tpu_torch.ops.ibf_query.TableShard`s,
    shard ``j`` on ``mesh.devices[0][j]``: cut from a packed table
    (:func:`~ganon_tpu_torch.ops.ibf_query.shard_table`) or repacked on
    their devices from the bit-matrix (:func:`~ganon_tpu_torch.ops.
    ibf_query.repack_shards`, no whole table anywhere). The other rows
    copy them (a copy per distinct device, none where entries repeat).
    With ``cols`` (a raptor sub) the combined counts are max-merged into
    those columns.
    """

    def __init__(self, shards, num_targets: int, mesh, *, bin_size: int,
                 hash_functions: int, cols=None):
        self.mesh = mesh
        self.num_targets = num_targets
        self.bin_size, self.hash_functions = bin_size, hash_functions
        self.widths = [s.t_hi - s.t_lo for s in shards]
        self.shards = [[s.to(d) for s, d in zip(shards, row)]
                       for row in mesh.devices]
        # combine's spans stay on the host: its kernel takes them by value
        self.spans = tuple(torch.tensor([getattr(s, a) for s in shards],
                                        dtype=torch.int32)
                           for a in ("t_lo", "t_hi"))
        # the partials' buffer needs a zero fill only where count's tile
        # walk may leave a cell unstored (an empty byte range in a shard of
        # 256 words or more); every other route stores every cell
        self.fill_parts = not all(count_writes_every_cell(s) for s in shards)
        self.cols = (None if cols is None else
                     [cols.to(row[0]) for row in mesh.devices])

    def counts(self, i: int, hashes: torch.Tensor, n_hashes: torch.Tensor, *,
               out: torch.Tensor | None = None, col0: int = 0):
        """Clamped counts of batch row ``i`` (``hashes``/``n_hashes`` on
        the row's first device): each shard's unclamped partials (sized by
        its target range) into one buffer there, then ``combine``. Into
        ``out[:, col0:col0 + T]`` when given (forest mode), max-merged into
        ``out[:, cols]`` for a raptor sub."""
        row = self.mesh.devices[i]
        B = hashes.shape[0]
        parts = (torch.zeros if self.fill_parts else torch.empty)(
            B * sum(self.widths), dtype=torch.int32, device=row[0])
        inputs = {row[0]: (hashes, n_hashes)}
        kw = dict(bin_size=self.bin_size, hash_functions=self.hash_functions,
                  clamp=False)
        off = 0
        for d, sh, w in zip(row, self.shards[i], self.widths):
            if w:
                if d not in inputs:
                    inputs[d] = (hashes.to(d, non_blocking=True),
                                 n_hashes.to(d, non_blocking=True))
                dst = parts[off:off + B * w].view(B, w)
                if d == row[0]:
                    bulk_target_counts_packed(
                        sh.tbl8, sh.byte_starts, sh.byte_ends, *inputs[d],
                        out=dst, **kw)
                else:  # another card: its partials come over afterwards
                    dst.copy_(bulk_target_counts_packed(
                        sh.tbl8, sh.byte_starts, sh.byte_ends, *inputs[d],
                        **kw), non_blocking=True)
            off += B * w
        if out is None:  # combine stores every column of a flat row
            out = torch.empty((B, self.num_targets), dtype=torch.int32,
                              device=row[0])
        return combine(parts, *self.spans, n_hashes, out,
                       num_targets=self.num_targets, col0=col0,
                       cols=None if self.cols is None else self.cols[i])


class DeviceFilter:
    """A flat IBF resident on one device, ready for batched counting.

    The interleaved bit-matrix goes to ``device`` as it is stored and is
    repacked there once into the query table (``repack_table``: the
    ``repack`` kernel on a card, its plain version on the CPU; W8 padded
    to whole u32 words because the ``count`` kernel reads words); the
    host computes only the plan, and nothing else is copied per batch.
    With ``mesh`` each column shard of a :class:`ShardedTable` is
    repacked on its own device (the whole table is made nowhere);
    ``device`` stays the home of the gathered counts.
    """

    def __init__(self, ibf, device="cuda", mesh=None):
        self.device = _resolve_device(device)
        self.ibf_config = ibf.ibf_config
        self.targets = ibf.targets()
        self.num_targets = len(self.targets)
        plan = repack_plan(ibf.bin_to_target_ids(), self.num_targets)
        bits = bits_tensor(ibf.bits)
        self.target_fpr = ibf.target_fpr()
        self.mesh, self.batch_mult, self.table = None, 1, None
        if mesh is not None:
            self._set_table(mesh, repack_shards(
                bits, plan, mesh.shape["bins"], mesh.devices[0]))
        else:
            self.tbl8 = repack_table(bits.to(self.device), plan)
            self.byte_starts = torch.from_numpy(plan.byte_starts).to(
                self.device)
            self.byte_ends = torch.from_numpy(plan.byte_ends).to(self.device)

    def with_mesh(self, mesh) -> "DeviceFilter":
        """This filter column-sharded over ``mesh``, cut slice by slice
        from its packed table on its device (no repack)."""
        if self.mesh is not None:
            raise ValueError("the filter is sharded already")
        out = copy.copy(self)
        out._set_table(mesh, shard_table(
            self.tbl8, self.byte_starts, self.byte_ends, mesh.shape["bins"],
            devices=mesh.devices[0]))
        return out

    def _set_table(self, mesh, shards) -> None:
        """Shard over ``mesh`` with these first-row shards; the whole
        table is dropped."""
        self.mesh, self.batch_mult = mesh, mesh.shape["batch"]
        self.table = ShardedTable(
            shards, self.num_targets, mesh,
            bin_size=self.ibf_config.bin_size_bits,
            hash_functions=self.ibf_config.hash_functions)
        self.tbl8 = self.byte_starts = self.byte_ends = None

    def to(self, device) -> "DeviceFilter":
        """The same filter with its tables on ``device`` (no repack); a
        sharded filter keeps its shards and moves its home only."""
        out = copy.copy(self)
        out.device = _resolve_device(device)
        if self.mesh is None:
            for name in ("tbl8", "byte_starts", "byte_ends"):
                setattr(out, name, getattr(self, name).to(out.device))
        return out

    def put_batch(self, arr):
        """A ``[B, ...]`` host array on the filter's device; with a mesh,
        its rows split over the ``batch`` axis (:func:`split_rows`: a list
        of parts, each on its batch row's first device). Span
        ``dispatch.upload``, counter ``transfer.h2d_bytes``."""
        trace.count("transfer.h2d_bytes", arr.nbytes)
        with trace.span("dispatch.upload", cpu=False):
            if self.mesh is None:
                return torch.as_tensor(arr).to(self.device)
            return split_rows(arr, self.mesh)

    def row_counts(self, i: int, hashes: torch.Tensor, n_hashes: torch.Tensor,
                   *, out: torch.Tensor | None = None,
                   col0: int = 0) -> torch.Tensor:
        """A sharded filter's clamped counts of batch row ``i``."""
        return self.table.counts(i, hashes, n_hashes, out=out, col0=col0)

    def counts(self, hashes: torch.Tensor, n_hashes: torch.Tensor, *,
               out: torch.Tensor | None = None, col0: int = 0) -> torch.Tensor:
        """Clamped per-target counts (int32 ``[B, T]``) of compacted hashes
        (into ``out[:, col0:col0 + T]`` when given: forest mode; a sharded
        filter takes no ``out`` and gathers on ``hashes``' device)."""
        if self.mesh is not None:
            if out is not None:
                raise ValueError("a sharded filter counts into row buffers")
            return _mesh_counts(self, hashes, n_hashes, self.row_counts)
        return bulk_target_counts_packed(
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

    def __init__(self, hibf, device="cuda", mesh=None):
        self.device = _resolve_device(device)
        self.ibf_config = hibf.ibf_config
        self.targets = hibf.targets()
        self.num_targets = len(self.targets)
        self.mesh = mesh
        self.batch_mult = 1 if mesh is None else mesh.shape["batch"]
        tid = {t: i for i, t in enumerate(self.targets)}
        self.subs = [DeviceFilter(s, self.device, mesh=mesh)
                     for s in hibf.subs]
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

    def with_mesh(self, mesh) -> "DeviceHIBF":
        """This forest with every sub column-sharded over ``mesh``."""
        out = copy.copy(self)
        out.mesh, out.batch_mult = mesh, mesh.shape["batch"]
        out.subs = [s.with_mesh(mesh) for s in self.subs]
        return out

    put_batch = DeviceFilter.put_batch

    def row_counts(self, i: int | None, hashes: torch.Tensor,
                   n_hashes: torch.Tensor) -> torch.Tensor:
        """Clamped counts of batch row ``i`` of a sharded forest (of the
        whole batch when ``i`` is None: the filter has no mesh)."""
        def sub_counts(sub, **kw):
            if i is None:
                return sub.counts(hashes, n_hashes, **kw)
            return sub.row_counts(i, hashes, n_hashes, **kw)

        out = torch.zeros((hashes.shape[0], self.num_targets),
                          dtype=torch.int32, device=hashes.device)
        for sub, cols in zip(self.subs, self.sub_cols):
            if not len(cols):
                continue
            if self.contiguous:
                sub_counts(sub, out=out, col0=int(cols[0]))
            else:
                idx = torch.from_numpy(cols.astype(np.int64)).to(out.device)
                out[:, idx] = sub_counts(sub)
        return out

    def counts(self, hashes: torch.Tensor, n_hashes: torch.Tensor) -> torch.Tensor:
        """Clamped counts (int32 ``[B, T]``): each sub counts into its
        columns of one matrix (``count`` in forest mode)."""
        if self.mesh is not None:
            return _mesh_counts(self, hashes, n_hashes, self.row_counts)
        return self.row_counts(None, hashes, n_hashes)


@dataclasses.dataclass
class RaptorSub:
    """One sub-IBF of a raptor archive in the query layout: its u8 table
    (``W8`` padded to whole u32 words), the byte ranges of its user bins,
    its hash parameters and ``cols``, the global target column of each of
    its user bins (int32, ascending, distinct)."""

    tbl8: torch.Tensor | None
    byte_starts: torch.Tensor | None
    byte_ends: torch.Tensor | None
    bin_size: int
    hash_funs: int
    cols: torch.Tensor
    # with a mesh: the table's column shards (the whole table dropped)
    table: ShardedTable | None = None

    def to(self, device) -> "RaptorSub":
        names = ("cols",) if self.table else (
            "tbl8", "byte_starts", "byte_ends", "cols")
        return dataclasses.replace(self, **{
            name: getattr(self, name).to(device) for name in names})

    def with_mesh(self, mesh) -> "RaptorSub":
        table = ShardedTable(
            shard_table(self.tbl8, self.byte_starts, self.byte_ends,
                        mesh.shape["bins"], devices=mesh.devices[0]),
            int(self.cols.numel()), mesh, bin_size=self.bin_size,
            hash_functions=self.hash_funs, cols=self.cols)
        return dataclasses.replace(self, tbl8=None, byte_starts=None,
                                   byte_ends=None, table=table)


class DeviceRaptorHIBF:
    """A raptor ``.hibf`` flattened into per-sub-IBF query tables.

    Port of ``ganon_tpu.classify.device.DeviceRaptorHIBF``; ``mesh``
    column-shards every sub's table (each sub's shards summed and
    clamped, then max-merged into its columns). Every sub-IBF is counted
    (see ``index.hibf.RaptorHIBF`` for why that equals the reference's
    gated descent). Per sub: the technical bins' file positions
    (``bin_to_filename``, padded with -1 to the technical bins or cut to
    them), the used positions as its local targets, merged and empty bins
    mapped to the dropped id ``len(used)`` of its repack plan; its bits go
    to the device and are repacked there (on a mesh, shard by shard, as
    :class:`DeviceFilter`'s); a routing-only IBF (every bin merged) is
    skipped. A user bin of several subs takes the largest of its counts.
    """

    def __init__(self, rhibf, device="cuda", mesh=None):
        self.device = _resolve_device(device)
        self.ibf_config = rhibf.ibf_config
        self.targets = rhibf.targets()
        self.num_targets = len(self.targets)
        self.target_fpr = rhibf.target_fpr()
        self.mesh, self.batch_mult = None, 1
        self.subs = []
        for (bits, _bins, bin_size, hash_funs), b2f in zip(
                rhibf.ibfs, rhibf.bin_to_filename):
            tb = bits.shape[1] * 32
            fpos = np.full(tb, -1, dtype=np.int64)
            b2f = np.asarray(b2f, dtype=np.int64)[:tb]
            fpos[:len(b2f)] = b2f
            used = np.unique(fpos[fpos >= 0])
            if not len(used):
                continue  # routing only: its children are counted directly
            b2t_local = np.searchsorted(used, fpos).astype(np.int32)
            b2t_local[fpos < 0] = len(used)
            plan = repack_plan(b2t_local, len(used))
            sub = RaptorSub(
                tbl8=None, byte_starts=None, byte_ends=None,
                bin_size=int(bin_size), hash_funs=int(hash_funs),
                cols=torch.from_numpy(used.astype(np.int32)).to(self.device))
            if mesh is None:
                sub.tbl8 = repack_table(bits_tensor(bits).to(self.device),
                                        plan)
                sub.byte_starts, sub.byte_ends = (
                    torch.from_numpy(a).to(self.device)
                    for a in (plan.byte_starts, plan.byte_ends))
            else:
                sub.table = ShardedTable(
                    repack_shards(bits_tensor(bits), plan, mesh.shape["bins"],
                                  mesh.devices[0]),
                    len(used), mesh, bin_size=sub.bin_size,
                    hash_functions=sub.hash_funs, cols=sub.cols)
            self.subs.append(sub)
        # the subs' descriptors for the one-launch count (none on a mesh)
        self.sub_desc = None
        if mesh is not None:
            self.mesh, self.batch_mult = mesh, mesh.shape["batch"]
        else:
            self.sub_desc = sub_descriptors(self.subs)

    def to(self, device) -> "DeviceRaptorHIBF":
        """The same archive with its tables on ``device`` (no repack)."""
        out = copy.copy(self)
        out.device = _resolve_device(device)
        out.subs = [s.to(out.device) for s in self.subs]
        if self.mesh is None:
            out.sub_desc = sub_descriptors(out.subs)
        return out

    def with_mesh(self, mesh) -> "DeviceRaptorHIBF":
        """This archive with every sub's table column-sharded."""
        out = copy.copy(self)
        out.mesh, out.batch_mult = mesh, mesh.shape["batch"]
        out.subs = [s.with_mesh(mesh) for s in self.subs]
        out.sub_desc = None
        return out

    put_batch = DeviceFilter.put_batch

    def row_counts(self, i: int, hashes: torch.Tensor,
                   n_hashes: torch.Tensor) -> torch.Tensor:
        """A sharded archive's clamped counts of batch row ``i``: per
        sub, the shards' partials summed and clamped, then max-merged."""
        out = torch.zeros((hashes.shape[0], self.num_targets),
                          dtype=torch.int32, device=hashes.device)
        for sub in self.subs:
            sub.table.counts(i, hashes, n_hashes, out=out)
        return out

    def counts(self, hashes: torch.Tensor, n_hashes: torch.Tensor) -> torch.Tensor:
        """Clamped counts (int32 ``[B, T]``): each sub max-merges its
        user bins' counts into their columns (``count`` in column-max
        mode, every sub in one launch), as JAX's
        ``DeviceRaptorHIBF.counts``."""
        if self.mesh is not None:
            return _mesh_counts(self, hashes, n_hashes, self.row_counts)
        return raptor_target_counts(self.subs, hashes, n_hashes,
                                    num_targets=self.num_targets,
                                    desc=self.sub_desc)


class DevicePrunedForest:
    """A merged-bin pruned forest on one device.

    Port of ``ganon_tpu.classify.device.DevicePrunedForest``; ``mesh``
    replicates both tables on each batch row's first device (``rows``)
    and splits the batch, as JAX's mesh does (its bins-sharded layout,
    ``parallel.pruned_shard``, is library-only there and here).
    Fast path: :func:`classify_batch_packed_pruned`; exact fallback:
    :meth:`counts_gated` (every group, the same gate). Built from a
    ``PrunedForest``'s arrays (either package's object, or either
    package's file loaded by ``ganon_tpu_torch.index.pruned``): the fine
    and coarse tables go to ``device`` as they are, rows padded to whole
    u32 words (zero padding lanes, never counted); nothing is repacked.
    ``grp_row_off`` is int64, so the fine table has no 2^31-row bound.
    """

    def __init__(self, pf, device="cuda", mesh=None):
        self.device = _resolve_device(device)
        self.mesh, self.batch_mult, self.rows = None, 1, None
        self.ibf_config = pf.ibf_config
        self.targets = pf.targets()
        self.num_targets = len(self.targets)
        self.target_fpr = pf.target_fpr()
        self.group_size = int(pf.group_size)
        self.fine_h = int(pf.fine_h)
        self.coarse_h = int(pf.coarse_h)
        self.coarse_bin_size = int(pf.coarse_bin_size)
        self.num_groups = len(pf.grp_bin_size)

        def table(t):
            # a raw file's tables are read-only memmaps; the tables are
            # only ever read, so they upload (or alias on the CPU) as is
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", "The given NumPy array is "
                                        "not writable")
                return torch.from_numpy(
                    table_as_u32(np.ascontiguousarray(t)).view(np.uint8)
                ).to(self.device)

        self.ftbl = table(pf.fine)
        self.ctbl = table(pf.coarse)
        bsz = np.asarray(pf.grp_bin_size, dtype=np.int64)
        self.grp_row_off = torch.from_numpy(
            np.asarray(pf.grp_row_off, dtype=np.int64)).to(self.device)
        self.grp_bin_size = torch.from_numpy(bsz).to(self.device)
        self.grp_shift = torch.tensor([clz64(int(b)) for b in bsz],
                                      dtype=torch.int32, device=self.device)
        self.grp_ntargets = torch.from_numpy(
            np.asarray(pf.grp_ntargets, dtype=np.int32)).to(self.device)
        if mesh is not None:
            self._shard(mesh)

    def _shard(self, mesh) -> None:
        base = copy.copy(self)
        self.mesh, self.batch_mult = mesh, mesh.shape["batch"]
        self.rows = [base.to(row[0]) for row in mesh.devices]

    def to(self, device) -> "DevicePrunedForest":
        """The same forest with its tables on ``device`` (a meshed
        forest's row replicas stay)."""
        out = copy.copy(self)
        out.device = _resolve_device(device)
        for name in ("ftbl", "ctbl", "grp_row_off", "grp_bin_size",
                     "grp_shift", "grp_ntargets"):
            setattr(out, name, getattr(self, name).to(out.device))
        return out

    def with_mesh(self, mesh) -> "DevicePrunedForest":
        """This forest replicated on each batch row of ``mesh``."""
        out = copy.copy(self)
        out._shard(mesh)
        return out

    put_batch = DeviceFilter.put_batch

    def _all_counts(self, hashes, n_hashes, surv):
        return fine_counts(
            self.ftbl, hashes, n_hashes, self.grp_row_off, self.grp_bin_size,
            self.grp_shift, fine_h=self.fine_h, group_size=self.group_size,
            surv=surv, num_targets=self.num_targets)

    def counts_gated(self, hashes: torch.Tensor, n_hashes: torch.Tensor,
                     rel_cutoff: float) -> torch.Tensor:
        """Counts of every target (int32 ``[B, T]``) under the forest's
        gated semantics: groups whose coarse count is below the read's
        cutoff read 0. The gate takes no hashes limit here (as JAX
        passes 0x7FFFFFFF), so only reads without hashes are invalid."""
        if self.mesh is not None:
            return _mesh_counts(
                self, hashes, n_hashes, lambda i, h, n:
                self.rows[i].counts_gated(h, n, rel_cutoff))
        _, _, _, surv = gate(
            self.ctbl, hashes, n_hashes,
            coarse_bin_size=self.coarse_bin_size, coarse_h=self.coarse_h,
            num_groups=self.num_groups, rel_cutoff=rel_cutoff,
            hashes_limit=NO_HASHES_LIMIT, max_groups=0, want_surv=True)
        return self._all_counts(hashes, n_hashes, surv)

    def counts(self, hashes: torch.Tensor, n_hashes: torch.Tensor) -> torch.Tensor:
        """Ungated counts of every target (diagnostics: the forest's
        defined semantics are the gated ones)."""
        return self._all_counts(hashes, n_hashes, None)


# filters of recently opened files, keyed by (path, mtime, size) as the
# JAX package memoizes them, plus the mesh and the home device for a
# sharded filter (a meshed run must not reuse an unsharded filter): a
# load reads the file and uploads its bit-matrix (db's 349 MB: 0.074 s
# of its 0.089, on an H100) before the card's repack (1.2 ms for
# db's 2.79 GB table), and runs in one process (tests, benchmarks, a
# hierarchy's several databases) reopen the same files. Four, as the JAX
# package keeps.
_FILTER_CACHE: dict = {}
_FILTER_CACHE_CAP = 4


def _open_filter(path: str, device, mesh=None):
    """A fresh device filter for ``path`` (flat ``.ibf`` of any format;
    pruned, raptor or native forest ``.hibf``, sniffed in that order),
    sharded over ``mesh`` when given."""
    from ganon_tpu_torch.index.hibf import HIBF, RaptorHIBF, is_raptor_hibf
    from ganon_tpu_torch.index.ibf import IBF
    from ganon_tpu_torch.index.pruned import PrunedForest, is_pruned_file

    if not path.endswith(".hibf"):
        return DeviceFilter(IBF.load(path), device, mesh)
    if is_pruned_file(path):
        return DevicePrunedForest(PrunedForest.load(path), device, mesh)
    if not zipfile.is_zipfile(path) and is_raptor_hibf(path):
        return DeviceRaptorHIBF(RaptorHIBF.load(path), device, mesh)
    return DeviceHIBF(HIBF.load(path), device, mesh)


def load_device_filter(path: str, device="cuda", mesh=None):
    """Open a flat ``.ibf`` or a forest ``.hibf`` on ``device``.

    A flat ``.ibf`` comes as npz, raw container or the reference's cereal
    archive. ``.hibf`` files are sniffed as the JAX package does: a
    pruned forest opens as a :class:`DevicePrunedForest`, a raptor
    archive as a :class:`DeviceRaptorHIBF`, anything else as a
    :class:`DeviceHIBF`. With ``mesh`` the filter is sharded over it
    (``device`` its home), cut slice by slice from the cached
    single-device filter of the same file where there is one, else each
    column shard repacked on its own device from the bit-matrix uploaded
    there (:func:`~ganon_tpu_torch.ops.ibf_query.repack_shards`; no host
    table and no whole table on any device).
    """
    device = _resolve_device(device)
    st = os.stat(path)
    base = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
    key = base if mesh is None else base + (mesh.key(), str(device))
    f = _FILTER_CACHE.pop(key, None)
    if f is None and mesh is not None and base in _FILTER_CACHE:
        f = _FILTER_CACHE[base].with_mesh(mesh).to(device)
    elif f is None:
        f = _open_filter(path, device, mesh)
    elif f.device != device:
        f = f.to(device)
    while len(_FILTER_CACHE) >= _FILTER_CACHE_CAP:
        _FILTER_CACHE.pop(next(iter(_FILTER_CACHE)))
    _FILTER_CACHE[key] = f
    return f
