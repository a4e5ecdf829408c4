"""Merged-bin pruned forest queries: the coarse gate and the fine counts.

Port of the pruned forest's device programs in
``ganon_tpu.classify.device`` (``bulk_group_counts``, the gate and top-S
block and the fine stage of ``classify_batch_packed_pruned``, and
``_pruned_all_counts``). Its kernel wrappers:

* :func:`gate` — coarse group counts, the read's cutoff, the survive
  mask and the top-S surviving groups (``csrc/gate.cu``); plain version
  :func:`gate_plain`.
* :func:`fine_counts` — per-lane counts of the chosen groups' fine rows
  (dense ``[B, S, gs]``), or of every group into ``[B, T]`` (probe-all,
  gated by the survive mask or not) (``csrc/fine.cu``); plain version
  :func:`fine_counts_plain`.
* :func:`pair_live` — the (read, slot) pair cap's live slots and spill
  flags (``csrc/scan.cu`` mode ``pairs``); plain version
  :func:`pair_live_plain`.
* :func:`fine_shard` — probe-all over one shard's groups of a
  bins-sharded fine table, into their global columns of ``[B, T]``
  (``csrc/fine.cu`` shard mode, K17); plain version
  :func:`fine_shard_plain`.

Both tables are u8 with rows padded to whole u32 words
(``table_as_u32``'s padding), as the kernels read words. A wrapper given
CPU tensors runs the plain version; given CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from ganon_tpu_torch import kernels
from ganon_tpu_torch.ops.ibf_query import (
    MAX_HASH_FUNCTIONS,
    clz64,
    ibf_row_dyn,
    ibf_row_indices,
)

# top-S slots per read the kernels keep (gate.cu, select.cu kMaxS)
MAX_GROUPS = 32
# the limit of counts_gated's gate: every read with hashes is valid
NO_HASHES_LIMIT = 0x7FFFFFFF
# u8 bit-plane elements per chunk of the plain probe-all version
_PLANE_CHUNK = 1 << 26


def _bit_planes(member: torch.Tensor) -> torch.Tensor:
    """u8 ``[..., W]`` -> ``[..., W*8]`` bits (little-endian: bit ``i`` of
    the last axis is bit ``i & 7`` of byte ``i >> 3``)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=member.device)
    planes = (member[..., None] >> shifts) & 1
    return planes.reshape(*member.shape[:-1], member.shape[-1] * 8)


def _slots(hashes: torch.Tensor, n_hashes: torch.Tensor) -> torch.Tensor:
    """bool ``[B, M]``: the read's first ``min(n, M)`` hash slots."""
    M = hashes.shape[1]
    return torch.arange(M, device=hashes.device)[None, :] < n_hashes[:, None]


def _check(tbl, hashes, n_hashes):
    if tbl.dtype != torch.uint8 or tbl.dim() != 2 or tbl.shape[1] % 4:
        raise ValueError("tables must be u8 [R, W8] with W8 % 4 == 0")
    if hashes.dtype != torch.int64 or hashes.dim() != 2:
        raise ValueError("hashes must be int64 [B, M]")
    if n_hashes.dtype != torch.int32 or n_hashes.shape != hashes.shape[:1]:
        raise ValueError("n_hashes must be int32 [B]")


def gate_plain(ctbl: torch.Tensor, hashes: torch.Tensor,
               n_hashes: torch.Tensor, *, coarse_bin_size: int, coarse_h: int,
               num_groups: int, rel_cutoff: float, hashes_limit: int,
               max_groups: int, overflow: torch.Tensor | None = None,
               want_surv: bool = False):
    """Plain version of the ``gate`` kernel (see :func:`gate`)."""
    B = hashes.shape[0]
    G, S = num_groups, max_groups
    rows = ibf_row_indices(hashes, bin_size=coarse_bin_size,
                           hash_functions=coarse_h)
    member = ctbl[rows[:, :, 0]]  # [B, M, Wc]
    for s in range(1, coarse_h):
        member = member & ctbl[rows[:, :, s]]
    member = torch.where(_slots(hashes, n_hashes)[:, :, None], member,
                         torch.zeros_like(member))
    gcounts = _bit_planes(member)[:, :, :G].sum(dim=1, dtype=torch.int64)
    n = n_hashes.to(torch.int64)
    cutoff = torch.clamp(torch.ceil(n.to(torch.float64) * rel_cutoff),
                         min=1.0).to(torch.int64)
    valid = (n > 0) & (n <= hashes_limit)
    surv = (gcounts >= cutoff[:, None]) & valid[:, None]
    ovf = (torch.zeros((B,), dtype=torch.bool, device=hashes.device)
           if overflow is None else overflow.bool())
    ovf = ovf | (surv.sum(dim=1) > S)
    # iterative argmax over unique keys: count, then the lower group id
    g = torch.arange(G, device=hashes.device)
    key = torch.where(surv, (gcounts << 32) | (0xFFFFFFFF - g), -1)
    gsel, slot_ok = [], []
    for _ in range(S):
        j = key.argmax(dim=1, keepdim=True)
        ok = key.gather(1, j)[:, 0] >= 0
        gsel.append(torch.where(ok, j[:, 0], 0))
        slot_ok.append(ok)
        key.scatter_(1, j, -1)
    if S:
        gsel_t = torch.stack(gsel, dim=1).to(torch.int32)
        ok_t = torch.stack(slot_ok, dim=1).to(torch.uint8)
    else:
        gsel_t = torch.zeros((B, 0), dtype=torch.int32, device=hashes.device)
        ok_t = torch.zeros((B, 0), dtype=torch.uint8, device=hashes.device)
    return (gsel_t, ok_t, ovf.to(torch.uint8),
            surv.to(torch.uint8) if want_surv else None)


def gate(ctbl: torch.Tensor, hashes: torch.Tensor, n_hashes: torch.Tensor, *,
         coarse_bin_size: int, coarse_h: int, num_groups: int,
         rel_cutoff: float, hashes_limit: int, max_groups: int,
         overflow: torch.Tensor | None = None, want_surv: bool = False):
    """The coarse gate of one batch: group counts, cutoff, top-S groups.

    Replaces ``ganon_tpu.classify.device.bulk_group_counts`` and the gate
    and top-S block of ``classify_batch_packed_pruned`` (and the gate of
    ``_pruned_all_counts``). ``ctbl`` is the coarse table (u8
    ``[coarse_bin_size, W8]``, one bit per group, rows padded to x4
    bytes); the first ``min(n, M)`` hashes of each read count. A group
    survives when the read is valid (``0 < n <= hashes_limit``) and its
    count reaches ``max(1, ceil(n * rel_cutoff))`` (float64).

    Returns ``(gsel int32 [B, S], slot_ok u8 [B, S], overflow u8 [B],
    surv u8 [B, G] or None)``: the top ``S = max_groups`` survivors by
    descending count (lower group id on ties), 0 in dead slots;
    ``overflow`` is the given ``overflow`` (u8 ``[B]``) OR ``n_surv >
    S``; ``surv`` only with ``want_surv``. ``max_groups`` may be 0.
    """
    _check(ctbl, hashes, n_hashes)
    B, M = hashes.shape
    G, S = num_groups, max_groups
    if not 0 <= S <= MAX_GROUPS or G < 1 or -(-G // 8) > ctbl.shape[1]:
        raise ValueError(f"max_groups in 0..{MAX_GROUPS}; the coarse rows "
                         f"must hold {G} groups")
    if not 1 <= coarse_h <= MAX_HASH_FUNCTIONS or coarse_bin_size > ctbl.shape[0]:
        raise ValueError("invalid coarse_h or coarse_bin_size")
    if overflow is not None and (overflow.dtype != torch.uint8
                                 or overflow.shape != (B,)):
        raise ValueError("overflow must be u8 [B]")
    kw = dict(coarse_bin_size=coarse_bin_size, coarse_h=coarse_h,
              num_groups=G, rel_cutoff=rel_cutoff, hashes_limit=hashes_limit,
              max_groups=S, overflow=overflow, want_surv=want_surv)
    if ctbl.device.type == "cpu":
        return gate_plain(ctbl, hashes, n_hashes, **kw)
    kernels.check_cuda(ctbl, hashes, n_hashes,
                       *([] if overflow is None else [overflow]))
    d = hashes.device
    gsel = torch.empty((B, S), dtype=torch.int32, device=d)
    slot_ok = torch.empty((B, S), dtype=torch.uint8, device=d)
    ovf = torch.empty((B,), dtype=torch.uint8, device=d)
    surv = (torch.empty((B, G), dtype=torch.uint8, device=d) if want_surv
            else None)
    if B == 0:
        return gsel, slot_ok, ovf, surv
    kernels.launch(
        "gate", ctbl, ctbl.shape[0], ctbl.shape[1], hashes, B, M, n_hashes,
        coarse_bin_size, coarse_h, clz64(coarse_bin_size), G,
        float(rel_cutoff), int(hashes_limit), S, overflow, gsel, slot_ok, ovf,
        surv,
    )
    return gsel, slot_ok, ovf, surv


def _fine_plain(ftbl, hashes, n_hashes, off, bsz, shift, live, *, fine_h,
                group_size):
    """Counts ``[B, P, gs]`` of each read's hashes against ``P`` groups
    per read (their ``off``/``bsz``/``shift`` int64 ``[B, P]``), zero
    where ``live`` (bool ``[B, P]``) is false; clamped to n."""
    h = hashes[:, None, :]
    member = None
    for i in range(fine_h):
        rows = ibf_row_dyn(h, i, bsz[:, :, None], shift[:, :, None]) + (
            off[:, :, None])
        m = ftbl[rows]  # [B, P, M, W8]
        member = m if member is None else member & m
    mask = _slots(hashes, n_hashes)[:, None, :] & live[:, :, None]
    member = torch.where(mask[..., None], member, torch.zeros_like(member))
    counts = _bit_planes(member)[..., :group_size].sum(dim=2,
                                                       dtype=torch.int64)
    n = n_hashes.to(torch.int64)[:, None, None]
    return torch.minimum(counts, n).to(torch.int32)


def fine_counts_plain(ftbl: torch.Tensor, hashes: torch.Tensor,
                      n_hashes: torch.Tensor, grp_row_off: torch.Tensor,
                      grp_bin_size: torch.Tensor, grp_shift: torch.Tensor, *,
                      fine_h: int, group_size: int,
                      gsel: torch.Tensor | None = None,
                      slot_ok: torch.Tensor | None = None,
                      surv: torch.Tensor | None = None,
                      num_targets: int = 0) -> torch.Tensor:
    """Plain version of the ``fine`` kernel (see :func:`fine_counts`)."""
    kw = dict(fine_h=fine_h, group_size=group_size)
    shift = grp_shift.to(torch.int64)
    if gsel is not None:
        g = gsel.to(torch.int64)
        return _fine_plain(ftbl, hashes, n_hashes, grp_row_off[g],
                           grp_bin_size[g], shift[g], slot_ok.bool(), **kw)
    B, M = hashes.shape
    G = grp_row_off.shape[0]
    step = max(1, _PLANE_CHUNK // max(1, B * M * ftbl.shape[1] * 8))
    parts = []
    for g0 in range(0, G, step):
        g = torch.arange(g0, min(G, g0 + step), device=hashes.device)
        live = (torch.ones((B, len(g)), dtype=torch.bool, device=hashes.device)
                if surv is None else surv[:, g0:g0 + len(g)].bool())
        parts.append(_fine_plain(
            ftbl, hashes, n_hashes, grp_row_off[g].expand(B, -1),
            grp_bin_size[g].expand(B, -1), shift[g].expand(B, -1), live,
            **kw).reshape(B, -1))
    return torch.cat(parts, dim=1)[:, :num_targets].contiguous()


def fine_counts(ftbl: torch.Tensor, hashes: torch.Tensor,
                n_hashes: torch.Tensor, grp_row_off: torch.Tensor,
                grp_bin_size: torch.Tensor, grp_shift: torch.Tensor, *,
                fine_h: int, group_size: int,
                gsel: torch.Tensor | None = None,
                slot_ok: torch.Tensor | None = None,
                surv: torch.Tensor | None = None,
                num_targets: int = 0) -> torch.Tensor:
    """Fine-table lane counts of compacted hashes.

    Replaces the fine stage of ``ganon_tpu.classify.device.
    classify_batch_packed_pruned`` (dense, ``pair_cap=0``) and
    ``_pruned_all_counts``. ``ftbl`` u8 ``[R, W8]`` (``group_size/8``
    bytes per row padded to x4); group ``g`` probes rows
    ``fastrange_i(x, grp_bin_size[g]) + grp_row_off[g]`` (int64 ``[G]``;
    ``grp_shift`` int32 ``[G]`` is ``clz64(grp_bin_size)``); lane ``j``
    counts the read's first ``min(n, M)`` hashes whose ``fine_h`` rows
    all have bit ``j`` set, clamped to ``n``.

    With ``gsel``/``slot_ok`` (the gate's ``[B, S]``): int32
    ``[B, S, group_size]``, zero in dead slots. Without: probe-all, int32
    ``[B, num_targets]`` with group ``g`` in columns ``g*gs + j``; the
    gate's ``surv`` (u8 ``[B, G]``) zeroes the groups that did not
    survive (the gated counts), ``surv=None`` counts every group.
    """
    _check(ftbl, hashes, n_hashes)
    B, M = hashes.shape
    G = grp_row_off.shape[0]
    gs = group_size
    if (grp_row_off.dtype != torch.int64 or grp_bin_size.dtype != torch.int64
            or grp_shift.dtype != torch.int32 or grp_bin_size.shape != (G,)
            or grp_shift.shape != (G,)):
        raise ValueError("grp_row_off/grp_bin_size int64 [G], grp_shift "
                         "int32 [G]")
    if not 1 <= fine_h <= MAX_HASH_FUNCTIONS or gs % 8 or gs < 8 or (
            gs > ftbl.shape[1] * 8):
        raise ValueError("invalid fine_h or group_size")
    dense = gsel is not None
    if dense:
        S = gsel.shape[1] if gsel.dim() == 2 else -1
        if (gsel.dtype != torch.int32 or gsel.shape != (B, S)
                or slot_ok is None or slot_ok.dtype != torch.uint8
                or slot_ok.shape != (B, S) or S < 1):
            raise ValueError("gsel int32 [B, S] and slot_ok u8 [B, S]")
    else:
        S = 0
        if not 0 < num_targets <= G * gs or num_targets <= (G - 1) * gs:
            raise ValueError("num_targets must fill the last group")
        if surv is not None and (surv.dtype != torch.uint8
                                 or surv.shape != (B, G)):
            raise ValueError("surv must be u8 [B, G]")
    kw = dict(fine_h=fine_h, group_size=gs, gsel=gsel, slot_ok=slot_ok,
              surv=surv, num_targets=num_targets)
    if ftbl.device.type == "cpu":
        return fine_counts_plain(ftbl, hashes, n_hashes, grp_row_off,
                                 grp_bin_size, grp_shift, **kw)
    extra = [t for t in (gsel, slot_ok, surv) if t is not None]
    kernels.check_cuda(ftbl, hashes, n_hashes, grp_row_off, grp_bin_size,
                       grp_shift, *extra)
    shape = (B, S, gs) if dense else (B, num_targets)
    out = torch.empty(shape, dtype=torch.int32, device=hashes.device)
    if B == 0:
        return out
    kernels.launch(
        "fine", ftbl, ftbl.shape[0], ftbl.shape[1], hashes, B, M, n_hashes,
        grp_row_off, grp_bin_size, grp_shift, G, fine_h, gs, gsel, slot_ok,
        S, surv, out, num_targets, None, 0,
        counter="fine" if dense else "fine_all",
    )
    return out


# reads a block of the pairs kernel's chained scan (csrc/scan.cu
# kPairsReads)
PAIRS_READS = 256


def pair_live_plain(slot_ok: torch.Tensor, overflow: torch.Tensor,
                    pair_cap: int):
    """Plain version of the ``pairs`` kernel (see :func:`pair_live`)."""
    ok = slot_ok.bool()
    pos = torch.cumsum(ok.reshape(-1).to(torch.int64), 0).reshape(ok.shape)
    live = ok & (pos - 1 < pair_cap)
    n_slots = ok.sum(dim=1)
    read_end = torch.cumsum(n_slots, 0)
    spill = (read_end > pair_cap) & (n_slots > 0)
    return live.to(torch.uint8), (overflow.bool() | spill).to(torch.uint8)


def pair_live(slot_ok: torch.Tensor, overflow: torch.Tensor, pair_cap: int):
    """The live slots of a batch under a (read, slot) pair cap.

    Replaces the pair compaction of ``ganon_tpu.classify.device.
    classify_batch_packed_pruned`` with ``pair_cap > 0``
    (``device.py:1199-1237``): the live slots of ``slot_ok`` (u8 ``[B,
    S]``) in read-major order are the pairs; a pair at position ``>=
    pair_cap`` is dropped (the fine stage counts it as a dead slot, so it
    adds zero), and a read whose pairs end past the cap with any slot
    live, ``cumsum(n_slots) > pair_cap``, gets its overflow flag (the
    engine's exact retry). Returns ``(live u8 [B, S], overflow u8 [B])``;
    ``slot_ok`` itself still decides the lanes and the group words.
    """
    B = slot_ok.shape[0]
    if slot_ok.dtype != torch.uint8 or slot_ok.dim() != 2 or (
            slot_ok.shape[1] < 1):
        raise ValueError("slot_ok must be u8 [B, S]")
    if overflow.dtype != torch.uint8 or overflow.shape != (B,):
        raise ValueError("overflow must be u8 [B]")
    if pair_cap < 0:
        raise ValueError("pair_cap must not be negative")
    if slot_ok.device.type == "cpu":
        return pair_live_plain(slot_ok, overflow, pair_cap)
    kernels.check_cuda(slot_ok, overflow)
    # both outputs in one allocation (the host's cost of a call leads)
    n = slot_ok.numel()
    out = torch.empty((n + B,), dtype=torch.uint8, device=slot_ok.device)
    live, ovf = out[:n].view(slot_ok.shape), out[n:]
    if B:
        status, epoch = kernels.scan_status(slot_ok.device,
                                            -(-B // PAIRS_READS))
        kernels.launch("pairs", slot_ok, B, slot_ok.shape[1], pair_cap,
                       overflow, status, epoch, live, ovf)
    return live, ovf


def fine_shard_plain(ftbl: torch.Tensor, hashes: torch.Tensor,
                     n_hashes: torch.Tensor, grp_row_off: torch.Tensor,
                     grp_bin_size: torch.Tensor, grp_shift: torch.Tensor,
                     gid: torch.Tensor, *, fine_h: int, group_size: int,
                     num_groups: int, surv: torch.Tensor | None,
                     out: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``fine`` kernel's shard mode (see
    :func:`fine_shard`)."""
    B, M = hashes.shape
    T, gs = out.shape[1], group_size
    local = torch.nonzero(gid >= 0).reshape(-1)
    shift = grp_shift.to(torch.int64)
    step = max(1, _PLANE_CHUNK // max(1, B * M * ftbl.shape[1] * 8))
    lane = torch.arange(gs, device=out.device)
    for i0 in range(0, local.numel(), step):
        loc = local[i0:i0 + step]
        g = gid[loc].to(torch.int64)
        live = (torch.ones((B, len(loc)), dtype=torch.bool,
                           device=hashes.device)
                if surv is None else surv[:, g].bool())
        c = _fine_plain(ftbl, hashes, n_hashes, grp_row_off[loc].expand(B, -1),
                        grp_bin_size[loc].expand(B, -1),
                        shift[loc].expand(B, -1), live, fine_h=fine_h,
                        group_size=gs).reshape(B, -1)
        cols = (g[:, None] * gs + lane).reshape(-1)
        keep = cols < T
        out[:, cols[keep]] = c[:, keep]
    return out


def fine_shard(ftbl: torch.Tensor, hashes: torch.Tensor,
               n_hashes: torch.Tensor, grp_row_off: torch.Tensor,
               grp_bin_size: torch.Tensor, grp_shift: torch.Tensor,
               gid: torch.Tensor, *, fine_h: int, group_size: int,
               num_groups: int, surv: torch.Tensor | None,
               out: torch.Tensor) -> torch.Tensor:
    """Probe-all over one shard's groups of a bins-sharded fine table.

    The shard_map body of ``ganon_tpu.parallel.pruned_shard.
    BinShardedPrunedForest`` (K17): ``ftbl`` is the shard's own table and
    ``grp_row_off``/``grp_bin_size``/``grp_shift`` (int64, int64, int32
    ``[G_loc]``) its local groups' geometry; ``gid`` (int32 ``[G_loc]``)
    maps a local group to its global id, -1 for a pad group. Global group
    ``g`` writes lanes ``j`` into ``out[:, g*gs + j]`` (``< T``): its
    counts clamped to n where ``surv[b, g]`` (the replicated gate's u8
    ``[B, num_groups]``; ``None`` counts every group), zeros elsewhere. A
    pad group writes nothing; the columns of other shards' groups are
    left as they are, so every shard of a batch row writes into one
    matrix. ``out`` is returned.
    """
    _check(ftbl, hashes, n_hashes)
    B, M = hashes.shape
    G = gid.shape[0] if gid.dim() == 1 else -1
    if gid.dtype != torch.int32 or G < 1:
        raise ValueError("gid must be int32 [G_loc], G_loc >= 1")
    if (grp_row_off.dtype != torch.int64 or grp_bin_size.dtype != torch.int64
            or grp_shift.dtype != torch.int32
            or not grp_row_off.shape == grp_bin_size.shape
            == grp_shift.shape == (G,)):
        raise ValueError("grp_row_off/grp_bin_size int64 [G_loc], grp_shift "
                         "int32 [G_loc]")
    if not 1 <= fine_h <= MAX_HASH_FUNCTIONS or group_size % 8 or (
            group_size < 8 or group_size > ftbl.shape[1] * 8):
        raise ValueError("invalid fine_h or group_size")
    if surv is not None and (surv.dtype != torch.uint8
                             or surv.shape != (B, num_groups)):
        raise ValueError(f"surv must be u8 [B, {num_groups}]")
    if (out.dtype != torch.int32 or out.dim() != 2 or out.shape[0] != B
            or not out.is_contiguous()
            or out.shape[1] <= (num_groups - 1) * group_size):
        raise ValueError("out must be contiguous int32 [B, T] with the last "
                         "group's columns")
    kw = dict(fine_h=fine_h, group_size=group_size, num_groups=num_groups,
              surv=surv, out=out)
    if ftbl.device.type == "cpu":
        return fine_shard_plain(ftbl, hashes, n_hashes, grp_row_off,
                                grp_bin_size, grp_shift, gid, **kw)
    kernels.check_cuda(ftbl, hashes, n_hashes, grp_row_off, grp_bin_size,
                       grp_shift, gid, out, *([] if surv is None else [surv]))
    if B == 0:
        return out
    kernels.launch(
        "fine", ftbl, ftbl.shape[0], ftbl.shape[1], hashes, B, M, n_hashes,
        grp_row_off, grp_bin_size, grp_shift, G, fine_h, group_size, None,
        None, 0, surv, out, out.shape[1], gid, num_groups,
        counter="fine_shard",
    )
    return out
