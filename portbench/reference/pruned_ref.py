"""Plain PyTorch reference of classify on the merged-bin pruned forest.

The layout, as the configuration fixes it: targets sorted by hash count
(descending) into groups of ``group_size``; a fine table that gives each
target one bin, group ``g`` holding rows ``[row_off_g, row_off_g +
bin_size_g)`` (``bin_size_g`` sized for the group's largest target at
the filter's false-positive rate with ``fine_h`` hash functions), and a
coarse filter of one bin a group (the union of its targets' hashes, at
``coarse_fp`` with ``coarse_h`` functions, rows rounded up to 32); the
reference builds both tables itself. The semantics are gated: a read counts a group's coarse hits first, and a
target is a match only when its group's count and its own count both
reach the read's rel-cutoff; rel-filter and fpr-query follow as on a flat
filter. Within a read, matches are ordered by count, then by the slot of
their group (coarse count descending, group ascending) and their place
in it, except in a batch where some read has more than ``max_groups``
surviving groups: there by count, then target.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from portbench.reference import ganon_ref as ref

RAW_MAGIC = b"GANON-TPU-PRUNED-RAW1\n"


def read_pruned(path: str):
    """(header, fine u8 ``[rows, group_size / 8]``, coarse u8
    ``[coarse_bin_size, ceil(G / 8)]``) of a raw pruned forest."""
    with open(path, "rb") as f:
        if f.read(len(RAW_MAGIC)) != RAW_MAGIC:
            raise ValueError(f"{path}: not a raw pruned forest")
        hlen = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(hlen).decode())
    off = len(RAW_MAGIC) + 8 + hlen
    off += -off % 4096
    fine = np.memmap(path, mode="r", dtype=np.uint8, offset=off,
                     shape=tuple(header["fine_shape"]))
    off += fine.size
    off += -off % 4096
    coarse = np.memmap(path, mode="r", dtype=np.uint8, offset=off,
                       shape=tuple(header["coarse_shape"]))
    return header, fine, coarse


def bin_size_for(fp: float, n: int, h: int) -> int:
    return math.ceil(n * (-h / math.log(1 - math.exp(math.log(fp) / h))))


class PrunedLayout:
    """The pruned forest's layout as the reference works it out from the
    configuration (``max_fp``, ``fine_h``, ``coarse_fp``, ``coarse_h``,
    ``group_size``) and the targets' hash counts, in the given order."""

    def __init__(self, targets: list, counts: list, fcfg: dict):
        self.targets = list(targets)
        self.counts = [int(c) for c in counts]
        self.gs = int(fcfg["group_size"])
        self.fine_h, self.coarse_h = int(fcfg["fine_h"]), int(
            fcfg["coarse_h"])
        self.k, self.w = int(fcfg["kmer_size"]), int(fcfg["window_size"])
        self.max_fp, self.coarse_fp = float(fcfg["max_fp"]), float(
            fcfg["coarse_fp"])
        self.G = -(-len(self.targets) // self.gs)
        self.bin_size, self.row_off, self.ntargets, sums = [], [], [], []
        off = 0
        for g in range(self.G):
            c = self.counts[g * self.gs:(g + 1) * self.gs]
            self.ntargets.append(len(c))
            self.bin_size.append(max(64, bin_size_for(
                self.max_fp, max(1, max(c)), self.fine_h)))
            self.row_off.append(off)
            off += self.bin_size[-1]
            sums.append(sum(c))
        self.rows = off
        cb = max(64, bin_size_for(self.coarse_fp, max(1, max(sums)),
                                  self.coarse_h))
        self.coarse_bin_size = cb + (-cb % 32)
        self.fpr = []
        for i, c in enumerate(self.counts):
            bs = self.bin_size[i // self.gs]
            self.fpr.append((1 - math.exp(-self.fine_h / (bs / c)))
                            ** self.fine_h if c else 0.0)

    def header_mismatch(self, header: dict) -> dict:
        """Entries of a pruned file's header that differ from this
        layout."""
        want = {"targets": self.targets, "hashes_count": self.counts,
                "group_size": self.gs, "grp_bin_size": self.bin_size,
                "grp_row_off": self.row_off, "grp_ntargets": self.ntargets,
                "coarse_bin_size": self.coarse_bin_size,
                "fine_h": self.fine_h, "coarse_h": self.coarse_h,
                "kmer_size": self.k, "window_size": self.w,
                "max_fp": self.max_fp, "coarse_fp": self.coarse_fp,
                "fine_shape": [self.rows, self.gs // 8],
                "coarse_shape": [self.coarse_bin_size, -(-self.G // 8)]}
        out = {}
        for key, v in want.items():
            got = header.get(key)
            if isinstance(v, list):
                got = [x if isinstance(x, str) else float(x)
                       for x in (got or [])]
                v = [x if isinstance(x, str) else float(x) for x in v]
            out[key] = int(got != v)
        return out


def build_tables(hashes: list, lay: PrunedLayout, device):
    """The fine and coarse u8 tables of the layout, from each target's
    distinct hashes (in the layout's order): a target's fine bit is lane
    ``j`` of its group's rows, a group's coarse bit is bit ``g`` of the
    coarse rows, at every row of each hash function."""
    fine = torch.zeros((lay.rows, lay.gs // 8), dtype=torch.uint8,
                       device=device)
    coarse = torch.zeros((lay.coarse_bin_size, -(-lay.G // 8)),
                         dtype=torch.uint8, device=device)
    for g in range(lay.G):
        o, bs = lay.row_off[g], lay.bin_size[g]
        gate = torch.zeros(lay.coarse_bin_size, dtype=torch.bool,
                           device=device)
        for j in range(lay.ntargets[g]):
            hs = hashes[g * lay.gs + j]
            lane = torch.zeros(bs, dtype=torch.bool, device=device)
            for i in range(lay.fine_h):
                lane[ref.hash_rows(hs, bs, i)] = True
            fine[o:o + bs, j // 8] |= lane.to(torch.uint8) << (j % 8)
            for i in range(lay.coarse_h):
                gate[ref.hash_rows(hs, lay.coarse_bin_size, i)] = True
        coarse[:, g // 8] |= gate.to(torch.uint8) << (g % 8)
    return fine, coarse


def bytes_mismatch(got: np.ndarray, want: torch.Tensor,
                   rows_chunk: int = 1 << 22) -> int:
    """Bytes of a file's u8 table that differ from ``want``, read in
    blocks of rows; every byte when the shapes differ."""
    if tuple(got.shape) != tuple(want.shape):
        return max(int(np.prod(got.shape)), want.numel())
    bad = 0
    for r0 in range(0, got.shape[0], rows_chunk):
        blk = torch.from_numpy(np.ascontiguousarray(
            got[r0:r0 + rows_chunk])).to(want.device)
        bad += int((blk != want[r0:r0 + rows_chunk]).sum())
    return bad


def _unpack(b: torch.Tensor) -> torch.Tensor:
    """u8 ``[..., W]`` -> bool ``[..., 8 W]`` (bit ``i`` of byte ``i // 8``
    at ``i % 8``)."""
    sh = torch.arange(8, device=b.device, dtype=torch.uint8)
    return ((b[..., None] >> sh) & 1).bool().reshape(*b.shape[:-1], -1)


def fold_groups(fine: torch.Tensor, coarse: torch.Tensor, lay):
    """The control's tables: each group's fine rows and the coarse rows
    folded onto their first half (``ganon_ref.fold_words``' rule)."""
    f = fine.clone()
    for g in range(lay.G):
        o, n = lay.row_off[g], lay.bin_size[g]
        h = (n + 1) // 2
        f[o:o + n - h] |= fine[o + h:o + n]
    return f, ref.fold_words(coarse)


def _rows(h, size, i, fold):
    r = ref.hash_rows(h, size, i)
    return r % ((size + 1) // 2) if fold else r


def coarse_counts(coarse, lay: PrunedLayout, h, rd, n_reads, *,
                  fold=False, chunk=1 << 20) -> torch.Tensor:
    """int64 ``[n_reads, G]``: each read's hashes whose coarse bit of the
    group is set at every coarse row."""
    gcount = torch.zeros((n_reads * lay.G,), dtype=torch.int32,
                         device=h.device)
    for c0 in range(0, h.numel(), chunk):
        hs = h[c0:c0 + chunk]
        m = None
        for i in range(lay.coarse_h):
            x = coarse[_rows(hs, lay.coarse_bin_size, i, fold)]
            m = x if m is None else m & x
        hi, g = _unpack(m)[:, :lay.G].nonzero(as_tuple=True)
        gcount.index_add_(0, rd[c0:c0 + chunk][hi] * lay.G + g,
                          torch.ones_like(g, dtype=torch.int32))
    return gcount.view(n_reads, lay.G).to(torch.int64)


def pruned_matches(fine, coarse, lay: PrunedLayout, h, rd, nh, n_reads,
                   *, rel_cutoff, rel_filter, fpr_query, max_groups=2,
                   batch=8192, hashes_limit=65535, fold=False,
                   chunk=1 << 20):
    """``(read, target, count)`` of every match in the program's order.
    ``h``/``rd``: the reads' hashes grouped by read (ascending), ``nh``
    each read's count; ``fine``/``coarse`` u8 tables on the device."""
    dev = h.device
    if fold:
        fine, coarse = fold_groups(fine, coarse, lay)
    n = nh.to(torch.int64)
    cutoff = torch.clamp(torch.ceil(n.to(torch.float64) * rel_cutoff),
                         min=1.0).to(torch.int64)
    valid = (n > 0) & (n <= hashes_limit)
    gcount = coarse_counts(coarse, lay, h, rd, n_reads, fold=fold,
                           chunk=chunk)
    surv = (gcount >= cutoff[:, None]) & valid[:, None]
    pr, pg = surv.nonzero(as_tuple=True)
    # each surviving (read, group) pair against its read's hashes
    start = torch.zeros(n_reads + 1, dtype=torch.int64, device=dev)
    start[1:] = torch.cumsum(n, 0)
    fc = torch.zeros((pr.numel(), lay.gs), dtype=torch.int32, device=dev)
    for g in torch.unique(pg).tolist():
        sel = (pg == g).nonzero(as_tuple=True)[0]
        cnt = n[pr[sel]]
        tot = int(cnt.sum())
        if not tot:
            continue
        pair = torch.repeat_interleave(sel, cnt)
        first = torch.repeat_interleave(start[pr[sel]], cnt)
        base = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
        hidx = first + torch.arange(tot, device=dev) - base
        for c0 in range(0, tot, chunk):
            hs = h[hidx[c0:c0 + chunk]]
            m = None
            for i in range(lay.fine_h):
                x = fine[lay.row_off[g]
                         + _rows(hs, lay.bin_size[g], i, fold)]
                m = x if m is None else m & x
            q, j = _unpack(m).nonzero(as_tuple=True)
            fc.view(-1).index_add_(0, pair[c0:c0 + chunk][q] * lay.gs + j,
                                   torch.ones_like(j, dtype=torch.int32))
    nt = torch.tensor(lay.ntargets, device=dev)
    c = torch.minimum(fc.to(torch.int64), n[pr][:, None])
    lane = torch.arange(lay.gs, device=dev)[None, :]
    kept = (c >= cutoff[pr][:, None]) & (lane < nt[pg][:, None])
    kp, kj = kept.nonzero(as_tuple=True)
    kr, kv = pr[kp], c[kp, kj]
    kt = pg[kp] * lay.gs + kj
    big = torch.iinfo(torch.int64).max
    mx = torch.zeros(n_reads, dtype=torch.int64, device=dev).scatter_reduce(
        0, kr, kv, "amax")
    mn = torch.full((n_reads,), big, dtype=torch.int64,
                    device=dev).scatter_reduce(0, kr, kv, "amin")
    mn = torch.minimum(n, mn)
    thr = (mx.to(torch.float64) - torch.ceil(
        (mx - mn).to(torch.float64) * rel_filter)).to(torch.int64)
    fin = kv >= thr[kr]
    kr, kt, kv, kg = kr[fin], kt[fin], kv[fin], pg[kp][fin]
    # slot of each surviving group within its read
    key = torch.where(surv, gcount * (lay.G + 1) + (lay.G - torch.arange(
        lay.G, device=dev)), -1)
    rank = torch.argsort(torch.argsort(key, dim=1, descending=True), dim=1)
    slot = rank[kr, kg]
    over = (surv.sum(dim=1) > max_groups).cpu().numpy()
    r, t, v, s = (x.cpu().numpy() for x in (kr, kt, kv, slot))
    if fpr_query < 1.0 and len(r):
        nr = n.cpu().numpy()[r]
        cache: dict = {}
        keep = np.empty(len(r), dtype=bool)
        for i, (nn, tt, vv) in enumerate(zip(nr.tolist(), t.tolist(),
                                             v.tolist())):
            m = cache.get((nn, tt))
            if m is None:
                m = cache[(nn, tt)] = ref.fpr_query_min_count(
                    nn, lay.fpr[tt], fpr_query)
            keep[i] = vv >= m
        r, t, v, s = r[keep], t[keep], v[keep], s[keep]
    nb = -(-n_reads // batch)
    bover = np.zeros(nb, dtype=bool)
    np.logical_or.at(bover, np.arange(n_reads) // batch, over)
    lane_of = s * lay.gs + t % lay.gs
    second = np.where(bover[r // batch], t, lane_of)
    order = np.lexsort((second, -v, r))
    return r[order], t[order], v[order]
