"""Bins-axis sharding of the merged-bin pruned forest.

Port of ``ganon_tpu.parallel.pruned_shard`` (K17). Capacity scaling for
RefSeq-scale pruned databases: the fine table (one row range per target
group, ``index.pruned``) is row-sharded over the mesh's ``bins`` axis so
each device holds about ``1/n`` of it; the coarse merged-bin IBF
(``ceil(G/8)`` bytes a row) is replicated. Groups stride over the shards
(group ``g`` to shard ``g % n_bins``): the grouped layout is
count-sorted, so striding balances rows, and so memory and gather work,
across shards to within one group's size.

Query: every shard's device runs the replicated coarse ``gate`` (once
per distinct device of a batch row) and ``fine`` in shard mode over its
own groups, which writes straight into the groups' global columns of the
row's ``[B, T]`` matrix: the result is in global target order, with no
permutation and no traffic on the fine path (a shard on another card
sends its zero-padded matrix to the row's first device). Semantics are
exactly the single-device ``DevicePrunedForest.counts_gated``.

As in the JAX package this is a library class, not wired into the engine
(``ganon_tpu/classify/device.py:1460-1463``): the engine's pruned forest
replicates both tables over the mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from ganon_tpu_torch.ops.ibf_query import clz64, table_as_u32
from ganon_tpu_torch.ops.pruned_query import NO_HASHES_LIMIT, fine_shard, gate


class BinShardedPrunedForest:
    """A PrunedForest with its fine table group-sharded over ``bins``.

    ``pf`` is either package's ``PrunedForest`` (the port's loads the
    JAX package's files). ``counts_gated(hashes, n_hashes, rel_cutoff)``
    returns the same gated ``[B, T]`` counts as the single-device forest.
    Pad groups (when the shards do not divide G) carry gid -1 and a 1-row
    bin on each shard's zero pad row; they write nothing.
    """

    def __init__(self, pf, mesh):
        self.mesh, self.pf = mesh, pf
        nb = mesh.shape["bins"]
        G, gs = int(pf.num_groups), int(pf.group_size)
        self.G, self.gs, self.nb = G, gs, nb
        self.num_targets = len(pf.targets())
        self.fine_h, self.coarse_h = int(pf.fine_h), int(pf.coarse_h)
        self.coarse_bin_size = int(pf.coarse_bin_size)
        G_loc = -(-G // nb)

        fine = np.ascontiguousarray(pf.fine)  # u8 [R, gs // 8]
        row_off = np.asarray(pf.grp_row_off, dtype=np.int64)
        bin_size = np.asarray(pf.grp_bin_size, dtype=np.int64)
        shards = []  # (table u8 [R_s, W8], off, bsz, shift, gid) per shard
        for s in range(nb):
            gids = list(range(s, G, nb))
            pieces = [fine[row_off[g]:row_off[g] + bin_size[g]] for g in gids]
            pos = int(sum(len(p) for p in pieces))
            # the shard's rows, then one zero pad row for its pad groups
            t = np.zeros((pos + 1, fine.shape[1]), dtype=fine.dtype)
            if pos:
                t[:pos] = np.concatenate(pieces)
            off = np.full(G_loc, pos, np.int64)
            off[:len(gids)] = np.cumsum([0] + [len(p) for p in pieces])[:-1]
            bsz = np.ones(G_loc, np.int64)
            bsz[:len(gids)] = bin_size[gids]
            gid = np.full(G_loc, -1, np.int32)
            gid[:len(gids)] = gids
            shift = np.asarray([clz64(int(b)) for b in bsz], dtype=np.int32)
            shards.append((table_as_u32(t).view(np.uint8), off, bsz, shift,
                           gid))
        # shard j on entry [i][j] of every batch row i (one copy per
        # distinct device); the coarse table on every device
        self.shards = [[tuple(torch.from_numpy(a).to(d) for a in sh)
                        for sh, d in zip(shards, row)]
                       for row in mesh.devices]
        coarse = torch.from_numpy(table_as_u32(np.ascontiguousarray(
            pf.coarse)).view(np.uint8))
        self.ctbl = {str(d): coarse.to(d) for d in mesh.flat}

    def counts_gated(self, hashes: torch.Tensor, n_hashes: torch.Tensor,
                     rel_cutoff: float) -> torch.Tensor:
        """Gated counts (int32 ``[B, T]``, on ``hashes``' device) of
        compacted hashes, equal to ``DevicePrunedForest.counts_gated``."""
        from ganon_tpu_torch.classify.device import gather_rows, split_rows

        out_rows = []
        for row, shards, h, n in zip(self.mesh.devices, self.shards,
                                     split_rows(hashes, self.mesh),
                                     split_rows(n_hashes, self.mesh)):
            B = h.shape[0]
            out = torch.zeros((B, self.num_targets), dtype=torch.int32,
                              device=row[0])
            # per distinct device: the inputs and the replicated gate's
            # survive mask (no hashes limit, as JAX passes 0x7FFFFFFF)
            local = {}
            for d in row:
                if str(d) not in local:
                    hd, nd = h.to(d), n.to(d)
                    surv = gate(
                        self.ctbl[str(d)], hd, nd,
                        coarse_bin_size=self.coarse_bin_size,
                        coarse_h=self.coarse_h, num_groups=self.G,
                        rel_cutoff=rel_cutoff, hashes_limit=NO_HASHES_LIMIT,
                        max_groups=0, want_surv=True)[3]
                    local[str(d)] = (hd, nd, surv)
            for d, (ftbl, off, bsz, shift, gid) in zip(row, shards):
                hd, nd, surv = local[str(d)]
                dst = out if d == row[0] else torch.zeros(
                    (B, self.num_targets), dtype=torch.int32, device=d)
                fine_shard(ftbl, hd, nd, off, bsz, shift, gid,
                           fine_h=self.fine_h, group_size=self.gs,
                           num_groups=self.G, surv=surv, out=dst)
                if d != row[0]:  # disjoint columns: adding places them
                    out += dst.to(row[0])
            out_rows.append(out)
        return gather_rows(out_rows, hashes.device)
