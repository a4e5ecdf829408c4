#!/usr/bin/env python3
"""A/B of the port's pruned-forest kernels, gate and fine: this checkout's
against an earlier version's sources, in one process on the card.

    mkdir -p chip_proof/old
    for f in gate.cu fine.cu ibf_hash.cuh; do
        git show <rev>:ganon_tpu_torch/csrc/$f > chip_proof/old/$f
    done
    python scripts/torch_gate_fine_ab.py --old chip_proof/old [--reps 2]

The earlier ``gate.cu`` and ``fine.cu`` are built with nvcc, each alone,
into ``build/`` and called through ctypes with the C signatures of this
checkout's ``ganon_gate`` and ``ganon_fine`` (unchanged since they were
written); their headers come from the same directory. This checkout's
kernels run through their wrappers (``ops.pruned_query.gate``,
``fine_counts`` and ``fine_shard``). Inputs are made on the card from
``--seed`` at the shape of PERF.md's kernel table for the pruned forest:
8192 reads of 56 hash slots (35-45 valid), 128 groups of 64 targets,
coarse_h = fine_h = 1, a coarse table of 1,700,000 rows x 16 bytes (~10%
of its bits set, as the build's coarse_fp 0.1 gives) and a fine table of
a bin size per group (40,000-70,000 rows, ~5% set, 56 MB in all). Each
read's hashes set the bits of one group in the coarse table and of one
lane of it in the fine table, 30% of the reads a second group's, so the
gate keeps one or two groups a read as the classify path does. Shapes:

* ``gate``, ``fine``: S = 2 at the CLI's cutoff 0.75 (fine on the gate's
  choice);
* ``gate_s32``, ``fine_s32``: S = 32 at cutoff 0.1 (the false positives
  pass it too, so most reads fill their 32 slots);
* ``fine_all``: probe-all into [8192, 8192] int32, gated by the gate's
  survive mask (``counts_gated``);
* ``fine_shard``: shard mode over 32 local groups (every fourth group,
  its rows as the shard's own table) into the global columns.

Each shape runs old, new, new, old per rep (a call between two CUDA
events, median, and the card's activity under torch.profiler); the new
kernel's outputs must equal the old's. One JSON line a turn, then the
card's name and power limit and the medians of each side. Needs one
CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _smoke():
    """chip_smoke.py of this checkout, for its timing helpers."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _old_library(src: str) -> ctypes.CDLL:
    """Build one earlier source alone into ``build/`` and load it (its
    headers from its own directory)."""
    from ganon_tpu_torch import BUILD_DIR, kernels

    tag = hashlib.sha1()
    for name in sorted(os.listdir(os.path.dirname(src))):
        with open(os.path.join(os.path.dirname(src), name), "rb") as f:
            tag.update(f.read())
    so = os.path.join(BUILD_DIR, f"ab_old_{os.path.basename(src)}_"
                      f"{tag.hexdigest()[:12]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-shared",
                        "-o", so, src], check=True)
    return ctypes.CDLL(so)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True,
                    help="directory of the earlier gate.cu, fine.cu and "
                    "their headers")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=31)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2

    from ganon_tpu_torch import kernels
    from ganon_tpu_torch.ops import ibf_query as q
    from ganon_tpu_torch.ops import pruned_query as pq

    smoke = _smoke()
    cuda = torch.device("cuda")
    g = torch.Generator(device=cuda).manual_seed(args.seed)
    old = {}
    for name in ("gate", "fine"):
        fn = getattr(_old_library(os.path.join(args.old, f"{name}.cu")),
                     f"ganon_{name}")
        fn.argtypes = list(kernels._SIGNATURES[name]) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        old[name] = fn

    def call_old(name, *a):
        cargs = [x.data_ptr() if isinstance(x, torch.Tensor) else x
                 for x in a]
        err = old[name](*cargs, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old {name}: error {err}")

    # the forest: 128 groups of 64 lanes, coarse_h = fine_h = 1
    B, M, G, gs, h = 8192, 56, 128, 64, 1
    T = G * gs
    Rc = 1_700_000
    bsz = torch.randint(40_000, 70_001, (G,), generator=g, device=cuda)
    off = torch.cumsum(bsz, 0) - bsz
    shift = torch.tensor([q.clz64(int(b)) for b in bsz.tolist()],
                         dtype=torch.int32, device=cuda)
    Rf = int(bsz.sum())
    hashes = torch.randint(-2**63, 2**63 - 1, (B, M), generator=g,
                           device=cuda, dtype=torch.int64)
    n = torch.randint(35, 46, (B,), generator=g, device=cuda,
                      dtype=torch.int32)
    ovf = (torch.rand((B,), generator=g, device=cuda) < 0.02).to(torch.uint8)
    cbits = torch.rand((Rc, G), generator=g, device=cuda) < 0.10
    fbits = torch.rand((Rf, gs), generator=g, device=cuda) < 0.05
    crow = q.ibf_row_indices(hashes, bin_size=Rc, hash_functions=h)[..., 0]
    reads = torch.arange(B, device=cuda)
    second = torch.rand((B,), generator=g, device=cuda) < 0.3
    for k, keep in ((0, slice(None)), (1, second)):
        grp = torch.randint(0, G, (B,), generator=g, device=cuda)
        lane = torch.randint(0, gs, (B,), generator=g, device=cuda)
        rb = reads[keep]
        rows_c = crow[rb, :40 if k else M]
        cbits[rows_c, grp[rb, None].expand_as(rows_c)] = True
        gb = grp[rb, None]
        rows_f = q.ibf_row_dyn(hashes[rb, :40 if k else M], 0, bsz[gb],
                               shift[gb].to(torch.int64)) + off[gb]
        fbits[rows_f, lane[rb, None].expand_as(rows_f)] = True

    def pack(bits):
        w = torch.arange(8, device=cuda, dtype=torch.uint8)
        r, c = bits.shape
        return (bits.view(r, c // 8, 8).to(torch.uint8) << w).sum(
            -1, dtype=torch.uint8)

    ctbl, ftbl = pack(cbits), pack(fbits)
    del cbits, fbits, crow
    torch.cuda.empty_cache()
    geo = (off.contiguous(), bsz.contiguous(), shift)

    turns, summary = [], {}

    def record(shape, side, fn, reps=20, runs=20):
        turns.append({"shape": shape, "side": side,
                      "ms": smoke._ms(fn, reps),
                      "profiled_ms": smoke._profiled_ms(fn, runs)})
        print(json.dumps(turns[-1]), flush=True)

    def ab(shape, run_old, run_new, info):
        a, b = run_old(), run_new()
        torch.cuda.synchronize()
        a, b = (a if isinstance(a, tuple) else (a,)), (
            b if isinstance(b, tuple) else (b,))
        if len(a) != len(b) or not all(
                torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{shape}: the new kernel differs from the "
                                 "old")
        summary[shape] = info
        sides = {"old": run_old, "new": run_new}
        for _ in range(args.reps):
            for side in ("old", "new", "new", "old"):
                record(shape, side, sides[side])

    def old_gate(S, cut, limit, overflow, want_surv):
        out = (torch.empty((B, S), dtype=torch.int32, device=cuda),
               torch.empty((B, S), dtype=torch.uint8, device=cuda),
               torch.empty((B,), dtype=torch.uint8, device=cuda),
               torch.empty((B, G), dtype=torch.uint8, device=cuda)
               if want_surv else None)
        call_old("gate", ctbl, Rc, ctbl.shape[1], hashes, B, M, n, Rc, h,
                 q.clz64(Rc), G, cut, limit, S, overflow, *out)
        return out if want_surv else out[:3]

    def new_gate(S, cut, limit, overflow, want_surv):
        out = pq.gate(ctbl, hashes, n, coarse_bin_size=Rc, coarse_h=h,
                      num_groups=G, rel_cutoff=cut, hashes_limit=limit,
                      max_groups=S, overflow=overflow, want_surv=want_surv)
        return out if want_surv else out[:3]

    def old_fine(tbl, geom, Gl, gsel=None, slot_ok=None, surv=None,
                 out=None, gid=None):
        S = 0 if gsel is None else gsel.shape[1]
        if out is None:
            shape = (B, S, gs) if S else (B, T)
            out = torch.empty(shape, dtype=torch.int32, device=cuda)
        call_old("fine", tbl, tbl.shape[0], tbl.shape[1], hashes, B, M, n,
                 *geom, Gl, h, gs, gsel, slot_ok, S, surv, out, T, gid,
                 G if gid is not None else 0)
        return out

    fkw = dict(fine_h=h, group_size=gs)
    for S, cut, tag in ((2, 0.75, ""), (32, 0.1, "_s32")):
        gargs = (S, cut, 65535, ovf, False)
        ab(f"gate{tag}", lambda a=gargs: old_gate(*a),
           lambda a=gargs: new_gate(*a),
           {"B": B, "M": M, "G": G, "S": S, "rel_cutoff": cut,
            "coarse_rows": Rc, "coarse_h": h})
        gsel, slot_ok, _ = new_gate(*gargs)
        ab(f"fine{tag}",
           lambda s=gsel, o=slot_ok: old_fine(ftbl, geo, G, gsel=s,
                                              slot_ok=o),
           lambda s=gsel, o=slot_ok: pq.fine_counts(
               ftbl, hashes, n, *geo, gsel=s, slot_ok=o, **fkw),
           {"B": B, "S": S, "gs": gs, "fine_rows": Rf, "fine_h": h,
            "live_slots": int(slot_ok.sum())})
    surv = new_gate(0, 0.75, pq.NO_HASHES_LIMIT, None, True)[3]
    ab("fine_all", lambda: old_fine(ftbl, geo, G, surv=surv),
       lambda: pq.fine_counts(ftbl, hashes, n, *geo, surv=surv,
                              num_targets=T, **fkw),
       {"B": B, "T": T, "surviving_pairs": int(surv.sum())})
    local = torch.arange(0, G, 4, device=cuda)
    sbsz = bsz[local].contiguous()
    sftbl = torch.cat([ftbl[int(o):int(o) + int(s)]
                       for o, s in zip(off[local].tolist(), sbsz.tolist())])
    sgeo = ((torch.cumsum(sbsz, 0) - sbsz).contiguous(), sbsz,
            shift[local].contiguous())
    gid = local.to(torch.int32)
    souts = [torch.zeros((B, T), dtype=torch.int32, device=cuda)
             for _ in range(2)]
    ab("fine_shard",
       lambda: old_fine(sftbl, sgeo, local.numel(), surv=surv, out=souts[0],
                        gid=gid),
       lambda: pq.fine_shard(sftbl, hashes, n, *sgeo, gid, num_groups=G,
                             surv=surv, out=souts[1], **fkw),
       {"B": B, "local_groups": local.numel(), "shard_rows": sftbl.shape[0],
        "T": T})

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for shape, info in summary.items():
        for side in ("old", "new"):
            mine = [t for t in turns
                    if t["shape"] == shape and t["side"] == side]
            info[side] = {m: statistics.median(t[m] for t in mine)
                          for m in ("ms", "profiled_ms")}
    print(smi)
    print(json.dumps({"gpu": smi, "median": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
