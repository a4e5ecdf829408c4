#!/usr/bin/env python3
"""A/B of the port's combine (``csrc/shard.cu``) and pack
(``csrc/sort.cu``) kernels: this checkout's against an earlier version's
sources, in one process on the card.

    mkdir -p chip_proof/old
    for f in shard.cu sort.cu; do
        git show <rev>:ganon_tpu_torch/csrc/$f > chip_proof/old/$f
    done
    python scripts/torch_combine_pack_ab.py --old chip_proof/old [--reps 2]

The earlier ``shard.cu`` and ``sort.cu`` are built with nvcc, each alone,
into ``build/`` and called through ctypes with their own C signatures
(``ganon_combine`` took the spans as int32 arrays on the card;
``ganon_pack`` took an offsets buffer and the three-kernel scan's
scratch), behind copies of their earlier wrappers (the same checks,
allocations and launch path), so a call's time compares wrapper with
wrapper. This checkout's kernels run through their wrappers
(``ops.ibf_query.combine``, ``ops.build_ops.pack_entries``). Inputs are
made on the card from ``--seed`` at the shapes of PERF.md's kernel
table:

* ``combine``: a mesh batch row of 4096 reads, T = 1024 targets over 4
  shards of 256 (the mesh phase: a target a byte, no split target), flat
  mode into [4096, 1024];
* ``combine_split``: the same with T = 1021 and a target split at every
  shard edge (rows and blocks off 16 bytes: the kernel's scalar edges);
* ``combine_cols``: column-max mode, a raptor sub of 64 targets over 4
  shards (a split target at each edge) max-merged into [4096, 256] (each
  call first restores the matrix: one copy in both sides' times);
* ``mesh_row``: the caller, ``ShardedTable.counts`` of one batch row
  (4096 reads of 40 hashes, a table of 2^20 rows x 1024 bytes, h 2, 4
  column shards): the earlier side zero-fills the partials and the
  output as that caller did, counts the shards and runs the earlier
  combine; the new side is the caller as it is;
* ``pack``: the build's first pass-1 group, 16,384 extract rows of 2018
  slots (pieces of 2048 bases, w 31), 250-310 valid slots a row, the
  rows' file keys ascending over 133 files; ``pack_narrow``: the same
  valid slots in rows of 311 (the valid runs nearly end to end); beside
  them, ``copy``: the card time of one ``Tensor.copy_`` that moves as
  many bytes (the card's rate for plain streaming, a yardstick, not an
  A/B).

Each shape runs old, new, new, old per rep (a call between two CUDA
events, median; the card's activity under torch.profiler; the host's
time a call over 100 calls back to back); the new
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
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# the earlier C signatures (the stream is the last pointer)
OLD_SIGNATURES = {
    # parts, t_lo, t_hi (int32 [nb] on the card), nb, B, T, n_hashes,
    # counts, ldc, col0, cols
    "combine": ("shard.cu", (_P, _P, _P, _I, _L, _I, _P, _P, _L, _I, _P)),
    # hashes, B, mc, n, keys, offs, sums, out_key, out_val, N
    "pack": ("sort.cu", (_P, _L, _I, _P, _P, _P, _P, _P, _P, _L)),
}
# the earlier pack's scan scratch: an int64 sum a block of 2048 rows
OLD_SCAN_TILE = 2048


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
                    help="directory of the earlier shard.cu and sort.cu")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=37)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2

    from ganon_tpu_torch import kernels
    from ganon_tpu_torch.classify.device import ShardedTable
    from ganon_tpu_torch.ops import build_ops as bo
    from ganon_tpu_torch.ops import ibf_query as q
    from ganon_tpu_torch.parallel.mesh import Mesh

    smoke = _smoke()
    cuda = torch.device("cuda")
    g = torch.Generator(device=cuda).manual_seed(args.seed)
    old = {}
    for name, (src, sig) in OLD_SIGNATURES.items():
        fn = getattr(_old_library(os.path.join(args.old, src)),
                     f"ganon_{name}")
        fn.argtypes = list(sig) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        old[name] = fn

    def call_old(name, *a):
        """kernels.launch's path (device, raw stream) to an earlier
        kernel."""
        lib = kernels.library()
        if lib.ganon_set_device(cuda.index or 0):
            raise RuntimeError("cudaSetDevice failed")
        cargs = [x.data_ptr() if isinstance(x, torch.Tensor) else x
                 for x in a]
        err = old[name](*cargs,
                        torch._C._cuda_getCurrentRawStream(cuda.index or 0))
        if err:
            raise RuntimeError(f"old {name}: error {err}")

    def old_combine(parts, t_lo, t_hi, n_hashes, out, *, num_targets,
                    col0=0, cols=None):
        """The earlier ``combine`` wrapper (spans on the card)."""
        nb = t_lo.shape[0] if t_lo.dim() == 1 else -1
        if (t_lo.dtype != torch.int32 or t_hi.dtype != torch.int32
                or nb < 1 or t_hi.shape != (nb,)):
            raise ValueError("t_lo and t_hi must be int32 [nb], nb >= 1")
        if n_hashes.dtype != torch.int32 or n_hashes.dim() != 1:
            raise ValueError("n_hashes must be int32 [B]")
        B = n_hashes.shape[0]
        if parts.dtype != torch.int32 or parts.dim() != 1:
            raise ValueError("parts must be flat int32")
        if out.dtype != torch.int32 or out.dim() != 2 or (
                out.shape[0] != B) or not out.is_contiguous():
            raise ValueError(f"out must be contiguous int32 [{B}, ldc]")
        if cols is not None and (col0 != 0 or cols.dtype != torch.int32
                                 or cols.dim() != 1):
            raise ValueError("column-max mode takes col0 = 0 and cols")
        if cols is None and not 0 <= col0 <= out.shape[1] - num_targets:
            raise ValueError("out must hold columns col0 .. col0 + T")
        if cols is not None and cols.shape != (num_targets,):
            raise ValueError(f"cols must be int32 [{num_targets}]")
        kernels.check_cuda(parts, t_lo, t_hi, n_hashes, out,
                           *([] if cols is None else [cols]))
        call_old("combine", parts, t_lo, t_hi, nb, B, num_targets,
                 n_hashes, out, out.shape[1], col0, cols)
        return out

    def old_pack(hashes, n_rows, keys, total):
        """The earlier ``pack_entries`` wrapper (four allocations)."""
        if hashes.dtype != torch.int64 or hashes.dim() != 2:
            raise ValueError("hashes must be int64 [B, mc]")
        B, mc = hashes.shape
        if n_rows.dtype != torch.int32 or keys.dtype != torch.int32 or \
                n_rows.shape != (B,) or keys.shape != (B,):
            raise ValueError("n_rows and keys must be int32 [B]")
        bo.check_entry_count(total)
        kernels.check_cuda(hashes, n_rows, keys)
        out_key = torch.empty((total,), dtype=torch.int32, device=cuda)
        out_val = torch.empty((total,), dtype=torch.int64, device=cuda)
        offs = torch.empty((B,), dtype=torch.int32, device=cuda)
        sums = torch.empty((max(-(-B // OLD_SCAN_TILE), 1),),
                           dtype=torch.int64, device=cuda)
        call_old("pack", hashes, B, mc, n_rows, keys, offs, sums, out_key,
                 out_val, total)
        return out_key, out_val

    turns, summary = [], {}

    def host_us(fn, n=100):
        """Microseconds of the host a call: n calls back to back, timed
        before the card catches up (the wrapper, the allocations and the
        launches, not the kernels)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return us

    def record(shape, side, fn, reps=20, runs=20):
        turns.append({"shape": shape, "side": side,
                      "ms": smoke._ms(fn, reps),
                      "profiled_ms": smoke._profiled_ms(fn, runs),
                      "host_us": host_us(fn)})
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

    # combine -----------------------------------------------------------------
    B = 4096

    def spans(T, nb, split):
        """nb shards over T targets, a split target at each edge."""
        cut = [T * j // nb for j in range(nb + 1)]
        lo = cut[:-1]
        hi = [c + (1 if split and j < nb - 1 else 0)
              for j, c in enumerate(cut[1:])]
        return (torch.tensor(lo, dtype=torch.int32),
                torch.tensor(hi, dtype=torch.int32))

    def combine_shape(shape, T, nb, split, ldc=None, cols=None):
        lo, hi = spans(T, nb, split)
        dlo, dhi = lo.to(cuda), hi.to(cuda)
        width = int((hi - lo).sum())
        parts = torch.randint(0, 40, (B * width,), generator=g, device=cuda,
                              dtype=torch.int32)
        n = torch.randint(0, 100, (B,), generator=g, device=cuda,
                          dtype=torch.int32)
        ldc = ldc or T
        base = torch.randint(0, 60, (B, ldc), generator=g, device=cuda,
                             dtype=torch.int32)
        outs = [base.clone() for _ in range(2)]

        def run_old():
            if cols is not None:
                outs[0].copy_(base)
            return old_combine(parts, dlo, dhi, n, outs[0], num_targets=T,
                               cols=cols)

        def run_new():
            if cols is not None:
                outs[1].copy_(base)
            return q.combine(parts, lo, hi, n, outs[1], num_targets=T,
                             cols=cols)

        ab(shape, run_old, run_new,
           {"B": B, "T": T, "shards": nb, "split_targets": split,
            "ldc": ldc, "column_max": cols is not None,
            "bytes": parts.numel() * 4 + B * T * 4 * (
                3 if cols is not None else 1) + B * 4})

    combine_shape("combine", 1024, 4, False)
    combine_shape("combine_split", 1021, 4, True)
    colmap = torch.randperm(256, generator=g, device=cuda)[:64].to(
        torch.int32).sort().values
    combine_shape("combine_cols", 64, 4, True, ldc=256, cols=colmap)

    # the caller: ShardedTable.counts of one batch row ----------------------
    R, W8, M = 1 << 20, 1024, 40
    # a bit set in a quarter of the cells: the AND of two random bytes
    tbl8 = torch.randint(0, 256, (R, W8), generator=g, device=cuda,
                         dtype=torch.uint8)
    tbl8 &= torch.randint(0, 256, (R, W8), generator=g, device=cuda,
                          dtype=torch.uint8)
    ends = torch.arange(1, W8 + 1, dtype=torch.int32)
    table = ShardedTable(tbl8, ends - 1, ends, W8, Mesh([[cuda] * 4]),
                         bin_size=R, hash_functions=2)
    del tbl8
    torch.cuda.empty_cache()
    hashes = torch.randint(-2**63, 2**63 - 1, (B, M), generator=g,
                           device=cuda, dtype=torch.int64)
    nh = torch.randint(25, M + 1, (B,), generator=g, device=cuda,
                       dtype=torch.int32)
    dlo, dhi = (x.to(cuda) for x in table.spans)
    kw = dict(bin_size=R, hash_functions=2, clamp=False)

    def row_old():
        parts = torch.zeros(B * sum(table.widths), dtype=torch.int32,
                            device=cuda)
        off = 0
        for sh, w in zip(table.shards[0], table.widths):
            q.bulk_target_counts_packed(
                sh.tbl8, sh.byte_starts, sh.byte_ends, hashes, nh,
                out=parts[off:off + B * w].view(B, w), **kw)
            off += B * w
        out = torch.zeros((B, W8), dtype=torch.int32, device=cuda)
        return old_combine(parts, dlo, dhi, nh, out, num_targets=W8)

    ab("mesh_row", row_old, lambda: table.counts(0, hashes, nh),
       {"B": B, "M": M, "rows": R, "W8": W8, "shards": 4, "h": 2,
        "fill_parts": table.fill_parts})
    del table, hashes
    torch.cuda.empty_cache()

    # pack --------------------------------------------------------------------
    PB, mc, files = 16_384, 2048 - 31 + 1, 133
    ph = torch.randint(-2**63, 2**63 - 1, (PB, mc), generator=g,
                       device=cuda, dtype=torch.int64)
    pn = torch.randint(250, 311, (PB,), generator=g, device=cuda,
                       dtype=torch.int32)
    pkeys = (torch.arange(PB, device=cuda) * files // PB).to(torch.int32)
    total = int(pn.sum())

    ab("pack", lambda: old_pack(ph, pn, pkeys, total),
       lambda: bo.pack_entries(ph, pn, pkeys, total),
       {"rows": PB, "mc": mc, "entries": total,
        "bytes": PB * 8 + total * (8 + 12)})
    # the same valid slots in rows of 311 (the rows' runs nearly end to
    # end): whether the read pattern of 2.2 KB runs 16 KB apart costs time
    del ph
    nh = torch.randint(-2**63, 2**63 - 1, (PB, 311), generator=g,
                       device=cuda, dtype=torch.int64)
    ab("pack_narrow", lambda: old_pack(nh, pn, pkeys, total),
       lambda: bo.pack_entries(nh, pn, pkeys, total),
       {"rows": PB, "mc": 311, "entries": total,
        "bytes": PB * 8 + total * (8 + 12)})
    del nh
    # the card's rate for plain streaming: a copy that moves pack's bytes
    # (half read, half written)
    src = torch.empty(((PB * 8 + total * 20) // 16,), dtype=torch.int64,
                      device=cuda)
    dst = torch.empty_like(src)
    summary["copy"] = {"bytes": 2 * src.numel() * 8,
                       "profiled_ms": smoke._profiled_ms(
                           lambda: dst.copy_(src), 20)}

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for shape, info in summary.items():
        for side in ("old", "new") if shape != "copy" else ():
            mine = [t for t in turns
                    if t["shape"] == shape and t["side"] == side]
            info[side] = {}
            for m in ("ms", "profiled_ms", "host_us"):
                vals = [t[m] for t in mine if t[m] is not None]
                info[side][m] = statistics.median(vals) if vals else None
    print(smi)
    print(json.dumps({"gpu": smi, "median": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
