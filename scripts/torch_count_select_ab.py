#!/usr/bin/env python3
"""A/B of the port's count and select kernels: this checkout's against an
earlier version's sources, in one process on the card.

    mkdir -p chip_proof/old
    for f in count.cu select.cu ibf_hash.cuh; do
        git show <rev>:ganon_tpu_torch/csrc/$f > chip_proof/old/$f
    done
    python scripts/torch_count_select_ab.py --old chip_proof/old [--reps 2]

The earlier ``count.cu`` and ``select.cu`` are built with nvcc, each
alone, into ``build/`` and called through ctypes with the C signatures of
this checkout's ``ganon_count``, ``ganon_select``, ``ganon_select32`` and
``ganon_select_lanes`` (unchanged since they were written). This
checkout's kernels run through their wrappers. Inputs are made on the
card from ``--seed`` at the shapes of PERF.md's kernel table (k 19,
random table bytes and hashes, so the gathers are as random as a real
filter's):

* ``count``: 8192 reads of 56 hash slots (35-45 valid) on a 1024-target
  table of 2,700,000 rows x 1024 bytes (256 words);
* ``count_shard``: 4096 reads on one column shard of it (256 targets, 64
  words), the clamp off;
* ``count_forest``: 8192 reads on a forest sub of 64 targets, 1,300,000
  rows x 17 words, into columns 192.. of [8192, 256];
* ``count_raptor``: 8192 reads on four raptor subs (17, 16, 16 and 16
  words; 1.3M, 0.7M, 0.35M and 0.18M rows) max-merged into [8192, 256]:
  four launches into a zeroed matrix (old) against one launch (new);
* ``select``: 8192 reads at T = 1024, K 32, cutoffs 0.75 / 0.1 (counts:
  1-5 on 85% of the targets, one or two targets near n);
* ``select_winners``: at U = 1472, K 32, rel-cutoff 0 (most targets
  kept, the list near full);
* ``select32``: 8192 reads at T = 70,000, K 4 (``torch.topk(k=4)`` of
  the counts timed beside: one step of the function, a partial
  yardstick);
* ``select_lanes``: 8192 reads at C = 128 (S 2, group size 64), K 4.

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

    with open(src, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    so = os.path.join(BUILD_DIR, f"ab_old_{os.path.basename(src)}_{tag}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-shared",
                        "-o", so, src], check=True)
    return ctypes.CDLL(so)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True,
                    help="directory of the earlier count.cu, select.cu and "
                    "ibf_hash.cuh")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=29)
    ap.add_argument("--shapes", default="count,select",
                    help="which kernels' shapes to run: count, select or "
                    "both (comma-separated)")
    args = ap.parse_args()
    shapes = set(args.shapes.split(","))

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2

    from ganon_tpu_torch import kernels
    from ganon_tpu_torch.classify import device as dev
    from ganon_tpu_torch.ops import ibf_query as q

    smoke = _smoke()
    cuda = torch.device("cuda")
    g = torch.Generator(device=cuda).manual_seed(args.seed)
    old_c = _old_library(os.path.join(args.old, "count.cu"))
    old_s = _old_library(os.path.join(args.old, "select.cu"))
    for lib, names in ((old_c, ("count",)),
                       (old_s, ("select", "select32", "select_lanes"))):
        for name in names:
            fn = getattr(lib, f"ganon_{name}")
            fn.argtypes = list(kernels._SIGNATURES[name]) + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

    def call_old(lib, name, *a):
        cargs = [x.data_ptr() if isinstance(x, torch.Tensor) else x
                 for x in a]
        err = getattr(lib, f"ganon_{name}")(
            *cargs, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old {name}: error {err}")

    def rand_hashes(B, M, lo, hi):
        h = torch.randint(-2**63, 2**63 - 1, (B, M), generator=g,
                          device=cuda, dtype=torch.int64)
        n = torch.randint(lo, hi + 1, (B,), generator=g, device=cuda,
                          dtype=torch.int32)
        return h, n

    def table(R, W32, T):
        tbl8 = torch.randint(0, 256, (R, 4 * W32), generator=g, device=cuda,
                             dtype=torch.uint8)
        edges = torch.linspace(0, 4 * W32, T + 1, device=cuda).round().to(
            torch.int32)
        return tbl8, edges[:-1].contiguous(), edges[1:].contiguous()

    def old_count(tb, h, n, bin_size, hf, out=None, col0=0, cols=None,
                  clamp=True):
        tbl8, bs, be = tb
        B, M = h.shape
        T = bs.shape[0]
        if out is None:
            out = torch.zeros((B, T), dtype=torch.int32, device=cuda)
        call_old(old_c, "count", tbl8, tbl8.shape[0], tbl8.shape[1], bs, be,
                 T, h, B, M, n, bin_size, hf, q.clz64(bin_size), out,
                 out.shape[1], col0, cols, int(clamp))
        return out

    turns, summary = [], {}

    def record(shape, side, fn, reps=20, runs=20):
        turns.append({"shape": shape, "side": side,
                      "ms": smoke._ms(fn, reps),
                      "profiled_ms": smoke._profiled_ms(fn, runs)})
        print(json.dumps(turns[-1]), flush=True)

    def ab(shape, old, new, info, extra=None):
        a, b = old(), new()
        torch.cuda.synchronize()
        a, b = (a if isinstance(a, tuple) else (a,)), (
            b if isinstance(b, tuple) else (b,))
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{shape}: the new kernel differs from the "
                                 "old")
        summary[shape] = info
        sides = {"old": old, "new": new, **(extra or {})}
        order = ["old", "new", *(extra or {}), *(extra or {}), "new", "old"]
        for _ in range(args.reps):
            for side in order:
                record(shape, side, sides[side])

    def count_part():
        """count's four modes, old against new."""
        hf = 2
        # count: the flat 1024-target table (256 words a row)
        R = 2_700_000
        flat = table(R, 256, 1024)
        h, n = rand_hashes(8192, 56, 35, 45)
        ab("count", lambda: old_count(flat, h, n, R, hf),
           lambda: q.bulk_target_counts_packed(*flat, h, n, bin_size=R,
                                               hash_functions=hf),
           {"B": 8192, "R": R, "W32": 256, "T": 1024, "h": hf})
        # count_shard: one of its four column shards, half the batch
        shard = table(R, 64, 256)
        hs, ns = h[:4096].contiguous(), n[:4096].contiguous()
        ab("count_shard", lambda: old_count(shard, hs, ns, R, hf, clamp=False),
           lambda: q.bulk_target_counts_packed(*shard, hs, ns, bin_size=R,
                                               hash_functions=hf, clamp=False),
           {"B": 4096, "R": R, "W32": 64, "T": 256, "h": hf})
        del flat, shard
        torch.cuda.empty_cache()
        # count_forest: the forest's last sub into its columns
        Rf = 1_300_000
        sub = table(Rf, 17, 64)
        fo = [torch.zeros((8192, 256), dtype=torch.int32, device=cuda)
              for _ in range(2)]
        ab("count_forest",
           lambda: old_count(sub, h, n, Rf, hf, out=fo[0].zero_(), col0=192),
           lambda: q.bulk_target_counts_packed(*sub, h, n, bin_size=Rf,
                                               hash_functions=hf,
                                               out=fo[1].zero_(), col0=192),
           {"B": 8192, "R": Rf, "W32": 17, "T": 64, "h": hf, "ldc": 256})
        # count_raptor: four subs, 64 user bins each, one launch against four
        subs = []
        for i, (Rs, W32) in enumerate(((1_300_000, 17), (700_000, 16),
                                       (350_000, 16), (180_000, 16))):
            tbl8, bs, be = table(Rs, W32, 64)
            cols = torch.arange(64 * i, 64 * i + 64, dtype=torch.int32,
                                device=cuda)
            subs.append(dev.RaptorSub(
                tbl8=tbl8, byte_starts=bs, byte_ends=be, bin_size=Rs,
                hash_funs=hf, cols=cols))
        desc = q.sub_descriptors(subs)

        def old_raptor():
            out = torch.zeros((8192, 256), dtype=torch.int32, device=cuda)
            for s in subs:
                old_count((s.tbl8, s.byte_starts, s.byte_ends), h, n,
                          s.bin_size, s.hash_funs, out=out, cols=s.cols)
            return out

        ab("count_raptor", old_raptor,
           lambda: q.raptor_target_counts(subs, h, n, num_targets=256,
                                          desc=desc),
           {"B": 8192, "subs": [[s.tbl8.shape[0], s.tbl8.shape[1] // 4]
                                for s in subs], "T": 256, "h": hf})
        del subs, desc, sub, fo
        torch.cuda.empty_cache()

    def select_part():
        """select's four modes, old against new."""

        def counts_of(B, T, n):
            """False-positive noise (1-5 on 85% of the targets, as ~40 hashes
            at 5% give) with one or two targets per read near n."""
            c = torch.randint(1, 6, (B, T), generator=g, device=cuda,
                              dtype=torch.int32)
            c[torch.rand((B, T), generator=g, device=cuda) >= 0.85] = 0
            rows = torch.arange(B, device=cuda)
            for _ in range(2):
                t = torch.randint(0, T, (B,), generator=g, device=cuda)
                c[rows, t] = n - torch.randint(0, 3, (B,), generator=g,
                                               device=cuda, dtype=torch.int32)
            return torch.clamp(c, min=0)

        def old_select(name, c, n, o, cuts, K, uwin=None, lanes=None):
            B, T = c.shape
            wide = name == "select32"
            extra = 0 if lanes is None else -(-lanes[3] // 2)
            size = (B * K * (2 if uwin is not None or wide else 1)
                    + (4 + extra) * B
                    + (lanes[5] if lanes is not None else T) + 3)
            out = torch.zeros((size,), dtype=torch.int32, device=cuda)
            if name == "select":
                call_old(old_s, name, c, B, T, n, o, *cuts, K, 0, uwin, out)
            elif wide:
                call_old(old_s, name, c, B, T, n, o, *cuts, K, 0, out)
            else:
                call_old(old_s, name, c, B, T, n, o, *cuts, K, 0, *lanes, out)
            return out

        B = 8192
        n = torch.randint(35, 46, (B,), generator=g, device=cuda,
                          dtype=torch.int32)
        o = (torch.rand((B,), generator=g, device=cuda) < 0.02).to(torch.uint8)
        cuts = (0.75, 0.1, 65535)
        c = counts_of(B, 1024, n)
        ab("select", lambda: old_select("select", c, n, o, cuts, 32),
           lambda: dev.select(c, n, o, *cuts, top_k=32, emit_matches_t=False),
           {"B": B, "T": 1024, "K": 32, "cuts": cuts})
        cw = counts_of(B, 1472, n)
        win = torch.randint(0, 2, (B, 1472), generator=g, device=cuda,
                            dtype=torch.int32)
        wcuts = (0.0, 0.1, 65535)
        ab("select_winners",
           lambda: old_select("select", cw, n, o, wcuts, 32, uwin=win),
           lambda: dev.select(cw, n, o, *wcuts, top_k=32, emit_matches_t=False,
                              uwin=win),
           {"B": B, "T": 1472, "K": 32, "cuts": wcuts,
            "kept_mean": float((cw >= 1).sum(1).float().mean())})
        del cw, win
        c32 = counts_of(B, 70_000, n)
        ab("select32", lambda: old_select("select32", c32, n, o, cuts, 4),
           lambda: dev.select(c32, n, o, *cuts, top_k=4, emit_matches_t=False,
                              pack16=False),
           {"B": B, "T": 70_000, "K": 4, "cuts": cuts,
            "topk_shape": [B, 70_000, 4]},
           extra={"topk": lambda: torch.topk(c32, 4, dim=1)})
        del c32
        torch.cuda.empty_cache()
        S, gs, G = 2, 64, 128
        cl = counts_of(B, S * gs, n)
        gsel = torch.stack([
            torch.randperm(G, generator=g, device=cuda)[:S] for _ in range(8)
        ]).repeat(B // 8, 1).to(torch.int32)
        slot_ok = (torch.rand((B, S), generator=g, device=cuda) < 0.9).to(
            torch.uint8)
        nt = torch.full((G,), gs, dtype=torch.int32, device=cuda)
        nt[-1] = 40
        lanes_args = (gsel, slot_ok, nt, S, gs, G * gs)
        ab("select_lanes",
           lambda: old_select("select_lanes", cl, n, o, cuts, 4,
                              lanes=lanes_args),
           lambda: dev.select_lanes(cl, n, o, gsel, slot_ok, nt, *cuts,
                                    group_size=gs, num_targets=G * gs, top_k=4,
                                    emit_matches_t=False),
           {"B": B, "C": S * gs, "K": 4, "cuts": cuts})

    if "count" in shapes:
        count_part()
    if "select" in shapes:
        select_part()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for shape, info in summary.items():
        for side in sorted({t["side"] for t in turns if t["shape"] == shape}):
            mine = [t for t in turns
                    if t["shape"] == shape and t["side"] == side]
            info[side] = {m: statistics.median(t[m] for t in mine)
                          for m in ("ms", "profiled_ms")}
    print(smi)
    print(json.dumps({"gpu": smi, "median": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
