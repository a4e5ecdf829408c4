#!/usr/bin/env python3
"""A/B of the port's extract and pairs kernels: this checkout's against an
earlier version's sources, in one process on the card.

    git show <rev>:ganon_tpu_torch/csrc/extract.cu > <dir>/extract.cu
    git show <rev>:ganon_tpu_torch/csrc/scan.cu > <dir>/scan.cu
    python scripts/torch_extract_ab.py --old <dir> [--reps 2]

The earlier sources are built with nvcc, each alone, into ``build/`` and
called through ctypes with their own C signatures (``ganon_extract``:
inbuf, B, row_bytes, L1, L2, k, w, mc, hashes, n, overflow, stream;
``ganon_pairs``: slot_ok, B, S, P, live, overflow, stream, the overflow a
copy of the input flags, as its wrapper made). This checkout's kernels
run through their wrappers (``ops.ibf_query.extract``,
``ops.pruned_query.pair_live``). Shapes, k 19, w 31, data made on the
card from ``--seed`` (random bases):

* ``build``: 16,384 pieces of 2048 bases, every window position (mc
  2018), the new kernel also in the build's mode (``zero_tail=False``);
* ``classify``: 8192 pairs of 150 bp in 160-base mates, mc 56;
* ``mixed``: 512 reads of 16,000 bases in 16,384-base rows (the long-read
  mix's 16 kbp bucket at the engine's bp budget), its compaction width;
* ``ultra``: ``--ultra-rows`` (64) reads of 600,000 bases in 2^20-base
  rows, every window position (the new kernel also without the zero
  tail);
* ``pairs``: 8192 reads, S 2, the engine's cap (8192), against
  ``torch.cumsum`` of the slot flags; then the host's microseconds a
  call of the wrapper, of ``torch.cumsum`` and of the wrapper's parts.

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
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
K, W = 19, 31


def _smoke():
    """chip_smoke.py of this checkout, for its timing helpers."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _old_library(src: str) -> ctypes.CDLL:
    """Build one earlier source alone into ``build/`` and load it."""
    from ganon_tpu_torch import BUILD_DIR, kernels

    with open(src, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    so = os.path.join(BUILD_DIR, f"ab_old_{os.path.basename(src)}_{tag}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-shared",
                        "-o", so, src], check=True)
    return ctypes.CDLL(so)


def _inbuf(g, cuda, B, L1, L2, len1, len2=0):
    import torch

    row = L1 // 4 + L2 // 4 + 4 + (4 if L2 else 0)
    buf = torch.randint(0, 256, (B, row), generator=g, device=cuda,
                        dtype=torch.uint8)
    o = L1 // 4 + L2 // 4
    lens = [len1] + ([len2] if L2 else [])
    buf[:, o:] = torch.tensor(lens, dtype=torch.int32).view(
        torch.uint8).to(cuda)
    return buf


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True,
                    help="directory of the earlier extract.cu and scan.cu")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--ultra-rows", type=int, default=64)
    ap.add_argument("--seed", type=int, default=23)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2

    from ganon_tpu_torch import kernels
    from ganon_tpu_torch.classify import device as dev
    from ganon_tpu_torch.ops import ibf_query as q
    from ganon_tpu_torch.ops import pruned_query as pq

    smoke = _smoke()
    cuda = torch.device("cuda")
    g = torch.Generator(device=cuda).manual_seed(args.seed)
    old_x = _old_library(os.path.join(args.old, "extract.cu"))
    old_p = _old_library(os.path.join(args.old, "scan.cu"))
    P_, I_, L_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    old_x.ganon_extract.argtypes = [P_, L_, L_, I_, I_, I_, I_, I_, P_, P_,
                                    P_, P_]
    old_p.ganon_pairs.argtypes = [P_, L_, I_, L_, P_, P_, P_]
    # each library links its own CUDA runtime, on device 0 by default

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def old_extract(inbuf, L1, L2, mc):
        B, row = inbuf.shape
        h = torch.empty((B, mc), dtype=torch.int64, device=cuda)
        n = torch.empty((B,), dtype=torch.int32, device=cuda)
        o = torch.empty((B,), dtype=torch.uint8, device=cuda)
        err = old_x.ganon_extract(inbuf.data_ptr(), B, row, L1, L2, K, W, mc,
                                  h.data_ptr(), n.data_ptr(), o.data_ptr(),
                                  stream())
        if err:
            raise RuntimeError(f"old extract: error {err}")
        return h, n, o

    def old_pairs(slot_ok, ovf_in, cap):
        B, S = slot_ok.shape
        live = torch.empty_like(slot_ok)
        ovf = ovf_in.clone()
        err = old_p.ganon_pairs(slot_ok.data_ptr(), B, S, cap,
                                live.data_ptr(), ovf.data_ptr(), stream())
        if err:
            raise RuntimeError(f"old pairs: error {err}")
        return live, ovf

    L_MIX = 16_384
    cases = {
        "build": (_inbuf(g, cuda, 16_384, 2048, 0, 2048), 2048, 0,
                  2048 - W + 1),
        "classify": (_inbuf(g, cuda, 8192, 160, 160, 150, 150), 160, 160,
                     dev.compact_width(2 * (160 - W + 1))),
        "mixed": (_inbuf(g, cuda, 8192 * 1024 // L_MIX, L_MIX, 0, 16_000),
                  L_MIX, 0, dev.compact_width(L_MIX - W + 1)),
        "ultra": (_inbuf(g, cuda, args.ultra_rows, 1 << 20, 0, 600_000),
                  1 << 20, 0, (1 << 20) - W + 1),
    }
    turns, summary = [], {}

    def record(shape, side, fn, reps, runs):
        turns.append({"shape": shape, "side": side,
                      "ms": smoke._ms(fn, reps),
                      "profiled_ms": smoke._profiled_ms(fn, runs)})
        print(json.dumps(turns[-1]), flush=True)

    for shape, (inbuf, L1, L2, mc) in cases.items():
        new = q.extract(inbuf, L1=L1, L2=L2, k=K, w=W, mc=mc)
        old = old_extract(inbuf, L1, L2, mc)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(new, old)):
            raise AssertionError(f"{shape}: the new extract differs from "
                                 "the old")
        summary[shape] = {"B": inbuf.shape[0], "L1": L1, "L2": L2, "mc": mc,
                          "n_mean": float(new[1].float().mean())}
        del new, old
        reps, runs = (3, 3) if shape == "ultra" else (10, 20)
        sides = {"old": lambda: old_extract(inbuf, L1, L2, mc),
                 "new": lambda: q.extract(inbuf, L1=L1, L2=L2, k=K, w=W,
                                          mc=mc)}
        if shape in ("build", "ultra"):
            sides["new_no_tail"] = lambda: q.extract(
                inbuf, L1=L1, L2=L2, k=K, w=W, mc=mc, zero_tail=False)
        for _ in range(args.reps):
            for side in ("old", *[s for s in sides if s != "old"], "old"):
                record(shape, side, sides[side], reps, runs)
        torch.cuda.empty_cache()

    B, S = 8192, 2
    slot_ok = (torch.rand((B, S), generator=g, device=cuda) < 0.6).to(
        torch.uint8)
    ovf_in = (torch.rand((B,), generator=g, device=cuda) < 0.05).to(
        torch.uint8)
    cap = min(-(-B // 256) * 256, B * S)
    flags = slot_ok.reshape(-1).to(torch.int32)
    new, old = pq.pair_live(slot_ok, ovf_in, cap), old_pairs(slot_ok, ovf_in,
                                                             cap)
    want = pq.pair_live_plain(slot_ok, ovf_in, cap)
    if not all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(new, old, want)):
        raise AssertionError("pairs: new, old and plain differ")
    summary["pairs"] = {"B": B, "S": S, "cap": cap}
    sides = {"old": lambda: old_pairs(slot_ok, ovf_in, cap),
             "new": lambda: pq.pair_live(slot_ok, ovf_in, cap),
             "cumsum": lambda: torch.cumsum(flags, 0)}
    for _ in range(args.reps):
        for side in ("old", "new", "cumsum", "cumsum", "new", "old"):
            record("pairs", side, sides[side], 20, 200)
    # the host's share of a call: microseconds a call over 2000 calls
    # (the card's time is a few microseconds, so the host sets the rate),
    # for the wrapper and its parts
    live, ovf = pq.pair_live(slot_ok, ovf_in, cap)
    status, _ = kernels.scan_status(slot_ok.device, -(-B // pq.PAIRS_READS))
    parts = dict(sides, **{
        "empty_like": lambda: torch.empty_like(slot_ok),
        "scan_status": lambda: kernels.scan_status(slot_ok.device, 32),
        "launch": lambda: kernels.launch("pairs", slot_ok, B, S, cap, ovf_in,
                                         status, next(kernels._SCAN_EPOCHS)
                                         % kernels.EPOCH_LIMIT, live, ovf),
    })
    host = {}
    for side, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        torch.cuda.synchronize()
        host[side] = (time.perf_counter() - t0) / 2000 * 1e6
    summary["pairs"]["host_us"] = host

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
