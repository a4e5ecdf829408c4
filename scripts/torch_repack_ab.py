#!/usr/bin/env python3
"""A/B of the filter load's repack (``csrc/repack.cu``, row L: the port of
``ganon_tpu/ops/ibf_query.py:162 pack_table_u8``): this checkout's kernel
against an earlier version's source, in one process on the card.

    mkdir -p chip_proof/old
    for f in repack.cu sm_count.cuh; do
        git show <rev>:ganon_tpu_torch/csrc/$f > chip_proof/old/$f; done
    python scripts/torch_repack_ab.py --old chip_proof/old [--reps 2]

The earlier ``repack.cu`` (a thread a word column, its 32 source bins in
registers, a test of each destination bit a row) is built with nvcc alone
into ``build/`` and called through ctypes behind a copy of its earlier
wrapper (``torch.empty`` output, the plan's ``src_of_dst`` uploaded, then
``kernels.launch``'s path: the device, the raw stream, the C call). This
checkout's kernel runs through its wrapper (``ops.ibf_query.
repack_table``). Bit-matrices are random words made on the card from
``--seed``, one bin a target (db's layout, 8x padding):

* ``db``: db's whole matrix, 2,724,977 rows of 32 words (1024 targets)
  into its 2.79 GB table;
* ``window``: shard 1 of 4 of that table, byte columns 256..511 (a
  (2, 4) mesh load's window);
* ``sub16``: a 64-target forest or raptor sub, rows of 2 words into 16
  words, 1,048,576 rows;
* ``wide``: the wide filter's rows of 2188 words (70,000 targets) into
  17,500 words, 4096 rows.

Each shape runs old, new, new, old per rep: ``ms`` (one call between two
CUDA events, median of 10), ``queued_ms`` (10 calls queued behind a card
sleep, back to back, between two events: the card's time a call where
the host keeps ahead; the earlier wrapper's pageable upload waits on the
stream, so its calls never queue), ``kernel_ms`` (10 launches alone,
queued the same way, their arguments uploaded and their output made
once: the kernel's card time) and ``host_us`` (the host's time a call
over 50 calls queued without a wait); beside them ``fill_ms``, a
``fill_`` of the same output queued the same way (the card's time to
store the table alone, the practical floor under the bound).
Both sides' tables must equal the plain version's. Beside each shape its
bound (``chip_smoke._repack_work``: the source words the window names
read once a row and the table written once, over 3.35 TB/s) and the new
kernel's launch geometry (modes, dynamic shared memory, blocks an SM).
One JSON line a turn, then the card's name and power limit and the
medians of each side. Needs one CUDA card.
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

_P, _L = ctypes.c_void_p, ctypes.c_int64
# bits, R, W, src_of_dst, n_dst, c0w, wc, tbl (the earlier C entry)
OLD_SIGNATURE = (_P, _L, _L, _P, _L, _L, _L, _P)


def _smoke():
    """chip_smoke.py of this checkout, for its timing helpers."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _library(src: str) -> ctypes.CDLL:
    """Build one repack.cu into a library under ``build/`` and load it
    (its headers from its own directory)."""
    from ganon_tpu_torch import BUILD_DIR, kernels

    tag = hashlib.sha1()
    d = os.path.dirname(src)
    for name in sorted(os.listdir(d)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(d, name), "rb") as f:
                tag.update(name.encode() + b"\0" + f.read())
    so = os.path.join(BUILD_DIR, f"ab_repack_{tag.hexdigest()[:12]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-shared",
                        "-o", so, src], check=True)
    return ctypes.CDLL(so)


SHAPES = (
    # name, rows, targets, source words a row, window (c0, width) or None
    ("db", 2_724_977, 1024, 32, None),
    ("window", 2_724_977, 1024, 32, (256, 256)),
    ("sub16", 1 << 20, 64, 2, None),
    ("wide", 4096, 70_000, 2188, None),
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True,
                    help="directory of the earlier repack.cu")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=21)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2

    from ganon_tpu_torch import kernels
    from ganon_tpu_torch.ops import ibf_query as q

    smoke = _smoke()
    cuda = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=cuda).manual_seed(args.seed)
    old_fn = _library(os.path.join(args.old, "repack.cu")).ganon_repack
    old_fn.argtypes = list(OLD_SIGNATURE) + [ctypes.c_void_p]
    old_fn.restype = ctypes.c_int

    def old(bits, plan, c0, width):
        """The earlier wrapper, as it was."""
        width = q._check_repack(bits, plan, c0, width)
        kernels.check_cuda(bits)
        R = bits.shape[0]
        out = torch.empty((R, width), dtype=torch.uint8, device=cuda)
        src = torch.from_numpy(plan.src_of_dst).to(cuda)
        err = kernels.library().ganon_set_device(cuda.index)
        if err != 0:
            raise RuntimeError(f"cudaSetDevice failed: error {err}")
        err = old_fn(bits.data_ptr(), R, bits.shape[1], src.data_ptr(),
                     src.numel(), c0 // 4, width // 4, out.data_ptr(),
                     torch._C._cuda_getCurrentRawStream(cuda.index))
        if err != 0:
            raise RuntimeError(f"old repack: error {err}")
        return out

    def host_us(fn, n):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / n * 1e6

    turns, summary = [], {}
    for shape, R, T, W, window in SHAPES:
        b2t = np.full(W * 32, T, dtype=np.int32)
        b2t[:T] = np.arange(T)
        plan = q.repack_plan(b2t, T)
        c0, width = window or (0, plan.W8p)
        bits = torch.randint(-2**31, 2**31 - 1, (R, W), generator=g,
                             dtype=torch.int32, device=cuda)
        sides = {"old": lambda: old(bits, plan, c0, width),
                 "new": lambda: q.repack_table(bits, plan, c0=c0,
                                               width=width)}
        # the launches alone, into one output, arguments on the card
        out = torch.empty((R, width), dtype=torch.uint8, device=cuda)
        src = torch.from_numpy(plan.src_of_dst).to(cuda)
        geo = q.repack_geometry(plan, R, W, c0 // 4, width // 4)
        buf = torch.from_numpy(q._repack_args(plan, geo)).to(cuda)
        n_t, at = len(geo.tiles), buf.data_ptr()
        stream = torch._C._cuda_getCurrentRawStream(cuda.index)

        def old_launch():
            err = old_fn(bits.data_ptr(), R, W, src.data_ptr(), src.numel(),
                         c0 // 4, width // 4, out.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"old repack: error {err}")

        launches = {"old": old_launch,
                    "new": lambda: kernels.launch(
                        "repack", bits, R, W, at + 32 * n_t,
                        at + 32 * n_t + 8 * len(plan.run_word),
                        len(plan.src_of_dst), at, n_t, c0 // 4, width // 4,
                        geo.cq, geo.nrb, geo.stage_words, geo.desc_cap,
                        geo.col_cap, out)}
        want = q.repack_table_plain(bits, plan, c0=c0, width=width)
        for side, fn in sides.items():
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{shape}: {side} differs from plain")
            del got
        for side, fn in launches.items():
            out.fill_(0xA5)
            fn()
            if not torch.equal(out, want):
                raise AssertionError(f"{shape}: {side}'s launch differs")
        del want
        fill = [smoke._ms_run(lambda: out.fill_(7), 10)
                for _ in range(2 * args.reps)]
        summary[shape] = {
            "R": R, "W": W, "targets": T, "c0": c0, "width": width,
            "bound_ms": smoke._bound(*smoke._repack_work(
                bits, plan, c0, width))[0],
            "fill_ms": statistics.median(fill),
            "modes": sorted({int(m) for m in geo.tiles[:, 7]}),
            "tiles": len(geo.tiles), "cq": geo.cq, "nrb": geo.nrb,
            "smem_bytes": geo.smem_bytes,
            "blocks_per_sm": kernels.library().ganon_repack_blocks_per_sm(
                geo.smem_bytes)}
        print(json.dumps({shape: summary[shape]}), flush=True)
        order = list(sides)
        for _ in range(args.reps):
            for side in order + order[::-1]:
                fn = sides[side]
                turns.append({"shape": shape, "side": side,
                              "ms": smoke._ms(fn, 10),
                              "queued_ms": smoke._ms_run(fn, 10),
                              "kernel_ms": smoke._ms_run(launches[side], 10),
                              "host_us": host_us(fn, 50)})
                print(json.dumps(turns[-1]), flush=True)
        del bits, out, src, buf
        torch.cuda.empty_cache()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for shape, info in summary.items():
        for side in ("new", "old"):
            mine = [t for t in turns
                    if t["shape"] == shape and t["side"] == side]
            info[side] = {m: statistics.median(t[m] for t in mine)
                          for m in ("ms", "queued_ms", "kernel_ms",
                                    "host_us")}
            info[side]["kernel_x_bound"] = (info[side]["kernel_ms"]
                                            / info["bound_ms"])
    print(smi)
    print(json.dumps({"gpu": smi, "median": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
