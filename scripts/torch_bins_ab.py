#!/usr/bin/env python3
"""A/B of the ops library's per-bin counts (``csrc/bins.cu``: ``bins``,
K18b, and ``bins_target``, K18d): this checkout's kernels against an
earlier version's source, in one process on the card.

    mkdir -p chip_proof/old
    git show <rev>:ganon_tpu_torch/csrc/bins.cu > chip_proof/old/bins.cu
    python scripts/torch_bins_ab.py --old chip_proof/old [--reps 2] \
        [--variants chip_proof/a,chip_proof/b]

The earlier ``bins.cu`` is built with nvcc alone into ``build/`` and
called through ctypes with the C signatures of this checkout's
``ganon_bins`` and ``ganon_bins_target`` (the earlier one always takes a
``[B, 32 W]`` scratch), behind a copy of its earlier caller (the output,
and the scratch, from ``torch.empty``). This checkout's kernels run
through their wrappers (``ops.library.bulk_count_bins`` and
``bulk_target_counts``, which takes its one-launch route where
``bins_target_fused`` says so). ``--variants`` names directories of
other versions of this checkout's ``bins.cu`` (each with the headers it
includes), built the same way and called with this checkout's C
signatures, as the wrapper calls them; they are timed in the same turns
and their outputs must equal the new ones. Inputs are made on the card
from ``--seed`` at the shapes of ``chip_smoke.py``'s rows, with random bits:

* ``bins_db``, ``bins_target_db``: the ops phase, 16,384 reads of 120
  hash slots (a prefix of 12-22 valid, as a 150 bp read's minimizers at
  k 19, w 31), S = 1, db's matrix of 2,787,889 rows x 32 words (349 MB),
  1024 targets of one bin each;
* ``bins_wide``, ``bins_target_wide``: the wide phase, 1024 reads of the
  same slots, S = 1, a matrix of 11,133 rows x 2188 words (T = 70,000,
  16 padding bins), bins_target on its two-launch route.

Each shape runs old, new, the variants, then the same backwards, per
rep: ``ms`` (one call between two CUDA events, median of 20),
``queued_ms`` (20 calls queued while the card sleeps, so they run back
to back, between two events: the card's time a call) and ``host_us``
(the host's time a call over 100 calls queued without a wait). Every
side's outputs must equal the new ones. Beside
each shape its bound: the distinct rows probed, rows, mask, segments and
the output, each once, over 3.35 TB/s. One JSON line a turn, then the
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
SIGNATURES = {
    # bits, R, W, rows, B, M, S, mask, out
    "bins": (_P, _L, _L, _P, _L, _I, _I, _P, _P),
    # bits, R, W, rows, B, M, S, mask, scratch, perm, starts, ends, T, out
    "bins_target": (_P, _L, _L, _P, _L, _I, _I, _P, _P, _P, _P, _P, _I, _P),
}


def _smoke():
    """chip_smoke.py of this checkout, for its timing helpers."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _library(src: str) -> ctypes.CDLL:
    """Build one bins.cu alone into ``build/`` and load it (its headers
    from its own directory)."""
    from ganon_tpu_torch import BUILD_DIR, kernels

    tag = hashlib.sha1()
    for name in sorted(os.listdir(os.path.dirname(src))):
        with open(os.path.join(os.path.dirname(src), name), "rb") as f:
            tag.update(name.encode() + b"\0" + f.read())
    so = os.path.join(BUILD_DIR, f"ab_bins_{tag.hexdigest()[:12]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-shared",
                        "-o", so, src], check=True)
    return ctypes.CDLL(so)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True,
                    help="directory of the earlier bins.cu")
    ap.add_argument("--variants", default="",
                    help="directories of other versions of this "
                    "checkout's bins.cu, comma-separated")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=16)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2

    from ganon_tpu_torch import kernels
    from ganon_tpu_torch.ops import library as lib

    smoke = _smoke()
    cuda = torch.device("cuda")
    g = torch.Generator(device=cuda).manual_seed(args.seed)
    dirs = {"old": args.old}
    for d in filter(None, args.variants.split(",")):
        dirs[os.path.basename(os.path.normpath(d))] = d
    libs = {}
    for side, d in dirs.items():
        lib_ = _library(os.path.join(d, "bins.cu"))
        libs[side] = {}
        for name, sig in SIGNATURES.items():
            fn = getattr(lib_, f"ganon_{name}")
            fn.argtypes = list(sig) + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            libs[side][name] = fn

    def call(side, name, *a):
        """kernels.launch's path (device, raw stream) to a kernel of
        another bins.cu."""
        if kernels.library().ganon_set_device(cuda.index or 0):
            raise RuntimeError("cudaSetDevice failed")
        cargs = [x.data_ptr() if isinstance(x, torch.Tensor) else x
                 for x in a]
        err = libs[side][name](
            *cargs, torch._C._cuda_getCurrentRawStream(cuda.index or 0))
        if err:
            raise RuntimeError(f"{side} {name}: error {err}")

    def host_us(fn, n=100):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / n * 1e6

    turns, summary = [], {}

    def ab(shape, sides, info):
        want = sides["new"]()
        for side, fn in sides.items():
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{shape}: {side} differs from new")
        summary[shape] = info
        order = list(sides)
        for _ in range(args.reps):
            for side in order + order[::-1]:
                fn = sides[side]
                turns.append({"shape": shape, "side": side,
                              "ms": smoke._ms(fn, 20),
                              "queued_ms": smoke._ms_run(fn, 20),
                              "host_us": host_us(fn)})
                print(json.dumps(turns[-1]), flush=True)

    M, S = 120, 1
    for tag, R, W, B, T in (("db", 2_787_889, 32, 16_384, 1024),
                            ("wide", 11_133, 2188, 1024, 70_000)):
        bits = torch.randint(-2**31, 2**31 - 1, (R, W), generator=g,
                             device=cuda, dtype=torch.int32)
        rows = torch.randint(0, R, (B, M, S), generator=g, device=cuda,
                             dtype=torch.int32)
        n = torch.randint(12, 23, (B,), generator=g, device=cuda)
        mask = torch.arange(M, device=cuda)[None, :] < n[:, None]
        b2t = torch.clamp(torch.arange(W * 32), max=T).to(torch.int32).numpy()
        perm, starts, ends = lib.target_segments(b2t, T)
        assert perm is None
        seg = [torch.from_numpy(x).to(cuda) for x in (starts, ends)]
        distinct = int(torch.unique(rows[mask]).numel())
        base = distinct * W * 4 + rows.numel() * 4 + mask.numel()
        info = {"B": B, "M": M, "S": S, "R": R, "W": W,
                "valid_hashes": int(mask.sum()), "distinct_rows": distinct}

        def bins(side):
            out = torch.empty((B, W * 32), dtype=torch.int32, device=cuda)
            call(side, "bins", bits, R, W, rows, B, M, S, mask, out)
            return out

        def bins_target(side):
            # the earlier caller always gave a scratch; this checkout's
            # gives none on the one-launch route
            out = torch.empty((B, T), dtype=torch.int32, device=cuda)
            scratch = (None if side != "old" and lib.bins_target_fused(W)
                       else torch.empty((B, W * 32), dtype=torch.int32,
                                        device=cuda))
            call(side, "bins_target", bits, R, W, rows, B, M, S, mask,
                 scratch, None, *seg, T, out)
            return out

        others = [d for d in dirs if d != "old"]
        ab(f"bins_{tag}",
           {"old": lambda: bins("old"),
            "new": lambda: lib.bulk_count_bins(bits, rows, mask),
            **{v: (lambda v=v: bins(v)) for v in others}},
           dict(info, bound_ms=(base + B * W * 128) / smoke.HBM_BYTES_PER_S
                * 1e3))
        ab(f"bins_target_{tag}",
           {"old": lambda: bins_target("old"),
            "new": lambda: lib.bulk_target_counts(bits, rows, mask, *seg),
            **{v: (lambda v=v: bins_target(v)) for v in others}},
           dict(info, T=T, fused=lib.bins_target_fused(W),
                bound_ms=(base + 8 * T + B * T * 4)
                / smoke.HBM_BYTES_PER_S * 1e3))
        del bits, rows, mask, seg
        torch.cuda.empty_cache()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for shape, info in summary.items():
        for side in ("new", *dirs):
            mine = [t for t in turns
                    if t["shape"] == shape and t["side"] == side]
            info[side] = {m: statistics.median(t[m] for t in mine)
                          for m in ("ms", "queued_ms", "host_us")}
    print(smi)
    print(json.dumps({"gpu": smi, "median": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
