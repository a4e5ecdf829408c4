#!/usr/bin/env python3
"""A/B of the ops library's per-target sums (``csrc/bins.cu``: ``tsum``,
K18c, with its plan ``tsum_plan``) and of ``probe_sort`` (``csrc/psort.cu``,
the ``sort_probes`` branch of K5): this checkout's kernels against an
earlier version's sources, in one process on the card.

    mkdir -p chip_proof/old
    for f in bins.cu psort.cu ibf_hash.cuh warp_bits.cuh sm_count.cuh; do
        git show <rev>:ganon_tpu_torch/csrc/$f > chip_proof/old/$f; done
    python scripts/torch_tsum_psort_ab.py --old chip_proof/old [--reps 2] \\
        [--variants chip_proof/a,chip_proof/b] [--only tsum|psort]

The earlier ``bins.cu`` and ``psort.cu`` are built with nvcc alone into
``build/`` and called through ctypes behind a copy of their earlier
caller: ``ganon_tsum(bc, B, TB, b2t, T, out)`` into a ``torch.zeros``
output (its shared-memory route wrote every cell anyway; past 12,288
targets it added into the zeros with global atomics), and
``ganon_probe_sort`` (the same C signature as now) into ``torch.empty``.
This checkout's kernels run through their wrappers
(``ops.library.target_counts``, which takes ``tsum_plan`` first past one
tile of targets, and ``ops.ibf_query.probe_sort``). ``--variants`` names
directories of other versions of this checkout's ``bins.cu`` and
``psort.cu`` (each with the headers they include), built the same way
and called with this checkout's C signatures, as the wrappers call them;
they are timed in the same turns and their outputs must equal the new
ones. Inputs are made on the card from ``--seed``:

* ``tsum_db``: 16,384 reads x 1024 bins -> 1024 targets (the ``ops``
  phase of ``chip_smoke.py``: db's one bin a target), counts 0-17 with
  40% zeros;
* ``tsum_wide``: 1024 reads x 70,016 bins -> 70,000 targets (the wide
  filter: ascending ids, 16 padding bins carrying T), the same counts;
* ``tsum_wide_shuffled``: the same with the map shuffled (the windows
  overlap: every tile reads the whole row);
* ``psort_flat``: 8192 reads x 56 slots (the flat classify batch's
  compaction width), n uniform in [0, 56], db's 2,787,889 rows;
* ``psort_4096``: 3 reads x 4096 slots (n = 4096, 3000, 0), the block
  route.

Each shape runs old, new, the variants, then the same backwards, per
rep: ``ms`` (one call between two CUDA events, median of 20),
``queued_ms`` (20 calls queued while the card sleeps, so they run back
to back, between two events: the card's time a call) and ``host_us``
(the host's time a call over 100 calls queued without a wait). Every
side's outputs must equal the new ones. Beside each shape its bound:
tsum's counts and map read once and its output written once, probe_sort's
hashes in and out and n, over 3.35 TB/s (the operations, an add a bin and
M log2 M compares a read, take less at 67 T/s). One JSON line a turn,
then the card's name and power limit and the medians of each side.
Needs one CUDA card.
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

_P, _I, _L, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint64
# hashes, B, M, n_hashes, bin_size, shift, out (both versions)
_PSORT = (_P, _L, _I, _P, _U, _I, _P)
SIGNATURES = {
    "old": {
        # bin_counts, B, TB, bin_to_target, T, out
        "tsum": (_P, _L, _L, _P, _I, _P),
        "probe_sort": _PSORT,
    },
    "new": {
        # bin_counts, B, TB, bin_to_target, T, TT, win, out
        "tsum": (_P, _L, _L, _P, _I, _I, _P, _P),
        # bin_to_target, TB, T, TT, win
        "tsum_plan": (_P, _L, _I, _I, _P),
        "probe_sort": _PSORT,
    },
}


def _smoke():
    """chip_smoke.py of this checkout, for its timing helpers."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _library(d: str) -> ctypes.CDLL:
    """Build a directory's bins.cu and psort.cu into one library under
    ``build/`` and load it (their headers from that directory)."""
    from ganon_tpu_torch import BUILD_DIR, kernels

    tag = hashlib.sha1()
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            tag.update(name.encode() + b"\0" + f.read())
    so = os.path.join(BUILD_DIR, f"ab_tsum_psort_{tag.hexdigest()[:12]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-shared",
                        "-o", so, os.path.join(d, "bins.cu"),
                        os.path.join(d, "psort.cu")], check=True)
    return ctypes.CDLL(so)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True,
                    help="directory of the earlier bins.cu and psort.cu")
    ap.add_argument("--variants", default="",
                    help="directories of other versions of this "
                    "checkout's bins.cu and psort.cu, comma-separated")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--only", choices=("tsum", "psort"), default=None)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2

    from ganon_tpu_torch import kernels
    from ganon_tpu_torch.ops import ibf_query as q
    from ganon_tpu_torch.ops import library as lib
    from ganon_tpu_torch.ops.ibf_query import clz64

    smoke = _smoke()
    cuda = torch.device("cuda")
    g = torch.Generator(device=cuda).manual_seed(args.seed)
    dirs = {"old": args.old}
    for d in filter(None, args.variants.split(",")):
        dirs[os.path.basename(os.path.normpath(d))] = d
    libs = {}
    for side, d in dirs.items():
        lib_ = _library(d)
        libs[side] = {}
        for name, sig in SIGNATURES["old" if side == "old" else "new"].items():
            fn = getattr(lib_, f"ganon_{name}")
            fn.argtypes = list(sig) + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            libs[side][name] = fn

    def call(side, name, *a):
        """kernels.launch's path (device, raw stream) to a kernel of
        another library."""
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

    others = [d for d in dirs if d != "old"]

    def bound_ms(nbytes):
        return nbytes / smoke.HBM_BYTES_PER_S * 1e3

    if args.only in (None, "tsum"):
        for shape, B, TB, T, shuffle in (
                ("tsum_db", 16_384, 1024, 1024, False),
                ("tsum_wide", 1024, 70_016, 70_000, False),
                ("tsum_wide_shuffled", 1024, 70_016, 70_000, True)):
            bc = torch.randint(0, 18, (B, TB), generator=g, device=cuda,
                               dtype=torch.int32)
            bc *= torch.rand((B, TB), generator=g, device=cuda) >= 0.4
            b2t = torch.clamp(torch.arange(TB, device=cuda), max=T)
            if shuffle:
                b2t = b2t[torch.randperm(TB, generator=g, device=cuda)]
            b2t = b2t.to(torch.int32).contiguous()
            tiles, width = lib.tsum_tiles(T)

            def old_tsum(bc=bc, b2t=b2t, B=B, TB=TB, T=T):
                out = torch.zeros((B, T), dtype=torch.int32, device=cuda)
                call("old", "tsum", bc, B, TB, b2t, T, out)
                return out

            def variant(v, bc=bc, b2t=b2t, B=B, TB=TB, T=T, tiles=tiles,
                        width=width):
                out = torch.empty((B, T), dtype=torch.int32, device=cuda)
                win = None
                if tiles > 1:
                    win = torch.empty((tiles, 2), dtype=torch.int32,
                                      device=cuda)
                    call(v, "tsum_plan", b2t, TB, T, width, win)
                call(v, "tsum", bc, B, TB, b2t, T, width, win, out)
                return out

            ab(shape,
               {"old": old_tsum,
                "new": lambda bc=bc, b2t=b2t, T=T: lib.target_counts(
                    bc, b2t, num_targets=T),
                **{v: (lambda v=v, f=variant: f(v)) for v in others}},
               {"B": B, "TB": TB, "T": T, "shuffled": shuffle,
                "tiles": tiles, "width": width,
                "bound_ms": bound_ms(4 * (B * TB + TB + B * T))})
            del bc, b2t
            torch.cuda.empty_cache()

    if args.only in (None, "psort"):
        bin_size = 2_787_889
        for shape, B, M in (("psort_flat", 8192, 56), ("psort_4096", 3, 4096)):
            h = torch.from_numpy(np.random.default_rng(args.seed + M).integers(
                -2**63, 2**63 - 1, size=(B, M), dtype=np.int64)).to(cuda)
            if M == 4096:
                n = torch.tensor([4096, 3000, 0], dtype=torch.int32,
                                 device=cuda)
            else:
                n = torch.randint(0, M + 1, (B,), generator=g, device=cuda,
                                  dtype=torch.int32)

            def side_sort(side, h=h, n=n, B=B, M=M):
                out = torch.empty_like(h)
                call(side, "probe_sort", h, B, M, n, bin_size,
                     clz64(bin_size), out)
                return out

            ab(shape,
               {"old": lambda f=side_sort: f("old"),
                "new": lambda h=h, n=n: q.probe_sort(h, n, bin_size=bin_size),
                **{v: (lambda v=v, f=side_sort: f(v)) for v in others}},
               {"B": B, "M": M, "bin_size": bin_size,
                "bound_ms": bound_ms(16 * B * M + 4 * B)})
            del h, n

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
