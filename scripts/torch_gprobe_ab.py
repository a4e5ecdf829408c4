#!/usr/bin/env python3
"""A/B of the gather probe (``csrc/gprobe.cu``, the port of
``scripts/pallas_gather_probe.py:28 pallas_count``): this checkout's
kernel against an earlier version's source, in one process on the card.

    mkdir -p chip_proof/old
    git show <rev>:ganon_tpu_torch/csrc/gprobe.cu > chip_proof/old/gprobe.cu
    python scripts/torch_gprobe_ab.py --old chip_proof/old [--reps 2]

The earlier ``gprobe.cu`` (a thread a probe, shared and global atomics)
is built with nvcc alone into ``build/`` and called through ctypes
behind a copy of its earlier wrapper (the shape checks,
``kernels.check_cuda``, a ``torch.zeros`` output, then
``kernels.launch``'s path: the device, the raw stream, the C call).
This checkout's kernel runs through its wrapper
(``ops.probe.gather_probe``). Inputs are made on the card from
``--seed``, the table as the probe's own (``ops.probe``: 131,072 rows of
32 random bytes, 4 MB):

* ``p_own``: 1,048,576 random rows (the Pallas probe's shape);
* ``one_group``: 1,048,576 rows, all with ``r & 15 == 5`` (the earlier
  kernel's atomics all on 8 words);
* ``p_16m``: 2^24 random rows;
* ``p_32`` and ``p_64k``: 32 and 65,536 random rows (a call's fixed
  cost: the launch, the first loads, the last block's sum).

Each shape runs old, new, new, old, per rep: ``ms`` (one call between
two CUDA events, median of 20),
``queued_ms`` (20 calls queued while the card sleeps, so they run back
to back, between two events: the card's time a call) and ``host_us``
(the host's time a call over 100 calls queued without a wait). Both
sides' outputs must equal the plain version's. Beside each shape its bound: the
distinct rows' 32 bytes, the row indices and the output once over 3.35
TB/s (the popcounts and adds, 16 a probe, take less at 67 T/s), and the
rows a second at ``queued_ms``. Then ``host_steps_us``: the host's time
a call of each step of the two wrappers alone (``host_us`` over 200
calls), so that the calls' difference can be read step by step. One
JSON line a turn, then the card's name and power limit and the medians
of each side. Needs one CUDA card.
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
# tbl, R, rows, N, out (the earlier C entry)
OLD_SIGNATURE = (_P, _L, _P, _L, _P)


def _smoke():
    """chip_smoke.py of this checkout, for its timing helpers."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _library(src: str) -> ctypes.CDLL:
    """Build one gprobe.cu into a library under ``build/`` and load it
    (its headers from its own directory)."""
    from ganon_tpu_torch import BUILD_DIR, kernels

    tag = hashlib.sha1()
    d = os.path.dirname(src)
    for name in sorted(os.listdir(d)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(d, name), "rb") as f:
                tag.update(name.encode() + b"\0" + f.read())
    so = os.path.join(BUILD_DIR, f"ab_gprobe_{tag.hexdigest()[:12]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-shared", "-o", so, src], check=True)
    return ctypes.CDLL(so)


def _host_steps(host_us, tbl, rows, call_old) -> dict:
    """The host's time a call of each step of the two wrappers alone,
    their kernels launched into preallocated buffers."""
    import torch

    from ganon_tpu_torch import kernels
    from ganon_tpu_torch.ops import probe

    dev = tbl.device
    sms = probe._sm_count(dev.index)
    parts = torch.empty((sms, 128), dtype=torch.int32, device=dev)
    status, _ = kernels.scan_status(dev, 0)
    out = torch.empty((1, 128), dtype=torch.int32, device=dev)
    n = rows.numel()

    def checks():
        probe._check(tbl, rows)
        kernels.check_cuda(tbl, rows)

    steps = {
        "checks": checks,
        "sm_count": lambda: probe._sm_count(dev.index),
        "empty_partials": lambda: torch.empty((sms, 128), dtype=torch.int32,
                                              device=dev),
        "scan_status": lambda: kernels.scan_status(dev, 0),
        "empty_out": lambda: torch.empty((1, 128), dtype=torch.int32,
                                         device=dev),
        "zeros_out": lambda: torch.zeros((1, 128), dtype=torch.int32,
                                         device=dev),
        "launch_new": lambda: kernels.launch(
            "gather_probe", tbl, tbl.shape[0], rows, n, parts, sms, status,
            out),
        "launch_old": lambda: call_old(tbl, probe.R, rows, n, out),
    }
    got = {name: host_us(fn, 200) for name, fn in steps.items()}
    print(json.dumps({"host_steps_us": got}), flush=True)
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True,
                    help="directory of the earlier gprobe.cu")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=18)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2

    from ganon_tpu_torch import kernels
    from ganon_tpu_torch.ops import probe

    smoke = _smoke()
    cuda = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=cuda).manual_seed(args.seed)
    old_fn = _library(os.path.join(args.old, "gprobe.cu")).ganon_gather_probe
    old_fn.argtypes = list(OLD_SIGNATURE) + [ctypes.c_void_p]
    old_fn.restype = ctypes.c_int

    def call_old(*a):
        """kernels.launch's path (device, raw stream, C call) to the
        earlier kernel's library."""
        err = kernels.library().ganon_set_device(cuda.index)
        if err != 0:
            raise RuntimeError(f"cudaSetDevice failed: error {err}")
        cargs = [x.data_ptr() if isinstance(x, torch.Tensor) else x
                 for x in a]
        err = old_fn(*cargs, torch._C._cuda_getCurrentRawStream(cuda.index))
        if err != 0:
            raise RuntimeError(f"old gather_probe: error {err}")

    def host_us(fn, n=100):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / n * 1e6

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    tbl = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, 256, size=(probe.R, probe.W8), dtype=np.uint8)).to(cuda)
    turns, summary = [], {}
    for shape, n, group in (("p_own", probe.NPROBE, None),
                            ("one_group", probe.NPROBE, 5),
                            ("p_16m", 1 << 24, None), ("p_32", 32, None),
                            ("p_64k", 1 << 16, None)):
        if group is None:
            rows = torch.randint(0, probe.R, (n,), generator=g, device=cuda,
                                 dtype=torch.int32)
        else:
            rows = torch.randint(0, probe.R // 16, (n,), generator=g,
                                 device=cuda, dtype=torch.int32) * 16 + group

        def old(rows=rows, n=n):
            """The earlier wrapper, as it was."""
            probe._check(tbl, rows)
            kernels.check_cuda(tbl, rows)
            out = torch.zeros((1, 128), dtype=torch.int32, device=cuda)
            if n:
                call_old(tbl, probe.R, rows, n, out)
            return out

        sides = {"old": old,
                 "new": lambda rows=rows: probe.gather_probe(tbl, rows)}
        want = probe.gather_probe_plain(tbl, rows)
        for side, fn in sides.items():
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{shape}: {side} differs from plain")
        distinct = int(torch.unique(rows).numel())
        summary[shape] = {
            "N": n, "group": group, "distinct_rows": distinct,
            "bound_ms": (distinct * probe.W8 + 4 * n + 512)
            / smoke.HBM_BYTES_PER_S * 1e3}
        order = list(sides)
        for _ in range(args.reps):
            for side in order + order[::-1]:
                fn = sides[side]
                turns.append({"shape": shape, "side": side,
                              "ms": smoke._ms(fn, 20),
                              "queued_ms": smoke._ms_run(fn, 20),
                              "host_us": host_us(fn)})
                print(json.dumps(turns[-1]), flush=True)
        if shape == "p_own":
            steps = _host_steps(host_us, tbl, rows, call_old)
        del rows
        torch.cuda.empty_cache()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for shape, info in summary.items():
        for side in ("new", "old"):
            mine = [t for t in turns
                    if t["shape"] == shape and t["side"] == side]
            info[side] = {m: statistics.median(t[m] for t in mine)
                          for m in ("ms", "queued_ms", "host_us")}
            info[side]["rows_per_s_card"] = info["N"] / (
                info[side]["queued_ms"] / 1e3)
    print(smi)
    print(json.dumps({"gpu": smi, "sms": sms, "median": summary,
                      "host_steps_us": steps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
