#!/usr/bin/env python3
"""A/B of the port's build sort and ragged match stream: this checkout
against another.

    python scripts/torch_sort_ab.py --other <dir> [--reps 2]

Each run is a process of its own that imports ``ganon_tpu_torch`` from
one checkout (its kernels built there) and times, with ``chip_smoke.py``'s
methods (a call between two CUDA events, median; a run of back-to-back
calls between one event pair; the card's activity under torch.profiler):

* ``sort_entries`` on entries shaped like ``chip_smoke.py``'s first
  pass-1 group (18,570,459 entries of 133 files, the keys in file order,
  values below 2^38 as k = 19 minimizers are), against ``torch.sort`` of
  ``key << 38 | value``, which it must equal;
* ``ragged`` at 8192 pairs, K 32, a cap of 16,384 (0-2 matches a read),
  against ``torch.cumsum`` of the valid flags; it must equal
  ``ragged_plain``.

The data is made on the card from ``--seed``. Runs go other, this, this,
other per rep; one JSON line a run, then the card's name and power limit
and the medians of each side. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ENTRIES, FILES, VALUE_BITS = 18_570_459, 133, 38
B, K, CAP, TARGETS = 8192, 32, 16_384, 1024


def _smoke():
    """chip_smoke.py of this checkout, for its timing helpers."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(root: str, seed: int) -> dict:
    sys.path.insert(0, root)
    import torch

    from ganon_tpu_torch.classify import device as dev
    from ganon_tpu_torch.ops import build_ops as bo

    smoke = _smoke()
    cuda = torch.device("cuda")
    g = torch.Generator(device=cuda).manual_seed(seed)
    key = torch.sort(torch.randint(0, FILES, (N_ENTRIES,), generator=g,
                                   device=cuda, dtype=torch.int32)).values
    val = torch.randint(0, 1 << VALUE_BITS, (N_ENTRIES,), generator=g,
                        device=cuda, dtype=torch.int64)
    kb = (FILES - 1).bit_length()
    comp = (key.to(torch.int64) << VALUE_BITS) | val
    sk, sv = bo.sort_entries(key, val, key_bits=kb)
    ref = torch.sort(comp).values
    if not (torch.equal(ref >> VALUE_BITS, sk.to(torch.int64))
            and torch.equal(ref & ((1 << VALUE_BITS) - 1), sv)):
        raise AssertionError(f"{root}: sort_entries differs from torch.sort")
    del sk, sv, ref

    def sort():
        return bo.sort_entries(key, val, key_bits=kb)

    def lib_sort():
        return torch.sort(comp)

    nm = torch.randint(0, 3, (B,), generator=g, device=cuda,
                       dtype=torch.int32)
    dense = torch.cat([
        torch.randint(-2**31, 2**31 - 1, (B * K,), generator=g, device=cuda,
                      dtype=torch.int32),
        nm,
        torch.randint(0, 0xFFFF, (B,), generator=g, device=cuda,
                      dtype=torch.int32),
        torch.randint(0, 0x3FFFF, (B,), generator=g, device=cuda,
                      dtype=torch.int32),
        torch.randint(0, 2, (B,), generator=g, device=cuda,
                      dtype=torch.int32),
        torch.randint(0, 1000, (TARGETS + 3,), generator=g, device=cuda,
                      dtype=torch.int32)])
    flags = (torch.arange(K, device=cuda)[None, :]
             < nm[:, None]).reshape(-1).to(torch.int32)
    if not torch.equal(dev.ragged(dense, B, K, CAP),
                       dev.ragged_plain(dense, B, K, CAP)):
        raise AssertionError(f"{root}: ragged differs from ragged_plain")

    def ragged():
        return dev.ragged(dense, B, K, CAP)

    def cumsum():
        return torch.cumsum(flags, 0)

    out = {"root": root}
    for name, fn, reps, runs in (("sort", sort, 10, 20),
                                 ("torch_sort", lib_sort, 10, 20),
                                 ("ragged", ragged, 20, 200),
                                 ("cumsum", cumsum, 20, 200)):
        out[f"{name}_ms"] = smoke._ms(fn, reps)
        out[f"{name}_run_ms"] = smoke._ms_run(fn, runs)
        out[f"{name}_profiled_ms"] = smoke._profiled_ms(fn, runs)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=19)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if args.worker:
        print(json.dumps(worker(args.worker, args.seed)), flush=True)
        return 0
    if not args.other:
        ap.error("--other is required")
    runs = []
    for _ in range(args.reps):
        for side in ("other", "this", "this", "other"):
            root = os.path.abspath(args.other) if side == "other" else ROOT
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", root,
                 "--seed", str(args.seed)],
                cwd=root, capture_output=True, text=True)
            if res.returncode:
                raise RuntimeError(f"{side}: exit {res.returncode}\n"
                                   f"{res.stderr[-3000:]}")
            runs.append({"side": side,
                         **json.loads(res.stdout.strip().splitlines()[-1])})
            print(json.dumps(runs[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    metrics = [k for k in runs[0] if k.endswith("_ms")]
    print(json.dumps({"gpu": smi, "median": {
        side: {m: statistics.median(r[m] for r in runs if r["side"] == side)
               for m in metrics}
        for side in ("other", "this")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
