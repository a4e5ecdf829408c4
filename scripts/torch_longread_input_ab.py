#!/usr/bin/env python3
"""A/B of the port's long-read input path: this checkout against another.

    python scripts/torch_longread_input_ab.py --other <dir> [--reps 2]

Builds a flat database on the card with this checkout's port (64 random
targets x 1 Mbp, seeded), writes ``chip_smoke.py``'s long-read mix
(49,152 reads of 500 bp to 16 kbp, 5% random, plus 64 ultra-long reads
of 600 kbp), then classifies it through ``python -m ganon_tpu_torch.cli
classify --multiple-matches lca --skip-report`` (no ``--longreads``, so
a checkout without the 32-bit layout runs it too: the ultra-long reads
are read and skipped) from ``--other`` and from this checkout in turns
(other, this, this, other per rep). Prints one JSON line per run (wall
seconds of the process, the engine's own seconds from its summary line)
and a last line with the card's name and power limit and the medians.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--targets", type=int, default=64)
    ap.add_argument("--genome-len", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=43)
    ap.add_argument("--workdir", default=os.path.join("build", "input_ab"))
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from ganon_tpu_torch.index.ibf import build_ibf

    work = os.path.abspath(args.workdir)
    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    genomes = rng.integers(0, 4, size=(args.targets, args.genome_len),
                           dtype=np.uint8)
    names = [f"T{t}" for t in range(args.targets)]
    db = os.path.join(work, "db")
    build_ibf(smoke._hashes(zip(names, genomes), 19, 31, "cuda"),
              kmer_size=19, window_size=31, max_fp=0.05,
              device="cuda").save(db + ".ibf")
    ids, seqs, _ = smoke._long_read_mix(np.random.default_rng(args.seed + 7),
                                        genomes, names, 49_152, 64, 600_000)
    fq = os.path.join(work, "long.fq")
    smoke._write_fastq_seqs(fq, ids, seqs)

    runs = []
    for rep in range(args.reps):
        for side in ("other", "this", "this", "other"):
            root = os.path.abspath(args.other) if side == "other" else ROOT
            out = os.path.join(work, f"{side}_{rep}_{len(runs)}")
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "ganon_tpu_torch.cli", "classify",
                 "--db-prefix", db, "--single-reads", fq,
                 "--output-prefix", out, "--multiple-matches", "lca",
                 "--skip-report", "--output-stats"],
                cwd=root, capture_output=True, text=True)
            wall = time.perf_counter() - t0
            if res.returncode:
                raise RuntimeError(f"{side}: exit {res.returncode}\n"
                                   f"{res.stderr[-2000:]}")
            engine = re.findall(r"processed \d+ sequences .* in ([0-9.]+)s",
                                res.stderr)
            with open(out + ".sta") as f:
                sta = f.read()
            runs.append({"side": side, "wall_s": wall,
                         "engine_s": float(engine[-1]), "sta": sta})
            print(json.dumps({k: v for k, v in runs[-1].items()
                              if k != "sta"}), flush=True)
    if len({r["sta"] for r in runs}) != 1:
        raise AssertionError("the two checkouts' .sta files differ")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"gpu": smi, "median_engine_s": {
        side: statistics.median(r["engine_s"] for r in runs
                                if r["side"] == side)
        for side in ("other", "this")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
