#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py            # full size (needs one CUDA card)

Phases, one output line each:

1. env      the card (nvidia-smi name and power limit), torch, nvcc, and
            the time to build the four CUDA kernels from ``csrc/``;
2. build    1024 targets x 1 Mbp of random genomes (seeded): minimizers
            through the ``extract`` kernel, the IBF through ``scatter``,
            saved as ``db.ibf`` with a ``db.tax`` of 32 genera;
3. kernels  the saved filter loaded and repacked, then each kernel
            against its plain torch version on the same CUDA tensors at
            main-path shapes (8192 pairs of 150 bp on that table), required
            equal, both timed with CUDA events;
4. classify 524,288 read pairs through ``python -m ganon_tpu_torch.cli
            classify`` (run in this process, so the launch counts are
            readable; the filter loaded in phase 3 stays cached), then
            once more through ``run_classify`` under ``torch.profiler``
            for the engine's time split and the card's busy share;
5. checks   every kernel launched on the main path (build + CLI run),
            every pair lists its true target in ``.all``, and on the
            first 4096 pairs the CUDA and ``device="cpu"`` runs write
            identical sorted ``.all``, ``.one`` and ``.rep``.

Then one JSON line per kernel, and last the device line. Any failure
raises (exit code 1); without CUDA the script exits 2 before any work.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time


def _ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events, warmed)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def _max_abs_err(a, b) -> int:
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {a.shape} vs {b.shape}")
    if not a.numel():
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def _write_fastq(path, ids, codes):
    """FASTQ of dna4 rows (bulk formatting: ids, bases and qualities)."""
    import numpy as np

    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = acgt[codes]
    qual = b"I" * codes.shape[1]
    with open(path, "wb") as f:
        for rid, s in zip(ids, seqs):
            f.write(b"@%s\n%s\n+\n%s\n" % (rid, s.tobytes(), qual))


def _sample_pairs(rng, genomes, n, read_len):
    """Pairs as bench.py samples them: mate 2 is a reverse complement."""
    import numpy as np

    n_targets, genome_len = genomes.shape
    tgt = rng.integers(0, n_targets, size=n)
    pos1 = rng.integers(0, genome_len - read_len, size=n)
    pos2 = rng.integers(0, genome_len - read_len, size=n)
    idx = np.arange(read_len)
    r1 = genomes[tgt[:, None], pos1[:, None] + idx]
    r2 = 3 - genomes[tgt[:, None], pos2[:, None] + idx][:, ::-1]
    return tgt, r1.astype(np.uint8), r2.astype(np.uint8)


def _device_busy(prof):
    """(union of device activity in us, {activity: total us}) from a
    torch.profiler run; (0, {}) when the trace holds no device events."""
    import re

    from torch.autograd import DeviceType

    spans, totals = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        name = e.name.replace("(anonymous namespace)::", "")
        name = re.split(r"[(<]", name.removeprefix("void "), maxsplit=1)[0]
        name = name.split("::")[-1].strip() or e.name[:40]
        totals[name] = totals.get(name, 0) + e.time_range.elapsed_us()
    busy, end = 0, None
    for s, t in sorted(spans):
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return busy, totals


def _sorted_rows(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return sorted(line for line in f if line.strip())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--targets", type=int, default=1024)
    ap.add_argument("--genome-len", type=int, default=1_000_000)
    ap.add_argument("--pairs", type=int, default=524_288)
    ap.add_argument("--bench-pairs", type=int, default=8192)
    ap.add_argument("--check-pairs", type=int, default=4096)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--seed", type=int, default=43)
    ap.add_argument("--workdir", default=os.path.join("build", "chip_smoke"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    import numpy as np

    from ganon_tpu_torch import kernels
    from ganon_tpu_torch.classify import device as dev
    from ganon_tpu_torch.classify.engine import ClassifyConfig, run_classify
    from ganon_tpu_torch.cli import main_cli
    from ganon_tpu_torch.index import sizing
    from ganon_tpu_torch.index.builder import _HashExtractor
    from ganon_tpu_torch.index.ibf import (
        SCATTER_CHUNK, _scatter_bits, build_ibf, scatter_hashes,
    )
    from ganon_tpu_torch.io.pipeline import EncodedBatch
    from ganon_tpu_torch.ops import ibf_query as q
    from ganon_tpu_torch.ops.minimizers import u64_to_torch

    cuda = torch.device("cuda")
    work = os.path.abspath(args.workdir)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    # 1. environment --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    t0 = time.perf_counter()
    so = kernels.build()
    kernels.library()
    build_s = time.perf_counter() - t0
    print("phase=env " + json.dumps({
        "gpu": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "torch": torch.__version__, "torch_cuda": torch.version.cuda,
        "nvcc": nvcc.stdout.strip().splitlines()[-1],
        "kernel_build_s": build_s, "library": os.path.basename(so),
    }), flush=True)

    # 2. build (main path, part 1) -------------------------------------------
    k, w = 19, 31
    rng = np.random.default_rng(args.seed)
    genomes = rng.integers(0, 4, size=(args.targets, args.genome_len),
                           dtype=np.uint8)
    names = [f"T{t}" for t in range(args.targets)]
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ex = _HashExtractor(k, w, device=cuda)
    for name, g in zip(names, genomes):
        ex.add_encoded(name, g)
    target_hashes = ex.finish()
    t_extract = time.perf_counter() - t0
    ibf = build_ibf(target_hashes, kmer_size=k, window_size=w, max_fp=0.05,
                    device=cuda)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = dict(kernels.LAUNCHES)
    db = os.path.join(work, "db")
    ibf.save(db + ".ibf")
    with open(db + ".tax", "w") as f:
        f.write("1\t0\tno rank\troot\n")
        for g in range(32):
            f.write(f"G{g}\t1\tgenus\tG{g}\n")
        for t, name in enumerate(names):
            f.write(f"{name}\tG{t % 32}\tspecies\t{name}\n")
    cfg = ibf.ibf_config
    bp = args.targets * args.genome_len
    print("phase=build " + json.dumps({
        "targets": args.targets, "bp": bp,
        "seconds": build_s, "extract_seconds": t_extract,
        "build_mbp_per_min": bp / 1e6 / (build_s / 60),
        "hashes": int(sum(len(h) for h in target_hashes.values())),
        "bin_size_bits": cfg.bin_size_bits, "hash_functions":
        cfg.hash_functions, "n_bins": cfg.n_bins,
        "bits_bytes": int(ibf.bits.nbytes),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": build_launches,
    }), flush=True)

    # 3. kernels vs plain at main-path shapes --------------------------------
    # the saved filter, loaded and repacked into the query layout once;
    # the CLI run below finds it in the process's filter cache
    t0 = time.perf_counter()
    f = dev.load_device_filter(db + ".ibf", cuda)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    tgt, r1, r2 = _sample_pairs(np.random.default_rng(args.seed + 2), genomes,
                                args.bench_pairs, args.read_len)
    lens = np.full(args.bench_pairs, args.read_len, np.int32)
    batch = EncodedBatch(prefix="", paired=True,
                         ids=[str(i) for i in range(args.bench_pairs)],
                         codes1=r1, len1=lens, codes2=r2, len2=lens)
    inbuf_np, L1, L2 = dev.pack_batch_direct(batch, args.bench_pairs)
    inbuf = torch.from_numpy(inbuf_np).to(cuda)
    mc = dev.compact_width(2 * (L1 - w + 1))
    rows = []

    def compare(name, source, replaces, run_kernel, run_plain, reps,
                plain_reps):
        got, want = run_kernel(), run_plain()
        torch.cuda.synchronize()
        errs = [_max_abs_err(a, b) for a, b in zip(got, want)]
        if any(errs) or not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: kernel != plain (max errors {errs})")
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": max(errs),
            "ms": _ms(run_kernel, reps), "plain_ms": _ms(run_plain, plain_reps),
        })
        return got

    hashes, n_hashes, overflow = compare(
        "extract", "ganon_tpu_torch/csrc/extract.cu",
        "ganon_tpu/ops/minimizers.py:245",
        lambda: q.extract(inbuf, L1=L1, L2=L2, k=k, w=w, mc=mc),
        lambda: q.extract_plain(inbuf, L1=L1, L2=L2, k=k, w=w, mc=mc), 20, 5,
    )
    bin_size, h = cfg.bin_size_bits, cfg.hash_functions
    (counts,) = compare(
        "count", "ganon_tpu_torch/csrc/count.cu",
        "ganon_tpu/ops/ibf_query.py:320",
        lambda: (q.target_counts(f.tbl8, f.byte_starts, f.byte_ends, hashes,
                                 n_hashes, bin_size=bin_size,
                                 hash_functions=h),),
        lambda: (q.bulk_target_counts(f.tbl8, f.byte_starts, f.byte_ends,
                                      hashes, n_hashes, bin_size=bin_size,
                                      hash_functions=h),), 20, 3,
    )
    K = min(32, f.num_targets)
    sel_args = (counts, n_hashes, overflow, 0.75, 0.1, 65535)
    compare(
        "select", "ganon_tpu_torch/csrc/select.cu",
        "ganon_tpu/classify/device.py:801",
        lambda: (dev.select(*sel_args, top_k=K, emit_matches_t=False),),
        lambda: (dev._pack_result(
            dev.threshold_topk(*sel_args[:2], *sel_args[3:], top_k=K,
                               emit_matches_t=False),
            n_hashes, overflow.to(torch.int32)),), 20, 5,
    )
    # one main-path scatter chunk: the build's first SCATTER_CHUNK pairs
    splits = sizing.split_target_bins(cfg, ibf.hashes_count)
    sh, sb, n = [], [], 0
    for binno, target, st, en in splits:
        part = target_hashes[target][st:en + 1]
        sh.append(part)
        sb.append(np.full(len(part), binno, np.int32))
        n += len(part)
        if n >= SCATTER_CHUNK:
            break
    sh = u64_to_torch(np.concatenate(sh)[:SCATTER_CHUNK]).to(cuda)
    sb = torch.from_numpy(np.concatenate(sb)[:SCATTER_CHUNK]).to(cuda)
    bits_k = torch.zeros(ibf.bits.shape, dtype=torch.int32, device=cuda)
    bits_p = torch.zeros_like(bits_k)

    def scatter_kernel():
        scatter_hashes(bits_k, sh, sb, bin_size=bin_size, hash_functions=h)
        return (bits_k,)

    def scatter_plain():
        _scatter_bits(bits_p, sh, sb, bin_size=bin_size, hash_functions=h)
        return (bits_p,)

    compare("scatter", "ganon_tpu_torch/csrc/scatter.cu",
            "ganon_tpu/index/ibf.py:231", scatter_kernel, scatter_plain, 10, 3)
    print("phase=kernels " + json.dumps({
        "pairs": args.bench_pairs, "L1": L1, "L2": L2, "mc": mc,
        "filter_load_s": load_s, "table_bytes": int(f.tbl8.numel()),
        "scatter_pairs": int(sh.numel()),
        "equal": [r["name"] for r in rows],
        "ms": {r["name"]: [r["ms"], r["plain_ms"]] for r in rows},
    }), flush=True)
    del f, bits_k, bits_p, counts, hashes
    torch.cuda.empty_cache()

    # 4. classify through the CLI (main path, part 2) -------------------------
    tgt, r1, r2 = _sample_pairs(np.random.default_rng(args.seed + 1), genomes,
                                args.pairs, args.read_len)
    ids = [b"r%d|T%d" % (i, t) for i, t in enumerate(tgt.tolist())]
    fq1, fq2 = os.path.join(work, "r1.fq"), os.path.join(work, "r2.fq")
    _write_fastq(fq1, ids, r1)
    _write_fastq(fq2, ids, r2)
    out = os.path.join(work, "out")
    argv = ["ganon-tpu-torch", "classify", "--db-prefix", db,
            "--paired-reads", fq1, fq2, "--output-prefix", out,
            "--multiple-matches", "lca", "--output-one", "--output-all",
            "--output-unclassified", "--skip-report"]
    kernels.reset_launches()
    saved, sys.argv = sys.argv, argv
    t0 = time.perf_counter()
    try:
        main_cli()
    except SystemExit as e:
        if e.code not in (0, None):
            raise RuntimeError(f"classify CLI exited {e.code}") from e
    finally:
        sys.argv = saved
    cli_s = time.perf_counter() - t0
    launches = {name: build_launches[name] + n
                for name, n in kernels.LAUNCHES.items()}
    mbp = args.pairs * 2 * args.read_len / 1e6
    # the same reads through run_classify under torch.profiler: the
    # engine's time split and the card's busy share of the wall clock
    prof_cfg = ClassifyConfig(
        ibf=[db + ".ibf"], tax=[db + ".tax"], paired_reads=[fq1, fq2],
        output_prefix=os.path.join(work, "prof"), rel_cutoff=[0.75],
        rel_filter=[0.1], fpr_query=[1e-5], output_lca=True, output_all=True,
        output_unclassified=True,
    )
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        timing = run_classify(prof_cfg)["timing"]
    busy_us, kernel_us = _device_busy(prof)
    print("phase=classify " + json.dumps({
        "pairs": args.pairs, "seconds": cli_s,
        "reads_per_s": args.pairs / cli_s,
        "mbp_per_min": mbp / (cli_s / 60),
        "filter": "packed table cached in-process (load: phase kernels)",
        "profiled_split_s": timing,
        "profiled_device_busy_share":
            busy_us / 1e6 / timing["total"] if busy_us else None,
        "profiled_device_us": kernel_us,
    }), flush=True)

    # 5. checks ------------------------------------------------------------
    missing = [name for name, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    found = set()
    with open(out + ".all") as fh:
        for line in fh:
            rid, target, _ = line.split("\t")
            if rid.split("|")[1] == target:
                found.add(rid)
    if len(found) != args.pairs:
        raise AssertionError(
            f"{args.pairs - len(found)} pairs lack their true target in .all")
    sub1, sub2 = (os.path.join(work, f"sub{m}.fq") for m in (1, 2))
    nc = args.check_pairs
    _write_fastq(sub1, ids[:nc], r1[:nc])
    _write_fastq(sub2, ids[:nc], r2[:nc])
    subs = {}
    for device in ("cuda", "cpu"):
        c = ClassifyConfig(
            ibf=[db + ".ibf"], tax=[db + ".tax"], paired_reads=[sub1, sub2],
            output_prefix=os.path.join(work, f"sub_{device}"),
            rel_cutoff=[0.75], rel_filter=[0.1], fpr_query=[1e-5],
            output_lca=True, output_all=True, device=device,
        )
        run_classify(c)
        subs[device] = {ext: _sorted_rows(c.output_prefix + ext)
                        for ext in (".all", ".one", ".rep")}
    for ext in (".all", ".one", ".rep"):
        if subs["cuda"][ext] != subs["cpu"][ext]:
            raise AssertionError(f"cuda and cpu runs differ in {ext}")
    print("phase=checks " + json.dumps({
        "launches": launches, "pairs_with_true_target": len(found),
        "cuda_equals_cpu_pairs": nc,
        "cuda_equals_cpu_lines": {e: len(v) for e, v in subs["cuda"].items()},
    }), flush=True)

    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}))
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
