#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py            # full size (needs one CUDA card)

Phases, one output line each:

1. env       the card (nvidia-smi name and power limit), torch, nvcc, and
             the time to build the five CUDA kernels from ``csrc/``;
2. build     1024 targets x 1 Mbp of random genomes (seeded): minimizers
             through the ``extract`` kernel, the IBF through ``scatter``,
             saved as ``db.ibf`` with a ``db.tax`` of 32 genera; then
             (line ``build_hierarchy``) the hierarchy's databases the same
             way: ``host.hibf``, a native forest of 256 targets of skewed
             lengths (64 each of 0.25, 0.5, 1 and 2 Mbp), and ``db_b.ibf``,
             512 targets x 1 Mbp whose first 64 are ``T0..T63`` of
             ``db.ibf`` (names and genomes), each with a ``.tax``;
3. kernels   the saved filters loaded and repacked, then each kernel (and
             kernel mode) against its plain torch version on the same CUDA
             tensors at main-path shapes (8192 pairs of 150 bp; count on
             ``db.ibf`` and, in forest mode, on the forest's last sub; merge
             and select with winners on the 1024 + 448 union of ``db`` and
             ``db_b``), required equal, both timed with CUDA events;
4. classify  524,288 read pairs through ``python -m ganon_tpu_torch.cli
             classify`` (run in this process, so the launch counts are
             readable; the filters loaded in phase 3 stay cached), then
             once more through ``run_classify`` under ``torch.profiler``
             for the engine's time split and the card's busy share;
hierarchy    524,288 pairs (25% from the forest's targets, 70% from the
             level-2 targets, 5% random) through the CLI with
             ``--db-prefix host db db_b --hierarchy-labels 1_host 2_refs
             2_refs``, then profiled the same way; every forest pair lists
             its true target in ``1_host.all`` and not in ``2_refs.all``,
             every level-2 pair its true target in ``2_refs.all``, random
             pairs land in ``.unc``, and on the first 4096 pairs the CUDA and
             ``device="cpu"`` runs write identical sorted per-level files,
             ``.rep`` and a byte-equal ``.sta``;
5. checks    every kernel mode launched on the main paths (builds + the two
             CLI runs), every flat pair lists its true target in ``.all``,
             and on its first 4096 pairs the CUDA and ``device="cpu"`` runs
             write identical sorted ``.all``, ``.one`` and ``.rep``.

Then one JSON line of every kernel mode, and last the device line. Any
failure raises (exit code 1); without CUDA the script exits 2 before any
work. If a run nears the time limit, shrink ``--pairs`` (the flat phase)
before the hierarchy.
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


def _write_tax(path, names, genus_of):
    """A .tax of root, the given genera and one species per target."""
    with open(path, "w") as f:
        f.write("1\t0\tno rank\troot\n")
        for g in sorted(set(genus_of)):
            f.write(f"{g}\t1\tgenus\t{g}\n")
        for name, g in zip(names, genus_of):
            f.write(f"{name}\t{g}\tspecies\t{name}\n")


def _hashes(named_genomes, k, w, device):
    """Per-target minimizers through the extract kernel (the build path)."""
    from ganon_tpu_torch.index.builder import _HashExtractor

    ex = _HashExtractor(k, w, device=device)
    for name, g in named_genomes:
        ex.add_encoded(name, g)
    return ex.finish()


def _true_target_rows(path):
    """{read id: set of listed targets} of a .all file."""
    rows = {}
    if os.path.exists(path):
        with open(path) as fh:
            for line in fh:
                rid, target, _ = line.split("\t")
                rows.setdefault(rid, set()).add(target)
    return rows


def _run_cli(argv):
    from ganon_tpu_torch.cli import main_cli

    saved, sys.argv = sys.argv, argv
    try:
        main_cli()
    except SystemExit as e:
        if e.code not in (0, None):
            raise RuntimeError(f"classify CLI exited {e.code}") from e
    finally:
        sys.argv = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--targets", type=int, default=1024)
    ap.add_argument("--genome-len", type=int, default=1_000_000)
    ap.add_argument("--pairs", type=int, default=524_288)
    ap.add_argument("--bench-pairs", type=int, default=8192)
    ap.add_argument("--check-pairs", type=int, default=4096)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--seed", type=int, default=43)
    # the hierarchy: a forest of 4 length classes (unit x 1, 2, 4, 8 bp),
    # per_class targets each, and db_b's target count
    ap.add_argument("--forest-per-class", type=int, default=64)
    ap.add_argument("--forest-unit", type=int, default=250_000)
    ap.add_argument("--b-targets", type=int, default=512)
    ap.add_argument("--hier-pairs", type=int, default=524_288)
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
    from ganon_tpu_torch.index import sizing
    from ganon_tpu_torch.index.hibf import build_hibf
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
    target_hashes = _hashes(zip(names, genomes), k, w, cuda)
    t_extract = time.perf_counter() - t0
    ibf = build_ibf(target_hashes, kmer_size=k, window_size=w, max_fp=0.05,
                    device=cuda)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = dict(kernels.LAUNCHES)
    db = os.path.join(work, "db")
    ibf.save(db + ".ibf")
    _write_tax(db + ".tax", names, [f"G{t % 32}" for t in range(args.targets)])
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

    # the hierarchy's databases: a native forest of skewed lengths and a
    # second flat filter overlapping db's first targets
    lengths = [args.forest_unit * m for m in (1, 2, 4, 8)]
    forest = [rng.integers(0, 4, size=(args.forest_per_class, n),
                           dtype=np.uint8) for n in lengths]
    forest_names = [[f"F{c}_{i}" for i in range(args.forest_per_class)]
                    for c in range(len(lengths))]
    flat_forest_names = [n for c in forest_names for n in c]
    n_shared = min(64, args.targets, args.b_targets)
    new_b = rng.integers(0, 4, size=(args.b_targets - n_shared,
                                     args.genome_len), dtype=np.uint8)
    b_names = names[:n_shared] + [f"U{i}" for i in
                                  range(n_shared, args.b_targets)]
    kernels.reset_launches()
    t0 = time.perf_counter()
    hibf = build_hibf(
        _hashes(((n, g) for c in range(len(lengths))
                 for n, g in zip(forest_names[c], forest[c])), k, w, cuda),
        kmer_size=k, window_size=w, max_fp=0.05, device=cuda,
    )
    torch.cuda.synchronize()
    forest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ibf_b = build_ibf(
        _hashes(zip(b_names, list(genomes[:n_shared]) + list(new_b)), k, w,
                cuda),
        kmer_size=k, window_size=w, max_fp=0.05, device=cuda,
    )
    torch.cuda.synchronize()
    db_b_s = time.perf_counter() - t0
    hier_build_launches = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    host, db_b = os.path.join(work, "host"), os.path.join(work, "db_b")
    hibf.save(host + ".hibf")
    ibf_b.save(db_b + ".ibf")
    save_s = time.perf_counter() - t0
    _write_tax(host + ".tax", flat_forest_names,
               [f"H{i % 8}" for i in range(len(flat_forest_names))])
    _write_tax(db_b + ".tax", b_names,
               [f"G{i % 32}" for i in range(args.b_targets)])
    print("phase=build_hierarchy " + json.dumps({
        "forest_build_s": forest_s, "db_b_build_s": db_b_s,
        "npz_save_s": save_s,
        "forest_targets": len(flat_forest_names),
        "forest_bp": int(sum(n * args.forest_per_class for n in lengths)),
        "forest_subs": len(hibf.subs),
        "forest_sub_targets": [len(x.targets()) for x in hibf.subs],
        "forest_sub_bin_size_bits": [x.ibf_config.bin_size_bits
                                     for x in hibf.subs],
        "db_b_targets": args.b_targets, "db_b_shared_with_db": n_shared,
        "launches": hier_build_launches,
    }), flush=True)
    if len(hibf.subs) < 2:
        raise AssertionError("the forest has one sub: K11 is not exercised")

    # 3. kernels vs plain at main-path shapes --------------------------------
    # the saved filters, loaded and repacked into the query layout once;
    # the CLI runs below find them in the process's filter cache
    load_s = {}
    for key, path in (("db", db + ".ibf"), ("host", host + ".hibf"),
                      ("db_b", db_b + ".ibf")):
        t0 = time.perf_counter()
        dev.load_device_filter(path, cuda)
        torch.cuda.synchronize()
        load_s[key] = time.perf_counter() - t0
    f = dev.load_device_filter(db + ".ibf", cuda)
    fh = dev.load_device_filter(host + ".hibf", cuda)
    fb = dev.load_device_filter(db_b + ".ibf", cuda)
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
    # forest mode: the forest's last sub into its columns (col0 > 0) of
    # the forest's [B, T] matrix, zeroed as DeviceHIBF.counts does
    sub, col0 = fh.subs[-1], int(fh.sub_cols[-1][0])
    sub_args = (sub.tbl8, sub.byte_starts, sub.byte_ends, hashes, n_hashes)
    sub_kw = dict(bin_size=sub.ibf_config.bin_size_bits,
                  hash_functions=sub.ibf_config.hash_functions, col0=col0)
    fout_k = torch.zeros((args.bench_pairs, fh.num_targets),
                         dtype=torch.int32, device=cuda)
    fout_p = torch.zeros_like(fout_k)
    compare(
        "count_forest", "ganon_tpu_torch/csrc/count.cu",
        "ganon_tpu/classify/device.py:432",
        lambda: (q.target_counts(*sub_args, out=fout_k.zero_(), **sub_kw),),
        lambda: (q.bulk_target_counts(*sub_args, out=fout_p.zero_(),
                                      **sub_kw),), 20, 3,
    )
    # the union step of the 2_refs level: db then db_b into 1024 + 448
    # columns (zeroing both [B, U] tensors, as the main path does)
    counts_b = fb.counts(hashes, n_hashes)
    U = f.num_targets + fb.num_targets - n_shared
    cols = [torch.arange(f.num_targets, dtype=torch.int32, device=cuda),
            torch.cat([torch.arange(n_shared, dtype=torch.int32),
                       torch.arange(f.num_targets, U, dtype=torch.int32)
                       ]).to(cuda)]
    uk = [torch.zeros((args.bench_pairs, U), dtype=torch.int32, device=cuda)
          for _ in range(4)]

    def union(fn, uc, uw):
        uc.zero_()
        uw.zero_()
        for fi, (c, cl) in enumerate(zip((counts, counts_b), cols)):
            fn(c, n_hashes, 0.75, 65535, cl, fi, uc, uw)
        return uc, uw

    ucounts, uwin = compare(
        "merge", "ganon_tpu_torch/csrc/merge.cu",
        "ganon_tpu/classify/device.py:542",
        lambda: union(dev.merge, uk[0], uk[1]),
        lambda: union(dev.merge_plain, uk[2], uk[3]), 20, 5,
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
    KU = min(32, U)
    usel = (ucounts, n_hashes, overflow, 0.0, 0.1, 65535)
    compare(
        "select_winners", "ganon_tpu_torch/csrc/select.cu",
        "ganon_tpu/classify/device.py:801",
        lambda: (dev.select(*usel, top_k=KU, emit_matches_t=False,
                            uwin=uwin),),
        lambda: (dev._pack_result(
            dev.threshold_topk(*usel[:2], *usel[3:], top_k=KU,
                               emit_matches_t=False, winners=uwin),
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
        "filter_load_s": load_s["db"],
        "filter_load_s_host_db_b": [load_s["host"], load_s["db_b"]],
        "table_bytes": int(f.tbl8.numel()),
        "forest_sub_col0": col0, "union_targets": U,
        "scatter_pairs": int(sh.numel()),
        "equal": [r["name"] for r in rows],
        "ms": {r["name"]: [r["ms"], r["plain_ms"]] for r in rows},
    }), flush=True)
    del f, fh, fb, sub, sub_args, bits_k, bits_p, counts, counts_b, hashes
    del fout_k, fout_p, uk, ucounts, uwin, sel_args, usel
    torch.cuda.empty_cache()

    # 4. classify through the CLI (main path, part 2) -------------------------
    tgt, r1, r2 = _sample_pairs(np.random.default_rng(args.seed + 1), genomes,
                                args.pairs, args.read_len)
    ids = [b"r%d|T%d" % (i, t) for i, t in enumerate(tgt.tolist())]
    fq1, fq2 = os.path.join(work, "r1.fq"), os.path.join(work, "r2.fq")
    _write_fastq(fq1, ids, r1)
    _write_fastq(fq2, ids, r2)
    out = os.path.join(work, "out")
    kernels.reset_launches()
    t0 = time.perf_counter()
    _run_cli(["ganon-tpu-torch", "classify", "--db-prefix", db,
              "--paired-reads", fq1, fq2, "--output-prefix", out,
              "--multiple-matches", "lca", "--output-one", "--output-all",
              "--output-unclassified", "--skip-report"])
    cli_s = time.perf_counter() - t0
    cli_launches = dict(kernels.LAUNCHES)
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
        "launches": cli_launches,
        "profiled_split_s": timing,
        "profiled_device_busy_share":
            busy_us / 1e6 / timing["total"] if busy_us else None,
        "profiled_device_us": kernel_us,
    }), flush=True)

    # hierarchy: forest level, then two flat filters on one level ----------
    hrng = np.random.default_rng(args.seed + 3)
    nh = args.hier_pairs
    n_forest, n_rand = nh // 4, nh // 20
    n_l2 = nh - n_forest - n_rand
    parts = []  # (true target names, r1, r2)
    for c, g in enumerate(forest):
        n_c = n_forest // 4 + (c < n_forest % 4)
        t_c, a, b = _sample_pairs(hrng, g, n_c, args.read_len)
        parts.append(([forest_names[c][t] for t in t_c], a, b))
    n_l2b = n_l2 * len(new_b) // (args.targets + len(new_b))
    for pool, pool_names, n_p in ((genomes, names, n_l2 - n_l2b),
                                  (new_b, b_names[n_shared:], n_l2b)):
        if n_p:
            t_p, a, b = _sample_pairs(hrng, pool, n_p, args.read_len)
            parts.append(([pool_names[t] for t in t_p], a, b))
    rand = hrng.integers(0, 4, size=(2, n_rand, args.read_len),
                         dtype=np.uint8)
    parts.append((["rnd"] * n_rand, rand[0], rand[1]))
    truth = [t for p in parts for t in p[0]]
    perm = hrng.permutation(nh)
    hr1 = np.concatenate([p[1] for p in parts])[perm]
    hr2 = np.concatenate([p[2] for p in parts])[perm]
    truth = [truth[j] for j in perm]
    hids = [b"h%d|%s" % (i, t.encode()) for i, t in enumerate(truth)]
    hq1, hq2 = os.path.join(work, "h1.fq"), os.path.join(work, "h2.fq")
    _write_fastq(hq1, hids, hr1)
    _write_fastq(hq2, hids, hr2)
    hout = os.path.join(work, "hout")
    labels = ["1_host", "2_refs", "2_refs"]
    kernels.reset_launches()
    t0 = time.perf_counter()
    _run_cli(["ganon-tpu-torch", "classify", "--db-prefix", host, db, db_b,
              "--hierarchy-labels", *labels, "--paired-reads", hq1, hq2,
              "--output-prefix", hout, "--multiple-matches", "lca",
              "--output-one", "--output-all", "--output-unclassified",
              "--output-stats", "--skip-report"])
    hier_s = time.perf_counter() - t0
    hier_launches = dict(kernels.LAUNCHES)
    hier_files = dict(ibf=[host + ".hibf", db + ".ibf", db_b + ".ibf"],
                      tax=[host + ".tax", db + ".tax", db_b + ".tax"],
                      hierarchy_labels=labels, rel_cutoff=[0.75],
                      rel_filter=[0.1], fpr_query=[1e-5], output_lca=True,
                      output_all=True, output_unclassified=True,
                      output_stats=True)
    with torch.profiler.profile(activities=acts) as prof:
        htiming = run_classify(ClassifyConfig(
            paired_reads=[hq1, hq2], output_prefix=os.path.join(work, "hprof"),
            **hier_files))["timing"]
    hbusy_us, hkernel_us = _device_busy(prof)
    # checks: forest pairs at level 1 only, level-2 pairs at level 2,
    # random pairs unclassified
    all1 = _true_target_rows(hout + ".1_host.all")
    all2 = _true_target_rows(hout + ".2_refs.all")
    with open(hout + ".unc") as fh_:
        unc = {line.strip() for line in fh_ if line.strip()}
    forest_set = set(flat_forest_names)
    bad = {"forest": 0, "forest_at_level_2": 0, "level_2": 0, "random": 0}
    for rid in hids:
        rid = rid.decode()
        t = rid.split("|")[1]
        if t in forest_set:
            bad["forest"] += t not in all1.get(rid, ())
            bad["forest_at_level_2"] += rid in all2
        elif t == "rnd":
            bad["random"] += rid not in unc
        else:
            bad["level_2"] += t not in all2.get(rid, ())
    if any(bad.values()):
        raise AssertionError(f"hierarchy pairs misplaced: {bad}")
    # the first pairs on the card and through the plain versions on the CPU
    nc = args.check_pairs
    hs1, hs2 = (os.path.join(work, f"hsub{m}.fq") for m in (1, 2))
    _write_fastq(hs1, hids[:nc], hr1[:nc])
    _write_fastq(hs2, hids[:nc], hr2[:nc])
    hsubs = {}
    for device in ("cuda", "cpu"):
        d = os.path.join(work, f"hsub_{device}")
        os.makedirs(d)
        run_classify(ClassifyConfig(paired_reads=[hs1, hs2], device=device,
                                    output_prefix=os.path.join(d, "o"),
                                    **hier_files))
        hsubs[device] = {
            fn: (open(os.path.join(d, fn), "rb").read() if fn.endswith(".sta")
                 else _sorted_rows(os.path.join(d, fn)))
            for fn in sorted(os.listdir(d))
        }
    if hsubs["cuda"] != hsubs["cpu"]:
        diff = [fn for fn in set(hsubs["cuda"]) | set(hsubs["cpu"])
                if hsubs["cuda"].get(fn) != hsubs["cpu"].get(fn)]
        raise AssertionError(f"hierarchy: cuda and cpu runs differ in {diff}")
    hmbp = nh * 2 * args.read_len / 1e6
    print("phase=hierarchy " + json.dumps({
        "pairs": nh, "forest_pairs": n_forest, "level_2_pairs": n_l2,
        "random_pairs": n_rand, "seconds": hier_s,
        "reads_per_s": nh / hier_s, "mbp_per_min": hmbp / (hier_s / 60),
        "classified_level_1": len(all1), "classified_level_2": len(all2),
        "unclassified": len(unc), "launches": hier_launches,
        "profiled_split_s": htiming,
        "profiled_device_busy_share":
            hbusy_us / 1e6 / htiming["total"] if hbusy_us else None,
        "profiled_device_us": hkernel_us,
        "cuda_equals_cpu_pairs": nc,
        "cuda_equals_cpu_files": sorted(hsubs["cuda"]),
    }), flush=True)

    # 5. checks ------------------------------------------------------------
    launches = {name: build_launches[name] + hier_build_launches[name]
                + cli_launches[name] + hier_launches[name]
                for name in kernels.LAUNCHES}
    missing = [name for name, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    found = {rid for rid, ts in _true_target_rows(out + ".all").items()
             if rid.split("|")[1] in ts}
    if len(found) != args.pairs:
        raise AssertionError(
            f"{args.pairs - len(found)} pairs lack their true target in .all")
    sub1, sub2 = (os.path.join(work, f"sub{m}.fq") for m in (1, 2))
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
