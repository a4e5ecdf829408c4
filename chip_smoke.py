#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py            # full size (needs one CUDA card)

Phases, one output line each:

1. env       the card (nvidia-smi name and power limit), torch, nvcc, and
             the time to build the CUDA kernels from ``csrc/`` (one nvcc
             per source, all started together);
2. build     1024 targets x 1 Mbp of random genomes (seeded): minimizers
             through the ``extract`` kernel, the IBF through ``scatter``,
             saved as ``db.ibf`` with a ``db.tax`` of 32 genera; then
             (line ``build_custom``) the same genomes as 1024 multi-line
             FASTA files through ``python -m ganon_tpu_torch.cli
             build-custom --input-file ... --taxonomy ncbi`` (an
             --input-file over 32 genera and their nodes.dmp/names.dmp),
             the two-pass device build: ``bc.ibf`` must equal ``db.ibf``
             and ``bc.tax`` exist; its StopClock phases, Mbp/min and peak
             card memory; ``extract`` on the build's pieces, ``pack``,
             ``sort``, ``dedup`` and ``scatter`` in ranked mode against
             their plain versions at one pass-1 group of that build (sort
             beside ``torch.sort``); a 64-target reference-format build of
             two files per target, one target over several bins, through
             ``run_build`` on the card and with ``device="cpu"``, byte-equal;
             then
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
raptor       the reference's own files: the flat database written as a
             cereal ``.ibf`` and read back through ``IBF.load`` (bits,
             config, hashes_count, bin_map equal); the forest's 256 targets
             (hashes kept from its build) written as raptor ``.hibf``
             archives, one in the shape of raptor's DP layout (IBF 0: the
             64 targets of 2 Mbp as user bins plus one merged bin per other
             class, the three classes its children; ``raptor.hibf``) and the
             forest's 2-level export (``rexport.hibf``); ``count`` in
             column-max mode (K12) against its plain version at 8192 pairs
             over the layout's four subs, and on a small layout with one
             user bin in two IBFs (both subs count it); 524,288 pairs (95%
             sampled, a quarter per class, 5% random) through the CLI with
             ``--db-prefix raptor``, profiled; every sampled pair lists its
             true target in ``.all``, random pairs land in ``.unc``, and on
             the first 4096 pairs both archives give the same sorted files
             and byte-equal ``.sta`` on the card and with ``device="cpu"``;
pruned       the merged-bin pruned forest at the JAX benchmark's T8192
             shape: 8192 targets x 20 kbp (group size 64), minimizers
             through ``extract``, the tables built by ``scatter`` in pruned
             mode (``build_pruned``'s default) and on the host, required
             byte-equal, saved raw as ``pruned.hibf`` with a ``.tax`` of 64
             genera (line ``pruned_build``); the same genomes as FASTA files
             through ``build-custom --filter-type hibf --filter-format
             tpu-raw --max-fp 0.05`` (``--hibf-layout auto`` picks pruned at
             8192 targets), byte-equal to ``pruned.hibf`` (line
             ``pruned_build_custom``); ``gate``, ``fine``, ``fine``
             probe-all, ``select`` in lanes mode and ``scatter`` in pruned
             mode (4M pairs) against their plain versions at 8192 pairs
             (line ``pruned_kernels``, rows of the kernels line); then
             1,048,576 pairs (95% sampled, 5% random) through the CLI,
             profiled again with the count of batches that took the exact
             probe-all path; every sampled pair lists its true target in
             ``.all``, random pairs land in ``.unc``, and the first 4096
             pairs at rel-cutoff 0.2 give the same sorted files and
             byte-equal ``.sta`` on the card (S = 2, and S = 1, which forces
             the probe-all path) and with ``device="cpu"``;
5. checks    every kernel mode launched on the main paths (builds, the
             two build-custom runs, the reference-format build, the four
             classify CLI runs and the raptor and pruned phases' card runs),
             every flat
             pair lists its true target in ``.all``, and on its first 4096
             pairs the CUDA and ``device="cpu"`` runs write identical sorted
             ``.all``, ``.one`` and ``.rep``.

Then one JSON line of every kernel mode (its time and its plain
version's, its bound at these inputs, the larger of bytes over 3.35 TB/s
and operations over 67 T/s, its launches on the main paths, and the
time of one PyTorch call computing the same function where there is one),
and last the device line. Any failure raises (exit code 1); without CUDA the script
exits 2 before any work. If a run nears the time limit, shrink ``--pairs``
(the flat phase) before the later phases.
"""

from __future__ import annotations

import argparse
import importlib.util
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


# the least time the card could take for a function's work: the
# larger of the bytes a function must move (each input read once, each
# output written once) over the H100 SXM's 3.35 TB/s and its operations
# over 67 T/s, the data sheet's rate outside the tensor cores (no kernel
# here uses them; their integer operations are counted at that rate)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def _bound(nbytes: float, ops: float):
    """(bound_ms, bound_by) of a function moving ``nbytes`` and doing
    ``ops`` operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _valid(hashes, n):
    """bool [B, M]: the slots the count kernels read (first min(n, M))."""
    import torch

    M = hashes.shape[1]
    return torch.arange(M, device=hashes.device)[None, :] < n[:, None]


def _distinct_rows(hashes, n, bin_size: int, h: int) -> int:
    """Distinct table rows the batch's valid hashes probe (h rows each):
    the rows a count or gate must gather at least once."""
    import torch

    from ganon_tpu_torch.ops.ibf_query import ibf_row_indices

    rows = ibf_row_indices(hashes[_valid(hashes, n)], bin_size=bin_size,
                           hash_functions=h)
    return int(torch.unique(rows).numel())


def _count_work(tbl8, hashes, n, bin_size: int, h: int, out_bytes: int):
    """(bytes, ops) of one count: its distinct rows of the table, the
    hashes and n in, ``out_bytes`` out; one operation per table byte
    gathered (AND or popcount)."""
    W8 = tbl8.shape[1]
    nvalid = int(_valid(hashes, n).sum())
    nbytes = (_distinct_rows(hashes, n, bin_size, h) * W8
              + _nbytes(hashes, n) + out_bytes)
    return nbytes, nvalid * h * W8


def _fine_work(fp, hashes, n, pairs_b, pairs_g):
    """(distinct fine-table rows, valid hashes) of the given (read, group)
    pairs: the rows the fine kernel must gather at least once."""
    import torch

    from ganon_tpu_torch.ops.ibf_query import ibf_row_dyn

    valid = _valid(hashes, n)[pairs_b]
    hv = hashes[pairs_b][valid]
    g = pairs_g[:, None].expand(valid.shape)[valid]
    size, shift = fp.grp_bin_size[g], fp.grp_shift[g].to(torch.int64)
    rows = torch.cat([ibf_row_dyn(hv, i, size, shift) + fp.grp_row_off[g]
                      for i in range(fp.fine_h)])
    return int(torch.unique(rows).numel()), int(hv.numel())


def _ranked_words(key, val, uniq, rank, params, n_words, *, bin_size,
                  hash_functions):
    """Distinct u32 words the ranked scatter sets: the words it must
    write at least once."""
    import torch

    from ganon_tpu_torch.ops.build_ops import _ranked_bins
    from ganon_tpu_torch.ops.ibf_query import ibf_row_indices

    u, bins = _ranked_bins(key, uniq, rank, params)
    rows = ibf_row_indices(val[u], bin_size=bin_size,
                           hash_functions=hash_functions)
    return int(torch.unique(rows * n_words + (bins >> 5)[:, None]).numel())


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
            raise RuntimeError(f"{argv[1]} CLI exited {e.code}") from e
    finally:
        sys.argv = saved


def _write_fasta(path, name, codes, width=80):
    """A one-sequence FASTA of dna4 codes, ``width`` bases a line."""
    import numpy as np

    s = np.frombuffer(b"ACGT", dtype=np.uint8)[codes]
    full = len(s) // width * width
    lines = np.concatenate([s[:full].reshape(-1, width),
                            np.full((full // width, 1), 10, np.uint8)], axis=1)
    with open(path, "wb") as f:
        f.write(b">%s\n" % name.encode())
        f.write(lines.tobytes())
        if full < len(s):
            f.write(s[full:].tobytes() + b"\n")


def _write_input(folder, named_genomes, nodes=None):
    """FASTA files of the genomes and a build-custom --input-file over
    them (``path, name[, node]``); returns the input file's path."""
    os.makedirs(folder, exist_ok=True)
    rows = []
    for i, (name, g) in enumerate(named_genomes):
        p = os.path.join(folder, f"{name}.fna")
        _write_fasta(p, name, g)
        rows.append("\t".join([p, name] + ([nodes[i]] if nodes else [])))
    path = os.path.join(folder, "input.tsv")
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return path


def _with_build_phases(fn):
    """Run ``fn()`` and return (its result, run_build's StopClock phases
    as {name: seconds}, the bases it read)."""
    from ganon_tpu_torch.index import builder

    seen = {}
    real = builder._finish_build

    def finish(cfg, ibf, stats, phases=None, mark=None):
        out = real(cfg, ibf, stats, phases, mark)
        seen.update(phases=dict(phases or []), bp=stats.length_bp)
        return out

    builder._finish_build = finish
    try:
        res = fn()
    finally:
        builder._finish_build = real
    return res, seen.get("phases", {}), seen.get("bp", 0)


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
    # the raptor archives over the forest's targets
    ap.add_argument("--raptor-pairs", type=int, default=524_288)
    # the pruned forest: the JAX benchmark's T8192 regime (bench.py:79)
    # and its soak size (bench.py:743-756)
    ap.add_argument("--pruned-targets", type=int, default=8192)
    ap.add_argument("--pruned-genome-len", type=int, default=20_000)
    ap.add_argument("--pruned-pairs", type=int, default=1_048_576)
    ap.add_argument("--workdir", default=os.path.join("build", "chip_smoke"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    import numpy as np

    from ganon_tpu_torch import kernels
    from ganon_tpu_torch.classify import device as dev
    from ganon_tpu_torch.classify import engine as eng
    from ganon_tpu_torch.classify.engine import ClassifyConfig, run_classify
    from ganon_tpu_torch.index import device_build as dbuild
    from ganon_tpu_torch.index import sizing
    from ganon_tpu_torch.index.builder import BuildConfig, run_build
    from ganon_tpu_torch.index.hibf import (
        PRUNED_AUTO_MIN_TARGETS, RaptorHIBF, build_hibf, export_raptor_hibf,
    )
    from ganon_tpu_torch.index.ibf import (
        IBF, SCATTER_CHUNK, _scatter_bits, build_ibf, scatter_hashes,
    )
    from ganon_tpu_torch.index.serialize import write_ibf
    from ganon_tpu_torch.index.pruned import (
        build_pruned, scatter_pruned, scatter_pruned_plain,
    )
    from ganon_tpu_torch.io.pipeline import EncodedBatch
    from ganon_tpu_torch.ops import build_ops as bo
    from ganon_tpu_torch.ops import ibf_query as q
    from ganon_tpu_torch.ops import pruned_query as pq
    from ganon_tpu_torch.ops.minimizers import u64_to_torch
    # the tests' layout writer, loaded by its path: a `tests` package
    # installed on the machine would shadow the repo's directory
    spec = importlib.util.spec_from_file_location(
        "raptor_layout", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "tests", "raptor_layout.py"))
    raptor_layout = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(raptor_layout)
    write_raptor_layout = raptor_layout.write_raptor_layout

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

    rows = []

    def compare(name, source, replaces, run_kernel, run_plain, reps,
                plain_reps, work, library=None):
        """Kernel against plain on the same card tensors (equal, or
        raise), both timed; ``work`` is the function's (bytes, ops) at
        these inputs, for the bound. ``library`` times the one PyTorch
        call that computes the same function, where there is one (else
        ``library_ms`` is null; PERF.md says why for each)."""
        got, want = run_kernel(), run_plain()
        torch.cuda.synchronize()
        errs = [_max_abs_err(a, b) for a, b in zip(got, want)]
        if any(errs) or not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: kernel != plain (max errors {errs})")
        bound_ms, bound_by = _bound(*work)
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": max(errs),
            "ms": _ms(run_kernel, reps), "plain_ms": _ms(run_plain, plain_reps),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": _ms(library, reps) if library else None,
        })
        return got

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

    # build_custom: the same genomes through the CLI's two-pass device
    # build (multi-line FASTA files, an --input-file over 32 genera and an
    # NCBI nodes.dmp/names.dmp of them) --------------------------------------
    bcin = os.path.join(work, "bc_in")
    t0 = time.perf_counter()
    bc_input = _write_input(bcin, zip(names, genomes),
                            [str(1000 + t % 32) for t in range(args.targets)])
    nodes_dmp, names_dmp = (os.path.join(bcin, n)
                            for n in ("nodes.dmp", "names.dmp"))
    with open(nodes_dmp, "w") as f_, open(names_dmp, "w") as g_:
        f_.write("1\t|\t1\t|\tno rank\t|\n")
        g_.write("1\t|\troot\t|\t\t|\tscientific name\t|\n")
        for j in range(32):
            f_.write(f"{1000 + j}\t|\t1\t|\tgenus\t|\n")
            g_.write(f"{1000 + j}\t|\tG{j}\t|\t\t|\tscientific name\t|\n")
    fasta_s = time.perf_counter() - t0
    bc = os.path.join(work, "bc")
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, bc_phases, bc_bp = _with_build_phases(lambda: _run_cli([
        "ganon-tpu-torch", "build-custom", "--input-file", bc_input,
        "--db-prefix", bc, "--taxonomy", "ncbi", "--taxonomy-files",
        nodes_dmp, names_dmp, "--skip-genome-size", "--threads", "8",
        "--verbose", "--max-fp", "0.05", "--hash-functions", "0",
        "--tpu-sizing", "auto"]))
    bc_s = time.perf_counter() - t0
    bc_launches = dict(kernels.LAUNCHES)
    bc_peak = torch.cuda.max_memory_allocated()
    got_ibf = IBF.load(bc + ".ibf")
    if not (np.array_equal(got_ibf.bits, ibf.bits)
            and got_ibf.ibf_config.to_dict() == cfg.to_dict()
            and got_ibf.hashes_count == ibf.hashes_count
            and got_ibf.bin_map == ibf.bin_map):
        raise AssertionError("build-custom: bc.ibf differs from db.ibf")
    if not os.path.getsize(bc + ".tax"):
        raise AssertionError("build-custom: no bc.tax")
    bc_missing = [x for x in ("extract_build", "pack", "sort", "dedup",
                              "scatter_ranked") if bc_launches[x] <= 0]
    if bc_missing:
        raise AssertionError(f"build-custom: not launched: {bc_missing}")
    del got_ibf

    # the build kernels against their plain versions at one pass-1 group
    # of this build: its first group's files (the group closes at the
    # first file boundary past GROUP_BASES bases)
    pipe = dbuild.DeviceBuildPipeline(k, w, device=cuda)
    try:
        m = 0
        while m < args.targets and pipe._open_bases < dbuild.GROUP_BASES:
            pipe.add_encoded((names[m], 0), genomes[m])
            m += 1
        group, arrays = pipe._close_open()
        L0 = group.batches[0][0]
        t_in = torch.from_numpy(arrays[0]).to(cuda)
        nb0 = L0 // 4 + 4
        ein = t_in[:, :nb0].contiguous()
        ekeys = t_in[:, nb0:].contiguous().view(torch.int32).reshape(-1)
        B0, emc = ein.shape[0], L0 - w + 1
        # the emitted hashes: the build reads the first n[b] of each row
        npk = int(q.extract_plain(ein, L1=L0, L2=0, k=k, w=w,
                                  mc=emc)[1].sum())
        eh, en, _ = compare(
            "extract_build", "ganon_tpu_torch/csrc/extract.cu",
            "ganon_tpu/index/builder.py:156",
            lambda: q.extract(ein, L1=L0, L2=0, k=k, w=w, mc=emc,
                              counter="extract_build"),
            lambda: q.extract_plain(ein, L1=L0, L2=0, k=k, w=w, mc=emc), 10, 2,
            # pieces in; n and the emitted hashes out; ~8 operations per
            # base
            (_nbytes(ein) + 4 * B0 + 8 * npk, 8 * B0 * L0),
        )
        compare("pack", "ganon_tpu_torch/csrc/sort.cu",
                "ganon_tpu/index/device_build.py:137",
                lambda: bo.pack_entries(eh, en, ekeys, npk),
                lambda: bo.pack_entries_plain(eh, en, ekeys, npk), 20, 5,
                # n and keys in, each emitted hash read once; entries out
                (_nbytes(en, ekeys) + npk * (8 + 12), npk))
        del eh, en, t_in, ein
        gkey, gval = pipe._entries(group, arrays)
        N = group.n
        kb = group.key_bits
        # the library yardstick: torch.sort of (key << 38 | value), one
        # key per entry, since k = 19 values are below 2^38
        comp = (gkey.to(torch.int64) << 38) | gval
        sk, sv = compare(
            "sort", "ganon_tpu_torch/csrc/sort.cu",
            "ganon_tpu/ops/bigsort.py:31",
            lambda: bo.sort_entries(gkey, gval, key_bits=kb),
            lambda: bo.sort_entries_plain(gkey, gval, key_bits=kb), 10, 3,
            # entries read and written once; a digit per entry per pass
            (24 * N, (8 + -(-kb // 8)) * N),
            library=lambda: torch.sort(comp),
        )
        lib_sorted = torch.sort(comp).values
        if not (torch.equal(lib_sorted >> 38, sk.to(torch.int64))
                and torch.equal(lib_sorted & ((1 << 38) - 1), sv)):
            raise AssertionError("sort: torch.sort of the composite differs")
        del gkey, gval, comp, lib_sorted
        R0 = len(group.files)
        cnt = [torch.zeros(R0, dtype=torch.int32, device=cuda)
               for _ in range(2)]

        def dedup_run(fn, c):
            c.zero_()
            u_, r_ = fn(sk, sv, num_files=R0, counts=c)
            return u_, r_, c

        uq, rk, gcounts = compare(
            "dedup", "ganon_tpu_torch/csrc/dedup.cu",
            "ganon_tpu/index/device_build.py:169",
            lambda: dedup_run(bo.dedup, cnt[0]),
            lambda: dedup_run(bo.dedup_plain, cnt[1]), 20, 5,
            # entries in; flags, ranks and counts out
            (12 * N + 8 * N + 4 * R0, 2 * N))
        counts_np = gcounts.cpu().numpy()
        if [int(c) for c in counts_np] != [ibf.hashes_count[rec.key[0]]
                                            for rec in group.files]:
            raise AssertionError("dedup: group counts differ from db.ibf's")
        split = dbuild.target_bins(
            sizing.split_target_bins(cfg, ibf.hashes_count))
        params = np.zeros((4, R0), dtype=np.int32)
        for i, rec in enumerate(group.files):
            params[:, i] = (*split[rec.key[0]], 0, int(counts_np[:i].sum()))
        params_t = torch.from_numpy(params).to(cuda)
        rbits = [torch.zeros(ibf.bits.shape, dtype=torch.int32, device=cuda)
                 for _ in range(2)]
        rk_args = (sk, sv, uq, rk, params_t)
        rk_kw = dict(bin_size=cfg.bin_size_bits,
                     hash_functions=cfg.hash_functions)
        compare("scatter_ranked", "ganon_tpu_torch/csrc/scatter.cu",
                "ganon_tpu/index/device_build.py:185",
                lambda: (bo.scatter_ranked(rbits[0], *rk_args, **rk_kw),
                         rbits[0])[1:],
                lambda: (bo.scatter_ranked_plain(rbits[1], *rk_args,
                                                 **rk_kw), rbits[1])[1:],
                10, 3,
                # entries, flags, ranks and params in; each distinct word
                # set, out; h bits per distinct entry
                (_nbytes(*rk_args) + 4 * _ranked_words(
                    sk, sv, uq, rk, params_t, rbits[0].shape[1], **rk_kw),
                 int(uq.sum()) * cfg.hash_functions))
        del sk, sv, uq, rk, rbits, cnt, gcounts, rk_args, arrays
    finally:
        pipe.close()
    torch.cuda.empty_cache()

    # the reference format on the card and with device="cpu": 64 targets
    # of two files each, one 15x the others (split over several bins)
    ref_ti = os.path.join(work, "ref_in", "target_info.tsv")
    refrng = np.random.default_rng(args.seed + 9)
    os.makedirs(os.path.dirname(ref_ti))
    with open(ref_ti, "w") as f_:
        for t in range(64):
            for fi in range(2):
                p_ = os.path.join(work, "ref_in", f"R{t}_{fi}.fna")
                _write_fasta(p_, f"R{t}_{fi}", refrng.integers(
                    0, 4, size=300_000 if t == 0 else 20_000, dtype=np.uint8))
                f_.write(f"{p_}\tR{t}\n")
    ref_bytes, ref_s = {}, {}
    for d_ in ("cuda", "cpu"):
        kernels.reset_launches()
        out_ = os.path.join(work, f"ref_{d_}.ibf")
        t0 = time.perf_counter()
        ref_ibf = run_build(BuildConfig(input_file=ref_ti, output_file=out_,
                                        filter_format="reference", device=d_))
        ref_s[d_] = time.perf_counter() - t0
        if d_ == "cuda":
            ref_launches = dict(kernels.LAUNCHES)
        with open(out_, "rb") as f_:
            ref_bytes[d_] = f_.read()
    if ref_bytes["cuda"] != ref_bytes["cpu"]:
        raise AssertionError("reference format: cuda and cpu files differ")
    if len(ref_ibf.bin_map) <= len(ref_ibf.hashes_count):
        raise AssertionError("reference format: no target over several bins")
    shutil.rmtree(bcin, ignore_errors=True)
    print("phase=build_custom " + json.dumps({
        "targets": args.targets, "bp": bc_bp, "fasta_write_s": fasta_s,
        "seconds": bc_s, "mbp_per_min": bc_bp / 1e6 / (bc_s / 60),
        "stopclock_s": bc_phases,
        "max_memory_allocated": bc_peak,
        "equals_db_ibf": True, "launches": bc_launches,
        "group": {"files": R0, "entries": N, "pieces_first_launch": B0,
                  "piece_len": L0},
        "reference_format": {"bytes": len(ref_bytes["cuda"]),
                             "bins": len(ref_ibf.bin_map),
                             "targets": len(ref_ibf.hashes_count),
                             "seconds": ref_s, "cuda_equals_cpu": True,
                             "launches": ref_launches},
        "ms": {r["name"]: [r["ms"], r["plain_ms"]] for r in rows},
    }), flush=True)
    del ref_bytes, ref_ibf

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
    # the forest's hashes stay for the raptor phase's archives
    forest_hashes = _hashes(((n, g) for c in range(len(lengths))
                             for n, g in zip(forest_names[c], forest[c])),
                            k, w, cuda)
    hibf = build_hibf(forest_hashes, kmer_size=k, window_size=w, max_fp=0.05,
                      device=cuda)
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
    hashes, n_hashes, overflow = compare(
        "extract", "ganon_tpu_torch/csrc/extract.cu",
        "ganon_tpu/ops/minimizers.py:245",
        lambda: q.extract(inbuf, L1=L1, L2=L2, k=k, w=w, mc=mc),
        lambda: q.extract_plain(inbuf, L1=L1, L2=L2, k=k, w=w, mc=mc), 20, 5,
        # inbuf in; hashes, n, overflow out; ~8 integer operations per base
        (_nbytes(inbuf) + args.bench_pairs * (mc * 8 + 5),
         8 * args.bench_pairs * (L1 + L2)),
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
        _count_work(f.tbl8, hashes, n_hashes, bin_size, h,
                    args.bench_pairs * f.num_targets * 4),
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
        _count_work(sub.tbl8, hashes, n_hashes, sub_kw["bin_size"],
                    sub_kw["hash_functions"],
                    args.bench_pairs * sub.num_targets * 4),
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
        # both filters' counts, n and cols in; union counts and winners out
        (_nbytes(counts, counts_b, n_hashes, *cols)
         + 2 * args.bench_pairs * U * 4,
         4 * args.bench_pairs * (counts.shape[1] + counts_b.shape[1])),
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
        # counts, n, overflow in; the packed buffer out; ~4 operations per
        # count (cutoff, rel-filter, top-K key, tallies)
        (_nbytes(counts, n_hashes, overflow)
         + 4 * (args.bench_pairs * (K + 4) + f.num_targets + 3),
         4 * counts.numel()),
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
        (_nbytes(ucounts, uwin, n_hashes, overflow)
         + 4 * (args.bench_pairs * (2 * KU + 4) + U + 3),
         4 * ucounts.numel()),
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

    # the (hash, bin) pairs in; each distinct u32 word the pairs set, out
    srows = q.ibf_row_indices(sh, bin_size=bin_size, hash_functions=h)
    swords = torch.unique(srows * bits_k.shape[1] + (sb // 32)[:, None].to(
        torch.int64)).numel()
    compare("scatter", "ganon_tpu_torch/csrc/scatter.cu",
            "ganon_tpu/index/ibf.py:231", scatter_kernel, scatter_plain, 10, 3,
            (_nbytes(sh, sb) + swords * 4, srows.numel()))
    del srows
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

    # raptor: the reference's own files over the forest's 256 targets -------
    # the cereal check: the flat database as `ganon build --filter-type ibf`
    # writes it, read back through IBF.load's sniffing
    t0 = time.perf_counter()
    cereal = os.path.join(work, "cereal.ibf")
    write_ibf(ibf, cereal)
    back = IBF.load(cereal)
    if not (np.array_equal(back.bits, ibf.bits)
            and back.ibf_config == ibf.ibf_config
            and back.hashes_count == ibf.hashes_count
            and back.bin_map == ibf.bin_map):
        raise AssertionError("cereal .ibf: read back differs from the filter")
    cereal_s = time.perf_counter() - t0
    cereal_bytes = os.path.getsize(cereal)
    os.remove(cereal)
    del back
    # two archives: the shape of raptor's DP layout (IBF 0 holds the 64
    # largest targets as user bins and one merged bin per other class,
    # each class a child IBF), and the forest's 2-level export
    rdb, edb = os.path.join(work, "raptor"), os.path.join(work, "rexport")
    layout = [(forest_names[3], [1, 2, 3]), (forest_names[0], []),
              (forest_names[1], []), (forest_names[2], [])]
    kernels.reset_launches()
    t0 = time.perf_counter()
    write_raptor_layout(forest_hashes, layout, rdb + ".hibf", kmer_size=k,
                        window_size=w, max_fp=0.05, device=cuda)
    layout_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    export_raptor_hibf(hibf, forest_hashes, edb + ".hibf", device=cuda)
    export_s = time.perf_counter() - t0
    rbuild_launches = dict(kernels.LAUNCHES)
    rload_s = {}
    for p_ in (rdb, edb):
        _write_tax(p_ + ".tax", flat_forest_names,
                   [f"H{i % 8}" for i in range(len(flat_forest_names))])
        t0 = time.perf_counter()
        dev.load_device_filter(p_ + ".hibf", cuda)
        torch.cuda.synchronize()
        rload_s[os.path.basename(p_)] = time.perf_counter() - t0
    fr = dev.load_device_filter(rdb + ".hibf", cuda)
    if not isinstance(fr, dev.DeviceRaptorHIBF) or len(fr.subs) != 4:
        raise AssertionError("raptor: the layout did not open as 4 subs")
    # K12 against its plain version: 8192 pairs over the four classes,
    # every sub max-merged into one zeroed [B, 256] matrix
    brng = np.random.default_rng(args.seed + 7)
    bparts = [_sample_pairs(brng, g, args.bench_pairs // 4
                            + (c < args.bench_pairs % 4), args.read_len)
              for c, g in enumerate(forest)]
    rbatch = EncodedBatch(
        prefix="", paired=True, ids=[str(i) for i in range(args.bench_pairs)],
        codes1=np.concatenate([x[1] for x in bparts]), len1=lens,
        codes2=np.concatenate([x[2] for x in bparts]), len2=lens)
    rin_np, rL1, rL2 = dev.pack_batch_direct(rbatch, args.bench_pairs)
    rh, rn, _ = dev._extract_compact(torch.from_numpy(rin_np).to(cuda), k=k,
                                     w=w, L1=rL1, L2=rL2)
    rout_k = torch.zeros((args.bench_pairs, fr.num_targets),
                         dtype=torch.int32, device=cuda)
    rout_p = torch.zeros_like(rout_k)

    def raptor_counts(fn, out, subs):
        out.zero_()
        for sub_ in subs:
            fn(sub_.tbl8, sub_.byte_starts, sub_.byte_ends, rh, rn,
               bin_size=sub_.bin_size, hash_functions=sub_.hash_funs,
               out=out, cols=sub_.cols)
        return (out,)

    # each sub gathers its own distinct rows; the hashes, n and the
    # [B, T] output are shared by the four launches and counted once
    rvalid = int(_valid(rh, rn).sum())
    compare(
        "count_raptor", "ganon_tpu_torch/csrc/count.cu",
        "ganon_tpu/classify/device.py:488",
        lambda: raptor_counts(q.target_counts, rout_k, fr.subs),
        lambda: raptor_counts(q.bulk_target_counts, rout_p, fr.subs), 20, 3,
        (sum(_distinct_rows(rh, rn, s_.bin_size, s_.hash_funs)
             * s_.tbl8.shape[1] for s_ in fr.subs)
         + _nbytes(rh, rn, rout_k),
         sum(rvalid * s_.hash_funs * s_.tbl8.shape[1] for s_ in fr.subs)),
    )
    # a small layout where one user bin sits in two IBFs, so the max
    # really combines two subs' values
    twin = forest_names[0][0]
    tdb = os.path.join(work, "twin.hibf")
    write_raptor_layout(
        forest_hashes, [(forest_names[3][:4] + [twin], [1]),
                        (forest_names[0][:4], [])],
        tdb, kmer_size=k, window_size=w, max_fp=0.05, device=cuda)
    ft = dev.DeviceRaptorHIBF(RaptorHIBF.load(tdb), cuda)
    tcol = ft.targets.index(twin)
    tk, tp = (torch.zeros((args.bench_pairs, ft.num_targets),
                          dtype=torch.int32, device=cuda) for _ in range(2))
    raptor_counts(q.target_counts, tk, ft.subs)
    raptor_counts(q.bulk_target_counts, tp, ft.subs)
    per_sub = [q.bulk_target_counts(
        s_.tbl8, s_.byte_starts, s_.byte_ends, rh, rn, bin_size=s_.bin_size,
        hash_functions=s_.hash_funs)[:, s_.cols.tolist().index(tcol)]
        for s_ in ft.subs]
    both = int(((per_sub[0] > 0) & (per_sub[1] > 0)).sum())
    if not torch.equal(tk, tp) or not both:
        raise AssertionError(f"raptor twin layout: kernel == plain "
                             f"{torch.equal(tk, tp)}, reads in both subs "
                             f"{both}")
    del ft, tk, tp, per_sub, rout_k, rout_p, rh, rn
    # 95% of the pairs from the 256 targets (a quarter per class), 5%
    # random, through the CLI; then profiled
    nr = args.raptor_pairs
    n_rrand = nr // 20
    rrng = np.random.default_rng(args.seed + 8)
    rparts = []
    for c, g in enumerate(forest):
        n_c = (nr - n_rrand) // 4 + (c < (nr - n_rrand) % 4)
        t_c, a, b = _sample_pairs(rrng, g, n_c, args.read_len)
        rparts.append(([forest_names[c][t] for t in t_c], a, b))
    rrand = rrng.integers(0, 4, size=(2, n_rrand, args.read_len),
                          dtype=np.uint8)
    rparts.append((["rnd"] * n_rrand, rrand[0], rrand[1]))
    rtruth = [t for p_ in rparts for t in p_[0]]
    perm = rrng.permutation(nr)
    rr1 = np.concatenate([p_[1] for p_ in rparts])[perm]
    rr2 = np.concatenate([p_[2] for p_ in rparts])[perm]
    rids = [b"x%d|%s" % (i, rtruth[j].encode()) for i, j in enumerate(perm)]
    rq1, rq2 = os.path.join(work, "x1.fq"), os.path.join(work, "x2.fq")
    _write_fastq(rq1, rids, rr1)
    _write_fastq(rq2, rids, rr2)
    rout = os.path.join(work, "xout")
    kernels.reset_launches()
    t0 = time.perf_counter()
    _run_cli(["ganon-tpu-torch", "classify", "--db-prefix", rdb,
              "--paired-reads", rq1, rq2, "--output-prefix", rout,
              "--multiple-matches", "lca", "--output-one", "--output-all",
              "--output-unclassified", "--skip-report"])
    r_cli_s = time.perf_counter() - t0
    r_cli_launches = dict(kernels.LAUNCHES)
    rfiles = dict(ibf=[rdb + ".hibf"], tax=[rdb + ".tax"], rel_cutoff=[0.75],
                  rel_filter=[0.1], fpr_query=[1e-5], output_lca=True,
                  output_all=True, output_unclassified=True)
    with torch.profiler.profile(activities=acts) as prof:
        rtiming = run_classify(ClassifyConfig(
            paired_reads=[rq1, rq2], output_prefix=os.path.join(work, "xprof"),
            **rfiles))["timing"]
    rbusy_us, rkernel_us = _device_busy(prof)
    rall = _true_target_rows(rout + ".all")
    with open(rout + ".unc") as fh_:
        runc = {line.strip() for line in fh_ if line.strip()}
    rbad = {"sampled": 0, "random": 0}
    for rid in rids:
        rid = rid.decode()
        t = rid.split("|")[1]
        if t == "rnd":
            rbad["random"] += rid not in runc
        else:
            rbad["sampled"] += t not in rall.get(rid, ())
    if any(rbad.values()):
        raise AssertionError(f"raptor pairs misplaced: {rbad}")
    # the first pairs on the card and through the plain versions on the
    # CPU, for both archives
    nc = args.check_pairs
    rs1, rs2 = (os.path.join(work, f"xsub{m}.fq") for m in (1, 2))
    _write_fastq(rs1, rids[:nc], rr1[:nc])
    _write_fastq(rs2, rids[:nc], rr2[:nc])
    req_launches = {}
    for p_ in (rdb, edb):
        rsubs = {}
        for device in ("cuda", "cpu"):
            d = os.path.join(work, f"xsub_{os.path.basename(p_)}_{device}")
            os.makedirs(d)
            kernels.reset_launches()
            run_classify(ClassifyConfig(**{
                **rfiles, "ibf": [p_ + ".hibf"], "tax": [p_ + ".tax"],
                "paired_reads": [rs1, rs2], "output_stats": True,
                "device": device, "output_prefix": os.path.join(d, "o")}))
            if device == "cuda":
                req_launches[os.path.basename(p_)] = dict(kernels.LAUNCHES)
            rsubs[device] = {
                fn: (open(os.path.join(d, fn), "rb").read()
                     if fn.endswith(".sta")
                     else _sorted_rows(os.path.join(d, fn)))
                for fn in sorted(os.listdir(d))}
        if rsubs["cuda"] != rsubs["cpu"]:
            diff = [fn for fn in set(rsubs["cuda"]) | set(rsubs["cpu"])
                    if rsubs["cuda"].get(fn) != rsubs["cpu"].get(fn)]
            raise AssertionError(f"raptor {p_}: cuda and cpu runs differ in "
                                 f"{diff}")
    rmbp = nr * 2 * args.read_len / 1e6
    print("phase=raptor " + json.dumps({
        "cereal_ibf": {"bytes": cereal_bytes, "write_read_s": cereal_s,
                       "equal": True},
        "layout_build_s": layout_s, "export_build_s": export_s,
        "archive_bytes": {os.path.basename(p_): os.path.getsize(p_ + ".hibf")
                          for p_ in (rdb, edb)},
        "filter_load_s": rload_s,
        "subs": [{"targets": int(s_.cols.numel()), "w8": s_.tbl8.shape[1],
                  "bin_size": s_.bin_size, "h": s_.hash_funs}
                 for s_ in fr.subs],
        "twin_reads_in_both_subs": both,
        "pairs": nr, "random_pairs": n_rrand, "seconds": r_cli_s,
        "reads_per_s": nr / r_cli_s, "mbp_per_min": rmbp / (r_cli_s / 60),
        "classified": len(rall), "unclassified": len(runc),
        "launches": r_cli_launches, "build_launches": rbuild_launches,
        "profiled_split_s": rtiming,
        "profiled_device_busy_share":
            rbusy_us / 1e6 / rtiming["total"] if rbusy_us else None,
        "profiled_device_us": rkernel_us,
        "cuda_equals_cpu_pairs": nc,
        "cuda_equals_cpu_archives": sorted(req_launches),
        "cuda_equals_cpu_launches": req_launches,
    }), flush=True)
    del fr, forest_hashes
    torch.cuda.empty_cache()

    # pruned: a merged-bin pruned forest at the T8192 shape ------------------
    # build: minimizers through extract, the tables through scatter's
    # pruned mode (the default) and on the host (device=False), equal
    prng = np.random.default_rng(args.seed + 4)
    pgen = prng.integers(0, 4, size=(args.pruned_targets,
                                     args.pruned_genome_len), dtype=np.uint8)
    pnames = [f"P{t}" for t in range(args.pruned_targets)]
    pbp = args.pruned_targets * args.pruned_genome_len
    kernels.reset_launches()
    t0 = time.perf_counter()
    phashes = _hashes(zip(pnames, pgen), k, w, cuda)
    torch.cuda.synchronize()
    p_extract_s = time.perf_counter() - t0
    pkw = dict(kmer_size=k, window_size=w, max_fp=0.05, group_size=64)
    t0 = time.perf_counter()
    pf = build_pruned(phashes, **pkw)  # the default: on the card
    p_dev_s = time.perf_counter() - t0
    pbuild_launches = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    pf_host = build_pruned(phashes, device=False, **pkw)
    p_host_s = time.perf_counter() - t0
    for name in ("fine", "coarse", "grp_bin_size", "grp_row_off",
                 "grp_ntargets"):
        if not np.array_equal(getattr(pf, name), getattr(pf_host, name)):
            raise AssertionError(f"pruned build: device and host {name} differ")
    if (pf.targets() != pf_host.targets()
            or pf.coarse_bin_size != pf_host.coarse_bin_size):
        raise AssertionError("pruned build: device and host layouts differ")
    del pf_host
    pdb = os.path.join(work, "pruned")
    t0 = time.perf_counter()
    pf.save_raw(pdb + ".hibf")
    p_save_s = time.perf_counter() - t0
    _write_tax(pdb + ".tax", pnames,
               [f"Q{t % 64}" for t in range(args.pruned_targets)])
    t0 = time.perf_counter()
    fp = dev.load_device_filter(pdb + ".hibf", cuda)
    torch.cuda.synchronize()
    p_load_s = time.perf_counter() - t0
    print("phase=pruned_build " + json.dumps({
        "targets": args.pruned_targets, "bp": pbp, "groups": pf.num_groups,
        "group_size": pf.group_size, "extract_s": p_extract_s,
        "device_build_s": p_dev_s, "host_build_s": p_host_s,
        # table builds alone, and with the minimizer extraction
        "device_build_mbp_per_min": pbp / 1e6 / (p_dev_s / 60),
        "host_build_mbp_per_min": pbp / 1e6 / (p_host_s / 60),
        "device_build_with_extract_mbp_per_min":
            pbp / 1e6 / ((p_extract_s + p_dev_s) / 60),
        "hashes": int(sum(len(x) for x in phashes.values())),
        "fine_bytes": int(pf.fine.nbytes),
        "coarse_bytes": int(pf.coarse.nbytes),
        "coarse_bin_size": pf.coarse_bin_size, "save_raw_s": p_save_s,
        "filter_load_s": p_load_s, "device_equals_host": True,
        "launches": pbuild_launches,
    }), flush=True)

    # the same genomes through build-custom --filter-type hibf: at 8192
    # targets --hibf-layout auto picks the pruned layout, byte-equal
    pcin = os.path.join(work, "pc_in")
    pc_input = _write_input(pcin, zip(pnames, pgen))
    pc = os.path.join(work, "pc")
    kernels.reset_launches()
    t0 = time.perf_counter()
    # (a rehearsal below the auto threshold names the layout)
    pc_layout = ("auto" if args.pruned_targets >= PRUNED_AUTO_MIN_TARGETS
                 else "pruned")
    _run_cli(["ganon-tpu-torch", "build-custom", "--input-file", pc_input,
              "--db-prefix", pc, "--filter-type", "hibf", "--filter-format",
              "tpu-raw", "--max-fp", "0.05", "--taxonomy", "skip",
              "--threads", "8", "--hibf-layout", pc_layout])
    pc_s = time.perf_counter() - t0
    pc_launches = dict(kernels.LAUNCHES)
    with open(pc + ".hibf", "rb") as a_, open(pdb + ".hibf", "rb") as b_:
        if a_.read() != b_.read():
            raise AssertionError("build-custom hibf: pc.hibf differs from "
                                 "pruned.hibf")
    shutil.rmtree(pcin, ignore_errors=True)
    print("phase=pruned_build_custom " + json.dumps({
        "targets": args.pruned_targets, "bp": pbp, "seconds": pc_s,
        "mbp_per_min": pbp / 1e6 / (pc_s / 60), "hibf_layout": pc_layout,
        "equals_pruned_hibf": True, "launches": pc_launches,
    }), flush=True)

    # the pruned kernels against their plain versions at main-path shapes:
    # CLI-default cutoffs, S = 2 slots, K = 4 (the start width at >= 4096
    # targets)
    _, pr1, pr2 = _sample_pairs(np.random.default_rng(args.seed + 5), pgen,
                                args.bench_pairs, args.read_len)
    pbatch = EncodedBatch(prefix="", paired=True,
                          ids=[str(i) for i in range(args.bench_pairs)],
                          codes1=pr1, len1=lens, codes2=pr2, len2=lens)
    pin_np, pL1, pL2 = dev.pack_batch_direct(pbatch, args.bench_pairs)
    ph, pn, povf = dev._extract_compact(torch.from_numpy(pin_np).to(cuda),
                                        k=k, w=w, L1=pL1, L2=pL2)
    S, gs = 2, fp.group_size
    gate_kw = dict(coarse_bin_size=fp.coarse_bin_size, coarse_h=fp.coarse_h,
                   num_groups=fp.num_groups, rel_cutoff=0.75,
                   hashes_limit=65535, max_groups=S, overflow=povf)
    gsel, slot_ok, govf = compare(
        "gate", "ganon_tpu_torch/csrc/gate.cu",
        "ganon_tpu/classify/device.py:1067",
        lambda: pq.gate(fp.ctbl, ph, pn, **gate_kw)[:3],
        lambda: pq.gate_plain(fp.ctbl, ph, pn, **gate_kw)[:3], 20, 5,
        _count_work(fp.ctbl, ph, pn, fp.coarse_bin_size, fp.coarse_h,
                    args.bench_pairs * (5 * S + 1)),
    )
    fargs = (fp.ftbl, ph, pn, fp.grp_row_off, fp.grp_bin_size, fp.grp_shift)
    fkw = dict(fine_h=fp.fine_h, group_size=gs)
    Wf = fp.ftbl.shape[1]
    live_b, live_s = torch.nonzero(slot_ok.bool(), as_tuple=True)
    frows, fvalid = _fine_work(fp, ph, pn, live_b,
                               gsel[live_b, live_s].to(torch.int64))
    (lane_counts,) = compare(
        "fine", "ganon_tpu_torch/csrc/fine.cu",
        "ganon_tpu/classify/device.py:1088",
        lambda: (pq.fine_counts(*fargs, gsel=gsel, slot_ok=slot_ok, **fkw),),
        lambda: (pq.fine_counts_plain(*fargs, gsel=gsel, slot_ok=slot_ok,
                                      **fkw),), 20, 5,
        (frows * Wf + _nbytes(ph, pn, gsel, slot_ok)
         + args.bench_pairs * S * gs * 4, fvalid * fp.fine_h * Wf),
    )
    # probe-all: counts_gated's survive mask (no hashes limit, no slots)
    surv = pq.gate(fp.ctbl, ph, pn, **{**gate_kw, "max_groups": 0,
                                        "overflow": None,
                                        "hashes_limit": pq.NO_HASHES_LIMIT},
                   want_surv=True)[3]
    akw = dict(surv=surv, num_targets=fp.num_targets, **fkw)
    surv_b, surv_g = torch.nonzero(surv.bool(), as_tuple=True)
    arows, avalid = _fine_work(fp, ph, pn, surv_b, surv_g)
    compare(
        "fine_all", "ganon_tpu_torch/csrc/fine.cu",
        "ganon_tpu/classify/device.py:1394",
        lambda: (pq.fine_counts(*fargs, **akw),),
        lambda: (pq.fine_counts_plain(*fargs, **akw),), 10, 2,
        (arows * Wf + _nbytes(ph, pn, surv)
         + args.bench_pairs * fp.num_targets * 4, avalid * fp.fine_h * Wf),
    )
    PK = min(4, S * gs)
    lc = lane_counts.reshape(args.bench_pairs, -1)
    lsel = (lc, pn, govf, gsel, slot_ok, fp.grp_ntargets, 0.75, 0.1, 65535)
    compare(
        "select_lanes", "ganon_tpu_torch/csrc/select.cu",
        "ganon_tpu/classify/device.py:1310",
        lambda: (dev.select_lanes(*lsel, group_size=gs,
                                  num_targets=fp.num_targets, top_k=PK,
                                  emit_matches_t=False),),
        lambda: (dev._pack_result(
            dev.threshold_topk(lc, pn, 0.75, 0.1, 65535, top_k=PK,
                               emit_matches_t=False,
                               lanes=(gsel, slot_ok, fp.grp_ntargets, gs,
                                      fp.num_targets)),
            pn, govf.to(torch.int32), dev.group_words(gsel, slot_ok)),),
        20, 5,
        (_nbytes(lc, pn, govf, gsel, slot_ok, fp.grp_ntargets)
         + 4 * (args.bench_pairs * (PK + 4 + -(-S // 2)) + fp.num_targets
                + 3), 4 * lc.numel()),
    )
    # one main-path scatter chunk of the fine table: the first 4M hashes
    # of the build's group-major member stream
    fh_, fg_, fj_, n = [], [], [], 0
    for t, name in enumerate(pf.targets()):
        part = phashes[name]
        fh_.append(part)
        fg_.append(np.full(len(part), t // gs, np.int32))
        fj_.append(np.full(len(part), t % gs, np.int32))
        n += len(part)
        if n >= SCATTER_CHUNK:
            break
    sph = u64_to_torch(np.concatenate(fh_)[:SCATTER_CHUNK]).to(cuda)
    spg = torch.from_numpy(np.concatenate(fg_)[:SCATTER_CHUNK]).to(cuda)
    spj = torch.from_numpy(np.concatenate(fj_)[:SCATTER_CHUNK]).to(cuda)
    fparams = (fp.grp_bin_size, fp.grp_shift, fp.grp_row_off)
    fine_k = torch.zeros((pf.fine.shape[0], -(-pf.fine.shape[1] // 4)),
                         dtype=torch.int32, device=cuda)
    fine_p = torch.zeros_like(fine_k)

    def scatter_pruned_kernel():
        scatter_pruned(fine_k, sph, spg, spj, *fparams, fp.fine_h)
        return (fine_k,)

    def scatter_pruned_run_plain():
        scatter_pruned_plain(fine_p, sph, spg, spj, *fparams, fp.fine_h)
        return (fine_p,)

    # the (hash, group, lane) triples in; each distinct u32 word set, out
    pg64 = spg.to(torch.int64)
    prow = torch.cat([
        q.ibf_row_dyn(sph, i, fp.grp_bin_size[pg64],
                      fp.grp_shift[pg64].to(torch.int64))
        + fp.grp_row_off[pg64] for i in range(fp.fine_h)])
    pwords = torch.unique(prow * fine_k.shape[1] + (spj // 32).to(
        torch.int64).repeat(fp.fine_h)).numel()
    compare("scatter_pruned", "ganon_tpu_torch/csrc/scatter.cu",
            "ganon_tpu/index/pruned.py:283", scatter_pruned_kernel,
            scatter_pruned_run_plain, 10, 3,
            (_nbytes(sph, spg, spj) + pwords * 4, prow.numel()))
    del pg64, prow
    print("phase=pruned_kernels " + json.dumps({
        "pairs": args.bench_pairs, "L1": pL1, "L2": pL2, "S": S, "K": PK,
        "gate_overflow_reads": int(govf.sum()),
        "live_slots": int(slot_ok.sum()),
        "scatter_pairs": int(sph.numel()),
        "ms": {r["name"]: [r["ms"], r["plain_ms"]] for r in rows[-5:]},
    }), flush=True)
    del ph, pn, povf, gsel, slot_ok, govf, lane_counts, lc, lsel, surv
    del live_b, live_s, surv_b, surv_g
    del fine_k, fine_p, sph, spg, spj, fargs, akw, phashes
    torch.cuda.empty_cache()

    # classify: 95% sampled pairs, 5% random, through the CLI, then profiled
    np_ = args.pruned_pairs
    n_prand = np_ // 20
    crng = np.random.default_rng(args.seed + 6)
    ptgt, pq1, pq2 = _sample_pairs(crng, pgen, np_ - n_prand, args.read_len)
    prand = crng.integers(0, 4, size=(2, n_prand, args.read_len),
                          dtype=np.uint8)
    ptruth = [pnames[t] for t in ptgt.tolist()] + ["rnd"] * n_prand
    perm = crng.permutation(np_)
    pq1 = np.concatenate([pq1, prand[0]])[perm]
    pq2 = np.concatenate([pq2, prand[1]])[perm]
    ptruth = [ptruth[j] for j in perm]
    pids = [b"p%d|%s" % (i, t.encode()) for i, t in enumerate(ptruth)]
    pf1, pf2 = os.path.join(work, "p1.fq"), os.path.join(work, "p2.fq")
    _write_fastq(pf1, pids, pq1)
    _write_fastq(pf2, pids, pq2)
    pout = os.path.join(work, "pout")
    kernels.reset_launches()
    t0 = time.perf_counter()
    _run_cli(["ganon-tpu-torch", "classify", "--db-prefix", pdb,
              "--paired-reads", pf1, pf2, "--output-prefix", pout,
              "--multiple-matches", "lca", "--output-one", "--output-all",
              "--output-unclassified", "--skip-report"])
    p_cli_s = time.perf_counter() - t0
    p_cli_launches = dict(kernels.LAUNCHES)
    # which batches take the exact probe-all path (group overflow)
    paths = {"fast": 0, "exact": 0}
    real_fast, real_exact = eng._dispatch_batch_fast, eng._classify_batch

    def fast(*a, **kw_):
        paths["fast"] += 1
        return real_fast(*a, **kw_)

    def exact(*a, **kw_):
        paths["exact"] += 1
        return real_exact(*a, **kw_)

    pfiles = dict(ibf=[pdb + ".hibf"], tax=[pdb + ".tax"], rel_cutoff=[0.75],
                  rel_filter=[0.1], fpr_query=[1e-5], output_lca=True,
                  output_all=True, output_unclassified=True)
    eng._dispatch_batch_fast, eng._classify_batch = fast, exact
    try:
        with torch.profiler.profile(activities=acts) as prof:
            ptiming = run_classify(ClassifyConfig(
                paired_reads=[pf1, pf2],
                output_prefix=os.path.join(work, "pprof"), **pfiles))["timing"]
    finally:
        eng._dispatch_batch_fast, eng._classify_batch = real_fast, real_exact
    pbusy_us, pkernel_us = _device_busy(prof)
    pall = _true_target_rows(pout + ".all")
    with open(pout + ".unc") as fh_:
        punc = {line.strip() for line in fh_ if line.strip()}
    pbad = {"sampled": 0, "random": 0}
    for rid in pids:
        rid = rid.decode()
        t = rid.split("|")[1]
        if t == "rnd":
            pbad["random"] += rid not in punc
        else:
            pbad["sampled"] += t not in pall.get(rid, ())
    if any(pbad.values()):
        raise AssertionError(f"pruned pairs misplaced: {pbad}")
    # the first pairs at cutoff 0.2 on the card (S = 2, then S = 1: the
    # probe-all fallback) and through the plain versions on the CPU
    nc = args.check_pairs
    ps1, ps2 = (os.path.join(work, f"psub{m}.fq") for m in (1, 2))
    _write_fastq(ps1, pids[:nc], pq1[:nc])
    _write_fastq(ps2, pids[:nc], pq2[:nc])
    psubs, peq_launches = {}, {}
    for key, device, s_max in (("cuda", "cuda", 2), ("cuda_s1", "cuda", 1),
                               ("cpu", "cpu", 2)):
        d = os.path.join(work, f"psub_{key}")
        os.makedirs(d)
        kernels.reset_launches()
        run_classify(ClassifyConfig(
            ibf=[pdb + ".hibf"], tax=[pdb + ".tax"], paired_reads=[ps1, ps2],
            rel_cutoff=[0.2], output_lca=True, output_all=True,
            output_unclassified=True, output_stats=True, device=device,
            pruned_max_groups=s_max, output_prefix=os.path.join(d, "o")))
        if device == "cuda":
            peq_launches[key] = dict(kernels.LAUNCHES)
        psubs[key] = {
            fn: (open(os.path.join(d, fn), "rb").read() if fn.endswith(".sta")
                 else _sorted_rows(os.path.join(d, fn)))
            for fn in sorted(os.listdir(d))
        }
    for key in ("cuda", "cuda_s1"):
        if psubs[key] != psubs["cpu"]:
            diff = [fn for fn in set(psubs[key]) | set(psubs["cpu"])
                    if psubs[key].get(fn) != psubs["cpu"].get(fn)]
            raise AssertionError(f"pruned: {key} and cpu runs differ in {diff}")
    if peq_launches["cuda_s1"]["fine_all"] <= 0:
        raise AssertionError("pruned: S = 1 run took no probe-all batch")
    pmbp = np_ * 2 * args.read_len / 1e6
    print("phase=pruned " + json.dumps({
        "pairs": np_, "random_pairs": n_prand, "seconds": p_cli_s,
        "reads_per_s": np_ / p_cli_s, "mbp_per_min": pmbp / (p_cli_s / 60),
        "classified": len(pall), "unclassified": len(punc),
        "launches": p_cli_launches,
        "profiled_batches": paths,
        "profiled_split_s": ptiming,
        "profiled_device_busy_share":
            pbusy_us / 1e6 / ptiming["total"] if pbusy_us else None,
        "profiled_device_us": pkernel_us,
        "cuda_equals_cpu_pairs": nc,
        "cuda_equals_cpu_files": sorted(psubs["cpu"]),
        "cuda_equals_cpu_launches": peq_launches,
    }), flush=True)
    del fp, pf, pgen
    torch.cuda.empty_cache()

    # 5. checks ------------------------------------------------------------
    main_runs = (build_launches, bc_launches, ref_launches,
                 hier_build_launches, cli_launches, hier_launches,
                 r_cli_launches, *req_launches.values(), pbuild_launches,
                 pc_launches, p_cli_launches, *peq_launches.values())
    launches = {name: sum(r[name] for r in main_runs)
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
