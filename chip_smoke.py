#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py            # full size (needs one CUDA card)

Phases, one output line each:

1. env       the card (nvidia-smi name and power limit), torch, nvcc, and
             the time to build the CUDA kernels from ``csrc/`` (one nvcc
             per source, all started together); ``nvcc -Xptxas -v`` of
             ``extract.cu``, ``scan.cu``, ``count.cu``, ``select.cu``,
             ``dedup.cu``, ``scatter.cu``, ``merge.cu``, ``bins.cu``,
             ``psort.cu`` and ``gprobe.cu`` (registers, spills, static
             shared memory) and
             the extract blocks an SM at k 19, w 31;
2. build     1024 targets x 1 Mbp of random genomes (seeded): minimizers
             through the ``extract`` kernel, the IBF through ``scatter``,
             saved raw as ``db.ibf`` (``save_raw``, the ``tpu-raw``
             container: the CLI below runs the npz writer) with a
             ``db.tax`` of 32 genera; then
             (line ``build_custom``) the same genomes as 1024 multi-line
             FASTA files through ``python -m ganon_tpu_torch.cli
             build-custom --input-file ... --taxonomy ncbi`` (an
             --input-file over 32 genera and their nodes.dmp/names.dmp),
             the two-pass device build: ``bc.ibf`` must equal ``db.ibf``
             and ``bc.tax`` exist; its StopClock phases, Mbp/min and peak
             card memory; ``extract`` on the build's pieces, ``pack``,
             ``sort``, ``dedup`` (its counts mode, as pass 1 runs it, and
             its rank mode, one chained scan, which no build path runs) and
             ``scatter`` in ranked mode (pass 2 in one call: first
             occurrences, ranks, bins, bits) against their plain versions
             at one pass-1 group of that build (sort beside
             ``torch.sort``); a 64-target reference-format build of
             two files per target, one target over several bins, through
             ``run_build`` on the card and with ``device="cpu"``, byte-equal;
             ``scatter`` in span mode (one of four row shards) against its
             plain version at that group; then
             (line ``build_acquire``) ``ganon build`` and ``update``
             through the CLI on a local repository tree (``local_dir``)
             of the same genomes as ``.fna.gz`` files: the first state
             lists all but the last 32 genomes, 16 decoys of 64 kbp and an
             ``na`` row, ``build`` fetches them, the taxdump of the 32
             genera and the genome sizes (1008 targets, a ``.tax``, the
             five build kernels launched); then the 32 come in and the
             decoys go, and ``update`` (32 ``A``, 16 ``R`` in changes.tsv,
             the kept files hard links to the first snapshot's) must give
             ``db.ibf`` again; its seconds of acquisition, build and
             update, Mbp/min, StopClock phases, peak card memory and
             launches; then
             (line ``mesh_build``) the same FASTA files through
             ``run_build`` with four views of ``cuda:0`` as the local
             devices (K17: the groups round-robin over them, the matrix is
             cut into four row spans), equal to ``db.ibf``; then
             (line ``build_hierarchy``) the hierarchy's databases the same
             way: ``host.hibf``, a native forest of 256 targets of skewed
             lengths (64 each of 0.25, 0.5, 1 and 2 Mbp), and ``db_b.ibf``,
             512 targets x 1 Mbp whose first 64 are ``T0..T63`` of
             ``db.ibf`` (names and genomes), each with a ``.tax``;
3. kernels   the saved filters loaded and repacked, then each kernel (and
             kernel mode) against its plain torch version on the same CUDA
             tensors at main-path shapes (8192 pairs of 150 bp; count on
             ``db.ibf`` and, in forest mode, on the forest's last sub; merge
             (one launch a level, into unfilled buffers) and select with
             winners on the 1024 + 448 union of ``db`` and ``db_b``),
             required equal, both timed with CUDA events;
             the transfer kernels at the same shapes: ``ragged`` on
             select's buffer (with and without winners) at the engine's
             cap of 2 slots a read, ``probe_sort`` (count's input with
             sort_probes; count timed on sorted and unsorted hashes,
             equal counts), and ``classify_batch_packed`` with
             sort_probes, equal to its buffer without; the gather probe
             (the Pallas probe's port: 1M random rows of a 4 MB table);
4. classify  524,288 read pairs through ``python -m ganon_tpu_torch.cli
             classify`` (run in this process, so the launch counts are
             readable; the filters loaded in phase 3 stay cached), then
             once more through ``run_classify`` under ``torch.profiler``
             for the engine's time split and the card's busy share; every
             pair lists its true target in ``.all``, and on its first 4096
             pairs the CUDA and ``device="cpu"`` runs write identical
             sorted ``.all``, ``.one`` and ``.rep`` (here, while ``db``'s
             table is still in the filter cache); the runs take the ragged
             match stream (line ``classify_transfer``: batches on it, cap
             overflows, final slots, bytes fetched against the dense
             layout's), and ``classify_batch_packed`` at 1024 pairs on the
             card equals its run on the filter moved to the CPU at
             ``match_cap`` 0 and at a cap it overflows;
ops          the ``ganon_tpu_torch.ops`` library (K18) at the flat
             filter's width, while ``db`` is cached: db's interleaved bits
             uploaded as saved, both mates of phase 3's 8192 pairs as
             16,384 single reads through ``minimizers``,
             ``ibf_row_indices``, ``bulk_count_bins``, ``target_counts``
             and ``bulk_target_counts``; the two per-target results equal
             each other and the packed ``count`` (clamp off) on the same
             hashes; each kernel against its plain version;
extract_wide the wide-window route of ``extract`` (k 19, w 18,104: past a
             tile's shared memory; one warp a read): 48 pairs of 20-40
             kbp mates from the genomes against the plain version, the
             build's mode single-end (first n slots), and the ops
             library's ``minimizers`` at that w on the card, counted as
             ``extract_wide`` (row ``extract_wide``);
mesh         the (batch, bins) device mesh (K17) over eight views of
             ``cuda:0`` (2 x 4), while ``db``'s table is still cached: the
             filter cut into column shards on the card (no host repack),
             its counts of 8192 pairs and ``ShardedClassifier``'s equal to
             one device's; ``count`` in shard mode and ``combine`` against
             their plain versions (combine beside ``torch.sum`` over the
             shard axis); the classify phase's pairs through the CLI on
             the mesh, its files equal to that phase's (sorted rows,
             ``.sta`` byte-equal); 16,384 forest pairs on one device and
             on the mesh, equal; ``--distributed``: two processes on the
             card (gloo), a read file pair each, whose ``.h0``/``.h1``
             outputs together equal one process's;
longreads    the 32-bit counter layout (``select`` in its 32-bit mode) at
             the CLI's default flags (EM reassignment, the report chained
             from ``db.tax``): 49,152 single-end reads of the JAX bench's
             nanopore-style mix (500 bp to 16 kbp, 5% random) plus 64
             ultra-long reads of 600 kbp (counts past 0xFFFF), through
             ``classify --db-prefix db --longreads``: reads/s, Mbp/m, the
             engine's, reassign's and report's seconds, peak card memory;
             again with ``--output-all`` under ``torch.profiler`` (busy
             share): every sampled read lists its true target, random reads
             none; without ``--longreads`` the ultra-long reads are skipped
             (``.sta``). Then a flat filter just past the 16-bit bound,
             70,000 targets x 4 kbp (``wide.ibf``), and 65,536 pairs through
             it (pairs from targets above 0xFFFF found). ``extract``
             (rows ``extract_ultra_long``, ``extract_mixed_long``) and
             ``select32`` against their plain versions at the ultra-long
             batch (64 x 2^20, every window position), ``extract`` also
             at the mix's 16 kbp bucket (512 reads), ``select32`` also at
             T = 70,000; on the first 4096 reads of each the card and
             ``device="cpu"`` write identical sorted ``.all``, ``.one``,
             ``.rep`` and ``.tre`` and a byte-equal ``.sta``; ``bins``,
             ``tsum`` and ``bins_target`` (its two-launch route: 2188
             words a row) on ``wide.ibf``'s matrix at 1024 reads, a main
             path of their own (``tsum`` past one tile of targets, after
             its plan ``tsum_plan``), equal to their plain versions and
             the per-target two to the packed count, and the plan against
             its plain version (row ``tsum_plan``);
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
             over the layout's four subs in one launch
             (``raptor_target_counts``; one launch a sub beside,
             ``per_sub_ms``), and on a small layout with one user bin in
             two IBFs (both subs count it, one launch a sub and a batch
             equal); 524,288 pairs (95%
             sampled, a quarter per class, 5% random) through the CLI with
             ``--db-prefix raptor``, profiled; every sampled pair lists its
             true target in ``.all``, random pairs land in ``.unc``, and on
             the first 4096 pairs both archives give the same sorted files
             and byte-equal ``.sta`` on the card and with ``device="cpu"``,
             and the layout archive the same on one device and on the mesh;
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
             mode (one build flush of both tables, 4M hashes in runs) against
             their plain versions at 8192 pairs,
             and ``pairs`` at the engine's pair cap (line
             ``pruned_kernels``, rows of the kernels line); the packed
             batch on the card equal to the CPU's at pair caps 0, 8 and
             B * S; then
             1,048,576 pairs (95% sampled, 5% random) through the CLI,
             profiled again with the count of batches that took the exact
             probe-all path; every sampled pair lists its true target in
             ``.all``, random pairs land in ``.unc``, and the first 4096
             pairs at rel-cutoff 0.2 give the same sorted files and
             byte-equal ``.sta`` on the card (S = 2, and S = 1, which forces
             the probe-all path) and with ``device="cpu"``; then
             (line ``mesh_pruned``) ``BinShardedPrunedForest`` over four
             views of the card (K17): its gated counts of 8192 pairs equal
             ``DevicePrunedForest.counts_gated``, and ``fine`` in shard
             mode against its plain version at shard 0;
5. checks    every kernel mode launched on the main paths (builds, the
             ops library at db's and at the wide filter's widths, the
             sort_probes batch, the gather probe, the
             two build-custom runs, ``build_acquire``'s build and update,
             the reference-format build, the mesh
             build, the classify CLI runs and the mesh runs, the longreads
             phase's runs and the raptor and pruned phases' card runs).

Every phase line carries ``wall_s``, the wall time since the line before
it. Then one JSON line of every kernel mode (its time and its plain
version's, its bound at these inputs, the larger of bytes over 3.35 TB/s
and operations over 67 T/s (extract's: 40 INT32 operations a window over
16.7 T/s, 64 lanes an SM a clock at 1.98 GHz; ``extract_build`` in the
build's mode, without the zero tail, ``zero_tail_ms`` and
``zero_tail_bound_ms`` beside), its launches on the main paths, and the
time of one PyTorch call computing the same function where there is one;
``sort``, ``ragged``, ``ragged_winners``, ``pairs``, ``dedup`` (both
modes), ``scatter`` and its ranked and span modes, ``count``, ``gate``,
``fine``, ``fine_all``, ``fine_shard``, ``pack``, ``merge``,
``scatter_pruned``, ``combine``, ``bins``, ``tsum``, ``tsum_plan``,
``bins_target``, ``probe_sort`` and ``gather_probe`` are also timed over
a run of back-to-back calls queued while the card sleeps, ``device_ms``
and ``library_device_ms``, and by the card's activity under
torch.profiler, ``profiled_ms`` and ``library_profiled_ms`` (null where no profiled window held every
device record of its calls' own activities), and the ``sort`` row names the digit passes it
planned at the pass-1 group from the card's histograms, the ``sort_hist``
row),
and last the device line. Every classify CLI run of phases 4,
hierarchy, raptor and pruned prints a ``transfer=<phase>`` line of its
own: per level, the batches fetched as the ragged stream and dense, the
cap overflows and final slots a read, the pair-spill retries, and the
bytes fetched per batch against the dense layout's at the same B and K.
Any failure raises (exit code 1); without CUDA the script
exits 2 before any work. If a run nears the time limit, ``wall_s`` says
where to cut: the host's filter loads (repacks), npz and raptor writers
and the ``device="cpu"`` checks take most of it, the pair counts little.
"""

from __future__ import annotations

import argparse
import functools
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


def _ms_run(fn, n: int) -> float:
    """Milliseconds a call of ``fn`` over ``n`` back-to-back calls
    between one CUDA event pair (warmed), queued behind ~10 ms of sleep
    on the card: the device time, the host's time a call hidden, unless
    ``fn`` waits on the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _profiled_ms(fn, n: int) -> float | None:
    """Device milliseconds a call of ``fn``: the union of the card's
    activity (kernels, memsets, copies) under torch.profiler over ``n``
    calls (warmed), over ``n``; the card's own time, whatever the host
    adds around it. One call's activities are those two windows of one
    call both hold (by name); a window of ``n`` calls counts only those,
    and must hold ``n`` times each (the profiler loses records now and
    then in a long process: such a window reads low), else it is
    profiled again, up to five windows; None if none holds them all."""
    from collections import Counter

    import torch
    from torch.autograd import DeviceType

    def window(calls):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return [e for e in prof.events() if e.device_type == DeviceType.CUDA]

    fn()
    torch.cuda.synchronize()
    own = (Counter(e.name for e in window(1))
           & Counter(e.name for e in window(1)))
    for _ in range(5):
        mine = [e for e in window(n) if e.name in own]
        if own and Counter(e.name for e in mine) == Counter(
                {k: v * n for k, v in own.items()}):
            return _union_us([(e.time_range.start, e.time_range.end)
                              for e in mine]) / n / 1e3
    return None


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
# the INT32 rate: 64 lanes an SM a clock, 132 SMs at 1.98 GHz (the extract
# kernel's 64-bit integer work is counted in INT32 operations)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# INT32 operations a window position of the extract kernel: the k-mer
# value (funnel load, bit reverse, pair swap, complement, two XORs, a
# 64-bit min), the prefix and suffix argmins and their merge, the flag
EXTRACT_OPS_PER_POSITION = 40


def _bound(nbytes: float, ops: float, ops_per_s: float = OPS_PER_S):
    """(bound_ms, bound_by) of a function moving ``nbytes`` and doing
    ``ops`` operations at ``ops_per_s``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _extract_work(inbuf, L1: int, L2: int, w: int, n, mc: int,
                  zero_tail: bool = True):
    """(bytes, ops, rate) of one extract: the packed rows in; n, overflow
    and the emitted hashes out, or the whole [B, mc] where the zero tail
    is written; EXTRACT_OPS_PER_POSITION INT32 operations for each window
    of this batch's lengths (mate 2 only where mate 1 has one)."""
    import torch

    B = inbuf.shape[0]
    o = L1 // 4 + L2 // 4
    lens = inbuf[:, o:o + (8 if L2 else 4)].contiguous().view(
        torch.int32).to(torch.int64)
    len1 = lens[:, 0]
    ok = len1 >= w
    windows = torch.clamp(torch.clamp(len1, max=L1) - w + 1, min=0)
    if L2:
        windows = windows + torch.clamp(
            torch.clamp(lens[:, 1], max=L2) - w + 1, min=0)
    positions = int(windows[ok].sum())
    out = (B * mc if zero_tail else int(torch.clamp(n, max=mc).sum())) * 8
    return (_nbytes(inbuf) + 5 * B + out,
            positions * EXTRACT_OPS_PER_POSITION, INT32_OPS_PER_S)


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
                  hash_functions, rows_in=None):
    """Distinct u32 words the ranked scatter sets (in the row range
    ``rows_in`` = (r0, r1) only, for its span mode): the words it must
    write at least once."""
    import torch

    from ganon_tpu_torch.ops.build_ops import _ranked_bins
    from ganon_tpu_torch.ops.ibf_query import ibf_row_indices

    u, bins = _ranked_bins(key, uniq, rank, params)
    rows = ibf_row_indices(val[u], bin_size=bin_size,
                           hash_functions=hash_functions)
    words = rows * n_words + (bins >> 5)[:, None]
    if rows_in is not None:
        words = words[(rows >= rows_in[0]) & (rows < rows_in[1])]
    return int(torch.unique(words).numel())


class _LocalDevices:
    """While active, ``parallel.mesh.local_devices`` returns ``devices``:
    the seam through which a run on one card sees several views of it
    (the engine's and the build's meshes, the build's round-robin)."""

    def __init__(self, devices):
        self.devices = list(devices)

    def __enter__(self):
        from ganon_tpu_torch.parallel import mesh as pmesh

        self._real = pmesh.local_devices
        pmesh.local_devices = lambda: list(self.devices)
        return self

    def __exit__(self, *exc):
        from ganon_tpu_torch.parallel import mesh as pmesh

        pmesh.local_devices = self._real


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


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
    return _union_us(spans), totals


def _union_us(spans):
    """The length of the union of ``(start, end)`` spans."""
    busy, end = 0, None
    for s, t in sorted(spans):
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return busy


def _sorted_rows(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return sorted(line for line in f if line.strip())


def _write_tax(path, names, genus_of, genome_size=1_000_000):
    """A .tax of root, the given genera and one species per target, each
    node with a genome size (the column the chained report reads)."""
    with open(path, "w") as f:
        f.write(f"1\t0\tno rank\troot\t{genome_size}\n")
        for g in sorted(set(genus_of)):
            f.write(f"{g}\t1\tgenus\t{g}\t{genome_size}\n")
        for name, g in zip(names, genus_of):
            f.write(f"{name}\t{g}\tspecies\t{name}\t{genome_size}\n")


# the JAX benchmark's nanopore-style length mix (bench.py:405-407)
MIX_LENS = (500, 1000, 2000, 4000, 8000, 16000)
MIX_WEIGHTS = (0.15, 0.2, 0.3, 0.2, 0.1, 0.05)


def _long_read_mix(rng, genomes, names, n, n_ultra, ultra_len):
    """Single-end reads: ``n`` of the length mix (5% random, the rest
    sampled from ``genomes``) and ``n_ultra`` ultra-long reads of
    ``ultra_len`` bp, shuffled. Returns (ids, ACGT byte strings, the
    ultra-long reads' codes). Ids are ``l<i>|<target>`` (``rnd`` for a
    random read) and ``u<i>|<target>`` for the ultra-long ones."""
    import numpy as np

    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    n_targets, glen = genomes.shape
    p = np.asarray(MIX_WEIGHTS) / sum(MIX_WEIGHTS)
    lens = rng.choice(np.asarray(MIX_LENS), size=n, p=p)
    n_rand = n // 20
    reads = []  # (kind, truth, seq)
    for i, ln in enumerate(lens.tolist()):
        if i < n_rand:
            reads.append((b"l", b"rnd", acgt[rng.integers(
                0, 4, size=ln, dtype=np.uint8)].tobytes()))
        else:
            t, s = int(rng.integers(n_targets)), int(rng.integers(glen - ln))
            reads.append((b"l", names[t].encode(),
                          acgt[genomes[t, s:s + ln]].tobytes()))
    ucodes = np.zeros((n_ultra, ultra_len), dtype=np.uint8)
    for i in range(n_ultra):
        t = int(rng.integers(n_targets))
        s = int(rng.integers(glen - ultra_len))
        ucodes[i] = genomes[t, s:s + ultra_len]
        reads.append((b"u", names[t].encode(), acgt[ucodes[i]].tobytes()))
    perm = rng.permutation(len(reads))
    ids = [b"%s%d|%s" % (reads[j][0], i, reads[j][1])
           for i, j in enumerate(perm)]
    return ids, [reads[j][2] for j in perm], ucodes


def _write_fastq_seqs(path, ids, seqs):
    """FASTQ of reads of any lengths (``seqs``: ACGT byte strings)."""
    with open(path, "wb") as f:
        for rid, s in zip(ids, seqs):
            f.write(b"@%s\n%s\n+\n%s\n" % (rid, s, b"I" * len(s)))


class _CallTimes:
    """Wraps ``module.name`` functions while active: each call's seconds
    (summed per name) and the last result, so a CLI run reports the
    engine's, reassign's and report's shares."""

    def __init__(self, *targets):
        self.targets = targets  # (module name, function name)
        self.seconds, self.results, self._saved = {}, {}, []

    def __enter__(self):
        import importlib

        for mod_name, fn in self.targets:
            mod = importlib.import_module(mod_name)
            real = getattr(mod, fn)

            def timed(*a, _real=real, _fn=fn, **kw):
                t0 = time.perf_counter()
                res = _real(*a, **kw)
                self.seconds[_fn] = (self.seconds.get(_fn, 0.0)
                                     + time.perf_counter() - t0)
                self.results[_fn] = res
                return res

            self._saved.append((mod, fn, real))
            setattr(mod, fn, timed)
        return self

    def __exit__(self, *exc):
        for mod, fn, real in self._saved:
            setattr(mod, fn, real)
        self._saved = []


def _sta_row(path):
    """The first level's row of a ``.sta`` file as {column: value}."""
    with open(path) as f:
        rows = [line.rstrip("\n").split("\t") for line in f if line.strip()]
    return dict(zip(rows[0], rows[1]))


def _output_files(d):
    """{file: sorted lines (``.sta``: bytes)} of a directory's outputs."""
    return {fn: (open(os.path.join(d, fn), "rb").read() if fn.endswith(".sta")
                 else _sorted_rows(os.path.join(d, fn)))
            for fn in sorted(os.listdir(d))}


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


def _transfer_line(phase, result) -> None:
    """Print a classify run's result transfers (``run_classify``'s
    ``transfer``), per level, with the bytes per batch."""
    levels = {}
    for label, tr in result["transfer"].items():
        n = tr["ragged_batches"] + tr["dense_batches"]
        levels[label] = dict(
            tr, fetched_bytes_per_batch=tr["fetched_bytes"] / max(n, 1),
            dense_bytes_per_batch=tr["dense_bytes"] / max(n, 1))
    print(f"transfer={phase} " + json.dumps(levels), flush=True)


def _ragged_work(dense, B, K, cap, has_win=False, n_extra=0):
    """(bytes, ops) of the ragged stream of a dense buffer: the four [B]
    rows, the valid entries, the extra rows and tail in; the stream, the
    two words, the extra rows and tail out; a scan step per read and a
    move per entry."""
    import torch

    o = B * K * (2 if has_win else 1)
    nm = dense[o:o + B].to(torch.int64)
    total = int(torch.clamp(nm, 0, K).sum())
    rest = dense.numel() - o - 4 * B  # extra rows and tail
    blocks = 2 if has_win else 1
    return (4 * (4 * B + blocks * total + rest)
            + 4 * (blocks * cap + 2 * B + rest), B + total)


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


def _fasta_bytes(name, codes, width=80) -> bytes:
    """A one-sequence FASTA of dna4 codes, ``width`` bases a line."""
    import numpy as np

    s = np.frombuffer(b"ACGT", dtype=np.uint8)[codes]
    full = len(s) // width * width
    lines = np.concatenate([s[:full].reshape(-1, width),
                            np.full((full // width, 1), 10, np.uint8)], axis=1)
    tail = s[full:].tobytes() + b"\n" if full < len(s) else b""
    return b">%s\n" % name.encode() + lines.tobytes() + tail


def _write_fasta(path, name, codes, width=80):
    with open(path, "wb") as f:
        f.write(_fasta_bytes(name, codes, width))


def _load_test_helper(name):
    """A helper module of ``tests/``, loaded by its path: a ``tests``
    package installed on the machine would shadow the repo's directory."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


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


def _build_acquire(args, work, genomes, ibf, names, emit):
    """Phase ``build_acquire``: ``ganon build`` and ``update`` on the card
    through the CLI, fetching from a local repository tree.

    The tree (``local_dir``) holds refseq bacteria's assembly_summary.txt
    in the 38-column layout, one ``{ftp_path}/{asm}_genomic.fna.gz`` a row
    (gzip level 1), a new_taxdump of the 32 genera and the species genome
    sizes. Its first state lists the first ``targets - 32`` genomes as
    latest, 16 decoys of 64 kbp (random from the seed) and the last 32
    genomes as replaced, and a row whose ftp_path is ``na``. ``build``
    (taxonomy and genome sizes fetched, ``--max-fp 0.05 --hash-functions 0
    --tpu-sizing auto --threads 8``) must give ``targets - 16`` targets and
    a ``.tax``, launching ``extract_build``, ``pack``, ``sort``, ``dedup``
    and ``scatter_ranked``. Then the 32 become latest and the decoys
    replaced, and ``update`` takes the saved configuration: its
    changes.tsv holds 32 ``A`` and 16 ``R`` rows, the kept files are hard
    links to the first snapshot's, and the filter equals ``db.ibf`` (bits,
    config, hashes count, and the bin map once each accession is mapped to
    its genome's name; accessions sort in genome order, as the build
    orders its files). Returns the launches of the build and of the
    update, for the checks."""
    import gzip
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from ganon_tpu_torch import acquire, kernels
    from ganon_tpu_torch.index.ibf import IBF

    tree = _load_test_helper("ncbi_tree")
    n_new = min(32, args.targets // 2)
    n_decoys = 16
    root = os.path.join(work, "acq_repo")
    drng = np.random.default_rng(args.seed + 19)
    decoys = drng.integers(0, 4, size=(n_decoys, 64_000), dtype=np.uint8)
    genus = [str(1000 + t % 32) for t in range(args.targets + n_decoys + 1)]
    rows = [tree.Assembly(f"GCF_{i + 1:09d}.1", genus[i])
            for i in range(args.targets + n_decoys + 1)]
    rows[-1].ftp_na = True
    name_of = {a.acc: names[i] for i, a in enumerate(rows[:args.targets])}

    def state(first):
        for i, a in enumerate(rows[:-1]):
            new, decoy = (args.targets - n_new <= i < args.targets,
                          i >= args.targets)
            a.status = "replaced" if (new if first else decoy) else "latest"
        tree.write_summaries(root, rows)

    def write_one(i):
        a = rows[i]
        codes = genomes[i] if i < args.targets else decoys[i - args.targets]
        path = os.path.join(tree.local_path(root, a.ftp_path),
                            a.name + "_genomic.fna.gz")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(gzip.compress(_fasta_bytes(a.acc + "_seq1", codes),
                                  compresslevel=1))

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write_one, range(len(rows) - 1)))
    tree.write_taxdump(root, [("1", "1", "no rank")] + [
        (str(1000 + j), "1", "genus") for j in range(32)],
        names={str(1000 + j): f"G{j}" for j in range(32)})
    tree.write_genome_sizes(root, {str(1000 + j): args.genome_len
                                   for j in range(32)})
    state(first=True)
    tree_s = time.perf_counter() - t0

    # the acquisition's own seconds, inside each CLI run
    acq_seconds = []
    real_acquire = acquire.acquire

    def timed_acquire(*a, **kw):
        t = time.perf_counter()
        try:
            return real_acquire(*a, **kw)
        finally:
            acq_seconds.append(time.perf_counter() - t)

    db = os.path.join(work, "acq", "db")
    os.makedirs(os.path.dirname(db))
    os.environ["local_dir"] = root
    acquire.acquire = timed_acquire
    try:
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, b_phases, b_bp = _with_build_phases(lambda: _run_cli([
            "ganon-tpu-torch", "build", "--db-prefix", db, "--source",
            "refseq", "--organism-group", "bacteria", "--taxonomy", "ncbi",
            "--threads", "8", "--max-fp", "0.05", "--hash-functions", "0",
            "--tpu-sizing", "auto", "--write-info-file", "--verbose"]))
        b_s = time.perf_counter() - t0
        b_launches = dict(kernels.LAUNCHES)
        b_peak = torch.cuda.max_memory_allocated()
        folder = db + "_files"
        v1 = acquire.current_version(folder)
        with open(db + ".info.tsv") as f:
            n_info = sum(1 for _ in f)
        if n_info != args.targets - n_new + n_decoys:
            raise AssertionError(f"build: {n_info} targets in .info.tsv")
        if not os.path.getsize(db + ".tax"):
            raise AssertionError("build: no .tax")

        state(first=False)
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, u_phases, u_bp = _with_build_phases(lambda: _run_cli([
            "ganon-tpu-torch", "update", "--db-prefix", db, "--threads", "8",
            "--write-info-file", "--verbose"]))
        u_s = time.perf_counter() - t0
        u_launches = dict(kernels.LAUNCHES)
        u_peak = torch.cuda.max_memory_allocated()
    finally:
        acquire.acquire = real_acquire
        os.environ.pop("local_dir", None)
    for what, launched in (("build", b_launches), ("update", u_launches)):
        missing = [x for x in ("extract_build", "pack", "sort", "dedup",
                               "scatter_ranked") if launched[x] <= 0]
        if missing:
            raise AssertionError(f"{what}: not launched: {missing}")
    v2 = acquire.current_version(folder)
    with open(os.path.join(folder, v2, "changes.tsv")) as f:
        ops = [line.split("\t")[0] for line in f]
    if (ops.count("A"), ops.count("R"), len(ops)) != (n_new, n_decoys,
                                                    n_new + n_decoys):
        raise AssertionError(f"update: changes.tsv {ops.count('A')} A, "
                             f"{ops.count('R')} R")
    kept = [a.name + "_genomic.fna.gz"
            for a in rows[:args.targets - n_new]]
    linked = sum(
        os.stat(os.path.join(folder, v1, "files", f)).st_ino
        == os.stat(os.path.join(folder, v2, "files", f)).st_ino for f in kept)
    if linked != len(kept):
        raise AssertionError(f"update: {linked} of {len(kept)} kept files "
                             "are hard links")
    t0 = time.perf_counter()
    got = IBF.load(db + ".ibf")
    load_s = time.perf_counter() - t0
    if not (np.array_equal(got.bits, ibf.bits)
            and got.ibf_config.to_dict() == ibf.ibf_config.to_dict()
            and [(name_of[t], c) for t, c in got.hashes_count.items()]
            == list(ibf.hashes_count.items())
            and [(b, name_of[t]) for b, t in got.bin_map] == ibf.bin_map):
        raise AssertionError("update: the filter differs from db.ibf")
    del got
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(os.path.dirname(db), ignore_errors=True)
    emit("build_acquire", {
        "assemblies": {"first": args.targets - n_new + n_decoys,
                       "update_added": n_new, "update_removed": n_decoys,
                       "na_rows": 1},
        "tree_write_s": tree_s,
        "acquire_s": acq_seconds,
        "build": {"seconds": b_s, "bp": b_bp,
                  "mbp_per_min": b_bp / 1e6 / (b_s / 60),
                  "stopclock_s": b_phases, "max_memory_allocated": b_peak,
                  "launches": b_launches},
        "update": {"seconds": u_s, "bp": u_bp,
                   "mbp_per_min": u_bp / 1e6 / (u_s / 60),
                   "stopclock_s": u_phases, "max_memory_allocated": u_peak,
                   "launches": u_launches, "hard_links": linked,
                   "equals_db_ibf": True, "filter_load_s": load_s},
    })
    return b_launches, u_launches


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
    # long reads against db (the JAX bench's mixedlen size, bench.py:728)
    # plus ultra-long reads whose counts pass 0xFFFF; and a flat filter
    # just past the 16-bit target bound
    ap.add_argument("--long-reads", type=int, default=49_152)
    ap.add_argument("--ultra-reads", type=int, default=64)
    ap.add_argument("--ultra-len", type=int, default=600_000)
    ap.add_argument("--wide-targets", type=int, default=70_000)
    ap.add_argument("--wide-genome-len", type=int, default=4000)
    ap.add_argument("--wide-pairs", type=int, default=65_536)
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
        build_pruned, pruned_plan, scatter_pruned, scatter_pruned_plain,
    )
    from ganon_tpu_torch.io.pipeline import EncodedBatch
    from ganon_tpu_torch.ops import build_ops as bo
    from ganon_tpu_torch.ops import ibf_query as q
    from ganon_tpu_torch.ops import pruned_query as pq
    from ganon_tpu_torch.ops.winnow import u64_to_torch
    write_raptor_layout = _load_test_helper(
        "raptor_layout").write_raptor_layout

    cuda = torch.device("cuda")
    work = os.path.abspath(args.workdir)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    last_line = [time.perf_counter()]

    def emit(phase, fields):
        """Print one phase line; ``wall_s`` is the wall time since the
        previous one (the first counts from here), so the lines show
        where the run's time limit goes."""
        now = time.perf_counter()
        fields["wall_s"] = now - last_line[0]
        last_line[0] = now
        print(f"phase={phase} " + json.dumps(fields), flush=True)

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
    # the redesigned kernels' registers, spills and shared memory, as ptxas
    # reports them, and the extract blocks an SM holds at k 19, w 31
    ptxas = {}
    csrc = os.path.join(os.path.dirname(kernels.__file__), "csrc")
    procs = {src: subprocess.Popen(
        [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c",
         "-o", f"{so}.{src}.ptxas.o", os.path.join(csrc, src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src in ("extract.cu", "scan.cu", "count.cu", "select.cu",
                    "dedup.cu", "scatter.cu", "merge.cu", "bins.cu",
                    "psort.cu", "gprobe.cu")}
    for src, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc -Xptxas -v {src} failed:\n{err}")
        os.remove(f"{so}.{src}.ptxas.o")
        ptxas[src] = [ln.strip() for ln in err.splitlines()
                      if "registers" in ln or "spill" in ln
                      or "Compiling entry" in ln]
        print(f"ptxas -v {src}:\n  " + "\n  ".join(ptxas[src]), flush=True)
    extract_blocks = kernels.library().ganon_extract_blocks_per_sm(19, 31)
    print(f"extract: {extract_blocks} blocks of 128 threads an SM at k 19, "
          f"w 31", flush=True)
    emit("env", {
        "gpu": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "torch": torch.__version__, "torch_cuda": torch.version.cuda,
        "nvcc": nvcc.stdout.strip().splitlines()[-1],
        "kernel_build_s": build_s, "library": os.path.basename(so),
        "extract_blocks_per_sm": extract_blocks,
    })

    rows = []

    def compare(name, source, replaces, run_kernel, run_plain, reps,
                plain_reps, work, library=None, runs=0, counted_as=None):
        """Kernel against plain on the same card tensors (equal, or
        raise), both timed; ``work`` is the function's (bytes, ops) at
        these inputs, for the bound. ``library`` times the one PyTorch
        call that computes the same function, where there is one (else
        ``library_ms`` is null; PERF.md says why for each). With ``runs``,
        kernel and library are also timed over ``runs`` back-to-back
        calls (``device_ms``, ``library_device_ms``) and by the card's
        activity under torch.profiler (``profiled_ms``,
        ``library_profiled_ms``). ``counted_as`` names the launch counter
        of a row that times a kernel at another shape (default ``name``)."""
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
        if counted_as:
            rows[-1]["counted_as"] = counted_as
        if runs:
            rows[-1].update(
                device_ms=_ms_run(run_kernel, runs),
                library_device_ms=_ms_run(library, runs) if library else None,
                profiled_ms=_profiled_ms(run_kernel, runs),
                library_profiled_ms=(_profiled_ms(library, runs)
                                     if library else None))
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
    ibf.save_raw(db + ".ibf")
    _write_tax(db + ".tax", names, [f"G{t % 32}" for t in range(args.targets)])
    cfg = ibf.ibf_config
    bp = args.targets * args.genome_len
    emit("build", {
        "targets": args.targets, "bp": bp,
        "seconds": build_s, "extract_seconds": t_extract,
        "build_mbp_per_min": bp / 1e6 / (build_s / 60),
        "hashes": int(sum(len(h) for h in target_hashes.values())),
        "bin_size_bits": cfg.bin_size_bits, "hash_functions":
        cfg.hash_functions, "n_bins": cfg.n_bins,
        "bits_bytes": int(ibf.bits.nbytes),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": build_launches,
    })

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
        # and so runs without the zero tail; the row holds the kernel with
        # the tail against the plain version bit for bit, and the build's
        # mode (its time, its bound) against the plain version's first
        # n[b] slots a row
        en_plain = q.extract_plain(ein, L1=L0, L2=0, k=k, w=w, mc=emc)[1]
        npk = int(en_plain.sum())
        eh, en, _ = compare(
            "extract_build", "ganon_tpu_torch/csrc/extract.cu",
            "ganon_tpu/index/builder.py:156",
            lambda: q.extract(ein, L1=L0, L2=0, k=k, w=w, mc=emc,
                              counter="extract_build"),
            lambda: q.extract_plain(ein, L1=L0, L2=0, k=k, w=w, mc=emc), 10, 2,
            _extract_work(ein, L0, 0, w, en_plain, emc),
        )

        def build_mode():
            return q.extract(ein, L1=L0, L2=0, k=k, w=w, mc=emc,
                             counter="extract_build", zero_tail=False)

        bh, bn, _ = build_mode()
        if not (torch.equal(bn, en) and torch.equal(bh[_valid(bh, bn)],
                                                    eh[_valid(eh, en)])):
            raise AssertionError("extract_build: zero_tail=False differs "
                                 "from the plain version's first n slots")
        del bh, bn
        tail_ms, tail_bound = rows[-1]["ms"], rows[-1]["bound_ms"]
        nt_bound, nt_by = _bound(*_extract_work(ein, L0, 0, w, en_plain, emc,
                                                zero_tail=False))
        rows[-1].update(ms=_ms(build_mode, 10), bound_ms=nt_bound,
                        bound_by=nt_by, zero_tail_ms=tail_ms,
                        zero_tail_bound_ms=tail_bound)
        print(f"extract_build: {rows[-1]['ms']:.4f} ms without the zero "
              f"tail (bound {nt_bound:.4f}, {nt_by}), {tail_ms:.4f} with it "
              f"(bound {tail_bound:.4f}); {B0} pieces of {L0}", flush=True)
        compare("pack", "ganon_tpu_torch/csrc/sort.cu",
                "ganon_tpu/index/device_build.py:137",
                lambda: bo.pack_entries(eh, en, ekeys, npk),
                lambda: bo.pack_entries_plain(eh, en, ekeys, npk), 20, 5,
                # n and keys in, each emitted hash read once; entries out
                (_nbytes(en, ekeys) + npk * (8 + 12), npk), runs=20)
        del eh, en, t_in, ein
        gkey, gval = pipe._entries(group, arrays)
        N = group.n
        kb = group.key_bits
        # the library yardstick: torch.sort of (key << 38 | value), one
        # key per entry, since k = 19 values are below 2^38
        comp = (gkey.to(torch.int64) << 38) | gval
        # the sort's first step, held against bincount's digit by digit;
        # the wrapper plans its passes from these histograms, so the
        # digits it runs are the plan of the card's own (the constant
        # ones skipped)
        D = bo.sort_digits(kb)
        (card_hist,) = compare(
            "sort_hist", "ganon_tpu_torch/csrc/sort.cu",
            "ganon_tpu/ops/bigsort.py:31",
            lambda: (bo.sort_digit_histograms(gkey, gval, key_bits=kb),),
            lambda: (bo.sort_digit_histograms_plain(gkey, gval,
                                                    key_bits=kb),), 10, 3,
            # entries read once, the counts and offsets written; a digit
            # per entry
            (12 * N + 2 * D * bo.RADIX * 4, D * N))
        sort_digits = bo.sort_pass_plan(card_hist[0], key_bits=kb)
        sk, sv = compare(
            "sort", "ganon_tpu_torch/csrc/sort.cu",
            "ganon_tpu/ops/bigsort.py:31",
            lambda: bo.sort_entries(gkey, gval, key_bits=kb),
            lambda: bo.sort_entries_plain(gkey, gval, key_bits=kb), 10, 3,
            # entries read and written once; a digit per entry per pass
            (24 * N, len(sort_digits) * N),
            library=lambda: torch.sort(comp), runs=20,
        )
        rows[-1].update(passes=len(sort_digits), digits=sort_digits,
                        entries=N, files=len(group.files))
        print(f"sort: {len(sort_digits)} passes (digits {sort_digits}, "
              f"planned from the card's histograms) at the first pass-1 "
              f"group, {N} entries, {len(group.files)} files", flush=True)
        lib_sorted = torch.sort(comp).values
        if not (torch.equal(lib_sorted >> 38, sk.to(torch.int64))
                and torch.equal(lib_sorted & ((1 << 38) - 1), sv)):
            raise AssertionError("sort: torch.sort of the composite differs")
        del gkey, gval, comp, lib_sorted
        R0 = len(group.files)
        cnt = [torch.zeros(R0, dtype=torch.int32, device=cuda)
               for _ in range(2)]

        def counts_run(fn, c):
            c.zero_()
            fn(sk, sv, num_files=R0, counts=c, want_rank=False)
            return (c,)

        # pass 1's counts mode: the entries in, the counts out
        (gcounts,) = compare(
            "dedup", "ganon_tpu_torch/csrc/dedup.cu",
            "ganon_tpu/index/device_build.py:169",
            lambda: counts_run(bo.dedup, cnt[0]),
            lambda: counts_run(bo.dedup_plain, cnt[1]), 20, 5,
            (12 * N + 4 * R0, N), runs=20)
        counts_np = gcounts.cpu().numpy()
        if [int(c) for c in counts_np] != [ibf.hashes_count[rec.key[0]]
                                            for rec in group.files]:
            raise AssertionError("dedup: group counts differ from db.ibf's")

        def rank_run(fn):
            return fn(sk, sv, num_files=R0)

        # the rank mode (flags and ranks in one chained scan), which the
        # ranked scatter runs inside its own call: entries in, flags and
        # ranks out
        uq, rk = compare(
            "dedup_rank", "ganon_tpu_torch/csrc/dedup.cu",
            "ganon_tpu/index/device_build.py:157",
            lambda: rank_run(bo.dedup), lambda: rank_run(bo.dedup_plain),
            20, 5, (12 * N + 8 * N, N), runs=20)
        split = dbuild.target_bins(
            sizing.split_target_bins(cfg, ibf.hashes_count))
        params = np.zeros((4, R0), dtype=np.int32)
        for i, rec in enumerate(group.files):
            params[:, i] = (*split[rec.key[0]], 0, int(counts_np[:i].sum()))
        params_t = torch.from_numpy(params).to(cuda)
        rbits = [torch.zeros(ibf.bits.shape, dtype=torch.int32, device=cuda)
                 for _ in range(2)]
        # pass 2 as the pipeline calls it: the word columns of the group's
        # bins, the flags and ranks made in the call
        rk_kw = dict(bin_size=cfg.bin_size_bits,
                     hash_functions=cfg.hash_functions)
        cols = bo.ranked_word_cols(params, counts_np)
        compare("scatter_ranked", "ganon_tpu_torch/csrc/scatter.cu",
                "ganon_tpu/index/device_build.py:185",
                lambda: (bo.scatter_ranked(rbits[0], sk, sv, None, None,
                                           params_t, **rk_kw,
                                           word_cols=cols), rbits[0])[1:],
                lambda: (bo.scatter_ranked_plain(rbits[1], sk, sv, None, None,
                                                 params_t, **rk_kw),
                         rbits[1])[1:],
                10, 3,
                # entries and params in; each distinct word set, out; h
                # bits per distinct entry
                (_nbytes(sk, sv, params_t) + 4 * _ranked_words(
                    sk, sv, uq, rk, params_t, rbits[0].shape[1], **rk_kw),
                 int(uq.sum()) * cfg.hash_functions), runs=10)
        # span mode (K17): the second of four row shards of the matrix,
        # as the mesh build's scatter on four devices runs it
        nw = rbits[0].shape[1]
        rps = -(-cfg.bin_size_bits // 4)
        sbits = [torch.zeros((min(rps, cfg.bin_size_bits - rps), nw),
                             dtype=torch.int32, device=cuda)
                 for _ in range(2)]
        compare("scatter_span", "ganon_tpu_torch/csrc/scatter.cu",
                "ganon_tpu/index/device_build.py:308",
                lambda: (bo.scatter_ranked(sbits[0], sk, sv, None, None,
                                           params_t, **rk_kw, w0=rps * nw,
                                           word_cols=cols), sbits[0])[1:],
                lambda: (bo.scatter_ranked_plain(sbits[1], sk, sv, None, None,
                                                 params_t, **rk_kw,
                                                 w0=rps * nw), sbits[1])[1:],
                10, 3,
                # entries and params in; each distinct word of the span
                # set, out; h rows per distinct entry
                (_nbytes(sk, sv, params_t) + 4 * _ranked_words(
                    sk, sv, uq, rk, params_t, nw, **rk_kw,
                    rows_in=(rps, rps + sbits[0].shape[0])),
                 int(uq.sum()) * cfg.hash_functions), runs=10)
        if not torch.equal(sbits[0], rbits[0][rps:rps + sbits[0].shape[0]]):
            raise AssertionError("scatter_span: the span differs from the "
                                 "whole matrix's rows")
        del sk, sv, uq, rk, rbits, sbits, cnt, gcounts, arrays
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
    emit("build_custom", {
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
    })
    # build_acquire: `ganon build` and `update` through the CLI on a
    # local repository tree (local_dir) of the same genomes --------------------
    acq_launches, upd_launches = _build_acquire(args, work, genomes, ibf,
                                                names, emit)

    # the mesh build (K17): the same FASTA files through run_build with
    # four views of the card as the local devices, so the groups
    # round-robin over them and the scatter's matrix is cut into four row
    # spans (builder._build_mesh); saved raw, it must equal db.ibf
    cuda0 = torch.device("cuda", 0)
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _LocalDevices([cuda0] * 4):
        mibf = run_build(BuildConfig(
            input_file=bc_input, output_file=os.path.join(work, "mesh.ibf"),
            filter_format="tpu-raw", threads=8, device="cuda"))
    mesh_build_s = time.perf_counter() - t0
    mesh_build_launches = dict(kernels.LAUNCHES)
    if not (np.array_equal(mibf.bits, ibf.bits)
            and mibf.ibf_config.to_dict() == cfg.to_dict()):
        raise AssertionError("mesh build: the filter differs from db.ibf")
    if (mesh_build_launches["scatter_span"] <= 0
            or mesh_build_launches["scatter_ranked"] > 0):
        raise AssertionError(f"mesh build: not the span scatter: "
                             f"{mesh_build_launches}")
    os.remove(os.path.join(work, "mesh.ibf"))
    del mibf
    shutil.rmtree(bcin, ignore_errors=True)
    emit("mesh_build", {
        "devices": "4 views of cuda:0", "seconds": mesh_build_s,
        "mbp_per_min": bc_bp / 1e6 / (mesh_build_s / 60),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "equals_db_ibf": True, "launches": mesh_build_launches,
    })
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
    hibf.save_raw(host + ".hibf")
    ibf_b.save_raw(db_b + ".ibf")
    save_s = time.perf_counter() - t0
    _write_tax(host + ".tax", flat_forest_names,
               [f"H{i % 8}" for i in range(len(flat_forest_names))])
    _write_tax(db_b + ".tax", b_names,
               [f"G{i % 32}" for i in range(args.b_targets)])
    emit("build_hierarchy", {
        "forest_build_s": forest_s, "db_b_build_s": db_b_s,
        "save_raw_s": save_s,
        "forest_targets": len(flat_forest_names),
        "forest_bp": int(sum(n * args.forest_per_class for n in lengths)),
        "forest_subs": len(hibf.subs),
        "forest_sub_targets": [len(x.targets()) for x in hibf.subs],
        "forest_sub_bin_size_bits": [x.ibf_config.bin_size_bits
                                     for x in hibf.subs],
        "db_b_targets": args.b_targets, "db_b_shared_with_db": n_shared,
        "launches": hier_build_launches,
    })
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
        _extract_work(inbuf, L1, L2, w, None, mc),
    )
    bin_size, h = cfg.bin_size_bits, cfg.hash_functions
    (counts,) = compare(
        "count", "ganon_tpu_torch/csrc/count.cu",
        "ganon_tpu/ops/ibf_query.py:320",
        lambda: (q.bulk_target_counts_packed(
            f.tbl8, f.byte_starts, f.byte_ends, hashes, n_hashes,
            bin_size=bin_size, hash_functions=h),),
        lambda: (q.bulk_target_counts_packed_plain(
            f.tbl8, f.byte_starts, f.byte_ends, hashes, n_hashes,
            bin_size=bin_size, hash_functions=h),), 20, 3,
        _count_work(f.tbl8, hashes, n_hashes, bin_size, h,
                    args.bench_pairs * f.num_targets * 4),
        runs=20,
    )
    # sort_probes (a branch of K5): each read's hashes ordered by their
    # first row before count; the library yardstick sorts the same keys
    pkeys = q._probe_keys(hashes, n_hashes, bin_size=bin_size)
    M_c = hashes.shape[1]
    (sorted_h,) = compare(
        "probe_sort", "ganon_tpu_torch/csrc/psort.cu",
        "ganon_tpu/classify/device.py:375",
        lambda: (q.probe_sort(hashes, n_hashes, bin_size=bin_size),),
        lambda: (q.probe_sort_plain(hashes, n_hashes, bin_size=bin_size),),
        20, 5,
        # hashes and n in, hashes out; a comparison sort's M log2 M
        # compares per read
        (2 * _nbytes(hashes) + _nbytes(n_hashes),
         args.bench_pairs * M_c * max(1, (M_c - 1).bit_length())),
        library=lambda: torch.sort(pkeys, dim=1, stable=True), runs=20)

    def count_of(hs):
        return q.bulk_target_counts_packed(
            f.tbl8, f.byte_starts, f.byte_ends, hs, n_hashes,
            bin_size=bin_size, hash_functions=h)

    if not torch.equal(count_of(sorted_h), counts):
        raise AssertionError("count: sorted probes change the counts")
    # unsorted, sorted, sorted, unsorted in one call (the probe question
    # of scripts/probe_locality.py on this card)
    sort_probes_ms = [_ms(lambda: count_of(hs), 20)
                      for hs in (hashes, sorted_h, sorted_h, hashes)]
    # the sort_probes batch through classify_batch_packed: its buffer
    # equals the unsorted one (launches counted for the checks phase)
    kernels.reset_launches()
    sp_buf = dev.classify_batch_packed(
        f, inbuf, 0.75, 0.1, 65535, k=k, w=w, L1=L1, L2=L2, top_k=32,
        sort_probes=True)
    torch.cuda.synchronize()
    sp_launches = dict(kernels.LAUNCHES)
    if not torch.equal(sp_buf, dev.classify_batch_packed(
            f, inbuf, 0.75, 0.1, 65535, k=k, w=w, L1=L1, L2=L2, top_k=32)):
        raise AssertionError("classify_batch_packed: sort_probes changes "
                             "the buffer")
    del pkeys, sp_buf
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
        lambda: (q.bulk_target_counts_packed(*sub_args, out=fout_k.zero_(),
                                             **sub_kw),),
        lambda: (q.bulk_target_counts_packed_plain(
            *sub_args, out=fout_p.zero_(), **sub_kw),), 20, 3,
        _count_work(sub.tbl8, hashes, n_hashes, sub_kw["bin_size"],
                    sub_kw["hash_functions"],
                    args.bench_pairs * sub.num_targets * 4),
    )
    # the union step of the 2_refs level: db then db_b into 1024 + 448
    # columns, one level merge into buffers neither side fills
    counts_b = fb.counts(hashes, n_hashes)
    U = f.num_targets + fb.num_targets - n_shared
    colmap = dev.merge_colmap(
        [np.arange(f.num_targets),
         np.concatenate([np.arange(n_shared),
                         np.arange(f.num_targets, U)])], U, cuda)
    uk = [torch.empty((args.bench_pairs, U), dtype=torch.int32, device=cuda)
          for _ in range(4)]

    def union(fn, uc, uw):
        fn([counts, counts_b], n_hashes, [0.75, 0.75], 65535, colmap, uc,
           uw)
        return uc, uw

    ucounts, uwin = compare(
        "merge", "ganon_tpu_torch/csrc/merge.cu",
        "ganon_tpu/classify/device.py:542",
        lambda: union(dev.merge, uk[0], uk[1]),
        lambda: union(dev.merge_plain, uk[2], uk[3]), 20, 5,
        # both filters' counts, n and the map in; union counts and winners
        # out
        (_nbytes(counts, counts_b, n_hashes, colmap)
         + 2 * args.bench_pairs * U * 4,
         4 * args.bench_pairs * (counts.shape[1] + counts_b.shape[1])),
        runs=20,
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
    # the ragged stream of that buffer at the engine's cap (2 slots a
    # read); the yardstick is the scan alone, torch.cumsum of the flags
    B_ = args.bench_pairs
    rcap = 2 * B_
    dense = dev.select(*sel_args, top_k=K, emit_matches_t=False)
    nmatch = dense[B_ * K:B_ * K + B_]
    rflags = (torch.arange(K, device=cuda)[None, :]
              < nmatch[:, None]).reshape(-1).to(torch.int32)
    compare("ragged", "ganon_tpu_torch/csrc/scan.cu",
            "ganon_tpu/classify/device.py:280",
            lambda: (dev.ragged(dense, B_, K, rcap),),
            lambda: (dev.ragged_plain(dense, B_, K, rcap),), 20, 5,
            _ragged_work(dense, B_, K, rcap),
            library=lambda: torch.cumsum(rflags, 0), runs=200)
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
    udense = dev.select(*usel, top_k=KU, emit_matches_t=False, uwin=uwin)
    unmatch = udense[2 * B_ * KU:2 * B_ * KU + B_]
    uflags = (torch.arange(KU, device=cuda)[None, :]
              < unmatch[:, None]).reshape(-1).to(torch.int32)
    compare("ragged_winners", "ganon_tpu_torch/csrc/scan.cu",
            "ganon_tpu/classify/device.py:280",
            lambda: (dev.ragged(udense, B_, KU, rcap, has_win=True),),
            lambda: (dev.ragged_plain(udense, B_, KU, rcap, has_win=True),),
            20, 5, _ragged_work(udense, B_, KU, rcap, has_win=True),
            library=lambda: torch.cumsum(uflags, 0), runs=200)
    ragged_total = [int(torch.clamp(x, 0, kk).sum())
                    for x, kk in ((nmatch, K), (unmatch, KU))]
    del dense, udense, rflags, uflags
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

    # the chunk's bins' word columns, as build_ibf's flush passes them
    scols = (int(sb.min()) >> 5, (int(sb.max()) >> 5) + 1)

    def scatter_kernel():
        scatter_hashes(bits_k, sh, sb, bin_size=bin_size, hash_functions=h,
                       word_cols=scols)
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
            (_nbytes(sh, sb) + swords * 4, srows.numel()), runs=10)
    del srows
    # the Pallas gather probe's port at its own shapes (its run counted
    # for the checks phase; no PyTorch call gathers, popcounts and sums
    # by lane in one)
    from ganon_tpu_torch.ops import probe

    grng = np.random.default_rng(args.seed + 14)
    gtbl = torch.from_numpy(grng.integers(0, 256, size=(probe.R, probe.W8),
                                          dtype=np.uint8)).to(cuda)
    grows = torch.from_numpy(grng.integers(0, probe.R, size=probe.NPROBE)
                             .astype(np.int32)).to(cuda)
    kernels.reset_launches()
    probe.gather_probe(gtbl, grows)
    torch.cuda.synchronize()
    gprobe_launches = dict(kernels.LAUNCHES)
    compare("gather_probe", "ganon_tpu_torch/csrc/gprobe.cu",
            "scripts/pallas_gather_probe.py:28",
            lambda: (probe.gather_probe(gtbl, grows),),
            lambda: (probe.gather_probe_plain(gtbl, grows),), 20, 5,
            # the distinct rows probed, the rows and the lanes; a popcount
            # and an add per word
            (int(torch.unique(grows).numel()) * probe.W8 + _nbytes(grows)
             + 512, 16 * probe.NPROBE), runs=20)
    gprobe_ms, gprobe_card_ms = rows[-1]["ms"], rows[-1]["device_ms"]
    del gtbl, grows
    emit("kernels", {
        "pairs": args.bench_pairs, "L1": L1, "L2": L2, "mc": mc,
        "filter_load_s": load_s["db"],
        "filter_load_s_host_db_b": [load_s["host"], load_s["db_b"]],
        "table_bytes": int(f.tbl8.numel()),
        "forest_sub_col0": col0, "union_targets": U,
        "scatter_pairs": int(sh.numel()),
        "count_ms_unsorted_sorted_sorted_unsorted": sort_probes_ms,
        "sort_probes_buffer_equal": True,
        "ragged_cap": rcap, "ragged_entries": ragged_total,
        "gather_probe_rows_per_s": probe.NPROBE / (gprobe_ms / 1e3),
        "gather_probe_rows_per_s_card": probe.NPROBE / (gprobe_card_ms / 1e3),
        "equal": [r["name"] for r in rows],
        "ms": {r["name"]: [r["ms"], r["plain_ms"]] for r in rows},
    })
    del f, fh, fb, sub, sub_args, bits_k, bits_p, counts, counts_b, hashes
    del sorted_h
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
    cli_argv = ["--multiple-matches", "lca", "--output-one", "--output-all",
                "--output-unclassified", "--output-stats", "--skip-report"]
    engine_run = ("ganon_tpu_torch.classify.engine", "run_classify")
    with _CallTimes(engine_run) as ct:
        _run_cli(["ganon-tpu-torch", "classify", "--db-prefix", db,
                  "--paired-reads", fq1, fq2, "--output-prefix", out,
                  *cli_argv])
    cli_s = time.perf_counter() - t0
    cli_launches = dict(kernels.LAUNCHES)
    _transfer_line("classify", ct.results["run_classify"])
    if cli_launches["ragged"] <= 0:
        raise AssertionError("classify: the CLI run took no ragged stream")
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
    # every pair's true target in .all; the first pairs on the card and on
    # the CPU, while db's table is still in the filter cache
    found = {rid for rid, ts in _true_target_rows(out + ".all").items()
             if rid.split("|")[1] in ts}
    if len(found) != args.pairs:
        raise AssertionError(
            f"{args.pairs - len(found)} pairs lack their true target in .all")
    nc = args.check_pairs
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
    # classify_batch_packed on the card and on the filter moved to the
    # CPU (no repack), at 1024 pairs: dense, and a ragged cap it overflows
    fc = dev.load_device_filter(db + ".ibf", cuda)
    fcpu = fc.to("cpu")
    nb = 1024
    cb = EncodedBatch(prefix="", paired=True, ids=ids[:nb], codes1=r1[:nb],
                      len1=np.full(nb, args.read_len, np.int32),
                      codes2=r2[:nb], len2=np.full(nb, args.read_len,
                                                   np.int32))
    cin, cL1, cL2 = dev.pack_batch_direct(cb, nb)
    cap_checks = {}
    for cap in (0, nb // 2):
        bufs = [dev.classify_batch_packed(
            fx, torch.from_numpy(cin).to(fx.device), 0.75, 0.1, 65535, k=k,
            w=w, L1=cL1, L2=cL2, top_k=32, match_cap=cap).cpu()
            for fx in (fc, fcpu)]
        if not torch.equal(bufs[0], bufs[1]):
            raise AssertionError(f"classify_batch_packed: card and cpu "
                                 f"differ at match_cap {cap}")
        if cap:
            cap_checks["overflowed"] = dev.unpack_batch_result_ragged(
                bufs[0].numpy(), nb, cap, fc.num_targets, 32)["cap_overflow"]
    if not cap_checks["overflowed"]:
        raise AssertionError("classify_batch_packed: the small cap held")
    del fc, fcpu, bufs
    emit("classify", {
        "pairs": args.pairs, "seconds": cli_s,
        "reads_per_s": args.pairs / cli_s,
        "mbp_per_min": mbp / (cli_s / 60),
        "filter": "packed table cached in-process (load: phase kernels)",
        "launches": cli_launches,
        "profiled_split_s": timing,
        "profiled_device_busy_share":
            busy_us / 1e6 / timing["total"] if busy_us else None,
        "profiled_device_us": kernel_us,
        "pairs_with_true_target": len(found),
        "cuda_equals_cpu_pairs": nc,
        "cuda_equals_cpu_lines": {e: len(v) for e, v in subs["cuda"].items()},
        "batch_cuda_equals_cpu_match_caps": [0, nb // 2],
    })
    del found, subs

    # ops: the library API (K18) at the flat filter's width, while db's
    # packed table is cached -----------------------------------------------
    from ganon_tpu_torch.ops import library as lib

    t0 = time.perf_counter()
    bits_d = torch.from_numpy(ibf.bits.view(np.int32)).to(cuda)
    upload_s = time.perf_counter() - t0
    b2t = ibf.bin_to_target_ids()  # [32 n_words], padding bins T
    T_db = len(ibf.targets())
    perm, starts, ends = lib.target_segments(b2t, T_db)
    seg = [torch.from_numpy(x).to(cuda) for x in (starts, ends)]
    perm_d = (None if perm is None else
              torch.from_numpy(perm.astype(np.int32)).to(cuda))
    b2t_d = torch.from_numpy(b2t).to(cuda)
    _, o1, o2 = _sample_pairs(np.random.default_rng(args.seed + 2), genomes,
                              args.bench_pairs, args.read_len)
    ocodes = torch.from_numpy(np.concatenate([o1, o2])).to(cuda)
    nr = ocodes.shape[0]
    olens = torch.full((nr,), args.read_len, dtype=torch.int32, device=cuda)
    mm = args.read_len - w + 1  # every window: nothing is cut
    kernels.reset_launches()
    t0 = time.perf_counter()
    oh, on = lib.minimizers(ocodes, olens, k=k, w=w, max_minimizers=mm)
    orows = lib.ibf_row_indices(oh, bin_size=bin_size, hash_functions=h)
    omask = torch.arange(mm, device=cuda)[None, :] < on[:, None]
    obins = lib.bulk_count_bins(bits_d, orows, omask)
    otc = lib.target_counts(obins, b2t_d, num_targets=T_db)
    obtc = lib.bulk_target_counts(bits_d, orows, omask, *seg, perm_d)
    torch.cuda.synchronize()
    ops_s = time.perf_counter() - t0
    ops_launches = dict(kernels.LAUNCHES)
    f = dev.load_device_filter(db + ".ibf", cuda)
    packed_tc = q.bulk_target_counts_packed(
        f.tbl8, f.byte_starts, f.byte_ends, oh, on, bin_size=bin_size,
        hash_functions=h, clamp=False)
    if not (torch.equal(otc, obtc) and torch.equal(otc, packed_tc)):
        raise AssertionError("ops: target_counts, bulk_target_counts and "
                             "the packed count differ")
    if f.targets != ibf.targets() or not int(otc.sum()):
        raise AssertionError("ops: the target orders differ or nothing "
                             "counted")
    nvalid = int(omask.sum())
    ob_rows = int(torch.unique(orows[omask]).numel())
    Wd = bits_d.shape[1]
    TB = Wd * 32
    compare("minimizers", "ganon_tpu_torch/csrc/extract.cu",
            "ganon_tpu/ops/minimizers.py:134",
            lambda: lib.minimizers(ocodes, olens, k=k, w=w,
                                   max_minimizers=mm),
            lambda: lib.minimizers_plain(ocodes, olens, k=k, w=w,
                                         max_minimizers=mm), 20, 3,
            # ranks and lengths in, hashes and n out; the extract kernel's
            # INT32 operations a window of these lengths
            (_nbytes(ocodes, olens, oh, on),
             int(torch.clamp(torch.clamp(olens.to(torch.int64),
                                         max=ocodes.shape[1]) - w + 1,
                             min=0).sum()) * EXTRACT_OPS_PER_POSITION,
             INT32_OPS_PER_S))
    compare("bins", "ganon_tpu_torch/csrc/bins.cu",
            "ganon_tpu/ops/ibf_query.py:113",
            lambda: (lib.bulk_count_bins(bits_d, orows, omask),),
            lambda: (lib.bulk_count_bins_plain(bits_d, orows, omask),), 10, 3,
            # the distinct rows probed, rows and mask in, [B, 32 W] out; an
            # AND per row word and an add per bit
            (ob_rows * Wd * 4 + _nbytes(orows, omask, obins),
             nvalid * Wd * (h + 32)), runs=20)
    onehot = torch.nn.functional.one_hot(
        b2t_d.to(torch.int64), T_db + 1).to(torch.float32)
    obins_f = obins.to(torch.float32)
    compare("tsum", "ganon_tpu_torch/csrc/bins.cu",
            "ganon_tpu/ops/ibf_query.py:137",
            lambda: (lib.target_counts(obins, b2t_d, num_targets=T_db),),
            lambda: (lib.target_counts_plain(obins, b2t_d,
                                             num_targets=T_db),), 20, 5,
            # the per-bin counts and the map in, [B, T] out; an add a bin
            (_nbytes(obins, b2t_d, otc), obins.numel()),
            # JAX's own form: f32 counts by the one-hot map (exact below
            # 2^24, and no int64 out)
            library=lambda: torch.matmul(obins_f, onehot), runs=20)
    compare("bins_target", "ganon_tpu_torch/csrc/bins.cu",
            "ganon_tpu/ops/ibf_query.py:470",
            lambda: (lib.bulk_target_counts(bits_d, orows, omask, *seg,
                                            perm_d),),
            lambda: (lib.bulk_target_counts_plain(bits_d, orows, omask, *seg,
                                                  perm_d),), 10, 3,
            (ob_rows * Wd * 4 + _nbytes(orows, omask, otc, *seg),
             nvalid * Wd * (h + 32) + nr * TB), runs=20)
    emit("ops", {
        "reads": nr, "max_minimizers": mm, "bits_bytes": int(ibf.bits.nbytes),
        "upload_s": upload_s, "n_words": Wd, "targets": T_db,
        "perm_identity": perm is None, "valid_hashes": nvalid,
        "chain_s": ops_s, "launches": ops_launches,
        "equal_to_packed_count": True,
        "ms": {r["name"]: [r["ms"], r["plain_ms"]] for r in rows[-4:]},
    })
    del bits_d, oh, on, orows, omask, obins, otc, obtc, packed_tc, onehot
    del obins_f, ocodes, seg, perm_d, b2t_d, f
    torch.cuda.empty_cache()

    # extract_wide: windows past a tile's shared memory (k 19, w 18,104)
    # take extract's one-thread-a-read route on the card. 48 pairs of
    # 20-40 kbp mates from the genomes, paired against the plain version
    # (with the zero tail) and single-end in the build's mode (the first
    # n slots); then the ops library's minimizers at that w, the entry
    # point a user calls (its launches count for the checks phase)
    ww_, wB = 18_104, 48
    if not q.extract_is_wide(k, ww_) or q.extract_is_wide(k, ww_ - 1):
        raise AssertionError("extract_wide: the route's threshold moved")
    wrng = np.random.default_rng(args.seed + 11)
    wlen = 40_000
    wl1 = wrng.integers(20_000, wlen + 1, size=wB).astype(np.int32)
    wl2 = wrng.integers(20_000, wlen + 1, size=wB).astype(np.int32)
    wt = wrng.integers(0, args.targets, size=wB)
    wp = wrng.integers(0, args.genome_len - wlen, size=(wB, 2))
    wc1 = np.stack([genomes[t, a:a + wlen] for t, (a, _) in zip(wt, wp)])
    wc2 = np.stack([3 - genomes[t, b:b + wlen][::-1]
                    for t, (_, b) in zip(wt, wp)])
    for c_, l_ in ((wc1, wl1), (wc2, wl2)):
        c_[np.arange(wlen)[None, :] >= l_[:, None]] = 0
    wids = [str(i) for i in range(wB)]
    wbuf, wL1, wL2 = dev.pack_batch_direct(EncodedBatch(
        prefix="", paired=True, ids=wids, codes1=wc1, len1=wl1,
        codes2=np.ascontiguousarray(wc2), len2=wl2), wB)
    wbuf = torch.from_numpy(wbuf).to(cuda)
    wmc = dev.compact_width((wL1 - ww_ + 1) + (wL2 - ww_ + 1))
    compare("extract_wide", "ganon_tpu_torch/csrc/extract.cu",
            "ganon_tpu/ops/minimizers.py:245",
            lambda: q.extract(wbuf, L1=wL1, L2=wL2, k=k, w=ww_, mc=wmc),
            lambda: q.extract_plain(wbuf, L1=wL1, L2=wL2, k=k, w=ww_,
                                    mc=wmc), 5, 2,
            _extract_work(wbuf, wL1, wL2, ww_, None, wmc))
    sbuf, sL1, _ = dev.pack_batch_direct(EncodedBatch(
        prefix="", paired=False, ids=wids, codes1=wc1, len1=wl1), wB)
    sbuf = torch.from_numpy(sbuf).to(cuda)
    smc = sL1 - ww_ + 1
    sh_, sn_, so_ = q.extract(sbuf, L1=sL1, L2=0, k=k, w=ww_, mc=smc,
                              zero_tail=False)
    ph_, pn_, po_ = q.extract_plain(sbuf, L1=sL1, L2=0, k=k, w=ww_, mc=smc)
    if not (torch.equal(sn_, pn_) and torch.equal(so_, po_) and torch.equal(
            sh_[_valid(sh_, sn_)], ph_[_valid(ph_, pn_)])):
        raise AssertionError("extract_wide: zero_tail=False differs from "
                             "the plain version's first n slots")
    wcodes = torch.from_numpy(np.ascontiguousarray(wc1)).to(cuda)
    wlens_d = torch.from_numpy(wl1).to(cuda)
    kernels.reset_launches()
    wh_, wn_ = lib.minimizers(wcodes, wlens_d, k=k, w=ww_, max_minimizers=64)
    torch.cuda.synchronize()
    wide_launches = dict(kernels.LAUNCHES)
    want_ = lib.minimizers_plain(wcodes, wlens_d, k=k, w=ww_,
                                 max_minimizers=64)
    if not (torch.equal(wh_, want_[0]) and torch.equal(wn_, want_[1])):
        raise AssertionError("extract_wide: ops.minimizers differs from "
                             "its plain version")
    if wide_launches["extract_wide"] != 1 or wide_launches["minimizers"]:
        raise AssertionError("extract_wide: ops.minimizers at a wide "
                             "window did not take the wide route")
    emit("extract_wide", {
        "k": k, "w": ww_, "pairs": wB, "L1": wL1, "L2": wL2, "mc": wmc,
        "emitted_mean": float(wn_.float().mean()),
        "ms": rows[-1]["ms"], "plain_ms": rows[-1]["plain_ms"],
        "launches": wide_launches,
    })
    del wbuf, sbuf, sh_, sn_, so_, ph_, pn_, po_, wcodes, wlens_d, wh_, wn_
    del want_, wc1, wc2

    # mesh: the (batch, bins) device mesh (K17) over eight views of the
    # card, while db's packed table is still in the filter cache -----------
    from ganon_tpu_torch.cli import main as cli_main
    from ganon_tpu_torch.parallel import mesh as pmesh

    mesh8 = pmesh.make_mesh([cuda0] * 8)  # (batch 2, bins 4)
    f = dev.load_device_filter(db + ".ibf", cuda)
    t0 = time.perf_counter()
    fm = f.with_mesh(mesh8)  # cut on the card from the packed table
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    B = args.bench_pairs
    _, m1, m2 = _sample_pairs(np.random.default_rng(args.seed + 2), genomes,
                              B, args.read_len)
    mlens = np.full(B, args.read_len, np.int32)
    mbatch = EncodedBatch(prefix="", paired=True, ids=[str(i) for i in
                                                        range(B)],
                          codes1=m1, len1=mlens, codes2=m2, len2=mlens)
    min_np, mL1, mL2 = dev.pack_batch_direct(mbatch, B)
    mh, mn, _ = dev._extract_compact(torch.from_numpy(min_np).to(cuda), k=k,
                                     w=w, L1=mL1, L2=mL2)
    single = f.counts(mh, mn)
    if not torch.equal(fm.counts(mh, mn), single):
        raise AssertionError("mesh: sharded counts differ from one device's")
    # ShardedClassifier (the JAX package's API, single-end codes) on the
    # mates 1, against the single-device filter on the same minimizers
    sc = pmesh.ShardedClassifier(f, mesh8)
    sc_c, sc_n = sc.counts(m1, mlens)
    sbatch = EncodedBatch(prefix="", paired=False, ids=mbatch.ids, codes1=m1,
                          len1=mlens, codes2=np.zeros((B, 0), np.uint8),
                          len2=np.zeros(B, np.int32))
    sin_np, sL1, _ = dev.pack_batch_direct(sbatch, B)
    sh_, sn_, _ = q.extract(torch.from_numpy(sin_np).to(cuda), L1=sL1, L2=0,
                            k=k, w=w, mc=sL1 - w + 1)
    if not (torch.equal(sc_c, f.counts(sh_, sn_)) and torch.equal(sc_n, sn_)):
        raise AssertionError("mesh: ShardedClassifier differs from one "
                             "device's counts")
    del sc, sc_c, sc_n, sh_, sn_, sbatch, sin_np
    # count_shard and combine against their plain versions at the
    # engine's shapes on this mesh: batch row 0 (half of 8192 pairs) and
    # its four column shards of the 1024-target table
    tab, Bh, T = fm.table, B // 2, f.num_targets
    h0, n0 = mh[:Bh].contiguous(), mn[:Bh].contiguous()
    sh0 = tab.shards[0][0]
    ckw = dict(bin_size=cfg.bin_size_bits, hash_functions=cfg.hash_functions,
               clamp=False)
    compare("count_shard", "ganon_tpu_torch/csrc/count.cu",
            "ganon_tpu/parallel/mesh.py:79",
            lambda: (q.bulk_target_counts_packed(
                sh0.tbl8, sh0.byte_starts, sh0.byte_ends, h0, n0, **ckw),),
            lambda: (q.bulk_target_counts_packed_plain(
                sh0.tbl8, sh0.byte_starts, sh0.byte_ends, h0, n0, **ckw),),
            20, 3,
            _count_work(sh0.tbl8, h0, n0, cfg.bin_size_bits,
                        cfg.hash_functions, Bh * tab.widths[0] * 4))
    # poisoned: count in shard mode stores every cell of its block
    parts = torch.full((Bh * sum(tab.widths),), -1, dtype=torch.int32,
                       device=cuda)
    dense = torch.zeros((len(tab.widths), Bh, T), dtype=torch.int32,
                        device=cuda)
    off = 0
    for j, (s_, w_) in enumerate(zip(tab.shards[0], tab.widths)):
        if w_:
            blk = parts[off:off + Bh * w_].view(Bh, w_)
            q.bulk_target_counts_packed(s_.tbl8, s_.byte_starts,
                                        s_.byte_ends, h0, n0, out=blk, **ckw)
            dense[j, :, s_.t_lo:s_.t_hi] = blk
        off += Bh * w_
    lo, hi = tab.spans  # host tensors: the kernel takes them by value
    # poisoned: combine stores every column in flat mode
    couts = [torch.full((Bh, T), -1, dtype=torch.int32, device=cuda)
             for _ in range(2)]
    (comb,) = compare(
        "combine", "ganon_tpu_torch/csrc/shard.cu",
        "ganon_tpu/classify/device.py:749",
        lambda: (q.combine(parts, lo, hi, n0, couts[0], num_targets=T),),
        lambda: (q.combine_plain(parts, lo, hi, n0, couts[1],
                                 num_targets=T),), 20, 5,
        # the partials, spans and n in; [B, T] out; an add per shard per
        # element
        (_nbytes(parts, lo, hi, n0) + Bh * T * 4, Bh * T * len(tab.widths)),
        # one PyTorch call: the sum over the shard axis of the partials
        # laid out dense ([shards, B, T]; the clamp is a second call)
        library=lambda: torch.sum(dense, dim=0), runs=20)
    if not torch.equal(comb, single[:Bh]):
        raise AssertionError("combine: differs from one device's counts")
    spans = [(s_.t_lo, s_.t_hi) for s_ in tab.shards[0]]
    del fm, tab, parts, dense, couts, comb, h0, n0, sh0, single, mh, mn
    torch.cuda.empty_cache()

    def drop_meshed():
        """Forget the sharded filters (they serve this phase only), so the
        single-device ones the later phases reload stay cached."""
        for key_ in [k_ for k_ in dev._FILTER_CACHE if len(k_) > 3]:
            del dev._FILTER_CACHE[key_]
        torch.cuda.empty_cache()

    # the engine on the mesh: the classify phase's pairs through the CLI
    # with eight views of the card as the local devices; its files must
    # equal that phase's (rows sorted, .sta byte for byte)
    mout = os.path.join(work, "mout")
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _LocalDevices([cuda0] * 8):
        _run_cli(["ganon-tpu-torch", "classify", "--db-prefix", db,
                  "--paired-reads", fq1, fq2, "--output-prefix", mout,
                  *cli_argv])
    mesh_cli_s = time.perf_counter() - t0
    mesh_launches = dict(kernels.LAUNCHES)
    mesh_peak = torch.cuda.max_memory_allocated()
    drop_meshed()
    if (mesh_launches["count_shard"] <= 0 or mesh_launches["combine"] <= 0
            or mesh_launches["count"] > 0):
        raise AssertionError(f"mesh: the engine did not shard: "
                             f"{mesh_launches}")
    for ext in (".rep", ".all", ".one", ".unc", ".sta"):
        same = (open(out + ext, "rb").read() == open(mout + ext, "rb").read()
                if ext == ".sta" else
                _sorted_rows(out + ext) == _sorted_rows(mout + ext))
        if not same:
            raise AssertionError(f"mesh: the meshed CLI run differs in {ext}")
    # the forest level at a smaller read count, one card and the mesh
    nfp = 4 * args.check_pairs
    frng = np.random.default_rng(args.seed + 11)
    fparts = [_sample_pairs(frng, g, nfp // 4, args.read_len) for g in forest]
    ff1, ff2 = (os.path.join(work, f"mf{m}.fq") for m in (1, 2))
    fids = [b"f%d" % i for i in range(4 * (nfp // 4))]
    _write_fastq(ff1, fids, np.concatenate([x[1] for x in fparts]))
    _write_fastq(ff2, fids, np.concatenate([x[2] for x in fparts]))
    fouts = {}
    for tag, devs in (("single", None), ("mesh", [cuda0] * 8)):
        d = os.path.join(work, f"mforest_{tag}")
        os.makedirs(d)
        kernels.reset_launches()
        with _LocalDevices(devs or [cuda0]):
            _run_cli(["ganon-tpu-torch", "classify", "--db-prefix", host,
                      "--paired-reads", ff1, ff2, "--output-prefix",
                      os.path.join(d, "o"), *cli_argv])
        fouts[tag] = _output_files(d)
    mesh_forest_launches = dict(kernels.LAUNCHES)
    drop_meshed()
    if fouts["single"] != fouts["mesh"]:
        raise AssertionError("mesh: the forest level differs on the mesh")
    if mesh_forest_launches["count_forest"] > 0 or (
            mesh_forest_launches["count_shard"] <= 0):
        raise AssertionError(f"mesh: the forest did not shard: "
                             f"{mesh_forest_launches}")
    # --distributed: two processes on the one card (gloo: init and one
    # closing barrier), two read files each of nfp pairs, against one
    # process's run of the same files
    drng = np.random.default_rng(args.seed + 12)
    dfiles = []
    for i in range(2):
        dparts = [_sample_pairs(drng, g, nfp // 4, args.read_len)
                  for g in forest]
        dids = [b"d%d_%d" % (i, j) for j in range(4 * (nfp // 4))]
        for m in (1, 2):
            p_ = os.path.join(work, f"dist{i}_{m}.fq")
            _write_fastq(p_, dids, np.concatenate([x[m] for x in dparts]))
            dfiles.append(p_)
    dkw = dict(db_prefix=[host], paired_reads=dfiles, multiple_matches="lca",
               output_one=True, output_all=True, output_unclassified=True,
               skip_report=True, quiet=True)
    dsolo, ddist = os.path.join(work, "dsolo"), os.path.join(work, "ddist")
    cli_main("classify", device="cuda", output_prefix=dsolo, **dkw)
    code = ("from ganon_tpu_torch.cli import main\n"
            f"assert main('classify', output_prefix={ddist!r}, "
            f"distributed=True, **{dkw!r})\n")
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 WORLD_SIZE="2", RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(2)]
    try:
        douts = [p_.communicate(timeout=300) for p_ in procs]
    finally:
        for p_ in procs:
            if p_.poll() is None:
                p_.kill()
                p_.wait()
    dist_s = time.perf_counter() - t0
    for p_, (_, err) in zip(procs, douts):
        if p_.returncode != 0:
            raise AssertionError(f"--distributed rank exited {p_.returncode}:"
                                 f" {err.decode()[-2000:]}")
    for ext in (".all", ".one", ".unc"):
        shards_ = [_sorted_rows(f"{ddist}.h{r}{ext}") for r in range(2)]
        if ext == ".all" and not all(shards_):
            raise AssertionError("--distributed: a rank classified nothing")
        if sorted(shards_[0] + shards_[1]) != _sorted_rows(dsolo + ext):
            raise AssertionError(f"--distributed: the ranks' {ext} differ "
                                 "from one process's")
    emit("mesh", {
        "mesh": mesh8.shape, "devices": "8 views of cuda:0",
        "shard_cut_s": shard_s, "shard_target_spans": spans,
        "sharded_counts_pairs": B, "sharded_equals_single": True,
        "cli_pairs": args.pairs, "cli_seconds": mesh_cli_s,
        "cli_reads_per_s": args.pairs / mesh_cli_s,
        "cli_single_seconds": cli_s, "cli_equals_single": True,
        "max_memory_allocated": mesh_peak, "launches": mesh_launches,
        "forest_pairs": len(fids), "forest_equals_single": True,
        "forest_launches": mesh_forest_launches,
        "distributed": {"ranks": 2, "pairs": 2 * len(fids),
                        "seconds": dist_s, "union_equals_single": True},
    })

    # longreads: the 32-bit counter layout at the CLI's default flags -------
    # (a) the length mix and ultra-long reads against db, --longreads
    LONG = (1 << 32) - 1
    lrng = np.random.default_rng(args.seed + 7)
    lids, lseqs, ucodes = _long_read_mix(lrng, genomes, names, args.long_reads,
                                         args.ultra_reads, args.ultra_len)
    lfq = os.path.join(work, "long.fq")
    _write_fastq_seqs(lfq, lids, lseqs)
    lbp = sum(len(s) for s in lseqs)
    # select32 at the ultra-long batch: its counts pass 0xFFFF
    f = dev.load_device_filter(db + ".ibf", cuda)
    nu = args.ultra_reads
    ubatch = EncodedBatch(prefix="", paired=False,
                          ids=[str(i) for i in range(nu)], codes1=ucodes,
                          len1=np.full(nu, args.ultra_len, np.int32),
                          codes2=np.zeros((nu, 0), np.uint8),
                          len2=np.zeros(nu, np.int32))
    uin_np, uL1, uL2 = dev.pack_batch_direct(ubatch, nu)
    # extract at the long-read shapes: the ultra-long batch at every window
    # position (2^20-base rows), and one batch of the mix's 16 kbp bucket
    # at the engine's bp budget (8192 x 1024 bp) and compaction width
    uin = torch.from_numpy(uin_np).to(cuda)
    umc = uL1 - w + 1
    uh, un, uo = compare(
        "extract_ultra_long", "ganon_tpu_torch/csrc/extract.cu",
        "ganon_tpu/ops/minimizers.py:245",
        lambda: q.extract(uin, L1=uL1, L2=uL2, k=k, w=w, mc=umc),
        lambda: q.extract_plain(uin, L1=uL1, L2=uL2, k=k, w=w, mc=umc), 5, 1,
        _extract_work(uin, uL1, uL2, w, None, umc), counted_as="extract")
    rank = np.zeros(256, np.uint8)
    rank[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    mix_len = MIX_LENS[-1]
    mseqs = [x for x in lseqs if len(x) == mix_len]
    nm_ = min(len(mseqs), 8192 * 1024 // dev.bucket_len(mix_len))
    mcodes = rank[np.frombuffer(b"".join(mseqs[:nm_]), np.uint8)].reshape(
        nm_, mix_len)
    mix_in, xL1, xL2 = dev.pack_batch_direct(EncodedBatch(
        prefix="", paired=False, ids=[str(i) for i in range(nm_)],
        codes1=mcodes, len1=np.full(nm_, mix_len, np.int32),
        codes2=np.zeros((nm_, 0), np.uint8), len2=np.zeros(nm_, np.int32)),
        nm_)
    mix_in = torch.from_numpy(mix_in).to(cuda)
    xmc = dev.compact_width(xL1 - w + 1)
    compare("extract_mixed_long", "ganon_tpu_torch/csrc/extract.cu",
            "ganon_tpu/ops/minimizers.py:245",
            lambda: q.extract(mix_in, L1=xL1, L2=xL2, k=k, w=w, mc=xmc),
            lambda: q.extract_plain(mix_in, L1=xL1, L2=xL2, k=k, w=w,
                                    mc=xmc), 10, 2,
            _extract_work(mix_in, xL1, xL2, w, None, xmc),
            counted_as="extract")
    rows[-2].update(reads=nu, L=uL1, mc=umc)
    rows[-1].update(reads=nm_, L=xL1, mc=xmc)
    print(f"extract at long-read shapes: {nu} x {uL1} (mc {umc}) "
          f"{rows[-2]['ms']:.3f} ms; {nm_} x {xL1} (mc {xmc}) "
          f"{rows[-1]['ms']:.3f} ms", flush=True)
    del uin, mix_in, mcodes, mseqs
    ucounts = f.counts(uh, un)
    usel32 = (ucounts, un, uo, 0.75, 0.1, LONG)
    K32u = min(32, f.num_targets)
    got = dev.select(*usel32, top_k=K32u, emit_matches_t=False, pack16=False)
    want = dev._pack_result(dev.threshold_topk(
        *usel32[:2], *usel32[3:], top_k=K32u, emit_matches_t=False,
        pack16=False), un, uo.to(torch.int32), pack16=False)
    if not torch.equal(got, want):
        raise AssertionError("select32 != plain at the ultra-long batch "
                             f"(max error {_max_abs_err(got, want)})")
    if int(ucounts.max()) <= 0xFFFF or int(un.min()) <= 0xFFFF:
        raise AssertionError("ultra-long reads: counts do not pass 0xFFFF")
    ultra_ms = [_ms(lambda: dev.select(*usel32, top_k=K32u,
                                       emit_matches_t=False, pack16=False),
                    20),
                _ms(lambda: dev.threshold_topk(
                    *usel32[:2], *usel32[3:], top_k=K32u,
                    emit_matches_t=False, pack16=False), 5)]
    ultra_n = [int(un.min()), int(un.max())]
    del f, uh, un, uo, ucounts, usel32, got, want, ubatch, uin_np
    torch.cuda.empty_cache()
    # the CLI at default flags (em, the report chained from db.tax):
    # reads/s, the engine's split, reassign and report, peak card memory
    lout = os.path.join(work, "lout")
    timers = (("ganon_tpu_torch.classify.engine", "run_classify"),
              ("ganon_tpu_torch.reassign", "reassign"),
              ("ganon_tpu_torch.report.report", "report"))
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _CallTimes(*timers) as lt:
        _run_cli(["ganon-tpu-torch", "classify", "--db-prefix", db,
                  "--single-reads", lfq, "--output-prefix", lout,
                  "--longreads"])
    l_s = time.perf_counter() - t0
    l_launches = dict(kernels.LAUNCHES)
    l_peak = torch.cuda.max_memory_allocated()
    if sorted(fn for fn in os.listdir(work) if fn.startswith("lout.")
              ) != ["lout.rep", "lout.tre"]:
        raise AssertionError("longreads: default flags should leave .rep "
                             "and .tre")
    if l_launches["select32"] <= 0 or l_launches["select"] > 0:
        raise AssertionError(f"longreads: not the 32-bit layout: {l_launches}")
    n_rand = sum(rid.split(b"|")[1] == b"rnd" for rid in lids)
    with open(lout + ".rep") as fh_:
        l_classified = next(int(line.split("\t")[1]) for line in fh_
                            if line.startswith("#total_classified"))
    if l_classified != len(lids) - n_rand:
        raise AssertionError(f"longreads: {l_classified} classified, want "
                             f"{len(lids) - n_rand}")
    # again with --output-all (em deletes .all otherwise), profiled
    lout2 = os.path.join(work, "lall")
    with _CallTimes(*timers[:1]) as lt2, torch.profiler.profile(
            activities=acts) as prof:
        _run_cli(["ganon-tpu-torch", "classify", "--db-prefix", db,
                  "--single-reads", lfq, "--output-prefix", lout2,
                  "--longreads", "--output-all"])
    ltiming = lt2.results["run_classify"]["timing"]
    lbusy_us, lkernel_us = _device_busy(prof)
    lall = _true_target_rows(lout2 + ".all")
    lbad = {"sampled": 0, "ultra": 0, "random": 0}
    for rid in lids:
        rid = rid.decode()
        t = rid.split("|")[1]
        if t == "rnd":
            lbad["random"] += rid in lall
        else:
            lbad["ultra" if rid[0] == "u" else "sampled"] += (
                t not in lall.get(rid, ()))
    if any(lbad.values()):
        raise AssertionError(f"long reads misplaced: {lbad}")
    # without --longreads the ultra-long reads are skipped as big
    skip_n = 1000
    normal = [i for i, rid in enumerate(lids) if rid[:1] == b"l"][:skip_n]
    ultra = [i for i, rid in enumerate(lids) if rid[:1] == b"u"]
    sfq = os.path.join(work, "skip.fq")
    _write_fastq_seqs(sfq, [lids[i] for i in normal + ultra],
                      [lseqs[i] for i in normal + ultra])
    sout = os.path.join(work, "skip")
    _run_cli(["ganon-tpu-torch", "classify", "--db-prefix", db,
              "--single-reads", sfq, "--output-prefix", sout, "--output-all",
              "--output-stats", "--skip-report"])
    skipped = len(normal) + len(ultra) - int(_sta_row(sout + ".sta")[
        "seq_processed"])
    if skipped != len(ultra) or any(
            rid.startswith("u") for rid in _true_target_rows(sout + ".all")):
        raise AssertionError(f"without --longreads: {skipped} reads skipped,"
                             f" want the {len(ultra)} ultra-long ones")

    # (b) a flat filter just past the 16-bit bound: wide targets x 4 kbp
    wrng = np.random.default_rng(args.seed + 8)
    wgen = wrng.integers(0, 4, size=(args.wide_targets, args.wide_genome_len),
                         dtype=np.uint8)
    wnames = [f"W{t}" for t in range(args.wide_targets)]
    kernels.reset_launches()
    t0 = time.perf_counter()
    wibf = build_ibf(_hashes(zip(wnames, wgen), k, w, cuda), kmer_size=k,
                     window_size=w, max_fp=0.05, device=cuda)
    torch.cuda.synchronize()
    w_build_s = time.perf_counter() - t0
    w_build_launches = dict(kernels.LAUNCHES)
    wdb = os.path.join(work, "wide")
    wibf.save(wdb + ".ibf")
    _write_tax(wdb + ".tax", wnames,
               [f"WG{t % 256}" for t in range(args.wide_targets)],
               args.wide_genome_len)
    wcol = {t: i for i, t in enumerate(wibf.targets())}
    if len(wcol) <= 0xFFFF:
        raise AssertionError("the wide filter has at most 65,535 targets")
    wbits = wibf.bits
    wb2t = wibf.bin_to_target_ids()
    wcfg = wibf.ibf_config
    del wibf
    # select32 at T = wide targets, K = 4 (the adaptive start past 4096
    # targets), 8192 pairs
    fw = dev.load_device_filter(wdb + ".ibf", cuda)
    _, a_, b_ = _sample_pairs(np.random.default_rng(args.seed + 10), wgen,
                              args.bench_pairs, args.read_len)
    wlens = np.full(args.bench_pairs, args.read_len, np.int32)
    wbatch = EncodedBatch(prefix="", paired=True,
                          ids=[str(i) for i in range(args.bench_pairs)],
                          codes1=a_, len1=wlens, codes2=b_, len2=wlens)
    win_np, wL1, wL2 = dev.pack_batch_direct(wbatch, args.bench_pairs)
    wh, wn, wo = q.extract(torch.from_numpy(win_np).to(cuda), L1=wL1, L2=wL2,
                           k=k, w=w, mc=dev.compact_width(2 * (wL1 - w + 1)))
    wcounts = fw.counts(wh, wn)
    K32 = min(4, fw.num_targets)
    wsel = (wcounts, wn, wo, 0.75, 0.1, 65535)
    compare(
        "select32", "ganon_tpu_torch/csrc/select.cu",
        "ganon_tpu/classify/device.py:801",
        lambda: (dev.select(*wsel, top_k=K32, emit_matches_t=False,
                            pack16=False),),
        lambda: (dev._pack_result(
            dev.threshold_topk(*wsel[:2], *wsel[3:], top_k=K32,
                               emit_matches_t=False, pack16=False),
            wn, wo.to(torch.int32), pack16=False),), 20, 3,
        # counts, n, overflow in; the two [B*K] blocks, the side arrays,
        # disc_t and the scalars out; ~4 operations per count
        (_nbytes(wcounts, wn, wo)
         + 4 * (args.bench_pairs * (2 * K32 + 4) + fw.num_targets + 3),
         4 * wcounts.numel()),
    )
    # the ops library's bins, tsum and bins_target (past the one-launch
    # route's width) on the wide matrix (T = wide targets): 1024 single
    # reads, both mates of the first 512 pairs
    from ganon_tpu_torch.ops import library as lib

    Tw = fw.num_targets
    wbits_d = torch.from_numpy(wbits.view(np.int32)).to(cuda)
    wb2t_d = torch.from_numpy(wb2t).to(cuda)
    wcodes = torch.from_numpy(np.concatenate([a_[:512], b_[:512]])).to(cuda)
    wmm = args.read_len - w + 1
    woh, won = lib.minimizers(wcodes, torch.full(
        (wcodes.shape[0],), args.read_len, dtype=torch.int32, device=cuda),
        k=k, w=w, max_minimizers=wmm)
    wrows = lib.ibf_row_indices(woh, bin_size=wcfg.bin_size_bits,
                                hash_functions=wcfg.hash_functions)
    wmask = torch.arange(wmm, device=cuda)[None, :] < won[:, None]
    wperm, wstarts, wends = lib.target_segments(wb2t, Tw)
    wseg = [torch.from_numpy(x).to(cuda) for x in (wstarts, wends)]
    wperm_d = (None if wperm is None else
               torch.from_numpy(wperm.astype(np.int32)).to(cuda))
    if lib.bins_target_fused(wbits_d.shape[1]):
        raise AssertionError("wide bins_target: not on its two-launch route")
    # the library's entry points at this width, a main path of its own:
    # past one tile of targets tsum runs after its plan (tsum_plan)
    wtiles, wwidth = lib.tsum_tiles(Tw)
    kernels.reset_launches()
    wbins = lib.bulk_count_bins(wbits_d, wrows, wmask)
    lib.target_counts(wbins, wb2t_d, num_targets=Tw)
    lib.bulk_target_counts(wbits_d, wrows, wmask, *wseg, wperm_d)
    torch.cuda.synchronize()
    wide_ops_launches = dict(kernels.LAUNCHES)
    if (wtiles < 2 or wide_ops_launches["tsum_plan"] != 1
            or wide_ops_launches["tsum"] != 1):
        raise AssertionError(f"wide tsum: not past one tile "
                             f"({wtiles} tiles): {wide_ops_launches}")
    del wbins
    wide_ops = {}
    for name, kern, plain, a in (
            ("bins", lib.bulk_count_bins, lib.bulk_count_bins_plain,
             (wbits_d, wrows, wmask)),
            ("tsum", lib.target_counts, lib.target_counts_plain, None),
            ("bins_target", lib.bulk_target_counts,
             lib.bulk_target_counts_plain,
             (wbits_d, wrows, wmask, *wseg, wperm_d))):
        if a is None:
            a = (wide_ops["bins"][0], wb2t_d)
            kern = functools.partial(kern, num_targets=Tw)
            plain = functools.partial(plain, num_targets=Tw)
        got, want = kern(*a), plain(*a)
        if not torch.equal(got, want):
            raise AssertionError(f"wide {name}: kernel != plain")
        wide_ops[name] = (got, _ms(lambda: kern(*a), 5),
                          _ms(lambda: plain(*a), 1),
                          _ms_run(lambda: kern(*a), 10))
    wpacked = q.bulk_target_counts_packed(
        fw.tbl8, fw.byte_starts, fw.byte_ends, woh, won,
        bin_size=wcfg.bin_size_bits, hash_functions=wcfg.hash_functions,
        clamp=False)
    if not torch.equal(wide_ops["tsum"][0], wpacked):
        raise AssertionError("wide tsum: differs from the packed count")
    compare("tsum_plan", "ganon_tpu_torch/csrc/bins.cu",
            "ganon_tpu/ops/ibf_query.py:137",
            lambda: (lib.target_windows(wb2t_d, Tw, wwidth),),
            lambda: (lib.target_windows_plain(wb2t_d, Tw, wwidth),), 20, 5,
            # the map in, a window a tile out; a compare a bin
            (_nbytes(wb2t_d) + 8 * wtiles, wb2t_d.numel()), runs=20)
    if not torch.equal(wide_ops["bins_target"][0], wpacked):
        raise AssertionError("wide bins_target: differs from the packed "
                             "count")
    wide_ops_ms = {n_: v[1:3] for n_, v in wide_ops.items()}
    wide_ops_device_ms = {n_: v[3] for n_, v in wide_ops.items()}
    del fw, wh, wn, wo, wcounts, wsel, wbatch, win_np, a_, b_, wbits
    del wbits_d, wb2t_d, wcodes, woh, won, wrows, wmask, wide_ops, wpacked
    del wseg, wperm_d
    torch.cuda.empty_cache()
    # wide pairs through the CLI at default flags: 5% random, an eighth
    # of the rest from the targets above 0xFFFF, the others from all
    n_wrand = args.wide_pairs // 20
    n_whi = (args.wide_pairs - n_wrand) // 8
    hi = np.asarray([t for t in range(args.wide_targets)
                     if wcol[wnames[t]] > 0xFFFF])
    wt, wq1, wq2 = _sample_pairs(wrng, wgen, args.wide_pairs - n_wrand - n_whi,
                                 args.read_len)
    ht, hq1, hq2 = _sample_pairs(wrng, wgen[hi], n_whi, args.read_len)
    wq1, wq2 = np.concatenate([wq1, hq1]), np.concatenate([wq2, hq2])
    wrand = wrng.integers(0, 4, size=(2, n_wrand, args.read_len),
                          dtype=np.uint8)
    wtruth = ([wnames[t] for t in wt.tolist()]
              + [wnames[t] for t in hi[ht].tolist()] + ["rnd"] * n_wrand)
    wperm = wrng.permutation(args.wide_pairs)
    wq1 = np.concatenate([wq1, wrand[0]])[wperm]
    wq2 = np.concatenate([wq2, wrand[1]])[wperm]
    wtruth = [wtruth[j] for j in wperm]
    wids = [b"w%d|%s" % (i, t.encode()) for i, t in enumerate(wtruth)]
    wf1, wf2 = os.path.join(work, "w1.fq"), os.path.join(work, "w2.fq")
    _write_fastq(wf1, wids, wq1)
    _write_fastq(wf2, wids, wq2)
    wout = os.path.join(work, "wout")
    kernels.reset_launches()
    t0 = time.perf_counter()
    with _CallTimes(*timers) as wt_:
        _run_cli(["ganon-tpu-torch", "classify", "--db-prefix", wdb,
                  "--paired-reads", wf1, wf2, "--output-prefix", wout,
                  "--output-all", "--output-one"])
    w_s = time.perf_counter() - t0
    w_launches = dict(kernels.LAUNCHES)
    if w_launches["select32"] <= 0 or w_launches["select"] > 0:
        raise AssertionError(f"wide: not the 32-bit layout: {w_launches}")
    wall = _true_target_rows(wout + ".all")
    wbad = {"sampled": 0, "above_0xffff": 0, "random": 0}
    w_high = 0
    for rid in wids:
        rid = rid.decode()
        t = rid.split("|")[1]
        if t == "rnd":
            wbad["random"] += rid in wall
            continue
        miss = t not in wall.get(rid, ())
        wbad["sampled"] += miss
        if wcol[t] > 0xFFFF:
            w_high += 1
            wbad["above_0xffff"] += miss
    if any(wbad.values()) or not w_high:
        raise AssertionError(f"wide pairs misplaced: {wbad}, {w_high} pairs "
                             "above 0xFFFF")

    # (c) the first reads of (a) and pairs of (b) on the card and on the
    # CPU: identical sorted files and a byte-equal .sta
    nc = args.check_pairs
    lsub = os.path.join(work, "lsub.fq")
    _write_fastq_seqs(lsub, lids[:nc], lseqs[:nc])
    ws1, ws2 = (os.path.join(work, f"wsub{m}.fq") for m in (1, 2))
    _write_fastq(ws1, wids[:nc], wq1[:nc])
    _write_fastq(ws2, wids[:nc], wq2[:nc])

    lsubs, leq_launches, leq_s = {}, {}, {}
    for key, dbp, reads_kw in (
            ("long", db, dict(single_reads=[lsub], longreads=True)),
            ("wide", wdb, dict(paired_reads=[ws1, ws2]))):
        for device in ("cuda", "cpu"):
            d = os.path.join(work, f"{key}_sub_{device}")
            os.makedirs(d)
            kernels.reset_launches()
            t0 = time.perf_counter()
            cli_main("classify", device=device, db_prefix=[dbp],
                     output_prefix=os.path.join(d, "o"), output_all=True,
                     output_one=True, output_stats=True, n_reads=1024,
                     quiet=True, **reads_kw)
            leq_s[f"{key}_{device}"] = time.perf_counter() - t0
            if device == "cuda":
                leq_launches[key] = dict(kernels.LAUNCHES)
            lsubs[key, device] = _output_files(d)
        a_, b_ = lsubs[key, "cuda"], lsubs[key, "cpu"]
        if a_ != b_:
            diff = [fn for fn in set(a_) | set(b_) if a_.get(fn) != b_.get(fn)]
            raise AssertionError(f"longreads {key}: cuda and cpu differ in "
                                 f"{diff}")
        if leq_launches[key]["select32"] <= 0:
            raise AssertionError(f"longreads {key}: no select32 on the card")
    wbp = args.wide_pairs * 2 * args.read_len
    emit("longreads", {
        "reads": len(lids), "ultra_long_reads": nu,
        "ultra_len": args.ultra_len, "random_reads": n_rand, "bp": lbp,
        "seconds": l_s, "reads_per_s": len(lids) / l_s,
        "mbp_per_min": lbp / 1e6 / (l_s / 60),
        "cli_split_s": lt.seconds,
        "engine_split_s": lt.results["run_classify"]["timing"],
        "max_memory_allocated": l_peak, "launches": l_launches,
        "classified": l_classified,
        "ultra_n_hashes_min_max": ultra_n,
        "select32_ultra_ms": ultra_ms,
        "profiled_split_s": ltiming,
        "profiled_device_busy_share":
            lbusy_us / 1e6 / ltiming["total"] if lbusy_us else None,
        "profiled_device_us": lkernel_us,
        "skipped_without_longreads": skipped,
        "wide_ops_reads": 1024, "wide_ops_ms_kernel_plain": wide_ops_ms,
        "wide_ops_device_ms": wide_ops_device_ms,
        "wide_ops_launches": wide_ops_launches,
        "wide_tsum_tiles_width": [wtiles, wwidth],
        "wide": {"targets": args.wide_targets,
                 "genome_len": args.wide_genome_len,
                 "build_s": w_build_s, "build_launches": w_build_launches,
                 "pairs": args.wide_pairs, "random_pairs": n_wrand,
                 "pairs_above_0xffff": w_high, "seconds": w_s,
                 "reads_per_s": args.wide_pairs / w_s,
                 "mbp_per_min": wbp / 1e6 / (w_s / 60),
                 "cli_split_s": wt_.seconds,
                 "engine_split_s": wt_.results["run_classify"]["timing"],
                 "launches": w_launches},
        "cuda_equals_cpu_reads": nc,
        "cuda_equals_cpu_files": {k_: sorted(lsubs[k_, "cpu"])
                                  for k_ in ("long", "wide")},
        "cuda_equals_cpu_s": leq_s,
        "cuda_equals_cpu_launches": leq_launches,
    })
    del lseqs, wgen, wq1, wq2

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
    with _CallTimes(engine_run) as ct:
        _run_cli(["ganon-tpu-torch", "classify", "--db-prefix", host, db,
                  db_b, "--hierarchy-labels", *labels, "--paired-reads", hq1,
                  hq2, "--output-prefix", hout, "--multiple-matches", "lca",
                  "--output-one", "--output-all", "--output-unclassified",
                  "--output-stats", "--skip-report"])
    hier_s = time.perf_counter() - t0
    hier_launches = dict(kernels.LAUNCHES)
    _transfer_line("hierarchy", ct.results["run_classify"])
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
    emit("hierarchy", {
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
    })

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
    # every sub max-merged into one [B, 256] matrix, the four subs in one
    # launch (raptor_target_counts, DeviceRaptorHIBF.counts's call)
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

    def raptor_counts(fn, out, subs):
        out.zero_()
        for sub_ in subs:
            fn(sub_.tbl8, sub_.byte_starts, sub_.byte_ends, rh, rn,
               bin_size=sub_.bin_size, hash_functions=sub_.hash_funs,
               out=out, cols=sub_.cols)
        return (out,)

    # each sub gathers its own distinct rows; the hashes, n and the
    # [B, T] output are shared by the subs and counted once
    rvalid = int(_valid(rh, rn).sum())
    compare(
        "count_raptor", "ganon_tpu_torch/csrc/count.cu",
        "ganon_tpu/classify/device.py:488",
        lambda: (q.raptor_target_counts(fr.subs, rh, rn,
                                        num_targets=fr.num_targets,
                                        desc=fr.sub_desc),),
        lambda: (q.raptor_target_counts_plain(fr.subs, rh, rn,
                                              num_targets=fr.num_targets),),
        20, 3,
        (sum(_distinct_rows(rh, rn, s_.bin_size, s_.hash_funs)
             * s_.tbl8.shape[1] for s_ in fr.subs)
         + _nbytes(rh, rn) + args.bench_pairs * fr.num_targets * 4,
         sum(rvalid * s_.hash_funs * s_.tbl8.shape[1] for s_ in fr.subs)),
    )
    # the same subs one launch each (column-max mode into a zeroed
    # matrix, as the mesh path and single subs run it), beside
    rout_k = torch.zeros((args.bench_pairs, fr.num_targets),
                         dtype=torch.int32, device=cuda)
    if not torch.equal(raptor_counts(q.bulk_target_counts_packed, rout_k,
                                     fr.subs)[0], fr.counts(rh, rn)):
        raise AssertionError("count_raptor: one launch a sub differs from "
                             "one launch a batch")
    rows[-1]["per_sub_ms"] = _ms(
        lambda: raptor_counts(q.bulk_target_counts_packed, rout_k, fr.subs),
        20)
    # a small layout where one user bin sits in two IBFs, so the max
    # really combines two subs' values (one launch a sub and a batch)
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
    raptor_counts(q.bulk_target_counts_packed, tk, ft.subs)
    raptor_counts(q.bulk_target_counts_packed_plain, tp, ft.subs)
    per_sub = [q.bulk_target_counts_packed_plain(
        s_.tbl8, s_.byte_starts, s_.byte_ends, rh, rn, bin_size=s_.bin_size,
        hash_functions=s_.hash_funs)[:, s_.cols.tolist().index(tcol)]
        for s_ in ft.subs]
    both = int(((per_sub[0] > 0) & (per_sub[1] > 0)).sum())
    if not torch.equal(tk, tp) or not both or not torch.equal(
            ft.counts(rh, rn), tp):
        raise AssertionError(f"raptor twin layout: kernel == plain "
                             f"{torch.equal(tk, tp)}, reads in both subs "
                             f"{both}")
    del ft, tk, tp, per_sub, rout_k, rh, rn
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
    with _CallTimes(engine_run) as ct:
        _run_cli(["ganon-tpu-torch", "classify", "--db-prefix", rdb,
                  "--paired-reads", rq1, rq2, "--output-prefix", rout,
                  "--multiple-matches", "lca", "--output-one", "--output-all",
                  "--output-unclassified", "--skip-report"])
    r_cli_s = time.perf_counter() - t0
    r_cli_launches = dict(kernels.LAUNCHES)
    _transfer_line("raptor", ct.results["run_classify"])
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
    # the layout archive on the (2, 4) mesh (K17): every sub's table
    # column-sharded, its shards summed and clamped, then max-merged
    rmesh = {}
    for tag, devs in (("single", [cuda0]), ("mesh", [cuda0] * 8)):
        d = os.path.join(work, f"xmesh_{tag}")
        os.makedirs(d)
        kernels.reset_launches()
        with _LocalDevices(devs):
            run_classify(ClassifyConfig(**{
                **rfiles, "paired_reads": [rs1, rs2], "output_stats": True,
                "output_prefix": os.path.join(d, "o")}))
        rmesh[tag] = _output_files(d)
    raptor_mesh_launches = dict(kernels.LAUNCHES)
    drop_meshed()
    if rmesh["single"] != rmesh["mesh"]:
        raise AssertionError("raptor: the mesh run differs from one card's")
    if raptor_mesh_launches["count_raptor"] > 0 or (
            raptor_mesh_launches["combine"] <= 0):
        raise AssertionError(f"raptor: the mesh run did not shard: "
                             f"{raptor_mesh_launches}")
    rmbp = nr * 2 * args.read_len / 1e6
    emit("raptor", {
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
        "mesh_pairs": nc, "mesh_equals_single": True,
        "mesh_launches": raptor_mesh_launches,
    })
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
    emit("pruned_build", {
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
    })

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
    emit("pruned_build_custom", {
        "targets": args.pruned_targets, "bp": pbp, "seconds": pc_s,
        "mbp_per_min": pbp / 1e6 / (pc_s / 60), "hibf_layout": pc_layout,
        "equals_pruned_hibf": True, "launches": pc_launches,
    })

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
        runs=20,
    )
    # the pair cap the engine takes at this batch (pair_frac 1.0, a
    # multiple of 256); the yardstick is the scan alone
    pcap = min(-(-args.bench_pairs // 256) * 256, args.bench_pairs * S)
    pflags = slot_ok.reshape(-1).to(torch.int32)
    compare("pairs", "ganon_tpu_torch/csrc/scan.cu",
            "ganon_tpu/classify/device.py:1199",
            lambda: pq.pair_live(slot_ok, govf, pcap),
            lambda: pq.pair_live_plain(slot_ok, govf, pcap), 20, 5,
            # the slot flags and overflow in, live flags and overflow out
            (2 * _nbytes(slot_ok, govf), slot_ok.numel()),
            library=lambda: torch.cumsum(pflags, 0), runs=50)
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
        runs=20,
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
        runs=10,
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
    # one main-path flush of both tables: the build's group-major member
    # stream, whole targets, until 4M hashes (SCATTER_CHUNK)
    fh_, runs_, n = [], [], 0
    for t, name in enumerate(pf.targets()):
        part = phashes[name]
        if not len(part):
            continue
        runs_.append((n, t // gs, t % gs))
        fh_.append(part)
        n += len(part)
        if n >= SCATTER_CHUNK:
            break
    sph = u64_to_torch(np.concatenate(fh_)).to(cuda)
    spruns = np.asarray(runs_, dtype=np.int64)
    skw = dict(grp_bin_size=pf.grp_bin_size, grp_row_off=pf.grp_row_off,
               fine_h=pf.fine_h, coarse_h=pf.coarse_h)
    # both tables staged by word column, as the build stages them
    tabs = [torch.zeros((-(-width // 4), rows_), dtype=torch.int32,
                        device=cuda)
            for _ in range(2) for rows_, width in (pf.fine.shape,
                                                   pf.coarse.shape)]

    def scatter_pruned_kernel():
        scatter_pruned(tabs[0], tabs[1], sph, spruns, **skw)
        return tabs[0], tabs[1]

    def scatter_pruned_run_plain():
        scatter_pruned_plain(tabs[2], tabs[3], sph, spruns, **skw)
        return tabs[2], tabs[3]

    # the hashes and the run table in; each distinct u32 word of both
    # tables read and written once; a bit set a hash and hash function
    sizes_ = torch.from_numpy(np.diff(np.append(spruns[:, 0], sph.numel()))
                              ).to(cuda)
    pg64 = torch.from_numpy(spruns[:, 1]).to(cuda).repeat_interleave(sizes_)
    plane = torch.from_numpy(spruns[:, 2]).to(cuda).repeat_interleave(sizes_)
    fwords = torch.unique(torch.cat([
        (q.ibf_row_dyn(sph, i, fp.grp_bin_size[pg64],
                       fp.grp_shift[pg64].to(torch.int64))
         + fp.grp_row_off[pg64]) * tabs[0].shape[0] + plane // 32
        for i in range(pf.fine_h)])).numel()
    cbs = torch.tensor(pf.coarse_bin_size, device=cuda)
    csh = torch.tensor(q.clz64(pf.coarse_bin_size), device=cuda)
    cwords = torch.unique(torch.cat([
        q.ibf_row_dyn(sph, i, cbs, csh) * tabs[1].shape[0] + pg64 // 32
        for i in range(pf.coarse_h)])).numel()
    compare("scatter_pruned", "ganon_tpu_torch/csrc/scatter.cu",
            "ganon_tpu/index/pruned.py:283", scatter_pruned_kernel,
            scatter_pruned_run_plain, 10, 3,
            (_nbytes(sph) + spruns.nbytes + 2 * 4 * (fwords + cwords),
             sph.numel() * (pf.fine_h + pf.coarse_h)), runs=10)
    rows[-1].update(fine_words=fwords, coarse_words=cwords,
                    runs=len(spruns),
                    fine_slices=pruned_plan(spruns, sph.numel(),
                                            pf.grp_bin_size, pf.grp_row_off,
                                            tabs[0].shape[0])[2])
    del pg64, plane, sizes_
    emit("pruned_kernels", {
        "pairs": args.bench_pairs, "L1": pL1, "L2": pL2, "S": S, "K": PK,
        "gate_overflow_reads": int(govf.sum()),
        "live_slots": int(slot_ok.sum()),
        "scatter_hashes": int(sph.numel()), "scatter_runs": len(spruns),
        "pair_cap": pcap, "live_pairs": int(slot_ok.sum()),
        "ms": {r["name"]: [r["ms"], r["plain_ms"]] for r in rows[-6:]},
    })
    # the packed batch on the card and on the forest moved to the CPU at
    # 1024 pairs: pair caps 0, 8 (spilling) and B * S, a ragged cap
    fpc = fp.to("cpu")
    pcb = pin_np[:1024]
    pair_checks = {}
    for pc_ in (0, 8, 1024 * S):
        bufs = [dev.classify_batch_packed_pruned(
            fx, torch.from_numpy(pcb).to(fx.device), 0.75, 0.1, 65535, k=k,
            w=w, L1=pL1, L2=pL2, max_groups=S, top_k=4, match_cap=2048,
            pair_cap=pc_).cpu() for fx in (fp, fpc)]
        if not torch.equal(bufs[0], bufs[1]):
            raise AssertionError(f"pruned batch: card and cpu differ at "
                                 f"pair_cap {pc_}")
        pair_checks[pc_] = int(dev.unpack_batch_result_ragged(
            bufs[0].numpy(), 1024, 2048, fp.num_targets, 4,
            n_extra=1)["overflow"].sum())
    if pair_checks[8] <= pair_checks[0]:
        raise AssertionError(f"pruned batch: pair cap 8 spilled no read: "
                             f"{pair_checks}")
    del fpc, bufs, pflags
    del ph, pn, povf, gsel, slot_ok, govf, lane_counts, lc, lsel, surv
    del live_b, live_s, surv_b, surv_g
    del tabs, sph, fargs, akw, phashes
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
    with _CallTimes(engine_run) as ct:
        _run_cli(["ganon-tpu-torch", "classify", "--db-prefix", pdb,
                  "--paired-reads", pf1, pf2, "--output-prefix", pout,
                  "--multiple-matches", "lca", "--output-one", "--output-all",
                  "--output-unclassified", "--skip-report"])
    p_cli_s = time.perf_counter() - t0
    p_cli_launches = dict(kernels.LAUNCHES)
    _transfer_line("pruned", ct.results["run_classify"])
    if p_cli_launches["pairs"] <= 0 or p_cli_launches["ragged"] <= 0:
        raise AssertionError(f"pruned: no pair compaction or ragged stream: "
                             f"{p_cli_launches}")
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
    emit("pruned", {
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
        "batch_cuda_equals_cpu_overflow_reads_by_pair_cap": pair_checks,
        "cuda_equals_cpu_files": sorted(psubs["cpu"]),
        "cuda_equals_cpu_launches": peq_launches,
    })

    # mesh_pruned: the bins-sharded pruned forest (K17) over four views of
    # the card: groups strided over the shards, the coarse gate on each
    # device, fine in shard mode into the global columns ------------------
    from ganon_tpu_torch.parallel.pruned_shard import BinShardedPrunedForest

    mesh4 = pmesh.make_mesh([cuda0] * 4, batch_axis=1)
    t0 = time.perf_counter()
    bsf = BinShardedPrunedForest(pf, mesh4)
    torch.cuda.synchronize()
    bsf_s = time.perf_counter() - t0
    _, pr1, pr2 = _sample_pairs(np.random.default_rng(args.seed + 13), pgen,
                                args.bench_pairs, args.read_len)
    pbatch = EncodedBatch(prefix="", paired=True,
                          ids=[str(i) for i in range(args.bench_pairs)],
                          codes1=pr1, len1=lens, codes2=pr2, len2=lens)
    pin_np, pL1, pL2 = dev.pack_batch_direct(pbatch, args.bench_pairs)
    ph, pn, _ = dev._extract_compact(torch.from_numpy(pin_np).to(cuda),
                                     k=k, w=w, L1=pL1, L2=pL2)
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = bsf.counts_gated(ph, pn, 0.75)
    torch.cuda.synchronize()
    bsf_counts_s = time.perf_counter() - t0
    mesh_pruned_launches = dict(kernels.LAUNCHES)
    want = fp.counts_gated(ph, pn, 0.75)
    if not torch.equal(got, want) or not want.any():
        raise AssertionError("mesh_pruned: sharded gated counts differ from "
                             "one device's")
    if mesh_pruned_launches["fine_shard"] != 4:
        raise AssertionError(f"mesh_pruned: {mesh_pruned_launches}")
    del got, want
    # fine_shard against its plain version: shard 0's groups at 8192 pairs
    sftbl, soff, sbsz, sshift, sgid = bsf.shards[0][0]
    ssurv = pq.gate(bsf.ctbl[str(cuda0)], ph, pn,
                    coarse_bin_size=fp.coarse_bin_size, coarse_h=fp.coarse_h,
                    num_groups=fp.num_groups, rel_cutoff=0.75,
                    hashes_limit=pq.NO_HASHES_LIMIT, max_groups=0,
                    want_surv=True)[3]
    souts = [torch.zeros((args.bench_pairs, fp.num_targets), dtype=torch.int32,
                         device=cuda) for _ in range(2)]
    sargs = (sftbl, ph, pn, soff, sbsz, sshift, sgid)
    skw = dict(fine_h=fp.fine_h, group_size=fp.group_size,
               num_groups=fp.num_groups, surv=ssurv)
    mine = sgid[sgid >= 0].to(torch.int64)
    sb_, sg_ = torch.nonzero(ssurv[:, mine].bool(), as_tuple=True)
    srows, svalid = _fine_work(fp, ph, pn, sb_, mine[sg_])
    Wf = fp.ftbl.shape[1]
    compare(
        "fine_shard", "ganon_tpu_torch/csrc/fine.cu",
        "ganon_tpu/parallel/pruned_shard.py:132",
        lambda: (pq.fine_shard(*sargs, **skw, out=souts[0]),),
        lambda: (pq.fine_shard_plain(*sargs, **skw, out=souts[1]),), 10, 2,
        # the surviving (read, group) pairs' distinct rows, the inputs and
        # the shard's columns out
        (srows * Wf + _nbytes(ph, pn, ssurv, soff, sbsz, sshift, sgid)
         + args.bench_pairs * int(mine.numel()) * fp.group_size * 4,
         svalid * fp.fine_h * Wf), runs=10)
    emit("mesh_pruned", {
        "mesh": mesh4.shape, "devices": "4 views of cuda:0",
        "groups": fp.num_groups, "groups_per_shard": int(sgid.numel()),
        "pad_groups_shard_0": int((sgid < 0).sum()),
        "build_s": bsf_s, "pairs": args.bench_pairs,
        "counts_gated_s": bsf_counts_s, "equals_single": True,
        "launches": mesh_pruned_launches,
    })
    del bsf, ph, pn, souts, ssurv, sargs, sb_, sg_
    del fp, pf, pgen
    torch.cuda.empty_cache()

    # 5. checks ------------------------------------------------------------
    main_runs = (build_launches, bc_launches, acq_launches, upd_launches,
                 ref_launches, sp_launches,
                 gprobe_launches, ops_launches, wide_launches,
                 wide_ops_launches,
                 mesh_build_launches, hier_build_launches, cli_launches,
                 mesh_launches, mesh_forest_launches, l_launches,
                 w_build_launches, w_launches, *leq_launches.values(),
                 hier_launches, r_cli_launches, *req_launches.values(),
                 raptor_mesh_launches, pbuild_launches, pc_launches,
                 p_cli_launches, *peq_launches.values(),
                 mesh_pruned_launches)
    launches = {name: sum(r[name] for r in main_runs)
                for name in kernels.LAUNCHES}
    # dedup's rank mode is off every main path: the ranked scatter ranks
    # in its own call (its row times it alone)
    missing = [name for name, n in launches.items()
               if n <= 0 and name != "dedup_rank"]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    emit("checks", {"launches": launches})

    for r in rows:
        r["launches"] = launches[r.get("counted_as", r["name"])]
    print(json.dumps({"kernels": rows}))
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
