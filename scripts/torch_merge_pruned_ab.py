#!/usr/bin/env python3
"""A/B of the port's merge (``csrc/merge.cu``) and pruned scatter
(``csrc/scatter.cu`` pruned mode) kernels: this checkout's against an
earlier version's sources, in one process on the card.

    mkdir -p chip_proof/old
    for f in merge.cu scatter.cu dedup.cuh ibf_hash.cuh scan.cuh; do
        git show <rev>:ganon_tpu_torch/csrc/$f > chip_proof/old/$f
    done
    python scripts/torch_merge_pruned_ab.py --old chip_proof/old [--reps 2] \
        [--only merge,merge_real,pruned,pruned_big]

The earlier ``merge.cu`` and ``scatter.cu`` are built with nvcc, each
alone, into ``build/`` and called through ctypes with their own C
signatures (``ganon_merge`` took one filter a launch; ``ganon_scatter_
pruned`` one table a launch, with a group and a bit a pair), behind
copies of their earlier callers (the same checks, fills, host arrays
and launches), so a call's time compares caller with caller. This
checkout's kernels run through their wrappers (``classify.device.merge``,
``index.pruned.scatter_pruned``). Inputs are made from ``--seed`` at the
shapes of ``chip_smoke.py``'s rows:

* ``merge``: the hierarchy's ``2_refs`` level, 8192 reads, filters of 1024
  and 512 targets sharing 64 (U = 1472), counts at most n, rel-cutoff
  0.75 each: the earlier side zero-fills ucounts and uwin and launches
  once a filter, the new side allocates them unfilled and launches once;
  ``merge_u1471``: the same with 1023 targets in the first filter (U =
  1471: rows off 16 bytes, the scalar edges); ``merge_real``: the same
  level on real counts, ``chip_smoke.py``'s ``db`` and ``db_b`` (1024
  and 512 random genomes of 1 Mbp, 64 shared, drawn as the smoke draws
  them from its seed) counted on its 8192 bench pairs. Beside each merge
  shape, the merge kernels' own card time (the fills left out) with the
  L2 warm (the calls back to back) and cold (a 256 MB fill between
  calls), and the share of valid reads;
* ``scatter_pruned``: the pruned build's first flush at the smoke's
  shape (8192 targets of ~2780 distinct hashes, group size 64, 128
  groups, fine max-fp 0.05, coarse 0.1, h 1 each; whole targets in
  group-major order until 4M hashes), hashes on the card: the earlier
  side runs its fine and its coarse launch on per-pair group and lane
  arrays already on the card, the new side the flush's plan, its upload
  and one launch into tables staged by word column (as the build stages
  them; compared through their transposes); ``flush``: the same from
  host arrays, as
  ``build_pruned``'s flush runs (the earlier side expands the runs with
  ``np.repeat`` and copies three arrays, the new side one array and the
  plan); beside them the earlier fine and coarse launches alone
  (``old_fine``, ``old_coarse``), the new kernel's coarse blocks alone
  (``new_coarse_only``), the build's transposes of the staged tables
  (``transpose_fine``, ``transpose_coarse``) and the new flush at other
  slice sizes (``slice_<bytes>``), card ms;
* ``pruned_<n>k``: the first flush of a build of genome-sized targets
  (about n thousand hashes each, n in 5, 10, 20, 50, 200, 700; groups of
  64, h 1 each, the fine bin size of the largest member, so its columns
  need 2 to ~250 slices of 216 KB), and ``pruned_15k_g16`` (512 targets
  of ~15K hashes in groups of 16: a column 1/17 of the flush, 6 slices),
  old against new at the default plan rule; for these and
  ``scatter_pruned``, the new flush under other rules (``atomics``: every
  column's fine bits set by the coarse blocks; ``slices``: none;
  ``max_<m>``, ``share_<c>``: ``MAX_COLUMN_SLICES`` m or
  ``COLUMN_SHARE`` c), card ms.

Each shape runs old, new, new, old per rep (a call between two CUDA
events, median; ``queued_ms``, 20 calls queued while the card sleeps, so
they run back to back, between two events, the new flush's launch alone
with its plan uploaded once; the card's activity under torch.profiler,
null where no window kept every record; the host's time a call over 100
calls back to back); the new kernel's outputs must equal
the old's (max_abs_err 0). One JSON line a turn, then the card's name and
power limit and the medians of each side. Needs one CUDA card.
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

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
# the earlier C signatures (the stream is the last pointer)
OLD_SIGNATURES = {
    # counts, B, T_f, n_hashes, rel_cutoff, hashes_limit, cols, f,
    # ucounts, uwin, U
    "merge": ("merge.cu", (_P, _L, _I, _P, _D, _L, _P, _I, _P, _P, _I)),
    # bits, R, W, hashes, grp (NULL = set 0), bit, N, bin_size, shift,
    # row_off, h
    "scatter_pruned": ("scatter.cu",
                       (_P, _L, _L, _P, _P, _P, _L, _P, _P, _P, _I)),
}


def _smoke():
    """chip_smoke.py of this checkout, for its timing helpers."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _old_library(src: str) -> ctypes.CDLL:
    """Build one earlier source alone into ``build/`` and load it (its
    headers from its own directory)."""
    from ganon_tpu_torch import BUILD_DIR, kernels

    tag = hashlib.sha1()
    for name in sorted(os.listdir(os.path.dirname(src))):
        with open(os.path.join(os.path.dirname(src), name), "rb") as f:
            tag.update(f.read())
    so = os.path.join(BUILD_DIR, f"ab_old_{os.path.basename(src)}_"
                      f"{tag.hexdigest()[:12]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-shared",
                        "-o", so, src], check=True)
    return ctypes.CDLL(so)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True,
                    help="directory of the earlier merge.cu and scatter.cu "
                    "(with the headers scatter.cu includes)")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=41)
    ap.add_argument("--only", default="merge,merge_real,pruned,pruned_big",
                    help="the parts to run, comma-separated")
    args = ap.parse_args()
    only = set(args.only.split(","))

    import torch
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2

    from ganon_tpu_torch import kernels
    from ganon_tpu_torch.classify import device as dev
    from ganon_tpu_torch.index import pruned as tp
    from ganon_tpu_torch.index.sizing import bin_size_fp_hf
    from ganon_tpu_torch.ops.ibf_query import clz64
    from ganon_tpu_torch.ops.winnow import u64_to_torch

    smoke = _smoke()
    cuda = torch.device("cuda")
    g = torch.Generator(device=cuda).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    old = {}
    for name, (src, sig) in OLD_SIGNATURES.items():
        fn = getattr(_old_library(os.path.join(args.old, src)),
                     f"ganon_{name}")
        fn.argtypes = list(sig) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        old[name] = fn

    def call_old(name, *a):
        """kernels.launch's path (device, raw stream) to an earlier
        kernel."""
        lib = kernels.library()
        if lib.ganon_set_device(cuda.index or 0):
            raise RuntimeError("cudaSetDevice failed")
        cargs = [x.data_ptr() if isinstance(x, torch.Tensor) else x
                 for x in a]
        err = old[name](*cargs,
                        torch._C._cuda_getCurrentRawStream(cuda.index or 0))
        if err:
            raise RuntimeError(f"old {name}: error {err}")

    turns, summary = [], {}
    flush_buf = torch.empty(64 << 20, dtype=torch.int32, device=cuda)

    def queued_ms(fn, n=20, between=None):
        """Card ms a call from CUDA events alone: the card sleeps ~10 ms
        while the host queues ``n`` calls, so they run back to back
        whatever the host's time a call (``fn`` must not wait on the
        card); ``between`` (run before each call, timed alone the same way
        and taken off) lets a call start with a cold L2."""
        def run(f):
            f()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(20_000_000)
            start.record()
            for _ in range(n):
                f()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / n

        if between is None:
            return run(fn)

        def both():
            between()
            fn()
        return run(both) - run(between)

    def kernel_ms(fn, name, n=20, cold=False):
        """Card ms a call of the kernels whose name holds ``name`` (the
        fills and copies left out), under torch.profiler over ``n`` calls;
        ``cold`` writes 256 MB between calls, so the L2 holds nothing of
        the call's inputs or outputs. A window that lost some of the
        kernels' records (fewer than ``n`` times one call's) is profiled
        again, up to five windows; None if none holds them all."""

        def window(calls):
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
                for _ in range(calls):
                    if cold:
                        flush_buf.fill_(1)
                    fn()
                torch.cuda.synchronize()
            ks = [e for e in p.events()
                  if e.device_type == DeviceType.CUDA and name in e.name]
            return len(ks), sum(e.time_range.elapsed_us() for e in ks)

        fn()
        torch.cuda.synchronize()
        per_call = window(1)[0]
        for _ in range(5):
            got, us = window(n)
            if per_call and got == n * per_call:
                return us / n / 1e3
        return None

    def host_us(fn, n=100):
        """Microseconds of the host a call: n calls back to back, timed
        before the card catches up (the caller, the allocations, copies
        and launches, not the kernels)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return us

    def record(shape, side, fn, reps=20, runs=20, queued=None):
        turns.append({"shape": shape, "side": side,
                      "ms": smoke._ms(fn, reps),
                      "queued_ms": queued_ms(queued or fn),
                      "profiled_ms": smoke._profiled_ms(fn, runs),
                      "host_us": host_us(fn, 20 if runs < 20 else 100)})
        print(json.dumps(turns[-1]), flush=True)

    def ab(shape, run_old, run_new, info, runs=20, queued_new=None):
        """Old and new equal, then timed in turns; ``queued_new`` is the
        new side's launches alone, for ``queued_ms`` where its caller
        waits on the card (a pageable upload)."""
        a, b = run_old(), run_new()
        torch.cuda.synchronize()
        errs = [int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
                for x, y in zip(a, b)]
        if len(a) != len(b) or any(errs):
            raise AssertionError(f"{shape}: the new kernel differs from the "
                                 f"old (max errors {errs})")
        info["max_abs_err"] = max(errs)
        summary[shape] = info
        sides = {"old": (run_old, None), "new": (run_new, queued_new)}
        for _ in range(args.reps):
            for side in ("old", "new", "new", "old"):
                record(shape, side, *sides[side][:1], runs=runs,
                       queued=sides[side][1])

    # merge ------------------------------------------------------------------
    B = 8192

    def synthetic(T0, T1, shared):
        """Counts at most n, uniform: most pass the cutoff."""
        n = torch.randint(0, 60, (B,), generator=g, device=cuda,
                          dtype=torch.int32)
        counts = [torch.minimum(torch.randint(0, 60, (B, t), generator=g,
                                              device=cuda,
                                              dtype=torch.int32),
                                n[:, None]).contiguous() for t in (T0, T1)]
        return n, counts, shared

    def merge_shape(shape, n, counts, shared):
        T0, T1 = (c.shape[1] for c in counts)
        U = T0 + T1 - shared
        cols = [np.arange(T0),
                np.concatenate([np.arange(shared), np.arange(T0, U)])]
        dcols = [torch.from_numpy(c.astype(np.int32)).to(cuda) for c in cols]
        colmap = dev.merge_colmap(cols, U, cuda)
        rcs = [0.75, 0.75]

        def run_old():
            """The earlier caller: two filled buffers, a launch a filter."""
            uc = torch.zeros((B, U), dtype=torch.int32, device=cuda)
            uw = torch.zeros_like(uc)
            for fi, (c, cl, rc) in enumerate(zip(counts, dcols, rcs)):
                kernels.check_cuda(c, n, cl, uc, uw)
                call_old("merge", c, B, c.shape[1], n, rc, 65535, cl, fi,
                         uc, uw, U)
            return uc, uw

        def run_new():
            uc = torch.empty((B, U), dtype=torch.int32, device=cuda)
            uw = torch.empty_like(uc)
            dev.merge(counts, n, rcs, 65535, colmap, uc, uw)
            return uc, uw

        nn = n.to(torch.int64)
        valid = (nn > 0) & (nn <= 65535)
        ab(shape, run_old, run_new,
           {"B": B, "T": [T0, T1], "U": U,
            "bytes": (T0 + T1) * B * 4 + B * 4 + 2 * B * U * 4,
            "valid_reads": float(valid.double().mean()),
            "passing_counts": float(sum(
                ((c >= torch.ceil(nn * 0.75)[:, None]) & valid[:, None]
                 & (c > 0)).double().sum() for c in counts)
                / (B * (T0 + T1)))})
        for side, fn in (("old", run_old), ("new", run_new)):
            for cold in (False, True):
                tag = f"{side}_kernel_{'cold' if cold else 'warm'}"
                summary[shape][tag + "_ms"] = kernel_ms(fn, "merge_kernel",
                                                        cold=cold)
            summary[shape][f"{side}_queued_warm_ms"] = queued_ms(fn)
            summary[shape][f"{side}_queued_cold_ms"] = queued_ms(
                fn, between=lambda: flush_buf.fill_(1))

    def real_counts():
        """chip_smoke.py's db and db_b, built as it builds them from its
        seed (43) and default sizes, and its bench pairs counted on
        each."""
        from ganon_tpu_torch.index.ibf import build_ibf
        from ganon_tpu_torch.io.pipeline import EncodedBatch
        from ganon_tpu_torch.ops import ibf_query as q

        srng = np.random.default_rng(43)
        genomes = srng.integers(0, 4, size=(1024, 1_000_000), dtype=np.uint8)
        for m in (1, 2, 4, 8):  # the forest's genomes, drawn in between
            srng.integers(0, 4, size=(64, 250_000 * m), dtype=np.uint8)
        shared = 64
        new_b = srng.integers(0, 4, size=(512 - shared, 1_000_000),
                              dtype=np.uint8)
        names = [f"T{t}" for t in range(1024)]
        b_names = names[:shared] + [f"U{i}" for i in range(shared, 512)]
        work = os.path.join(ROOT, "build", "merge_ab")
        os.makedirs(work, exist_ok=True)
        filters = []
        for tag, named in (("db", zip(names, genomes)),
                           ("db_b", zip(b_names, list(genomes[:shared])
                                        + list(new_b)))):
            ibf = build_ibf(smoke._hashes(named, 19, 31, cuda), kmer_size=19,
                            window_size=31, max_fp=0.05, device=cuda)
            ibf.save_raw(os.path.join(work, tag + ".ibf"))
            filters.append(dev.load_device_filter(
                os.path.join(work, tag + ".ibf"), cuda))
        _, r1, r2 = smoke._sample_pairs(np.random.default_rng(45), genomes,
                                        B, 150)
        lens = np.full(B, 150, np.int32)
        batch = EncodedBatch(prefix="", paired=True,
                             ids=[str(i) for i in range(B)], codes1=r1,
                             len1=lens, codes2=r2, len2=lens)
        inbuf_np, L1, L2 = dev.pack_batch_direct(batch, B)
        inbuf = torch.from_numpy(inbuf_np).to(cuda)
        mc = dev.compact_width(2 * (L1 - 31 + 1))
        hashes, n, _ = q.extract(inbuf, L1=L1, L2=L2, k=19, w=31, mc=mc)
        return n, [f.counts(hashes, n) for f in filters], shared

    if "merge" in only:
        merge_shape("merge", *synthetic(1024, 512, 64))
        merge_shape("merge_u1471", *synthetic(1023, 512, 64))
    if "merge_real" in only:
        merge_shape("merge_real", *real_counts())

    # pruned scatter ---------------------------------------------------------
    def flush_inputs(sizes, gs=64):
        """The first flush of a pruned build of targets of ``sizes``
        hashes (sorted descending, groups of ``gs``, fine max-fp 0.05 and
        coarse 0.1, h 1 each): whole targets, group-major, until
        SCATTER_CHUNK hashes; hashes on the card, tables of both layouts
        zeroed."""
        sizes = np.sort(sizes)[::-1]
        G = -(-len(sizes) // gs)
        grp_bin_size = np.asarray([max(64, bin_size_fp_hf(0.05, int(
            sizes[j * gs:(j + 1) * gs].max()), 1)) for j in range(G)],
            np.int64)
        grp_row_off = np.concatenate([[0], np.cumsum(grp_bin_size)[:-1]])
        Rc = max(64, bin_size_fp_hf(0.1, int(max(
            sizes[j * gs:(j + 1) * gs].sum() for j in range(G))), 1))
        Rc += -Rc % 32
        n_t = min(len(sizes), int(np.searchsorted(
            np.cumsum(sizes), tp.SCATTER_CHUNK)) + 1)
        starts = np.concatenate([[0], np.cumsum(sizes[:n_t])[:-1]])
        runs = np.stack([starts, np.arange(n_t) // gs, np.arange(n_t) % gs],
                        axis=1).astype(np.int64)
        N = int(sizes[:n_t].sum())
        x = dict(runs=runs, N=N, G=G, gs=gs, Rc=Rc, Rf=int(grp_bin_size.sum()),
                 Wf=-(-gs // 32), Wc=-(-G // 32), grp_bin_size=grp_bin_size,
                 grp_row_off=grp_row_off, lens=np.diff(np.append(starts, N)))
        x["hashes"] = rng.integers(0, 2**64, size=N, dtype=np.uint64)
        x["dh"] = u64_to_torch(x["hashes"]).to(cuda)
        x["fparams"] = (torch.from_numpy(grp_bin_size).to(cuda),
                        torch.tensor([clz64(int(b)) for b in grp_bin_size],
                                     dtype=torch.int32, device=cuda),
                        torch.from_numpy(grp_row_off).to(cuda))
        x["cparams"] = (torch.tensor([Rc], dtype=torch.int64, device=cuda),
                        torch.tensor([clz64(Rc)], dtype=torch.int32,
                                     device=cuda),
                        torch.zeros((1,), dtype=torch.int64, device=cuda))
        # the earlier kernel's tables row-major, the new one's staged by
        # word column (compared through their transposes)
        x["old"] = (torch.zeros((x["Rf"], x["Wf"]), dtype=torch.int32,
                                device=cuda),
                    torch.zeros((Rc, x["Wc"]), dtype=torch.int32,
                                device=cuda))
        x["new"] = (torch.zeros((x["Wf"], x["Rf"]), dtype=torch.int32,
                                device=cuda),
                    torch.zeros((x["Wc"], Rc), dtype=torch.int32,
                                device=cuda))
        x["dgrp"] = torch.from_numpy(np.repeat(runs[:, 1], x["lens"]).astype(
            np.int32)).to(cuda)
        x["dlane"] = torch.from_numpy(np.repeat(runs[:, 2], x["lens"]).astype(
            np.int32)).to(cuda)
        x["kw"] = dict(grp_bin_size=grp_bin_size, grp_row_off=grp_row_off,
                       fine_h=1, coarse_h=1)
        x["info"] = {
            "targets": len(sizes), "group_size": gs, "groups": G,
            "hashes": N, "runs": n_t, "fine_rows": x["Rf"],
            "coarse_rows": Rc, "largest_group_bin_size": int(
                grp_bin_size[runs[:, 1]].max()),
            "fine_slices": tp.pruned_plan(runs, N, grp_bin_size,
                                          grp_row_off, x["Wf"])[2],
            "slice_bytes": tp.SLICE_BYTES,
            "max_column_slices": tp.MAX_COLUMN_SLICES,
            "column_share": tp.COLUMN_SHARE}
        return x

    def old_fine(x, h, gg, bit):
        fine = x["old"][0]
        kernels.check_cuda(fine, h, bit, *x["fparams"], gg)
        call_old("scatter_pruned", fine, x["Rf"], x["Wf"], h, gg, bit,
                 x["N"], *x["fparams"], 1)

    def old_coarse(x, h, gg):
        coarse = x["old"][1]
        kernels.check_cuda(coarse, h, gg, *x["cparams"])
        call_old("scatter_pruned", coarse, x["Rc"], x["Wc"], h, None, gg,
                 x["N"], *x["cparams"], 1)

    def sc_old(x):
        old_fine(x, x["dh"], x["dgrp"], x["dlane"])
        old_coarse(x, x["dh"], x["dgrp"])
        return x["old"]

    def sc_new(x):
        tp.scatter_pruned(*x["new"], x["dh"], x["runs"], **x["kw"])
        return x["new"][0].t(), x["new"][1].t()

    def launch_new(x):
        """The new flush's launch alone, its plan made and uploaded once
        (per plan rule)."""
        key = (tp.MAX_COLUMN_SLICES, tp.COLUMN_SHARE, tp.SLICE_BYTES)
        if x.get("plan_key") != key:
            meta, nr, nfb, srows = tp.pruned_plan(
                x["runs"], x["N"], x["grp_bin_size"], x["grp_row_off"],
                x["Wf"])
            x["plan"] = (torch.from_numpy(meta).to(cuda), nr, nfb, srows)
            x["plan_key"] = key
        dmeta, nr, nfb, srows = x["plan"]
        fine_t, coarse_t = x["new"]
        kernels.launch("scatter_pruned", fine_t, x["Rf"], x["Wf"], coarse_t,
                       x["Rc"], x["Wc"], x["dh"], x["N"], dmeta, nr, nfb,
                       srows, 1, 1)

    def same_tables(x, shape):
        got = sc_new(x)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, x["old"])):
            raise AssertionError(f"{shape}: the tables differ")

    # the plan's choice between slices and atomics: (MAX_COLUMN_SLICES,
    # COLUMN_SHARE); "atomics" gives every column to the coarse blocks,
    # "slices" none
    plans = {"default": (tp.MAX_COLUMN_SLICES, tp.COLUMN_SHARE),
             "atomics": (0, 1), "slices": (1 << 30, 1), "max_2": (2, 8),
             "max_8": (8, 8), "share_4": (4, 4), "share_16": (4, 16)}

    def sweep(x, shape):
        """The new flush under each plan rule: its slices, the runs left
        to the coarse blocks and its card ms (tables equal the old)."""
        for tag, (m, c) in plans.items():
            tp.MAX_COLUMN_SLICES, tp.COLUMN_SHARE = m, c
            same_tables(x, f"{shape} {tag}")
            meta, nr, nfb, _ = tp.pruned_plan(
                x["runs"], x["N"], x["grp_bin_size"], x["grp_row_off"],
                x["Wf"])
            summary[shape][tag] = {
                "fine_slices": nfb,
                "atomic_runs": int((meta[4 * nr + 1:5 * nr + 1] > 0).sum()),
                "queued_ms": queued_ms(lambda: launch_new(x)),
                "profiled_ms": smoke._profiled_ms(lambda: sc_new(x), 10)}
        tp.MAX_COLUMN_SLICES, tp.COLUMN_SHARE = plans["default"]

    if "pruned" in only:
        x = flush_inputs(rng.normal(2780, 40, size=8192).astype(np.int64))
        ab("scatter_pruned", lambda: sc_old(x), lambda: sc_new(x),
           dict(x["info"]), runs=10, queued_new=lambda: launch_new(x))
        sweep(x, "scatter_pruned")

        def flush_old():
            """The earlier flush: the runs expanded by np.repeat, three
            arrays copied, two launches."""
            h = u64_to_torch(x["hashes"]).to(cuda)
            gg = torch.from_numpy(np.repeat(x["runs"][:, 1].astype(
                np.int32), x["lens"])).to(cuda)
            bit = torch.from_numpy(np.repeat(x["runs"][:, 2].astype(
                np.int32), x["lens"])).to(cuda)
            old_fine(x, h, gg, bit)
            old_coarse(x, h, gg)
            return x["old"]

        def flush_new():
            tp.scatter_pruned(*x["new"], u64_to_torch(x["hashes"]).to(cuda),
                              x["runs"], **x["kw"])
            return x["new"][0].t(), x["new"][1].t()

        ab("flush", flush_old, flush_new, dict(x["info"]), runs=5)
        summary["old_fine"] = {"profiled_ms": smoke._profiled_ms(
            lambda: old_fine(x, x["dh"], x["dgrp"], x["dlane"]), 10)}
        summary["old_coarse"] = {"profiled_ms": smoke._profiled_ms(
            lambda: old_coarse(x, x["dh"], x["dgrp"]), 10)}
        # the new kernel's coarse blocks alone (no fine slice: nfb 0), and
        # the build's one transpose of each staged table back to rows
        meta, nr, _, srows = tp.pruned_plan(
            x["runs"], x["N"], x["grp_bin_size"], x["grp_row_off"], x["Wf"])
        dmeta = torch.from_numpy(meta).to(cuda)
        fine_t, coarse_t = x["new"]
        summary["new_coarse_only"] = {"profiled_ms": smoke._profiled_ms(
            lambda: kernels.launch(
                "scatter_pruned", fine_t, x["Rf"], x["Wf"], coarse_t,
                x["Rc"], x["Wc"], x["dh"], x["N"], dmeta, nr, 0, srows, 1,
                1), 10)}
        summary["transpose_fine"] = {"profiled_ms": smoke._profiled_ms(
            lambda: fine_t.t().contiguous(), 10)}
        summary["transpose_coarse"] = {"profiled_ms": smoke._profiled_ms(
            lambda: coarse_t.t().contiguous(), 10)}
        base = tp.SLICE_BYTES
        for sb in (28 << 10, 56 << 10, 112 << 10, 216 << 10):
            tp.SLICE_BYTES = sb
            same_tables(x, f"slice {sb}")
            summary[f"slice_{sb}"] = {
                "fine_slices": tp.pruned_plan(
                    x["runs"], x["N"], x["grp_bin_size"], x["grp_row_off"],
                    x["Wf"])[2],
                "profiled_ms": smoke._profiled_ms(lambda: sc_new(x), 10)}
        tp.SLICE_BYTES = base
        del x, dmeta, fine_t, coarse_t

    if "pruned_big" in only:
        # genome-sized targets, 128 of them in groups of 64 (the flush in
        # the first group), and 512 of 15K hashes in groups of 16 (a
        # column 1/17 of the flush, 6 slices)
        for kh, gs, T in ((5, 64, 128), (10, 64, 128), (20, 64, 128),
                          (50, 64, 128), (200, 64, 128), (700, 64, 128),
                          (15, 16, 512)):
            x = flush_inputs(rng.normal(kh * 1000, kh * 30, size=T)
                             .astype(np.int64), gs)
            shape = f"pruned_{kh}k" + ("" if gs == 64 else f"_g{gs}")
            ab(shape, lambda: sc_old(x), lambda: sc_new(x), dict(x["info"]),
               runs=10, queued_new=lambda: launch_new(x))
            sweep(x, shape)
            del x
            torch.cuda.empty_cache()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for shape, info in summary.items():
        mine_all = [t for t in turns if t["shape"] == shape]
        for side in ("old", "new") if mine_all else ():
            mine = [t for t in mine_all if t["side"] == side]
            info[side] = {}
            for m in ("ms", "queued_ms", "profiled_ms", "host_us"):
                vals = [t[m] for t in mine if t[m] is not None]
                info[side][m] = statistics.median(vals) if vals else None
    print(smi)
    print(json.dumps({"gpu": smi, "median": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
