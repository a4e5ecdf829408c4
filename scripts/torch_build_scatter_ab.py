#!/usr/bin/env python3
"""A/B of the port's build write path, ``dedup.cu`` and ``scatter.cu``:
this checkout's kernels against an earlier version's, in one process on
the card.

    mkdir -p chip_proof/old
    for f in dedup.cu sort.cu scatter.cu ibf_hash.cuh; do
        git show <rev>:ganon_tpu_torch/csrc/$f > chip_proof/old/$f
    done
    python scripts/torch_build_scatter_ab.py --old chip_proof/old [--reps 2]

The earlier ``dedup.cu`` (with the ``sort.cu`` whose three-kernel scan it
calls) and ``scatter.cu`` are built with nvcc into ``build/`` and called
through ctypes with their own C signatures (the one-thread-a-pair
``atomicOr`` scatter, the flag kernel and scan, given below). This
checkout's kernels run through their wrappers. Inputs are made on the
card from ``--seed`` at the shapes of PERF.md's kernel table: the first
pass-1 group of the 1.024 Gbp build (133 files, 18,570,459 entries, k 19
values below 2^38, ~0.5% repeated, sorted by (file, value)) and the
1024-target filter's matrix (``sizing.size_filter`` at that group's
distinct counts a file: rows, words and h):

* ``dedup_counts``: pass 1's per-file counts (the earlier kernel also
  wrote the [N] flags);
* ``dedup_rank``: the flags and ranks (the earlier: flags, then the
  three-kernel scan);
* ``pass2``: pass 2's chain, flags and ranks then the ranked scatter
  into the whole matrix (the earlier: ``dedup`` then ``scatter_ranked``;
  the new: one ``scatter_ranked`` call);
* ``span``: the ranked scatter into the second of four row spans, as the
  mesh build runs it (the earlier given the flags and ranks, which it
  computed once a group; ``old_with_dedup`` adds them);
* ``scatter``: K9, the first 4,194,304 (hash, bin) pairs of the flat
  library build's flush order (the group's distinct entries, target by
  target);
* ``k9_flush``: the new K9 over the first 16,777,216 of those pairs, as
  flushes of 4M (``index/ibf.py`` ``SCATTER_CHUNK``), 8M and 16M pairs,
  each flush with its own bins' word columns.

Each shape runs old, new, new, old per rep (a call between two CUDA
events, median, and the card's activity a call under torch.profiler);
the new outputs must equal the old. The new scatters take the word
columns of their bins, as the build passes them (``ranked_word_cols``;
a flush's bins); side ``new_all_cols`` times them with every column
(``word_cols=None``), and ``--tile-words`` at other tile sizes
(``build_ops.TILE_WORDS``); each such side must equal ``new``. For each
scatter the line gives the bit inserts (N x h), the distinct words and
the distinct 32-byte sectors they touch. One JSON line a turn, then the
card's name and power limit and the medians. Needs one CUDA card.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the group's shape (PERF.md's kernel table)
FILES = 133
ENTRIES = 18_570_459
TARGETS = 1024
PAIRS = 4 << 20
FLUSHES = (4 << 20, 8 << 20, 16 << 20)
VALUE_BITS = 38


def _smoke():
    """chip_smoke.py of this checkout, for its timing helpers."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _old_library(srcs: list[str]) -> ctypes.CDLL:
    """Build earlier sources into one library in ``build/`` and load it
    (headers from their own directory)."""
    from ganon_tpu_torch import BUILD_DIR, kernels

    h = hashlib.sha1()
    for src in srcs:
        with open(src, "rb") as f:
            h.update(f.read())
    name = "_".join(os.path.basename(s).split(".")[0] for s in srcs)
    so = os.path.join(BUILD_DIR, f"ab_old_{name}_{h.hexdigest()[:12]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-shared",
                        "-o", so, *srcs], check=True)
    return ctypes.CDLL(so)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True,
                    help="directory of the earlier dedup.cu, sort.cu, "
                    "scatter.cu and ibf_hash.cuh")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=31)
    ap.add_argument("--tile-words", default="",
                    help="comma-separated TILE_WORDS values to time the new "
                    "scatters at besides the default")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2

    from ganon_tpu_torch.index import device_build as dbuild
    from ganon_tpu_torch.index import sizing
    from ganon_tpu_torch.index.ibf import scatter_hashes
    from ganon_tpu_torch.ops import build_ops as bo
    from ganon_tpu_torch.ops import ibf_query as q

    smoke = _smoke()
    cuda = torch.device("cuda")
    g = torch.Generator(device=cuda).manual_seed(args.seed)
    P, L, I, U = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                  ctypes.c_uint64)
    old_d = _old_library([os.path.join(args.old, "dedup.cu"),
                          os.path.join(args.old, "sort.cu")])
    old_s = _old_library([os.path.join(args.old, "scatter.cu")])
    # the earlier C signatures (stream last)
    for lib, name, sig in (
            (old_d, "dedup", (P, P, L, I, P, P, P, P)),
            (old_s, "scatter", (P, L, L, P, P, L, U, I, I)),
            (old_s, "scatter_ranked", (P, L, L, P, P, P, P, L, P, I, U, I, I,
                                       L))):
        fn = getattr(lib, f"ganon_{name}")
        fn.argtypes = list(sig) + [P]
        fn.restype = ctypes.c_int

    def call_old(lib, name, *a):
        cargs = [x.data_ptr() if isinstance(x, torch.Tensor) else x
                 for x in a]
        err = getattr(lib, f"ganon_{name}")(
            *cargs, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old {name}: error {err}")

    # the group: FILES files of ENTRIES entries, sorted by (file, value)
    per = torch.full((FILES,), ENTRIES // FILES, dtype=torch.int64)
    per[: ENTRIES % FILES] += 1
    key = torch.repeat_interleave(torch.arange(FILES, dtype=torch.int32),
                                  per).to(cuda)
    val = torch.randint(0, 1 << VALUE_BITS, (ENTRIES,), generator=g,
                        device=cuda, dtype=torch.int64)
    rep = torch.randint(1, ENTRIES, (ENTRIES // 200,), generator=g,
                        device=cuda)
    val[rep] = val[rep - 1]
    comp = torch.sort((key.to(torch.int64) << VALUE_BITS) | val).values
    key = (comp >> VALUE_BITS).to(torch.int32)
    val = comp & ((1 << VALUE_BITS) - 1)
    del comp, rep
    N = ENTRIES
    counts = torch.zeros((FILES,), dtype=torch.int32, device=cuda)
    uniq, rank = bo.dedup_plain(key, val, num_files=FILES, counts=counts)
    c = counts.cpu().numpy()
    # the 1024-target filter: every target as large as the group's mean
    hc = {f"T{t}": int(c[t]) if t < FILES else int(c.mean())
          for t in range(TARGETS)}
    cfg = sizing.size_filter(hc, kmer_size=19, window_size=31, max_fp=0.05)
    splits = sizing.split_target_bins(cfg, hc)
    split = dbuild.target_bins(splits)
    R, hf = cfg.bin_size_bits, cfg.hash_functions
    W = sizing.optimal_bins(cfg.n_bins) // 32
    params = torch.zeros((4, FILES), dtype=torch.int32)
    for f in range(FILES):
        params[:, f] = torch.tensor((*split[f"T{f}"], 0, int(c[:f].sum())))
    params = params.to(cuda)
    kw = dict(bin_size=R, hash_functions=hf)
    cols = bo.ranked_word_cols(params.cpu().numpy(), c)
    # K9's pairs: the distinct entries target by target, with their bins
    ubins = params[0][key[uniq.bool()].to(torch.int64)]
    ph = val[uniq.bool()][:PAIRS].contiguous()
    pb = ubins[:PAIRS].contiguous()
    del ubins
    rps = -(-R // 4)
    span_rows = min(rps, R - rps)
    geometry = {"entries": N, "files": FILES, "distinct": int(uniq.sum()),
                "rows": R, "words_a_row": W, "h": hf,
                "matrix_bytes": R * W * 4, "pairs": int(ph.numel()),
                "span_rows": [rps, rps + span_rows], "word_cols": cols,
                "tile_words": bo.TILE_WORDS}
    print(json.dumps({"geometry": geometry}), flush=True)

    def touched(rows, words):
        """bit inserts, distinct words and distinct 32-byte sectors."""
        u = torch.unique(words)
        return {"inserts": int(rows.numel()), "words": int(u.numel()),
                "sectors": int(torch.unique(u >> 3).numel())}

    rows_u = q.ibf_row_indices(val[uniq.bool()], **kw)
    _, bins_u = bo._ranked_bins(key, uniq, rank, params)
    words_u = rows_u * W + (bins_u >> 5)[:, None]
    ranked_work = touched(rows_u, words_u)
    in_span = (rows_u >= rps) & (rows_u < rps + span_rows)
    span_work = touched(rows_u[in_span], words_u[in_span])
    prows = q.ibf_row_indices(ph, **kw)
    pair_work = touched(prows, prows * W + (pb >> 5).to(torch.int64)[:, None])
    del rows_u, bins_u, words_u, in_span, prows
    torch.cuda.empty_cache()

    turns, summary = [], {}

    def profiled(fn, runs):
        """(card ms a call, {kernel: card ms a call}) under torch.profiler"""
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        busy, totals = smoke._device_busy(prof)
        return busy / runs / 1e3, {k: v / runs / 1e3
                                   for k, v in sorted(totals.items())}

    def record(shape, side, fn, reps=10, runs=10):
        card, split = profiled(fn, runs)
        turns.append({"shape": shape, "side": side,
                      "ms": smoke._ms(fn, reps), "profiled_ms": card,
                      "kernels_ms": split})
        print(json.dumps(turns[-1]), flush=True)

    def ab(shape, old, new, info, extra=None):
        a, b = old(), new()
        torch.cuda.synchronize()
        a, b = (a if isinstance(a, tuple) else (a,)), (
            b if isinstance(b, tuple) else (b,))
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{shape}: the new kernel differs from the "
                                 "old")
        for side, fn in (extra or {}).items():
            c = fn()
            c = c if isinstance(c, tuple) else (c,)
            if not all(torch.equal(x, y) for x, y in zip(b, c)):
                raise AssertionError(f"{shape}: {side} differs from new")
        summary[shape] = info
        sides = {"old": old, "new": new, **(extra or {})}
        order = ["old", "new", *(extra or {}), *(extra or {}), "new", "old"]
        for _ in range(args.reps):
            for side in order:
                record(shape, side, sides[side])

    cnt = [torch.zeros_like(counts) for _ in range(2)]
    ubuf = torch.empty((N,), dtype=torch.int32, device=cuda)
    rbuf = torch.empty_like(ubuf)
    # the earlier dedup's scratch: an int64 sum a scan block of 2048
    sums = torch.empty((-(-N // 2048),), dtype=torch.int64,
                       device=cuda)

    def old_counts():
        call_old(old_d, "dedup", key, val, N, FILES, ubuf, None,
                 cnt[0].zero_(), sums)
        return cnt[0]

    def new_counts():
        bo.dedup(key, val, num_files=FILES, counts=cnt[1].zero_(),
                 want_rank=False)
        return cnt[1]

    ab("dedup_counts", old_counts, new_counts,
       {"entries": N, "files": FILES})

    def old_rank():
        call_old(old_d, "dedup", key, val, N, FILES, ubuf, rbuf, None, sums)
        return ubuf, rbuf

    ab("dedup_rank", old_rank,
       lambda: bo.dedup(key, val, num_files=FILES), {"entries": N})

    bits = [torch.zeros((R, W), dtype=torch.int32, device=cuda)
            for _ in range(2)]

    def old_ranked(out, w0=0, with_dedup=True):
        if with_dedup:
            old_rank()
        call_old(old_s, "scatter_ranked", out, out.shape[0], W, key, val,
                 ubuf, rbuf, N, params, FILES, R, hf, q.clz64(R), w0)
        return out

    def new_ranked(out, w0=None, word_cols=cols):
        bo.scatter_ranked(out, key, val, None, None, params, **kw, w0=w0,
                          word_cols=word_cols)
        return out

    def tiles_extra(fn, like):
        """fn(out) at each --tile-words value, each into a matrix of its
        own."""
        out = {}
        for tw in filter(None, args.tile_words.split(",")):
            def at(tw=int(tw), buf=torch.zeros_like(like)):
                keep, bo.TILE_WORDS = bo.TILE_WORDS, tw
                try:
                    return fn(buf)
                finally:
                    bo.TILE_WORDS = keep
            out[f"new_tile_{tw}"] = at
        return out

    all_cols = torch.zeros_like(bits[1])
    ab("pass2", lambda: old_ranked(bits[0]), lambda: new_ranked(bits[1]),
       ranked_work, extra={
           "new_all_cols": lambda: new_ranked(all_cols, word_cols=None),
           **tiles_extra(new_ranked, bits[1])})
    del all_cols
    sbits = [torch.zeros((span_rows, W), dtype=torch.int32, device=cuda)
             for _ in range(2)]
    old_rank()
    ab("span", lambda: old_ranked(sbits[0], rps * W, with_dedup=False),
       lambda: new_ranked(sbits[1], rps * W), span_work,
       extra={"old_with_dedup": lambda: old_ranked(sbits[0], rps * W)})
    if not torch.equal(sbits[1], bits[1][rps:rps + span_rows]):
        raise AssertionError("span: the span differs from the matrix's rows")
    del sbits, bits
    torch.cuda.empty_cache()
    kbits = [torch.zeros((R, W), dtype=torch.int32, device=cuda)
             for _ in range(2)]

    def old_k9():
        call_old(old_s, "scatter", kbits[0], R, W, ph, pb, ph.numel(), R, hf,
                 q.clz64(R))
        return kbits[0]

    pcols = (int(pb.min()) >> 5, (int(pb.max()) >> 5) + 1)

    def new_k9(out=kbits[1], word_cols=pcols):
        scatter_hashes(out, ph, pb, **kw, word_cols=word_cols)
        return out

    all_cols = torch.zeros_like(kbits[1])
    ab("scatter", old_k9, new_k9, {**pair_work, "word_cols": pcols},
       extra={"new_all_cols": lambda: new_k9(all_cols, None),
              **tiles_extra(new_k9, kbits[1])})
    del kbits, ph, pb, all_cols
    torch.cuda.empty_cache()

    # K9 at larger flushes: the same pairs, cut into flushes of each size
    fh = val[uniq.bool()][:FLUSHES[-1]].contiguous()
    fb = params[0][key[uniq.bool()].to(torch.int64)][:FLUSHES[-1]].contiguous()
    flush_out = {}

    def flushes(size):
        cuts = [(s, fb[s:s + size], fh[s:s + size])
                for s in range(0, fb.numel(), size)]
        spans = [(int(b.min()) >> 5, (int(b.max()) >> 5) + 1)
                 for _, b, _ in cuts]
        out = flush_out.setdefault(size, torch.zeros(
            (R, W), dtype=torch.int32, device=cuda))

        def run():
            for (_, b, h), wc in zip(cuts, spans):
                scatter_hashes(out, h, b, **kw, word_cols=wc)
            return out
        return run

    runs = {f"flush_{n}": flushes(n) for n in FLUSHES}
    for fn in runs.values():
        fn()
    if not all(torch.equal(x, flush_out[FLUSHES[0]])
               for x in flush_out.values()):
        raise AssertionError("k9_flush: the flush sizes set different bits")
    summary["k9_flush"] = {"pairs": int(fh.numel()), "flushes": FLUSHES}
    order = [*runs, *reversed(runs)]
    for _ in range(args.reps):
        for side in order:
            record("k9_flush", side, runs[side])

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for shape, info in summary.items():
        for side in sorted({t["side"] for t in turns if t["shape"] == shape}):
            mine = [t for t in turns
                    if t["shape"] == shape and t["side"] == side]
            info[side] = {m: statistics.median(t[m] for t in mine)
                          for m in ("ms", "profiled_ms")}
            info[side]["kernels_ms"] = mine[-1]["kernels_ms"]
    print(smi)
    print(json.dumps({"gpu": smi, "geometry": geometry, "median": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
