"""Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

The kernels compile with ``nvcc`` into one content-addressed shared
library under the checkout's ``build/`` directory at first use, with a
plain C interface loaded through ctypes (no torch headers, so a build
takes seconds). Every pointer and the stream are passed as
``ctypes.c_void_p``; kernels launch on ``torch.cuda.current_stream()``
and each C entry returns ``cudaGetLastError()``, which :func:`launch`
turns into an exception.

``LAUNCHES`` counts kernel launches (one per :func:`launch`) per kernel
and mode: ``count_forest`` is ``count`` writing into a column range of a
shared matrix, ``count_raptor`` is ``count`` in column-max mode (a raptor
sub-IBF's targets max-merged into their columns: one launch a sub, or one
launch a batch for every sub of an archive), ``count_ring`` is the flat
``count`` on its ring route (``ops.ibf_query.count_route``: rows of 96
to 512 words; the recorder's ``count.ring_launches`` counts the route's
launches in every mode), ``select_winners`` is
``select`` with the winners payload, ``select32`` is ``select`` in its
32-bit mode (two [B*K] blocks of counts and ids: ``--longreads``, more
than 65,535 targets),
``fine_all`` is ``fine`` over every group (the pruned forest's probe-all
path); ``gate``, ``fine``, ``select_lanes`` and ``scatter_pruned`` (both
tables of a build flush in one launch) are the pruned forest's;
``extract_build`` is ``extract`` on the build's pieces (single-end, a
capacity of every window position); ``extract_wide`` is
``extract``'s route for windows too wide for a tile's shared memory
(one warp a read), whichever caller asked; ``pack``, ``sort_hist``
(the digit histograms that start each sort), ``sort``, ``dedup`` (its
counts mode, pass 1) and ``scatter_ranked`` (pass 2: first occurrences,
ranks, bins and bits in one call) are the two-pass device build's;
``dedup_rank`` is dedup's rank mode (flags and ranks in one chained
scan), which no build path runs since the ranked scatter ranks in its
own call.
The device mesh's modes (K17): ``count_shard`` is ``count`` on one
column shard of a table with the clamp off, ``combine`` adds the shards'
partials and clamps, ``fine_shard`` is ``fine`` over one shard's groups
of a bins-sharded pruned forest, ``scatter_span`` is ``scatter_ranked``
into one shard's row range of the build's bit-matrix.
The ``ops`` library API (K18): ``minimizers`` is ``extract`` in
single-end mode for ``ganon_tpu_torch.ops.library.minimizers``; ``bins``,
``tsum`` and ``bins_target`` count the interleaved bit-matrix
(``csrc/bins.cu``); ``tsum_plan`` finds ``tsum``'s bin window of each
target tile past the first. The JAX engine's default transfer settings:
``ragged`` compacts ``select``'s dense buffer into the ragged match
stream (``ragged_winners`` with the winners block of a multi-filter
level), ``pairs`` compacts a pruned batch's (read, slot) pairs under
the pair cap (``csrc/scan.cu``): both chained scans, as are ``extract``,
``dedup_rank``, the ranked scatter's stage step and ``pack``,
whose status words and epochs :func:`scan_status` hands out, one buffer
a device and stream; ``probe_sort`` orders each read's
hashes by their first row before ``count`` (``csrc/psort.cu``);
``gather_probe`` is the port of the Pallas gather probe
(``csrc/gprobe.cu``); ``repack`` writes a filter's query table (or one
column shard of it) from its interleaved bit-matrix at load
(``csrc/repack.cu``).
A run can so show that its main path went through every kernel mode.
Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import shutil
import subprocess

import torch

from ganon_tpu_torch import BUILD_DIR, trace

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = ("extract.cu", "count.cu", "merge.cu", "select.cu", "scatter.cu",
           "gate.cu", "fine.cu", "sort.cu", "dedup.cu", "shard.cu", "bins.cu",
           "scan.cu", "psort.cu", "gprobe.cu", "repack.cu")
HEADERS = ("ibf_hash.cuh", "scan.cuh", "dedup.cuh", "warp_bits.cuh",
           "sm_count.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_P, _I, _L, _U, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_uint64, ctypes.c_double)
# C entry points: name -> argtypes (the stream is always the last pointer)
_SIGNATURES = {
    # inbuf, B, row_bytes, L1, L2, k, w, mc, zero_tail, status, epoch,
    # hashes, n, overflow
    "extract": (_P, _L, _L, _I, _I, _I, _I, _I, _I, _P, _U, _P, _P, _P),
    # inbuf, B, row_bytes, L1, L2, k, w, mc, hashes, n, overflow (windows
    # past a tile's shared memory)
    "extract_wide": (_P, _L, _L, _I, _I, _I, _I, _I, _P, _P, _P),
    # tbl, R, W8, byte_starts, byte_ends, T, hashes, B, M, n_hashes,
    # bin_size, h, shift, counts, ldc, col0, cols (NULL = not column-max),
    # clamp (0 = a shard's partial sums), ring (1 = the ring route)
    "count": (_P, _L, _L, _P, _P, _I, _P, _L, _I, _P, _U, _I, _I, _P, _L,
              _I, _P, _I, _I),
    # subs (int64 [S, 9] descriptors), S, hmax, wmax, hashes, B, M,
    # n_hashes, counts, T: every sub of a raptor archive in one launch
    "count_raptor": (_P, _I, _I, _L, _P, _L, _I, _P, _P, _L),
    # parts, parts_n, t_lo, t_hi (host int32 [nb]: passed to the kernel by
    # value), nb, B, T, n_hashes, counts, ldc, col0, cols (NULL = not
    # column-max)
    "combine": (_P, _L, _P, _P, _I, _L, _I, _P, _P, _L, _I, _P),
    # n_hashes, B, counts, tf, rel_cutoffs (host int64 pointers, int32
    # T_f and doubles [nf]: passed to the kernel by value), nf, f0,
    # hashes_limit, colmap, U, init (0 = merge into ucounts/uwin),
    # ucounts, uwin
    "merge": (_P, _L, _P, _P, _P, _I, _I, _L, _P, _I, _I, _P, _P),
    # counts, B, T, n_hashes, overflow, rel_cutoff, rel_filter,
    # hashes_limit, K, emit_matches_t, uwin (NULL = no winners), packed
    "select": (_P, _L, _I, _P, _P, _D, _D, _L, _I, _I, _P, _P),
    # counts, B, T, n_hashes, overflow, rel_cutoff, rel_filter,
    # hashes_limit, K, emit_matches_t, packed (the 32-bit mode)
    "select32": (_P, _L, _I, _P, _P, _D, _D, _L, _I, _I, _P),
    # bits, rows, W, row0 (the first row bits holds), hashes, bins, N,
    # bin_size, h, shift, c0, band (the word columns of the bins), cw, rpt
    # (a tile's columns and rows), loc, items (scratch)
    "scatter": (_P, _L, _L, _L, _P, _P, _L, _U, _I, _I, _L, _L, _L, _L, _P,
                _P),
    # counts, B, C, n_hashes, overflow, rel_cutoff, rel_filter,
    # hashes_limit, K, emit_matches_t, gsel, slot_ok, grp_ntargets, S, gs,
    # T, packed
    "select_lanes": (_P, _L, _I, _P, _P, _D, _D, _L, _I, _I, _P, _P, _P, _I,
                     _I, _I, _P),
    # fine_t, Rf, Wf, coarse_t, Rc (the coarse bin size), Wc (the tables by
    # word column, [Wf, Rf] and [Wc, Rc]), hashes, N, meta
    # (index.pruned.pruned_plan), nr, nfb, slice_rows, fine_h, coarse_h
    "scatter_pruned": (_P, _L, _L, _P, _L, _L, _P, _L, _P, _I, _I, _L, _I,
                       _I),
    # ctbl, R, W8, hashes, B, M, n_hashes, bin_size, h, shift, G,
    # rel_cutoff, hashes_limit, S, overflow_in, gsel, slot_ok,
    # overflow_out, surv (NULL = not written)
    "gate": (_P, _L, _L, _P, _L, _I, _P, _U, _I, _I, _I, _D, _L, _I, _P, _P,
             _P, _P, _P),
    # ftbl, R, W8, hashes, B, M, n_hashes, grp_row_off, grp_bin_size,
    # grp_shift, G, h, gs, gsel (NULL = probe-all), slot_ok, S, surv
    # (NULL = ungated), out, T, gid (NULL = not a shard), Gs
    "fine": (_P, _L, _L, _P, _L, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _I,
             _P, _P, _L, _P, _I),
    # hashes, B, mc, n, keys, status, epoch, out_key, out_val, N
    "pack": (_P, _L, _I, _P, _P, _P, _U, _P, _P, _L),
    # key, val, N, D (digits), hist ([2, D, 256]: counts, offsets)
    "sort_hist": (_P, _P, _L, _I, _P),
    # key, val, N, digits (bit d: run digit d's pass), offs (hist[1]),
    # key_a, val_a, key_b, val_b, status (scratch)
    "sort": (_P, _P, _L, _I, _P, _P, _P, _P, _P, _P),
    # key, val, N, R, uniq, rank (NULL = counts mode), counts (NULL =
    # none), status, epoch
    "dedup": (_P, _P, _L, _I, _P, _P, _P, _P, _U),
    # bits, rows, W, row0, key, val, start, end, params, R, bin_size, h,
    # shift, c0, band, cw, rpt, status, epoch, carry_in, carry_out, loc,
    # items (scratch)
    "scatter_ranked": (_P, _L, _L, _L, _P, _P, _L, _L, _P, _I, _U, _I, _I,
                       _L, _L, _L, _L, _P, _U, _P, _P, _P, _P),
    # bits, R, W, rows, B, M, S, mask, out
    "bins": (_P, _L, _L, _P, _L, _I, _I, _P, _P),
    # bin_counts, B, TB, bin_to_target, T, TT (the tile width), win (the
    # tiles' bin windows; NULL at one tile), out
    "tsum": (_P, _L, _L, _P, _I, _I, _P, _P),
    # bin_to_target, TB, T, TT, win (out: [lo, hi) a tile)
    "tsum_plan": (_P, _L, _I, _I, _P),
    # bits, R, W, rows, B, M, S, mask, scratch (NULL = one launch, the
    # counts in shared memory), perm (NULL = identity), starts, ends, T,
    # out
    "bins_target": (_P, _L, _L, _P, _L, _I, _I, _P, _P, _P, _P, _P, _I, _P),
    # dense, B, K, has_win, n_extra, tail, C, status, epoch, out
    "ragged": (_P, _L, _I, _I, _I, _L, _L, _P, _U, _P),
    # slot_ok, B, S, P, overflow, status, epoch, live, overflow out
    "pairs": (_P, _L, _I, _L, _P, _P, _U, _P, _P),
    # hashes, B, M, n_hashes, bin_size, shift, out
    "probe_sort": (_P, _L, _I, _P, _U, _I, _P),
    # tbl, R, rows, N, partials, max_blocks (the partials' rows), status,
    # out
    "gather_probe": (_P, _L, _P, _L, _P, _I, _P, _P),
    # bits, R, W, runs, col_runs, n_dst (the plan's destination bits),
    # tiles, n_tiles, c0w (the first word column), wc (the output's words
    # a row), cq, nrb, stage_words, desc_cap, col_cap
    # (ops.ibf_query.repack_geometry), tbl
    "repack": (_P, _L, _L, _P, _P, _L, _P, _I, _L, _L, _I, _I, _I, _I, _I,
               _P),
}

# launch counters: each kernel, plus the modes counted apart
LAUNCHES = {name: 0 for name in (*_SIGNATURES, "dedup_rank", "count_forest",
                                 "count_raptor", "count_ring",
                                 "select_winners",
                                 "fine_all", "extract_build", "count_shard",
                                 "fine_shard", "scatter_span", "minimizers",
                                 "ragged_winners")}

_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> str:
    """Content-addressed path of the kernel library (sources + flags)."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"ganon_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless the content-addressed library exists
    (span ``kernels.build``; counter ``kernels.builds``, the compiles).

    One ``nvcc -c`` per source, all started together, then one link.
    """
    with trace.span("kernels.build"):
        so = library_path()
        if os.path.exists(so):
            return so
        trace.count("kernels.builds")
        _compile(so)
    return so


def _compile(so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [f"{so}.{s}.{tag}.o" for s in SOURCES]
    nvcc = nvcc_path()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, os.path.join(_CSRC, s)]
            for s, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    fails = []
    for c, p in zip(cmds, procs):
        _, err = p.communicate()
        if p.returncode != 0:
            fails.append(f"nvcc failed ({p.returncode}): {' '.join(c)}\n{err}")
    try:
        if fails:
            raise RuntimeError("\n".join(fails))
        tmp = f"{so}.{tag}"
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({res.returncode}): {' '.join(cmd)}\n"
                f"{res.stderr}")
        os.replace(tmp, so)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, f"ganon_{name}")
            fn.argtypes = list(argtypes) + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.ganon_set_device.argtypes = [ctypes.c_int]
        lib.ganon_set_device.restype = ctypes.c_int
        lib.ganon_extract_blocks_per_sm.argtypes = [ctypes.c_int] * 2
        lib.ganon_extract_blocks_per_sm.restype = ctypes.c_int
        lib.ganon_repack_blocks_per_sm.argtypes = [ctypes.c_int]
        lib.ganon_repack_blocks_per_sm.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is contiguous and on one CUDA device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        # (asked only here: a CUDA tensor means a CUDA device)
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA tensors given but no CUDA device is "
                               "available")
        raise ValueError(f"tensors must share one CUDA device, got {devs}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel arguments must be contiguous tensors")


def launch(name: str, *args, counter: str | None = None) -> None:
    """Launch kernel ``name`` on the current stream and count it (under
    ``counter``, default ``name``).

    Tensor arguments pass their data pointers (``None`` passes NULL);
    the caller keeps them alive (they are its outputs or inputs) while
    the kernel runs.
    """
    lib = library()
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    # the library's CUDA runtime keeps its own current device
    err = lib.ganon_set_device(device.index)
    if err != 0:
        raise RuntimeError(f"cudaSetDevice({device.index}) failed: error {err}")
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    # the raw handle of torch.cuda.current_stream(device), without building
    # a Stream object (microseconds a launch on the host)
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    err = getattr(lib, f"ganon_{name}")(*cargs, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")
    LAUNCHES[counter or name] += 1


# The chained scans' status words (csrc/scan.cuh): one buffer per (device,
# stream), shared by ``ragged``, ``pairs``, ``extract``, ``dedup_rank``,
# ``scatter_ranked`` (its stage step) and ``pack`` (and the counter alone
# by ``gather_probe``, its last block's ticket); made zero and
# written only by those kernels, every call tagged with a new epoch
# (csrc/scan.cu says why that is safe)
_SCAN_STATUS: dict = {}
_SCAN_EPOCHS = itertools.count(1)
EPOCH_LIMIT = 1 << 31
# the least buffer made, in words
SCAN_STATUS_MIN = 64


def scan_status(device: torch.device, blocks: int):
    """(status buffer of at least ``blocks + 1`` int64 words, epoch) for a
    chained-scan launch of ``blocks`` blocks on ``device``'s current
    stream.

    The buffer is kept per (device, stream) and grows to the largest grid
    asked for; the epoch is new for every call (when the epochs wrap,
    every buffer is made anew, zero). A CPU device keys on stream 0.
    """
    epoch = next(_SCAN_EPOCHS) % EPOCH_LIMIT
    if not epoch:  # the epochs wrapped: every buffer is made anew
        _SCAN_STATUS.clear()
        epoch = next(_SCAN_EPOCHS) % EPOCH_LIMIT
    stream = (torch._C._cuda_getCurrentRawStream(device.index)
              if device.type == "cuda" else 0)
    key = (device.type, device.index, stream)
    buf = _SCAN_STATUS.get(key)
    if buf is None or buf.numel() < blocks + 1:
        buf = _SCAN_STATUS[key] = torch.zeros(
            (max(blocks + 1, SCAN_STATUS_MIN),), dtype=torch.int64,
            device=device)
    return buf, epoch
