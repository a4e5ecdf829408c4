"""Index construction engine (ganon-build equivalent).

Port of ``ganon_tpu.index.builder``. :func:`run_build` reads a
``target_info`` table (``file [<tab> target]`` rows, GanonBuild.cpp:
86-136), runs the two-pass device build
(:class:`~ganon_tpu_torch.index.device_build.DeviceBuildPipeline`),
sizes the filter and saves it. Reference behaviours kept: hashes are
deduplicated per *file* (duplicates across files of one target are
stored and counted twice, GanonBuild.cpp:225-240), sequences shorter
than ``min_length`` are skipped, a missing or empty input file is a
warning.

The host-array extraction (``_HashExtractor``, ``sequence_hashes``,
:func:`count_target_hashes`) serves the hierarchical builds. Sequences are cut into pieces
with ``w - 1`` bases of overlap, so every window lies in exactly one
piece, and the pieces go through the ``extract`` kernel in single-end
mode with a capacity of every window position (it never overflows). The
set of emitted minimizers equals the set of window minima, so the
per-target ``np.unique`` of the emissions is the target's minimizer set,
as ``ganon_tpu``'s ``finish`` computes it (there with ``np.unique``;
here with the same sort-based result, see :func:`_sorted_unique`).

The pieces are shorter than the JAX package's 256 kbp chunks: the
kernel walks one piece per thread, and many short pieces keep every SM
busy. The piece length changes no result.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ganon_tpu_torch import trace
from ganon_tpu_torch.classify.device import pack_codes_2bit
from ganon_tpu_torch.index.ibf import IBF
from ganon_tpu_torch.io.sequence import SequenceReader
from ganon_tpu_torch.ops.ibf_query import extract
from ganon_tpu_torch.ops.winnow import encode_seqs, torch_to_u64

# bases per piece handed to one kernel thread (multiple of 4); a window
# wider than half of it gets pieces of 2w bases
PIECE = 1 << 11
# pieces per kernel launch
PIECES_PER_BATCH = 16384
# sequence chunk the readers yield (w - 1 bases of overlap); the
# extractors cut each into pieces of PIECE bases
CHUNK = 1 << 18
# chunks per reader batch
READ_BATCH = 32


@dataclass
class BuildStats:
    files: int = 0
    invalid_files: int = 0
    sequences: int = 0
    skipped_sequences: int = 0
    length_bp: int = 0


@dataclass
class BuildConfig:
    input_file: str = ""
    output_file: str = ""
    kmer_size: int = 19
    window_size: int = 31
    max_fp: float = 0.05
    filter_size: float = 0.0
    hash_functions: int = 0
    mode: str = "avg"
    min_length: int = 0
    threads: int = 1
    tpu_sizing: bool = True  # throughput-aware auto hash-function tuning
    hash_functions_defaulted: bool = False  # h=4 came from the CLI default
    quiet: bool = True
    verbose: bool = False
    # tpu (npz) | tpu-raw (mmap-able) | reference (cereal, cross-loadable)
    filter_format: str = "tpu"
    # the build's device: "cuda" (the card's kernels) or "cpu" (their
    # plain versions)
    device: str = "cuda"

    def validate(self):
        if not self.input_file:
            raise ValueError("--input-file is mandatory")
        if not self.output_file:
            raise ValueError("--output-file is mandatory")
        if self.hash_functions > 5:
            raise ValueError("--hash-functions must be <=5")
        if self.filter_size == 0 and self.max_fp == 0:
            raise ValueError("--max-fp or --filter-size is mandatory")
        if self.filter_size > 0:
            self.max_fp = 0
        if self.window_size < self.kmer_size:
            raise ValueError("--window-size has to be >= --kmer-size")
        if self.kmer_size > 32:
            raise ValueError("--kmer-size has to be <= 32")
        if self.mode not in ("avg", "smaller", "smallest", "faster", "fastest"):
            raise ValueError("invalid --mode")


def _build_mesh(cfg: BuildConfig):
    """A 1-D ``bins`` mesh over this process's devices of ``cfg.device``'s
    type (None with one device).

    The sharded scatter equals the single-device one bit for bit and
    divides per-device matrix memory and scatter traffic by the device
    count (see ``DeviceBuildPipeline.scatter``).
    """
    from ganon_tpu_torch.parallel import mesh as pmesh

    # local devices: each process builds from its own inputs
    kind = torch.device(cfg.device).type
    devices = [d for d in pmesh.local_devices() if d.type == kind]
    if len(devices) < 2:
        return None
    return pmesh.make_mesh(devices, batch_axis=1)


def parse_target_info(
    input_file: str, quiet: bool, stats: BuildStats
) -> dict[str, list[str]]:
    """``file [<tab> target]`` rows -> {target: [files]} (insertion order)."""
    input_map: dict[str, list[str]] = {}
    seen_files = set()
    with open(input_file) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            fields = line.split("\t")
            path = fields[0]
            seen_files.add(path)
            if not os.path.exists(path) or os.path.getsize(path) == 0:
                if not quiet:
                    print(
                        f"WARNING: input file not found/empty: {path}",
                        file=sys.stderr,
                    )
                stats.invalid_files += 1
                continue
            target = fields[1] if len(fields) >= 2 else os.path.basename(path)
            input_map.setdefault(target, []).append(path)
    stats.files = len(seen_files)
    return input_map


def _bucket(n: int, cap: int, minimum: int = 256) -> int:
    b = minimum
    while b < n:
        b *= 2
    return min(b, cap)


def piece_len(w: int) -> int:
    """Bases per piece: ``PIECE``, or 2w rounded up to x4 for wide windows."""
    return max(PIECE, -(-2 * w // 4) * 4)


def cut_pieces(row: np.ndarray, w: int, piece: int) -> list[np.ndarray]:
    """A dna4 row's pieces of ``piece`` bases with ``w - 1`` bases of
    overlap: every window lies in exactly one."""
    step = piece - (w - 1)
    return [row[s : s + piece] for s in range(0, len(row) - w + 1, step)]


def pack_pieces(pieces: list, L: int) -> np.ndarray:
    """The extract kernel's single-end input: u8 ``[B, L/4 + 4]``, each
    piece 2-bit packed into ``L`` bases, then its length (le-i32)."""
    B = len(pieces)
    codes = np.zeros((B, L), dtype=np.uint8)
    lengths = np.zeros((B,), dtype="<i4")
    for i, piece in enumerate(pieces):
        codes[i, : len(piece)] = piece
        lengths[i] = len(piece)
    return np.concatenate(
        [pack_codes_2bit(codes), lengths.view(np.uint8).reshape(B, 4)], axis=1)


class _HashExtractor:
    """Batched device minimizer extraction, deduplicated per key.

    ``add``/``add_encoded`` queue a sequence (str or dna4 ranks) under a
    key; pieces of equal bucket length are packed 2-bit into one buffer
    per launch. ``finish`` returns ``{key: sorted distinct minimizers}``
    as uint64 arrays.
    """

    def __init__(self, k: int, w: int, device="cuda"):
        self.k, self.w = k, w
        self.piece = piece_len(w)
        self.device = torch.device(device)
        self.bufs: dict[int, list] = {}    # bucket L -> [(key, codes)]
        self.out: dict[object, list] = {}  # key -> [np.uint64 arrays]

    def add(self, key, seq: str) -> None:
        if len(seq) < self.w:
            return
        enc, _ = encode_seqs([seq], max_len=len(seq))
        self.add_encoded(key, enc[0])

    def add_encoded(self, key, row: np.ndarray) -> None:
        """Add one dna4-encoded sequence (uint8 [n]), cut into pieces."""
        if len(row) < self.w:
            return
        for piece in cut_pieces(row, self.w, self.piece):
            L = _bucket(len(piece), self.piece)
            buf = self.bufs.setdefault(L, [])
            buf.append((key, piece))
            if len(buf) >= PIECES_PER_BATCH:
                self._submit(L)

    def _submit(self, L: int) -> None:
        buf = self.bufs.pop(L, [])
        if not buf:
            return
        inbuf = pack_pieces([piece for _, piece in buf], L)
        hashes, n, _ = extract(
            torch.from_numpy(inbuf).to(self.device), L1=L, L2=0,
            k=self.k, w=self.w, mc=L - self.w + 1, counter="extract_build",
            zero_tail=False,
        )
        keep = torch.arange(hashes.shape[1], device=self.device)[None, :] < n[:, None]
        vals = torch_to_u64(hashes[keep])
        counts = n.cpu().numpy()
        off = 0
        for (key, _), c in zip(buf, counts.tolist()):
            if c:
                self.out.setdefault(key, []).append(vals[off : off + c])
            off += c

    def finish(self) -> dict[object, np.ndarray]:
        for L in list(self.bufs):
            self._submit(L)
        return {
            key: _sorted_unique(np.concatenate(parts))
            for key, parts in self.out.items()
        }


def _sorted_unique(a: np.ndarray) -> np.ndarray:
    """``np.unique(a)`` by sort and adjacent compare. numpy >= 2.3 routes
    ``np.unique`` of uint64 through a hash table: 77 ms against 1.9 ms
    for this sort on 160k values, measured on the H100 machine's host
    (numpy 2.3.5), which made it the build's bottleneck."""
    a = np.sort(a)
    return a[np.concatenate(([True], a[1:] != a[:-1]))] if len(a) else a


def sequence_hashes(seq: str, k: int, w: int, device="cuda") -> np.ndarray:
    """Distinct minimizer values of one sequence."""
    ex = _HashExtractor(k, w, device)
    ex.add(0, seq)
    res = ex.finish()
    return res.get(0, np.empty(0, dtype=np.uint64))


def _use_native_reader(min_length: int) -> bool:
    if min_length >= CHUNK:
        return False
    try:
        from ganon_tpu_torch.native import NativeSeqReader

        return NativeSeqReader.available()
    except Exception:
        return False


def _file_piece_batches(
    path: str, window_size: int, min_length: int, use_native: bool
):
    """Yield ``(rows, (seqs, skipped, bp))`` batches for one file.

    ``rows`` is a list of dna4-encoded chunks of one or more sequences,
    ``window_size - 1`` bases of overlap between chunks of one sequence.
    A pure function of the file, safe on a reader thread (the native
    parser releases the GIL through ctypes).
    """
    from ganon_tpu_torch.io.pipeline import native_supported

    if use_native and native_supported(path):
        from ganon_tpu_torch.native import NativeSeqReader

        reader = NativeSeqReader(path)
        try:
            while True:
                codes, lens, (seqs, skipped, bp) = reader.next_pieces(
                    READ_BATCH, CHUNK, window_size - 1, min_length
                )
                if not len(codes):
                    break
                rows = [codes[i, : lens[i]] for i in range(len(codes))]
                yield rows, (seqs - skipped, skipped, bp)
        finally:
            reader.close()
    else:
        step = CHUNK - (window_size - 1)
        for _id, seq in SequenceReader(path):
            if len(seq) < min_length:
                yield [], (0, 1, 0)
                continue
            rows = []
            if len(seq) >= window_size:
                for s in range(0, max(len(seq) - window_size + 1, 1), step):
                    piece = seq[s : s + CHUNK]
                    enc, _ = encode_seqs([piece], max_len=len(piece))
                    rows.append(enc[0])
            yield rows, (1, 0, len(seq))


def iter_pieces(
    input_map: dict[str, list[str]],
    *,
    window_size: int,
    min_length: int = 0,
    stats: BuildStats | None = None,
    threads: int = 1,
):
    """Yield ``(key=(target, file_index), dna4-encoded chunk)``.

    Chunks of one file arrive consecutively and files arrive in input
    order (the bin split depends on arrival order). With ``threads > 1``
    reader threads prefetch upcoming files while this generator drains
    them strictly in order, so the stream is the serial one.
    """
    stats = stats if stats is not None else BuildStats()
    use_native = _use_native_reader(min_length)
    entries = [
        ((target, fi), path)
        for target, files in input_map.items()
        for fi, path in enumerate(files)
    ]
    if threads > 1 and len(entries) > 1:
        yield from _iter_pieces_parallel(
            entries, window_size, min_length, stats, use_native,
            threads=threads,
        )
        return
    for key, path in entries:
        for rows, (seqs, skipped, bp) in _file_piece_batches(
            path, window_size, min_length, use_native
        ):
            stats.sequences += seqs
            stats.skipped_sequences += skipped
            stats.length_bp += bp
            for row in rows:
                yield key, row


def _iter_pieces_parallel(
    entries, window_size, min_length, stats, use_native, *,
    threads: int, queue_batches: int = 4,
):
    """Reader-thread prefetch behind :func:`iter_pieces`.

    Each worker claims the next unclaimed file (at most ``2 * threads``
    files past the consumer) and streams its batches into that file's
    bounded queue; the consumer drains the queues in input order.
    """
    import queue as queue_mod
    import threading

    n = len(entries)
    threads = min(threads, n)
    lookahead = threading.Semaphore(threads * 2)
    stop = threading.Event()
    next_file = [0]
    claim_lock = threading.Lock()
    stats_lock = threading.Lock()
    queues = [queue_mod.Queue(maxsize=queue_batches) for _ in range(n)]
    _DONE = object()

    def _put(q, item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def worker():
        while not stop.is_set():
            lookahead.acquire()
            with claim_lock:
                i = next_file[0]
                if i >= n:
                    lookahead.release()
                    return
                next_file[0] = i + 1
            _, path = entries[i]
            q = queues[i]
            try:
                for rows, deltas in _file_piece_batches(
                    path, window_size, min_length, use_native
                ):
                    with stats_lock:
                        stats.sequences += deltas[0]
                        stats.skipped_sequences += deltas[1]
                        stats.length_bp += deltas[2]
                    if rows and not _put(q, rows):
                        return
                _put(q, _DONE)
            except BaseException as e:  # surfaced by the consumer
                _put(q, e)

    workers = [
        threading.Thread(target=worker, daemon=True) for _ in range(threads)
    ]
    for t in workers:
        t.start()
    try:
        for i in range(n):
            key = entries[i][0]
            q = queues[i]
            while True:
                item = q.get()
                if item is _DONE:
                    break
                if isinstance(item, BaseException):
                    raise item
                for row in item:
                    yield key, row
            lookahead.release()  # let workers claim one more file ahead
    finally:
        stop.set()
        for t in workers:
            t.join(timeout=10)


def count_target_hashes(
    input_map: dict[str, list[str]],
    *,
    kmer_size: int,
    window_size: int,
    min_length: int = 0,
    stats: BuildStats | None = None,
    threads: int = 1,
    device="cuda",
) -> dict[str, np.ndarray]:
    """{target: concatenated per-file distinct minimizer arrays}.

    Dedup within a file; duplicates across files of one target are kept
    (GanonBuild.cpp:225-240). The host-array path of the hierarchical
    builds; :func:`run_build` keeps the hashes on the card instead.
    """
    stats = stats if stats is not None else BuildStats()
    ex = _HashExtractor(kmer_size, window_size, device)
    for key, row in iter_pieces(
        input_map, window_size=window_size, min_length=min_length,
        stats=stats, threads=threads,
    ):
        ex.add_encoded(key, row)
    per_file = ex.finish()
    out: dict[str, np.ndarray] = {}
    for target, files in input_map.items():
        parts = [per_file[(target, fi)] for fi in range(len(files))
                 if (target, fi) in per_file]
        out[target] = (
            np.concatenate(parts) if parts else np.empty(0, dtype=np.uint64)
        )
    return out


def _h_tunable(cfg: BuildConfig) -> bool:
    """Hash-function count is free to tune: auto (0) or the CLI default."""
    return cfg.hash_functions == 0 or cfg.hash_functions_defaulted


def run_build(cfg: BuildConfig) -> IBF:
    """Full ganon-build equivalent: parse, count, size, build, save.

    Always the two-pass device build on ``cfg.device``: per-piece
    extraction, per-file dedup and counts and the bin-split scatter run
    there; the host fetches the counts (4 bytes a file) and the final
    bit-matrix. With several local devices the groups round-robin over
    them and the scatter is row-sharded (``_build_mesh``). The filter
    equals ``ganon_tpu``'s ``run_build`` output.
    """
    from ganon_tpu_torch.index import sizing
    from ganon_tpu_torch.index.device_build import DeviceBuildPipeline

    cfg.validate()
    stats = BuildStats()
    phases: list[tuple[str, float]] = []  # StopClock analogue
    mark = functools.partial(_phase, phases)

    # the device check comes before any input is read
    pipe = DeviceBuildPipeline(cfg.kmer_size, cfg.window_size,
                               device=cfg.device)
    try:
        with mark("Ingest", "build.ingest"):
            input_map = parse_target_info(cfg.input_file, cfg.quiet, stats)
            if not input_map:
                raise ValueError("No valid input files")
            for key, row in iter_pieces(
                input_map, window_size=cfg.window_size,
                min_length=cfg.min_length, stats=stats, threads=cfg.threads,
            ):
                pipe.add_encoded(key, row)
        with mark("Count", "build.count"):
            pipe.finish_counts()
        with mark("EstimateParams", "build.estimate"):
            # drop targets with zero hashes (sequences all too short)
            hashes_count = {t: c for t, c in pipe.hashes_count().items()
                            if c}
            if not hashes_count:
                raise ValueError("No valid sequences to build")
            icfg = sizing.size_filter(
                hashes_count,
                kmer_size=cfg.kmer_size,
                window_size=cfg.window_size,
                max_fp=cfg.max_fp,
                filter_size=cfg.filter_size,
                hash_functions=cfg.hash_functions,
                mode=cfg.mode,
                tpu_sizing=cfg.tpu_sizing and _h_tunable(cfg),
            )
        with mark("BuildIBF", "build.scatter"):
            splits = sizing.split_target_bins(icfg, hashes_count)
            bits = pipe.scatter(icfg, splits, mesh=_build_mesh(cfg))
    finally:
        pipe.close()
    ibf = IBF(
        bits, icfg, hashes_count,
        [(binno, target) for binno, target, _, _ in splits],
    )
    return _finish_build(cfg, ibf, stats, phases, mark)


@contextlib.contextmanager
def _phase(phases, label: str, name: str):
    """Span ``name``, its wall seconds appended to ``phases`` (when given)
    as the StopClock phase ``label``."""
    with trace.span(name) as sp:
        yield sp
    if phases is not None:
        phases.append((label, sp.wall_s))


def _finish_build(cfg: BuildConfig, ibf: IBF, stats: BuildStats,
                  phases=None, mark=None) -> IBF:
    """Write the filter (phase ``WriteIBF``, span ``build.write``, through
    ``mark(label, span name)``, by default recorded in ``phases``) and
    print the build's summary."""
    mark = mark or functools.partial(_phase, phases)
    if cfg.output_file:
        with mark("WriteIBF", "build.write"):
            if cfg.filter_format == "reference":
                from ganon_tpu_torch.index import serialize

                serialize.write_ibf(ibf, cfg.output_file)
            elif cfg.filter_format == "tpu-raw":
                ibf.save_raw(cfg.output_file)
            else:
                ibf.save(cfg.output_file)
    if not cfg.quiet:
        c = ibf.ibf_config
        mb = (len(ibf.bits.tobytes())) / 1048576
        total = sum(d for _, d in phases or [])
        mbpm = (stats.length_bp / 1e6) / (total / 60) if total else 0.0
        if cfg.verbose and phases:
            # reference StopClock phase report (GanonBuild.cpp:722-748)
            for name, dur in phases:
                print(f" - {name}: {dur:.2f}s", file=sys.stderr)
        print(
            f"ganon-tpu build processed {stats.sequences} sequences "
            f"({stats.length_bp / 1e6:.2f} Mbp) in {total:.2f}s "
            f"({mbpm:,.1f} Mbp/m) — max fp {c.true_max_fp:.4f} "
            f"(avg {c.true_avg_fp:.4f}), filter size {mb:.2f}MB",
            file=sys.stderr,
        )
    return ibf
