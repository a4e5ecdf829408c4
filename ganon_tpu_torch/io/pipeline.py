"""Async host pipeline: reader thread feeding encoded read batches.

The analogue of the reference's producer thread + bounded SafeQueue
(GanonClassify.cpp:1220-1287, SafeQueue.hpp): the native C++ parser (or
the Python fallback) encodes reads into fixed-shape dna4 arrays on a
background thread while the device computes the previous batch.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field

import numpy as np

from ganon_tpu_torch import trace
from ganon_tpu_torch.io.sequence import SequenceReader
from ganon_tpu_torch.ops.winnow import encode_seqs



@dataclass
class EncodedBatch:
    """One device-ready batch: ids + dna4 codes (+ mate2 when paired)."""

    prefix: str = ""
    paired: bool = False
    ids: list = field(default_factory=list)
    codes1: np.ndarray | None = None
    len1: np.ndarray | None = None
    codes2: np.ndarray | None = None
    len2: np.ndarray | None = None

    def __len__(self):
        return len(self.ids)

    def select(self, idx: np.ndarray) -> "EncodedBatch":
        """Subset batch by row indices (leftover requeue between levels,
        length-bucket splits). Trims the length axis to the selection's
        longest read: without the trim every bucket split of a
        mixed-length batch inherited the PARENT's width, so "bucketed"
        batches all hashed at the longest read's padded length (the
        round-4 mixed-length bp gap, and a [16384, 16384] compile OOM
        once a 1 kbp bucket met a 16 kbp parent)."""
        len1 = self.len1[idx]
        len2 = self.len2[idx] if self.paired else None
        return EncodedBatch(
            prefix=self.prefix,
            paired=self.paired,
            ids=[self.ids[i] for i in idx],
            codes1=_trim(self.codes1[idx], len1),
            len1=len1,
            codes2=_trim(self.codes2[idx], len2) if self.paired else None,
            len2=len2,
        )


def _trim(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Cut the length axis down to the longest read in the batch."""
    if len(lengths) == 0:
        return codes
    m = int(lengths.max())
    m = max(m, 1)
    return codes[:, : min(m, codes.shape[1])]


def _read_exact(reader, n):
    """Exactly n reads from an adaptive reader (mate-pairing needs 1:1
    rows even when the reader splits batches to grow its row width);
    fewer only at EOF. Returns (codes, lengths) width-padded across
    chunks."""
    chunks = []
    got = 0
    while got < n:
        _, codes, lengths = reader.next_batch_adaptive(n - got)
        if not len(lengths):
            break
        chunks.append((codes, lengths))
        got += len(lengths)
    if not chunks:
        return np.zeros((0, 1), np.uint8), np.zeros((0,), np.int32)
    if len(chunks) == 1:
        return chunks[0]
    w = max(c.shape[1] for c, _ in chunks)
    codes = np.concatenate(
        [np.pad(c, ((0, 0), (0, w - c.shape[1]))) for c, _ in chunks]
    )
    return codes, np.concatenate([ln for _, ln in chunks])


def _native_batches(file1, file2, prefix, n_reads):
    from ganon_tpu_torch.native import NativeSeqReader

    r1 = NativeSeqReader(file1)
    r2 = NativeSeqReader(file2) if file2 else None
    paired = r2 is not None
    while True:
        ids, codes1, len1 = r1.next_batch_adaptive(n_reads)
        if not ids:
            return
        b = EncodedBatch(prefix=prefix, paired=paired, ids=ids)
        b.codes1, b.len1 = _trim(codes1, len1), len1
        if paired:
            codes2, len2 = _read_exact(r2, len(ids))
            if codes2.shape[0] < len(ids):  # mate file shorter
                pad = len(ids) - codes2.shape[0]
                codes2 = np.pad(codes2, ((0, pad), (0, 0)))
                len2 = np.pad(len2, (0, pad))
            b.codes2 = _trim(codes2, len2)
            b.len2 = len2
        yield b


def _python_batches(file1, file2, prefix, n_reads):
    r1 = iter(SequenceReader(file1))
    r2 = iter(SequenceReader(file2)) if file2 else None
    paired = r2 is not None
    while True:
        ids, seqs, seqs2 = [], [], []
        for _ in range(n_reads):
            try:
                rid, seq = next(r1)
            except StopIteration:
                break
            # never truncate: rows grow to the longest read, matching
            # the native reader — over-limit reads are SKIPPED by the
            # hashes_limit rule downstream, exactly like the reference
            # (GanonClassify.cpp:705,739-741 skips, never truncates)
            ids.append(rid)
            seqs.append(seq)
            if paired:
                try:
                    _, seq2 = next(r2)
                except StopIteration:
                    seq2 = ""
                seqs2.append(seq2)
        if not ids:
            return
        b = EncodedBatch(prefix=prefix, paired=paired, ids=ids)
        b.codes1, b.len1 = encode_seqs(seqs)
        if paired:
            b.codes2, b.len2 = encode_seqs(seqs2)
        yield b


def native_supported(*paths) -> bool:
    """The C++ reader handles plain and gzip files (zlib's gzopen is
    magic-transparent); bz2/xz need the Python reader. Sniff MAGIC, not
    extension — a bz2 file named plain would otherwise reach the native
    reader and parse as garbage."""
    for p in paths:
        if not p:
            continue
        try:
            with open(p, "rb") as f:
                magic = f.read(6)
        except OSError:
            continue  # let the chosen reader raise the real error
        if magic[:3] == b"BZh" or magic == b"\xfd7zXZ\x00":
            return False
    return True


def encoded_batches(file1, file2, prefix, n_reads, use_native=True):
    """Yield EncodedBatch from a read file (pair); native parser if built."""
    if use_native and native_supported(file1, file2):
        try:
            from ganon_tpu_torch.native import NativeSeqReader

            if NativeSeqReader.available():
                yield from _native_batches(file1, file2, prefix, n_reads)
                return
        except Exception:
            pass
    yield from _python_batches(file1, file2, prefix, n_reads)


def strided_batches(source, stride: int, offset: int):
    """Keep records where ``global_record_index % stride == offset``.

    Record-range sharding for multi-host runs on fewer files than hosts
    (parallel/multihost.shard_reads): every host streams the same files
    in the same order, so a global running record counter gives each
    host a disjoint, exhaustive stripe — reader-agnostic (applies after
    either the native or the Python parser).
    """
    pos = 0
    for batch in source:
        n = len(batch)
        if not n:
            continue
        idx = np.arange(pos, pos + n)
        pos += n
        keep = np.nonzero(idx % stride == offset)[0]
        if not len(keep):
            continue
        yield batch if len(keep) == n else batch.select(keep)


def merge_batches(parts: list[EncodedBatch]) -> EncodedBatch:
    """Concatenate batches of one (prefix, paired) into a single batch
    (rows width-padded to the widest part)."""
    if len(parts) == 1:
        return parts[0]
    first = parts[0]
    b = EncodedBatch(prefix=first.prefix, paired=first.paired)
    b.ids = [rid for p in parts for rid in p.ids]
    # trim each part to its own longest read first: an untrimmed part
    # (raw reader batch) must not widen the merged bucket
    c1s = [_trim(p.codes1, p.len1) for p in parts]
    w1 = max(c.shape[1] for c in c1s)
    b.codes1 = np.concatenate(
        [np.pad(c, ((0, 0), (0, w1 - c.shape[1]))) for c in c1s]
    )
    b.len1 = np.concatenate([p.len1 for p in parts])
    if first.paired:
        c2s = [_trim(p.codes2, p.len2) for p in parts]
        w2 = max(c.shape[1] for c in c2s)
        b.codes2 = np.concatenate(
            [np.pad(c, ((0, 0), (0, w2 - c.shape[1]))) for c in c2s]
        )
        b.len2 = np.concatenate([p.len2 for p in parts])
    return b


class BatchCoalescer:
    """Push-based length-bucketed batch accumulator.

    The incremental core behind :func:`bucketed_batches`, also used
    directly by the engine's cross-level scheduler: hierarchy leftovers
    arrive one finished batch at a time and must coalesce to full
    ``n_reads`` batches WHILE the previous level is still in flight
    (draining the pipeline at each level boundary was the round-4
    hierarchy cost — reference requeue never stalls consumers,
    GanonClassify.cpp:811-830,1521-1537).

    ``bucketed=False`` keeps arrival order within a (prefix, paired)
    stream and only merges up to ``n_reads`` rows (the engine's
    length_bucketing=off mode coalesces nothing: pass batches through).
    """

    def __init__(self, n_reads: int, max_bucket_bytes: int = 64 << 20,
                 bucketed: bool = True, bp_budget: int = 0):
        self.n_reads = n_reads
        self.max_bucket_bytes = max_bucket_bytes
        self.bucketed = bucketed
        # bp-budgeted batch sizing (B x L ~ constant): long-read buckets
        # flush at ~bp_budget base pairs instead of n_reads rows, so a
        # mixed-length stream starts emitting (and the device pipeline
        # starts) long before the input is exhausted — with row-count
        # sizing no bucket of a nanopore-style mix ever fills n_reads
        # and EVERY batch waits for EOF (the round-4 mixedlen stall).
        # 0 disables (short-read streams: row-count sizing unchanged).
        self.bp_budget = bp_budget
        self.acc: dict[tuple, list[EncodedBatch]] = {}
        self.sizes: dict[tuple, int] = {}

    def _rows_target(self, bl: int) -> int:
        if not self.bp_budget or not bl:
            return self.n_reads
        return max(1024, min(self.n_reads, self.bp_budget // bl))

    def _emit(self, key):
        parts = self.acc.pop(key)
        self.sizes.pop(key)
        return merge_batches(parts)

    def add(self, batch: EncodedBatch) -> list[EncodedBatch]:
        """Absorb one batch; return any now-full batches."""
        from ganon_tpu_torch.classify.device import bucket_len

        if not len(batch):
            return []
        out = []
        if self.bucketed:
            lmax = batch.len1
            if batch.paired:
                lmax = np.maximum(lmax, batch.len2)
            ulen = np.unique(lmax)
            ubkt = np.asarray([bucket_len(max(int(x), 1)) for x in ulen])
            row_bkt = ubkt[np.searchsorted(ulen, lmax)]
            pieces = [
                (int(bl), batch.select(np.nonzero(row_bkt == bl)[0]))
                for bl in np.unique(row_bkt)
            ]
        else:
            pieces = [(0, batch)]
        for bl, part in pieces:
            key = (batch.prefix, batch.paired, bl)
            self.acc.setdefault(key, []).append(part)
            self.sizes[key] = self.sizes.get(key, 0) + len(part)
            if (
                self.sizes[key] >= self._rows_target(bl)
                or (bl and self.sizes[key] * bl >= self.max_bucket_bytes)
            ):
                out.append(self._emit(key))
        return out

    def flush(self) -> list[EncodedBatch]:
        """Emit every partial batch (input exhausted)."""
        return [self._emit(key) for key in sorted(self.acc)]


def bucketed_batches(source, n_reads: int, max_bucket_bytes: int = 64 << 20,
                     coalesce: bool = False, bp_budget: int = 0):
    """Regroup a batch stream by read-length bucket before padding.

    Mixed-length inputs (nanopore-style distributions) otherwise pad
    every read in a batch to the longest record's bucket — one 100 kb
    read makes thousands of 1 kb reads pay ~100x the hashing work
    (reference skips nothing here: its per-read loop is shape-free,
    GanonClassify.cpp:693-700; fixed device shapes are a TPU-only
    concern). Reads are binned by ``bucket_len(max(len1, len2))`` and
    re-emitted as per-bucket batches of up to ``n_reads`` rows (flushed
    earlier past ``max_bucket_bytes``). Single-bucket input batches
    (uniform short-read workloads) pass through untouched, preserving
    the original streaming behavior — unless ``coalesce`` is set, in
    which case even uniform batches accumulate to full ``n_reads``
    rows: hierarchy leftovers arrive as ragged half-empty sub-batches
    and each dispatch pays a fixed per-call cost, so merging them
    divides the next level's dispatch count.
    """
    from ganon_tpu_torch.classify.device import bucket_len

    co = BatchCoalescer(n_reads, max_bucket_bytes, bucketed=True,
                        bp_budget=bp_budget)
    for batch in source:
        if not len(batch):
            continue
        lmax = batch.len1
        if batch.paired:
            lmax = np.maximum(lmax, batch.len2)
        lo = bucket_len(max(int(lmax.min()), 1))
        hi = bucket_len(max(int(lmax.max()), 1))
        if lo == hi and not co.acc and not coalesce:
            yield batch  # uniform batch, nothing buffered: pass through
            continue
        yield from co.add(batch)
    yield from co.flush()


class ThreadedBatchSource:
    """Run a batch generator on a background thread (bounded queue),
    each item a span ``parse.batch`` under the creator's trace root."""

    _DONE = object()

    def __init__(self, generator, max_queued: int = 8):
        self._q: queue.Queue = queue.Queue(maxsize=max_queued)
        self._err = None
        token = trace.carry()

        def work():
            items = iter(generator)
            try:
                with trace.within(token):
                    while True:
                        with trace.span("parse.batch", cpu=False) as sp:
                            item = next(items, self._DONE)
                            if item is not self._DONE:
                                sp.set(reads=len(item))
                        if item is self._DONE:
                            break
                        self._q.put(item)
                        trace.high("parse.queue_max", self._q.qsize())
            except BaseException as e:  # surfaced on the consumer side
                self._err = e
            finally:
                self._q.put(self._DONE)

        self._t = threading.Thread(target=work, name="ganon-parser",
                                   daemon=True)
        self._t.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                if self._err is not None:
                    raise self._err
                return
            yield item
