"""Two-pass IBF construction on the card.

Port of ``ganon_tpu.index.device_build``. Hashes stay on the card from
extraction to the bit-matrix:

  ingest           sequences are cut into short pieces (``w - 1`` bases
                   of overlap) and 2-bit packed on the host; files are
                   grouped, a group closing at a file boundary once it
                   holds ``GROUP_BASES`` bases
  pass 1 (count)   per group: ``extract`` (one thread per piece, a
                   capacity of every window position, so it never
                   overflows; each launch's entry total is fetched, 8
                   bytes a launch of up to 16384 pieces) -> ``pack`` into
                   exact (file key, value) entries -> ``sort`` by (key,
                   unsigned value) -> ``dedup``'s per-file distinct
                   counts (its counts mode: one read of the entries,
                   nothing written of their size); the counts of every
                   group (4 bytes a file) come back in one fetch at the
                   end
  host             sizing (``sizing.size_filter``, then
                   ``sizing.split_target_bins``) from the counts
  pass 2 (scatter) per group: the sorted entries (kept on the card while
                   they fit ``device_cache_bytes``, else re-extracted
                   from the host spill of packed pieces) ->
                   ``scatter_ranked`` finds the first occurrences and
                   their ranks (dedup's chained scan, in the same call)
                   and ORs each into its technical bin of the bit-matrix,
                   which lives on the card whole -> one fetch of the
                   matrix

Semantics are the reference's, as in the JAX package: dedup within a
file, duplicates across files of one target stored and counted twice
(GanonBuild.cpp:225-240), and a target's hashes split over technical
bins by index ranges over the per-file-sorted, file-concatenated order
(GanonBuild.cpp:619-653, ``sizing.split_target_bins``). The bit-matrix
equals ``ganon_tpu``'s bit for bit. ``device="cpu"`` runs every kernel's
plain version.

Several devices (K17), as the JAX package does: the groups round-robin
over ``devices`` (each group's extract, pack, sort and dedup run on its
owner device), and ``scatter(..., mesh=...)`` row-shards the bit-matrix
over the devices of a mesh flattened onto one ``bins`` axis, every shard
running the ranked scatter in span mode over its own rows only (the
entries are copied to each shard's device; no collective touches the
matrix).
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field

import numpy as np
import torch

from ganon_tpu_torch.index import sizing
from ganon_tpu_torch.index.builder import (
    CHUNK,
    PIECES_PER_BATCH,
    _bucket,
    cut_pieces,
    pack_pieces,
    piece_len,
)
from ganon_tpu_torch.ops.build_ops import (
    check_entry_count,
    dedup,
    pack_entries,
    ranked_word_cols,
    scatter_ranked,
    scatter_scratch_bytes,
    sort_entries,
)
from ganon_tpu_torch.ops.ibf_query import extract
from ganon_tpu_torch.parallel import mesh as pmesh

# a group closes at the first file boundary past this many bases: ~19M
# entries of random sequence at k 19, w 31
GROUP_BASES = 1 << 27
# entry cache budget when the device is the CPU
CPU_CACHE_BYTES = 4 << 30
# bytes of one cached entry: int32 key + int64 value
_ENTRY_BYTES = 12
# bytes an entry takes while its group sorts: the unsorted entries, the
# radix sort's two double buffers and its status words (2/3 byte an entry,
# ops/build_ops.sort_entries)
_SORT_BYTES = 3 * _ENTRY_BYTES + 1


class PieceSpill:
    """Append-only spill of packed piece batches to one temporary file."""

    def __init__(self, tmp_dir: str | None = None):
        fd, self.path = tempfile.mkstemp(suffix=".pieces", dir=tmp_dir or None)
        self._w = os.fdopen(fd, "wb")
        self._r = open(self.path, "rb")
        self.index: list[tuple[int, tuple]] = []  # (offset, shape)
        self._off = 0

    def add(self, arr: np.ndarray) -> int:
        b = np.ascontiguousarray(arr, dtype=np.uint8).tobytes()
        self._w.write(b)
        self.index.append((self._off, arr.shape))
        self._off += len(b)
        return len(self.index) - 1

    def read(self, sid: int) -> np.ndarray:
        off, shape = self.index[sid]
        self._w.flush()
        self._r.seek(off)
        buf = bytearray(self._r.read(int(np.prod(shape))))
        return np.frombuffer(buf, dtype=np.uint8).reshape(shape)

    def close(self):
        for f in (self._w, self._r):
            try:
                f.close()
            except OSError:
                pass
        try:
            os.unlink(self.path)
        except OSError:
            pass


@dataclass
class _FileRec:
    key: object                      # (target, file_index)
    count: int = 0


@dataclass
class _Group:
    files: list                      # _FileRec; a file's key is its index
    batches: list                    # (L, spill id, B) per extract launch
    n: int = 0                       # entries (emitted hashes)
    device: object = None            # owner device (extract .. dedup)
    counts: object = None            # card int32 [R], pass 1
    sorted: object = None            # cached sorted (key, val) on the card
    key_bits: int = field(init=False)

    def __post_init__(self):
        self.key_bits = max(len(self.files) - 1, 0).bit_length()


def _pieces_array(part: list, L: int) -> np.ndarray:
    """u8 [B, L/4 + 8]: ``pack_pieces``' rows, then each file key
    (le-i32)."""
    keys = np.asarray([fi for fi, _ in part], dtype="<i4")
    return np.concatenate(
        [pack_pieces([p for _, p in part], L),
         keys.view(np.uint8).reshape(-1, 4)], axis=1)


def target_bins(splits) -> dict:
    """{target: (first technical bin, hashes per bin)} of
    ``sizing.split_target_bins``' rows: a target's first row starts at
    index 0 and holds a full bin's hashes."""
    out = {}
    for binno, target, st, en in splits:
        out.setdefault(target, (binno, en - st + 1))
    return out


class DeviceBuildPipeline:
    """Streamed two-pass IBF build (module docstring).

    The groups round-robin over this process's devices of ``device``'s
    type (``parallel.mesh.local_devices``, or ``device`` alone); groups
    never interact until the bit-matrix, so the result equals one
    device's bit for bit.

    ``device_cache_bytes`` bounds the card memory of the sorted entries
    kept between the passes (12 bytes an entry) together with the group
    being sorted (37 bytes an entry: its entries, the radix sort's
    double buffers and status words) and, in pass 2, the bit-matrix and
    the scatter's scratch (``build_ops.scatter_scratch_bytes``).
    Before each sort the cache is trimmed to leave room for it (pass 1
    drops the oldest groups, pass 2 the ones it reaches last); a dropped
    group is re-extracted in pass 2 from the host spill. The default is
    half of the card's free memory when the pipeline starts
    (``torch.cuda.mem_get_info``), leaving the rest for one group's
    extraction; on the CPU it is ``CPU_CACHE_BYTES``.
    ``device="cuda"`` without CUDA raises here.
    """

    def __init__(self, k: int, w: int, tmp_dir: str | None = None,
                 device_cache_bytes: int | None = None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but CUDA is not available")
        self.devices = [d for d in pmesh.local_devices()
                        if d.type == self.device.type] or [self.device]
        if device_cache_bytes is None:
            device_cache_bytes = (
                torch.cuda.mem_get_info(self.device)[0] // 2
                if self.device.type == "cuda" else CPU_CACHE_BYTES)
        self.k, self.w = k, w
        self.piece = piece_len(w)
        self.spill = PieceSpill(tmp_dir)
        self.files: list[_FileRec] = []
        self._file_of_key: dict[object, _FileRec] = {}
        self.groups: list[_Group] = []
        self._cache_bytes = 0
        self._cache_limit = device_cache_bytes
        self._open_files: list[_FileRec] = []
        self._bufs: dict[int, list] = {}   # bucket L -> [(file index, codes)]
        self._open_bases = 0

    # -- ingest ------------------------------------------------------------

    def add_encoded(self, key, row: np.ndarray) -> None:
        """Add one dna4-encoded piece (uint8 [n]) of file ``key``. Pieces
        of one file must arrive consecutively."""
        if len(row) < self.w:
            return
        rec = self._file_of_key.get(key)
        if rec is None:
            # file boundary: close the group once it is large enough
            if self._open_bases >= GROUP_BASES:
                self._cut()
            rec = _FileRec(key=key)
            self._file_of_key[key] = rec
            self.files.append(rec)
            self._open_files.append(rec)
        elif not self._open_files or self._open_files[-1] is not rec:
            raise ValueError(f"pieces of file {key!r} must arrive "
                             "consecutively")
        fi = len(self._open_files) - 1
        for piece in cut_pieces(row, self.w, self.piece):
            self._bufs.setdefault(_bucket(len(piece), self.piece), []).append(
                (fi, piece))
            self._open_bases += len(piece)

    def add_sequence(self, key, seq_codes: np.ndarray) -> None:
        """Chunk a full encoded sequence into w-1-overlapping pieces."""
        n = len(seq_codes)
        if n < self.w:
            return
        step = CHUNK - (self.w - 1)
        for s in range(0, max(n - self.w + 1, 1), step):
            self.add_encoded(key, seq_codes[s : s + CHUNK])

    def _cut(self) -> None:
        """Close the open group and count it (pass 1)."""
        if not self._open_files:
            return
        group, arrays = self._close_open()
        key, val = self._entries(group, arrays)
        del arrays
        self._trim_cache(self.groups, reserve=_SORT_BYTES * group.n)
        key, val = sort_entries(key, val, key_bits=group.key_bits)
        group.counts = torch.zeros((len(group.files),), dtype=torch.int32,
                                   device=group.device)
        dedup(key, val, num_files=len(group.files), counts=group.counts,
              want_rank=False)
        group.sorted = (key, val)
        self._cache_bytes += _ENTRY_BYTES * group.n
        self.groups.append(group)
        self._trim_cache(self.groups)

    def _close_open(self):
        """The open group's record and its packed piece batches (also
        written to the spill); the next file opens a new group."""
        batches, arrays = [], []
        for L in sorted(self._bufs):
            buf = self._bufs[L]
            for b0 in range(0, len(buf), PIECES_PER_BATCH):
                arr = _pieces_array(buf[b0 : b0 + PIECES_PER_BATCH], L)
                batches.append((L, self.spill.add(arr), arr.shape[0]))
                arrays.append(arr)
        group = _Group(files=self._open_files, batches=batches,
                       device=self.devices[len(self.groups)
                                           % len(self.devices)])
        self._open_files, self._bufs, self._open_bases = [], {}, 0
        return group, arrays

    def _entries(self, group: _Group, arrays: list | None = None):
        """The group's unsorted entries ``(key, val)``: extract every batch
        (from ``arrays`` or the spill) on the group's device, fetch its
        entry total and pack its emissions into exact buffers; sets
        ``group.n``. Raises before the pack that would pass the kernels'
        int32 limit."""
        parts, n = [], 0
        for i, (L, sid, B) in enumerate(group.batches):
            arr = arrays[i] if arrays is not None else self.spill.read(sid)
            t = torch.from_numpy(np.ascontiguousarray(arr)).to(group.device)
            nb = L // 4 + 4
            hashes, cnt, _ = extract(
                t[:, :nb].contiguous(), L1=L, L2=0, k=self.k, w=self.w,
                mc=L - self.w + 1, counter="extract_build", zero_tail=False)
            keys = t[:, nb:].contiguous().view(torch.int32).reshape(B)
            m = int(cnt.sum())
            n += m
            check_entry_count(n)
            parts.append(pack_entries(hashes, cnt, keys, m))
            del hashes, cnt, t
        group.n = n
        if len(parts) == 1:
            return parts[0]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))

    def _trim_cache(self, order, reserve: int = 0) -> None:
        """Drop cached groups, in ``order``, until the cache and
        ``reserve`` bytes fit the budget."""
        for group in order:
            if self._cache_bytes + reserve <= self._cache_limit:
                return
            if group.sorted is not None:
                group.sorted = None
                self._cache_bytes -= _ENTRY_BYTES * group.n

    # -- pass 1: counts ------------------------------------------------------

    def finish_counts(self) -> None:
        """Close the last group, then fetch every group's per-file counts
        in one device-to-host copy."""
        self._cut()
        if not self.groups:
            return
        allc = torch.cat([g.counts.to(self.device) for g in self.groups]
                         ).cpu().numpy()
        off = 0
        for g in self.groups:
            for i, rec in enumerate(g.files):
                rec.count = int(allc[off + i])
            off += len(g.files)
            g.counts = None

    # -- sizing inputs -------------------------------------------------------

    def hashes_count(self) -> dict[str, int]:
        """{target: sum of per-file distinct counts} in insertion order."""
        out: dict[str, int] = {}
        for rec in self.files:
            target = rec.key[0]
            out[target] = out.get(target, 0) + rec.count
        return out

    # -- pass 2: scatter -------------------------------------------------------

    def scatter(self, ibf_config, splits, mesh=None) -> np.ndarray:
        """Build the bit-matrix on the device; returns it as host uint32
        ``[bin_size_bits, n_words]``. ``splits``: the rows of
        ``sizing.split_target_bins(ibf_config, hashes_count)``.

        With ``mesh`` (a ``parallel.mesh.Mesh``; a 2-D one is flattened
        onto one ``bins`` axis, as JAX's ``scatter`` does) the matrix is
        row-sharded over its devices, ``ceil(bin_size / n)`` rows a shard,
        and each shard runs the ranked scatter in span mode over its own
        rows: per-device matrix memory and scatter traffic drop by the
        shard count. The shards come back to the host in one matrix.
        """
        n_words = sizing.optimal_bins(ibf_config.n_bins) // 32
        R = ibf_config.bin_size_bits
        if mesh is None:
            spans = [(self.device, 0, R)]
        else:
            flat = mesh.flat
            rps = -(-R // len(flat))
            spans = [(d, r0, min(rps, R - r0))
                     for d, r0 in zip(flat, range(0, R, rps))]
        bits = [torch.zeros((rc, n_words), dtype=torch.int32, device=d)
                for d, _, rc in spans]
        # the matrix and the scatter's scratch, at the largest group
        pass2_bytes = R * n_words * 4 + scatter_scratch_bytes(
            max((g.n for g in self.groups), default=0),
            ibf_config.hash_functions, R, n_words)
        newest_first = self.groups[::-1]
        self._trim_cache(newest_first, reserve=pass2_bytes)
        split = target_bins(splits)
        running: dict[str, int] = {}
        for group in self.groups:
            params = np.zeros((4, len(group.files)), dtype=np.int32)
            key_start = 0
            for i, rec in enumerate(group.files):
                t = rec.key[0]
                off = running.get(t, 0)
                params[:, i] = (*split.get(t, (0, 1)), off, key_start)
                running[t] = off + rec.count
                key_start += rec.count
            word_cols = ranked_word_cols(
                params, [rec.count for rec in group.files])
            if group.sorted is not None:
                key, val = group.sorted
                group.sorted = None
                self._cache_bytes -= _ENTRY_BYTES * group.n
            else:
                self._trim_cache(newest_first, reserve=pass2_bytes
                                 + _SORT_BYTES * group.n)
                key, val = self._entries(group)
                key, val = sort_entries(key, val, key_bits=group.key_bits)
            params = torch.from_numpy(params)
            for b, (d, r0, _) in zip(bits, spans):
                # the group's entries on the shard's device (a no-op
                # where the owner is that device)
                k_, v_, p_ = (x.to(d) for x in (key, val, params))
                scatter_ranked(
                    b, k_, v_, None, None, p_,
                    bin_size=R, hash_functions=ibf_config.hash_functions,
                    w0=None if mesh is None else r0 * n_words,
                    word_cols=word_cols,
                )
            del key, val
        out = np.empty((R, n_words), dtype=np.uint32)
        for b, (_, r0, rc) in zip(bits, spans):
            out[r0:r0 + rc] = b.cpu().numpy().view(np.uint32)
        return out

    def close(self):
        self.spill.close()
