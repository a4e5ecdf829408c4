"""Native (C++) host runtime: sequence parsing + dna4 encoding.

Compiled lazily with g++ into a cached shared library under the
checkout's ``build/`` directory (never the package directory) and loaded
via ctypes; callers fall back to the pure-Python reader when no compiler
is available (``NativeSeqReader.available()``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np

from ganon_tpu_torch import BUILD_DIR

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "seqio.cpp")
_lib = None
_tried = False


def _compile(src: str, name: str, extra: list[str] = []) -> str | None:
    """Lazily compile one native source into a content-addressed .so."""
    with open(src, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    so = os.path.join(BUILD_DIR, f"_{name}_{tag}.so")
    if os.path.exists(so):
        return so
    tmp = f"{so}.{os.getpid()}.tmp"  # concurrent builders never share it
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, *extra, "-o",
        tmp,
    ]
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so)
        return so
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        print(f"ganon-tpu: native {name} build failed: {e}", file=sys.stderr)
        return None


def _build_lib() -> str | None:
    return _compile(_SRC, "seqio", ["-lz"])


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    so = _build_lib()
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    lib.seqio_open.restype = ctypes.c_void_p
    lib.seqio_open.argtypes = [ctypes.c_char_p]
    lib.seqio_close.argtypes = [ctypes.c_void_p]
    lib.seqio_next_batch.restype = ctypes.c_int64
    lib.seqio_next_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.seqio_next_batch2.restype = ctypes.c_int64
    lib.seqio_next_batch2.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.seqio_next_pieces.restype = ctypes.c_int64
    lib.seqio_next_pieces.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
    ]
    _lib = lib
    return lib


class NativeSeqReader:
    """Batched fasta/fastq reader that encodes directly into numpy arrays."""

    @staticmethod
    def available() -> bool:
        return _load() is not None

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("native seqio unavailable")
        self._lib = lib
        self._h = lib.seqio_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open sequence file: {path}")
        self._cur_width = 256  # adaptive row width (next_batch_adaptive)

    def next_batch(self, max_reads: int, max_len: int):
        """Returns (ids list[str], codes uint8 [n, max_len], lengths [n])."""
        codes = np.zeros((max_reads, max_len), dtype=np.uint8)
        lengths = np.zeros((max_reads,), dtype=np.int32)
        ids_cap = max_reads * 256
        ids_buf = ctypes.create_string_buffer(ids_cap)
        n = self._lib.seqio_next_batch(
            self._h, max_reads, max_len,
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ids_buf, ids_cap,
        )
        if n < 0:
            raise IOError("native seqio read error")
        if n == 0:
            return [], codes[:0], lengths[:0]
        ids = ids_buf.value.decode(errors="replace").split("\n")[:n]
        return ids, codes[:n], lengths[:n]

    def next_batch_adaptive(self, max_reads: int, row_budget: int = 64 << 20):
        """Batch of reads with the row width adapted to the data.

        Starts at 256 columns and grows (power of two) when a longer
        read appears — a fixed worst-case width costs two orders of
        magnitude more allocation+memset than the reads themselves for
        short-read data. When the width grows, the row count shrinks to
        keep each batch under ``row_budget`` bytes, so a stray 1 Mb
        record cannot explode the buffer. Never truncates. Returns
        (ids, codes [n, cur_width], lengths); n == 0 only at EOF.
        """
        while True:
            width = self._cur_width
            rows = max(1, min(max_reads, row_budget // width))
            codes = np.zeros((rows, width), dtype=np.uint8)
            lengths = np.zeros((rows,), dtype=np.int32)
            ids_cap = rows * 256
            ids_buf = ctypes.create_string_buffer(ids_cap)
            needed = ctypes.c_int64(0)
            n = self._lib.seqio_next_batch2(
                self._h, rows, width,
                codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                ids_buf, ids_cap, ctypes.byref(needed),
            )
            if n < 0:
                raise IOError("native seqio read error")
            if needed.value:
                w = self._cur_width
                while w < needed.value:
                    w *= 2
                self._cur_width = w
                if n == 0:
                    continue  # retry with the grown width
            if n == 0:
                return [], codes[:0], lengths[:0]
            if not needed.value:
                # shrink back to this batch's longest read: one
                # ultra-long read must not leave every later batch at its
                # width (64 rows of 1 Mb, mostly padding, to the end)
                w = 256
                while w < int(lengths[:n].max()):
                    w *= 2
                self._cur_width = min(self._cur_width, w)
            ids = ids_buf.value.decode(errors="replace").split("\n")[:n]
            return ids, codes[:n], lengths[:n]

    def next_pieces(self, max_pieces: int, chunk_len: int, overlap: int,
                    min_len: int = 0):
        """Encoded sequence pieces for index construction.

        Long sequences are chunked to ``chunk_len`` with ``overlap``
        carried bases; sequences shorter than ``min_len`` are skipped.
        Returns (codes uint8 [n, chunk_len], lens int32 [n],
        stats (seqs, skipped, bp) deltas). n == 0 signals EOF.
        """
        codes = np.zeros((max_pieces, chunk_len), dtype=np.uint8)
        lens = np.zeros((max_pieces,), dtype=np.int32)
        stats = np.zeros((3,), dtype=np.int64)
        n = self._lib.seqio_next_pieces(
            self._h, max_pieces, chunk_len, overlap, min_len,
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if n < 0:
            raise IOError("native seqio read error")
        return codes[:n], lens[:n], tuple(int(s) for s in stats)

    def close(self):
        if self._h:
            self._lib.seqio_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# --------------------------------------------------------------------------
# native LCA (Euler + sparse-table RMQ; classify/lca.py routes here)

_lca_lib = None
_lca_tried = False


def _load_lca():
    global _lca_lib, _lca_tried
    if _lca_tried:
        return _lca_lib
    _lca_tried = True
    if os.environ.get("GANON_TPU_NO_NATIVE"):
        return None
    so = _compile(os.path.join(_DIR, "lca.cpp"), "lca")
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    lib.lca_build.restype = ctypes.c_void_p
    lib.lca_build.argtypes = [
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
    ]
    lib.lca_free.argtypes = [ctypes.c_void_p]
    lib.lca_reachable.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)
    ]
    lib.lca_pair.restype = ctypes.c_int32
    lib.lca_pair.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
    lib.lca_list.restype = ctypes.c_int32
    lib.lca_list.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64
    ]
    lib.lca_rows.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    _lca_lib = lib
    return lib


class NativeLCA:
    """Integer-id LCA index (Euler walk + RMQ) backed by native/lca.cpp."""

    @staticmethod
    def available() -> bool:
        return _load_lca() is not None

    def __init__(self, parents: np.ndarray, children: np.ndarray,
                 n_nodes: int, root: int):
        lib = _load_lca()
        if lib is None:
            raise RuntimeError("native lca unavailable")
        self._lib = lib
        p = np.ascontiguousarray(parents, dtype=np.int32)
        c = np.ascontiguousarray(children, dtype=np.int32)
        self._h = lib.lca_build(
            n_nodes, len(p),
            p.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            root,
        )
        self.n_nodes = n_nodes

    def reachable(self) -> np.ndarray:
        out = np.zeros(self.n_nodes, dtype=np.uint8)
        self._lib.lca_reachable(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        )
        return out.astype(bool)

    def pair(self, u: int, v: int) -> int:
        return self._lib.lca_pair(self._h, u, v)

    def lca_list(self, nodes: np.ndarray) -> int:
        a = np.ascontiguousarray(nodes, dtype=np.int32)
        return self._lib.lca_list(
            self._h, a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(a)
        )

    def lca_rows(self, ids: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """Per-row LCA of ``ids[r, :lens[r]]``; -1 for empty/invalid rows."""
        a = np.ascontiguousarray(ids, dtype=np.int32)
        n_rows, K = a.shape
        ln = np.ascontiguousarray(lens, dtype=np.int32)
        out = np.empty(n_rows, dtype=np.int32)
        self._lib.lca_rows(
            self._h,
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n_rows, K,
            ln.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out

    def close(self):
        if getattr(self, "_h", None):
            self._lib.lca_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
