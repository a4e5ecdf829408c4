"""The reference's own filter files: cereal ``.ibf`` and raptor ``.hibf``.

Port of ``ganon_tpu.index.serialize`` (host code; no tensor work). Byte
readers and writers for the archives the reference C++ binaries write,
so a database built by upstream ganon classifies through the port, and
either package reads what the other writes.

Cereal ``.ibf`` (``ganon build --filter-type ibf``; reference write
``GanonBuild.cpp:251-288``, read ``GanonClassify.cpp:949-986``): cereal's
binary archive writes raw little-endian fields with no padding or tags;
strings and vectors carry a ``u64`` length.

  1. version        tuple<int,int,int>           3 x i32
  2. ibf_config     IBFConfig                    ``<QQBBHQddd``: n_bins,
                                                 max_hashes_bin,
                                                 hash_functions, kmer_size,
                                                 window_size, bin_size_bits,
                                                 max_fp, true_max_fp,
                                                 true_avg_fp
  3. hashes_count   vector<tuple<string,u64>>
  4. bin_map        vector<tuple<u64,string>>
  5. seqan3 IBF     6 x u64 header               bins, technical_bins,
                                                 bin_size, hash_shift,
                                                 bin_words, hash_funs
     sdsl bit_vector                             u64 m_size (bits), an
                                                 optional u8 width (= 1),
                                                 ceil(m_size/64) x u64

The sdsl tail is read in both known variants (with and without the width
byte), and every seqan3 header field is checked against what the config
implies. Bit ``row * technical_bins + bin`` is hash row ``row`` of
technical bin ``bin``: with technical bins a multiple of 64, the u64 word
stream viewed as u32 is the IBF's ``uint32[bin_size, technical_bins/32]``
matrix as it is.

Raptor ``.hibf`` (``ganon build --filter-type hibf``, ganon2's default;
reference read ``GanonClassify.cpp:875-938``): a cereal archive of (u32
version, u64 window, seqan3::shape, u8 parts, bool compressed,
vector<vector<string>> bin_path, f64 fpr, bool is_hibf, HIBF{ibf_vector,
next_ibf_id, user_bins{filenames, ibf_bin_to_filename_position}}).
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ganon_tpu_torch.index.config import IBFConfig
from ganon_tpu_torch.index.ibf import IBF
from ganon_tpu_torch.ops.ibf_query import clz64

# version written into new cereal files (the reference release whose
# layout this implements)
VERSION = (2, 1, 1)

_IBFCONFIG_FMT = "<QQBBHQddd"  # no padding: cereal writes fields back to back


class _Reader:
    """Sequential little-endian reads from a byte buffer."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def take(self, n: int) -> bytes:
        if self.off + n > len(self.buf):
            raise ValueError(
                f"truncated cereal archive: need {n} bytes at offset "
                f"{self.off}, file has {len(self.buf)}"
            )
        out = self.buf[self.off:self.off + n]
        self.off += n
        return out

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]

    def u8(self) -> int:
        return self.take(1)[0]

    def string(self) -> str:
        n = self.u64()
        if n > len(self.buf):
            raise ValueError(f"implausible string length {n} at {self.off - 8}")
        return self.take(n).decode()

    def remaining(self) -> int:
        return len(self.buf) - self.off


def _words_as_bits(data: np.ndarray, bin_size: int,
                   technical_bins: int) -> np.ndarray:
    """The u64 word stream as the ``uint32[bin_size, tb/32]`` matrix."""
    return (data.reshape(bin_size, technical_bins // 64)
            .view(np.uint32).astype(np.uint32, copy=True))


def read_ibf(path: str) -> IBF:
    """Parse a reference cereal ``.ibf`` into an :class:`IBF`."""
    with open(path, "rb") as f:
        r = _Reader(f.read())

    version = (r.i32(), r.i32(), r.i32())
    if not all(0 <= v < 1000 for v in version):
        raise ValueError(f"{path}: implausible version tuple {version}; "
                         "not a reference cereal .ibf?")
    (n_bins, max_hashes_bin, hash_functions, kmer_size, window_size,
     bin_size_bits, max_fp, true_max_fp, true_avg_fp) = struct.unpack(
        _IBFCONFIG_FMT, r.take(struct.calcsize(_IBFCONFIG_FMT)))

    hashes_count = {}
    for _ in range(r.u64()):
        t = r.string()
        hashes_count[t] = r.u64()
    bin_map = []
    for _ in range(r.u64()):
        binno = r.u64()
        bin_map.append((binno, r.string()))

    # seqan3 interleaved_bloom_filter header (all size_t)
    bins, technical_bins, bin_size, hash_shift, bin_words, hash_funs = (
        r.u64() for _ in range(6))
    expect_tb = -(-n_bins // 64) * 64
    checks = {
        "bins": (bins, n_bins),
        "technical_bins": (technical_bins, expect_tb),
        "bin_size": (bin_size, bin_size_bits),
        "hash_shift": (hash_shift, clz64(bin_size_bits)),
        "bin_words": (bin_words, expect_tb // 64),
        "hash_funs": (hash_funs, hash_functions),
    }
    bad = {k: v for k, v in checks.items() if v[0] != v[1]}
    if bad:
        raise ValueError(
            f"{path}: seqan3 IBF header does not match IBFConfig "
            f"(got, expected): {bad} — unknown layout variant"
        )

    # sdsl bit_vector: m_size (+ optional width byte) + words
    m_size = r.u64()
    n_words = -(-m_size // 64)
    if m_size != technical_bins * bin_size:
        raise ValueError(
            f"{path}: sdsl bit count {m_size} != technical_bins*bin_size "
            f"{technical_bins * bin_size}"
        )
    if r.remaining() == n_words * 8 + 1:
        width = r.u8()
        if width != 1:
            raise ValueError(f"{path}: sdsl bit_vector width {width} != 1")
    elif r.remaining() != n_words * 8:
        raise ValueError(
            f"{path}: trailing {r.remaining()} bytes, expected "
            f"{n_words * 8} (+1 width byte) for {m_size} bits"
        )
    data = np.frombuffer(r.take(n_words * 8), dtype="<u8")
    cfg = IBFConfig(
        kmer_size=kmer_size, window_size=window_size, max_fp=max_fp,
        n_bins=n_bins, max_hashes_bin=max_hashes_bin,
        hash_functions=hash_functions, bin_size_bits=bin_size_bits,
        true_max_fp=true_max_fp, true_avg_fp=true_avg_fp,
    )
    return IBF(_words_as_bits(data, bin_size, technical_bins), cfg,
               hashes_count, [(int(b), t) for b, t in bin_map])


def write_ibf(ibf: IBF, path: str, *, version=VERSION) -> None:
    """Write an :class:`IBF` as a reference cereal ``.ibf`` (with the
    sdsl width byte, byte-equal to ``ganon_tpu``'s writer)."""
    cfg = ibf.ibf_config
    technical_bins = ibf.technical_bins
    if technical_bins % 64:
        raise ValueError("technical bin count must be a multiple of 64")
    out = bytearray()
    out += struct.pack("<iii", *version)
    out += struct.pack(
        _IBFCONFIG_FMT, cfg.n_bins, cfg.max_hashes_bin, cfg.hash_functions,
        cfg.kmer_size, cfg.window_size, cfg.bin_size_bits, cfg.max_fp,
        cfg.true_max_fp, cfg.true_avg_fp,
    )
    out += struct.pack("<Q", len(ibf.hashes_count))
    for t, c in ibf.hashes_count.items():
        b = t.encode()
        out += struct.pack("<Q", len(b)) + b + struct.pack("<Q", c)
    out += struct.pack("<Q", len(ibf.bin_map))
    for binno, t in ibf.bin_map:
        b = t.encode()
        out += struct.pack("<QQ", binno, len(b)) + b
    bin_size = cfg.bin_size_bits
    out += struct.pack("<QQQQQQ", cfg.n_bins, technical_bins, bin_size,
                       clz64(bin_size), technical_bins // 64,
                       cfg.hash_functions)
    out += struct.pack("<Q", technical_bins * bin_size) + bytes([1])
    out += np.ascontiguousarray(ibf.bits).view("<u8").tobytes()
    with open(path, "wb") as f:
        f.write(bytes(out))


def _read_seqan3_ibf(r: _Reader, width_byte: bool = False):
    """One seqan3 interleaved_bloom_filter of a raptor archive.

    Returns ``(bits uint32[bin_size, technical_bins/32], bins, bin_size,
    hash_funs)``. ``width_byte`` picks the sdsl variant; the caller
    resolves it by reading the whole archive with each (a local peek is
    ambiguous: the first data byte can be 1).
    """
    bins, technical_bins, bin_size, hash_shift, bin_words, hash_funs = (
        r.u64() for _ in range(6))
    if (
        technical_bins % 64
        or bin_words != technical_bins // 64
        or hash_shift != clz64(max(bin_size, 1))
        or not (0 < hash_funs <= 5)
        or bins > technical_bins
    ):
        raise ValueError(
            "implausible seqan3 IBF header "
            f"(bins={bins}, tb={technical_bins}, size={bin_size}, "
            f"shift={hash_shift}, words={bin_words}, funs={hash_funs})"
        )
    m_size = r.u64()
    if m_size != technical_bins * bin_size:
        raise ValueError(f"sdsl bit count {m_size} != technical_bins*bin_size")
    if width_byte:
        width = r.u8()
        if width != 1:
            raise ValueError(f"sdsl bit_vector width {width} != 1")
    data = np.frombuffer(r.take(-(-m_size // 64) * 8), dtype="<u8")
    return _words_as_bits(data, bin_size, technical_bins), bins, bin_size, \
        hash_funs


def read_raptor_hibf(path: str) -> dict:
    """Parse a raptor ``.hibf`` (the file ``ganon build --filter-type
    hibf`` writes through raptor).

    Returns a dict: window_size, kmer_size, shape_size, fpr, targets (one
    per user bin, the ``.minimiser`` suffix and the ``|||``/``---`` name
    mangling undone as ``GanonClassify.cpp:920-928`` does), raw_filenames,
    ibfs (list of ``(bits, bins, bin_size, hash_funs)``), next_ibf_id and
    bin_to_filename (int64 arrays, one per IBF). The archive is read
    without the sdsl width byte first, then with it.
    """
    with open(path, "rb") as f:
        buf = f.read()
    first_error = None
    for width_byte in (False, True):
        try:
            return _read_raptor_hibf_buf(buf, path, width_byte)
        except ValueError as e:
            if first_error is None:
                first_error = e
    raise first_error


def _decode_shape(a: int, b: int):
    """``(size, bits)`` of a seqan3::shape stored as (u64 size, u64 bits)
    or in the swapped order; None when neither order is plausible."""
    if 0 < a <= 58 and b < (1 << a):
        return a, b
    if 0 < b <= 58 and a < (1 << b):
        return b, a
    return None


def _unmangle(name: str) -> str:
    f = os.path.basename(name)
    found = f.find(".minimiser")
    if found != -1:
        f = f[:found]
    return f.replace("|||", ".").replace("---", " ")


def _i64_vectors(r: _Reader) -> list:
    out = []
    for _ in range(r.u64()):
        m = r.u64()
        out.append(np.frombuffer(r.take(m * 8), dtype="<i8").astype(np.int64))
    return out


def _read_raptor_hibf_buf(buf: bytes, path: str, width_byte: bool) -> dict:
    r = _Reader(buf)
    version = struct.unpack("<I", r.take(4))[0]
    if version > 1000:
        raise ValueError(f"{path}: implausible raptor index version {version}")
    window_size = r.u64()
    a, b = r.u64(), r.u64()
    shape = _decode_shape(a, b)
    if shape is None:
        raise ValueError(f"{path}: cannot decode seqan3 shape ({a}, {b})")
    size, sbits = shape
    r.u8()  # parts
    if r.u8():
        raise ValueError(f"{path}: compressed raptor indexes not supported")
    n_outer = r.u64()
    if n_outer > 1 << 32:
        raise ValueError(f"{path}: implausible bin_path size {n_outer}")
    for _ in range(n_outer):  # bin_path: read for the layout, not needed
        for _ in range(r.u64()):
            r.string()
    fpr = struct.unpack("<d", r.take(8))[0]
    if not r.u8():
        raise ValueError(f"{path}: raptor index without is_hibf flag")
    n_ibfs = r.u64()
    if n_ibfs > 1 << 20:
        raise ValueError(f"{path}: implausible IBF count {n_ibfs}")
    ibfs = [_read_seqan3_ibf(r, width_byte) for _ in range(n_ibfs)]
    next_ibf_id = _i64_vectors(r)
    filenames = [r.string() for _ in range(r.u64())]
    bin_to_filename = _i64_vectors(r)
    if r.remaining():
        raise ValueError(f"{path}: {r.remaining()} trailing bytes")
    return {
        "window_size": int(window_size),
        "kmer_size": bin(sbits).count("1"),
        "shape_size": int(size),
        "fpr": float(fpr),
        "targets": [_unmangle(f) for f in filenames],
        "raw_filenames": filenames,
        "ibfs": ibfs,
        "next_ibf_id": next_ibf_id,
        "bin_to_filename": bin_to_filename,
    }


def write_raptor_hibf(path: str, *, window_size: int, kmer_size: int,
                      fpr: float, filenames: list[str], ibfs, next_ibf_id,
                      bin_to_filename, version: int = 3) -> None:
    """Write a raptor ``.hibf`` (the layout :func:`read_raptor_hibf`
    reads), byte-equal to ``ganon_tpu``'s writer.

    ``ibfs`` is a list of ``(bits uint32[bin_size, tb/32], bins,
    hash_funs)``; ``next_ibf_id`` and ``bin_to_filename`` one int64
    vector per IBF (technical bin -> child IBF; technical bin -> user-bin
    file position, -1 for a merged or empty bin). The shape is an ungapped
    k-mer; no sdsl width byte is written.
    """
    out = bytearray()
    out += struct.pack("<I", version)
    out += struct.pack("<Q", window_size)
    out += struct.pack("<QQ", kmer_size, (1 << kmer_size) - 1)  # shape
    out += bytes([1])  # parts
    out += bytes([0])  # compressed
    out += struct.pack("<Q", len(filenames))  # bin_path: one file per bin
    for f in filenames:
        b = f.encode()
        out += struct.pack("<Q", 1) + struct.pack("<Q", len(b)) + b
    out += struct.pack("<d", fpr)
    out += bytes([1])  # is_hibf
    out += struct.pack("<Q", len(ibfs))
    for bits, bins, hash_funs in ibfs:
        bin_size, n_words32 = bits.shape
        technical_bins = n_words32 * 32
        if technical_bins % 64:
            raise ValueError("technical bins must be a multiple of 64")
        out += struct.pack("<QQQQQQ", bins, technical_bins, bin_size,
                           clz64(bin_size), technical_bins // 64, hash_funs)
        out += struct.pack("<Q", technical_bins * bin_size)
        out += np.ascontiguousarray(bits).view("<u8").tobytes()

    def vectors(vs):
        out.extend(struct.pack("<Q", len(vs)))
        for v in vs:
            arr = np.asarray(v, dtype="<i8")
            out.extend(struct.pack("<Q", len(arr)) + arr.tobytes())

    vectors(next_ibf_id)
    out += struct.pack("<Q", len(filenames))
    for f in filenames:
        b = f.encode()
        out += struct.pack("<Q", len(b)) + b
    vectors(bin_to_filename)
    with open(path, "wb") as f:
        f.write(bytes(out))


def is_raptor_hibf(path: str) -> bool:
    """Sniff a raptor archive: u32 version + u64 window + decodable shape."""
    try:
        with open(path, "rb") as f:
            head = f.read(28)
    except OSError:
        return False
    if len(head) < 28:
        return False
    version, window = struct.unpack("<IQ", head[:12])
    if version > 1000 or not (0 < window < 1 << 16):
        return False
    return _decode_shape(*struct.unpack("<QQ", head[12:28])) is not None


def is_cereal_ibf(path: str) -> bool:
    """Sniff a cereal ``.ibf``: plausible version tuple and IBFConfig."""
    n = 12 + struct.calcsize(_IBFCONFIG_FMT)
    try:
        with open(path, "rb") as f:
            head = f.read(n)
    except OSError:
        return False
    if len(head) < n:
        return False
    if not all(0 <= v < 1000 for v in struct.unpack("<iii", head[:12])):
        return False
    (n_bins, _mh, hf, k, w, bsb, max_fp, _tm, _ta) = struct.unpack(
        _IBFCONFIG_FMT, head[12:])
    return (0 < n_bins < 1 << 40 and 0 < hf <= 5 and 0 < k <= 32
            and k <= w < 1 << 16 and bsb > 0 and 0 < max_fp <= 1)
