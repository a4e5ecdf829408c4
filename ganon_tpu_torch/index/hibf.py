"""Size-stratified IBF forest (native ``.hibf``): build, save, load.

Port of the native half of ``ganon_tpu.index.hibf``. Targets are split
into size classes at geometric bounds of their minimizer counts and each
class builds its own optimally sized IBF, so small targets do not pay
the bin size of the largest. A query counts every class and writes each
class's targets into its own columns (the forest's target order is the
concatenation of its classes'), which equals a single IBF holding all
targets with class-local false-positive rates.

File formats are the JAX package's, so either package loads what the
other writes: the npz container (JSON header + ``bits{i}`` per class)
and the mmap-able raw container (``save_raw``).

Two detectors tell the other ``.hibf`` kinds apart without parsing them:
:func:`is_pruned_file` (the merged-bin pruned forest) and
:func:`is_raptor_hibf` (the reference's raptor cereal archive). Neither
format is ported yet (ROADMAP queue 1, items 9 and 5c).
"""

from __future__ import annotations

import json
import os
import struct
import zipfile

import numpy as np

from ganon_tpu_torch.index.config import IBFConfig
from ganon_tpu_torch.index.ibf import IBF, build_ibf

MAGIC = "ganon-tpu-hibf-v1"
# mmap-able raw container (save_raw / --filter-format tpu-raw)
RAW_MAGIC = b"GANON-TPU-HIBF-RAW1\n"
RAW_MAGIC_STR = "ganon-tpu-hibf-raw-v1"
# the pruned forest's container magics (ganon_tpu.index.pruned)
PRUNED_MAGIC = "ganon-tpu-pruned-v1"
PRUNED_RAW_MAGIC = b"GANON-TPU-PRUNED-RAW1\n"


class HIBF:
    """A forest of size-stratified IBFs acting as one filter."""

    hashes_count_is_estimate = False  # exact, carried per sub-IBF

    def __init__(self, subs: list[IBF], kmer_size: int, window_size: int,
                 max_fp: float):
        self.subs = subs
        self.ibf_config = IBFConfig(
            kmer_size=kmer_size,
            window_size=window_size,
            max_fp=max_fp,
            n_bins=sum(s.ibf_config.n_bins for s in subs),
            hash_functions=subs[0].ibf_config.hash_functions if subs else 0,
            true_max_fp=max((s.ibf_config.true_max_fp for s in subs), default=0),
            true_avg_fp=(
                sum(s.ibf_config.true_avg_fp for s in subs) / len(subs)
                if subs
                else 0
            ),
        )
        self.hashes_count = {}
        for s in subs:
            self.hashes_count.update(s.hashes_count)

    def targets(self):
        return list(self.hashes_count.keys())

    def target_fpr(self):
        out = {}
        for s in self.subs:
            out.update(s.target_fpr())
        return out

    def _sub_meta(self, s: IBF) -> dict:
        return {
            "ibf_config": s.ibf_config.to_dict(),
            "targets": s.targets(),
            "hashes_count": [s.hashes_count[t] for t in s.targets()],
            "bin_map": s.bin_map,
        }

    def _head(self, magic: str) -> dict:
        return {
            "magic": magic,
            "kmer_size": self.ibf_config.kmer_size,
            "window_size": self.ibf_config.window_size,
            "max_fp": self.ibf_config.max_fp,
        }

    def save(self, path: str):
        header = self._head(MAGIC) | {
            "subs": [self._sub_meta(s) for s in self.subs]
        }
        arrays = {
            "header": np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
        }
        for i, s in enumerate(self.subs):
            arrays[f"bits{i}"] = s.bits
        np.savez_compressed(path + ".tmp.npz", **arrays)
        os.replace(path + ".tmp.npz", path)

    def save_raw(self, path: str) -> None:
        """mmap-able forest container: JSON header + one page-aligned raw
        bit-matrix per class (load time independent of forest size)."""
        metas = [
            self._sub_meta(s) | {
                "bits_shape": list(s.bits.shape),
                "bits_dtype": str(s.bits.dtype),
                # 2^48-1: a fixed-width placeholder longer than any real
                # offset, so the header length is known before the offsets
                "bits_offset": 0xFFFFFFFFFFFF,
            }
            for s in self.subs
        ]
        header = self._head(RAW_MAGIC_STR)
        blob = json.dumps(header | {"subs": metas}).encode()
        data_start = len(RAW_MAGIC) + 8 + len(blob)
        data_start += -data_start % 4096
        offset = data_start
        for m, s in zip(metas, self.subs):
            m["bits_offset"] = offset
            offset += int(np.prod(m["bits_shape"])) * s.bits.dtype.itemsize
            offset += -offset % 4096
        # pad the shorter real offsets back to the placeholder length
        blob2 = json.dumps(header | {"subs": metas}).encode()
        blob2 = blob2.ljust(len(blob), b" ")
        assert len(blob2) == len(blob)
        with open(path + ".tmp", "wb") as f:
            f.write(RAW_MAGIC)
            f.write(len(blob2).to_bytes(8, "little"))
            f.write(blob2)
            f.write(b"\0" * (data_start - f.tell()))
            for m, s in zip(metas, self.subs):
                f.write(b"\0" * (m["bits_offset"] - f.tell()))
                f.write(np.ascontiguousarray(s.bits).tobytes())
        os.replace(path + ".tmp", path)

    @staticmethod
    def _sub(sh: dict, bits) -> IBF:
        return IBF(bits, IBFConfig.from_dict(sh["ibf_config"]),
                   dict(zip(sh["targets"], sh["hashes_count"])),
                   [(int(b), t) for b, t in sh["bin_map"]])

    @classmethod
    def _load_raw(cls, path: str) -> "HIBF":
        with open(path, "rb") as f:
            assert f.read(len(RAW_MAGIC)) == RAW_MAGIC
            hlen = int.from_bytes(f.read(8), "little")
            header = json.loads(f.read(hlen).decode())
        if header.get("magic") != RAW_MAGIC_STR:
            raise ValueError(f"not a ganon-tpu raw HIBF file: {path}")
        subs = [
            cls._sub(sh, np.memmap(
                path, mode="r", dtype=np.dtype(sh["bits_dtype"]),
                offset=int(sh["bits_offset"]), shape=tuple(sh["bits_shape"]),
            ))
            for sh in header["subs"]
        ]
        return cls(subs, header["kmer_size"], header["window_size"],
                   header["max_fp"])

    @classmethod
    def load(cls, path: str) -> "HIBF":
        if not zipfile.is_zipfile(path):
            with open(path, "rb") as f:
                if f.read(len(RAW_MAGIC)) == RAW_MAGIC:
                    return cls._load_raw(path)
            raise ValueError(f"not a ganon-tpu HIBF file: {path}")
        with np.load(path, allow_pickle=False) as z:
            header = json.loads(bytes(z["header"].tobytes()).decode())
            if header.get("magic") != MAGIC:
                raise ValueError(f"not a ganon-tpu HIBF file: {path}")
            subs = [cls._sub(sh, z[f"bits{i}"])
                    for i, sh in enumerate(header["subs"])]
        return cls(subs, header["kmer_size"], header["window_size"],
                   header["max_fp"])


def build_hibf(
    target_hashes: dict[str, np.ndarray],
    *,
    kmer_size: int,
    window_size: int,
    max_fp: float = 0.001,
    hash_functions: int = 0,
    num_classes: int = 4,
    tpu_sizing: bool | None = None,
    device="cuda",
) -> HIBF:
    """Partition targets into size classes and build one IBF per class.

    Classes split at geometric bounds of the per-target minimizer count,
    so bin sizes within a class are within ~4x of each other. Each class
    builds through :func:`~ganon_tpu_torch.index.ibf.build_ibf` (the
    ``scatter`` kernel on ``device``), so the forest is byte-equal to
    ``ganon_tpu.index.hibf.build_hibf``'s.
    """
    counts = {t: len(h) for t, h in target_hashes.items()}
    if not counts:
        raise ValueError("no targets to build")
    cmin, cmax = min(counts.values()), max(counts.values())
    if cmin == cmax or num_classes <= 1:
        groups = [list(counts.keys())]
    else:
        bounds = np.geomspace(cmin, cmax, num_classes + 1)[1:-1]
        groups = [[] for _ in range(len(bounds) + 1)]
        for t, c in counts.items():
            groups[int(np.searchsorted(bounds, c, side="right"))].append(t)
        groups = [g for g in groups if g]
    subs = [
        build_ibf(
            {t: target_hashes[t] for t in group},
            kmer_size=kmer_size,
            window_size=window_size,
            max_fp=max_fp,
            hash_functions=hash_functions,
            tpu_sizing=tpu_sizing,
            device=device,
        )
        for group in groups
    ]
    return HIBF(subs, kmer_size, window_size, max_fp)


def is_pruned_file(path: str) -> bool:
    """Sniff a ``.hibf`` path for the pruned container (npz or raw)."""
    try:
        with open(path, "rb") as f:
            if f.read(len(PRUNED_RAW_MAGIC)) == PRUNED_RAW_MAGIC:
                return True
        if not zipfile.is_zipfile(path):
            return False
        with np.load(path, allow_pickle=False) as z:
            if "header" not in z:
                return False
            header = json.loads(bytes(z["header"].tobytes()).decode())
            return header.get("magic") == PRUNED_MAGIC
    except Exception:
        return False


def is_raptor_hibf(path: str) -> bool:
    """Sniff a raptor archive: u32 version + u64 window + decodable shape."""
    try:
        with open(path, "rb") as f:
            head = f.read(28)
        if len(head) < 28:
            return False
        version, window = struct.unpack("<IQ", head[:12])
        a, b = struct.unpack("<QQ", head[12:28])
        if version > 1000 or not (0 < window < 1 << 16):
            return False
        return (0 < a <= 58 and b < (1 << a)) or (
            0 < b <= 58 and a < (1 << b)
        )
    except OSError:
        return False
