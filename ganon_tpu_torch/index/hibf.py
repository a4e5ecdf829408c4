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
:func:`is_pruned_file` (the merged-bin pruned forest, whose container
lives in :mod:`ganon_tpu_torch.index.pruned`) and :func:`is_raptor_hibf`
(the reference's raptor archive, whose codec lives in
:mod:`ganon_tpu_torch.index.serialize`); both are re-exported here.
:class:`RaptorHIBF` is a raptor archive flattened for the batched query,
and :func:`export_raptor_hibf` writes a forest as one.
:func:`run_build_hibf` is ``build-custom --filter-type hibf``'s build.
"""

from __future__ import annotations

import json
import os
import zipfile

import numpy as np
import torch

from ganon_tpu_torch.index.config import IBFConfig
from ganon_tpu_torch.index.ibf import IBF, build_ibf
from ganon_tpu_torch.index.pruned import MAGIC as PRUNED_MAGIC  # noqa: F401
from ganon_tpu_torch.index.pruned import RAW_MAGIC as PRUNED_RAW_MAGIC  # noqa: F401
from ganon_tpu_torch.index.pruned import is_pruned_file  # noqa: F401
from ganon_tpu_torch.index.serialize import (  # noqa: F401
    is_raptor_hibf,
    read_raptor_hibf,
    write_raptor_hibf,
)

MAGIC = "ganon-tpu-hibf-v1"
# mmap-able raw container (save_raw / --filter-format tpu-raw)
RAW_MAGIC = b"GANON-TPU-HIBF-RAW1\n"
RAW_MAGIC_STR = "ganon-tpu-hibf-raw-v1"


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


def _per_bin_set_bits(bits: np.ndarray, row_chunk: int = 8192) -> np.ndarray:
    """Set-bit count per technical bin of a ``[rows, words]`` u32 matrix.

    Bin ``b`` is bit ``b % 32`` of word ``b // 32``; rows go in chunks so
    a large filter never unpacks whole.
    """
    rows, words = bits.shape
    out = np.zeros(words * 32, dtype=np.int64)
    for r0 in range(0, rows, row_chunk):
        chunk = np.ascontiguousarray(bits[r0:r0 + row_chunk]).view(np.uint8)
        # little-endian u32: byte j of word w holds bins w*32+8j..+7
        out += np.unpackbits(chunk, axis=1, bitorder="little").sum(
            axis=0, dtype=np.int64)
    return out


class RaptorHIBF:
    """A raptor ``.hibf`` flattened for the batched query.

    Port of ``ganon_tpu.index.hibf.RaptorHIBF``. The reference descends
    per read (``hierarchical_interleaved_bloom_filter.hpp:432-460``): it
    counts IBF 0's technical bins, enters a merged bin's child IBF when
    the bin's count reaches the read's threshold, and records user-bin
    sums. A merged bin holds every hash of its subtree, so its count is
    never below a descendant's and the descent never drops a user bin
    whose own count passes. Counting every IBF and leaving the threshold
    to the rel-cutoff therefore gives the same matches, as uniform
    batched work.
    """

    # raptor files carry no per-target hash counts: hashes_count is an
    # estimate from filter occupancy (consumers of exact counts check this)
    hashes_count_is_estimate = True

    def __init__(self, parsed: dict):
        self.window_size = parsed["window_size"]
        self.kmer_size = parsed["kmer_size"]
        self.fpr = parsed["fpr"]
        self._targets = parsed["targets"]
        self.ibfs = parsed["ibfs"]  # list of (bits, bins, bin_size, funs)
        self.next_ibf_id = parsed["next_ibf_id"]
        self.bin_to_filename = parsed["bin_to_filename"]
        self.ibf_config = IBFConfig(
            kmer_size=self.kmer_size,
            window_size=self.window_size,
            max_fp=self.fpr,
            n_bins=sum(b for _, b, _, _ in self.ibfs),
            hash_functions=self.ibfs[0][3] if self.ibfs else 0,
            true_max_fp=self.fpr,
            true_avg_fp=self.fpr,
        )
        self._hashes_count = None

    @property
    def hashes_count(self) -> dict:
        """Per-target element counts estimated from filter occupancy.

        The raptor format carries one global fpr and no counts
        (``GanonClassify.cpp:930-934``). Each technical bin's fill is
        inverted, ``n = -(m/h) ln(1 - X/m)`` for ``X`` of ``m`` bits set
        (float64 ``log1p``), and a user bin sums its technical bins.
        Merged bins (file position -1) are left out, so subtree unions
        are not counted twice. Computed on first use and cached.
        """
        if self._hashes_count is None:
            est = np.zeros(len(self._targets), dtype=np.float64)
            for (bits, _bins, bin_size, hash_funs), b2f in zip(
                    self.ibfs, self.bin_to_filename):
                if not len(b2f) or hash_funs <= 0:
                    continue
                x = _per_bin_set_bits(bits)
                fpos = np.asarray(b2f, dtype=np.int64)
                nb = min(len(fpos), x.shape[0])
                fill = np.minimum(x[:nb] / float(bin_size), 1.0 - 1e-12)
                n_b = -(float(bin_size) / hash_funs) * np.log1p(-fill)
                keep = fpos[:nb] >= 0
                np.add.at(est, fpos[:nb][keep], n_b[keep])
            self._hashes_count = {
                t: int(round(est[i])) for i, t in enumerate(self._targets)
            }
        return self._hashes_count

    def targets(self):
        return list(self._targets)

    def target_fpr(self):
        # raptor reports one fpr for every user bin
        return {t: self.fpr for t in self._targets}

    @classmethod
    def load(cls, path: str) -> "RaptorHIBF":
        return cls(read_raptor_hibf(path))


def mangle_raptor_name(target: str) -> str:
    """A target name as raptor derives it from a file name (``.`` ->
    ``|||``, `` `` -> ``---``, + ``.minimiser``); readers undo it."""
    return target.replace(".", "|||").replace(" ", "---") + ".minimiser"


def export_raptor_hibf(hibf: HIBF, target_hashes: dict[str, np.ndarray],
                       output_file: str, device="cuda") -> None:
    """Write a forest as a 2-level raptor ``.hibf`` the reference loads.

    Port of ``ganon_tpu.index.hibf.export_raptor_hibf``, byte-equal to
    its file for the same forest: IBF 0 holds one merged bin per forest
    class (the union of the class's hashes, built with
    :func:`~ganon_tpu_torch.index.ibf.build_ibf` on ``device``), and each
    class IBF is its child with its user bins. Names are mangled as
    raptor derives them from file names (:func:`mangle_raptor_name`).
    """
    cfg = hibf.ibf_config
    merged = {
        f"merged{gi}": np.unique(
            np.concatenate([target_hashes[t] for t in sub.targets()]))
        for gi, sub in enumerate(hibf.subs)
    }
    root = build_ibf(merged, kmer_size=cfg.kmer_size,
                     window_size=cfg.window_size, max_fp=cfg.max_fp,
                     device=device)
    tree = [(root, [], {f"merged{gi}": gi + 1
                        for gi in range(len(hibf.subs))})]
    tree += [(sub, sub.targets(), {}) for sub in hibf.subs]
    _write_raptor_tree(output_file, tree, kmer_size=cfg.kmer_size,
                       window_size=cfg.window_size, max_fp=cfg.max_fp)


def _write_raptor_tree(path: str, tree: list, *, kmer_size: int,
                       window_size: int, max_fp: float) -> None:
    """Write built IBFs as a raptor ``.hibf``, IBF 0 the root.

    ``tree`` lists ``(ibf, users, children)`` per IBF: ``users`` the
    targets it holds as user bins, ``children`` its merged bins' names
    mapped to the child IBF each routes to. A user bin points to its own
    IBF in ``next_ibf_id`` and a merged bin to its child, as raptor writes
    them; file positions follow first appearance in ``users`` (a target in
    several IBFs keeps one), and names are mangled as raptor derives them
    (:func:`mangle_raptor_name`).
    """
    fidx: dict[str, int] = {}
    for _, users, _ in tree:
        for t in users:
            fidx.setdefault(t, len(fidx))
    ibfs, next_ibf_id, bin_to_filename = [], [], []
    for i, (ibf, _, children) in enumerate(tree):
        nid = np.full(ibf.technical_bins, i, dtype=np.int64)
        b2f = np.full(ibf.technical_bins, -1, dtype=np.int64)
        for b, t in ibf.bin_map:
            if t in children:
                nid[b] = children[t]
            else:
                b2f[b] = fidx[t]
        ibfs.append((ibf.bits, ibf.ibf_config.n_bins,
                     ibf.ibf_config.hash_functions))
        next_ibf_id.append(nid)
        bin_to_filename.append(b2f)
    write_raptor_hibf(
        path, window_size=window_size, kmer_size=kmer_size, fpr=max_fp,
        filenames=[mangle_raptor_name(t) for t in fidx], ibfs=ibfs,
        next_ibf_id=next_ibf_id, bin_to_filename=bin_to_filename,
    )


# target count at or above which ``--hibf-layout auto`` picks the pruned
# merged-bin layout (the JAX package's threshold): below it the forest's
# per-class sizing already bounds the space, at many targets the coarse
# gate keeps most of the fine table unread
PRUNED_AUTO_MIN_TARGETS = 2048


def run_build_hibf(
    *, target_info_file: str, output_file: str, kmer_size: int,
    window_size: int, hash_functions: int = 0, max_fp: float = 0.001,
    min_length: int = 0, threads: int = 1, tpu_sizing: bool | None = None,
    filter_format: str = "tpu", layout: str = "auto", quiet: bool = True,
    device="cuda",
):
    """Count hashes from a target_info file and build and save a
    hierarchical filter: the size-stratified forest (``layout="forest"``)
    or the merged-bin pruned forest (``layout="pruned"``). ``auto`` picks
    pruned at ``PRUNED_AUTO_MIN_TARGETS`` targets or more. The raptor
    export (``filter_format="reference"``) always builds the forest.

    Port of ``ganon_tpu.index.hibf.run_build_hibf``; the files are
    byte-equal to its. Extraction and the bit scatters run on ``device``.
    """
    from ganon_tpu_torch.index.builder import (
        BuildStats,
        count_target_hashes,
        parse_target_info,
    )
    from ganon_tpu_torch.index.pruned import build_pruned

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    stats = BuildStats()
    input_map = parse_target_info(target_info_file, quiet, stats)
    if not input_map:
        raise ValueError("No valid input files")
    target_hashes = count_target_hashes(
        input_map, kmer_size=kmer_size, window_size=window_size,
        min_length=min_length, stats=stats, threads=threads, device=dev,
    )
    target_hashes = {t: h for t, h in target_hashes.items() if len(h)}
    if not target_hashes:
        raise ValueError("No valid sequences to build")
    if layout == "auto":
        layout = (
            "pruned"
            if (len(target_hashes) >= PRUNED_AUTO_MIN_TARGETS
                and filter_format != "reference")
            else "forest"
        )
    if layout == "pruned" and filter_format != "reference":
        pf = build_pruned(
            target_hashes, kmer_size=kmer_size, window_size=window_size,
            max_fp=max_fp, device=dev,
        )
        if filter_format == "tpu-raw":
            pf.save_raw(output_file)
        else:
            pf.save(output_file)
        return pf
    hibf = build_hibf(
        target_hashes, kmer_size=kmer_size, window_size=window_size,
        max_fp=max_fp, hash_functions=hash_functions,
        tpu_sizing=tpu_sizing, device=dev,
    )
    if filter_format == "reference":
        export_raptor_hibf(hibf, target_hashes, output_file, device=dev)
    elif filter_format == "tpu-raw":
        hibf.save_raw(output_file)
    else:
        hibf.save(output_file)
    return hibf
