"""IBF container: build (device bit scatter), save/load.

Port of ``ganon_tpu.index.ibf``. File formats are the JAX package's, so
either package loads what the other writes:

* ``.ibf`` npz: a JSON header (version, IBFConfig, targets,
  hashes_count, bin_map) plus the ``uint32[bin_size, n_words]`` bits;
* the raw container (``save_raw``): JSON header, then the page-aligned
  bit-matrix, loaded through ``np.memmap``;
* the reference's cereal archive, read and written by
  :mod:`ganon_tpu_torch.index.serialize` (``IBF.load`` sniffs it).
"""

from __future__ import annotations

import json
import os
import zipfile

import numpy as np
import torch

from ganon_tpu_torch import kernels
from ganon_tpu_torch.index import sizing
from ganon_tpu_torch.index.config import IBFConfig
from ganon_tpu_torch.ops.ibf_query import clz64, ibf_row_indices
from ganon_tpu_torch.ops.winnow import u64_to_torch

MAGIC = "ganon-tpu-ibf-v1"
# mmap-able raw container (save_raw / --filter-format tpu-raw)
RAW_MAGIC = b"GANON-TPU-IBF-RAW1\n"


class IBF:
    """Interleaved Bloom filter as a dense ``uint32[bin_size, n_words]``.

    Attributes:
      bits: uint32 [bin_size_bits, n_words] bit-matrix (numpy, host).
      ibf_config: IBFConfig.
      hashes_count: {target: distinct-minimizer count} (insertion order is
        the canonical target order).
      bin_map: list[(binno, target)] technical-bin ownership.
    """

    def __init__(self, bits, ibf_config: IBFConfig, hashes_count, bin_map):
        self.bits = bits
        self.ibf_config = ibf_config
        self.hashes_count = dict(hashes_count)
        self.bin_map = list(bin_map)

    @classmethod
    def from_arrays(cls, bits, ibf_config: dict, hashes_count, bin_map) -> "IBF":
        """An IBF from plain state: the bits array, the IBFConfig as a dict
        (``IBFConfig.to_dict()`` of either package), ``hashes_count`` and
        ``bin_map``."""
        return cls(
            np.ascontiguousarray(bits, dtype=np.uint32),
            IBFConfig.from_dict(ibf_config),
            hashes_count,
            [(int(b), t) for b, t in bin_map],
        )

    # --- derived views -----------------------------------------------------

    @property
    def technical_bins(self) -> int:
        return self.bits.shape[1] * 32

    def targets(self) -> list[str]:
        return list(self.hashes_count.keys())

    def bin_to_target_ids(self) -> np.ndarray:
        """int32 [technical_bins]; padding bins get id == num_targets."""
        tids = {t: i for i, t in enumerate(self.targets())}
        arr = np.full((self.technical_bins,), len(tids), dtype=np.int32)
        for binno, target in self.bin_map:
            arr[binno] = tids[target]
        return arr

    def target_fpr(self) -> dict[str, float]:
        return sizing.target_fpr(self.hashes_count, self.ibf_config)

    # --- persistence ---------------------------------------------------------

    def _header(self) -> dict:
        return {
            "magic": MAGIC,
            "ibf_config": self.ibf_config.to_dict(),
            "targets": self.targets(),
            "hashes_count": [self.hashes_count[t] for t in self.targets()],
            "bin_map": self.bin_map,
        }

    def save(self, path: str) -> None:
        np.savez_compressed(
            path if path.endswith(".npz") else path + ".tmp.npz",
            header=np.frombuffer(json.dumps(self._header()).encode(),
                                 dtype=np.uint8),
            bits=self.bits,
        )
        if not path.endswith(".npz"):
            os.replace(path + ".tmp.npz", path)

    def save_raw(self, path: str) -> None:
        """mmap-able container: small JSON header + page-aligned raw
        bit-matrix bytes (loads without decompressing)."""
        header = self._header() | {
            "bits_shape": list(self.bits.shape),
            "bits_dtype": str(self.bits.dtype),
        }
        blob = json.dumps(header).encode()
        with open(path + ".tmp", "wb") as f:
            f.write(RAW_MAGIC)
            f.write(len(blob).to_bytes(8, "little"))
            f.write(blob)
            pos = f.tell()
            f.write(b"\0" * (-pos % 4096))  # page-align the matrix
            f.write(np.ascontiguousarray(self.bits).tobytes())
        os.replace(path + ".tmp", path)

    @classmethod
    def _load_raw(cls, path: str) -> "IBF":
        with open(path, "rb") as f:
            f.read(len(RAW_MAGIC))
            hlen = int.from_bytes(f.read(8), "little")
            header = json.loads(f.read(hlen).decode())
            offset = f.tell()
            offset += -offset % 4096
        if header.get("magic") != MAGIC:
            raise ValueError(f"not a ganon-tpu IBF file: {path}")
        bits = np.memmap(
            path, mode="r", dtype=np.dtype(header["bits_dtype"]),
            offset=offset, shape=tuple(header["bits_shape"]),
        )
        cfg = IBFConfig.from_dict(header["ibf_config"])
        hashes_count = dict(zip(header["targets"], header["hashes_count"]))
        bin_map = [(int(b), t) for b, t in header["bin_map"]]
        return cls(bits, cfg, hashes_count, bin_map)

    @classmethod
    def load(cls, path: str) -> "IBF":
        if not zipfile.is_zipfile(path):
            with open(path, "rb") as f:
                if f.read(len(RAW_MAGIC)) == RAW_MAGIC:
                    return cls._load_raw(path)
            # the reference's cereal archive (ganon build --filter-type ibf)
            from ganon_tpu_torch.index import serialize

            if serialize.is_cereal_ibf(path):
                return serialize.read_ibf(path)
            raise ValueError(f"unrecognized IBF file format: {path}")
        with np.load(path, allow_pickle=False) as z:
            header = json.loads(bytes(z["header"].tobytes()).decode())
            if header.get("magic") != MAGIC:
                raise ValueError(f"not a ganon-tpu IBF file: {path}")
            bits = z["bits"]
        cfg = IBFConfig.from_dict(header["ibf_config"])
        hashes_count = dict(zip(header["targets"], header["hashes_count"]))
        bin_map = [(int(b), t) for b, t in header["bin_map"]]
        return cls(bits, cfg, hashes_count, bin_map)


def _scatter_bits(bits: torch.Tensor, hashes: torch.Tensor, bins: torch.Tensor,
                  *, bin_size: int, hash_functions: int) -> None:
    """Plain version of the ``scatter`` kernel (see :func:`scatter_hashes`).

    Like ``ganon_tpu.index.ibf._scatter_bits`` and the JAX device step:
    deduplicate the flat bit indices, after which OR equals ADD, so one
    ``index_add_`` of the bit masks sets them.
    """
    R, W = bits.shape
    rows = ibf_row_indices(hashes, bin_size=bin_size,
                           hash_functions=hash_functions)  # [N, h]
    flat = (rows * (W * 32) + bins.to(torch.int64)[:, None]).reshape(-1)
    flat = torch.unique(flat)
    delta = torch.zeros(R * W, dtype=torch.int64, device=bits.device)
    delta.index_add_(0, flat >> 5, torch.ones_like(flat) << (flat & 31))
    delta = torch.where(delta >= 1 << 31, delta - (1 << 32), delta)
    bits |= delta.to(torch.int32).reshape(R, W)


def scatter_hashes(bits: torch.Tensor, hashes: torch.Tensor, bins: torch.Tensor,
                   *, bin_size: int, hash_functions: int) -> None:
    """OR every (hash, technical bin) pair into the bit-matrix, in place.

    ``bits`` int32 ``[bin_size, n_words]`` (the u32 words' bit patterns)
    is updated in place; ``hashes`` int64 ``[N]`` (u64 bit patterns),
    ``bins`` int32 ``[N]``. Replaces ``ganon_tpu.index.ibf``'s
    ``_scatter_chunk_jit`` step.
    """
    if bits.dtype != torch.int32 or bits.dim() != 2 or not bits.is_contiguous():
        raise ValueError("bits must be a contiguous int32 [R, W] tensor")
    if hashes.dtype != torch.int64 or bins.dtype != torch.int32:
        raise ValueError("hashes must be int64 and bins int32")
    if hashes.shape != bins.shape or hashes.dim() != 1:
        raise ValueError("hashes and bins must be [N]")
    if bin_size != bits.shape[0] or not 1 <= hash_functions <= 5:
        raise ValueError("bin_size must equal the rows of bits; h in 1..5")
    if bits.device.type == "cpu":
        _scatter_bits(bits, hashes, bins, bin_size=bin_size,
                      hash_functions=hash_functions)
        return
    kernels.check_cuda(bits, hashes, bins)
    N = hashes.shape[0]
    if N == 0:
        return
    kernels.launch(
        "scatter", bits, bits.shape[0], bits.shape[1], hashes, bins, N,
        bin_size, hash_functions, clz64(bin_size),
    )


# hashes per scatter launch (x hash_functions bit-inserts each)
SCATTER_CHUNK = 4 << 20


def build_ibf(
    target_hashes: dict[str, np.ndarray],
    *,
    kmer_size: int,
    window_size: int,
    max_fp: float = 0.05,
    filter_size: float = 0.0,
    hash_functions: int = 0,
    mode: str = "avg",
    tpu_sizing: bool | None = None,
    device="cuda",
) -> IBF:
    """Build an IBF from per-target minimizer arrays (sorted, deduplicated).

    Sizing is the JAX package's (``--tpu-sizing`` included), so the
    filter is byte-equal to ``ganon_tpu.index.ibf.build_ibf``'s. The
    bit-matrix lives on ``device`` while (hash, bin) chunks of up to
    ``SCATTER_CHUNK`` pairs are scattered into it.
    """
    hashes_count = {t: int(len(h)) for t, h in target_hashes.items()}
    cfg = sizing.size_filter(
        hashes_count,
        kmer_size=kmer_size,
        window_size=window_size,
        max_fp=max_fp,
        filter_size=filter_size,
        hash_functions=hash_functions,
        mode=mode,
        tpu_sizing=tpu_sizing,
    )
    splits = sizing.split_target_bins(cfg, hashes_count)
    n_words = sizing.optimal_bins(cfg.n_bins) // 32
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    bits = torch.zeros((cfg.bin_size_bits, n_words), dtype=torch.int32,
                       device=dev)

    def flush(acc_h, acc_b):
        scatter_hashes(
            bits,
            u64_to_torch(np.concatenate(acc_h)).to(dev),
            torch.from_numpy(np.concatenate(acc_b)).to(dev),
            bin_size=cfg.bin_size_bits,
            hash_functions=cfg.hash_functions,
        )

    acc_h, acc_b, acc_n = [], [], 0
    for binno, target, st, en in splits:
        h = np.asarray(target_hashes[target][st : en + 1], dtype=np.uint64)
        acc_h.append(h)
        acc_b.append(np.full(len(h), binno, dtype=np.int32))
        acc_n += len(h)
        if acc_n >= SCATTER_CHUNK:
            flush(acc_h, acc_b)
            acc_h, acc_b, acc_n = [], [], 0
    if acc_n:
        flush(acc_h, acc_b)

    bin_map = [(binno, target) for binno, target, _, _ in splits]
    return IBF(bits.cpu().numpy().view(np.uint32), cfg, hashes_count, bin_map)
