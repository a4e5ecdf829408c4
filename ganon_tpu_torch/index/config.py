"""IBF parameter set (mirrors the reference's serialized IBFConfig).

Reference: pirovc/ganon:src/utils/include/utils/IBFConfig.hpp:6-40.
"""

from __future__ import annotations

from dataclasses import dataclass, asdict


@dataclass
class IBFConfig:
    n_bins: int = 0
    max_hashes_bin: int = 0
    hash_functions: int = 0
    kmer_size: int = 0
    window_size: int = 0
    bin_size_bits: int = 0
    max_fp: float = 0.0
    true_max_fp: float = 0.0
    true_avg_fp: float = 0.0

    def to_dict(self):
        return asdict(self)

    @classmethod
    def from_dict(cls, d):
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})
