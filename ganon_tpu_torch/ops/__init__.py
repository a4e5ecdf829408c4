"""Leaf compute: minimizer extraction and the IBF hash family / counts.

The package exports the counterparts of ``ganon_tpu.ops``'s library API
(K18), with JAX's signatures; ``minimizers_jax`` is ``minimizers`` here
(the port names a function for what it computes, as
``minimizers_masked`` for ``minimizers_masked_jax``). The modules hold
the classify and build paths' kernel wrappers besides.
"""

from ganon_tpu_torch.ops.library import (
    bulk_count_bins,
    bulk_target_counts,
    ibf_row_indices,
    minimizers,
    target_counts,
    target_segments,
)
from ganon_tpu_torch.ops.winnow import (
    adjust_seed,
    encode_seqs,
    minimizers_golden,
)

__all__ = [
    "adjust_seed",
    "encode_seqs",
    "minimizers",
    "minimizers_golden",
    "ibf_row_indices",
    "bulk_count_bins",
    "bulk_target_counts",
    "target_counts",
    "target_segments",
]
