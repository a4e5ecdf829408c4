"""ganon_tpu_torch — the PyTorch/CUDA port of ganon_tpu.

A metagenomic read classifier over Interleaved Bloom Filters (IBF) of
winnowed minimizers, with the capabilities of ganon2 (reference:
pirovc/ganon). The device work of the classify and build paths runs as
hand-written CUDA kernels for Hopper (``csrc/``, loaded by
:mod:`ganon_tpu_torch.kernels`); torch provides tensors, memory, streams
and the plain reference versions the CPU tests run.

The package mirrors ``ganon_tpu``'s layout file for file (``ops/``,
``index/``, ``classify/``, ``io/``, ``native/``; ``ops/minimizers.py`` is
``ops/winnow.py`` here, since ``ganon_tpu_torch.ops.minimizers`` is the
library function) and imports neither jax nor pandas. Unsigned 64-bit hashes travel as ``int64`` bit patterns:
torch has no unsigned 64-bit arithmetic beyond ``^``, ``*`` and sort.
"""

import os as _os

__version__ = "0.1.0"

# compiled artifacts (CUDA kernels, native host helpers) live beside the
# package in the checkout, never inside it
BUILD_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), "build"
)
