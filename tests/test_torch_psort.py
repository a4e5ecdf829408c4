"""The port's ``probe_sort`` (the ``sort_probes`` branch of K5) against the
order the JAX package's own rows give.

``ganon_tpu.classify.device.classify_batch_packed`` sorts each read's
hashes by ``ibf_row_indices(...)[..., 0]`` (``device.py:393-401``) with
JAX's unstable sort, so equal rows may come in any order there. The
port's order is ``(row0, slot)`` over the first ``min(n, M)`` slots, the
slots past them after, in slot order. Seeded numpy hashes go through
JAX's ``ibf_row_indices`` and that order is built from its rows with the
slot as tiebreak (past 2^31 rows, from its numpy twin
``ibf_row_indices_np``, since the jitted one returns int32); the port's
``probe_sort`` (its plain version, on the CPU) must give it exactly, at
the widths where the card's kernel changes route (a warp a read up to
256 slots, 1 to 8 keys a lane; a block a read past it, up to 4096).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ganon_tpu  # noqa: F401  (turns on jax x64 for the u64 reference)
import ganon_tpu.ops as jops
from ganon_tpu.ops.ibf_query import ibf_row_indices_np
from ganon_tpu_torch.ops import ibf_query as q
from ganon_tpu_torch.ops.winnow import torch_to_u64, u64_to_torch


def _jax_order(hashes: np.ndarray, n: np.ndarray, bin_size: int):
    """Each read's hashes in (JAX row0, slot) order over its first min(n,
    M) slots, the rest after in slot order. The rows are the jitted
    ``ibf_row_indices``' while they fit its int32 result, else its numpy
    twin's (int64; the jitted one's rows wrap past 2^31)."""
    row0 = ibf_row_indices_np(hashes, bin_size=bin_size,
                              hash_functions=1)[..., 0]
    if bin_size <= 2**31:
        assert np.array_equal(row0, np.asarray(jops.ibf_row_indices(
            jnp.asarray(hashes), bin_size=bin_size, hash_functions=1))[..., 0])
    B, M = hashes.shape
    out = np.empty_like(hashes)
    for b in range(B):
        v = min(max(int(n[b]), 0), M)
        slots = np.arange(v)
        order = slots[np.lexsort((slots, row0[b, :v]))]
        out[b] = hashes[b, np.concatenate([order, np.arange(v, M)])]
    return out


@pytest.mark.parametrize("M", [1, 31, 32, 33, 56, 64, 256, 257, 4096])
def test_probe_sort_matches_jax_rows(M):
    """Every route edge of the card's kernel, with n = 0, n past M, a
    repeated hash (equal rows: the slot decides) and bin_size near 2^46."""
    rng = np.random.default_rng(M)
    B = 3 if M == 4096 else 9
    hashes = rng.integers(0, 2**64, size=(B, M), dtype=np.uint64)
    hashes[0, :] = hashes[0, 0]
    hashes[2, M // 2:] = hashes[2, 0]
    n = rng.integers(0, M + 1, size=B).astype(np.int32)
    n[1], n[-1] = 0, M + 5
    for bin_size in (97, 2_787_889, (1 << 46) - 1):
        got = q.probe_sort(u64_to_torch(hashes), torch.from_numpy(n),
                           bin_size=bin_size)
        assert np.array_equal(torch_to_u64(got),
                              _jax_order(hashes, n, bin_size))
