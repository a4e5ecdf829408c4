"""Multi-process runtime wiring for ``classify --distributed``.

Port of ``ganon_tpu.parallel.multihost``. The reference's only
multi-node notion is embarrassingly parallel file-level batching
(``--batch-reads``, GanonClassify.cpp:289-351), and the JAX package
keeps that shape: every process runs the same CLI command, read files
are partitioned per process, and each process classifies its share on
its own local device mesh.

Here the processes join one ``torch.distributed`` group through
PyTorch's own launcher contract (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them), in place of
``JAX_COORDINATOR_ADDRESS``. Classify needs no collective across
processes, so the backend is gloo, for the initialisation and one
closing barrier; NCCL is not needed on this path (and refuses two ranks
on one card, which gloo allows).

Outputs: each process writes its shard's outputs under
``{output_prefix}.h{rank}`` unless it owns the whole input. ``report``
and ``table`` accept many ``.rep`` inputs, so the per-process reports
merge downstream exactly like ``--batch-reads`` outputs do.
"""

from __future__ import annotations

import os

# whether this module initialised the process group (and so ends it)
_OWNED = False


def maybe_initialize(force: bool = False) -> tuple[int, int]:
    """Join the process group when configured; ``(rank, world_size)``.

    Triggers on ``--distributed`` (``force=True``) or a ``WORLD_SIZE`` in
    the environment; the group is initialised from the environment
    (``init_method="env://"``). Safe to call repeatedly.
    """
    global _OWNED
    import torch.distributed as dist

    if not dist.is_available():
        return 0, 1
    if (force or os.environ.get("WORLD_SIZE")) and not dist.is_initialized():
        dist.init_process_group(backend="gloo", init_method="env://")
        _OWNED = True
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def finish() -> None:
    """Wait for every process at the end of a run (so none leaves while
    another still writes its shard), then leave the group if this module
    joined it."""
    global _OWNED
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return
    dist.barrier()
    if _OWNED:
        dist.destroy_process_group()
        _OWNED = False


def shard_reads(single, paired, batch, process_index: int,
                process_count: int):
    """Partition read inputs across hosts.

    ``paired`` is a flat [r1a, r2a, r1b, r2b, ...] list — pairs stay
    together. Returns ``(single, paired, batch, stride, offset)``:

    * enough file units (>= hosts): file-level round-robin, stride 1 —
      the reference's --batch-reads shape (GanonClassify.cpp:289-351);
    * fewer units than hosts (e.g. ONE big fastq on a pod): every host
      keeps ALL files and instead takes records where
      ``record_index % stride == offset`` (record-range sharding —
      the engine applies the stripe reader-agnostically via
      io.pipeline.strided_batches), so no host sits idle.
    """
    if process_count <= 1:
        return single, paired, batch, 1, 0

    pairs = [tuple(paired[i : i + 2]) for i in range(0, len(paired), 2)]
    units = (
        [("s", f) for f in single]
        + [("p", p) for p in pairs]
        + [("b", f) for f in batch]
    )
    if len(units) < process_count:
        return single, paired, batch, process_count, process_index

    # one round-robin over ALL units (not per kind) so every host gets
    # a unit whenever units >= hosts
    mine = [u for i, u in enumerate(units)
            if i % process_count == process_index]
    return (
        [f for k, f in mine if k == "s"],
        [f for k, p in mine if k == "p" for f in p],
        [f for k, f in mine if k == "b"],
        1,
        0,
    )


def host_output_prefix(prefix: str, process_index: int,
                       process_count: int) -> str:
    """Per-host output prefix (merge downstream via report/table)."""
    if process_count <= 1 or not prefix:
        return prefix
    return f"{prefix}.h{process_index}"
