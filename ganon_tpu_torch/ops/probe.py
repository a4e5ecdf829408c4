"""The gather probe: the card's random row-gather rate into a small table.

Port of the repository's only Pallas kernel,
``scripts/pallas_gather_probe.py:28 pallas_count``: ``NPROBE`` random
rows of a ``[R, 32]`` u8 table (4 MB, which stays in L2) are gathered,
and each probe ``r`` adds the popcounts of its row's eight u32 words to
lanes ``8 (r & 15) .. 8 (r & 15) + 7`` of an int32 ``[1, 128]`` result.
No classify or build path runs it: it measures the rate that the count
kernels' gathers rest on (``chip_smoke.py``).

:func:`gather_probe` launches ``csrc/gprobe.cu`` on CUDA tensors; its
plain version :func:`gather_probe_plain` runs on the CPU.
"""

from __future__ import annotations

import torch

from ganon_tpu_torch import kernels

# the Pallas probe's shapes: table rows, bytes a row, probes
R = 1 << 17
W8 = 32
NPROBE = 1 << 20


def _check(tbl: torch.Tensor, rows: torch.Tensor) -> None:
    if tbl.dtype != torch.uint8 or tbl.dim() != 2 or tbl.shape[1] != W8:
        raise ValueError(f"tbl must be u8 [R, {W8}]")
    if tbl.shape[0] % 16:
        raise ValueError("the table's rows must fill [R / 16, 128] words")
    if rows.dtype != torch.int32 or rows.dim() != 1:
        raise ValueError("rows must be int32 [N]")


def gather_probe_plain(tbl: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gather_probe`."""
    words = tbl.view(torch.int32)[rows.to(torch.int64)]  # [N, 8]
    pc = torch.zeros_like(words)
    for i in range(32):
        pc += (words >> i) & 1
    lanes = torch.zeros((16, 8), dtype=torch.int64, device=tbl.device)
    lanes.index_add_(0, (rows & 15).to(torch.int64), pc.to(torch.int64))
    return lanes.reshape(1, 128).to(torch.int32)


def gather_probe(tbl: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Popcounts of the probed rows' words by lane: int32 ``[1, 128]``.

    ``tbl`` u8 ``[R, 32]`` (``R`` a multiple of 16, the Pallas kernel's
    ``[R / 16, 128]`` u32 view), ``rows`` int32 ``[N]`` in ``[0, R)``.
    """
    _check(tbl, rows)
    if tbl.device.type == "cpu":
        return gather_probe_plain(tbl, rows)
    kernels.check_cuda(tbl, rows)
    out = torch.zeros((1, 128), dtype=torch.int32, device=tbl.device)
    if rows.numel():
        kernels.launch("gather_probe", tbl, tbl.shape[0], rows, rows.numel(),
                       out)
    return out
