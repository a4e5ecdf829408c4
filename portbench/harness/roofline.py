"""The yardstick: the card's peaks and the bytes a kernel must move.

Peaks are NVIDIA's published H100 SXM figures (3.35 TB/s of HBM3); a
kernel's least time is its bytes over that rate, and its roofline share
that time over the time it took. Bytes are reckoned from the inputs and
the configuration with the reference's own code, never from what the
kernel did.
"""

from __future__ import annotations

import torch

from portbench.harness.judge import sample_hashes
from portbench.reference import ganon_ref as ref
from portbench.reference import pruned_ref

HBM_BYTES_PER_S = 3.35e12
# the program's documented batch: 8192 reads, or 8192 x 1024 bases
BATCH_READS = 8192
BATCH_BASES = 8192 * 1024


def table_row_bytes(layout: ref.Layout) -> int:
    """One row of a query table that keeps each target's bins in whole
    bytes of its own: the least a count of one probed row reads."""
    return sum(-(-(hi - lo) // 8) for lo, hi in zip(layout.bin_lo,
                                                   layout.bin_hi))


def _batches(sample) -> torch.Tensor:
    """Each read's batch: consecutive reads, ``BATCH_READS`` reads or
    ``BATCH_BASES`` bases, whichever closes a batch first."""
    bases = (sample.len1 + sample.len2).to(torch.int64).cpu()
    batch = torch.empty(len(sample), dtype=torch.int64)
    b, start, acc = 0, 0, 0
    for i, x in enumerate(bases.tolist()):
        if i > start and (i - start >= BATCH_READS or acc + x > BATCH_BASES):
            b, start, acc = b + 1, i, 0
        acc += x
        batch[i] = b
    return batch


def count_bytes(sample, layout: ref.Layout, device) -> int:
    """Bytes the flat ``count`` must read for ``sample``: for each batch of
    consecutive reads (``BATCH_READS`` reads or ``BATCH_BASES`` bases,
    whichever closes it first), the distinct table rows its hashes probe
    over all hash functions, times the row's bytes."""
    h, rd, _ = sample_hashes(sample, layout.k, layout.w, device)
    bt = _batches(sample).to(device)[rd]
    rows = torch.cat([bt * layout.bin_size + ref.hash_rows(h, layout.bin_size,
                                                           i)
                      for i in range(layout.h)])
    return int(torch.unique(rows).numel()) * table_row_bytes(layout)


def gate_fine_bytes(sample, lay, coarse, device, rel_cutoff=0.75) -> int:
    """Bytes the pruned ``gate`` and ``fine`` must read for ``sample``: a
    batch's distinct coarse rows times a coarse row's bytes, plus the
    distinct fine rows that its reads probe in the groups that pass their
    gate, times a fine row's bytes."""
    h, rd, nh = sample_hashes(sample, lay.k, lay.w, device)
    bt = _batches(sample).to(device)
    rows = torch.cat([bt[rd] * lay.coarse_bin_size
                      + ref.hash_rows(h, lay.coarse_bin_size, i)
                      for i in range(lay.coarse_h)])
    total = int(torch.unique(rows).numel()) * coarse.shape[1]
    n = nh.to(torch.int64)
    cut = torch.clamp(torch.ceil(n.to(torch.float64) * rel_cutoff),
                      min=1.0).to(torch.int64)
    g = pruned_ref.coarse_counts(coarse, lay, h, rd, len(sample))
    surv = (g >= cut[:, None]) & (n > 0)[:, None]
    fine_rows = []
    for grp in torch.unique(surv.nonzero(as_tuple=True)[1]).tolist():
        hit = surv[:, grp][rd]
        for i in range(lay.fine_h):
            r = lay.row_off[grp] + ref.hash_rows(h[hit], lay.bin_size[grp], i)
            fine_rows.append(bt[rd[hit]] * (1 << 40) + r)
    if fine_rows:
        total += int(torch.unique(torch.cat(fine_rows)).numel()) \
            * (lay.gs // 8)
    return total
