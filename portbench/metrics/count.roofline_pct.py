"""The flat ``count`` kernel's share of its roofline over the traced
window: the least time its bytes take at the card's HBM rate
(``harness/roofline.py``: distinct table rows probed a batch, times a
row's bytes, reckoned from the reads on the reference's own layout of the
configuration) over its card time (the device trace's ``count_kernel``
records, ``harness/kernel_time.py``)."""

from portbench.harness import kernel_time, roofline
from portbench.reference import ganon_ref as ref


def read(run):
    c = run.cell
    layout = getattr(c, "ref_layout", None)
    if not isinstance(layout, ref.Layout):
        return None
    secs = kernel_time.seconds(run, "count", "count_kernel")
    if not secs:
        return None
    per_sample = {}
    total = 0
    for k, _, _, ok in c.runs:
        if not ok:
            continue
        if k not in per_sample:
            per_sample[k] = roofline.count_bytes(c.pool[k], layout, c.device)
        total += per_sample[k]
    return 100.0 * total / roofline.HBM_BYTES_PER_S / secs
