"""The pruned forest's ``gate`` and ``fine`` kernels' share of their
roofline over the traced window: the least time their bytes take at the
card's HBM rate (``harness/roofline.py``: a batch's distinct coarse rows,
and the distinct fine rows of the groups its reads pass, times their row
bytes, reckoned on the reference's own layout and coarse table) over
their card time (the device trace's ``gate_kernel`` and ``fine_kernel``
records, ``harness/kernel_time.py``)."""

from portbench.harness import kernel_time, roofline
from portbench.reference import pruned_ref


def read(run):
    c = run.cell
    lay = getattr(c, "ref_layout", None)
    if not isinstance(lay, pruned_ref.PrunedLayout):
        return None
    g = kernel_time.seconds(run, "gate", "gate_kernel")
    f = kernel_time.seconds(run, "fine", "fine_kernel")
    if not g or not f:
        return None
    per_sample, total = {}, 0
    for k, _, _, ok in c.runs:
        if ok:
            if k not in per_sample:
                per_sample[k] = roofline.gate_fine_bytes(
                    c.pool[k], lay, c.ref_coarse, c.device)
            total += per_sample[k]
    return 100.0 * total / roofline.HBM_BYTES_PER_S / (g + f)
