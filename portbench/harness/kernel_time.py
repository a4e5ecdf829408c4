"""A kernel's card seconds over the traced window, for the rooflines.

From the device trace alone: the summed durations of the trace's kernels
whose name holds the kernel's symbol, where the trace holds one record
for each of the window's launches. Where it holds another number (the
profiler can drop records in long windows), there is no reading, and the
roofline is left out of that run's line. Each reading's source is kept
in ``run.sources`` for the run's info line.
"""


def seconds(run, kernel: str, symbol: str):
    """Card seconds of ``kernel`` (its ``kernels.launch`` name) whose
    compiled symbol holds ``symbol``; None when it never ran or the trace
    does not hold each launch."""
    n = run.launches.get(kernel, 0)
    if not n:
        return None
    recs = [v for name, v in run.ops.items() if symbol in name]
    got = sum(k for _, k in recs)
    run.sources[kernel] = f"trace: {got} records for {n} launches"
    if got != n:
        return None
    return sum(s for s, _ in recs)
