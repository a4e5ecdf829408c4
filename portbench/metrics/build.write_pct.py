"""Share of the window's builds spent writing the filter: the build's
StopClock ``WriteIBF`` over the sum of its phases, summed over the
window's builds (traced run)."""


def read(run):
    ph = getattr(run.cell, "phases", None)
    total = sum(sum(p.values()) for p in ph or [])
    if not total:
        return None
    return 100.0 * sum(p.get("WriteIBF", 0.0) for p in ph) / total
