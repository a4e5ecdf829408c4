"""Share of the window's sample time spent in EM reassignment and the
report: the benchmark's spans around ``reassign.reassign`` and
``report.report``, over its spans around the samples (traced run)."""


def read(run):
    s = run.span_s
    if not s.get("sample") or "reassign" not in s:
        return None
    return 100.0 * (s.get("reassign", 0.0) + s.get("report", 0.0)) \
        / s["sample"]
