"""The program's own spans and counters over a traced window's classify
samples, for the per-layer metrics that read them.

Each sample is one ``cli.main("classify", ...)``, one root
``cmd.classify`` of the program's recorder (``ganon_tpu_torch.trace``);
the window's are the newest, one a window run. A program without the
recorder gives None, and so does every metric read from it.
"""

from __future__ import annotations


def window_totals(run) -> dict | None:
    """The recorder's totals over the window's ``cmd.classify`` roots."""
    try:
        from ganon_tpu_torch import trace
    except ImportError:  # a program without the recorder
        return None
    roots = trace.records("cmd.classify", last=len(run.cell.runs))
    return trace.totals(roots) if roots else None


def share(run, parts, whole: str) -> float | None:
    """100 times the summed wall seconds of the spans ``parts`` over those
    of span ``whole``, over the window's samples."""
    t = window_totals(run)
    if t is None:
        return None
    spans = t["spans"]
    total = spans.get(whole, {}).get("wall_s")
    if not total:
        return None
    return 100.0 * sum(spans[p]["wall_s"] for p in parts if p in spans) \
        / total
