"""Share of the window's builds spent ingesting the input (reading the
FASTA files and extracting minimizers on the card): the StopClock
``Ingest`` over the sum of the phases, summed over the window's builds
(traced run)."""


def read(run):
    ph = getattr(run.cell, "phases", None)
    total = sum(sum(p.values()) for p in ph or [])
    if not total:
        return None
    return 100.0 * sum(p.get("Ingest", 0.0) for p in ph) / total
