"""Share of the classify calls' engine time spent waiting for parsed
input: the engine's own ``timing["input_wait"]`` over its
``timing["total"]``, summed over the window's samples (traced run)."""


def read(run):
    t = [r["timing"] for r in run.calls.get("classify", [])]
    total = sum(x["total"] for x in t)
    if not total:
        return None
    return 100.0 * sum(x["input_wait"] for x in t) / total
