"""Share of the classify calls' engine time spent dispatching batches
(packing, upload and kernel launches): ``timing["dispatch"]`` over
``timing["total"]``, summed over the window's samples (traced run)."""


def read(run):
    t = [r["timing"] for r in run.calls.get("classify", [])]
    total = sum(x["total"] for x in t)
    if not total:
        return None
    return 100.0 * sum(x["dispatch"] for x in t) / total
