"""Share of the classify calls' engine time spent finishing batches
(the wait for the result's copy, unpacking, LCA, tallies and the
writers): ``timing["finish"]`` over ``timing["total"]``, summed over the
window's samples (traced run)."""


def read(run):
    t = [r["timing"] for r in run.calls.get("classify", [])]
    total = sum(x["total"] for x in t)
    if not total:
        return None
    return 100.0 * sum(x["finish"] for x in t) / total
