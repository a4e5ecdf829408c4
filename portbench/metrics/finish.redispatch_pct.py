"""Share of the dispatched batches sent to the card again or finished
on the exact path: the program's counters ``engine.redispatches`` (cap
overflows, top-K widenings, pair spills) and ``engine.exact_batches``
over ``engine.batches``, summed over the window's samples (traced
run)."""

from portbench.harness import spans


def read(run):
    t = spans.window_totals(run)
    if t is None:
        return None
    c = t["counters"]
    if not c.get("engine.batches"):
        return None
    return 100.0 * (c.get("engine.redispatches", 0)
                    + c.get("engine.exact_batches", 0)) / c["engine.batches"]
