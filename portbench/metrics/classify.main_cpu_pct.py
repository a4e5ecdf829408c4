"""The main thread's CPU seconds over its wall seconds in the classify
calls' engine (the program's span ``engine.run``, whose CPU time is the
thread's that opened it), summed over the window's samples (traced run):
the rest is the loop's time off the CPU, waiting on the interpreter lock,
the card or I/O."""

from portbench.harness import spans


def read(run):
    t = spans.window_totals(run)
    if t is None or not t["spans"].get("engine.run", {}).get("wall_s"):
        return None
    r = t["spans"]["engine.run"]
    return 100.0 * r["cpu_s"] / r["wall_s"]
