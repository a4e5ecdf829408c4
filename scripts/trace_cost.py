"""What the span recorder costs: microseconds a span, and the main
thread's CPU seconds a classify sample.

    python scripts/trace_cost.py [--checkout DIR] [--samples N]
        [--seed S] [--spans N] [--interleave] [--small]

Classifies ``--samples`` whole samples of the benchmark's
``arc_ibf_short`` cell (set up by ``portbench``'s own cell: the filter
built and loaded, the pool of FASTQ samples written, one warm-up
sample) through ``cli.main("classify")``, the package imported from
``--checkout`` (default: this checkout), and prints one JSON line: the
main thread's CPU seconds and the wall seconds of each sample, and,
where the package has ``ganon_tpu_torch.trace``, the spans a sample
records, each span's wall and self seconds a sample, the counters, and
the microseconds of an empty span with torch's profiler off and on (CPU
and CUDA activities), with the thread CPU clock and without. Run a checkout without the recorder
and this one in one call, in turns, to compare them on one card.
``--interleave`` then classifies ``--samples`` pairs more in this
process, the recorder taken out (every span, counter and hand-off a
no-op) for one of each pair in turns (on, off, off, on, ...): the
comparison the host's drift between processes cannot blur.
``--small`` cuts the cell to a few species and a small sample, to
rehearse on the CPU.
"""

import argparse
import contextlib
import glob
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def span_us(trace, torch, n: int) -> dict:
    """Microseconds an empty span costs, inside a root, with the profiler
    off and on; with the thread CPU clock (the default) and without it
    (``cpu=False``, the per-batch spans)."""

    def loop(k, cpu):
        with trace.span("cmd.cost"):
            t0 = time.perf_counter()
            for _ in range(k):
                with trace.span("cost.span", cpu=cpu):
                    pass
            return (time.perf_counter() - t0) / k * 1e6

    loop(1000, True)
    out = {}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    for cpu, tag in ((True, ""), (False, "_nocpu")):
        out["span_us_profiler_off" + tag] = loop(n, cpu)
        with torch.profiler.profile(activities=acts):
            loop(100, cpu)
            out["span_us_profiler_on" + tag] = loop(n // 10, cpu)
    return out


class _NullSpan:
    """A span that records nothing: the recorder taken out."""

    root = None
    wall_s = cpu_s = 0.0

    def __init__(self, *args, **attrs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass

    def elapsed_s(self):
        return 0.0


@contextlib.contextmanager
def null_recorder(trace, engine):
    """Every span, counter and hand-off of the recorder a no-op, and the
    engine's ``timing`` zero, while the block runs."""
    names = ("span", "within", "count", "high", "carry")
    saved = [getattr(trace, n) for n in names] + [engine._walls]
    trace.span = trace.within = _NullSpan
    trace.count = trace.high = lambda *a, **kw: None
    trace.carry = lambda: (None, None)
    engine._walls = lambda root: {k: 0.0 for k, _ in engine._TIMING}
    try:
        yield
    finally:
        for n, v in zip(names, saved):
            setattr(trace, n, v)
        engine._walls = saved[-1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkout", default=ROOT)
    ap.add_argument("--samples", type=int, default=10)
    ap.add_argument("--seed", type=int, default=2**31 + 12345)
    ap.add_argument("--spans", type=int, default=100000)
    ap.add_argument("--interleave", action="store_true")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    sys.path[:0] = [os.path.abspath(args.checkout), ROOT]
    import torch

    from portbench.harness import spec
    from portbench.harness.classify_cell import ClassifyCell
    from portbench.harness.trace import Tracer

    device = "cuda" if torch.cuda.is_available() else "cpu"
    work = os.path.join(os.path.abspath(args.checkout), ".trace_cost_work")
    os.makedirs(work, exist_ok=True)
    cell = ClassifyCell(spec.Cell("arc_ibf_short"), args.seed, device, work,
                        Tracer(profile=False),
                        {"species": 3, "sample": 1500} if args.small
                        else None)
    try:
        cell.setup()
        import ganon_tpu_torch

        try:
            from ganon_tpu_torch import trace
        except ImportError:
            trace = None
        def sample(i, cpu, wall):
            prefix = os.path.join(work, f"s{i}")
            c0, t0 = time.thread_time(), time.perf_counter()
            assert cell._classify(i % len(cell.pool), prefix)
            cpu.append(time.thread_time() - c0)
            wall.append(time.perf_counter() - t0)
            for f in glob.glob(prefix + ".*"):
                os.remove(f)

        cpu, wall = [], []
        for i in range(args.samples):
            sample(i, cpu, wall)
        out = {"checkout": os.path.relpath(ganon_tpu_torch.__file__, ROOT),
               "device": (torch.cuda.get_device_name(0) if device == "cuda"
                          else "cpu"),
               "main_cpu_s": cpu, "wall_s": wall}
        if trace is not None:
            roots = trace.records("cmd.classify", last=args.samples)
            out["spans_a_sample"] = [
                sum(a[0] for a in r.spans.values()) for r in roots]
            # each span's wall and self seconds a sample, and the counters
            t = trace.totals(roots)
            out["span_s_a_sample"] = {
                k: [round(v["wall_s"] / len(roots), 6),
                    round(v["self_s"] / len(roots), 6)]
                for k, v in t["spans"].items()}
            out["counters"] = t["counters"]
            if args.interleave:
                from ganon_tpu_torch.classify import engine

                split = {"on": ([], []), "off": ([], [])}
                for i in range(2 * args.samples):
                    if i % 4 in (1, 2):
                        with null_recorder(trace, engine):
                            sample(i, *split["off"])
                    else:
                        sample(i, *split["on"])
                out["interleaved"] = {
                    k: {"main_cpu_s": c, "wall_s": w}
                    for k, (c, w) in split.items()}
            out.update(span_us(trace, torch, args.spans))
        print("trace_cost " + json.dumps(out), flush=True)
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
