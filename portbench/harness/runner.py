"""One run of one cell: set-up, the measured window, the check, the
result line.

``run`` is the whole of a benchmark run after the harness's look for
cards, so tests can drive it on the CPU (``device="cpu"``) at a small
``scale``. The measured window runs with nothing of the harness around
the program but for a host span around each sample or build, a count of
each kernel launch and, on a card where an end-to-end metric is read
from it, the profiler's device trace; ``trace`` adds the trace in every
cell, the spans of :mod:`portbench.harness.trace` and the per-layer
metrics.
"""

from __future__ import annotations

import os
import shutil
import sys
import time
from types import SimpleNamespace

import torch

from portbench.harness import host, judge, spec
from portbench.harness.build_cell import BuildCell
from portbench.harness.classify_cell import ClassifyCell
from portbench.harness.trace import Tracer

KINDS = {"classify": (ClassifyCell, judge.judge_classify),
         "build": (BuildCell, judge.judge_build)}
WORK = os.path.join(spec.ROOT, ".portbench_work")


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", t_process: float, scale: dict | None = None,
        control: bool = False, work: str = WORK) -> dict:
    cls, judge_fn = KINDS[cell.traffic["kind"]]
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    tracer = Tracer(profile=device != "cpu" and (trace or any(
        m["source"] == "device_trace" for m in cell.end_to_end)))
    c = cls(cell, seed, device, work, tracer, scale)
    try:
        c.setup()
        if device != "cpu":
            torch.cuda.synchronize()
        setup_s = time.monotonic() - t_process
        if trace:
            c.instrument()
        from ganon_tpu_torch import kernels

        tracer.count_launches(kernels)
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        tracer.start_profile()
        window_s, bases = c.window(seconds)
        prof = tracer.stop_profile(os.path.join(work, "trace.json"))
        tracer.restore()
        launches = dict(tracer.launch_n)
        if prof is not None and prof["kernel_n"] < sum(launches.values()):
            raise RuntimeError(
                f"the device trace lost kernel records: {prof['kernel_n']} "
                f"for {sum(launches.values())} launches")
        peak = (torch.cuda.max_memory_allocated() if device != "cpu"
                else 0)
        c.release()
        t_check = time.monotonic()
        checks = judge_fn(c, control=control)
        check_s = time.monotonic() - t_check
        record = SimpleNamespace(cell=c, calls=tracer.calls,
                                 span_s=dict(tracer.span_s),
                                 launches=launches, sources={},
                                 ops=prof["ops"] if prof else {},
                                 window_s=window_s, bases=bases)
        if trace:
            metrics = {}
            for m in cell.per_layer:
                v = spec.metric_reader(m["name"])(record)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            values = {"setup_s": setup_s,
                      f"{c.kind}_mbp_per_min": bases / 1e6 / (window_s / 60)}
            if prof is not None and bases:
                values[f"{c.kind}_kernel_ms_per_gbp"] = (
                    prof["kernel_s"] * 1e3 / (bases / 1e9))
            # without a card there is no device trace, and no device metric
            metrics = {m["name"]: {"value": values[m["name"]],
                                   "unit": m["unit"]}
                       for m in cell.end_to_end if m["name"] in values}
        attempted = len(c.runs)
        failed = sum(not r[-1] for r in c.runs)
        correct = all(checks[k] <= judge.LIMITS[k] and checks[k] >= 0
                      for k in checks)
        dev = {"platform": "gpu" if device != "cpu" else "cpu",
               "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                        else "cpu"),
               "count": cell.chips, "memory_peak_bytes": int(peak)}
        out = {"correct": correct, "attempted": attempted, "failed": failed,
               "metrics": metrics, "device": dev}
        if trace and prof is not None:
            dev["busy_s"] = prof["busy_s"]
            dev["window_s"] = window_s
            out["breakdown"] = {"device_ops": prof["device_ops"],
                                "idle_gaps": prof["idle_gaps"]}
        out["checks"] = {k: {"value": v, "limit": judge.LIMITS[k]}
                         for k, v in checks.items()}
        info = {"window_runs": attempted, "window_s": window_s,
                "bases": bases, "seconds_per_run": [r[-2] for r in c.runs],
                "checked_run": c.checked_run(), "launches": launches,
                "spans": dict(tracer.span_s),
                "input_bytes": getattr(c, "input_bytes", None),
                "filter_bytes": getattr(c, "filter_bytes", None),
                "table_bytes": getattr(c, "table_bytes", None),
                "load_s": getattr(c, "load_s", None), "check_s": check_s,
                "host": host.deltas(c.host),
                "checked_output_bytes": c.output_bytes(),
                "device_events": prof and prof["device_events"],
                "kernel_s": prof and prof["kernel_s"],
                "kernel_records": prof and prof["kernel_n"],
                "roofline_sources": record.sources}
        print("portbench-info " + repr(info), file=sys.stderr, flush=True)
        return out
    finally:
        tracer.restore()
        shutil.rmtree(work, ignore_errors=True)
