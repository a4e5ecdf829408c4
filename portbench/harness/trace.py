"""Spans, kernel timings and the device trace of a traced run.

Everything here wraps the program from outside, by attribute: a span is
the host time of a call into one of the program's layers, each
``kernels.launch`` is counted, and the device trace is torch.profiler's
over the measured window (on a card, in every run of a cell with an
end-to-end metric read from it, such as ``classify_kernel_ms_per_gbp``).
``restore`` puts every wrapped attribute back.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch


class Tracer:
    def __init__(self, profile: bool):
        self.profile = profile
        self.span_s: dict = defaultdict(float)
        self.calls: dict = defaultdict(list)  # name -> returned values
        self.launch_n: dict = defaultdict(int)  # kernel name -> launches
        self._saved: list = []
        self._prof = None

    # -- spans ---------------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str):
        rf = (torch.profiler.record_function("span." + name)
              if self.profile else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            try:
                yield
            finally:
                self.span_s[name] += time.perf_counter() - t0

    def wrap(self, obj, attr: str, name: str, keep: bool = False) -> None:
        """Time every call of ``obj.attr`` as span ``name`` (and keep what
        it returns with ``keep``)."""
        real = getattr(obj, attr)

        def wrapped(*a, **kw):
            with self.span(name):
                out = real(*a, **kw)
            if keep:
                self.calls[name].append(out)
            return out

        self._saved.append((obj, attr, real))
        setattr(obj, attr, wrapped)

    def replace(self, obj, attr: str, fn) -> None:
        self._saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, fn)

    def restore(self) -> None:
        while self._saved:
            obj, attr, real = self._saved.pop()
            setattr(obj, attr, real)

    # -- kernels -------------------------------------------------------------

    def count_launches(self, kernels_mod) -> None:
        """Count every ``kernels.launch`` by kernel name."""
        real = kernels_mod.launch
        counts = self.launch_n

        def launch(name, *args, counter=None):
            counts[name] += 1
            return real(name, *args, counter=counter)

        self._saved.append((kernels_mod, "launch", real))
        kernels_mod.launch = launch

    # -- device trace --------------------------------------------------------

    def start_profile(self) -> None:
        if not self.profile:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()

    def stop_profile(self, path: str) -> dict | None:
        """Busy seconds, device operations and idle gaps from the trace
        (None without a profile)."""
        if self._prof is None:
            return None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self._prof.export_chrome_trace(path)
        self._prof = None
        with open(path) as f:
            trace = json.load(f)
        os.remove(path)
        return reduce_trace(trace.get("traceEvents", []))


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def reduce_trace(events: list) -> dict:
    """``busy_s`` (the union of device activity), ``kernel_s`` and
    ``kernel_n`` (the summed seconds and the number of the kernel
    records, copies and fills left out), ``device_ops`` (seconds by
    operation name, most first), ``idle_gaps`` (the longest gaps between
    device activity, each named by the innermost ``span.*`` annotation
    open on the host at its middle) and ``ops`` (every operation's
    seconds and count)."""
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                  e.get("name", "?"))
                 for e in events
                 if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS)
    kern = [float(e.get("dur", 0)) for e in events
            if e.get("ph") == "X" and e.get("cat") == "kernel"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                    e["name"][5:])
                   for e in events
                   if e.get("ph") == "X" and str(e.get("name", ""))
                   .startswith("span."))
    by_op: dict = defaultdict(float)
    n_op: dict = defaultdict(int)
    for s, t, n in dev:
        by_op[n] += (t - s) / 1e6
        n_op[n] += 1
    busy, gaps, end = 0.0, [], None
    for s, t, _ in dev:
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    if spans and dev:
        # the idle time before the first and after the last operation,
        # inside the traced spans
        lo = min(s for s, _, _ in spans)
        hi = max(t for _, t, _ in spans)
        if lo < dev[0][0]:
            gaps.append((lo, dev[0][0]))
        if end is not None and hi > end:
            gaps.append((end, hi))

    def label(mid):
        best = None
        for s, t, n in spans:
            if s <= mid <= t and (best is None or t - s < best[0]):
                best = (t - s, n)
        return best[1] if best else "outside"

    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    return {
        "busy_s": busy / 1e6,
        "kernel_s": sum(kern) / 1e6,
        "kernel_n": len(kern),
        "device_ops": sorted(([n, v] for n, v in by_op.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": [[label((a + b) / 2), (b - a) / 1e6]
                      for a, b in gaps[:10]],
        "device_events": len(dev),
        "ops": {n: (by_op[n], n_op[n]) for n in by_op},
    }
