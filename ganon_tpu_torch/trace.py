"""Spans and counters of one request, on the device trace's clock.

A span (``with trace.span(name, **attrs):``) records its name, its start
in host real-time nanoseconds (``time.time_ns``: the clock of
torch.profiler's trace, whose events' ``ts`` in microseconds plus the
trace's ``baseTimeNanoseconds`` give it), its wall time, the CPU time of
the thread that opened it, its parent span and its thread. Starts and
durations are both read on the monotonic clock, a start moved to real
time by the root's offset between the two clocks (taken when the root
opens), so a child always lies inside its parent. The thread CPU clock is a system call (4-6 µs alone on the
H100's host, about 70 µs beside the engine's other threads), so spans
opened once a batch pass ``cpu=False`` and record no CPU time (None).
:func:`count` adds to a counter, :func:`high` keeps a high-water mark.

Spans and counters belong to a root, one request: ``cli.main`` opens
``cmd.<which>``, and a span opened while no root is open starts a root
of its own. Work handed to another thread carries the submitting root
with it: :func:`carry` on the submitting thread, ``with
trace.within(token):`` on the worker, so the writer's and the parser's
spans are recorded under the run that made their work (a worker span
with no carried root records nothing).

Each root keeps aggregate totals by span name (count; wall, self and CPU
seconds, the wall and CPU of a span nested in a span of its own name
counted once), its counters and high-water marks, the change of
``kernels.LAUNCHES`` over it, and its span events (at most ``EVENTS``;
the counter ``trace.dropped`` counts the rest). The newest ``ROOTS``
finished roots are kept: :func:`records` returns them, :func:`totals`
sums them, :func:`table` prints one for ``--verbose``.

While torch's profiler is on, a span on a thread that carries no other
thread's root also opens ``torch.profiler.record_function("span." +
name)``, so it lands in the device trace; the profiler keeps no event of
an annotation opened on another thread than its own. A span never waits
on the device and allocates nothing there.
"""

from __future__ import annotations

import itertools
import sys
import threading
import time
from collections import deque
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler

# finished roots kept (a 51 s window of some 50 samples fits many times)
ROOTS = 256
# span events kept a root
EVENTS = 4096

_lock = threading.Lock()
_roots: deque = deque(maxlen=ROOTS)
_ids = itertools.count(1)
_local = threading.local()


class Event(NamedTuple):
    name: str
    id: int
    parent: int            # the parent span's id, 0 for none
    thread: str
    start_ns: int          # host real time (the device trace's clock)
    wall_ns: int
    cpu_ns: int | None     # the opening thread's CPU time
    attrs: dict | None


def _launches() -> dict:
    k = sys.modules.get("ganon_tpu_torch.kernels")
    return dict(k.LAUNCHES) if k is not None else {}


class Root:
    """One request: aggregates by span name, counters, high-water marks,
    kernel launches and span events."""

    __slots__ = ("name", "id", "start_ns", "wall_s", "spans", "parents",
                 "counters", "highs", "launches", "events", "_launch0",
                 "offset_ns")

    def __init__(self, name: str):
        self.name = name
        self.id = next(_ids)
        self.start_ns = 0
        self.wall_s = 0.0
        # name -> [count, wall s, self s, cpu s (None: not measured)]
        self.spans: dict = {}
        self.parents: dict = {}   # name -> the name of its first parent
        self.counters: dict = {}
        self.highs: dict = {}
        self.launches: dict = {}  # kernels.LAUNCHES' change over the root
        self.events: list = []
        self._launch0 = _launches()
        self.offset_ns = _clock_offset()


def _clock_offset() -> int:
    """Real time minus the monotonic clock, in ns: the closest of three
    readings of the real-time clock between two of the monotonic one."""
    best = None
    for _ in range(3):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


class _Thread:
    __slots__ = ("root", "base", "stack", "open", "worker", "name")

    def __init__(self):
        self.name = threading.current_thread().name
        self.root = None     # the root spans of this thread go to
        self.base = None     # the carried parent of a worker's spans
        self.stack = []      # this thread's open spans
        self.open = {}       # name -> open spans of that name
        self.worker = False  # runs work carried from another thread


def _state() -> _Thread:
    st = getattr(_local, "st", None)
    if st is None:
        st = _local.st = _Thread()
    return st


class span:
    """Context manager of one span (see the module's docstring)."""

    __slots__ = ("name", "attrs", "id", "parent", "root", "start_ns",
                 "wall_s", "cpu_s", "_child", "_t0", "_c0", "_rf", "_outer",
                 "_owns", "_st", "_cpu")

    def __init__(self, name: str, *, cpu: bool = True, **attrs):
        self.name = name
        self.attrs = attrs or None
        self.root = None
        self._cpu = cpu
        self.wall_s = self._child = 0.0
        self.cpu_s = 0.0 if cpu else None

    def set(self, **attrs) -> None:
        """Add attributes to the span's event."""
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)

    def elapsed_s(self) -> float:
        """Wall seconds since the span opened."""
        return (time.perf_counter_ns() - self._t0) / 1e9

    def __enter__(self):
        st = self._st = _state()
        root = st.root
        self._owns = root is None
        if root is None:
            if st.worker:
                return self  # carried from no root: nothing is recorded
            root = st.root = Root(self.name)
        self.root = root
        self.parent = st.stack[-1] if st.stack else st.base
        st.stack.append(self)
        depth = st.open.get(self.name, 0)
        st.open[self.name] = depth + 1
        self._outer = depth == 0
        self.id = next(_ids)
        self._rf = None
        if not st.worker and _autograd_profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function("span." + self.name)
            self._rf.__enter__()
        if self._cpu:
            self._c0 = time.thread_time_ns()
        self._t0 = time.perf_counter_ns()
        self.start_ns = root.offset_ns + self._t0
        if self._owns:
            root.start_ns = self.start_ns
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        root = self.root
        if root is None:
            return False
        cpu_ns = time.thread_time_ns() - self._c0 if self._cpu else None
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        st = self._st
        st.stack.pop()
        st.open[self.name] -= 1
        wall_ns = t1 - self._t0
        self.wall_s = wall_ns / 1e9
        if cpu_ns is not None:
            self.cpu_s = cpu_ns / 1e9
        if st.stack:  # a parent on this thread: its self time excludes ours
            st.stack[-1]._child += self.wall_s
        parent = self.parent
        with _lock:
            agg = root.spans.get(self.name)
            if agg is None:
                agg = root.spans[self.name] = [
                    0, 0.0, 0.0, None if self.cpu_s is None else 0.0]
            agg[0] += 1
            agg[2] += self.wall_s - self._child
            if self._outer:
                agg[1] += self.wall_s
                if agg[3] is not None and self.cpu_s is not None:
                    agg[3] += self.cpu_s
                if self.name not in root.parents:
                    root.parents[self.name] = parent and parent.name
            if len(root.events) < EVENTS:
                root.events.append(Event(
                    self.name, self.id, parent.id if parent else 0,
                    st.name, self.start_ns, wall_ns,
                    cpu_ns, self.attrs))
            else:
                root.counters["trace.dropped"] = \
                    root.counters.get("trace.dropped", 0) + 1
        if self._owns:
            st.root = None
            root.wall_s = self.wall_s
            now = _launches()
            root.launches = {k: v - root._launch0.get(k, 0)
                             for k, v in now.items()
                             if v != root._launch0.get(k, 0)}
            with _lock:
                _roots.append(root)
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the open root's counter ``name`` (nothing outside a
    root)."""
    root = _state().root
    if root is not None:
        with _lock:
            root.counters[name] = root.counters.get(name, 0) + n


def high(name: str, v) -> None:
    """Keep the largest ``v`` seen as the open root's mark ``name``."""
    root = _state().root
    if root is not None:
        with _lock:
            if name not in root.highs or v > root.highs[name]:
                root.highs[name] = v


def carry() -> tuple:
    """The calling thread's root and open span, to hand to a worker
    thread with the work (:class:`within`)."""
    st = _state()
    return st.root, st.stack[-1] if st.stack else st.base


class within:
    """On a worker thread: record spans, counters and marks under a
    :func:`carry` token's root and parent."""

    __slots__ = ("_token", "_saved")

    def __init__(self, token: tuple):
        self._token = token

    def __enter__(self):
        st = _state()
        self._saved = st.root, st.base, st.worker
        st.root, st.base = self._token
        st.worker = True
        return self

    def __exit__(self, *exc) -> bool:
        st = _state()
        st.root, st.base, st.worker = self._saved
        return False


def records(name: str | None = None, last: int | None = None) -> list:
    """The kept finished roots (named ``name``), oldest first; the newest
    ``last`` of them when given."""
    with _lock:
        roots = [r for r in _roots if name is None or r.name == name]
    if last is not None:
        roots = roots[max(len(roots) - last, 0):]
    return roots


def totals(roots) -> dict:
    """The roots' aggregates summed: ``spans`` (name -> count, wall_s,
    self_s, cpu_s; cpu_s None for a span opened with ``cpu=False``),
    ``counters`` (summed; high-water marks as their largest),
    ``launches``, ``wall_s`` and the number of ``roots``."""
    spans: dict = {}
    counters: dict = {}
    launches: dict = {}
    wall = 0.0
    roots = list(roots)
    with _lock:
        for r in roots:
            wall += r.wall_s
            for k, a in r.spans.items():
                s = spans.get(k)
                if s is None:
                    spans[k] = list(a)
                    continue
                for i in range(3):
                    s[i] += a[i]
                s[3] = None if s[3] is None or a[3] is None else s[3] + a[3]
            for k, v in r.counters.items():
                counters[k] = counters.get(k, 0) + v
            for k, v in r.highs.items():
                counters[k] = max(counters.get(k, v), v)
            for k, v in r.launches.items():
                launches[k] = launches.get(k, 0) + v
    return {"spans": {k: {"count": a[0], "wall_s": a[1], "self_s": a[2],
                          "cpu_s": a[3]} for k, a in spans.items()},
            "counters": counters, "launches": launches, "wall_s": wall,
            "roots": len(roots)}


def table(root: Root) -> str:
    """The root's spans (wall, self and CPU seconds and count, indented
    under their parents), then its counters and kernel launches."""
    t = totals([root])
    kids: dict = {}
    for name in t["spans"]:
        kids.setdefault(root.parents.get(name), []).append(name)
    lines = [f"{'span':<34}{'wall s':>11}{'self s':>11}{'cpu s':>11}"
             f"{'count':>8}"]
    shown: set = set()

    def walk(name, depth):
        shown.add(name)
        a = t["spans"][name]
        cpu = "-" if a["cpu_s"] is None else f"{a['cpu_s']:.4f}"
        lines.append(f"{'  ' * depth + name:<34}{a['wall_s']:>11.4f}"
                     f"{a['self_s']:>11.4f}{cpu:>11}{a['count']:>8}")
        # children in the order they first finished
        for kid in kids.get(name, []):
            if kid not in shown:
                walk(kid, depth + 1)

    # the root's tree, then any span whose first parent it does not hold
    for name in kids.get(None, []) + list(t["spans"]):
        if name not in shown:
            walk(name, 0)
    for title, d in (("counter", t["counters"]),
                     ("kernel launches", t["launches"])):
        if d:
            lines.append(title)
            lines += [f"  {k:<32}{v:>11}" for k, v in sorted(d.items())]
    return "\n".join(lines)
