"""Readings of the host taken between the window's runs, for the run's
``portbench-info`` line: they show whether a slow stretch of samples is
the process's own CPU work, steal, I/O wait or writeback.

``reading`` is one snapshot: the process's CPU seconds (every thread),
the machine's steal and I/O wait seconds (``/proc/stat``) and its dirty
and writeback bytes (``/proc/meminfo``); ``deltas`` turns snapshots
into per-run figures.
"""

from __future__ import annotations

import os
import time

_TICK = os.sysconf("SC_CLK_TCK")


def _proc_stat() -> tuple:
    try:
        with open("/proc/stat") as f:
            cpu = f.readline().split()
        return int(cpu[5]) / _TICK, int(cpu[8]) / _TICK
    except (OSError, IndexError, ValueError):
        return 0.0, 0.0


def _meminfo_mb() -> float:
    kb = 0
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith(("Dirty:", "Writeback:")):
                    kb += int(line.split()[1])
    except (OSError, IndexError, ValueError):
        pass
    return kb / 1024


def reading() -> tuple:
    """(wall, process CPU, I/O wait, steal) seconds and dirty MB."""
    t = os.times()
    iowait, steal = _proc_stat()
    return (time.perf_counter(), t.user + t.system, iowait, steal,
            _meminfo_mb())


def deltas(snaps: list) -> dict:
    """Per-run wall, CPU, I/O wait and steal seconds between consecutive
    snapshots, the dirty MB at each run's end, and the window's sums."""
    keys = ("wall_s", "cpu_s", "iowait_s", "steal_s")
    per = {k: [round(b[i] - a[i], 4) for a, b in zip(snaps, snaps[1:])]
           for i, k in enumerate(keys)}
    per["dirty_mb"] = [round(s[4], 1) for s in snaps[1:]]
    per["window"] = {k: round(snaps[-1][i] - snaps[0][i], 4)
                     for i, k in enumerate(keys)} if snaps else {}
    return per
