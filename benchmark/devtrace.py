"""The traced slice: torch.profiler over a steady slice of work, reduced
to what the per-layer metrics and the breakdown read.

Device operations are the kernels, copies and sets the profiler records
on the card (CUPTI), graph replays included; a user annotation's span on
the device track is not one. The slice's window is the host span
`bench.slice`, which starts and ends with a synchronize of every card.
Busy time is the union of a card's operations within it. An idle gap is
a stretch of the window in which a card runs nothing; it is labelled by
the innermost host operation of the harness's thread that was running
when it began. Times are kept in seconds.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

SLICE = "bench.slice"
# gaps shorter than this are summed under one label, not looked up
SHORT_GAP_S = 2e-6
NAME_CHARS = 120


def _on_device(e) -> bool:
    """A profiler event that is a kernel, copy or set on a card, by the
    benchmark's own rule, which the port's tools read through profile():
    torch's elementwise and copy kernels hold "{lambda(" in their names, a
    user annotation does not count."""
    return (str(e.device_type).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)
            and ("#" not in e.key or "{lambda(" in e.key))


def union(spans: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The disjoint intervals that (start, end) intervals cover, sorted."""
    out: List[List[float]] = []
    for start, end in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


class Trace:
    """A profiled slice: per card its device operations, busy and idle
    time, and the host operations of the harness's thread."""

    def __init__(self, events, devices: Sequence[int]):
        # the host's span; torch marks it a user annotation, and its copy
        # on the device track is one too
        slices = [e for e in events if e.name == SLICE
                  and not str(e.device_type).endswith("CUDA")]
        if not slices:
            raise RuntimeError("the profiler recorded no bench.slice span")
        sl = slices[0]
        self.t0, self.t1 = sl.time_range.start * 1e-6, sl.time_range.end * 1e-6
        self.window_s = self.t1 - self.t0
        self.devices = list(devices)
        self.ops: Dict[int, List[Tuple[str, float, float]]] = defaultdict(list)
        host = []
        for e in events:
            a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if _on_device(e):
                a, b = max(a, self.t0), min(b, self.t1)
                if b > a:
                    self.ops[e.device_index].append((e.name, a, b))
            elif e.thread == sl.thread and e.name != SLICE and b > a:
                host.append((a, b, e.name))
        host.sort()
        self._host_start = [h[0] for h in host]
        self._host = host
        self.busy = {d: sum(b - a for a, b in union(
            [(a, b) for _, a, b in self.ops.get(d, [])]))
            for d in self.devices}
        if not any(self.busy.values()):
            raise RuntimeError("the profiler recorded no device operation "
                               "in the slice")
        self.busy_s = sum(self.busy.values()) / len(self.devices)

    def idle_pct(self) -> float:
        """The cards' mean share of the window with nothing running, in %."""
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernel_time(self, names: Sequence[str]) -> Tuple[int, float]:
        """(launches, device seconds) of the kernels whose names hold one
        of `names` as a whole identifier, over every card."""
        pat = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(map(re.escape, names))
                         + r")(?![A-Za-z0-9_])")
        n, t = 0, 0.0
        for ops in self.ops.values():
            for name, a, b in ops:
                if pat.search(name):
                    n += 1
                    t += b - a
        return n, t

    def _host_at(self, t: float) -> str:
        """The innermost host operation running at t (latest started)."""
        i = bisect.bisect_right(self._host_start, t) - 1
        for j in range(i, max(i - 4096, -1), -1):
            a, b, name = self._host[j]
            if b > t:
                return name
        return SLICE

    def breakdown(self) -> dict:
        """{"device_ops": [[name, s]], "idle_gaps": [[host op, s]]}: the ten
        device operations with the most time, and idle time by what the
        host was doing when it began, each per card (mean over cards)."""
        nd = len(self.devices)
        by_op: Dict[str, float] = defaultdict(float)
        by_host: Dict[str, float] = defaultdict(float)
        for d in self.devices:
            ops = self.ops.get(d, [])
            for name, a, b in ops:
                by_op[name[:NAME_CHARS]] += (b - a) / nd
            at = self.t0
            for a, b in union([(a, b) for _, a, b in ops]) + [(self.t1, self.t1)]:
                gap = a - at
                if gap > 0:
                    label = (self._host_at(at) if gap >= SHORT_GAP_S
                             else f"gaps under {SHORT_GAP_S * 1e6:g} us")
                    by_host[label[:NAME_CHARS]] += gap / nd
                at = max(at, b)

        def top(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                    [:10]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


def profile(fn, devices) -> Trace:
    """Run fn() under torch.profiler between synchronizes of every card
    and return its Trace. Nothing is written to disk."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    def sync():
        for d in devices:
            torch.cuda.synchronize(d)
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(SLICE):
            sync()
            fn()
            sync()
    return Trace(prof.events(), [d.index for d in devices])
