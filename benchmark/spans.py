"""The program's own spans in a traced run, for the metrics whose source
is `program_span`.

A --trace 1 run whose cell reads such a metric calls take(driver) before
its profiled slice (run.slices): it runs the driver's slice() once with
the program's recorder (svision_tpu_torch/trace.py) on and the profiler
off, so that the spans carry none of the profiler's cost; the recorder
synchronizes every card at its start and at its end, and its window lies
between the two. The record is kept on ctx, where record(ctx) finds it
for every reader. An untraced run (ctx.trace None), or a program without
the recorder, gives None, and each reader then returns None.

The readers below take the program's record (trace.Record): its `spans`
(each with name, id, parent, call, device, start_ns, end_ns, attrs),
`find(name, device)`, `start_ns` and `end_ns`: times in ns of the host
span clock, device spans' included (device is None on a host span, the
card's index on a device span).
"""

from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Dict, List, Optional

from benchmark.devtrace import union


def record(ctx):
    """The program's span record that a --trace 1 run took before its
    profiled slice; None untraced or when the program records no spans."""
    return None if ctx.trace is None else getattr(ctx, "spans", None)


def take(driver):
    """The program's span record of one more slice of the driver's work,
    the recorder on and the profiler off; None when the program has no
    recorder."""
    try:
        from svision_tpu_torch import trace
    except ImportError:
        return None
    with trace.recording(driver.devices) as rec:
        driver.slice()
    return rec


def _by_card(rec, name: str) -> Dict[int, list]:
    """Each card's device spans named `name`."""
    out: Dict[int, list] = defaultdict(list)
    for s in rec.find(name, device=True):
        out[s.device].append(s)
    return out


def idle_pct(rec, name: str) -> Optional[float]:
    """The cards' mean share of the window that no device span `name`
    covers, in %."""
    cards = _by_card(rec, name)
    if not cards:
        return None
    lo, hi = rec.start_ns, rec.end_ns
    idle = []
    for v in cards.values():
        clipped = [(max(s.start_ns, lo), min(s.end_ns, hi)) for s in v]
        busy = sum(b - a for a, b in union([(a, b) for a, b in clipped
                                            if b > a]))
        idle.append(1.0 - busy / (hi - lo))
    return 100.0 * statistics.fmean(idle)


def call_gap_ms(rec, name: str) -> Optional[float]:
    """Per card, the time from the end of call k's last device span `name`
    to the start of call k+1's first, in ms: the mean over calls and
    cards."""
    gaps = []
    for v in _by_card(rec, name).values():
        calls: Dict[int, List[int]] = {}
        for s in v:
            ends = calls.setdefault(s.call, [s.start_ns, s.end_ns])
            ends[0] = min(ends[0], s.start_ns)
            ends[1] = max(ends[1], s.end_ns)
        ordered = sorted(calls.values())
        gaps += [(b[0] - a[1]) / 1e6 for a, b in zip(ordered, ordered[1:])]
    return statistics.fmean(gaps) if gaps else None


def host_busy_pct(rec) -> Optional[float]:
    """The engine's calls on the host less their waits for the cards
    (engine.call less its engine.sync children), over the window, in %."""
    calls = rec.find("engine.call", device=False)
    if not calls:
        return None
    ids = {s.id for s in calls}
    # an engine.sync's parent is the engine.call it closes
    wait = sum(s.end_ns - s.start_ns
               for s in rec.find("engine.sync", device=False)
               if s.parent in ids)
    busy = sum(s.end_ns - s.start_ns for s in calls) - wait
    return 100.0 * busy / (rec.end_ns - rec.start_ns)


def host_rows_per_s(rec) -> Optional[float]:
    """The rows of the engine.host_rows spans (a dispatch's raw specs laid
    out a card and pinned; the cards make the endpoints) over those spans'
    summed time."""
    rows = rec.find("engine.host_rows", device=False)
    ns = sum(s.end_ns - s.start_ns for s in rows)
    if not ns:
        return None
    return sum(s.attrs["rows"] for s in rows) / ns * 1e9


def step_device_ms(rec, name: str = "train.step",
                   phase: str = "replay") -> Optional[float]:
    """The median time of the device spans `name` whose host span is of
    the given phase, in ms."""
    host = {s.id: s for s in rec.find(name, device=False)}
    ms = [(s.end_ns - s.start_ns) / 1e6 for s in rec.find(name, device=True)
          if s.parent in host and host[s.parent].attrs.get("phase") == phase]
    return statistics.median(ms) if ms else None
