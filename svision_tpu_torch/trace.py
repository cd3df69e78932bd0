"""The program's own record of where a call's or a step's time goes: spans
on the host and on the cards, and counters, at the engine's and the
training step's boundaries.

    with trace.span("engine.call") as sp:     # a host span
        ...
        if sp:                                # only while something records
            sp.set(rows=n)
    with trace.device_span("engine.dispatch", device):
        ...                                   # the card's work it brackets
    trace.count("graphs.captures")

    with trace.recording(devices) as rec:     # turn recording on for a block
        engine.predict_specs(specs)
    rec.spans, rec.counts, rec.dropped

A host span has a name, a start and an end (time.perf_counter_ns), the
thread that ran it, the span it opened inside (its parent) and a call id:
the id of its outermost span, shared by every span of one
`predict_specs` call or one training step. Self time is a span's time less
what its children cover (Record.self_ns).

A device span brackets the work a block enqueues on a card's stream with
a pair of CUDA events, resolved when recording stops. The stream is the
card's current one as recording starts, and the events come from a pool
made then (POOL a card, each recorded once so that it exists), so a span
only records two events; past the pool a span makes its own. Anchor
events, recorded on each card right after a synchronize at the start and
at the end of recording while the card is idle, place the events on the
host span clock: device times map linearly between the two anchors, so
drift between the card's clock and the host's does not move the spans.

Recording is off unless a `recording()` block is open. Off, `span`,
`device_span` and `count` read one module global, `span` also asks torch
whether its profiler is on, and each returns the one shared null context.
While torch.profiler records, `span` also opens a record_function of the
same name, recorder on or off, so the program's stages appear in the
profiler's host track (and an idle gap is labelled by them).

The record is held in memory and bounded: past CAP spans it keeps no
more and counts how many it dropped. Record.chrome_trace() gives it in
Chrome's trace-event format (the CLI's --profile writes it as
spans.json).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Sequence

import torch

__all__ = ["CAP", "POOL", "Record", "Span", "count", "device_span",
           "recording", "span"]

# spans a record keeps; a genome pass on four cards makes about 6,000
CAP = 1 << 20
# CUDA events made a card as recording starts: two a device span; a genome
# pass makes about 450 device spans a card, 128 training steps 128
POOL = 2048

_REC: Optional["Record"] = None
_profiling = torch.autograd._profiler_enabled


class _Null:
    """What span(), device_span() are while nothing records: a context that
    does nothing, false, and that takes attributes and drops them."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL = _Null()


class Span:
    """One recorded span. device is None for a host span, else the card's
    index; a device span's times are on the host span clock."""

    __slots__ = ("name", "id", "parent", "call", "thread", "start_ns",
                 "end_ns", "attrs", "device")

    def __init__(self, name, id, parent, call, thread, start_ns, end_ns,
                 attrs, device=None):
        self.name, self.id, self.parent, self.call = name, id, parent, call
        self.thread, self.start_ns, self.end_ns = thread, start_ns, end_ns
        self.attrs, self.device = attrs, device

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns

    def __repr__(self):
        where = "host" if self.device is None else f"cuda:{self.device}"
        return (f"Span({self.name!r}, {where}, {self.ns} ns, id={self.id}, "
                f"parent={self.parent}, call={self.call}, {self.attrs})")


class _Live:
    """A host span while it is open: recorded into `rec` (None: only the
    profiler's record_function), with `rf` the record_function or None."""

    __slots__ = ("rec", "name", "attrs", "rf", "id", "parent", "call",
                 "start_ns")

    def __init__(self, rec, name, attrs, rf):
        self.rec, self.name, self.attrs, self.rf = rec, name, attrs, rf

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        rec = self.rec
        if rec is not None:
            stack = rec._stack()
            self.id = next(rec._ids)
            top = stack[-1] if stack else None
            self.parent = top.id if top is not None else None
            self.call = top.call if top is not None else self.id
            stack.append(self)
            self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            end = time.perf_counter_ns()
            rec._stack().pop()
            rec._add(Span(self.name, self.id, self.parent, self.call,
                          rec._local.thread, self.start_ns, end,
                          self.attrs))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False

    def __bool__(self):
        return self.rec is not None

    def set(self, **attrs) -> None:
        """Add attributes to the span (kept only while recording)."""
        if self.rec is not None:
            self.attrs.update(attrs)


class _LiveDevice:
    """A device span while it is open: an event pair on card `card`'s
    stream."""

    __slots__ = ("rec", "name", "card", "ev", "parent", "call")

    def __init__(self, rec, name, card):
        self.rec, self.name, self.card = rec, name, card

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        top = stack[-1] if stack else None
        self.parent = top.id if top is not None else None
        self.call = top.call if top is not None else None
        self.ev = (rec._event(self.card), rec._event(self.card))
        self.ev[0].record(rec._streams[self.card])
        return self

    def __exit__(self, *exc):
        self.ev[1].record(self.rec._streams[self.card])
        self.rec._pending.append(self)
        return False


def _card(device) -> Optional[int]:
    """The CUDA card's index, or None for another device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return torch.cuda.current_device() if dev.index is None else dev.index


def span(name: str, **attrs):
    """A host span named `name` around a with-block; the one null context
    while neither the recorder nor torch.profiler is on."""
    rec = _REC
    profiling = _profiling()
    if rec is None and not profiling:
        return _NULL
    return _Live(rec, name, attrs,
                 torch.profiler.record_function(name) if profiling else None)


def device_span(name: str, device):
    """A span on `device` around the work the with-block enqueues on its
    stream (the one current as recording started): recorded while the
    recorder is on, on a CUDA card it anchored; else the null context."""
    rec = _REC
    if rec is None:
        return _NULL
    try:
        idx = rec._cards[device]
    except KeyError:
        idx = rec._cards[device] = _card(device)
    if idx is None:
        return _NULL
    if idx not in rec._streams or rec._full():
        with rec._lock:
            rec.dropped += 1
        return _NULL
    return _LiveDevice(rec, name, idx)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while the recorder is on."""
    rec = _REC
    if rec is not None:
        with rec._lock:
            rec.counts[name] += n


class Record:
    """What one recording() block recorded: spans (host and device, the
    host ones in the order they ended, the device ones after them),
    counts, how many spans were dropped past CAP, and the block's
    start and end on the host span clock (after the opening synchronize of
    every anchored card, and after the closing one)."""

    def __init__(self, devices: Sequence = ()):
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = defaultdict(int)
        self.dropped = 0
        self.start_ns = self.end_ns = 0
        self._devices = sorted({_card(d) for d in devices} - {None})
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._pending: List[_LiveDevice] = []
        self._anchor0: Dict[int, tuple] = {}
        # each anchored card's stream and unused events; each device as
        # device_span was given it -> its card's index, None for no card
        self._streams: Dict[int, torch.cuda.Stream] = {}
        self._pool: Dict[int, List[torch.cuda.Event]] = {}
        self._cards: Dict[object, Optional[int]] = {}
        self._closed = False
        # wall clock at start, for the Chrome trace's timestamps
        self._wall0_ns = 0

    def _stack(self) -> list:
        """This thread's open host spans; its id is then _local.thread
        (asked once a thread: a system call)."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
            self._local.thread = threading.get_native_id()
        return stack

    def _full(self) -> bool:
        return len(self.spans) + len(self._pending) >= CAP

    def _event(self, card: int) -> torch.cuda.Event:
        """An unused event of the card's pool, or a new one."""
        try:
            return self._pool[card].pop()
        except IndexError:
            return torch.cuda.Event(enable_timing=True)

    def _add(self, s: Span) -> None:
        with self._lock:
            if self._closed or self._full():
                self.dropped += 1
            else:
                self.spans.append(s)

    def _anchor(self) -> Dict[int, tuple]:
        """(event, host ns) on each card, right after a synchronize."""
        out = {}
        for i in self._devices:
            torch.cuda.synchronize(i)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self._streams[i])
            out[i] = (ev, time.perf_counter_ns())
        return out

    def _start(self) -> None:
        for i in self._devices:
            stream = self._streams[i] = torch.cuda.current_stream(i)
            pool = self._pool[i] = [torch.cuda.Event(enable_timing=True)
                                    for _ in range(POOL)]
            for ev in pool:
                ev.record(stream)
        self._anchor0 = self._anchor()
        self._wall0_ns = time.time_ns()
        self.start_ns = time.perf_counter_ns()

    def _stop(self) -> None:
        anchor1 = self._anchor()
        self.end_ns = time.perf_counter_ns()
        with self._lock:
            self._closed = True
        for i in self._devices:
            torch.cuda.synchronize(i)
        for live in self._pending:
            i = live.card
            (a0, h0), (a1, h1) = self._anchor0[i], anchor1[i]
            # ns of the host clock per ns of the card's, between anchors
            d = a0.elapsed_time(a1) * 1e6
            scale = (h1 - h0) / d if d > 0 else 1.0
            t0, t1 = (h0 + round(a0.elapsed_time(e) * 1e6 * scale)
                      for e in live.ev)
            self.spans.append(Span(live.name, None, live.parent, live.call,
                                   None, t0, t1, {}, i))
        self._pending = []
        self._pool = {}

    # -- reading ---------------------------------------------------------

    def find(self, name: str, device: Optional[bool] = None) -> List[Span]:
        """The spans named `name`; device=True only device spans, False
        only host spans."""
        return [s for s in self.spans if s.name == name
                and (device is None or (s.device is not None) == device)]

    def children(self, parent: Span) -> List[Span]:
        """The host spans opened directly inside `parent`."""
        return [s for s in self.spans
                if s.device is None and s.parent == parent.id]

    def self_ns(self, s: Span) -> int:
        """The span's time less the part of it its host children cover."""
        covered, at = 0, s.start_ns
        for c in sorted(self.children(s), key=lambda c: c.start_ns):
            a, b = max(c.start_ns, at), min(c.end_ns, s.end_ns)
            if b > a:
                covered += b - a
                at = b
        return s.ns - covered

    def chrome_trace(self) -> dict:
        """The record in Chrome's trace-event format: host spans on this
        process's threads, device spans on one track a card, counts as
        counter events at the end; timestamps in microseconds of the wall
        clock."""
        pid = os.getpid()

        def us(ns):
            return (self._wall0_ns + ns - self.start_ns) / 1e3
        events = []
        for i in self._devices:
            events.append({"name": "process_name", "ph": "M",
                           "pid": f"cuda:{i}", "tid": 0,
                           "args": {"name": f"cuda:{i} (device spans)"}})
        for s in self.spans:
            args = dict(s.attrs, id=s.id, parent=s.parent, call=s.call)
            events.append({
                "name": s.name, "ph": "X", "ts": us(s.start_ns),
                "dur": s.ns / 1e3, "args": args,
                "pid": pid if s.device is None else f"cuda:{s.device}",
                "tid": s.thread if s.device is None else 0})
        for name, n in sorted(self.counts.items()):
            events.append({"name": name, "ph": "C", "ts": us(self.end_ns),
                           "pid": pid, "args": {name: n}})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped": self.dropped}}

    def write_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


@contextlib.contextmanager
def recording(devices: Sequence = ()) -> Iterator[Record]:
    """Record every span and count of the block (all threads) into a new
    Record, which the block gets; device spans on the CUDA cards in
    `devices`, each synchronized at the start and at the end. One block
    at a time."""
    global _REC
    if _REC is not None:
        raise RuntimeError("trace.recording() is already on")
    rec = Record(devices)
    rec._start()
    _REC = rec
    try:
        yield rec
    finally:
        _REC = None
        rec._stop()
