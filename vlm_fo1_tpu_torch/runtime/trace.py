"""Spans and counters recorded inside the port, on by default.

A span is one piece of work at a layer boundary: its name, id, the id of
the span open around it on the same thread (`parent`), the request ids it
serves (`reqs`, inherited from the parent when not given), its thread, its
start and end (`t0`, `t1`, ns) and free `info`. Every request gets an id in
`FO1Model.prepare`, and each later span that serves it carries that id, on
whichever thread it runs.

    with trace.span("vit", device=True):
        ...
    trace.count("captures")
    trace.spans()       # the recorded spans, oldest first
    trace.counters()    # {name: count}
    trace.set_enabled(False)

Stamps are `time.time_ns()`, the clock of `torch.profiler`'s events on
Linux (CLOCK_REALTIME). While a profiler is active each span also opens a
`record_function("fo1.<name>#<id>")` range, so the spans sit on the device
trace's timeline; a span that a profiler was active at its open or its
close is marked `profiled`, since the profiler's per-op recording, start or
stop then sit in its times. `device=True` records a pair of CUDA timing
events on the current stream around the span; their elapsed time
(`device_ms`) is read only by `spans()`, and only once the end event has
completed: nothing here synchronises or waits. Device time between two
events includes any time the device waited for the host inside the span.

Spans go to a bounded ring (`RING` entries; the oldest drop out). Nothing
is recorded while a CUDA graph is being captured: inside `capture()` (which
`graphs.CapturedSteps` opens around its capture) no span opens on any
thread, and a `device=True` span also checks its own stream
(`torch.cuda.is_current_stream_capturing`). Host-only spans do not query
the stream: a prepare worker's current stream is the legacy default
stream, which a CUDA query from another thread must not touch during a
capture. A disabled recorder, or a span under capture, still stamps `t0` /
`t1` on the span object it returns (`device.stage_timer` reads them) but
keeps nothing.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque

import torch
import torch.autograd.profiler as _autograd_profiler

RING = 100_000


def _capturing() -> bool:
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


class Span:
    """One span; a context manager that opens it and closes it."""

    __slots__ = ("name", "id", "parent", "reqs", "thread", "t0", "t1",
                 "info", "device_ms", "profiled", "_recorder", "_device",
                 "_events", "_range", "_kept")

    def __init__(self, recorder, name, reqs, device, info):
        self.name, self.reqs, self.info = name, reqs, info
        self._recorder, self._device = recorder, device
        self.id = self.parent = self.t1 = self.device_ms = None
        self._events = self._range = None
        self._kept = self.profiled = False

    def __enter__(self):
        self._recorder._open(self)
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self, keep: bool = True) -> None:
        """End the span; keep=False drops it (a span whose end never came)."""
        self._recorder._close(self, keep)

    @property
    def host_ms(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _resolve(self) -> None:
        if self._events is not None and self._events[1].query():
            self.device_ms = self._events[0].elapsed_time(self._events[1])
            self._events = None

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"reqs={self.reqs}, host_ms={self.host_ms:.3f}, "
                f"device_ms={self.device_ms})")


class Recorder:
    def __init__(self, capacity: int = RING):
        self.enabled = True
        self._ring: deque = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._request_ids = itertools.count(1)
        self._local = threading.local()
        self._counters: dict[str, int] = {}
        self._lock = threading.Lock()
        self._captures = 0

    def span(self, name: str, reqs=None, device: bool = False,
             **info) -> Span:
        """A span to open with `with`. reqs: the request ids it serves
        (default: its parent's); device: also time it with CUDA events."""
        return Span(self, name, reqs, device, info)

    def open_span(self, name: str, reqs=None, device: bool = False,
                  **info) -> Span:
        """A span opened now and ended by its `close()`; spans of one
        thread must still nest."""
        s = Span(self, name, reqs, device, info)
        self._open(s)
        return s

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextlib.contextmanager
    def capture(self):
        """Around a CUDA graph capture: no span opens, on any thread."""
        with self._lock:
            self._captures += 1
        try:
            yield
        finally:
            with self._lock:
                self._captures -= 1

    def _open(self, s: Span) -> None:
        if (self.enabled and not self._captures
                and not (s._device and _capturing())):
            s._kept = True
            s.id = next(self._ids)
            stack = self._stack()
            if stack:
                s.parent = stack[-1].id
                if s.reqs is None:
                    s.reqs = stack[-1].reqs
            stack.append(s)
            s.thread = threading.get_ident()
            if s._device and torch.cuda.is_initialized():
                start = torch.cuda.Event(enable_timing=True)
                start.record()
                s._events = (start, torch.cuda.Event(enable_timing=True))
            if _autograd_profiler._is_profiler_enabled:
                s.profiled = True
                s._range = torch.profiler.record_function(
                    f"fo1.{s.name}#{s.id}")
                s._range.__enter__()
        s.t0 = time.time_ns()

    def _close(self, s: Span, keep: bool) -> None:
        if s.t1 is not None:
            return
        s.t1 = time.time_ns()
        if not s._kept:
            return
        s._kept = False
        if _autograd_profiler._is_profiler_enabled:
            s.profiled = True
        stack = self._stack()
        if stack and stack[-1] is s:
            stack.pop()
        elif s in stack:
            stack.remove(s)
        if s._range is not None:
            s._range.__exit__(None, None, None)
            s._range = None
        if not keep:
            s._events = None
            return
        if s._events is not None:
            s._events[1].record()
        if s.reqs is None:
            s.reqs = ()
        self._ring.append(s)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def spans(self) -> list[Span]:
        """The kept spans, oldest first, each with its `device_ms` where
        its events have completed."""
        out = list(self._ring)
        for s in out:
            s._resolve()
        return out

    def request_id(self) -> int:
        return next(self._request_ids)


RECORDER = Recorder()
span = RECORDER.span
capture = RECORDER.capture
open_span = RECORDER.open_span
count = RECORDER.count
counters = RECORDER.counters
spans = RECORDER.spans
request_id = RECORDER.request_id


def set_enabled(flag: bool) -> None:
    """Turn the recording of spans on or off (counters always count)."""
    RECORDER.enabled = bool(flag)


def request_ids(preps) -> tuple:
    """The request ids of prepared inputs, in order, each once."""
    return tuple(dict.fromkeys(p["request_id"] for p in preps
                               if "request_id" in p))
