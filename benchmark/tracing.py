"""Spans around the benchmark's calls into the program, and a traced slice
of the window (`--trace 1` only).

`Tracer.wrap` replaces a method of one object (the model instance) with a
timed call: a host span {name, id, t0, t1, thread, info} and, inside it, a
`torch.profiler.record_function` range named `bench.<name>#<id>`, so the
device trace can attribute each kernel to the span whose call launched it.
The profiler runs over one slice of the window: it starts at the first
span that opens `slice_at` seconds after the window's start and stops at
the first that opens `slice_s` seconds later, after a device synchronise,
so every kernel launched inside the slice is in the trace. The slice is a
range `bench.slice` on the main thread; the traced window runs from the
first device operation inside it to its end.

`summarize` reduces the profiler's events: each device event is tied to
the runtime call that launched it (CUDA correlation ids), and the call to
the innermost span open on its thread. It returns the slice's length, the
seconds in which any device operation ran, device time by kernel name and
by span, and the longest idle gaps, each labelled with the innermost span
open on the main thread at the gap's middle (else one open on another
thread, else "host").
"""

from __future__ import annotations

import bisect
import itertools
import re
import threading
import time
from collections import defaultdict

import torch

# runtime calls that put work on the device (cudaLaunchKernel,
# cuLaunchKernelEx, cudaGraphLaunch, cudaMemcpyAsync, cudaMemsetAsync, ...)
_LAUNCH = re.compile(r"^cu\w*(Launch|Memcpy|Memset)")
_SPAN = re.compile(r"^bench\.(\w+)#(\d+)$")


class Tracer:
    def __init__(self, profile: bool = False, slice_at: float = 0.0,
                 slice_s: float = 0.0):
        self.spans: list[dict] = []
        self.profile = profile
        self.slice_at, self.slice_s = slice_at, slice_s
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._armed = None
        self._prof = None
        self._range = None
        self._t_on = None
        self.stopped = False
        self.main_thread = threading.get_ident()

    # -------------------------------------------------------- spans
    def wrap(self, obj, attr: str, name: str, info=None, post=None):
        """Time every call of obj.attr. info(args, kwargs) -> dict is kept
        with the span; post(span, result) may add to it."""
        fn = getattr(obj, attr)

        def timed(*args, **kwargs):
            if threading.get_ident() == self.main_thread:
                self._toggle()
            with self._lock:
                sid = next(self._ids)
            span = {"id": sid, "name": name,
                    "thread": threading.get_ident(),
                    "info": info(args, kwargs) if info else {}}
            span["t0"] = time.perf_counter()
            with torch.profiler.record_function(f"bench.{name}#{sid}"):
                out = fn(*args, **kwargs)
            span["t1"] = time.perf_counter()
            if post is not None:
                post(span, out)
            with self._lock:
                self.spans.append(span)
            return out

        setattr(obj, attr, timed)

    # ------------------------------------------------------ profiler
    def warm(self) -> None:
        """Start and stop the profiler once during set-up, so its first
        start costs nothing inside the window."""
        if self.profile:
            with _profiler():
                torch.zeros(1, device="cuda").add_(1)
                torch.cuda.synchronize()

    def arm(self, window_start: float) -> None:
        if self.profile:
            self._armed = window_start + self.slice_at

    def _toggle(self) -> None:
        if self._armed is None or self.stopped:
            return
        now = time.perf_counter()
        if self._prof is None and now >= self._armed:
            self._prof = _profiler()
            self._prof.start()
            self._range = torch.profiler.record_function("bench.slice#0")
            self._range.__enter__()
            self._t_on = now
        elif self._prof is not None and now >= self._t_on + self.slice_s:
            self.stop()

    def stop(self) -> None:
        if self._prof is None or self.stopped:
            return
        torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._prof.stop()
        self.stopped = True

    def summarize(self, top: int = 10) -> dict | None:
        if self._prof is None:
            return None
        self.stop()
        return summarize(self._prof.profiler.kineto_results.events(), top)


def _profiler():
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=act)


def _is_device(ev) -> bool:
    return ev.device_type() == torch.autograd.DeviceType.CUDA


def summarize(events, top: int = 10) -> dict:
    """See the module docstring. Times are in seconds."""
    spans = defaultdict(list)          # host thread -> [(t0, t1, name, id)]
    slice_range = None
    launches = {}                      # correlation id -> (t0, thread)
    device = []
    for ev in events:
        if _is_device(ev):
            if ev.is_user_annotation() or ev.name().startswith("bench."):
                continue   # a range's device-side shadow, not an operation
            device.append((ev.start_ns(), ev.duration_ns(), ev.name(),
                           ev.correlation_id(), ev.linked_correlation_id()))
            continue
        name = ev.name()
        m = _SPAN.match(name)
        if m:
            t0 = ev.start_ns()
            rec = (t0, t0 + ev.duration_ns(), m.group(1), int(m.group(2)))
            if m.group(1) == "slice":
                slice_range = rec
                main = ev.start_thread_id()
            else:
                spans[ev.start_thread_id()].append(rec)
        elif _LAUNCH.match(name) and ev.correlation_id():
            launches[ev.correlation_id()] = (ev.start_ns(),
                                             ev.start_thread_id())
    if slice_range is None:
        return {"error": "no bench.slice range in the trace"}
    w0, w1 = slice_range[:2]
    # work queued before the profiler started runs unseen at the slice's
    # head, so the traced window opens at the first operation it holds
    w0 = max(w0, min((d[0] for d in device if w0 <= d[0] < w1),
                     default=w0))
    for lst in spans.values():
        lst.sort()
    starts = {t: [s[0] for s in lst] for t, lst in spans.items()}

    def innermost(thread, t):
        """The span open on `thread` at t that started last (spans of one
        thread nest, so it is among the few that started just before)."""
        lst = spans.get(thread)
        if not lst:
            return None
        i = bisect.bisect_right(starts[thread], t) - 1
        for s in lst[max(0, i - 15):i + 1][::-1]:
            if s[0] <= t <= s[1]:
                return s
        return None

    by_name = defaultdict(int)
    by_span = defaultdict(lambda: defaultdict(int))
    intervals = []
    owner = {}                         # correlation id -> span id
    linked = 0
    for start, dur, name, corr, link in device:
        end = start + dur
        if end <= w0 or start >= w1:
            continue
        intervals.append((max(start, w0), min(end, w1)))
        by_name[name] += dur
        key = corr if corr in launches else link
        if key not in launches:
            continue
        linked += 1
        if key not in owner:
            t, thread = launches[key]
            span = innermost(thread, t)
            owner[key] = None if span is None else span[3]
        if owner[key] is not None:
            by_span[owner[key]][name] += dur
    intervals.sort()
    busy, gaps = 0, []
    cur0, cur1 = None, None
    prev_end = w0
    for a, b in intervals:
        if cur1 is None or a > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
                prev_end = cur1
            if a > prev_end:
                gaps.append((a - prev_end, (a + prev_end) // 2))
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        busy += cur1 - cur0
        prev_end = cur1
    if w1 > prev_end:
        gaps.append((w1 - prev_end, (w1 + prev_end) // 2))

    def label(t):
        s = innermost(main, t)
        if s is not None:
            return s[2]
        for thread in spans:
            if thread != main and innermost(thread, t) is not None:
                return innermost(thread, t)[2]
        return "host"

    gaps.sort(reverse=True)
    inside = {s[3] for lst in spans.values() for s in lst
              if s[0] >= w0 and s[1] <= w1}
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy * 1e-9,
        "device_events": len(intervals),
        "linked_events": linked,
        "by_name": {k: v * 1e-9 for k, v in by_name.items()},
        "by_span": {sid: {k: v * 1e-9 for k, v in d.items()}
                    for sid, d in by_span.items()},
        "spans_inside": inside,
        "idle_gaps": [[label(t), d * 1e-9] for d, t in gaps[:top]],
        "device_ops": [[k[:160], v * 1e-9] for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
    }
