"""Host milliseconds a launched batch in which batched serving's loop waited
on a prepare that was not done yet: the program's `serve.wait` spans
(`vlm_fo1_tpu_torch.runtime.trace`) over the window, over the window's
`launch` spans. Spans a profiler was active in (the traced slice of
`--trace 1`) are left out: the profiler's per-op recording, start and stop
sit in their times. None without the recorder (a program that predates
it)."""

import time


def read(ctx):
    try:
        from vlm_fo1_tpu_torch.runtime import trace
    except ImportError:
        return None
    t_window = time.time_ns() - int((time.perf_counter() - ctx.t_window)
                                    * 1e9)
    spans = [s for s in trace.spans()
             if s.t0 >= t_window and not s.profiled]
    launches = sum(s.name == "launch" for s in spans)
    if not launches:
        return None
    return sum(s.host_ms for s in spans if s.name == "serve.wait") / launches
