"""Host milliseconds a request spent enqueuing the encode inside a launch:
the program's `upload`, `vit`, `davit` and `region` spans
(`vlm_fo1_tpu_torch.runtime.trace`) whose parent is a `launch` span, over
the requests those launches served, for every launch of the window. Spans
a profiler was active in (the traced slice of `--trace 1`) are left out:
the profiler's per-op recording, start and stop sit in their times. None
without the recorder (a program that predates it)."""

import time

ENCODE = ("upload", "vit", "davit", "region")


def read(ctx):
    try:
        from vlm_fo1_tpu_torch.runtime import trace
    except ImportError:
        return None
    t_window = time.time_ns() - int((time.perf_counter() - ctx.t_window)
                                    * 1e9)
    spans = [s for s in trace.spans()
             if s.t0 >= t_window and not s.profiled]
    launches = {s.id: s for s in spans if s.name == "launch"}
    served = sum(len(s.reqs) for s in launches.values())
    if not served:
        return None
    return sum(s.host_ms for s in spans
               if s.name in ENCODE and s.parent in launches) / served
