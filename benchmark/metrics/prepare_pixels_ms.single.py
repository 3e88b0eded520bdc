"""Host milliseconds a request of `FO1Model.prepare`'s pixel work (image
load, shortest-edge resize, patchify or the raw image, the aux squash):
the program's `prepare.pixels` spans (`vlm_fo1_tpu_torch.runtime.trace`),
averaged over every request of the window. Spans a profiler was active in
(the traced slice of `--trace 1`) are left out: the profiler's per-op
recording, start and stop sit in their times. None without the recorder (a
program that predates it)."""

import time


def read(ctx):
    try:
        from vlm_fo1_tpu_torch.runtime import trace
    except ImportError:
        return None
    t_window = time.time_ns() - int((time.perf_counter() - ctx.t_window)
                                    * 1e9)
    ms = [s.host_ms for s in trace.spans()
          if not s.profiled and s.name == "prepare.pixels"
          and s.t0 >= t_window]
    return sum(ms) / len(ms) if ms else None
