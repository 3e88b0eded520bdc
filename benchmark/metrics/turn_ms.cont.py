"""Host milliseconds of continuous serving's turn between two decode chunks:
from a chunk's last host readback to the next chunk's launch, the refills
and their readbacks inside (the program's `cont.turn` spans,
`vlm_fo1_tpu_torch.runtime.trace`; a turn with no chunk after it is not
kept), averaged over every such turn of the window. Spans a profiler was
active in (the traced slice of `--trace 1`) are left out: the profiler's
per-op recording, start and stop sit in their times. None without the
recorder (a program that predates it)."""

import time


def read(ctx):
    try:
        from vlm_fo1_tpu_torch.runtime import trace
    except ImportError:
        return None
    t_window = time.time_ns() - int((time.perf_counter() - ctx.t_window)
                                    * 1e9)
    ms = [s.host_ms for s in trace.spans()
          if not s.profiled and s.name == "cont.turn" and s.t0 >= t_window]
    return sum(ms) / len(ms) if ms else None
