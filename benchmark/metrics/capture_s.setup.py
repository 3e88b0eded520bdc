"""Seconds of set-up spent capturing decode programs as CUDA graphs: the
program's `graph.capture` spans (`vlm_fo1_tpu_torch.runtime.trace`: each
capture's eager warm-up, synchronise, collection and capture) that ran
between the run's start and the window's. 0 where nothing was captured
(the CPU); None without the recorder (a program that predates it)."""

import time


def read(ctx):
    try:
        from vlm_fo1_tpu_torch.runtime import trace
    except ImportError:
        return None
    t_window = time.time_ns() - int((time.perf_counter() - ctx.t_window)
                                    * 1e9)
    t_start = t_window - int(ctx.setup_s * 1e9)
    return sum(s.t1 - s.t0 for s in trace.spans()
               if s.name == "graph.capture" and s.t0 >= t_start
               and s.t1 <= t_window) * 1e-9
