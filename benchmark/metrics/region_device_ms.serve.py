"""Device milliseconds a batch of the region path in batched serving (the ViT
captures' feature maps, the HFRE over each image's boxes,
`mm_projector_aux`): the CUDA timing events the program records around its
`region` span (`vlm_fo1_tpu_torch.runtime.trace`), averaged over every
launch of the window. The time between the two events includes any time
the card waited for the host's enqueue inside the span. Spans a profiler
was active in (the traced slice of `--trace 1`) are left out: the
profiler's per-op recording, start and stop sit in their times. None
without the recorder (a program that predates it) or without CUDA events
(the CPU)."""

import time


def read(ctx):
    try:
        from vlm_fo1_tpu_torch.runtime import trace
    except ImportError:
        return None
    t_window = time.time_ns() - int((time.perf_counter() - ctx.t_window)
                                    * 1e9)
    ms = [s.device_ms for s in trace.spans()
          if not s.profiled and s.name == "region" and s.t0 >= t_window
          and s.device_ms is not None]
    return sum(ms) / len(ms) if ms else None
