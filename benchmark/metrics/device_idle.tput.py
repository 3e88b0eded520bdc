"""Share of the traced slice in which no operation ran on the device
(1 - busy_s / window_s of the profiler's trace)."""


def read(ctx):
    t = ctx.trace
    if not t or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
