"""90th percentile of the same latencies as `latency_p50_ms`, over every
request of the window (`statistics.quantiles`, exclusive method)."""

import statistics


def read(ctx):
    lat = [(r["t_done"] - r["t_sent"]) * 1e3 for r in ctx.records
           if r["result"] is not None]
    if len(lat) < 10:
        return None
    return statistics.quantiles(lat, n=10)[-1]
