"""Median latency of the window's requests, from the call into the program
to its return (host clock), over every request of the window."""

import statistics


def read(ctx):
    lat = [(r["t_done"] - r["t_sent"]) * 1e3 for r in ctx.records
           if r["result"] is not None]
    return statistics.median(lat) if lat else None
