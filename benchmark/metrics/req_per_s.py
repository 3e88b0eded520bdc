"""Requests completed per second: every request the window finished, over
all the time from the window's start to the last completion (host clock),
the drain of the last batch or group included."""


def read(ctx):
    done = sum(r["result"] is not None for r in ctx.records)
    return done / ctx.window_s if done and ctx.window_s > 0 else None
