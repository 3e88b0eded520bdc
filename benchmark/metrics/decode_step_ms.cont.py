"""Device milliseconds per decode step of continuous serving: the kernels
launched inside `decode_session_chunk` (one chunk graph each) over the
steps those chunks ran, for the chunks inside the traced slice."""


def read(ctx):
    t = ctx.trace
    if not t or "by_span" not in t:
        return None
    spans = [s for s in ctx.spans
             if s["name"] == "chunk" and s["id"] in t["spans_inside"]]
    steps = sum(int(s["info"]["steps"]) for s in spans)
    total = sum(sum(t["by_span"].get(s["id"], {}).values()) for s in spans)
    if not steps or total <= 0:
        return None
    return 1e3 * total / steps
