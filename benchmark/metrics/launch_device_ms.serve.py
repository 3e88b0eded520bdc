"""Device milliseconds of the kernels launched inside one
`FO1Model.launch_batch` (encode, splice, prefill, first decode graph), per
batch, over the launches that opened and closed inside the traced slice."""


def read(ctx):
    t = ctx.trace
    if not t or "by_span" not in t:
        return None
    ids = [s["id"] for s in ctx.spans
           if s["name"] == "launch" and s["id"] in t["spans_inside"]]
    if not ids:
        return None
    total = sum(sum(t["by_span"].get(i, {}).values()) for i in ids)
    return 1e3 * total / len(ids) if total > 0 else None
