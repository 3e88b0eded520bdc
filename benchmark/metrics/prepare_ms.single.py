"""Host milliseconds in `FO1Model.prepare` per request (tokens, resizes,
patches, M-RoPE positions), from the spans around it over the window."""


def read(ctx):
    spans = [s for s in ctx.spans if s["name"] == "prepare"]
    if not spans:
        return None
    return 1e3 * sum(s["t1"] - s["t0"] for s in spans) / len(spans)
