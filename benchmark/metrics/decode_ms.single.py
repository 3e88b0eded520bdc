"""Host milliseconds in the decode (`FO1Model.finish_batch`: the graph
replays after the first and the tokens' copy back) per request, from the
spans around it over the window."""


def read(ctx):
    spans = [s for s in ctx.spans if s["name"] == "finish"]
    if not spans:
        return None
    return 1e3 * sum(s["t1"] - s["t0"] for s in spans) / len(spans)
