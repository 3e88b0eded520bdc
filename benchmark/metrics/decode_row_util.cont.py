"""Share of decode-slot steps that produced a token in continuous serving:
tokens emitted by decode steps (each finished request's tokens after the
first, which the prefill gives) over `device_steps` x batch, from
`ContinuousServingPipeline.stats`, over every group of the window."""


def read(ctx):
    steps = ctx.stats.get("device_steps")
    if not steps:
        return None
    emitted = sum(max(0, len(r["result"].token_ids) - 1)
                  for r in ctx.records if r["result"] is not None)
    return 100.0 * emitted / (steps * ctx.stats["batch_size"])
