"""The whole request's share of the card's peak: model FLOPs of every
request the window finished (encode, causal prefill, decode;
`yardstick/flops.py`) over the window's time, against 989 TFLOP/s (bf16,
H100 SXM at 700 W; the run notes the card's power limit)."""

from benchmark.yardstick import flops, peaks


def read(ctx):
    total = flops.finished_flops(ctx.config, ctx.records)
    if not total or ctx.window_s <= 0:
        return None
    return 100.0 * total / (ctx.window_s * peaks.BF16_FLOPS)
