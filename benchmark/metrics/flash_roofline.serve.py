"""Share of its roofline the flash attention kernel reaches in batched
serving: the least time the card needs for the attention of the launches
inside the traced slice (the ViT's full blocks over the real patches, the
prefill's causal pairs of each prompt's own length; bf16 peak, each q, k,
v, o byte once) over the device time of the flash kernels those launches
ran."""

from benchmark.yardstick import flops, peaks


def read(ctx):
    t = ctx.trace
    if not t or "by_span" not in t:
        return None
    least = kernel = 0.0
    for s in ctx.spans:
        if s["name"] != "launch" or s["id"] not in t["spans_inside"]:
            continue
        gh, gw = s["info"]["grid"][1:]
        lengths = s["info"]["lengths"]
        for f, b in (flops.flash_vit(ctx.config, gh, gw, len(lengths)),
                     flops.flash_prefill(ctx.config, lengths)):
            least += peaks.least_seconds(f, b)
        kernel += sum(v for k, v in t["by_span"].get(s["id"], {}).items()
                      if "flash_" in k)
    return 100.0 * least / kernel if kernel > 0 else None
