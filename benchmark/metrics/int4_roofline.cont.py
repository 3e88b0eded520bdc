"""Share of its roofline the int4 matmul kernels reach in continuous
serving: the least time of every int4 product launched inside the traced
slice's session starts, refills and decode chunks (each packed weight byte
read once a call, x read and y written once; bf16 peak) over the device
time of the int4 kernels they ran. A chunk runs one product per trunk
projection and step at M = its rows; a start or refill prefills
rows x prompt bucket tokens."""

from benchmark.yardstick import flops, peaks


def _least(cfg, m):
    return sum(peaks.least_seconds(*flops.int4_call(m, k, n))
               for k, n in flops.trunk_linear_shapes(cfg))


def read(ctx):
    t = ctx.trace
    if not t or "by_span" not in t:
        return None
    least = kernel = 0.0
    for s in ctx.spans:
        if s["id"] not in t["spans_inside"]:
            continue
        info = s["info"]
        if s["name"] == "chunk":
            least += int(info["steps"]) * _least(ctx.config, info["rows"])
        elif s["name"] in ("start", "refill"):
            least += _least(ctx.config, info["rows"] * info["pad"])
        else:
            continue
        kernel += sum(v for k, v in t["by_span"].get(s["id"], {}).items()
                      if "int4k::" in k)
    return 100.0 * least / kernel if kernel > 0 else None
