"""The entries of the program that a window drives. A traffic mix's
`driver` key names a file of this folder, `benchmark/drivers/<driver>.py`,
found by name as the metrics are. A driver file defines

  Driver(model, mix)   with warmup(requests), spans(tracer, cfg) and
                       window(requests, seconds) -> (records, stats)

and may define

  build(cfg, seed, device)       the system under test (default:
                                 `benchmark.program.build`, an FO1Model)
  requests(mix, seed, stream=0)  the request stream (default:
                                 `benchmark.generator.Requests`)

Each driver warms up exactly the shapes its traffic will use, then runs
the window and returns one record per request handed to the program:
{"req", "t_sent", "t_done", "result"}, with "result" the program's
`GenerationResult` (None if the request never came back).

What the drivers share lives here: the prompt buckets a mix reaches, and
the fixed backlog a throughput window serves.
"""

from __future__ import annotations

import importlib.util
import os
import re

from benchmark.generator import messages

BUCKET = 128


def load(name: str, root: str):
    """The module `benchmark/drivers/<name>.py` of the checkout at root."""
    path = os.path.join(root, "benchmark", "drivers", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_driver_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def prompt_buckets(model, mix: dict, warm) -> dict[int, int]:
    """{prompt bucket: a box count whose prompt lands in it}, over the
    mix's box counts (host work only). Prompt lengths are bucketed to
    multiples of 128 tokens and each bucket is a decode program of its own
    (captured CUDA graphs)."""
    lo, hi = mix["boxes"]
    out = {}
    for n in range(lo, hi + 1):
        prep = model.prepare(messages(warm.request(0, n)))
        bucket = -(-prep["splice"].seq_len // BUCKET) * BUCKET
        out.setdefault(bucket, n)
    return out


def work(seconds: float, offered_per_s: float, unit: int) -> int:
    """The requests a throughput window serves: the mix's offered rate
    times the window, in whole batches or groups (at least one). The
    pipelines pull work ahead as fast as the host prepares it, so the
    window is this fixed backlog, served to its end."""
    return unit * max(1, round(seconds * offered_per_s / unit))
