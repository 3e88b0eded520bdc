"""One run of one cell, driven by data.

`BENCHMARK.json` names the cell's configuration and traffic mix; each is a
file of its own, found by name:

  benchmark/configs/<config>.json   the configuration as it is run
  benchmark/traffic/<mix>.json      the mix the general generator reads
  benchmark/drivers/<driver>.py     the entry of the program a mix drives
                                    (the mix's `driver` key)
  benchmark/reference/<ref>.py      the plain reference and its weight
                                    layout (the configuration's
                                    `reference` key)
  benchmark/limits/<cell>.json      the limits of the numbers compared
  benchmark/metrics/<metric>.py     a reader per metric: read(ctx) returns
                                    the value, or None where the run gave
                                    it nothing to read

A run draws the weights from the seed, builds the program, warms up the
cell's own shapes (set-up), measures for `seconds`, reads the metrics
(the end-to-end ones with `trace` 0, the per-layer ones with `trace` 1),
frees the program, and compares a sample of what the window served with
the plain reference (`benchmark/check.py`, which alone decides
`correct`).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace

import torch

from benchmark import check, drivers, generator, program
from benchmark.tracing import Tracer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "vlm_fo1_tpu")


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_bench(root: str = ROOT) -> dict:
    return _json(root, "BENCHMARK.json")


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(name: str, root: str = ROOT) -> dict:
    return _json(root, "benchmark", "configs", f"{name}.json")


def load_limits(cell: str, root: str = ROOT) -> dict:
    path = os.path.join(root, "benchmark", "limits", f"{cell}.json")
    if not os.path.exists(path):
        return {}
    return _json(path)


def cell_metrics(bench: dict, cell: dict, kind: str) -> list[dict]:
    """The metrics of `kind` ("end_to_end" / "per_layer") this cell
    reports: those whose `workloads` list it, or, without the key, every
    cell (per-layer: every cell that reports the metric it moves)."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell["name"] in m["workloads"]}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell["name"] in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def reader(name: str, root: str = ROOT):
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def start(cfg: dict, mix: dict, seed: int, dev, root: str = ROOT,
          after_build=None):
    """The program built from the seed (the mix's driver's `build`, else
    `program.build`), its driver warmed up, and the window's request
    stream made: (driver, requests). `after_build(model)` plants a fault
    underneath (tests, calibration)."""
    mod = drivers.load(mix["driver"], root)
    model = getattr(mod, "build", program.build)(cfg, seed, dev)
    if after_build is not None:
        after_build(model)
    make_requests = getattr(mod, "requests", generator.Requests)
    driver = mod.Driver(model, mix)
    driver.warmup(make_requests(mix, seed, stream=1))
    return driver, make_requests(mix, seed)


def release(dev) -> None:
    """Give the device memory of dropped objects back."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def free(driver, dev) -> None:
    """Drop the program and give its device memory back."""
    driver.model = None
    release(dev)


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that belong to JAX or the JAX
    package, compared whole (`vlm_fo1_tpu_torch` is not `vlm_fo1_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit_w() -> float | None:
    """The card's power limit from nvidia-smi, None where it cannot be
    read."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda", root: str = ROOT,
             bench: dict | None = None, after_build=None) -> dict:
    """One run; returns the result line's object. `after_build(model)` is
    for tests that break the timed path underneath."""
    bench = bench or load_bench(root)
    cell = find_cell(bench, name)
    cfg = load_config(cell["config"], root)
    mix = generator.load_mix(cell["traffic"], root)
    limits = load_limits(name, root)
    dev = torch.device(device)
    profile = bool(trace) and dev.type == "cuda"
    tracer = Tracer(profile, **mix.get("trace", {}))

    driver, reqs = start(cfg, mix, seed, dev, root, after_build)
    if trace:
        driver.spans(tracer, cfg)
        tracer.warm()
    reqs.fill()
    _sync(dev)
    gc.collect()
    setup_peak = 0
    if dev.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t_window = time.perf_counter()
    setup_s = time.time() - t_start
    tracer.arm(t_window)
    records, stats = driver.window(reqs, seconds)
    _sync(dev)
    t_last = max((r["t_done"] for r in records if r["t_done"] is not None),
                 default=time.perf_counter())
    window_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    summary = tracer.summarize() if profile else None

    ctx = SimpleNamespace(
        cell=cell, config=cfg, mix=mix, records=records, stats=stats,
        setup_s=setup_s, window_s=t_last - t_window, t_window=t_window,
        seconds=seconds, peak_bytes=window_peak, spans=tracer.spans,
        trace=summary)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, cell, kind):
        value = reader(m["name"], root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    free(driver, dev)
    del driver

    picked = check.sample(records, seed, mix["check"]["requests"])
    ref = check.reference(cfg, seed, dev)
    compared = check.compared(check.program_readings(ref, picked, mix),
                              records, picked, mix, limits)
    del ref
    correct = check.decide(compared)
    failed = compared["failed_requests"]["value"]
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1,
                   "memory_peak_bytes": int(max(setup_peak, window_peak))}
    out = {"correct": bool(correct), "attempted": len(records),
           "failed": failed, "metrics": metrics, "device": device_info}
    if summary is not None and "error" not in summary:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["notes"] = {
        "power_limit_w": power_limit_w() if dev.type == "cuda" else None,
        "requests_done": len(records) - failed,
        "stats": {k: v for k, v in stats.items()
                  if isinstance(v, (int, float))},
        "picked_gaps_from": [r["req"]["id"] for r in picked],
        "trace": None if summary is None else {
            k: summary[k] for k in ("device_events", "linked_events")
            if k in summary} or summary.get("error"),
    }
    out["compared"] = compared
    return out

