"""Fixtures of the benchmark's own tests (`pytest benchmark/tests`).

`tiny_root` lays out a temporary checkout holding this benchmark with tiny
cells added as files only: a configuration (`FO1Config.tiny()`'s sizes in
float32, weights drawn wider so greedy tokens vary), three mixes at a
120x160 image and a few tokens, their limits, and a `BENCHMARK.json` whose
cells are the real ones renamed `tiny.*`. Tests marked `cuda` need an
NVIDIA card; whether there is one is decided inside the `cuda_device`
fixture, never at import.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_LIMIT = 1e-3   # float32 program against the float32 reference
TINY_PREFILL_LIMIT = 1e-4


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
    # a few threads a worker: time-bound windows (the single cell's closed
    # loop) stay long enough to finish several requests under `-n`
    import torch

    torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def tiny_config() -> dict:
    with open(os.path.join(HERE, "fixtures", "tiny.json")) as f:
        return json.load(f)


def _tiny_mix(name: str) -> dict:
    with open(os.path.join(BENCH_DIR, "traffic", f"{name}.json")) as f:
        mix = json.load(f)
    mix["image"] = {"width": 160, "height": 120}
    mix["image_pool"] = 4
    if mix["driver"] == "continuous":
        # a group is one block of box counts, each count once, as the
        # cell's groups of 48 hold each three times
        mix["continuous"]["group"] = 16
        mix["max_new_tokens"].update(min=4, max=40, block=16)
    else:
        mix["max_new_tokens"]["value"] = 6
    # one whole request's tokens: a window on a loaded CPU may finish few
    mix["check"]["min_tokens"] = 6
    mix["trace"] = {"slice_at": 0.0, "slice_s": 1.0}
    return mix


def make_tiny_root(path: str) -> tuple[str, dict]:
    """A checkout at `path` with the tiny cells; returns (root, bench)."""
    shutil.copytree(BENCH_DIR, os.path.join(path, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cfg = tiny_config()
    configs = {"tiny": cfg, "tiny-int4": dict(cfg, quant="int4")}
    for name, c in configs.items():
        with open(os.path.join(path, "benchmark", "configs",
                               f"{name}.json"), "w") as f:
            json.dump(c, f)
    cells = []
    for cell in bench["workloads"]:
        mix = "tiny-" + cell["traffic"]
        with open(os.path.join(path, "benchmark", "traffic",
                               f"{mix}.json"), "w") as f:
            json.dump(_tiny_mix(cell["traffic"]), f)
        cell = dict(cell, name="tiny." + cell["name"], traffic=mix,
                    config="tiny-int4" if "int4" in cell["config"]
                    else "tiny")
        with open(os.path.join(path, "benchmark", "limits",
                               f"{cell['name']}.json"), "w") as f:
            json.dump({"logit_gap_max": {"limit": TINY_LIMIT},
                       "prefill_logit_err_max": {
                           "limit": TINY_PREFILL_LIMIT}}, f)
        cells.append(cell)
    bench = copy.deepcopy(bench)
    bench["workloads"] = cells
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny." + w for w in m["workloads"]]
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return path, bench


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(str(tmp_path))
