"""The harness: found by name, the result line's shape, the import check,
and whole runs of the tiny cells on the CPU, sound and with the timed
path broken underneath."""

import json
import os
import re
import sys
import time
import types

import pytest

from benchmark import core, faults, generator

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _run(root, bench, cell, trace=0, seconds=3.0, after_build=None):
    return core.run_cell(cell, 2**31 + 99, seconds, bool(trace),
                         t_start=time.time(), device="cpu", root=root,
                         bench=bench, after_build=after_build)


def test_benchmark_json_names_and_units():
    bench = core.load_bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(core.ROOT, "benchmark", "metrics",
                                           m["name"] + ".py")), m["name"]
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(core.ROOT, "benchmark", "traffic",
                                           w["traffic"] + ".json"))
        driver = generator.load_mix(w["traffic"])["driver"]
        assert os.path.exists(os.path.join(core.ROOT, "benchmark", "drivers",
                                           driver + ".py"))
        assert os.path.exists(os.path.join(core.ROOT, "benchmark", "limits",
                                           w["name"] + ".json"))
        assert len(w["why"]) <= 200
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer metric
        e2e = [m["name"] for m in core.cell_metrics(bench, w, "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert core.cell_metrics(bench, w, "per_layer")
    for c in bench["configs"]:
        cfg = core.load_config(c["name"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert c["source"] == cfg["source"]


def test_new_config_mix_and_metric_are_found_without_an_edit(tiny_root):
    """A configuration, a mix, a driver and a metric added as files only
    (the tiny root's cells are such files too) are found by name."""
    root, bench = tiny_root
    drivers_dir = os.path.join(root, "benchmark", "drivers")
    with open(os.path.join(drivers_dir, "single.py")) as f:
        src = f.read()
    with open(os.path.join(drivers_dir, "single_counted.py"), "w") as f:
        f.write(src + """

from benchmark import generator, program

BUILT = []


def build(cfg, seed, device):
    BUILT.append(seed)
    return program.build(cfg, seed, device)


class requests(generator.Requests):
    def request(self, i, n_boxes=None):
        return dict(super().request(i, n_boxes), own_builder=True)


class Counted(Driver):
    def window(self, reqs, seconds, **kw):
        records, stats = super().window(reqs, seconds, **kw)
        return records, dict(stats, counted=len(records), built=BUILT[-1],
                             own=all(r["req"]["own_builder"]
                                     for r in records))


Driver = Counted
""")
    mix_path = os.path.join(root, "benchmark", "traffic", "tiny-single.json")
    with open(mix_path) as f:
        mix = json.load(f)
    mix["driver"] = "single_counted"
    mix["single_counted"] = mix.pop("single")
    with open(os.path.join(root, "benchmark", "traffic",
                           "tiny-counted.json"), "w") as f:
        json.dump(mix, f)
    cell = dict(core.find_cell(bench, "tiny.bf16.single"),
                name="tiny.counted", traffic="tiny-counted")
    bench["workloads"].append(cell)
    with open(os.path.join(root, "benchmark", "limits",
                           "tiny.bf16.single.json")) as f:
        limits = f.read()
    with open(os.path.join(root, "benchmark", "limits",
                           "tiny.counted.json"), "w") as f:
        f.write(limits)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny.bf16.single" in m.get("workloads", []):
            m["workloads"].append("tiny.counted")
    with open(os.path.join(root, "benchmark", "metrics",
                           "served_tokens.extra.py"), "w") as f:
        f.write("def read(ctx):\n    return float(sum(len(r['result']"
                ".token_ids) for r in ctx.records if r['result']))\n")
    bench["per_layer"].append({
        "name": "served_tokens.extra", "unit": "tokens", "better": "higher",
        "source": "program_counter", "layer": "serving pipelines",
        "moves": "latency_p50_ms", "workloads": ["tiny.counted"]})
    out = _run(root, bench, "tiny.counted", trace=1)
    assert out["metrics"]["served_tokens.extra"]["value"] > 0
    stats = out["notes"]["stats"]
    assert stats["counted"] == out["attempted"] and stats["own"] is True
    assert stats["built"] == 2**31 + 99
    assert out["correct"] is True


def test_result_line_shape(tiny_root):
    root, bench = tiny_root
    out = _run(root, bench, "tiny.bf16.serve-b8")
    line = json.dumps(out)
    back = json.loads(line)
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in back
    assert list(back)[-1] == "compared"
    assert set(back["metrics"]) == {"req_per_s", "peak_mem_gib", "setup_s"} \
        - {"peak_mem_gib"}   # no device memory reading on the CPU
    for m in back["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for key in ("platform", "kind", "count", "memory_peak_bytes"):
        assert key in back["device"]
    for c in back["compared"].values():
        assert set(c) == {"value", "limit"}
    assert back["correct"] is True and back["failed"] == 0
    assert back["attempted"] % 8 == 0      # whole batches only


@pytest.mark.parametrize("cell", ["tiny.bf16.serve-b8",
                                  "tiny.int4.cont-b8.long",
                                  "tiny.bf16.single"])
def test_tiny_cells_run_correct(tiny_root, cell):
    root, bench = tiny_root
    out = _run(root, bench, cell, trace=1)
    assert out["correct"] is True, out["compared"]
    assert out["compared"]["logit_gap_max"]["value"] <= 1e-3
    assert out["metrics"]


def test_import_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "vlm_fo1_tpu_torch.fake",
                        types.ModuleType("vlm_fo1_tpu_torch.fake"))
    monkeypatch.setitem(sys.modules, "jaxtyping_like",
                        types.ModuleType("jaxtyping_like"))
    assert "vlm_fo1_tpu" not in core.forbidden_modules()
    assert "jax" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "vlm_fo1_tpu.models",
                        types.ModuleType("vlm_fo1_tpu.models"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert {"vlm_fo1_tpu", "jax"} <= set(core.forbidden_modules())


def test_no_jax_after_a_run(tiny_root):
    root, bench = tiny_root
    _run(root, bench, "tiny.bf16.single", seconds=0.5)
    # the test process itself may hold JAX from other test files; the
    # harness's own modules must not pull it in
    import benchmark.core
    import benchmark.reference.fo1
    for mod in (benchmark.core, benchmark.reference.fo1):
        src = open(mod.__file__).read()
        assert not re.search(r"^\s*(import|from)\s+(jax|vlm_fo1_tpu)\b",
                             src, re.M)


# ------------------------------------------------------------- faults
# Each fault (`benchmark/faults.py`) breaks the timed path underneath the
# harness; the rest of the run is the real one, and `correct` has to come
# out false, for every fault a cell's driver can have.

FAULT_CASES = [(cell, fault)
               for cell, driver in (("tiny.bf16.serve-b8", "serving"),
                                    ("tiny.int4.cont-b8.long", "continuous"),
                                    ("tiny.bf16.single", "single"))
               for fault in faults.for_driver(driver)]


@pytest.mark.parametrize("cell,fault", FAULT_CASES)
def test_broken_timed_path_is_not_correct(tiny_root, cell, fault):
    root, bench = tiny_root
    out = _run(root, bench, cell,
               after_build=lambda m: faults.plant(fault, m))
    assert out["correct"] is False, out["compared"]
    assert out["compared"]["logit_gap_max"]["value"] > 1e-3
