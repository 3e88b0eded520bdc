"""The readers of the program's own spans (`vlm_fo1_tpu_torch.runtime.trace`)
on the tiny cells on the CPU: each host reader returns a number in its
cells' traced runs, each device reader returns nothing (no CUDA events on
the CPU), every reader returns nothing, without raising, for a program
that has no recorder, and the readers leave out the spans a profiler was
active in."""

import sys
import time
from types import SimpleNamespace

import pytest

from benchmark import core

HOST = {"tiny.bf16.serve-b8": ["prep_stall_ms.serve", "capture_s.setup"],
        "tiny.int4.cont-b8.long": ["turn_ms.cont", "capture_s.setup"],
        "tiny.bf16.single": ["prepare_pixels_ms.single",
                             "encode_host_ms.single", "capture_s.setup"]}
DEVICE = ["vit_device_ms.serve", "davit_device_ms.serve",
          "region_device_ms.serve", "prefill_device_ms.serve"]
NEW = DEVICE + sorted({m for ms in HOST.values() for m in ms})


@pytest.mark.parametrize("cell", sorted(HOST))
def test_host_readers_read_and_device_readers_do_not(tiny_root, cell):
    root, bench = tiny_root
    out = core.run_cell(cell, 2**31 + 11, 3.0, True, t_start=time.time(),
                        device="cpu", root=root, bench=bench)
    assert out["correct"] is True, out["compared"]
    metrics = out["metrics"]
    for name in HOST[cell]:
        assert metrics[name]["value"] >= 0.0, name
    # graphs are captured only on the card
    assert metrics["capture_s.setup"]["value"] == 0.0
    assert not set(DEVICE) & set(metrics)
    if cell == "tiny.bf16.single":
        # a request's pixel work is part of its prepare
        assert metrics["prepare_pixels_ms.single"]["value"] \
            < metrics["prepare_ms.single"]["value"]
        assert metrics["encode_host_ms.single"]["value"] > 0.0
    if cell == "tiny.int4.cont-b8.long":
        assert metrics["turn_ms.cont"]["value"] > 0.0


@pytest.mark.parametrize("name", NEW)
def test_reader_without_the_recorder_reads_nothing(monkeypatch, name):
    # a None entry in sys.modules makes the import raise ImportError, as
    # on a program that predates the recorder
    import vlm_fo1_tpu_torch.runtime as runtime

    monkeypatch.delattr(runtime, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "vlm_fo1_tpu_torch.runtime.trace",
                        None)
    ctx = SimpleNamespace(t_window=time.perf_counter(), setup_s=1.0)
    assert core.reader(name)(ctx) is None


def test_readers_leave_out_what_a_profiler_touched():
    from torch.profiler import ProfilerActivity, profile

    from vlm_fo1_tpu_torch.runtime import trace

    ctx = SimpleNamespace(t_window=time.perf_counter(), setup_s=1.0)
    for _ in range(2):
        with trace.span("prepare.pixels"):
            time.sleep(0.002)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("prepare.pixels"):
            time.sleep(0.2)
    got = core.reader("prepare_pixels_ms.single")(ctx)
    assert 2.0 <= got < 50.0
