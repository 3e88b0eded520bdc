"""On the card (`pytest -m cuda benchmark/tests`): the tiny cells end to
end with the traced slice, and the trace's reduction."""

import time

import pytest

from benchmark import core


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.bf16.serve-b8",
                                  "tiny.int4.cont-b8.long",
                                  "tiny.bf16.single"])
def test_tiny_cell_on_the_card(tiny_root, cuda_device, cell):
    root, bench = tiny_root
    out = core.run_cell(cell, 2**31 + 7, 3.0, True, t_start=time.time(),
                        device="cuda", root=root, bench=bench)
    assert out["correct"] is True, out["compared"]
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["memory_peak_bytes"] > 0
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert out["breakdown"]["device_ops"]
    assert out["notes"]["trace"]["linked_events"] > 0
