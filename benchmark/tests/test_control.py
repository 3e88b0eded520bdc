"""The control at a size a test run holds: the reference in e4m3 linear
layers, read at the program's own prompts and served tokens, lands far
above the program's widest gap and comes out not correct through the
decision a run makes; and the calibration's one-process readings run end
to end, each decided, into a limits file."""

import json

import pytest
import torch

from benchmark import calibrate, check, generator, program
from benchmark.reference.fo1 import fp8_rows

from conftest import TINY_LIMIT, TINY_PREFILL_LIMIT, _tiny_mix, tiny_config


def test_fp8_rows_rounds_to_three_mantissa_bits():
    x = torch.tensor([[1.0, 1.0625, 448.0, -3.3]])
    y = fp8_rows(x)
    assert y[0, 2] == 448.0 and y[0, 0] == 1.0
    # e4m3 holds 1 and 1.125 near 1; 1.0625 rounds to one of them
    assert y[0, 1] in (1.0, 1.125)
    assert abs(y[0, 3] + 3.3) / 3.3 < 1 / 16


@pytest.mark.parametrize("quant", ["none", "int4"])
def test_control_reads_far_above_the_program(quant):
    cfg = dict(tiny_config(), quant=quant)
    seed = 2**31 + 5
    model = program.build(cfg, seed, torch.device("cpu"))
    mix = _tiny_mix("single")
    reqs = generator.Requests(mix, seed)
    records = []
    for i in range(6):
        req = reqs.request(i)
        records.append({"req": req, "result": model.generate(
            generator.messages(req), max_new_tokens=8)})
    picked = check.sample(records, seed, 6)
    ref = check.reference(cfg, seed, "cpu")
    low = check.reference(cfg, seed, "cpu", precision="fp8")
    prog_r = check.program_readings(ref, picked, mix)
    ctl_r = check.control_readings(ref, low, picked, mix)
    prog, ctl = max(prog_r["gap"]), max(ctl_r["gap"])
    assert prog < 5e-4          # float32 against float32
    assert ctl > 100 * max(prog, 1e-5)
    assert max(prog_r["prefill"]) < TINY_PREFILL_LIMIT
    assert min(ctl_r["prefill"]) > 100 * max(prog_r["prefill"])
    # the same decision a run makes, against the tiny cells' limits
    limits = {"logit_gap_max": {"limit": TINY_LIMIT},
              "prefill_logit_err_max": {"limit": TINY_PREFILL_LIMIT}}
    assert check.decide(check.compared(prog_r, records, picked, mix,
                                       limits)) is True
    assert check.decide(check.compared(ctl_r, records, picked, mix,
                                       limits)) is False


def test_decide_reads_every_number_against_its_limit():
    def numbers(gap, failed, tokens):
        return {"logit_gap_max": {"value": gap, "limit": 0.4},
                "failed_requests": {"value": failed, "limit": 0},
                "checked_tokens_at_least": {"value": tokens, "limit": 200}}

    assert check.decide(numbers(0.4, 0, 200)) is True
    assert check.decide(numbers(0.41, 0, 256)) is False
    assert check.decide(numbers(0.1, 1, 256)) is False
    assert check.decide(numbers(0.1, 0, 199)) is False
    assert check.decide(numbers(None, 0, 256)) is False
    missing = numbers(0.1, 0, 256)
    missing["logit_gap_max"]["limit"] = None
    assert check.decide(missing) is False


def test_calibration_runs_in_one_process(tiny_root, tmp_path, capsys):
    root, bench = tiny_root
    limits = {"logit_gap_max": TINY_LIMIT,
              "prefill_logit_err_max": TINY_PREFILL_LIMIT}
    out = calibrate.calibrate("tiny.bf16.single", [3, 4], {4}, 1.5,
                              limits, {"region_zero": [5]},
                              device="cpu", root=root, bench=bench)
    gap = out["numbers"]["logit_gap_max"]
    assert gap["program_seeds"] == 2 and gap["lower"] < 5e-4
    assert gap["upper"] is not None and gap["upper"] > gap["lower"]
    assert out["numbers"]["prefill_logit_err_max"]["lower"] < TINY_PREFILL_LIMIT
    assert out["correct"] == {"program": [True, True], "control": [False],
                              "region_zero": [False]}
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [json.loads(x) for x in lines[:-1]]
    assert json.loads(lines[-1])["workload"] == "tiny.bf16.single"
    # the recorded rows decided again against a limit no reading meets
    again = calibrate.redecide(rows, {"logit_gap_max": -1.0})
    assert not any(r["correct"] for r in again)
    path = str(tmp_path / "limits.json")
    calibrate.write_limits(path, out)
    merged = calibrate.write_limits(path, out)
    assert merged["logit_gap_max"]["program_seeds"] == 4
    assert merged["logit_gap_max"]["lower"] == gap["lower"]
    assert merged["decisions"]["control"] == [False, False]
    assert merged["logit_gap_max"]["control_per_seed"] == 2 * [gap["upper"]]
    assert merged["logit_gap_max"]["faults"]["region_zero"] == 2 * gap[
        "faults"]["region_zero"]
    assert merged["prefill_logit_err_max"]["limit"] == TINY_PREFILL_LIMIT
