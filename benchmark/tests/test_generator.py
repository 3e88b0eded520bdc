"""The general request generator: seeded, the same work for every seed."""

import json
import os

import numpy as np

from benchmark import generator

HERE = os.path.dirname(os.path.abspath(__file__))


def _mix(name):
    with open(os.path.join(HERE, "..", "traffic", f"{name}.json")) as f:
        return json.load(f)


def _signature(reqs, n):
    out = []
    for i in range(n):
        r = reqs.request(i)
        out.append((len(r["boxes"]), tuple(map(tuple, r["boxes"])),
                    r["max_new_tokens"], np.asarray(r["image"])[:2, :2]
                    .tobytes()))
    return out


def test_same_seed_same_traffic_other_seed_other_order():
    mix = _mix("cont-b8.long")
    a = generator.Requests(mix, 2**31 + 17)
    b = generator.Requests(mix, 2**31 + 17)
    c = generator.Requests(mix, 5)
    assert _signature(a, 60) == _signature(b, 60)
    assert _signature(a, 60) != _signature(c, 60)
    # the warm-up's stream is not the window's
    assert _signature(generator.Requests(mix, 2**31 + 17, stream=1), 8) \
        != _signature(a, 8)


def test_every_seed_does_the_same_work():
    mix = _mix("cont-b8.long")
    lo, hi = mix["boxes"]
    block = mix["max_new_tokens"]["block"]
    for seed in (0, 1, 2**33 + 5):
        reqs = generator.Requests(mix, seed)
        counts = sorted(reqs.box_count(i) for i in range(hi - lo + 1))
        assert counts == list(range(lo, hi + 1))
        budgets = sorted(reqs.budget(i) for i in range(block))
        assert budgets == sorted(generator.budget_block(
            mix["max_new_tokens"]))


def test_budgets_are_log_uniform_quantiles():
    b = generator.budget_block({"dist": "loguniform", "min": 32,
                                "max": 512, "block": 48})
    assert len(b) == 48 and b == sorted(b)
    assert 32 <= b[0] <= 34 and 490 <= b[-1] <= 512
    assert abs(np.mean(b) - 173) < 5    # (512 - 32) / ln 16
    assert generator.budget_block({"dist": "fixed", "value": 32}) == [32]


def test_boxes_lie_inside_the_image():
    mix = _mix("serve-b8")
    reqs = generator.Requests(mix, 3)
    w, h = mix["image"]["width"], mix["image"]["height"]
    for i in range(40):
        r = reqs.request(i)
        assert r["image"].size == (w, h)
        for x1, y1, x2, y2 in r["boxes"]:
            assert 0 <= x1 < x2 <= w and 0 <= y1 < y2 <= h
