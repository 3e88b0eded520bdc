"""FLOP and byte counts and the roofline arithmetic, against values worked
out by hand."""

import json
import os

import pytest

from benchmark.yardstick import flops, peaks

HERE = os.path.dirname(os.path.abspath(__file__))


def _cfg():
    with open(os.path.join(HERE, "..", "configs", "fo1-3b-bf16.json")) as f:
        return json.load(f)


def test_causal_prefill_counts_the_pairs_a_prompt_needs():
    cfg = _cfg()
    # 36 layers x 2048 wide: one query-key pair costs 2 products x 2 FLOPs
    # x 2048 (all heads together) x 36 layers
    assert flops.attention_pair_flops(cfg) == 4 * 2048 * 36
    # a 3-token prompt has 3 + 2 + 1 = 6 causal pairs
    linear = flops.prefill_flops(cfg, 3) - flops.attention_pair_flops(cfg) \
        * 6 - 2 * 2048 * 151936
    # per token and layer: q 2048x2048, k and v 2048x256, o 2048x2048,
    # gate / up / down 2048x11008, each x 2 FLOPs
    per_token = 36 * 2 * (2048 * 2048 * 2 + 2048 * 256 * 2
                          + 3 * 2048 * 11008)
    assert linear == pytest.approx(3 * per_token, rel=1e-12)
    # the prefill attention of a 1771-token prompt: 1771 * 1772 / 2 pairs
    f, b = flops.flash_prefill(cfg, [1771])
    assert f == 4 * 2048 * 36 * 1771 * 1772 / 2
    assert b == 36 * 1771 * (2 * 2048 + 2 * 256) * 2


def test_decode_counts_each_steps_keys():
    cfg = _cfg()
    one = flops.decode_flops(cfg, 1, 100)
    two = flops.decode_flops(cfg, 2, 100)
    # the second step attends over one key more than the first
    assert two - 2 * one == pytest.approx(flops.attention_pair_flops(cfg))


def test_vit_full_attention_counts_real_patches_only():
    cfg = _cfg()
    f, b = flops.flash_vit(cfg, 68, 92, 8)
    s = 68 * 92
    assert f == 4 * 8 * 2 * (2 * s * 1280 * s)
    assert b == 4 * 8 * 4 * s * 1280 * 2


def test_int4_call_reads_each_weight_byte_once():
    f, b = flops.int4_call(8, 2048, 11008)
    assert f == 2 * 8 * 2048 * 11008
    assert b == 2048 * 11008 // 2 + 4 * 11008 + 2 * 8 * 2048 + 2 * 8 * 11008


def test_least_seconds_takes_the_binding_roof():
    # 989 GFLOP alone takes 1 ms at 989 TFLOP/s; 3.35 GB alone 1 ms
    assert peaks.least_seconds(989e9, 0) == pytest.approx(1e-3)
    assert peaks.least_seconds(0, 3.35e9) == pytest.approx(1e-3)
    assert peaks.least_seconds(989e9, 6.7e9) == pytest.approx(2e-3)
    # the int4 M = 8 gate projection is bound by its 11.3 MB of weights
    t = peaks.least_seconds(*flops.int4_call(8, 2048, 11008))
    assert t == pytest.approx((2048 * 11008 / 2 + 4 * 11008 + 2 * 8 * 2048
                               + 2 * 8 * 11008) / 3.35e12)


def test_request_flops_of_the_demo_request():
    cfg = _cfg()
    total = flops.request_flops(cfg, 68, 92, 7, 1771, 32)
    # ~20 TFLOP a demo request: encode ~9, prefill ~11, decode ~0.2
    assert 15e12 < total < 30e12
