"""The frozen reference against the program on the tiny configuration, on
the CPU in float32: the same weights and requests give the same logits."""

import numpy as np
import pytest
import torch

from benchmark import generator, program, weights
from benchmark.check import gaps
from benchmark.reference.fo1 import Reference, cubic_weights, prepare

from conftest import _tiny_mix, tiny_config

SEED = 2**32 + 3


def _pair(quant="none"):
    cfg = dict(tiny_config(), quant=quant)
    model = program.build(cfg, SEED, torch.device("cpu"))
    ref = Reference(cfg, weights.draw(cfg, SEED, "cpu", torch.float32),
                       quant=quant, device="cpu")
    return cfg, model, ref


def test_weight_layout_is_the_programs():
    cfg = tiny_config()
    model = program.build(cfg, SEED, torch.device("cpu"))
    spec = {n: s for n, s, _ in weights.param_spec(cfg)}
    sd = model.state_dict()
    assert set(spec) == set(sd)
    assert all(tuple(sd[n].shape) == tuple(s) for n, s in spec.items())


def test_weights_are_the_seeds():
    cfg = tiny_config()
    a = weights.draw(cfg, 5, "cpu", torch.float32)
    b = weights.draw(cfg, 5, "cpu", torch.float32)
    c = weights.draw(cfg, 6, "cpu", torch.float32)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["text.embed_tokens.weight"],
                           c["text.embed_tokens.weight"])


@pytest.mark.parametrize("quant", ["none", "int4"])
def test_generate_matches_reference(quant):
    # float32 on both sides: logits of magnitude ~5 agree to round-off,
    # a few 1e-5 relative
    cfg, model, ref = _pair(quant)
    reqs = generator.Requests(_tiny_mix("single"), 11)
    for i in range(4):
        req = reqs.request(i)
        res = model.generate(generator.messages(req), max_new_tokens=6)
        logits = ref.served_logits(req, res.token_ids, "pil")
        # the prefill's last row, then every served token
        assert np.abs(logits[0].numpy() - res.prefill_logits).max() < 5e-4
        assert float(gaps(logits, res.token_ids).max()) < 5e-4


def test_device_preprocessed_batch_matches_reference():
    cfg, model, ref = _pair()
    reqs = generator.Requests(_tiny_mix("serve-b8"), 12)
    req = [reqs.request(i) for i in range(4)]
    preps = [model.prepare(generator.messages(r), device_preproc=True)
             for r in req]
    out = model.finish_batch(model.launch_batch(preps, max_new_tokens=6))
    for r, res in zip(req, out):
        logits = ref.served_logits(r, res.token_ids, "cubic")
        assert np.abs(logits[0].numpy() - res.prefill_logits).max() < 5e-4
        assert float(gaps(logits, res.token_ids).max()) < 5e-4


def test_host_steps_match_the_programs():
    cfg, model, _ = _pair()
    reqs = generator.Requests(_tiny_mix("single"), 13)
    for i in range(6):
        req = reqs.request(i)
        mine = prepare(cfg, req, "pil")
        theirs = model.prepare(generator.messages(req))
        info = theirs["splice"]
        ids = np.where(info.input_ids < 0, -300, info.input_ids)
        assert np.array_equal(mine["ids"], ids)
        assert np.array_equal(mine["positions"], theirs["position_ids"][:, 0])
        assert np.allclose(mine["aux_boxes"], theirs["aux_boxes"])
        assert np.allclose(mine["vt_boxes"], theirs["vt_boxes"])
        assert np.array_equal(mine["raw"].shape[:2],
                              np.array(theirs["grid"][1:]) * 14)


def test_cubic_weights_sum_to_one_inside():
    w = cubic_weights(952, 768)
    assert w.shape == (952, 768)
    assert np.allclose(w.sum(0), 1.0, atol=1e-5)
