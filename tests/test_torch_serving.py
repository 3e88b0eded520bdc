"""The port's batched generation, serving pipelines and streaming vs the JAX
package on `FO1Config.tiny()` (untied head), f32 on the CPU, weights bridged
from the port's `random_init` into the JAX package's own checkpoint
converters (FO1: `torch_parity.jax_fo1_params`; UPN: a `.pth` that both
wrappers load), seeded synthetic
images: greedy tokens, step counts and texts of `generate_batch` on a
same-geometry ragged batch (1, 3 and 7 boxes; the stacked path) and on a
mixed-geometry batch (the per-item path); the device-preprocessed ViT
patches bit-equal to JAX `_device_preproc_batched` and the aux squash within
1e-4 of `jax.image.resize` cubic on the [0, 1] scale; `ServingPipeline`
FIFO and grouped, `ContinuousServingPipeline` (results and device steps) and
`UPNFO1Pipeline` in input order; streaming through `generate(streamer=)`.

One JAX model serves the whole module and each JAX result is computed once:
its compiles dominate the file's time."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from conftest import StubTokenizer
from torch_parity import (  # noqa: F401
    jax_fo1_params,
    one_torch_thread,
    port_config,
)
from vlm_fo1_tpu.config import FO1Config
from vlm_fo1_tpu.models.fo1 import FO1Model as JaxFO1Model
from vlm_fo1_tpu.models.fo1 import _device_preproc_batched
from vlm_fo1_tpu.runtime import serving as js
from vlm_fo1_tpu.upn.model import UPNConfig as JaxUPNConfig
from vlm_fo1_tpu.upn.swin import SwinConfig as JaxSwinConfig
from vlm_fo1_tpu.upn.wrapper import UPNWrapper as JaxUPNWrapper
from vlm_fo1_tpu_torch.models.fo1 import FO1Model, cubic_resize_matrix
from vlm_fo1_tpu_torch.runtime import serving as ts
from vlm_fo1_tpu_torch.upn.wrapper import UPNWrapper

JCFG = dataclasses.replace(
    FO1Config.tiny(),
    text=dataclasses.replace(FO1Config.tiny().text, tie_word_embeddings=False))
CFG = port_config(JCFG)
J_SWIN = JaxSwinConfig(embed_dim=16, depths=(1, 1, 2, 1),
                       num_heads=(1, 2, 4, 8), window_size=4)
J_UPN = JaxUPNConfig(d_model=32, n_heads=4, n_points=2,
                     num_encoder_layers=2, num_decoder_layers=2, d_ffn=64,
                     num_queries=20, gn_groups=8, pos_feats=16)
MAX_NEW = 6
SIZES = {"a": (64, 80), "b": (96, 128)}   # two grids: 2x3 and 3x5 units


def _image(seed, size):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (*size, 3), np.uint8))


def _boxes(n, size):
    h, w = size
    return [[2.0 * i, 1.0 * i, w - 3.0 * i - 1, h - 2.0 * i - 1]
            for i in range(n)]


def _messages(seed, geom="a", n_boxes=3, text="Find the cup."):
    size = SIZES[geom]
    return [{
        "role": "user",
        "content": [{"type": "image_url",
                     "image_url": {"url": _image(seed, size)}},
                    {"type": "text", "text": text}],
        "bbox_list": _boxes(n_boxes, size),
    }]


@pytest.fixture(scope="module")
def models():
    tm = FO1Model.random_init(CFG, seed=5, device="cpu",
                              tokenizer=StubTokenizer())
    jm = JaxFO1Model(JCFG, jax_fo1_params(tm.state_dict(), JCFG),
                     tokenizer=StubTokenizer())
    return jm, tm


def _same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g.token_ids),
                                      np.asarray(w.token_ids),
                                      err_msg=f"request {i}")
        assert (g.num_steps, g.prompt_len, g.text) == \
            (w.num_steps, w.prompt_len, w.text), f"request {i}"


BATCHES = {
    # one geometry, prompts of three lengths (1, 3 and 7 boxes): stacked
    "stacked": [_messages(1, "a", 1), _messages(2, "a", 3, "Find a dog."),
                _messages(3, "a", 7, "Where is the orange?")],
    # two geometries: one encode per item
    "per_item": [_messages(4, "a", 3), _messages(5, "b", 2),
                 _messages(6, "a", 7)],
}


@pytest.mark.parametrize("which", sorted(BATCHES))
def test_generate_batch_matches(models, which):
    jm, tm = models
    msgs = BATCHES[which]
    preps = [tm.prepare(m) for m in msgs]
    assert tm._fusable(preps) == (which == "stacked")
    want = jm.generate_batch(msgs, max_new_tokens=MAX_NEW)
    got = tm.generate_batch(msgs, max_new_tokens=MAX_NEW)
    _same(got, want)
    assert len({r.prompt_len for r in got}) == 3   # ragged prompts
    assert len(set(got[0].token_ids.tolist())) > 2  # worth comparing


def test_device_preproc_patches_and_aux(models):
    """Raw-image mode: the ViT patches bit-equal to JAX's, the aux squash
    within 1e-4 of jax.image.resize cubic on the [0, 1] scale (and the
    normalised aux input to the same 1e-4 in units of the [0, 1] scale)."""
    jm, tm = models
    preps = [tm.prepare(_messages(s, "b"), device_preproc=True)
             for s in (7, 8)]
    raw = np.stack([p["raw_image"] for p in preps])
    gather = preps[0]["plan"].gather_idx
    pj, aj = _device_preproc_batched(jnp.asarray(raw), JCFG,
                                     jnp.asarray(gather), jnp.float32)
    pt, at = tm._device_preproc(torch.from_numpy(raw),
                                torch.from_numpy(gather).long())
    assert np.array_equal(pt.numpy(), np.asarray(pj))
    size = JCFG.aux_image_size
    ref01 = np.asarray(jax.image.resize(
        jnp.asarray(raw, jnp.float32), (2, size, size, 3),
        method="cubic")) / 255.0
    h, w = raw.shape[1:3]
    got01 = np.einsum("bhwc,hy,wx->byxc", raw.astype(np.float32),
                      cubic_resize_matrix(h, size),
                      cubic_resize_matrix(w, size)) / 255.0
    np.testing.assert_allclose(got01, ref01, atol=1e-4)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    np.testing.assert_allclose(at.numpy() * std, np.asarray(aj) * std,
                               atol=1e-4)


def _serving_messages():
    """Five requests over two geometries, so both modes form partial and
    per-item batches."""
    return [_messages(10, "a", 2), _messages(11, "b", 3),
            _messages(12, "a", 5), _messages(13, "b", 1),
            _messages(14, "a", 7)]


@pytest.mark.parametrize("grouped", [False, True], ids=["fifo", "grouped"])
def test_serving_pipeline_matches(models, grouped):
    jm, tm = models
    kw = dict(batch_size=2, max_new_tokens=MAX_NEW, geometry_group=grouped,
              prepare_workers=2)
    jp = js.ServingPipeline(jm, js.ServingOptions(**kw))
    tp = ts.ServingPipeline(tm, ts.ServingOptions(**kw))
    msgs = _serving_messages()
    _same(tp.run(msgs), jp.run(msgs))
    assert tp.stats == jp.stats
    assert tp.stats["retries"] == 0


def test_continuous_pipeline_matches(models):
    """Mixed budgets through slot refill: results and device steps equal,
    fewer steps than the batch-synchronous sum."""
    jm, tm = models
    budgets = [2, MAX_NEW, 3, MAX_NEW, 2]
    reqs = [{"messages": _messages(20 + i, "a", 1 + i % 3),
             "max_new_tokens": mx} for i, mx in enumerate(budgets)]
    kw = dict(batch_size=2, chunk=3, refill_size=1, max_new_tokens=MAX_NEW,
              prepare_workers=2)
    jp = js.ContinuousServingPipeline(jm, js.ContinuousOptions(**kw))
    tp = ts.ContinuousServingPipeline(tm, ts.ContinuousOptions(**kw))
    want, got = jp.run(reqs), tp.run(reqs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.token_ids, w.token_ids)
        assert (g.num_steps, g.prompt_len, g.text) == \
            (w.num_steps, w.prompt_len, w.text)
    assert tp.stats == jp.stats
    assert tp.stats["device_steps"] < 3 * (MAX_NEW - 1)


def test_upn_fo1_pipeline_matches(models, tmp_path):
    """Proposals, then FO1, in two launches of one request each (the second
    UPN forward runs between the first FO1 launch and its finish). The
    filter truncates boxes to ints, and the two UPNs agree to ~1e-4 px
    (test_torch_upn.py), so a proposal coordinate may differ by one where
    JAX's float lies within 2e-3 of an integer, and nowhere else; the answer
    equals JAX FO1's over the port's proposals."""
    jm, tm = models
    ucfg, scfg = port_config(J_UPN), port_config(J_SWIN)
    ckpt = str(tmp_path / "upn.pth")
    torch.save({"model": UPNWrapper.random_init(
        ucfg, scfg, seed=3, device="cpu").model.state_dict()}, ckpt)
    ju = JaxUPNWrapper(ckpt, J_UPN, J_SWIN, dtype=jnp.float32)
    tu = UPNWrapper(ckpt, ucfg, scfg, dtype=torch.float32, device="cpu")
    for w in (ju, tu):
        orig = w.transform_image
        w.transform_image = (
            lambda img, orig=orig, **kw: orig(img, short_side=64,
                                              max_size=96))
    reqs = []
    for i in range(2):
        path = str(tmp_path / f"im{i}.png")
        _image(30 + i, SIZES["a"]).save(path)
        reqs.append({"image": path, "text": f"Find object {i}."})
    kw = dict(batch_size=1, min_score=0.0, nms_value=0.8, max_boxes=10,
              max_new_tokens=MAX_NEW, device_preproc=False)
    want = js.UPNFO1Pipeline(ju, jm, js.UPNFO1Options(**kw)).run(reqs)
    got = ts.UPNFO1Pipeline(tu, tm, ts.UPNFO1Options(**kw)).run(reqs)
    assert len(got) == len(want) == 2
    floats = ju.inference([r["image"] for r in reqs])["original_xyxy_boxes"]
    for i, (g, w) in enumerate(zip(got, want)):
        gp, wp = np.asarray(g["proposals"]), np.asarray(w["proposals"])
        assert gp.shape == wp.shape == (10, 4)
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-2)
        for row, col in zip(*np.nonzero(gp != wp)):
            assert abs(gp[row, col] - wp[row, col]) == 1
            near = np.abs(floats[i] - np.round(floats[i])) < 2e-3
            assert near.any(), (i, row, col)
        ref = jm.generate_batch([_upn_messages(reqs[i], g["proposals"])],
                                max_new_tokens=MAX_NEW)[0]
        assert g["text"] == ref.text
        if np.array_equal(gp, wp):
            assert (g["text"], g["fo1_bboxes"]) == (w["text"],
                                                    w["fo1_bboxes"])


def _upn_messages(req, boxes):
    return [{"role": "user",
             "content": [{"type": "image_url",
                          "image_url": {"url": req["image"]}},
                         {"type": "text", "text": req["text"]}],
             "bbox_list": boxes}]


def test_streaming_matches(models):
    """generate(streamer=) on both sides: the same texts streamed after
    every token, the same tokens and step count."""
    jm, tm = models
    msgs = _messages(40, "a", 3)
    seen = {"jax": [], "port": []}
    rj = jm.generate(msgs, max_new_tokens=MAX_NEW,
                     streamer=seen["jax"].append)
    rt = tm.generate(msgs, max_new_tokens=MAX_NEW,
                     streamer=seen["port"].append)
    np.testing.assert_array_equal(rt.token_ids, rj.token_ids)
    assert (rt.num_steps, rt.text) == (rj.num_steps, rj.text)
    assert seen["port"] == seen["jax"] and len(seen["port"]) == MAX_NEW
    # the streamed route agrees with the batch route
    rb = tm.generate(msgs, max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(rb.token_ids, rt.token_ids)
