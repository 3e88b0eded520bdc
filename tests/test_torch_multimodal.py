"""The port's multi-image and video prompts vs the JAX `FO1Model` on
`FO1Config.tiny()` (untied head), f32 on the CPU, weights bridged from the
port's `random_init` into the JAX converters
(`torch_parity.jax_fo1_params`): a two-image prompt (boxes on the first), a
video of four frames and a video followed by an image (no region branch).
`prepare` equal (ids, positions, grids, every slot's pixel rows), `encode`
to 1e-4, greedy tokens of `generate` (and streamed) equal; `generate_batch`
over a batch that mixes them with single-image prompts gives each
request's own tokens and JAX's; `ServingPipeline` serves the same batch;
a two-image prompt with more region slots than JAX's bucket holds runs."""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

from conftest import StubTokenizer
from torch_parity import jax_fo1_params, one_torch_thread, port_config  # noqa: F401
from vlm_fo1_tpu.config import FO1Config
from vlm_fo1_tpu.models.fo1 import FO1Model as JaxFO1Model
from vlm_fo1_tpu_torch.models.fo1 import FO1Model
from vlm_fo1_tpu_torch.runtime import serving as ts

JCFG = dataclasses.replace(
    FO1Config.tiny(),
    text=dataclasses.replace(FO1Config.tiny().text, tie_word_embeddings=False))
CFG = port_config(JCFG)
ATOL = 1e-4
MAX_NEW = 6


def _image(seed, h, w):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8))


def _image_part(img):
    return {"type": "image_url", "image_url": {"url": img}}


def _video_part(seed, n=4):
    return {"type": "video_url",
            "video_url": {"url": [_image(seed + i, 56, 84)
                                  for i in range(n)]}}


def _messages(parts, text, boxes=None):
    return [{"role": "user",
             "content": parts + [{"type": "text", "text": text}],
             "bbox_list": boxes}]


BOXES = [[4.0, 3.0, 50.0, 40.0], [10.0, 20.0, 70.0, 60.0],
         [0.0, 0.0, 79.0, 63.0]]
PROMPTS = {
    "two_images": _messages(
        [_image_part(_image(1, 64, 80)), _image_part(_image(2, 96, 72))],
        "Which boxes hold a cup?", BOXES),
    "video": _messages([_video_part(10)], "What happens?"),
    "video_then_image": _messages(
        [_video_part(20, 3), _image_part(_image(3, 64, 80))],
        "Compare them.", BOXES),
}
SINGLE = _messages([_image_part(_image(4, 64, 80))], "Find the cup.",
                   BOXES[:2])


@pytest.fixture(scope="module")
def models():
    tm = FO1Model.random_init(CFG, seed=7, device="cpu",
                              tokenizer=StubTokenizer())
    jm = JaxFO1Model(JCFG, jax_fo1_params(tm.state_dict(), JCFG),
                     tokenizer=StubTokenizer())
    return jm, tm


@pytest.mark.parametrize("kind", sorted(PROMPTS))
def test_prepare_matches(models, kind):
    jm, tm = models
    pj = jm.prepare(PROMPTS[kind])
    pt = tm.prepare(PROMPTS[kind])
    assert pt["prompt"] == pj["prompt"]
    assert pt["grids"] == pj["grids"] and len(pt["grids"]) == \
        (2 if kind != "video" else 1)
    assert pt["first_is_image"] == pj["first_is_image"] == \
        (kind == "two_images")
    assert [k for k, _ in pt["media"]] == [k for k, _ in pj["media"]]
    assert pt["bbox_list"] == pj["bbox_list"]
    for got, want in zip(pt["pixel_values_list"], pj["pixel_values_list"]):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for key in ("aux", "aux_boxes", "vt_boxes", "position_ids",
                "rope_deltas"):
        if pj[key] is None:
            assert pt[key] is None, key
        else:
            np.testing.assert_array_equal(pt[key], pj[key], err_msg=key)
    for key in ("input_ids", "image_positions", "region_positions"):
        np.testing.assert_array_equal(getattr(pt["splice"], key),
                                      getattr(pj["splice"], key))
    if kind != "two_images":  # the video's pad id fills its slot
        ids = pt["splice"].input_ids[pt["splice"].image_positions]
        assert (ids == CFG.video_token_id).any()


@pytest.mark.parametrize("kind", sorted(PROMPTS))
def test_encode_matches(models, kind):
    jm, tm = models
    prep = tm.prepare(PROMPTS[kind])
    vj, rj, nbj, rpj = jm.encode(jm.prepare(PROMPTS[kind]))
    vt, rt = tm.encode(prep)
    _, rpt, nbt = tm._encode_one(prep)
    assert nbt == nbj and vt.shape == vj.shape
    assert vt.shape[0] == len(prep["splice"].image_positions)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=ATOL)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=ATOL)
    np.testing.assert_allclose(rpt.numpy(), np.asarray(rpj), atol=ATOL)


@pytest.mark.parametrize("kind", sorted(PROMPTS))
def test_generate_matches(models, kind):
    jm, tm = models
    want = jm.generate(PROMPTS[kind], max_new_tokens=MAX_NEW)
    got = tm.generate(PROMPTS[kind], max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(got.token_ids, np.asarray(want.token_ids))
    assert (got.num_steps, got.prompt_len) == (want.num_steps,
                                                want.prompt_len)
    assert len(set(got.token_ids.tolist())) > 1


MIXED = [SINGLE, PROMPTS["two_images"], PROMPTS["video"], SINGLE,
         PROMPTS["video_then_image"]]


@pytest.fixture(scope="module")
def alone(models):
    _, tm = models
    return [tm.generate(m, max_new_tokens=MAX_NEW) for m in MIXED]


def _same_tokens(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g.token_ids)[:MAX_NEW],
                                      np.asarray(w.token_ids)[:MAX_NEW],
                                      err_msg=f"request {i}")


def test_mixed_generate_batch_matches(models, alone):
    """Multi-slot prompts are not fusable: the batch encodes per item, and
    each row gives the request's own greedy tokens, and JAX's."""
    jm, tm = models
    preps = [tm.prepare(m) for m in MIXED]
    assert not tm._fusable(preps)
    got = tm.generate_batch(MIXED, max_new_tokens=MAX_NEW)
    _same_tokens(got, alone)
    _same_tokens(got, jm.generate_batch(MIXED, max_new_tokens=MAX_NEW))


@pytest.mark.parametrize("grouped", [False, True])
def test_serving_pipeline_serves_multislot(models, alone, grouped):
    _, tm = models
    pipe = ts.ServingPipeline(tm, ts.ServingOptions(
        batch_size=2, max_new_tokens=MAX_NEW, prepare_workers=2,
        geometry_group=grouped))
    got = pipe.run(MIXED)
    _same_tokens(got, alone)
    assert pipe.stats["requests"] == len(MIXED)


def test_video_rows_are_not_normalized_twice(models):
    """The video's float rows reach the ViT as they are (cast only); the
    uint8 image rows go through the /255-mean-std affine."""
    _, tm = models
    rows = torch.from_numpy(
        tm.prepare(PROMPTS["video"])["pixel_values_list"][0])
    assert rows.dtype == torch.float32
    out, _ = tm._normalize(rows, None)
    assert torch.equal(out, rows)


def test_region_slots_of_a_further_image(models):
    """The chat template puts a region slot per box after every image, and
    the boxes belong to the first: seven boxes on a two-image prompt give
    fourteen slots. JAX's encode pads its rows to the box count's bucket
    (10) and raises; the port pads them to the slots' bucket (20), which
    gives JAX's result wherever JAX's bucket has room (the 3-box prompts
    above)."""
    jm, tm = models
    boxes = [[2.0 * i, 1.0 * i, 40.0 + i, 30.0 + i] for i in range(7)]
    msgs = _messages([_image_part(_image(5, 64, 80)),
                      _image_part(_image(6, 64, 80))], "Find them.", boxes)
    with pytest.raises(ValueError):
        jm.generate(msgs, max_new_tokens=2)
    prep = tm.prepare(msgs)
    assert len(prep["splice"].region_positions) == 14
    vision, region, nb = tm._encode_one(prep)
    assert nb == 20 and region.shape[0] == 20
    res = tm.generate(msgs, max_new_tokens=MAX_NEW)
    assert np.isfinite(res.prefill_logits).all()
    batch = tm.generate_batch([msgs, SINGLE], max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(batch[0].token_ids[:MAX_NEW],
                                  res.token_ids[:MAX_NEW])


@pytest.mark.parametrize("kind", ["two_images", "video"])
def test_streaming_multislot(models, kind):
    """`generate(streamer=)` over a multi-slot prompt: the host-driven step
    decode gives the greedy tokens of the loop, and JAX's streamed text."""
    jm, tm = models
    seen, jseen = [], []
    got = tm.generate(PROMPTS[kind], max_new_tokens=MAX_NEW,
                      streamer=seen.append)
    want = jm.generate(PROMPTS[kind], max_new_tokens=MAX_NEW,
                       streamer=jseen.append)
    loop = tm.generate(PROMPTS[kind], max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(got.token_ids, loop.token_ids)
    np.testing.assert_array_equal(got.token_ids, np.asarray(want.token_ids))
    assert seen == jseen and len(seen) == got.num_steps
