"""The port's UPN vs the JAX package on tiny configs, f32 on the CPU, weights
through `upn.convert.upn_state_dict_from_jax_params`: Swin maps at a size
that is not a window multiple, `upn_forward` (boxes and logits to 1e-4,
identical top-k indices) at two geometries, the wrapper's inference and
filter, and the reference `.pth` key map in both directions.

At the 256x256 geometry the level-0 map is 64 px wide, so its border anchors
are invalid and compete in the top-k with one identical score. There the
encoder-output bias is set so that this tied score is the highest of all:
the top-k then lies wholly inside the tie group and its indices depend only
on the tie rule (lax.top_k takes the lower index first)."""

import argparse
import dataclasses
import pickle
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torch_parity import (  # noqa: F401
    one_torch_thread,
    port_config,
    rand,
    to_numpy,
)
from vlm_fo1_tpu.upn.model import UPNConfig as JaxUPNConfig
from vlm_fo1_tpu.upn.model import init_upn_params, upn_forward
from vlm_fo1_tpu.upn.swin import SwinConfig as JaxSwinConfig
from vlm_fo1_tpu.upn.swin import init_swin_params, swin_forward
from vlm_fo1_tpu.upn.wrapper import UPNWrapper as JaxUPNWrapper
from vlm_fo1_tpu_torch.upn.convert import (
    swin_state_dict,
    upn_state_dict_from_jax_params,
)
from vlm_fo1_tpu_torch.upn.model import UPN, gen_anchor_proposals
from vlm_fo1_tpu_torch.upn.swin import SwinTransformer
from vlm_fo1_tpu_torch.upn.wrapper import UPNWrapper

ATOL = 1e-4  # f32 through Swin, 2 encoder and 2 decoder layers
J_SWIN = JaxSwinConfig(embed_dim=16, depths=(1, 1, 2, 1),
                       num_heads=(1, 2, 4, 8), window_size=4)
J_UPN = JaxUPNConfig(d_model=32, n_heads=4, n_points=2,
                     num_encoder_layers=2, num_decoder_layers=2, d_ffn=64,
                     num_queries=20, gn_groups=8, pos_feats=16)
SWIN, CFG = port_config(J_SWIN), port_config(J_UPN)
PROMPT = "fine_grained_prompt"


def _port_upn(params):
    model = UPN(CFG, SWIN, device="cpu")
    model.load_state_dict(
        upn_state_dict_from_jax_params(to_numpy(params), CFG, SWIN),
        strict=True)
    return model


def _jax_forward_with_topk(params, image, valid_hw):
    """JAX upn_forward under jit, also returning the indices that its
    lax.top_k selected."""
    def fwd(params, image, valid_hw):
        seen = []
        top_k = jax.lax.top_k

        def spy(x, k):
            out = top_k(x, k)
            seen.append(out[1])
            return out

        with mock.patch.object(jax.lax, "top_k", spy):
            out = upn_forward(params, J_UPN, J_SWIN, image, valid_hw, PROMPT)
        return out["pred_boxes"], out["pred_logits"], seen[0]

    return [np.asarray(x) for x in jax.jit(fwd)(
        params, jnp.asarray(image), jnp.asarray(valid_hw))]


def _image(seed, h, w, valid):
    img = np.zeros((1, h, w, 3), np.float32)
    img[:, :valid[0], :valid[1]] = rand(np.random.default_rng(seed), 1,
                                        valid[0], valid[1], 3)
    return img, np.array([valid], np.int32)


def test_swin_maps_match_jax():
    params = init_swin_params(jax.random.PRNGKey(0), J_SWIN)
    swin = SwinTransformer(SWIN)
    swin.load_state_dict(swin_state_dict(to_numpy(params), SWIN),
                         strict=True)
    x = rand(np.random.default_rng(1), 1, 52, 68, 3)
    want = jax.jit(swin_forward, static_argnums=1)(params, J_SWIN,
                                                    jnp.asarray(x))
    with torch.no_grad():
        got = swin(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert got[0].shape == (1, 13, 17, 16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def _tie_weights(params):
    """Encoder-output bias along the centred prompt: LN(Linear(0)) of an
    invalid anchor then scores above every valid anchor."""
    p = np.asarray(params[PROMPT][0])
    params = dict(params)
    params["enc_output"] = {"w": params["enc_output"]["w"],
                            "b": jnp.asarray(3.0 * (p - p.mean()))}
    return params


@pytest.mark.parametrize("geometry", ["64x96", "256x256_border_ties"])
def test_upn_forward_matches_jax(geometry):
    params = init_upn_params(jax.random.PRNGKey(2), J_UPN, J_SWIN)
    if geometry == "64x96":
        image, hw = _image(3, 128, 128, (64, 96))
    else:
        params = _tie_weights(params)
        image, hw = _image(4, 256, 256, (256, 256))
    boxes_j, logits_j, idx_j = _jax_forward_with_topk(params, image, hw)
    out = _port_upn(params)(torch.from_numpy(image), torch.from_numpy(hw),
                            PROMPT)
    np.testing.assert_array_equal(out["topk_idx"].numpy(), idx_j)
    np.testing.assert_allclose(out["pred_boxes"].numpy(), boxes_j,
                               atol=ATOL)
    np.testing.assert_allclose(out["pred_logits"].numpy(), logits_j,
                               atol=ATOL)
    if geometry != "64x96":
        # the premise: every selected anchor is an invalid border anchor of
        # level 0, and there are more of them than queries
        props = gen_anchor_proposals(((64, 64),), torch.ones(1, 1, 2))[0]
        border = ~((props > 0.01) & (props < 0.99)).all(-1)
        assert border.sum() > CFG.num_queries
        assert border[torch.from_numpy(idx_j[0].copy())].all()
        assert idx_j[0].tolist() == sorted(idx_j[0].tolist())


def test_wrapper_inference_and_filter_match_jax():
    """Two images of one bucket; the threshold lies between their best
    scores, so one image keeps boxes and the other gives an empty row."""
    jw = JaxUPNWrapper.random_init(cfg=J_UPN, swin_cfg=J_SWIN, seed=5)
    tw = UPNWrapper.random_init(cfg=CFG, swin_cfg=SWIN, device="cpu")
    tw.model.load_state_dict(
        upn_state_dict_from_jax_params(to_numpy(jw.params), CFG, SWIN),
        strict=True)
    for w in (jw, tw):
        orig = w.transform_image
        w.transform_image = (
            lambda img, orig=orig: orig(img, short_side=64, max_size=96))
    rng = np.random.default_rng(6)
    imgs = [Image.fromarray(rng.integers(0, 255, (96, 128, 3), np.uint8)),
            Image.fromarray(np.full((96, 128, 3), 128, np.uint8))]
    raw_j, raw_t = jw.inference(imgs), tw.inference(imgs)
    for key in ("original_xyxy_boxes", "scores"):
        assert raw_t[key].shape == raw_j[key].shape
    np.testing.assert_allclose(raw_t["original_xyxy_boxes"],
                               raw_j["original_xyxy_boxes"], atol=1e-3)
    np.testing.assert_allclose(raw_t["scores"], raw_j["scores"], atol=1e-5)
    # random weights barely tell the images apart; the threshold sits
    # midway between their best scores, far from both against the port's
    # score error
    best = raw_j["scores"][:, 0, 0]
    err = np.abs(raw_t["scores"] - raw_j["scores"]).max()
    assert abs(best[0] - best[1]) > 20 * err
    thr = float(best.mean())
    det_j = jw.filter(raw_j, min_score=thr, nms_value=0.8)
    det_t = tw.filter(raw_t, min_score=thr, nms_value=0.8)
    assert det_t == det_j
    assert sorted(len(r) for r in det_t["original_xyxy_boxes"])[0] == 0
    assert max(len(r) for r in det_t["original_xyxy_boxes"]) > 0


def test_wrapper_batches_two_sizes_in_one_bucket():
    """Two image sizes that share a bucket run as one batch of 2 with
    different valid regions (per-image masks, valid ratios, anchors)."""
    jw = JaxUPNWrapper.random_init(cfg=J_UPN, swin_cfg=J_SWIN, seed=9)
    tw = UPNWrapper.random_init(cfg=CFG, swin_cfg=SWIN, device="cpu")
    tw.model.load_state_dict(
        upn_state_dict_from_jax_params(to_numpy(jw.params), CFG, SWIN),
        strict=True)
    for w in (jw, tw):
        orig = w.transform_image
        w.transform_image = (
            lambda img, orig=orig: orig(img, short_side=64, max_size=120))
    rng = np.random.default_rng(10)
    imgs = [Image.fromarray(rng.integers(0, 255, (96, 128, 3), np.uint8)),
            Image.fromarray(rng.integers(0, 255, (80, 150, 3), np.uint8))]
    preps = [tw.prepare(i) for i in imgs]
    assert {p[0].shape for p in preps} == {(128, 128, 3)}
    assert preps[0][1] != preps[1][1]
    raw_j, raw_t = jw.inference(imgs), tw.inference(imgs)
    np.testing.assert_allclose(raw_t["original_xyxy_boxes"],
                               raw_j["original_xyxy_boxes"], atol=1e-3)
    np.testing.assert_allclose(raw_t["scores"], raw_j["scores"], atol=1e-5)


def test_config_dict_reads_like_jax():
    model = {"num_queries": 300, "transformer_cfg": {
        "num_feature_levels": 4,
        "encoder_cfg": {"num_layers": 3, "encoder_layer_cfg": {
            "d_model": 128, "n_heads": 4, "d_ffn": 512}},
        "decoder_cfg": {"num_layers": 2}},
        "vision_backbone_cfg": {"position_embedding_cfg": {
            "num_pos_feats": 64, "temperatureH": 10}}}
    assert dataclasses.asdict(type(CFG).from_config_dict(model)) == \
        dataclasses.asdict(JaxUPNConfig.from_config_dict(model))


def test_pth_round_trip_both_ways(tmp_path):
    """A port state dict saved as a reference-style .pth loads through the
    JAX UPNWrapper into the same parameters, and back through the port's
    loader into the same state dict."""
    params = to_numpy(init_upn_params(jax.random.PRNGKey(7), J_UPN, J_SWIN))
    sd = upn_state_dict_from_jax_params(params, CFG, SWIN)
    path = tmp_path / "upn.pth"
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}},
               str(path))
    jw = JaxUPNWrapper(str(path), cfg=J_UPN, swin_cfg=J_SWIN,
                       dtype=jnp.float32)
    want, want_def = jax.tree.flatten(params)
    got, got_def = jax.tree.flatten(to_numpy(jw.params))
    assert got_def == want_def
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    tw = UPNWrapper(str(path), cfg=CFG, swin_cfg=SWIN, dtype=torch.float32,
                    device="cpu")
    for k, v in tw.model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


class OptimizerState:
    """An object a training script might pickle beside the weights."""

    def __init__(self, step):
        self.step = step


def _pth_with(tmp_path, seed, **extra):
    """A reference-style .pth of seeded JAX parameters with `extra`
    entries beside `model`; (path, JAX params, port state dict)."""
    params = to_numpy(init_upn_params(jax.random.PRNGKey(seed), J_UPN,
                                      J_SWIN))
    sd = upn_state_dict_from_jax_params(params, CFG, SWIN)
    path = tmp_path / "upn.pth"
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()},
                **extra}, str(path))
    return path, params, sd


def test_pth_with_training_args_loads_in_both(tmp_path):
    """The file DETR-family training scripts save (`model`, an
    argparse.Namespace under `args`, an `epoch`) loads in the JAX package
    and in the port to the same parameters, without trusted=True."""
    path, params, sd = _pth_with(
        tmp_path, 9, args=argparse.Namespace(lr=1e-4, backbone="swin_L",
                                             lr_drop_list=[33, 45]),
        epoch=12)
    jw = JaxUPNWrapper(str(path), cfg=J_UPN, swin_cfg=J_SWIN,
                       dtype=jnp.float32)
    for g, w in zip(jax.tree.leaves(to_numpy(jw.params)),
                    jax.tree.leaves(params)):
        np.testing.assert_array_equal(g, w)
    tw = UPNWrapper(str(path), cfg=CFG, swin_cfg=SWIN, dtype=torch.float32,
                    device="cpu")
    for k, v in tw.model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


def test_pth_with_other_objects_needs_trust(tmp_path):
    """Any other pickled object raises an UnpicklingError that names it,
    unless the caller passes trusted=True (then it loads as in JAX)."""
    path, _, sd = _pth_with(tmp_path, 10, optimizer=OptimizerState(3))
    with pytest.raises(pickle.UnpicklingError, match="OptimizerState"):
        UPNWrapper(str(path), cfg=CFG, swin_cfg=SWIN, dtype=torch.float32,
                   device="cpu")
    tw = UPNWrapper(str(path), cfg=CFG, swin_cfg=SWIN, dtype=torch.float32,
                    device="cpu", trusted=True)
    for k, v in tw.model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


def test_pth_missing_key_raises(tmp_path):
    params = to_numpy(init_upn_params(jax.random.PRNGKey(8), J_UPN, J_SWIN))
    sd = upn_state_dict_from_jax_params(params, CFG, SWIN)
    sd["transformer.level_embeds"] = sd.pop("transformer.level_embed")
    path = tmp_path / "bad.pth"
    torch.save({"model": sd}, str(path))
    with pytest.raises(KeyError):
        UPNWrapper(str(path), cfg=CFG, swin_cfg=SWIN, dtype=torch.float32,
                   device="cpu")


def test_random_init_is_seeded_and_complete():
    a = UPNWrapper.random_init(CFG, SWIN, seed=1, device="cpu").model
    b = UPNWrapper.random_init(CFG, SWIN, seed=1, device="cpu").model
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)
    tr = a.transformer
    assert torch.all(tr.encoder.layers[0].self_attn.sampling_offsets.weight
                     == 0)
    assert torch.all(a.bbox_embed[0].layers[-1].weight == 0)


def test_configs_match_jax():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(J_UPN)
    assert port_config(JaxUPNConfig()) == type(CFG)()
    assert port_config(JaxSwinConfig()) == type(SWIN)()


def test_cuda_device_is_never_guessed():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError):
        UPN(CFG, SWIN)
