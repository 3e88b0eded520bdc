"""Every HFRE variant, the SimpleFPN and the CAbstractor / TokenPacker
projectors of the port vs the JAX functions with the same parameters, f32
on the CPU to 1e-4 (different summation order). Parameters are drawn from
numpy; the projectors' reach JAX through its own `convert_projector_params`
(the reference names, which the port's modules carry) and the port's
converters (`convert.hfre_state_dict`, `projector_state_dict`) are held to
give the same state dicts back. The released-checkpoint loader
reads `model.object_vp_extractor.{aux,vt}_region_norm.*` as the JAX
`from_pretrained` does, applying a norm only where the checkpoint holds
it."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlm_fo1_tpu.config as jax_config
import vlm_fo1_tpu_torch.config as port_config_mod
from conftest import StubTokenizer
from torch_parity import (  # noqa: F401
    jax_hfre_params,
    one_torch_thread,
    port_config,
    rand,
    to_numpy,
)
from vlm_fo1_tpu.config import HFREConfig
from vlm_fo1_tpu.models import hfre as jh
from vlm_fo1_tpu.models.fo1 import FO1Model as JaxFO1Model
from vlm_fo1_tpu.models.projector import (
    convert_projector_params,
    init_projector_params,
    projector_forward,
)
from vlm_fo1_tpu.models.simple_fpn import simple_fpn_forward
from vlm_fo1_tpu_torch import nn as tnn
from vlm_fo1_tpu_torch.checkpoint import fit_region_norms, port_state_dict
from vlm_fo1_tpu_torch.convert import hfre_state_dict, projector_state_dict
from vlm_fo1_tpu_torch.models import hfre as th
from vlm_fo1_tpu_torch.models.fo1 import FO1Model
from vlm_fo1_tpu_torch.models.projector import build_projector
from vlm_fo1_tpu_torch.models.simple_fpn import SimpleFPN
from vlm_fo1_tpu_torch.training.checkpointing import save_params_safetensors

ATOL = 1e-4
AUX_DIMS = (4, 12)          # two aux levels: 24x24 and 12x12
AUX_BOXES = np.array([[3.0, 5.0, 60.0, 41.0], [0.0, 0.0, 96.0, 96.0],
                      [40.5, 10.25, 44.0, 90.0], [7.0, 30.0, 80.0, 31.0]],
                     np.float32)
VT_BOXES = AUX_BOXES * np.array([168 / 96, 140 / 96] * 2, np.float32)


def _cfg(vt_dim=32, **kw):
    """A small HFRE config: aux 4 + 12 channels, vt_dim ViT channels."""
    concat = kw.get("region_feature_combination", "concat") \
        .startswith("concat")
    out = sum(AUX_DIMS) + vt_dim if concat else vt_dim
    if not kw.get("use_vision_tower_region_feature", True):
        out = sum(AUX_DIMS)
    if kw.get("use_vt_region_feature_only"):
        out = vt_dim
    base = dict(roi_output_size=7, region_feature_dim=out,
                vt_region_feature_dim=vt_dim, vt_spatial_scale=1.0 / 14,
                aux_region_feature_dims=AUX_DIMS, aux_spatial_scale=0.25)
    return HFREConfig(**{**base, **kw})


def _inputs(seed, vt_channels):
    rng = np.random.default_rng(seed)
    aux = [rand(rng, 24, 24, AUX_DIMS[0]), rand(rng, 12, 12, AUX_DIMS[1])]
    return aux, rand(rng, 10, 12, vt_channels)


def _filled(module, seed):
    """A port module with every parameter drawn from numpy: norm weights
    near 1, everything else N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for mod in module.modules():
            for name, p in mod.named_parameters(recurse=False):
                x = 0.1 * rng.standard_normal(tuple(p.shape))
                if isinstance(mod, tnn.LayerNorm) and name == "weight":
                    x += 1.0
                p.copy_(torch.from_numpy(x.astype(np.float32)))
    return module


def _np_sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _ln(rng, n):
    return {"scale": (1 + 0.1 * rng.standard_normal(n)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(n)).astype(np.float32)}


COMBOS = ["concat", "concat_aux_pos", "mean", "mean_aux_pos",
          "concat_sep_pos", "mean_sep_pos", "concat_sep_no_vt_pos",
          "mean_sep_no_vt_pos"]
VARIANTS = {f"combination_{c}": dict(region_feature_combination=c,
                                     vt_dim=16 if c.startswith("mean")
                                     else 32)
            for c in COMBOS}
VARIANTS.update({
    "no_position_embedding": dict(apply_position_embedding=False),
    "feature_map_pos": dict(pos_embedding_strategy="feature_map_based"),
    "hybrid_pos": dict(pos_embedding_strategy="hybrid"),
    "hybrid_pos_mean_sep": dict(pos_embedding_strategy="hybrid",
                                region_feature_combination="mean_sep_pos",
                                vt_dim=16),
    "vt_feature_only": dict(use_vt_region_feature_only=True),
    "aux_only": dict(use_vision_tower_region_feature=False),
    "aux_only_feature_map_pos": dict(use_vision_tower_region_feature=False,
                                     pos_embedding_strategy="hybrid"),
    "region_layer_norms": dict(apply_region_layer_norm=True),
    "region_layer_norms_mean_sep": dict(
        apply_region_layer_norm=True, vt_dim=16,
        region_feature_combination="mean_sep_pos"),
    "simple_fpn": dict(use_simple_fpn_for_vt=True, vt_dim=16,
                       apply_position_embedding=False),
    "simple_fpn_pos_norms": dict(use_simple_fpn_for_vt=True, vt_dim=16,
                                 apply_region_layer_norm=True),
    "adaptive_sampling_off": dict(roi_sampling_ratio=2),
})


def _variant(name):
    kw = dict(VARIANTS[name])
    vt_dim = kw.pop("vt_dim", 32)
    vt_channels = vt_dim
    if kw.get("use_simple_fpn_for_vt"):
        # the pyramid's four levels of out_channels make the vt feature
        vt_channels = 24
    jcfg = _cfg(vt_dim, **kw)
    rng = np.random.default_rng(sorted(VARIANTS).index(name))
    params = {}
    if jcfg.apply_region_layer_norm:
        params["aux_region_norm"] = _ln(rng, sum(AUX_DIMS))
        params["vt_region_norm"] = _ln(rng, vt_dim)
    if jcfg.use_simple_fpn_for_vt:
        fpn = _filled(SimpleFPN(vt_channels, vt_dim // 4), 3)
        params["simple_fpn"] = jax_hfre_params(
            {f"simple_fpn.{k}": v for k, v in _np_sd(fpn).items()}
        )["simple_fpn"]
    return jcfg, params, vt_channels


def _port_hfre(jcfg, params, vt_channels):
    mod = th.HFRE(port_config(jcfg), vt_channels)
    mod.load_state_dict(hfre_state_dict(params), strict=True)
    return mod


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_hfre_variant_matches(name):
    jcfg, params, vt_channels = _variant(name)
    aux, vt_map = _inputs(1, vt_channels)
    ref = jax.jit(jh.hfre_forward, static_argnums=1)(
        jax.tree.map(jnp.asarray, params), jcfg,
        [jnp.asarray(m) for m in aux], jnp.asarray(AUX_BOXES),
        jnp.asarray(vt_map), jnp.asarray(VT_BOXES))
    mod = _port_hfre(jcfg, params, vt_channels)
    with torch.no_grad():
        out = mod([torch.from_numpy(m) for m in aux],
                  torch.from_numpy(AUX_BOXES), torch.from_numpy(vt_map),
                  torch.from_numpy(VT_BOXES))
    assert out.shape == (len(AUX_BOXES), jcfg.region_feature_dim)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("pos", [True, False])
def test_hfre_preconcatenated_aux_map(pos):
    """One [H0, W0, sum C] map (`upsample_concat_aux`) in place of the list
    of levels: pooled as it is, no feature-map position embedding."""
    jcfg = _cfg(apply_position_embedding=pos,
                pos_embedding_strategy="hybrid")
    aux, vt_map = _inputs(2, 32)
    jcat = jh.upsample_concat_aux([jnp.asarray(m)[None] for m in aux])[0]
    tcat = th.upsample_concat_aux([torch.from_numpy(m)[None]
                                   for m in aux])[0]
    np.testing.assert_allclose(tcat.numpy(), np.asarray(jcat), atol=ATOL)
    ref = jh.hfre_forward({}, jcfg, jcat, jnp.asarray(AUX_BOXES),
                          jnp.asarray(vt_map), jnp.asarray(VT_BOXES))
    out = th.hfre_forward(port_config(jcfg), tcat,
                          torch.from_numpy(AUX_BOXES),
                          torch.from_numpy(vt_map),
                          torch.from_numpy(VT_BOXES))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_hfre_non_integer_aux_level():
    """A level whose size does not divide stage 0's is upsampled first."""
    jcfg = dataclasses.replace(_cfg(), aux_region_feature_dims=(4, 12, 8),
                               region_feature_dim=24 + 32)
    rng = np.random.default_rng(5)
    aux = [rand(rng, 24, 24, 4), rand(rng, 12, 12, 12), rand(rng, 9, 7, 8)]
    vt_map = rand(rng, 10, 12, 32)
    ref = jh.hfre_forward({}, jcfg, [jnp.asarray(m) for m in aux],
                          jnp.asarray(AUX_BOXES), jnp.asarray(vt_map),
                          jnp.asarray(VT_BOXES))
    out = th.hfre_forward(port_config(jcfg),
                          [torch.from_numpy(m) for m in aux],
                          torch.from_numpy(AUX_BOXES),
                          torch.from_numpy(vt_map),
                          torch.from_numpy(VT_BOXES))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("hw", [(8, 12), (5, 7), (3, 16)])
def test_position_embedding_2d(hw):
    for dim in (8, 12, 64):
        ref = jh.generate_2d_position_embedding(*hw, dim)
        out = th.generate_2d_position_embedding(*hw, dim)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_unknown_combination_raises():
    jcfg = _cfg(region_feature_combination="max")
    aux, vt_map = _inputs(3, 32)
    args = ([torch.from_numpy(m) for m in aux], torch.from_numpy(AUX_BOXES),
            torch.from_numpy(vt_map), torch.from_numpy(VT_BOXES))
    with pytest.raises(NotImplementedError):
        th.hfre_forward(port_config(jcfg), *args)


def test_simple_fpn_matches():
    """Also the converter both ways: the port's state dict -> the JAX tree
    (`torch_parity.jax_hfre_params`) -> `hfre_state_dict` gives it back."""
    fpn = _filled(SimpleFPN(32, 16), 0)
    sd = {f"simple_fpn.{k}": v for k, v in _np_sd(fpn).items()}
    params = jax_hfre_params(sd)
    back = hfre_state_dict(params)
    assert back.keys() == sd.keys()
    assert all(np.array_equal(back[k].numpy(), v) for k, v in sd.items())
    x = rand(np.random.default_rng(2), 2, 7, 9, 32)
    ref = jax.jit(simple_fpn_forward)(params["simple_fpn"], jnp.asarray(x))
    with torch.no_grad():
        out = fpn(torch.from_numpy(x))
    assert [tuple(o.shape) for o in out] == [
        (2, 28, 36, 16), (2, 14, 18, 16), (2, 7, 9, 16), (2, 3, 4, 16)]
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# ------------------------------------------------------------ projectors
# Parameters are drawn from numpy into the port's module and read by the
# JAX package's own `convert_projector_params` (the reference names); the
# port's converter is held to give the same state dict back.

def _jax_projector(proj, kind):
    sd = _np_sd(proj)
    params = convert_projector_params(sd, kind)
    back = projector_state_dict(params, kind)
    assert back.keys() == sd.keys()
    assert all(np.array_equal(back[k].numpy(), v) for k, v in sd.items())
    return params


@pytest.mark.parametrize("nq,l_in,prenorm", [(4, 16, False), (9, 36, False),
                                             (4, 25, True)])
def test_cabstractor_matches(nq, l_in, prenorm):
    from vlm_fo1_tpu.models.projector import cabstractor_forward
    from vlm_fo1_tpu_torch.models.projector import CAbstractor

    in_dim, out_dim = 12, 20
    proj = _filled(CAbstractor(l_in, in_dim, out_dim, hidden=16, depth=2,
                               num_queries=nq, prenorm=prenorm), nq)
    params = _jax_projector(proj, "cabstract")
    x = rand(np.random.default_rng(nq), 2, l_in, in_dim)
    ref = jax.jit(cabstractor_forward, static_argnames="num_queries")(
        params, jnp.asarray(x), num_queries=nq)
    with torch.no_grad():
        out = proj(torch.from_numpy(x))
    assert out.shape == (2, nq, out_dim)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("raw_grid,sf", [(4, 2), (6, 2), (6, 3)])
def test_tokenpacker_matches(raw_grid, sf):
    from vlm_fo1_tpu.models.projector import tokenpacker_forward

    mm, hid, e, heads = 6, 10, 16, 2
    proj = _filled(build_projector("tokenpacker", mm, hid, embed_dim=e,
                                   num_heads=heads), raw_grid + sf)
    params = _jax_projector(proj, "tokenpacker")
    rng = np.random.default_rng(raw_grid)
    x = rand(rng, 2, raw_grid ** 2, mm)
    xm = rand(rng, 2, raw_grid ** 2, 4 * mm)
    ref = jax.jit(tokenpacker_forward, static_argnames=(
        "raw_grid", "scale_factor", "num_heads"))(
        params, jnp.asarray(x), jnp.asarray(xm), raw_grid=raw_grid,
        scale_factor=sf, num_heads=heads)
    with torch.no_grad():
        out = proj((torch.from_numpy(x), torch.from_numpy(xm)),
                   raw_grid=raw_grid, scale_factor=sf)
    g = raw_grid // sf
    assert out.shape == (2, g * g, hid)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("kind", ["cabstract", "tokenpacker"])
def test_projector_converter_round_trip(kind):
    """A tree of the JAX initialiser's layout (`init_projector_params`,
    the default widths' structure) -> the port's state dict -> the JAX
    `convert_projector_params` gives back the same tree, leaf for leaf,
    and the module of the default options loads it."""
    proj = _filled(build_projector(kind, 8, 12, num_input_tokens=16,
                                   num_queries=4), 9)
    params = _jax_projector(proj, kind)
    init = jax.eval_shape(lambda: init_projector_params(
        jax.random.PRNGKey(9), kind, 8, 12, num_input_tokens=16,
        num_queries=4))
    assert jax.tree.structure(init) == jax.tree.structure(params)
    for got, want in zip(jax.tree.leaves(params), jax.tree.leaves(init)):
        assert got.shape == want.shape


def test_cabstractor_timm_layout_without_conv_biases():
    """A reference-named state dict in timm's layout (no conv biases, SE
    biases) loads into `conv_bias=False` and matches the JAX
    `convert_projector_params` reading of the same dict."""
    proj = _filled(build_projector("cabstract", 8, 12, num_input_tokens=16,
                                   num_queries=4, conv_bias=False), 4)
    assert not any(k.endswith(".conv.bias") for k in proj.state_dict())
    jp = convert_projector_params(_np_sd(proj), "cabstract")
    x = rand(np.random.default_rng(4), 1, 16, 8)
    ref = jax.jit(projector_forward, static_argnums=1, static_argnames=(
        "num_queries",))(jp, "cabstract", jnp.asarray(x), num_queries=4)
    with torch.no_grad():
        out = proj(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


# ---------------------------------------------------------- the loader

TINY = jax_config.FO1Config.tiny()
JCFG = dataclasses.replace(
    TINY, text=dataclasses.replace(TINY.text, tie_word_embeddings=False),
    hfre=dataclasses.replace(TINY.hfre, apply_region_layer_norm=True))
CFG = port_config(JCFG)
RELEASE = (("vision_tower_aux.", "model.vision_tower_aux.image_tower."),
           ("vision_tower.", "model.vision_tower.image_tower."),
           ("mm_projector_aux.", "model.mm_projector_aux."),
           ("mm_projector.", "model.mm_projector."),
           ("object_vp_extractor.", "model.object_vp_extractor."),
           ("text.lm_head.", "lm_head."),
           ("text.", "model."))


def _release_name(name):
    return next(r + name[len(p):] for p, r in RELEASE if name.startswith(p))


def _write_checkpoint(d, sd, cfg):
    flat = {_release_name(k): v for k, v in sd.items()}
    save_params_safetensors(str(d / "model-00001-of-00001.safetensors"),
                            flat)
    v, t = cfg.vision, cfg.text
    (d / "config.json").write_text(json.dumps({
        "vision_config": {k: (list(x) if isinstance(x, tuple) else x)
                          for k, x in dataclasses.asdict(v).items()},
        "vocab_size": t.vocab_size, "hidden_size": t.hidden_size,
        "intermediate_size": t.intermediate_size,
        "num_hidden_layers": t.num_hidden_layers,
        "num_attention_heads": t.num_attention_heads,
        "num_key_value_heads": t.num_key_value_heads,
        "tie_word_embeddings": t.tie_word_embeddings, "head_dim": t.head_dim,
        "rope_scaling": {"type": "mrope",
                         "mrope_section": list(t.mrope_section)},
        "mm_hidden_size": cfg.mm_hidden_size,
        "mm_region_hidden_size": cfg.mm_region_hidden_size,
        "aux_image_size": cfg.aux_image_size,
        "mm_apply_region_layer_norm": True,
    }))


@pytest.fixture
def tiny_towers(monkeypatch):
    """The release's config.json names no DaViT; swap in the tiny DaViT
    and HFRE widths after parsing, keeping the parsed LayerNorm flag."""
    for mod in (jax_config, port_config_mod):
        parse = mod.FO1Config.from_hf_config
        tiny = mod.FO1Config.tiny()

        def wrapped(c, parse=parse, tiny=tiny):
            cfg = parse(c)
            return dataclasses.replace(cfg, davit=tiny.davit,
                                       hfre=dataclasses.replace(
                                           tiny.hfre,
                                           apply_region_layer_norm=cfg.hfre
                                           .apply_region_layer_norm))
        monkeypatch.setattr(mod.FO1Config, "from_hf_config",
                            staticmethod(wrapped))


@pytest.mark.parametrize("with_norms", [True, False])
def test_loader_region_norms_match_jax(tmp_path, tiny_towers, with_norms):
    model = FO1Model.random_init(CFG, seed=3, device="cpu")
    sd = model.state_dict()
    rng = np.random.default_rng(8)
    for k in list(sd):
        if "region_norm" in k:
            sd[k] = sd[k] + torch.from_numpy(
                0.2 * rng.standard_normal(sd[k].shape).astype(np.float32))
            if not with_norms:
                del sd[k]
    _write_checkpoint(tmp_path, sd, JCFG)
    tm = FO1Model.from_pretrained(str(tmp_path), dtype=torch.float32,
                                  device="cpu", tokenizer=StubTokenizer())
    jm = JaxFO1Model.from_pretrained(str(tmp_path), dtype=jnp.float32,
                                     tokenizer=StubTokenizer())
    assert tm.cfg.hfre.apply_region_layer_norm
    assert sorted(jm.params["hfre"]) == (
        ["aux_region_norm", "vt_region_norm"] if with_norms else [])
    assert (tm.object_vp_extractor.aux_region_norm is None) != with_norms
    rng = np.random.default_rng(1)
    from PIL import Image

    img = Image.fromarray(rng.integers(0, 255, (80, 96, 3), np.uint8))
    msgs = [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": img}},
        {"type": "text", "text": "detect things"}],
        "bbox_list": [[2.0, 2.0, 50.0, 60.0], [10.0, 5.0, 70.0, 40.0]]}]
    _, want, *_ = jm.encode(jm.prepare(msgs))
    _, got = tm.encode(tm.prepare(msgs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_fit_region_norms_drops_unapplied_keys():
    """A checkpoint's norms that the config does not apply are dropped, as
    the JAX forward ignores them."""
    model = FO1Model(port_config(TINY), device="cpu")
    sd = {"object_vp_extractor.vt_region_norm.weight": torch.ones(3),
          "text.norm.weight": torch.ones(3)}
    assert list(fit_region_norms(model, sd)) == ["text.norm.weight"]
    assert port_state_dict(
        {"model.object_vp_extractor.aux_region_norm.bias": 0}) == \
        {"object_vp_extractor.aux_region_norm.bias": 0}
