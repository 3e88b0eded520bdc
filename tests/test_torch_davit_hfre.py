"""PyTorch DaViT, pooled ROIAlign, HFRE and projector vs the JAX modules on
tiny shapes, f32 on the CPU (atol 1e-4: f32, different summation order).
The `cuda` test holds the ROIAlign to the same bits on every call on the
card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (  # noqa: F401
    one_torch_thread,
    port_config,
    rand,
    to_numpy,
)
from vlm_fo1_tpu.config import FO1Config
from vlm_fo1_tpu.models.davit import davit_forward, init_davit_params
from vlm_fo1_tpu.models.hfre import hfre_forward as jax_hfre
from vlm_fo1_tpu.models.projector import (
    init_projector_params,
    projector_forward,
)
from vlm_fo1_tpu.ops.roi_align import (
    roi_align_mean_separable as jax_roi_align,
)
from vlm_fo1_tpu_torch.convert import davit_state_dict, projector_state_dict
from vlm_fo1_tpu_torch.models.davit import DaViT
from vlm_fo1_tpu_torch.models.hfre import hfre_forward
from vlm_fo1_tpu_torch.models.projector import build_projector
from vlm_fo1_tpu_torch.ops.roi_align import roi_align_mean_separable

ATOL = 1e-4
JCFG = FO1Config.tiny()
CFG = port_config(JCFG)
BOXES = np.array([[3.0, 5.0, 60.0, 41.0], [0.0, 0.0, 96.0, 96.0],
                  [40.5, 10.25, 44.0, 90.0], [0.0, 10.0, 0.0, 10.0]],
                 np.float32)


def test_davit_stage_maps():
    params = init_davit_params(jax.random.PRNGKey(2), JCFG.davit)
    model = DaViT(CFG.davit)
    model.load_state_dict(davit_state_dict(to_numpy(params), CFG.davit),
                          strict=True)
    img = rand(np.random.default_rng(0), 1, 96, 96, 3)
    ref = jax.jit(davit_forward, static_argnums=1)(params, JCFG.davit,
                                                   jnp.asarray(img))
    with torch.no_grad():
        out = model(torch.from_numpy(img))
    assert [tuple(m.shape) for m in out] == [m.shape for m in ref]
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("ratio,upsample", [(-1, 1), (-1, 2), (-1, 4),
                                            (2, 2)])
def test_roi_align_mean_separable(ratio, upsample):
    feat = rand(np.random.default_rng(1), 96 // 4 // upsample,
                96 // 4 // upsample, 8)
    args = (7, 0.25)
    ref = jax_roi_align(jnp.asarray(feat), jnp.asarray(BOXES), *args,
                        sampling_ratio=ratio, upsample=upsample)
    out = roi_align_mean_separable(torch.from_numpy(feat),
                                   torch.from_numpy(BOXES), *args,
                                   sampling_ratio=ratio, upsample=upsample)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_hfre_forward():
    rng = np.random.default_rng(3)
    dims = CFG.davit.embed_dims
    aux_maps = [rand(rng, 24 >> i, 24 >> i, c) for i, c in enumerate(dims)]
    vt_map = rand(rng, 12, 20, CFG.hfre.vt_region_feature_dim)
    vt_boxes = BOXES * np.array([280 / 96, 168 / 96] * 2, np.float32)
    ref = jax_hfre({}, JCFG.hfre, [jnp.asarray(m) for m in aux_maps],
                   jnp.asarray(BOXES), jnp.asarray(vt_map),
                   jnp.asarray(vt_boxes))
    out = hfre_forward(CFG.hfre, [torch.from_numpy(m) for m in aux_maps],
                       torch.from_numpy(BOXES), torch.from_numpy(vt_map),
                       torch.from_numpy(vt_boxes))
    assert out.shape == (len(BOXES), CFG.hfre.region_feature_dim)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_hfre_forward_zero_boxes():
    """A prompt without boxes gives zero region rows, not a crash."""
    rng = np.random.default_rng(3)
    dims = CFG.davit.embed_dims
    aux_maps = [rand(rng, 24 >> i, 24 >> i, c) for i, c in enumerate(dims)]
    vt_map = rand(rng, 12, 20, CFG.hfre.vt_region_feature_dim)
    none = torch.zeros(0, 4)
    out = hfre_forward(CFG.hfre, [torch.from_numpy(m) for m in aux_maps],
                       none, torch.from_numpy(vt_map), none)
    assert out.shape == (0, CFG.hfre.region_feature_dim)
    assert out.dtype == torch.float32


def test_hfre_unported_variants_raise():
    """Every variant of the JAX module is ported (test_torch_hfre_variants
    .py); a combination that neither package knows raises in both."""
    import dataclasses

    rng = np.random.default_rng(3)
    dims = CFG.davit.embed_dims
    aux_maps = [rand(rng, 24 >> i, 24 >> i, c) for i, c in enumerate(dims)]
    vt_map = rand(rng, 12, 20, CFG.hfre.vt_region_feature_dim)
    with pytest.raises(NotImplementedError):
        jax_hfre({}, dataclasses.replace(JCFG.hfre,
                                         region_feature_combination="max"),
                 [jnp.asarray(m) for m in aux_maps], jnp.asarray(BOXES),
                 jnp.asarray(vt_map), jnp.asarray(BOXES))
    cfg = dataclasses.replace(CFG.hfre, region_feature_combination="max")
    with pytest.raises(NotImplementedError):
        hfre_forward(cfg, [torch.from_numpy(m) for m in aux_maps],
                     torch.from_numpy(BOXES), torch.from_numpy(vt_map),
                     torch.from_numpy(BOXES))


@pytest.mark.parametrize("kind", ["mlp2x_gelu", "mlp3x_gelu", "linear",
                                  "identity"])
def test_projector(kind):
    in_dim, out_dim = CFG.mm_region_hidden_size, CFG.text.hidden_size
    if kind == "identity":
        in_dim = out_dim
    params = init_projector_params(jax.random.PRNGKey(4), kind, in_dim,
                                   out_dim)
    proj = build_projector(kind, in_dim, out_dim)
    proj.load_state_dict(projector_state_dict(to_numpy(params), kind),
                         strict=True)
    x = rand(np.random.default_rng(4), 5, in_dim)
    ref = projector_forward(params, kind, jnp.asarray(x))
    with torch.no_grad():
        out = proj(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_unported_projectors_raise():
    """CAbstractor and TokenPacker are ported (test_torch_hfre_variants.py);
    a type that neither package knows raises in both."""
    for kind in ("cabstract", "tokenpacker"):
        assert isinstance(build_projector(kind, 8, 8), torch.nn.Module)
    for kind in ("mlp_gelu", "resampler"):
        with pytest.raises(ValueError):
            init_projector_params(jax.random.PRNGKey(0), kind, 8, 8)
        with pytest.raises(ValueError):
            build_projector(kind, 8, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("upsample", [1, 4])
def test_roi_align_repeats_bit_equal_on_card(upsample):
    """On the card the pooled ROIAlign gives the same bits on every call
    (its tap weights are summed in a fixed order, not by atomics), and
    agrees with the CPU to ATOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    feat = rand(np.random.default_rng(4), 192 // upsample, 192 // upsample,
                64)
    boxes = np.random.default_rng(5).uniform(0, 760, (100, 4)).astype(
        np.float32)
    boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2])
    args = (torch.from_numpy(feat), torch.from_numpy(boxes), 7, 0.25)
    ref = roi_align_mean_separable(*args, upsample=upsample)
    outs = [roi_align_mean_separable(*(a.cuda() for a in args[:2]),
                                     *args[2:], upsample=upsample)
            for _ in range(20)]
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    np.testing.assert_allclose(outs[0].cpu().numpy(), ref.numpy(),
                               atol=ATOL)
