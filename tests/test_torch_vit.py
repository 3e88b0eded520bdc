"""PyTorch ViT vs JAX `vit_forward` + `captures_to_feature_map` on the tiny
config, f32 on the CPU, weights bridged by `convert.vit_state_dict`."""

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
from vlm_fo1_tpu.models.vit import (
    captures_to_feature_map as jax_feature_map,
    init_vit_params,
    vit_forward,
)
from vlm_fo1_tpu.preprocess.windowing import build_vit_plan
from vlm_fo1_tpu_torch.convert import vit_state_dict
from vlm_fo1_tpu_torch.models.vit import (
    VisionTransformer,
    captures_to_feature_map,
)

ATOL = 1e-4  # f32 through 4 blocks, different summation order
JCFG = FO1Config.tiny().vision
CFG = port_config(JCFG)


@pytest.fixture(scope="module")
def towers():
    params = init_vit_params(jax.random.PRNGKey(0), JCFG)
    vit = VisionTransformer(CFG)
    vit.load_state_dict(vit_state_dict(to_numpy(params), CFG), strict=True)
    return params, vit


# (12, 20): windows with padded slots; (8, 8): one full window
@pytest.mark.parametrize("grid", [(1, 12, 20), (1, 8, 8)])
def test_tokens_captures_and_feature_map(towers, grid):
    params, vit = towers
    plan = build_vit_plan(grid, JCFG)
    rng = np.random.default_rng(0)
    patches = rand(rng, 1, plan.seq_pad, CFG.patch_dim)
    tok_j, cap_j = vit_forward(
        params, JCFG, jnp.asarray(patches), jnp.asarray(plan.rot_cos),
        jnp.asarray(plan.rot_sin), jnp.asarray(plan.valid),
        num_windows=plan.num_windows,
        inv_unit_idx=jnp.asarray(plan.inv_unit_idx))
    map_j = jax_feature_map(cap_j, jnp.asarray(plan.inv_token_idx), grid)
    with torch.no_grad():
        tok_t, cap_t = vit(
            torch.from_numpy(patches), torch.from_numpy(plan.rot_cos),
            torch.from_numpy(plan.rot_sin), torch.from_numpy(plan.valid),
            num_windows=plan.num_windows,
            inv_unit_idx=torch.from_numpy(plan.inv_unit_idx).long())
        map_t = captures_to_feature_map(
            cap_t, torch.from_numpy(plan.inv_token_idx).long(), grid)
    np.testing.assert_allclose(tok_t.numpy(), np.asarray(tok_j), atol=ATOL)
    assert len(cap_t) == len(CFG.fullatt_block_indexes)
    valid = plan.valid  # pad rows are unspecified on both sides
    for g, c in enumerate(cap_t):
        np.testing.assert_allclose(c.numpy()[:, valid],
                                   np.asarray(cap_j[g])[:, valid], atol=ATOL)
    np.testing.assert_allclose(map_t.numpy(), np.asarray(map_j), atol=ATOL)
    assert map_t.shape == (1, grid[1], grid[2],
                           len(cap_t) * CFG.hidden_size)
