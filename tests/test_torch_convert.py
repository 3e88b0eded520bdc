"""Weight bridge: JAX params -> port state dict -> the JAX package's own
checkpoint converters reproduces the JAX params exactly, which shows the
port's parameter names and layouts are the released checkpoint's."""

import jax
import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread, port_config, to_numpy  # noqa: F401
from vlm_fo1_tpu.checkpoint import (
    convert_davit,
    convert_text_model,
    convert_vision_tower,
)
from vlm_fo1_tpu.config import FO1Config
from vlm_fo1_tpu.models.fo1 import FO1Model as JaxFO1Model
from vlm_fo1_tpu.models.projector import convert_projector_params
from vlm_fo1_tpu_torch.convert import state_dict_from_jax_params
from vlm_fo1_tpu_torch.models.fo1 import FO1Model

JCFG = FO1Config.tiny()
CFG = port_config(JCFG)


@pytest.fixture(scope="module")
def bridged():
    params = to_numpy(JaxFO1Model.random_init(JCFG, seed=3).params)
    return params, state_dict_from_jax_params(params, CFG)


def _tower(sd, prefix):
    return {k[len(prefix):]: v.numpy() for k, v in sd.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("which", ["tiny", "released"])
def test_port_config_is_a_copy_of_the_jax_config(which):
    """The port's own FO1Config equals the JAX one field for field, with
    the same defaults and the same `tiny()`."""
    import dataclasses

    from vlm_fo1_tpu_torch.config import FO1Config as PortFO1Config

    jax_cfg = JCFG if which == "tiny" else FO1Config()
    port_cfg = PortFO1Config.tiny() if which == "tiny" else PortFO1Config()
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)
    assert port_config(jax_cfg) == port_cfg


def test_round_trip_through_the_checkpoint_converters(bridged):
    params, sd = bridged
    back = {
        "vision_tower": convert_vision_tower(_tower(sd, "vision_tower."),
                                             JCFG.vision),
        "vision_tower_aux": convert_davit(_tower(sd, "vision_tower_aux."),
                                          JCFG.davit),
        "text": convert_text_model(_tower(sd, "text."), JCFG.text),
        "mm_projector": convert_projector_params(
            _tower(sd, "mm_projector."), JCFG.mm_projector_type),
        "mm_projector_aux": convert_projector_params(
            _tower(sd, "mm_projector_aux."), JCFG.mm_projector_aux_type),
        "hfre": {},
    }
    want, want_def = jax.tree.flatten(params)
    got, got_def = jax.tree.flatten(to_numpy(back))
    assert got_def == want_def
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_bridge_fills_every_port_parameter(bridged):
    _, sd = bridged
    model = FO1Model(CFG, device="cpu")
    model.load_state_dict(sd, strict=True)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == {k: tuple(v.shape) for k, v in sd.items()}


def test_random_init_draws_on_the_device():
    model = FO1Model.random_init(CFG, seed=0, device="cpu")
    again = FO1Model.random_init(CFG, seed=0, device="cpu")
    sd, sd2 = model.state_dict(), again.state_dict()
    for k, v in sd.items():
        torch.testing.assert_close(v, sd2[k], rtol=0, atol=0)
    assert torch.all(sd["text.norm.weight"] == 1)
    assert torch.all(sd["vision_tower.blocks.0.attn.qkv.bias"] == 0)
    std = sd["text.embed_tokens.weight"].std().item()
    assert abs(std - 0.02) < 2e-3


def test_cuda_device_is_never_guessed():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError):
        FO1Model(CFG, device="cuda")
