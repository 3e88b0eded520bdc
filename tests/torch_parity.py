"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
one torch thread per test module (six xdist workers share the CPUs), the
JAX tree -> numpy conversion that feeds the weight bridge, and the JAX
config -> port config rebuild (the port keeps its own copies of the config
dataclasses and never imports the JAX package)."""

import dataclasses
import importlib
import typing

import jax
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _build(cls, values: dict):
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        v = values[f.name]
        if dataclasses.is_dataclass(hints[f.name]):
            v = _build(hints[f.name], v)
        kw[f.name] = v
    return cls(**kw)


def port_config(jax_cfg):
    """The port's dataclass of the same name and module path
    (`vlm_fo1_tpu.X` -> `vlm_fo1_tpu_torch.X`), rebuilt field for field from
    `dataclasses.asdict(jax_cfg)`; raises if the two differ in any field."""
    jax_cls = type(jax_cfg)
    module = importlib.import_module(
        jax_cls.__module__.replace("vlm_fo1_tpu", "vlm_fo1_tpu_torch", 1))
    cfg = _build(getattr(module, jax_cls.__name__),
                 dataclasses.asdict(jax_cfg))
    if dataclasses.asdict(cfg) != dataclasses.asdict(jax_cfg):
        raise AssertionError(f"port config differs: {cfg} vs {jax_cfg}")
    return cfg


def jax_fo1_params(state_dict, jax_cfg):
    """A port FO1 state dict (the checkpoint's names under the port's tower
    prefixes) -> the JAX FO1 parameter tree in f32, through the JAX
    package's own checkpoint converters (the HFRE's parameters through
    `jax_hfre_params`). Much faster than the JAX
    `random_init` for building both sides of a parity test."""
    import jax.numpy as jnp

    from vlm_fo1_tpu.checkpoint import (
        convert_davit,
        convert_text_model,
        convert_vision_tower,
        strip_prefix,
        to_device_tree,
    )
    from vlm_fo1_tpu.models.projector import convert_projector_params

    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    params = {
        "vision_tower": convert_vision_tower(
            strip_prefix(sd, "vision_tower."), jax_cfg.vision),
        "vision_tower_aux": convert_davit(
            strip_prefix(sd, "vision_tower_aux."), jax_cfg.davit),
        "text": convert_text_model(strip_prefix(sd, "text."), jax_cfg.text),
        "mm_projector": convert_projector_params(
            strip_prefix(sd, "mm_projector."), jax_cfg.mm_projector_type),
        "mm_projector_aux": convert_projector_params(
            strip_prefix(sd, "mm_projector_aux."),
            jax_cfg.mm_projector_aux_type),
        "hfre": jax_hfre_params(strip_prefix(sd, "object_vp_extractor.")),
    }
    return to_device_tree(params, jnp.float32)


def jax_hfre_params(sd):
    """A port `HFRE` state dict (numpy) -> the JAX HFRE tree: region
    LayerNorms {"scale", "bias"} and the SimpleFPN's {"w", "b"} convs and
    {"scale", "bias"} norms by level."""
    hfre = {}
    for name in ("aux_region_norm", "vt_region_norm"):
        if f"{name}.weight" in sd:
            hfre[name] = {"scale": sd[f"{name}.weight"],
                          "bias": sd[f"{name}.bias"]}
    fpn = {}
    for key, value in sd.items():
        if key.startswith("simple_fpn."):
            _, level, node, leaf = key.split(".")
            names = ("scale", "bias") if node.endswith("norm") else ("w", "b")
            fpn.setdefault(level, {}).setdefault(node, {})[
                names[leaf == "bias"]] = value
    if fpn:
        hfre["simple_fpn"] = fpn
    return hfre
