"""The system under test: `vlm_fo1_tpu_torch`, built from a configuration
file and the weights the benchmark drew.

The program gets what a deployment would hand it: a configuration (the
checkpoint's config.json, read by `FO1Config.from_hf_config`), the weights
under the checkpoint's tower names (one `load_state_dict`), a tokenizer,
and its serving mode (`quant.quantize_model`).
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark import weights as bench_weights
from benchmark.yardstick.tokenizer import CharTokenizer


def program_config(cfg: dict):
    """The port's FO1Config for a configuration file: the released
    config.json keys through `from_hf_config`, the DaViT sizes and the
    preprocessing caps from the file's own keys."""
    from vlm_fo1_tpu_torch.config import DaViTConfig, FO1Config

    base = FO1Config.from_hf_config(cfg)
    d = cfg["davit"]
    davit = DaViTConfig(
        depths=tuple(d["depths"]), embed_dims=tuple(d["embed_dims"]),
        num_heads=tuple(d["num_heads"]), num_groups=tuple(d["num_groups"]),
        patch_size=tuple(d["patch_size"]),
        patch_stride=tuple(d["patch_stride"]),
        patch_padding=tuple(d["patch_padding"]),
        patch_prenorm=tuple(d["patch_prenorm"]),
        window_size=d["window_size"], mlp_ratio=d["mlp_ratio"],
        in_channels=d["in_chans"], image_size=d["image_size"])
    v = cfg["vision_config"]
    hfre = dataclasses.replace(
        base.hfre, aux_region_feature_dims=tuple(d["embed_dims"]),
        vt_region_feature_dim=v["hidden_size"]
        * len(v["fullatt_block_indexes"]))
    return dataclasses.replace(
        base, davit=davit, hfre=hfre, min_pixels=cfg["min_pixels"],
        max_pixels=cfg["max_pixels"],
        max_image_long_side=cfg["max_image_long_side"],
        max_regions=cfg["max_regions"])


def dtype_of(cfg: dict):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        cfg["torch_dtype"]]


def build(cfg: dict, seed: int, device):
    """The port's FO1Model on `device` holding the weights drawn from
    `seed`, in the configuration's serving mode."""
    from vlm_fo1_tpu_torch.models.fo1 import FO1Model
    from vlm_fo1_tpu_torch.quant import quantize_model

    dtype = dtype_of(cfg)
    model = FO1Model(program_config(cfg), device=device, dtype=dtype,
                     tokenizer=CharTokenizer())
    drawn = bench_weights.draw(cfg, seed, model.device, dtype)
    model.load_state_dict(drawn, strict=True)
    del drawn
    if cfg["quant"] != "none":
        quantize_model(model, cfg["quant"])
    return model

