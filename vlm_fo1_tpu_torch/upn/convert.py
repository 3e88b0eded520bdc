"""Weight bridge for UPN: the JAX package's UPN tree (numpy leaves) -> the
port's state dict, whose keys are the reference checkpoint's (the keys that
`vlm_fo1_tpu/upn/convert.py` reads). Linears go back to [out, in]; the
`sampling_offsets` columns and bias go back from the JAX package's
level-major lane order (level, head, point, coord) to the reference's
head-major order (head, level, point, coord).
"""

from __future__ import annotations

import numpy as np
import torch

from vlm_fo1_tpu_torch.upn.model import UPNConfig
from vlm_fo1_tpu_torch.upn.swin import SwinConfig

_SWIN = "backbone.model.backbone"


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _linear(sd, name, p):
    sd[f"{name}.weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        sd[f"{name}.bias"] = _t(p["b"])


def _norm(sd, name, p):
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _mlp(sd, name, p):
    for j, lp in enumerate(p["layers"]):
        _linear(sd, f"{name}.layers.{j}", lp)


def head_major_order(n_heads: int, n_levels: int, n_points: int):
    """Index array that takes level-major (l, m, p, c) lanes to head-major
    (m, l, p, c) lanes: head_major = level_major[..., order]."""
    lanes = np.arange(n_levels * n_heads * n_points * 2).reshape(
        n_levels, n_heads, n_points, 2)
    return lanes.transpose(1, 0, 2, 3).reshape(-1)


def msda_state_dict(p: dict, n_heads: int, n_levels: int,
                    n_points: int) -> dict:
    """One JAX `msda_layer` tree -> `ops.msda.MSDeformAttn` state dict."""
    order = head_major_order(n_heads, n_levels, n_points)
    sd = {}
    so = p["sampling_offsets"]
    sd["sampling_offsets.weight"] = _t(np.asarray(so["w"])[:, order].T)
    sd["sampling_offsets.bias"] = _t(np.asarray(so["b"])[order])
    for name in ("attention_weights", "value_proj", "output_proj"):
        _linear(sd, name, p[name])
    return sd


def swin_state_dict(p: dict, cfg: SwinConfig) -> dict:
    sd = {"patch_embed.proj.weight": _t(p["patch_embed"]["proj"]["w"]),
          "patch_embed.proj.bias": _t(p["patch_embed"]["proj"]["b"])}
    _norm(sd, "patch_embed.norm", p["patch_embed"]["norm"])
    for i, stage in enumerate(p["stages"]):
        for j, blk in enumerate(stage["blocks"]):
            b = f"layers.{i}.blocks.{j}"
            _norm(sd, f"{b}.norm1", blk["norm1"])
            _norm(sd, f"{b}.norm2", blk["norm2"])
            _linear(sd, f"{b}.attn.qkv", blk["attn"]["qkv"])
            _linear(sd, f"{b}.attn.proj", blk["attn"]["proj"])
            sd[f"{b}.attn.relative_position_bias_table"] = _t(
                blk["attn"]["rel_bias"])
            _linear(sd, f"{b}.mlp.fc1", blk["mlp"]["fc1"])
            _linear(sd, f"{b}.mlp.fc2", blk["mlp"]["fc2"])
        if "downsample" in stage:
            _norm(sd, f"layers.{i}.downsample.norm",
                  stage["downsample"]["norm"])
            _linear(sd, f"layers.{i}.downsample.reduction",
                    stage["downsample"]["reduction"])
    for i in cfg.out_indices:
        _norm(sd, f"norm{i}", p["out_norms"][str(i)])
    return sd


def upn_state_dict_from_jax_params(params_np: dict, cfg: UPNConfig,
                                   swin_cfg: SwinConfig) -> dict:
    """The whole JAX UPN tree (`init_upn_params` / `load_upn_checkpoint`,
    leaves as numpy) -> `upn.model.UPN` state dict."""
    sd = {f"{_SWIN}.{k}": v for k, v in
          swin_state_dict(params_np["backbone"], swin_cfg).items()}
    for lvl, proj in enumerate(params_np["input_proj"]):
        sd[f"input_proj.{lvl}.0.weight"] = _t(proj["conv"]["w"])
        sd[f"input_proj.{lvl}.0.bias"] = _t(proj["conv"]["b"])
        _norm(sd, f"input_proj.{lvl}.1", proj["gn"])
    sd["transformer.level_embed"] = _t(params_np["level_embed"])
    msda = (cfg.n_heads, cfg.num_feature_levels, cfg.n_points)
    for i, enc in enumerate(params_np["encoder"]):
        p = f"transformer.encoder.layers.{i}"
        for k, v in msda_state_dict(enc["self_attn"], *msda).items():
            sd[f"{p}.self_attn.{k}"] = v
        _norm(sd, f"{p}.norm1", enc["norm1"])
        _linear(sd, f"{p}.linear1", enc["linear1"])
        _linear(sd, f"{p}.linear2", enc["linear2"])
        _norm(sd, f"{p}.norm2", enc["norm2"])
    dec_tree = params_np["decoder"]
    for i, dec in enumerate(dec_tree["layers"]):
        p = f"transformer.decoder.layers.{i}"
        for k, v in msda_state_dict(dec["cross_attn"], *msda).items():
            sd[f"{p}.cross_attn.{k}"] = v
        _norm(sd, f"{p}.norm1", dec["norm1"])
        sa = dec["self_attn"]
        sd[f"{p}.self_attn.in_proj_weight"] = _t(
            np.asarray(sa["in_proj"]["w"]).T)
        sd[f"{p}.self_attn.in_proj_bias"] = _t(sa["in_proj"]["b"])
        _linear(sd, f"{p}.self_attn.out_proj", sa["out_proj"])
        _norm(sd, f"{p}.norm2", dec["norm2"])
        _linear(sd, f"{p}.linear1", dec["linear1"])
        _linear(sd, f"{p}.linear2", dec["linear2"])
        _norm(sd, f"{p}.norm3", dec["norm3"])
    _norm(sd, "transformer.decoder.norm", dec_tree["norm"])
    _mlp(sd, "transformer.decoder.ref_point_head", dec_tree["ref_point_head"])
    sd["transformer.tgt_embed.weight"] = _t(params_np["tgt_embed"])
    _linear(sd, "transformer.enc_output", params_np["enc_output"])
    _norm(sd, "transformer.enc_output_norm", params_np["enc_output_norm"])
    _mlp(sd, "transformer.enc_out_bbox_embed",
         params_np["enc_out_bbox_embed"])
    _mlp(sd, "bbox_embed.0", params_np["bbox_embed"])
    for name in ("fine_grained_prompt", "coarse_grained_prompt"):
        sd[f"transformer.{name}.weight"] = _t(params_np[name])
    return sd
