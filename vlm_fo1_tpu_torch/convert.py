"""Weight bridge: the JAX package's parameter tree (as numpy) -> the port's
state dict.

The port's tower state dicts use the released checkpoint's names and
layouts, so loading a checkpoint is a prefix strip per tower:

  vision_tower.*      <- model.vision_tower.image_tower.*
  vision_tower_aux.*  <- model.vision_tower_aux.image_tower.*
  text.*              <- model.* (embed_tokens, layers, norm); text.lm_head
                         <- lm_head when untied
  mm_projector(_aux).* <- model.mm_projector(_aux).*
  object_vp_extractor.* <- model.object_vp_extractor.* (the HFRE's region
                         LayerNorms; its SimpleFPN under the JAX tree's
                         names)

From the JAX tree this unstacks the ViT's {"window": [G, W, ...],
"full": [G, ...]} scan layout and the trunk's [L, ...] stack, transposes
[in, out] linears back to [out, in], and reshapes the ViT patch embedding
back to the checkpoint's [D, C, T, ph, pw].

Quantized trees (`vlm_fo1_tpu.quant`) bridge too, into a port model
quantized to the same mode (`quant.quantize_model`): int8 `w_q` (transposed),
packed int4 `w_q4`, scales, the `a8` marker, the `fused_int4` MLP node and a
row-int8 `embed_tokens` move byte for byte; nothing is quantized again.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from vlm_fo1_tpu_torch.config import DaViTConfig, FO1Config, TextConfig, ViTConfig


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _take(tree, *idx):
    """Index every leaf of a stacked pytree."""
    if isinstance(tree, dict):
        return {k: _take(v, *idx) for k, v in tree.items()}
    return np.asarray(tree)[idx]


def _key(name, leaf):
    return f"{name}.{leaf}" if name else leaf


def _linear(sd, name, p):
    """A linear node: full precision {"w" [in, out]}, int8 {"w_q" [in, out],
    "scale", "a8"?} or int4 {"w_q4" [in/2, out], "scale"}, each with an
    optional bias. int8 weights are transposed to the port's [out, in];
    packed int4 bytes and scales move as they are."""
    if "w" in p:
        sd[_key(name, "weight")] = _t(np.asarray(p["w"]).T)
    elif "w_q" in p:
        sd[_key(name, "w_q")] = _t(np.asarray(p["w_q"]).T)
    else:
        sd[_key(name, "w_q4")] = _t(p["w_q4"])
    for leaf, key in (("scale", "scale"), ("a8", "a8"), ("b", "bias")):
        if leaf in p:
            sd[_key(name, key)] = _t(p[leaf])


def _norm(sd, name, p):
    sd[f"{name}.weight"] = _t(p["scale"])
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _conv(sd, name, p):
    sd[f"{name}.weight"] = _t(p["w"])
    if "b" in p:
        sd[f"{name}.bias"] = _t(p["b"])


def vit_state_dict(p: dict, cfg: ViTConfig) -> dict:
    g = len(cfg.fullatt_block_indexes)
    period = cfg.depth // g
    sd = {}
    w = np.asarray(p["patch_embed"]["proj"]["w"])           # [patch_dim, D]
    sd["patch_embed.proj.weight"] = _t(w.T.reshape(
        cfg.hidden_size, cfg.in_channels, cfg.temporal_patch_size,
        cfg.patch_size, cfg.patch_size))
    for i in range(cfg.depth):
        gi, wi = divmod(i, period)
        blk = (_take(p["blocks"]["full"], gi) if wi == period - 1
               else _take(p["blocks"]["window"], gi, wi))
        b = f"blocks.{i}"
        _norm(sd, f"{b}.norm1", blk["norm1"])
        _norm(sd, f"{b}.norm2", blk["norm2"])
        _linear(sd, f"{b}.attn.qkv", blk["attn"]["qkv"])
        _linear(sd, f"{b}.attn.proj", blk["attn"]["proj"])
        for name in ("gate_proj", "up_proj", "down_proj"):
            _linear(sd, f"{b}.mlp.{name}", blk["mlp"][name])
    _norm(sd, "merger.ln_q", p["merger"]["ln_q"])
    _linear(sd, "merger.mlp.0", p["merger"]["fc1"])
    _linear(sd, "merger.mlp.2", p["merger"]["fc2"])
    return sd


def text_state_dict(p: dict, cfg: TextConfig) -> dict:
    emb = p["embed_tokens"]
    if "w_q" in emb:  # row-int8 table
        sd = {"embed_tokens.w_q": _t(emb["w_q"]),
              "embed_tokens.scale": _t(emb["scale"])}
    else:
        sd = {"embed_tokens.weight": _t(emb["w"])}
    for i in range(cfg.num_hidden_layers):
        lp = _take(p["layers"], i)
        b = f"layers.{i}"
        _norm(sd, f"{b}.input_layernorm", lp["input_layernorm"])
        _norm(sd, f"{b}.post_attention_layernorm",
              lp["post_attention_layernorm"])
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _linear(sd, f"{b}.self_attn.{name}", lp["attn"][name])
        if "fused_int4" in lp["mlp"]:  # the int4-mlp mode's fused node
            for k, v in lp["mlp"]["fused_int4"].items():
                sd[f"{b}.mlp.{k}"] = _t(v)
            continue
        for name in ("gate_proj", "up_proj", "down_proj"):
            _linear(sd, f"{b}.mlp.{name}", lp["mlp"][name])
    _norm(sd, "norm", p["norm"])
    if "lm_head" in p:
        _linear(sd, "lm_head", p["lm_head"])
    return sd


def davit_state_dict(p: dict, cfg: DaViTConfig) -> dict:
    sd = {}
    for i, stage in enumerate(p["stages"]):
        _conv(sd, f"convs.{i}.proj", stage["conv"]["proj"])
        _norm(sd, f"convs.{i}.norm", stage["conv"]["norm"])
        for j, blk in enumerate(stage["blocks"]):
            for kind, attn_name in (("spatial", "window_attn"),
                                    ("channel", "channel_attn")):
                bp = blk[kind]
                b = f"blocks.{i}.{j}.{kind}_block"
                _conv(sd, f"{b}.conv1.fn.dw", bp["conv1"]["dw"])
                _conv(sd, f"{b}.conv2.fn.dw", bp["conv2"]["dw"])
                _norm(sd, f"{b}.{attn_name}.norm", bp["attn"]["norm"])
                _linear(sd, f"{b}.{attn_name}.fn.qkv", bp["attn"]["qkv"])
                _linear(sd, f"{b}.{attn_name}.fn.proj", bp["attn"]["proj"])
                _norm(sd, f"{b}.ffn.norm", bp["ffn"]["norm"])
                _linear(sd, f"{b}.ffn.fn.net.fc1", bp["ffn"]["fc1"])
                _linear(sd, f"{b}.ffn.fn.net.fc2", bp["ffn"]["fc2"])
    return sd


def projector_state_dict(p: dict, projector_type: str) -> dict:
    if projector_type == "identity":
        return {}
    sd = {}
    if projector_type == "linear":
        _linear(sd, "", p["layers"][0])
        return sd
    if projector_type == "cabstract":
        return _cabstractor_state_dict(p)
    if projector_type == "tokenpacker":
        return _tokenpacker_state_dict(p)
    if not re.match(r"^mlp(\d+)x_gelu$", projector_type):
        raise ValueError(f"unknown projector type: {projector_type}")
    for k, lp in enumerate(p["layers"]):
        _linear(sd, str(2 * k), lp)
    return sd


def _cabstractor_state_dict(p: dict) -> dict:
    """The JAX CAbstractor tree -> the reference names the JAX
    `_convert_cabstractor` reads: `net.{0,2}.b{i}.{conv1,conv2,conv3,
    downsample}.{conv,bn}`, `se.fc{1,2}`, `readout.{0,2,...}`, `pos_emb`,
    `prenorm`."""
    sd = {}
    for net, blocks in ((0, p["s1"]), (2, p["s2"])):
        for i, blk in enumerate(blocks):
            b = f"net.{net}.b{i + 1}"
            for conv, norm, name in (("conv1", "norm1", "conv1"),
                                     ("conv2", "norm2", "conv2"),
                                     ("conv3", "norm3", "conv3"),
                                     ("down", "down_norm", "downsample")):
                if conv in blk:
                    _conv(sd, f"{b}.{name}.conv", blk[conv])
                    _norm(sd, f"{b}.{name}.bn", blk[norm])
            _conv(sd, f"{b}.se.fc1", blk["se_fc1"])
            _conv(sd, f"{b}.se.fc2", blk["se_fc2"])
    for k, lp in enumerate(p["readout"]):
        _linear(sd, f"readout.{2 * k}", lp)
    if "pos_emb" in p:
        sd["pos_emb"] = _t(p["pos_emb"])
    if "prenorm" in p:
        _norm(sd, "prenorm", p["prenorm"])
    return sd


def _tokenpacker_state_dict(p: dict) -> dict:
    """The JAX TokenPacker tree -> the reference names the JAX
    `_convert_tokenpacker` reads, with torch MultiheadAttention's packed
    `in_proj_weight` [3E, E] and `in_proj_bias`."""
    sd = {}
    _linear(sd, "q_proj_1", p["q_proj"])
    for name, layers in (("k_proj_1", p["k_proj"]), ("v_proj_1", p["v_proj"]),
                         ("mlp", p["mlp"])):
        _linear(sd, f"{name}.0", layers[0])
        _linear(sd, f"{name}.2", layers[1])
    for name in ("ln_q", "ln_k", "ln_v"):
        _norm(sd, f"{name}_1", p[name])
    a = p["attn"]
    sd["clip_attn.in_proj_weight"] = _t(np.concatenate(
        [np.asarray(a[n]["w"]).T for n in ("in_q", "in_k", "in_v")]))
    sd["clip_attn.in_proj_bias"] = _t(np.concatenate(
        [np.asarray(a[n]["b"]) for n in ("in_q", "in_k", "in_v")]))
    _linear(sd, "clip_attn.out_proj", a["out"])
    return sd


def hfre_state_dict(p: dict) -> dict:
    """The JAX HFRE tree (region LayerNorms, SimpleFPN) -> the port's
    `HFRE` state dict."""
    sd = {}
    for name in ("aux_region_norm", "vt_region_norm"):
        if name in p:
            _norm(sd, name, p[name])
    for level, lp in p.get("simple_fpn", {}).items():
        for name, node in lp.items():
            if "scale" in node:
                _norm(sd, f"simple_fpn.{level}.{name}", node)
            else:
                _conv(sd, f"simple_fpn.{level}.{name}", node)
    return sd


def state_dict_from_jax_params(params_np: dict, cfg: FO1Config) -> dict:
    """The whole FO1 tree (`vlm_fo1_tpu.models.fo1.FO1Model.params`, leaves
    as numpy) -> `vlm_fo1_tpu_torch.models.fo1.FO1Model` state dict."""
    parts = {
        "vision_tower": vit_state_dict(params_np["vision_tower"], cfg.vision),
        "vision_tower_aux": davit_state_dict(params_np["vision_tower_aux"],
                                             cfg.davit),
        "text": text_state_dict(params_np["text"], cfg.text),
        "mm_projector": projector_state_dict(params_np["mm_projector"],
                                             cfg.mm_projector_type),
        "mm_projector_aux": projector_state_dict(
            params_np["mm_projector_aux"], cfg.mm_projector_aux_type),
        "object_vp_extractor": hfre_state_dict(params_np.get("hfre", {})),
    }
    return {f"{prefix}.{k}": v for prefix, sd in parts.items()
            for k, v in sd.items()}
