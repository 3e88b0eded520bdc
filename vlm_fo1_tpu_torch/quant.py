"""Weight quantization for serving (counterpart of `vlm_fo1_tpu/quant.py`).

The modes, by name (`quantize_model`):

  int8      per-output-channel symmetric int8 trunk linears and an untied
            head (DEFAULT_QUANT_PATTERNS): the reference's `load_8bit`
  int8-all  the same over ALL_QUANT_PATTERNS: also the ViT, DaViT and
            projector linears and the row-quantized token table
  w8a8      int8, plus per-row int8 activations on multi-token calls
            (`mark_w8a8`): `load_8bit` with `w8a8`
  int4      nibble-packed int4 trunk linears whose `in` dim is even, and
            the row-int8 token table: the reference's `load_4bit`
  int4-mlp  the trunk MLPs as one fused int4 SwiGLU each (`Int4MLP`), the
            rest as int8-all; a model whose MLP does not fit the kernel
            (D odd or I % 128) keeps int8 MLPs

Quantized values, scales and packings are the JAX package's, byte for byte;
only the layout of int8 weights follows the port's linears ([out, in]). Modules
are swapped in place, one at a time, and each full-precision weight is dropped
as soon as its quantized copy exists, so memory peaks near the model plus one
layer. Every function here that swaps a module or its function drops the
model's captured decode programs, which read the old ones
(`runtime.generate.drop_programs`). The patterns match the port's module names
(the checkpoint's), selecting the same linears as the JAX patterns select tree
paths.
"""

from __future__ import annotations

import re

import torch

from vlm_fo1_tpu_torch import nn as tnn
from vlm_fo1_tpu_torch.models.llm import Int4MLP, TextModel
from vlm_fo1_tpu_torch.ops.int4_matmul import (  # noqa: F401
    int4_matmul,
    int4_matmul_reference,
    unpack_int4,
    unpack_int4_halves,
)
from vlm_fo1_tpu_torch.ops.int4_mlp import int4_mlp, int4_mlp_reference
from vlm_fo1_tpu_torch.runtime.generate import drop_programs

MODES = ("none", "int8", "int8-all", "w8a8", "int4", "int4-mlp")

DEFAULT_QUANT_PATTERNS = (
    # the decode-bandwidth hot spots: trunk projections and an untied head
    r"^text\.layers\.\d+\.(self_attn|mlp)\.\w+$",
    r"^text\.lm_head$",
)

ALL_QUANT_PATTERNS = DEFAULT_QUANT_PATTERNS + (
    r"^vision_tower\.blocks\.\d+\.(attn|mlp)\.\w+$",
    r"^vision_tower_aux\.blocks\.\d+\.\d+\.(spatial|channel)_block\."
    r"(window_attn|channel_attn|ffn)\.fn\.(qkv|proj|net\.fc1|net\.fc2)$",
    r"^mm_projector(_aux)?(\.\d+)?$",
    # the (tied) token table, row-quantized
    r"^text\.embed_tokens$",
)


def _absmax(w, qmax: float, lo: int, hi: int):
    """Symmetric quantization of each row of w (its last axis) with scale
    max(absmax * (1 / qmax), 1e-8). The product with the f32 reciprocal is
    what XLA makes of the JAX package's `amax / qmax`, and it differs from
    the quotient in the last bit for some rows."""
    wf = w.float()
    inv = torch.tensor(1.0 / qmax, dtype=torch.float32, device=wf.device)
    scale = torch.clamp(wf.abs().amax(dim=-1, keepdim=True) * inv, min=1e-8)
    q = torch.clamp(torch.round(wf / scale), lo, hi).to(torch.int8)
    return q, scale.squeeze(-1)


def quantize_int8(w):
    """int8 with one f32 scale per row: per output channel of a linear
    weight [out, in] (the JAX package's `_quantize_weight` on [in, out]),
    per vocabulary row of a token table [V, D] (`_quantize_rows`)."""
    return _absmax(w, 127.0, -127, 127)


def _pack(lo, hi):
    return ((lo & 0x0F) | (hi << 4)).to(torch.int8)


def quantize_weight_int4(w):
    """Linear weight [out, in] (in even) -> (packed [in/2, out] int8, f32
    scales [out]): byte [k, n] holds w[n, k] in its low nibble and
    w[n, k + in/2] in its high one (contraction halves)."""
    q, scale = _absmax(w, 7.0, -8, 7)
    half = q.shape[-1] // 2
    return _pack(q[:, :half], q[:, half:]).t().contiguous(), scale


def quantize_weight_int4_outpack(w):
    """Linear weight [out, in] (out even) -> (packed [in, out/2] int8, f32
    scales [out]): byte [i, n] holds w[n, i] in its low nibble and
    w[n + out/2, i] in its high one (output halves, the fused MLP's down
    projection)."""
    q, scale = _absmax(w, 7.0, -8, 7)
    half = q.shape[0] // 2
    return _pack(q[:half], q[half:]).t().contiguous(), scale


def _matching(model, patterns, types):
    compiled = [re.compile(p) for p in patterns]
    return [n for n, m in model.named_modules()
            if isinstance(m, types) and any(c.search(n) for c in compiled)]


def _swap(model, name, new):
    parent, _, child = name.rpartition(".")
    setattr(model.get_submodule(parent) if parent else model, child, new)


def _drop_programs(model):
    for mod in model.modules():
        if isinstance(mod, TextModel):
            drop_programs(mod)
    return model


@torch.no_grad()
def quantize_params(model, patterns=DEFAULT_QUANT_PATTERNS):
    """int8 for every linear (and the token table) whose name matches one
    of `patterns`."""
    for name in _matching(model, patterns, (tnn.Linear, tnn.Weight)):
        mod = model.get_submodule(name)
        if name.endswith("embed_tokens"):
            new = tnn.QEmbedding8(*quantize_int8(mod.weight))
        else:
            new = tnn.QLinear8(*quantize_int8(mod.weight), mod.bias)
        del mod
        _swap(model, name, new)
    return _drop_programs(model)


def mark_w8a8(model):
    """Add the `a8` marker (per-row activation quantization on multi-token
    calls) to every int8 linear; the token table stays weight-only."""
    for mod in model.modules():
        if isinstance(mod, tnn.QLinear8) and mod.a8 is None:
            mod.a8 = torch.ones(1, dtype=torch.int8, device=mod.w_q.device)
    return _drop_programs(model)


def quantize_params_w8a8(model, patterns=DEFAULT_QUANT_PATTERNS):
    return mark_w8a8(quantize_params(model, patterns))


@torch.no_grad()
def quantize_params_int4(model, patterns=DEFAULT_QUANT_PATTERNS):
    """int4 for every matching linear with an even `in` dim (odd ones stay
    in full precision), and the token table row-quantized to int8."""
    for name in _matching(model, patterns, tnn.Linear):
        mod = model.get_submodule(name)
        if mod.weight.shape[1] % 2:
            continue
        new = tnn.QLinear4(*quantize_weight_int4(mod.weight), mod.bias)
        del mod
        _swap(model, name, new)
    text = model.text
    if isinstance(text.embed_tokens, tnn.Weight):
        text.embed_tokens = tnn.QEmbedding8(
            *quantize_int8(text.embed_tokens.weight))
    return _drop_programs(model)


@torch.no_grad()
def quantize_mlp_int4(mlp) -> Int4MLP:
    """A SwiGLU MLP (gate_proj / up_proj / down_proj, no biases) -> the
    fused int4 node."""
    gate_pk, gate_s = quantize_weight_int4(mlp.gate_proj.weight)
    up_pk, up_s = quantize_weight_int4(mlp.up_proj.weight)
    down_pk, down_s = quantize_weight_int4_outpack(mlp.down_proj.weight)
    return Int4MLP({"gate_pk": gate_pk, "gate_s": gate_s, "up_pk": up_pk,
                    "up_s": up_s, "down_pk": down_pk, "down_s": down_s})


def int4_mlp_eligible(text) -> bool:
    """The fused kernel's rule, as the JAX package's: D even and
    I % 128 == 0."""
    i_dim, d = text.layers[0].mlp.gate_proj.weight.shape
    return d % 2 == 0 and i_dim % 128 == 0


def quantize_params_int4_mlp(model):
    """Trunk MLPs -> `Int4MLP` when eligible, then int8 over
    ALL_QUANT_PATTERNS for everything else (and for ineligible MLPs)."""
    text = model.text
    if int4_mlp_eligible(text):
        for layer in text.layers:
            layer.mlp = quantize_mlp_int4(layer.mlp)
    return quantize_params(model, ALL_QUANT_PATTERNS)


def quantize_model(model, mode: str):
    """Quantize an `FO1Model` in place to one of MODES; returns it."""
    if mode not in MODES:
        raise ValueError(f"unknown quantization mode {mode!r}; one of "
                         f"{MODES}")
    if mode == "int8":
        quantize_params(model)
    elif mode == "int8-all":
        quantize_params(model, ALL_QUANT_PATTERNS)
    elif mode == "w8a8":
        quantize_params_w8a8(model)
    elif mode == "int4":
        quantize_params_int4(model)
    elif mode == "int4-mlp":
        quantize_params_int4_mlp(model)
    return model


def apply_load_flags(model, load_8bit=False, load_4bit=False, w8a8=False):
    """The flags of the JAX package's `api.load_pretrained_model`: 4-bit
    wins over 8-bit, and w8a8 needs load_8bit."""
    if w8a8 and (load_4bit or not load_8bit):
        raise ValueError(
            "w8a8=True requires load_8bit=True (activation quant rides the "
            f"int8 weight path); got load_8bit={load_8bit} "
            f"load_4bit={load_4bit}")
    if load_4bit:
        return quantize_params_int4(model)
    if load_8bit:
        quantize_params(model)
        if w8a8:
            mark_w8a8(model)
    return model


def use_int4_kernels(model, kernels: bool = True):
    """Route the model's int4 products through the CUDA kernels (default)
    or through their plain versions, for comparisons on the card."""
    for mod in model.modules():
        if isinstance(mod, tnn.QLinear4):
            mod.matmul = int4_matmul if kernels else int4_matmul_reference
        elif isinstance(mod, Int4MLP):
            mod.fn = int4_mlp if kernels else int4_mlp_reference
    return _drop_programs(model)


def quantized_bytes(model) -> int:
    """Bytes of every parameter and buffer of the model."""
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))
