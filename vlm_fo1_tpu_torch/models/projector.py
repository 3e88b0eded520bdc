"""Multimodal projectors (counterpart of `vlm_fo1_tpu/models/projector.py`).

`mlpNx_gelu` is the checkpoint's Sequential of Linear / exact GELU (state
keys `0.weight`, `2.weight`, ...); `linear` is one Linear (`weight`,
`bias`); `identity` has no parameters. The two resampling projectors carry
the reference's state-dict names (the ones the JAX converters read):

- CAbstractor (`cabstract`): learned position embedding, a RegNet-style
  stage (`net.0.b{i}`: 1x1 -> LN2d -> SiLU -> 3x3 depthwise -> LN2d ->
  SiLU -> squeeze-excite -> 1x1 -> LN2d, residual, SiLU), adaptive average
  pooling to a sqrt(n_query) grid (`net.1`), a second stage (`net.2`) and a
  SiLU MLP readout (`readout.{0,2}`).
- TokenPacker (`tokenpacker`): queries from the single-level map
  bilinearly downsampled by scale_factor (`q_proj_1`, `ln_q_1`), keys and
  values from the multi-level map through GELU MLPs (`k_proj_1`,
  `v_proj_1`, `ln_k_1`, `ln_v_1`), one cross-attention step in which each
  query attends only to its scale_factor^2 window (`clip_attn`, torch
  MultiheadAttention's parameters), then a GELU MLP readout (`mlp`).
"""

from __future__ import annotations

import math
import re

import torch
import torch.nn.functional as F
from torch import nn

from vlm_fo1_tpu_torch import nn as tnn


def build_projector(projector_type: str, in_dim: int, out_dim: int, **kw):
    """kw: the CAbstractor's `num_input_tokens` (576), `num_queries` (144)
    and `conv_bias` (True), as the JAX `init_projector_params` defaults
    them; the TokenPacker's `embed_dim` (1024) and `num_heads` (8)."""
    if projector_type == "identity":
        return nn.Identity()
    if projector_type == "linear":
        return tnn.Linear(in_dim, out_dim)
    if projector_type == "cabstract":
        return CAbstractor(kw.get("num_input_tokens", 576), in_dim, out_dim,
                           num_queries=kw.get("num_queries", 144),
                           conv_bias=kw.get("conv_bias", True))
    if projector_type == "tokenpacker":
        return TokenPacker(in_dim, out_dim,
                           embed_dim=kw.get("embed_dim", 1024),
                           num_heads=kw.get("num_heads", 8))
    m = re.match(r"^mlp(\d+)x_gelu$", projector_type)
    if not m:
        raise ValueError(f"unknown projector type: {projector_type}")
    layers = [tnn.Linear(in_dim, out_dim)]
    for _ in range(1, int(m.group(1))):
        layers += [nn.GELU(), tnn.Linear(out_dim, out_dim)]
    return nn.Sequential(*layers)


# ---------------------------------------------------------------- CAbstractor

class LayerNorm2d(tnn.LayerNorm):
    """LayerNorm over the channels of an NCHW map (timm's LayerNorm2d)."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvNorm(nn.Module):
    """`conv` (OIHW) then `bn` (LayerNorm2d, eps 1e-6)."""

    def __init__(self, in_ch, out_ch, k, groups=1, bias=True):
        super().__init__()
        self.conv = tnn.Conv2d(in_ch, out_ch, k, groups=groups, bias=bias)
        self.bn = LayerNorm2d(out_ch, eps=1e-6)
        self.groups, self.padding = groups, k // 2

    def forward(self, x):
        w = self.conv
        return self.bn(F.conv2d(x, w.weight, w.bias, padding=self.padding,
                                groups=self.groups))


class SqueezeExcite(nn.Module):
    def __init__(self, ch, rd):
        super().__init__()
        self.fc1 = tnn.Conv2d(ch, rd, 1)
        self.fc2 = tnn.Conv2d(rd, ch, 1)

    def forward(self, x):
        se = x.mean(dim=(2, 3), keepdim=True)
        se = F.conv2d(F.relu(F.conv2d(se, self.fc1.weight, self.fc1.bias)),
                      self.fc2.weight, self.fc2.bias)
        return x * torch.sigmoid(se)


class RegBlock(nn.Module):
    """RegNet bottleneck: bottle ratio 1, depthwise 3x3, SE 0.25, stride 1;
    a 1x1 projection shortcut where the width changes."""

    def __init__(self, in_ch, out_ch, bias=True):
        super().__init__()
        self.conv1 = ConvNorm(in_ch, out_ch, 1, bias=bias)
        self.conv2 = ConvNorm(out_ch, out_ch, 3, groups=out_ch, bias=bias)
        self.se = SqueezeExcite(out_ch, int(round(in_ch * 0.25)))
        self.conv3 = ConvNorm(out_ch, out_ch, 1, bias=bias)
        self.downsample = ConvNorm(in_ch, out_ch, 1, bias=bias) \
            if in_ch != out_ch else None

    def forward(self, x):
        y = F.silu(self.conv1(x))
        y = self.se(F.silu(self.conv2(y)))
        y = self.conv3(y)
        shortcut = x if self.downsample is None else self.downsample(x)
        return F.silu(y + shortcut)


class RegStage(nn.Module):
    """Blocks `b1`..`b{depth}`."""

    def __init__(self, in_ch, out_ch, depth, bias=True):
        super().__init__()
        for i in range(depth):
            self.add_module(f"b{i + 1}", RegBlock(
                in_ch if i == 0 else out_ch, out_ch, bias))

    def forward(self, x):
        for blk in self.children():
            x = blk(x)
        return x


class AdaptiveAvgPool(nn.Module):
    def __init__(self, out_hw):
        super().__init__()
        self.out_hw = out_hw

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.out_hw)


class CAbstractor(nn.Module):
    def __init__(self, num_input_tokens: int, in_dim: int, out_dim: int,
                 hidden: int = 1024, depth: int = 3, mlp_depth: int = 2,
                 num_queries: int = 144, pos_emb: bool = True,
                 prenorm: bool = False, conv_bias: bool = True):
        """conv_bias: the block convolutions carry biases, as the JAX
        `init_cabstractor_params` makes them; timm's layout has none."""
        super().__init__()
        self.num_queries = num_queries
        self.hw_out = int(round(math.sqrt(num_queries)))
        if self.hw_out ** 2 != num_queries:
            raise ValueError(f"num_queries {num_queries} is not a square")
        self.pos_emb = nn.Parameter(torch.empty(1, num_input_tokens, in_dim)) \
            if pos_emb else None
        self.prenorm = tnn.LayerNorm(in_dim, eps=1e-6) if prenorm else None
        self.net = nn.Sequential(RegStage(in_dim, hidden, depth, conv_bias),
                                 AdaptiveAvgPool(self.hw_out),
                                 RegStage(hidden, hidden, depth, conv_bias))
        layers = [tnn.Linear(hidden, out_dim)]
        for _ in range(1, mlp_depth):
            layers += [nn.SiLU(), tnn.Linear(out_dim, out_dim)]
        self.readout = nn.Sequential(*layers)

    def forward(self, x):
        """x [B, L, in_dim], L a perfect square -> [B, num_queries, out]."""
        b, length, d = x.shape
        hw_in = int(round(math.sqrt(length)))
        if hw_in * hw_in != length:
            raise ValueError(f"{length} input tokens do not form a square")
        if self.prenorm is not None:
            x = self.prenorm(x)
        if self.pos_emb is not None:
            x = x + self.pos_emb.to(x.dtype)
        y = self.net(x.reshape(b, hw_in, hw_in, d).permute(0, 3, 1, 2))
        return self.readout(y.permute(0, 2, 3, 1).reshape(
            b, self.num_queries, -1))


# ---------------------------------------------------------------- TokenPacker

def _gelu_mlp2(in_dim, hidden, out_dim):
    return nn.Sequential(tnn.Linear(in_dim, hidden), nn.GELU(),
                         tnn.Linear(hidden, out_dim))


class TokenPacker(nn.Module):
    def __init__(self, mm_hidden: int, hidden_size: int,
                 embed_dim: int = 1024, num_heads: int = 8):
        super().__init__()
        self.q_proj_1 = tnn.Linear(mm_hidden, embed_dim, bias=False)
        self.k_proj_1 = _gelu_mlp2(mm_hidden * 4, embed_dim, embed_dim)
        self.v_proj_1 = _gelu_mlp2(mm_hidden * 4, embed_dim, embed_dim)
        self.ln_q_1 = tnn.LayerNorm(embed_dim, eps=1e-6)
        self.ln_k_1 = tnn.LayerNorm(embed_dim, eps=1e-6)
        self.ln_v_1 = tnn.LayerNorm(embed_dim, eps=1e-6)
        self.clip_attn = tnn.MultiheadAttention(embed_dim, num_heads)
        self.mlp = _gelu_mlp2(embed_dim, hidden_size, hidden_size)

    def forward(self, x, *, raw_grid: int, scale_factor: int = 2):
        """x = (x_single [B, raw_grid^2, mm_hidden], x_multi: the same
        tokens with 4x the channels) -> [B, (raw_grid / sf)^2, hidden]."""
        x_single, x_multi = x
        b, length, _ = x_single.shape
        sf = scale_factor
        g = raw_grid // sf
        if length != raw_grid * raw_grid or g * sf != raw_grid:
            raise ValueError(f"{length} tokens do not form a {raw_grid}^2 "
                             f"grid divisible by {sf}")
        k = self.ln_k_1(self.k_proj_1(x_multi))
        v = self.ln_v_1(self.v_proj_1(x_multi))
        e = k.shape[-1]
        # bilinear downsample of the single-level map -> queries
        q_img = x_single.reshape(b, raw_grid, raw_grid, -1).float()
        q_img = F.interpolate(q_img.permute(0, 3, 1, 2), size=(g, g),
                              mode="bilinear", align_corners=False)
        q = self.q_proj_1(q_img.permute(0, 2, 3, 1).to(x_single.dtype))
        q = self.ln_q_1(q.reshape(b, g * g, e))

        def windows(t):  # the sf x sf window under each query
            t = t.reshape(b, g, sf, g, sf, e).permute(0, 1, 3, 2, 4, 5)
            return t.reshape(b * g * g, sf * sf, e)

        out = self.clip_attn(q.reshape(b * g * g, 1, e), windows(k),
                             windows(v))
        return self.mlp(out.reshape(b, g * g, e))
