"""Qwen2.5-VL vision transformer (counterpart of `vlm_fo1_tpu/models/vit.py`).

Consumes the same padded-window layout as the JAX tower
(`preprocess/windowing.build_vit_plan`): tokens [B, P, D] with
P = num_windows * window_tokens, a validity mask, rotary tables and the
merge-unit permutation. Window attention is plain PyTorch over [B, W, T]
tiles; the full-attention blocks run the whole padded sequence through
`attention` (the flash kernel by default) with the per-key validity mask.
Hidden states after each full-attention block are returned as captures.

Parameters use the checkpoint's names: `patch_embed.proj.weight`
[D, C, T, ph, pw], `blocks.{i}.*`, `merger.ln_q`, `merger.mlp.{0,2}`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vlm_fo1_tpu_torch.config import ViTConfig
from vlm_fo1_tpu_torch import nn as tnn
from vlm_fo1_tpu_torch.ops.flash_attention import flash_attention


def _apply_rotary(x, cos, sin):
    """Rotate-half rotary in x's dtype; cos/sin are fp32 tables that
    broadcast against x with its head axis (-2) dropped."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x * cos[..., None, :].to(x.dtype)
            + rot * sin[..., None, :].to(x.dtype))


class VisionAttention(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.qkv = tnn.Linear(dim, 3 * dim)
        self.proj = tnn.Linear(dim, dim)
        # the model axis the heads are split over
        # (`parallel.sharding.shard_model`): this rank computes
        # num_heads / tp of them
        self.tp = 1

    def _qkv(self, x, shape):
        qkv = self.qkv(x)
        d = qkv.shape[-1] // 3
        return (qkv[..., :d].reshape(shape), qkv[..., d:2 * d].reshape(shape),
                qkv[..., 2 * d:].reshape(shape))

    def window(self, x, cos, sin, mask, num_heads, num_windows):
        """x [B, P, D]; cos/sin [W, T, hd]; mask [W, T, T] (True = attend)."""
        b, pad, d = x.shape
        hd = d // num_heads
        num_heads //= self.tp
        w, t = num_windows, pad // num_windows
        q, k, v = self._qkv(x, (b, w, t, num_heads, hd))
        q = _apply_rotary(q, cos[None], sin[None])
        k = _apply_rotary(k, cos[None], sin[None])
        logits = torch.einsum("bwqnh,bwknh->bwnqk", q.float(), k.float())
        logits = (logits * (1.0 / math.sqrt(hd))).to(x.dtype).float()
        logits = logits.masked_fill(~mask[None, :, None], tnn.MASK_FILL)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bwnqk,bwknh->bwqnh", probs, v).reshape(
            b, pad, num_heads * hd)
        return self.proj(out)

    def full(self, x, cos, sin, valid, num_heads, attention):
        """x [B, P, D]; cos/sin [P, hd]; valid [P] bool key mask."""
        b, pad, d = x.shape
        hd = d // num_heads
        num_heads //= self.tp
        q, k, v = self._qkv(x, (b, pad, num_heads, hd))
        q = _apply_rotary(q, cos, sin).transpose(1, 2).contiguous()
        k = _apply_rotary(k, cos, sin).transpose(1, 2).contiguous()
        v = v.transpose(1, 2).contiguous()
        out = attention(q, k, v, kv_valid=valid)
        return self.proj(out.transpose(1, 2).reshape(b, pad, num_heads * hd))


class VisionMLP(nn.Module):
    def __init__(self, dim, hidden, act):
        super().__init__()
        self.gate_proj = tnn.Linear(dim, hidden)
        self.up_proj = tnn.Linear(dim, hidden)
        self.down_proj = tnn.Linear(hidden, dim)
        self.act = tnn.ACT[act]

    def forward(self, x):
        return self.down_proj(self.act(self.gate_proj(x)) * self.up_proj(x))


class VisionBlock(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.norm1 = tnn.RMSNorm(d)
        self.norm2 = tnn.RMSNorm(d)
        self.attn = VisionAttention(d)
        self.mlp = VisionMLP(d, cfg.intermediate_size, cfg.hidden_act)

    def window_block(self, x, cos_w, sin_w, win_mask, num_heads,
                     num_windows):
        x = x + self.attn.window(self.norm1(x), cos_w, sin_w, win_mask,
                                 num_heads, num_windows)
        return x + self.mlp(self.norm2(x))

    def full_block(self, x, cos, sin, valid, num_heads, attention):
        x = x + self.attn.full(self.norm1(x), cos, sin, valid, num_heads,
                               attention)
        return x + self.mlp(self.norm2(x))


class PatchMerger(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        merged = cfg.hidden_size * cfg.spatial_merge_unit
        self.ln_q = tnn.RMSNorm(cfg.hidden_size)
        self.mlp = nn.Sequential(tnn.Linear(merged, merged), nn.GELU(),
                                 tnn.Linear(merged, cfg.out_hidden_size))
        self.unit = cfg.spatial_merge_unit

    def forward(self, x, inv_unit_idx):
        b, pad, _ = x.shape
        y = self.ln_q(x).reshape(b, pad // self.unit, -1)
        return self.mlp(y).index_select(1, inv_unit_idx)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = nn.Module()
        self.patch_embed.proj = tnn.Weight(
            cfg.hidden_size, cfg.in_channels, cfg.temporal_patch_size,
            cfg.patch_size, cfg.patch_size)
        self.blocks = nn.ModuleList(VisionBlock(cfg) for _ in range(cfg.depth))
        self.merger = PatchMerger(cfg)

    def forward(self, patches, rot_cos, rot_sin, valid, *, num_windows,
                inv_unit_idx, attention=flash_attention, remat=False):
        """patches [B, P, patch_dim] normalized, padded-window layout;
        rot_cos/rot_sin [P, hd] fp32; valid [P] bool; inv_unit_idx [U].
        `attention` serves the full-attention blocks: the forward-only flash
        kernel by default, `flash_attention_differentiable` for training.
        remat=True
        recomputes each window block in the backward pass instead of
        storing its activations (the JAX `remat`); full blocks stay stored,
        their outputs are the captures anyway.

        Returns (tokens [B, U, out_hidden] in original order, captures: list
        of [B, P, D] hidden states after each full-attention block)."""
        cfg = self.cfg
        b, pad, _ = patches.shape
        w_pe = self.patch_embed.proj.weight
        x = F.linear(patches, w_pe.reshape(w_pe.shape[0], -1))
        wt = pad // num_windows
        valid_w = valid.reshape(num_windows, wt)
        win_mask = valid_w[:, :, None] & valid_w[:, None, :]
        cos_w = rot_cos.reshape(num_windows, wt, -1)
        sin_w = rot_sin.reshape(num_windows, wt, -1)
        full = set(cfg.fullatt_block_indexes)
        captures = []
        for i, blk in enumerate(self.blocks):
            if i in full:
                x = blk.full_block(x, rot_cos, rot_sin, valid, cfg.num_heads,
                                   attention)
                captures.append(x)
            elif remat:
                x = checkpoint(blk.window_block, x, cos_w, sin_w, win_mask,
                               cfg.num_heads, num_windows,
                               use_reentrant=False)
            else:
                x = blk.window_block(x, cos_w, sin_w, win_mask,
                                     cfg.num_heads, num_windows)
        return self.merger(x, inv_unit_idx), captures


def captures_to_feature_map(captures, inv_token_idx, grid_thw, merge_size=2):
    """Captured hidden states (list of [B, P, D]) -> channel-last map
    [B, t*gh, gw, G*D] in original token order."""
    t, gh, gw = grid_thw
    x = torch.cat(list(captures), dim=-1).index_select(1, inv_token_idx)
    b, _, c = x.shape
    m = merge_size
    x = x.reshape(b, t, gh // m, gw // m, m, m, c).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(b, t * gh, gw, c)
