"""Swin transformer backbone of UPN (counterpart of `vlm_fo1_tpu/upn/swin.py`).

Four stages of (shifted-)window attention blocks with a relative position
bias, patch merging between stages and a LayerNorm on each output stage.
Activations are channel-last [B, H, W, C]. After `norm1` a block pads its
input with zeros up to a multiple of the window; shifted blocks roll by
window // 2 and add the -100 mask built on the host. Window attention is
plain `torch.matmul` with float32 logits and softmax.

Parameters carry the reference checkpoint's names under the backbone prefix:
`patch_embed.proj`, `patch_embed.norm`, `layers.{i}.blocks.{j}.{norm1,
attn.qkv, attn.proj, attn.relative_position_bias_table, norm2, mlp.fc1,
mlp.fc2}`, `layers.{i}.downsample.{norm, reduction}`, `norm{i}`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vlm_fo1_tpu_torch import nn as tnn


@dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 192
    depths: tuple[int, ...] = (2, 2, 18, 2)
    num_heads: tuple[int, ...] = (6, 12, 24, 48)
    window_size: int = 12
    patch_size: int = 4
    mlp_ratio: float = 4.0
    in_channels: int = 3
    out_indices: tuple[int, ...] = (0, 1, 2, 3)

    @property
    def num_features(self) -> tuple[int, ...]:
        return tuple(self.embed_dim * 2**i for i in range(len(self.depths)))


def swin_large_config() -> SwinConfig:
    return SwinConfig()


def relative_position_index(ws: int) -> np.ndarray:
    """[ws*ws, ws*ws] index into the (2ws-1)^2 relative bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def shifted_window_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """Additive (0 / -100) mask [num_windows, ws*ws, ws*ws] for SW-MSA over
    a padded (hp, wp) map."""
    img = np.zeros((hp, wp), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for vs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, vs] = cnt
            cnt += 1
    win = img.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim, num_heads, ws):
        super().__init__()
        self.qkv = tnn.Linear(dim, 3 * dim)
        self.proj = tnn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * ws - 1) ** 2, num_heads))
        self.num_heads, self.ws = num_heads, ws

    def forward(self, x, rel_idx, mask=None):
        """x [B, Hp, Wp, C] (window multiples); rel_idx [T, T] long; mask
        [num_windows, T, T] float32 or None."""
        b, hp, wp, c = x.shape
        ws, nhd = self.ws, self.num_heads
        nh, nw, t, hd = hp // ws, wp // ws, ws * ws, c // nhd
        y = x.reshape(b, nh, ws, nw, ws, c).permute(0, 1, 3, 2, 4, 5)
        qkv = self.qkv(y.reshape(-1, t, c)).reshape(-1, t, 3, nhd, hd)
        q = (qkv[:, :, 0] * hd ** -0.5).transpose(1, 2)      # [W, H, T, hd]
        k = qkv[:, :, 1].transpose(1, 2)
        v = qkv[:, :, 2].transpose(1, 2)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        bias = self.relative_position_bias_table[rel_idx]    # [T, T, H]
        logits = logits + bias.permute(2, 0, 1)[None].float()
        if mask is not None:
            logits = (logits.reshape(b, nh * nw, nhd, t, t)
                      + mask[None, :, None]).reshape(-1, nhd, t, t)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(-1, t, c)
        out = self.proj(out).reshape(b, nh, nw, ws, ws, c)
        return out.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)


class _Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = tnn.Linear(dim, hidden)
        self.fc2 = tnn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class SwinBlock(nn.Module):
    def __init__(self, dim, num_heads, ws, mlp_ratio):
        super().__init__()
        self.norm1 = tnn.LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, ws)
        self.norm2 = tnn.LayerNorm(dim)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))
        self.ws = ws

    def forward(self, x, shift, rel_idx, sw_mask):
        b, h, w, c = x.shape
        ws = self.ws
        y = self.norm1(x)
        ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
        if ph or pw:
            y = F.pad(y, (0, 0, 0, pw, 0, ph))
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        y = self.attn(y, rel_idx, sw_mask if shift > 0 else None)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y[:, :h, :w]
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = tnn.LayerNorm(4 * dim)
        self.reduction = tnn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        h, w = x.shape[1:3]
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        # the reference's concat order: (even, even), (odd, even),
        # (even, odd), (odd, odd) in (row, column)
        y = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(y))


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.proj = tnn.Conv2d(cfg.in_channels, cfg.embed_dim, cfg.patch_size)
        self.norm = tnn.LayerNorm(cfg.embed_dim)


class _Stage(nn.Module):
    def __init__(self, dim, depth, num_heads, ws, mlp_ratio, merge):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, ws, mlp_ratio) for _ in range(depth))
        self.downsample = PatchMerging(dim) if merge else None


class SwinTransformer(nn.Module):
    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = _PatchEmbed(cfg)
        n = len(cfg.depths)
        self.layers = nn.ModuleList(
            _Stage(cfg.num_features[i], cfg.depths[i], cfg.num_heads[i],
                   cfg.window_size, cfg.mlp_ratio, i < n - 1)
            for i in range(n))
        for i in cfg.out_indices:
            self.add_module(f"norm{i}", tnn.LayerNorm(cfg.num_features[i]))
        # host-built index and shift-mask tables on the device, per padded
        # stage geometry: building them for every call held the card idle
        self._tables = {}

    def _table(self, key, build, device):
        key = (key, device)
        if key not in self._tables:
            # a plain tensor even when built under inference mode, so that
            # a later differentiable call may save it for its backward
            with torch.inference_mode(False):
                self._tables[key] = torch.from_numpy(build()).to(device)
        return self._tables[key]

    def forward(self, images):
        """images [B, H, W, 3] (H, W multiples of the patch size) -> the
        LayerNormed channel-last map of each output stage."""
        cfg = self.cfg
        ws = cfg.window_size
        dev = images.device
        rel_idx = self._table("rel_idx", lambda: relative_position_index(ws),
                              dev)
        x = tnn.conv2d_nhwc(self.patch_embed.proj, images,
                            stride=cfg.patch_size)
        x = self.patch_embed.norm(x)
        outs = []
        for i, stage in enumerate(self.layers):
            h, w = x.shape[1:3]
            hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
            sw_mask = self._table(
                ("sw_mask", hp, wp),
                lambda: shifted_window_mask(hp, wp, ws, ws // 2), dev)
            for j, blk in enumerate(stage.blocks):
                x = blk(x, 0 if j % 2 == 0 else ws // 2, rel_idx, sw_mask)
            if i in cfg.out_indices:
                outs.append(getattr(self, f"norm{i}")(x))
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs
