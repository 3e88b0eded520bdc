"""DaViT aux tower (counterpart of `vlm_fo1_tpu/models/davit.py`).

Four stages of [ConvEmbed -> depth x (spatial block, channel block)] on a
fixed square input. Activations are channel-last [B, H, W, C] at the public
function, as in the JAX package; convs apply the checkpoint's OIHW weights.
The spatial-window attention pads the map to whole 12x12 windows and, like
the reference, does NOT mask the zero pad. Channel attention scales q by
N^-0.5 (N = H*W).

Parameters use the checkpoint's names (`convs.{i}.proj`, `convs.{i}.norm`,
`blocks.{i}.{j}.spatial_block.conv1.fn.dw`, `...window_attn.fn.qkv`,
`...channel_block.channel_attn.fn.proj`, `...ffn.fn.net.fc1`, ...).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vlm_fo1_tpu_torch.config import DaViTConfig
from vlm_fo1_tpu_torch import nn as tnn


def _module(**children) -> nn.Module:
    m = nn.Module()
    for name, child in children.items():
        setattr(m, name, child)
    return m


class _DepthwiseResidual(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.fn = _module(dw=tnn.Conv2d(dim, dim, 3, groups=dim))

    def forward(self, x):
        return x + tnn.conv2d_nhwc(self.fn.dw, x, padding=1,
                                   groups=x.shape[-1])


class _PreNormAttention(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = tnn.LayerNorm(dim)
        self.fn = _module(qkv=tnn.Linear(dim, 3 * dim),
                          proj=tnn.Linear(dim, dim))


class _FFN(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.norm = tnn.LayerNorm(dim)
        self.fn = _module(net=_module(fc1=tnn.Linear(dim, hidden),
                                      fc2=tnn.Linear(hidden, dim)))

    def forward(self, x):
        net = self.fn.net
        return x + net.fc2(F.gelu(net.fc1(self.norm(x))))


def _qkv(attn: _PreNormAttention, y, shape):
    c = y.shape[-1]
    qkv = attn.fn.qkv(y)
    return (qkv[..., :c].reshape(shape), qkv[..., c:2 * c].reshape(shape),
            qkv[..., 2 * c:].reshape(shape))


def window_attention(attn: _PreNormAttention, x, num_heads, window):
    """Non-shifted window MSA over zero-padded windows (pad unmasked)."""
    b, h, w, c = x.shape
    ph, pw = (window - h % window) % window, (window - w % window) % window
    x_p = F.pad(x, (0, 0, 0, pw, 0, ph)) if (ph or pw) else x
    hp, wp = h + ph, w + pw
    nh, nw = hp // window, wp // window
    y = attn.norm(x_p)
    y = y.reshape(b, nh, window, nw, window, c).permute(0, 1, 3, 2, 4, 5)
    y = y.reshape(b * nh * nw, window * window, c)
    q, k, v = _qkv(attn, y, (y.shape[0], window * window, num_heads,
                             c // num_heads))
    out = tnn.sdpa(q, k, v).reshape(y.shape)
    out = attn.fn.proj(out)
    out = out.reshape(b, nh, nw, window, window, c).permute(0, 1, 3, 2, 4, 5)
    return x + out.reshape(b, hp, wp, c)[:, :h, :w]


def channel_attention(attn: _PreNormAttention, x, groups):
    """Attention over channel groups with N^-0.5 scaling."""
    b, h, w, c = x.shape
    n = h * w
    y = attn.norm(x).reshape(b, n, c)
    q, k, v = _qkv(attn, y, (b, n, groups, c // groups))
    q = q * (float(n) ** -0.5)
    logits = torch.einsum("bngc,bngd->bgcd", q.float(), k.float())
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bgcd,bngd->bngc", probs, v).reshape(b, n, c)
    return x + attn.fn.proj(out).reshape(b, h, w, c)


class _SpatialBlock(nn.Module):
    def __init__(self, dim, mlp_ratio):
        super().__init__()
        self.conv1 = _DepthwiseResidual(dim)
        self.window_attn = _PreNormAttention(dim)
        self.conv2 = _DepthwiseResidual(dim)
        self.ffn = _FFN(dim, int(dim * mlp_ratio))


class _ChannelBlock(nn.Module):
    def __init__(self, dim, mlp_ratio):
        super().__init__()
        self.conv1 = _DepthwiseResidual(dim)
        self.channel_attn = _PreNormAttention(dim)
        self.conv2 = _DepthwiseResidual(dim)
        self.ffn = _FFN(dim, int(dim * mlp_ratio))


class DaViT(nn.Module):
    def __init__(self, cfg: DaViTConfig):
        super().__init__()
        self.cfg = cfg
        convs, blocks = [], []
        for i in range(cfg.num_stages):
            in_ch = cfg.in_channels if i == 0 else cfg.embed_dims[i - 1]
            dim = cfg.embed_dims[i]
            convs.append(_module(
                proj=tnn.Conv2d(in_ch, dim, cfg.patch_size[i]),
                norm=tnn.LayerNorm(in_ch if cfg.patch_prenorm[i] else dim)))
            blocks.append(nn.ModuleList(
                _module(spatial_block=_SpatialBlock(dim, cfg.mlp_ratio),
                        channel_block=_ChannelBlock(dim, cfg.mlp_ratio))
                for _ in range(cfg.depths[i])))
        self.convs = nn.ModuleList(convs)
        self.blocks = nn.ModuleList(blocks)

    def forward(self, images):
        """images [B, H, W, 3] normalized -> list of the 4 stage maps
        [B, H_i, W_i, C_i]."""
        cfg = self.cfg
        x = images
        outs = []
        for i, (conv, stage) in enumerate(zip(self.convs, self.blocks)):
            if cfg.patch_prenorm[i]:
                x = conv.norm(x)
            x = tnn.conv2d_nhwc(conv.proj, x, stride=cfg.patch_stride[i],
                                padding=cfg.patch_padding[i])
            if not cfg.patch_prenorm[i]:
                x = conv.norm(x)
            for blk in stage:
                sp, ch = blk.spatial_block, blk.channel_block
                x = sp.conv1(x)
                x = window_attention(sp.window_attn, x, cfg.num_heads[i],
                                     cfg.window_size)
                x = sp.ffn(sp.conv2(x))
                x = ch.conv1(x)
                x = channel_attention(ch.channel_attn, x, cfg.num_groups[i])
                x = ch.ffn(ch.conv2(x))
            outs.append(x)
        return outs
