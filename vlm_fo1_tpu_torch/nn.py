"""Layer primitives of the PyTorch port (counterpart of `vlm_fo1_tpu/nn.py`).

Modules hold parameters under the released checkpoint's names and layouts:
linear weights are [out, in] and conv weights OIHW. Construction allocates
nothing beyond empty tensors; weights come from
`models.fo1.FO1Model.random_init` or a state dict.

Numerics follow the JAX package: RMSNorm and LayerNorm statistics in fp32
(cast back before the affine), attention softmax in fp32, and masked logits
filled with the finite `finfo(float32).min`, never -inf. The fill is applied
after logits are rounded to the activation dtype (bf16 cannot hold it), so
a query row whose keys are all masked stays finite.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

MASK_FILL = torch.finfo(torch.float32).min


def _promoted(x):
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def rms_norm(weight, x, eps=1e-6):
    xf = _promoted(x)
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return weight * xf.to(x.dtype)


def layer_norm(weight, bias, x, eps=1e-5):
    xf = _promoted(x)
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).pow(2).mean(-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return xf.to(x.dtype) * weight + bias


class RMSNorm(nn.Module):
    def __init__(self, dim, eps=1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.eps = eps

    def forward(self, x):
        return rms_norm(self.weight, x, self.eps)


class LayerNorm(nn.Module):
    def __init__(self, dim, eps=1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))
        self.eps = eps

    def forward(self, x):
        return layer_norm(self.weight, self.bias, x, self.eps)


def group_norm(weight, bias, x, groups, eps=1e-5):
    """Channel-last GroupNorm over [..., H, W, C]: fp32 statistics, cast
    back to x's dtype before the affine."""
    *lead, h, w, c = x.shape
    xf = _promoted(x).reshape(*lead, h * w, groups, c // groups)
    mean = xf.mean(dim=(-3, -1), keepdim=True)
    var = (xf - mean).pow(2).mean(dim=(-3, -1), keepdim=True)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(*lead, h, w, c)
    return xf.to(x.dtype) * weight + bias


class GroupNorm(nn.Module):
    def __init__(self, groups, dim, eps=1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))
        self.groups, self.eps = groups, eps

    def forward(self, x):
        return group_norm(self.weight, self.bias, x, self.groups, self.eps)


class Weight(nn.Module):
    """A bare `weight` parameter of any shape (patch embed, token table)."""

    def __init__(self, *shape):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(*shape))


class Linear(nn.Module):
    """[out, in] weight, optional bias; no initialisation of its own."""

    def __init__(self, in_dim, out_dim, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim)) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Conv2d(nn.Module):
    """OIHW conv weight; applied by callers that own the layout."""

    def __init__(self, in_ch, out_ch, kernel_size, groups=1, bias=True):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None


def conv2d_nhwc(conv: Conv2d, x, stride=1, padding=0, groups=1):
    """Channel-last conv [B, H, W, C] with an OIHW weight."""
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias,
                 stride=stride, padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


def mlp(layers, x):
    """Reference MLP (module/mlp.py): relu between layers, none after the
    last. Each product runs in the wider of x's and the weights' dtypes,
    as JAX promotes a float32 input against bfloat16 weights."""
    for i, lin in enumerate(layers):
        dt = torch.promote_types(x.dtype, lin.weight.dtype)
        x = F.linear(x.to(dt), lin.weight.to(dt),
                     None if lin.bias is None else lin.bias.to(dt))
        if i < len(layers) - 1:
            x = F.relu(x)
    return x


def embedding(weight, ids):
    """Row lookup with ids clamped to [0, V-1], like jnp.take(mode="clip")."""
    return weight[ids.clamp(0, weight.shape[0] - 1)]


ACT = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
}


def sdpa(q, k, v, mask=None, scale=None):
    """Plain attention, fp32 logits and softmax. q [..., Sq, H, D],
    k/v [..., Sk, H, D]; mask broadcastable to [..., H, Sq, Sk], True =
    attend. Logits are rounded to q's dtype before the fp32 softmax and the
    probabilities cast back to it, as in the JAX package."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qh = q.transpose(-2, -3)
    kh = k.transpose(-2, -3)
    vh = v.transpose(-2, -3)
    logits = torch.matmul(_promoted(qh), _promoted(kh).transpose(-1, -2))
    logits = _promoted((logits * scale).to(q.dtype))
    if mask is not None:
        logits = logits.masked_fill(~mask, MASK_FILL)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, vh).transpose(-2, -3)


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (`in_proj_weight` [3C, C],
    `in_proj_bias`, `out_proj`), computed through `sdpa` as the JAX
    package's `_mha` does (no mask, batch first)."""

    def __init__(self, dim, num_heads):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = Linear(dim, dim)
        self.num_heads = num_heads

    def forward(self, q, k, v):
        b, n, c = q.shape
        w, bias = self.in_proj_weight, self.in_proj_bias
        hd = c // self.num_heads
        qp = F.linear(q, w[:c], bias[:c]).reshape(b, n, self.num_heads, hd)
        kp = F.linear(k, w[c:2 * c], bias[c:2 * c]).reshape(
            b, -1, self.num_heads, hd)
        vp = F.linear(v, w[2 * c:], bias[2 * c:]).reshape(
            b, -1, self.num_heads, hd)
        return self.out_proj(sdpa(qp, kp, vp).reshape(b, n, c))
