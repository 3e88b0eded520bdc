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

from vlm_fo1_tpu_torch.ops.int4_matmul import int4_matmul

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

    def product(self, x):
        """The product without the bias."""
        return F.linear(x, self.weight)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


# static outlier-channel budget of w8a8 (LLM.int8-style decomposition with
# a fixed channel count, as the JAX package's W8A8_OUTLIER_CHANNELS)
W8A8_OUTLIER_CHANNELS = 64


def exact_int_mm(a, b):
    """a [M, K] int8 @ b [K, N] int8 -> exact int32 [M, N] via
    `torch._int_mm`, whose CUDA version needs M > 16 and K, N multiples of
    8: zero rows and columns are padded in and cut off again, which leaves
    the product exact."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    return torch._int_mm(a, b)[:m, :n]


def w8a8_matmul(x, w_q, scale):
    """Dynamic per-row int8 activations against int8 weights, as the JAX
    package's w8a8 branch of `nn.linear`: the top-k activation columns by
    absmax over all leading dims (k = min(64, in/8), ties to the lower
    index) skip quantization and meet their dequantized weight rows in f32;
    the rest quantize per row and take the exact int32 product. x [..., in],
    w_q [out, in] int8, scale [out] f32 -> [..., out] in x's dtype."""
    xf = x.float()
    in_dim = xf.shape[-1]
    k = min(W8A8_OUTLIER_CHANNELS, in_dim // 8)
    y_out = 0.0
    if k > 0:
        col_amax = xf.abs().reshape(-1, in_dim).amax(dim=0)
        oidx = torch.sort(col_amax, descending=True, stable=True).indices[:k]
        w_o = w_q[:, oidx].float() * scale[:, None]          # [out, k]
        y_out = xf[..., oidx] @ w_o.t()
        keep = torch.ones(in_dim, dtype=torch.float32, device=x.device)
        keep[oidx] = 0.0
        xf = xf * keep
    sx = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-6) \
        * (1.0 / 127.0)
    x_q = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    acc = exact_int_mm(x_q.reshape(-1, in_dim), w_q.t())
    acc = acc.reshape(*x.shape[:-1], w_q.shape[0])
    return (acc.float() * sx * scale + y_out).to(x.dtype)


class QLinear8(nn.Module):
    """int8 linear (the JAX package's `w_q` leaves): weights [out, in] int8
    with per-output-channel f32 scales. Weight-only by default: the product
    in x's dtype, then `* scale` in x's dtype. With the `a8` marker
    (`quant.mark_w8a8`) a call whose second-to-last dim is above 1 (prefill,
    encode) quantizes its activations per row (`w8a8_matmul`); decode steps
    stay weight-only."""

    def __init__(self, w_q, scale, bias=None):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("scale", scale)
        self.register_buffer("a8", None)
        self.bias = bias

    def product(self, x):
        """The product without the bias."""
        if self.a8 is not None and x.dim() >= 2 and x.shape[-2] > 1:
            return w8a8_matmul(x, self.w_q, self.scale)
        return F.linear(x, self.w_q.to(x.dtype)) * self.scale.to(x.dtype)

    def forward(self, x):
        y = self.product(x)
        return y if self.bias is None else y + self.bias


class QLinear4(nn.Module):
    """int4 linear (the JAX package's `w_q4` leaves): nibble-packed
    [in/2, out] int8 with contraction halves, f32 scales [out]; the product
    runs through `matmul` (the int4 CUDA kernel on the card; set it to
    `ops.int4_matmul.int4_matmul_reference` to run the plain version)."""

    def __init__(self, w_q4, scale, bias=None):
        super().__init__()
        self.register_buffer("w_q4", w_q4)
        self.register_buffer("scale", scale)
        self.bias = bias
        self.matmul = int4_matmul

    def forward(self, x):
        y = self.matmul(x.reshape(-1, x.shape[-1]).contiguous(), self.w_q4,
                        self.scale)
        y = y.reshape(*x.shape[:-1], y.shape[-1])
        return y if self.bias is None else y + self.bias


class QEmbedding8(nn.Module):
    """Row-quantized token table (the JAX package's quantized
    `embed_tokens`): int8 [V, D] with per-row f32 scales [V]."""

    def __init__(self, w_q, scale):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("scale", scale)

    def lookup(self, ids, dtype):
        """Rows of `ids` (clamped like jnp.take(mode="clip")), dequantized
        into `dtype`; only the gathered rows are converted."""
        ids = ids.clamp(0, self.w_q.shape[0] - 1)
        return self.w_q[ids].to(dtype) * self.scale[ids][..., None].to(dtype)


def int8_head_logits(hidden, w_q, scale, chunk=16384):
    """Logits through an int8 head w_q [V, D] with per-row scales [V]: the
    f32 product with the int8 values, then the scale, [..., V] f32 (no bf16
    rounding of the logits, which could flip greedy ties). The weights are
    widened to f32 `chunk` rows at a time."""
    h = hidden.float()
    parts = [F.linear(h, w_q[i:i + chunk].float())
             for i in range(0, w_q.shape[0], chunk)]
    return torch.cat(parts, dim=-1) * scale


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
