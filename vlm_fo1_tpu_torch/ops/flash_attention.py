"""Flash attention for the ViT full-attention blocks and the trunk prefill.

Counterpart of `vlm_fo1_tpu/ops/flash_attention.py`, with the same signature
and layout: q [B, H, Sq, D], k/v [B, Hkv, Sk, D], GQA (query head h reads kv
head h // (H // Hkv)), `causal` aligned bottom-right, a scalar `kv_len`
bound, an arbitrary per-key `kv_valid` [Sk] bool mask and `scale`.

`flash_attention` launches the hand-written CUDA kernel
(`csrc/flash_attention.cu`) for CUDA tensors and takes the plain PyTorch
version (`flash_attention_reference`) only for CPU tensors. It is forward
only; `flash_attention_differentiable` is the same kernel with the plain
version's gradient, which the training loss chooses for the ViT. The kernel is
built with nvcc into `build/` at the repository root on first use and loaded
with ctypes (`cuda_lib`); a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from vlm_fo1_tpu_torch.ops import cuda_lib

NEG_INF = -1e30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def flash_attention_reference(q, k, v, *, causal=False, kv_len=None,
                              kv_valid=None, scale=None):
    """Plain PyTorch version with the kernel's semantics: fp32 logits,
    finite -1e30 fill for masked keys, fp32 softmax, probabilities cast to
    q's dtype before the product with v."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    groups = h // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    kx = k.repeat_interleave(groups, dim=1)
    vx = v.repeat_interleave(groups, dim=1)
    logits = torch.matmul(q.float(), kx.float().transpose(-1, -2)) * scale
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(sq, device=q.device)
        mask &= kpos[None, :] <= qpos[:, None] + (sk - sq)
    if kv_len is not None:
        mask &= (kpos < kv_len)[None, :]
    if kv_valid is not None:
        mask &= kv_valid.to(torch.bool)[None, :]
    logits = logits.masked_fill(~mask, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.matmul(p.to(q.dtype), vx)


def _load():
    global _lib
    if _lib is None:
        lib = cuda_lib.load("flash_attention")
        fn = lib.fo1_flash_attention_fwd
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
                       ctypes.c_float, ci, vp]
        fn.restype = ci
        _lib = lib
    return _lib


def flash_attention(q, k, v, *, causal=False, kv_len=None, kv_valid=None,
                    scale=None):
    """Online-softmax attention -> [B, H, Sq, D] in q's dtype.

    A query row whose keys are all masked comes out finite (its value is
    unspecified). CPU tensors take `flash_attention_reference`. Forward
    only: with grad mode on, inputs that require a gradient raise (see
    `flash_attention_differentiable`)."""
    cuda_lib.refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         kv_len=kv_len, kv_valid=kv_valid,
                                         scale=scale)
    return _kernel(q, k, v, causal, kv_len, kv_valid, scale)


def _kernel(q, k, v, causal, kv_len, kv_valid, scale):
    """Launch `csrc/flash_attention.cu` on CUDA inputs (checked here)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; need all float32 or all bfloat16")
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or h % hkv or d > 128):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k and v on different devices")
    valid_ptr = None
    if kv_valid is not None:
        if kv_valid.shape != (sk,) or kv_valid.device != q.device:
            raise ValueError("flash_attention: kv_valid must be [Sk] on q's "
                             "device")
        kv_valid = kv_valid.to(torch.uint8).contiguous()
        valid_ptr = kv_valid.data_ptr()
    kv_len = sk if kv_len is None else int(min(int(kv_len), sk))
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    lib = _load()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fo1_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_ptr,
            out.data_ptr(), b, h, hkv, sq, sk, d, kv_len, int(bool(causal)),
            float(scale), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """The flash kernel as the forward, the plain version's gradient as the
    backward: it recomputes `flash_attention_reference` one kv head (and
    its query heads) at a time and differentiates that. This is the JAX
    package's design (its Pallas kernel has no backward; the gradient runs
    through the reference path). Saves only q, k, v and the mask, so a
    training forward stores no [Sq, Sk] logits; the backward holds one kv
    head's at a time."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, causal, kv_len, scale):
        ctx.save_for_backward(q, k, v, kv_valid)
        ctx.opts = dict(causal=causal, kv_len=kv_len, scale=scale)
        return _kernel(q, k, v, causal, kv_len, kv_valid, scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        q, k, v, kv_valid = ctx.saved_tensors
        g = q.shape[1] // k.shape[1]
        grads = ([], [], [])
        with torch.enable_grad():
            for j in range(k.shape[1]):
                ins = [t.detach().requires_grad_(True) for t in
                       (q[:, j * g:(j + 1) * g], k[:, j:j + 1], v[:, j:j + 1])]
                out = flash_attention_reference(*ins, kv_valid=kv_valid,
                                                **ctx.opts)
                for acc, d in zip(grads, torch.autograd.grad(
                        out, ins, grad_out[:, j * g:(j + 1) * g])):
                    acc.append(d)
        return (*(torch.cat(acc, dim=1) for acc in grads),
                None, None, None, None)


def flash_attention_differentiable(q, k, v, *, causal=False, kv_len=None,
                                   kv_valid=None, scale=None):
    """`flash_attention` with a gradient, for training: CUDA tensors go
    through `FlashAttentionFunction` (the kernel forward, counted in
    `flash_attention.launches`); CPU tensors take
    `flash_attention_reference`, which autograd differentiates."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         kv_len=kv_len, kv_valid=kv_valid,
                                         scale=scale)
    return FlashAttentionFunction.apply(q, k, v, kv_valid, causal, kv_len,
                                        scale)
