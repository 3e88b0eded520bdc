"""Decode attention: one query token a row over the whole KV cache.

The S = 1 step of `models.llm.Attention` (the decode branch of the JAX
`_attention`, `vlm_fo1_tpu/models/llm.py:164-181`), from after the cache
write to the input of `o_proj`: q [B, H, hd] after rope, this layer's cache
kc / vc [B, C, Hkv, hd] as stored, mask [B, C] bool (its row stride may be
0), GQA (query head h reads kv head h // (H // Hkv)). The arithmetic is the
reference's, in its order: f32 dot products of the operands as stored,
times `scale` in f32; `finfo(float32).min` where the mask is False; the
logits rounded to q's dtype; an f32 softmax; the probabilities rounded to
q's dtype; P V accumulated in f32 and rounded once -> [B, H * hd] in q's
dtype.

`decode_attention` launches the hand-written CUDA kernel
(`csrc/decode_attention.cu`) for CUDA tensors and takes the plain PyTorch
version (`decode_attention_reference`) only for CPU tensors. The kernel cuts
C into pieces of PIECE slots and makes three launches: the logits with each
piece's softmax max and sum, P V over each piece once every piece's max and
sum are in, a fold of the pieces. The pieces do not depend on B and every
sum over them runs in piece order, where a piece with no valid slot adds an
exact zero, so a row's result is the same in any batch, in a longer cache
and in another prompt-pad bucket. The wrapper allocates the
scratch; nothing synchronises, so a CUDA graph captures it. It is built with
nvcc into `build/` at the repository root on first use and loaded with
ctypes (`cuda_lib`); a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from vlm_fo1_tpu_torch import nn as tnn
from vlm_fo1_tpu_torch.ops import cuda_lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PIECE = 64  # slots of C a block of the kernel takes (csrc/decode_attention.cu)
_lib = None


def decode_attention_reference(q, kc, vc, mask, scale=None):
    """Plain PyTorch version: the decode chain of `Attention.forward` as
    it stood before the kernel, operation for operation. A row whose slots
    are all masked gives NaN in bf16 (its logits round to -inf)."""
    b, nh, hd = q.shape
    nkv = kc.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, nkv, nh // nkv, hd)
    logits = torch.einsum("bngh,bcnh->bngc", qg.float(), kc.float())
    logits = logits * scale
    logits = logits.masked_fill(~mask[:, None, None, :], tnn.MASK_FILL)
    probs = torch.softmax(logits.to(q.dtype).float(), dim=-1).to(q.dtype)
    out = torch.einsum("bngc,bcnh->bngh", probs, vc.to(q.dtype))
    return out.reshape(b, nh * hd)


def _load():
    global _lib
    if _lib is None:
        lib = cuda_lib.load("decode_attention")
        fn = lib.fo1_decode_attention
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, vp, vp, vp, vp,
                       ci, ci, ci, ci, ci, ctypes.c_float, ci, vp]
        fn.restype = ci
        _lib = lib
    return _lib


def decode_attention(q, kc, vc, mask, scale=None):
    """q [B, H, hd], kc / vc [B, C, Hkv, hd], mask [B, C] bool ->
    [B, H * hd] in q's dtype. CPU tensors take
    `decode_attention_reference`; CUDA tensors launch the kernel, or raise
    on input it does not take. Forward only."""
    cuda_lib.refuse_grad("decode_attention", q, kc, vc)
    if q.device.type == "cpu":
        return decode_attention_reference(q, kc, vc, mask, scale)
    return _kernel(q, kc, vc, mask, scale)


def _kernel(q, kc, vc, mask, scale):
    """Launch `csrc/decode_attention.cu` on CUDA inputs (checked here)."""
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if q.dim() != 3 or kc.dim() != 4:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"kc {tuple(kc.shape)}; need [B, H, hd] and "
                         f"[B, C, Hkv, hd]")
    b, h, hd = q.shape
    _, c, hkv, _ = kc.shape
    if q.dtype not in _DTYPES or kc.dtype != q.dtype or vc.dtype != q.dtype:
        raise TypeError(f"decode_attention: dtypes {q.dtype}, {kc.dtype}, "
                        f"{vc.dtype}; need all float32 or all bfloat16")
    if (kc.shape != vc.shape or kc.shape[0] != b or kc.shape[3] != hd
            or hd > 256 or h % hkv or mask.shape != (b, c)
            or mask.dtype != torch.bool):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"kc {tuple(kc.shape)}, vc {tuple(vc.shape)}, mask "
                         f"{tuple(mask.shape)} {mask.dtype}")
    if not (kc.device == q.device and vc.device == q.device
            and mask.device == q.device):
        raise ValueError("decode_attention: inputs on different devices")
    if not (q.is_contiguous() and kc.is_contiguous()
            and vc.is_contiguous()):
        raise ValueError("decode_attention: q, kc and vc must be contiguous")
    if mask.stride(1) != 1:
        mask = mask.contiguous()
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    splits = -(-c // PIECE)
    lib = _load()
    logits = torch.empty((b, h, PIECE * splits), dtype=q.dtype,
                         device=q.device)
    stats = torch.empty((2, b, h, splits), dtype=torch.float32,
                        device=q.device)
    part = torch.empty((b, h, splits, hd), dtype=torch.float32,
                       device=q.device)
    out = torch.empty((b, h * hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fo1_decode_attention(
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(), mask.data_ptr(),
            mask.stride(0), logits.data_ptr(), stats.data_ptr(),
            part.data_ptr(), out.data_ptr(), b, h, hkv, c, hd, float(scale),
            _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
