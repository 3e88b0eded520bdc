"""Matmul with nibble-packed int4 weights (counterpart of
`vlm_fo1_tpu/ops/int4_matmul.py`).

    y[M, N] = (x[:, :K/2] @ lo + x[:, K/2:] @ hi) * scale[N]

x is [M, K] in f32 or bf16; `packed` is [K/2, N] int8 whose byte [k, n]
holds w[k, n] in its low nibble and w[k + K/2, n] in its high nibble, both
signed (`quant.quantize_weight_int4`); `scale` is [N] f32. The sum is taken
in f32 and scaled after it; the result comes back in x's dtype.

`int4_matmul` launches the hand-written CUDA kernel (`csrc/int4_matmul.cu`)
for CUDA tensors and takes the plain PyTorch version
(`int4_matmul_reference`, the halves formulation) only for CPU tensors. The
kernel is built with nvcc into `build/` on first use (`cuda_lib`); a failed
build or launch raises. Each call takes one route of the kernel, counted in
`int4_matmul.routes`: "gemv" (M <= 8, streaming), "tma" (M > 8, bf16 x,
TMA-fed wgmma tiles; every shape whose row strides are multiples of 16
bytes, K % 16 == 0 and N % 16 == 0, on 16-byte aligned tensors), "mma"
(M > 8, bf16 x, other shapes: mma.sync tiles) or "fma" (M > 8, f32 x).
"""

from __future__ import annotations

import ctypes

import torch

from vlm_fo1_tpu_torch.ops import cuda_lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' route codes (int4_core.cuh ROUTE_*), in order
ROUTES = ("gemv", "fma", "mma", "tma")
# calls with at most this many rows take the kernel's streaming (GEMV) path
SKINNY_ROWS = 8
_SM_COUNT = 132
_lib = None


def unpack_int4_halves(packed):
    """int8 packed bytes -> (lo, hi) int8 nibbles in [-8, 7], sign-extended
    by arithmetic shifts."""
    return (packed << 4) >> 4, packed >> 4


def unpack_int4(packed):
    """int8 [..., in/2, out] -> int8 [..., in, out] (halves along `in`)."""
    lo, hi = unpack_int4_halves(packed)
    return torch.cat([lo, hi], dim=-2)


def int4_matmul_reference(x, packed, scale):
    """Plain PyTorch version: the two halves' products accumulated in f32
    (products of bf16 and int4 values are exact in f32), then the scale,
    then the cast to x's dtype."""
    khalf = packed.shape[0]
    lo, hi = unpack_int4_halves(packed)
    acc = x[:, :khalf].float() @ lo.float()
    acc = acc + x[:, khalf:].float() @ hi.float()
    return (acc * scale.float()).to(x.dtype)


def skinny_splits(rows: int, cols: int) -> int:
    """How many slices the streaming path cuts the packed rows into: enough
    blocks for two per SM, at least 64 rows per slice. Each block covers
    128 packed columns; the slices' partial sums are added in a fixed
    order by a second launch."""
    col_blocks = -(-cols // 128)
    splits = max(1, min(-(-2 * _SM_COUNT // col_blocks), rows // 64))
    per = -(-rows // splits)
    return -(-rows // per)


def check_cuda_inputs(name, x, tensors):
    """Device, dtype and contiguity checks shared by the int4 wrappers."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: x is {x.dtype}; need float32 or bfloat16")
    for t in (x, *tensors):
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _load():
    global _lib
    if _lib is None:
        lib = cuda_lib.load("int4_matmul")
        fn = lib.fo1_int4_matmul
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp,
                       ctypes.POINTER(ci)]
        fn.restype = ci
        _lib = lib
    return _lib


def int4_matmul(x, packed, scale):
    """x [M, K] @ packed int4 [K/2, N] * scale [N] -> [M, N] in x's dtype.
    CPU tensors take `int4_matmul_reference`. Forward only: with grad mode
    on, inputs that require a gradient raise."""
    cuda_lib.refuse_grad("int4_matmul", x, packed, scale)
    if x.device.type == "cpu":
        return int4_matmul_reference(x, packed, scale)
    check_cuda_inputs("int4_matmul", x, (packed, scale))
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return int4_matmul(x, packed, scale)
    m, k = x.shape
    khalf, n = packed.shape
    if k != 2 * khalf or packed.dtype != torch.int8 \
            or scale.shape != (n,) or scale.dtype != torch.float32:
        raise ValueError(f"int4_matmul: x {tuple(x.shape)}, packed "
                         f"{tuple(packed.shape)} {packed.dtype}, scale "
                         f"{tuple(scale.shape)} {scale.dtype}")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out                           # nothing to launch
    splits, ws = 0, None
    if m <= SKINNY_ROWS:
        splits = skinny_splits(khalf, n)
        ws = torch.empty(splits * m * n, dtype=torch.float32,
                         device=x.device)
    lib = _load()
    stream = torch.cuda.current_stream().cuda_stream
    route = ctypes.c_int(-1)
    err = lib.fo1_int4_matmul(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(),
        m, k, n, splits, _DTYPES[x.dtype], stream, ctypes.byref(route))
    if err != 0:
        raise RuntimeError(f"int4_matmul kernel launch failed: CUDA error "
                           f"{err}")
    int4_matmul.launches += 1
    int4_matmul.routes[ROUTES[route.value]] += 1
    return out


int4_matmul.launches = 0
int4_matmul.routes = dict.fromkeys(ROUTES, 0)
