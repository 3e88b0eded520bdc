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

The streaming route with bf16 x is one launch: the packed bytes stream
once through registers into tensor-core products (x as the n = 8 operand),
K is split over the blocks of a thread-block cluster, and the cluster sums
its slices in rank order in the same launch. `cluster_plan` sizes the
split from the card's SM count and the clusters the CUDA runtime says it
holds at once; any shape takes it (bytes of rows that are not 8-byte aligned
load one at a time), and only an x slice too large for shared memory at
every split (K above about 60,000) falls back to the tiles. f32 x streams
with f32 FMAs and a second launch that sums the `fma_splits` slices.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vlm_fo1_tpu_torch.ops import cuda_lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' route codes (int4_core.cuh ROUTE_*), in order
ROUTES = ("gemv", "fma", "mma", "tma")
# calls with at most this many rows take the kernel's streaming (GEMV) path
SKINNY_ROWS = 8
# the bf16 streaming kernel's geometry (int4_core.cuh, namespace sk): a
# block covers 64 packed columns, its 8 warps take 16 packed rows a step,
# and at most 8 blocks (a portable cluster) split the packed rows
STREAM_COLS = 64
STREAM_STEP = 16
STREAM_MAX_SPLIT = 8
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


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


# the planner's fixed cost of a block (launch, the first round trip to
# device memory, the reduction), in 16-row steps of streaming
STREAM_BLOCK_STEPS = 32


def cluster_plan(rows: int, cols: int, sms: int, capacity=None):
    """The bf16 streaming route's split of a packed [rows, cols] weight:
    (splits, rows_per). The kernel's grid is splits x ceil(cols / 64)
    blocks, clusters of `splits` along the packed rows; block s of a
    cluster takes rows [s * rows_per, min(rows, (s + 1) * rows_per)),
    rows_per a multiple of 16, so the slices cover every row once and none
    is empty. capacity(splits, rows_per) is how many such clusters the card
    holds at once (the kernel library asks the CUDA runtime; by default
    two blocks an SM). Of the splits up to 8 (a portable cluster), the one with
    the least (waves of clusters) x (16-row steps of a block + a block's
    fixed cost), the smaller split on a tie: one wave of clusters when the
    card can hold them, and as many SMs at work as that allows. The plan
    does not depend on M: a row of x gets the same sums alone as in a
    batch."""
    if capacity is None:
        def capacity(splits, rows_per):
            return 2 * sms // splits
    units = -(-cols // STREAM_COLS)
    steps = -(-rows // STREAM_STEP)
    best = None
    for splits in range(1, min(STREAM_MAX_SPLIT, steps) + 1):
        per = -(-steps // splits)
        if -(-steps // per) != splits:   # the same slices as a smaller split
            continue
        waves = -(-units // max(1, capacity(splits, per * STREAM_STEP)))
        cost = waves * (per + STREAM_BLOCK_STEPS)
        if best is None or cost < best[0]:
            best = (cost, (splits, per * STREAM_STEP))
    return best[1]


_PLANS = {}


def stream_plan(key, rows: int, cols: int, index: int, capacity):
    """cluster_plan on CUDA device `index` with the library's capacity
    query, kept by `key` (the product and its shape)."""
    plan = _PLANS.get((key, index))
    if plan is None:
        with torch.cuda.device(index):
            plan = _PLANS[(key, index)] = cluster_plan(rows, cols,
                                                       sm_count(index),
                                                       capacity)
    return plan


def fma_splits(rows: int, cols: int, sms: int) -> int:
    """How many slices the f32 streaming path cuts the packed rows into:
    enough blocks for two per SM, at least 64 rows per slice. Each block
    covers 128 packed columns; the slices' partial sums are added in a
    fixed order by a second launch."""
    col_blocks = -(-cols // 128)
    splits = max(1, min(-(-2 * sms // col_blocks), rows // 64))
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
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp,
                       ctypes.POINTER(ci)]
        fn.restype = ci
        lib.fo1_int4_matmul_capacity.argtypes = [ci, ci]
        lib.fo1_int4_matmul_capacity.restype = ci
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
    lib = _load()
    splits, rows_per, ws = 0, 0, None
    if m <= SKINNY_ROWS:
        index = x.device.index
        if x.dtype == torch.bfloat16:
            splits, rows_per = stream_plan(
                ("int4_matmul", khalf, n), khalf, n, index,
                lib.fo1_int4_matmul_capacity)
        else:
            splits = fma_splits(khalf, n, sm_count(index))
            ws = torch.empty(splits * m * n, dtype=torch.float32,
                             device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    route = ctypes.c_int(-1)
    err = lib.fo1_int4_matmul(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(),
        m, k, n, splits, rows_per, _DTYPES[x.dtype], stream,
        ctypes.byref(route))
    if err != 0:
        raise RuntimeError(f"int4_matmul kernel launch failed: CUDA error "
                           f"{err}")
    int4_matmul.launches += 1
    int4_matmul.routes[ROUTES[route.value]] += 1
    return out


int4_matmul.launches = 0
int4_matmul.routes = dict.fromkeys(ROUTES, 0)
