"""One fused int4 SwiGLU MLP per call (counterpart of
`vlm_fo1_tpu/ops/int4_mlp.py`).

    g = (x @ gate) * gate_s        gate, up: [D/2, I] packed along the
    u = (x @ up) * up_s                      contraction halves
    h = silu(g) * u                in f32, cast to x's dtype
    y = (h @ down) * down_s        down: [I, D/2] packed along the OUTPUT
                                   halves: byte [i, n] holds column n in its
                                   low nibble, column n + D/2 in its high one

`node` is the dict of `quant.quantize_mlp_int4` (and of the JAX package's
`fused_int4` node): gate_pk, gate_s, up_pk, up_s, down_pk, down_s.

`int4_mlp` launches the hand-written CUDA kernel (`csrc/int4_mlp.cu`) for
CUDA tensors and takes the plain PyTorch version (`int4_mlp_reference`)
only for CPU tensors; a failed build or launch raises. One call counts as
one launch however many CUDA launches it makes (two on the bf16 streaming
route: gate and up with the SwiGLU epilogue writing h, then down, each on
its own `cluster_plan`). `int4_mlp.routes` counts the routes of the two
products of each call (gate and up, then down) as `int4_matmul.routes`
does: two per call.
"""

from __future__ import annotations

import ctypes

import torch

from vlm_fo1_tpu_torch.ops import cuda_lib
from vlm_fo1_tpu_torch.ops.int4_matmul import (
    ROUTES,
    SKINNY_ROWS,
    _DTYPES,
    check_cuda_inputs,
    fma_splits,
    sm_count,
    stream_plan,
    unpack_int4,
    unpack_int4_halves,
)

KEYS = ("gate_pk", "gate_s", "up_pk", "up_s", "down_pk", "down_s")
_lib = None


def int4_mlp_reference(x, node):
    """Plain PyTorch version, as the JAX package's `int4_mlp_reference`:
    dequantize the three weights, the SwiGLU chain in f32, h cast to x's
    dtype before the down product."""
    xf = x.float()
    g = (xf @ unpack_int4(node["gate_pk"]).float()) * node["gate_s"]
    u = (xf @ unpack_int4(node["up_pk"]).float()) * node["up_s"]
    h = (g * torch.sigmoid(g) * u).to(x.dtype).float()
    lo, hi = unpack_int4_halves(node["down_pk"])
    down = torch.cat([lo, hi], dim=-1).float()               # [I, D]
    return ((h @ down) * node["down_s"]).to(x.dtype)


def _load():
    global _lib
    if _lib is None:
        lib = cuda_lib.load("int4_mlp")
        fn = lib.fo1_int4_mlp
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 10 + [ci] * 8 + [vp, ctypes.POINTER(ci)]
        fn.restype = ci
        lib.fo1_int4_mlp_capacity.argtypes = [ci, ci, ci]
        lib.fo1_int4_mlp_capacity.restype = ci
        _lib = lib
    return _lib


def int4_mlp(x, node):
    """x [M, D] through the fused int4 SwiGLU -> [M, D] in x's dtype. CPU
    tensors take `int4_mlp_reference`. Forward only: with grad mode on,
    inputs that require a gradient raise."""
    cuda_lib.refuse_grad("int4_mlp", x, *(node[k] for k in KEYS))
    if x.device.type == "cpu":
        return int4_mlp_reference(x, node)
    tensors = [node[k] for k in KEYS]
    check_cuda_inputs("int4_mlp", x, tensors)
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return int4_mlp(x, node)
    m, d = x.shape
    dhalf, i_dim = node["gate_pk"].shape
    shapes_ok = (
        d == 2 * dhalf and node["up_pk"].shape == (dhalf, i_dim)
        and node["down_pk"].shape == (i_dim, dhalf)
        and all(node[k].dtype == torch.int8
                for k in ("gate_pk", "up_pk", "down_pk"))
        and node["gate_s"].shape == (i_dim,)
        and node["up_s"].shape == (i_dim,)
        and node["down_s"].shape == (d,)
        and all(node[k].dtype == torch.float32
                for k in ("gate_s", "up_s", "down_s")))
    if not shapes_ok:
        raise ValueError(f"int4_mlp: x {tuple(x.shape)}, node " + ", ".join(
            f"{k} {tuple(node[k].shape)} {node[k].dtype}" for k in KEYS))
    dev = x.device
    out = torch.empty((m, d), dtype=x.dtype, device=dev)
    if m == 0:
        return out                           # nothing to launch
    h = torch.empty((m, i_dim), dtype=x.dtype, device=dev)
    lib = _load()
    s1 = r1 = s2 = r2 = 0
    ws = None
    if m <= SKINNY_ROWS:
        index = dev.index
        if x.dtype == torch.bfloat16:
            cap = lib.fo1_int4_mlp_capacity
            s1, r1 = stream_plan(("int4_mlp gate_up", dhalf, i_dim), dhalf,
                                 i_dim, index, lambda s, r: cap(0, s, r))
            s2, r2 = stream_plan(("int4_mlp down", i_dim, dhalf), i_dim,
                                 dhalf, index, lambda s, r: cap(1, s, r))
        else:
            sms = sm_count(index)
            s1, s2 = fma_splits(dhalf, i_dim, sms), fma_splits(i_dim, dhalf,
                                                                sms)
            ws = torch.empty(max(2 * s1 * m * i_dim, s2 * m * d),
                             dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    route = (ctypes.c_int * 2)(-1, -1)
    err = lib.fo1_int4_mlp(
        x.data_ptr(), *(t.data_ptr() for t in tensors), h.data_ptr(),
        None if ws is None else ws.data_ptr(), out.data_ptr(),
        m, d, i_dim, s1, r1, s2, r2, _DTYPES[x.dtype], stream, route)
    if err != 0:
        raise RuntimeError(f"int4_mlp kernel launch failed: CUDA error "
                           f"{err}")
    int4_mlp.launches += 1
    for r in route:
        int4_mlp.routes[ROUTES[r]] += 1
    return out


int4_mlp.launches = 0
int4_mlp.routes = dict.fromkeys(ROUTES, 0)
