"""Multi-scale deformable attention (counterpart of `vlm_fo1_tpu/ops/msda.py`).

`ms_deform_attn_core` takes the JAX package's 6-D public layout: value
[B, S, M, D] (S = the levels' H*W concatenated), sampling locations
[B, Lq, M, L, P, 2] normalised to [0, 1] per level, attention weights
[B, Lq, M, L, P]; it returns [B, Lq, M*D] in float32. Sampling is
grid_sample(align_corners=False) with zeros padding.

For CUDA tensors it runs `MSDeformAttnFunction`: the hand-written forward
kernel (`csrc/msda.cu`) with the hand-written backward kernel
(`csrc/msda_bwd.cu`, the counterpart of the Pallas `msda_backward_pallas`)
as its gradient. CPU tensors take the plain version
`ms_deform_attn_core_reference`, the row-gather formulation of the JAX
oracle, which autograd differentiates. That gradient as a function,
`ms_deform_attn_core_backward_reference`, is the plain version of the
backward kernel. The kernels are built with nvcc into `build/` at first use
(`cuda_lib`); a failed build or launch raises.

`MSDeformAttn` is the full layer (the JAX `msda_layer`), with the reference
checkpoint's parameter names and its head-major `sampling_offsets` output
order (head, level, point, coord).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch import nn

from vlm_fo1_tpu_torch import nn as tnn
from vlm_fo1_tpu_torch.ops import cuda_lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
_lib_bwd = None


def _check(value, spatial_shapes, sampling_locations, attention_weights):
    if value.dtype not in _DTYPES:
        raise TypeError(f"ms_deform_attn_core: value dtype {value.dtype}; "
                        "need float32 or bfloat16")
    if (sampling_locations.dtype != torch.float32
            or attention_weights.dtype != torch.float32):
        raise TypeError("ms_deform_attn_core: locations and weights must be "
                        "float32")
    b, s, m, d = value.shape
    if (sampling_locations.dim() != 6 or attention_weights.dim() != 5):
        raise ValueError("ms_deform_attn_core: locations [B,Lq,M,L,P,2] and "
                         "weights [B,Lq,M,L,P]")
    bl, lq, ml, nl, npts, two = sampling_locations.shape
    if ((bl, ml, nl, two) != (b, m, len(spatial_shapes), 2)
            or attention_weights.shape != sampling_locations.shape[:5]
            or sum(h * w for h, w in spatial_shapes) != s or d > 128):
        raise ValueError(
            f"ms_deform_attn_core: shapes value {tuple(value.shape)}, "
            f"locations {tuple(sampling_locations.shape)}, weights "
            f"{tuple(attention_weights.shape)}, levels {spatial_shapes}")


def ms_deform_attn_core_reference(value, spatial_shapes, sampling_locations,
                                  attention_weights):
    """Plain PyTorch version: four separate corner gathers per level in
    float32, as the JAX `ms_deform_attn_core_reference`."""
    b, s, m, d = value.shape
    _, lq, _, _, npts, _ = sampling_locations.shape
    out = torch.zeros(b, lq, m, d, dtype=torch.float32, device=value.device)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        val = value[:, start:start + h * w].float().transpose(1, 2)  # B,M,HW,D
        start += h * w
        loc = sampling_locations[:, :, :, lvl].float()        # [B,Lq,M,P,2]
        x = loc[..., 0] * w - 0.5
        y = loc[..., 1] * h - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        lx, ly = x - x0, y - y0
        x0i, y0i = x0.long(), y0.long()

        def corner(yi, xi, wgt):
            inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)  # [B,Lq,M,P]
            idx = idx.transpose(1, 2).reshape(b, m, lq * npts, 1)
            v = torch.gather(val, 2, idx.expand(-1, -1, -1, d))
            v = v.reshape(b, m, lq, npts, d).transpose(1, 2)
            return v * torch.where(inb, wgt, 0.0)[..., None]

        sampled = (corner(y0i, x0i, (1 - ly) * (1 - lx))
                   + corner(y0i, x0i + 1, (1 - ly) * lx)
                   + corner(y0i + 1, x0i, ly * (1 - lx))
                   + corner(y0i + 1, x0i + 1, ly * lx))     # [B,Lq,M,P,D]
        aw = attention_weights[:, :, :, lvl].float()
        out = out + torch.einsum("blmpd,blmp->blmd", sampled, aw)
    return out.reshape(b, lq, m * d)


def ms_deform_attn_core_backward_reference(value, spatial_shapes,
                                           sampling_locations,
                                           attention_weights, grad_output):
    """Plain PyTorch version of the backward: autograd of the plain core in
    float32. grad_output [B, Lq, M*D] -> (grad_value in value's dtype,
    grad_loc float32, grad_aw float32), what `jax.vjp` of the JAX
    `ms_deform_attn_core` gives."""
    # float32 copies as fresh leaves, also for inputs made under inference
    # mode and for a caller inside it
    with torch.inference_mode(False), torch.enable_grad():
        v, loc, aw = (
            t.detach().to(torch.float32, copy=True).requires_grad_(True)
            for t in (value, sampling_locations, attention_weights))
        out = ms_deform_attn_core_reference(v, spatial_shapes, loc, aw)
        gv, gl, ga = torch.autograd.grad(out, (v, loc, aw),
                                         grad_output.float())
    return gv.to(value.dtype), gl, ga


def _load():
    global _lib
    if _lib is None:
        lib = cuda_lib.load("msda")
        fn = lib.fo1_msda_fwd
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
        _lib = lib
    return _lib


def _load_bwd():
    global _lib_bwd
    if _lib_bwd is None:
        lib = cuda_lib.load("msda_bwd")
        fn = lib.fo1_msda_bwd
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 8 + [ci] * 8 + [vp]
        fn.restype = ci
        _lib_bwd = lib
    return _lib_bwd


def _check_cuda(name, value, *others):
    if value.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {value.device}")
    if any(t.device != value.device for t in others):
        raise ValueError(f"{name}: inputs on different devices")
    if not all(t.is_contiguous() for t in (value, *others)):
        raise ValueError(f"{name}: inputs must be contiguous")


def _levels(spatial_shapes):
    """Host array [L][3] of (H, W, first row in S) for the kernels."""
    starts = np.cumsum([0] + [h * w for h, w in spatial_shapes])[:-1]
    return np.array([(h, w, st) for (h, w), st in
                     zip(spatial_shapes, starts)], np.int32).reshape(-1)


def _forward_kernel(value, spatial_shapes, sampling_locations,
                    attention_weights):
    """Launch `csrc/msda.cu` on checked CUDA inputs -> [B, Lq, M*D] f32."""
    _check_cuda("ms_deform_attn_core", value, sampling_locations,
                attention_weights)
    b, s, m, d = value.shape
    _, lq, _, nl, npts, _ = sampling_locations.shape
    levels = _levels(spatial_shapes)
    lib = _load()
    out = torch.empty(b, lq, m * d, dtype=torch.float32, device=value.device)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        err = lib.fo1_msda_fwd(
            value.data_ptr(), sampling_locations.data_ptr(),
            attention_weights.data_ptr(), out.data_ptr(),
            levels.ctypes.data, b, s, m, d, lq, nl, npts,
            _DTYPES[value.dtype], stream)
    if err != 0:
        raise RuntimeError(f"msda kernel launch failed: CUDA error {err}")
    ms_deform_attn_core.launches += 1
    return out


def ms_deform_attn_core_backward(value, spatial_shapes, sampling_locations,
                                 attention_weights, grad_output):
    """The MSDA backward: grad_output [B, Lq, M*D] float32 -> (grad_value
    [B, S, M, D] in value's dtype, grad_loc [B, Lq, M, L, P, 2] float32,
    grad_aw [B, Lq, M, L, P] float32). CUDA tensors launch the hand-written
    kernel (`csrc/msda_bwd.cu`), which sums grad_value with float32 atomics
    into a zeroed float32 map, cast to value's dtype after; CPU tensors
    take `ms_deform_attn_core_backward_reference`."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    _check(value, spatial_shapes, sampling_locations, attention_weights)
    b, s, m, d = value.shape
    lq = sampling_locations.shape[1]
    if (grad_output.dtype != torch.float32
            or grad_output.shape != (b, lq, m * d)):
        raise ValueError(f"ms_deform_attn_core_backward: grad_output "
                         f"{tuple(grad_output.shape)} {grad_output.dtype}; "
                         f"need ({b}, {lq}, {m * d}) float32")
    if value.device.type == "cpu":
        return ms_deform_attn_core_backward_reference(
            value, spatial_shapes, sampling_locations, attention_weights,
            grad_output)
    _check_cuda("ms_deform_attn_core_backward", value, sampling_locations,
                attention_weights, grad_output)
    _, _, _, nl, npts, _ = sampling_locations.shape
    levels = _levels(spatial_shapes)
    lib = _load_bwd()
    dev = value.device
    grad_value = torch.zeros(value.shape, dtype=torch.float32, device=dev)
    grad_loc = torch.empty_like(sampling_locations)
    grad_aw = torch.empty_like(attention_weights)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fo1_msda_bwd(
            value.data_ptr(), sampling_locations.data_ptr(),
            attention_weights.data_ptr(), grad_output.data_ptr(),
            grad_value.data_ptr(), grad_loc.data_ptr(), grad_aw.data_ptr(),
            levels.ctypes.data, b, s, m, d, lq, nl, npts,
            _DTYPES[value.dtype], stream)
    if err != 0:
        raise RuntimeError(f"msda backward kernel launch failed: CUDA error "
                           f"{err}")
    ms_deform_attn_core_backward.launches += 1
    return grad_value.to(value.dtype), grad_loc, grad_aw


ms_deform_attn_core_backward.launches = 0


class MSDeformAttnFunction(torch.autograd.Function):
    """The CUDA forward kernel with the CUDA backward kernel as its
    gradient (the JAX `custom_vjp` of `ms_deform_attn_core_flat`). It saves
    value, locations and weights, as the JAX residuals do."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations,
                attention_weights):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return _forward_kernel(value, spatial_shapes, sampling_locations,
                               attention_weights)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_output):
        value, loc, aw = ctx.saved_tensors
        gv, gl, ga = ms_deform_attn_core_backward(
            value, ctx.spatial_shapes, loc, aw, grad_output.contiguous())
        need = ctx.needs_input_grad
        return (gv if need[0] else None, None, gl if need[2] else None,
                ga if need[3] else None)


def ms_deform_attn_core(value, spatial_shapes, sampling_locations,
                        attention_weights):
    """-> [B, Lq, M*D] float32. spatial_shapes: ((H0, W0), ...) as ints.
    value float32 or bfloat16, locations and weights float32; any other
    dtype or shape raises. CUDA tensors go through `MSDeformAttnFunction`
    (forward and backward kernels); CPU tensors take the plain version,
    which autograd differentiates."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    _check(value, spatial_shapes, sampling_locations, attention_weights)
    if value.device.type == "cpu":
        return ms_deform_attn_core_reference(
            value, spatial_shapes, sampling_locations, attention_weights)
    return MSDeformAttnFunction.apply(value, spatial_shapes,
                                      sampling_locations, attention_weights)


ms_deform_attn_core.launches = 0


class MSDeformAttn(nn.Module):
    """The MSDeformAttn layer (JAX `msda_layer`, reference
    ms_deform_attn.py:100-204): value projection with padded keys zeroed,
    query-driven sampling offsets and an f32 softmax over the L*P weights of
    each head, the sampling core, output projection. Linears are [out, in]
    and `sampling_offsets` is head-major, as in the reference checkpoint."""

    def __init__(self, d_model, n_levels, n_heads, n_points):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.sampling_offsets = tnn.Linear(
            d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = tnn.Linear(
            d_model, n_heads * n_levels * n_points)
        self.value_proj = tnn.Linear(d_model, d_model)
        self.output_proj = tnn.Linear(d_model, d_model)
        # the sampling core; setting `ms_deform_attn_core_reference` here
        # runs the plain version instead (for comparisons on the card)
        self.core = ms_deform_attn_core

    def forward(self, query, reference_points, value_flatten, spatial_shapes,
                key_padding_mask=None, use_4d_normalizer=False):
        """query [B, Lq, C]; reference_points [B, Lq, L, 2] or [B, Lq, L, 4]
        in [0, 1]; value_flatten [B, S, C]; key_padding_mask [B, S] (True =
        pad). Returns [B, Lq, C] in query's dtype."""
        b, lq, c = query.shape
        nl, m, npts = self.n_levels, self.n_heads, self.n_points
        value = self.value_proj(value_flatten)
        if key_padding_mask is not None:
            value = value.masked_fill(key_padding_mask[..., None], 0.0)
        value = value.reshape(b, -1, m, c // m)
        cdt = torch.promote_types(query.dtype, torch.float32)
        offsets = self.sampling_offsets(query).reshape(
            b, lq, m, nl, npts, 2).to(cdt)
        aw = torch.softmax(
            self.attention_weights(query).reshape(b, lq, m, nl * npts)
            .to(cdt), dim=-1).reshape(b, lq, m, nl, npts)
        # 1/W, 1/H in float64, then rounded to the compute dtype
        inv_wh = torch.tensor([[1.0 / w, 1.0 / h] for h, w in spatial_shapes],
                              dtype=torch.float64).to(cdt).to(query.device)
        inv_wh = inv_wh[:, None, :]                              # [L, 1, 2]
        ref = reference_points[:, :, None, :, None, :]     # [B,Lq,1,L,1,k]
        if reference_points.shape[-1] == 2:
            loc = ref + offsets * inv_wh
        elif reference_points.shape[-1] == 4:
            norm = (inv_wh if use_4d_normalizer
                    else torch.tensor(1.0 / npts, dtype=cdt))
            loc = ref[..., :2] + offsets * norm * ref[..., 2:] * 0.5
        else:
            raise ValueError("reference_points last dim must be 2 or 4")
        out = self.core(value, spatial_shapes, loc.contiguous(),
                        aw.contiguous())
        return self.output_proj(out.to(query.dtype))
