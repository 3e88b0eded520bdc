"""Pooled ROIAlign on channel-last maps (counterpart of
`roi_align_mean_separable` in `vlm_fo1_tpu/ops/roi_align.py`).

Plain PyTorch: the JAX package computes this with matmuls, not a Pallas
kernel, and torchvision is not a dependency. Numerics follow torchvision's
roi_align (aligned=False) followed by a spatial mean, including the adaptive
sampling ratio (sampling_ratio=-1): the pooled weight matrix separates into
per-axis vectors, so the data-dependent tap count only moves weights inside a
fixed tap buffer. `upsample=f` pools a virtually bilinear-upsampled map by
folding a [H*f, H] interpolation matrix into the per-axis weights.
"""

from __future__ import annotations

import torch


def _axis_pooled_weights(lo, hi, size, out_bins, ns_max, sampling_ratio):
    """lo, hi [N] box extent on one axis in grid units -> [N, size] fp32
    weights (the bin-mean factor included, out-of-bounds taps zero)."""
    n = lo.shape[0]
    dev = lo.device
    bin_sz = torch.clamp(hi - lo, min=1.0) / out_bins
    if sampling_ratio > 0:
        ns_max = int(sampling_ratio)
        ns = torch.full((n,), ns_max, dtype=torch.int64, device=dev)
    else:  # torchvision adaptive: ceil(roi_extent / pooled_extent)
        ns = torch.clamp(torch.ceil(bin_sz).long(), 1, ns_max)
    t = torch.arange(out_bins * ns_max, device=dev)
    pb = (t // ns_max).float()
    s = t % ns_max
    nsf = ns.float()[:, None]
    pos = lo[:, None] + (pb[None] + (s[None].float() + 0.5) / nsf) \
        * bin_sz[:, None]
    live = (s[None] < ns[:, None]) & (pos >= -1.0) & (pos <= size)
    wt = torch.where(live, 1.0 / (out_bins * nsf), torch.zeros_like(pos))
    pc = torch.clamp(pos, 0.0, size - 1)
    i0 = torch.floor(pc).long()
    i1 = torch.clamp(i0 + 1, max=size - 1)
    frac = pc - i0.float()
    # sums over one-hot taps, not scatter_add_: on the card scatter_add_
    # adds with atomics in no fixed order, and the region features would
    # change in their last bits from one run to the next
    cols = torch.arange(size, device=dev)
    w = ((i0[..., None] == cols) * (wt * (1.0 - frac))[..., None]).sum(1)
    return w + ((i1[..., None] == cols) * (wt * frac)[..., None]).sum(1)


def _upsample_matrix_1d(size: int, factor: int, device) -> torch.Tensor:
    """[size*factor, size] bilinear upsample weights (half-pixel centers,
    edge clamp: F.interpolate(align_corners=False))."""
    hi_size = size * factor
    up = torch.arange(hi_size, device=device, dtype=torch.float64)
    src = torch.clamp((up + 0.5) / factor - 0.5, 0.0, size - 1)
    lo = torch.floor(src).long()
    hi = torch.clamp(lo + 1, max=size - 1)
    t = (src - lo).float()
    rows = torch.arange(hi_size, device=device)
    u = torch.zeros((hi_size, size), dtype=torch.float32, device=device)
    u.index_put_((rows, lo), 1.0 - t, accumulate=True)
    u.index_put_((rows, hi), t, accumulate=True)
    return u


def roi_align_mean_separable(feat, boxes, output_size, spatial_scale,
                             sampling_ratio=-1, upsample=1):
    """feat [H, W, C], boxes [N, 4] xyxy in input pixels -> [N, C] fp32:
    ROIAlign(output_size, spatial_scale) averaged over the output bins."""
    h, w, c = feat.shape
    f = int(upsample)
    h0, w0 = h * f, w * f
    boxes = boxes.float() * spatial_scale
    ns_max_y = -(-h0 // int(output_size))
    ns_max_x = -(-w0 // int(output_size))
    wy = _axis_pooled_weights(boxes[:, 1], boxes[:, 3], h0, int(output_size),
                              ns_max_y, sampling_ratio)
    wx = _axis_pooled_weights(boxes[:, 0], boxes[:, 2], w0, int(output_size),
                              ns_max_x, sampling_ratio)
    if f > 1:
        wy = wy @ _upsample_matrix_1d(h, f, feat.device)
        wx = wx @ _upsample_matrix_1d(w, f, feat.device)
    wmat = (wy[:, :, None] * wx[:, None, :]).reshape(boxes.shape[0], h * w)
    return wmat @ feat.reshape(h * w, c).float()
