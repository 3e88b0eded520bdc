"""Hybrid Fine-grained Region Encoder (counterpart of
`vlm_fo1_tpu/models/hfre.py`) for the released checkpoint's configuration:

  aux path: every DaViT stage map pooled by ROIAlign(7x7, 0.25) at the
            stage-0 resolution, with stages 1..3 upsampled virtually (the
            bilinear upsample folded into the pooling weights), channel
            concat -> [N, sum C_i]
  vt path:  the concatenated ViT captures [gh, gw, 4D] pooled by
            ROIAlign(7x7, 1/14) -> [N, 4D]
  combine:  concat, plus the sine embedding of the normalized (cx, cy, w, h)
            ViT-space box (strategy `bbox_based`).

The other variants of the JAX module (SimpleFPN vt path, separate or
aux-only position embeddings, feature-map position embeddings, mean
combination, region LayerNorms) raise NotImplementedError. The module has no
parameters in this configuration. ROI numerics are fp32.
"""

from __future__ import annotations

import math

import torch

from vlm_fo1_tpu_torch.config import HFREConfig
from vlm_fo1_tpu_torch.ops.roi_align import roi_align_mean_separable


def gen_sineembed_for_position(pos, dim_feats: int):
    """pos [N, 4] (cx, cy, w, h) in [0, 1] -> [N, 4*dim_feats] ordered
    (y, x, w, h) with interleaved sin/cos pairs."""
    dim_t = torch.arange(dim_feats, dtype=torch.float32, device=pos.device)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                        / dim_feats)

    def embed(coord):
        f = coord[:, None] * (2 * math.pi) / dim_t
        # explicit width: with zero boxes a -1 cannot be inferred
        return torch.stack([f[:, 0::2].sin(), f[:, 1::2].cos()],
                           dim=-1).reshape(coord.shape[0], dim_feats)

    return torch.cat([embed(pos[:, 1]), embed(pos[:, 0]), embed(pos[:, 2]),
                      embed(pos[:, 3])], dim=-1)


def _xyxy_to_normalized_cxcywh(boxes, img_w, img_h):
    x1, y1 = boxes[:, 0] / img_w, boxes[:, 1] / img_h
    x2, y2 = boxes[:, 2] / img_w, boxes[:, 3] / img_h
    w, h = x2 - x1, y2 - y1
    return torch.stack([x1 + w / 2, y1 + h / 2, w, h], dim=-1)


def _check_supported(cfg: HFREConfig):
    unsupported = {
        "use_vt_region_feature_only": cfg.use_vt_region_feature_only,
        "use_simple_fpn_for_vt": cfg.use_simple_fpn_for_vt,
        "apply_region_layer_norm": cfg.apply_region_layer_norm,
        "not use_vision_tower_region_feature":
            not cfg.use_vision_tower_region_feature,
        "region_feature_combination != concat":
            cfg.region_feature_combination != "concat",
        "pos_embedding_strategy != bbox_based":
            cfg.apply_position_embedding
            and cfg.pos_embedding_strategy != "bbox_based",
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"HFRE variant not ported yet: {bad}")


def roi_align_aux_levels(aux_maps, boxes, cfg: HFREConfig):
    """Pool each [Hi, Wi, Ci] level at stage-0 resolution without
    materializing the upsampled maps -> [N, sum Ci] fp32."""
    h0, w0 = aux_maps[0].shape[:2]
    feats = []
    for m in aux_maps:
        hi, wi = m.shape[:2]
        if h0 % hi or w0 % wi or h0 // hi != w0 // wi:
            raise NotImplementedError(
                f"aux level {hi}x{wi} is not an integer scale of {h0}x{w0}")
        feats.append(roi_align_mean_separable(
            m.float(), boxes, cfg.roi_output_size, cfg.aux_spatial_scale,
            sampling_ratio=cfg.roi_sampling_ratio, upsample=h0 // hi))
    return torch.cat(feats, dim=-1)


def hfre_forward(cfg: HFREConfig, aux_maps, aux_boxes, vt_map, vt_boxes):
    """aux_maps: list of [Hi, Wi, Ci] stage maps; aux_boxes [N, 4] xyxy in
    aux-input pixels; vt_map [gh, gw, 4D]; vt_boxes [N, 4] xyxy in
    ViT-input pixels. Returns region features [N, region_feature_dim]
    fp32."""
    _check_supported(cfg)
    aux_feat = roi_align_aux_levels(aux_maps, aux_boxes, cfg)
    vt_feat = roi_align_mean_separable(
        vt_map.float(), vt_boxes, cfg.roi_output_size, cfg.vt_spatial_scale,
        sampling_ratio=cfg.roi_sampling_ratio)
    out = torch.cat([aux_feat, vt_feat], dim=-1)
    if cfg.apply_position_embedding:
        gh, gw = vt_map.shape[:2]
        pos = _xyxy_to_normalized_cxcywh(vt_boxes.float(),
                                         gw / cfg.vt_spatial_scale,
                                         gh / cfg.vt_spatial_scale)
        out = out + gen_sineembed_for_position(pos,
                                               cfg.region_feature_dim // 4)
    return out
