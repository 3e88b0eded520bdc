"""Hybrid Fine-grained Region Encoder (counterpart of
`vlm_fo1_tpu/models/hfre.py`), every variant of the JAX module:

  aux path: every DaViT stage map pooled by ROIAlign(7x7, 0.25) at the
            stage-0 resolution, with stages 1..3 upsampled virtually (the
            bilinear upsample folded into the pooling weights), channel
            concat -> [N, sum C_i]; or one pre-concatenated map
            (`upsample_concat_aux`) pooled directly; feature-map position
            embeddings added to each level first (strategies
            `feature_map_based` / `hybrid`)
  vt path:  the concatenated ViT captures [gh, gw, 4D] pooled by
            ROIAlign(7x7, 1/14) -> [N, 4D], or a SimpleFPN pyramid of that
            map pooled level by level at strides 3.5 / 7 / 14 / 28
  combine:  `concat` / `mean` (and their `_aux_pos`, `_sep_pos`,
            `_sep_no_vt_pos` forms), optional region LayerNorms per path,
            then the sine embedding of the normalized (cx, cy, w, h) box
            (strategies `bbox_based` / `hybrid`); or the vt path alone
            (`use_vt_region_feature_only`), or the aux path alone
            (`use_vision_tower_region_feature=False`).

The released configuration (concat, bbox_based, no LayerNorms) has no
parameters. The parameters of the others live on `HFRE`, the port's
`object_vp_extractor`: `aux_region_norm` / `vt_region_norm` (when
`apply_region_layer_norm`; the JAX module applies each only when the
checkpoint holds it, and so does the port, whose loader drops a norm the
checkpoint lacks) and `simple_fpn` (when `use_simple_fpn_for_vt`). ROI
numerics are fp32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vlm_fo1_tpu_torch import nn as tnn
from vlm_fo1_tpu_torch.config import HFREConfig
from vlm_fo1_tpu_torch.models.simple_fpn import SimpleFPN
from vlm_fo1_tpu_torch.ops.roi_align import roi_align_mean_separable

# SimpleFPN level strides for a 14 px-patch ViT
FPN_STRIDES = (3.5, 7.0, 14.0, 28.0)
_COMBINATIONS = ("concat", "concat_aux_pos", "mean", "mean_aux_pos",
                 "concat_sep_pos", "mean_sep_pos", "concat_sep_no_vt_pos",
                 "mean_sep_no_vt_pos")


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


def generate_2d_position_embedding(height: int, width: int, dim: int,
                                   device=None):
    """2D sine/cos encoding [H, W, dim]: per axis, normalized coordinates
    scaled by 2*pi over a quarter-dim frequency bank, (y-block, x-block)."""
    quarter = dim // 4
    y = torch.arange(height, dtype=torch.float32, device=device) / height
    x = torch.arange(width, dtype=torch.float32, device=device) / width
    yg, xg = torch.meshgrid(y, x, indexing="ij")
    if quarter > 0:
        dim_t = torch.arange(quarter, dtype=torch.float32, device=device)
        dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / quarter)
    else:
        dim_t = torch.ones(1, dtype=torch.float32, device=device)

    def embed(grid):
        f = grid[..., None] * (2 * math.pi) / dim_t
        return torch.stack([f.sin(), f.cos()], dim=-1).reshape(
            height, width, -1)

    return torch.cat([embed(yg), embed(xg)], dim=-1)


def _apply_feature_map_pos(aux_maps):
    """Each aux level plus its 2D position encoding (strategies
    feature_map_based / hybrid)."""
    out = []
    for m in aux_maps:
        h, w, c = m.shape
        pe = generate_2d_position_embedding(h, w, c, m.device)
        out.append(m + pe[..., :c].to(m.dtype))
    return out


def _xyxy_to_normalized_cxcywh(boxes, img_w, img_h):
    x1, y1 = boxes[:, 0] / img_w, boxes[:, 1] / img_h
    x2, y2 = boxes[:, 2] / img_w, boxes[:, 3] / img_h
    w, h = x2 - x1, y2 - y1
    return torch.stack([x1 + w / 2, y1 + h / 2, w, h], dim=-1)


def _bilinear_to(m, h0, w0):
    """Channel-last [..., H, W, C] -> [..., h0, w0, C] f32, half-pixel
    centers (`jax.image.resize` bilinear when upsampling)."""
    lead = m.shape[:-3]
    x = m.float().reshape(-1, *m.shape[-3:]).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(h0, w0), mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1).reshape(*lead, h0, w0, m.shape[-1])


def upsample_concat_aux(aux_maps):
    """Stages 1..3 bilinearly upsampled to stage-0 size and concatenated
    with it: list of [B, Hi, Wi, Ci] -> [B, H0, W0, sum Ci] f32."""
    h0, w0 = aux_maps[0].shape[1:3]
    return torch.cat([aux_maps[0].float()]
                     + [_bilinear_to(m, h0, w0) for m in aux_maps[1:]],
                     dim=-1)


def roi_align_aux_levels(aux_maps, boxes, cfg: HFREConfig):
    """Pool each [Hi, Wi, Ci] level at stage-0 resolution -> [N, sum Ci]
    fp32: an integer-scale level without materializing its upsampled map,
    any other level upsampled first."""
    h0, w0 = aux_maps[0].shape[:2]
    feats = []
    for m in aux_maps:
        hi, wi = m.shape[:2]
        if h0 % hi == 0 and w0 % wi == 0 and h0 // hi == w0 // wi:
            feats.append(roi_align_mean_separable(
                m.float(), boxes, cfg.roi_output_size, cfg.aux_spatial_scale,
                sampling_ratio=cfg.roi_sampling_ratio, upsample=h0 // hi))
        else:
            feats.append(roi_align_mean_separable(
                _bilinear_to(m, h0, w0), boxes, cfg.roi_output_size,
                cfg.aux_spatial_scale, sampling_ratio=cfg.roi_sampling_ratio))
    return torch.cat(feats, dim=-1)


class HFRE(nn.Module):
    """The HFRE's parameters (none in the released configuration) and its
    forward. Submodules by the checkpoint's `object_vp_extractor.*` names."""

    def __init__(self, cfg: HFREConfig, vt_dim: int):
        """vt_dim: channels of the concatenated ViT captures (the SimpleFPN
        input)."""
        super().__init__()
        self.cfg = cfg
        if cfg.apply_region_layer_norm:
            self.aux_region_norm = tnn.LayerNorm(
                sum(cfg.aux_region_feature_dims))
            self.vt_region_norm = tnn.LayerNorm(cfg.vt_region_feature_dim)
        if cfg.use_simple_fpn_for_vt:
            self.simple_fpn = SimpleFPN(vt_dim,
                                        cfg.vt_region_feature_dim // 4)

    def forward(self, aux_maps, aux_boxes, vt_map, vt_boxes):
        return hfre_forward(self.cfg, aux_maps, aux_boxes, vt_map, vt_boxes,
                            params=self)


def _norm(params, name, x):
    mod = getattr(params, name, None)
    return x if mod is None else mod(x)


def hfre_forward(cfg: HFREConfig, aux_maps, aux_boxes, vt_map, vt_boxes,
                 params: HFRE | None = None):
    """aux_maps: list of [Hi, Wi, Ci] stage maps, or one pre-concatenated
    [H0, W0, sum Ci] map; aux_boxes [N, 4] xyxy in aux-input pixels; vt_map
    [gh, gw, 4D]; vt_boxes [N, 4] xyxy in ViT-input pixels; params: the
    `HFRE` holding the region LayerNorms and the SimpleFPN, if any. Returns
    region features [N, region_feature_dim] fp32."""
    if cfg.use_vt_region_feature_only:
        out = _extract_vt_feature(params, cfg, vt_map, vt_boxes)
        if cfg.apply_position_embedding:
            out = out + _vt_pos_embed(vt_map, vt_boxes, cfg,
                                      cfg.region_feature_dim // 4)
        return out

    if isinstance(aux_maps, (list, tuple)):
        if (cfg.apply_position_embedding
                and cfg.pos_embedding_strategy in ("feature_map_based",
                                                   "hybrid")):
            aux_maps = _apply_feature_map_pos(aux_maps)
        h0, w0 = aux_maps[0].shape[:2]
        aux_feat = roi_align_aux_levels(aux_maps, aux_boxes, cfg)
    else:
        h0, w0 = aux_maps.shape[:2]
        aux_feat = roi_align_mean_separable(
            aux_maps.float(), aux_boxes, cfg.roi_output_size,
            cfg.aux_spatial_scale, sampling_ratio=cfg.roi_sampling_ratio)
    if cfg.apply_region_layer_norm:
        aux_feat = _norm(params, "aux_region_norm", aux_feat)

    comb = cfg.region_feature_combination
    if not cfg.use_vision_tower_region_feature:
        out = aux_feat
    elif comb not in _COMBINATIONS:
        raise NotImplementedError(
            f"region_feature_combination={comb!r} is not supported")
    else:
        vt_feat = _extract_vt_feature(params, cfg, vt_map, vt_boxes)
        if cfg.apply_region_layer_norm:
            vt_feat = _norm(params, "vt_region_norm", vt_feat)
        if "_sep_" in comb:
            # separate position embeddings per path: aux boxes at the aux
            # width, vt boxes (unless *_no_vt_pos) at the vt width
            aux_pos = _xyxy_to_normalized_cxcywh(
                aux_boxes.float(), w0 / cfg.aux_spatial_scale,
                h0 / cfg.aux_spatial_scale)
            aux_feat = aux_feat + gen_sineembed_for_position(
                aux_pos, aux_feat.shape[-1] // 4)
            if not comb.endswith("_no_vt_pos"):
                vt_feat = vt_feat + _vt_pos_embed(vt_map, vt_boxes, cfg,
                                                  vt_feat.shape[-1] // 4)
        if comb.startswith("concat"):
            out = torch.cat([aux_feat, vt_feat], dim=-1)
        else:
            out = (aux_feat + vt_feat) / 2

    if cfg.apply_position_embedding and cfg.pos_embedding_strategy in (
            "bbox_based", "hybrid"):
        if (cfg.use_vision_tower_region_feature and vt_boxes is not None
                and comb not in ("concat_aux_pos", "mean_aux_pos")):
            out = out + _vt_pos_embed(vt_map, vt_boxes, cfg,
                                      cfg.region_feature_dim // 4)
        else:
            pos = _xyxy_to_normalized_cxcywh(
                aux_boxes.float(), w0 / cfg.aux_spatial_scale,
                h0 / cfg.aux_spatial_scale)
            out = out + gen_sineembed_for_position(
                pos, cfg.region_feature_dim // 4)
    return out


def _extract_vt_feature(params, cfg: HFREConfig, vt_map, vt_boxes):
    """One ROIAlign on the concatenated captures, or the SimpleFPN pyramid
    pooled level by level at its strides."""
    if cfg.use_simple_fpn_for_vt:
        levels = params.simple_fpn(vt_map.float()[None])
        return torch.cat([
            roi_align_mean_separable(lvl[0], vt_boxes, cfg.roi_output_size,
                                     1.0 / stride,
                                     sampling_ratio=cfg.roi_sampling_ratio)
            for lvl, stride in zip(levels, FPN_STRIDES)], dim=-1)
    return roi_align_mean_separable(vt_map.float(), vt_boxes,
                                    cfg.roi_output_size, cfg.vt_spatial_scale,
                                    sampling_ratio=cfg.roi_sampling_ratio)


def _vt_pos_embed(vt_map, vt_boxes, cfg: HFREConfig, dim_feats: int):
    gh, gw = vt_map.shape[:2]
    pos = _xyxy_to_normalized_cxcywh(vt_boxes.float(),
                                     gw / cfg.vt_spatial_scale,
                                     gh / cfg.vt_spatial_scale)
    return gen_sineembed_for_position(pos, dim_feats)
