"""UPN, the universal proposal network (counterpart of
`vlm_fo1_tpu/upn/model.py`).

Swin-L -> per-level 1x1 conv + GroupNorm projections plus one extra stride-2
level -> 6-layer deformable encoder -> two-stage proposal selection against
a fine/coarse granularity prompt -> 6-layer decoder with iterative box
refinement -> boxes and objectness from the LayerNormed decoder states.
The deformable attention is `ops.msda.MSDeformAttn` (the CUDA kernel on the
card). Box coordinates stay float32 under bfloat16 features.

Parameters carry the reference checkpoint's names: `backbone.model.backbone.*`
(the Swin), `input_proj.{l}.{0,1}`, `transformer.level_embed`,
`transformer.encoder.layers.{i}.*`, `transformer.decoder.{layers, norm,
ref_point_head}`, `transformer.{tgt_embed, enc_output, enc_output_norm,
enc_out_bbox_embed, fine_grained_prompt, coarse_grained_prompt}` and
`bbox_embed.0` (the decoder's shared box head).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from vlm_fo1_tpu_torch import nn as tnn
from vlm_fo1_tpu_torch.ops.msda import MSDeformAttn
from vlm_fo1_tpu_torch.runtime.device import resolve_device, stage_timer
from vlm_fo1_tpu_torch.upn.swin import SwinConfig, SwinTransformer


@dataclass(frozen=True)
class UPNConfig:
    d_model: int = 256
    n_heads: int = 8
    n_points: int = 4
    num_feature_levels: int = 5
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    d_ffn: int = 2048
    num_queries: int = 900
    gn_groups: int = 32
    pos_feats: int = 128
    pos_temperature: float = 20.0

    @classmethod
    def from_config_dict(cls, model_cfg: dict) -> "UPNConfig":
        """Read the reference's declarative `model=dict(...)` tree
        (configs/upn_large.py); nested type= dicts collapse into this
        config and unknown keys are ignored."""
        t = model_cfg.get("transformer_cfg", {})
        enc = t.get("encoder_cfg", {})
        dec = t.get("decoder_cfg", {})
        layer = enc.get("encoder_layer_cfg", {})
        pos = (model_cfg.get("vision_backbone_cfg", {})
               .get("position_embedding_cfg", {}))
        return cls(
            d_model=layer.get("d_model", cls.d_model),
            n_heads=layer.get("n_heads", cls.n_heads),
            num_feature_levels=t.get("num_feature_levels",
                                     layer.get("n_levels",
                                               cls.num_feature_levels)),
            num_encoder_layers=enc.get("num_layers", cls.num_encoder_layers),
            num_decoder_layers=dec.get("num_layers", cls.num_decoder_layers),
            d_ffn=layer.get("d_ffn", cls.d_ffn),
            num_queries=model_cfg.get("num_queries", cls.num_queries),
            pos_feats=pos.get("num_pos_feats", cls.pos_feats),
            pos_temperature=float(pos.get("temperatureH",
                                          cls.pos_temperature)),
        )

    @classmethod
    def from_config_file(cls, path: str) -> "UPNConfig":
        """Execute a reference-style python config file and read its
        `model` dict."""
        ns: dict = {}
        with open(path) as f:
            exec(compile(f.read(), path, "exec"), ns)  # noqa: S102
        if "model" not in ns:
            raise ValueError(f"{path} defines no `model` dict")
        return cls.from_config_dict(ns["model"])


def inverse_sigmoid(x, eps=1e-3):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def _interleave(v):
    """sin on even features, cos on odd, interleaved back."""
    return torch.stack([torch.sin(v[..., 0::2]), torch.cos(v[..., 1::2])],
                       dim=-1).flatten(-2)


def sine_position_embedding(h: int, w: int, valid_h, valid_w,
                            num_pos_feats=128, temperature=20.0):
    """PositionEmbeddingSineHW with normalize=True (reference
    detr_utils.py:79-149), in float32. valid_h / valid_w: [B] tensors.
    Returns [B, H, W, 2 * num_pos_feats]."""
    dev = valid_h.device
    ys = torch.arange(1, h + 1, dtype=torch.float32, device=dev)[:, None] \
        * torch.ones(1, w, device=dev)
    xs = torch.ones(h, 1, device=dev) \
        * torch.arange(1, w + 1, dtype=torch.float32, device=dev)[None, :]
    valid = ((torch.arange(h, device=dev)[None, :, None] < valid_h[:, None,
                                                                   None])
             & (torch.arange(w, device=dev)[None, None, :]
                < valid_w[:, None, None]))                     # [B, H, W]
    ys = torch.where(valid, ys, 0.0)
    xs = torch.where(valid, xs, 0.0)
    eps, scale = 1e-6, 2 * math.pi
    y_embed = ys / (ys.amax(dim=1, keepdim=True) + eps) * scale
    x_embed = xs / (xs.amax(dim=2, keepdim=True) + eps) * scale
    dim_t = temperature ** (
        2 * torch.div(torch.arange(num_pos_feats, dtype=torch.float32,
                                   device=dev), 2, rounding_mode="floor")
        / num_pos_feats)
    return torch.cat([_interleave(y_embed[..., None] / dim_t),
                      _interleave(x_embed[..., None] / dim_t)], dim=-1)


def sineembed_512(pos, d=128):
    """gen_sineembed_for_position (detr_utils.py:276-310): d features per
    coordinate in the order (y, x, w, h). pos [B, N, 4] -> [B, N, 4d]."""
    dim_t = 10000.0 ** (
        2 * torch.div(torch.arange(d, dtype=torch.float32, device=pos.device),
                      2, rounding_mode="floor") / d)

    def emb(c):
        return _interleave(c[..., None] * (2 * math.pi) / dim_t)

    return torch.cat([emb(pos[..., 1]), emb(pos[..., 0]), emb(pos[..., 2]),
                      emb(pos[..., 3])], dim=-1)


def encoder_reference_points(spatial_shapes, valid_ratios):
    """[B, S, L, 2] per-level grid centres normalised by the valid region
    (reference upn_encoder.py:193-208), float32."""
    dev = valid_ratios.device
    vr = valid_ratios.float()
    pts = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
            torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
            indexing="ij")
        gy = gy.reshape(-1)[None] / (vr[:, None, lvl, 1] * h)
        gx = gx.reshape(-1)[None] / (vr[:, None, lvl, 0] * w)
        pts.append(torch.stack([gx, gy], -1))
    return torch.cat(pts, 1)[:, :, None] * vr[:, None]


def gen_anchor_proposals(spatial_shapes, valid_ratios):
    """Per-pixel anchors (cx, cy, w, h) with wh = 0.05 * 2^level (reference
    detr_utils.py:351-415), float32 [B, S, 4]."""
    dev = valid_ratios.device
    b = valid_ratios.shape[0]
    props = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=dev),
            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
        grid = torch.stack([gx, gy], -1)[None]               # [1, H, W, 2]
        valid_wh = valid_ratios.float()[:, lvl] * torch.tensor(
            [w, h], dtype=torch.float32, device=dev)
        grid = (grid + 0.5) / valid_wh[:, None, None, :]
        wh = torch.full_like(grid, 0.05 * 2.0**lvl)
        props.append(torch.cat([grid, wh], -1).reshape(b, -1, 4))
    return torch.cat(props, 1)


class _Mlp(nn.Module):
    def __init__(self, dims):
        super().__init__()
        self.layers = nn.ModuleList(
            tnn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        return tnn.mlp(self.layers, x)


class _Ffn(nn.Module):
    """linear2(relu(linear1(x))) + residual, then the named LayerNorm."""

    def ffn(self, x, norm):
        return norm(x + self.linear2(F.relu(self.linear1(x))))


class EncoderLayer(_Ffn):
    def __init__(self, cfg: UPNConfig):
        super().__init__()
        d = cfg.d_model
        self.self_attn = MSDeformAttn(d, cfg.num_feature_levels, cfg.n_heads,
                                      cfg.n_points)
        self.norm1 = tnn.LayerNorm(d)
        self.linear1 = tnn.Linear(d, cfg.d_ffn)
        self.linear2 = tnn.Linear(cfg.d_ffn, d)
        self.norm2 = tnn.LayerNorm(d)

    def forward(self, mem, pos, ref, shapes, key_pad):
        attn = self.self_attn(mem + pos, ref, mem, shapes,
                              key_padding_mask=key_pad)
        return self.ffn(self.norm1(mem + attn), self.norm2)


class DecoderLayer(_Ffn):
    def __init__(self, cfg: UPNConfig):
        super().__init__()
        d = cfg.d_model
        self.cross_attn = MSDeformAttn(d, cfg.num_feature_levels,
                                       cfg.n_heads, cfg.n_points)
        self.norm1 = tnn.LayerNorm(d)
        self.self_attn = tnn.MultiheadAttention(d, cfg.n_heads)
        self.norm2 = tnn.LayerNorm(d)
        self.linear1 = tnn.Linear(d, cfg.d_ffn)
        self.linear2 = tnn.Linear(cfg.d_ffn, d)
        self.norm3 = tnn.LayerNorm(d)

    def forward(self, out, query_pos, ref_input, memory, shapes, key_pad):
        q = out + query_pos
        out = self.norm2(out + self.self_attn(q, q, out))
        cross = self.cross_attn(out + query_pos, ref_input, memory, shapes,
                                key_padding_mask=key_pad)
        return self.ffn(self.norm1(out + cross), self.norm3)


class _Module(nn.Module):
    """A named holder of submodules (keeps the checkpoint's key paths)."""

    def __init__(self, **children):
        super().__init__()
        for name, mod in children.items():
            self.add_module(name, mod)


class UPN(nn.Module):
    def __init__(self, cfg: UPNConfig, swin_cfg: SwinConfig, *,
                 device="cuda", dtype=torch.float32):
        """Allocates uninitialised parameters on `device`; fill them with
        `upn.wrapper.random_init_` or a state dict."""
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.swin_cfg, self.device = cfg, swin_cfg, device
        d, nl = cfg.d_model, cfg.num_feature_levels
        with torch.device("meta"):
            self.backbone = _Module(model=_Module(
                backbone=SwinTransformer(swin_cfg)))
            nb = len(swin_cfg.out_indices)
            proj = [nn.ModuleList([
                tnn.Conv2d(swin_cfg.num_features[i], d, 1),
                tnn.GroupNorm(cfg.gn_groups, d)]) for i in range(nb)]
            in_ch = swin_cfg.num_features[-1]
            for _ in range(nb, nl):
                proj.append(nn.ModuleList([
                    tnn.Conv2d(in_ch, d, 3), tnn.GroupNorm(cfg.gn_groups, d)]))
                in_ch = d
            self.input_proj = nn.ModuleList(proj)
            self.transformer = _Module(
                encoder=_Module(layers=nn.ModuleList(
                    EncoderLayer(cfg) for _ in range(cfg.num_encoder_layers))),
                decoder=_Module(
                    layers=nn.ModuleList(
                        DecoderLayer(cfg)
                        for _ in range(cfg.num_decoder_layers)),
                    norm=tnn.LayerNorm(d),
                    ref_point_head=_Mlp((2 * d, d, d))),
                tgt_embed=tnn.Weight(cfg.num_queries, d),
                enc_output=tnn.Linear(d, d),
                enc_output_norm=tnn.LayerNorm(d),
                enc_out_bbox_embed=_Mlp((d, d, d, 4)),
                fine_grained_prompt=tnn.Weight(1, d),
                coarse_grained_prompt=tnn.Weight(1, d))
            self.transformer.level_embed = nn.Parameter(torch.empty(nl, d))
            self.bbox_embed = nn.ModuleList([_Mlp((d, d, d, 4))])
        self.to(dtype=dtype)
        self.to_empty(device=device)
        self.requires_grad_(False)

    def use_msda_core(self, core):
        """Route every deformable-attention layer through `core`
        (`ops.msda.ms_deform_attn_core` by default)."""
        for mod in self.modules():
            if isinstance(mod, MSDeformAttn):
                mod.core = core

    # --------------------------------------------------------- stages

    def features(self, image, valid_hw):
        """Backbone, input projections, flattened levels. Returns (src,
        pos, spatial_shapes, valid_ratios, key_pad)."""
        cfg = self.cfg
        b = image.shape[0]
        feats = self.backbone.model.backbone(image)
        srcs = []
        for i, f in enumerate(feats):
            conv, gn = self.input_proj[i]
            srcs.append(gn(tnn.conv2d_nhwc(conv, f)))
        extra = feats[-1]
        for i in range(len(feats), cfg.num_feature_levels):
            conv, gn = self.input_proj[i]
            extra = gn(tnn.conv2d_nhwc(conv, extra, stride=2, padding=1))
            srcs.append(extra)
        shapes = tuple((s.shape[1], s.shape[2]) for s in srcs)
        strides = [4 * 2**i for i in range(len(feats))]
        strides += [strides[-1] * 2**(i + 1)
                    for i in range(cfg.num_feature_levels - len(feats))]
        vh = valid_hw[:, 0:1].float()
        vw = valid_hw[:, 1:2].float()
        level_embed = self.transformer.level_embed
        src_flat, pos_flat, ratios, masks = [], [], [], []
        for lvl, s in enumerate(srcs):
            h, w = shapes[lvl]
            lvh_f = torch.ceil(vh / strides[lvl])[:, 0]
            lvw_f = torch.ceil(vw / strides[lvl])[:, 0]
            lvh, lvw = lvh_f.int(), lvw_f.int()
            pos = sine_position_embedding(h, w, lvh, lvw, cfg.pos_feats,
                                          cfg.pos_temperature)
            # float32 table plus the level embed, then the feature dtype
            pos_flat.append((pos + level_embed[lvl].float())
                            .to(s.dtype).reshape(b, -1, cfg.d_model))
            src_flat.append(s.reshape(b, -1, cfg.d_model))
            ratios.append(torch.stack([lvw.float() / w, lvh.float() / h],
                                      -1))
            mh = torch.arange(h, device=s.device)[None, :] >= lvh_f[:, None]
            mw = torch.arange(w, device=s.device)[None, :] >= lvw_f[:, None]
            masks.append((mh[:, :, None] | mw[:, None, :]).reshape(b, -1))
        return (torch.cat(src_flat, 1), torch.cat(pos_flat, 1), shapes,
                torch.stack(ratios, 1), torch.cat(masks, 1))

    def encoder(self, src, pos, shapes, valid_ratios, key_pad):
        memory = src
        ref = encoder_reference_points(shapes, valid_ratios)
        for layer in self.transformer.encoder.layers:
            memory = layer(memory, pos, ref, shapes, key_pad)
        return memory

    def decoder(self, memory, shapes, valid_ratios, key_pad, prompt):
        """Two-stage proposals, the decoder and the box / logit heads.
        Returns (pred_boxes [B, nq, 4] float32 cxcywh, pred_logits
        [B, nq, 1] float32, topk_idx [B, nq])."""
        cfg, tr = self.cfg, self.transformer
        b = memory.shape[0]
        proposals = gen_anchor_proposals(shapes, valid_ratios)
        prop_valid = ((proposals > 0.01) & (proposals < 0.99)).all(-1)
        prop_valid = prop_valid & ~key_pad
        proposals_unsig = torch.where(prop_valid[..., None],
                                      inverse_sigmoid(proposals, eps=0.0),
                                      torch.inf)
        out_mem = torch.where(prop_valid[..., None], memory, 0.0)
        out_mem = tr.enc_output_norm(tr.enc_output(out_mem))
        prompt_emb = (getattr(tr, prompt).weight[0] if prompt
                      else torch.zeros(cfg.d_model, dtype=memory.dtype,
                                       device=memory.device))
        logits = (out_mem @ prompt_emb).float()                # [B, S]
        # Invalid border anchors are not masked out: they compete with one
        # identical score. A stable descending sort puts the lower index
        # first among equal scores, as lax.top_k does.
        topk_idx = torch.sort(logits, dim=-1, descending=True,
                              stable=True).indices[:, :cfg.num_queries]
        coords_unsig = tr.enc_out_bbox_embed(out_mem).float() \
            + proposals_unsig
        ref = torch.sigmoid(torch.gather(
            coords_unsig, 1, topk_idx[..., None].expand(-1, -1, 4)))
        out = tr.tgt_embed.weight[None].expand(b, -1, -1)
        vr4 = torch.cat([valid_ratios, valid_ratios], -1).float()
        ref_before = ref
        for layer in tr.decoder.layers:
            ref_input = ref[:, :, None] * vr4[:, None]         # [B,nq,L,4]
            qse = sineembed_512(ref_input[:, :, 0, :], d=cfg.d_model // 2)
            query_pos = tr.decoder.ref_point_head(qse).to(out.dtype)
            out = layer(out, query_pos, ref_input, memory, shapes, key_pad)
            # iterative refinement from the raw layer output
            delta = self.bbox_embed[0](out).float()
            ref_before, ref = ref, torch.sigmoid(delta + inverse_sigmoid(ref))
        # the reported boxes redo the last refinement from the normed states
        hs = tr.decoder.norm(out)
        pred_boxes = torch.sigmoid(self.bbox_embed[0](hs).float()
                                   + inverse_sigmoid(ref_before))
        pred_logits = (hs @ prompt_emb).float()[..., None]
        return pred_boxes, pred_logits, topk_idx

    def predict(self, image, valid_hw, prompt="fine_grained_prompt"):
        """The differentiable entry, counterpart of the JAX `upn_forward`:
        the same stages as `forward` with autograd on whatever parameters
        the caller set to require gradients (the constructor freezes all).
        image [B, H, W, 3] padded, valid_hw [B, 2] int. Returns
        dict(pred_boxes [B, nq, 4] normalised cxcywh float32, pred_logits
        [B, nq, 1] float32). On the card its deformable attention runs the
        MSDA forward kernel and, in the backward pass, the MSDA backward
        kernel (`ops.msda.MSDeformAttnFunction`)."""
        src, pos, shapes, vr, key_pad = self.features(image, valid_hw)
        memory = self.encoder(src, pos, shapes, vr, key_pad)
        boxes, logits, _ = self.decoder(memory, shapes, vr, key_pad, prompt)
        return {"pred_boxes": boxes, "pred_logits": logits}

    @torch.inference_mode()
    def forward(self, image, valid_hw, prompt="fine_grained_prompt",
                stage_ms: dict | None = None):
        """image [B, H, W, 3] padded, in the model dtype; valid_hw [B, 2]
        int (true h, w before padding). Returns dict(pred_boxes [B, nq, 4]
        normalised cxcywh, pred_logits [B, nq, 1], topk_idx [B, nq],
        memory [B, S, C] the encoder output). stage_ms receives the
        device-synchronised ms of backbone / encoder / decoder."""
        with stage_timer(stage_ms, "backbone", self.device):
            src, pos, shapes, vr, key_pad = self.features(image, valid_hw)
        with stage_timer(stage_ms, "encoder", self.device):
            memory = self.encoder(src, pos, shapes, vr, key_pad)
        with stage_timer(stage_ms, "decoder", self.device):
            boxes, logits, idx = self.decoder(memory, shapes, vr, key_pad,
                                              prompt)
        return {"pred_boxes": boxes, "pred_logits": logits, "topk_idx": idx,
                "memory": memory}
