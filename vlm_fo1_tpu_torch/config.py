"""Typed configuration tree for the whole framework.

One dataclass hierarchy replaces the reference's three coexisting config
systems (HF PretrainedConfig `mm_*` fields, mmengine dicts for UPN, argparse
in eval scripts — see reference vlm_fo1/model/omchat_arch.py:7-33 and
detect_tools/upn/configs/upn_large.py). `FO1Config.from_hf_config` ingests a
released checkpoint's config.json unchanged.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Sequence


@dataclass(frozen=True)
class ViTConfig:
    """Qwen2.5-VL vision transformer (reference configuration_qwen2_5_vl.py:30-65).

    Defaults match the 3B checkpoint's vision_config.
    """

    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    tokens_per_second: int = 2
    window_size: int = 112
    out_hidden_size: int = 2048
    fullatt_block_indexes: tuple[int, ...] = (7, 15, 23, 31)
    hidden_act: str = "silu"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def spatial_merge_unit(self) -> int:
        return self.spatial_merge_size**2

    @property
    def window_patches(self) -> int:
        """Patches per attention window side (112px / 14px = 8)."""
        return self.window_size // self.patch_size

    @property
    def patch_dim(self) -> int:
        """Flattened input patch length (3*2*14*14 = 1176)."""
        return self.in_channels * self.temporal_patch_size * self.patch_size**2


@dataclass(frozen=True)
class TextConfig:
    """Qwen2.5 decoder trunk. Defaults match Qwen2.5-VL-3B-Instruct."""

    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 11008
    num_hidden_layers: int = 36
    num_attention_heads: int = 16
    num_key_value_heads: int = 2
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    mrope_section: tuple[int, ...] = (16, 24, 24)
    max_position_embeddings: int = 32768
    tie_word_embeddings: bool = True
    hidden_act: str = "silu"
    attention_bias: bool = True  # q/k/v have bias, o_proj does not

    @property
    def num_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads


@dataclass(frozen=True)
class DaViTConfig:
    """DaViT dual-attention CNN/transformer; defaults = "davit-large"
    (reference vlm_fo1/model/multimodal_encoder/davit/configs.py:70-136)."""

    depths: tuple[int, ...] = (1, 1, 9, 1)
    embed_dims: tuple[int, ...] = (256, 512, 1024, 2048)
    num_heads: tuple[int, ...] = (8, 16, 32, 64)
    num_groups: tuple[int, ...] = (8, 16, 32, 64)
    patch_size: tuple[int, ...] = (7, 3, 3, 3)
    patch_stride: tuple[int, ...] = (4, 2, 2, 2)
    patch_padding: tuple[int, ...] = (3, 1, 1, 1)
    patch_prenorm: tuple[bool, ...] = (False, True, True, True)
    window_size: int = 12
    mlp_ratio: float = 4.0
    in_channels: int = 3
    image_size: int = 768

    @property
    def num_stages(self) -> int:
        return len(self.embed_dims)


@dataclass(frozen=True)
class HFREConfig:
    """Hybrid Fine-grained Region Encoder
    (reference hybrid_finegrained_region_encoder.py:106-203)."""

    roi_output_size: int = 7
    region_feature_dim: int = 8960  # = sum(aux dims) 3840 + ViT 4*1280
    apply_position_embedding: bool = True
    pos_embedding_strategy: str = "bbox_based"  # | feature_map_based | hybrid
    use_vt_region_feature_only: bool = False
    use_vision_tower_region_feature: bool = True
    region_feature_combination: str = "concat"
    apply_region_layer_norm: bool = False
    vt_region_feature_dim: int = 5120  # vision hidden * 4 captured levels
    vt_spatial_scale: float = 1.0 / 14
    use_simple_fpn_for_vt: bool = False
    aux_region_feature_dims: tuple[int, ...] = (256, 512, 1024, 2048)
    aux_spatial_scale: float = 0.25
    # -1 = torchvision's adaptive sampling ratio, the reference default
    # (roi_align called without sampling_ratio, hybrid...:248-268, 353-358).
    # Shape-static under jit via the separable pooled formulation
    # (ops/roi_align.roi_align_mean_separable); a positive value selects
    # that many taps per bin per axis instead.
    roi_sampling_ratio: int = -1


@dataclass(frozen=True)
class FO1Config:
    """Full model composition (reference omchat_arch.py:7-33)."""

    vision: ViTConfig = field(default_factory=ViTConfig)
    text: TextConfig = field(default_factory=TextConfig)
    davit: DaViTConfig = field(default_factory=DaViTConfig)
    hfre: HFREConfig = field(default_factory=HFREConfig)

    mm_projector_type: str = "mlp2x_gelu"
    mm_projector_aux_type: str = "mlp2x_gelu"
    mm_hidden_size: int = 2048  # ViT out_hidden_size
    mm_region_hidden_size: int = 8960
    aux_image_size: int = 768
    max_regions: int = 100

    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    bos_token_id: int = 151643
    eos_token_id: int = 151645  # <|im_end|>
    pad_token_id: int = 151643

    # preprocessing caps (reference qwen2_5_vl_encoder.py:179, mm_utils.py:589)
    min_pixels: int = 56 * 56
    max_pixels: int = 2048 * 2048
    max_image_long_side: int = 2048

    @staticmethod
    def from_hf_config(cfg: dict[str, Any] | str) -> "FO1Config":
        """Build from a checkpoint's config.json (path or parsed dict)."""
        if isinstance(cfg, str):
            with open(cfg) as f:
                cfg = json.load(f)

        v = dict(cfg.get("vision_config", {}))
        vision = _apply(ViTConfig(), v)

        text_keys = {
            "vocab_size", "hidden_size", "intermediate_size",
            "num_hidden_layers", "num_attention_heads", "num_key_value_heads",
            "rms_norm_eps", "rope_theta", "max_position_embeddings",
            "tie_word_embeddings", "hidden_act",
        }
        text = _apply(TextConfig(), {k: cfg[k] for k in text_keys if k in cfg})
        rs = cfg.get("rope_scaling") or {}
        if "mrope_section" in rs:
            text = dataclasses.replace(text, mrope_section=tuple(rs["mrope_section"]))
        if "head_dim" in cfg:
            text = dataclasses.replace(text, head_dim=cfg["head_dim"])
        else:
            text = dataclasses.replace(
                text, head_dim=text.hidden_size // text.num_attention_heads)

        hfre = HFREConfig(
            roi_output_size=cfg.get("mm_roi_output_size", 7),
            region_feature_dim=cfg.get("mm_region_hidden_size", 8960),
            apply_position_embedding=cfg.get("mm_apply_position_embedding", True),
            pos_embedding_strategy=cfg.get("mm_pos_embedding_strategy", "bbox_based"),
            use_vt_region_feature_only=cfg.get("mm_use_vt_region_feature_only", False),
            use_vision_tower_region_feature=cfg.get(
                "mm_use_vision_tower_region_feature", True),
            region_feature_combination=cfg.get("mm_region_feature_combination", "concat"),
            apply_region_layer_norm=cfg.get("mm_apply_region_layer_norm", False),
            vt_region_feature_dim=(
                2048 if cfg.get("mm_use_simpleFPN_for_vt", False)
                else vision.hidden_size * 4),
            vt_spatial_scale=1.0 / vision.patch_size,
            use_simple_fpn_for_vt=cfg.get("mm_use_simpleFPN_for_vt", False),
        )

        return FO1Config(
            vision=vision,
            text=text,
            hfre=hfre,
            mm_projector_type=cfg.get("mm_projector_type", "mlp2x_gelu"),
            mm_projector_aux_type=cfg.get("mm_projector_aux_type", "mlp2x_gelu"),
            mm_hidden_size=cfg.get("mm_hidden_size", vision.out_hidden_size),
            mm_region_hidden_size=cfg.get("mm_region_hidden_size", 8960),
            aux_image_size=cfg.get("aux_image_size", 768),
            image_token_id=cfg.get("image_token_id", 151655),
            video_token_id=cfg.get("video_token_id", 151656),
            vision_start_token_id=cfg.get("vision_start_token_id", 151652),
            bos_token_id=cfg.get("bos_token_id", 151643),
            eos_token_id=cfg.get("eos_token_id", 151645),
            pad_token_id=cfg.get("pad_token_id", 151643) or 151643,
        )

    @staticmethod
    def tiny() -> "FO1Config":
        """A minutes-not-hours config for CPU tests: same topology, tiny dims."""
        vision = ViTConfig(
            depth=4, hidden_size=32, intermediate_size=64, num_heads=2,
            out_hidden_size=48, fullatt_block_indexes=(1, 3), window_size=112,
        )
        text = TextConfig(
            vocab_size=512, hidden_size=48, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            head_dim=12, mrope_section=(2, 2, 2),
        )
        davit = DaViTConfig(
            depths=(1, 1, 2, 1), embed_dims=(8, 16, 32, 64),
            num_heads=(1, 2, 4, 8), num_groups=(1, 2, 4, 8), image_size=96,
        )
        vt_dim = vision.hidden_size * len(vision.fullatt_block_indexes)
        hfre = HFREConfig(
            region_feature_dim=sum(davit.embed_dims) + vt_dim,
            vt_region_feature_dim=vt_dim,
            aux_region_feature_dims=davit.embed_dims,
        )
        return FO1Config(
            vision=vision, text=text, davit=davit, hfre=hfre,
            mm_hidden_size=vision.out_hidden_size,
            mm_region_hidden_size=hfre.region_feature_dim,
            aux_image_size=davit.image_size,
        )


def _apply(dc, overrides: dict[str, Any]):
    """dataclasses.replace with only the fields the dataclass knows about;
    sequences are normalised to tuples so configs stay hashable."""
    names = {f.name for f in dataclasses.fields(dc)}
    clean = {}
    for k, v in overrides.items():
        if k not in names:
            continue
        if isinstance(v, Sequence) and not isinstance(v, (str, bytes)):
            v = tuple(v)
        clean[k] = v
    return dataclasses.replace(dc, **clean)
