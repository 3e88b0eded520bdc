"""Name-dispatch tower builders (counterpart of
`vlm_fo1_tpu/models/builder.py`, reference multimodal_encoder/builder.py):
the tower name in a checkpoint config resolves to the port's module class
and its config. Composition normally goes through `FO1Model`; these serve
API parity and a tower used on its own."""

from __future__ import annotations

from vlm_fo1_tpu_torch.config import DaViTConfig, ViTConfig


def build_vision_tower(vision_tower_name: str, cfg: ViTConfig | None = None):
    """'qwen2.5-vl*' -> (VisionTransformer, ViTConfig)."""
    name = (vision_tower_name or "").lower()
    if "qwen2.5-vl" in name or "qwen2_5" in name:
        from vlm_fo1_tpu_torch.models.vit import VisionTransformer

        return VisionTransformer, (cfg or ViTConfig())
    raise ValueError(f"unknown vision tower: {vision_tower_name}")


def build_vision_tower_aux(vision_tower_name: str,
                           cfg: DaViTConfig | None = None):
    """'davit*' -> (DaViT, DaViTConfig)."""
    name = (vision_tower_name or "").lower()
    if "davit" in name:
        from vlm_fo1_tpu_torch.models.davit import DaViT

        return DaViT, (cfg or DaViTConfig())
    raise ValueError(f"unknown aux vision tower: {vision_tower_name}")
