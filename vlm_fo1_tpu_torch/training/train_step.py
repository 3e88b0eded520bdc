"""Multimodal LM training step (counterpart of
`vlm_fo1_tpu/training/train_step.py`): ViT + DaViT + HFRE + projectors +
trunk -> next-token cross-entropy -> AdamW.

The batch carries the JAX batch's keys, shapes and layouts (numpy arrays or
tensors), so one set of arrays feeds both:
  patches [B, P, pd], rot_cos / rot_sin [P, hd], valid [P],
  inv_unit_idx [U], inv_token_idx [S_vit], aux_image [B, Ha, Wa, 3],
  aux_boxes / vt_boxes [B, N, 4], input_ids [B, S], image_positions [B, U],
  region_positions [B, N], position_ids [3, B, S], labels [B, S]
(labels of -100 are ignored). Patches and the aux image come in already
normalized, as the JAX function takes them.

Every module on this path is differentiable. The ViT's full-attention blocks
take `flash_attention_differentiable`: the flash kernel forward on the card
(4 launches per loss), the plain version's gradient, as the JAX package runs
its forward-only Pallas kernel on the TPU. The trunk takes the plain
`llm.causal_attention`, as the JAX trunk does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from vlm_fo1_tpu_torch.models.llm import causal_attention, mrope_cos_sin
from vlm_fo1_tpu_torch.models.vit import captures_to_feature_map
from vlm_fo1_tpu_torch.ops.flash_attention import (
    flash_attention_differentiable,
)
from vlm_fo1_tpu_torch.preprocess.image import (
    AUX_IMAGE_MEAN,
    AUX_IMAGE_STD,
    qwen_patch_norm_vectors,
)
from vlm_fo1_tpu_torch.preprocess.windowing import pad_pixel_values

IGNORE = -100
_FLOAT_KEYS = ("patches", "aux_image")
_INDEX_KEYS = ("inv_unit_idx", "inv_token_idx", "input_ids",
               "image_positions", "region_positions", "position_ids",
               "labels")


def _to_device(batch: dict, device, dtype) -> dict:
    """numpy arrays or tensors -> tensors on `device`: images in the model
    dtype, index arrays int64, rotary tables and boxes float32, `valid`
    bool."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v, device=device)
        if k in _FLOAT_KEYS:
            t = t.to(dtype)
        elif k in _INDEX_KEYS:
            t = t.long()
        elif k == "valid":
            t = t.bool()
        else:
            t = t.float()
        out[k] = t
    return out


def batch_from_prepared(cfg, prep: dict) -> dict:
    """A one-row batch (numpy, the layout above) from `FO1Model.prepare`'s
    output: patches in the padded-window layout and the aux image, both
    normalized as `FO1Model.encode` does, and the splice and rotary arrays.
    The labels are the prompt's token ids with the image and region slots
    set to -100 (replace batch["labels"] to train on other targets)."""
    plan, info = prep["plan"], prep["splice"]
    mean, std = qwen_patch_norm_vectors(cfg.vision.patch_size,
                                        cfg.vision.temporal_patch_size)
    patches = (pad_pixel_values(prep["pixel_values"], plan)
               .astype(np.float32) / 255.0 - mean) / std
    aux = (prep["aux"].astype(np.float32) / 255.0 - AUX_IMAGE_MEAN) \
        / AUX_IMAGE_STD
    ids = np.asarray(info.input_ids, np.int64)
    labels = ids.copy()
    labels[np.asarray(info.image_positions)] = IGNORE
    labels[np.asarray(info.region_positions)] = IGNORE
    return {
        "patches": patches[None],
        "rot_cos": np.asarray(plan.rot_cos), "rot_sin": np.asarray(plan.rot_sin),
        "valid": np.asarray(plan.valid),
        "inv_unit_idx": np.asarray(plan.inv_unit_idx),
        "inv_token_idx": np.asarray(plan.inv_token_idx),
        "aux_image": aux[None],
        "aux_boxes": np.asarray(prep["aux_boxes"], np.float32)[None],
        "vt_boxes": np.asarray(prep["vt_boxes"], np.float32)[None],
        "input_ids": ids[None],
        "image_positions": np.asarray(info.image_positions)[None],
        "region_positions": np.asarray(info.region_positions)[None],
        "position_ids": np.asarray(prep["position_ids"]),
        "labels": labels[None],
    }


def multimodal_lm_loss(model, batch: dict, *, num_windows: int, grid,
                       remat: bool = False):
    """Cross-entropy of next-token prediction over the spliced multimodal
    sequence, as the JAX `multimodal_lm_loss`: f32 logits, mean over the
    labels that are not -100. `model` is a `models.fo1.FO1Model`; `batch`
    as in the module docstring. Returns a 0-dim float32 tensor."""
    cfg = model.cfg
    t = _to_device(batch, model.device, model.dtype)
    tokens, captures = model.vision_tower(
        t["patches"], t["rot_cos"], t["rot_sin"], t["valid"],
        num_windows=num_windows, inv_unit_idx=t["inv_unit_idx"],
        attention=flash_attention_differentiable, remat=remat)
    vis = model.mm_projector(tokens)                          # [B, U, D]
    vt_map = captures_to_feature_map(
        captures, t["inv_token_idx"], tuple(int(g) for g in grid),
        cfg.vision.spatial_merge_size)
    stage_maps = model.vision_tower_aux(t["aux_image"])
    embeds = []
    for b in range(vis.shape[0]):
        feats = model.object_vp_extractor(
            [m[b] for m in stage_maps], t["aux_boxes"][b], vt_map[b],
            t["vt_boxes"][b])
        reg = model.mm_projector_aux(feats.to(vis.dtype))
        # out-of-place scatters: the token rows they replace take no
        # gradient, as with the JAX `.at[].set`
        emb = model.text.embed(t["input_ids"][b].clamp(min=0))
        emb = emb.index_put((t["image_positions"][b],), vis[b].to(emb.dtype))
        emb = emb.index_put((t["region_positions"][b],), reg.to(emb.dtype))
        embeds.append(emb)
    embeds = torch.stack(embeds)
    cos, sin = mrope_cos_sin(t["position_ids"], cfg.text)
    hidden = model.text(embeds, cos, sin, attention=causal_attention,
                        remat=remat)
    logits = model.text.logits(hidden)                       # [B, S, V] f32
    labels = t["labels"][:, 1:]
    valid = labels != IGNORE
    ce = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                         labels.clamp(min=0).reshape(-1), reduction="none")
    return (ce * valid.reshape(-1)).sum() / valid.sum().clamp(min=1)


def adamw(params, lr: float = 1e-4):
    """`torch.optim.AdamW` set to what `optax.adamw(lr)` does: b1 0.9, b2
    0.999, eps 1e-8, weight decay 1e-4 on every parameter, moments kept in
    the parameter dtype."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def make_train_step(model, optimizer, *, num_windows: int, grid,
                    remat: bool = False):
    """Returns train_step(batch) -> loss (a detached 0-dim tensor): zero the
    gradients, the loss, its backward, one optimizer step. The caller turns
    on the gradients of the parameters to train (the model's constructor
    freezes all). remat=True recomputes the ViT window blocks and every
    trunk layer in the backward pass."""

    def train_step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = multimodal_lm_loss(model, batch, num_windows=num_windows,
                                  grid=grid, remat=remat)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step
