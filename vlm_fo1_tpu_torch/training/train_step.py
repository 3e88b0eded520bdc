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
import torch.distributed as dist
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
# arrays with a batch axis (position_ids has it second)
_ROW_KEYS = ("patches", "aux_image", "aux_boxes", "vt_boxes", "input_ids",
             "image_positions", "region_positions", "labels")
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


def local_batch(batch: dict, rows: slice) -> dict:
    """The rows of a global batch that one data rank trains on
    (`parallel.sharding.data_rows`): every batch-indexed array cut along
    its batch axis (position_ids along its second), the plan arrays
    whole."""
    out = {}
    for k, v in batch.items():
        if k == "position_ids":
            v = v[:, rows]
        elif k in _ROW_KEYS:
            v = v[rows]
        out[k] = v
    return out


def _global_mean(ce_sum, count, data_group):
    """The token mean over every data rank: the sums and the counts are
    all-reduced separately (never a mean of per-rank means). Its value is
    the global loss on every rank; its gradient is this rank's share, so
    gradients summed over the data axis are those of the global loss."""
    if data_group is None:
        return ce_sum / count.clamp(min=1)
    tot = torch.stack([ce_sum.detach(), count.to(ce_sum.dtype)])
    dist.all_reduce(tot, group=data_group)
    return (ce_sum + (tot[0] - ce_sum.detach())) / tot[1].clamp(min=1)


def multimodal_lm_loss(model, batch: dict, *, num_windows: int, grid,
                       remat: bool = False, data_group=None):
    """Cross-entropy of next-token prediction over the spliced multimodal
    sequence, as the JAX `multimodal_lm_loss`: f32 logits, mean over the
    labels that are not -100. `model` is a `models.fo1.FO1Model`; `batch`
    as in the module docstring. With `data_group` (the mesh's "data"
    group) `batch` holds this rank's rows and the mean runs over the
    labels of every data rank. Returns a 0-dim float32 tensor."""
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
    return _global_mean((ce * valid.reshape(-1)).sum(), valid.sum(),
                        data_group)


def adamw(params, lr: float = 1e-4):
    """`torch.optim.AdamW` set to what `optax.adamw(lr)` does: b1 0.9, b2
    0.999, eps 1e-8, weight decay 1e-4 on every parameter, moments kept in
    the parameter dtype."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def all_reduce_grads(model, group):
    """Sum every parameter gradient over `group`, one flat buffer per
    dtype."""
    by_dtype = {}
    for p in model.parameters():
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


def make_train_step(model, optimizer, *, num_windows: int, grid,
                    remat: bool = False, data_group=None):
    """Returns train_step(batch) -> loss (a detached 0-dim tensor): zero the
    gradients, the loss, its backward, one optimizer step. The caller turns
    on the gradients of the parameters to train (the model's constructor
    freezes all). remat=True recomputes the ViT window blocks and every
    trunk layer in the backward pass. Under a mesh the model is sharded
    over "model" (`parallel.sharding.shard_model`), `batch` holds this
    rank's rows (`local_batch`), `data_group` is the "data" group: the
    loss is the global token mean and the gradients are all-reduced over
    "data" before the optimizer step."""

    def train_step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = multimodal_lm_loss(model, batch, num_windows=num_windows,
                                  grid=grid, remat=remat,
                                  data_group=data_group)
        loss.backward()
        if data_group is not None:
            all_reduce_grads(model, data_group)
        optimizer.step()
        return loss.detach()

    return train_step
