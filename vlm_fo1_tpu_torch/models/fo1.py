"""FO1 model composition (counterpart of `vlm_fo1_tpu/models/fo1.py`):
Qwen2.5-VL ViT + DaViT -> HFRE region features -> two projectors ->
embedding splice -> Qwen2.5 trunk prefill -> greedy / top-p decode, for
one request or a batch, and continuous-batching sessions.

The host steps are the port's copies of the JAX package's host functions
(`vlm_fo1_tpu_torch.preprocess`), composed here for prompts of one or more
images and videos (the boxes attach to the first image); parsing the
answer back to boxes is left to callers
(`postprocess.extract_predictions_to_bboxes`).

Host and device, and where the host waits:
  `prepare`       host only (numpy and PIL), safe in a thread pool;
  `launch_batch`  uploads the batch from pinned host memory with
                  non-blocking copies, runs the batched encode, the splice,
                  the prefill into a decode program's cache, samples the
                  first tokens and replays the first decode graph: all of
                  it is enqueued on the current stream and the host does
                  not wait for the device (the first call at a new shape
                  captures its graph, and a capture synchronises);
  `finish_batch`  replays the remaining decode graphs, reading one finished
                  flag per replay, and copies the tokens to the host.
A serving pipeline prepares the next batch on the host while the device
runs this one. Sessions (`start_session`, `decode_session_chunk`,
`refill_session`) hold a chunk-mode decode program for their lifetime.

Submodules carry the checkpoint's tower names: `vision_tower`,
`vision_tower_aux`, `text` (the trunk, `model.` in the checkpoint),
`mm_projector`, `mm_projector_aux`, `object_vp_extractor` (the HFRE).
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from vlm_fo1_tpu_torch import nn as tnn
from vlm_fo1_tpu_torch import preprocess as pp
from vlm_fo1_tpu_torch.config import FO1Config
from vlm_fo1_tpu_torch.preprocess.image import (
    AUX_IMAGE_MEAN,
    AUX_IMAGE_STD,
    qwen_patch_norm_vectors,
)
from vlm_fo1_tpu_torch.preprocess.tokens import (
    build_chat_tokens,
    expand_multimodal_tokens,
)
from vlm_fo1_tpu_torch.preprocess.windowing import (
    build_vit_plan,
    pad_pixel_values,
)
from vlm_fo1_tpu_torch.models.davit import DaViT
from vlm_fo1_tpu_torch.models.hfre import HFRE
from vlm_fo1_tpu_torch.models.llm import TextModel
from vlm_fo1_tpu_torch.models.projector import CAbstractor, build_projector
from vlm_fo1_tpu_torch.models.simple_fpn import Deconv2x
from vlm_fo1_tpu_torch.models.vit import (
    VisionTransformer,
    captures_to_feature_map,
)
from vlm_fo1_tpu_torch.ops.flash_attention import flash_attention
from vlm_fo1_tpu_torch.runtime.device import resolve_device, stage_timer
from vlm_fo1_tpu_torch.runtime.generate import (
    GenerationConfig,
    acquire_program,
    decode_chunk,
    decode_step,
    decode_to_text,
    load_chunk_state,
    loop_program,
    pad_to_bucket,
    prefill,
    prefill_into_slots,
    release_program,
    sample_first,
    start_decode_loop,
)

BOX_BUCKET = 10  # boxes padded to a multiple of this (cap 100)
# a padding box: inside every map, its features land on the scratch row
DUMMY_BOX = np.array([[0.0, 10.0, 0.0, 10.0]], np.float32)


def _round_boxes(n: int) -> int:
    return max(BOX_BUCKET, -(-n // BOX_BUCKET) * BOX_BUCKET)


def _region_slots(prep) -> int:
    """Region rows a prep needs, at least 1: one per box, and one per
    region slot of its prompt. The chat template puts a region slot per box
    after every image, while the boxes belong to the first image, so a
    prompt with a further image has more slots than boxes; the extra slots
    take padding rows, which the JAX `encode` gives them too where its own
    bucket of the box count has room (where it has not, JAX raises)."""
    return max(len(prep["aux_boxes"]), len(prep["splice"].region_positions),
               1)


def _keys_cubic(x):
    """Keys' cubic convolution kernel with a = -0.5, as `jax.image.resize`
    "cubic" uses it; x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


@functools.lru_cache(maxsize=16)
def cubic_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] f32 weights of `jax.image.resize(...,
    method="cubic")` along one axis (its `compute_weight_mat` with
    antialias): when downsampling the kernel is widened by in/out, each
    output's weights are normalised to sum to 1, and an output whose
    sample falls outside the input gets none. Not torch's bicubic (a =
    -0.75, other edges)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@dataclass
class GenerationResult:
    text: str
    token_ids: np.ndarray        # generated ids (trimmed at EOS)
    prompt_len: int
    num_steps: int
    prefill_logits: np.ndarray   # [V] fp32 last-token logits of the prompt


class FO1Model(nn.Module):
    def __init__(self, cfg: FO1Config, *, device="cuda",
                 dtype=torch.float32, tokenizer=None):
        """Allocates uninitialised parameters on `device` (the card unless
        the caller asks for the CPU); fill them with `random_init`,
        `load_state_dict` or `from_pretrained`."""
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = device
        self.dtype = dtype
        # the attention used by the ViT full blocks and the trunk prefill;
        # setting ops.flash_attention.flash_attention_reference here runs
        # the plain version instead (for comparisons on the card)
        self.attention = flash_attention
        # decode from captured CUDA graphs on the card; False runs the same
        # steps eagerly (for comparisons on the card)
        self.cuda_graphs = True
        # device copies of per-geometry plans and constants, uploaded once
        self._consts: dict = {}
        with torch.device("meta"):
            self.vision_tower = VisionTransformer(cfg.vision)
            self.vision_tower_aux = DaViT(cfg.davit)
            self.text = TextModel(cfg.text)
            self.mm_projector = build_projector(
                cfg.mm_projector_type, cfg.mm_hidden_size,
                cfg.text.hidden_size)
            self.mm_projector_aux = build_projector(
                cfg.mm_projector_aux_type, cfg.mm_region_hidden_size,
                cfg.text.hidden_size)
            self.object_vp_extractor = HFRE(
                cfg.hfre, cfg.vision.hidden_size
                * len(cfg.vision.fullatt_block_indexes))
        self.to(dtype=dtype)
        self.to_empty(device=device)
        self.requires_grad_(False)

    @classmethod
    def random_init(cls, cfg: FO1Config, seed: int = 0,
                    dtype=torch.float32, *, device="cuda",
                    tokenizer=None) -> "FO1Model":
        """std-0.02 normal weights drawn on `device` from a seeded
        torch.Generator, zero biases, unit norm scales."""
        model = cls(cfg, device=device, dtype=dtype, tokenizer=tokenizer)
        gen = torch.Generator(device=model.device).manual_seed(seed)
        seen = set()
        with torch.no_grad():
            for mod in model.modules():
                if isinstance(mod, (tnn.RMSNorm, tnn.LayerNorm)):
                    mod.weight.fill_(1.0)
                elif isinstance(mod, (tnn.Linear, tnn.Conv2d, tnn.Weight,
                                      Deconv2x)):
                    mod.weight.normal_(0.0, 0.02, generator=gen)
                elif isinstance(mod, tnn.MultiheadAttention):
                    mod.in_proj_weight.normal_(0.0, 0.02, generator=gen)
                    mod.in_proj_bias.zero_()
                elif isinstance(mod, CAbstractor) and mod.pos_emb is not None:
                    mod.pos_emb.normal_(0.0, 0.02, generator=gen)
                    seen.add(id(mod.pos_emb))
                    continue
                else:
                    continue
                bias = getattr(mod, "bias", None)
                if bias is not None:
                    bias.zero_()
                seen.update(id(p) for p in mod.parameters(recurse=False))
        missed = [n for n, p in model.named_parameters() if id(p) not in seen]
        if missed:
            raise RuntimeError(f"random_init left parameters unset: {missed}")
        return model

    @classmethod
    def from_pretrained(cls, model_path: str, dtype=torch.bfloat16,
                        tokenizer=None, *, device="cuda") -> "FO1Model":
        """A released checkpoint directory: `config.json` and sharded
        safetensors (`checkpoint.load_fo1_checkpoint`). The tokenizer comes
        from `transformers.AutoTokenizer` when that loads, else None."""
        from vlm_fo1_tpu_torch.checkpoint import load_fo1_checkpoint

        cfg = FO1Config.from_hf_config(os.path.join(model_path,
                                                    "config.json"))
        model = cls(cfg, device=device, dtype=dtype, tokenizer=tokenizer)
        load_fo1_checkpoint(model_path, model)
        if tokenizer is None:
            try:
                from transformers import AutoTokenizer

                model.tokenizer = AutoTokenizer.from_pretrained(model_path)
            except Exception:  # no tokenizer files: run without one
                model.tokenizer = None
        return model

    # ------------------------------------------------------ host pipeline

    def prepare(self, messages: list[dict], max_pixels: int | None = None,
                device_preproc: bool = False,
                geometry_factor: int | None = None):
        """Host preparation, as `vlm_fo1_tpu.models.fo1.FO1Model.prepare`
        does it: ChatML tokens with sentinels, the media slots in message
        order (plain entries are images, `{"video": frames}` entries are
        videos), the shortest-edge resize of every image with the boxes on
        the first one, the ViT window plan of each slot, box transforms,
        token expansion and M-RoPE position ids. Images go as uint8 patch
        rows, videos as the float32 normalized rows of
        `qwen_video_preprocess` (max_pixels or 1024^2). The aux squash and
        the boxes exist only when the first slot is an image.
        device_preproc=True (a single-image prompt only) ships the
        smart-resized uint8 image alone and the device patchifies it and
        makes the aux squash (`_device_preproc`). geometry_factor snaps an
        image's smart resize to a coarser multiple of 28 px, so mixed sizes
        share grids."""
        cfg = self.cfg
        prompt, tokens, media_urls, bbox_list = build_chat_tokens(
            self.tokenizer, messages)
        if not media_urls:
            raise ValueError("FO1 requires at least one image/video message")
        media = [("video", [pp.load_image(f) for f in u["video"]])
                 if isinstance(u, dict) and "video" in u
                 else ("image", pp.load_image(u)) for u in media_urls]
        first_image_idx = next((i for i, (k, _) in enumerate(media)
                                if k == "image"), None)
        boxes = []
        if first_image_idx is not None:
            imgs = [m for k, m in media if k == "image"]
            per_image = [list(bbox_list or [])] + [[] for _ in imgs[1:]]
            imgs, bbox_lists = pp.resize_shortest_edge_images_and_bboxes(
                imgs, per_image, max_size=cfg.max_image_long_side)
            boxes = bbox_lists[0][:cfg.max_regions]
            it = iter(imgs)
            media = [(k, next(it) if k == "image" else m) for k, m in media]

        kw = dict(patch_size=cfg.vision.patch_size,
                  merge_size=cfg.vision.spatial_merge_size,
                  min_pixels=cfg.min_pixels)
        raw_mode = (device_preproc and len(media) == 1
                    and media[0][0] == "image")
        pvs, grids, plans, slot_ids = [], [], [], []
        raw = None
        for kind, m in media:
            if kind == "video":
                pv, grid = pp.qwen_video_preprocess(
                    m, **kw, max_pixels=max_pixels or 1024 * 1024)
                slot_ids.append(cfg.video_token_id)
            else:
                img_kw = dict(kw, max_pixels=max_pixels or cfg.max_pixels,
                              round_factor=geometry_factor)
                if raw_mode:
                    raw, grid = pp.qwen_image_raw_u8(m, **img_kw)
                    pv = None
                else:
                    pv, grid = pp.qwen_image_patchify_u8(m, **img_kw)
                slot_ids.append(cfg.image_token_id)
            pvs.append(pv)
            grids.append(grid)
            plans.append(build_vit_plan(grid, cfg.vision))

        aux = None
        aux_boxes = np.zeros((0, 4), np.float32)
        vt_boxes = aux_boxes
        if first_image_idx == 0:
            img, grid, size = media[0][1], grids[0], cfg.aux_image_size
            if not raw_mode:
                aux = pp.aux_image_u8(img, size)
            w, h = img.size
            aux_boxes = np.asarray(
                pp.adjust_bbox(boxes, h, w, size, size) if boxes
                else np.zeros((0, 4)), np.float32).reshape(-1, 4)
            sx = grid[2] * cfg.vision.patch_size / size
            sy = grid[1] * cfg.vision.patch_size / size
            vt_boxes = aux_boxes * np.array([sx, sy, sx, sy], np.float32)
        else:
            boxes = []
        info = expand_multimodal_tokens(tokens, [p.num_units for p in plans],
                                        slot_ids)
        pos_ids, deltas = pp.get_rope_index(
            info.input_ids[None], grids,
            spatial_merge_size=cfg.vision.spatial_merge_size,
            image_token_id=cfg.image_token_id,
            video_token_id=cfg.video_token_id,
            vision_start_token_id=cfg.vision_start_token_id,
            tokens_per_second=cfg.vision.tokens_per_second,
            second_per_grid_ts=[1.0] * sum(k == "video" for k, _ in media))
        return {
            "prompt": prompt, "media": media, "bbox_list": boxes,
            "pixel_values": pvs[0], "raw_image": raw, "grid": grids[0],
            "plan": plans[0], "pixel_values_list": pvs, "grids": grids,
            "plans": plans, "first_is_image": first_image_idx == 0,
            "aux": aux, "aux_boxes": aux_boxes, "vt_boxes": vt_boxes,
            "splice": info, "position_ids": pos_ids, "rope_deltas": deltas,
        }

    # ---------------------------------------------------- device inputs

    def _upload(self, a, dtype=None):
        """A host array on the device without a host wait: through pinned
        memory and a non-blocking copy on the card."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dtype is not None:
            t = t.to(dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _const(self, key, make):
        """A device tensor uploaded once: make() -> (array, dtype)."""
        hit = self._consts.get(key)
        if hit is None:
            hit = self._consts[key] = self._upload(*make())
        return hit

    def _device_plan(self, grid, plan):
        """The ViT plan's tensors for one grid: rot_cos, rot_sin, valid,
        inv_unit_idx, inv_token_idx."""
        key = ("plan", tuple(int(g) for g in grid))
        return tuple(self._const(key + (name,), lambda n=name, d=dt:
                                 (getattr(plan, n), d))
                     for name, dt in (("rot_cos", torch.float32),
                                      ("rot_sin", torch.float32),
                                      ("valid", torch.bool),
                                      ("inv_unit_idx", torch.long),
                                      ("inv_token_idx", torch.long)))

    def _normalize(self, patches, aux):
        """uint8 patch rows and aux images -> the /255, mean, std affine in
        f32 on the device, cast to the model dtype (the JAX
        `_normalize_on_device`). Float rows (a video's, normalized on the
        host) are only cast."""
        cfg = self.cfg
        if patches is not None and patches.dtype != torch.uint8:
            patches = patches.to(self.dtype)
        elif patches is not None:
            mean, std = (self._const(("patch_norm", i), lambda i=i: (
                qwen_patch_norm_vectors(cfg.vision.patch_size,
                                        cfg.vision.temporal_patch_size)[i],
                torch.float32)) for i in (0, 1))
            patches = ((patches.float() / 255.0 - mean) / std).to(self.dtype)
        if aux is not None and aux.dtype != torch.uint8:
            aux = aux.to(self.dtype)
        elif aux is not None:
            aux = self._aux_normalize(aux.float() / 255.0)
        return patches, aux

    def _aux_normalize(self, aux01):
        mean = self._const(("aux_mean",), lambda: (AUX_IMAGE_MEAN,
                                                    torch.float32))
        std = self._const(("aux_std",), lambda: (AUX_IMAGE_STD,
                                                  torch.float32))
        return ((aux01 - mean) / std).to(self.dtype)

    def _device_preproc(self, raw, gather_idx):
        """Raw smart-resized uint8 images [B, H, W, C] on the device ->
        (ViT patches in the padded window layout, DaViT aux input), as the
        JAX `_device_preproc_batched`. The ViT half equals the host path
        bit for bit (patchify, temporal duplication and window padding are
        relayouts). The aux half is `jax.image.resize` cubic of the
        smart-resized image to the aux size (two separable weight matrices
        from `cubic_resize_matrix`, as two products), one resampling
        generation away from the host's PIL squash."""
        cfg = self.cfg
        ph = cfg.vision.patch_size
        m = cfg.vision.spatial_merge_size
        tps = cfg.vision.temporal_patch_size
        b, hb, wb, c = raw.shape
        gh, gw = hb // ph, wb // ph
        x = raw.reshape(b, gh // m, m, ph, gw // m, m, ph, c)
        x = x.permute(0, 1, 4, 2, 5, 7, 3, 6).reshape(b, gh * gw, c, 1, ph,
                                                      ph)
        x = x.expand(b, gh * gw, c, tps, ph, ph).reshape(b, gh * gw, -1)
        patches, _ = self._normalize(x.index_select(1, gather_idx), None)
        size = cfg.aux_image_size
        wh, ww = (self._const(("cubic", n, size), lambda n=n: (
            cubic_resize_matrix(n, size), torch.float32)) for n in (hb, wb))
        aux = torch.einsum("bhwc,hy->bywc", raw.float(), wh)
        aux = torch.einsum("bywc,wx->byxc", aux, ww)
        return patches, self._aux_normalize(aux / 255.0)

    def _host_prep(self, prep):
        """A raw-mode prep on a path that encodes it alone: the host
        representations made from its smart-resized image, as the JAX
        `encode` makes them (patch rows, PIL aux squash)."""
        if prep.get("raw_image") is None:
            return prep
        from PIL import Image

        cfg = self.cfg
        pv = pp.patchify_raw_np(prep["raw_image"], cfg.vision.patch_size,
                                cfg.vision.spatial_merge_size,
                                cfg.vision.temporal_patch_size)
        return dict(
            prep, raw_image=None, pixel_values=pv, pixel_values_list=[pv],
            aux=pp.aux_image_u8(Image.fromarray(prep["raw_image"]),
                                cfg.aux_image_size))

    def _stack_batch_inputs(self, preps: list[dict]) -> dict:
        """Stack and upload a same-geometry batch's vision inputs: patch
        rows and aux images, or the raw images with the cached window-pad
        gather, and the boxes padded with dummies to one bucket."""
        plan, grid = preps[0]["plan"], preps[0]["grid"]
        nb = _round_boxes(max(_region_slots(p) for p in preps))

        def padded(boxes):
            return np.concatenate(
                [boxes, np.tile(DUMMY_BOX, (nb - len(boxes), 1))])[:nb]

        gather = None
        if all(p.get("raw_image") is not None for p in preps):
            patches = self._upload(np.stack([p["raw_image"] for p in preps]))
            aux = None
            gather = self._const(
                ("gather", tuple(int(g) for g in grid)),
                lambda: (plan.gather_idx, torch.long))
        else:
            patches = self._upload(np.stack(
                [pad_pixel_values(p["pixel_values"], plan) for p in preps]))
            aux = self._upload(np.stack([p["aux"] for p in preps]))
        return {
            "patches": patches, "aux": aux, "gather_idx": gather,
            "aux_boxes": self._upload(np.stack(
                [padded(p["aux_boxes"]) for p in preps])),
            "vt_boxes": self._upload(np.stack(
                [padded(p["vt_boxes"]) for p in preps])),
            "plan_arrays": self._device_plan(grid, plan),
            "num_windows": plan.num_windows, "grid": grid, "nb": nb,
        }

    # ----------------------------------------------------------- device

    @torch.inference_mode()
    def _encode_batched(self, enc: dict):
        """Vision and region path of a stacked batch: the ViT and DaViT run
        as one batch, the HFRE once per image (the JAX `vmap`). Returns
        (vision_tokens [B, U, D], region_tokens [B, nb, D]) in the model
        dtype; padded boxes give padded rows."""
        cfg = self.cfg
        if enc["gather_idx"] is not None:
            patches, aux = self._device_preproc(enc["patches"],
                                                enc["gather_idx"])
        else:
            patches, aux = self._normalize(enc["patches"], enc["aux"])
        rot_cos, rot_sin, valid, inv_unit, inv_token = enc["plan_arrays"]
        tokens, captures = self.vision_tower(
            patches, rot_cos, rot_sin, valid,
            num_windows=enc["num_windows"], inv_unit_idx=inv_unit,
            attention=self.attention)
        vision_tokens = self.mm_projector(tokens)
        vt_maps = captures_to_feature_map(captures, inv_token, enc["grid"],
                                          cfg.vision.spatial_merge_size)
        stage_maps = self.vision_tower_aux(aux)
        region = torch.stack([
            self.object_vp_extractor([m[i] for m in stage_maps],
                                     enc["aux_boxes"][i], vt_maps[i],
                                     enc["vt_boxes"][i])
            for i in range(patches.shape[0])])
        region_tokens = self.mm_projector_aux(region.to(vision_tokens.dtype))
        return vision_tokens, region_tokens

    @torch.inference_mode()
    def _encode_image_only(self, pixel_values, grid, plan):
        """Vision tokens [U, D] of a further image or a video of a
        multi-slot prompt: the ViT and `mm_projector` only (the JAX
        `_encode_image_only`)."""
        rot_cos, rot_sin, valid, inv_unit, _ = self._device_plan(grid, plan)
        patches, _ = self._normalize(
            self._upload(pad_pixel_values(pixel_values, plan)[None]), None)
        tokens, _ = self.vision_tower(
            patches, rot_cos, rot_sin, valid, num_windows=plan.num_windows,
            inv_unit_idx=inv_unit, attention=self.attention)
        return self.mm_projector(tokens)[0]

    def _encode_one(self, prep: dict):
        """One prep alone -> (vision_tokens [U, D], region_padded [nb, D],
        nb). A first image takes the region path; every further image and
        video the ViT and projector alone, its tokens concatenated in slot
        order. When the first slot is a video, the region rows are nb rows
        of zeros."""
        prep = self._host_prep(prep)
        slots = list(zip(prep["pixel_values_list"], prep["grids"],
                         prep["plans"]))
        if prep.get("first_is_image", True):
            enc = self._stack_batch_inputs([prep])
            vision, region = self._encode_batched(enc)
            parts, region, nb = [vision[0]], region[0], enc["nb"]
            slots = slots[1:]
        else:
            nb = _round_boxes(_region_slots(prep))
            region = torch.zeros(nb, self.cfg.text.hidden_size,
                                 dtype=self.dtype, device=self.device)
            parts = []
        parts += [self._encode_image_only(*slot) for slot in slots]
        return torch.cat(parts) if len(parts) > 1 else parts[0], region, nb

    @torch.inference_mode()
    def encode(self, prep: dict):
        """Vision and region path of one prep. Returns (vision_tokens
        [U, D], region_tokens [n_boxes, D]) in the model dtype."""
        vision, region, _ = self._encode_one(prep)
        return vision, region[:len(prep["aux_boxes"])]

    @torch.inference_mode()
    def splice(self, prep: dict, vision_tokens, region_tokens):
        """Token embeddings with the vision and region features scattered
        into their slots -> [1, S, D]. region_tokens needs a row per region
        slot of the prompt: `encode`'s rows for a single-image prompt, the
        padded rows of `_encode_one` for a prompt with a further image."""
        info = prep["splice"]
        return self._splice_one(info, vision_tokens, region_tokens,
                                info.seq_len)[None]

    def _splice_one(self, info, vision_tokens, region_padded, pad_len):
        """One prompt's embeddings padded with zeros to pad_len (the JAX
        `_splice_embeds`): padded region positions point at a scratch row
        past the prompt, which is dropped. -> [pad_len, D]."""
        s = info.seq_len
        reg_pos = np.full(len(region_padded), s, np.int64)
        reg_pos[:len(info.region_positions)] = info.region_positions
        emb = self.text.embed(self._upload(info.input_ids, torch.long)
                              .clamp(min=0))
        scratch = emb.new_zeros(pad_len + 1, emb.shape[-1])
        scratch[:s] = emb
        scratch[self._upload(info.image_positions, torch.long)] = \
            vision_tokens.to(emb.dtype)
        scratch[self._upload(reg_pos)] = region_padded.to(emb.dtype)
        scratch[s:] = 0
        return scratch[:pad_len]

    def _splice_rows(self, ids, vision_tokens, img_pos, region_padded,
                     reg_pos):
        """Whole-batch embed and scatter (the JAX `_splice_embeds_batched`):
        ids [B, L] right-padded with 0, img_pos [B, U], reg_pos [B, nb]
        with padded positions at the scratch row L -> [B, L, D]."""
        b, length = ids.shape
        emb = self.text.embed(ids.clamp(min=0))
        scratch = emb.new_zeros(b, length + 1, emb.shape[-1])
        scratch[:, :length] = emb
        rows = torch.arange(b, device=ids.device)[:, None]
        scratch[rows, img_pos] = vision_tokens.to(emb.dtype)
        scratch[rows, reg_pos] = region_padded.to(emb.dtype)
        return scratch[:, :length]

    @torch.inference_mode()
    def prefill(self, prep: dict, embeds, cache_len: int):
        """One unpadded prompt [1, S, D]. Returns (kv_cache, last-token
        logits [1, V] fp32)."""
        s = embeds.shape[1]
        return prefill(self.text, self.cfg.text, embeds,
                       self._upload(prep["position_ids"], torch.long),
                       torch.full((1,), s, device=self.device), cache_len,
                       attention=self.attention)

    def _stop_token_sequences(self, stop_strings) -> tuple:
        seqs = []
        for s in stop_strings or ():
            if isinstance(s, (list, tuple)):
                seqs.append(tuple(int(t) for t in s))
            elif self.tokenizer is not None:
                seqs.append(tuple(int(t) for t in self.tokenizer.encode(s)))
        return tuple(seqs)

    @staticmethod
    def _trim_stop_tail(out: np.ndarray, stop_seqs: tuple) -> np.ndarray:
        """Drop a trailing matched stop sequence from generated ids."""
        for seq in stop_seqs:
            n = len(seq)
            if n and len(out) >= n and out[-n:].tolist() == list(seq):
                return out[:-n]
        return out

    def _gen_cfg(self, max_new_tokens, temperature, top_p, eos_token_id,
                 stop_sequences=()):
        eos = self.cfg.eos_token_id if eos_token_id is None else eos_token_id
        return GenerationConfig(
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_p=top_p, eos_token_id=eos, pad_token_id=self.cfg.pad_token_id,
            stop_sequences=stop_sequences)

    def _generator(self, seed):
        return torch.Generator(device=self.device).manual_seed(seed)

    # ---------------------------------------------------------- generate

    @torch.inference_mode()
    def generate(self, messages: list[dict], max_new_tokens: int = 512,
                 temperature: float = 0.0, top_p: float = 1.0, seed: int = 0,
                 max_pixels: int | None = None,
                 eos_token_id: int | None = None, stop_strings=None,
                 streamer=None, stage_ms: dict | None = None
                 ) -> GenerationResult:
        """One request. By default it rides the batch path with B = 1 (as
        the JAX `generate` rides its fused program). stage_ms: a dict that
        receives the wall-clock ms of prepare / encode / prefill / decode,
        each stage ended by a device synchronise (the JAX `timer` route,
        whose decode writes at the prompt's own length). streamer: a
        callable(text_so_far) after every token, with a host-driven greedy
        step decode (`decode_step`); string stop_strings stop it at
        string level."""
        dev = self.device
        stop_seqs = self._stop_token_sequences(stop_strings)
        with stage_timer(stage_ms, "prepare", dev):
            prep = self.prepare(messages, max_pixels=max_pixels)
        if stage_ms is None and streamer is None and self._fusable([prep]):
            handle = self._launch_fused(
                [prep], max_new_tokens=max_new_tokens,
                temperature=temperature, top_p=top_p, seed=seed,
                eos_token_id=eos_token_id, stop_sequences=stop_seqs)
            return self.finish_batch(handle)[0]
        cfg = self.cfg
        with stage_timer(stage_ms, "encode", dev):
            vision, region_padded, _ = self._encode_one(prep)
        info = prep["splice"]
        s = info.seq_len
        pad_len = pad_to_bucket(s, 128)
        cache_len = pad_len + max_new_tokens
        gen_cfg = self._gen_cfg(max_new_tokens, temperature, top_p,
                                eos_token_id, stop_seqs)
        prog = None
        with stage_timer(stage_ms, "prefill", dev):
            embeds = self._splice_one(info, vision, region_padded,
                                      pad_len)[None]
            pos = np.zeros((3, 1, pad_len), np.int64)
            pos[:, :, :s] = prep["position_ids"]
            if streamer is None:
                prog = loop_program(self.text, cfg.text, gen_cfg, 1,
                                    cache_len, None, self.cuda_graphs)
            seq = torch.full((1,), s, device=dev)
            cache, first_logits = prefill(
                self.text, cfg.text, embeds, self._upload(pos), seq,
                cache_len, attention=self.attention,
                cache=None if prog is None else prog.cache)
        delta = int(prep["rope_deltas"][0, 0])
        with stage_timer(stage_ms, "decode", dev):
            if streamer is not None:
                tokens, steps = self._decode_streaming(
                    cache, first_logits, s, delta, gen_cfg, streamer,
                    stop_strings=[x for x in (stop_strings or ())
                                  if isinstance(x, str)])
            else:
                tokens, steps = start_decode_loop(
                    self.text, cfg.text, gen_cfg, cache, first_logits, seq,
                    torch.full((1,), delta, device=dev),
                    self._generator(seed), program=prog).finish()
                tokens = tokens[0].cpu().numpy()
        out = tokens[:steps]
        eos = gen_cfg.eos_token_id
        if eos in out.tolist():
            out = out[:out.tolist().index(eos)]
        out = self._trim_stop_tail(out, stop_seqs)
        text = decode_to_text(
            self.tokenizer, tokens[:steps], eos,
            stop_strings=("<|im_end|>",) + tuple(
                x for x in (stop_strings or ()) if isinstance(x, str))) \
            if self.tokenizer else ""
        return GenerationResult(
            text=text, token_ids=out, prompt_len=s, num_steps=steps,
            prefill_logits=first_logits[0].float().cpu().numpy())

    @staticmethod
    def _fusable(preps: list[dict]) -> bool:
        """True when a batch runs as one stacked batch: single-image
        prompts sharing one geometry and one transfer mode (all raw images
        or all patch rows)."""
        return (
            all(p.get("first_is_image", True) and len(p["plans"]) == 1
                for p in preps)
            and len({tuple(int(g) for g in p["grid"]) for p in preps}) == 1
            and len({p.get("raw_image") is not None for p in preps}) == 1)

    def _token_arrays(self, preps, nb, pad_len):
        """ids / img_pos / reg_pos / pos / seq_lens / deltas host arrays of
        a same-geometry batch right-padded to pad_len."""
        b = len(preps)
        splices = [p["splice"] for p in preps]
        seq_lens = np.array([s.seq_len for s in splices], np.int64)
        if int(seq_lens.max()) > pad_len:
            raise ValueError(
                f"prompt length {int(seq_lens.max())} exceeds the pad bucket "
                f"{pad_len}")
        ids = np.zeros((b, pad_len), np.int64)
        img_pos = np.empty((b, len(splices[0].image_positions)), np.int64)
        reg_pos = np.full((b, nb), pad_len, np.int64)
        pos = np.zeros((3, b, pad_len), np.int64)
        for i, (p, info) in enumerate(zip(preps, splices)):
            ids[i, :info.seq_len] = info.input_ids
            img_pos[i] = info.image_positions
            reg_pos[i, :len(info.region_positions)] = info.region_positions
            pos[:, i, :info.seq_len] = p["position_ids"][:, 0]
        deltas = np.array([int(p["rope_deltas"][0, 0]) for p in preps],
                          np.int64)
        return ids, img_pos, reg_pos, pos, seq_lens, deltas

    def _splice_stacked(self, enc, vision, region, preps, pad_len):
        ids, img_pos, reg_pos, pos, seq_lens, deltas = self._token_arrays(
            preps, enc["nb"], pad_len)
        embeds = self._splice_rows(self._upload(ids), vision,
                                   self._upload(img_pos), region,
                                   self._upload(reg_pos))
        return embeds, pos, seq_lens, deltas

    def _prefill_and_decode(self, embeds, pos, seq_lens, deltas, gen_cfg,
                            seed, prompt_pad):
        """Prefill the padded batch into a loop program's cache and start
        its decode; nothing here waits for the device."""
        b, pad_len = embeds.shape[:2]
        cache_len = pad_len + gen_cfg.max_new_tokens
        prog = loop_program(self.text, self.cfg.text, gen_cfg, b, cache_len,
                            prompt_pad, self.cuda_graphs)
        seq_d = self._upload(seq_lens)
        _, first_logits = prefill(
            self.text, self.cfg.text, embeds, self._upload(pos), seq_d,
            cache_len, attention=self.attention, cache=prog.cache)
        run = start_decode_loop(
            self.text, self.cfg.text, gen_cfg, prog.cache, first_logits,
            seq_d, self._upload(deltas), self._generator(seed),
            prompt_pad, program=prog)
        return run, first_logits

    @torch.inference_mode()
    def _launch_fused(self, preps: list[dict], max_new_tokens: int = 512,
                      temperature: float = 0.0, top_p: float = 1.0,
                      seed: int = 0, eos_token_id: int | None = None,
                      stop_sequences: tuple = ()) -> dict:
        """launch_batch of a same-geometry batch: one stacked encode, one
        batched splice, the prefill and the decode."""
        enc = self._stack_batch_inputs(preps)
        pad_len = pad_to_bucket(max(p["splice"].seq_len for p in preps), 128)
        gen_cfg = self._gen_cfg(max_new_tokens, temperature, top_p,
                                eos_token_id, stop_sequences)
        vision, region = self._encode_batched(enc)
        embeds, pos, seq_lens, deltas = self._splice_stacked(
            enc, vision, region, preps, pad_len)
        run, first_logits = self._prefill_and_decode(
            embeds, pos, seq_lens, deltas, gen_cfg, seed, pad_len)
        return {"run": run, "first_logits": first_logits,
                "seq_lens": seq_lens, "eos": gen_cfg.eos_token_id,
                "stop_sequences": stop_sequences}

    def _encode_many(self, preps: list[dict]):
        """Per-item (splice, nb, vision_tokens, region_padded): one stacked
        encode for a same-geometry batch of more than one, else one encode
        per item."""
        if len(preps) > 1 and self._fusable(preps):
            enc = self._stack_batch_inputs(preps)
            vision, region = self._encode_batched(enc)
            return [(p["splice"], enc["nb"], vision[i], region[i])
                    for i, p in enumerate(preps)]
        out = []
        for p in preps:
            vision, region, nb = self._encode_one(p)
            out.append((p["splice"], nb, vision, region))
        return out

    def generate_batch(self, messages_list: list[list[dict]],
                       max_new_tokens: int = 512, temperature: float = 0.0,
                       top_p: float = 1.0, seed: int = 0,
                       max_pixels: int | None = None,
                       eos_token_id: int | None = None
                       ) -> list[GenerationResult]:
        """Batched generation: ragged prompts right-padded to a shared
        bucket, one prefill and one decode loop for the batch."""
        preps = [self.prepare(m, max_pixels=max_pixels)
                 for m in messages_list]
        handle = self.launch_batch(
            preps, max_new_tokens=max_new_tokens, temperature=temperature,
            top_p=top_p, seed=seed, eos_token_id=eos_token_id)
        return self.finish_batch(handle)

    @torch.inference_mode()
    def launch_batch(self, preps: list[dict], max_new_tokens: int = 512,
                     temperature: float = 0.0, top_p: float = 1.0,
                     seed: int = 0, eos_token_id: int | None = None) -> dict:
        """Enqueue encode, splice, prefill and the first decode graph for a
        batch of prepared inputs without waiting for the device; the
        handle's tensors are in flight. `finish_batch` completes it. A
        same-geometry batch stacks (`_launch_fused`); a mixed one encodes
        per item."""
        if self._fusable(preps):
            return self._launch_fused(
                preps, max_new_tokens=max_new_tokens, temperature=temperature,
                top_p=top_p, seed=seed, eos_token_id=eos_token_id)
        items = self._encode_many(preps)
        pad_len = pad_to_bucket(max(s.seq_len for s, *_ in items), 128)
        uniform = len({(tuple(v.shape), tuple(r.shape),
                        len(s.image_positions))
                       for s, _, v, r in items}) == 1
        if uniform:
            ids, img_pos, reg_pos, _, _, _ = self._token_arrays(
                preps, items[0][1], pad_len)
            embeds = self._splice_rows(
                self._upload(ids), torch.stack([v for *_, v, _ in items]),
                self._upload(img_pos), torch.stack([r for *_, r in items]),
                self._upload(reg_pos))
        else:
            embeds = torch.stack([self._splice_one(s, v, r, pad_len)
                                  for s, _, v, r in items])
        b = len(preps)
        seq_lens = np.array([s.seq_len for s, *_ in items], np.int64)
        pos = np.zeros((3, b, pad_len), np.int64)
        for i, prep in enumerate(preps):
            pos[:, i, :seq_lens[i]] = prep["position_ids"][:, 0]
        deltas = np.array([int(p["rope_deltas"][0, 0]) for p in preps],
                          np.int64)
        gen_cfg = self._gen_cfg(max_new_tokens, temperature, top_p,
                                eos_token_id)
        run, first_logits = self._prefill_and_decode(
            embeds, pos, seq_lens, deltas, gen_cfg, seed, pad_len)
        return {"run": run, "first_logits": first_logits,
                "seq_lens": seq_lens, "eos": gen_cfg.eos_token_id}

    @torch.inference_mode()
    def finish_batch(self, handle: dict) -> list[GenerationResult]:
        """Run a launch_batch handle's decode to its end and decode the
        results (each row's text is cut at EOS and `<|im_end|>`)."""
        tokens, steps = handle["run"].finish()
        tokens = tokens.cpu().numpy()
        logits = handle["first_logits"].float().cpu().numpy()
        seq_lens, eos = handle["seq_lens"], handle["eos"]
        stop_seqs = handle.get("stop_sequences", ())
        results = []
        for i in range(tokens.shape[0]):
            row = tokens[i, :steps]
            out = row
            if eos in out.tolist():
                out = out[:out.tolist().index(eos)]
            out = self._trim_stop_tail(out, stop_seqs)
            text = decode_to_text(self.tokenizer, row, eos) \
                if self.tokenizer else ""
            results.append(GenerationResult(
                text=text, token_ids=out, prompt_len=int(seq_lens[i]),
                num_steps=steps, prefill_logits=logits[i]))
        return results

    # ---------------------------------------------- continuous batching
    # A session decodes in chunks over a chunk-mode decode program; between
    # chunks, finished slots are refilled with new prepared requests
    # (encode, prefill into the slots, first-token sample, state scatter).

    @torch.inference_mode()
    def start_session(self, preps: list[dict], max_new_tokens: int = 512,
                      row_max: list[int] | None = None,
                      temperature: float = 0.0, top_p: float = 1.0,
                      seed: int = 0, eos_token_id: int | None = None,
                      stop_sequences: tuple = (), chunk: int = 32,
                      pad_len: int | None = None) -> dict:
        """Open a continuous-batching session over a same-geometry prep
        batch. `row_max` gives per-request token budgets (<= max_new_tokens,
        which sizes the shared cache). The session holds its decode program
        until `close_session`; its "cur", "row_steps", "done", "seq_lens",
        "deltas", "row_max", "tail" and "cache" are the program's device
        tensors."""
        if not self._fusable(preps):
            raise ValueError("session batches must share one geometry "
                             "(see FO1Model._fusable)")
        b = len(preps)
        enc = self._stack_batch_inputs(preps)
        pad_len = pad_len or pad_to_bucket(
            max(p["splice"].seq_len for p in preps), 128)
        row_max = list(row_max or [max_new_tokens] * b)
        if len(row_max) != b or max(row_max) > max_new_tokens:
            raise ValueError(f"row_max {row_max} for {b} rows and "
                             f"max_new_tokens {max_new_tokens}")
        gen_cfg = self._gen_cfg(max_new_tokens, temperature, top_p,
                                eos_token_id, stop_sequences)
        tlen = max([len(s) for s in stop_sequences] or [1])
        prog = acquire_program(
            self.text, self.cfg.text, gen_cfg, mode="chunk", batch=b,
            cache_len=pad_len + max_new_tokens, prompt_pad=pad_len,
            steps=chunk, tail_len=tlen, cuda_graphs=self.cuda_graphs)
        vision, region = self._encode_batched(enc)
        embeds, pos, seq_lens, deltas = self._splice_stacked(
            enc, vision, region, preps, pad_len)
        seq_d = self._upload(seq_lens)
        _, first_logits = prefill(
            self.text, self.cfg.text, embeds, self._upload(pos), seq_d,
            pad_len + max_new_tokens, attention=self.attention,
            cache=prog.cache)
        gen = self._generator(seed)
        tok0, done0 = sample_first(first_logits, gen_cfg, gen)
        load_chunk_state(prog, tok0, torch.ones_like(tok0), done0, seq_d,
                         self._upload(deltas),
                         self._upload(np.asarray(row_max, np.int64)),
                         torch.full_like(prog.tail, -1))
        return {
            "program": prog, "cache": prog.cache, "cur": prog.cur,
            "row_steps": prog.row_steps, "done": prog.done,
            "seq_lens": prog.seq_lens, "deltas": prog.rope_deltas,
            "row_max": prog.row_max, "tail": prog.tail, "tok0": tok0,
            "gen_cfg": gen_cfg, "prompt_pad": pad_len, "chunk": chunk,
            "grid": enc["grid"], "batch": b, "eos": gen_cfg.eos_token_id,
            "stop_sequences": stop_sequences, "seed": seed,
            "generator": gen, "ticks": 0,
        }

    @torch.inference_mode()
    def decode_session_chunk(self, sess: dict):
        """Run one decode chunk on the session (one graph replay, no host
        wait). Returns (tokens [B, chunk], prev_row_steps, steps_taken) as
        device tensors: row b's new tokens are tokens[b, :row_steps[b] -
        prev_row_steps[b]]."""
        sess["ticks"] += 1
        prog = sess["program"]
        prev = prog.row_steps.clone()
        toks, *_, steps, _ = decode_chunk(
            self.text, self.cfg.text, sess["gen_cfg"], prog.cache, prog.cur,
            prog.row_steps, prog.done, prog.seq_lens, prog.rope_deltas,
            prog.row_max, prog.tail, sess["generator"],
            prompt_pad=sess["prompt_pad"], chunk=sess["chunk"], program=prog)
        return toks, prev, steps

    @torch.inference_mode()
    def refill_session(self, sess: dict, preps: list[dict],
                       slots: list[int],
                       row_max: list[int] | None = None):
        """Fill freed slots with new prepared requests (same geometry as the
        session). Returns tok0 [G]: each refilled row's first token."""
        if len(preps) != len(slots) or not slots:
            raise ValueError("one prep per slot, at least one")
        enc = self._stack_batch_inputs(preps)
        if tuple(enc["grid"]) != tuple(sess["grid"]):
            raise ValueError("refill geometry differs from the session's")
        gen_cfg = sess["gen_cfg"]
        row_max = list(row_max or [gen_cfg.max_new_tokens] * len(preps))
        if max(row_max) > gen_cfg.max_new_tokens:
            raise ValueError(f"row_max {row_max} exceeds the session's "
                             f"{gen_cfg.max_new_tokens}")
        sess["ticks"] += 1
        prog = sess["program"]
        vision, region = self._encode_batched(enc)
        embeds, pos, seq_lens, deltas = self._splice_stacked(
            enc, vision, region, preps, sess["prompt_pad"])
        slots_d = self._upload(np.asarray(slots, np.int64))
        seq_d = self._upload(seq_lens)
        _, logits = prefill_into_slots(
            self.text, self.cfg.text, embeds, self._upload(pos), seq_d,
            prog.cache, slots_d, attention=self.attention)
        tok0, done0 = sample_first(logits, gen_cfg, sess["generator"])
        prog.cur.index_copy_(0, slots_d, tok0)
        prog.row_steps.index_fill_(0, slots_d, 1)
        prog.done.index_copy_(0, slots_d, done0)
        prog.seq_lens.index_copy_(0, slots_d, seq_d)
        prog.rope_deltas.index_copy_(0, slots_d, self._upload(deltas))
        prog.row_max.index_copy_(0, slots_d, self._upload(
            np.asarray(row_max, np.int64)))
        prog.tail.index_fill_(0, slots_d, -1)
        return tok0

    def close_session(self, sess: dict):
        """Return the session's decode program to the program cache."""
        prog = sess.pop("program", None)
        if prog is not None:
            release_program(self.text, prog)

    @torch.inference_mode()
    def _decode_streaming(self, cache, first_logits, seq_len, delta, gen_cfg,
                          streamer, stop_strings=()):
        """Host-driven greedy step decode that calls `streamer(text)` after
        every token (the reference streams through HF's TextStreamer).
        stop_strings are matched against the decoded text. Returns (tokens
        [max_new] padded, steps)."""
        tokens = []
        cur = int(first_logits.argmax(dim=-1)[0])
        dev = first_logits.device
        for step in range(gen_cfg.max_new_tokens):
            tokens.append(cur)
            text_now = None
            if self.tokenizer is not None:
                text_now = decode_to_text(
                    self.tokenizer, tokens, gen_cfg.eos_token_id,
                    stop_strings=("<|im_end|>",) + tuple(stop_strings))
                streamer(text_now)
            if cur == gen_cfg.eos_token_id:
                break
            if text_now is not None and stop_strings:
                raw = self.tokenizer.decode([int(t) for t in tokens])
                if any(s in raw for s in stop_strings):
                    break
            logits = decode_step(
                self.text, self.cfg.text, cache,
                torch.full((1,), cur, device=dev),
                torch.full((1,), seq_len + delta + step, device=dev),
                seq_len + step)
            cur = int(logits.argmax(dim=-1)[0])
        out = np.full(gen_cfg.max_new_tokens, gen_cfg.pad_token_id, np.int64)
        out[:len(tokens)] = tokens
        return out, len(tokens)
