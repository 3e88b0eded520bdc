"""FO1 model composition (counterpart of `vlm_fo1_tpu/models/fo1.py`):
Qwen2.5-VL ViT + DaViT -> HFRE region features -> two projectors ->
embedding splice -> Qwen2.5 trunk prefill -> greedy / top-p decode.

The host steps are the port's copies of the JAX package's host functions
(`vlm_fo1_tpu_torch.preprocess`), composed here for single-image prompts;
parsing the answer back to boxes is left to callers
(`postprocess.extract_predictions_to_bboxes`). Batched, serving, session and video
paths are not ported yet.

Submodules carry the checkpoint's tower names: `vision_tower`,
`vision_tower_aux`, `text` (the trunk, `model.` in the checkpoint),
`mm_projector`, `mm_projector_aux`.
"""

from __future__ import annotations

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
from vlm_fo1_tpu_torch.models.hfre import hfre_forward
from vlm_fo1_tpu_torch.models.llm import TextModel
from vlm_fo1_tpu_torch.models.projector import build_projector
from vlm_fo1_tpu_torch.models.vit import (
    VisionTransformer,
    captures_to_feature_map,
)
from vlm_fo1_tpu_torch.ops.flash_attention import flash_attention
from vlm_fo1_tpu_torch.runtime.device import resolve_device, stage_timer
from vlm_fo1_tpu_torch.runtime.generate import (
    GenerationConfig,
    decode_loop,
    decode_to_text,
    prefill,
)


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
        the caller asks for the CPU); fill them with `random_init` or
        `load_state_dict`."""
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
                elif isinstance(mod, (tnn.Linear, tnn.Conv2d, tnn.Weight)):
                    mod.weight.normal_(0.0, 0.02, generator=gen)
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

    # ------------------------------------------------------ host pipeline

    def prepare(self, messages: list[dict], max_pixels: int | None = None):
        """Host preparation of a single-image prompt, as
        `vlm_fo1_tpu.models.fo1.FO1Model.prepare` does it: ChatML tokens with
        sentinels, shortest-edge resize with box rescale, uint8 patchify, the
        ViT window plan, the aux squash, box transforms, token expansion and
        M-RoPE position ids."""
        cfg = self.cfg
        prompt, tokens, media_urls, bbox_list = build_chat_tokens(
            self.tokenizer, messages)
        if len(media_urls) != 1 or isinstance(media_urls[0], dict):
            raise NotImplementedError(
                "the PyTorch port handles prompts with exactly one image")
        imgs, bbox_lists = pp.resize_shortest_edge_images_and_bboxes(
            [pp.load_image(media_urls[0])], [list(bbox_list or [])],
            max_size=cfg.max_image_long_side)
        img, boxes = imgs[0], bbox_lists[0][:cfg.max_regions]
        pv, grid = pp.qwen_image_patchify_u8(
            img, patch_size=cfg.vision.patch_size,
            merge_size=cfg.vision.spatial_merge_size,
            min_pixels=cfg.min_pixels,
            max_pixels=max_pixels or cfg.max_pixels)
        plan = build_vit_plan(grid, cfg.vision)
        aux = pp.aux_image_u8(img, cfg.aux_image_size)
        w, h = img.size
        size = cfg.aux_image_size
        aux_boxes = np.asarray(
            pp.adjust_bbox(boxes, h, w, size, size) if boxes
            else np.zeros((0, 4)), np.float32).reshape(-1, 4)
        sx = grid[2] * cfg.vision.patch_size / size
        sy = grid[1] * cfg.vision.patch_size / size
        vt_boxes = aux_boxes * np.array([sx, sy, sx, sy], np.float32)
        info = expand_multimodal_tokens(tokens, [plan.num_units],
                                        [cfg.image_token_id])
        pos_ids, deltas = pp.get_rope_index(
            info.input_ids[None], [grid],
            spatial_merge_size=cfg.vision.spatial_merge_size,
            image_token_id=cfg.image_token_id,
            video_token_id=cfg.video_token_id,
            vision_start_token_id=cfg.vision_start_token_id,
            tokens_per_second=cfg.vision.tokens_per_second,
            second_per_grid_ts=[])
        return {
            "prompt": prompt, "bbox_list": boxes, "pixel_values": pv,
            "grid": grid, "plan": plan, "aux": aux, "aux_boxes": aux_boxes,
            "vt_boxes": vt_boxes, "splice": info, "position_ids": pos_ids,
            "rope_deltas": deltas,
        }

    # ----------------------------------------------------------- device

    def _tensor(self, a, dtype=None):
        return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)

    @torch.inference_mode()
    def encode(self, prep: dict):
        """Vision and region path. Returns (vision_tokens [U, D],
        region_tokens [n_boxes, D]) in the model dtype."""
        cfg = self.cfg
        plan = prep["plan"]
        mean, std = qwen_patch_norm_vectors(cfg.vision.patch_size,
                                            cfg.vision.temporal_patch_size)
        pv = self._tensor(pad_pixel_values(prep["pixel_values"], plan)[None])
        patches = ((pv.float() / 255.0 - self._tensor(mean))
                   / self._tensor(std)).to(self.dtype)
        aux = self._tensor(prep["aux"][None]).float() / 255.0
        aux = ((aux - self._tensor(AUX_IMAGE_MEAN))
               / self._tensor(AUX_IMAGE_STD)).to(self.dtype)

        tokens, captures = self.vision_tower(
            patches, self._tensor(plan.rot_cos), self._tensor(plan.rot_sin),
            self._tensor(plan.valid), num_windows=plan.num_windows,
            inv_unit_idx=self._tensor(plan.inv_unit_idx, torch.long),
            attention=self.attention)
        vision_tokens = self.mm_projector(tokens)[0]
        vt_map = captures_to_feature_map(
            captures, self._tensor(plan.inv_token_idx, torch.long),
            prep["grid"], cfg.vision.spatial_merge_size)[0]
        stage_maps = self.vision_tower_aux(aux)
        region_feats = hfre_forward(
            cfg.hfre, [m[0] for m in stage_maps],
            self._tensor(prep["aux_boxes"]), vt_map,
            self._tensor(prep["vt_boxes"]))
        region_tokens = self.mm_projector_aux(
            region_feats.to(vision_tokens.dtype))
        return vision_tokens, region_tokens

    @torch.inference_mode()
    def splice(self, prep: dict, vision_tokens, region_tokens):
        """Token embeddings with the vision and region features scattered
        into their slots -> [1, S, D]."""
        info = prep["splice"]
        embeds = self.text.embed(self._tensor(info.input_ids, torch.long))
        embeds[self._tensor(info.image_positions, torch.long)] = \
            vision_tokens.to(embeds.dtype)
        embeds[self._tensor(info.region_positions, torch.long)] = \
            region_tokens.to(embeds.dtype)
        return embeds[None]

    @torch.inference_mode()
    def prefill(self, prep: dict, embeds, cache_len: int):
        """Returns (kv_cache, last-token logits [1, V] fp32)."""
        return prefill(self.text, self.cfg.text, embeds,
                       self._tensor(prep["position_ids"], torch.long),
                       cache_len, attention=self.attention)

    def _stop_token_sequences(self, stop_strings) -> tuple:
        seqs = []
        for s in stop_strings or ():
            if isinstance(s, (list, tuple)):
                seqs.append(tuple(int(t) for t in s))
            elif self.tokenizer is not None:
                seqs.append(tuple(int(t) for t in self.tokenizer.encode(s)))
        return tuple(seqs)

    @torch.inference_mode()
    def generate(self, messages: list[dict], max_new_tokens: int = 512,
                 temperature: float = 0.0, top_p: float = 1.0, seed: int = 0,
                 max_pixels: int | None = None,
                 eos_token_id: int | None = None, stop_strings=None,
                 stage_ms: dict | None = None) -> GenerationResult:
        """Single-stream generation. stage_ms: optional dict that receives
        the wall-clock ms of prepare / encode / prefill / decode, each
        stage ended by a device synchronise."""
        cfg = self.cfg
        stop_seqs = self._stop_token_sequences(stop_strings)
        with stage_timer(stage_ms, "prepare", self.device):
            prep = self.prepare(messages, max_pixels=max_pixels)
        with stage_timer(stage_ms, "encode", self.device):
            vision_tokens, region_tokens = self.encode(prep)
        s = prep["splice"].seq_len
        with stage_timer(stage_ms, "prefill", self.device):
            embeds = self.splice(prep, vision_tokens, region_tokens)
            cache, first_logits = self.prefill(prep, embeds,
                                               s + max_new_tokens)
        eos = cfg.eos_token_id if eos_token_id is None else eos_token_id
        gen_cfg = GenerationConfig(
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_p=top_p, eos_token_id=eos, pad_token_id=cfg.pad_token_id,
            stop_sequences=stop_seqs)
        generator = None
        if temperature != 0.0:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        with stage_timer(stage_ms, "decode", self.device):
            tokens, steps = decode_loop(
                self.text, cfg.text, gen_cfg, cache, first_logits, s,
                int(prep["rope_deltas"][0, 0]), generator)
            tokens = tokens[0].cpu().numpy()
        out = tokens[:steps]
        if eos in out.tolist():
            out = out[:out.tolist().index(eos)]
        for seq in stop_seqs:
            n = len(seq)
            if n and len(out) >= n and out[-n:].tolist() == list(seq):
                out = out[:-n]
                break
        text = decode_to_text(
            self.tokenizer, tokens[:steps], eos,
            stop_strings=("<|im_end|>",) + tuple(
                x for x in (stop_strings or ()) if isinstance(x, str))) \
            if self.tokenizer else ""
        return GenerationResult(
            text=text, token_ids=out, prompt_len=s, num_steps=steps,
            prefill_logits=first_logits[0].float().cpu().numpy())
