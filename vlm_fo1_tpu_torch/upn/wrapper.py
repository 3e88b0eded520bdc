"""UPNWrapper, the UPN public API (counterpart of `vlm_fo1_tpu/upn/wrapper.py`,
reference inference_wrapper.py:29-237).

    upn = UPNWrapper(ckpt_path)            # or UPNWrapper.random_init()
    raw = upn.inference(image, prompt_type="fine_grained_prompt")
    det = upn.filter(raw, min_score=0.3, nms_value=0.8)

The host resizes each image (short side 800, long side capped at 1333, PIL
bilinear) and pads it to a stride-128 bucket as uint8; the device normalises
it with the ImageNet statistics and zeroes the padded region in normalised
space. Same-bucket images run as one batch. The postprocess (sigmoid,
cxcywh -> original-pixel xyxy, stable descending sort by score) runs on the
device; `filter` (threshold, NMS, int cast) runs on the host.
"""

from __future__ import annotations

import argparse
import pickle
import re

import numpy as np
import torch
from PIL import Image

from vlm_fo1_tpu_torch import nn as tnn
from vlm_fo1_tpu_torch.ops.msda import MSDeformAttn
from vlm_fo1_tpu_torch.ops.nms import nms_numpy
from vlm_fo1_tpu_torch.runtime.device import stage_timer
from vlm_fo1_tpu_torch.upn.model import UPN, UPNConfig
from vlm_fo1_tpu_torch.upn.swin import swin_large_config

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
BUCKET = 128
_SWIN_PREFIX = "backbone.model.backbone."


def _compass_bias(n_heads, n_levels, n_points) -> np.ndarray:
    """The reference's sampling-offset bias init (ms_deform_attn.py:77-97),
    head-major (head, level, point, coord)."""
    thetas = np.arange(n_heads, dtype=np.float64) * (2 * np.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


@torch.no_grad()
def random_init_(model: UPN, seed: int = 0) -> UPN:
    """The JAX package's init scheme, drawn on the model's device from a
    seeded torch.Generator: std-0.02 linears and convs with zero biases, unit
    norms, std-1 level / query / prompt embeddings, the compass offset bias
    with zero offset and weight projections, zeroed last box layers."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    for p in model.parameters():
        p.fill_(float("nan"))

    def normal(p, std):
        p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * std)

    for mod in model.modules():
        if isinstance(mod, (tnn.LayerNorm, tnn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, (tnn.Linear, tnn.Conv2d)):
            normal(mod.weight, 0.02)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, tnn.MultiheadAttention):
            normal(mod.in_proj_weight, 0.02)
            mod.in_proj_bias.zero_()
        elif hasattr(mod, "relative_position_bias_table"):
            normal(mod.relative_position_bias_table, 0.02)
    for mod in model.modules():
        if isinstance(mod, MSDeformAttn):
            mod.sampling_offsets.weight.zero_()
            mod.sampling_offsets.bias.copy_(torch.from_numpy(_compass_bias(
                mod.n_heads, mod.n_levels, mod.n_points)))
            mod.attention_weights.weight.zero_()
    tr = model.transformer
    for p in (tr.level_embed, tr.tgt_embed.weight,
              tr.fine_grained_prompt.weight, tr.coarse_grained_prompt.weight):
        normal(p, 1.0)
    for head in (model.bbox_embed[0], tr.enc_out_bbox_embed):
        head.layers[-1].weight.zero_()
        head.layers[-1].bias.zero_()
    missed = [n for n, p in model.named_parameters() if p.isnan().any()]
    if missed:
        raise RuntimeError(f"random_init_ left parameters unset: {missed}")
    return model


# what a checkpoint may hold beside tensors, containers and plain values:
# the `args` Namespace that training scripts of the DETR family save
SAFE_GLOBALS = (argparse.Namespace,)


def read_checkpoint(ckpt_path: str, trusted: bool = False):
    """torch.load of a `.pth` on the CPU. By default only tensors,
    containers, plain values and SAFE_GLOBALS are unpickled; any other
    object raises pickle.UnpicklingError naming it. trusted=True unpickles
    whatever the file holds (weights_only=False, as the JAX converter
    loads), which runs code from the file: only for a file whose source
    is trusted."""
    if trusted:
        return torch.load(ckpt_path, map_location="cpu", weights_only=False)
    try:
        with torch.serialization.safe_globals(list(SAFE_GLOBALS)):
            return torch.load(ckpt_path, map_location="cpu",
                              weights_only=True)
    except pickle.UnpicklingError as e:
        found = re.search(r"GLOBAL (\S+)", str(e))
        what = found.group(1) if found else "an object"
        raise pickle.UnpicklingError(
            f"UPN checkpoint {ckpt_path} holds {what}, which is not a tensor,"
            f" a plain value or one of "
            f"{[f'{c.__module__}.{c.__qualname__}' for c in SAFE_GLOBALS]};"
            f" pass trusted=True to unpickle it (runs code from the file)"
        ) from e


def load_upn_checkpoint(model: UPN, ckpt_path: str,
                        trusted: bool = False) -> UPN:
    """Load a reference `.pth` (`checkpoint["model"]`, `module.` prefixes
    stripped; older `backbone.model.0.` / `backbone.0.body.` Swin prefixes
    accepted). Every parameter of the model must be present; keys the model
    does not have (shared copies of the box head, training state) are
    ignored, as the JAX converter ignores them. The file is read by
    `read_checkpoint` (`trusted` as there)."""
    ckpt = read_checkpoint(ckpt_path, trusted)
    state = ckpt.get("model", ckpt)
    sd = {k.replace("module.", ""): v for k, v in state.items()}
    if not any(k.startswith(_SWIN_PREFIX) for k in sd):
        for old in ("backbone.model.0.", "backbone.0.body."):
            if any(k.startswith(old) for k in sd):
                sd = {(_SWIN_PREFIX + k[len(old):] if k.startswith(old)
                       else k): v for k, v in sd.items()}
                break
    want = model.state_dict().keys()
    missing = [k for k in want if k not in sd]
    if missing:
        raise KeyError(f"UPN checkpoint {ckpt_path} lacks {missing[:8]}"
                       f" ({len(missing)} keys)")
    model.load_state_dict({k: sd[k] for k in want}, strict=True)
    return model


class UPNWrapper:
    def __init__(self, ckpt_path: str | None = None,
                 cfg: UPNConfig | dict | str | None = None, swin_cfg=None,
                 dtype=torch.bfloat16, seed: int = 0, device="cuda",
                 trusted: bool = False):
        """cfg: a UPNConfig, a reference-style `model` dict or the path of a
        reference config .py. bfloat16 by default; the box chain inside
        the model stays float32. trusted: unpickle any object the
        checkpoint holds (`read_checkpoint`)."""
        if isinstance(cfg, str):
            cfg = UPNConfig.from_config_file(cfg)
        elif isinstance(cfg, dict):
            cfg = UPNConfig.from_config_dict(cfg)
        self.cfg = cfg or UPNConfig()
        self.swin_cfg = swin_cfg or swin_large_config()
        self.dtype = dtype
        self.model = UPN(self.cfg, self.swin_cfg, device=device, dtype=dtype)
        self.device = self.model.device
        if ckpt_path is not None:
            load_upn_checkpoint(self.model, ckpt_path, trusted)
        else:
            random_init_(self.model, seed)

    @classmethod
    def random_init(cls, cfg=None, swin_cfg=None, seed=0,
                    dtype=torch.float32, device="cuda"):
        return cls(None, cfg, swin_cfg, dtype, seed, device)

    # ------------------------------------------------------------- host

    def transform_image(self, image_pil: Image.Image,
                        short_side: int = 800, max_size: int = 1333):
        """Shortest-edge resize capped at max_size. Returns raw uint8
        pixels [H, W, 3] and (H, W); normalisation happens on the device."""
        w, h = image_pil.size
        scale = short_side / min(h, w)
        if max(h, w) * scale > max_size:
            scale = max_size / max(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        img = image_pil.resize((nw, nh), Image.Resampling.BILINEAR)
        return np.asarray(img, np.uint8), (nh, nw)

    def _pad_to_bucket(self, arr: np.ndarray):
        h, w, _ = arr.shape
        ph = -(-h // BUCKET) * BUCKET
        pw = -(-w // BUCKET) * BUCKET
        out = np.zeros((ph, pw, 3), arr.dtype)
        out[:h, :w] = arr
        return out

    # ----------------------------------------------------------- device

    def prepare(self, image):
        """Host side of one image (path or PIL): returns the bucket-padded
        uint8 pixels [Hb, Wb, 3], the resized (h, w) and the original
        (w, h)."""
        if isinstance(image, str):
            image = Image.open(image).convert("RGB")
        arr, hw = self.transform_image(image)
        return self._pad_to_bucket(arr), hw, image.size

    def model_input(self, stack, hw):
        """uint8 [B, Hb, Wb, 3] and valid (h, w) [B, 2] on the device ->
        the ImageNet-normalised image in the model dtype, zero outside the
        valid region (the reference pads with 0 after normalisation)."""
        dev = self.device
        img = torch.as_tensor(stack).to(dev)
        hw = torch.as_tensor(hw).to(dev)
        mean = torch.from_numpy(IMAGENET_MEAN * 255.0).to(dev)
        std = torch.from_numpy(IMAGENET_STD * 255.0).to(dev)
        x = ((img.float() - mean) / std).to(self.dtype)
        rows = torch.arange(x.shape[1], device=dev)[None, :, None]
        cols = torch.arange(x.shape[2], device=dev)[None, None, :]
        valid = (rows < hw[:, 0, None, None]) & (cols < hw[:, 1, None, None])
        return x * valid[..., None].to(self.dtype), hw

    @torch.inference_mode()
    def _forward(self, stack, hw, wh, prompt_type, stage_ms):
        dev = self.device
        x, hw = self.model_input(stack, hw)
        out = self.model(x, hw, prompt_type, stage_ms=stage_ms)
        with stage_timer(stage_ms, "postprocess", dev):
            boxes = out["pred_boxes"].float()                 # cxcywh [0,1]
            scores = torch.sigmoid(out["pred_logits"].float())
            wh = torch.from_numpy(wh).to(dev)[:, None]        # [B, 1, 2]
            half = boxes[..., 2:4] / 2
            xyxy = torch.cat([(boxes[..., 0:2] - half) * wh,
                              (boxes[..., 0:2] + half) * wh], -1)
            order = torch.sort(-scores[..., 0], dim=-1, stable=True).indices
            xyxy = torch.gather(xyxy, 1, order[..., None].expand(-1, -1, 4))
            scores = torch.gather(scores, 1, order[..., None])
        return xyxy, scores

    def inference(self, image, prompt_type: str = "fine_grained_prompt",
                  batch_size: int = 4, stage_ms: dict | None = None):
        """image: path / PIL / list of either. Returns dict with
        original_xyxy_boxes [B, nq, 4] (pixels, score-sorted) and scores
        [B, nq, 1], as numpy. stage_ms receives the summed ms of transform
        (host) and backbone / encoder / decoder / postprocess (device,
        synchronised)."""
        if not isinstance(image, (list, tuple)):
            image = [image]
        n = len(image)
        times: dict = {}
        with stage_timer(times, "transform", torch.device("cpu")):
            metas, groups = [], {}
            for i, img in enumerate(image):
                padded, hw, size = self.prepare(img)
                metas.append(size)                           # (w, h)
                groups.setdefault(padded.shape, []).append((i, padded, hw))
        pending = []
        for items in groups.values():
            for c0 in range(0, len(items), max(batch_size, 1)):
                chunk = items[c0:c0 + max(batch_size, 1)]
                idxs = [it[0] for it in chunk]
                part: dict = {}
                out = self._forward(
                    np.stack([it[1] for it in chunk]),
                    np.array([it[2] for it in chunk], np.int32),
                    np.array([metas[i] for i in idxs], np.float32),
                    prompt_type, part if stage_ms is not None else None)
                for k, v in part.items():
                    times[k] = times.get(k, 0.0) + v
                pending.append((idxs, out))
        all_boxes, all_scores = [None] * n, [None] * n
        for idxs, (xy, sc) in pending:
            xy, sc = xy.cpu().numpy(), sc.cpu().numpy()
            for row, i in enumerate(idxs):
                all_boxes[i], all_scores[i] = xy[row], sc[row]
        if stage_ms is not None:
            stage_ms.update(times)
        return {"original_xyxy_boxes": np.stack(all_boxes),
                "scores": np.stack(all_scores)}

    # ------------------------------------------------------------- post

    def filter(self, result: dict, min_score: float, nms_value: float = 0.8):
        """Score threshold + NMS + int cast, score-sorted (reference
        inference_wrapper.py:186-237). An image with no box above the
        threshold gives an empty row, and the other images keep theirs."""
        filtered = {"original_xyxy_boxes": [], "scores": []}
        for boxes, scores in zip(np.asarray(result["original_xyxy_boxes"]),
                                 np.asarray(result["scores"])):
            keep = scores[:, 0] >= min_score
            boxes = boxes[keep]
            scores = scores[keep][:, 0]
            if len(boxes) == 0:
                filtered["original_xyxy_boxes"].append([])
                filtered["scores"].append([])
                continue
            if nms_value > 0:
                keep_idx = nms_numpy(boxes, scores, nms_value)
            else:
                keep_idx = np.arange(len(boxes))
            boxes = boxes[keep_idx].astype(np.int32)
            scores = scores[keep_idx]
            order = np.argsort(-scores, kind="stable")
            filtered["original_xyxy_boxes"].append(boxes[order].tolist())
            filtered["scores"].append([round(float(s), 2)
                                       for s in scores[order]])
        return filtered
