"""Plain float32 reference of one FO1 grounding request: VLM-FO1 on the
Qwen2.5-VL-3B trunk (Qwen2.5-VL ViT + DaViT -> HFRE region features -> two
mlp2x_gelu projectors -> splice -> Qwen2.5 decoder with M-RoPE).

It imports nothing of the program. From a configuration file, the weights
the benchmark drew (checkpoint names, as handed to the program) and a
request (image, boxes, question), it works out everything again: the chat
tokens and their expansion, the resizes, patches and aux image, the box
transforms, the M-RoPE positions, every tower, the int4 / int8 rounding of
the quantized serving mode, and the logits that predict each served token
(`served_logits`). No cache, no padding, no batching, no kernels: each
attention is a dense masked softmax over the whole sequence, the ViT's
window attention a mask over 8x8-patch windows, and the trunk sees the
prompt and the served tokens as one causal sequence.

`param_spec` is the layout of the weights the benchmark draws for this
reference and hands to both sides (`benchmark/weights.py`).

`precision="fp8"` is the control: every linear layer whose weights the
configuration states in bf16 takes e4m3 weights (one scale per output row)
and every linear layer takes e4m3 inputs (one scale per row), the products
summed in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from benchmark.yardstick.tokenizer import CharTokenizer

IM_START, IM_END = 151644, 151645
IMAGE_PAD = 151655
IMAGE_SENTINEL, REGION_SENTINEL = -200, -300
QWEN_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
QWEN_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
AUX_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
AUX_STD = np.array([0.229, 0.224, 0.225], np.float32)
FP8_MAX = 448.0


# ------------------------------------------------------------ host steps

def smart_resize(h, w, factor=28, min_pixels=56 * 56, max_pixels=2048 * 2048):
    """Qwen2-VL's rule: sides divisible by factor, pixels within bounds."""
    h_bar = round(h / factor) * factor
    w_bar = round(w / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt(h * w / max_pixels)
        h_bar = max(factor, math.floor(h / beta / factor) * factor)
        w_bar = max(factor, math.floor(w / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (h * w))
        h_bar = math.ceil(h * beta / factor) * factor
        w_bar = math.ceil(w * beta / factor) * factor
    return h_bar, w_bar


def cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] weights of a Keys cubic (a = -0.5) resize with
    antialias (`jax.image.resize(method="cubic")`): the kernel widened by
    the scale when shrinking, each output's weights normalised to sum 1,
    outputs whose sample lies outside the input left empty."""
    f32 = np.float32
    inv = f32(n_in / n_out)
    kscale = max(inv, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kscale
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = np.where(x >= 2.0, 0.0, w).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def rope_index(ids: np.ndarray, lh: int, lw: int) -> np.ndarray:
    """[3, S] M-RoPE positions of one single-image prompt: text advances the
    three channels together; the image span holds (t, row, col) offsets
    from the position where it starts; text after it resumes past the
    largest."""
    pos = np.zeros((3, len(ids)), np.int64)
    cur, i = 0, 0
    while i < len(ids):
        if ids[i] == IMAGE_PAD:
            n = lh * lw
            pos[0, i:i + n] = cur
            pos[1, i:i + n] = cur + np.repeat(np.arange(lh), lw)
            pos[2, i:i + n] = cur + np.tile(np.arange(lw), lh)
            cur = int(pos[:, i:i + n].max()) + 1
            i += n
        else:
            pos[:, i] = cur
            cur += 1
            i += 1
    return pos


def chat_tokens(tok, question: str, n_boxes: int) -> list[int]:
    """The VLM-FO1 prompt of one image with n_boxes regions: the system
    turn, the user turn with the vision markers, one `<region{i}>` +
    region slot per box and the question, then the assistant header."""
    text = "<|im_start|>user\n<|vision_start|><image><|vision_end|>\n"
    if n_boxes:
        text += "".join(f"<region{i}><regionfeat>" for i in range(n_boxes))
        text += "\n"
    text += question + "<|im_end|>\n"
    user = []
    for j, part in enumerate(text.split("<image>")):
        if j:
            user.append(IMAGE_SENTINEL)
        for k, piece in enumerate(part.split("<regionfeat>")):
            if k:
                user.append(REGION_SENTINEL)
            user += tok.encode(piece) if piece else []
    return ([IM_START] + tok.encode("system\nYou are a helpful assistant.")
            + [IM_END] + tok.encode("\n") + user + [IM_START]
            + tok.encode("assistant\n"))


def prepare(cfg: dict, request: dict, aux_mode: str) -> dict:
    """Host inputs of one request. aux_mode "pil" squashes the image to the
    DaViT size with PIL bicubic; "cubic" resamples the smart-resized image
    with `cubic_weights` (the serving paths' device resampling)."""
    v = cfg["vision_config"]
    img = request["image"].convert("RGB")
    boxes = [list(map(float, b)) for b in request["boxes"]]
    ow, oh = img.size
    nh, nw = oh, ow
    long_side = cfg["max_image_long_side"]
    if max(nh, nw) > long_side:
        s = long_side / max(nh, nw)
        nh, nw = int(nh * s), int(nw * s)
    nw, nh = max(28, nw), max(28, nh)
    if (nw, nh) != (ow, oh):
        img = img.resize((nw, nh), Image.Resampling.BICUBIC)
        sx, sy = nw / ow, nh / oh
        boxes = [[a * sx, b * sy, c * sx, d * sy] for a, b, c, d in boxes]
    boxes = boxes[:cfg["max_regions"]]
    ps, ms, tps = (v["patch_size"], v["spatial_merge_size"],
                   v["temporal_patch_size"])
    h_bar, w_bar = smart_resize(img.height, img.width, ps * ms,
                                cfg["min_pixels"], cfg["max_pixels"])
    raw = np.asarray(img.resize((w_bar, h_bar), Image.Resampling.BICUBIC),
                     np.uint8)
    gh, gw = h_bar // ps, w_bar // ps
    chw = ((raw.astype(np.float32) / 255.0 - QWEN_MEAN) / QWEN_STD
           ).transpose(2, 0, 1)
    frames = np.broadcast_to(chw, (tps, *chw.shape))
    patches = frames.reshape(tps, 3, gh // ms, ms, ps, gw // ms, ms, ps)
    patches = patches.transpose(2, 5, 3, 6, 1, 0, 4, 7).reshape(
        gh * gw, 3 * tps * ps * ps)

    size = cfg["aux_image_size"]
    if aux_mode == "pil":
        aux = np.asarray(img.resize((size, size), Image.Resampling.BICUBIC),
                         np.float32)
    elif aux_mode == "cubic":   # resampled on the device (`aux_image`)
        aux = None
    else:
        raise ValueError(f"aux_mode {aux_mode!r}")

    w, h = img.size
    aux_boxes = []
    for x1, y1, x2, y2 in boxes:
        x1, x2 = min(max(x1, 0), w), min(max(x2, 0), w)
        y1, y2 = min(max(y1, 0), h), min(max(y2, 0), h)
        aux_boxes.append([x1 * size / w, y1 * size / h, x2 * size / w,
                          y2 * size / h])
    aux_boxes = np.asarray(aux_boxes, np.float32).reshape(-1, 4)
    sx, sy = gw * ps / size, gh * ps / size
    vt_boxes = aux_boxes * np.array([sx, sy, sx, sy], np.float32)

    tok = CharTokenizer()
    units = (gh // ms) * (gw // ms)
    ids = []
    for t in chat_tokens(tok, request["question"], len(boxes)):
        ids += [IMAGE_PAD] * units if t == IMAGE_SENTINEL else [t]
    ids = np.asarray(ids, np.int64)
    return {"patches": patches, "grid": (gh, gw), "aux": aux, "raw": raw,
            "aux_boxes": aux_boxes, "vt_boxes": vt_boxes, "ids": ids,
            "positions": rope_index(ids, gh // ms, gw // ms)}


# ---------------------------------------------------------- arithmetic

def fp8_rows(x):
    """x rounded to e4m3 with one scale per row (its last axis)."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def absmax_rows(w, qmax: float, lo: int, hi: int):
    """Symmetric per-row rounding of a weight: q * scale in float32, with
    scale = max(absmax / qmax, 1e-8) (the serving modes' int4 and int8)."""
    inv = torch.tensor(1.0 / qmax, dtype=torch.float32, device=w.device)
    scale = (w.abs().amax(dim=-1, keepdim=True) * inv).clamp(min=1e-8)
    return torch.clamp(torch.round(w / scale), lo, hi) * scale


def rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def layer_norm(x, w, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).pow(2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def rotate_half(x, cos, sin):
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], -1) * sin


def attend(q, k, v, allowed):
    """q [H, S, d], k/v [H, T, d] (heads already matched), allowed [S, T]
    -> [S, H*d]; heads in groups to bound the logits' memory."""
    h, s, d = q.shape
    out = torch.empty(s, h, d, dtype=q.dtype, device=q.device)
    group = max(1, (1 << 28) // max(1, s * k.shape[1]))
    for i in range(0, h, group):
        logits = q[i:i + group] @ k[i:i + group].transpose(1, 2)
        logits = (logits / math.sqrt(d)).masked_fill(~allowed, -math.inf)
        out[:, i:i + group] = (torch.softmax(logits, -1)
                               @ v[i:i + group]).transpose(0, 1)
    return out.reshape(s, h * d)


class Reference:
    """cfg: a configuration file's dict; weights: {name: tensor} as the
    benchmark drew them (bf16 on the device); quant "none" or "int4"."""

    def __init__(self, cfg: dict, weights: dict, *, quant: str = "none",
                 precision: str = "f32", device=None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.precision = precision
        self.device = torch.device(device or next(iter(weights.values()))
                                   .device)
        self.w = {}
        low_trunk = quant == "int4"
        for name, t in weights.items():
            t = t.to(self.device, torch.float32)
            trunk_linear = (name.startswith("text.layers.")
                            and (".self_attn." in name or ".mlp." in name)
                            and name.endswith(".weight"))
            if low_trunk and trunk_linear:
                t = absmax_rows(t, 7.0, -8, 7)
            elif low_trunk and name == "text.embed_tokens.weight":
                t = absmax_rows(t, 127.0, -127, 127)
            elif precision == "fp8" and t.dim() == 2 and name != \
                    "text.embed_tokens.weight":
                t = fp8_rows(t)
            elif precision == "fp8" and name.endswith("patch_embed.proj."
                                                      "weight"):
                t = fp8_rows(t.reshape(t.shape[0], -1)).reshape(t.shape)
            self.w[name] = t
        # the tied head: the token table, rounded as the head's weights
        head = self.w["text.embed_tokens.weight"]
        self.head = head if (low_trunk or precision != "fp8") \
            else fp8_rows(head)

    def lin(self, x, name, bias=True):
        if self.precision == "fp8":
            x = fp8_rows(x)
        b = self.w.get(name + ".bias") if bias else None
        return F.linear(x, self.w[name + ".weight"], b)

    # ------------------------------------------------------------ ViT
    def vit(self, patches, gh, gw):
        v = self.cfg["vision_config"]
        p = "vision_tower."
        d, nh = v["hidden_size"], v["num_heads"]
        hd = d // nh
        m = v["spatial_merge_size"]
        lh, lw = gh // m, gw // m
        dev = self.device
        wpe = self.w[p + "patch_embed.proj.weight"]
        x = patches.to(dev)
        if self.precision == "fp8":
            x = fp8_rows(x)
        x = x @ wpe.reshape(wpe.shape[0], -1).t()
        hb = torch.arange(lh, device=dev).repeat_interleave(lw)
        wb = torch.arange(lw, device=dev).repeat(lh)
        mh = torch.tensor([0, 0, 1, 1], device=dev)
        mw = torch.tensor([0, 1, 0, 1], device=dev)
        h_pos = (hb[:, None] * m + mh).reshape(-1).double()
        w_pos = (wb[:, None] * m + mw).reshape(-1).double()
        inv = 1.0 / (10000.0 ** (torch.arange(0, hd // 2, 2, device=dev,
                                              dtype=torch.float64)
                                 / (hd // 2)))
        freqs = torch.cat([h_pos[:, None] * inv, w_pos[:, None] * inv], -1)
        emb = torch.cat([freqs, freqs], -1)
        cos, sin = emb.cos().float(), emb.sin().float()
        wm = v["window_size"] // v["patch_size"] // m
        win = ((hb // wm) * (-(-lw // wm)) + wb // wm).repeat_interleave(
            m * m)
        win_mask = win[:, None] == win[None, :]
        full_mask = torch.ones_like(win_mask)
        full = set(v["fullatt_block_indexes"])
        captures = []
        for i in range(v["depth"]):
            b = f"{p}blocks.{i}."
            h = rms(x, self.w[b + "norm1.weight"], 1e-6)
            qkv = self.lin(h, b + "attn.qkv").reshape(-1, 3, nh, hd)
            q = rotate_half(qkv[:, 0], cos[:, None], sin[:, None])
            k = rotate_half(qkv[:, 1], cos[:, None], sin[:, None])
            att = attend(q.transpose(0, 1), k.transpose(0, 1),
                         qkv[:, 2].transpose(0, 1),
                         full_mask if i in full else win_mask)
            x = x + self.lin(att, b + "attn.proj")
            h = rms(x, self.w[b + "norm2.weight"], 1e-6)
            x = x + self.lin(F.silu(self.lin(h, b + "mlp.gate_proj"))
                             * self.lin(h, b + "mlp.up_proj"),
                             b + "mlp.down_proj")
            if i in full:
                captures.append(x)
        y = rms(x, self.w[p + "merger.ln_q.weight"], 1e-6).reshape(
            -1, d * m * m)
        y = self.lin(F.gelu(self.lin(y, p + "merger.mlp.0")),
                     p + "merger.mlp.2")
        fmap = torch.cat(captures, -1).reshape(lh, lw, m, m, -1)
        fmap = fmap.permute(0, 2, 1, 3, 4).reshape(gh, gw, -1)
        return y, fmap

    # ---------------------------------------------------------- DaViT
    def aux_image(self, prep):
        """The normalised DaViT input [S, S, 3]: the PIL squash, or the
        smart-resized image resampled by `cubic_weights` on each axis."""
        aux = prep["aux"]
        if aux is None:
            size = self.cfg["aux_image_size"]
            h, w = prep["raw"].shape[:2]
            wh, ww = (torch.from_numpy(cubic_weights(n, size)).to(self.device)
                      for n in (h, w))
            raw = torch.from_numpy(np.array(prep["raw"], np.float32)).to(
                self.device)
            aux = torch.einsum("hwc,hy->ywc", raw, wh)
            aux = torch.einsum("ywc,wx->yxc", aux, ww)
        else:
            aux = torch.from_numpy(np.ascontiguousarray(aux)).to(self.device)
        mean, std = (torch.from_numpy(a).to(self.device)
                     for a in (AUX_MEAN, AUX_STD))
        return (aux / 255.0 - mean) / std

    def _dw(self, x, name):
        c = x.shape[-1]
        y = F.conv2d(x.permute(2, 0, 1)[None], self.w[name + ".weight"],
                     self.w[name + ".bias"], padding=1, groups=c)
        return x + y[0].permute(1, 2, 0)

    def _ffn(self, x, p):
        h = layer_norm(x, self.w[p + "norm.weight"], self.w[p + "norm.bias"])
        return x + self.lin(F.gelu(self.lin(h, p + "fn.net.fc1")),
                            p + "fn.net.fc2")

    def _window_attn(self, x, p, heads, ws):
        h, w, c = x.shape
        ph, pw = (-h) % ws, (-w) % ws
        xp = F.pad(x, (0, 0, 0, pw, 0, ph))
        y = layer_norm(xp, self.w[p + "norm.weight"], self.w[p + "norm.bias"])
        nh, nw = (h + ph) // ws, (w + pw) // ws
        y = y.reshape(nh, ws, nw, ws, c).permute(0, 2, 1, 3, 4).reshape(
            nh * nw, ws * ws, c)
        qkv = self.lin(y, p + "fn.qkv").reshape(nh * nw, ws * ws, 3, heads,
                                               c // heads)
        q, k, vv = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        logits = q @ k.transpose(-1, -2) / math.sqrt(c // heads)
        out = (torch.softmax(logits, -1) @ vv).transpose(1, 2).reshape(
            nh * nw, ws * ws, c)
        out = self.lin(out, p + "fn.proj")
        out = out.reshape(nh, nw, ws, ws, c).permute(0, 2, 1, 3, 4).reshape(
            h + ph, w + pw, c)
        return x + out[:h, :w]

    def _channel_attn(self, x, p, groups):
        h, w, c = x.shape
        n = h * w
        y = layer_norm(x, self.w[p + "norm.weight"],
                       self.w[p + "norm.bias"]).reshape(n, c)
        qkv = self.lin(y, p + "fn.qkv").reshape(n, 3, groups, c // groups)
        q = qkv[:, 0] * (float(n) ** -0.5)
        logits = torch.einsum("ngc,ngd->gcd", q, qkv[:, 1])
        out = torch.einsum("gcd,ngd->ngc", torch.softmax(logits, -1),
                           qkv[:, 2]).reshape(n, c)
        return x + self.lin(out, p + "fn.proj").reshape(h, w, c)

    def davit(self, image):
        dv = self.cfg["davit"]
        p = "vision_tower_aux."
        x = image.to(self.device)
        outs = []
        for i in range(len(dv["embed_dims"])):
            c = f"{p}convs.{i}."
            if dv["patch_prenorm"][i]:
                x = layer_norm(x, self.w[c + "norm.weight"],
                               self.w[c + "norm.bias"])
            x = F.conv2d(x.permute(2, 0, 1)[None], self.w[c + "proj.weight"],
                         self.w[c + "proj.bias"],
                         stride=dv["patch_stride"][i],
                         padding=dv["patch_padding"][i])[0].permute(1, 2, 0)
            if not dv["patch_prenorm"][i]:
                x = layer_norm(x, self.w[c + "norm.weight"],
                               self.w[c + "norm.bias"])
            for j in range(dv["depths"][i]):
                b = f"{p}blocks.{i}.{j}."
                s, ch = b + "spatial_block.", b + "channel_block."
                x = self._dw(x, s + "conv1.fn.dw")
                x = self._window_attn(x, s + "window_attn.",
                                      dv["num_heads"][i], dv["window_size"])
                x = self._ffn(self._dw(x, s + "conv2.fn.dw"), s + "ffn.")
                x = self._dw(x, ch + "conv1.fn.dw")
                x = self._channel_attn(x, ch + "channel_attn.",
                                       dv["num_groups"][i])
                x = self._ffn(self._dw(x, ch + "conv2.fn.dw"), ch + "ffn.")
            outs.append(x)
        return outs

    # ----------------------------------------------------------- HFRE
    @staticmethod
    def _axis(lo, hi, size, out):
        """torchvision roi_align (aligned=False, adaptive sampling) along
        one axis, averaged over the output bins: [size] weights."""
        w = np.zeros(size, np.float64)
        roi = max(hi - lo, 1.0)
        bin_sz = roi / out
        ns = max(1, math.ceil(roi / out))
        for pb in range(out):
            for s in range(ns):
                y = lo + pb * bin_sz + (s + 0.5) * bin_sz / ns
                if y < -1.0 or y > size:
                    continue
                y = max(y, 0.0)
                y0 = int(y)
                if y0 >= size - 1:
                    y0 = y1 = size - 1
                    frac = 0.0
                else:
                    y1, frac = y0 + 1, y - y0
                w[y0] += (1.0 - frac) / (out * ns)
                w[y1] += frac / (out * ns)
        return w

    def roi_pool(self, fmap, boxes, scale):
        """fmap [H, W, C], boxes [N, 4] xyxy pixels -> [N, C]."""
        h, w, _ = fmap.shape
        out = self.cfg["mm_roi_output_size"]
        rows = []
        for x1, y1, x2, y2 in np.asarray(boxes, np.float64) * scale:
            wy = torch.tensor(self._axis(y1, y2, h, out), dtype=torch.float32,
                              device=self.device)
            wx = torch.tensor(self._axis(x1, x2, w, out), dtype=torch.float32,
                              device=self.device)
            rows.append(torch.einsum("h,w,hwc->c", wy, wx, fmap))
        return torch.stack(rows)

    @staticmethod
    def sine_embed(pos, dim):
        dim_t = torch.arange(dim, dtype=torch.float32, device=pos.device)
        dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / dim)

        def one(c):
            f = c[:, None] * (2 * math.pi) / dim_t
            return torch.stack([f[:, 0::2].sin(), f[:, 1::2].cos()],
                               -1).reshape(c.shape[0], dim)

        return torch.cat([one(pos[:, 1]), one(pos[:, 0]), one(pos[:, 2]),
                          one(pos[:, 3])], -1)

    def regions(self, stages, vt_map, aux_boxes, vt_boxes, gh, gw):
        h0, w0 = stages[0].shape[:2]
        levels = [stages[0]] + [
            F.interpolate(s.permute(2, 0, 1)[None], size=(h0, w0),
                          mode="bilinear", align_corners=False)[0]
            .permute(1, 2, 0) for s in stages[1:]]
        aux_feat = torch.cat([self.roi_pool(m, aux_boxes, 0.25)
                              for m in levels], -1)
        ps = self.cfg["vision_config"]["patch_size"]
        vt_feat = self.roi_pool(vt_map, vt_boxes, 1.0 / ps)
        out = torch.cat([aux_feat, vt_feat], -1)
        b = torch.tensor(vt_boxes, dtype=torch.float32, device=self.device)
        img_w, img_h = gw * ps, gh * ps
        x1, y1, x2, y2 = b[:, 0] / img_w, b[:, 1] / img_h, b[:, 2] / img_w, \
            b[:, 3] / img_h
        pos = torch.stack([x1 + (x2 - x1) / 2, y1 + (y2 - y1) / 2, x2 - x1,
                           y2 - y1], -1)
        out = out + self.sine_embed(pos, out.shape[-1] // 4)
        return self.lin(F.gelu(self.lin(out, "mm_projector_aux.0")),
                        "mm_projector_aux.2")

    # ---------------------------------------------------------- trunk
    def trunk_logits(self, emb, positions, rows):
        c = self.cfg
        nh, nkv = c["num_attention_heads"], c["num_key_value_heads"]
        hd = c["hidden_size"] // nh
        eps = c["rms_norm_eps"]
        s = emb.shape[0]
        dev = self.device
        inv = 1.0 / (c["rope_theta"] ** (torch.arange(
            0, hd, 2, dtype=torch.float64, device=dev) / hd))
        pos = torch.as_tensor(positions, device=dev).double()
        freqs = pos[..., None] * inv                       # [3, S, hd/2]
        parts, start = [], 0
        for i, sec in enumerate(c["rope_scaling"]["mrope_section"]):
            parts.append(freqs[i % 3, :, start:start + sec])
            start += sec
        half = torch.cat(parts, -1)
        emb_r = torch.cat([half, half], -1)
        cos, sin = emb_r.cos().float()[:, None], emb_r.sin().float()[:, None]
        causal = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
        x = emb
        for i in range(c["num_hidden_layers"]):
            p = f"text.layers.{i}."
            h = rms(x, self.w[p + "input_layernorm.weight"], eps)
            q = rotate_half(self.lin(h, p + "self_attn.q_proj").reshape(
                s, nh, hd), cos, sin)
            k = rotate_half(self.lin(h, p + "self_attn.k_proj").reshape(
                s, nkv, hd), cos, sin)
            v = self.lin(h, p + "self_attn.v_proj").reshape(s, nkv, hd)
            rep = nh // nkv
            att = attend(q.transpose(0, 1),
                         k.transpose(0, 1).repeat_interleave(rep, 0),
                         v.transpose(0, 1).repeat_interleave(rep, 0), causal)
            x = x + self.lin(att, p + "self_attn.o_proj", bias=False)
            h = rms(x, self.w[p + "post_attention_layernorm.weight"], eps)
            x = x + self.lin(
                F.silu(self.lin(h, p + "mlp.gate_proj", bias=False))
                * self.lin(h, p + "mlp.up_proj", bias=False),
                p + "mlp.down_proj", bias=False)
        x = rms(x[rows], self.w["text.norm.weight"], eps)
        if self.precision == "fp8":
            x = fp8_rows(x)
        return x @ self.head.t()

    # ------------------------------------------------------- request
    @torch.no_grad()
    def served_logits(self, request: dict, served, aux_mode: str):
        """[n, V] float32 logits that predict each of the n served tokens:
        row j is the distribution after the prompt and served[:j]."""
        prep = prepare(self.cfg, request, aux_mode)
        gh, gw = prep["grid"]
        vision, vt_map = self.vit(torch.from_numpy(np.ascontiguousarray(
            prep["patches"])), gh, gw)
        vision = self.lin(F.gelu(self.lin(vision, "mm_projector.0")),
                          "mm_projector.2")
        stages = self.davit(self.aux_image(prep))
        ids = prep["ids"]
        served = np.asarray(served, np.int64)
        n, s = len(served), len(ids)
        all_ids = np.concatenate([ids, served])
        table = self.w["text.embed_tokens.weight"]
        emb = table[torch.as_tensor(np.clip(all_ids, 0, len(table) - 1),
                                    device=self.device)]
        emb[torch.as_tensor(np.nonzero(ids == IMAGE_PAD)[0],
                            device=self.device)] = vision
        reg_pos = np.nonzero(ids == REGION_SENTINEL)[0]
        if len(reg_pos):
            emb[torch.as_tensor(reg_pos, device=self.device)] = self.regions(
                stages, vt_map, prep["aux_boxes"], prep["vt_boxes"], gh, gw)
        last = int(prep["positions"][:, -1].max())
        positions = np.concatenate(
            [prep["positions"],
             np.broadcast_to(last + 1 + np.arange(n), (3, n))], 1)
        rows = torch.arange(s - 1, s - 1 + n, device=self.device)
        return self.trunk_logits(emb, positions, rows)


# ------------------------------------------------------- weight layout

def _linear(spec, name, n_in, n_out, bias=True):
    spec.append((name + ".weight", (n_out, n_in), "w"))
    if bias:
        spec.append((name + ".bias", (n_out,), "w"))


def _norm(spec, name, dim, bias):
    spec.append((name + ".weight", (dim,), "n"))
    if bias:
        spec.append((name + ".bias", (dim,), "w"))


def _conv(spec, name, n_in, n_out, k, groups=1):
    spec.append((name + ".weight", (n_out, n_in // groups, k, k), "w"))
    spec.append((name + ".bias", (n_out,), "w"))


def _mlp2x(spec, name, n_in, n_out):
    _linear(spec, name + ".0", n_in, n_out)
    _linear(spec, name + ".2", n_out, n_out)


def param_spec(cfg: dict) -> list[tuple[str, tuple, str]]:
    """[(name, shape, kind)] of the released layout (tied head, no HFRE
    parameters) under the checkpoint's tower names (`vision_tower.*`,
    `vision_tower_aux.*`, `text.*`, `mm_projector*.*`); kind "w" (drawn
    around 0) or "n" (a norm scale, drawn around 1)."""
    if cfg["mm_projector_type"] != "mlp2x_gelu" or \
            cfg["mm_projector_aux_type"] != "mlp2x_gelu":
        raise ValueError("only mlp2x_gelu projectors are laid out here")
    if not cfg["tie_word_embeddings"]:
        raise ValueError("only a tied head is laid out here")
    spec = []
    v = cfg["vision_config"]
    d, inter = v["hidden_size"], v["intermediate_size"]
    p = "vision_tower."
    spec.append((p + "patch_embed.proj.weight",
                 (d, v["in_chans"], v["temporal_patch_size"],
                  v["patch_size"], v["patch_size"]), "w"))
    for i in range(v["depth"]):
        b = f"{p}blocks.{i}."
        _norm(spec, b + "norm1", d, False)
        _norm(spec, b + "norm2", d, False)
        _linear(spec, b + "attn.qkv", d, 3 * d)
        _linear(spec, b + "attn.proj", d, d)
        _linear(spec, b + "mlp.gate_proj", d, inter)
        _linear(spec, b + "mlp.up_proj", d, inter)
        _linear(spec, b + "mlp.down_proj", inter, d)
    merged = d * v["spatial_merge_size"] ** 2
    _norm(spec, p + "merger.ln_q", d, False)
    _linear(spec, p + "merger.mlp.0", merged, merged)
    _linear(spec, p + "merger.mlp.2", merged, v["out_hidden_size"])

    dv = cfg["davit"]
    p = "vision_tower_aux."
    in_ch = dv["in_chans"]
    for i, c in enumerate(dv["embed_dims"]):
        _conv(spec, f"{p}convs.{i}.proj", in_ch, c, dv["patch_size"][i])
        _norm(spec, f"{p}convs.{i}.norm",
              in_ch if dv["patch_prenorm"][i] else c, True)
        hidden = int(c * dv["mlp_ratio"])
        for j in range(dv["depths"][i]):
            for blk, att in (("spatial_block", "window_attn"),
                             ("channel_block", "channel_attn")):
                b = f"{p}blocks.{i}.{j}.{blk}."
                _conv(spec, b + "conv1.fn.dw", c, c, 3, groups=c)
                _norm(spec, f"{b}{att}.norm", c, True)
                _linear(spec, f"{b}{att}.fn.qkv", c, 3 * c)
                _linear(spec, f"{b}{att}.fn.proj", c, c)
                _conv(spec, b + "conv2.fn.dw", c, c, 3, groups=c)
                _norm(spec, b + "ffn.norm", c, True)
                _linear(spec, b + "ffn.fn.net.fc1", c, hidden)
                _linear(spec, b + "ffn.fn.net.fc2", hidden, c)
        in_ch = c

    p = "text."
    d, inter = cfg["hidden_size"], cfg["intermediate_size"]
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // nh
    spec.append((p + "embed_tokens.weight", (cfg["vocab_size"], d), "w"))
    for i in range(cfg["num_hidden_layers"]):
        b = f"{p}layers.{i}."
        _norm(spec, b + "input_layernorm", d, False)
        _norm(spec, b + "post_attention_layernorm", d, False)
        _linear(spec, b + "self_attn.q_proj", d, nh * hd)
        _linear(spec, b + "self_attn.k_proj", d, nkv * hd)
        _linear(spec, b + "self_attn.v_proj", d, nkv * hd)
        _linear(spec, b + "self_attn.o_proj", nh * hd, d, bias=False)
        _linear(spec, b + "mlp.gate_proj", d, inter, bias=False)
        _linear(spec, b + "mlp.up_proj", d, inter, bias=False)
        _linear(spec, b + "mlp.down_proj", inter, d, bias=False)
    _norm(spec, p + "norm", d, False)

    _mlp2x(spec, "mm_projector", cfg["mm_hidden_size"], d)
    _mlp2x(spec, "mm_projector_aux", cfg["mm_region_hidden_size"], d)
    return spec
