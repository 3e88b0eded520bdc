"""Reference-shaped entry points (counterpart of `vlm_fo1_tpu/api.py`):
the surface a VLM-FO1 user knows (reference `model/builder.py`
`load_pretrained_model`, `mm_utils.py` `prepare_inputs`), over the port.

    from vlm_fo1_tpu_torch.api import load_pretrained_model, prepare_inputs
    tokenizer, model, image_processors = load_pretrained_model(path)
    kwargs = prepare_inputs(path, model, image_processors, tokenizer, messages)
    output_ids = model.generate(**kwargs)

`model.generate` takes the prepared kwargs and returns a numpy array of
[1, prompt + generated] ids, as HF generate does.
"""

from __future__ import annotations

import numpy as np
import torch

from vlm_fo1_tpu_torch.models.fo1 import FO1Model
from vlm_fo1_tpu_torch.quant import apply_load_flags


class _ProcessorShim:
    """Processor objects for API parity; the work is in
    `vlm_fo1_tpu_torch.preprocess`."""

    def __init__(self, kind: str, model: FO1Model):
        self.kind = kind
        self.model = model

    def preprocess(self, image, **kw):
        from vlm_fo1_tpu_torch import preprocess as pp

        cfg = self.model.cfg
        if self.kind == "primary":
            pv, grid = pp.qwen_image_preprocess(
                image, patch_size=cfg.vision.patch_size,
                merge_size=cfg.vision.spatial_merge_size,
                min_pixels=cfg.min_pixels, max_pixels=cfg.max_pixels)
            return {"pixel_values": pv, "image_grid_thw": np.asarray([grid])}
        arr = pp.aux_image_preprocess(image, cfg.aux_image_size)
        return {"pixel_values": arr[None]}


class GenerateFacade:
    """FO1Model behind an HF-generate-shaped call."""

    def __init__(self, model: FO1Model):
        self._model = model
        self.config = model.cfg

    def __getattr__(self, name):
        return getattr(self._model, name)

    def generate(self, messages=None, max_new_tokens=512, temperature=0.0,
                 top_p=1.0, do_sample=False, input_tokens=None, **kw):
        if not do_sample:
            temperature = 0.0
        result = self._model.generate(
            messages, max_new_tokens=max_new_tokens,
            temperature=temperature, top_p=top_p)
        prompt = np.asarray(input_tokens if input_tokens is not None else [],
                            np.int64)
        out = np.concatenate([prompt, result.token_ids,
                              [self._model.cfg.eos_token_id]])
        return out[None]


def load_pretrained_model(model_path: str, load_8bit: bool = False,
                          load_4bit: bool = False, device="cuda",
                          w8a8: bool = False, dtype=torch.bfloat16):
    """Returns (tokenizer, model, (primary_processor, aux_processor)) for a
    released checkpoint directory, on the card unless `device` says
    otherwise. load_8bit / load_4bit quantize the trunk (int8 weights /
    packed int4, `quant.apply_load_flags`); w8a8 (with load_8bit) also
    quantizes activations per row at prefill."""
    if w8a8 and (load_4bit or not load_8bit):
        raise ValueError(
            "w8a8=True requires load_8bit=True (activation quant rides the "
            f"int8 weight path); got load_8bit={load_8bit} "
            f"load_4bit={load_4bit}")
    model = FO1Model.from_pretrained(model_path, dtype=dtype, device=device)
    apply_load_flags(model, load_8bit=load_8bit, load_4bit=load_4bit,
                     w8a8=w8a8)
    processors = (_ProcessorShim("primary", model),
                  _ProcessorShim("aux", model))
    return model.tokenizer, GenerateFacade(model), processors


def prepare_inputs(model_name, model, image_processors, tokenizer, messages,
                   device=None, max_tokens=512, top_p=1.0, temperature=0.0,
                   do_sample=False):
    """Reference-shaped kwargs (mm_utils.py `prepare_inputs`): the device
    work happens inside `model.generate`; this returns the calling
    convention's plumbing, the prompt ids under 'inputs'."""
    from vlm_fo1_tpu_torch.preprocess.tokens import build_chat_tokens

    real = model._model if isinstance(model, GenerateFacade) else model
    if real.tokenizer is None:
        real.tokenizer = tokenizer
    _, tokens, _, _ = build_chat_tokens(tokenizer, messages)
    return {
        "messages": messages,
        "input_tokens": tokens,
        "inputs": np.asarray([tokens]),
        "max_new_tokens": max_tokens,
        "temperature": temperature,
        "top_p": top_p,
        "do_sample": do_sample and temperature > 0.0,
    }
