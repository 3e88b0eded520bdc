"""The released VLM-FO1 checkpoint -> the port's `FO1Model` (counterpart of
`load_safetensors_dir`, `strip_prefix` and `load_fo1_checkpoint` in
`vlm_fo1_tpu/checkpoint.py`).

The release stores everything in sharded safetensors. The port's towers
carry the checkpoint's own state-dict names, so loading is a prefix map:

  model.vision_tower.image_tower.*      -> vision_tower.*
  model.vision_tower_aux.image_tower.*  -> vision_tower_aux.*
  model.mm_projector.* / model.mm_projector_aux.* -> mm_projector(_aux).*
  model.object_vp_extractor.*           -> object_vp_extractor.* (the
                                           HFRE's region LayerNorms; none
                                           in the released configuration)
  model.* (embed_tokens, layers, norm)  -> text.*
  lm_head.*                             -> text.lm_head.*

then one `load_state_dict(strict=True)`. A region LayerNorm is applied only
when the checkpoint holds it, as in the JAX loader (`fit_region_norms`). Shards are read by the port's own
safetensors reader (`training.checkpointing.load_params_safetensors`): the
`safetensors` package is not needed.
"""

from __future__ import annotations

import os

import torch

from vlm_fo1_tpu_torch.training.checkpointing import load_params_safetensors

# checkpoint prefix -> the port's submodule, most specific first
_TOWERS = (
    ("model.vision_tower_aux.image_tower.", "vision_tower_aux."),
    ("model.vision_tower.image_tower.", "vision_tower."),
    ("model.mm_projector_aux.", "mm_projector_aux."),
    ("model.mm_projector.", "mm_projector."),
    ("model.object_vp_extractor.", "object_vp_extractor."),
    ("lm_head.", "text.lm_head."),
    ("model.", "text."),
)


def load_safetensors_dir(model_path: str) -> dict:
    """Every `*.safetensors` shard of a checkpoint directory, in name order,
    merged into one {name: CPU tensor} dict."""
    files = sorted(f for f in os.listdir(model_path)
                   if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors shards in {model_path}")
    state = {}
    for fname in files:
        state.update(load_params_safetensors(os.path.join(model_path, fname)))
    return state


def strip_prefix(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def port_state_dict(sd: dict) -> dict:
    """Checkpoint names -> the port's names (see the module docstring)."""
    out = {}
    for name, t in sd.items():
        for prefix, target in _TOWERS:
            if name.startswith(prefix):
                out[target + name[len(prefix):]] = t
                break
        else:
            raise KeyError(f"checkpoint key {name!r} belongs to no tower")
    return out


def fit_region_norms(model, sd: dict) -> dict:
    """The JAX HFRE applies a region LayerNorm only when the checkpoint
    holds it (`"aux_region_norm" in params`) and the config asks for it:
    a norm of the model that `sd` lacks is removed from the model, and a
    norm in `sd` that the model's config does not apply is dropped from
    `sd`. Returns the state dict to load."""
    hfre = model.object_vp_extractor
    for name in ("aux_region_norm", "vt_region_norm"):
        prefix = f"object_vp_extractor.{name}."
        present = any(k.startswith(prefix) for k in sd)
        if getattr(hfre, name, None) is None:
            sd = {k: v for k, v in sd.items() if not k.startswith(prefix)}
        elif not present:
            setattr(hfre, name, None)
    return sd


def load_fo1_checkpoint(model_path: str, model) -> "torch.nn.Module":
    """Load a released checkpoint directory into `model` (an `FO1Model`
    built from the same config.json): every parameter must be present and
    no key may be left over, but for the region LayerNorms
    (`fit_region_norms`). Floating tensors are cast to the model's dtype
    by the copy. Returns the model."""
    sd = port_state_dict(load_safetensors_dir(model_path))
    model.load_state_dict(fit_region_norms(model, sd), strict=True)
    return model
