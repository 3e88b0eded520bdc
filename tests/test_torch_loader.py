"""The released-checkpoint entry points: the port's `api.load_pretrained_model`
(`FO1Model.from_pretrained` -> `checkpoint.load_fo1_checkpoint`) vs the JAX
package's `FO1Model.from_pretrained` (`checkpoint.load_fo1_checkpoint`) on
one fabricated checkpoint directory: a tiny port state dict under the
release's names (`model.vision_tower.image_tower.*`, `model.*`,
`lm_head.*`, ...) in two safetensors shards, with a `config.json` the test
writes. Both load it, f32 on the CPU, and the reference-shaped
`generate(**prepare_inputs(...))` gives equal greedy ids, full precision
and with load_4bit.

The release's config.json has no DaViT section (its aux tower is always
DaViT-large, `FO1Config.from_hf_config` keeps the default, and derives the
HFRE widths from those towers), so both packages' `from_hf_config` are
wrapped to swap in the tiny DaViT and HFRE configs after parsing the file;
everything else comes from the file."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import vlm_fo1_tpu.config as jax_config
import vlm_fo1_tpu_torch.config as port_config_mod
from conftest import StubTokenizer
from torch_parity import one_torch_thread, port_config  # noqa: F401
from vlm_fo1_tpu import api as jax_api
from vlm_fo1_tpu.models.fo1 import FO1Model as JaxFO1Model
from vlm_fo1_tpu.quant import quantize_params_int4
from vlm_fo1_tpu_torch import api
from vlm_fo1_tpu_torch.checkpoint import (
    load_safetensors_dir,
    port_state_dict,
)
from vlm_fo1_tpu_torch.models.fo1 import FO1Model
from vlm_fo1_tpu_torch.training.checkpointing import save_params_safetensors

TINY = jax_config.FO1Config.tiny()
JCFG = dataclasses.replace(TINY, text=dataclasses.replace(
    TINY.text, tie_word_embeddings=False))
CFG = port_config(JCFG)
# port prefix -> release prefix
RELEASE = (("vision_tower_aux.", "model.vision_tower_aux.image_tower."),
           ("vision_tower.", "model.vision_tower.image_tower."),
           ("mm_projector_aux.", "model.mm_projector_aux."),
           ("mm_projector.", "model.mm_projector."),
           ("text.lm_head.", "lm_head."),
           ("text.", "model."))


def _release_name(name):
    for port, release in RELEASE:
        if name.startswith(port):
            return release + name[len(port):]
    raise KeyError(name)


def _config_json(cfg):
    v, t = cfg.vision, cfg.text
    return {
        "vision_config": {k: (list(x) if isinstance(x, tuple) else x)
                          for k, x in dataclasses.asdict(v).items()},
        "vocab_size": t.vocab_size, "hidden_size": t.hidden_size,
        "intermediate_size": t.intermediate_size,
        "num_hidden_layers": t.num_hidden_layers,
        "num_attention_heads": t.num_attention_heads,
        "num_key_value_heads": t.num_key_value_heads,
        "rms_norm_eps": t.rms_norm_eps, "rope_theta": t.rope_theta,
        "max_position_embeddings": t.max_position_embeddings,
        "tie_word_embeddings": t.tie_word_embeddings,
        "hidden_act": t.hidden_act, "head_dim": t.head_dim,
        "rope_scaling": {"type": "mrope",
                         "mrope_section": list(t.mrope_section)},
        "mm_projector_type": cfg.mm_projector_type,
        "mm_projector_aux_type": cfg.mm_projector_aux_type,
        "mm_hidden_size": cfg.mm_hidden_size,
        "mm_region_hidden_size": cfg.mm_region_hidden_size,
        "aux_image_size": cfg.aux_image_size,
    }


def _with_tiny_davit(parse, tiny):
    def wrapped(cfg):
        return dataclasses.replace(parse(cfg), davit=tiny.davit,
                                   hfre=tiny.hfre)
    return staticmethod(wrapped)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """Two shards of the release's names and a config.json."""
    d = tmp_path_factory.mktemp("fo1_ckpt")
    sd = FO1Model.random_init(CFG, seed=11, device="cpu").state_dict()
    flat = {_release_name(k): v for k, v in sd.items()}
    keys = sorted(flat)
    half = len(keys) // 2
    save_params_safetensors(str(d / "model-00001-of-00002.safetensors"),
                            {k: flat[k] for k in keys[:half]})
    save_params_safetensors(str(d / "model-00002-of-00002.safetensors"),
                            {k: flat[k] for k in keys[half:]})
    (d / "config.json").write_text(json.dumps(_config_json(JCFG)))
    return str(d), sd


@pytest.fixture
def tiny_davit(monkeypatch):
    for mod in (jax_config, port_config_mod):
        monkeypatch.setattr(mod.FO1Config, "from_hf_config",
                            _with_tiny_davit(mod.FO1Config.from_hf_config,
                                             mod.FO1Config.tiny()))


def _messages():
    rng = np.random.default_rng(3)
    img = Image.fromarray(rng.integers(0, 255, (80, 96, 3), np.uint8))
    return [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": img}},
        {"type": "text", "text": "detect things"}],
        "bbox_list": [[2.0, 2.0, 50.0, 60.0], [10.0, 5.0, 70.0, 40.0]]}]


def test_shards_round_trip(ckpt_dir):
    """The port's reader gives back every tensor of the state dict, byte
    for byte, under the port's names."""
    path, sd = ckpt_dir
    back = port_state_dict(load_safetensors_dir(path))
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], v) for k, v in sd.items())


@pytest.mark.parametrize("load_4bit", [False, True], ids=["f32", "int4"])
def test_load_pretrained_model_matches_jax(ckpt_dir, tiny_davit, load_4bit):
    path, _ = ckpt_dir
    tok = StubTokenizer()
    _, model, procs = api.load_pretrained_model(
        path, load_4bit=load_4bit, device="cpu", dtype=torch.float32)
    assert model.config == CFG and len(procs) == 2
    jm = JaxFO1Model.from_pretrained(path, dtype=jnp.float32, tokenizer=tok)
    assert jm.cfg == JCFG
    if load_4bit:
        jm.params = quantize_params_int4(jm.params)
    jmodel = jax_api.GenerateFacade(jm)
    msgs = _messages()
    kw = dict(max_tokens=8)
    got = model.generate(**api.prepare_inputs(path, model, procs, tok, msgs,
                                              **kw))
    want = jmodel.generate(**jax_api.prepare_inputs(path, jmodel, None, tok,
                                                    msgs, **kw))
    np.testing.assert_array_equal(got, want)
    n_prompt = len(api.prepare_inputs(path, model, procs, tok, msgs)
                   ["input_tokens"])
    assert got.shape[1] > n_prompt + 3   # a few generated ids to compare
    assert len(set(got[0, n_prompt:].tolist())) > 2


def test_loader_refuses_incomplete_or_stray_keys(ckpt_dir, tmp_path):
    path, sd = ckpt_dir
    flat = load_safetensors_dir(path)
    model = FO1Model(CFG, device="cpu")
    missing = dict(flat)
    missing.pop("lm_head.weight")
    with pytest.raises(RuntimeError, match="lm_head"):
        model.load_state_dict(port_state_dict(missing), strict=True)
    with pytest.raises(KeyError, match="stray"):
        port_state_dict({**flat, "stray.weight": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        load_safetensors_dir(str(tmp_path))
