"""PyTorch trunk vs JAX `prefill` / `decode_loop` on the tiny text config,
f32 on the CPU, weights bridged by `convert.text_state_dict`: prefill logits
to 1e-4 and greedy decode tokens exactly, with EOS and n-gram stops. Both
the tied head (the released configuration) and an untied one run: with
random weights a tied head echoes the last token, so only the untied head
gives a varied greedy sequence."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (  # noqa: F401
    one_torch_thread,
    port_config,
    rand,
    to_numpy,
)
from vlm_fo1_tpu.config import FO1Config
from vlm_fo1_tpu.models.llm import init_text_params, mrope_cos_sin as jax_mrope
from vlm_fo1_tpu.preprocess.mrope import get_rope_index
from vlm_fo1_tpu.runtime.generate import (
    GenerationConfig as JaxGenerationConfig,
    decode_loop as jax_decode_loop,
    prefill as jax_prefill,
)
from vlm_fo1_tpu_torch.convert import text_state_dict
from vlm_fo1_tpu_torch.models.llm import TextModel, mrope_cos_sin
from vlm_fo1_tpu_torch.runtime.generate import (
    GenerationConfig,
    decode_loop,
    prefill,
)

ATOL = 1e-4  # f32 logits through 2 layers, different summation order
CFGS = {"tied": FO1Config.tiny().text,
        "untied": dataclasses.replace(FO1Config.tiny().text,
                                      tie_word_embeddings=False)}
MAX_NEW = 8
S, SP = 27, 32  # prompt length; the JAX side pads it to a bucket of SP


def _positions():
    """M-RoPE ids of a prompt with one 4x4-patch image span (4 units)."""
    ids = np.arange(100, 100 + S, dtype=np.int64)
    ids[5:9] = 151655
    pos, deltas = get_rope_index(ids[None], [(1, 4, 4)])
    return pos, int(deltas[0, 0])


@pytest.fixture(scope="module", params=sorted(CFGS))
def run(request):
    cfg = CFGS[request.param]
    pcfg = port_config(cfg)
    params = init_text_params(jax.random.PRNGKey(1), cfg)
    text = TextModel(pcfg)
    text.load_state_dict(text_state_dict(to_numpy(params), pcfg),
                         strict=True)
    rng = np.random.default_rng(0)
    embeds = rand(rng, 1, SP, cfg.hidden_size)
    pos, delta = _positions()
    pos_pad = np.zeros((3, 1, SP), np.int32)
    pos_pad[:, :, :S] = pos

    def jax_run(gen_cfg):
        cache, logits = jax_prefill(params, cfg, jnp.asarray(embeds),
                                    jnp.asarray(pos_pad), jnp.asarray([S]),
                                    cache_len=SP + MAX_NEW)
        tokens, steps, _ = jax_decode_loop(
            params, cfg, gen_cfg, cache, logits, jnp.asarray([S]),
            jnp.asarray([delta]), jax.random.PRNGKey(0))
        return np.asarray(logits), np.asarray(tokens), int(steps)

    def torch_run(gen_cfg):
        with torch.no_grad():
            cache, logits = prefill(text, pcfg,
                                    torch.from_numpy(embeds[:, :S]),
                                    torch.from_numpy(pos).long(),
                                    torch.tensor([S]), S + MAX_NEW)
            tokens, steps = decode_loop(text, pcfg, gen_cfg, cache, logits,
                                        torch.tensor([S]),
                                        torch.tensor([delta]))
        return logits.numpy(), tokens.numpy(), steps

    return jax_run, torch_run, cfg.tie_word_embeddings


def test_mrope_tables_match():
    pos, _ = _positions()
    cos_j, sin_j = jax_mrope(jnp.asarray(pos), CFGS["tied"])
    cos_t, sin_t = mrope_cos_sin(torch.from_numpy(pos).long(),
                                 port_config(CFGS["tied"]))
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=1e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=1e-6)


def test_prefill_logits_and_greedy_tokens(run):
    jax_run, torch_run, tied = run
    lj, tj, sj = jax_run(JaxGenerationConfig(max_new_tokens=MAX_NEW))
    lt, tt, st = torch_run(GenerationConfig(max_new_tokens=MAX_NEW))
    np.testing.assert_allclose(lt, lj, atol=ATOL)
    assert st == sj == MAX_NEW
    np.testing.assert_array_equal(tt, tj)
    if not tied:
        assert len(set(tj[0].tolist())) > 2  # a sequence worth comparing


@pytest.mark.parametrize("stop", ["eos", "ngram"])
def test_early_stop_matches(run, stop):
    """EOS set to the third greedy token, or a stop n-gram of tokens 2..3:
    both loops stop at the same step with the same padded tail."""
    jax_run, torch_run, _ = run
    _, ref, _ = jax_run(JaxGenerationConfig(max_new_tokens=MAX_NEW))
    kw = ({"eos_token_id": int(ref[0, 2])} if stop == "eos"
          else {"stop_sequences": (tuple(int(t) for t in ref[0, 1:3]),)})
    jcfg = dataclasses.replace(JaxGenerationConfig(max_new_tokens=MAX_NEW),
                               pad_token_id=7, **kw)
    tcfg = GenerationConfig(max_new_tokens=MAX_NEW, pad_token_id=7, **kw)
    _, tj, sj = jax_run(jcfg)
    _, tt, st = torch_run(tcfg)
    assert st == sj < MAX_NEW
    np.testing.assert_array_equal(tt, tj)


def test_top_p_sampling_stays_in_the_nucleus():
    from vlm_fo1_tpu_torch.runtime.generate import _sample

    logits = torch.from_numpy(rand(np.random.default_rng(2), 4, 64) * 3)
    gen = torch.Generator().manual_seed(0)
    greedy = logits.argmax(-1)
    torch.testing.assert_close(_sample(logits, 1.0, 1e-6, gen), greedy)
    probs = torch.softmax(logits, -1).numpy()
    order = np.argsort(-probs, axis=-1)
    for _ in range(20):
        tok = _sample(logits, 1.0, 0.5, gen).numpy()
        for row in range(4):
            p = probs[row, order[row]]
            keep = order[row][(np.cumsum(p) - p) <= 0.5]
            assert tok[row] in keep
    a = _sample(logits, 0.7, 0.9, torch.Generator().manual_seed(3))
    b = _sample(logits, 0.7, 0.9, torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b)
