"""Prefill and static-cache decode (counterpart of
`vlm_fo1_tpu/runtime/generate.py`).

PyTorch runs eagerly, so prompts are not padded to buckets: the prefill sees
exactly the prompt and the decode loop attends to cache slots up to the one
it writes, which equals the JAX masks on every real position. The loop stops
early once every row has emitted EOS or matched a stop sequence.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from vlm_fo1_tpu_torch.config import TextConfig
from vlm_fo1_tpu_torch.models.llm import (
    TextModel,
    init_kv_cache,
    mrope_cos_sin,
)
from vlm_fo1_tpu_torch.ops.flash_attention import flash_attention


@dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 512
    temperature: float = 0.0
    top_p: float = 1.0
    eos_token_id: int = 151645  # <|im_end|>
    pad_token_id: int = 151643
    # token-id n-grams that end a row, matched against the generated tail
    stop_sequences: tuple = ()


def prefill(text: TextModel, cfg: TextConfig, embeds, position_ids, cache_len,
            attention=flash_attention):
    """embeds [B, S, D] (the whole prompt), position_ids [3, B, S].
    Returns (kv_cache with slots [0, S) filled, last-token logits [B, V]
    fp32)."""
    b, s, _ = embeds.shape
    cache = init_kv_cache(cfg, b, cache_len, embeds.dtype, embeds.device)
    cos, sin = mrope_cos_sin(position_ids, cfg)
    hidden = text(embeds, cos, sin, cache, 0, attention)
    return cache, text.logits(hidden[:, -1:])[:, 0]


def _sample(logits, temperature, top_p, generator):
    """Greedy argmax (first index wins ties) for temperature 0, else
    temperature + top-p nucleus sampling from `generator`."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_p < 1.0:
        sorted_logits = logits.sort(dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cutoff = (probs.cumsum(dim=-1) - probs) > top_p
        kth = (~cutoff).sum(dim=-1, keepdim=True) - 1
        threshold = sorted_logits.gather(-1, kth)
        logits = logits.masked_fill(logits < threshold, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def decode_loop(text: TextModel, cfg: TextConfig, gen_cfg: GenerationConfig,
                kv_cache, first_logits, seq_len: int, rope_delta: int,
                generator=None):
    """Autoregressive decode after a prefill of `seq_len` tokens (all rows
    share it). Token `step` is written at cache slot seq_len + step - 1 with
    rope position seq_len + rope_delta + step - 1.

    Returns (tokens [B, max_new] int64 -- pad after a row finishes, number
    of steps taken)."""
    b = first_logits.shape[0]
    max_new = gen_cfg.max_new_tokens
    dev = first_logits.device
    stops = [torch.tensor(s, device=dev) for s in gen_cfg.stop_sequences
             if 0 < len(s) <= max_new]
    cur = _sample(first_logits, gen_cfg.temperature, gen_cfg.top_p, generator)
    tokens = torch.full((b, max_new), gen_cfg.pad_token_id, dtype=torch.long,
                        device=dev)
    tokens[:, 0] = cur
    done = cur == gen_cfg.eos_token_id
    for s in stops:
        if len(s) == 1:
            done |= cur == s[0]
    step = 1
    while step < max_new and not bool(done.all()):
        pos = torch.full((3, b, 1), seq_len + rope_delta + step - 1,
                         dtype=torch.long, device=dev)
        cos, sin = mrope_cos_sin(pos, cfg)
        hidden = text(text.embed(cur[:, None]), cos, sin, kv_cache,
                      seq_len + step - 1)
        nxt = _sample(text.logits(hidden)[:, 0], gen_cfg.temperature,
                      gen_cfg.top_p, generator)
        nxt = torch.where(done, gen_cfg.pad_token_id, nxt)
        tokens[:, step] = nxt
        done |= nxt == gen_cfg.eos_token_id
        for s in stops:
            n = len(s)
            if step + 1 >= n:
                done |= (tokens[:, step - n + 1:step + 1] == s).all(dim=1)
        cur = nxt
        step += 1
    return tokens, step


def decode_to_text(tokenizer, token_row, eos_token_id=151645,
                   stop_strings=("<|im_end|>",)):
    """Trim at EOS, decode, and cut at the first stop string."""
    toks = [int(t) for t in token_row]
    if eos_token_id in toks:
        toks = toks[:toks.index(eos_token_id)]
    text = tokenizer.decode(toks, skip_special_tokens=False)
    for s in stop_strings:
        if s in text:
            text = text.split(s)[0]
    return text.strip()
