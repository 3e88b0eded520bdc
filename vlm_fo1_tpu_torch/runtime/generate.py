"""Bucketed prefill and static-shape decode (counterpart of
`vlm_fo1_tpu/runtime/generate.py`).

Prompts are right-padded to a shared bucket (`pad_to_bucket`) and the
last-token logits are gathered per row at `seq_lens - 1`. Decode runs over a
static KV cache of C slots with an explicit mask, as the JAX programs do:

  decode_loop   the batch-synchronous loop: token `step` is written at
                slot prompt_pad + step - 1 (seq_lens[0] + step - 1 with no
                prompt_pad), rows attend to their prompt and to the
                generated slots; stops when every row is done or at
                max_new_tokens;
  decode_chunk  up to `chunk` steps of continuous batching: every per-row
                quantity (step count, write slot, rope position, budget
                `row_max`, the tail of stop n-grams) is a vector;
  sample_first, prefill_into_slots, decode_step: the session pieces.

`prefill_sequence_parallel` fills the same cache from a prompt cut into
chunks over a ring of ranks (ring attention).

A run of steps is a `DecodeProgram`: static buffers (cache, tokens, current
token, counters, done flags) and `steps` masked steps over them, captured as
one CUDA graph on the card (`runtime/graphs.py`) and replayed; the host
reads one flag per replay. The JAX `while_loop` stops exactly when every
row is done; a graph always runs its `steps` steps, so each step first
computes on the device whether the loop would still be running, and a step
after that changes no counter, token or flag: its only write is a cache
slot that no later step reads before writing it. `num_steps` is counted on
the device and equals JAX's. On the CPU the same steps run eagerly; on the
card `cuda_graphs=False` runs them eagerly too (for comparisons).

Sampling cannot match JAX draw for draw (JAX draws from `jax.random` keys).
Here a temperature above 0 draws, per run of steps, one Exp(1) noise tensor
[steps, B, V] from the caller's `torch.Generator`, outside the graph, and
each step samples the categorical distribution by the exponential race
argmax(p / noise) over the top-p nucleus: the same tokens eager and from
the graph for one seed.
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
from vlm_fo1_tpu_torch.runtime.graphs import CapturedSteps, ProgramCache

# steps captured in one graph of the batch-synchronous loop: the host reads
# the finished flag once per this many steps, and at most this many - 1
# steps run after the loop has ended
LOOP_CHUNK = 8


@dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 512
    temperature: float = 0.0
    top_p: float = 1.0
    eos_token_id: int = 151645  # <|im_end|>
    pad_token_id: int = 151643
    # token-id n-grams that end a row, matched against the generated tail
    stop_sequences: tuple = ()


def pad_to_bucket(n: int, multiple: int = 128) -> int:
    return max(multiple, -(-n // multiple) * multiple)


@torch.no_grad()
def prefill(text: TextModel, cfg: TextConfig, embeds, position_ids, seq_lens,
            cache_len, attention=flash_attention, cache=None):
    """embeds [B, Sp, D] right-padded prompts, position_ids [3, B, Sp],
    seq_lens [B] (a device tensor). Fills slots [0, Sp) of a zeroed cache of
    `cache_len` slots (`cache`, or a new one) through the flash kernel.
    Returns (kv_cache, last-token logits [B, V] fp32)."""
    b, sp, d = embeds.shape
    if cache is None:
        cache = init_kv_cache(cfg, b, cache_len, embeds.dtype, embeds.device,
                              text.kv_heads)
    else:
        cache["k"].zero_()
        cache["v"].zero_()
    cos, sin = mrope_cos_sin(position_ids, cfg)
    hidden = text(embeds, cos, sin, cache, 0, attention)
    last = hidden.gather(1, (seq_lens.long() - 1).view(b, 1, 1).expand(b, 1, d))
    return cache, text.logits(last)[:, 0]


@torch.no_grad()
def prefill_sequence_parallel(text: TextModel, cfg: TextConfig, embeds,
                              position_ids, seq_lens, cache_len, group=None):
    """Sequence-parallel prefill (the JAX `prefill_sequence_parallel`): the
    padded prompt embeds [B, Sp, D] is cut into one chunk per rank of
    `group` (a process group, None for the default one, or a
    `parallel.ring_attention.LocalRing` that holds every chunk in this
    process), the trunk runs `TextModel.forward_ring` with ring attention,
    and the K/V chunks are all-gathered into a cache of `cache_len` slots
    laid out as `prefill`'s. Every rank passes the same arguments and gets
    the same (kv_cache, last-token logits [B, V] fp32), so the decode loop
    and its graphs continue from it unchanged. Sp must divide by the ring's
    size. The trunk's weights are whole on every rank of the ring."""
    from vlm_fo1_tpu_torch.parallel.ring_attention import as_ring

    ring = as_ring(group)
    b, sp, d = embeds.shape
    n = ring.size
    if sp % n:
        raise ValueError(f"padded prompt length {sp} does not split into "
                         f"{n} chunks")
    sl = sp // n
    cos, sin = mrope_cos_sin(position_ids, cfg)
    pos = torch.arange(sp, device=embeds.device).expand(b, sp)
    valid = pos < seq_lens.view(b, 1)

    def chunks(x):  # [B, Sp, ...] -> this process's chunks stacked on B
        return torch.cat([x[:, c * sl:(c + 1) * sl] for c in ring.chunks])

    hidden, ks, vs = text.forward_ring(
        chunks(embeds), chunks(cos), chunks(sin), chunks(pos), chunks(pos),
        chunks(valid), ring)
    cache = init_kv_cache(cfg, b, cache_len, embeds.dtype, embeds.device,
                          text.kv_heads)
    cache["k"][:, :, :sp] = ring.gather(ks, 1).to(cache["k"].dtype)
    cache["v"][:, :, :sp] = ring.gather(vs, 1).to(cache["v"].dtype)
    hidden = ring.gather(hidden, 0)
    last = hidden.gather(1, (seq_lens.long() - 1).view(b, 1, 1).expand(b, 1, d))
    return cache, text.logits(last)[:, 0]


def sampling_noise(generator, shape, device):
    """Exp(1) draws for the exponential race, kept above zero so a masked
    (zero) probability never wins."""
    noise = torch.empty(shape, dtype=torch.float32, device=device)
    noise.exponential_(generator=generator)
    return noise.clamp_min_(torch.finfo(torch.float32).tiny)


def _sample(logits, temperature, top_p, generator=None, noise=None):
    """Greedy argmax (first index wins ties) for temperature 0; else the
    top-p nucleus of logits / temperature, sampled by argmax(p / noise)
    with `noise` (or fresh noise from `generator`)."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    if noise is None:
        noise = sampling_noise(generator, logits.shape, logits.device)
    logits = logits / temperature
    if top_p < 1.0:
        sorted_logits = logits.sort(dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cutoff = (probs.cumsum(dim=-1) - probs) > top_p
        kth = (~cutoff).sum(dim=-1, keepdim=True) - 1
        threshold = sorted_logits.gather(-1, kth)
        logits = logits.masked_fill(logits < threshold, float("-inf"))
    return (torch.softmax(logits, dim=-1) / noise).argmax(dim=-1)


def _first_done(tok0, gen_cfg):
    done = tok0 == gen_cfg.eos_token_id
    for seq in gen_cfg.stop_sequences:
        if len(seq) == 1:  # the loop's windows start at step 1
            done = done | (tok0 == seq[0])
    return done


@torch.no_grad()
def sample_first(first_logits, gen_cfg: GenerationConfig, generator=None):
    """Each row's first generated token from the prefill logits and its
    done flag: (tok0 [B] long, done0 [B] bool)."""
    tok0 = _sample(first_logits, gen_cfg.temperature, gen_cfg.top_p,
                   generator)
    return tok0, _first_done(tok0, gen_cfg)


def _step_logits(text, cfg, cache, cur, rope_pos, write_at, mask):
    """One masked decode step: cur [B] at rope positions [B], written at
    slot `write_at` ([] or [B]), attending where mask [B, C] -> logits
    [B, V] fp32."""
    b = cur.shape[0]
    cos, sin = mrope_cos_sin(rope_pos.view(1, b, 1).expand(3, b, 1), cfg)
    hidden = text(text.embed(cur[:, None]), cos, sin, cache, write_at,
                  mask=mask[:, None, None])
    return text.logits(hidden)[:, 0]


@torch.no_grad()
def decode_step(text: TextModel, cfg: TextConfig, kv_cache, cur, rope_pos,
                write_at):
    """One cached decode step for host-driven streaming: cur [B] at rope
    positions [B], written at slot `write_at` (an int), attending to slots
    [0, write_at]. Returns logits [B, V] fp32; the cache is written in
    place."""
    c = kv_cache["k"].shape[2]
    k_pos = torch.arange(c, device=cur.device)
    mask = (k_pos <= write_at).expand(cur.shape[0], c)
    return _step_logits(text, cfg, kv_cache, cur, rope_pos, write_at, mask)


def _programs(text: TextModel) -> ProgramCache:
    """The text model's program cache."""
    cache = getattr(text, "_decode_programs", None)
    if cache is None:
        cache = text._decode_programs = ProgramCache()
    return cache


def drop_programs(text: TextModel):
    """Forget every kept program of the text model. A captured graph reads
    the weights at the addresses it was captured with and calls the int4
    functions it was captured with: whatever swaps a weight or an int4
    module's function (`quant.py`) calls this."""
    _programs(text).clear()


class DecodeProgram:
    """Static decode state of B rows over a C-slot cache and `steps` masked
    steps over it: a chunk of `decode_loop` (mode "loop") or one
    `decode_chunk` call (mode "chunk"). Captured as a CUDA graph on the card
    unless use_graph is False.

    `DecodeProgram.steps_run` counts the masked steps that every program
    ran on the device: `steps` for each run, and `steps` for a capture's
    eager warm-up. Steps after a loop's end count too (they launch their
    kernels), so a request's forwards are its prefill plus this count."""

    steps_run = 0

    def __init__(self, text, cfg, gen_cfg, *, mode, batch, cache_len,
                 prompt_pad, steps, tail_len, dtype, device, use_graph):
        self.text, self.cfg, self.gen_cfg = text, cfg, gen_cfg
        self.mode, self.prompt_pad, self.steps = mode, prompt_pad, steps
        # normal tensors even under a caller's inference mode, so callers
        # outside it may read and update the state in place
        with torch.inference_mode(False), torch.no_grad():
            self._build(text, cfg, gen_cfg, mode, batch, cache_len, steps,
                        tail_len, dtype, device, use_graph)

    def _build(self, text, cfg, gen_cfg, mode, batch, cache_len, steps,
               tail_len, dtype, device, use_graph):
        b, dev = batch, device
        max_new = gen_cfg.max_new_tokens

        def longs(*shape, fill=0):
            return torch.full(shape, fill, dtype=torch.long, device=dev)

        self.cache = init_kv_cache(cfg, b, cache_len, dtype, dev,
                                   text.kv_heads)
        self.k_pos = torch.arange(cache_len, device=dev)
        self.cur = longs(b, fill=gen_cfg.pad_token_id)
        self.done = torch.ones(b, dtype=torch.bool, device=dev)
        self.seq_lens = longs(b, fill=1)
        self.rope_deltas = longs(b)
        self.finished = torch.ones((), dtype=torch.bool, device=dev)
        self.noise = None
        if gen_cfg.temperature != 0.0:
            self.noise = torch.ones(steps, b, text.cfg.vocab_size,
                                    dtype=torch.float32, device=dev)
        if mode == "loop":
            # column max_new is scratch for steps after the loop's end
            self.tokens = longs(b, max_new + 1, fill=gen_cfg.pad_token_id)
            self.step = longs(fill=max_new)
            self.stops = [(len(s), torch.tensor(s, device=dev))
                          for s in gen_cfg.stop_sequences
                          if 0 < len(s) <= max_new]
            self._step = self._loop_step
        else:
            self.tokens = longs(b, steps, fill=gen_cfg.pad_token_id)
            self.row_steps = longs(b, fill=1)
            self.row_max = longs(b, fill=1)
            self.lstep = longs()
            self.tail = longs(b, tail_len, fill=-1)
            self.stops = [(len(s), torch.tensor(s, device=dev))
                          for s in gen_cfg.stop_sequences
                          if 0 < len(s) <= tail_len]
            self._step = self._chunk_step
        self.captured = CapturedSteps(self._run_steps, dev, use_graph)
        if self.captured.graph is not None:
            DecodeProgram.steps_run += steps

    def nbytes(self) -> int:
        tensors = [self.cache["k"], self.cache["v"], self.tokens]
        if self.noise is not None:
            tensors.append(self.noise)
        return (sum(t.numel() * t.element_size() for t in tensors)
                + self.captured.pool_bytes)

    def _run_steps(self):
        if self.mode == "chunk":
            self.tokens.fill_(self.gen_cfg.pad_token_id)
            self.lstep.zero_()
        for i in range(self.steps):
            self._step(i)

    def _loop_step(self, i):
        g = self.gen_cfg
        max_new = g.max_new_tokens
        step = self.step
        active = (step < max_new) & ~self.done.all()
        if self.prompt_pad is None:
            write_at = self.seq_lens[0] + step - 1
            mask = (self.k_pos <= write_at).expand(self.cur.shape[0], -1)
        else:
            write_at = self.prompt_pad + step - 1
            mask = ((self.k_pos[None] < self.seq_lens[:, None])
                    | ((self.k_pos >= self.prompt_pad)
                       & (self.k_pos <= write_at))[None])
        logits = _step_logits(self.text, self.cfg, self.cache, self.cur,
                              self.seq_lens + self.rope_deltas + step - 1,
                              write_at, mask)
        nxt = _sample(logits, g.temperature, g.top_p,
                      noise=None if self.noise is None else self.noise[i])
        nxt = torch.where(self.done, g.pad_token_id, nxt)
        self.tokens.index_copy_(1, step.clamp(max=max_new).view(1),
                                nxt[:, None])
        done = self.done | (nxt == g.eos_token_id)
        for n, seq in self.stops:
            # the last n generated ids ending at `step`; windows that start
            # before column 0 are clamped and never match (step + 1 < n)
            cols = (step - n + 1 + torch.arange(n, device=step.device))
            win = self.tokens.index_select(1, cols.clamp(min=0))
            done = done | ((win == seq).all(dim=1) & (step + 1 >= n))
        self.done.copy_(torch.where(active, done, self.done))
        self.cur.copy_(torch.where(active, nxt, self.cur))
        step.add_(active.long())
        self.finished.copy_((step >= max_new) | self.done.all())

    def _chunk_step(self, i):
        g = self.gen_cfg
        active = ~self.done.all()
        pp = self.prompt_pad
        write_at = pp + self.row_steps - 1
        k_pos = self.k_pos[None]
        mask = ((k_pos < self.seq_lens[:, None])
                | ((k_pos >= pp) & (k_pos <= write_at[:, None])))
        logits = _step_logits(
            self.text, self.cfg, self.cache, self.cur,
            self.seq_lens + self.rope_deltas + self.row_steps - 1, write_at,
            mask)
        nxt = _sample(logits, g.temperature, g.top_p,
                      noise=None if self.noise is None else self.noise[i])
        nxt = torch.where(self.done, g.pad_token_id, nxt)
        # a step after every row is done writes pad over pad here
        self.tokens[:, i] = nxt
        new_steps = self.row_steps + (~self.done).long()
        tail = torch.cat([self.tail[:, 1:], nxt[:, None]], dim=1)
        done = (self.done | (nxt == g.eos_token_id)
                | (new_steps >= self.row_max))
        tlen = self.tail.shape[1]
        for n, seq in self.stops:
            hit = (tail[:, tlen - n:] == seq).all(dim=1)
            done = done | (hit & (new_steps >= n))
        self.row_steps.copy_(new_steps)
        self.tail.copy_(torch.where(active, tail, self.tail))
        self.cur.copy_(torch.where(active, nxt, self.cur))
        self.done.copy_(done)
        self.lstep.add_(active.long())
        self.finished.copy_(self.done.all())

    @torch.no_grad()
    def run(self, generator=None):
        """One run of `steps` steps (a graph replay on the card)."""
        if self.noise is not None:
            self.noise.exponential_(generator=generator)
            self.noise.clamp_min_(torch.finfo(torch.float32).tiny)
        self.captured.run()
        DecodeProgram.steps_run += self.steps


@torch.no_grad()
def acquire_program(text: TextModel, cfg: TextConfig, gen_cfg, *, mode,
                    batch, cache_len, prompt_pad, steps, tail_len=1,
                    dtype=None, device=None, cuda_graphs=True):
    """A free `DecodeProgram` of this shape from the text model's program
    cache, or a new one (captured now on the card). Return it with
    `release_program` once its results are read."""
    dtype = dtype or text.norm.weight.dtype
    device = torch.device(device or text.norm.weight.device)
    use_graph = bool(cuda_graphs) and device.type == "cuda"
    key = (mode, batch, cache_len, prompt_pad, steps, tail_len, gen_cfg,
           dtype, device, use_graph)

    def build():
        return DecodeProgram(text, cfg, gen_cfg, mode=mode, batch=batch,
                             cache_len=cache_len, prompt_pad=prompt_pad,
                             steps=steps, tail_len=tail_len, dtype=dtype,
                             device=device, use_graph=use_graph)

    prog = _programs(text).acquire(key, build)
    prog.key = key
    return prog


def release_program(text: TextModel, prog: DecodeProgram):
    _programs(text).release(prog.key, prog)


def loop_program(text, cfg, gen_cfg, batch, cache_len, prompt_pad=None,
                 cuda_graphs=True, dtype=None, device=None):
    """A loop-mode program; prefill straight into its `cache`."""
    steps = max(1, min(LOOP_CHUNK, gen_cfg.max_new_tokens - 1))
    return acquire_program(text, cfg, gen_cfg, mode="loop", batch=batch,
                           cache_len=cache_len, prompt_pad=prompt_pad,
                           steps=steps, dtype=dtype, device=device,
                           cuda_graphs=cuda_graphs)


def _copy_cache(dst, src):
    if dst["k"] is not src["k"]:
        dst["k"].copy_(src["k"])
        dst["v"].copy_(src["v"])


class DecodeRun:
    """A batch-synchronous decode in flight: `start_decode_loop` sampled the
    first token and ran the first graph without a host synchronisation;
    `finish` runs the rest, one host read per run, and returns
    (tokens [B, max_new] long, num_steps)."""

    def __init__(self, text, prog, generator):
        self.text, self.prog, self.generator = text, prog, generator
        self.result = None

    @torch.no_grad()
    def finish(self):
        if self.result is not None:
            return self.result
        prog = self.prog
        try:
            while not bool(prog.finished):
                prog.run(self.generator)
            max_new = prog.gen_cfg.max_new_tokens
            self.result = (prog.tokens[:, :max_new].clone(),
                           int(prog.step))
        except BaseException:
            self.prog = None   # a program that failed is not reused
            raise
        release_program(self.text, prog)
        self.prog = None
        return self.result


@torch.no_grad()
def start_decode_loop(text: TextModel, cfg: TextConfig,
                      gen_cfg: GenerationConfig, kv_cache, first_logits,
                      seq_lens, rope_deltas, generator=None, prompt_pad=None,
                      cuda_graphs=True, program=None) -> DecodeRun:
    """Sample the first token and start the loop (see `decode_loop`) with
    no host synchronisation. `program` is a `loop_program` whose cache the
    prefill filled; without one, a program is acquired and `kv_cache` is
    copied into it."""
    b, c = first_logits.shape[0], kv_cache["k"].shape[2]
    prog = program or loop_program(text, cfg, gen_cfg, b, c, prompt_pad,
                                   cuda_graphs, kv_cache["k"].dtype,
                                   first_logits.device)
    _copy_cache(prog.cache, kv_cache)
    tok0, done0 = sample_first(first_logits, gen_cfg, generator)
    prog.tokens.fill_(gen_cfg.pad_token_id)
    prog.tokens[:, 0] = tok0
    prog.cur.copy_(tok0)
    prog.done.copy_(done0)
    prog.seq_lens.copy_(seq_lens)
    prog.rope_deltas.copy_(rope_deltas)
    prog.step.fill_(1)
    prog.run(generator)
    return DecodeRun(text, prog, generator)


def decode_loop(text: TextModel, cfg: TextConfig, gen_cfg: GenerationConfig,
                kv_cache, first_logits, seq_lens, rope_deltas,
                generator=None, prompt_pad=None, cuda_graphs=True):
    """Autoregressive decode after `prefill`, with an early exit when every
    row is done (EOS or a stop n-gram). seq_lens / rope_deltas [B] device
    tensors. Generated tokens occupy slots [prompt_pad, prompt_pad +
    max_new); rows shorter than prompt_pad mask out the gap. With no
    prompt_pad every row writes at seq_lens[0] + step - 1 (one prompt).

    Returns (tokens [B, max_new] long, pad after a row's end; num_steps,
    the step at which the loop stopped, counting the first token)."""
    return start_decode_loop(text, cfg, gen_cfg, kv_cache, first_logits,
                             seq_lens, rope_deltas, generator, prompt_pad,
                             cuda_graphs).finish()


def load_chunk_state(prog: DecodeProgram, cur, row_steps, done, seq_lens,
                     rope_deltas, row_max, tail):
    for dst, src in ((prog.cur, cur), (prog.row_steps, row_steps),
                     (prog.done, done), (prog.seq_lens, seq_lens),
                     (prog.rope_deltas, rope_deltas),
                     (prog.row_max, row_max), (prog.tail, tail)):
        if dst is not src:
            dst.copy_(src)


@torch.no_grad()
def decode_chunk(text: TextModel, cfg: TextConfig, gen_cfg: GenerationConfig,
                 kv_cache, cur, row_steps, done, seq_lens, rope_deltas,
                 row_max, tail, generator=None, *, prompt_pad: int,
                 chunk: int, cuda_graphs=True, program=None):
    """Up to `chunk` decode steps over live slot state (continuous
    batching): cur [B] last token, row_steps [B] tokens generated so far,
    done [B], seq_lens / rope_deltas [B], row_max [B] budgets, tail [B, T]
    the last T generated ids. Rows that are done emit pad and keep their
    counters; the chunk ends early once every row is done.

    `program` is a chunk-mode program that holds the state (a session's):
    the state arguments are then its own tensors, nothing is copied and
    the program stays checked out. Without one, a program is acquired, the
    cache and state are copied into it and the cache back out.

    Returns (tokens [B, chunk], cur, row_steps, done, tail, steps_taken
    (a device scalar), kv_cache); the cache is updated in place."""
    b, c = cur.shape[0], kv_cache["k"].shape[2]
    prog = program or acquire_program(
        text, cfg, gen_cfg, mode="chunk", batch=b, cache_len=c,
        prompt_pad=prompt_pad, steps=chunk, tail_len=tail.shape[1],
        dtype=kv_cache["k"].dtype, device=cur.device,
        cuda_graphs=cuda_graphs)
    _copy_cache(prog.cache, kv_cache)
    load_chunk_state(prog, cur, row_steps, done, seq_lens, rope_deltas,
                     row_max, tail)
    prog.run(generator)
    out = (prog.tokens.clone(), prog.cur.clone(), prog.row_steps.clone(),
           prog.done.clone(), prog.tail.clone(), prog.lstep.clone())
    if program is None:
        _copy_cache(kv_cache, prog.cache)
        release_program(text, prog)
    return (*out, kv_cache)


@torch.no_grad()
def prefill_into_slots(text: TextModel, cfg: TextConfig, embeds,
                       position_ids, seq_lens_g, kv_cache, slots,
                       attention=flash_attention):
    """Prefill G new requests (embeds [G, Sp, D]) and write their K/V into
    batch rows `slots` [G] of a live cache, slots [0, Sp). Generated-token
    K/V of the rows' earlier requests stays past Sp; the decode mask never
    reads it before it is written again. Returns (kv_cache, first_logits
    [G, V])."""
    sp = embeds.shape[1]
    cache_g, logits = prefill(text, cfg, embeds, position_ids, seq_lens_g,
                              sp, attention)
    for name in ("k", "v"):
        kv_cache[name][:, :, :sp].index_copy_(
            1, slots, cache_g[name].to(kv_cache[name].dtype))
    return kv_cache, logits


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
