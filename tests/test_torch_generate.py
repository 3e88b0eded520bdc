"""The port's `runtime/generate.py` and static-shape decode step vs the JAX
`runtime/generate.py` on `FO1Config.tiny()`'s trunk (untied head), f32 on
the CPU, weights bridged by `convert.text_state_dict`, inputs from a numpy
seed: ragged prefill logits to 1e-5; greedy tokens and step counts of
`decode_loop` (with prompt_pad, EOS and stop n-grams), `decode_chunk` (row
budgets, a 2-token stop), `prefill_into_slots` + `decode_chunk` and
`sample_first` exactly equal; `decode_step` logits to 1e-5.

Only real positions are compared: the port's prefill runs the flash
kernel's causal mask over the prompt's own keys where JAX masks `causal &
in_prompt` over the cache; the two agree on every real query, and the
padded rows' keys are masked out of every decode step.

The `cuda` tests run the same steps from CUDA graphs against eager on the
card (tokens and step counts bit-equal, greedy and top-p), the flash
kernel on the ragged batch's own prefill against its plain version, the
int4 kernels at M = 8 replayed from a graph against eager calls, and the
int4 launch counts of graph decode against the forwards the device ran."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread, port_config, to_numpy  # noqa: F401
from vlm_fo1_tpu.config import FO1Config
from vlm_fo1_tpu.models.llm import init_text_params
from vlm_fo1_tpu.preprocess.mrope import get_rope_index
from vlm_fo1_tpu.runtime import generate as jg
from vlm_fo1_tpu_torch.convert import text_state_dict
from vlm_fo1_tpu_torch.models.llm import TextModel
from vlm_fo1_tpu_torch.runtime import generate as tg

JCFG = dataclasses.replace(FO1Config.tiny().text, tie_word_embeddings=False)
CFG = port_config(JCFG)
B, SP = 3, 32
SEQ = np.array([27, 19, 32])           # ragged prompts, right-padded to SP
MAX_NEW = 10
ATOL = 1e-5


def _inputs():
    """Embeddings [B, SP, D] (zero past each prompt) and M-RoPE ids with one
    4x4-patch image span per prompt."""
    rng = np.random.default_rng(0)
    embeds = rng.standard_normal((B, SP, JCFG.hidden_size)).astype(np.float32)
    pos = np.zeros((3, B, SP), np.int64)
    deltas = np.zeros(B, np.int64)
    for i, s in enumerate(SEQ):
        embeds[i, s:] = 0.0
        ids = np.arange(100, 100 + s, dtype=np.int64)
        ids[3 + i:7 + i] = 151655
        p, d = get_rope_index(ids[None], [(1, 4, 4)])
        pos[:, i, :s] = p[:, 0]
        deltas[i] = d[0, 0]
    return embeds, pos, deltas


@pytest.fixture(scope="module")
def setup():
    params = init_text_params(jax.random.PRNGKey(4), JCFG)
    text = TextModel(CFG)
    text.load_state_dict(text_state_dict(to_numpy(params), CFG), strict=True)
    text.requires_grad_(False)
    embeds, pos, deltas = _inputs()
    return params, text, embeds, pos, deltas


def _jax_prefill(setup, rows=slice(None), cache_len=SP + MAX_NEW):
    params, _, embeds, pos, _ = setup
    return jg.prefill(params, JCFG, jnp.asarray(embeds[rows]),
                      jnp.asarray(pos[:, rows]), jnp.asarray(SEQ[rows]),
                      cache_len=cache_len)


def _port_prefill(setup, rows=slice(None), cache_len=SP + MAX_NEW):
    _, text, embeds, pos, _ = setup
    return tg.prefill(text, CFG, torch.from_numpy(embeds[rows]),
                      torch.from_numpy(pos[:, rows]),
                      torch.from_numpy(SEQ[rows]), cache_len)


def test_prefill_ragged_logits(setup):
    _, lj = _jax_prefill(setup)
    cache, lt = _port_prefill(setup)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    assert cache["k"].shape == (JCFG.num_hidden_layers, B, SP + MAX_NEW,
                                JCFG.num_key_value_heads, JCFG.head_dim)


def _greedy_stream(setup):
    cache, logits = _jax_prefill(setup)
    tokens, _, _ = jg.decode_loop(
        setup[0], JCFG, jg.GenerationConfig(max_new_tokens=MAX_NEW), cache,
        logits, jnp.asarray(SEQ), jnp.asarray(setup[4]),
        jax.random.PRNGKey(0), prompt_pad=SP)
    return np.asarray(tokens)


@pytest.mark.parametrize("stop", ["none", "eos", "ngram", "all_eos"])
def test_decode_loop_prompt_pad(setup, stop):
    """Greedy tokens and num_steps of the batch-synchronous loop with
    ragged prompts at prompt_pad: run to max_new, EOS ending one row early,
    a 2-token stop n-gram of row 1, and EOS ending every row early."""
    ref = _greedy_stream(setup)
    assert len(set(ref[0].tolist())) > 2   # a sequence worth comparing
    kw = {"none": {},
          "eos": {"eos_token_id": int(ref[0, 3])},
          "ngram": {"stop_sequences": (tuple(int(t) for t in ref[1, 2:4]),)},
          "all_eos": {"eos_token_id": int(ref[0, 2]),
                      "stop_sequences": ((int(ref[1, 1]),),
                                         tuple(int(t) for t in ref[2, 1:3]))},
          }[stop]
    gj = jg.GenerationConfig(max_new_tokens=MAX_NEW, pad_token_id=7, **kw)
    gt = tg.GenerationConfig(max_new_tokens=MAX_NEW, pad_token_id=7, **kw)
    cache, logits = _jax_prefill(setup)
    tj, sj, _ = jg.decode_loop(setup[0], JCFG, gj, cache, logits,
                               jnp.asarray(SEQ), jnp.asarray(setup[4]),
                               jax.random.PRNGKey(0), prompt_pad=SP)
    cache, logits = _port_prefill(setup)
    tt, st = tg.decode_loop(setup[1], CFG, gt, cache, logits,
                            torch.from_numpy(SEQ),
                            torch.from_numpy(setup[4]), prompt_pad=SP)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    assert st == int(sj)
    if stop == "all_eos":
        assert st < MAX_NEW


def test_decode_loop_one_prompt_no_pad(setup):
    """prompt_pad=None (every row writes at seq_lens[0] + step - 1), the
    single-request route, with one prompt."""
    gj = jg.GenerationConfig(max_new_tokens=MAX_NEW)
    gt = tg.GenerationConfig(max_new_tokens=MAX_NEW)
    cache, logits = _jax_prefill(setup, slice(0, 1))
    tj, sj, _ = jg.decode_loop(setup[0], JCFG, gj, cache, logits,
                               jnp.asarray(SEQ[:1]),
                               jnp.asarray(setup[4][:1]),
                               jax.random.PRNGKey(0))
    cache, logits = _port_prefill(setup, slice(0, 1))
    tt, st = tg.decode_loop(setup[1], CFG, gt, cache, logits,
                            torch.from_numpy(SEQ[:1]),
                            torch.from_numpy(setup[4][:1]))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    assert st == int(sj) == MAX_NEW


def _chunk_runs(setup, gen_kw, row_max, chunk, n_chunks, tlen):
    """sample_first + n_chunks decode_chunk calls on both sides; returns
    the per-chunk outputs of each as numpy."""
    params, text, _, _, deltas = setup
    gj = jg.GenerationConfig(max_new_tokens=MAX_NEW, pad_token_id=7,
                             **gen_kw)
    gt = tg.GenerationConfig(max_new_tokens=MAX_NEW, pad_token_id=7,
                             **gen_kw)
    outs = {"jax": [], "port": []}
    cache, logits = _jax_prefill(setup)
    cur, done = jg.sample_first(logits, gj, jax.random.PRNGKey(0))
    state = (cur, jnp.ones((B,), jnp.int32), done)
    tail = jnp.full((B, tlen), -1, jnp.int32)
    for _ in range(n_chunks):
        toks, cur, steps_r, done, tail, n, cache = jg.decode_chunk(
            params, JCFG, gj, cache, state[0], state[1], state[2],
            jnp.asarray(SEQ), jnp.asarray(deltas), jnp.asarray(row_max),
            tail, jax.random.PRNGKey(1), prompt_pad=SP, chunk=chunk)
        state = (cur, steps_r, done)
        outs["jax"].append([np.asarray(x) for x in
                            (toks, cur, steps_r, done, tail, n)])
    cache, logits = _port_prefill(setup)
    cur, done = tg.sample_first(logits, gt)
    steps_r = torch.ones(B, dtype=torch.long)
    tail = torch.full((B, tlen), -1, dtype=torch.long)
    for _ in range(n_chunks):
        toks, cur, steps_r, done, tail, n, cache = tg.decode_chunk(
            text, CFG, gt, cache, cur, steps_r, done, torch.from_numpy(SEQ),
            torch.from_numpy(deltas), torch.tensor(row_max), tail,
            prompt_pad=SP, chunk=chunk)
        outs["port"].append([x.numpy() for x in
                             (toks, cur, steps_r, done, tail, n)])
    return outs


def test_decode_chunk_row_max_and_stop(setup):
    """Three chunks of 4 with per-row budgets and a 2-token stop n-gram of
    row 0: tokens, cur, row_steps, done, tail and steps_taken equal after
    every chunk."""
    ref = _greedy_stream(setup)
    stop = (tuple(int(t) for t in ref[0, 3:5]),)
    outs = _chunk_runs(setup, {"stop_sequences": stop}, [9, 8, 7], 4, 3, 2)
    for c, (oj, ot) in enumerate(zip(outs["jax"], outs["port"])):
        for name, a, b in zip(("tokens", "cur", "row_steps", "done", "tail",
                               "steps"), ot, oj):
            np.testing.assert_array_equal(a, b, err_msg=f"chunk {c} {name}")
    last = outs["port"][-1]
    assert last[3].all() and last[2].tolist() == [5, 8, 7]


def test_prefill_into_slots_then_chunk(setup):
    """Decode rows 0-2 one chunk, refill slot 1 with prompt 0 through
    prefill_into_slots, then decode two more chunks: both sides' tokens and
    counters equal, and the refilled row equals prompt 0's own stream."""
    params, text, embeds, pos, deltas = setup
    gj = jg.GenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=-7)
    gt = tg.GenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=-7)
    row_max = np.full(B, MAX_NEW)
    seq, dl = SEQ.copy(), deltas.copy()
    seq[1], dl[1] = SEQ[0], deltas[0]
    slot = np.array([1])
    # JAX
    cache, logits = _jax_prefill(setup)
    cur, done = jg.sample_first(logits, gj, jax.random.PRNGKey(0))
    st = (cur, jnp.ones((B,), jnp.int32), done, jnp.full((B, 1), -1))
    *st, _, cache = jg.decode_chunk(
        params, JCFG, gj, cache, *st[:3], jnp.asarray(SEQ),
        jnp.asarray(deltas), jnp.asarray(row_max), st[3],
        jax.random.PRNGKey(1), prompt_pad=SP, chunk=3)
    toks_j, cur, rs, done, tail = st
    cache, lg = jg.prefill_into_slots(
        params, JCFG, jnp.asarray(embeds[:1]), jnp.asarray(pos[:, :1]),
        jnp.asarray(SEQ[:1]), cache, jnp.asarray(slot))
    t0, d0 = jg.sample_first(lg, gj, jax.random.PRNGKey(2))
    cur, rs, done = cur.at[slot].set(t0), rs.at[slot].set(1), \
        done.at[slot].set(d0)
    jax_out = [np.asarray(t0)]
    for _ in range(2):
        toks, cur, rs, done, tail, n, cache = jg.decode_chunk(
            params, JCFG, gj, cache, cur, rs, done, jnp.asarray(seq),
            jnp.asarray(dl), jnp.asarray(row_max), tail,
            jax.random.PRNGKey(3), prompt_pad=SP, chunk=4)
        jax_out += [np.asarray(toks), np.asarray(rs), int(n)]
    # port
    cache, logits = _port_prefill(setup)
    cur, done = tg.sample_first(logits, gt)
    rs = torch.ones(B, dtype=torch.long)
    tail = torch.full((B, 1), -1, dtype=torch.long)
    toks_t, cur, rs, done, tail, _, cache = tg.decode_chunk(
        text, CFG, gt, cache, cur, rs, done, torch.from_numpy(SEQ),
        torch.from_numpy(deltas), torch.from_numpy(row_max), tail,
        prompt_pad=SP, chunk=3)
    np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))
    slot_t = torch.from_numpy(slot)
    cache, lg = tg.prefill_into_slots(
        text, CFG, torch.from_numpy(embeds[:1]), torch.from_numpy(pos[:, :1]),
        torch.from_numpy(SEQ[:1]), cache, slot_t)
    t0, d0 = tg.sample_first(lg, gt)
    cur[slot_t], rs[slot_t], done[slot_t] = t0, 1, d0
    port_out = [t0.numpy()]
    for _ in range(2):
        toks, cur, rs, done, tail, n, cache = tg.decode_chunk(
            text, CFG, gt, cache, cur, rs, done, torch.from_numpy(seq),
            torch.from_numpy(dl), torch.from_numpy(row_max), tail,
            prompt_pad=SP, chunk=4)
        port_out += [toks.numpy(), rs.numpy(), int(n)]
    for a, b in zip(port_out, jax_out):
        np.testing.assert_array_equal(a, b)
    refilled = np.concatenate([port_out[0], port_out[1][1], port_out[4][1]])
    np.testing.assert_array_equal(refilled, _greedy_stream(setup)[0, :9])


def test_sample_first_and_decode_step(setup):
    """sample_first's tokens and done flags (EOS and a 1-token stop) and
    one decode_step's logits after a prefill."""
    params, text, _, _, deltas = setup
    _, lj = _jax_prefill(setup)
    _, lt = _port_prefill(setup)
    first = np.asarray(jnp.argmax(lj, -1))
    kw = {"eos_token_id": int(first[0]),
          "stop_sequences": ((int(first[2]),),)}
    tj, dj = jg.sample_first(lj, jg.GenerationConfig(**kw),
                             jax.random.PRNGKey(0))
    tt, dt = tg.sample_first(lt, tg.GenerationConfig(**kw))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert dt.tolist() == [True, first[1] in (first[0], first[2]), True]
    # one step of the unpadded prompt (row 2, SEQ = SP) at slot SP: a
    # ragged row would attend its padded slots, which the two sides fill
    # differently (see the module docstring)
    row = slice(2, 3)
    cache_j, _ = _jax_prefill(setup, row)
    cache_t, _ = _port_prefill(setup, row)
    cur = first[row].copy()
    rope = SEQ[row] + deltas[row]
    gj, _ = jg.decode_step(params, JCFG, cache_j, jnp.asarray(cur),
                           jnp.asarray(rope), jnp.asarray(SP))
    gt = tg.decode_step(text, CFG, cache_t, torch.from_numpy(cur),
                        torch.from_numpy(rope), SP)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=ATOL)


def test_top_p_decode_seeded_and_in_nucleus(setup):
    """Top-p decode on its own terms: one seed gives the same tokens twice
    (through a reused program the second time), another seed other
    tokens; each first token lies inside the nucleus of its logits."""
    _, text, _, _, deltas = setup
    g = tg.GenerationConfig(max_new_tokens=MAX_NEW, temperature=1.0,
                            top_p=0.8, eos_token_id=-7)
    runs = []
    for seed in (3, 3, 4):
        cache, logits = _port_prefill(setup)
        gen = torch.Generator().manual_seed(seed)
        runs.append(tg.decode_loop(text, CFG, g, cache, logits,
                                   torch.from_numpy(SEQ),
                                   torch.from_numpy(deltas), gen,
                                   prompt_pad=SP)[0].numpy())
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    probs = torch.softmax(logits, -1).numpy()
    for row in range(B):
        order = np.argsort(-probs[row])
        p = probs[row, order]
        assert runs[0][row, 0] in order[(np.cumsum(p) - p) <= 0.8]


def test_steps_run_counts_every_step_of_every_run(setup):
    """`DecodeProgram.steps_run` grows by a program's `steps` for each run,
    the steps after the loop's end included: what a request's forwards on
    the device are besides its prefill."""
    gt = tg.GenerationConfig(max_new_tokens=MAX_NEW,
                             eos_token_id=int(_greedy_stream(setup)[0, 4]))
    cache, logits = _port_prefill(setup, slice(0, 1))
    before = tg.DecodeProgram.steps_run
    _, steps = tg.decode_loop(setup[1], CFG, gt, cache, logits,
                              torch.from_numpy(SEQ[:1]),
                              torch.from_numpy(setup[4][:1]))
    per_run = min(tg.LOOP_CHUNK, MAX_NEW - 1)
    runs = max(1, -(-(steps - 1) // per_run))
    assert steps == 5
    assert tg.DecodeProgram.steps_run - before == runs * per_run


def test_quantizing_drops_the_decode_programs(setup):
    """A captured program reads the weights and int4 functions it was
    captured over: each quant function that swaps them (the int4
    functions, the int4 linears, the w8a8 marker) empties the text model's
    program cache."""
    from vlm_fo1_tpu_torch import quant as tq

    text = TextModel(CFG)
    text.load_state_dict(setup[1].state_dict())
    text.requires_grad_(False)
    holder = torch.nn.Module()
    holder.text = text
    gt = tg.GenerationConfig(max_new_tokens=MAX_NEW)

    def decode():
        cache, logits = tg.prefill(
            text, CFG, torch.from_numpy(setup[2][:1]),
            torch.from_numpy(setup[3][:, :1]), torch.from_numpy(SEQ[:1]),
            SP + MAX_NEW)
        return tg.decode_loop(text, CFG, gt, cache, logits,
                              torch.from_numpy(SEQ[:1]),
                              torch.from_numpy(setup[4][:1]))[0]

    for swap in (lambda: tq.use_int4_kernels(holder, False),
                 lambda: tq.quantize_params_int4(holder),
                 lambda: tq.mark_w8a8(holder)):
        decode()
        assert tg._programs(text).pool_bytes() > 0
        swap()
        assert tg._programs(text).pool_bytes() == 0


# ------------------------------------------------------------ on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", ["greedy", "top_p"])
@pytest.mark.parametrize("prompt_pad", [None, SP])
def test_graph_decode_equals_eager_on_card(setup, sampling, prompt_pad,
                                           monkeypatch):
    """decode_loop from CUDA graphs vs the same steps eagerly on the card:
    tokens and num_steps bit-equal (greedy with an early EOS, and top-p
    from one seed)."""
    _card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    _, text, embeds, pos, deltas = setup
    text = TextModel(CFG).to("cuda")
    text.load_state_dict(setup[1].state_dict())
    text.requires_grad_(False)
    rows = slice(0, 1) if prompt_pad is None else slice(None)
    ref = _greedy_stream(setup)
    kw = ({"eos_token_id": int(ref[0, 4])} if sampling == "greedy" else
          {"temperature": 0.9, "top_p": 0.8, "eos_token_id": -7})
    g = tg.GenerationConfig(max_new_tokens=MAX_NEW, **kw)
    outs = []
    for graphs in (True, False, True):
        cache, logits = tg.prefill(
            text, CFG, torch.from_numpy(embeds[rows]).cuda(),
            torch.from_numpy(pos[:, rows]).cuda(),
            torch.from_numpy(SEQ[rows]).cuda(), SP + MAX_NEW)
        gen = torch.Generator(device="cuda").manual_seed(5)
        toks, steps = tg.decode_loop(
            text, CFG, g, cache, logits, torch.from_numpy(SEQ[rows]).cuda(),
            torch.from_numpy(deltas[rows]).cuda(), gen,
            prompt_pad=prompt_pad, cuda_graphs=graphs)
        outs.append((toks.cpu().numpy(), steps))
    for toks, steps in outs[1:]:
        np.testing.assert_array_equal(toks, outs[0][0])
        assert steps == outs[0][1]


@pytest.mark.cuda
def test_graph_decode_chunk_equals_eager_on_card(setup, monkeypatch):
    """decode_chunk with budgets and a stop n-gram from a graph vs eager on
    the card: every output bit-equal, two chunks each."""
    _card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    _, _, embeds, pos, deltas = setup
    text = TextModel(CFG).to("cuda")
    text.load_state_dict(setup[1].state_dict())
    text.requires_grad_(False)
    ref = _greedy_stream(setup)
    g = tg.GenerationConfig(max_new_tokens=MAX_NEW, stop_sequences=(
        tuple(int(t) for t in ref[0, 3:5]),))
    outs = []
    for graphs in (True, False):
        cache, logits = tg.prefill(
            text, CFG, torch.from_numpy(embeds).cuda(),
            torch.from_numpy(pos).cuda(), torch.from_numpy(SEQ).cuda(),
            SP + MAX_NEW)
        cur, done = tg.sample_first(logits, g)
        rs = torch.ones(B, dtype=torch.long, device="cuda")
        tail = torch.full((B, 2), -1, dtype=torch.long, device="cuda")
        run = []
        for _ in range(2):
            toks, cur, rs, done, tail, n, cache = tg.decode_chunk(
                text, CFG, g, cache, cur, rs, done,
                torch.from_numpy(SEQ).cuda(), torch.from_numpy(deltas).cuda(),
                torch.tensor([3, 9, 7], device="cuda"), tail, prompt_pad=SP,
                chunk=4, cuda_graphs=graphs)
            run.append([x.cpu().numpy() for x in (toks, cur, rs, done, tail,
                                                  n)])
        outs.append(run)
    for a, b in zip(outs[0], outs[1]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_flash_on_a_right_padded_prefill_batch_on_card(setup, dtype, tol,
                                                       monkeypatch):
    """The flash kernel on the trunk's own layer-0 q/k/v of the ragged
    batch (B = 3, right-padded to SP, causal) against its plain version:
    worst row relative L2 within tol."""
    _card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    from vlm_fo1_tpu_torch.ops import flash_attention as fa

    _, _, embeds, pos, _ = setup
    text = TextModel(CFG).to(device="cuda", dtype=dtype)
    text.load_state_dict(setup[1].state_dict())
    text.requires_grad_(False)
    seen = []

    def record(q, k, v, **kw):
        seen.append((q, k, v, kw))
        return fa.flash_attention(q, k, v, **kw)

    tg.prefill(text, CFG, torch.from_numpy(embeds).to("cuda", dtype),
               torch.from_numpy(pos).cuda(), torch.from_numpy(SEQ).cuda(),
               SP + MAX_NEW, attention=record)
    q, k, v, kw = seen[0]
    assert q.shape[0] == B and kw["causal"]
    got = fa.flash_attention(q, k, v, **kw).float()
    ref = fa.flash_attention_reference(q.float(), k.float(), v.float(), **kw)
    rel = ((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max().item()
    assert rel <= tol, rel


@pytest.mark.cuda
def test_int4_decode_rows_replayed_from_a_graph_on_card():
    """The int4 matmul and fused SwiGLU at M = 8 (a B = 8 decode step) in a
    CUDA graph: replays bit-equal to eager calls, on the streaming route."""
    _card()
    from vlm_fo1_tpu_torch.ops import int4_matmul as i4, int4_mlp as i4mlp
    from vlm_fo1_tpu_torch.quant import (
        quantize_weight_int4,
        quantize_weight_int4_outpack,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)

    def w(*shape):
        return torch.randn(*shape, device="cuda", generator=gen) * 0.02

    x = torch.randn(8, 256, device="cuda", generator=gen).to(torch.bfloat16)
    packed, scale = quantize_weight_int4(w(384, 256))
    node = {}
    for name, mat in (("gate", w(512, 256)), ("up", w(512, 256))):
        node[f"{name}_pk"], node[f"{name}_s"] = quantize_weight_int4(mat)
    node["down_pk"], node["down_s"] = quantize_weight_int4_outpack(
        w(256, 512))
    for fn, call in ((i4.int4_matmul, lambda: i4.int4_matmul(x, packed,
                                                              scale)),
                     (i4mlp.int4_mlp, lambda: i4mlp.int4_mlp(x, node))):
        eager = call()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        routes = dict(fn.routes)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = call()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, eager)
        assert {r for r in routes if fn.routes[r] != routes[r]} == {"gemv"}


@pytest.mark.cuda
def test_capture_counts_only_the_kernels_that_run_on_card(setup,
                                                         monkeypatch):
    """An int4 trunk decoded from CUDA graphs and eagerly: the int4 matmul
    launches are the trunk's int4 linears once per forward the device ran
    (the prefill, the capture's eager warm-up and every replay's steps),
    with nothing counted for the capture itself."""
    _card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    from vlm_fo1_tpu_torch import quant as tq
    from vlm_fo1_tpu_torch.nn import QLinear4
    from vlm_fo1_tpu_torch.ops.int4_matmul import int4_matmul

    _, _, embeds, pos, deltas = setup
    holder = torch.nn.Module()
    holder.text = TextModel(CFG).to("cuda")
    holder.text.load_state_dict(setup[1].state_dict())
    holder.text.requires_grad_(False)
    tq.quantize_params_int4(holder)
    text = holder.text
    per_forward = sum(isinstance(m, QLinear4) for m in text.modules())
    assert per_forward > 0
    g = tg.GenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=-7)
    for graphs in (True, True, False):
        cache, logits = tg.prefill(
            text, CFG, torch.from_numpy(embeds).cuda(),
            torch.from_numpy(pos).cuda(), torch.from_numpy(SEQ).cuda(),
            SP + MAX_NEW)
        int4_matmul.launches = 0
        steps0 = tg.DecodeProgram.steps_run
        tg.decode_loop(text, CFG, g, cache, logits,
                       torch.from_numpy(SEQ).cuda(),
                       torch.from_numpy(deltas).cuda(), prompt_pad=SP,
                       cuda_graphs=graphs)
        torch.cuda.synchronize()
        assert int4_matmul.launches == per_forward * (
            tg.DecodeProgram.steps_run - steps0)
