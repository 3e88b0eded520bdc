"""The port's serving quantization (`vlm_fo1_tpu_torch.quant`, the quantized
modules of `nn.py` and the int8 / int4 heads of `models/llm.py`) vs the JAX
package's `quant.py`, `nn.linear`, `nn.embedding` and `lm_head_logits`, f32
on the CPU with inputs made from numpy seeds:

- the quantizers are byte-identical (int8 per channel, int8 per row, int4
  contraction halves, int4 output halves) and so are the nibble unpacks;
- int8 weight-only and w8a8 linears to 1e-5, including an odd width
  (K = 3420, the ViT MLP's), a single-row call and outlier channels;
- the row-int8 token table and the int8 / int4 heads to 1e-5;
- in each of the five modes the port's quantized tiny FO1 has exactly the
  state-dict keys of the bridged quantized JAX tree (the same quantized
  leaves) with equal bytes, and generates the same greedy tokens with
  prefill logits within 1e-4 (untied head; I = 128 for int4-mlp, whose
  kernel the default tiny's I = 96 does not fit: that falls back to int8).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import StubTokenizer
from torch_parity import one_torch_thread, port_config, to_numpy  # noqa: F401
from vlm_fo1_tpu import nn as jnn
from vlm_fo1_tpu import quant as jq
from vlm_fo1_tpu.config import FO1Config
from vlm_fo1_tpu.models import llm as jllm
from vlm_fo1_tpu.models.fo1 import FO1Model as JaxFO1Model, _splice_embeds
from vlm_fo1_tpu.runtime.generate import pad_to_bucket, prefill as jax_prefill
from vlm_fo1_tpu.runtime.profiler import StageTimer
from vlm_fo1_tpu.task_templates import OD_template
from vlm_fo1_tpu_torch import nn as tnn
from vlm_fo1_tpu_torch import quant as tq
from vlm_fo1_tpu_torch.convert import (
    state_dict_from_jax_params,
    text_state_dict,
)
from vlm_fo1_tpu_torch.models.fo1 import FO1Model
from vlm_fo1_tpu_torch.models.llm import Int4MLP, TextModel

ATOL = 1e-5
LOGIT_ATOL = 1e-4
MAX_PIXELS = 128 * 128
JAX_MODES = {
    "int8": lambda p: jq.quantize_params(p),
    "int8-all": lambda p: jq.quantize_params(p, jq.ALL_QUANT_PATTERNS),
    "w8a8": lambda p: jq.mark_w8a8(jq.quantize_params(p)),
    "int4": jq.quantize_params_int4,
    "int4-mlp": jq.quantize_params_int4_mlp,
}


def _copy(tree):
    """A fresh tree of dicts: the JAX quantizers pop leaves in place."""
    return jax.tree.map(lambda x: x, tree)


# ------------------------------------------------------------ quantizers

@pytest.mark.parametrize("kind", ["int8", "rows", "int4", "int4_out"])
def test_quantizers_are_byte_identical(kind):
    rng = np.random.default_rng(11)
    w = rng.standard_normal((96, 64)).astype(np.float32) * 0.05  # [in, out]
    w[:, 3] = 0.0  # an all-zero column takes the 1e-8 scale floor
    if kind == "int8":
        qj, sj = jq._quantize_weight(jnp.asarray(w))
        qt, st = tq.quantize_int8(torch.from_numpy(w.T.copy()))
        qt = qt.t()
    elif kind == "rows":
        qj, sj = jq._quantize_rows(jnp.asarray(w))
        qt, st = tq.quantize_int8(torch.from_numpy(w))
    elif kind == "int4":
        qj, sj = jq._quantize_weight_int4(jnp.asarray(w))
        qt, st = tq.quantize_weight_int4(torch.from_numpy(w.T.copy()))
    else:
        qj, sj = jq._quantize_weight_int4_outpack(jnp.asarray(w))
        qt, st = tq.quantize_weight_int4_outpack(
            torch.from_numpy(w.T.copy()))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_unpack_matches_jax_on_every_byte():
    packed = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    lo_j, hi_j = jq.unpack_int4_halves(jnp.asarray(packed))
    lo_t, hi_t = tq.unpack_int4_halves(torch.from_numpy(packed))
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))
    np.testing.assert_array_equal(tq.unpack_int4(torch.from_numpy(packed)),
                                  np.asarray(jq.unpack_int4(packed)))


# ----------------------------------------------------------- int8 linears

def _linear_case(seed, k, n, x_shape, outliers=False, bias=True):
    rng = np.random.default_rng(seed)
    p = {"w": jnp.asarray(rng.standard_normal((k, n)).astype(np.float32)
                          * 0.05)}
    if bias:
        p["b"] = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    x = rng.standard_normal(x_shape).astype(np.float32)
    if outliers:
        x[..., [3, 17]] *= 1e4
    return p, x


def _port_linear(p, w8a8):
    q = jq.quantize_linear(dict(p))
    bias = torch.nn.Parameter(torch.from_numpy(np.array(p["b"])),
                              requires_grad=False) if "b" in p else None
    mod = tnn.QLinear8(torch.from_numpy(np.asarray(q["w_q"]).T.copy()),
                       torch.from_numpy(np.array(q["scale"])), bias)
    if w8a8:
        q = jq.mark_w8a8(q)
        tq.mark_w8a8(mod)
    return q, mod


@pytest.mark.parametrize("w8a8", [False, True], ids=["int8", "w8a8"])
@pytest.mark.parametrize("case", [
    ("rows", 64, 40, (9, 64), False),
    ("batched", 64, 24, (2, 5, 64), False),
    ("vit_mlp_k3420", 3420, 24, (7, 3420), False),
    ("single_row", 64, 24, (2, 1, 64), False),
    ("outliers", 64, 32, (5, 64), True),
], ids=lambda c: c[0])
def test_int8_linear_matches_jax(case, w8a8):
    _, k, n, x_shape, outliers = case
    p, x = _linear_case(k + n, k, n, x_shape, outliers)
    q, mod = _port_linear(p, w8a8)
    want = np.asarray(jnn.linear(q, jnp.asarray(x)))
    got = mod(torch.from_numpy(x)).numpy()
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=ATOL * scale, rtol=0)


def test_w8a8_single_row_call_stays_weight_only():
    p, x = _linear_case(3, 64, 24, (2, 1, 64))
    _, plain = _port_linear(p, False)
    _, marked = _port_linear(p, True)
    xt = torch.from_numpy(x)
    assert torch.equal(marked(xt), plain(xt))


def test_exact_int_mm_pads_to_the_card_rules():
    """Row counts <= 16 and widths that are not multiples of 8 are padded
    with zeros and cut back: the int32 product stays exact."""
    rng = np.random.default_rng(4)
    a = rng.integers(-127, 128, (7, 3420)).astype(np.int8)
    b = rng.integers(-127, 128, (3420, 13)).astype(np.int8)
    got = tnn.exact_int_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (7, 13)
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


# ------------------------------------------------------- table and heads

TEXT = FO1Config.tiny().text


def _text_pair(tied, mode):
    """A JAX tiny trunk quantized by `mode` and the port's, loaded from the
    bridged tree (wrapped so that names start with `text.`)."""
    cfg = dataclasses.replace(TEXT, tie_word_embeddings=tied)
    params = jllm.init_text_params(jax.random.PRNGKey(3), cfg)
    q = JAX_MODES[mode]({"text": _copy(params)})["text"]
    pcfg = port_config(cfg)
    holder = torch.nn.Module()
    holder.text = TextModel(pcfg).requires_grad_(False)
    holder.text.load_state_dict(text_state_dict(to_numpy(params), pcfg))
    tq.quantize_model(holder, mode)
    holder.text.load_state_dict(text_state_dict(to_numpy(q), pcfg),
                                strict=True)
    return cfg, q, holder.text


@pytest.mark.parametrize("tied,mode,head", [
    (True, "int8-all", tnn.QEmbedding8),
    (False, "int8", tnn.QLinear8),
    (False, "int4", tnn.QLinear4),
], ids=["tied_row_int8", "untied_int8", "untied_int4"])
def test_table_and_head_match_jax(tied, mode, head):
    cfg, q, text = _text_pair(tied, mode)
    assert isinstance(text.embed_tokens if tied else text.lm_head, head)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, cfg.vocab_size + 40, (2, 7))  # some past the end
    if isinstance(text.embed_tokens, tnn.QEmbedding8):
        want = np.asarray(jllm.embed_tokens(q, jnp.asarray(ids)))
        got = text.embed(torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    hidden = rng.standard_normal((2, 3, cfg.hidden_size)).astype(np.float32)
    want = np.asarray(jllm.lm_head_logits(q, cfg, jnp.asarray(hidden)))
    got = text.logits(torch.from_numpy(hidden))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


# ------------------------------------------------------------- whole FO1

def _cfg(intermediate):
    tiny = FO1Config.tiny()
    return dataclasses.replace(tiny, text=dataclasses.replace(
        tiny.text, tie_word_embeddings=False,
        intermediate_size=intermediate))


JCFG_96, JCFG_128 = _cfg(96), _cfg(128)


@pytest.fixture(scope="module")
def jax_models():
    """The tiny FO1 (I = 96) and the same with a fresh I = 128 trunk."""
    m96 = JaxFO1Model.random_init(JCFG_96, seed=5, tokenizer=StubTokenizer())
    params = dict(m96.params, text=jllm.init_text_params(
        jax.random.PRNGKey(7), JCFG_128.text))
    return {96: m96,
            128: JaxFO1Model(JCFG_128, params, tokenizer=StubTokenizer())}


def _pair(jax_models, mode, intermediate):
    """(JAX model quantized by `mode`, port model quantized by `mode` and
    loaded from the bridged quantized tree, port model's own quantized
    state dict before that load)."""
    jcfg = JCFG_96 if intermediate == 96 else JCFG_128
    cfg = port_config(jcfg)
    base = jax_models[intermediate]
    jq_params = JAX_MODES[mode](_copy(base.params))
    jm = JaxFO1Model(jcfg, jq_params, tokenizer=base.tokenizer)
    tm = FO1Model(cfg, device="cpu", tokenizer=StubTokenizer())
    tm.load_state_dict(state_dict_from_jax_params(to_numpy(base.params), cfg),
                       strict=True)
    tq.quantize_model(tm, mode)
    own = {k: v.clone() for k, v in tm.state_dict().items()}
    tm.load_state_dict(state_dict_from_jax_params(to_numpy(jq_params), cfg),
                       strict=True)
    return jm, tm, own


MODE_CASES = [("int8", 96), ("int8-all", 96), ("w8a8", 96), ("int4", 96),
              ("int4-mlp", 96), ("int4-mlp", 128)]


@pytest.mark.parametrize("mode,intermediate", MODE_CASES,
                         ids=[f"{m}-I{i}" for m, i in MODE_CASES])
def test_quantized_leaves_and_bytes_match_jax(jax_models, mode,
                                              intermediate):
    """The port's quantizer picks the JAX package's leaves (same bridged
    keys, strict load) and writes the same bytes."""
    jm, tm, own = _pair(jax_models, mode, intermediate)
    bridged = tm.state_dict()
    assert set(own) == set(bridged)
    for k, v in own.items():
        assert v.dtype == bridged[k].dtype and torch.equal(v, bridged[k]), k
    fused = [m for m in tm.modules() if isinstance(m, Int4MLP)]
    jax_fused = "fused_int4" in jm.params["text"]["layers"]["mlp"]
    if mode == "int4-mlp":
        # I = 96 does not fit the kernel (96 % 128): int8 MLPs instead
        eligible = intermediate == 128
        assert jax_fused == eligible
        assert len(fused) == (JCFG_128.text.num_hidden_layers
                              if eligible else 0)
        if not eligible:
            assert isinstance(tm.text.layers[0].mlp.down_proj, tnn.QLinear8)
    else:
        assert not fused and not jax_fused
    if mode in ("int4", "int4-mlp", "int8-all"):
        assert isinstance(tm.text.embed_tokens, tnn.QEmbedding8)
    if mode == "w8a8":
        assert all(m.a8 is not None for m in tm.modules()
                   if isinstance(m, tnn.QLinear8))


def _messages(target):
    rng = np.random.default_rng(0)
    from PIL import Image

    img = Image.fromarray(rng.integers(0, 255, (120, 160, 3), np.uint8))
    return [{
        "role": "user",
        "content": [{"type": "image_url", "image_url": {"url": img}},
                    {"type": "text", "text": OD_template.format(target)}],
        "bbox_list": [[10.0 * i, 5.0 * i, 30.0 + 10.0 * i, 40.0 + 5.0 * i]
                      for i in range(3)],
    }]


def _jax_prefill_logits(jm, prep, max_new):
    """Prefill logits of the JAX model, through the same jitted programs as
    its staged `generate` (prompt padded to its 128 bucket)."""
    vj, _, nb, rpad = jm.encode(prep)
    info = prep["splice"]
    s = info.seq_len
    pad_len = pad_to_bucket(s, 128)
    reg_pos = np.full(nb, s, np.int32)
    reg_pos[:len(info.region_positions)] = info.region_positions
    embeds = _splice_embeds(jm.params["text"], jnp.asarray(info.input_ids),
                            vj, jnp.asarray(info.image_positions), rpad,
                            jnp.asarray(reg_pos), pad_len=pad_len)
    pos = np.zeros((3, 1, pad_len), np.int32)
    pos[:, :, :s] = prep["position_ids"]
    _, logits = jax_prefill(jm.params["text"], jm.cfg.text, embeds,
                            jnp.asarray(pos), jnp.asarray([s]),
                            cache_len=pad_len + max_new)
    return np.asarray(logits)[0]


@pytest.mark.parametrize("mode,intermediate", MODE_CASES,
                         ids=[f"{m}-I{i}" for m, i in MODE_CASES])
def test_quantized_fo1_matches_jax(jax_models, mode, intermediate):
    jm, tm, _ = _pair(jax_models, mode, intermediate)
    msgs = _messages("orange")
    prep = tm.prepare(msgs, max_pixels=MAX_PIXELS)
    rt = tm.generate(msgs, max_new_tokens=8, max_pixels=MAX_PIXELS)
    lj = _jax_prefill_logits(jm, jm.prepare(msgs, max_pixels=MAX_PIXELS), 8)
    np.testing.assert_allclose(rt.prefill_logits, lj, atol=LOGIT_ATOL)
    rj = jm.generate(msgs, max_new_tokens=8, max_pixels=MAX_PIXELS,
                     timer=StageTimer())
    np.testing.assert_array_equal(rt.token_ids, rj.token_ids)
    assert len(set(rj.token_ids.tolist())) > 2  # a sequence worth comparing
    assert prep["splice"].seq_len == rt.prompt_len


def test_load_flags_mirror_the_jax_api():
    cfg = port_config(JCFG_96)
    model = FO1Model.random_init(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="w8a8"):
        tq.apply_load_flags(model, w8a8=True)
    with pytest.raises(ValueError, match="w8a8"):
        tq.apply_load_flags(model, load_4bit=True, w8a8=True)
    with pytest.raises(ValueError, match="mode"):
        tq.quantize_model(model, "int3")
    tq.apply_load_flags(model, load_8bit=True, w8a8=True)
    q = model.text.layers[0].self_attn.q_proj
    assert isinstance(q, tnn.QLinear8) and q.a8 is not None
    assert isinstance(model.vision_tower.blocks[0].attn.qkv, tnn.Linear)


# ------------------------------------------------------------ on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("x_shape", [(7, 3420), (40, 3420), (2, 1, 3420)])
def test_w8a8_linear_on_card_matches_cpu(x_shape):
    """The card's int32 product (`torch._int_mm`, padded to its M > 16 and
    multiple-of-8 rules) equals the CPU's."""
    _card()
    p, x = _linear_case(9, 3420, 36, x_shape, outliers=True)
    _, mod = _port_linear(p, True)
    want = mod(torch.from_numpy(x))
    got = mod.cuda()(torch.from_numpy(x).cuda()).cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=ATOL * max(1.0, want.abs().max().item()))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,intermediate", MODE_CASES,
                         ids=[f"{m}-I{i}" for m, i in MODE_CASES])
def test_quantized_fo1_card_matches_cpu_and_jax(jax_models, mode,
                                                intermediate):
    """The bridged quantized weights give the same greedy tokens in three
    places: the JAX package (CPU), the port on the CPU (plain versions) and
    the port on the card (kernels)."""
    _card()
    jm, tm, _ = _pair(jax_models, mode, intermediate)
    gpu = tq.quantize_model(FO1Model(tm.cfg, device="cuda",
                                     tokenizer=StubTokenizer()), mode)
    gpu.load_state_dict(tm.state_dict(), strict=True)
    msgs = _messages("cup")
    rc = tm.generate(msgs, max_new_tokens=8, max_pixels=MAX_PIXELS)
    rg = gpu.generate(msgs, max_new_tokens=8, max_pixels=MAX_PIXELS)
    rj = jm.generate(msgs, max_new_tokens=8, max_pixels=MAX_PIXELS,
                     timer=StageTimer())
    np.testing.assert_array_equal(rc.token_ids, rj.token_ids)
    np.testing.assert_array_equal(rg.token_ids, rc.token_ids)
    np.testing.assert_allclose(rg.prefill_logits, rc.prefill_logits,
                               atol=LOGIT_ATOL)
