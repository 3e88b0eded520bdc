"""The decode step's attention (`ops/decode_attention.py`): on the CPU the
plain version against the chain it replaced in `Attention.forward`, bit for
bit; on a card (`cuda`-marked) the kernel against the
plain version, a graph replay against the eager call, and the launches of
a captured 3B decode step."""

import math

import numpy as np
import pytest
import torch

from vlm_fo1_tpu_torch import nn as tnn
from vlm_fo1_tpu_torch.ops import decode_attention as da


def _pre_change_chain(q, kc, vc, mask4, x_dtype):
    """The decode branch of `Attention.forward` before the kernel: q
    [B, 1, H, hd], mask [B, 1, 1, C]."""
    b, _, nh, hd = q.shape
    nkv = kc.shape[2]
    qg = q.reshape(b, nkv, nh // nkv, hd)
    logits = torch.einsum("bngh,bcnh->bngc", qg.float(), kc.float())
    logits = logits * (1.0 / math.sqrt(hd))
    logits = logits.masked_fill(~mask4[:, :, :1], tnn.MASK_FILL)
    probs = torch.softmax(logits.to(x_dtype).float(), dim=-1).to(x_dtype)
    out = torch.einsum("bngc,bcnh->bngh", probs, vc.to(x_dtype))
    return out.reshape(b, 1, nh * hd)


def _mask(kind, b, c, rng):
    """[B, C] bool: "shared", one row expanded (row stride 0, as
    `decode_step`); "holes", per-row prompt lengths, a gap and the written
    slots after a pad bucket (as the batched loop program)."""
    if kind == "shared":
        return (torch.arange(c) <= max(c - 5, 0)).expand(b, c)
    pad = c - 8
    seq = torch.from_numpy(rng.integers(1, pad + 1, size=b))
    k = torch.arange(c)[None]
    write_at = pad + 3
    return (k < seq[:, None]) | ((k >= pad) & (k <= write_at))


def _inputs(seed, b, hkv, g, c, hd, dtype, mask_kind, qscale=1.0):
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dtype)

    q = draw(b, 1, hkv * g, hd) * qscale
    kc, vc = draw(b, c, hkv, hd), draw(b, c, hkv, hd)
    return q.to(dtype), kc, vc, _mask(mask_kind, b, c, rng)


@pytest.mark.parametrize("mask_kind", ["shared", "holes"])
@pytest.mark.parametrize("hd", [12, 128])
@pytest.mark.parametrize("g", [1, 2, 8])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_version_is_the_pre_change_chain(dtype, b, g, hd, mask_kind):
    dt = getattr(torch, dtype)
    q, kc, vc, mask = _inputs(7, b, 2, g, 37, hd, dt, mask_kind)
    want = _pre_change_chain(q, kc, vc, mask[:, None, None], dt)
    before = da.decode_attention.launches
    got = da.decode_attention(q[:, 0], kc, vc, mask)
    assert da.decode_attention.launches == before  # the CPU takes the plain
    assert got.dtype == dt and got.shape == (b, 2 * g * hd)
    assert torch.equal(got.reshape(b, 1, -1), want)
    assert torch.equal(da.decode_attention_reference(q[:, 0], kc, vc, mask),
                       got)


def test_refuses_a_gradient():
    q, kc, vc, mask = _inputs(1, 1, 2, 2, 9, 12, torch.float32, "shared")
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        da.decode_attention(q[:, 0], kc, vc, mask)


# ------------------------------------------------------------ on the card

def _card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


def _row_rel(out, ref, hd):
    """Worst relative L2 error of one output head row."""
    o = out.float().reshape(out.shape[0], -1, hd)
    r = ref.float().reshape(o.shape)
    return float(((o - r).norm(dim=-1) / r.norm(dim=-1)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", ["shared", "holes"])
@pytest.mark.parametrize("c", [77, 1824, 2432])
@pytest.mark.parametrize("b", [1, 8])
def test_kernel_matches_plain_on_card(b, c, mask_kind, monkeypatch):
    """The 3B shape in bf16 (H 16, Hkv 2, hd 128): worst head row within
    1e-2 relative L2 of the plain version on the same inputs (a logit or a
    probability that rounds to the neighbouring bf16 value moves a row by
    ~1e-3); bit-equal on repeat."""
    _card(monkeypatch)
    q, kc, vc, mask = (x.cuda() for x in _inputs(
        11 + b + c, b, 2, 8, c, 128, torch.bfloat16, mask_kind, qscale=3.0))
    before = da.decode_attention.launches
    out = da.decode_attention(q[:, 0], kc, vc, mask)
    again = da.decode_attention(q[:, 0], kc, vc, mask)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 2
    ref = da.decode_attention_reference(q[:, 0], kc, vc, mask)
    assert _row_rel(out, ref, 128) <= 1e-2
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", ["shared", "holes"])
def test_kernel_matches_plain_on_card_f32_tiny(mask_kind, monkeypatch):
    """The tiny config's shape in f32 (H 4, Hkv 2, hd 12): the FMA path,
    to 1e-5."""
    _card(monkeypatch)
    q, kc, vc, mask = (x.cuda() for x in _inputs(
        5, 3, 2, 2, 77, 12, torch.float32, mask_kind))
    out = da.decode_attention(q[:, 0], kc, vc, mask)
    ref = da.decode_attention_reference(q[:, 0], kc, vc, mask)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


# (b, hkv, g, c, hd, dtype): 16 and 24 query heads a kv head on the
# mma.sync path (one and two groups of 16), one slot, C off every tile; the
# FMA path in bf16 (hd 12, 64, 80, 192, 256) and f32 at the 3B widths; long
# caches (hd 128 and 256)
CARD_EDGE_CASES = [
    (2, 2, 8, 300, 64, "bfloat16"),
    (2, 1, 8, 131, 256, "bfloat16"),
    (3, 2, 16, 333, 128, "bfloat16"),
    (2, 1, 24, 200, 128, "bfloat16"),
    (4, 2, 4, 1, 128, "bfloat16"),
    (2, 2, 8, 65, 192, "bfloat16"),
    (2, 2, 2, 90, 12, "bfloat16"),
    (2, 2, 8, 150, 80, "bfloat16"),
    (2, 2, 8, 700, 128, "float32"),
    (8, 2, 8, 6000, 128, "bfloat16"),
    (2, 1, 8, 4000, 256, "bfloat16"),
]


# the holes mask needs 9 slots or more
EDGE_PARAMS = [(case, kind) for case in CARD_EDGE_CASES
               for kind in ("shared", "holes")
               if case[3] >= 9 or kind == "shared"]


@pytest.mark.cuda
@pytest.mark.parametrize("case,mask_kind", EDGE_PARAMS,
                         ids=lambda x: "-".join(map(str, x))
                         if isinstance(x, tuple) else x)
def test_kernel_edges_on_card(case, mask_kind, monkeypatch):
    _card(monkeypatch)
    b, hkv, g, c, hd, dtype = case
    dt = getattr(torch, dtype)
    q, kc, vc, mask = (x.cuda() for x in _inputs(
        b + c + hd, b, hkv, g, c, hd, dt, mask_kind, qscale=3.0))
    out = da.decode_attention(q[:, 0], kc, vc, mask)
    ref = da.decode_attention_reference(q[:, 0], kc, vc, mask)
    torch.cuda.synchronize()
    assert _row_rel(out, ref, hd) <= (1e-2 if dtype == "bfloat16" else 1e-5)


@pytest.mark.cuda
def test_row_result_independent_of_batch_on_card(monkeypatch):
    """A row's output is bit-equal alone, in a batch of 8, and in a cache
    with 100 more masked slots: serving the same request in another batch
    or bucket must not move its tokens."""
    _card(monkeypatch)
    q, kc, vc, mask = (x.cuda() for x in _inputs(
        4, 8, 2, 8, 1900, 128, torch.bfloat16, "holes", qscale=3.0))
    q = q[:, 0].contiguous()
    batch = da.decode_attention(q, kc, vc, mask)
    alone = da.decode_attention(q[5:6], kc[5:6], vc[5:6], mask[5:6])
    pad = torch.zeros((1, 100, 2, 128), dtype=kc.dtype, device=kc.device)
    longer = da.decode_attention(
        q[5:6], torch.cat([kc[5:6], pad], 1), torch.cat([vc[5:6], pad], 1),
        torch.cat([mask[5:6], torch.zeros_like(mask[5:6, :100])], 1))
    torch.cuda.synchronize()
    assert torch.equal(alone, batch[5:6])
    assert torch.equal(longer, alone)


@pytest.mark.cuda
def test_row_result_independent_of_prompt_pad_on_card(monkeypatch):
    """A batch whose written slots sit after a prompt pad of 1920 and the
    same rows after a pad of 2048 (the next 128-slot bucket, as when a
    longer prompt joins the batch): bit-equal outputs."""
    _card(monkeypatch)
    b, hkv, hd, written = 8, 2, 128, 5
    q, kc, vc, _ = (x.cuda() for x in _inputs(
        6, b, hkv, 8, 1920 + 16, hd, torch.bfloat16, "shared", qscale=3.0))
    q = q[:, 0].contiguous()
    lens = torch.arange(1700, 1700 + 27 * b, 27, device=q.device)

    def layout(pad):
        c = pad + 16
        k2 = torch.zeros((b, c, hkv, hd), dtype=kc.dtype, device=kc.device)
        v2 = torch.zeros_like(k2)
        k2[:, :1920], v2[:, :1920] = kc[:, :1920], vc[:, :1920]
        k2[:, pad:pad + 16], v2[:, pad:pad + 16] = kc[:, 1920:], vc[:, 1920:]
        pos = torch.arange(c, device=q.device)[None]
        mask = (pos < lens[:, None]) | ((pos >= pad) & (pos < pad + written))
        return da.decode_attention(q, k2, v2, mask)

    near, far = layout(1920), layout(2048)
    torch.cuda.synchronize()
    assert torch.equal(near, far)


@pytest.mark.cuda
def test_graph_replay_equals_eager_on_card(monkeypatch):
    _card(monkeypatch)
    q, kc, vc, mask = (x.cuda() for x in _inputs(
        3, 8, 2, 8, 2432, 128, torch.bfloat16, "holes"))
    q = q[:, 0].contiguous()
    eager = da.decode_attention(q, kc, vc, mask)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.decode_attention(q, kc, vc, mask)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.decode_attention(q, kc, vc, mask)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.cuda
def test_captured_3b_steps_launch_once_a_layer_on_card(monkeypatch):
    """A captured B = 8 chunk program of the 3B trunk: each step it runs
    adds 36 launches (one a layer); the capture counts its eager warm-up
    alone."""
    _card(monkeypatch)
    from vlm_fo1_tpu_torch.config import FO1Config
    from vlm_fo1_tpu_torch.models.llm import TextModel
    from vlm_fo1_tpu_torch.runtime import generate as gen

    cfg = FO1Config().text
    with torch.device("cuda"):
        text = TextModel(cfg).to(torch.bfloat16)
    with torch.no_grad():
        for p in text.parameters():
            p.normal_(0.0, 0.02)
    gen_cfg = gen.GenerationConfig(max_new_tokens=16)
    before = da.decode_attention.launches
    prog = gen.acquire_program(text, cfg, gen_cfg, mode="chunk", batch=8,
                               cache_len=1920 + 16, prompt_pad=1920, steps=4)
    captured = da.decode_attention.launches - before
    before = da.decode_attention.launches
    with torch.no_grad():
        prog.done.zero_()
        prog.row_max.fill_(16)
        prog.seq_lens.fill_(1800)
        prog.run()
    torch.cuda.synchronize()
    assert captured == cfg.num_hidden_layers * 4   # the eager warm-up
    assert da.decode_attention.launches - before == 36 * 4
