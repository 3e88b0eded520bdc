"""PyTorch port's flash attention vs the JAX Pallas kernel (interpret mode)
and its jnp reference, on the CPU, and the gradient of its differentiable
form vs `jax.vjp` of the JAX reference (the path the JAX package's gradient
takes); the CUDA kernel itself is compared with the plain version by the
`cuda`-marked tests on a card."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vlm_fo1_tpu.ops.flash_attention import (
    flash_attention as jax_flash,
    flash_attention_reference as jax_reference,
)
from vlm_fo1_tpu_torch.ops import flash_attention as fa

ATOL = 2e-5  # f32, different summation order

# (b, h, hkv, sq, sk, d, kwargs): the cases of tests/test_flash_attention.py
# plus the head dims of the full-width (80, 128) and tiny (12) configs
CASES = [
    (1, 2, 2, 72, 72, 16, {}),
    (1, 2, 2, 72, 72, 16, {"causal": True}),
    (1, 1, 1, 24, 64, 8, {"kv_len": 37}),
    (1, 4, 2, 40, 40, 8, {"causal": True}),
    (2, 2, 2, 37, 53, 16, {"kv_len": 53}),
    (1, 2, 2, 50, 50, 12, {"causal": True, "kv_len": 45}),
    (1, 2, 1, 64, 64, 80, {"kv_valid": "random"}),
    (1, 4, 2, 33, 33, 128, {"causal": True}),
]


def _case_id(case):
    return f"d{case[5]}-{sorted(case[6])}"


def _inputs(seed, b, h, hkv, sq, sk, d, kw):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    kw = dict(kw)
    if kw.get("kv_valid") == "random":
        kw["kv_valid"] = rng.random(sk) > 0.3
    return q, k, v, kw


def _torch_kw(kw):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


def _jax_kw(kw):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_matches_pallas_and_reference(case):
    q, k, v, kw = _inputs(0, *case)
    out = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), **_torch_kw(kw)).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    ref = jax_reference(jq, jk, jv, **_jax_kw(kw))
    pallas = jax_flash(jq, jk, jv, block_q=16, block_k=128, interpret=True,
                       **_jax_kw(kw))
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(out, np.asarray(pallas), atol=ATOL, rtol=ATOL)


def test_keys_past_kv_len_do_not_matter():
    q, k, v, _ = _inputs(1, 1, 1, 1, 24, 64, 8, {})
    t = [torch.from_numpy(x) for x in (q, k, v)]
    out = fa.flash_attention(*t, kv_len=37)
    k2, v2 = t[1].clone(), t[2].clone()
    k2[:, :, 37:] = 999.0
    v2[:, :, 37:] = -999.0
    torch.testing.assert_close(fa.flash_attention(t[0], k2, v2, kv_len=37),
                               out, atol=1e-6, rtol=0)


def test_fully_masked_query_rows_stay_finite():
    """Causal with Sq > Sk leaves the first Sq - Sk query rows without a
    key; an all-False kv_valid masks every row. Both stay finite."""
    q, k, v, _ = _inputs(2, 1, 2, 2, 20, 12, 16, {})
    t = [torch.from_numpy(x) for x in (q, k, v)]
    out = fa.flash_attention(*t, causal=True)
    assert torch.isfinite(out).all()
    ref = jax_reference(*(jnp.asarray(x) for x in (q, k, v)), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    q2, k2, v2, _ = _inputs(3, 1, 2, 2, 16, 16, 16, {})
    none = torch.zeros(16, dtype=torch.bool)
    out2 = fa.flash_attention(torch.from_numpy(q2), torch.from_numpy(k2),
                              torch.from_numpy(v2), kv_valid=none)
    assert torch.isfinite(out2).all()


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    before = fa.flash_attention.launches
    q, k, v, _ = _inputs(4, 1, 2, 2, 8, 8, 16, {})
    out = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert out.shape == (1, 2, 8, 16)
    assert fa.flash_attention.launches == before


def test_other_devices_raise():
    q = torch.empty(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_kernel_matches_plain_on_card(case, dtype, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v, kw = _inputs(5, *case)
    kw = {n: torch.from_numpy(x).cuda() if isinstance(x, np.ndarray) else x
          for n, x in kw.items()}
    dt = getattr(torch, dtype)
    t = [torch.from_numpy(x).cuda().to(dt) for x in (q, k, v)]
    before = fa.flash_attention.launches
    out = fa.flash_attention(*t, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    ref = fa.flash_attention_reference(*(x.float() for x in t), **kw)
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=0)


# The edges of the card's tiles (blocks of 64 or 128 queries, 64-key tiles,
# d padded to a multiple of 16), kept apart from CASES so the Pallas
# interpret runs on the CPU do not grow: d=12 (plain element loads), the head dims 80 and 128
# (16-byte copies), Sq and Sk off every tile, a 64-key tile whose keys are
# all invalid, causal with Sq < Sk and kv_len < Sk, and 8 query heads per kv
# head at Sq = 300.
CARD_EDGE_CASES = [
    (1, 2, 2, 131, 131, 12, {"causal": True}),
    (1, 2, 1, 200, 211, 80, {"kv_valid": "random"}),
    (2, 2, 2, 129, 77, 128, {"kv_len": 70}),
    (1, 2, 2, 100, 200, 80, {"kv_valid": "second_tile_invalid"}),
    (1, 4, 2, 70, 190, 128, {"causal": True, "kv_len": 150}),
    (1, 16, 2, 300, 300, 128, {"causal": True, "kv_len": 290}),
    (1, 2, 2, 257, 130, 16, {"kv_len": 129}),
]


def _edge_id(case):
    b, h, hkv, sq, sk, d, kw = case
    return f"{b}x{h}/{hkv}-q{sq}-k{sk}-d{d}-{'-'.join(sorted(kw))}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CARD_EDGE_CASES, ids=_edge_id)
def test_kernel_tile_edges_on_card(case, dtype, monkeypatch):
    """The kernel against the plain version in f32 on the same inputs: f32
    (TF32 off) to 1e-4, bf16 to 2e-2 (bf16 probabilities before P V)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v, kw = _inputs(6, *case)
    if isinstance(kw.get("kv_valid"), str):  # "second_tile_invalid"
        kw["kv_valid"] = np.random.default_rng(6).random(case[4]) > 0.3
        kw["kv_valid"][64:128] = False
    kw = {n: torch.from_numpy(x).cuda() if isinstance(x, np.ndarray) else x
          for n, x in kw.items()}
    dt = getattr(torch, dtype)
    t = [torch.from_numpy(x).cuda().to(dt) for x in (q, k, v)]
    out = fa.flash_attention(*t, **kw)
    torch.cuda.synchronize()
    ref = fa.flash_attention_reference(*(x.float() for x in t), **kw)
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fully_masked_query_rows_stay_finite_on_card(dtype, monkeypatch):
    """As on the CPU: causal with Sq > Sk (the first Sq - Sk rows have no
    key; the rest match the plain version) and an all-False kv_valid."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    dt = getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 2e-2
    q, k, v, _ = _inputs(9, 1, 2, 2, 200, 72, 16, {})
    t = [torch.from_numpy(x).cuda().to(dt) for x in (q, k, v)]
    out = fa.flash_attention(*t, causal=True)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    ref = fa.flash_attention_reference(*(x.float() for x in t), causal=True)
    torch.testing.assert_close(out[:, :, 128:].float(), ref[:, :, 128:],
                               atol=tol, rtol=0)
    none = torch.zeros(72, dtype=torch.bool, device="cuda")
    assert torch.isfinite(fa.flash_attention(*t, kv_valid=none)).all()


# GQA, causal with kv_len, and the ViT's interspersed key mask
GRAD_CASES = [CASES[3], CASES[5], CASES[6]]


def _grad_inputs(seed, case):
    q, k, v, kw = _inputs(seed, *case)
    b, h, _, sq, _, d, _ = case
    g = np.random.default_rng(seed + 100).standard_normal(
        (b, h, sq, d)).astype(np.float32)
    return q, k, v, kw, g


def _plain_kernel(q, k, v, causal, kv_len, kv_valid, scale):
    return fa.flash_attention_reference(q, k, v, causal=causal, kv_len=kv_len,
                                        kv_valid=kv_valid, scale=scale)


@pytest.mark.parametrize("case", GRAD_CASES, ids=_case_id)
def test_differentiable_gradients_match_jax_vjp(case, monkeypatch):
    """`FlashAttentionFunction` (its kernel launch swapped for the plain
    version, the only way to run it without a card: the backward's
    per-kv-head recompute is the code under test) and the CPU entry
    `flash_attention_differentiable` both give `jax.vjp` of the JAX
    reference. f32, different summation order: atol/rtol 1e-4."""
    q, k, v, kw, g = _grad_inputs(7, case)
    _, vjp = jax.vjp(lambda a, b, c: jax_reference(a, b, c, **_jax_kw(kw)),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    tkw = _torch_kw(kw)
    monkeypatch.setattr(fa, "_kernel", _plain_kernel)
    for route in ("function", "cpu entry"):
        leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        if route == "function":
            out = fa.FlashAttentionFunction.apply(
                *leaves, tkw.get("kv_valid"), tkw.get("causal", False),
                tkw.get("kv_len"), None)
        else:
            out = fa.flash_attention_differentiable(*leaves, **tkw)
        out.backward(torch.from_numpy(g))
        for name, leaf, w in zip("qkv", leaves, want):
            np.testing.assert_allclose(leaf.grad.numpy(), w, atol=1e-4,
                                       rtol=1e-4, err_msg=f"{route} d{name}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GRAD_CASES + [CASES[7]], ids=_case_id)
def test_differentiable_kernel_path_on_card(case, dtype, monkeypatch):
    """`flash_attention_differentiable` on the card (one kernel launch, the
    plain gradient recomputed per kv head) against autograd of the plain
    version in f32 on the same inputs: f32 with TF32 off 1e-4, bf16 3e-2 x
    max(1, max|plain|) (bf16 inputs and probabilities)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v, kw, g = _grad_inputs(8, case)
    kw = {n: torch.from_numpy(x).cuda() if isinstance(x, np.ndarray) else x
          for n, x in kw.items()}
    dt = getattr(torch, dtype)
    gc = torch.from_numpy(g).cuda()
    leaves = [torch.from_numpy(x).cuda().to(dt).requires_grad_(True)
              for x in (q, k, v)]
    before = fa.flash_attention.launches
    out = fa.flash_attention_differentiable(*leaves, **kw)
    out.backward(gc.to(dt))
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    refs = [x.detach().float().requires_grad_(True) for x in leaves]
    ref = fa.flash_attention_reference(*refs, **kw)
    ref.backward(gc)
    tol = 1e-4 if dtype == "float32" else 3e-2
    for got, want in [(out, ref)] + [(a.grad, b.grad)
                                     for a, b in zip(leaves, refs)]:
        assert got.dtype == dt
        bound = tol * max(1.0, want.abs().max().item())
        torch.testing.assert_close(got.float(), want.detach(), atol=bound,
                                   rtol=0)
