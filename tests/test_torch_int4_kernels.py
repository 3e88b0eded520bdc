"""The port's int4 kernels' plain versions vs the JAX package, f32 (and
bf16) on the CPU, inputs from numpy seeds:

- `ops.int4_matmul.int4_matmul` (CPU: the halves formulation) vs JAX
  `nn.linear`'s CPU branch for `w_q4` leaves at four shapes, and vs the
  Pallas kernel `int4_matmul(..., interpret=True)` at one, to 2e-5;
- `ops.int4_mlp.int4_mlp` (CPU: the plain version) vs the Pallas kernel
  `int4_mlp_matmul(..., interpret=True)` at one shape and vs
  `int4_mlp_reference` at the others of tests/test_quant.py, to 2e-5 in f32
  and 2e-2 in bf16.

The `cuda`-marked tests hold each CUDA kernel against its plain version on
the card (skipped without one): odd shapes, both dtypes, the streaming
(M <= 8) and tiled paths, and bit-equal repeats.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread  # noqa: F401
from vlm_fo1_tpu import nn as jnn
from vlm_fo1_tpu.ops.int4_matmul import int4_matmul as jax_int4_matmul
from vlm_fo1_tpu.ops.int4_mlp import (
    int4_mlp_matmul as jax_int4_mlp_matmul,
    int4_mlp_reference as jax_int4_mlp_reference,
)
from vlm_fo1_tpu.quant import _quantize_weight_int4, quantize_mlp_int4
from vlm_fo1_tpu_torch.ops.int4_matmul import int4_matmul
from vlm_fo1_tpu_torch.ops.int4_mlp import int4_mlp

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _int4_case(m, k, n, seed=0):
    rng = np.random.default_rng(seed + 31 * m + k + n)
    packed, scale = _quantize_weight_int4(
        jnp.asarray(rng.standard_normal((k, n)).astype(np.float32)))
    x = rng.standard_normal((m, k)).astype(np.float32)
    return x, np.asarray(packed), np.asarray(scale)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("m,k,n", [(1, 32, 24), (5, 64, 48), (9, 16, 130),
                                   (128, 64, 128)])
def test_int4_matmul_plain_matches_jax_linear(m, k, n):
    x, packed, scale = _int4_case(m, k, n)
    want = np.asarray(jnn.linear({"w_q4": jnp.asarray(packed),
                                  "scale": jnp.asarray(scale)},
                                 jnp.asarray(x)))
    got = int4_matmul(*_t(x, packed, scale)).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_matmul_plain_matches_pallas_interpret(dtype):
    x, packed, scale = _int4_case(9, 64, 130)
    want = np.asarray(jax_int4_matmul(jnp.asarray(x, dtype), packed, scale,
                                      interpret=True), np.float32)
    xt, pt, st = _t(x, packed, scale)
    got = int4_matmul(xt.to(getattr(torch, dtype)), pt, st).float().numpy()
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _mlp_node(d, i, seed=0):
    rng = np.random.default_rng(seed + d + i)
    mlp = {name: {"w": jnp.asarray(
        rng.standard_normal(shape).astype(np.float32) * 0.05)}
        for name, shape in (("gate_proj", (d, i)), ("up_proj", (d, i)),
                            ("down_proj", (i, d)))}
    node = quantize_mlp_int4(mlp)["fused_int4"]
    return {k: np.asarray(v) for k, v in node.items()}


@pytest.mark.parametrize("m,d,i,oracle", [
    (5, 256, 768, "pallas_interpret"), (1, 64, 256, "reference"),
    (16, 128, 128, "reference"), (200, 128, 256, "reference"),
    (300, 64, 128, "reference")])
def test_int4_mlp_plain_matches_jax(m, d, i, oracle):
    node = _mlp_node(d, i)
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, d)).astype(np.float32)
    jnode = {k: jnp.asarray(v) for k, v in node.items()}
    tnode = {k: torch.from_numpy(np.array(v)) for k, v in node.items()}
    for dtype, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL)):
        xj = jnp.asarray(x, dtype)
        want = np.asarray(
            jax_int4_mlp_matmul(xj, jnode, interpret=True)
            if oracle == "pallas_interpret"
            else jax_int4_mlp_reference(xj, jnode), np.float32)
        got = int4_mlp(torch.from_numpy(x).to(getattr(torch, dtype)),
                       tnode).float().numpy()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=dtype)


# ------------------------------------------------------------ on the card

def _card(monkeypatch):
    """Skip without a card; turn TF32 off for this test only."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


INT4_CARD_SHAPES = [(1, 32, 24), (3, 64, 130), (5, 3420, 48), (8, 96, 4100),
                    (9, 16, 130), (128, 64, 128), (77, 2048, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", INT4_CARD_SHAPES)
def test_int4_matmul_kernel_matches_plain_on_card(m, k, n, monkeypatch):
    from vlm_fo1_tpu_torch.ops.int4_matmul import int4_matmul_reference

    _card(monkeypatch)
    x, packed, scale = (t.cuda() for t in _t(*_int4_case(m, k, n)))
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        xd = x.to(dtype)
        got = int4_matmul(xd, packed, scale)
        again = int4_matmul(xd, packed, scale)
        torch.cuda.synchronize()
        want = int4_matmul_reference(xd.float(), packed, scale)
        scale_ = max(1.0, want.abs().max().item())
        assert got.dtype == dtype and torch.equal(got, again)
        assert (got.float() - want).abs().max().item() <= tol * scale_


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,i", [(1, 64, 256), (5, 256, 768),
                                   (16, 128, 128), (200, 128, 256),
                                   (8, 48, 128), (33, 2048, 1024)])
def test_int4_mlp_kernel_matches_plain_on_card(m, d, i, monkeypatch):
    from vlm_fo1_tpu_torch.ops.int4_mlp import int4_mlp_reference

    _card(monkeypatch)
    node = {k: torch.from_numpy(np.array(v)).cuda()
            for k, v in _mlp_node(d, i).items()}
    x = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (m, d)).astype(np.float32)).cuda()
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        xd = x.to(dtype)
        got = int4_mlp(xd, node)
        again = int4_mlp(xd, node)
        torch.cuda.synchronize()
        want = int4_mlp_reference(xd, node).float()
        scale_ = max(1.0, want.abs().max().item())
        assert got.dtype == dtype and torch.equal(got, again)
        assert (got.float() - want).abs().max().item() <= tol * scale_
