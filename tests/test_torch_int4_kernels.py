"""The port's int4 kernels' plain versions vs the JAX package, f32 (and
bf16) on the CPU, inputs from numpy seeds:

- `ops.int4_matmul.int4_matmul` (CPU: the halves formulation) vs JAX
  `nn.linear`'s CPU branch for `w_q4` leaves at four shapes, and vs the
  Pallas kernel `int4_matmul(..., interpret=True)` at one, to 2e-5;
- `ops.int4_mlp.int4_mlp` (CPU: the plain version) vs the Pallas kernel
  `int4_mlp_matmul(..., interpret=True)` at one shape and vs
  `int4_mlp_reference` at the others of tests/test_quant.py, to 2e-5 in f32
  and 2e-2 in bf16.

- the magic-number nibble decode of the tiled kernels, written in torch
  on integer bit patterns as the CUDA code runs it, vs `unpack_int4_halves`
  and JAX `quant.unpack_int4` for all 256 byte values, exactly, and the
  streaming route's variant (two rows' bytes gathered into one word, the
  XOR folded into the mask) for all 65,536 pairs of bytes;
- the streaming route's split planner (`cluster_plan`) on the 3B trunk's
  packed weights and on chip_smoke.py's streaming cases, at 132 and 114
  SMs, with its default capacity model and the clusters an H100 holds:
  every packed row in exactly one slice, at most 8 slices (a portable
  cluster), and a grid that fills the SMs;
- the plain versions of the unpack microbenchmark's strategies vs
  `tools/xp_int4_unpack.py`'s `unpack_divide` / `unpack_shift` /
  `unpack_float` (imported by path), exactly; and its fused gate/up
  product (`unpack_bench_reference`) vs the file's own kernel bodies
  (`kernel` per mode, `nounpack_kernel` for "none") run as an interpreted
  `pallas_call` over the file's grid at a cut geometry (the file's module
  constants patched), worst row relative L2 <= 1e-5; "cvt" and "magic"
  equal to "divide" exactly.

The `cuda`-marked tests hold each CUDA kernel against its plain version on
the card (skipped without one): odd shapes, both dtypes, the streaming
(M <= 8) and tiled paths, tile edges with the route each call takes, and
bit-equal repeats; and the unpack microbenchmark's product for every
strategy (row bound, zero columns, bit-equal repeats, its copy ring).
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from chip_smoke import INT4_CASES, INT4_MLP_CASES, _at_offset, _seg_rel
from torch_parity import one_torch_thread  # noqa: F401
from vlm_fo1_tpu import nn as jnn
from vlm_fo1_tpu.ops.int4_matmul import int4_matmul as jax_int4_matmul
from vlm_fo1_tpu.ops.int4_mlp import (
    int4_mlp_matmul as jax_int4_mlp_matmul,
    int4_mlp_reference as jax_int4_mlp_reference,
)
from vlm_fo1_tpu import quant as jquant
from vlm_fo1_tpu.quant import _quantize_weight_int4, quantize_mlp_int4
from vlm_fo1_tpu_torch.ops import int4_unpack
from vlm_fo1_tpu_torch.ops.int4_matmul import (
    STREAM_COLS,
    STREAM_MAX_SPLIT,
    STREAM_STEP,
    cluster_plan,
    int4_matmul,
    unpack_int4_halves,
)
from vlm_fo1_tpu_torch.ops.int4_mlp import int4_mlp

F32_TOL = 2e-5
BF16_TOL = 2e-2
# worst relative L2 error of one output row segment (128 columns) on the
# card, chip_smoke.py's bound: bf16 output rounding gives ~3e-3, a wrong
# tile several percent
SEG_BF16 = 1e-2
ALL_BYTES = np.arange(-128, 128, dtype=np.int8)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


# ------------------------------------------------------------- the decode

def test_magic_decode_matches_unpack_for_all_bytes():
    """Every byte value, both nibbles: the tiled kernels' decode (bit
    patterns, bf16 arithmetic) gives the signed nibbles exactly."""
    lo, hi = int4_unpack.decode_magic(torch.from_numpy(ALL_BYTES))
    assert lo.dtype == hi.dtype == torch.bfloat16
    tlo, thi = unpack_int4_halves(torch.from_numpy(ALL_BYTES))
    assert torch.equal(lo.float(), tlo.float())
    assert torch.equal(hi.float(), thi.float())
    jlo, jhi = jquant.unpack_int4_halves(jnp.asarray(ALL_BYTES))
    want = np.asarray(jquant.unpack_int4(jnp.asarray(ALL_BYTES[None])))
    np.testing.assert_array_equal(lo.float().numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.float().numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(
        torch.cat([lo[None], hi[None]]).float().numpy(),
        want.astype(np.float32))


def test_streaming_decode_matches_unpack_for_all_byte_pairs():
    """The streaming kernel's decode, on bit patterns as the CUDA code runs
    it: `__byte_perm` puts byte c of two rows' words at bytes 0 and 2 of
    one word (bytes 1 and 3 keep whatever they held), `(t & 0x000F000F) ^
    0x43084308` (the high nibbles: t >> 4 first) forms 0x4300 | (n ^ 8) in
    both halves, and x * 1 - 136 in bf16 leaves the signed nibbles of the
    two rows, for every pair of byte values."""
    a, b = torch.meshgrid(torch.arange(256), torch.arange(256),
                          indexing="ij")
    word = a | (0x5A << 8) | (b << 16) | (0xC3 << 24)   # bytes 1, 3: noise
    mask, magic = 0x000F000F, 0x43084308

    def bf16x2(v):
        halves = torch.stack([v & 0xFFFF, v >> 16], -1)
        return (halves.to(torch.int16).view(torch.bfloat16).float() * 1.0
                - 136.0).to(torch.bfloat16)

    lo, hi = bf16x2((word & mask) ^ magic), bf16x2(((word >> 4) & mask)
                                                   ^ magic)
    bytes_ = torch.stack([a, b], -1).to(torch.uint8).view(torch.int8)
    want_lo, want_hi = unpack_int4_halves(bytes_)
    assert torch.equal(lo.float(), want_lo.float())
    assert torch.equal(hi.float(), want_hi.float())


# (packed rows, packed columns) of the streaming route's products: the 3B
# trunk's int4 linears (CK [K/2, N]: q/o, k/v, gate/up, down), the fused
# MLP's down (OUT [I, D/2]), and every streaming case of chip_smoke.py
PLAN_SHAPES = sorted(
    {(1024, 2048), (1024, 256), (1024, 11008), (5504, 2048), (11008, 1024)}
    | {(k // 2, n) for m, k, n, _, _ in INT4_CASES if m <= 8}
    | {shape for m, d, i, _, _ in INT4_MLP_CASES if m <= 8
       for shape in ((d // 2, i), (i, d // 2))})


# clusters of 1..8 blocks of the streaming kernel an H100 SXM holds at once
# (cudaOccupancyMaxActiveClusters on the card, 132 SMs); the planner's
# default model is two blocks an SM
H100_CLUSTERS = (264, 132, 79, 62, 47, 39, 32, 30)


@pytest.mark.parametrize("capacity", ["two_a_sm", "h100_clusters"])
@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("rows,cols", PLAN_SHAPES)
def test_cluster_plan_covers_rows_once_and_fills_sms(rows, cols, sms,
                                                     capacity):
    def held(splits, rows_per):
        return H100_CLUSTERS[splits - 1] * sms // 132

    splits, rows_per = cluster_plan(
        rows, cols, sms, held if capacity == "h100_clusters" else None)
    assert 1 <= splits <= STREAM_MAX_SPLIT
    assert rows_per > 0 and rows_per % STREAM_STEP == 0
    slices = [range(s * rows_per, min(rows, (s + 1) * rows_per))
              for s in range(splits)]
    assert all(len(sl) > 0 for sl in slices)
    assert [r for sl in slices for r in sl] == list(range(rows))
    # the grid fills the SMs, or no cluster of at most 8 could shorten its
    # longest slice
    steps = -(-rows // STREAM_STEP)
    blocks = splits * -(-cols // STREAM_COLS)
    assert blocks >= sms or rows_per // STREAM_STEP == -(-steps // min(
        STREAM_MAX_SPLIT, steps))


def _tpu_unpack_file():
    spec = importlib.util.spec_from_file_location(
        "xp_int4_unpack", os.path.join(ROOT, "tools", "xp_int4_unpack.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("strategy", ["divide", "shift", "float"])
def test_unpack_strategies_match_tpu_file(strategy):
    xp = _tpu_unpack_file()
    if strategy == "float":
        want = xp.unpack_float(jnp.asarray(ALL_BYTES), jnp.bfloat16)
        got = int4_unpack.unpack_float(torch.from_numpy(ALL_BYTES),
                                       torch.bfloat16)
    else:
        fn = getattr(xp, f"unpack_{strategy}")
        want = fn(jnp.asarray(ALL_BYTES, jnp.int32))
        got = getattr(int4_unpack, f"unpack_{strategy}")(
            torch.from_numpy(ALL_BYTES).to(torch.int32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))


# the TPU file's kernels at a cut geometry: D, I, TI, M patched in its module
UNPACK_CUT = {"D": 256, "I": 512, "TI": 128, "M": 8}
# worst relative L2 error of one output row against the TPU file's kernel:
# the same exact bf16 products, f32 sums in another order
UNPACK_ROW_REL = 1e-5


def _unpack_inputs(seed, d, i, m=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    g, u = (rng.integers(-128, 127, (d // 2, i), dtype=np.int8)
            for _ in range(2))
    x16 = torch.from_numpy(x).to(torch.bfloat16)
    return x16, torch.from_numpy(g), torch.from_numpy(u)


def _row_rel(got, want):
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()


@pytest.mark.parametrize("mode", ["none", "divide", "shift", "float"])
def test_unpack_bench_plain_matches_tpu_kernel(mode, monkeypatch):
    xp = _tpu_unpack_file()
    for name, value in UNPACK_CUT.items():
        monkeypatch.setattr(xp, name, value)
    d, i, ti, m = (UNPACK_CUT[k] for k in ("D", "I", "TI", "M"))
    x, g, u = _unpack_inputs(3, d, i, m)
    body = (xp.nounpack_kernel if mode == "none"
            else functools.partial(xp.kernel, mode=mode))
    vmem = pltpu.VMEM
    want = pl.pallas_call(
        body, grid=(i // ti,),
        in_specs=[pl.BlockSpec((m, d), lambda t: (0, 0), memory_space=vmem),
                  pl.BlockSpec((d // 2, ti), lambda t: (0, t),
                               memory_space=vmem),
                  pl.BlockSpec((d // 2, ti), lambda t: (0, t),
                               memory_space=vmem)],
        out_specs=pl.BlockSpec((m, d), lambda t: (0, 0), memory_space=vmem),
        out_shape=jax.ShapeDtypeStruct((m, d), jnp.float32),
        interpret=True)(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                        jnp.asarray(g.numpy()), jnp.asarray(u.numpy()))
    want = torch.from_numpy(np.array(want))
    got = int4_unpack.unpack_bench(x, g, u, mode, ti=ti)
    assert got.shape == (m, d) and not got[:, ti:].any()
    assert _row_rel(got, want) <= UNPACK_ROW_REL


def test_unpack_bench_signed_decodes_agree_without_a_launch():
    """cvt and magic decode to the same values as divide (and shift), so
    their products are equal bit for bit; float's unsigned low nibble and
    none's raw bytes give other products. CPU tensors take the plain
    version and launch nothing."""
    x, g, u = _unpack_inputs(5, 256, 384)
    before = (int4_unpack.unpack_bench.launches,
              int4_unpack.copy_ring.launches)
    outs = {s: int4_unpack.unpack_bench(x, g, u, s, ti=128)
            for s in int4_unpack.STRATEGIES}
    for s in ("shift", "cvt", "magic"):
        assert torch.equal(outs[s], outs["divide"]), s
    for s in ("none", "float"):
        assert _row_rel(outs[s], outs["divide"]) > 1e-2, s
    assert before == (int4_unpack.unpack_bench.launches,
                      int4_unpack.copy_ring.launches)
    with pytest.raises(ValueError):
        int4_unpack.copy_ring(x, g, u, ti=128)
    with pytest.raises(ValueError):
        int4_unpack.unpack_bench(x, g, u, "other", ti=128)


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


# (M, K, N, byte offset of x, route of a bf16 call): tile edges of the TMA
# tiles (M around 64 and 128, K/2 off the 64-row tile, K = 11008, N = 256
# and 11008), the shapes that keep the mma.sync tiles, and the streaming
# route (one launch a call) at odd M, N and x offsets
INT4_EDGE_CASES = [(9, 2048, 256, 0, "tma"), (63, 2112, 256, 0, "tma"),
                   (64, 11008, 2048, 0, "tma"), (65, 2048, 11008, 0, "tma"),
                   (127, 2112, 4100, 0, "mma"), (129, 2048, 130, 0, "mma"),
                   (1771, 2048, 256, 0, "tma"), (65, 2048, 256, 48, "tma"),
                   (65, 2048, 256, 8, "mma"), (2, 2048, 256, 8, "gemv"),
                   (4, 11008, 2048, 48, "gemv"), (7, 3420, 130, 4, "gemv"),
                   (8, 2048, 11008, 0, "gemv")]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,offset,route", INT4_EDGE_CASES)
def test_int4_matmul_tile_edges_on_card(m, k, n, offset, route, monkeypatch):
    from vlm_fo1_tpu_torch.ops.int4_matmul import int4_matmul_reference

    _card(monkeypatch)
    x, packed, scale = (t.cuda() for t in _t(*_int4_case(m, k, n)))
    xd = _at_offset(x.to(torch.bfloat16), offset)
    before = dict(int4_matmul.routes)
    got = int4_matmul(xd, packed, scale)
    again = int4_matmul(xd, packed, scale)
    torch.cuda.synchronize()
    took = {r for r in before if int4_matmul.routes[r] != before[r]}
    want = int4_matmul_reference(xd.float(), packed, scale)
    assert took == {route}
    assert torch.equal(got, again)
    assert _seg_rel(got, want) <= SEG_BF16


# (M, D, I, byte offset of x, route of both products in bf16)
INT4_MLP_EDGE_CASES = [(9, 2048, 1024, 0, "tma"), (63, 2048, 1024, 0, "tma"),
                       (64, 2048, 1024, 0, "tma"), (127, 2112, 1024, 0, "tma"),
                       (129, 2048, 1024, 48, "tma"), (33, 40, 128, 0, "mma"),
                       (2, 2048, 1024, 8, "gemv"), (7, 64, 130, 0, "gemv")]


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,i,offset,route", INT4_MLP_EDGE_CASES)
def test_int4_mlp_tile_edges_on_card(m, d, i, offset, route, monkeypatch):
    from vlm_fo1_tpu_torch.ops.int4_mlp import int4_mlp_reference

    _card(monkeypatch)
    node = {k: torch.from_numpy(np.array(v)).cuda()
            for k, v in _mlp_node(d, i).items()}
    x = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (m, d)).astype(np.float32)).cuda()
    xd = _at_offset(x.to(torch.bfloat16), offset)
    before = dict(int4_mlp.routes)
    got = int4_mlp(xd, node)
    again = int4_mlp(xd, node)
    torch.cuda.synchronize()
    took = {r: int4_mlp.routes[r] - before[r] for r in before
            if int4_mlp.routes[r] != before[r]}
    want = int4_mlp_reference(xd.float(), node).float()
    assert took == {route: 4}
    assert torch.equal(got, again)
    assert _seg_rel(got, want) <= SEG_BF16


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", int4_unpack.STRATEGIES)
@pytest.mark.parametrize("d,i,ti", [(256, 512, 256), (2048, 2816, 256)])
def test_unpack_bench_matches_plain_on_card(strategy, d, i, ti, monkeypatch):
    """The fused product on the card: worst row relative L2 <= 1e-4
    (chip_smoke.py's bound), zero columns past ti, bit-equal on repeat;
    the copy ring alone reads zeros, each launch counted."""
    _card(monkeypatch)
    x, g, u = (t.cuda() for t in _unpack_inputs(11, d, i))
    before = int4_unpack.unpack_bench.launches
    got = int4_unpack.unpack_bench(x, g, u, strategy, ti=ti)
    again = int4_unpack.unpack_bench(x, g, u, strategy, ti=ti)
    torch.cuda.synchronize()
    assert int4_unpack.unpack_bench.launches == before + 2
    want = int4_unpack.unpack_bench_reference(x, g, u, strategy, ti=ti)
    assert torch.equal(got, again)
    assert not got[:, ti:].any()
    assert _row_rel(got, want) <= 1e-4
    ring = int4_unpack.copy_ring(x, g, u, ti=ti)
    torch.cuda.synchronize()
    assert not ring.any()


@pytest.mark.cuda
def test_int4_zero_rows_launch_nothing_on_card(monkeypatch):
    _card(monkeypatch)
    _, packed, scale = (t.cuda() for t in _t(*_int4_case(1, 64, 48)))
    node = {k: torch.from_numpy(np.array(v)).cuda()
            for k, v in _mlp_node(64, 128).items()}
    before = (int4_matmul.launches, dict(int4_matmul.routes),
              int4_mlp.launches, dict(int4_mlp.routes))
    x = torch.empty(0, 64, dtype=torch.bfloat16, device="cuda")
    assert int4_matmul(x, packed, scale).shape == (0, 48)
    assert int4_mlp(x, node).shape == (0, 64)
    assert before == (int4_matmul.launches, int4_matmul.routes,
                      int4_mlp.launches, int4_mlp.routes)
