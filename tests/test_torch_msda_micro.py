"""The port's MSDA microbenchmarks (`ops/msda_dma.py`, `ops/msda_micro.py`,
`ops/matmul_floor.py`) vs the TPU files they replace, on the CPU.

Each TPU file's kernel body is rebuilt here at a cut geometry (its
constants read from the file itself) and run as `pl.pallas_call(...,
interpret=True)` with the file's BlockSpecs (VMEM and SMEM blocks, dynamic
row reads from an SMEM code block). The port's plain versions take the same
numpy-seeded inputs:
- the streaming benchmark: its out block of zeros equals the TPU kernel's
  exactly, and its 32-bit checksum equals a numpy sum of the words read;
- the gather benchmark: equal to the TPU kernel's one-hot products to f32
  rounding (atol = rtol = 1e-6: the same exact products, summed in slot
  order);
- the chained products: equal to the TPU kernel's dots to f32 rounding
  (rtol 1e-5, atol 1e-4 on sums of 128-512 products of unit normals), and
  the plain version's tile the same after 1 and 3 steps.
The CUDA kernels themselves are compared with the plain versions by the
`cuda`-marked tests on a card."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from torch_parity import one_torch_thread  # noqa: F401
from vlm_fo1_tpu_torch.ops import matmul_floor, msda_dma, msda_micro

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------- streaming (xp_msda_dma)

DMA_HEADS, DMA_NQB, DMA_RBAND = 2, 3, 64


def _dma_inputs(xp, seed=0):
    """numpy arrays of the file's kinds at the cut geometry: (val4 as f32
    values on the bf16 grid, dvm, w4, code x3, dense x3)."""
    rng = np.random.default_rng(seed)
    lq = xp.QB * DMA_NQB
    code_rows = -(-DMA_NQB // 8) * 8

    def words(*shape):
        return rng.integers(-2**31, 2**31 - 1, shape, dtype=np.int32)

    val4 = np.asarray(jnp.asarray(rng.standard_normal(
        (DMA_HEADS, DMA_RBAND, 128)), jnp.bfloat16).astype(jnp.float32))
    return {"val4": val4, "dvm": words(DMA_HEADS, lq, 4),
            "w4": rng.standard_normal((DMA_HEADS, lq, 16)).astype(np.float32),
            "code": [words(DMA_HEADS, code_rows, 128) for _ in range(3)],
            "dense": [words(DMA_HEADS, lq * 4 // 128, 128)
                      for _ in range(3)]}


def _tpu_dma(xp, arrays, flags, out_w, scratch_rows):
    """The TPU file's `build` kernel (main / main2 / main3) with the case's
    input blocks, interpreted: the out block of zeros it writes."""
    qb, brows = xp.QB, xp.BROWS
    lq = qb * DMA_NQB
    specs = []
    args = []

    def add(spec, x):
        specs.append(spec)
        args.append(jnp.asarray(x))

    if flags & msda_dma.VAL4:
        add(pl.BlockSpec((1, DMA_RBAND, 128), lambda i, j: (i, 0, 0),
                         memory_space=pltpu.VMEM),
            jnp.asarray(arrays["val4"], jnp.bfloat16))
    if flags & msda_dma.DVM:
        add(pl.BlockSpec((1, qb, 4), lambda i, j: (i, j, 0),
                         memory_space=pltpu.VMEM), arrays["dvm"])
    if flags & msda_dma.W4:
        add(pl.BlockSpec((1, qb, 16), lambda i, j: (i, j, 0),
                         memory_space=pltpu.VMEM), arrays["w4"])
    if flags & msda_dma.CODE:
        for a in arrays["code"]:
            add(pl.BlockSpec((1, 8, 128), lambda i, j: (i, j // 8, 0),
                             memory_space=pltpu.SMEM), a)
    for bit, space in ((msda_dma.DENSE, pltpu.VMEM),
                       (msda_dma.DSMEM, pltpu.SMEM)):
        if flags & bit:
            for a in arrays["dense"]:
                add(pl.BlockSpec((1, brows, 128), lambda i, j: (i, j, 0),
                                 memory_space=space), a)

    def kernel(*refs):
        if scratch_rows:
            out_ref, scratch = refs[-2], refs[-1]
            scratch[0, :] = jnp.zeros((scratch.shape[1],), jnp.float32)
        else:
            out_ref = refs[-1]
        out_ref[0] = jnp.zeros((qb, out_w), jnp.float32)

    return np.asarray(pl.pallas_call(
        kernel, grid=(DMA_HEADS, DMA_NQB), in_specs=specs,
        out_specs=pl.BlockSpec((1, qb, out_w), lambda i, j: (i, j, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((DMA_HEADS, lq, out_w), jnp.float32),
        scratch_shapes=([pltpu.VMEM((scratch_rows, 2048), jnp.float32)]
                        if scratch_rows else []),
        interpret=True)(*args))


def _words_sum(arrays, flags, passes):
    """numpy: passes x the sum of the case's 32-bit words, as int32."""
    picked = []
    if flags & msda_dma.VAL4:
        bf = np.asarray(jnp.asarray(arrays["val4"], jnp.bfloat16))
        picked.append(bf.view(np.uint16).reshape(-1, 2).copy()
                      .view(np.int32))
    if flags & msda_dma.DVM:
        picked.append(arrays["dvm"])
    if flags & msda_dma.W4:
        picked.append(arrays["w4"].view(np.int32))
    if flags & msda_dma.CODE:
        picked += arrays["code"]
    if flags & (msda_dma.DENSE | msda_dma.DSMEM):
        picked += arrays["dense"]
    total = passes * sum(int(a.astype(np.int64).sum()) for a in picked)
    return np.int64(total & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("case", msda_dma.CASES, ids=lambda c: c[0])
def test_dma_plain_matches_tpu_file(case):
    """Every case of main / main2 / main3: the zeros exactly, the checksum
    exactly (the file's 1-4 MB scratch cut to 8 rows)."""
    xp = _tool("xp_msda_dma")
    assert (xp.QB, xp.HEADS, xp.PASSES, xp.RBAND, xp.BROWS) == (
        msda_dma.QB, msda_dma.HEADS, msda_dma.PASSES, msda_dma.RBAND,
        msda_dma.BROWS)
    name, flags, out_w, passes, kb = case
    arrays = _dma_inputs(xp)
    want = _tpu_dma(xp, arrays, flags, out_w, 8 if kb else 0)
    inputs = {"val4": _t(arrays["val4"]).to(torch.bfloat16),
              "dvm": _t(arrays["dvm"]), "w4": _t(arrays["w4"]),
              "code": [_t(a) for a in arrays["code"]],
              "dense": [_t(a) for a in arrays["dense"]]}
    before = msda_dma.dma_bench.launches
    out, checksum = msda_dma.dma_bench(inputs, flags, out_w, passes, kb)
    assert msda_dma.dma_bench.launches == before
    np.testing.assert_array_equal(out.numpy(), want)
    assert checksum.dtype == torch.int32
    assert checksum.item() == int(_words_sum(arrays, flags, passes))


# ------------------------------------------------- gather (xp_msda_micro)

MICRO_HEADS, MICRO_RBAND = 2, 512


def _micro_inputs(qb, transposed, lqp, seed):
    """The file's inputs (its draws) at the cut geometry, numpy."""
    rng = np.random.default_rng(seed)
    s = msda_micro.S
    ncode = (lqp // qb + 7) // 8 * 8
    val4 = np.asarray(jnp.asarray(rng.standard_normal(
        (MICRO_HEADS, MICRO_RBAND, 128)), jnp.bfloat16).astype(jnp.float32))
    code = rng.integers(0, MICRO_RBAND - 128,
                        size=(MICRO_HEADS, ncode, 128)).astype(np.int32)
    if transposed:
        dvm = rng.integers(0, 128, size=(MICRO_HEADS, 8, lqp)).astype(
            np.int32)
        w4 = rng.standard_normal((MICRO_HEADS, 4 * s, lqp)).astype(
            np.float32)
    else:
        dvm = rng.integers(0, 128, size=(MICRO_HEADS, lqp, s)).astype(
            np.int32)
        w4 = rng.standard_normal((MICRO_HEADS, lqp, 4 * s)).astype(
            np.float32)
    return val4, code, dvm, w4


def _tpu_micro(xp, qb, transposed, lqp, val4, code, dvm, w4):
    """The file's `run` kernel body at the cut geometry, interpreted."""
    S, D4 = xp.S, xp.D4
    nqb = lqp // qb
    brows = qb * S // 128
    ex = jnp.asarray(np.eye(4 * S, S * D4)[:, :S * D4], jnp.bfloat16)
    smem_extra = jnp.zeros((MICRO_HEADS, lqp * S // 128, 128), jnp.int32)

    def kernel(code_ref, dvm_ref, g1, g2, g3, w4_ref, ex_ref, val4_ref,
               out_ref, w128_ref):
        exv = ex_ref[:]
        if transposed:
            w4v = w4_ref[0]
            hi = w4v.astype(jnp.bfloat16)
            w128_ref[:] = jax.lax.dot_general(
                hi, exv, (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32)
        else:
            w4v = w4_ref[0]
            hi = w4v.astype(jnp.bfloat16)
            w128_ref[:] = jnp.dot(hi, exv,
                                  preferred_element_type=jnp.float32)
        vdt = val4_ref.dtype
        io_l = jax.lax.broadcasted_iota(jnp.int32, (64, 128), 1)
        io_s = jax.lax.broadcasted_iota(jnp.int32, (128, 64), 0)
        jrow = jax.lax.rem(pl.program_id(1), 8)
        for g64 in range(qb // 64):
            q0 = g64 * 64
            if not transposed:
                dmat = dvm_ref[0, pl.ds(q0, 64), :]
            acc = jnp.zeros((64, D4), jnp.float32)
            for s in range(S):
                c = code_ref[0, jrow, g64 * S + s]
                base = pl.multiple_of(jnp.maximum(c, 0), 8)
                blk = val4_ref[0, pl.ds(base, 128), :]
                if transposed:
                    dl = dvm_ref[0, s, q0:q0 + 64]
                    ohT = (io_s == dl[None, :]).astype(vdt)
                    sel = jax.lax.dot_general(
                        ohT, blk, (((0,), (0,)), ((), ())),
                        preferred_element_type=jnp.float32)
                else:
                    delta = jax.lax.slice(dmat, (0, s), (64, s + 1))
                    oh = (io_l == delta).astype(vdt)
                    sel = jnp.dot(oh, blk, preferred_element_type=jnp.float32)
                acc = acc + sel * w128_ref[q0:q0 + 64, s * D4:(s + 1) * D4]
            out_ref[0, pl.ds(q0, 64), :] = acc

    smem = pl.BlockSpec((1, 8, 128), lambda i, j: (i, j // 8, 0),
                        memory_space=pltpu.SMEM)
    if transposed:
        dspec = pl.BlockSpec((1, 8, qb), lambda i, j: (i, 0, j),
                             memory_space=pltpu.VMEM)
        wspec = pl.BlockSpec((1, 4 * S, qb), lambda i, j: (i, 0, j),
                             memory_space=pltpu.VMEM)
    else:
        dspec = pl.BlockSpec((1, qb, S), lambda i, j: (i, j, 0),
                             memory_space=pltpu.VMEM)
        wspec = pl.BlockSpec((1, qb, 4 * S), lambda i, j: (i, j, 0),
                             memory_space=pltpu.VMEM)
    extras = [pl.BlockSpec((1, brows, 128), lambda i, j: (i, j, 0),
                           memory_space=pltpu.SMEM)] * 3
    out = pl.pallas_call(
        kernel, grid=(MICRO_HEADS, nqb),
        in_specs=[smem, dspec] + extras + [
            wspec,
            pl.BlockSpec((4 * S, S * D4), lambda i, j: (0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, MICRO_RBAND, D4), lambda i, j: (i, 0, 0),
                         memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, qb, D4), lambda i, j: (i, j, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((MICRO_HEADS, lqp, D4), jnp.float32),
        scratch_shapes=[pltpu.VMEM((qb, S * D4), jnp.float32)],
        interpret=True,
    )(jnp.asarray(code), jnp.asarray(dvm), smem_extra, smem_extra,
      smem_extra, jnp.asarray(w4), ex, jnp.asarray(val4, jnp.bfloat16))
    return np.asarray(out)


@pytest.mark.parametrize("qb,transposed", [(256, False), (256, True),
                                           (512, False), (1024, True)])
def test_micro_plain_matches_tpu_file(qb, transposed):
    xp = _tool("xp_msda_micro")
    assert (xp.S, xp.D4, xp.HEADS, xp.LQP, xp.RBAND) == (
        msda_micro.S, msda_micro.D4, msda_micro.HEADS, msda_micro.LQP,
        msda_micro.RBAND)
    lqp = qb * (2 if qb < 1024 else 1)
    val4, code, dvm, w4 = _micro_inputs(qb, transposed, lqp, seed=qb)
    want = _tpu_micro(xp, qb, transposed, lqp, val4, code, dvm, w4)
    ex = torch.eye(16, 512).to(torch.bfloat16)
    got = msda_micro.gather_bench(_t(val4).to(torch.bfloat16), _t(code),
                                  _t(dvm), _t(w4), ex, qb, transposed)
    assert got.shape == (MICRO_HEADS, lqp, 128)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_micro_layouts_agree_and_ex_is_checked():
    """The slot-major inputs transposed give the query-major result; a
    matrix that is not a selection matrix is refused for the kernel."""
    val4, code, dvm, w4 = _micro_inputs(256, False, 512, seed=3)
    ex = torch.eye(16, 512).to(torch.bfloat16)
    dvm_t = np.zeros((MICRO_HEADS, 8, 512), np.int32)
    dvm_t[:, :4] = dvm.transpose(0, 2, 1)
    a = msda_micro.gather_bench(_t(val4).to(torch.bfloat16), _t(code),
                                _t(dvm), _t(w4), ex, 256, False)
    b = msda_micro.gather_bench(_t(val4).to(torch.bfloat16), _t(code),
                                _t(dvm_t), _t(w4.transpose(0, 2, 1).copy()),
                                ex, 256, True)
    assert torch.equal(a, b)
    assert msda_micro.column_map(ex)[:16].tolist() == list(range(16))
    assert (msda_micro.column_map(ex)[16:] == -1).all()
    with pytest.raises(ValueError):
        msda_micro.column_map(ex * 2)
    with pytest.raises(ValueError):
        msda_micro.gather_bench(_t(val4).to(torch.bfloat16), _t(code),
                                _t(dvm), _t(w4), ex, 128, False)


# ------------------------------------------ products (xp_matmul_floor)

FLOOR_QB, FLOOR_NSTEP = 128, 2


def _tpu_floor(xp, rows, variant, lhs, rhs, wgt):
    """The file's `run` kernel at QB = 128, two steps, interpreted."""
    qb, slots = FLOOR_QB, xp.SLOTS

    def kernel(lhs_ref, rhs_ref, w_ref, out_ref):
        for c in range(qb // rows):
            q0 = c * rows
            if variant == "k512":
                acc = jnp.dot(lhs_ref[q0:q0 + rows, :], rhs_ref[:],
                              preferred_element_type=jnp.float32)
            else:
                lhs_t = lhs_ref[q0:q0 + rows, 0:128]
                acc = jnp.zeros((rows, 128), jnp.float32)
                for s in range(slots):
                    r0 = 0 if variant == "same" else s * 128
                    sel = jnp.dot(lhs_t, rhs_ref[r0:r0 + 128, :],
                                  preferred_element_type=jnp.float32)
                    if variant == "weight":
                        sel = sel * w_ref[q0:q0 + rows,
                                          s * 128:(s + 1) * 128]
                    acc = acc + sel
            out_ref[q0:q0 + rows, :] = acc

    return np.asarray(pl.pallas_call(
        kernel, grid=(FLOOR_NSTEP,),
        in_specs=[pl.BlockSpec((qb, 512), lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((slots * 128, 128), lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((qb, 512), lambda i: (0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((qb, 128), lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((qb, 128), jnp.float32),
        interpret=True)(lhs, rhs, wgt))


@pytest.mark.parametrize("rows,variant", [(64, "chain"), (128, "chain"),
                                          (64, "weight"), (64, "same"),
                                          (64, "k512")])
def test_floor_plain_matches_tpu_file(rows, variant):
    xp = _tool("xp_matmul_floor")
    assert (xp.QB, xp.NSTEP, xp.SLOTS) == (
        matmul_floor.QB, matmul_floor.NSTEP, matmul_floor.SLOTS)
    rng = np.random.default_rng(rows)
    lhs = jnp.asarray(rng.standard_normal((FLOOR_QB, 512)), jnp.bfloat16)
    rhs = jnp.asarray(rng.standard_normal((512, 128)), jnp.bfloat16)
    wgt = jnp.asarray(rng.standard_normal((FLOOR_QB, 512)), jnp.float32)
    want = _tpu_floor(xp, rows, variant, lhs, rhs, wgt)
    got = matmul_floor.floor_bench(
        _t(lhs.astype(jnp.float32)).to(torch.bfloat16),
        _t(rhs.astype(jnp.float32)).to(torch.bfloat16), _t(wgt), variant,
        rows)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("variant", matmul_floor.VARIANTS)
def test_floor_reference_steps_give_the_same_tile(variant):
    gen = torch.Generator().manual_seed(6)
    lhs, rhs, w = matmul_floor.make_inputs(gen, device="cpu", qb=64)
    one = matmul_floor.floor_reference(lhs, rhs, w, variant, nstep=1)
    three = matmul_floor.floor_reference(lhs, rhs, w, variant, nstep=3)
    assert torch.equal(one, three) and one.abs().max() > 1


def test_cpu_tensors_take_the_plain_versions_without_a_launch():
    gen = torch.Generator().manual_seed(5)
    counts = (matmul_floor.floor_bench.launches,
              msda_micro.gather_bench.launches, msda_dma.dma_bench.launches)
    lhs, rhs, w = matmul_floor.make_inputs(gen, device="cpu", qb=64)
    two = matmul_floor.floor_bench(lhs, rhs, w, "same")
    one = matmul_floor.floor_reference(lhs, rhs, w, "chain")
    assert torch.allclose(two, 4 * (lhs.float()[:, :128]
                                    @ rhs.float()[:128]), rtol=1e-5,
                          atol=1e-4)
    assert one.shape == (64, 128)
    inputs = msda_micro.make_inputs(256, True, gen, device="cpu", heads=1,
                                    lqp=256, rband=256)
    msda_micro.gather_bench(*inputs, 256, True)
    dma = msda_dma.make_inputs(gen, device="cpu", heads=1, nqb=2, rband=16)
    out, _ = msda_dma.dma_bench(dma, msda_dma.VAL4, 32, 1)
    assert out.shape == (1, 2 * msda_dma.QB, 32) and not out.any()
    assert counts == (matmul_floor.floor_bench.launches,
                      msda_micro.gather_bench.launches,
                      msda_dma.dma_bench.launches)
    with pytest.raises(ValueError):
        matmul_floor.floor_bench(lhs, rhs, w, "other")


# ------------------------------------------------------------ on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("case", msda_dma.CASES, ids=lambda c: c[0])
def test_dma_kernel_matches_plain_on_card(case):
    _card()
    name, flags, out_w, passes, kb = case
    gen = torch.Generator(device="cuda").manual_seed(1)
    inputs = msda_dma.make_inputs(gen, device="cuda", heads=2, nqb=5,
                                  rband=96)
    before = msda_dma.dma_bench.launches
    out, ck = msda_dma.dma_bench(inputs, flags, out_w, passes, kb)
    torch.cuda.synchronize()
    assert msda_dma.dma_bench.launches == before + passes
    ref, rck = msda_dma.dma_bench_reference(inputs, flags, out_w, passes)
    assert torch.equal(out, ref) and ck.item() == rck.item()


@pytest.mark.cuda
@pytest.mark.parametrize("qb", msda_micro.BLOCKS)
@pytest.mark.parametrize("transposed", [False, True])
def test_micro_kernel_matches_plain_on_card(qb, transposed):
    """Bit-equal: the same exact products summed in slot order in f32."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(qb)
    inputs = msda_micro.make_inputs(qb, transposed, gen, device="cuda",
                                    heads=2, lqp=2048, rband=1024)
    got = msda_micro.gather_bench(*inputs, qb, transposed)
    torch.cuda.synchronize()
    assert torch.equal(got, msda_micro.gather_reference(*inputs, qb,
                                                        transposed))


@pytest.mark.cuda
@pytest.mark.parametrize("name,rows,variant", matmul_floor.CASES)
def test_floor_kernel_matches_plain_on_card(name, rows, variant,
                                            monkeypatch):
    """Worst row relative L2 <= 1e-4 (chip_smoke.py's FLOOR_ROW_REL), the
    same tile bit for bit after 1, 3 and 600 steps and on repeat."""
    _card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator(device="cuda").manual_seed(2)
    lhs, rhs, w = matmul_floor.make_inputs(gen)
    before = matmul_floor.floor_bench.launches
    got = matmul_floor.floor_bench(lhs, rhs, w, variant, rows)
    steps = [matmul_floor.floor_bench(lhs, rhs, w, variant, rows, nstep=n)
             for n in (1, 3, matmul_floor.NSTEP)]
    torch.cuda.synchronize()
    assert matmul_floor.floor_bench.launches == before + 4
    assert all(torch.equal(got, s) for s in steps), name
    ref = matmul_floor.floor_reference(lhs, rhs, w, variant)
    rel = ((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max().item()
    assert rel <= 1e-4, name
