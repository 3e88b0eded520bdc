"""Gradients through the port's multi-scale deformable attention and UPN vs
the JAX package, f32 on the CPU:

- the core's three gradients (value, sampling locations, attention weights)
  against `jax.vjp` of JAX `ms_deform_attn_core`, on the grid-structured and
  the random / out-of-range geometries of tests/test_msda.py, D in {8, 32},
  atol 2e-4 / rtol 1e-4 as there; `ms_deform_attn_core_backward` (the plain
  version of the backward kernel on the CPU) gives the same (the Pallas
  backward kernel in interpret mode takes 100 s for even 24 queries, so
  tests/test_msda.py alone holds it against the same `jax.vjp`);
- the `MSDeformAttn` layer's parameter gradients against `jax.grad` of
  `msda_layer(backend="xla")`, mapped through `upn/convert.py` (the map is
  linear, so it carries gradients as it carries weights);
- tiny UPN's parameter gradients against `jax.grad` of `upn_forward` at the
  256x256 geometry whose whole top-k lies in the border-anchor tie group:
  the selected anchors' inf coordinates go through sigmoid and
  inverse_sigmoid, and every gradient must come out finite and equal;
- the three forward-only kernel wrappers refuse a gradient.

The CUDA backward kernel itself is compared with its plain version by the
`cuda`-marked test on a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_upn import (
    J_SWIN,
    J_UPN,
    PROMPT,
    _image,
    _port_upn,
    _tie_weights,
)
from torch_parity import one_torch_thread, rand, to_numpy  # noqa: F401
from vlm_fo1_tpu.ops.msda import (
    ms_deform_attn_core as jax_core,
    msda_layer as jax_msda_layer,
    msda_layer_init,
)
from vlm_fo1_tpu.upn.model import init_upn_params, upn_forward
from vlm_fo1_tpu_torch.ops import msda
from vlm_fo1_tpu_torch.ops.flash_attention import flash_attention
from vlm_fo1_tpu_torch.ops.int4_matmul import int4_matmul
from vlm_fo1_tpu_torch.ops.int4_mlp import KEYS, int4_mlp
from vlm_fo1_tpu_torch.upn.convert import (
    msda_state_dict,
    upn_state_dict_from_jax_params,
)

ATOL, RTOL = 2e-4, 1e-4  # tests/test_msda.py's backward tolerance
SHAPES = ((10, 12), (5, 6))
S = sum(h * w for h, w in SHAPES)


def _core_case(case, d, seed, b=1, lq=131, m=2, p=2):
    """tests/test_msda.py's backward geometries: near-grid queries, or
    locations in [-0.2, 1.2] (corners and whole windows off the map); and
    locations on cell edges."""
    rng = np.random.default_rng(seed)
    nl = len(SHAPES)
    if case == "grid":
        xs = (np.arange(lq) % 12 + 0.5) / 12
        ys = (np.arange(lq) // 12 + 0.5) / 10
        base = np.stack([xs, ys], -1)[None, :, None, None, None]
        loc = np.broadcast_to(base, (b, lq, m, nl, p, 2)).astype(
            np.float32).copy()
        loc += rng.uniform(-0.02, 0.02, loc.shape).astype(np.float32)
    elif case == "edges":
        # pixel centres plus whole-pixel offsets, as UPN's encoder samples
        # (random-init offsets): loc * W - 0.5 is an integer or one rounding
        # from it, where the location gradient jumps
        wh = np.array(SHAPES, np.float32)[:, None, ::-1]         # [L, 1, 2]
        k = rng.integers(-2, 13, (b, lq, m, nl, p, 2))
        loc = ((k + 0.5) / wh).astype(np.float32)
    else:
        loc = rng.uniform(-0.2, 1.2, (b, lq, m, nl, p, 2)).astype(np.float32)
    aw = np.asarray(jax.nn.softmax(jnp.asarray(rand(rng, b, lq, m, nl * p)))
                    ).reshape(b, lq, m, nl, p)
    value = rand(rng, b, S, m, d)
    g = rand(rng, b, lq, m * d)
    return value, loc, aw, g


def _jax_vjp(value, loc, aw, g):
    _, vjp = jax.vjp(lambda v, lc, a: jax_core(v, SHAPES, lc, a),
                     jnp.asarray(value), jnp.asarray(loc), jnp.asarray(aw))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _assert_grads(got, want, names=("grad_value", "grad_loc", "grad_aw")):
    for gt, wt, name in zip(got, want, names):
        np.testing.assert_allclose(gt, wt, atol=ATOL, rtol=RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("d", [8, 32])
@pytest.mark.parametrize("case", ["grid", "random", "edges"])
def test_core_gradients_match_jax_vjp(case, d):
    value, loc, aw, g = _core_case(case, d, seed=d)
    want = _jax_vjp(value, loc, aw, g)
    v, lc, a = (torch.from_numpy(x.copy()).requires_grad_(True)
                for x in (value, loc, aw))
    out = msda.ms_deform_attn_core(v, SHAPES, lc, a)
    out.backward(torch.from_numpy(g))
    _assert_grads([x.grad.numpy() for x in (v, lc, a)], want)
    # the plain version of the backward kernel: the same three gradients
    got = msda.ms_deform_attn_core_backward(
        torch.from_numpy(value), SHAPES, torch.from_numpy(loc),
        torch.from_numpy(aw), torch.from_numpy(g))
    assert [x.dtype for x in got] == [torch.float32] * 3
    _assert_grads([x.numpy() for x in got], want)
    if case == "random":  # samples whose whole window is off the map
        x = loc[..., 0] * np.array([w for _, w in SHAPES])[:, None] - 0.5
        off = (np.floor(x) < -1) | (np.floor(x) > np.array(
            [w - 1 for _, w in SHAPES])[:, None])
        assert off.any()
        assert (got[1].numpy()[off] == 0).all()
        assert (got[2].numpy()[off] == 0).all()


def test_backward_keeps_value_dtype_and_checks_grad_output():
    value, loc, aw, g = _core_case("random", 8, seed=4, lq=5)
    args = (torch.from_numpy(value).bfloat16(), SHAPES,
            torch.from_numpy(loc), torch.from_numpy(aw))
    gv, gl, ga = msda.ms_deform_attn_core_backward(*args,
                                                   torch.from_numpy(g))
    assert (gv.dtype, gl.dtype, ga.dtype) == (torch.bfloat16, torch.float32,
                                              torch.float32)
    before = msda.ms_deform_attn_core_backward.launches
    with pytest.raises(ValueError):
        msda.ms_deform_attn_core_backward(*args, torch.from_numpy(g[:, 1:]))
    with pytest.raises(ValueError):
        msda.ms_deform_attn_core_backward(*args,
                                          torch.from_numpy(g).double())
    assert msda.ms_deform_attn_core_backward.launches == before


def test_layer_parameter_gradients_match_jax():
    d_model, heads, points = 32, 4, 2
    params = msda_layer_init(jax.random.PRNGKey(5), d_model, len(SHAPES),
                             heads, points)
    rng = np.random.default_rng(5)
    for name, scale in (("sampling_offsets", 0.05),
                        ("attention_weights", 0.1)):
        params[name]["w"] = jnp.asarray(
            rand(rng, *params[name]["w"].shape) * scale)
    b, lq = 2, 11
    query = rand(rng, b, lq, d_model)
    value = rand(rng, b, S, d_model)
    ref = rng.uniform(0.05, 0.95, (b, lq, len(SHAPES), 2)).astype(np.float32)
    mask = rng.random((b, S)) < 0.2
    cot = rand(rng, b, lq, d_model)

    def jloss(p):
        out = jax_msda_layer(p, jnp.asarray(query), jnp.asarray(ref),
                             jnp.asarray(value), SHAPES, heads, points,
                             jnp.asarray(mask), backend="xla")
        return jnp.sum(out * cot)

    want = msda_state_dict(to_numpy(jax.grad(jloss)(params)), heads,
                           len(SHAPES), points)
    layer = msda.MSDeformAttn(d_model, len(SHAPES), heads, points)
    layer.load_state_dict(msda_state_dict(to_numpy(params), heads,
                                          len(SHAPES), points), strict=True)
    out = layer(torch.from_numpy(query), torch.from_numpy(ref),
                torch.from_numpy(value), SHAPES, torch.from_numpy(mask))
    (out * torch.from_numpy(cot)).sum().backward()
    for name, p in layer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=name)


def test_upn_parameter_gradients_match_jax_on_border_anchors():
    """d/dparams of sum(pred_boxes * cb) + sum(pred_logits * cl) at the
    256x256 geometry: the top-k is wholly inside the tie group of invalid
    border anchors, whose inf coordinates meet sigmoid and
    inverse_sigmoid."""
    params = _tie_weights(init_upn_params(jax.random.PRNGKey(2), J_UPN,
                                          J_SWIN))
    image, hw = _image(4, 256, 256, (256, 256))
    rng = np.random.default_rng(11)
    cb = rand(rng, 1, J_UPN.num_queries, 4)
    cl = rand(rng, 1, J_UPN.num_queries, 1)

    def jloss(p):
        out = upn_forward(p, J_UPN, J_SWIN, jnp.asarray(image),
                          jnp.asarray(hw), PROMPT)
        return (jnp.sum(out["pred_boxes"] * cb)
                + jnp.sum(out["pred_logits"] * cl))

    want = upn_state_dict_from_jax_params(
        to_numpy(jax.jit(jax.grad(jloss))(params)), *_cfgs())
    model = _port_upn(params).requires_grad_(True)
    out = model.predict(torch.from_numpy(image), torch.from_numpy(hw),
                        PROMPT)
    loss = ((out["pred_boxes"] * torch.from_numpy(cb)).sum()
            + (out["pred_logits"] * torch.from_numpy(cl)).sum())
    loss.backward()
    grads = dict(model.named_parameters())
    assert set(grads) <= set(want)
    scale = max(np.abs(w.numpy()).max() for w in want.values())
    for name, p in grads.items():
        w = want[name].numpy()
        g = p.grad.numpy() if p.grad is not None else np.zeros_like(w)
        assert np.isfinite(g).all(), name
        # f32 through Swin, 2 encoder and 2 decoder layers: 1e-4 of the
        # largest gradient magnitude
        np.testing.assert_allclose(g, w, atol=1e-4 * max(1.0, scale),
                                   rtol=1e-3, err_msg=name)
    # the gradient reached the deformable attention through both stacks
    for stack in ("encoder", "decoder"):
        attn = "self_attn" if stack == "encoder" else "cross_attn"
        g = grads[f"transformer.{stack}.layers.0.{attn}.value_proj.weight"]
        assert g.grad is not None and g.grad.abs().max() > 0


def _cfgs():
    from torch_parity import port_config

    return port_config(J_UPN), port_config(J_SWIN)


@pytest.mark.parametrize("wrapper", ["flash_attention", "int4_matmul",
                                     "int4_mlp"])
def test_forward_only_kernels_refuse_gradients(wrapper):
    """With grad mode on and an input that requires a gradient, each
    forward-only wrapper raises (before its device dispatch, so here on the
    CPU too) instead of returning an output without a grad_fn; without a
    gradient it runs."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rand(rng, 4, 16))
    packed = torch.from_numpy(rng.integers(-128, 128, (8, 16), np.int8))
    scale = torch.ones(16)
    if wrapper == "flash_attention":
        q = torch.from_numpy(rand(rng, 1, 2, 4, 16))

        def call(t):
            return flash_attention(t, q, q)
        x = q
    elif wrapper == "int4_matmul":
        def call(t):
            return int4_matmul(t, packed, scale)
    else:
        node = dict(zip(KEYS, (packed, scale, packed, scale,
                               packed.t().contiguous(), torch.ones(16))))

        def call(t):
            return int4_mlp(t, node)
    with torch.no_grad():
        want = call(x.clone().requires_grad_(True))
    with pytest.raises(RuntimeError, match="forward-only"):
        call(x.clone().requires_grad_(True))
    torch.testing.assert_close(call(x), want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "edges"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 32])
def test_backward_kernel_matches_plain_on_card(d, dtype, case, monkeypatch):
    """The CUDA backward kernel against its plain version on the card, and
    through `MSDeformAttnFunction` (one forward and one backward launch).
    f32 with TF32 off: 1e-4 (float32 atomics sum grad_value in no fixed
    order); bf16 value: grad_value is rounded to bf16, 2e-2. On cell edges
    the kernel must pick the plain version's cell."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    value, loc, aw, g = _core_case(case, d, seed=13)
    dt = getattr(torch, dtype)
    v = torch.from_numpy(value).cuda().to(dt)
    lc, a, gc = (torch.from_numpy(x).cuda() for x in (loc, aw, g))
    got = msda.ms_deform_attn_core_backward(v, SHAPES, lc, a, gc)
    torch.cuda.synchronize()
    want = msda.ms_deform_attn_core_backward_reference(v, SHAPES, lc, a, gc)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for x, y in zip(got, want):
        assert x.dtype == y.dtype
        torch.testing.assert_close(x.float(), y.float(), atol=tol, rtol=0)
    leaves = [t.clone().requires_grad_(True) for t in (v, lc, a)]
    f0 = msda.ms_deform_attn_core.launches
    b0 = msda.ms_deform_attn_core_backward.launches
    out = msda.ms_deform_attn_core(*leaves[:1], SHAPES, *leaves[1:])
    out.backward(gc)
    torch.cuda.synchronize()
    assert msda.ms_deform_attn_core.launches == f0 + 1
    assert msda.ms_deform_attn_core_backward.launches == b0 + 1
    for leaf, y in zip(leaves, want):
        torch.testing.assert_close(leaf.grad.float(), y.float(), atol=tol,
                                   rtol=0)


def _card_inputs(shapes, lq, d, dtype, case, seed, b=1, m=8, p=4):
    """CUDA inputs and a seeded upstream gradient: locations uniform in
    [-0.1, 1.1] or on cell edges (pixel centres plus whole-pixel
    offsets)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    s = sum(h * w for h, w in shapes)
    nl = len(shapes)
    value = torch.randn(b, s, m, d, device="cuda", generator=gen).to(
        getattr(torch, dtype))
    if case == "edges":
        wh = torch.tensor([[w, h] for h, w in shapes], device="cuda",
                          dtype=torch.float32)[:, None, :]
        k = torch.randint(-2, 13, (b, lq, m, nl, p, 2), device="cuda",
                          generator=gen)
        loc = (k + 0.5) / wh
    else:
        loc = -0.1 + 1.2 * torch.rand(b, lq, m, nl, p, 2, device="cuda",
                                      generator=gen)
    aw = torch.softmax(torch.randn(b, lq, m, nl * p, device="cuda",
                                   generator=gen), -1)
    g = torch.randn(b, lq, m * d, device="cuda", generator=gen)
    return (value, loc.contiguous(),
            aw.reshape(b, lq, m, nl, p).contiguous(), g)


def _assert_card_grads(value, shapes, loc, aw, g):
    """Each gradient within 1e-4 x max(1, max|plain|) (grad_value in bf16:
    2e-2), as chip_smoke.py phase 13."""
    got = msda.ms_deform_attn_core_backward(value, shapes, loc, aw, g)
    torch.cuda.synchronize()
    want = msda.ms_deform_attn_core_backward_reference(value.float(),
                                                       shapes, loc, aw, g)
    for k, (x, y) in enumerate(zip(got, want)):
        bf16 = k == 0 and value.dtype == torch.bfloat16
        tol = (2e-2 if bf16 else 1e-4) * max(1.0, y.abs().max().item())
        assert x.dtype == (value.dtype if k == 0 else torch.float32)
        torch.testing.assert_close(x.float(), y, atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lq", [37, 900])
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128, 12, 20])
def test_backward_kernel_widths_and_launch_sizes_on_card(d, lq, dtype,
                                                         monkeypatch):
    """Every channel group width (D = 8 .. 128; the vector reductions on
    two channel quads; D = 12, 20 take the scalar loads and float32
    atomics), Lq not a multiple of a block's queries (37), and the
    decoder-sized launch (900 queries, samples split over more lanes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    shapes = ((12, 15), (6, 8), (3, 4))
    _assert_card_grads(*_with_shapes(shapes, *_card_inputs(
        shapes, lq, d, dtype, "random", seed=d + lq)))


def _with_shapes(shapes, value, loc, aw, g):
    return value, shapes, loc, aw, g


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "edges"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_encoder_layout_on_card(case, dtype, monkeypatch):
    """The UPN encoder's layout at a cut size (five levels of a 224x288
    input, Lq = S = 5375, 8 heads, D = 32), uniform and cell-edge
    samples."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    shapes = ((56, 72), (28, 36), (14, 18), (7, 9), (4, 5))
    s = sum(h * w for h, w in shapes)
    _assert_card_grads(*_with_shapes(shapes, *_card_inputs(
        shapes, s, 32, dtype, case, seed=12)))


def _offset_view(t):
    """t's values in a contiguous view one element into a larger storage,
    so that its data pointer is off 16-byte alignment."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [12, 32])
def test_backward_kernel_unaligned_inputs_on_card(d, dtype, monkeypatch):
    """value and the upstream gradient as contiguous views off 16-byte
    alignment take the scalar channel loads and scalar float32 atomics, at
    the decoder-sized launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    shapes = ((12, 15), (6, 8), (3, 4))
    value, loc, aw, g = _card_inputs(shapes, 900, d, dtype, "random",
                                     seed=d + 6)
    value, g = _offset_view(value), _offset_view(g)
    assert value.data_ptr() % 16 and g.data_ptr() % 16
    _assert_card_grads(value, shapes, loc, aw, g)
