"""The port's multi-scale deformable attention vs the JAX package, f32 on the
CPU: the plain core vs JAX `ms_deform_attn_core` and the Pallas kernel in
interpret mode (atol 1e-5: f32, different summation order), and the
`MSDeformAttn` layer vs JAX `msda_layer(backend="xla")` with weights through
the bridge. The CUDA kernel itself is compared with the plain version by the
`cuda`-marked test on a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread, rand  # noqa: F401
from vlm_fo1_tpu.ops.msda import (
    ms_deform_attn_core as jax_core,
    msda_layer as jax_msda_layer,
    msda_layer_init,
)
from vlm_fo1_tpu.ops.msda_pallas import ms_deform_attn_core_fast
from vlm_fo1_tpu_torch.ops import msda
from vlm_fo1_tpu_torch.upn.convert import msda_state_dict

ATOL = 1e-5
SHAPES = ((6, 8), (3, 4), (2, 2))
S = sum(h * w for h, w in SHAPES)


def _core_inputs(seed, d, b=2, lq=13, m=2, p=4):
    """Locations in [-0.3, 1.3]: corners and whole windows fall outside."""
    rng = np.random.default_rng(seed)
    value = rand(rng, b, S, m, d)
    loc = rng.uniform(-0.3, 1.3, (b, lq, m, len(SHAPES), p, 2)).astype(
        np.float32)
    w = np.array(jax.nn.softmax(jnp.asarray(
        rand(rng, b, lq, m, len(SHAPES) * p)))).reshape(b, lq, m,
                                                        len(SHAPES), p)
    return value, loc, w


def _port(value, loc, w):
    return msda.ms_deform_attn_core(
        torch.from_numpy(value), SHAPES, torch.from_numpy(loc),
        torch.from_numpy(w)).numpy()


@pytest.mark.parametrize("d", [8, 32])
def test_plain_core_matches_jax_core(d):
    value, loc, w = _core_inputs(0, d)
    got = _port(value, loc, w)
    want = np.asarray(jax_core(jnp.asarray(value), SHAPES, jnp.asarray(loc),
                               jnp.asarray(w)))
    assert got.shape == (2, 13, 2 * d)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_core_matches_pallas_interpret(dtype):
    value, loc, w = _core_inputs(1, 32)
    jv = jnp.asarray(value, getattr(jnp, dtype))
    want = np.asarray(ms_deform_attn_core_fast(
        jv, SHAPES, jnp.asarray(loc), jnp.asarray(w), interpret=True, qb=16))
    tv = torch.from_numpy(np.array(jv.astype(jnp.float32)))
    got = msda.ms_deform_attn_core(tv.to(getattr(torch, dtype)), SHAPES,
                                   torch.from_numpy(loc),
                                   torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    value, loc, w = _core_inputs(2, 8, lq=5)
    before = msda.ms_deform_attn_core.launches
    _port(value, loc, w)
    assert msda.ms_deform_attn_core.launches == before


def test_unsupported_inputs_raise():
    value, loc, w = _core_inputs(3, 8, lq=5)
    v, lc, aw = (torch.from_numpy(x) for x in (value, loc, w))
    with pytest.raises(TypeError):
        msda.ms_deform_attn_core(v.double(), SHAPES, lc, aw)
    with pytest.raises(TypeError):
        msda.ms_deform_attn_core(v, SHAPES, lc.double(), aw)
    with pytest.raises(ValueError):
        msda.ms_deform_attn_core(v, SHAPES[:2], lc, aw)
    with pytest.raises(ValueError):
        msda.ms_deform_attn_core(v.to("meta"), SHAPES, lc.to("meta"),
                                 aw.to("meta"))


def _layer_case(seed, d_model=32, heads=4, points=2):
    """JAX layer params with non-zero sampling-offset weights (so the
    head-major permutation matters) and the bridged port layer."""
    params = msda_layer_init(jax.random.PRNGKey(seed), d_model, len(SHAPES),
                             heads, points)
    rng = np.random.default_rng(seed)
    params["sampling_offsets"]["w"] = jnp.asarray(
        rand(rng, *params["sampling_offsets"]["w"].shape) * 0.05)
    params["attention_weights"]["w"] = jnp.asarray(
        rand(rng, *params["attention_weights"]["w"].shape) * 0.1)
    np_params = jax.tree.map(np.asarray, params)
    layer = msda.MSDeformAttn(d_model, len(SHAPES), heads, points)
    layer.load_state_dict(msda_state_dict(np_params, heads, len(SHAPES),
                                          points), strict=True)
    return params, layer


@pytest.mark.parametrize("refs,norm4,masked", [
    (2, False, False), (2, False, True), (4, False, False), (4, True, True)])
def test_layer_matches_jax(refs, norm4, masked):
    params, layer = _layer_case(4)
    rng = np.random.default_rng(5)
    b, lq = 2, 11
    query = rand(rng, b, lq, 32)
    value = rand(rng, b, S, 32)
    ref = rng.uniform(0.05, 0.95, (b, lq, len(SHAPES), refs)).astype(
        np.float32)
    mask = (rng.random((b, S)) < 0.2) if masked else None
    want = np.asarray(jax_msda_layer(
        params, jnp.asarray(query), jnp.asarray(ref), jnp.asarray(value),
        SHAPES, 4, 2, None if mask is None else jnp.asarray(mask),
        use_4d_normalizer=norm4, backend="xla"))
    with torch.no_grad():
        got = layer(torch.from_numpy(query), torch.from_numpy(ref),
                    torch.from_numpy(value), SHAPES,
                    None if mask is None else torch.from_numpy(mask),
                    use_4d_normalizer=norm4).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_offsets_are_head_major():
    """The port's sampling_offsets rows follow (head, level, point, coord):
    moving head 1's rows moves only head 1's output channels (the output
    projection is set to the identity to read the core's output)."""
    _, layer = _layer_case(6)
    rng = np.random.default_rng(7)
    query = torch.from_numpy(rand(rng, 1, 3, 32))
    value = torch.from_numpy(rand(rng, 1, S, 32))
    ref = torch.full((1, 3, len(SHAPES), 2), 0.5)
    with torch.no_grad():
        layer.output_proj.weight.copy_(torch.eye(32))
        layer.output_proj.bias.zero_()
        before = layer(query, ref, value, SHAPES)
        rows = len(SHAPES) * 2 * 2                 # one head's rows
        layer.sampling_offsets.bias[rows:2 * rows] += 3.0
        after = layer(query, ref, value, SHAPES)
    diff = (after - before).abs().reshape(3, 4, 8).amax(dim=(0, 2))
    assert diff[1] > 0 and diff[0] == diff[2] == diff[3] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 32])
def test_kernel_matches_plain_on_card(d, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    value, loc, w = _core_inputs(8, d)
    dt = getattr(torch, dtype)
    v = torch.from_numpy(value).cuda().to(dt)
    lc, aw = torch.from_numpy(loc).cuda(), torch.from_numpy(w).cuda()
    before = msda.ms_deform_attn_core.launches
    out = msda.ms_deform_attn_core(v, SHAPES, lc, aw)
    torch.cuda.synchronize()
    assert msda.ms_deform_attn_core.launches == before + 1
    ref = msda.ms_deform_attn_core_reference(v.float(), SHAPES, lc, aw)
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out, ref, atol=tol, rtol=0)


def _card_inputs(shapes, lq, d, dtype, case, seed, b=1, m=8, p=4):
    """CUDA inputs: locations uniform in [-0.1, 1.1] ("random") or on cell
    edges ("edges": pixel centres plus whole-pixel offsets, where
    loc * W - 0.5 is an integer or one rounding from it)."""
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
    return value, loc.contiguous(), aw.reshape(b, lq, m, nl, p).contiguous()


def _worst_row_rel(out, ref, d):
    diff = (out - ref).reshape(-1, d).norm(dim=-1)
    norm = ref.reshape(-1, d).norm(dim=-1)
    return (diff / norm.clamp_min(1e-3 * norm.mean().item())
            .clamp_min(1e-30)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lq", [37, 900])
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128, 12, 20])
def test_kernel_widths_and_launch_sizes_on_card(d, lq, dtype, monkeypatch):
    """Every channel group width (D = 8 .. 128: 1 to 16 lanes; D = 12, 20
    take the scalar channel loads, a lane's last channels cut short), Lq
    not a multiple of a block's queries (37), and the decoder-sized launch
    (900 queries, samples split over more lanes): worst row (one query of
    one head) relative L2 <= 1e-4 against the plain version on the same
    values (chip_smoke.py's MSDA_ROW_REL)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    shapes = ((12, 15), (6, 8), (3, 4))
    v, lc, aw = _card_inputs(shapes, lq, d, dtype, "random", seed=d + lq)
    out = msda.ms_deform_attn_core(v, shapes, lc, aw)
    torch.cuda.synchronize()
    ref = msda.ms_deform_attn_core_reference(v.float(), shapes, lc, aw)
    assert _worst_row_rel(out, ref, d) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "edges"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_encoder_layout_on_card(case, dtype, monkeypatch):
    """The UPN encoder's layout at a cut size (five levels of a 224x288
    input, Lq = S = 5375, 8 heads, D = 32), with uniform samples and with
    samples on cell edges, where the kernel must pick the plain version's
    cell."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    shapes = ((56, 72), (28, 36), (14, 18), (7, 9), (4, 5))
    s = sum(h * w for h, w in shapes)
    v, lc, aw = _card_inputs(shapes, s, 32, dtype, case, seed=11)
    out = msda.ms_deform_attn_core(v, shapes, lc, aw)
    torch.cuda.synchronize()
    ref = msda.ms_deform_attn_core_reference(v.float(), shapes, lc, aw)
    assert _worst_row_rel(out, ref, 32) <= 1e-4
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


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
def test_kernel_unaligned_value_on_card(d, dtype, monkeypatch):
    """A value tensor whose data pointer is off 16-byte alignment (a
    contiguous view one element into its storage) takes the scalar channel
    loads, at the decoder-sized launch: worst row relative L2 <= 1e-4
    against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    shapes = ((12, 15), (6, 8), (3, 4))
    v, lc, aw = _card_inputs(shapes, 900, d, dtype, "random", seed=d + 5)
    v = _offset_view(v)
    assert v.is_contiguous() and v.data_ptr() % 16
    out = msda.ms_deform_attn_core(v, shapes, lc, aw)
    torch.cuda.synchronize()
    ref = msda.ms_deform_attn_core_reference(v.float(), shapes, lc, aw)
    assert _worst_row_rel(out, ref, d) <= 1e-4
