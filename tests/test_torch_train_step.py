"""The port's training vs the JAX package on `FO1Config.tiny()`, f32 on the
CPU, weights bridged by `convert.state_dict_from_jax_params` (a linear map,
so it carries gradients as it carries weights), on the batch of
tests/test_sharding.py (`__graft_entry__._build_inputs`: a 112x112 image,
4 boxes):

- `multimodal_lm_loss` against the JAX function (rtol 1e-5) and every
  parameter gradient against `jax.grad` (atol 1e-5 x the largest gradient:
  f32 through the ViT, DaViT, HFRE and a two-layer trunk, summed in
  another order);
- one AdamW step: `training.train_step.adamw` fed the JAX gradients against
  `optax.adamw(1e-4)` (atol 1e-7), and a whole `make_train_step` step
  against optax where the gradient is far from zero;
- remat on and off: equal loss and gradients;
- checkpoints: a save / restore round trip of model and optimizer,
  `latest_checkpoint`, and the safetensors export read back by
  `safetensors.numpy.load_file` and by the port's own reader."""

import dataclasses
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import one_torch_thread, port_config, to_numpy  # noqa: F401
from vlm_fo1_tpu.config import FO1Config
from vlm_fo1_tpu.models.fo1 import FO1Model as JaxFO1Model
from vlm_fo1_tpu.training.train_step import multimodal_lm_loss as jax_loss
from vlm_fo1_tpu_torch.convert import state_dict_from_jax_params
from vlm_fo1_tpu_torch.models.fo1 import FO1Model
from vlm_fo1_tpu_torch.training import checkpointing as ckpt
from vlm_fo1_tpu_torch.training.train_step import (
    adamw,
    make_train_step,
    multimodal_lm_loss,
)

JCFG = FO1Config.tiny()
CFG = port_config(JCFG)
LR = 1e-4


@pytest.fixture(scope="module")
def case():
    """JAX params, the batch as numpy arrays, loss kwargs, and the JAX loss
    and gradients."""
    import __graft_entry__ as g

    jm = JaxFO1Model.random_init(JCFG, seed=0)
    prep = g._build_inputs(JCFG, image_hw=(112, 112), n_boxes=4,
                           prompt_extra=8)
    plan, info = prep["plan"], prep["splice"]
    rng = np.random.default_rng(0)
    labels = rng.integers(0, JCFG.text.vocab_size, size=(1, info.seq_len))
    labels[0, :5] = -100  # ignored positions
    batch = {
        "patches": np.asarray(prep["pixel_values"], np.float32)[
            plan.gather_idx][None],
        "rot_cos": np.asarray(plan.rot_cos), "rot_sin": np.asarray(plan.rot_sin),
        "valid": np.asarray(plan.valid),
        "inv_unit_idx": np.asarray(plan.inv_unit_idx),
        "inv_token_idx": np.asarray(plan.inv_token_idx),
        "aux_image": np.asarray(prep["aux"], np.float32).transpose(
            1, 2, 0)[None],
        "aux_boxes": np.asarray(prep["aux_boxes"])[None],
        "vt_boxes": np.asarray(prep["vt_boxes"])[None],
        "input_ids": np.asarray(info.input_ids)[None],
        "image_positions": np.asarray(info.image_positions)[None],
        "region_positions": np.asarray(info.region_positions)[None],
        "position_ids": np.asarray(prep["position_ids"]),
        "labels": labels,
    }
    kw = dict(num_windows=plan.num_windows,
              grid=tuple(int(x) for x in prep["grid"]))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(lambda p: jax.value_and_grad(jax_loss)(
        p, JCFG, jbatch, **kw))(jm.params)
    return jm.params, batch, kw, float(loss), grads


def _port_model(params):
    model = FO1Model(CFG, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(to_numpy(params), CFG),
                          strict=True)
    return model.requires_grad_(True)


def _port_grads(params, batch, kw, remat=False):
    model = _port_model(params)
    loss = multimodal_lm_loss(model, batch, remat=remat, **kw)
    loss.backward()
    return model, loss, {n: p.grad for n, p in model.named_parameters()}


def test_loss_and_gradients_match_jax(case):
    params, batch, kw, jloss, jgrads = case
    _, loss, grads = _port_grads(params, batch, kw)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    want = state_dict_from_jax_params(to_numpy(jgrads), CFG)
    assert set(grads) == set(want)
    scale = max(np.abs(w.numpy()).max() for w in want.values())
    for name, g in grads.items():
        assert g is not None, f"{name} took no gradient"
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   atol=1e-5 * scale, rtol=1e-4,
                                   err_msg=name)
    # every tower took a gradient
    for prefix in ("vision_tower.", "vision_tower_aux.", "text.",
                   "mm_projector.", "mm_projector_aux."):
        assert any(g.abs().max() > 0 for n, g in grads.items()
                   if n.startswith(prefix)), prefix


def test_adamw_matches_optax(case):
    """The same gradients in, the same parameters out: the optimizer alone
    (two steps, so the moments and the bias correction count)."""
    params, _, _, _, jgrads = case
    opt = optax.adamw(LR)

    @jax.jit
    def jstep(g, state, p):
        updates, state = opt.update(g, state, p)
        return optax.apply_updates(p, updates), state

    state = opt.init(params)
    jp = params
    model = _port_model(params)
    tgrads = state_dict_from_jax_params(to_numpy(jgrads), CFG)
    topt = adamw(model.parameters(), lr=LR)
    for step in range(2):
        g = jax.tree.map(lambda x: x * (1.0 + step), jgrads)
        jp, state = jstep(g, state, jp)
        for n, p in model.named_parameters():
            p.grad = tgrads[n] * (1.0 + step)
        topt.step()
    want = state_dict_from_jax_params(to_numpy(jp), CFG)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   atol=1e-7, rtol=1e-6, err_msg=n)
    moments = [topt.state[p]["exp_avg"].dtype for p in model.parameters()]
    assert set(moments) == {torch.float32}


def test_train_step_matches_optax_step(case):
    """One `make_train_step` step: the loss it returns is the JAX loss, and
    where the gradient is far from zero (so that a last-bit difference in
    it cannot flip the Adam direction) the new parameters are optax's."""
    params, batch, kw, jloss, jgrads = case
    model = _port_model(params)
    step = make_train_step(model, adamw(model.parameters(), lr=LR), **kw)
    loss = step(batch)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    opt = optax.adamw(LR)
    new = jax.jit(lambda g, p: optax.apply_updates(
        p, opt.update(g, opt.init(p), p)[0]))(jgrads, params)
    want = state_dict_from_jax_params(to_numpy(new), CFG)
    old = state_dict_from_jax_params(to_numpy(params), CFG)
    g = state_dict_from_jax_params(to_numpy(jgrads), CFG)
    moved = 0
    for n, p in model.named_parameters():
        big = np.abs(g[n].numpy()) > 1e-4
        got = p.detach().numpy()
        np.testing.assert_allclose(got[big], want[n].numpy()[big],
                                   atol=1e-7, rtol=0, err_msg=n)
        # elsewhere Adam moves a parameter by at most lr (1 + wd |p|)
        bound = LR * (1 + 1e-4 * np.abs(old[n].numpy())) * 1.0001
        assert (np.abs(got - old[n].numpy()) <= bound).all(), n
        moved += int(big.sum())
    assert moved > 0


def test_remat_gives_equal_loss_and_gradients(case):
    params, batch, kw, _, _ = case
    _, l0, g0 = _port_grads(params, batch, kw, remat=False)
    _, l1, g1 = _port_grads(params, batch, kw, remat=True)
    np.testing.assert_allclose(l1.item(), l0.item(), rtol=1e-6)
    for n in g0:
        np.testing.assert_allclose(g1[n].numpy(), g0[n].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=n)


def test_checkpoint_round_trip(case, tmp_path):
    params, batch, kw, _, _ = case
    model = _port_model(params)
    opt = adamw(model.parameters(), lr=LR)
    step = make_train_step(model, opt, **kw)
    step(batch)
    d = str(tmp_path / "ckpts")
    assert ckpt.latest_checkpoint(d) is None
    p1 = ckpt.save_checkpoint(d, 1, model, opt, extra={"note": "first"})
    step(batch)
    p2 = ckpt.save_checkpoint(d, 2, model, opt)
    p2_again = ckpt.save_checkpoint(d, 2, model, opt)  # replaces step 2
    assert p2_again == p2 and ckpt.latest_checkpoint(d) == p2
    assert sorted(os.listdir(d)) == ["step_1", "step_2"]

    fresh = _port_model(params)
    fresh_opt = adamw(fresh.parameters(), lr=LR)
    meta = ckpt.restore_checkpoint(p1, fresh, fresh_opt)
    assert meta == {"step": 1, "extra": {"note": "first"}}
    # resuming from step 1 repeats step 2 exactly
    make_train_step(fresh, fresh_opt, **kw)(batch)
    for (n, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
    with pytest.raises(ValueError):
        ckpt.restore_checkpoint(ckpt.save_checkpoint(d, 3, model), fresh,
                                fresh_opt)


def test_safetensors_export(tmp_path):
    from safetensors.numpy import load_file

    model = FO1Model.random_init(CFG, seed=1, device="cpu")
    path = str(tmp_path / "params.safetensors")
    ckpt.save_params_safetensors(path, model)
    flat = load_file(path)
    sd = model.state_dict()
    assert set(flat) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(flat[k], v.numpy(), err_msg=k)
    mixed = {"w": torch.randn(3, 5).bfloat16(), "i": torch.arange(4),
             "s": torch.tensor(2.5), "m": torch.tensor([True, False])}
    ckpt.save_params_safetensors(path, mixed)
    back = ckpt.load_params_safetensors(path)
    for k, v in mixed.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def test_loss_on_a_prepared_prompt_matches_the_serving_forward():
    """`batch_from_prepared` over `FO1Model.prepare`, through the training
    forward (differentiable attention, no KV cache), gives the cross-entropy of
    the serving forward's logits (encode, splice, the cached trunk with the
    flash kernel's plain version) on the same prompt."""
    from PIL import Image

    from conftest import StubTokenizer
    from vlm_fo1_tpu_torch.models.llm import init_kv_cache, mrope_cos_sin
    from vlm_fo1_tpu_torch.task_templates import OD_template
    from vlm_fo1_tpu_torch.training.train_step import batch_from_prepared

    # the full vocabulary: the chat template's ids are the real ones
    cfg = dataclasses.replace(CFG, text=dataclasses.replace(
        CFG.text, vocab_size=151936))
    model = FO1Model.random_init(cfg, seed=3, device="cpu",
                                 tokenizer=StubTokenizer())
    rng = np.random.default_rng(3)
    img = Image.fromarray(rng.integers(0, 255, (120, 160, 3), np.uint8))
    msgs = [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": img}},
        {"type": "text", "text": OD_template.format("cup")}],
        "bbox_list": [[5.0, 5.0, 60.0, 70.0], [40.0, 20.0, 150.0, 110.0]]}]
    prep = model.prepare(msgs, max_pixels=128 * 128)
    batch = batch_from_prepared(cfg, prep)
    labels = torch.from_numpy(batch["labels"][0])
    assert (labels == -100).sum() == len(prep["splice"].image_positions) + 2
    loss = multimodal_lm_loss(model, batch, num_windows=prep["plan"]
                              .num_windows, grid=prep["grid"], remat=True)
    with torch.no_grad():
        emb = model.splice(prep, *model.encode(prep))
        cos, sin = mrope_cos_sin(
            torch.from_numpy(np.asarray(prep["position_ids"])).long(),
            cfg.text)
        cache = init_kv_cache(cfg.text, 1, emb.shape[1], emb.dtype, "cpu")
        logits = model.text.logits(model.text(emb, cos, sin, cache, 0))[0]
        ce = torch.nn.functional.cross_entropy(
            logits[:-1], labels[1:].clamp(min=0), reduction="none")
        valid = labels[1:] != -100
        want = (ce * valid).sum() / valid.sum()
    np.testing.assert_allclose(loss.item(), want.item(), rtol=1e-5)
