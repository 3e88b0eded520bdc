"""The port's parallel layer (`vlm_fo1_tpu_torch/parallel`) vs the JAX
package's, on `FO1Config.tiny()` in f32 on the CPU.

One group of 4 gloo ranks (`tests/torch_parallel_worker.py`, spawned once
for the whole file) runs every multi-rank case; the JAX side runs here on
the 8 virtual CPU devices of tests/conftest.py:

- ring attention over 4 ranks against JAX `ring_attention` under
  `shard_map` on 8 devices and the dense reference (rtol / atol 2e-5, the
  JAX test's), a ragged case included;
- `prefill_sequence_parallel` over 4 ranks against the JAX function on 8
  devices, in f32 (2e-4) and with int4-mlp weights (2e-3), and the same
  prefill in one process over a `LocalRing` of 4 chunks;
- the tensor-parallel plan against JAX `param_shardings` where the heads
  divide by the model axis, replicated where they do not;
- a TP-sharded trunk forward on a (2, 2) mesh against the JAX sharded
  forward (2e-4);
- the trunk in w8a8 TP-sharded over (1, 4) and (2, 2) (row-parallel w8a8
  shards) against the dense w8a8 trunk and the JAX sharded w8a8 forward
  (1e-5), with the same greedy tokens, and one row-parallel w8a8 product
  with outlier columns on every rank and tied column absmax against the
  dense product and the JAX w8a8 linear;
- the DP x TP loss and every gradient against JAX `value_and_grad` of
  `multimodal_lm_loss` (what JAX `make_train_step` takes) on a batch whose
  rows hold unequal numbers of labels;
- the dry-run suite (`parallel/dryrun.py`) at world 4;
- the multihost helpers (the JAX tests/test_multihost.py cases)."""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from torch_parity import (  # noqa: F401
    jax_fo1_params,
    one_torch_thread,
    port_config,
    to_numpy,
)
from vlm_fo1_tpu import nn as jnn
from vlm_fo1_tpu import quant as jquant
from vlm_fo1_tpu.config import FO1Config
from vlm_fo1_tpu.models import llm as jllm
from vlm_fo1_tpu.parallel.ring_attention import ring_attention as jax_ring
from vlm_fo1_tpu.parallel.sharding import (
    create_mesh as jax_create_mesh,
    param_shardings,
    shard_params,
)
from vlm_fo1_tpu.quant import quantize_mlp_int4 as jax_quantize_mlp_int4
from vlm_fo1_tpu.runtime.generate import (
    prefill_sequence_parallel as jax_sp_prefill,
)
from vlm_fo1_tpu.training.train_step import multimodal_lm_loss as jax_loss
from vlm_fo1_tpu_torch import quant
from vlm_fo1_tpu_torch.convert import state_dict_from_jax_params
from vlm_fo1_tpu_torch.models.fo1 import FO1Model
from vlm_fo1_tpu_torch.parallel import initialize_distributed
from vlm_fo1_tpu_torch.parallel.multihost import create_hybrid_mesh
from vlm_fo1_tpu_torch.parallel.ring_attention import LocalRing
from vlm_fo1_tpu_torch.parallel.sharding import (
    param_specs,
    shard_leaf,
)
from vlm_fo1_tpu_torch.runtime.generate import prefill_sequence_parallel
from torch_parallel_worker import W8A8_MESHES, greedy_logits

JCFG = FO1Config.tiny()
CFG = port_config(JCFG)
WORLD = 4
RING_CASES = {"gqa2": (4, 2, False), "gqa4_ragged": (8, 2, True)}
SP_CASES = {"f32": (2, 27, 32, (27, 22)), "int4_mlp": (1, 19, 24, (19,))}
SP_TOL = {"f32": 2e-4, "int4_mlp": 2e-3}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.as_tensor(np.array(x))


def _ring_dense(q, k, v, pos, valid):
    """The JAX test's dense reference (test_ring_attention.py)."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, hd)
    logits = np.einsum("bsngh,bcnh->bngsc", qg, k).astype(np.float32)
    logits /= np.sqrt(hd)
    mask = ((pos[:, None, None, None, :] <= pos[:, None, None, :, None])
            & valid[:, None, None, None, :])
    logits = np.where(mask, logits, -1e30)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = np.where(mask, p, 0.0)
    p /= np.maximum(p.sum(-1, keepdims=True), 1e-30)
    out = np.einsum("bngsc,bcnh->bngsh", p, v)
    return out.transpose(0, 3, 1, 2, 4).reshape(b, s, hq, hd)


def _ring_inputs(rng):
    """The cases' inputs, and a function that computes the JAX side (the
    parts are split so the ranks run while JAX computes)."""
    cases, arrays = {}, {}
    for name, (hq, hkv, ragged) in RING_CASES.items():
        b, s, hd = 2, 64, 8
        q = rng.standard_normal((b, s, hq, hd)).astype(np.float32)
        k = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
        v = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
        pos = np.broadcast_to(np.arange(s)[None], (b, s)).copy()
        valid = np.ones((b, s), bool)
        if ragged:
            valid[0, 50:] = False
            valid[1, 33:] = False
        cases[name] = {"q": _t(q), "k": _t(k), "v": _t(v), "pos": _t(pos),
                       "valid": _t(valid)}
        arrays[name] = (q, k, v, pos, valid)

    def refs():
        mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("sp",))
        fn = jax.shard_map(functools.partial(jax_ring, axis_name="sp"),
                           mesh=mesh, in_specs=(P(None, "sp"),) * 6,
                           out_specs=P(None, "sp"))
        out = {}
        for name, (q, k, v, pos, valid) in arrays.items():
            got = np.asarray(fn(*(jnp.asarray(x) for x in
                                  (q, k, v, pos, pos, valid))))
            out[name] = (got, _ring_dense(q, k, v, pos, valid), valid)
        return out

    return cases, refs


def _sp_inputs(rng, table):
    cases = {}
    for name, (b, s, pad, lens) in SP_CASES.items():
        ids = rng.integers(0, JCFG.text.vocab_size, (b, pad))
        pos = np.broadcast_to(np.arange(pad)[None, None], (3, b, pad)).copy()
        cases[name] = {"embeds": table[_t(ids)], "pos": _t(pos),
                       "seq_lens": _t(np.asarray(lens)).long(),
                       "cache_len": pad + 8}

    def refs(jtext):
        mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("model",))
        out = {}
        for name, c in cases.items():
            params = dict(jtext)
            if name == "int4_mlp":
                params["layers"] = dict(params["layers"])
                params["layers"]["mlp"] = jax_quantize_mlp_int4(
                    params["layers"]["mlp"])
            cache, logits = jax_sp_prefill(
                params, JCFG.text, jnp.asarray(c["embeds"].numpy()),
                jnp.asarray(c["pos"].numpy()),
                jnp.asarray(c["seq_lens"].numpy(), jnp.int32),
                cache_len=c["cache_len"], mesh=mesh)
            out[name] = (np.asarray(cache["k"]), np.asarray(logits),
                         SP_CASES[name][3])
        return out

    return cases, refs


def _tp_inputs(rng):
    b, s = 2, 16
    ids = rng.integers(0, JCFG.text.vocab_size, (b, s))
    pos = np.broadcast_to(np.arange(s)[None, None], (3, b, s)).copy()
    return {"ids": _t(ids), "pos": _t(pos)}, functools.partial(
        _tp_ref, ids, pos)


def _tp_ref(ids, pos, jtext, w8a8=False):
    """The JAX trunk's logits over ids, its parameters sharded over a (2, 2)
    mesh (int8 weights with the w8a8 marker when `w8a8`)."""
    if w8a8:   # on a copy of the tree: the quantizer edits it in place
        jtext = jquant.quantize_params_w8a8(
            jax.tree.map(lambda a: a, {"text": jtext}))["text"]
    b, s = ids.shape
    embeds = jllm.embed_tokens(jtext, jnp.asarray(ids))
    cos, sin = jllm.mrope_cos_sin(jnp.asarray(pos), JCFG.text)
    mask = jnp.broadcast_to((jnp.arange(s)[None, None, :]
                             <= jnp.arange(s)[None, :, None])[:, None],
                            (b, 1, s, s))

    def fwd(p):
        hidden, _ = jllm.text_forward(p, JCFG.text, embeds, cos, sin, mask)
        return jllm.lm_head_logits(p, JCFG.text, hidden)

    mesh = jax_create_mesh(data=2, model=2, devices=jax.devices()[:4])
    sharded = shard_params({"text": jtext}, mesh)["text"]
    with mesh:
        return np.asarray(jax.jit(fwd)(sharded))


def _w8a8_product_inputs(rng):
    """x [2, 5, 256] with 20 outlier columns spread over the 4 ranks'
    slices and 30 more columns whose absmax ties at the top-k cut
    (k = 32); w_q [48, 256] int8, scale [48]."""
    x = rng.standard_normal((2, 5, 256)).astype(np.float32) * 0.5
    cols = rng.permutation(256)
    x[1, 2, cols[:20]] = 40.0 * rng.choice([-1.0, 1.0], 20)
    x[0, 3, cols[20:50]] = 5.0
    w_q = rng.integers(-127, 128, (48, 256)).astype(np.int8)
    scale = (rng.random(48).astype(np.float32) + 0.5) * 1e-2
    return {"x": _t(x), "w_q": torch.from_numpy(w_q), "scale": _t(scale)}


def _w8a8_product_ref(case):
    q = {"w_q": jnp.asarray(case["w_q"].numpy().T),
         "scale": jnp.asarray(case["scale"].numpy())}
    return np.asarray(jnn.linear(jquant.mark_w8a8(q),
                                 jnp.asarray(case["x"].numpy())))


def _train_inputs(rng):
    import __graft_entry__ as g

    prep = g._build_inputs(JCFG, image_hw=(112, 112), n_boxes=4,
                           prompt_extra=8)
    plan, info = prep["plan"], prep["splice"]
    s = info.seq_len

    def rep(x):
        return np.broadcast_to(np.asarray(x)[None], (2, *np.shape(x))).copy()

    labels = rng.integers(0, JCFG.text.vocab_size, size=(2, s))
    labels[0, :5] = -100     # the rows hold unequal numbers of labels
    labels[1, :s // 2] = -100
    batch = {
        "patches": rep(np.asarray(prep["pixel_values"], np.float32)[
            plan.gather_idx]),
        "rot_cos": np.asarray(plan.rot_cos),
        "rot_sin": np.asarray(plan.rot_sin),
        "valid": np.asarray(plan.valid),
        "inv_unit_idx": np.asarray(plan.inv_unit_idx),
        "inv_token_idx": np.asarray(plan.inv_token_idx),
        "aux_image": rep(np.asarray(prep["aux"], np.float32).transpose(
            1, 2, 0)),
        "aux_boxes": rep(prep["aux_boxes"]),
        "vt_boxes": rep(prep["vt_boxes"]),
        "input_ids": rep(info.input_ids),
        "image_positions": rep(info.image_positions),
        "region_positions": rep(info.region_positions),
        "position_ids": np.broadcast_to(prep["position_ids"],
                                        (3, 2, s)).copy(),
        "labels": labels,
    }
    kw = dict(num_windows=plan.num_windows,
              grid=tuple(int(x) for x in prep["grid"]))

    def refs(jparams):
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        loss, grads = jax.jit(lambda p: jax.value_and_grad(jax_loss)(
            p, JCFG, jbatch, **kw))(jparams)
        return float(loss), state_dict_from_jax_params(to_numpy(grads), CFG)

    return {"batch": batch, "kw": kw}, refs


def _launch(path):
    """The 4 worker ranks, started together."""
    from vlm_fo1_tpu_torch.parallel.dryrun import free_port

    env = dict(os.environ, PYTHONPATH=ROOT)
    address = f"localhost:{free_port()}"
    worker = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
    return [subprocess.Popen(
        [sys.executable, worker, str(r), str(WORLD), address, str(path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]


def _join(procs, path):
    """The ranks' outputs once all have ended; a rank that failed raises
    with its traceback."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    outs = []
    for r, p in enumerate(procs):
        f = path / f"out_{r}.pt"
        out = torch.load(f, weights_only=False) if f.exists() else {}
        if p.returncode != 0 or "error" in out:
            raise AssertionError(f"rank {r} exit {p.returncode}:\n"
                                 f"{out.get('error', '')}\n{logs[r][-3000:]}")
        outs.append(out)
    return outs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX references and the port's 4 ranks' results."""
    rng = np.random.default_rng(0)
    model = FO1Model.random_init(CFG, seed=0, device="cpu")
    sd = model.state_dict()
    inputs = {"cfg": CFG, "state_dict": sd}
    ref_fns = {}
    inputs["ring"], ref_fns["ring"] = _ring_inputs(rng)
    inputs["sp"], ref_fns["sp"] = _sp_inputs(
        rng, sd["text.embed_tokens.weight"])
    inputs["tp"], ref_fns["tp"] = _tp_inputs(rng)
    inputs["w8a8_product"] = _w8a8_product_inputs(rng)
    inputs["train"], ref_fns["train"] = _train_inputs(rng)
    path = tmp_path_factory.mktemp("parallel")
    torch.save(inputs, path / "inputs.pt")
    procs = _launch(path)
    try:   # the JAX side while the ranks run
        jparams = jax_fo1_params(sd, JCFG)
        refs = {"ring": ref_fns["ring"](),
                "sp": ref_fns["sp"](jparams["text"]),
                "tp": ref_fns["tp"](jparams["text"]),
                "tp_w8a8": ref_fns["tp"](jparams["text"], w8a8=True),
                "w8a8_product": _w8a8_product_ref(inputs["w8a8_product"]),
                "train": ref_fns["train"](jparams)}
    finally:
        outs = _join(procs, path)
    return {"inputs": inputs, "refs": refs, "outs": outs, "model": model,
            "jparams": jparams}


@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_attention_matches_jax_and_dense(run, case):
    got = torch.cat([o[f"ring/{case}"] for o in run["outs"]], dim=1).numpy()
    want_jax, want_dense, valid = run["refs"]["ring"][case]
    # rows whose query is padding are irrelevant; compare valid rows only
    np.testing.assert_allclose(got[valid], want_jax[valid], rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got[valid], want_dense[valid], rtol=2e-5,
                               atol=2e-5)


def _check_sp(case, cache_k, logits, refs):
    k_ref, logits_ref, lens = refs
    tol = SP_TOL[case]
    np.testing.assert_allclose(logits.numpy(), logits_ref, rtol=tol, atol=tol)
    for i, sl in enumerate(lens):
        np.testing.assert_allclose(cache_k[:, i, :sl].numpy(),
                                   k_ref[:, i, :sl], rtol=tol, atol=tol)


@pytest.mark.parametrize("case", list(SP_CASES))
def test_prefill_sequence_parallel_matches_jax(run, case):
    outs = [o[f"sp/{case}"] for o in run["outs"]]
    for k, logits in outs[1:]:   # every rank returns the same cache
        assert torch.equal(k, outs[0][0]) and torch.equal(logits, outs[0][1])
    _check_sp(case, *outs[0], run["refs"]["sp"][case])


@pytest.mark.parametrize("case", list(SP_CASES))
def test_prefill_over_a_local_ring_matches_jax(run, case):
    text = FO1Model(CFG, device="cpu")
    text.load_state_dict(run["inputs"]["state_dict"])
    text = text.text
    if case == "int4_mlp":
        for layer in text.layers:
            layer.mlp = quant.quantize_mlp_int4(layer.mlp)
    c = run["inputs"]["sp"][case]
    cache, logits = prefill_sequence_parallel(
        text, CFG.text, c["embeds"], c["pos"], c["seq_lens"], c["cache_len"],
        LocalRing(4))
    _check_sp(case, cache["k"], logits, run["refs"]["sp"][case])


def _jax_spec(specs, name):
    """The JAX spec of the leaf that a port parameter name stands for, and
    the port dim each sharded JAX axis corresponds to."""
    parts = name.split(".")
    leaf = parts[-1]
    if parts[0] == "text":
        t = specs["text"]
        if parts[1] == "embed_tokens":
            return t["embed_tokens"]["w"].spec, {-1: 1}
        if parts[1] == "lm_head":
            return t["lm_head"]["w"].spec, {-1: 0, -2: 1}
        node = t["layers"]["attn" if parts[3] == "self_attn" else "mlp"][
            parts[4]]
    else:
        kind = ("full" if int(parts[2]) in JCFG.vision.fullatt_block_indexes
                else "window")
        node = specs["vision_tower"]["blocks"][kind][parts[3]][parts[4]]
    key = {"weight": "w", "bias": "b"}[leaf]
    if key not in node:
        return None, {}
    return node[key].spec, ({-1: 0, -2: 1} if leaf == "weight" else {-1: 0})


def _jax_dim(spec, axes):
    spec = tuple(spec)
    for neg, port_dim in axes.items():
        if len(spec) >= -neg and spec[neg] == "model":
            return port_dim
    return None


@pytest.mark.parametrize("m", [2, 4])
def test_plan_matches_jax_where_heads_divide(run, m):
    specs = param_shardings(run["jparams"],
                            jax_create_mesh(data=8 // m, model=m))
    port = param_specs(run["model"], m)
    heads_divide = {"text": JCFG.text.num_key_value_heads % m == 0,
                    "vision_tower": JCFG.vision.num_heads % m == 0}
    checked = 0
    for name, dim in port.items():
        if not (name.startswith("text.") or ".blocks." in name
                and name.startswith("vision_tower.")):
            assert dim is None, name       # DaViT, HFRE, projectors, norms
            continue
        if name.endswith("norm.weight") or "norm" in name.split(".")[-2]:
            assert dim is None, name
            continue
        jspec, axes = _jax_spec(specs, name)
        want = None if jspec is None else _jax_dim(jspec, axes)
        attention = ".self_attn." in name or ".attn." in name
        if attention and not heads_divide[name.split(".")[0]]:
            # heads do not divide: the port keeps the attention whole,
            # where JAX splits the widths (queue 3 #3, by design)
            assert dim is None, name
            continue
        if name.startswith("vision_tower.") and name.endswith(".bias"):
            # a column shard's bias goes with its rows; JAX keeps the
            # ViT's biases whole (no rule names them) and GSPMD slices them
            assert want is None and dim == (0 if ".proj." not in name
                                            and ".down_proj." not in name
                                            else None), name
            continue
        assert dim == want, (name, dim, jspec)
        checked += 1
    assert checked > 10


def test_int8_leaves_follow_the_jax_rules(run):
    model = FO1Model(CFG, device="cpu")
    model.load_state_dict(run["inputs"]["state_dict"])
    quant.quantize_model(model, "int8-all")
    port = param_specs(model, 2)
    assert port["text.layers.0.self_attn.q_proj.w_q"] == 0
    assert port["text.layers.0.self_attn.q_proj.scale"] == 0
    assert port["text.layers.0.self_attn.o_proj.w_q"] == 1
    assert port["text.layers.0.self_attn.o_proj.scale"] is None
    assert port["text.layers.0.mlp.down_proj.scale"] is None
    assert port["text.embed_tokens.w_q"] == 1
    assert port["text.embed_tokens.scale"] is None  # per-row: V stays whole
    assert port["text.layers.0.input_layernorm.weight"] is None
    # int4 leaves stay replicated, as in JAX
    q4 = FO1Model(CFG, device="cpu")
    q4.load_state_dict(run["inputs"]["state_dict"])
    quant.quantize_model(q4, "int4")
    assert all(d is None for n, d in param_specs(q4, 2).items()
               if n.startswith("text.layers."))


@pytest.fixture(scope="module")
def dense_w8a8(run):
    """The unsharded tiny trunk in w8a8: (prompt logits, greedy tokens)."""
    model = FO1Model(CFG, device="cpu")
    model.load_state_dict(run["inputs"]["state_dict"])
    quant.quantize_model(model, "w8a8")
    return greedy_logits(model.text, CFG, run["inputs"]["tp"]["ids"])


@pytest.mark.parametrize("shape", W8A8_MESHES, ids=str)
def test_w8a8_row_parallel_shard_matches_dense_and_jax(run, dense_w8a8,
                                                       shape):
    """Every rank's prompt logits within 1e-5 of the dense w8a8 trunk and
    of the JAX w8a8 forward sharded over (2, 2); the same greedy tokens as
    the dense trunk."""
    want, want_tokens = dense_w8a8
    for r, out in enumerate(run["outs"]):
        logits, tokens = out[f"tp_w8a8/{shape}"]
        np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(logits.numpy(), run["refs"]["tp_w8a8"],
                                   rtol=1e-5, atol=1e-5, err_msg=f"rank {r}")
        assert torch.equal(tokens, want_tokens), (r, tokens, want_tokens)


def test_w8a8_row_parallel_product_matches_dense_and_jax(run):
    """One row-parallel w8a8 product over 4 ranks: outlier columns in
    every rank's slice and an absmax tie across the top-k cut pick the
    dense outliers (lower index first), and the result equals the dense
    product and the JAX w8a8 linear to 1e-5 (the f32 outlier products
    are summed over the ranks in another order)."""
    want = run["refs"]["w8a8_product"]
    for r, out in enumerate(run["outs"]):
        got, dense = out["w8a8_product"]
        np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=f"rank {r}")


def test_tp_forward_matches_jax_on_a_2x2_mesh(run):
    want = run["refs"]["tp"]
    for out in run["outs"]:
        assert out["tp/heads"] == (2, 1)   # local heads of 4 q, 2 kv
        np.testing.assert_allclose(out["tp/logits"].numpy(), want,
                                   rtol=2e-4, atol=2e-4)


def test_dp_tp_train_loss_matches_jax(run):
    jloss, _ = run["refs"]["train"]
    for out in run["outs"]:
        np.testing.assert_allclose(out["train/loss"].item(), jloss,
                                   rtol=1e-5)


def test_dp_tp_train_gradients_match_jax(run):
    _, want = run["refs"]["train"]
    scale = max(np.abs(w.numpy()).max() for w in want.values())
    for r, out in enumerate(run["outs"]):
        plan, grads = out["train/plan"], out["train/grads"]
        assert set(grads) == set(want)
        model_rank = r % 2
        for name, g in grads.items():
            assert g is not None, name
            mod, _, leaf = name.rpartition(".")
            ref = want[name]
            if mod in plan:
                ref = shard_leaf(ref, plan[mod], leaf, model_rank, 2)
            np.testing.assert_allclose(g.numpy(), ref.numpy(),
                                       atol=1e-5 * scale, rtol=1e-4,
                                       err_msg=f"rank {r} {name}")


def test_dryrun_suite_at_world_4(run):
    results = [o["dryrun"] for o in run["outs"]]
    assert all(r["mesh"] == [2, 2] for r in results)
    assert all(r["tokens"] == results[0]["tokens"] for r in results)
    assert results[0]["decode_steps"] == 8
    assert results[0]["sp_prefill_max_err"] <= 2e-4
    assert abs(results[0]["loss"] - results[0]["dense_loss"]) <= 2e-4


def test_hybrid_mesh_layout(run):
    for r, out in enumerate(run["outs"]):
        ranks, names, data_rank, model_rank = out["multihost/mesh"]
        assert names == ("data", "model")
        assert ranks == [[0, 1], [2, 3]]   # the model axis over neighbours
        assert (data_rank, model_rank) == (r // 2, r % 2)
        # a sum over the model group adds the two neighbours' ranks
        assert out["multihost/model_sum"].tolist() == [
            float(2 * (r // 2) * 2 + 1)] * 3


def test_hybrid_mesh_needs_enough_devices(run):
    for out in run["outs"]:
        assert "need 16 devices, have 4" in out["multihost/too_big"]
    with pytest.raises(ValueError, match="need 16 devices"):
        create_hybrid_mesh(ici_data=2, ici_model=4, num_slices=2)


def test_initialize_distributed_single_process_noop(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    initialize_distributed(device="cpu")
    assert not torch.distributed.is_initialized()


def test_initialize_distributed_never_swaps_the_backend(monkeypatch):
    """Asking for NCCL on a machine without a card raises; there is no
    quiet gloo group instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        initialize_distributed("localhost:1", 2, 0, device="cuda")
    assert not torch.distributed.is_initialized()
