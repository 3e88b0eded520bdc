"""One gloo rank of tests/test_torch_parallel.py: runs every case of that
file on this rank and writes its results to <dir>/out_<rank>.pt. Imports
nothing of JAX; the test file computes the JAX side and compares.

    python tests/torch_parallel_worker.py RANK WORLD ADDRESS DIR

reads DIR/inputs.pt (the port's tiny FO1 state dict and the cases'
inputs, written by the test)."""

import os
import sys
import traceback

import torch
import torch.distributed as dist


def _ring(inp, out):
    from vlm_fo1_tpu_torch.parallel.ring_attention import ring_attention

    r, n = dist.get_rank(), dist.get_world_size()
    for name, case in inp["ring"].items():
        sl = case["q"].shape[1] // n
        part = {k: v[:, r * sl:(r + 1) * sl] for k, v in case.items()}
        out[f"ring/{name}"] = ring_attention(
            part["q"], part["k"], part["v"], part["pos"], part["pos"],
            part["valid"])


def _text(inp, cfg, int4_mlp=False):
    from vlm_fo1_tpu_torch.models.fo1 import FO1Model
    from vlm_fo1_tpu_torch.quant import quantize_mlp_int4

    model = FO1Model(cfg, device="cpu")
    model.load_state_dict(inp["state_dict"])
    if int4_mlp:
        for layer in model.text.layers:
            layer.mlp = quantize_mlp_int4(layer.mlp)
    return model


def _sp(inp, cfg, out):
    from vlm_fo1_tpu_torch.runtime.generate import prefill_sequence_parallel

    for name, case in inp["sp"].items():
        text = _text(inp, cfg, int4_mlp=name == "int4_mlp").text
        cache, logits = prefill_sequence_parallel(
            text, cfg.text, case["embeds"], case["pos"], case["seq_lens"],
            case["cache_len"])
        out[f"sp/{name}"] = (cache["k"], logits)


def _tp_forward(inp, cfg, mesh, out):
    from vlm_fo1_tpu_torch.models.llm import causal_attention, mrope_cos_sin
    from vlm_fo1_tpu_torch.parallel.sharding import shard_model

    case = inp["tp"]
    text = _text(inp, cfg).text
    shard_model(text, mesh)
    cos, sin = mrope_cos_sin(case["pos"], cfg.text)
    with torch.no_grad():
        hidden = text(text.embed(case["ids"]), cos, sin,
                      attention=causal_attention)
        out["tp/logits"] = text.logits(hidden)
    out["tp/heads"] = (text.layers[0].self_attn.nh, text.kv_heads)


W8A8_MESHES = ((1, 4), (2, 2))
W8A8_NEW = 4     # greedy tokens after the prompt


def greedy_logits(text, cfg, ids, new=W8A8_NEW):
    """The trunk's causal forward over ids [B, S] (every call multi-token,
    so w8a8 linears quantize their activations), then `new` greedy tokens,
    each from a full forward over the grown sequence: (the prompt's logits
    [B, S, V], the new tokens [B, new])."""
    from vlm_fo1_tpu_torch.models.llm import causal_attention, mrope_cos_sin

    first, toks = None, []
    with torch.no_grad():
        for _ in range(new + 1):
            b, s = ids.shape
            pos = torch.arange(s).expand(3, b, s)
            cos, sin = mrope_cos_sin(pos, cfg.text)
            logits = text.logits(text(text.embed(ids), cos, sin,
                                      attention=causal_attention))
            first = logits if first is None else first
            nxt = logits[:, -1].argmax(-1, keepdim=True)
            toks.append(nxt)
            ids = torch.cat([ids, nxt], dim=1)
    return first, torch.cat(toks[:new], dim=1)


def _tp_w8a8(inp, cfg, out):
    """The tiny trunk in w8a8, TP-sharded over each mesh of W8A8_MESHES
    (row-parallel w8a8 o_proj / down_proj), and one row-parallel w8a8
    product against the dense one on inputs with planted outlier columns
    on every rank and tied column absmax."""
    from vlm_fo1_tpu_torch import nn as tnn
    from vlm_fo1_tpu_torch.parallel.sharding import (
        create_mesh,
        shard_leaf,
        shard_model,
        w8a8_row_parallel,
    )
    from vlm_fo1_tpu_torch.quant import quantize_model

    for shape in W8A8_MESHES:
        mesh = create_mesh(*shape)
        model = _text(inp, cfg)
        quantize_model(model, "w8a8")
        shard_model(model.text, mesh)
        out[f"tp_w8a8/{shape}"] = greedy_logits(model.text, cfg,
                                                inp["tp"]["ids"])
    case = inp["w8a8_product"]
    group = create_mesh(1, dist.get_world_size()).get_group("model")
    r, m = dist.get_rank(group), dist.get_world_size(group)
    x = case["x"].chunk(m, dim=-1)[r].contiguous()
    w_q = shard_leaf(case["w_q"], "row", "w_q", r, m)
    out["w8a8_product"] = (w8a8_row_parallel(x, w_q, case["scale"], group),
                           tnn.w8a8_matmul(case["x"], case["w_q"],
                                           case["scale"]))


def _train(inp, cfg, mesh, out):
    from vlm_fo1_tpu_torch.parallel.sharding import (
        data_rows,
        shard_model,
        tp_plan,
    )
    from vlm_fo1_tpu_torch.training import train_step as train

    case = inp["train"]
    model = _text(inp, cfg)
    plan = tp_plan(model, mesh.size(1))
    shard_model(model, mesh).requires_grad_(True)
    rows = data_rows(case["batch"]["labels"].shape[0], mesh)
    loss = train.multimodal_lm_loss(
        model, train.local_batch(case["batch"], rows),
        data_group=mesh.get_group("data"), **case["kw"])
    loss.backward()
    train.all_reduce_grads(model, mesh.get_group("data"))
    out["train/loss"] = loss.detach()
    out["train/plan"] = plan
    out["train/grads"] = {n: p.grad for n, p in model.named_parameters()}


def _multihost(out):
    from vlm_fo1_tpu_torch.parallel import (
        create_hybrid_mesh,
        initialize_distributed,
    )

    mesh = create_hybrid_mesh(ici_data=1, ici_model=2, num_slices=2)
    out["multihost/mesh"] = (mesh.mesh.tolist(), mesh.mesh_dim_names,
                             mesh.get_local_rank("data"),
                             mesh.get_local_rank("model"))
    try:
        create_hybrid_mesh(ici_data=2, ici_model=4, num_slices=2)
        out["multihost/too_big"] = None
    except ValueError as e:
        out["multihost/too_big"] = str(e)
    initialize_distributed()        # a group exists: nothing happens
    x = torch.full((3,), float(dist.get_rank()))
    dist.all_reduce(x, group=mesh.get_group("model"))
    out["multihost/model_sum"] = x


def main(rank, world, address, path):
    torch.set_num_threads(1)
    from vlm_fo1_tpu_torch.parallel.dryrun import run_suite
    from vlm_fo1_tpu_torch.parallel.multihost import initialize_distributed
    from vlm_fo1_tpu_torch.parallel.sharding import create_mesh

    initialize_distributed(address, world, rank, "cpu")
    out = {}
    try:
        inp = torch.load(os.path.join(path, "inputs.pt"), weights_only=False)
        cfg = inp["cfg"]
        mesh = create_mesh(2, world // 2)
        _ring(inp, out)
        _sp(inp, cfg, out)
        _tp_forward(inp, cfg, mesh, out)
        _tp_w8a8(inp, cfg, out)
        _train(inp, cfg, mesh, out)
        _multihost(out)
        out["dryrun"] = run_suite(mesh, "cpu")
    except BaseException:
        out["error"] = traceback.format_exc()
        raise
    finally:
        torch.save(out, os.path.join(path, f"out_{rank}.pt"))
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
