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
