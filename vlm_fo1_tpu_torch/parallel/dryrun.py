"""The multi-chip program suite (counterpart of `dryrun_multichip` /
`_dryrun_body` in the JAX package's `__graft_entry__.py`).

    python -m vlm_fo1_tpu_torch.parallel.dryrun --world N [--device cpu]
    torchrun --nproc-per-node N -m vlm_fo1_tpu_torch.parallel.dryrun

spawns N ranks (one per card on `cuda`, with NCCL; gloo processes on `cpu`)
or runs as one rank of a torchrun launch. Over a (N/2, 2) mesh (or (1, N)
for an odd N), with `FO1Config.tiny()` (untied head) in f32 and the same
seeded weights on every rank, it runs:

  serving   `generate_batch` with DP rows (2 per data rank) x TP modules;
            the tokens and `num_steps` must equal those of the dense model
            on the whole batch, token for token;
  sp        `prefill_sequence_parallel` over the model axis; its logits
            must be within 2e-4 of `prefill`'s;
  train     one DP x TP `make_train_step` step on a batch whose rows hold
            unequal numbers of labels; its loss must equal the dense loss
            to 2e-4.

and prints one line like the JAX `dryrun_multichip(...)` line. With
`--grounding-3b` it then takes `FO1Config()` (Qwen2.5-VL-3B FO1) in bf16
with random weights, answers one grounding request densely, shards the
model over (1, N) and answers it four times, decoding from CUDA graphs
(the collectives captured inside them) and eagerly in turns, every run
staged as the dense one (`stage_ms`: its decode writes at the prompt's own
length); the prefill logits must agree to 2e-2 relative L2 with the dense
request's, at N = 1 (size-1 collectives on the dense arithmetic) every
run's greedy tokens must equal the dense request's, and above it the
tokens that agree are counted. `--json PATH` writes rank 0's results.

Nothing falls back: a failed check or rank raises and the exit code is
not 0.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist

from vlm_fo1_tpu_torch.config import FO1Config
from vlm_fo1_tpu_torch.models.fo1 import FO1Model
from vlm_fo1_tpu_torch.parallel.multihost import initialize_distributed
from vlm_fo1_tpu_torch.parallel.sharding import (
    create_mesh,
    data_rows,
    shard_model,
)
from vlm_fo1_tpu_torch.runtime.fallback_tokenizer import FallbackTokenizer
from vlm_fo1_tpu_torch.runtime.generate import (
    prefill,
    prefill_sequence_parallel,
)
from vlm_fo1_tpu_torch.task_templates import OD_template
from vlm_fo1_tpu_torch.training import train_step as train

TOL = 2e-4
BF16_REL = 2e-2


def tiny_config() -> FO1Config:
    """FO1Config.tiny() with an untied head: with random weights a tied
    head echoes the last prompt token, and equal tokens would prove
    little."""
    tiny = FO1Config.tiny()
    return dataclasses.replace(tiny, text=dataclasses.replace(
        tiny.text, tie_word_embeddings=False))


def grounding_messages(seed: int, h: int, w: int, n_boxes: int):
    """One grounding prompt on a seeded h x w image with n_boxes seeded
    boxes."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))
    x0 = rng.uniform(0, w * 0.6, n_boxes)
    y0 = rng.uniform(0, h * 0.6, n_boxes)
    boxes = [[float(a), float(b), float(a + w * 0.3), float(b + h * 0.3)]
             for a, b in zip(x0, y0)]
    return [{"role": "user",
             "content": [{"type": "image_url", "image_url": {"url": img}},
                         {"type": "text", "text": OD_template.format("cat")}],
             "bbox_list": boxes}]


def _gather_data(obj, mesh):
    out = [None] * mesh.size(0)
    dist.all_gather_object(out, obj, group=mesh.get_group("data"))
    return out


def train_batch(model, n_rows: int) -> tuple[dict, dict]:
    """A batch of n_rows prompts of one geometry (`batch_from_prepared`
    rows stacked) with seeded labels in the vocabulary, row i with its
    first 3 + 4 i labels set to -100 so the rows hold unequal numbers of
    labels. Returns (batch, loss kwargs)."""
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n_rows):
        prep = model.prepare(grounding_messages(700 + i, 112, 112, 3))
        row = train.batch_from_prepared(model.cfg, prep)
        row["labels"] = rng.integers(0, model.cfg.text.vocab_size,
                                     row["labels"].shape)
        row["labels"][0, :3 + 4 * i] = train.IGNORE
        rows.append(row)
    batch = {}
    for k in rows[0]:
        if k == "position_ids":
            batch[k] = np.concatenate([r[k] for r in rows], axis=1)
        elif k in train._ROW_KEYS:
            batch[k] = np.concatenate([r[k] for r in rows])
        else:
            batch[k] = rows[0][k]
    plan = prep["plan"]
    return batch, dict(num_windows=plan.num_windows,
                       grid=tuple(int(g) for g in prep["grid"]))


def run_suite(mesh, device, seed: int = 0) -> dict:
    """The three programs over `mesh` on tiny shapes; raises on a
    mismatch. Returns rank-local results."""
    cfg = tiny_config()
    tok = FallbackTokenizer()
    data, model_n = mesh.shape
    out = {"mesh": [data, model_n]}

    # ---- serving: DP rows x TP modules against the dense whole batch
    b = 2 * data
    msgs = [grounding_messages(600 + i, 112, 140, 1 + i % 3)
            for i in range(b)]
    dense = FO1Model.random_init(cfg, seed=seed, device=device, tokenizer=tok)
    kw = dict(max_new_tokens=8, eos_token_id=-1, max_pixels=256 * 256)
    want = dense.generate_batch(msgs, **kw)
    tp = FO1Model.random_init(cfg, seed=seed, device=device, tokenizer=tok)
    shard_model(tp, mesh)
    rows = data_rows(b, mesh)
    mine = tp.generate_batch(msgs[rows], **kw)
    got = [r for part in _gather_data(
        [(r.token_ids.tolist(), r.num_steps, r.prefill_logits)
         for r in mine], mesh) for r in part]
    for i, (ids, steps, logits) in enumerate(got):
        if ids != want[i].token_ids.tolist():
            raise AssertionError(f"row {i}: sharded tokens {ids} != dense "
                                 f"{want[i].token_ids.tolist()}")
        err = float(np.abs(logits - want[i].prefill_logits).max())
        if err > TOL:
            raise AssertionError(f"row {i}: prefill logits differ by {err}")
    steps = max(s for _, s, _ in got)
    if steps != want[0].num_steps:
        raise AssertionError(f"num_steps {steps} != dense "
                             f"{want[0].num_steps}")
    out["decode_steps"] = steps
    out["serve_logits_max"] = float(max(np.abs(r.prefill_logits).max()
                                        for r in want))
    out["tokens"] = [ids for ids, _, _ in got]

    # ---- sequence-parallel prefill over the model axis
    sp_pad = 32 * model_n
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.text.vocab_size, (b, sp_pad),
                        generator=gen).to(device)
    with torch.no_grad():
        embeds = dense.text.embed(ids)
    pos = torch.arange(sp_pad, device=device).view(1, 1, -1).expand(
        3, b, sp_pad)
    seq_lens = torch.full((b,), sp_pad - 3, device=device)
    _, ref = prefill(dense.text, cfg.text, embeds, pos, seq_lens, sp_pad + 8,
                     attention=dense.attention)
    _, sp = prefill_sequence_parallel(dense.text, cfg.text, embeds, pos,
                                      seq_lens, sp_pad + 8,
                                      mesh.get_group("model"))
    out["sp_prefill_max_err"] = float((sp - ref).abs().max())
    if not out["sp_prefill_max_err"] <= TOL:
        raise AssertionError(f"SP prefill logits differ by "
                             f"{out['sp_prefill_max_err']}")

    # ---- one DP x TP train step against the dense loss
    batch, lkw = train_batch(dense, b)
    with torch.no_grad():
        dense_loss = float(train.multimodal_lm_loss(dense, batch, **lkw))
    tp.requires_grad_(True)
    step = train.make_train_step(tp, train.adamw(tp.parameters()), **lkw,
                                 data_group=mesh.get_group("data"))
    loss = float(step(train.local_batch(batch, rows)))
    out["loss"], out["dense_loss"] = loss, dense_loss
    if not abs(loss - dense_loss) <= TOL:
        raise AssertionError(f"DP x TP loss {loss} != dense {dense_loss}")
    return out


def run_grounding_3b(mesh, device, seed: int = 0) -> dict:
    """One 3B bf16 grounding request, dense and then TP-sharded over the
    mesh's model axis, with the flash launches of the sharded request."""
    from vlm_fo1_tpu_torch.ops.flash_attention import flash_attention

    cfg = FO1Config()
    model = FO1Model.random_init(cfg, seed=seed, dtype=torch.bfloat16,
                                 device=device, tokenizer=FallbackTokenizer())
    msgs = grounding_messages(100, 966, 1288, 7)
    dense = model.generate(msgs, max_new_tokens=32, stage_ms={})
    shard_model(model, mesh)
    flash_attention.launches = 0
    stage = {}
    res = model.generate(msgs, max_new_tokens=32, stage_ms=stage)
    launches = flash_attention.launches
    runs = [res]
    for graphs in (False, True, False):
        model.cuda_graphs = graphs
        runs.append(model.generate(msgs, max_new_tokens=32, stage_ms={}))
    model.cuda_graphs = True
    ref = torch.as_tensor(dense.prefill_logits)
    rel = max(float((torch.as_tensor(r.prefill_logits) - ref).norm()
                    / ref.norm()) for r in runs)

    def agree(r):
        n = min(len(r.token_ids), len(dense.token_ids))
        return int((r.token_ids[:n] == dense.token_ids[:n]).sum())

    out = {"prompt_len": res.prompt_len, "logits_rel_l2": rel,
           "tokens_agree": [agree(r) for r in runs],
           "decode": ["graph", "eager", "graph", "eager"],
           "tokens": len(dense.token_ids), "flash_launches": launches,
           "stage_ms": stage, "model_axis": mesh.size(1)}
    if not rel <= BF16_REL:
        raise AssertionError(f"3B TP prefill logits relative L2 {rel}")
    if mesh.size(1) == 1 and out["tokens_agree"] != [out["tokens"]] * 4:
        raise AssertionError(
            f"3B TP tokens at model axis 1 differ from dense: "
            f"{[r.token_ids.tolist() for r in runs]} vs "
            f"{dense.token_ids.tolist()}")
    return out


def _rank_main(rank, world, device, address, grounding, json_path):
    if device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(address, world if address else None,
                           rank if address else None, device)
    world = dist.get_world_size()
    data = 2 if world % 2 == 0 and world > 1 else 1
    try:
        mesh = create_mesh(data, world // data)
        out = run_suite(mesh, device)
        line = (f"dryrun_multichip({world}): mesh=({data},{world // data}) "
                f"backend={dist.get_backend()} loss={out['loss']:.4f} "
                f"serve_logits_max={out['serve_logits_max']:.3f} "
                f"decode_steps={out['decode_steps']} sp_prefill_max_err="
                f"{out['sp_prefill_max_err']:.2e} "
                f"sharded_vs_dense_tokens=equal ok")
        if grounding:
            out["grounding_3b"] = run_grounding_3b(
                create_mesh(1, world), device)
        if dist.get_rank() == 0:
            print(line, flush=True)
            if grounding:
                print("grounding_3b " + json.dumps(out["grounding_3b"]),
                      flush=True)
            if json_path:
                with open(json_path, "w") as f:
                    json.dump({"world": world, **out}, f)
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=None,
                    help="ranks to spawn (default: every visible card, or 4 "
                         "on the CPU; ignored under torchrun)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--grounding-3b", action="store_true",
                    help="also answer one 3B grounding request TP-sharded")
    ap.add_argument("--json", default=None, help="write rank 0's results")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is unavailable")
    if "RANK" in os.environ:  # one rank of a torchrun launch
        _rank_main(int(os.environ["RANK"]), None, args.device, None,
                   args.grounding_3b, args.json)
        return 0
    world = args.world or (torch.cuda.device_count()
                           if args.device == "cuda" else 4)
    if args.device == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"{world} ranks need {world} cards (NCCL takes one "
                         f"card per rank); {torch.cuda.device_count()} "
                         "visible")
    address = f"localhost:{free_port()}"
    torch.multiprocessing.spawn(
        _rank_main, args=(world, args.device, address, args.grounding_3b,
                          args.json), nprocs=world, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
