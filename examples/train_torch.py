"""Fine-tuning demo: FO1 training steps with the PyTorch port.

    python examples/train_torch.py --random-init tiny --device cpu
    python examples/train_torch.py --random-init 3b --steps 3
    python examples/train_torch.py --random-init 3b --steps 3 --profile

One seeded batch, repeated: the 7 demo boxes on a synthetic 1288x966 image
(or --image), labels the prompt's own token ids with the image and region
slots ignored (`training.train_step.batch_from_prepared`). AdamW set as
`optax.adamw(1e-4)`, remat on (the ViT window blocks and every trunk layer
are recomputed in the backward pass). --ckpt-dir saves a checkpoint after
the last step. No checkpoint loader is ported yet, so the
weights are random (seeded).

--profile runs the last step by hand under torch.profiler, split into the
loss (forward), its backward and the optimizer step: each part's wall time
(ended by a device synchronise), the summed time of its kernels, their
share of the wall time (the device's busy share; one stream) and the
kernels that took the most device time. With --device cpu only the wall
times mean anything.
"""

import argparse
import dataclasses
import os
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_HERE), _HERE]

import torch  # noqa: E402

from inference_torch import BBOX_LIST  # noqa: E402
from profile_upn_torch import _profile  # noqa: E402
from run_upn_torch import load_image  # noqa: E402
from vlm_fo1_tpu_torch.config import FO1Config  # noqa: E402
from vlm_fo1_tpu_torch.models.fo1 import FO1Model  # noqa: E402
from vlm_fo1_tpu_torch.runtime.fallback_tokenizer import (  # noqa: E402
    FallbackTokenizer,
)
from vlm_fo1_tpu_torch.task_templates import OD_template  # noqa: E402
from vlm_fo1_tpu_torch.training import checkpointing  # noqa: E402
from vlm_fo1_tpu_torch.training.train_step import (  # noqa: E402
    adamw,
    batch_from_prepared,
    make_train_step,
    multimodal_lm_loss,
)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--random-init", choices=["tiny", "3b"], required=True,
                    help="seeded random weights: FO1Config.tiny() (with "
                         "the full vocabulary) in f32 or FO1Config() in "
                         "bf16")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:1, ..., or cpu")
    ap.add_argument("--image", default=None,
                    help="image path (default: synthetic 1288x966 image)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)

    cfg = FO1Config()
    if args.random_init == "tiny":
        # the full vocabulary, so that the prompt's token ids are labels
        tiny = FO1Config.tiny()
        cfg = dataclasses.replace(tiny, text=dataclasses.replace(
            tiny.text, vocab_size=cfg.text.vocab_size))
    dtype = torch.bfloat16 if args.random_init == "3b" else torch.float32
    model = FO1Model.random_init(cfg, seed=0, dtype=dtype, device=args.device,
                                 tokenizer=FallbackTokenizer())
    model.requires_grad_(True)
    dev = model.device
    card = "cpu"
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    messages = [{
        "role": "user",
        "content": [
            {"type": "image_url", "image_url": {"url": load_image(args.image)}},
            {"type": "text", "text": OD_template.format("orange")},
        ],
        "bbox_list": BBOX_LIST,
    }]
    prep = model.prepare(messages)
    batch = batch_from_prepared(cfg, prep)
    kw = dict(num_windows=prep["plan"].num_windows, grid=prep["grid"],
              remat=True)
    opt = adamw(model.parameters())
    step = make_train_step(model, opt, **kw)
    print(f"[{card}] {sum(p.numel() for p in model.parameters()) / 1e9:.3f}B "
          f"parameters {str(dtype)[6:]}, prompt {prep['splice'].seq_len} "
          f"tokens, {int((batch['labels'] >= 0).sum())} labelled, remat on")
    n_plain = args.steps - 1 if args.profile else args.steps
    for i in range(n_plain):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        _sync(dev)
        t0 = time.perf_counter()
        loss = step(batch).item()
        ms = (time.perf_counter() - t0) * 1e3
        peak = (f", peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
                " GiB" if dev.type == "cuda" else "")
        print(f"[{card}] step {i}: loss {loss:.5f}, {ms:.1f} ms{peak}")
    if args.profile:
        opt.zero_grad(set_to_none=True)
        parts = {}
        loss, *parts["forward (loss)"] = _profile(
            lambda: multimodal_lm_loss(model, batch, **kw), dev, args.top)
        _, *parts["backward"] = _profile(loss.backward, dev, args.top)
        _, *parts["optimizer step"] = _profile(opt.step, dev, args.top)
        print(f"[{card}] step {args.steps - 1} (profiled): loss "
              f"{loss.item():.5f}")
        for name, (wall_ms, busy_ms, rows) in parts.items():
            share = 100 * busy_ms / wall_ms if wall_ms else 0.0
            print(f"[{card}] {name}: wall {wall_ms:.1f} ms, kernels "
                  f"{busy_ms:.1f} ms ({share:.0f}% busy)")
            for key, count, ms in rows:
                print(f"[{card}]     {ms:8.2f} ms  {count:5d}x  {key}")
    if args.ckpt_dir:
        path = checkpointing.save_checkpoint(args.ckpt_dir, args.steps, model,
                                             opt)
        print(f"[{card}] saved {path}")


if __name__ == "__main__":
    main()
