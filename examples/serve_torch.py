"""Batched and continuous serving with the PyTorch port of FO1.

    python examples/serve_torch.py --random-init tiny --device cpu
    python examples/serve_torch.py --random-init 3b --mode serving
    python examples/serve_torch.py --model-path /path/to/VLM-FO1 --mode continuous

Modes:
  batch       one `FO1Model.generate_batch` over all requests
  serving     `ServingPipeline` (geometry-grouped unless --fifo)
  continuous  `ContinuousServingPipeline`, budgets alternating between
              --max-new-tokens and a quarter of it
  upn-fo1     `UPNFO1Pipeline`: UPN proposals, then one FO1 request each

Requests are grounding prompts on seeded synthetic images of two sizes, with
boxes scaled from the demo's 7 (upn-fo1 takes UPN's proposals instead).
`--random-init tiny|3b` draws seeded random weights; `--model-path` loads a
released checkpoint directory (`api.load_pretrained_model`). Prints each
request's result and the pipeline's stats.
"""

import argparse
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_HERE), _HERE]

import numpy as np  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from vlm_fo1_tpu_torch.config import FO1Config  # noqa: E402
from vlm_fo1_tpu_torch.models.fo1 import FO1Model  # noqa: E402
from vlm_fo1_tpu_torch.postprocess import (  # noqa: E402
    extract_predictions_to_bboxes,
)
from vlm_fo1_tpu_torch.runtime import serving  # noqa: E402
from vlm_fo1_tpu_torch.runtime.fallback_tokenizer import (  # noqa: E402
    FallbackTokenizer,
)
from vlm_fo1_tpu_torch.task_templates import OD_template  # noqa: E402

DEMO_BOXES = np.array([
    [161.0, 11.0, 292.0, 127.0], [268.0, 61.0, 428.0, 226.0],
    [12.0, 100.0, 140.0, 227.0], [205.0, 188.0, 332.0, 320.0],
    [326.0, 202.0, 478.0, 357.0], [136.0, 106.0, 269.0, 233.0],
    [25.0, 206.0, 200.0, 383.0],
])
SIZES = {"tiny": [(120, 160), (96, 128)], "3b": [(966, 1288), (768, 1024)]}


def _image(seed, size):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (*size, 3), np.uint8))


def _request(i, size):
    """A grounding prompt on image i with the demo boxes scaled to it."""
    h, w = size
    boxes = (DEMO_BOXES * [w / 640, h / 480, w / 640, h / 480]).round(1)
    return [{
        "role": "user",
        "content": [{"type": "image_url",
                     "image_url": {"url": _image(i, size)}},
                    {"type": "text", "text": OD_template.format("orange")}],
        "bbox_list": boxes.tolist(),
    }]


def _model(args):
    if args.model_path:
        from vlm_fo1_tpu_torch.api import load_pretrained_model

        _, facade, _ = load_pretrained_model(args.model_path,
                                             device=args.device)
        model = facade._model
        if model.tokenizer is None:
            model.tokenizer = FallbackTokenizer()
        return model
    cfg = FO1Config.tiny() if args.random_init == "tiny" else FO1Config()
    dtype = torch.bfloat16 if args.random_init == "3b" else torch.float32
    return FO1Model.random_init(cfg, seed=0, dtype=dtype, device=args.device,
                                tokenizer=FallbackTokenizer())


def _print_result(i, res, boxes):
    found = extract_predictions_to_bboxes(res.text, boxes)
    print(f"request {i}: prompt {res.prompt_len} tokens, {res.num_steps} "
          f"steps, answer boxes {found}, text {res.text[:60]!r}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="batch",
                    choices=["batch", "serving", "continuous", "upn-fo1"])
    ap.add_argument("--random-init", choices=["tiny", "3b"], default=None,
                    help="model size; weights are random (seeded)")
    ap.add_argument("--model-path", default=None,
                    help="released checkpoint directory")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:1, ..., or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--fifo", action="store_true",
                    help="serving mode: FIFO batches, not grouped by grid")
    args = ap.parse_args(argv)
    if (args.random_init is None) == (args.model_path is None):
        ap.error("give one of --random-init tiny|3b and --model-path")

    model = _model(args)
    sizes = SIZES["3b" if args.random_init != "tiny" else "tiny"]
    reqs = [_request(i, sizes[i % 2 if args.mode != "continuous" else 0])
            for i in range(args.requests)]
    boxes = [r[0]["bbox_list"] for r in reqs]
    t0 = time.perf_counter()
    stats = {}
    if args.mode == "batch":
        results = model.generate_batch(reqs,
                                       max_new_tokens=args.max_new_tokens)
    elif args.mode == "serving":
        pipe = serving.ServingPipeline(model, serving.ServingOptions(
            batch_size=args.batch_size, max_new_tokens=args.max_new_tokens,
            geometry_group=not args.fifo))
        results = pipe.run(reqs)
        stats = pipe.stats
    elif args.mode == "continuous":
        budgets = [args.max_new_tokens if i % 2 else
                   max(1, args.max_new_tokens // 4)
                   for i in range(args.requests)]
        pipe = serving.ContinuousServingPipeline(
            model, serving.ContinuousOptions(
                batch_size=args.batch_size, chunk=8,
                max_new_tokens=args.max_new_tokens))
        results = pipe.run([{"messages": r, "max_new_tokens": b}
                            for r, b in zip(reqs, budgets)])
        stats = pipe.stats
    else:
        from run_upn_torch import TINY_SWIN, TINY_UPN
        from vlm_fo1_tpu_torch.upn.wrapper import UPNWrapper

        if args.random_init == "tiny":
            upn = UPNWrapper.random_init(TINY_UPN, TINY_SWIN, seed=0,
                                         device=args.device)
        else:
            upn = UPNWrapper.random_init(seed=0, dtype=torch.bfloat16,
                                         device=args.device)
        pipe = serving.UPNFO1Pipeline(upn, model, serving.UPNFO1Options(
            batch_size=args.batch_size, min_score=0.0,
            max_new_tokens=args.max_new_tokens))
        out = pipe.run([{"image": r[0]["content"][0]["image_url"]["url"],
                         "text": OD_template.format("orange")}
                        for r in reqs])
        for i, o in enumerate(out):
            print(f"request {i}: {len(o['proposals'])} proposals, answer "
                  f"boxes {o['fo1_bboxes']}, text {o['text'][:60]!r}")
        results = None
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    wall = time.perf_counter() - t0
    for i, res in enumerate(results or []):
        _print_result(i, res, boxes[i])
    print(f"{args.mode}: {args.requests} requests in {wall:.2f} s "
          f"({args.requests / wall:.2f} requests/s) on {model.device}")
    if stats:
        print("stats:", stats)


if __name__ == "__main__":
    main()
