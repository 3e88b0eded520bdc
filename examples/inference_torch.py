"""Demo: box-conditioned object detection with the PyTorch port of FO1.

The counterpart of examples/inference.py: 7 provided boxes + an OD prompt
-> grounded `<region>` answer -> drawn boxes. No checkpoint loader is ported
yet, so the weights are random (`--random-init tiny|3b`, seeded).

    python examples/inference_torch.py --random-init tiny --device cpu
    python examples/inference_torch.py --random-init 3b
    python examples/inference_torch.py --random-init 3b --quant int4

`--quant` picks a serving mode of `vlm_fo1_tpu_torch.quant` (int8, int8-all,
w8a8, int4, int4-mlp), applied to the weights before the request.

Without --image a seeded synthetic 1288x966 image stands in for the demo
photo.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from vlm_fo1_tpu_torch.config import FO1Config  # noqa: E402
from vlm_fo1_tpu_torch.models.fo1 import FO1Model  # noqa: E402
from vlm_fo1_tpu_torch.postprocess import (  # noqa: E402
    draw_bboxes_and_save,
    extract_predictions_to_bboxes,
)
from vlm_fo1_tpu_torch.quant import MODES, quantize_model  # noqa: E402
from vlm_fo1_tpu_torch.runtime.fallback_tokenizer import (  # noqa: E402
    FallbackTokenizer,
)
from vlm_fo1_tpu_torch.task_templates import OD_template  # noqa: E402

BBOX_LIST = [
    [161.0, 11.0, 292.0, 127.0], [268.0, 61.0, 428.0, 226.0],
    [12.0, 100.0, 140.0, 227.0], [205.0, 188.0, 332.0, 320.0],
    [326.0, 202.0, 478.0, 357.0], [136.0, 106.0, 269.0, 233.0],
    [25.0, 206.0, 200.0, 383.0],
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--random-init", choices=["tiny", "3b"], required=True,
                    help="model size; weights are random (seeded)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:1, ..., or cpu")
    ap.add_argument("--image", default=None,
                    help="image path (default: synthetic 1288x966 image)")
    ap.add_argument("--target", default="orange")
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--output", default=None,
                    help="save the image with the parsed boxes drawn")
    ap.add_argument("--quant", choices=MODES, default="none",
                    help="serving mode: weight quantization applied after "
                         "the random init")
    args = ap.parse_args(argv)

    if args.image:
        image = Image.open(args.image).convert("RGB")
    else:
        rng = np.random.default_rng(0)
        image = Image.fromarray(rng.integers(0, 256, (966, 1288, 3), np.uint8))
    messages = [{
        "role": "user",
        "content": [
            {"type": "image_url", "image_url": {"url": image}},
            {"type": "text", "text": OD_template.format(args.target)},
        ],
        "bbox_list": BBOX_LIST,
    }]
    cfg = FO1Config.tiny() if args.random_init == "tiny" else FO1Config()
    dtype = torch.bfloat16 if args.random_init == "3b" else torch.float32
    model = FO1Model.random_init(cfg, seed=0, dtype=dtype, device=args.device,
                                 tokenizer=FallbackTokenizer())
    quantize_model(model, args.quant)
    stage_ms = {}
    result = model.generate(messages, max_new_tokens=args.max_new_tokens,
                            stage_ms=stage_ms)
    print("model output:", result.text)
    print("stage ms:", {k: round(v, 1) for k, v in stage_ms.items()})
    bboxes = extract_predictions_to_bboxes(result.text, BBOX_LIST)
    print("parsed boxes:", bboxes)
    if args.output:
        draw_bboxes_and_save(image=image, fo1_bboxes=bboxes,
                             output_path=args.output)
        print("saved:", args.output)


if __name__ == "__main__":
    main()
