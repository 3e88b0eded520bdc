"""UPN proposals -> FO1 grounded answer with the PyTorch port (counterpart of
examples/inference_with_upn.py, reference scripts/inference_with_upn.py).

    python examples/inference_with_upn_torch.py --random-init tiny --device cpu
    python examples/inference_with_upn_torch.py --random-init 3b

UPN proposes boxes (score filter + NMS), at most --max-boxes of them go into
one FO1 grounding request, and the `<regionN>` answer is parsed back to
boxes. No FO1 checkpoint loader is ported yet, so FO1's weights are random
(seeded); `3b` pairs the released UPN geometry with the 3B FO1 in bfloat16.
Without --image a seeded synthetic 1288x966 image stands in for the demo
photo.
"""

import argparse
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_HERE), _HERE]

import torch  # noqa: E402

from run_upn_torch import (  # noqa: E402
    add_upn_args,
    build_upn,
    load_image,
    proposals,
)
from vlm_fo1_tpu_torch.config import FO1Config  # noqa: E402
from vlm_fo1_tpu_torch.models.fo1 import FO1Model  # noqa: E402
from vlm_fo1_tpu_torch.postprocess import (  # noqa: E402
    draw_bboxes_and_save,
    extract_predictions_to_bboxes,
)
from vlm_fo1_tpu_torch.runtime.fallback_tokenizer import (  # noqa: E402
    FallbackTokenizer,
)
from vlm_fo1_tpu_torch.task_templates import OD_template  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_upn_args(ap)
    ap.add_argument("--target", default="orange")
    ap.add_argument("--max-boxes", type=int, default=100)
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--output", default=None,
                    help="save the image with the parsed boxes drawn")
    args = ap.parse_args(argv)
    if args.random_init is None:
        ap.error("--random-init tiny|3b is required (FO1 weights are random)")

    upn = build_upn(args)
    image = load_image(args.image)
    bbox_list = proposals(upn, image, args.min_score)[:args.max_boxes]
    print(f"UPN proposals: {len(bbox_list)}")

    messages = [{
        "role": "user",
        "content": [{"type": "image_url", "image_url": {"url": image}},
                    {"type": "text", "text": OD_template.format(args.target)}],
        "bbox_list": bbox_list,
    }]
    tiny = args.random_init == "tiny"
    fo1 = FO1Model.random_init(
        FO1Config.tiny() if tiny else FO1Config(), seed=0,
        dtype=torch.float32 if tiny else torch.bfloat16, device=args.device,
        tokenizer=FallbackTokenizer())
    stage_ms = {}
    result = fo1.generate(messages, max_new_tokens=args.max_new_tokens,
                          max_pixels=256 * 256, stage_ms=stage_ms)
    print("model output:", result.text)
    print("stage ms:", {k: round(v, 1) for k, v in stage_ms.items()})
    bboxes = extract_predictions_to_bboxes(result.text, bbox_list)
    print("parsed boxes:", bboxes)
    if args.output:
        draw_bboxes_and_save(image=image, fo1_bboxes=bboxes,
                             detection_bboxes=bbox_list,
                             output_path=args.output)
        print("saved:", args.output)


if __name__ == "__main__":
    main()
