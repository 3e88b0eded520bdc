"""UPN-only proposals with the PyTorch port (counterpart of examples/run_upn.py,
reference scripts/run_upn.py).

    python examples/run_upn_torch.py --random-init tiny --device cpu
    python examples/run_upn_torch.py --random-init 3b
    python examples/run_upn_torch.py --ckpt upn_large.pth --image photo.jpg

`--random-init 3b` is the released UPN geometry (Swin-L + UPNConfig(), the
proposal network served with the 3B FO1) with seeded random weights, in
bfloat16; `tiny` is a small seeded model in float32. Without --image a
seeded synthetic 1288x966 image stands in for the demo photo.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from vlm_fo1_tpu_torch.postprocess import draw_bboxes_and_save  # noqa: E402
from vlm_fo1_tpu_torch.upn.model import UPNConfig  # noqa: E402
from vlm_fo1_tpu_torch.upn.swin import SwinConfig  # noqa: E402
from vlm_fo1_tpu_torch.upn.wrapper import UPNWrapper  # noqa: E402

TINY_SWIN = SwinConfig(embed_dim=16, depths=(1, 1, 2, 1),
                       num_heads=(1, 2, 4, 8), window_size=4)
TINY_UPN = UPNConfig(d_model=32, n_heads=4, n_points=2, num_encoder_layers=2,
                     num_decoder_layers=2, d_ffn=64, num_queries=20,
                     gn_groups=8, pos_feats=16)


def add_upn_args(ap):
    ap.add_argument("--upn-ckpt", "--ckpt", dest="upn_ckpt", default=None,
                    help="reference UPN .pth checkpoint")
    ap.add_argument("--trust-checkpoint", action="store_true",
                    help="unpickle any object the checkpoint holds (runs "
                         "code from the file; only for a trusted source)")
    ap.add_argument("--random-init", choices=["tiny", "3b"], default=None,
                    help="seeded random weights instead of a checkpoint")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:1, ..., or cpu")
    ap.add_argument("--image", default=None,
                    help="image path (default: synthetic 1288x966 image)")
    ap.add_argument("--min-score", type=float, default=0.3)


def load_image(path):
    if path:
        return Image.open(path).convert("RGB")
    rng = np.random.default_rng(0)
    return Image.fromarray(rng.integers(0, 256, (966, 1288, 3), np.uint8))


def build_upn(args) -> UPNWrapper:
    if args.upn_ckpt:
        return UPNWrapper(args.upn_ckpt, device=args.device,
                          trusted=args.trust_checkpoint)
    if args.random_init == "tiny":
        return UPNWrapper.random_init(TINY_UPN, TINY_SWIN, seed=0,
                                      device=args.device)
    if args.random_init == "3b":
        return UPNWrapper.random_init(seed=0, dtype=torch.bfloat16,
                                      device=args.device)
    raise SystemExit("--upn-ckpt or --random-init is required")


def proposals(upn: UPNWrapper, image, min_score: float,
              prompt: str = "fine_grained_prompt"):
    """Score filter + NMS over the proposals of one image -> xyxy pixel
    boxes, best first."""
    raw = upn.inference(image, prompt_type=prompt)
    det = upn.filter(raw, min_score=min_score, nms_value=0.8)
    return [[float(v) for v in b] for b in det["original_xyxy_boxes"][0]]


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_upn_args(ap)
    ap.add_argument("--prompt", default="fine_grained_prompt",
                    choices=["fine_grained_prompt", "coarse_grained_prompt"])
    ap.add_argument("--output", default=None,
                    help="save the image with the proposals drawn")
    args = ap.parse_args(argv)

    upn = build_upn(args)
    image = load_image(args.image)
    boxes = proposals(upn, image, args.min_score, args.prompt)
    print(f"{len(boxes)} proposals above {args.min_score}")
    print("top proposals:", boxes[:5])
    if args.output:
        draw_bboxes_and_save(image=image, detection_bboxes=boxes,
                             output_path=args.output)
        print("saved:", args.output)


if __name__ == "__main__":
    main()
