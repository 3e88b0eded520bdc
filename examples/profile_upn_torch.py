"""Where the time of one UPN proposal request goes on the card.

    python examples/profile_upn_torch.py              # released geometry
    python examples/profile_upn_torch.py --random-init tiny --device cpu

Runs warm-up requests on a seeded synthetic 1288x966 image, then profiles
each stage of one more request (backbone, encoder, decoder) with
torch.profiler: the stage's wall time (ended by a device synchronise), the
summed time of the kernels it ran, their share of the wall time (the
device's busy share; one stream, so kernels do not overlap) and the kernels
that took the most device time. With --device cpu only the wall times mean
anything. --backward profiles, after a warm-up, the differentiable forward
(`UPN.predict`) and the backward of a fixed scalar of its boxes and logits
the same way.
"""

import argparse
import os
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_HERE), _HERE]

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from run_upn_torch import build_upn, load_image  # noqa: E402


def _device_us(row):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(row, name):
            return getattr(row, name)
    return 0.0


def _profile(fn, device, top):
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel rows carry device time and no CPU time of their own
    kernels = [r for r in prof.key_averages()
               if _device_us(r) > 0 and r.self_cpu_time_total == 0]
    kernels.sort(key=_device_us, reverse=True)
    busy_ms = sum(_device_us(r) for r in kernels) / 1e3
    rows = [(r.key[:70], r.count, _device_us(r) / 1e3) for r in kernels[:top]]
    return out, wall_ms, busy_ms, rows


def _profile_backward(model, x, valid, dev, args):
    """Forward and backward of sum(boxes * cb) + sum(logits * cl), cb and cl
    seeded, after args.warmup unprofiled rounds."""
    model.requires_grad_(True)
    gen = torch.Generator().manual_seed(0)
    nq = model.cfg.num_queries
    cb = torch.randn(1, nq, 4, generator=gen).to(dev)
    cl = torch.randn(1, nq, 1, generator=gen).to(dev)

    def forward():
        # x was made under inference mode; autograd may save only a copy
        out = model.predict(x.clone(), valid)
        return (out["pred_boxes"] * cb).sum() + (out["pred_logits"] * cl).sum()

    for _ in range(args.warmup):
        model.zero_grad(set_to_none=True)
        forward().backward()
    model.zero_grad(set_to_none=True)
    stages = {}
    loss, *stages["forward (differentiable)"] = _profile(forward, dev,
                                                         args.top)
    _, *stages["backward"] = _profile(loss.backward, dev, args.top)
    return stages


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--random-init", choices=["tiny", "3b"], default="3b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:1, ..., or cpu")
    ap.add_argument("--image", default=None,
                    help="image path (default: synthetic 1288x966 image)")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--backward", action="store_true")
    args = ap.parse_args(argv)
    args.upn_ckpt = None

    upn = build_upn(args)
    dev = upn.device
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    else:
        card = "cpu"
    image = load_image(args.image)
    for _ in range(args.warmup):
        upn.inference(image)
    padded, hw, _ = upn.prepare(image)
    model = upn.model
    with torch.inference_mode():
        x, valid = upn.model_input(padded[None], np.array([hw], np.int32))
        stages = {}
        feats, *stages["backbone"] = _profile(
            lambda: model.features(x, valid), dev, args.top)
        src, pos, shapes, ratios, key_pad = feats
        memory, *stages["encoder"] = _profile(
            lambda: model.encoder(src, pos, shapes, ratios, key_pad), dev,
            args.top)
        _, *stages["decoder"] = _profile(
            lambda: model.decoder(memory, shapes, ratios, key_pad,
                                  "fine_grained_prompt"), dev, args.top)
    print(f"[{card}] UPN request at padded {tuple(x.shape[1:3])}, levels "
          f"{shapes}")
    if args.backward:
        stages.update(_profile_backward(model, x, valid, dev, args))
    for name, (wall_ms, busy_ms, rows) in stages.items():
        print(f"[{card}] {name}: wall {wall_ms:.1f} ms, kernels "
              f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.0f}% busy)")
        for key, count, ms in rows:
            print(f"[{card}]     {ms:8.2f} ms  {count:5d}x  {key}")


if __name__ == "__main__":
    main()
