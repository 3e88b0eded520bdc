"""Designs of the MSDA CUDA kernels, timed in one process on one card.

    python examples/compare_msda_kernels_torch.py --old-src DIR \
        [--design NAME=DIR ...] [--out FILE]

DIR holds an earlier design's `msda.cu` and `msda_bwd.cu`, with any header
they include (for example written out with `git show
<commit>:vlm_fo1_tpu_torch/csrc/<file>`); the checkout's own sources are
the design "new". Each `--design` adds another directory of the same kind
(a patched copy, say). Every design is built with nvcc and swapped in as the
wrappers' libraries, so each number goes through `ops.msda` as UPN calls it:

- one UPN request at the released geometry (Swin-L + UPNConfig(), bf16,
  random seeded weights, a seeded synthetic 1288x966 image) is run once to
  capture its encoder's and decoder's MSDA inputs. On those inputs, for each
  design in turns (old, new, the others, then back in reverse): the forward
  and the backward (with a seeded upstream gradient) as device ms per call
  from CUDA graph replays and as eager ms per call, each checked against
  the plain version by the worst relative L2 error of one row
  (chip_smoke.py's bound), beside the plain version's ms and the least time
  the card could take;
- with each design in turns: UPN proposal requests (stage ms), and UPN's
  forward + backward of a fixed scalar of its outputs (ms).

Prints the card's name and power limit and one JSON line; --out also writes
the JSON. Needs a CUDA card.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
sys.path[:0] = [_ROOT, _HERE]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

NAMES = ("msda", "msda_bwd")


def build(src_dir, out_dir):
    """nvcc msda.cu and msda_bwd.cu of src_dir into out_dir (both at once)."""
    os.makedirs(out_dir, exist_ok=True)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "nvcc")
    procs = []
    for name in NAMES:
        lib = os.path.join(out_dir, f"libfo1_{name}.so")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib,
               os.path.join(src_dir, f"{name}.cu")]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {src_dir}/{name}.cu failed:\n{out}")
    return {n: os.path.join(out_dir, f"libfo1_{n}.so") for n in NAMES}


def libraries(paths):
    """The two wrappers' ctypes libraries (every design has the same C
    entry points)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fwd = ctypes.CDLL(paths["msda"])
    fwd.fo1_msda_fwd.argtypes = [vp] * 5 + [ci] * 8 + [vp]
    fwd.fo1_msda_fwd.restype = ci
    bwd = ctypes.CDLL(paths["msda_bwd"])
    bwd.fo1_msda_bwd.argtypes = [vp] * 8 + [ci] * 8 + [vp]
    bwd.fo1_msda_bwd.restype = ci
    return fwd, bwd


def in_turns(designs, use, measure):
    """measure() with each design, in order and then in reverse."""
    order = list(designs)
    out = {name: [] for name in order}
    for name in order + order[::-1]:
        use(designs[name])
        out[name].append(measure())
    return out


def capture(upn, msda, image):
    """The encoder's and decoder's MSDA inputs of one UPN request."""
    padded, hw, _ = upn.prepare(image)
    x, valid = upn.model_input(padded[None], np.array([hw], np.int32))
    captured = {}

    def record(value, shapes, loc, aw):
        key = "encoder" if loc.shape[1] == value.shape[1] else "decoder"
        captured.setdefault(key, (value, shapes, loc, aw))
        return msda.ms_deform_attn_core(value, shapes, loc, aw)

    upn.model.use_msda_core(record)
    with torch.no_grad():
        upn.model(x, valid)
    upn.model.use_msda_core(msda.ms_deform_attn_core)
    return captured


def kernel_times(msda, designs, use, captured):
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = {}
    for key in ("encoder", "decoder"):
        value, shapes, loc, aw = captured[key]
        d = value.shape[-1]
        g = torch.randn(value.shape[0], loc.shape[1],
                        value.shape[2] * d, device="cuda", generator=gen)
        ref = msda.ms_deform_attn_core_reference(value.float(), shapes, loc,
                                                 aw)
        bref = msda.ms_deform_attn_core_backward_reference(
            value.float(), shapes, loc, aw, g)

        def fwd():
            return msda._forward_kernel(value, shapes, loc, aw)

        def bwd():
            return msda.ms_deform_attn_core_backward(value, shapes, loc, aw,
                                                     g)

        def checked():
            out = fwd()
            grads = bwd()
            torch.cuda.synchronize()
            return {"row_rel": cs._msda_row_rel(out, ref, d),
                    "bwd_row_rel": cs._msda_bwd_rows(value, loc, grads,
                                                     bref)}

        row = {
            "fwd_graph_ms": in_turns(designs, use,
                                     lambda: cs._graph_ms(fwd, [()])),
            "fwd_eager_ms": in_turns(designs, use, lambda: cs._timeit(fwd)),
            "bwd_graph_ms": in_turns(designs, use,
                                     lambda: cs._graph_ms(bwd, [()])),
            "bwd_eager_ms": in_turns(designs, use, lambda: cs._timeit(bwd)),
            "checks": in_turns(designs, use, checked),
            "fwd_plain_ms": cs._timeit(lambda: msda.ms_deform_attn_core_reference(
                value, shapes, loc, aw), n=3),
            "bwd_plain_ms": cs._timeit(
                lambda: msda.ms_deform_attn_core_backward_reference(
                    value, shapes, loc, aw, g), n=3),
        }
        nbytes, flops = cs._msda_cost(value, shapes, loc)
        row["fwd_bound_ms"] = cs._bound(nbytes, flops, cs.F32_FLOPS)
        nbytes, flops = cs._msda_bwd_cost(value, shapes, loc)
        row["bwd_bound_ms"] = cs._bound(nbytes, flops, cs.F32_FLOPS)
        row["shape"] = {"value": list(value.shape), "lq": loc.shape[1]}
        print(f"{key}: {json.dumps(row)}", flush=True)
        rows[key] = row
    return rows


def upn_times(upn, designs, use):
    """UPN requests (stage ms) and forward + backward ms, each design in
    turns after a warm-up with each."""
    images = [cs._synthetic_image(500 + i) for i in range(2)]
    for name in designs:
        use(designs[name])
        upn.inference(images[0])

    def request():
        runs = []
        for img in images:
            stage = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            upn.inference(img, stage_ms=stage)
            stage["total"] = (time.perf_counter() - t0) * 1e3
            runs.append({k: round(v, 2) for k, v in stage.items()})
        return runs

    requests = in_turns(designs, use, request)
    model = upn.model.requires_grad_(True)
    padded, hw, _ = upn.prepare(images[1])
    x, valid = upn.model_input(padded[None], np.array([hw], np.int32))
    gen = torch.Generator(device="cuda").manual_seed(9)
    nq = model.cfg.num_queries
    cb = torch.randn(1, nq, 4, device="cuda", generator=gen)
    cl = torch.randn(1, nq, 1, device="cuda", generator=gen)

    def fwd_bwd():
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.predict(x, valid)
        loss = ((out["pred_boxes"] * cb).sum()
                + (out["pred_logits"] * cl).sum())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return {"forward_ms": round((t1 - t0) * 1e3, 2),
                "backward_ms": round((t2 - t1) * 1e3, 2)}

    for name in designs:
        use(designs[name])
        fwd_bwd()
    train = in_turns(designs, use, fwd_bwd)
    model.requires_grad_(False)
    model.zero_grad(set_to_none=True)
    print(f"UPN requests: {json.dumps(requests)}", flush=True)
    print(f"UPN forward+backward: {json.dumps(train)}", flush=True)
    return {"requests": requests, "forward_backward": train}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old-src", required=True,
                    help="directory with the earlier design's msda.cu and "
                         "msda_bwd.cu")
    ap.add_argument("--design", action="append", default=[],
                    metavar="NAME=DIR", help="another design to time")
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_msda_kernels_torch: needs a CUDA card",
              file=sys.stderr)
        return 1
    from vlm_fo1_tpu_torch.ops import cuda_lib, msda
    from vlm_fo1_tpu_torch.upn import wrapper as upn_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs._card()
    print(card, flush=True)
    cuda_lib.build(list(NAMES))
    sources = {"old": args.old_src}
    for spec in args.design:
        name, _, src = spec.partition("=")
        sources[name] = src
    designs = {"old": None,
               "new": libraries({n: cuda_lib.library(n) for n in NAMES})}
    for name, src in sources.items():
        designs[name] = libraries(build(
            os.path.abspath(src),
            os.path.join(_ROOT, "build", "msda_designs", name)))

    def use(libs):
        msda._lib, msda._lib_bwd = libs

    upn = upn_mod.UPNWrapper.random_init(seed=0, dtype=torch.bfloat16,
                                         device="cuda")
    use(designs["new"])
    captured = capture(upn, msda, cs._synthetic_image(200))
    result = {"card": card, "designs": list(designs),
              "kernels": kernel_times(msda, designs, use, captured)}
    del captured
    torch.cuda.empty_cache()
    result["upn"] = upn_times(upn, designs, use)
    use(designs["new"])
    line = json.dumps(result)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
