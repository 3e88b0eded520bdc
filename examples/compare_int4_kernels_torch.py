"""Two designs of the int4 CUDA kernels, timed in one process on one card.

    python examples/compare_int4_kernels_torch.py --old-src DIR [--out FILE]

DIR holds an earlier design's int4 sources, `int4_core.cuh`,
`int4_matmul.cu` and `int4_mlp.cu` (for example written out with `git show
<commit>:vlm_fo1_tpu_torch/csrc/<file>`); the checkout's own sources are the
other design. Both are built with nvcc and swapped in as the wrappers'
libraries, so each number below goes through `ops.int4_matmul.int4_matmul`
and `ops.int4_mlp.int4_mlp` as the model calls them:

- every 3B trunk linear (q/o 2048->2048, k/v 2048->256, gate/up
  2048->11008, down 11008->2048) and the fused SwiGLU MLP (D = 2048,
  I = 11008) at M = 1 and M = 1771 (the prompt of the demo request with 7
  boxes), bf16: device ms per call from CUDA graph replays (weights rotated
  past the L2 cache at M = 1) and eager ms per call, for the two designs in
  turns (old, new, new, old), beside the plain version's ms, one PyTorch
  call on pre-dequantized bf16 weights (`F.linear`, three of them and a silu
  for the MLP) and the least time the card could take;
- the prefill of one grounding request of the 3B FO1 model (random seeded
  weights, the demo geometry) in the int4 and the int4-mlp serving modes,
  with each design in turns, over the same prepared and encoded request.

Prints the card's name and power limit and one JSON line; --out also
writes the JSON. Needs a CUDA card.
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

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402

NAMES = ("int4_matmul", "int4_mlp")


def build(src_dir, out_dir):
    """nvcc each int4 source of src_dir into out_dir (all at once)."""
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
            raise RuntimeError(f"nvcc {name} failed:\n{out}")
    return {n: os.path.join(out_dir, f"libfo1_{n}.so") for n in NAMES}


def libraries(paths):
    """The two wrappers' ctypes libraries from built paths. An earlier
    design's functions take one pointer fewer (no route); the extra
    argument is ignored by the C calling convention."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    mm = ctypes.CDLL(paths["int4_matmul"])
    mm.fo1_int4_matmul.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp,
                                   ctypes.POINTER(ci)]
    mm.fo1_int4_matmul.restype = ci
    mlp = ctypes.CDLL(paths["int4_mlp"])
    mlp.fo1_int4_mlp.argtypes = [vp] * 10 + [ci] * 6 + [vp, ctypes.POINTER(ci)]
    mlp.fo1_int4_mlp.restype = ci
    return mm, mlp


def in_turns(designs, use, measure):
    """measure() with each design in the order old, new, new, old."""
    out = {name: [] for name in designs}
    for name in ("old", "new", "new", "old"):
        use(designs[name])
        out[name].append(measure())
    return out


def kernel_times(i4, i4mlp, quant, designs, use):
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = {}
    for name, k, n in cs.TRUNK_LINEARS:
        packed, scale = quant.quantize_weight_int4(
            torch.randn(n, k, device="cuda", generator=gen) * 0.02)
        w_deq = (quant.unpack_int4(packed).float() * scale).t() \
            .to(torch.bfloat16).contiguous()
        for m in (1, cs.PREFILL_ROWS):
            xb = torch.randn(m, k, device="cuda", generator=gen) \
                .to(torch.bfloat16)
            cold = m == 1
            wq = cs._copies(packed.numel(), lambda: (
                packed.clone(), scale.clone())) if cold else [(packed, scale)]
            wl = cs._copies(w_deq.numel() * 2, lambda: (w_deq.clone(),)) \
                if cold else [(w_deq,)]

            def kernel(p, sc):
                return i4.int4_matmul(xb, p, sc)
            graph = in_turns(designs, use, lambda: cs._graph_ms(kernel, wq))
            eager = in_turns(designs, use,
                             lambda: cs._timeit_rotating(kernel, wq))
            nbytes = packed.numel() + 4 * n + 2 * m * k + 2 * m * n
            bound_ms, bound_by = cs._bound(nbytes, 2 * m * k * n,
                                           cs.BF16_FLOPS)
            rows[f"{name} M={m}"] = {
                "ms": graph, "eager_ms": eager,
                "plain_ms": cs._graph_ms(
                    lambda p, sc: i4.int4_matmul_reference(xb, p, sc), wq),
                "library_ms": cs._graph_ms(lambda w: F.linear(xb, w), wl),
                "bound_ms": bound_ms, "bound_by": bound_by}
            print(f"{name} M={m}: {json.dumps(rows[f'{name} M={m}'])}",
                  flush=True)
            del wq, wl
    d, i = 2048, 11008
    node = cs._mlp_node(quant, gen, d, i)
    lo, hi = quant.unpack_int4_halves(node["down_pk"])
    lib_w = [(quant.unpack_int4(node[k]).float() * node[s]).t()
             .to(torch.bfloat16).contiguous()
             for k, s in (("gate_pk", "gate_s"), ("up_pk", "up_s"))]
    lib_w.append((torch.cat([lo, hi], -1).float() * node["down_s"]).t()
                 .to(torch.bfloat16).contiguous())
    node_bytes = sum(t.numel() * t.element_size() for t in node.values())
    for m in (1, cs.PREFILL_ROWS):
        xb = torch.randn(m, d, device="cuda", generator=gen) \
            .to(torch.bfloat16)
        nodes = cs._copies(node_bytes, lambda: (
            {k: v.clone() for k, v in node.items()},)) if m == 1 \
            else [(node,)]

        def kernel(nd):
            return i4mlp.int4_mlp(xb, nd)
        graph = in_turns(designs, use, lambda: cs._graph_ms(kernel, nodes))
        eager = in_turns(designs, use,
                         lambda: cs._timeit_rotating(kernel, nodes))
        bound_ms, bound_by = cs._bound(node_bytes + 4 * m * d, 6 * m * d * i,
                                       cs.BF16_FLOPS)
        rows[f"mlp M={m}"] = {
            "ms": graph, "eager_ms": eager,
            "plain_ms": cs._graph_ms(
                lambda nd: i4mlp.int4_mlp_reference(xb, nd), nodes),
            "library_ms": cs._graph_ms(lambda g, u, dn: F.linear(
                F.silu(F.linear(xb, g)) * F.linear(xb, u), dn), [lib_w]),
            "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"mlp M={m}: {json.dumps(rows[f'mlp M={m}'])}", flush=True)
        del nodes
    return rows


def prefill_times(quant, designs, use, mode):
    """ms of one 3B prefill (the int4 products and the rest of the trunk)
    over one prepared and encoded demo request, each design in turns, twice
    each after a warm-up."""
    from vlm_fo1_tpu_torch.config import FO1Config
    from vlm_fo1_tpu_torch.models.fo1 import FO1Model
    from vlm_fo1_tpu_torch.runtime.fallback_tokenizer import (
        FallbackTokenizer,
    )
    from vlm_fo1_tpu_torch.task_templates import OD_template

    model = FO1Model.random_init(FO1Config(), seed=0, dtype=torch.bfloat16,
                                 device="cuda", tokenizer=FallbackTokenizer())
    quant.quantize_model(model, mode)
    prep = model.prepare(cs._messages(100, OD_template))
    vis, reg = model.encode(prep)
    emb = model.splice(prep, vis, reg)
    cache_len = prep["splice"].seq_len + 1

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(prep, emb, cache_len)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for name in ("old", "new"):
        use(designs[name])
        run()
    out = {name: [] for name in designs}
    for _ in range(2):
        for name, ms in in_turns(designs, use, run).items():
            out[name] += ms
    print(f"3B {mode} prefill ({prep['splice'].seq_len} tokens) ms: "
          f"{json.dumps(out)}", flush=True)
    del model
    torch.cuda.empty_cache()
    return {"prompt_tokens": prep["splice"].seq_len, "ms": out}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old-src", required=True,
                    help="directory with the earlier design's int4_core.cuh, "
                         "int4_matmul.cu and int4_mlp.cu")
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_int4_kernels_torch: needs a CUDA card", file=sys.stderr)
        return 1
    from vlm_fo1_tpu_torch import quant
    from vlm_fo1_tpu_torch.ops import cuda_lib
    from vlm_fo1_tpu_torch.ops import int4_matmul as i4
    from vlm_fo1_tpu_torch.ops import int4_mlp as i4mlp

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs._card()
    print(card, flush=True)
    cuda_lib.build(list(NAMES) + ["flash_attention"])
    designs = {
        "new": libraries({n: cuda_lib.library(n) for n in NAMES}),
        "old": libraries(build(os.path.abspath(args.old_src),
                               os.path.join(_ROOT, "build", "int4_old"))),
    }

    def use(libs):
        i4._lib, i4mlp._lib = libs

    result = {"card": card, "kernels": kernel_times(i4, i4mlp, quant,
                                                    designs, use)}
    for mode in ("int4", "int4-mlp"):
        result[f"prefill_{mode}"] = prefill_times(quant, designs, use, mode)
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
