"""Two designs of the int4 CUDA kernels, timed in one process on one card.

    python examples/compare_int4_kernels_torch.py --old-src DIR \
        [--rows 1 2 4 8] [--decode] [--prefill] [--out FILE]

DIR holds an earlier design's int4 sources, `int4_core.cuh`,
`int4_matmul.cu` and `int4_mlp.cu` (for example written out with `git show
<commit>:vlm_fo1_tpu_torch/csrc/<file>`); the checkout's own sources are the
other design. Both are built with nvcc and swapped in as the wrappers'
libraries, so each number below goes through `ops.int4_matmul.int4_matmul`
and `ops.int4_mlp.int4_mlp` as the model calls them. A design whose
streaming route still takes a workspace and a second launch (the
interface before the single-launch route: no plan arguments and no capacity
query) is called through `LegacyMatmul` / `LegacyMLP`, which allocate its
workspace and size its slices as its own wrapper did.

- every 3B trunk linear (q/o 2048->2048, k/v 2048->256, gate/up
  2048->11008, down 11008->2048) and the fused SwiGLU MLP (D = 2048,
  I = 11008) at each M of --rows (the decode rows; 1771 is the prompt of
  the demo request with 7 boxes), bf16: device ms per call from CUDA graph
  replays (weights rotated past the L2 cache at M <= 8) and eager ms per
  call, for the two designs in turns (old, new, new, old), beside the
  plain version's ms, one PyTorch call on pre-dequantized bf16 weights
  (`F.linear`, three of them and a silu for the MLP) and the least time
  the card could take;
- with --decode, the 3B FO1 model's masked decode step (random seeded
  weights, a demo request's cache) in the int4 and the int4-mlp serving
  modes at B = 1 and 8, from CUDA graphs, each design in turns (the decode
  programs are dropped at each swap, so each design is captured anew);
- with --prefill, the prefill of one grounding request (the demo
  geometry) in both modes, each design in turns, over the same prepared
  and encoded request;
- first, the checkout's streaming plan for each 3B product beside the
  clusters of 1-8 blocks the card holds at once, which the plan reads.

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


class LegacyMatmul:
    """The wrapper's view (`fo1_int4_matmul` with the plan arguments) of a
    library whose streaming route takes an f32 workspace of splits x M x N
    and a second launch: its slices and workspace as its own wrapper sized
    them (`fma_splits` over the card's SMs)."""

    def __init__(self, lib, current):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        self.lib = lib
        lib.fo1_int4_matmul.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                        ci, vp, ctypes.POINTER(ci)]
        lib.fo1_int4_matmul.restype = ci
        # the wrapper plans the current design's streaming route with this
        self.fo1_int4_matmul_capacity = current.fo1_int4_matmul_capacity

    def fo1_int4_matmul(self, x, packed, scale, out, ws, m, k, n, splits,
                        rows_per, dtype, stream, route):
        from vlm_fo1_tpu_torch.ops import int4_matmul as i4

        if m <= i4.SKINNY_ROWS:
            splits = i4.fma_splits(k // 2, n, i4.sm_count(
                torch.cuda.current_device()))
            ws = torch.empty(splits * m * n, dtype=torch.float32,
                             device="cuda")
            return self.lib.fo1_int4_matmul(x, packed, scale, out,
                                            ws.data_ptr(), m, k, n, splits,
                                            dtype, stream, route)
        return self.lib.fo1_int4_matmul(x, packed, scale, out, ws, m, k, n,
                                        splits, dtype, stream, route)


class LegacyMLP:
    """`fo1_int4_mlp` with the plan arguments over a library that takes a
    workspace of max(2 s1 M I, s2 M D) floats at M <= 8."""

    def __init__(self, lib, current):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        self.lib = lib
        lib.fo1_int4_mlp.argtypes = [vp] * 10 + [ci] * 6 + [
            vp, ctypes.POINTER(ci)]
        lib.fo1_int4_mlp.restype = ci
        self.fo1_int4_mlp_capacity = current.fo1_int4_mlp_capacity

    def fo1_int4_mlp(self, x, gate, gs, up, us, down, ds, h, ws, out, m, d,
                     i, s1, r1, s2, r2, dtype, stream, route):
        from vlm_fo1_tpu_torch.ops import int4_matmul as i4

        if m <= i4.SKINNY_ROWS:
            sms = i4.sm_count(torch.cuda.current_device())
            s1 = i4.fma_splits(d // 2, i, sms)
            s2 = i4.fma_splits(i, d // 2, sms)
            ws = torch.empty(max(2 * s1 * m * i, s2 * m * d),
                             dtype=torch.float32, device="cuda")
            ws = ws.data_ptr()
        return self.lib.fo1_int4_mlp(x, gate, gs, up, us, down, ds, h, ws,
                                     out, m, d, i, s1, s2, dtype, stream,
                                     route)


def libraries(paths, current):
    """An earlier design's two libraries from built paths: one with the
    checkout's interface is bound as the wrappers bind theirs; one without
    the plan arguments goes through LegacyMatmul / LegacyMLP. `current` is
    the checkout's pair (the capacity queries that plan the wrappers'
    calls)."""
    mm = ctypes.CDLL(paths["int4_matmul"])
    mlp = ctypes.CDLL(paths["int4_mlp"])
    if not hasattr(mm, "fo1_int4_matmul_capacity"):
        return LegacyMatmul(mm, current[0]), LegacyMLP(mlp, current[1])
    vp, ci = ctypes.c_void_p, ctypes.c_int
    mm.fo1_int4_matmul.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                   ci, vp, ctypes.POINTER(ci)]
    mm.fo1_int4_matmul.restype = ci
    mm.fo1_int4_matmul_capacity.argtypes = [ci, ci]
    mm.fo1_int4_matmul_capacity.restype = ci
    mlp.fo1_int4_mlp.argtypes = [vp] * 10 + [ci] * 8 + [
        vp, ctypes.POINTER(ci)]
    mlp.fo1_int4_mlp.restype = ci
    mlp.fo1_int4_mlp_capacity.argtypes = [ci, ci, ci]
    mlp.fo1_int4_mlp_capacity.restype = ci
    return mm, mlp


def in_turns(designs, use, measure):
    """measure() with each design in the order old, new, new, old."""
    out = {name: [] for name in designs}
    for name in ("old", "new", "new", "old"):
        use(designs[name])
        out[name].append(measure())
    return out


def kernel_times(i4, i4mlp, quant, designs, use, rows):
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    for name, k, n in cs.TRUNK_LINEARS:
        packed, scale = quant.quantize_weight_int4(
            torch.randn(n, k, device="cuda", generator=gen) * 0.02)
        w_deq = (quant.unpack_int4(packed).float() * scale).t() \
            .to(torch.bfloat16).contiguous()
        for m in rows:
            xb = torch.randn(m, k, device="cuda", generator=gen) \
                .to(torch.bfloat16)
            cold = m <= i4.SKINNY_ROWS
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
            out[f"{name} M={m}"] = {
                "ms": graph, "eager_ms": eager,
                "plain_ms": cs._graph_ms(
                    lambda p, sc: i4.int4_matmul_reference(xb, p, sc), wq),
                "library_ms": cs._graph_ms(lambda w: F.linear(xb, w), wl),
                "bound_ms": bound_ms, "bound_by": bound_by}
            print(f"{name} M={m}: {json.dumps(out[f'{name} M={m}'])}",
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
    for m in rows:
        xb = torch.randn(m, d, device="cuda", generator=gen) \
            .to(torch.bfloat16)
        nodes = cs._copies(node_bytes, lambda: (
            {k: v.clone() for k, v in node.items()},)) \
            if m <= i4.SKINNY_ROWS else [(node,)]

        def kernel(nd):
            return i4mlp.int4_mlp(xb, nd)
        graph = in_turns(designs, use, lambda: cs._graph_ms(kernel, nodes))
        eager = in_turns(designs, use,
                         lambda: cs._timeit_rotating(kernel, nodes))
        bound_ms, bound_by = cs._bound(node_bytes + 4 * m * d, 6 * m * d * i,
                                       cs.BF16_FLOPS)
        out[f"mlp M={m}"] = {
            "ms": graph, "eager_ms": eager,
            "plain_ms": cs._graph_ms(
                lambda nd: i4mlp.int4_mlp_reference(xb, nd), nodes),
            "library_ms": cs._graph_ms(lambda g, u, dn: F.linear(
                F.silu(F.linear(xb, g)) * F.linear(xb, u), dn), [lib_w]),
            "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"mlp M={m}: {json.dumps(out[f'mlp M={m}'])}", flush=True)
        del nodes
    return out


def capacities(i4, i4mlp):
    """The streaming route's plan for each 3B product and, for each split
    of 1-8 blocks, the clusters the card holds at once
    (cudaOccupancyMaxActiveClusters through the libraries' capacity
    queries) that the plan was chosen from."""
    mm, mlp = i4._load(), i4mlp._load()
    index = torch.cuda.current_device()
    products = [(f"int4_matmul {name}", k // 2, n, mm.fo1_int4_matmul_capacity)
                for name, k, n in cs.TRUNK_LINEARS]
    products += [("int4_mlp gate_up", 1024, 11008,
                  lambda s, r: mlp.fo1_int4_mlp_capacity(0, s, r)),
                 ("int4_mlp down", 11008, 1024,
                  lambda s, r: mlp.fo1_int4_mlp_capacity(1, s, r))]
    out = {}
    for name, rows, cols, cap in products:
        steps = -(-rows // i4.STREAM_STEP)
        held = [cap(s, -(-steps // s) * i4.STREAM_STEP)
                for s in range(1, i4.STREAM_MAX_SPLIT + 1)]
        plan = i4.cluster_plan(rows, cols, i4.sm_count(index), cap)
        out[name] = {"clusters_held_by_split": held, "plan": plan}
        print(f"{name}: clusters held at once for splits 1-8 {held}, plan "
              f"(splits, rows a block) {plan}", flush=True)
    return out


def _model(quant, mode):
    from vlm_fo1_tpu_torch.config import FO1Config
    from vlm_fo1_tpu_torch.models.fo1 import FO1Model
    from vlm_fo1_tpu_torch.runtime.fallback_tokenizer import (
        FallbackTokenizer,
    )

    model = FO1Model.random_init(FO1Config(), seed=0, dtype=torch.bfloat16,
                                 device="cuda", tokenizer=FallbackTokenizer())
    quant.quantize_model(model, mode)
    return model


def kernels_per_step(model, b):
    """Device kernels a masked decode step launches at B = b: one eager run
    of a loop program's steps under torch.profiler (None where the
    profiler recorded no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    from vlm_fo1_tpu_torch.runtime import generate as gen

    g = model._gen_cfg(cs.SERVE_NEW, 0.0, 1.0, -1)   # no row finishes
    prog = gen.loop_program(model.text, model.cfg.text, g, b, cs.DECODE_C,
                            1792, False)
    with torch.inference_mode():
        prog.cur.random_(0, 1000)
        prog.done.zero_()
        prog.seq_lens.fill_(1771)
        prog.rope_deltas.zero_()
        for profiled in (False, True):
            prog.step.fill_(1)
            torch.cuda.synchronize()
            if not profiled:
                prog.run()
                continue
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                prog.run()
                torch.cuda.synchronize()
    gen.release_program(model.text, prog)
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "memcpy" not in e.name.lower()
            and "memset" not in e.name.lower())
    return n / prog.steps if n else None


def decode_times(quant, designs, use, mode):
    """ms a masked decode step (chip_smoke's demo-request cache, every row
    live) at B = 1 and 8 from CUDA graphs, each design in turns (the
    programs are dropped at each swap, so each run captures anew), and the
    device kernels a step of each design."""
    from vlm_fo1_tpu_torch.runtime import generate as gen

    model = _model(quant, mode)
    out = {}
    for b in (1, cs.SERVE_BATCH):
        def step():
            gen.drop_programs(model.text)
            return cs._decode_step_ms(model, gen, b, True)[0]
        out[f"B={b}"] = in_turns(designs, use, step)
        print(f"3B {mode} decode step B={b} ms: {json.dumps(out[f'B={b}'])}",
              flush=True)
    counts = {}
    for name in ("old", "new"):
        use(designs[name])
        gen.drop_programs(model.text)
        counts[name] = kernels_per_step(model, cs.SERVE_BATCH)
    out["kernels_per_step_B8"] = counts
    print(f"3B {mode} device kernels a decode step (B={cs.SERVE_BATCH}): "
          f"{json.dumps(counts)}", flush=True)
    gen.drop_programs(model.text)
    del model
    torch.cuda.empty_cache()
    return out


def prefill_times(quant, designs, use, mode):
    """ms of one 3B prefill (the int4 products and the rest of the trunk)
    over one prepared and encoded demo request, each design in turns, twice
    each after a warm-up."""
    from vlm_fo1_tpu_torch.task_templates import OD_template

    model = _model(quant, mode)
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
    ap.add_argument("--rows", type=int, nargs="+", default=[1, 2, 4, 8],
                    help="rows of x (M) of the per-shape times")
    ap.add_argument("--decode", action="store_true",
                    help="also the 3B int4 / int4-mlp decode step, B = 1, 8")
    ap.add_argument("--prefill", action="store_true",
                    help="also the 3B int4 / int4-mlp prefill")
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
    new = (i4._load(), i4mlp._load())
    old = libraries(build(os.path.abspath(args.old_src),
                          os.path.join(_ROOT, "build", "int4_old")), new)
    designs = {"new": new, "old": old}
    legacy = isinstance(old[0], LegacyMatmul)

    def use(libs):
        i4._lib, i4mlp._lib = libs

    result = {"card": card, "old_interface_legacy": legacy,
              "capacities": capacities(i4, i4mlp),
              "kernels": kernel_times(i4, i4mlp, quant, designs, use,
                                      args.rows)}
    for mode in ("int4", "int4-mlp"):
        if args.decode:
            result[f"decode_{mode}"] = decode_times(quant, designs, use,
                                                    mode)
        if args.prefill:
            result[f"prefill_{mode}"] = prefill_times(quant, designs, use,
                                                      mode)
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
