"""Where a decode step's device time goes, for the 3B FO1 trunk on the card.

    python examples/profile_decode_torch.py [--batch 1 8] [--quant int4]

For each batch size: the masked decode step's ms from a CUDA graph and
eagerly (CUDA events over runs of one loop program, every step live, a
demo request's cache of 1792 + 32 slots), then one eager run of its steps
under `torch.profiler`: kernels launched a step, device time a step, and
the kernels that take the most of it. The graph removes the host time
between kernels, so its ms a step is close to the device time summed here.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from vlm_fo1_tpu_torch.config import FO1Config  # noqa: E402
from vlm_fo1_tpu_torch.models.fo1 import FO1Model  # noqa: E402
from vlm_fo1_tpu_torch.quant import MODES, quantize_model  # noqa: E402
from vlm_fo1_tpu_torch.runtime import generate as gen  # noqa: E402

PROMPT, BUCKET, NEW = 1771, 1792, 32


def _program(model, batch, graphs):
    g = model._gen_cfg(NEW, 0.0, 1.0, -1)   # no row finishes
    prog = gen.loop_program(model.text, model.cfg.text, g, batch,
                            BUCKET + NEW, BUCKET, graphs)
    with torch.inference_mode():
        prog.cur.random_(0, 1000)
        prog.done.zero_()
        prog.seq_lens.fill_(PROMPT)
        prog.rope_deltas.zero_()
    return prog


def _run(prog):
    with torch.inference_mode():
        prog.step.fill_(1)
        prog.run()


def _ms_per_step(prog, reps):
    _run(prog)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        _run(prog)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (reps * prog.steps)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--quant", choices=MODES, default="none")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode_torch: needs an NVIDIA GPU")
    card = torch.cuda.get_device_name(0)
    model = FO1Model.random_init(FO1Config(), seed=0, dtype=torch.bfloat16,
                                 device="cuda")
    quantize_model(model, args.quant)
    for b in args.batch:
        graph = _program(model, b, True)
        eager = _program(model, b, False)
        ms_graph = _ms_per_step(graph, 5)
        ms_eager = _ms_per_step(eager, 1)
        _run(eager)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _run(eager)
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_us = sum(e.self_device_time_total for e in rows)
        launches = sum(e.count for e in rows)
        steps = eager.steps
        print(f"[{card}] {args.quant} B={b}: graph {ms_graph:.3f} ms a "
              f"step, eager {ms_eager:.3f} ms a step; profiled eager run: "
              f"{launches / steps:.0f} kernels a step, device time "
              f"{dev_us / 1e3 / steps:.3f} ms a step")
        rows.sort(key=lambda e: -e.self_device_time_total)
        for e in rows[:args.top]:
            print(f"    {e.self_device_time_total / 1e3 / steps:8.3f} ms "
                  f"{e.count / steps:6.1f}x  {e.key[:90]}")
        for prog in (graph, eager):
            gen.release_program(model.text, prog)


if __name__ == "__main__":
    main()
