"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload bf16.serve-b8 --seed 7 \\
        --seconds 45 --trace 0

From the root of a checkout, on a machine with the cards the cell asks
for. The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
`--trace 0`, its per-layer metrics with `--trace 1`), `device` (with the
traced slice's `busy_s` and `window_s` under `--trace 1`), `breakdown`
(`--trace 1`), `notes`, and last `compared`: each number the correctness
check compared, beside its limit. The same numbers end standard error.
Without a card, or with fewer than the cell asks for, it prints no result
and exits 2; if JAX or the JAX package was loaded, it exits 3.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache inside the checkout, at fixed paths
_BUILD = os.path.join(ROOT, "build")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_BUILD, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_BUILD, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_BUILD, "nv_compute_cache")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import core

    cell = core.find_cell(core.load_bench(ROOT), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = core.run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), t_start=T_START, root=ROOT)
    found = core.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for k, v in out["compared"].items():
        print(f"compared {k} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
