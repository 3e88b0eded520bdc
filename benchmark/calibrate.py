"""The readings a cell's correctness limit is set from, in one process.

    python3 benchmark/calibrate.py --workload bf16.serve-b8 \\
        --seeds 11 12 13 --control-seeds 11 12 13 \\
        --fault region_zero=21,22,23 --seconds 8 \\
        --limit logit_gap_max=0.4 --limit prefill_logit_err_max=0.05 \\
        --write chiprun_out/limits/bf16.serve-b8.json

For every seed: the weights and the program from the seed, the cell's
warm-up, a short window at the cell's own load (long enough for the mix's
longest requests and as many compared requests as a run compares), then
the comparison a run makes: the lower readings. For each control seed
also the control (`check.control_readings`): the reference in the
program's place with e4m3 linear layers, read at the same prompts and
served tokens: the upper readings. For each `--fault NAME=SEEDS` the same
with that fault planted in the program (`benchmark/faults.py`). Every row
goes through the decision a run makes (`check.decide`) against the
`--limit`s: each records its `compared` numbers and `correct`. Prints one
JSON line per row and a summary line last; `--write` merges the summary
into a limits file (`benchmark/limits/<cell>.json` layout), where a lower
reading is the largest over the file's earlier seeds and these. With
`--rows`, the rows of earlier outputs are decided again against the
`--limit`s and written, without a run. Needs the card otherwise; the
benchmark's own runs never run it.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


# each number compared that a reading gives: its name, the readings' key
NUMBERS = {"logit_gap_max": "gap", "prefill_logit_err_max": "prefill"}


def _row(kind, seed, readings, records, picked, mix, limits, t0):
    from benchmark import check

    numbers = check.compared(readings, records, picked, mix,
                             {k: {"limit": v} for k, v in limits.items()})
    return {"kind": kind, "seed": seed, "requests": len(records),
            "readings": readings, "compared": numbers,
            "correct": check.decide(numbers),
            "seconds": round(time.time() - t0, 1)}


def calibrate(name, seeds, control_seeds, seconds, limits, faults=None,
              device="cuda", root=ROOT, bench=None):
    """Rows of readings, each decided against `limits` ({number: limit}),
    and a summary."""
    import torch

    from benchmark import check, core, faults as fault_lib, generator

    bench = bench or core.load_bench(root)
    cell = core.find_cell(bench, name)
    cfg = core.load_config(cell["config"], root)
    mix = generator.load_mix(cell["traffic"], root)
    dev = torch.device(device)
    runs = [("program", s, None) for s in seeds]
    for fault, fseeds in (faults or {}).items():
        runs += [(fault, s, fault) for s in fseeds]
    rows = []
    for kind, seed, fault in runs:
        t0 = time.time()
        plant = (lambda m, f=fault: fault_lib.plant(f, m)) if fault else None
        driver, reqs = core.start(cfg, mix, seed, dev, root, plant)
        records, _ = driver.window(reqs, seconds)
        core.free(driver, dev)
        del driver
        picked = check.sample(records, seed, mix["check"]["requests"])
        ref = check.reference(cfg, seed, dev)
        out = [_row(kind, seed, check.program_readings(ref, picked, mix),
                    records, picked, mix, limits, t0)]
        if kind == "program" and seed in control_seeds:
            low = check.reference(cfg, seed, dev, precision="fp8")
            out.append(_row("control", seed,
                            check.control_readings(ref, low, picked, mix),
                            records, picked, mix, limits, t0))
            del low
        del ref
        core.release(dev)
        for row in out:
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = summarize(name, rows, limits)
    print(json.dumps(summary), flush=True)
    return summary


def summarize(name, rows, limits) -> dict:
    """Per number: the limit, the program's widest reading per seed and
    the largest (lower), the control's per seed and the smallest (upper),
    each fault's per seed; and the decision each row got."""
    out = {"workload": name, "numbers": {},
           "correct": {}}
    for r in rows:
        out["correct"].setdefault(r["kind"], []).append(r["correct"])
    for number, key in NUMBERS.items():
        per = {}
        for r in rows:
            vals = r["readings"][key]
            if vals:
                per.setdefault(r["kind"], []).append(max(vals))
        if not per:
            continue
        prog, ctl = per.pop("program", []), per.pop("control", [])
        out["numbers"][number] = {
            "limit": limits.get(number), "program_seeds": len(prog),
            "lower": max(prog, default=None),
            "upper": min(ctl, default=None),
            "program_per_seed": prog, "control_per_seed": ctl,
            "faults": per}
    return out


def write_limits(path: str, summary: dict) -> dict:
    """Merge a summary into the limits file at path, number by number: the
    limit; the program's seeds and lower reading (the largest over the
    file's seeds and the summary's); the control's readings and upper
    reading (the smallest); each fault's readings; and the decisions every
    row got."""
    old = {}
    if os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
    out = dict(old)
    for number, new in summary["numbers"].items():
        entry = dict(old.get(number, {}))
        lowers = [v for v in (entry.get("lower"), new["lower"])
                  if v is not None]
        entry.update(limit=new["limit"], lower=max(lowers, default=None),
                     program_seeds=entry.get("program_seeds", 0)
                     + new["program_seeds"])
        ctl = entry.get("control_per_seed", []) + new["control_per_seed"]
        if ctl:
            entry.update(upper=min(ctl), control_per_seed=ctl)
        faults = dict(entry.get("faults", {}))
        for name, vals in new["faults"].items():
            faults[name] = faults.get(name, []) + vals
        if faults:
            entry["faults"] = faults
        entry["how"] = (
            "benchmark/calibrate.py on the card at the cell's own size: "
            "lower = largest reading of the program over its seeds; upper "
            "= smallest of the e4m3 control; every row decided by "
            "check.decide against the limits")
        out[number] = entry
    out["decisions"] = dict(old.get("decisions", {}))
    for kind, got in summary["correct"].items():
        out["decisions"][kind] = out["decisions"].get(kind, []) + got
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    return out


def redecide(rows: list[dict], limits: dict) -> list[dict]:
    """Recorded rows decided again against other limits (no card)."""
    from benchmark import check

    out = []
    for r in rows:
        numbers = {k: dict(v, limit=limits.get(k, v["limit"]))
                   if k in NUMBERS else v for k, v in r["compared"].items()}
        out.append(dict(r, compared=numbers,
                        correct=check.decide(numbers)))
    return out


def _limit_arg(text):
    name, _, value = text.partition("=")
    return name, float(value)


def _fault_arg(text):
    name, _, seeds = text.partition("=")
    return name, [int(s) for s in seeds.split(",") if s]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", type=_fault_arg, action="append",
                    default=[], help="NAME=SEED,SEED,... (repeatable)")
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--limit", type=_limit_arg, action="append",
                    default=[], help="NUMBER=LIMIT (repeatable)")
    ap.add_argument("--write", default=None,
                    help="a limits file to merge the summary into")
    ap.add_argument("--rows", nargs="*", default=[],
                    help="decide the rows these earlier outputs recorded "
                         "again, against --limit, instead of a run")
    args = ap.parse_args(argv)
    if args.rows:
        rows = []
        for path in args.rows:
            with open(path) as f:
                rows += [r for r in map(json.loads, f) if "kind" in r]
        summary = summarize(args.workload, redecide(rows, dict(args.limit)),
                            dict(args.limit))
        print(json.dumps(summary))
    else:
        summary = calibrate(args.workload, args.seeds,
                            set(args.control_seeds), args.seconds,
                            dict(args.limit), dict(args.fault))
    if args.write:
        write_limits(args.write, summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
