"""The comparison that decides `correct`.

After the window has closed and the program's memory is freed, a sample of
the requests the window finished, drawn from the seed and holding the one
with the most served tokens, goes through the plain reference
(`benchmark/reference/<config's reference>.py`, float32, TF32 off) with the
weights drawn again from the seed. For every served token the reference
gives the logits of that position; the number compared is the widest gap
by which a served token's reference logit lies below the reference's best
at its position (0 where the program served the reference's own argmax).
Where the entry returns its logits after the prompt (`GenerationResult.
prefill_logits`: `generate`, `ServingPipeline`), their relative error
against the reference's is compared too: it sees the whole distribution
the prompt's encode and prefill give, the region path included, where the
served tokens of a randomly drawn model hardly move with it.

The control (`control_readings`) puts the reference in the program's place at
a lower precision: at each position of the same prompts and served tokens
it reads the gap of the token that the lower precision puts first.

`compared` gathers the numbers of one run beside their limits, and
`decide` alone turns them into `correct`: the benchmark's runs, the
calibration's program, control and fault readings, and the tests all go
through it.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from benchmark import weights as bench_weights
from benchmark.program import dtype_of


# the gap reported for a token outside the vocabulary (JSON has no inf)
OUTSIDE = 1e9


def served(rec) -> np.ndarray:
    res = rec["result"]
    return np.asarray([] if res is None else res.token_ids, np.int64)


def sample(records: list[dict], seed: int, n: int) -> list[dict]:
    """n finished requests: the one with the most served tokens (then the
    most boxes, then the first), and the rest drawn from the seed."""
    done = [r for r in records if r["result"] is not None
            and len(served(r))]
    if not done:
        return []
    first = max(range(len(done)), key=lambda i: (
        len(served(done[i])), len(done[i]["req"]["boxes"]), -i))
    rest = [r for i, r in enumerate(done) if i != first]
    pick = np.random.default_rng([seed, 7]).permutation(len(rest))
    return [done[first]] + [rest[i] for i in pick[:max(0, n - 1)]]


def compared(readings: dict, records: list[dict], picked: list[dict],
             mix: dict, limits: dict) -> dict:
    """The numbers a run is judged by, each {"value", "limit"}: the widest
    gap over the picked requests; where the program returns its logits
    after the prompt, their largest relative error; the requests that
    never came back; and the served tokens compared (a floor: names ending
    `_at_least`)."""
    def limit(name):
        return limits.get(name, {}).get("limit")

    numbers = {"logit_gap_max": {"value": max(readings["gap"], default=None),
                                 "limit": limit("logit_gap_max")}}
    if readings["prefill"]:
        numbers["prefill_logit_err_max"] = {
            "value": max(readings["prefill"]),
            "limit": limit("prefill_logit_err_max")}
    return dict(numbers, **{
        "failed_requests": {
            "value": sum(r["result"] is None for r in records), "limit": 0},
        "checked_tokens_at_least": {
            "value": int(sum(len(served(r)) for r in picked)),
            "limit": mix["check"]["min_tokens"]},
    })


def decide(numbers: dict) -> bool:
    """`correct`: every number read and limited, a floor (`*_at_least`)
    at or above its limit, every other number at or below it."""
    for name, n in numbers.items():
        v, lim = n["value"], n["limit"]
        if v is None or lim is None:
            return False
        if (v < lim) if name.endswith("_at_least") else (v > lim):
            return False
    return True


def reference(cfg: dict, seed: int, device, precision: str = "f32"):
    mod = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    drawn = bench_weights.draw(cfg, seed, device, dtype_of(cfg))
    ref = mod.Reference(cfg, drawn, quant=cfg["quant"],
                        precision=precision, device=device)
    del drawn
    return ref


def aux_mode(mix: dict) -> str:
    """How the program made the DaViT input on this mix's path."""
    opts = mix.get(mix["driver"], {})
    return "cubic" if opts.get("device_preproc") else "pil"


def gaps(logits: torch.Tensor, tokens) -> torch.Tensor:
    """Per position: best logit minus the logit of `tokens`; a token
    outside the vocabulary is infinitely far."""
    tok = torch.as_tensor(tokens, device=logits.device)
    ok = (tok >= 0) & (tok < logits.shape[1])
    got = logits.gather(1, tok.clamp(0, logits.shape[1] - 1)[:, None])[:, 0]
    return torch.where(ok, logits.max(-1).values - got,
                       torch.full_like(got, float("inf")))


def prefill_error(program, reference) -> tuple[float, float]:
    """(relative, absolute) error of the program's logits after the prompt
    against the reference's: |p - r|_2 / |r|_2 and max |p - r|."""
    r = reference.double()
    d = torch.as_tensor(program, device=r.device).double() - r
    return float(d.norm() / r.norm()), float(d.abs().max())


def _readings() -> dict:
    return {"gap": [], "prefill": [], "prefill_abs": []}


@torch.no_grad()
def program_readings(ref, picked: list[dict], mix: dict) -> dict:
    """Per picked request: the widest gap of its served tokens ("gap"),
    and, where the program returned its logits after the prompt, their
    error against the reference's ("prefill", relative; "prefill_abs")."""
    out = _readings()
    for rec in picked:
        toks = served(rec)
        logits = ref.served_logits(rec["req"], toks, aux_mode(mix))
        out["gap"].append(min(float(gaps(logits, toks).max()), OUTSIDE))
        first = getattr(rec["result"], "prefill_logits", None)
        if first is not None:
            rel, ab = prefill_error(first, logits[0])
            out["prefill"].append(rel)
            out["prefill_abs"].append(ab)
    return out


@torch.no_grad()
def control_readings(ref, low, picked: list[dict], mix: dict) -> dict:
    """The same readings with `low` (the reference at the lower precision)
    in the program's place: the widest gap, under `ref`'s logits, of the
    tokens that `low` puts first at each position of the same prompts and
    served tokens, and the error of `low`'s logits after the prompt."""
    out = _readings()
    for rec in picked:
        toks = served(rec)
        mode = aux_mode(mix)
        low_logits = low.served_logits(rec["req"], toks, mode)
        logits = ref.served_logits(rec["req"], toks, mode)
        out["gap"].append(float(gaps(logits, low_logits.argmax(-1)
                                     .cpu().numpy()).max()))
        if getattr(rec["result"], "prefill_logits", None) is not None:
            rel, ab = prefill_error(low_logits[0], logits[0])
            out["prefill"].append(rel)
            out["prefill_abs"].append(ab)
    return out
