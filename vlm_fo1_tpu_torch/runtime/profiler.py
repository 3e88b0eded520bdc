"""Profiling and debug helpers (counterpart of
`vlm_fo1_tpu/runtime/profiler.py`):

- `timed(name)`: the wall time of a block, ended by a device synchronise;
- `StageTimer`: named stage times accumulated over calls;
- `trace(path)`: a `torch.profiler` trace of a block, written as a Chrome
  trace (open it in chrome://tracing or Perfetto);
- `enable_debug(model)` / `disable_debug(model)`: raise at the first module
  whose output holds a NaN or an infinity (the counterpart of
  `jax_debug_nans` / `jax_debug_infs`); every module output is read on the
  host, so the model runs far slower while it is on.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def _sync(device):
    device = torch.device(device) if device is not None else None
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timed(name: str, results: dict | None = None, device=None):
    """Seconds of the block, ended by a synchronise of `device` (a CUDA
    device; None or the CPU waits for nothing), added to results[name], or
    printed in ms when results is None."""
    t0 = time.perf_counter()
    yield
    _sync(device)
    dt = time.perf_counter() - t0
    if results is not None:
        results[name] = results.get(name, 0.0) + dt
    else:
        print(f"[timed] {name}: {dt * 1e3:.1f} ms")


class StageTimer:
    """Per-stage wall times, each stage ended by a synchronise of the
    timer's device."""

    def __init__(self, device=None):
        self.device = device
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        _sync(self.device)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> dict[str, float]:
        """Mean seconds per call of each stage."""
        return {k: round(v / max(self.counts[k], 1), 4)
                for k, v in self.totals.items()}


@contextlib.contextmanager
def trace(path: str):
    """Profile the block with `torch.profiler` (CPU activity, and CUDA
    activity where a card is present) and write the Chrome trace to
    `path`. Yields the profiler, whose `key_averages()` sums the time by
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)


def _check_finite(name):
    def hook(module, args, output):
        outs = output if isinstance(output, (tuple, list)) else (output,)
        for i, t in enumerate(outs):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and not bool(torch.isfinite(t).all())):
                raise FloatingPointError(
                    f"non-finite value in output {i} of module "
                    f"{name or type(module).__name__!r} "
                    f"({type(module).__name__}, shape {tuple(t.shape)})")
    return hook


def enable_debug(model: torch.nn.Module) -> None:
    """Check every module output of `model` for NaN and infinity: the first
    module (innermost first, as forwards finish) whose output is not
    finite raises FloatingPointError. The hooks live on the model until
    `disable_debug`."""
    disable_debug(model)
    model._debug_hooks = [mod.register_forward_hook(_check_finite(name))
                          for name, mod in model.named_modules()]


def disable_debug(model: torch.nn.Module) -> None:
    for handle in getattr(model, "_debug_hooks", ()):
        handle.remove()
    model._debug_hooks = []
