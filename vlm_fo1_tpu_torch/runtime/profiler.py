"""Profiling and debug helpers (counterpart of
`vlm_fo1_tpu/runtime/profiler.py`):

- `trace(path)`: a `torch.profiler` trace of a block, written as a Chrome
  trace (open it in chrome://tracing or Perfetto);
- `enable_debug(model)` / `disable_debug(model)`: raise at the first module
  whose output holds a NaN or an infinity (the counterpart of
  `jax_debug_nans` / `jax_debug_infs`); every module output is read on the
  host, so the model runs far slower while it is on.
"""

from __future__ import annotations

import contextlib

import torch


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
