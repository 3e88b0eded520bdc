"""Seeded weights of a configuration, under the checkpoint's names as the
program's modules carry them.

The layout belongs to the plain reference that the configuration's
`reference` key names: `benchmark/reference/<reference>.py` defines
`param_spec(cfg)`, every parameter with its shape and kind. `draw(cfg,
seed, device, dtype)` makes them on the device from one `torch.Generator`
in two large calls: matrices, convolution kernels and biases ~ N(0,
init_std) (the file's `init_std`, 0.02 by default), norm scales ~ N(1,
0.05). The same seed gives the same tensors, so the benchmark draws them
once for the program and again, after the window, for the reference.
"""

from __future__ import annotations

import importlib

import torch


def param_spec(cfg: dict) -> list[tuple[str, tuple, str]]:
    """[(name, shape, kind)] of the configuration's reference: kind "w"
    (drawn around 0) or "n" (a norm scale, drawn around 1)."""
    mod = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    return mod.param_spec(cfg)


def draw(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """{name: tensor} from `seed`: views into two flat buffers, each filled
    by one normal_ call of a generator on `device`."""
    spec = param_spec(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    w_std = cfg.get("init_std", 0.02)
    for kind, mean, std in (("w", 0.0, w_std), ("n", 1.0, 0.05)):
        items = [(n, s) for n, s, k in spec if k == kind]
        sizes = [torch.Size(s).numel() for _, s in items]
        flat = torch.empty(sum(sizes), dtype=dtype, device=device)
        flat.normal_(mean, std, generator=gen)
        for (name, shape), part in zip(items, flat.split(sizes)):
            out[name] = part.view(shape)
    return out
