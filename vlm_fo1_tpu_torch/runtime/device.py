"""Device choice and stage timing shared by the port's entry points."""

from __future__ import annotations

import contextlib
import time

import torch


def resolve_device(device) -> torch.device:
    """The device asked for; asking for CUDA where there is none raises,
    there is no silent CPU path."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is unavailable")
    return device


@contextlib.contextmanager
def stage_timer(out: dict | None, name: str, device: torch.device):
    """Record the wall-clock ms of the block, ended by a device
    synchronise, as out[name]; a no-op when out is None."""
    t0 = time.perf_counter()
    yield
    if out is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out[name] = (time.perf_counter() - t0) * 1e3
