"""Device choice and stage timing shared by the port's entry points."""

from __future__ import annotations

import contextlib

import torch

from vlm_fo1_tpu_torch.runtime import trace


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
    synchronise, as out[name] (a `stage.<name>` span); a no-op when out is
    None."""
    if out is None:
        yield
        return
    with trace.span(f"stage.{name}") as s:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    out[name] = s.host_ms
