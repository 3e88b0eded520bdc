"""Multi-process launches and the (data, model) device mesh (counterpart of
`vlm_fo1_tpu/parallel/multihost.py`).

`initialize_distributed()` wraps `torch.distributed.init_process_group`
for a launch of one process per device: the arguments, or torchrun's
`RANK` / `WORLD_SIZE` / `MASTER_ADDR` / `MASTER_PORT` when they are not
given; with nothing configured in a single process it does nothing, as the
JAX function does. The backend follows the device asked for (NCCL for
`cuda`, gloo for `cpu`) and is never switched for the other.

`create_hybrid_mesh()` builds a `DeviceMesh` with the axes ("data",
"model") over `num_slices` groups of (ici_data, ici_model) ranks. Ranks are
laid out row-major, so each model group is a run of consecutive ranks: with
torchrun's numbering (`rank = node * nproc_per_node + local_rank`) it stays
inside one node, where the per-layer tensor-parallel collectives take
NVLink, and only the data axis's once-a-step gradient all-reduce crosses
nodes (the JAX mesh keeps its model axis inside a slice for the same
reason).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from vlm_fo1_tpu_torch.runtime.device import resolve_device


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device="cuda") -> None:
    """Join the process group of a multi-process launch.
    coordinator_address is "host:port" of rank 0. A no-op when a group
    exists already, and in a single process with nothing configured. On
    `cuda` the process takes the card of its local rank (`LOCAL_RANK`, else
    its rank modulo the visible cards) and the group uses NCCL; on `cpu` it
    uses gloo."""
    if dist.is_initialized():
        return
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        if (num_processes or 1) > 1:
            raise ValueError(f"{num_processes} processes need a coordinator "
                             "address")
        return  # one process, nothing configured
    device = resolve_device(device)
    rank, world = process_id or 0, num_processes or 1
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}", world_size=world,
        rank=rank)


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def create_hybrid_mesh(ici_data: int = 1, ici_model: int = 1,
                       num_slices: int = 1) -> DeviceMesh:
    """A ("data", "model") mesh of shape (num_slices * ici_data, ici_model)
    over ranks 0..n-1 of the process group, the model axis over consecutive
    ranks. Needs n = num_slices * ici_data * ici_model ranks; every rank of
    the group must call it. Under torchrun, a model group that would span
    two nodes raises."""
    n = num_slices * ici_data * ici_model
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise ValueError(f"need {n} devices, have {have}")
    if not dist.is_initialized():
        raise RuntimeError("create a mesh after initialize_distributed(): "
                           "no process group exists")
    if have != n:
        raise ValueError(f"the mesh must cover the process group: {n} ranks "
                         f"asked for, {have} in the group")
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if per_node % ici_model:
        raise ValueError(f"a model group of {ici_model} ranks would span "
                         f"nodes of {per_node} processes")
    ranks = np.arange(n).reshape(num_slices * ici_data, ici_model)
    return DeviceMesh(_device_type(), torch.as_tensor(ranks),
                      mesh_dim_names=("data", "model"))


# torch 2.13 renames all_gather_into_tensor; torch 2.11 has only the old
# name
_all_gather_flat = getattr(dist, "all_gather_single",
                           dist.all_gather_into_tensor)


def all_gather_stacked(x, group=None):
    """Every rank's x stacked on a new leading dim [m, *x.shape], in rank
    order: one collective into one flat buffer (NCCL and gloo alike)."""
    m = dist.get_world_size(group)
    out = torch.empty((m * x.numel(),), dtype=x.dtype, device=x.device)
    _all_gather_flat(out, x.contiguous().view(-1), group=group)
    return out.view(m, *x.shape)
