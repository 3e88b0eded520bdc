"""Captured step programs: a function over static tensors, run as one CUDA
graph replay on the card (the PyTorch counterpart of one jitted JAX
program), and a small bounded cache of such programs (the counterpart of
the JAX jit cache).

`CapturedSteps(fn, device)` runs `fn()` once eagerly on a side stream (it
loads every kernel library and cuBLAS handle), then captures it with
`torch.cuda.graph` into a private memory pool; each `run()` replays it. `fn`
must read and write only tensors that outlive the program, take no host
value that changes between runs, and never synchronise (no `.item()`, no
tensor built from host data). On the CPU, or with `use_graph=False`, `run()`
calls `fn()` eagerly: that is the only other way a program runs, and a
failed capture raises.

A graph replay launches kernels without running their Python wrappers, so
the wrappers' launch counters (`flash_attention.launches`,
`decode_attention.launches`, `int4_matmul.launches` and `.routes`,
`int4_mlp.launches` and `.routes`)
would miss them, and the capture itself, which runs the wrappers but
launches nothing, would count launches that never happen. So the capture
records what the wrappers counted while it ran, puts every counter back as
it was, and every replay adds the recorded counts again: the counters read
the eager warm-up and the replays, the kernels that really ran.

Each capture counts in `trace.counters()["captures"]` and is a
`graph.capture` span (its warm-up, synchronise, collection and capture):
a count that rises after a server's warm-up means a shape it missed.
"""

from __future__ import annotations

import gc
from collections import OrderedDict

import torch

from vlm_fo1_tpu_torch.ops.decode_attention import decode_attention
from vlm_fo1_tpu_torch.ops.flash_attention import flash_attention
from vlm_fo1_tpu_torch.ops.int4_matmul import int4_matmul
from vlm_fo1_tpu_torch.ops.int4_mlp import int4_mlp
from vlm_fo1_tpu_torch.runtime import trace

_COUNTED = (flash_attention, decode_attention, int4_matmul, int4_mlp)


def _counts():
    return [(f.launches, dict(getattr(f, "routes", {}))) for f in _COUNTED]


def _count_delta(before, after):
    return [(a[0] - b[0], {r: a[1][r] - b[1][r] for r in a[1]})
            for b, a in zip(before, after)]


def _restore(counts):
    for f, (n, routes) in zip(_COUNTED, counts):
        f.launches = n
        if routes:
            f.routes.update(routes)


class CapturedSteps:
    """fn() as one CUDA graph on a CUDA device (unless use_graph=False),
    eagerly otherwise. `pool_bytes` is the device memory the capture
    reserved for the graph's private pool (0 when eager)."""

    def __init__(self, fn, device: torch.device, use_graph: bool = True):
        self.fn = fn
        self.graph = None
        self.pool_bytes = 0
        self._launches = None
        if device.type == "cuda" and use_graph:
            trace.count("captures")
            with trace.span("graph.capture"):
                self._capture(device)

    def _capture(self, device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self.fn()
        torch.cuda.current_stream(device).wait_stream(side)
        # the capture empties the allocator's cache first; empty it here,
        # so the growth of the reserved bytes is the graph's pool
        torch.cuda.synchronize(device)
        # a program dropped earlier may still wait in a reference cycle (its
        # captured steps hold the program); the collector destroying its
        # graph in the middle of this capture would invalidate the capture,
        # so collect it now
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph()
        before = _counts()
        try:
            with trace.capture(), torch.cuda.graph(graph):
                self.fn()
            self._launches = _count_delta(before, _counts())
        finally:
            _restore(before)
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.graph = graph

    def run(self):
        if self.graph is None:
            self.fn()
            return
        self.graph.replay()
        for f, (n, routes) in zip(_COUNTED, self._launches):
            f.launches += n
            for r, c in routes.items():
                f.routes[r] += c


class ProgramCache:
    """Free programs by key, at most `capacity` of them kept; the least
    recently released goes first. A program is checked out by `acquire`
    and returned by `release`, so two runs in flight never share one."""

    def __init__(self, capacity: int = 6):
        self.capacity = capacity
        self._free: OrderedDict = OrderedDict()

    def acquire(self, key, build):
        progs = self._free.get(key)
        if progs:
            prog = progs.pop()
            if not progs:
                del self._free[key]
            return prog
        return build()

    def release(self, key, prog):
        self._free.setdefault(key, []).append(prog)
        self._free.move_to_end(key)
        while sum(len(v) for v in self._free.values()) > self.capacity:
            oldest = next(iter(self._free))
            self._free[oldest].pop(0)
            if not self._free[oldest]:
                del self._free[oldest]

    def clear(self):
        self._free.clear()

    def pool_bytes(self) -> int:
        """Bytes held by the kept programs: their static buffers and their
        graphs' pools."""
        return sum(p.nbytes() for v in self._free.values() for p in v)
