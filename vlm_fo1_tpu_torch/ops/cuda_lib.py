"""Build and load the port's CUDA kernels (`csrc/*.cu`).

Each source compiles with nvcc for `sm_90a` into its own plain-C shared
library under `build/` at the repository root, at first use and again
whenever the source or a shared header (`csrc/*.cuh`) is newer than the
library. Several sources build in parallel, one nvcc process each. Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)


def source(name: str) -> str:
    return os.path.join(_PKG, "csrc", f"{name}.cu")


def library(name: str) -> str:
    return os.path.join(_ROOT, "build", f"libfo1_{name}.so")


def _stale(name: str) -> bool:
    """The library is missing or older than its source or any shared header
    (`csrc/*.cuh`)."""
    lib = library(name)
    if not os.path.exists(lib):
        return True
    csrc = os.path.dirname(source(name))
    deps = [source(name)] + [os.path.join(csrc, f) for f in os.listdir(csrc)
                             if f.endswith(".cuh")]
    return os.path.getmtime(lib) < max(os.path.getmtime(d) for d in deps)


def build(names) -> dict[str, float]:
    """Compile the named kernels whose library is missing or stale, all nvcc
    processes started together. Returns the seconds each compile took
    (empty when nothing needed building). A failed compile raises with the
    compiler's output."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    os.makedirs(os.path.dirname(library(todo[0])), exist_ok=True)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = f"{library(n)}.{os.getpid()}.tmp"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, source(n)]
        # the compiler's messages go to a file: a pipe nobody reads while
        # the processes run could fill up and stall them
        with open(f"{tmp}.log", "w") as log:
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT))
    seconds, failed = {}, []
    while procs:
        for n, (tmp, proc) in list(procs.items()):
            if proc.poll() is None:
                continue
            seconds[n] = time.perf_counter() - t0
            del procs[n]
            with open(f"{tmp}.log") as log:
                out = log.read()
            os.remove(f"{tmp}.log")
            if proc.returncode != 0:
                failed.append(f"{source(n)} (nvcc exit {proc.returncode}):"
                              f"\n{out}")
            else:
                os.replace(tmp, library(n))
        time.sleep(0.05)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return seconds


def refuse_grad(name: str, *tensors) -> None:
    """A forward-only kernel's wrapper calls this first: with grad mode on
    and any input requiring a gradient it raises, rather than return an
    output without a `grad_fn` that would train on a silently missing
    gradient. Checked before the device dispatch, so the plain version on
    the CPU refuses too."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only: its kernel has no backward. Call it "
            "under torch.no_grad() or torch.inference_mode(), or take a "
            "differentiable path (for attention, "
            "flash_attention_differentiable)")


def load(name: str) -> ctypes.CDLL:
    """Build the kernel if needed, then open its library."""
    build([name])
    return ctypes.CDLL(library(name))
