"""Training checkpoints (counterpart of
`vlm_fo1_tpu/training/checkpointing.py`, which writes through orbax).

`save_checkpoint` writes `<dir>/step_<N>/checkpoint.pt` with `torch.save`
(model state dict, optimizer state, step, extra) into a temporary directory
that `os.replace` then moves into place, so a reader never sees a half
written step. `save_params_safetensors` / `load_params_safetensors` write
and read the safetensors format themselves (an 8-byte little-endian header
length, a JSON header of dtype / shape / byte offsets per tensor, then the
raw little-endian bytes), with the state dict's names as keys: the
`safetensors` package is not needed.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import tempfile

import torch

_PAYLOAD = "checkpoint.pt"
_ST_DTYPES = {
    torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
    torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
    torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8",
    torch.bool: "BOOL",
}
_ST_TORCH = {v: k for k, v in _ST_DTYPES.items()}


def save_checkpoint(ckpt_dir: str, step: int, model, optimizer=None,
                    extra: dict | None = None) -> str:
    """Write `ckpt_dir/step_<step>` atomically, replacing one of the same
    step. Returns its path."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step}")
    payload = {"step": int(step), "model": model.state_dict(),
               "optimizer": (optimizer.state_dict() if optimizer is not None
                             else None),
               "extra": extra}
    tmp = tempfile.mkdtemp(prefix=f".step_{step}.", dir=ckpt_dir)
    try:
        torch.save(payload, os.path.join(tmp, _PAYLOAD))
        if os.path.exists(final):
            old = tempfile.mkdtemp(prefix=f".old_step_{step}.", dir=ckpt_dir)
            os.replace(final, os.path.join(old, "step"))
            os.replace(tmp, final)
            shutil.rmtree(old)
        else:
            os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
    return final


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """The `step_<N>` directory with the largest N, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                continue
    if not steps:
        return None
    return os.path.join(ckpt_dir, f"step_{max(steps)}")


def restore_checkpoint(path: str, model, optimizer=None) -> dict:
    """Load a `save_checkpoint` directory into `model` (strictly) and, when
    given, `optimizer`. Returns {"step": int, "extra": ...}."""
    payload = torch.load(os.path.join(path, _PAYLOAD), map_location="cpu",
                         weights_only=True)
    model.load_state_dict(payload["model"], strict=True)
    if optimizer is not None:
        if payload["optimizer"] is None:
            raise ValueError(f"{path} holds no optimizer state")
        optimizer.load_state_dict(payload["optimizer"])
    return {"step": payload["step"], "extra": payload["extra"]}


def save_params_safetensors(path: str, model_or_state_dict) -> None:
    """Flat safetensors export of a module's state dict (or a dict of
    tensors), keys as given, written to a temporary file and moved into
    place."""
    sd = (model_or_state_dict.state_dict()
          if isinstance(model_or_state_dict, torch.nn.Module)
          else model_or_state_dict)
    header, blobs, offset = {}, [], 0
    for name, t in sd.items():
        if t.dtype not in _ST_DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors "
                            "code")
        raw = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
        data = raw.numpy().tobytes()
        header[name] = {"dtype": _ST_DTYPES[t.dtype],
                        "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)  # the format's 8-byte alignment
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=".params.", dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(struct.pack("<Q", len(head)))
            f.write(head)
            for data in blobs:
                f.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_params_safetensors(path: str) -> dict:
    """Read a safetensors file into {name: CPU tensor} (metadata ignored)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_TORCH[info["dtype"]]
        lo, hi = info["data_offsets"]
        raw = torch.frombuffer(data, dtype=torch.uint8, count=hi - lo,
                               offset=lo) if hi > lo else \
            torch.empty(0, dtype=torch.uint8)
        out[name] = raw.clone().view(dtype).reshape(info["shape"])
    return out
