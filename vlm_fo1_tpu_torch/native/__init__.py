"""Native (C++) host preprocessing: fused normalize + patchify over the
uint8 image (counterpart of `vlm_fo1_tpu/native`).

`preproc.cpp` is compiled with `g++ -O3 -march=native -shared -fPIC` at
first use into `build/libfo1_preproc.so` at the repository root, and again
whenever the source is newer than the library. A failed compile raises with
the compiler's output. Only a missing `g++` leaves the numpy path of
`preprocess/image.py` in use: then `get_lib()` returns None.

`calls` counts which path each preprocessing call took ("native" or
"numpy"), as the kernels count their launches. `enabled = False` sends the
callers down the numpy path (for comparisons); it is True by default.

The C++ path multiplies by 1/std where the numpy path divides by std, so
the two agree to 1e-6, not bit for bit.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "preproc.cpp")
_SO = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                   "libfo1_preproc.so")

_lib = None
enabled = True
calls = {"native": 0, "numpy": 0}


def library() -> str:
    return _SO


def build() -> bool:
    """Compile the library when it is missing or older than its source.
    Returns False when there is no g++; a failed compile raises."""
    if (os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
        return True
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [gxx, "-O3", "-march=native", "-shared", "-fPIC", _SRC, "-o", tmp],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {_SRC} failed (g++ exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, _SO)   # atomic: concurrent builders never see half a file
    return True


def get_lib():
    """The loaded library, or None when there is no g++."""
    global _lib
    if _lib is not None:
        return _lib
    if not build():
        return None
    lib = ctypes.CDLL(_SO)
    i64 = ctypes.c_int64
    fp = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.qwen_patchify_u8.argtypes = [u8p, i64, i64, i64, i64, i64, fp, fp, fp]
    lib.qwen_patchify_u8.restype = None
    lib.normalize_chw_u8.argtypes = [u8p, i64, i64, fp, fp, fp]
    lib.normalize_chw_u8.restype = None
    lib.qwen_patchify_u8_raw.argtypes = [u8p, i64, i64, i64, i64, i64, u8p]
    lib.qwen_patchify_u8_raw.restype = None
    _lib = lib
    return _lib


def active():
    """The library when the callers should take the native path (enabled
    and g++ present), else None."""
    return get_lib() if enabled else None


def _image(img_u8, multiple=1):
    """A C-contiguous uint8 [H, W, 3] image whose sides divide by
    `multiple` (the C loops assume both)."""
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    h, w = img_u8.shape[:2]
    if img_u8.ndim != 3 or img_u8.shape[2] != 3 or h % multiple or \
            w % multiple:
        raise ValueError(f"expected uint8 [H, W, 3] with H and W multiples "
                         f"of {multiple}, got {img_u8.shape}")
    return img_u8


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def qwen_patchify_native(lib, img_u8: np.ndarray, patch: int, merge: int,
                         temporal: int, mean: np.ndarray, std: np.ndarray):
    """img_u8 [H, W, 3] uint8 (H, W multiples of patch * merge) ->
    normalized pixel_values [grid_h * grid_w, 3 * temporal * patch * patch]
    float32."""
    img_u8 = _image(img_u8, patch * merge)
    h, w, _ = img_u8.shape
    out = np.empty(((h // patch) * (w // patch), 3 * temporal * patch * patch),
                   np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    inv_std = np.ascontiguousarray(1.0 / np.asarray(std, np.float32))
    lib.qwen_patchify_u8(_u8ptr(img_u8), h, w, patch, merge, temporal,
                         _fptr(mean), _fptr(inv_std), _fptr(out))
    return out


def normalize_chw_native(lib, img_u8: np.ndarray, mean: np.ndarray,
                         std: np.ndarray):
    """img_u8 [H, W, 3] uint8 -> normalized [3, H, W] float32."""
    img_u8 = _image(img_u8)
    h, w, _ = img_u8.shape
    out = np.empty((3, h, w), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    inv_std = np.ascontiguousarray(1.0 / np.asarray(std, np.float32))
    lib.normalize_chw_u8(_u8ptr(img_u8), h, w, _fptr(mean), _fptr(inv_std),
                         _fptr(out))
    return out


def qwen_patchify_raw_native(lib, img_u8: np.ndarray, patch: int, merge: int,
                             temporal: int):
    """The layout transform alone: [H, W, 3] uint8 -> uint8 pixel_values
    [grid_h * grid_w, 3 * temporal * patch * patch]."""
    img_u8 = _image(img_u8, patch * merge)
    h, w, _ = img_u8.shape
    out = np.empty(((h // patch) * (w // patch), 3 * temporal * patch * patch),
                   np.uint8)
    lib.qwen_patchify_u8_raw(_u8ptr(img_u8), h, w, patch, merge, temporal,
                             _u8ptr(out))
    return out
