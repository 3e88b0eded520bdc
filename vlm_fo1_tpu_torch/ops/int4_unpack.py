"""Nibble-decode strategies and their card microbenchmark (counterpart of
`tools/xp_int4_unpack.py`, whose Pallas kernel timed unpack strategies at
the fused int4 MLP's geometry).

The plain versions below decode packed int4 bytes to bf16 by each
strategy; `decode_magic` writes out, on integer bit patterns, the
magic-number decode that the tiled int4 kernels run
(`csrc/int4_core.cuh` `decode_magic`). `unpack_bench` launches the
hand-written CUDA kernel (`csrc/int4_unpack_bench.cu`) for CUDA tensors and
takes the plain version only for CPU tensors: it streams two packed arrays
once and folds every decoded bf16x2 word into a 32-bit XOR checksum, or
returns the decoded values.
"""

from __future__ import annotations

import ctypes

import torch

from vlm_fo1_tpu_torch.ops import cuda_lib
from vlm_fo1_tpu_torch.ops.int4_matmul import unpack_int4_halves

# the TPU file's geometry: gate and up packed [D/2, I]
D, I = 2048, 11008
STRATEGIES = ("none", "divide", "shift", "float", "cvt", "magic")
_lib = None


def unpack_divide(p32):
    """The TPU file's `unpack_divide` on int32 bytes: (lo, hi) int32."""
    hi = torch.div(p32, 16, rounding_mode="floor")
    lo = p32 - 16 * hi
    lo = lo - 16 * (lo >= 8).to(torch.int32)
    return lo, hi


def unpack_shift(p32):
    """The TPU file's `unpack_shift` on int32 bytes: (lo, hi) int32."""
    return (p32 << 28) >> 28, p32 >> 4


def unpack_float(p8, dtype):
    """The TPU file's `unpack_float`: (lo, hi) in `dtype`. Its lo is the
    UNSIGNED low nibble, [0, 15]."""
    pf = p8.to(dtype)
    hif = torch.floor(pf * (1.0 / 16.0))
    return pf - 16.0 * hif, hif


def decode_magic(packed):
    """The kernels' magic-number decode, step for step on 32-bit words of
    four packed bytes: w ^ 0x88888888 moves each signed nibble s to s + 8;
    the bytes spread into 16-bit halves (`__byte_perm` 0x4140 / 0x4342);
    a nibble OR-ed into the bf16 pattern 0x4300 (128.0, one unit per
    mantissa step) reads 136 + s; x * 1 - 136 in bf16 leaves s.
    int8 [..., 4n] -> (lo, hi) bf16 of the same shape."""
    words = packed.contiguous().view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    w = words ^ 0x88888888
    t01 = (w & 0xFF) | (((w >> 8) & 0xFF) << 16)
    t23 = ((w >> 16) & 0xFF) | (((w >> 24) & 0xFF) << 16)

    def bf16x2(word):
        halves = torch.stack([word & 0xFFFF, word >> 16], -1)
        v = halves.to(torch.int16).view(torch.bfloat16)
        return (v.float() * 1.0 - 136.0).to(torch.bfloat16)

    mask, magic = 0x000F000F, 0x43004300
    lo = torch.cat([bf16x2((t01 & mask) | magic),
                    bf16x2((t23 & mask) | magic)], -1)
    hi = torch.cat([bf16x2(((t01 >> 4) & mask) | magic),
                    bf16x2(((t23 >> 4) & mask) | magic)], -1)
    return lo.reshape(packed.shape), hi.reshape(packed.shape)


def decode_reference(packed, strategy):
    """Plain version of one strategy: int8 packed -> (lo, hi) bf16 (the
    kernel's values; "float" keeps the TPU file's unsigned lo)."""
    if strategy == "magic":
        return decode_magic(packed)
    if strategy == "float":
        return unpack_float(packed, torch.bfloat16)
    if strategy == "cvt":
        lo, hi = unpack_int4_halves(packed)
    elif strategy in ("divide", "shift"):
        fn = unpack_divide if strategy == "divide" else unpack_shift
        lo, hi = fn(packed.to(torch.int32))
    else:
        raise ValueError(f"no decoded values for strategy {strategy!r}")
    return lo.to(torch.bfloat16), hi.to(torch.bfloat16)


def _xor_reduce(words):
    """XOR of all int32 words (a halving tree: works on any device)."""
    w = words.reshape(-1)
    while w.numel() > 1:
        half = w.numel() // 2
        w = torch.cat([w[:half] ^ w[half:2 * half], w[2 * half:]])
    return w.reshape(()) if w.numel() else torch.zeros((), dtype=torch.int32,
                                                      device=words.device)


def _pairs(values):
    """bf16 [2n] -> int32 [n] words, element 2j in the low 16 bits."""
    bits = values.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
    return bits[0::2] | (bits[1::2] << 16)


def unpack_bench_reference(g, u, strategy, decoded=False):
    """Plain version of `unpack_bench`: the checksum (0-dim int32), or with
    `decoded` the (lo, hi) bf16 values of g then u."""
    if strategy == "none":
        if decoded:
            raise ValueError("strategy 'none' decodes nothing")
        return _xor_reduce(torch.cat([g.reshape(-1).view(torch.int32),
                                      u.reshape(-1).view(torch.int32)]))
    lo, hi = (torch.cat(p) for p in zip(decode_reference(g.reshape(-1),
                                                         strategy),
                                        decode_reference(u.reshape(-1),
                                                         strategy)))
    if decoded:
        return lo, hi
    return _xor_reduce(torch.cat([_pairs(lo), _pairs(hi)]))


def _load():
    global _lib
    if _lib is None:
        lib = cuda_lib.load("int4_unpack_bench")
        fn = lib.fo1_int4_unpack_bench
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, ctypes.c_longlong, ctypes.c_int, vp, vp, vp,
                       vp]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def unpack_bench(g, u, strategy, decoded=False):
    """Decode the packed int8 arrays g and u (same size, a multiple of 16
    bytes) by `strategy`: the XOR checksum of every decoded bf16x2 word (of
    the raw words for "none") as a 0-dim int32, or with `decoded` the
    (lo, hi) bf16 values of g then u. CPU tensors take
    `unpack_bench_reference`."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    if g.device.type == "cpu":
        return unpack_bench_reference(g, u, strategy, decoded)
    if g.device.type != "cuda" or u.device != g.device:
        raise ValueError(f"unpack_bench: unsupported devices {g.device}, "
                         f"{u.device}")
    if g.dtype != torch.int8 or u.dtype != torch.int8 \
            or g.numel() != u.numel() or g.numel() % 16 \
            or not (g.is_contiguous() and u.is_contiguous()):
        raise ValueError(f"unpack_bench: g {tuple(g.shape)} {g.dtype}, u "
                         f"{tuple(u.shape)} {u.dtype}")
    if decoded and strategy == "none":
        raise ValueError("strategy 'none' decodes nothing")
    n = g.numel()
    checksum = torch.zeros((), dtype=torch.int32, device=g.device)
    lo = hi = None
    if decoded:
        lo = torch.empty(2 * n, dtype=torch.bfloat16, device=g.device)
        hi = torch.empty(2 * n, dtype=torch.bfloat16, device=g.device)
    with torch.cuda.device(g.device):
        err = _load().fo1_int4_unpack_bench(
            g.data_ptr(), u.data_ptr(), n, STRATEGIES.index(strategy),
            None if lo is None else lo.data_ptr(),
            None if hi is None else hi.data_ptr(), checksum.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"unpack_bench kernel launch failed: CUDA error "
                           f"{err}")
    unpack_bench.launches += 1
    return (lo, hi) if decoded else checksum


unpack_bench.launches = 0
