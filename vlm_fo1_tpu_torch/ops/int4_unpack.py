"""Nibble-decode strategies and the fused gate/up product they feed
(counterpart of `tools/xp_int4_unpack.py`, whose Pallas kernel timed
unpack strategies at the fused int4 MLP's geometry).

For x [M, D] bf16 and gate and up packed [D/2, I] int8 (byte [r, n]: W[r, n]
in the low nibble, W[D/2 + r, n] in the high one), each of the I / TI tiles t
of TI columns gives

    g_t = x[:, :D/2] @ lo(gate_t) + x[:, D/2:] @ hi(gate_t),  u_t likewise

with f32 sums, and the output o [M, D] f32 is the sum over t of
pad(g_t * u_t): o[:, :TI] holds it, o[:, TI:] is zero. The strategy is the
decode of lo and hi: the TPU file's `divide`, `shift` and `float` (whose low
value is the UNSIGNED nibble, as the TPU file computes it), the port's `cvt`
(`unpack_int4_halves`) and `magic` (`decode_magic`, the tiled kernels'
decode); `none` decodes nothing and multiplies x[:, :D/2] by the raw bytes.

`unpack_bench` launches the hand-written CUDA kernel
(`csrc/int4_unpack_bench.cu`) for CUDA tensors and takes the plain version
`unpack_bench_reference` only for CPU tensors. `copy_ring` runs the
kernel's copy ring alone, to measure the stream without the decode.
"""

from __future__ import annotations

import ctypes

import torch

from vlm_fo1_tpu_torch.ops import cuda_lib
from vlm_fo1_tpu_torch.ops.int4_matmul import sm_count, unpack_int4_halves

# the TPU file's geometry: x [M, D], gate and up packed [D/2, I], tiles of TI
D, I, TI, M = 2048, 11008, 256, 8
STRATEGIES = ("none", "divide", "shift", "float", "cvt", "magic")
# the kernel's geometry: tiles of TILE columns (the TPU file's TI), items of
# ROWS packed rows, a block's range of items within MAX_SEG tiles, a tile's
# items within MAX_OWN blocks' ranges, at most MAX_TILES tiles
TILE, ROWS, MAX_SEG, MAX_OWN, MAX_TILES = 256, 32, 2, 8, 64
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


def unpack_bench_reference(x, g, u, strategy, ti=TI):
    """Plain version of `unpack_bench`: o [M, D] float32, the sum over the
    I / ti tiles of pad(g_t * u_t) (see the module docstring), products of
    the bf16 values summed in f32."""
    m, d = x.shape
    half = d // 2
    xf = x.float()

    def product(w):
        if strategy == "none":
            return xf[:, :half] @ w.float()
        lo, hi = decode_reference(w, strategy)
        return xf[:, :half] @ lo.float() + xf[:, half:] @ hi.float()

    gu = product(g) * product(u)
    out = torch.zeros(m, d, dtype=torch.float32, device=x.device)
    out[:, :ti] = gu.reshape(m, -1, ti).sum(1)
    return out


def _check(name, x, g, u, strategy, ti):
    if strategy not in STRATEGIES:
        raise ValueError(f"{name}: unknown strategy {strategy!r}")
    m, d = x.shape
    if (x.dtype != torch.bfloat16 or g.dtype != torch.int8
            or u.dtype != torch.int8 or g.shape != u.shape
            or g.shape[0] * 2 != d or g.shape[1] % ti or ti > d):
        raise ValueError(f"{name}: x {tuple(x.shape)} {x.dtype}, g "
                         f"{tuple(g.shape)} {g.dtype}, u {tuple(u.shape)} "
                         f"{u.dtype}, ti {ti}")


def _load():
    global _lib
    if _lib is None:
        lib = cuda_lib.load("int4_unpack_bench")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fo1_int4_unpack_bench.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci,
                                              ci, ci, ci, ci, vp]
        lib.fo1_int4_unpack_bench.restype = ci
        _lib = lib
    return _lib


def plan_fits(tiles, row_blocks, grid):
    """Whether `grid` blocks sharing the tiles x row_blocks items in equal
    contiguous ranges leave every block's range within MAX_SEG tiles and
    every tile within MAX_OWN blocks' ranges (the kernel's workspace and
    fold)."""
    items, owners = tiles * row_blocks, {}
    for q in range(grid):
        a, b = q * items // grid, (q + 1) * items // grid
        if b <= a:
            continue
        if (b - 1) // row_blocks - a // row_blocks + 1 > MAX_SEG:
            return False
        for t in range(a // row_blocks, (b - 1) // row_blocks + 1):
            owners[t] = owners.get(t, 0) + 1
    return max(owners.values(), default=0) <= MAX_OWN


def grid_for(d, i, sms):
    """The kernel's blocks for this geometry: the most, up to one an SM (the
    launch is cooperative) and one an item, that `plan_fits`; 0 when none
    does."""
    tiles, row_blocks = i // TILE, d // 2 // ROWS
    if tiles > MAX_TILES:
        return 0
    for grid in range(min(sms, tiles * row_blocks), 0, -1):
        if plan_fits(tiles, row_blocks, grid):
            return grid
    return 0


def _launch(name, x, g, u, strategy, ti, loads_only):
    dev = x.device
    if dev.type != "cuda" or g.device != dev or u.device != dev:
        raise ValueError(f"{name}: unsupported devices {x.device}, "
                         f"{g.device}, {u.device}")
    if not (x.is_contiguous() and g.is_contiguous() and u.is_contiguous()):
        raise ValueError(f"{name}: tensors must be contiguous")
    m, d = x.shape
    n = g.shape[1]
    grid = grid_for(d, n, sm_count(dev.index)) if ti == TILE else 0
    if grid == 0:
        raise ValueError(f"{name}: the kernel takes tiles of {TILE} columns, "
                         f"at most {MAX_SEG} tiles a block and {MAX_OWN} "
                         f"blocks a tile (ti {ti}, x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)})")
    lib = _load()
    out = torch.empty(m, d, dtype=torch.float32, device=dev)
    ws = torch.empty(grid * MAX_SEG * 2 * 8 * TILE, dtype=torch.float32,
                     device=dev)
    with torch.cuda.device(dev):
        err = lib.fo1_int4_unpack_bench(
            x.data_ptr(), g.data_ptr(), u.data_ptr(), ws.data_ptr(),
            out.data_ptr(), m, d, n, ti, STRATEGIES.index(strategy), grid,
            int(loads_only), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"(x {tuple(x.shape)}, g {tuple(g.shape)}, grid "
                           f"{grid})")
    return out


def unpack_bench(x, g, u, strategy, ti=TI):
    """o [M, D] float32: the fused gate/up product of x [M, D] bf16 with the
    packed int8 gate and up [D/2, I], decoded by `strategy` (see the module
    docstring). CPU tensors take `unpack_bench_reference`; on the card M <=
    8, D a multiple of 64 from 256 to 2048, ti 256, I a multiple of 256."""
    _check("unpack_bench", x, g, u, strategy, ti)
    if x.device.type == "cpu":
        return unpack_bench_reference(x, g, u, strategy, ti)
    out = _launch("unpack_bench", x, g, u, strategy, ti, False)
    unpack_bench.launches += 1
    return out


def copy_ring(x, g, u, ti=TI):
    """The kernel's copy ring alone on CUDA tensors: the same launch as
    `unpack_bench`, with every stage of gate and up copied in and released
    unread (o[:, :ti] reads 0). A measurement of the stream, with no plain
    version: other devices raise."""
    _check("copy_ring", x, g, u, "magic", ti)
    out = _launch("copy_ring", x, g, u, "magic", ti, True)
    copy_ring.launches += 1
    return out


unpack_bench.launches = 0
copy_ring.launches = 0
