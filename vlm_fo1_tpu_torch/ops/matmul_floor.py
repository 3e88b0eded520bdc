"""The small chained-product microbenchmark (counterpart of
`tools/xp_matmul_floor.py`, whose Pallas kernel measured the floor of the
small products that the TPU's MSDA kernel selected corners with).

Each of NSTEP steps computes out[QB, 128] float32 for QB = 1024 queries, in
row tiles, by one of four variants of `lhs` [QB, 512] bf16, `rhs`
[512, 128] bf16 and `w` [QB, 512] f32: "chain" sums lhs[:, :128] @ each
128-row slot block of rhs over the 4 slots; "weight" multiplies each slot's
product by w's matching 128 columns first; "same" uses rhs's first block
for every slot; "k512" is one lhs @ rhs. `floor_bench` launches the
hand-written CUDA kernel (`csrc/matmul_floor_bench.cu`, `wgmma` bf16
products with f32 sums) for CUDA tensors and takes the plain version
`floor_reference` only for CPU tensors. Every step gives the same tile;
the step count is an argument (the TPU file's 600 by default), and the
kernel computes every step.
"""

from __future__ import annotations

import ctypes

import torch

from vlm_fo1_tpu_torch.ops import cuda_lib

# the TPU file's geometry
QB = 1024
NSTEP = 600
SLOTS = 4
VARIANTS = ("chain", "weight", "same", "k512")
ROWS = (64, 128, 256, 512)
# the TPU file's seven cases: (name, row tile, variant)
CASES = (("rows64", 64, "chain"), ("rows128", 128, "chain"),
         ("rows256", 256, "chain"), ("rows512", 512, "chain"),
         ("w64", 64, "weight"), ("same64", 64, "same"),
         ("k512x64", 64, "k512"))
# multiply-adds of a call, 2 flops each; the same for every variant (the
# "weight" variant's f32 products, 1/64 of the rest, left out)
FLOPS = 2 * NSTEP * QB * SLOTS * 128 * 128
_lib = None


def make_inputs(gen=None, device="cuda", qb=QB):
    """Seeded lhs [qb, 512] bf16, rhs [512, 128] bf16, w [qb, 512] f32, as
    the TPU file draws them."""
    lhs = torch.randn(qb, 512, generator=gen, device=device)
    rhs = torch.randn(SLOTS * 128, 128, generator=gen, device=device)
    w = torch.randn(qb, 512, generator=gen, device=device)
    return lhs.to(torch.bfloat16), rhs.to(torch.bfloat16), w


def floor_reference(lhs, rhs, w, variant, nstep=1):
    """Plain version: [QB, 128] float32, slots summed in order; computed
    `nstep` times over, as the kernel's steps (each gives the same tile)."""
    lf, rf = lhs.float(), rhs.float()
    for _ in range(nstep):
        if variant == "k512":
            acc = lf @ rf
            continue
        acc = torch.zeros(lhs.shape[0], 128, dtype=torch.float32,
                          device=lhs.device)
        for s in range(SLOTS):
            r0 = 0 if variant == "same" else s * 128
            sel = lf[:, :128] @ rf[r0:r0 + 128]
            if variant == "weight":
                sel = sel * w[:, s * 128:(s + 1) * 128]
            acc = acc + sel
    return acc


def _load():
    global _lib
    if _lib is None:
        lib = cuda_lib.load("matmul_floor_bench")
        fn = lib.fo1_matmul_floor_bench
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
        fn.restype = ci
        _lib = lib
    return _lib


def floor_bench(lhs, rhs, w, variant, rows=64, nstep=NSTEP):
    """One call: nstep steps of the variant in row tiles of `rows` ->
    out [QB, 128] float32. CPU tensors take `floor_reference` of one step
    (every step gives the same tile)."""
    if variant not in VARIANTS or rows not in ROWS or nstep < 1:
        raise ValueError(f"floor_bench: variant {variant!r}, rows {rows}, "
                         f"nstep {nstep}")
    if lhs.device.type == "cpu":
        return floor_reference(lhs, rhs, w, variant)
    dev = lhs.device
    if (dev.type != "cuda" or rhs.device != dev or w.device != dev
            or lhs.dtype != torch.bfloat16 or rhs.dtype != torch.bfloat16
            or w.dtype != torch.float32 or tuple(lhs.shape) != (QB, 512)
            or tuple(rhs.shape) != (SLOTS * 128, 128)
            or tuple(w.shape) != (QB, 512)
            or not (lhs.is_contiguous() and rhs.is_contiguous()
                    and w.is_contiguous())
            or (variant != "chain" and rows != 64)):
        raise ValueError(f"floor_bench: lhs {tuple(lhs.shape)} {lhs.dtype}, "
                         f"rhs {tuple(rhs.shape)}, w {tuple(w.shape)} on "
                         f"{dev}, variant {variant!r} rows {rows}")
    out = torch.empty(QB, 128, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _load().fo1_matmul_floor_bench(
            lhs.data_ptr(), rhs.data_ptr(), w.data_ptr(), out.data_ptr(),
            rows, VARIANTS.index(variant), nstep,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul floor kernel launch failed: CUDA error "
                           f"{err}")
    floor_bench.launches += 1
    return out


floor_bench.launches = 0
