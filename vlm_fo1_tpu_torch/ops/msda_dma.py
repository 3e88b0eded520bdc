"""The MSDA streaming microbenchmark (counterpart of `tools/xp_msda_dma.py`,
whose Pallas kernels rebuilt the MSDA pass structure with an empty body and
added one input block at a time).

`dma_bench` launches the hand-written CUDA kernel (`csrc/msda_dma_bench.cu`)
for CUDA tensors and takes the plain version `dma_bench_reference` only for
CPU tensors. One call runs a case's passes: each streams the case's arrays
once, writes the out block of zeros, and adds a 32-bit wrapping sum of
every word it read into the checksum. It returns (out, checksum).
"""

from __future__ import annotations

import ctypes

import torch

from vlm_fo1_tpu_torch.ops import cuda_lib

# the TPU file's geometry
QB = 256
NQB = 299
HEADS = 8
PASSES = 4
RBAND = 26624
BROWS = QB * 4 // 128
VAL4, DVM, W4, CODE, DENSE, DSMEM = 1, 2, 4, 8, 16, 32
# (name, flags, out width, passes, dynamic shared memory KB): `main`'s six
# input sets, `main2`'s variants, `main3`'s scratch sizes (the TPU file's
# 1-4 MB VMEM scratch becomes shared memory per block on the card)
CASES = (
    ("base (val4+out)", VAL4, 32, PASSES, 0),
    ("+dvm thin", VAL4 | DVM, 32, PASSES, 0),
    ("+dvm+w4 thin", VAL4 | DVM | W4, 32, PASSES, 0),
    ("+smem code", VAL4 | DVM | W4 | CODE, 32, PASSES, 0),
    ("+dense regs x3", VAL4 | DVM | W4 | CODE | DENSE, 32, PASSES, 0),
    ("+dense smem x3 (prod)", VAL4 | DVM | W4 | CODE | DSMEM, 32, PASSES, 0),
    ("out128, val4, 4 passes", VAL4, 128, PASSES, 0),
    ("out32, no val4, 4 passes", 0, 32, PASSES, 0),
    ("out32, val4, 1 pass", VAL4, 32, 1, 0),
    ("scratch 48KB", VAL4, 32, PASSES, 48),
    ("scratch 96KB", VAL4, 32, PASSES, 96),
    ("scratch 192KB", VAL4, 32, PASSES, 192),
)
_lib = None


def make_inputs(gen=None, device="cpu", heads=HEADS, nqb=NQB, rband=RBAND):
    """Seeded arrays of the TPU file's shapes (it streamed zeros; random
    words make the checksum see every read): val4 [heads, rband, 128] bf16,
    dvm [heads, lq, 4] and w4 [heads, lq, 16] (float32 bits), three code
    arrays [heads, ceil(nqb/8)*8, 128] and three dense [heads, lq*4/128,
    128], all int32 but val4."""
    lq = nqb * QB

    def words(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                             dtype=torch.int32, device=device)

    code_rows = -(-nqb // 8) * 8
    return {
        "val4": torch.randn(heads, rband, 128, generator=gen,
                            device=device).to(torch.bfloat16),
        "dvm": words(heads, lq, 4),
        "w4": torch.randn(heads, lq, 16, generator=gen, device=device),
        "code": [words(heads, code_rows, 128) for _ in range(3)],
        "dense": [words(heads, lq * 4 // 128, 128) for _ in range(3)],
    }


def _word_sum(t):
    """Sum of a tensor's 32-bit words, as int64."""
    return int(t.contiguous().view(torch.int32).to(torch.int64).sum().item())


def _arrays(inputs, flags):
    out = []
    if flags & VAL4:
        out.append(inputs["val4"])
    if flags & DVM:
        out.append(inputs["dvm"])
    if flags & W4:
        out.append(inputs["w4"])
    if flags & CODE:
        out += inputs["code"]
    if flags & (DENSE | DSMEM):
        out += inputs["dense"]
    return out


def dma_bench_reference(inputs, flags, out_w=32, passes=PASSES):
    """Plain version: (zeros [heads, lq, out_w] f32, checksum 0-dim int32 =
    passes x the sum of every 32-bit word of the case's arrays, mod 2^32)."""
    heads, lq = inputs["dvm"].shape[:2]
    total = passes * sum(_word_sum(t) for t in _arrays(inputs, flags))
    total &= 0xFFFFFFFF
    if total >= 2**31:
        total -= 2**32
    device = inputs["dvm"].device
    return (torch.zeros(heads, lq, out_w, dtype=torch.float32, device=device),
            torch.tensor(total, dtype=torch.int32, device=device))


def _load():
    global _lib
    if _lib is None:
        lib = cuda_lib.load("msda_dma_bench")
        fn = lib.fo1_msda_dma_bench
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp] + [ci] * 7 + [vp]
        fn.restype = ci
        _lib = lib
    return _lib


def dma_bench(inputs, flags, out_w=32, passes=PASSES, scratch_kb=0):
    """Run one case: `passes` launches of the streaming kernel (each counts
    one launch) -> (out, checksum) as `dma_bench_reference`. CPU tensors
    take the plain version."""
    if inputs["dvm"].device.type == "cpu":
        return dma_bench_reference(inputs, flags, out_w, passes)
    heads, lq = inputs["dvm"].shape[:2]
    nqb = lq // QB
    rband = inputs["val4"].shape[1]
    code_rows = inputs["code"][0].shape[1]
    tensors = [inputs["val4"], inputs["dvm"], inputs["w4"], *inputs["code"],
               *inputs["dense"]]
    dev = inputs["dvm"].device
    if (dev.type != "cuda" or lq % QB or any(t.device != dev for t in tensors)
            or not all(t.is_contiguous() for t in tensors)
            or inputs["val4"].dtype != torch.bfloat16
            or tuple(inputs["w4"].shape) != (heads, lq, 16)
            or any(tuple(t.shape) != (heads, lq * 4 // 128, 128)
                   for t in inputs["dense"])
            or any(tuple(t.shape) != (heads, code_rows, 128)
                   for t in inputs["code"]) or code_rows * 8 < nqb
            or out_w not in (32, 128)):
        raise ValueError("dma_bench: arrays of another shape, type or device "
                         "than make_inputs gives")
    want = {VAL4: [0], DVM: [1], W4: [2], CODE: [3, 4, 5],
            DENSE: [6, 7, 8], DSMEM: [6, 7, 8]}
    used = {i for bit, idx in want.items() if flags & bit for i in idx}
    ptrs = (ctypes.c_void_p * 9)(*[t.data_ptr() if i in used else None
                                   for i, t in enumerate(tensors)])
    out = torch.empty(heads, lq, out_w, dtype=torch.float32, device=dev)
    checksum = torch.zeros((), dtype=torch.int32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(passes):
            err = lib.fo1_msda_dma_bench(
                ptrs, out.data_ptr(), checksum.data_ptr(), heads, nqb, rband,
                code_rows, flags, out_w, scratch_kb * 1024, stream)
            if err != 0:
                raise RuntimeError(f"msda dma kernel launch failed: CUDA "
                                   f"error {err}")
            dma_bench.launches += 1
    return out, checksum


dma_bench.launches = 0


def case_bytes(inputs, flags, out_w):
    """Bytes one pass moves: each of the case's arrays read once, the zeros
    written once."""
    heads, lq = inputs["dvm"].shape[:2]
    return (sum(t.numel() * t.element_size() for t in _arrays(inputs, flags))
            + heads * lq * out_w * 4)
