"""The MSDA gather microbenchmark (counterpart of `tools/xp_msda_micro.py`,
whose Pallas kernel timed one MSDA-shaped pass per query-block size and
index layout).

For each head h and query q (query block j = q // qb, 64-query group
g64 = (q % qb) // 64) the function sums over the S = 4 slots
`val4[h, max(code[h, j, g64 * S + s], 0) + delta[h, q, s], :]` (bf16, 128
wide) times `w128[h, q, s * 128:(s + 1) * 128]` (f32), with
`w128 = bf16(w4) @ ex`, in slot order in float32; a row index is clamped
into the band. `gather_bench` launches the hand-written CUDA kernel
(`csrc/msda_micro_bench.cu`) for CUDA tensors and takes the plain version
`gather_reference` only for CPU tensors. `ex` must be a selection matrix
(each column at most one 1, else 0), as the TPU file's `eye(16, 512)` is: the
kernel gathers its weights by column instead of multiplying.
"""

from __future__ import annotations

import ctypes

import torch

from vlm_fo1_tpu_torch.ops import cuda_lib

# the TPU file's geometry
S, D4, HEADS = 4, 128, 8
LQP = 76800
RBAND = 16384
NW = 4 * S                      # w4 columns
BLOCKS = (256, 512, 1024)       # queries per block
# the TPU file's four cases: (name, queries per block, slot-major)
CASES = (("base", 256, False), ("qb512", 512, False),
         ("qb512-t", 512, True), ("qb1024-t", 1024, True))
_lib = None


def make_inputs(qb, slot_major, gen=None, device="cuda", heads=HEADS,
                lqp=LQP, rband=RBAND):
    """Seeded inputs of the TPU file's kinds: val4 [heads, rband, 128] bf16;
    code [heads, ncode, 128] int32 in [0, rband - 128); delta [heads, lqp,
    S] (slot-major [heads, 8, lqp]) int32 in [0, 128); w4 [heads, lqp, 16]
    (slot-major [heads, 16, lqp]) f32; ex = eye(16, 512) bf16."""
    def randint(hi, shape):
        return torch.randint(0, hi, shape, generator=gen, dtype=torch.int32,
                             device=device)

    ncode = (lqp // qb + 7) // 8 * 8
    val4 = torch.randn(heads, rband, D4, generator=gen,
                       device=device).to(torch.bfloat16)
    code = randint(rband - 128, (heads, ncode, 128))
    if slot_major:
        delta = randint(128, (heads, 8, lqp))
        w4 = torch.randn(heads, NW, lqp, generator=gen, device=device)
    else:
        delta = randint(128, (heads, lqp, S))
        w4 = torch.randn(heads, lqp, NW, generator=gen, device=device)
    ex = torch.eye(NW, S * D4, device=device).to(torch.bfloat16)
    return val4, code, delta, w4, ex


def _rows(code, delta, qb, slot_major, rband):
    """[H, LQ, S] row of val4 each (query, slot) reads."""
    h = code.shape[0]
    lq = delta.shape[2] if slot_major else delta.shape[1]
    q = torch.arange(lq, device=code.device)
    col = ((q % qb) // 64)[:, None] * S + torch.arange(S, device=code.device)
    base = code[:, (q // qb)[:, None], col]                     # [H, LQ, S]
    d = delta[:, :S, :].transpose(1, 2) if slot_major else delta
    return (base.clamp_min(0) + d).clamp(0, rband - 1).reshape(h, lq, S)


def gather_reference(val4, code, delta, w4, ex, qb, slot_major):
    """Plain version: [H, LQ, 128] float32, the slots summed in order."""
    h, rband, d4 = val4.shape
    rows = _rows(code, delta, qb, slot_major, rband).long()
    wq = w4.transpose(1, 2) if slot_major else w4               # [H, LQ, 16]
    w128 = wq.to(torch.bfloat16).float() @ ex.float()           # [H, LQ, 512]
    out = torch.zeros(h, rows.shape[1], d4, dtype=torch.float32,
                      device=val4.device)
    for s in range(S):
        idx = rows[:, :, s, None].expand(-1, -1, d4)
        sel = torch.gather(val4, 1, idx).float()
        out = out + sel * w128[:, :, s * d4:(s + 1) * d4]
    return out


def column_map(ex):
    """int8 [S * 128]: the row of the selection matrix ex [16, 512] whose 1
    weights each column, -1 for an all-zero column; raises for any other
    matrix."""
    exf = ex.float()
    if exf.shape != (NW, S * D4) or not bool(
            ((exf == 0) | (exf == 1)).all()) or bool(
            (exf.sum(0) > 1).any()):
        raise ValueError("gather_bench: ex must be a [16, 512] selection "
                         "matrix (each column at most one 1, else 0)")
    return torch.where(exf.sum(0) > 0, exf.argmax(0),
                       torch.full_like(exf[0], -1).long()).to(torch.int8)


def _load():
    global _lib
    if _lib is None:
        lib = cuda_lib.load("msda_micro_bench")
        fn = lib.fo1_msda_micro_bench
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 6 + [ci] * 6 + [vp]
        fn.restype = ci
        _lib = lib
    return _lib


def gather_bench(val4, code, delta, w4, ex, qb, slot_major, colmap=None):
    """The function above -> [H, LQ, 128] float32. CUDA tensors launch the
    kernel (colmap: `column_map(ex)`, computed here when not given); CPU
    tensors take `gather_reference`."""
    if qb not in BLOCKS:
        raise ValueError(f"gather_bench: qb {qb} not in {BLOCKS}")
    if val4.device.type == "cpu":
        return gather_reference(val4, code, delta, w4, ex, qb, slot_major)
    h, rband, d4 = val4.shape
    lq = delta.shape[2] if slot_major else delta.shape[1]
    want_d = (h, 8, lq) if slot_major else (h, lq, S)
    want_w = (h, NW, lq) if slot_major else (h, lq, NW)
    tensors = (val4, code, delta, w4, ex)
    if (val4.device.type != "cuda" or any(t.device != val4.device
                                          for t in tensors)
            or val4.dtype != torch.bfloat16 or d4 != D4
            or code.dtype != torch.int32 or delta.dtype != torch.int32
            or w4.dtype != torch.float32 or tuple(delta.shape) != want_d
            or tuple(w4.shape) != want_w or code.shape[0] != h
            or code.shape[1] < lq // qb or code.shape[2] != 128
            or lq % qb or not all(t.is_contiguous() for t in tensors)):
        raise ValueError(
            f"gather_bench: val4 {tuple(val4.shape)} {val4.dtype}, code "
            f"{tuple(code.shape)}, delta {tuple(delta.shape)}, w4 "
            f"{tuple(w4.shape)} on {val4.device}, qb {qb}")
    if colmap is None:
        colmap = column_map(ex)
    out = torch.empty(h, lq, D4, dtype=torch.float32, device=val4.device)
    with torch.cuda.device(val4.device):
        err = _load().fo1_msda_micro_bench(
            val4.data_ptr(), code.data_ptr(), delta.data_ptr(),
            w4.data_ptr(), colmap.data_ptr(), out.data_ptr(), h, rband, lq,
            code.shape[1], qb, int(slot_major),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"msda micro kernel launch failed: CUDA error "
                           f"{err}")
    gather_bench.launches += 1
    return out


gather_bench.launches = 0
