"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  0. environment: torch / CUDA versions, the card, Pillow;
  1. build the ten CUDA kernels from the checkout's sources, one nvcc
     each, started together, and the native host helper
     (native/preproc.cpp -> build/libfo1_preproc.so, g++);
  2. flash attention vs its plain PyTorch version on the card: every mask
     mode and GQA at small shapes, then the two main-path shapes (ViT full
     attention S=6912 D=80 with the real 68x92 window-plan mask; trunk
     prefill H=16/Hkv=2 D=128 causal S=1700 kv_len<S), f32 with TF32 off
     (max abs err <= 1e-4) and bf16 against the plain version in f32 on the
     same bf16 inputs (<= 2e-2); at the main-path shapes also the worst
     relative L2 error of one output row (one query of one head; <= 1e-4
     f32, <= 2e-2 bf16), and two planted faults in bf16 (the last key tile
     with an allowed key skipped, the key mask ignored) that must exceed
     that row bound; at the main-path shapes in bf16 the kernel
     and scaled_dot_product_attention as device time from CUDA graph
     replays, the kernel's eager per-call time, the plain version's time,
     the achieved TFLOP/s and the share of the bound;
  3. multi-scale deformable attention vs its plain version the same way:
     D in {8, 32} at small non-square levels with out-of-range locations,
     then the UPN encoder (Lq = S = 85,932) and decoder (Lq = 900) shapes
     of the demo image, with kernel and plain times beside the bound; each
     also to the worst relative L2 error of one output row (one query of
     one head, <= 1e-4), and at the main shapes in bf16 three planted
     faults run through the plain version (one point of one level dropped,
     one level's start offset by one row, x and y swapped in one level)
     that must read above that bound;
  4. FO1Config.tiny() (untied head) f32 with shared weights: greedy
     tokens on the card (kernel) equal those on the CPU (plain version);
  5. tiny UPN f32 with shared weights: the card (kernel) and the CPU (plain
     version) select the same top-k anchors, boxes and logits to 1e-4;
  6. FO1Config() (Qwen2.5-VL-3B FO1) bf16 with random weights: three
     grounding requests with the 7 demo boxes on seeded synthetic 1288x966
     images, flash launches counted over them, then the first request's
     prefill logits and region tokens compared between the kernel path and
     the plain path;
  7. UPN at the released geometry (Swin-L + UPNConfig()) bf16 with random
     weights: three proposal requests on seeded synthetic 1288x966 images,
     stage times and MSDA launches per request, then one request's encoder
     output compared between the kernel path and the plain path, and the
     kernel checked (with phase 3's row bound and planted faults) and
     timed on that request's own encoder and decoder inputs;
  8. UPN -> FO1: the first 100 proposals after filter(min_score=0,
     nms=0.8) go into one 3B grounding request (the phase-6 model); both
     kernels' launches counted over this path;
 9. the int4 matmul vs its plain version: odd small shapes and tile
     edges (M in {1, 2, 3, 4, 5, 6, 7, 8, 9, 63, 64, 65, 77, 127, 128,
     129}, K/2 off the 64-row tile, K = 11008, N off every tile (24, 130),
     x at byte offsets 4, 8 and 48), each asserting its route (streaming
     for M <= 8; bf16 x on the TMA/wgmma tiles where every row stride is a
     multiple of 16 bytes, else the mma.sync tiles; f32 x on the FMA
     tiles), in f32 with TF32 off (<= 2e-5 x max(1, max|plain|)) and bf16
     (<= 2e-2 x the same), and the worst relative L2 error of one output
     row segment (one row of one 128-column tile; <= 1e-4 f32, <= 1e-2
     bf16), two runs bit-equal; then the 3B trunk shapes (q/o 2048->2048,
     k/v 2048->256, gate/up 2048->11008, down 11008->2048) at M = 1, 2, 4,
     8 (the bf16 streaming route, one launch a call) and M = 1771 (the TMA
     route) the same way, three planted faults run through the plain
     version (a 64-packed-row K tile zeroed, the nibbles of one column tile
     swapped, one column tile's scales shifted by a column) that must
     exceed the segment bound, and kernel, plain and F.linear
     (pre-dequantized bf16 weight) device times from CUDA graph replays
     beside the bound, and the kernel's eager per-call time; at M <= 8 the
     weights rotate through copies larger than the L2 cache, as decode
     finds them;
 10. the fused int4 SwiGLU vs its plain version the same way: the shapes of
     tests/test_quant.py and tile edges (M in {1, ..., 8, 9, 63, 64, 65,
     127, 129}, D/2 off the tile, I = 24 and 130, x at byte offsets 4, 8
     and 48, one shape on the mma.sync tiles), routes asserted for both
     products, then D = 2048, I = 11008 at M = 1, 2, 4, 8 and 1771 with
     the planted faults in the down weight, two runs bit-equal, kernel /
     plain / three-F.linear times;
 11. FO1Config.tiny() f32 (untied head) in the int4 mode, and with I = 128
     in the int4-mlp mode: greedy tokens on the card (kernels) equal those
     on the CPU (plain versions), the same quantized bytes on both;
 12. FO1Config() bf16 in the int4, int4-mlp, int8-all and w8a8 modes
     (`quant.quantize_model` on fresh random weights): grounding requests
     with the 7 demo boxes and 32 tokens, stage times, quantized bytes,
     peak memory, kernel launches and routes per request (the prefill on
     the TMA tiles, the decode steps streaming; each request's launches
     the trunk's int4 modules once per forward the device ran, the first
     request's graph capture included); in the int4 and int4-mlp
     modes the first request's region tokens and prefill logits compared
     between the kernel path and the plain path;
 13. the MSDA backward vs its plain version (autograd of the plain core):
     D in {8, 32} at small levels with out-of-range locations, then phase
     7's encoder (Lq = S = 85,932) and decoder (Lq = 900) inputs with a
     seeded upstream gradient, f32 (TF32 off) and bf16, each of the three
     gradients held to 1e-4 x max(1, max|plain|) (grad_value in bf16 to
     2e-2 x the same), the worst relative L2 error of one row of
     grad_value (one pixel of one head; <= 1e-4, bf16 <= 1e-2) and of
     grad_loc (one query of one head; <= 1e-4), phase 3's planted faults
     in bf16 on both; kernel, plain and bound times;
 14. tiny UPN f32 with shared weights: the parameter gradients of a fixed
     scalar of pred_boxes and pred_logits on the card (both MSDA kernels,
     4 + 4 launches) equal the CPU's (plain versions), each parameter to
     1e-4 x its largest CPU gradient + 1e-6; as a negative control, the
     card run with grad_value, then grad_loc, zeroed in the MSDA backward
     must fail that check;
 15. UPN at the released geometry bf16: forward and backward of such a
     scalar on a seeded 1288x966 image, twice, with forward / backward ms,
     peak memory, 12 MSDA forward and 12 backward launches each, all
     gradients finite;
 16. FO1Config.tiny() f32 (full vocabulary): `multimodal_lm_loss` with
     remat (the ViT's full attention through the flash kernel), loss and
     every parameter gradient card == CPU to the bounds of phase 14; three
     AdamW steps on the card;
 17. FO1Config() bf16 with remat at the demo geometry (1288x966, 7 demo
     boxes): loss and gradients with the ViT's full attention through the
     flash kernel (4 launches) against its plain version (relative L2
     <= 5e-2), the peak memory of each; then three AdamW steps
     (`training.train_step.make_train_step`, 12 flash launches) on one
     seeded batch, loss, ms and peak memory per step;
 18. (after phase 24) the int4 unpack microbenchmark at
     tools/xp_int4_unpack.py's geometry: the TPU file's fused gate/up
     product (x [8, 2048] bf16, gate and up packed [1024, 11008], o [8,
     2048] f32 the sum over 43 tiles of 256 columns of g_t * u_t) for six
     decode strategies (none, divide, shift, float, cvt, magic), each
     against its plain version (worst row relative L2 <= 1e-4), o's
     columns past 256 zero, bit-equal on repeat; shift, cvt and magic
     equal to divide; two planted faults (one byte's nibbles swapped, a
     tile's up columns shifted) through the plain version that must read
     above the bound; one device kernel a call (profiler and wrapper);
     each strategy's ms and GB/s of the packed bytes against 3.35 TB/s,
     the copy ring alone, the plain version and two torch.matmul on the
     dequantised weights with g * u and the tile sum;
 19. (after phase 18) the MSDA streaming microbenchmark at
     tools/xp_msda_dma.py's geometry (8 heads x 299 query blocks of 256,
     4 passes): its twelve cases (the file's six input sets, out width
     128, no value band, one pass, 48 / 96 / 192 KB of shared memory a
     block), zeros and 32-bit checksums equal to the plain version's, ms
     a pass, GB/s against 3.35 TB/s;
 20. the MSDA gather microbenchmark at tools/xp_msda_micro.py's geometry
     (8 heads x 76,800 queries x 4 slots of 128-wide bf16 rows): blocks of
     256 / 512 / 1024 queries, query- and slot-major indices, bit-equal to
     the plain version, ms, us a block and ns a gathered sample;
 21. the chained small-product microbenchmark at tools/xp_matmul_floor.py's
     geometry (600 steps of 1024 queries x 4 slots, wgmma bf16): row tiles
     of 64-512, the weight / same / k512 variants, worst row relative L2 <=
     1e-4 against the plain version, bit-equal on repeat, two planted
     faults (one slot skipped, one k-step skipped) through the plain
     version above the bound, one device kernel a call; ms, ns a 64-query
     slot visit and TFLOP/s (none above 989), rows64 at 300 and 600 steps
     (the time ratio in [1.8, 2.2]: every step computed), one stride-0
     batched torch.matmul over the 600 steps beside each case but weight;
 22. (after phase 5) FO1Config.tiny() f32 with shared weights: generate_batch
     on a same-geometry batch (stacked) and a mixed one (per item), top-p,
     the staged single request, ServingPipeline, ContinuousServingPipeline
     and UPN -> FO1 (tiny UPN): the card (kernels, decode from CUDA graphs)
     equal to the CPU (plain versions), graph decode equal to eager decode
     on the card (tokens and step counts), and launch_batch enqueued with
     no host synchronisation (sync debug mode "error");
 23. (after phase 8) the phase-6 3B model and phase-7 UPN: decode ms a step at
     B = 1 and 8, eager and from graphs, with the graph's memory; the staged
     request's decode stage eager and graphed; two encodes of a batch of 8
     demo requests bit-equal; the batch (ms, tokens/s, peak); each with graph decode equal to eager decode (tokens
     and step counts); each row's prefill logits against the request alone: on
     the same embeddings (the batched prefill, relative L2 <= 2e-2), and end to
     end no farther (x 1.25) from an f32 copy of the weights than the request
     alone, token agreement printed; the flash kernel on the batch's own right-
     padded layer-0 prefill against its plain version (row bound 2e-2);
     ServingPipeline and ContinuousServingPipeline over 16 demo requests
     (requests/s, device steps beside the batch-synchronous sum, retries 0) and
     UPN -> FO1 over 2 images; flash and MSDA launches counted over each of the
     four main-path runs (batch, two pipelines, UPN -> FO1), zeroed just before
     it and read just after;
 24. (after phase 10) the int4 matmul on the four trunk shapes and the
     fused SwiGLU at D = 2048, I = 11008, M = 1, 2, 4 and 8, captured in a
     CUDA graph and replayed: bit-equal to eager, streaming route, and
     within the bf16 bounds of the plain version; the device kernels of
     one M = 8 call from torch.profiler (one a matmul, two a fused MLP);
 25. (after phase 12) the 3B model in the int4 and int4-mlp modes: the
     first demo request alone and a batch of 8 (prefill on the TMA tiles,
     decode streaming from the decode graph), graph decode equal to eager
     decode at B = 1 and 8, the batch's launches the int4 modules once
     per forward the device ran, the decode ms a step at B = 1 and 8,
     eager and from graphs, and the first request's 32-token decode stage
     from its kept graph;
 26. (after phase 23) the phase-6 3B bf16 model on multi-slot prompts: a
     two-image request (two 1288x966 synthetic images, the 7 demo boxes on
     the first) and a video request (8 synthetic 1288x966 frames: grid
     (4, 62, 84), 22,528 padded ViT tokens), each with its stage ms, peak
     memory and flash launches zeroed just before it and read just after
     (4 per ViT encode + 36 for the prefill: 44 and 40); the two-image
     request's kernel path against its plain path at full width
     (PATH_REL_TOL); a generate_batch of 8 mixing four single-image, two
     two-image and two video prompts (per-item encode, 76 flash launches),
     each row's prefill logits within 2e-2 relative L2 of the request
     alone and the greedy tokens that agree printed; the per-stage TFLOP/s
     of the phase-6 demo request from runtime/flops.py against the H100
     SXM dense bf16 peak;
 27. (after phase 2) the flash kernel at the video's ViT full-attention
     shape (S = 22,528, D = 80, 16 heads, the plan's kv_valid) in bf16
     against its plain version on 512 sampled query rows of every head
     against all keys (the whole plain attention needs 32 GB of logits),
     phase 2's row bound and its two planted faults; kernel and
     scaled_dot_product_attention as CUDA graph replays beside the bound,
     the plain version's time on the sampled rows;
 28. (after phase 26) every HFRE variant (the eight combinations, the
     feature-map and hybrid position embeddings, none, vt-only, aux-only,
     region LayerNorms, the SimpleFPN vt path, a pre-concatenated aux map)
     on the phase-6 request's own DaViT maps and ViT captures, and the
     CAbstractor and TokenPacker at the trunk's widths: card vs CPU in
     f32, relative L2 <= 1e-4;
 29. (after phase 28) the evaluation runners over the 3B model on records
     fabricated from --seed (default 0) under build/: 16 CountBench items
     (3-12 boxes) at batch 1, 8 and pipelined 8 with equal predictions, 8
     COCO images through eval_coco and score_coco_files; items/s each;
 30. (after phase 29) the demo request's prepare on the native C++ path
     (counted by native.calls), qwen_image_preprocess,
     aux_image_preprocess and qwen_image_patchify_u8 on a 1288x966 image
     within 1e-6 of their numpy path, stage_ms["prepare"] of the demo
     request native and numpy over 2 x 5 calls each, in turns;
 31. (after phase 30) the phase-6 3B model on the demo prompt padded to a
     multiple of 4: prefill_sequence_parallel over an in-process world-1
     NCCL group and over a LocalRing of 4 chunks (the ring's 4-step
     arithmetic in one process) against prefill; in f32 (an f32 copy of
     the trunk) last-token logits and the prompt's K/V rows to 2e-4
     relative L2; in bf16 no farther (x 1.25) from the f32 prefill than
     the bf16 prefill, the distance to the bf16 prefill printed beside the
     bf16 floor (prefill with the plain attention against the kernel's);
     ms of each (second run); 32 greedy tokens decoded from the SP cache and
     from the dense cache through the decode graphs, their agreement
     printed; then the same with the trunk's MLPs as fused int4 SwiGLUs, 36
     launches in the SP prefill and in prefill;
 32. (after phase 31) python -m vlm_fo1_tpu_torch.parallel.dryrun at world =
     the visible cards on NCCL: the tiny DP x TP suite (serving tokens equal
     to dense, SP prefill, train loss) and one 3B grounding request
     TP-sharded over (1, world), four times (decode from graphs with the
     collectives captured, and eager, in turns), against the same request
     dense, all staged (prefill logits to 2e-2 relative L2; at world 1
     every run's tokens equal the dense ones; each run's token agreement
     and the flash launches printed); the world size is printed, and at
     world 1 the groups are of size 1;
 33. (after phase 23) the decode step's attention kernel against its plain
     version (the chain it replaced) at (B, C) = (1, 1952), (8, 1952) and
     (8, 2432), H 16, Hkv 2, hd 128, bf16, each row valid below a length
     drawn from [C - 200, C]: worst head row within 1e-2 relative L2,
     bit-equal on repeat, kernel and plain as CUDA graph replays over
     copies larger than the L2 cache beside the byte bound (K and V of the
     valid slots, q, the mask and the output once) and the kernel's eager
     per-call time; then a captured B = 8 chunk program of the phase-6 3B
     model (C 2432, prompt bucket 1920, 8 steps) adds 36 launches a step.
Findings go to stdout, each line tagged with the card's name and power
limit; the line before the last is the kernels' JSON summary and the last
line is the result JSON.
"""

import dataclasses
import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

F32_TOL = 1e-4
BF16_TOL = 2e-2
# kernel path vs plain path at full width in bf16, relative to the largest
# reference magnitude: many layers of bf16 rounding in different places
PATH_REL_TOL = 5e-2
DEMO_BOXES = [
    [161.0, 11.0, 292.0, 127.0], [268.0, 61.0, 428.0, 226.0],
    [12.0, 100.0, 140.0, 227.0], [205.0, 188.0, 332.0, 320.0],
    [326.0, 202.0, 478.0, 357.0], [136.0, 106.0, 269.0, 233.0],
    [25.0, 206.0, 200.0, 383.0],
]
# published H100 SXM peaks (dense): device memory rate, bf16 tensor-core
# rate, float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


class Smoke:
    def __init__(self, card):
        self.card = card
        self.failures = []

    def log(self, msg):
        print(f"[{self.card}] {msg}", flush=True)

    def check(self, ok, msg):
        self.log(("PASS " if ok else "FAIL ") + msg)
        if not ok:
            self.failures.append(msg)


def _timeit(fn, n=5):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def _timeit_rotating(fn, copies, n=10):
    """Mean ms of eager fn(*args) calls that cycle through `copies` (lists
    of arguments): with copies larger than the L2 cache in all, every call
    reads its weights from device memory, as a decode step does."""
    for args in copies:
        fn(*args)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(n):
        fn(*copies[i % len(copies)])
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def _graph_ms(fn, copies, reps=5):
    """Device ms per call: one call per copy (at least 10, cycling) captured
    in a CUDA graph and replayed, so no host time sits between the kernels
    (a decode-sized call is shorter than its Python wrapper)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in copies:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    n = max(10, len(copies))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(*copies[i % len(copies)])
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / (reps * n)
    del graph
    torch.cuda.empty_cache()
    return ms


def _copies(nbytes, make):
    """Enough copies from make() to hold at least 120 MB (the L2 is 50 MB)."""
    return [make() for _ in range(max(1, -(-120_000_000 // nbytes)))]


def _bound(nbytes, flops, peak_flops):
    """Least time the card could take: (ms, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _synthetic_image(seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (966, 1288, 3), np.uint8))


def _messages(seed, template, boxes=DEMO_BOXES, image=None):
    return [{
        "role": "user",
        "content": [{"type": "image_url",
                     "image_url": {"url": image or _synthetic_image(seed)}},
                    {"type": "text", "text": template.format("orange")}],
        "bbox_list": boxes,
    }]


# ------------------------------------------------------------ flash kernel

def _row_rel(out, ref):
    """Worst relative L2 error of one output row (one query of one head).
    At the ViT shape a row averages ~6256 keys and its values are ~0.02, so
    an absolute 2e-2 would pass a kernel that drops a whole key tile."""
    diff = (out.float() - ref).norm(dim=-1)
    return (diff / ref.norm(dim=-1).clamp_min(1e-30)).max().item()


def _planted_faults(kw, sk, tile=64):
    """Masks under which the correct kernel returns what a faulty one would:
    the last 64-key tile that holds an allowed key skipped, and the key
    mask (kv_valid or kv_len) ignored."""
    kpos = torch.arange(sk, device="cuda")
    keep = kpos < kw.get("kv_len", sk)
    if "kv_valid" in kw:
        keep &= kw["kv_valid"]
    last = int(kpos[keep].max().item())
    skip = dict(kw, kv_valid=keep & (kpos < last // tile * tile))
    skip.pop("kv_len", None)
    ignore = {n: x for n, x in kw.items() if n not in ("kv_valid", "kv_len")}
    return [("last key tile skipped", skip), ("key mask ignored", ignore)]


def phase_flash(sm, fa, build_vit_plan, vit_cfg):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(b, h, hkv, sq, sk, d, dtype):
        def r(*shape):
            return torch.randn(*shape, device="cuda", generator=gen).to(dtype)
        return r(b, h, sq, d), r(b, hkv, sk, d), r(b, hkv, sk, d)

    def compare(name, shape, kw, dtype):
        q, k, v = inputs(*shape, dtype)
        out = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = fa.flash_attention_reference(q.float(), k.float(), v.float(),
                                           **kw)
        err = (out.float() - ref).abs().max().item()
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        sm.check(bool(torch.isfinite(out).all()) and err <= tol,
                 f"flash {name} {str(dtype)[6:]} shape={shape} "
                 f"max_abs_err={err:.3e} (tol {tol:g})")
        return err, out, (q, k, v, ref)

    rand_valid = torch.rand(130, device="cuda", generator=gen) > 0.3
    small = [
        ("plain", (1, 2, 2, 72, 72), {}),
        ("causal", (1, 2, 2, 72, 72), {"causal": True}),
        ("kv_len", (2, 2, 2, 37, 53), {"kv_len": 40}),
        ("kv_valid", (1, 2, 2, 130, 130), {"kv_valid": rand_valid}),
        ("gqa_causal_kv_len", (1, 4, 2, 100, 100),
         {"causal": True, "kv_len": 90}),
    ]
    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        for d in (12, 16, 80, 128):
            for name, shape, kw in small:
                errs.append(compare(name, shape + (d,), kw, dtype)[0])

    plan = build_vit_plan((1, 68, 92), vit_cfg)
    vit_valid = torch.from_numpy(plan.valid).cuda()
    s_vit = plan.seq_pad
    main = [("vit_full", (1, 16, 16, s_vit, s_vit, 80),
             {"kv_valid": vit_valid}),
            ("prefill", (1, 16, 2, 1700, 1700, 128),
             {"causal": True, "kv_len": 1650})]
    times = {}
    for name, shape, kw in main:
        b, h, hkv, sq, sk, d = shape
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            err, out, (q, k, v, ref) = compare(name, shape, kw, dtype)
            errs.append(err)
            rel = _row_rel(out, ref)
            sm.check(rel <= tol, f"flash {name} {str(dtype)[6:]} worst row "
                     f"relative L2 {rel:.3e} (tol {tol:g})")
        # q, k, v and ref are the bf16 case's: a planted fault must fail the
        # row bound that the kernel passes
        faults = {}
        for fault, fkw in _planted_faults(kw, sk):
            fout = fa.flash_attention(q, k, v, **fkw)
            faults[fault] = {"row_rel": _row_rel(fout, ref),
                             "max_abs_err": (fout.float() - ref).abs().max()
                             .item()}
            sm.check(faults[fault]["row_rel"] > BF16_TOL,
                     f"flash {name} bf16 with the {fault}: worst row "
                     f"relative L2 {faults[fault]['row_rel']:.3e}, "
                     f"max_abs_err {faults[fault]['max_abs_err']:.3e} (must "
                     f"exceed the row bound {BF16_TOL:g})")
        del out, ref, fout
        # the same function as one PyTorch call (a yardstick only)
        kpos = torch.arange(sk, device="cuda")
        allowed = torch.ones(sq, sk, dtype=torch.bool, device="cuda")
        if kw.get("causal"):
            qpos = torch.arange(sq, device="cuda")
            allowed &= kpos[None, :] <= qpos[:, None] + (sk - sq)
        if "kv_len" in kw:
            allowed &= (kpos < kw["kv_len"])[None, :]
        if "kv_valid" in kw:
            allowed &= kw["kv_valid"][None, :]
        kernel = (lambda: fa.flash_attention(q, k, v, **kw))
        sdpa = (lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=allowed, enable_gqa=hkv != h))
        # device time from CUDA graph replays (no host time between calls),
        # the kernel's eager per-call time beside it
        ms = _graph_ms(kernel, [()])
        lib_ms = _graph_ms(sdpa, [()])
        eager_ms = _timeit(kernel)
        plain_ms = _timeit(lambda: fa.flash_attention_reference(q, k, v, **kw))
        # the work this mask needs: rows of pad queries (kv_valid) are
        # unspecified, so only valid query rows count
        rows = allowed & kw["kv_valid"][:, None] if "kv_valid" in kw \
            else allowed
        flops = 4 * b * h * d * int(rows.sum().item())
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        bound_ms, bound_by = _bound(nbytes, flops, BF16_FLOPS)
        times[name] = {"shape": f"{name} B={b} H={h} Hkv={hkv} Sq={sq} "
                                f"Sk={sk} D={d} bf16",
                       "max_abs_err": err, "row_rel": rel, "faults": faults,
                       "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "eager_ms": eager_ms,
                       "tflops": flops / ms / 1e9,
                       "bound_share": bound_ms / ms}
        sm.log(f"time flash {name} bf16 shape={shape}: kernel {ms:.4f} ms "
               f"(eager calls {eager_ms:.4f} ms), scaled_dot_product_attention"
               f" {lib_ms:.4f} ms, plain {plain_ms:.3f} ms (eager), bound "
               f"{bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.1f} GFLOP, "
               f"{nbytes / 1e6:.1f} MB); kernel {flops / ms / 1e9:.1f} "
               f"TFLOP/s, {100 * bound_ms / ms:.1f}% of the bound; CUDA "
               f"events over CUDA graph replays")
    return max(errs), times


# ------------------------------------------------------------- MSDA kernel

def _upn_levels(h, w, levels=5):
    """Level maps of a padded UPN input: strides 4..32, then stride-2
    convolutions (kernel 3, padding 1)."""
    out = [(h // 4 // 2**i, w // 4 // 2**i) for i in range(4)]
    while len(out) < levels:
        ph, pw = out[-1]
        out.append(((ph - 1) // 2 + 1, (pw - 1) // 2 + 1))
    return tuple(out)


def _msda_cost(value, shapes, loc):
    """(bytes, flops) the function needs on these inputs: every input read
    once, the output written once; ~10 FLOPs per channel for each sample
    with at least one corner on its map (4 corner weights, 4 products,
    the weighted sum)."""
    b, s, m, d = value.shape
    lq = loc.shape[1]
    nbytes = (value.numel() * value.element_size() + loc.numel() * 4
              + loc.numel() // 2 * 4 + b * lq * m * d * 4)
    return nbytes, 10 * d * _msda_samples(shapes, loc)


def _msda_samples(shapes, loc):
    """Samples with at least one corner of their 2x2 window on the map."""
    hw = torch.tensor(shapes, dtype=torch.float32, device=loc.device)
    x = loc[..., 0] * hw[None, None, None, :, None, 1] - 0.5
    y = loc[..., 1] * hw[None, None, None, :, None, 0] - 0.5
    inside = ((x > -1) & (x < hw[:, 1, None]) & (y > -1)
              & (y < hw[:, 0, None]))
    return int(inside.sum().item())


def _msda_inputs(gen, shapes, b, lq, m, d, npts, dtype, lo, hi):
    s = sum(h * w for h, w in shapes)
    nl = len(shapes)
    value = torch.randn(b, s, m, d, device="cuda", generator=gen).to(dtype)
    loc = lo + (hi - lo) * torch.rand(b, lq, m, nl, npts, 2, device="cuda",
                                      generator=gen)
    aw = torch.softmax(torch.randn(b, lq, m, nl * npts, device="cuda",
                                   generator=gen), -1)
    return value, loc, aw.reshape(b, lq, m, nl, npts).contiguous()


# worst relative L2 error of one MSDA row against the plain version: one
# (query, head) output row of D channels; in the backward one pixel's D
# channels of grad_value and one (query, head)'s L x P x 2 entries of
# grad_loc. The kernels and the plain versions sum the same bf16-exact
# values times float32 weights in float32, in another order (~1e-6 a row;
# grad_value rounded to bf16 when value is bf16, ~2^-9). An absolute bound
# would pass a kernel that skips one point of 20: a weight of ~0.05 on values
# of ~1 moves an output by ~0.05. Rows are divided by their norm, floored at
# 1e-3 x the mean row norm (rows with every sample off the map are 0).
MSDA_ROW_REL = 1e-4
MSDA_ROW_REL_BF16 = 1e-2


def _msda_row_rel(out, ref, width):
    diff = (out.float() - ref).reshape(-1, width).norm(dim=-1)
    norm = ref.reshape(-1, width).norm(dim=-1)
    return (diff / norm.clamp_min(1e-3 * norm.mean().item())
            .clamp_min(1e-30)).max().item()


def _msda_faults(value, shapes, loc, aw, level=1):
    """Inputs under which the plain version computes what a faulty kernel
    would, in one level: one point dropped (its weight 0), the level's
    start offset by one row (its rows read one later), x and y swapped.
    Each entry: (name, value, loc, aw, the first row of the level, its
    rows)."""
    start = sum(h * w for h, w in shapes[:level])
    n = shapes[level][0] * shapes[level][1]
    dropped = aw.clone()
    dropped[:, :, :, level, 0] = 0.0
    shifted = value.clone()
    shifted[:, start:start + n - 1] = value[:, start + 1:start + n]
    swapped = loc.clone()
    swapped[..., level, :, :] = loc[..., level, :, :].flip(-1)
    return [("one point dropped", value, loc, dropped, start, n),
            ("level start + 1 row", shifted, loc, aw, start, n),
            ("x and y swapped", value, swapped, aw, start, n)]


def _msda_compare(sm, msda, name, value, shapes, loc, aw, faults=False):
    out = msda.ms_deform_attn_core(value, shapes, loc, aw)
    torch.cuda.synchronize()
    ref = msda.ms_deform_attn_core_reference(value.float(), shapes, loc, aw)
    err = (out - ref).abs().max().item()
    tol = F32_TOL if value.dtype == torch.float32 else BF16_TOL
    d = value.shape[-1]
    rel = _msda_row_rel(out, ref, d)
    sm.check(bool(torch.isfinite(out).all()) and err <= tol
             and rel <= MSDA_ROW_REL,
             f"msda {name} {str(value.dtype)[6:]} value={tuple(value.shape)}"
             f" Lq={loc.shape[1]} max_abs_err={err:.3e} (tol {tol:g}), "
             f"worst row relative L2 {rel:.2e} (bound {MSDA_ROW_REL:g})")
    if faults:
        for what, v, lc, a, _, _ in _msda_faults(value.float(), shapes, loc,
                                                 aw):
            bad = msda.ms_deform_attn_core_reference(v, shapes, lc, a)
            fr = _msda_row_rel(bad, ref, d)
            sm.check(fr > MSDA_ROW_REL,
                     f"msda {name} planted fault ({what}, plain version): "
                     f"worst row relative L2 {fr:.3g} > {MSDA_ROW_REL:g}")
    return err


def _msda_time(sm, msda, name, value, shapes, loc, aw):
    ms = _timeit(lambda: msda.ms_deform_attn_core(value, shapes, loc, aw))
    plain_ms = _timeit(lambda: msda.ms_deform_attn_core_reference(
        value, shapes, loc, aw), n=3)
    nbytes, flops = _msda_cost(value, shapes, loc)
    bound_ms, bound_by = _bound(nbytes, flops, F32_FLOPS)
    sm.log(f"time msda {name} {str(value.dtype)[6:]} Lq={loc.shape[1]}: "
           f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
           f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB, "
           f"{flops / 1e9:.2f} GFLOP; CUDA events)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase_msda(sm, msda):
    gen = torch.Generator(device="cuda").manual_seed(1)
    small = ((6, 8), (3, 4), (2, 2))
    for dtype in (torch.float32, torch.bfloat16):
        for d in (8, 32):
            inp = _msda_inputs(gen, small, 2, 37, 2, d, 4, dtype, -0.3, 1.3)
            _msda_compare(sm, msda, f"small D={d}", inp[0], small, *inp[1:])
    shapes = _upn_levels(896, 1152)
    s = sum(h * w for h, w in shapes)
    errs = []
    for name, lq in (("encoder", s), ("decoder", 900)):
        for dtype in (torch.float32, torch.bfloat16):
            inp = _msda_inputs(gen, shapes, 1, lq, 8, 32, 4, dtype,
                               -0.05, 1.05)
            errs.append(_msda_compare(sm, msda, f"{name} synthetic",
                                      inp[0], shapes, *inp[1:],
                                      faults=dtype == torch.bfloat16))
        _msda_time(sm, msda, f"{name} synthetic (uniform locations)",
                   inp[0], shapes, *inp[1:])
    return max(errs)


# ----------------------------------------------------------------- tiny

def phase_tiny_fo1(sm, FO1Model, FO1Config, FallbackTokenizer, OD_template):
    # untied head: with random weights a tied head echoes the last prompt
    # token, and equal greedy tokens would prove nothing
    tiny = FO1Config.tiny()
    cfg = dataclasses.replace(tiny, text=dataclasses.replace(
        tiny.text, tie_word_embeddings=False))
    tok = FallbackTokenizer()
    cpu = FO1Model.random_init(cfg, seed=0, device="cpu", tokenizer=tok)
    gpu = FO1Model(cfg, device="cuda", tokenizer=tok)
    gpu.load_state_dict(cpu.state_dict())
    msgs = _messages(1, OD_template)
    r_cpu = cpu.generate(msgs, max_new_tokens=16, max_pixels=256 * 256)
    r_gpu = gpu.generate(msgs, max_new_tokens=16, max_pixels=256 * 256)
    logit_err = np.abs(r_cpu.prefill_logits - r_gpu.prefill_logits).max()
    sm.check(np.array_equal(r_cpu.token_ids, r_gpu.token_ids),
             f"tiny FO1 f32 greedy tokens card == cpu: "
             f"{r_gpu.token_ids.tolist()} vs {r_cpu.token_ids.tolist()}; "
             f"prefill logits max_abs_err={logit_err:.3e}")


def _tiny_upn_pair(upn_mod, msda):
    """Tiny UPN wrappers with the same f32 weights on the CPU and the card,
    and one padded 320x256 input."""
    from vlm_fo1_tpu_torch.upn.model import UPNConfig
    from vlm_fo1_tpu_torch.upn.swin import SwinConfig

    swin = SwinConfig(embed_dim=16, depths=(1, 1, 2, 1),
                      num_heads=(1, 2, 4, 8), window_size=4)
    cfg = UPNConfig(d_model=32, n_heads=4, n_points=2, num_encoder_layers=2,
                    num_decoder_layers=2, d_ffn=64, num_queries=20,
                    gn_groups=8, pos_feats=16)
    cpu = upn_mod.UPNWrapper.random_init(cfg, swin, seed=1, device="cpu")
    # sampling offsets that follow the queries, so the kernel's sampling
    # pattern depends on the data
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for mod in cpu.model.modules():
            if isinstance(mod, msda.MSDeformAttn):
                w = mod.sampling_offsets.weight
                w.copy_(torch.randn(w.shape, generator=gen) * 0.05)
    gpu = upn_mod.UPNWrapper.random_init(cfg, swin, device="cuda")
    gpu.model.load_state_dict(cpu.model.state_dict())
    padded, hw, _ = cpu.prepare(_synthetic_image(3).resize((320, 256)))
    return cpu, gpu, padded, hw


def phase_tiny_upn(sm, upn_mod, msda):
    cpu, gpu, padded, hw = _tiny_upn_pair(upn_mod, msda)
    outs = {}
    for name, w in (("cpu", cpu), ("card", gpu)):
        x, valid = w.model_input(padded[None], np.array([hw], np.int32))
        before = msda.ms_deform_attn_core.launches
        out = w.model(x, valid)
        outs[name] = {k: v.cpu() for k, v in out.items()}
        outs[name]["launches"] = msda.ms_deform_attn_core.launches - before
    c, g = outs["cpu"], outs["card"]
    box_err = (c["pred_boxes"] - g["pred_boxes"]).abs().max().item()
    logit_err = (c["pred_logits"] - g["pred_logits"]).abs().max().item()
    sm.check(torch.equal(c["topk_idx"], g["topk_idx"])
             and box_err <= F32_TOL and logit_err <= F32_TOL
             and g["launches"] == 4 and c["launches"] == 0,
             f"tiny UPN f32 card == cpu: top-k equal "
             f"{torch.equal(c['topk_idx'], g['topk_idx'])}, boxes "
             f"max_abs_err={box_err:.3e}, logits max_abs_err="
             f"{logit_err:.3e} (tol {F32_TOL:g}), msda launches card "
             f"{g['launches']} cpu {c['launches']}")


# ----------------------------------------------------------- full width

def phase_fo1(sm, FO1Model, FO1Config, FallbackTokenizer, OD_template, fa,
              extract):
    cfg = FO1Config()
    t0 = time.perf_counter()
    model = FO1Model.random_init(cfg, seed=0, dtype=torch.bfloat16,
                                 device="cuda",
                                 tokenizer=FallbackTokenizer())
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    sm.log(f"FO1 full width: {n_params / 1e9:.3f}B params bf16, random init "
           f"{time.perf_counter() - t0:.1f} s")
    msgs = [_messages(100 + i, OD_template) for i in range(3)]
    min_launches = len(cfg.vision.fullatt_block_indexes) + \
        cfg.text.num_hidden_layers

    fa.flash_attention.launches = 0
    per_request = []
    for i, m in enumerate(msgs):
        before = fa.flash_attention.launches
        stage = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = model.generate(m, max_new_tokens=32, stage_ms=stage)
        total_ms = (time.perf_counter() - t0) * 1e3
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        n = fa.flash_attention.launches - before
        per_request.append(n)
        decoded = res.num_steps - 1  # the first token comes from prefill
        tok_s = decoded / (stage["decode"] / 1e3) if decoded else 0.0
        boxes = extract(res.text, DEMO_BOXES)
        sm.log(f"FO1 request {i}: prompt {res.prompt_len} tokens, "
               f"prepare {stage['prepare']:.1f} ms, encode "
               f"{stage['encode']:.1f} ms, prefill {stage['prefill']:.1f} ms,"
               f" decode {stage['decode']:.1f} ms ({res.num_steps} tokens, "
               f"{tok_s:.1f} tok/s after the first), total {total_ms:.1f} ms,"
               f" peak memory {peak_gb:.2f} GiB, flash launches {n}, "
               f"parsed boxes {boxes}")
        sm.check(n >= min_launches and
                 bool(np.isfinite(res.prefill_logits).all()),
                 f"FO1 request {i}: flash launches {n} >= {min_launches} and "
                 f"finite prefill logits")
    launches = fa.flash_attention.launches

    prep = model.prepare(msgs[0])
    outs = {}
    for name, attn in (("kernel", fa.flash_attention),
                       ("plain", fa.flash_attention_reference)):
        model.attention = attn
        vis, reg = model.encode(prep)
        emb = model.splice(prep, vis, reg)
        _, logits = model.prefill(prep, emb, prep["splice"].seq_len + 1)
        outs[name] = (reg.float(), logits)
    model.attention = fa.flash_attention
    for i, what in enumerate(("region tokens", "prefill last-token logits")):
        got, ref = outs["kernel"][i], outs["plain"][i]
        err = (got - ref).abs().max().item()
        rel = ((got.float() - ref.float()).norm()
               / ref.float().norm()).item()
        bound = PATH_REL_TOL * max(1.0, ref.abs().max().item())
        sm.check(err <= bound, f"FO1 kernel path vs plain path, {what}: "
                 f"max_abs_err={err:.3e} (bound {bound:.3e} = "
                 f"{PATH_REL_TOL:g} x max(1, max|plain|)); relative L2 "
                 f"{rel:.3e}")
    return model, launches, per_request


def phase_upn(sm, upn_mod, msda):
    cfg_min = 2 * 6  # 6 encoder + 6 decoder layers
    t0 = time.perf_counter()
    upn = upn_mod.UPNWrapper.random_init(seed=0, dtype=torch.bfloat16,
                                         device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in upn.model.parameters())
    sm.log(f"UPN full width (Swin-L + UPNConfig()): {n_params / 1e6:.1f}M "
           f"params bf16, random init {time.perf_counter() - t0:.1f} s")
    images = [_synthetic_image(200 + i) for i in range(3)]
    msda.ms_deform_attn_core.launches = 0
    per_request = []
    for i, img in enumerate(images):
        before = msda.ms_deform_attn_core.launches
        stage = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        raw = upn.inference(img, stage_ms=stage)
        total_ms = (time.perf_counter() - t0) * 1e3
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        n = msda.ms_deform_attn_core.launches - before
        per_request.append(n)
        finite = bool(np.isfinite(raw["original_xyxy_boxes"]).all()
                      and np.isfinite(raw["scores"]).all())
        sm.log(f"UPN request {i}: transform {stage['transform']:.1f} ms, "
               f"backbone {stage['backbone']:.1f} ms, encoder "
               f"{stage['encoder']:.1f} ms, decoder {stage['decoder']:.1f} "
               f"ms + postprocess {stage['postprocess']:.1f} ms, total "
               f"{total_ms:.1f} ms, peak memory {peak_gb:.2f} GiB, msda "
               f"launches {n}, best score {raw['scores'][0, 0, 0]:.4f}")
        sm.check(n >= cfg_min and finite and raw["scores"].shape == (1, 900, 1),
                 f"UPN request {i}: msda launches {n} >= {cfg_min}, 900 "
                 f"finite boxes and scores")
    launches = msda.ms_deform_attn_core.launches

    padded, hw, _ = upn.prepare(images[0])
    x, valid = upn.model_input(padded[None], np.array([hw], np.int32))
    captured = {}

    def record(value, shapes, loc, aw):
        key = "encoder" if loc.shape[1] == value.shape[1] else "decoder"
        captured.setdefault(key, (value, shapes, loc, aw))
        return msda.ms_deform_attn_core(value, shapes, loc, aw)

    outs = {}
    for name, core in (("kernel", record),
                       ("plain", msda.ms_deform_attn_core_reference)):
        upn.model.use_msda_core(core)
        outs[name] = upn.model(x, valid)
    upn.model.use_msda_core(msda.ms_deform_attn_core)
    got, ref = outs["kernel"]["memory"].float(), outs["plain"]["memory"].float()
    err = (got - ref).abs().max().item()
    bound = PATH_REL_TOL * max(1.0, ref.abs().max().item())
    sm.check(err <= bound, f"UPN kernel path vs plain path, encoder output: "
             f"max_abs_err={err:.3e} (bound {bound:.3e} = {PATH_REL_TOL:g} x "
             f"max(1, max|plain|))")
    ik = set(outs["kernel"]["topk_idx"][0].tolist())
    ip = set(outs["plain"]["topk_idx"][0].tolist())
    sm.log(f"UPN kernel path vs plain path: top-900 index sets overlap "
           f"{len(ik & ip)}/900; boxes max_abs_diff "
           f"{(outs['kernel']['pred_boxes'] - outs['plain']['pred_boxes']).abs().max().item():.3e}")

    times, errs = {}, []
    for key in ("encoder", "decoder"):
        value, shapes, loc, aw = captured[key]
        errs.append(_msda_compare(sm, msda, f"{key} (request 0's inputs)",
                                  value, shapes, loc, aw, faults=True))
        times[key] = _msda_time(sm, msda, f"{key} (request 0's inputs)",
                                value, shapes, loc, aw)
    return upn, launches, per_request, times, max(errs), captured


def phase_upn_fo1(sm, upn, fo1, fa, msda, OD_template, extract):
    image = _synthetic_image(300)
    fa.flash_attention.launches = 0
    msda.ms_deform_attn_core.launches = 0
    upn_ms = {}
    t0 = time.perf_counter()
    raw = upn.inference(image, stage_ms=upn_ms)
    det = upn.filter(raw, min_score=0.0, nms_value=0.8)
    boxes = [[float(v) for v in b] for b in det["original_xyxy_boxes"][0]]
    boxes = boxes[:100]
    t_upn = (time.perf_counter() - t0) * 1e3
    stage = {}
    res = fo1.generate(_messages(0, OD_template, boxes, image),
                       max_new_tokens=32, stage_ms=stage)
    total_ms = (time.perf_counter() - t0) * 1e3
    launches = {"flash_attention": fa.flash_attention.launches,
                "ms_deform_attn_core": msda.ms_deform_attn_core.launches}
    parsed = extract(res.text, boxes)
    sm.log(f"UPN -> FO1: UPN + filter {t_upn:.1f} ms ({len(boxes)} of "
           f"{len(det['original_xyxy_boxes'][0])} proposals kept), FO1 "
           f"prompt {res.prompt_len} tokens, prepare {stage['prepare']:.1f}"
           f" ms, encode {stage['encode']:.1f} ms, prefill "
           f"{stage['prefill']:.1f} ms, decode {stage['decode']:.1f} ms "
           f"({res.num_steps} tokens), total {total_ms:.1f} ms; parsed "
           f"boxes {parsed}")
    sm.check(launches["flash_attention"] > 0
             and launches["ms_deform_attn_core"] >= 12 and len(boxes) > 0
             and bool(np.isfinite(res.prefill_logits).all()),
             f"UPN -> FO1 path: launches {launches}, {len(boxes)} boxes in "
             f"the request, finite prefill logits")
    return launches


# ------------------------------------------------------------ int4 kernels

INT4_F32_TOL = 2e-5
# worst relative L2 error of one output row segment (one row of one
# 128-column tile) against the plain version: bf16 rounds each output to
# 8 bits (~2e-3 a row segment), f32 sums in another order (~1e-6); a wrong
# tile moves its segments by several percent (PERF.md records the margins)
INT4_SEG_BF16 = 1e-2
INT4_SEG_F32 = 1e-4
SEG_COLS = 128
# the 3B trunk's int4 linears: q and o, k and v, gate and up, down
TRUNK_LINEARS = (("q_o", 2048, 2048), ("k_v", 2048, 256),
                 ("gate_up", 2048, 11008), ("down", 11008, 2048))
PREFILL_ROWS = 1771  # prompt tokens of a demo request with 7 boxes


def _rel_check(sm, what, got, ref, tol):
    """max |got - ref| against tol x max(1, max|ref|)."""
    err = (got.float() - ref.float()).abs().max().item()
    bound = tol * max(1.0, ref.float().abs().max().item())
    sm.check(bool(torch.isfinite(got).all()) and err <= bound,
             f"{what} max_abs_err={err:.3e} (bound {bound:.3e} = {tol:g} x "
             f"max(1, max|plain|))")
    return err


def _seg_rel(out, ref, cols=SEG_COLS):
    """Worst relative L2 error of one output row segment of `cols` columns
    (one row of one column tile). A dropped K tile moves every row; a wrong
    column tile moves only its own segments, which a norm over a whole row
    of 11008 columns would dilute below the rounding of the rest."""
    import torch.nn.functional as F

    m, n = ref.shape
    pad = (-n) % cols
    diff = F.pad(out.float() - ref.float(), (0, pad)).view(m, -1, cols)
    den = F.pad(ref.float(), (0, pad)).view(m, -1, cols).norm(dim=-1)
    num = diff.norm(dim=-1)
    keep = den > 0
    return (num[keep] / den[keep]).max().item()


def _at_offset(x, nbytes):
    """x copied into a fresh buffer `nbytes` past its start: a contiguous
    tensor whose data pointer is aligned only to that offset."""
    size = x.numel() * x.element_size()
    buf = torch.empty(size + 256, dtype=torch.uint8, device=x.device)
    y = buf[nbytes:nbytes + size].view(x.dtype).view(x.shape)
    y.copy_(x)
    return y


def _both_dtypes(sm, what, kernel, plain, x, repeat=False, routes=None,
                 offset=0):
    """The kernel on x in f32 (TF32 off) and bf16 against the plain version
    on the same values in f32: max |err| to tol x max(1, max|plain|) and the
    worst row segment to INT4_SEG_*; optionally two kernel runs bit-equal;
    optionally the route (routes = (counter dict, bf16 route)) and x placed
    at a byte offset. Returns (max abs err, {dtype: worst segment})."""
    errs, segs = [], {}
    for dtype, tol, seg_tol in ((torch.float32, INT4_F32_TOL, INT4_SEG_F32),
                                (torch.bfloat16, BF16_TOL, INT4_SEG_BF16)):
        name = str(dtype)[6:]
        xd = x.to(dtype)
        if offset:
            xd = _at_offset(xd, offset)
        before = dict(routes[0]) if routes else None
        got = kernel(xd)
        again = kernel(xd) if repeat else got
        torch.cuda.synchronize()
        ref = plain(xd.float())
        errs.append(_rel_check(sm, f"{what} {name}", got, ref, tol))
        seg = _seg_rel(got, ref)
        segs[name] = seg
        sm.check(seg <= seg_tol, f"{what} {name}: worst row segment relative "
                 f"L2 {seg:.3e} (bound {seg_tol:g})")
        if repeat:
            sm.check(torch.equal(got, again),
                     f"{what} {name}: two runs bit-equal")
        if routes:
            want = routes[1] if dtype == torch.bfloat16 else (
                "gemv" if x.shape[0] <= 8 else "fma")
            took = {r: routes[0][r] - before[r] for r in routes[0]
                    if routes[0][r] != before[r]}
            sm.check(set(took) == {want}, f"{what} {name}: route {took} "
                     f"(want {want})")
    return max(errs), segs


def _int4_faults(packed, scale, out_pack=False, tile_rows=64, tile_cols=128):
    """Weights under which the plain version returns what a kernel with a
    tiling fault would: one 64-packed-row K tile zeroed; the low and high
    nibbles swapped in one column tile (out_pack: 64 packed columns, so 128
    outputs); one column tile's scales shifted by one column. Tiles in the
    middle of the weight."""
    kt = packed.shape[0] // 2 // tile_rows * tile_rows
    zero = packed.clone()
    zero[kt:kt + tile_rows] = 0
    pc = tile_cols // 2 if out_pack else tile_cols
    ct = packed.shape[1] // 2 // pc * pc
    swap = packed.clone()
    seg = swap[:, ct:ct + pc]
    swap[:, ct:ct + pc] = (seg << 4) | ((seg >> 4) & 0xF)
    n = scale.shape[0]
    sc = n // 2 // tile_cols * tile_cols
    shift = scale.clone()
    shift[sc:sc + tile_cols] = torch.roll(scale, -1)[sc:sc + tile_cols]
    return [("K tile zeroed", zero, scale), ("nibbles swapped", swap, scale),
            ("scales shifted", packed, shift)]


def _fault_readings(sm, what, plain, ref, faults, bound):
    """Each planted fault's worst row segment against the true plain
    output `ref`; each must read above the bound."""
    out = {}
    for name, pk, sc in faults:
        out[name] = _seg_rel(plain(pk, sc), ref)
        sm.check(out[name] > bound, f"{what}: planted fault '{name}' reads "
                 f"{out[name]:.3e} > bound {bound:g}")
    return out


# (M, K, N, byte offset of x, route in bf16): M <= 8 streams (any shape;
# x at any offset, N off the 8-byte loads); the TMA tiles need every row
# stride a multiple of 16 bytes (K % 16, N % 16) and 16-byte aligned
# pointers; other shapes take the mma.sync tiles
INT4_CASES = ((1, 32, 24, 0, "gemv"), (5, 64, 130, 0, "gemv"),
              (9, 3420, 200, 0, "mma"), (128, 96, 4100, 0, "mma"),
              (5, 2048, 300, 0, "gemv"), (77, 256, 130, 0, "mma"),
              (9, 2048, 256, 0, "tma"), (63, 2112, 256, 0, "tma"),
              (64, 11008, 2048, 0, "tma"), (65, 2048, 11008, 0, "tma"),
              (127, 2112, 4100, 0, "mma"), (129, 2048, 130, 0, "mma"),
              (65, 2048, 256, 16 * 3, "tma"), (65, 2048, 256, 8, "mma"),
              (2, 64, 24, 0, "gemv"), (3, 2048, 130, 8, "gemv"),
              (4, 96, 4100, 16 * 3, "gemv"), (6, 3420, 130, 4, "gemv"),
              (7, 2048, 24, 0, "gemv"), (8, 11008, 2048, 8, "gemv"))
# the rows of the streaming route's timings: decode at B = 1, 2, 4, 8
DECODE_ROWS = (1, 2, 4, 8)


def phase_int4_matmul(sm, quant, i4):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(4)

    def weight(n, k):
        return quant.quantize_weight_int4(
            torch.randn(n, k, device="cuda", generator=gen) * 0.02)

    errs = []
    for m, k, n, off, route in INT4_CASES:
        packed, scale = weight(n, k)
        x = torch.randn(m, k, device="cuda", generator=gen)
        errs.append(_both_dtypes(
            sm, f"int4_matmul M={m} K={k} N={n}"
            + (f" x at +{off} B" if off else ""),
            lambda xd: i4.int4_matmul(xd, packed, scale),
            lambda xf: i4.int4_matmul_reference(xf, packed, scale), x,
            repeat=True, routes=(i4.int4_matmul.routes, route),
            offset=off)[0])
    times = {}
    for name, k, n in TRUNK_LINEARS:
        packed, scale = weight(n, k)
        w_deq = (quant.unpack_int4(packed).float() * scale).t() \
            .to(torch.bfloat16).contiguous()                     # [n, k]
        for m in DECODE_ROWS + (PREFILL_ROWS,):
            x = torch.randn(m, k, device="cuda", generator=gen)
            err, segs = _both_dtypes(
                sm, f"int4_matmul {name} M={m} K={k} N={n}",
                lambda xd: i4.int4_matmul(xd, packed, scale),
                lambda xf: i4.int4_matmul_reference(xf, packed, scale), x,
                repeat=True, routes=(i4.int4_matmul.routes,
                                     "gemv" if m <= 8 else "tma"))
            errs.append(err)
            xf = x.float()
            faults = _fault_readings(
                sm, f"int4_matmul {name} M={m}",
                lambda pk, sc: i4.int4_matmul_reference(xf, pk, sc),
                i4.int4_matmul_reference(xf, packed, scale),
                _int4_faults(packed, scale), INT4_SEG_BF16)
            xb = x.to(torch.bfloat16)
            cold = m <= 8
            wq = _copies(packed.numel(), lambda: (packed.clone(),
                                                  scale.clone())) \
                if cold else [(packed, scale)]
            wl = _copies(w_deq.numel() * 2, lambda: (w_deq.clone(),)) \
                if cold else [(w_deq,)]
            kernel = (lambda p, sc: i4.int4_matmul(xb, p, sc))
            ms = _graph_ms(kernel, wq)
            eager_ms = _timeit_rotating(kernel, wq)
            plain_ms = _graph_ms(
                lambda p, sc: i4.int4_matmul_reference(xb, p, sc), wq)
            lib_ms = _graph_ms(lambda w: F.linear(xb, w), wl)
            nbytes = packed.numel() + 4 * n + 2 * m * k + 2 * m * n
            bound_ms, bound_by = _bound(nbytes, 2 * m * k * n, BF16_FLOPS)
            times[f"{name} M={m}"] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "eager_ms": eager_ms, "seg_rel": segs, "faults": faults}
            sm.log(f"time int4_matmul {name} {k}->{n} M={m} bf16: kernel "
                   f"{ms:.4f} ms (eager calls {eager_ms:.4f} ms), plain "
                   f"{plain_ms:.4f} ms, F.linear on the dequantized bf16 "
                   f"weight {lib_ms:.4f} ms, bound {bound_ms:.4f} ms by "
                   f"{bound_by} ({nbytes / 1e6:.2f} MB, "
                   f"{2 * m * k * n / 1e9:.2f} GFLOP; CUDA events over CUDA "
                   f"graph replays{', weights cold' if cold else ''}); "
                   f"worst row segment {segs}, planted faults {faults}")
            del wq, wl
    return max(errs), times


def _mlp_node(quant, gen, d, i):
    def w(*shape):
        return torch.randn(*shape, device="cuda", generator=gen) * 0.02
    gate_pk, gate_s = quant.quantize_weight_int4(w(i, d))
    up_pk, up_s = quant.quantize_weight_int4(w(i, d))
    down_pk, down_s = quant.quantize_weight_int4_outpack(w(d, i))
    return {"gate_pk": gate_pk, "gate_s": gate_s, "up_pk": up_pk,
            "up_s": up_s, "down_pk": down_pk, "down_s": down_s}


# (M, D, I, byte offset of x, route in bf16): both products take it (the
# tiles: the first needs D % 16 and I % 16, the second I % 8 and
# (D/2) % 16; streaming: any shape)
INT4_MLP_CASES = ((1, 64, 256, 0, "gemv"), (5, 256, 768, 0, "gemv"),
                  (16, 128, 128, 0, "tma"), (200, 128, 256, 0, "tma"),
                  (300, 64, 128, 0, "tma"), (8, 48, 128, 0, "gemv"),
                  (9, 2048, 1024, 0, "tma"), (63, 2048, 1024, 0, "tma"),
                  (64, 2048, 1024, 0, "tma"), (65, 2048, 1024, 16 * 3, "tma"),
                  (127, 2048, 1024, 0, "tma"), (129, 2048, 1024, 0, "tma"),
                  (33, 2112, 1024, 0, "tma"), (33, 40, 128, 0, "mma"),
                  (2, 2048, 1024, 8, "gemv"), (3, 64, 130, 0, "gemv"),
                  (4, 256, 768, 16 * 3, "gemv"), (6, 48, 24, 4, "gemv"),
                  (7, 2112, 1024, 0, "gemv"), (8, 2048, 1024, 4, "gemv"))


def phase_int4_mlp(sm, quant, i4mlp):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(5)
    errs, times = [], {}
    for m, d, i, off, route in INT4_MLP_CASES:
        node = _mlp_node(quant, gen, d, i)
        x = torch.randn(m, d, device="cuda", generator=gen)
        errs.append(_both_dtypes(
            sm, f"int4_mlp M={m} D={d} I={i}"
            + (f" x at +{off} B" if off else ""),
            lambda xd: i4mlp.int4_mlp(xd, node),
            lambda xf: i4mlp.int4_mlp_reference(xf, node), x, repeat=True,
            routes=(i4mlp.int4_mlp.routes, route), offset=off)[0])
    d, i = 2048, 11008
    node = _mlp_node(quant, gen, d, i)
    lo, hi = quant.unpack_int4_halves(node["down_pk"])
    lib_w = [(quant.unpack_int4(node[k]).float() * node[s]).t()
             .to(torch.bfloat16).contiguous()
             for k, s in (("gate_pk", "gate_s"), ("up_pk", "up_s"))]
    lib_w.append((torch.cat([lo, hi], -1).float() * node["down_s"]).t()
                 .to(torch.bfloat16).contiguous())               # [D, I]
    node_bytes = sum(t.numel() * t.element_size() for t in node.values())
    for m in DECODE_ROWS + (PREFILL_ROWS,):
        x = torch.randn(m, d, device="cuda", generator=gen)
        err, segs = _both_dtypes(
            sm, f"int4_mlp D={d} I={i} M={m}",
            lambda xd: i4mlp.int4_mlp(xd, node),
            lambda xf: i4mlp.int4_mlp_reference(xf, node), x, repeat=True,
            routes=(i4mlp.int4_mlp.routes, "gemv" if m <= 8 else "tma"))
        errs.append(err)
        xf = x.float()
        faults = _fault_readings(
            sm, f"int4_mlp D={d} I={i} M={m} (faults in down)",
            lambda pk, sc: i4mlp.int4_mlp_reference(
                xf, dict(node, down_pk=pk, down_s=sc)),
            i4mlp.int4_mlp_reference(xf, node),
            _int4_faults(node["down_pk"], node["down_s"], out_pack=True),
            INT4_SEG_BF16)
        xb = x.to(torch.bfloat16)
        cold = m <= 8
        nodes = _copies(node_bytes, lambda: ({k: v.clone() for k, v in
                                              node.items()},)) \
            if cold else [(node,)]
        kernel = (lambda nd: i4mlp.int4_mlp(xb, nd))
        ms = _graph_ms(kernel, nodes)
        eager_ms = _timeit_rotating(kernel, nodes)
        plain_ms = _graph_ms(
            lambda nd: i4mlp.int4_mlp_reference(xb, nd), nodes)
        lib_ms = _graph_ms(lambda g, u, dn: F.linear(
            F.silu(F.linear(xb, g)) * F.linear(xb, u), dn), [lib_w])
        nbytes = node_bytes + 2 * m * d * 2
        flops = 6 * m * d * i
        bound_ms, bound_by = _bound(nbytes, flops, BF16_FLOPS)
        times[f"M={m}"] = {"ms": ms, "plain_ms": plain_ms,
                           "library_ms": lib_ms, "bound_ms": bound_ms,
                           "bound_by": bound_by, "eager_ms": eager_ms,
                           "seg_rel": segs, "faults": faults}
        sm.log(f"time int4_mlp D={d} I={i} M={m} bf16: kernel {ms:.4f} ms "
               f"(eager calls {eager_ms:.4f} ms), plain {plain_ms:.4f} ms, "
               f"three F.linear + silu on the dequantized bf16 weights "
               f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
               f"({nbytes / 1e6:.2f} MB, {flops / 1e9:.1f} GFLOP; CUDA "
               f"events over CUDA graph replays"
               f"{', weights cold' if cold else ''}); worst row segment "
               f"{segs}, planted faults {faults}")
        del nodes
    return max(errs), times


def phase_tiny_quant(sm, FO1Model, FO1Config, FallbackTokenizer, OD_template,
                     quant, i4, i4mlp):
    """Tiny FO1 f32, untied head: int4 (I = 96) and int4-mlp (I = 128, the
    fused kernel's I % 128 rule), quantized on each device from the same
    full-precision weights, card (kernels) vs CPU (plain versions)."""
    tiny = FO1Config.tiny()
    tok = FallbackTokenizer()
    for mode, inter in (("int4", tiny.text.intermediate_size),
                        ("int4-mlp", 128)):
        cfg = dataclasses.replace(tiny, text=dataclasses.replace(
            tiny.text, tie_word_embeddings=False, intermediate_size=inter))
        cpu = FO1Model.random_init(cfg, seed=0, device="cpu", tokenizer=tok)
        gpu = FO1Model(cfg, device="cuda", tokenizer=tok)
        gpu.load_state_dict(cpu.state_dict())
        quant.quantize_model(cpu, mode)
        quant.quantize_model(gpu, mode)
        sd_c, sd_g = cpu.state_dict(), gpu.state_dict()
        same = sd_c.keys() == sd_g.keys() and all(
            torch.equal(v, sd_g[k].cpu()) for k, v in sd_c.items())
        msgs = _messages(1, OD_template)
        counts = {}
        res = {}
        for name, model in (("cpu", cpu), ("card", gpu)):
            before = (i4.int4_matmul.launches, i4mlp.int4_mlp.launches)
            res[name] = model.generate(msgs, max_new_tokens=16,
                                       max_pixels=256 * 256)
            counts[name] = (i4.int4_matmul.launches - before[0],
                            i4mlp.int4_mlp.launches - before[1])
        kernel = 0 if mode == "int4" else 1
        logit_err = np.abs(res["cpu"].prefill_logits
                           - res["card"].prefill_logits).max()
        sm.check(same and np.array_equal(res["cpu"].token_ids,
                                         res["card"].token_ids)
                 and counts["card"][kernel] > 0 and counts["cpu"] == (0, 0),
                 f"tiny FO1 f32 {mode} (I={inter}): quantized bytes equal on "
                 f"both devices {same}; greedy tokens card == cpu: "
                 f"{res['card'].token_ids.tolist()} vs "
                 f"{res['cpu'].token_ids.tolist()}; prefill logits "
                 f"max_abs_err={logit_err:.3e}; (int4_matmul, int4_mlp) "
                 f"launches card {counts['card']} cpu {counts['cpu']}")


def phase_quant_fo1(sm, FO1Model, FO1Config, FallbackTokenizer, OD_template,
                    quant, fa, i4, i4mlp, extract, mode, n_requests):
    """FO1Config() bf16 in one serving mode on fresh random weights. Each
    request's int4 launches must be the trunk's int4 modules once per
    forward: its prefill and every decode step the device ran (a capture's
    eager warm-up and the steps of a graph's last replay after the end
    included; the capture itself launches nothing)."""
    from vlm_fo1_tpu_torch.models.llm import Int4MLP
    from vlm_fo1_tpu_torch.nn import QLinear4
    from vlm_fo1_tpu_torch.runtime.generate import DecodeProgram

    cfg = FO1Config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = FO1Model.random_init(cfg, seed=0, dtype=torch.bfloat16,
                                 device="cuda",
                                 tokenizer=FallbackTokenizer())
    full_gb = quant.quantized_bytes(model) / 1e9
    t1 = time.perf_counter()
    quant.quantize_model(model, mode)
    torch.cuda.synchronize()
    q_gb = quant.quantized_bytes(model) / 1e9
    sm.log(f"FO1 {mode}: parameters and buffers {full_gb:.3f} GB bf16 -> "
           f"{q_gb:.3f} GB quantized (random init {t1 - t0:.1f} s, quantize"
           f" {time.perf_counter() - t1:.1f} s, peak so far "
           f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
    msgs = [_messages(100 + i, OD_template) for i in range(n_requests)]
    per_forward = tuple(sum(isinstance(m, t) for m in model.text.modules())
                        for t in (QLinear4, Int4MLP))
    i4.int4_matmul.launches = 0
    i4mlp.int4_mlp.launches = 0
    per_request = []
    for i, m in enumerate(msgs):
        before = (i4.int4_matmul.launches, i4mlp.int4_mlp.launches)
        routes0 = (dict(i4.int4_matmul.routes), dict(i4mlp.int4_mlp.routes))
        steps0 = DecodeProgram.steps_run
        stage = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = model.generate(m, max_new_tokens=32, stage_ms=stage)
        total_ms = (time.perf_counter() - t0) * 1e3
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        n = (i4.int4_matmul.launches - before[0],
             i4mlp.int4_mlp.launches - before[1])
        forwards = 1 + DecodeProgram.steps_run - steps0
        routes = [{r: c[r] - c0[r] for r in c if c[r] != c0[r]} for c, c0 in
                  zip((i4.int4_matmul.routes, i4mlp.int4_mlp.routes), routes0)]
        per_request.append({"int4_matmul": n[0], "int4_mlp": n[1],
                            "forwards": forwards,
                            "num_steps": res.num_steps,
                            "routes_int4_matmul": routes[0],
                            "routes_int4_mlp": routes[1]})
        sm.log(f"FO1 {mode} request {i}: prompt {res.prompt_len} tokens, "
               f"prepare {stage['prepare']:.1f} ms, encode "
               f"{stage['encode']:.1f} ms, prefill {stage['prefill']:.1f} ms,"
               f" decode {stage['decode']:.1f} ms ({res.num_steps} tokens), "
               f"total {total_ms:.1f} ms, peak memory {peak_gb:.2f} GiB, "
               f"{forwards} trunk forwards on the device, launches "
               f"int4_matmul {n[0]} ({n[0] / forwards:.2f} per forward), "
               f"int4_mlp {n[1]} ({n[1] / forwards:.2f} per forward), "
               f"routes {routes}, parsed boxes "
               f"{extract(res.text, DEMO_BOXES)}")
        # the prompt's prefill (M = prompt length) takes the TMA tiles, the
        # decode steps (M = 1) the streaming path, nothing the mma.sync tiles
        tiled = {"int4": routes[0], "int4-mlp": routes[1]}.get(mode)
        if tiled is not None:
            sm.check(tiled.get("tma", 0) > 0 and "mma" not in tiled
                     and "fma" not in tiled,
                     f"FO1 {mode} request {i}: prefill on the TMA tiles, "
                     f"routes {tiled}")
        want = tuple(c * forwards for c in per_forward)
        sm.check(n == want and bool(np.isfinite(res.prefill_logits).all()),
                 f"FO1 {mode} request {i}: finite prefill logits, kernel "
                 f"launches {n} == (int4 linears, int4 MLPs) {per_forward} "
                 f"x {forwards} forwards {want}")
    launches = {"int4_matmul": i4.int4_matmul.launches,
                "int4_mlp": i4mlp.int4_mlp.launches}

    if mode in ("int4", "int4-mlp"):
        prep = model.prepare(msgs[0])
        outs = {}
        for name, kernels in (("kernel", True), ("plain", False)):
            model.attention = (fa.flash_attention if kernels
                               else fa.flash_attention_reference)
            quant.use_int4_kernels(model, kernels)
            vis, reg = model.encode(prep)
            emb = model.splice(prep, vis, reg)
            _, logits = model.prefill(prep, emb, prep["splice"].seq_len + 1)
            outs[name] = (reg.float(), logits)
        model.attention = fa.flash_attention
        quant.use_int4_kernels(model, True)
        for j, what in enumerate(("region tokens",
                                  "prefill last-token logits")):
            got, ref = outs["kernel"][j], outs["plain"][j]
            err = (got - ref).abs().max().item()
            bound = PATH_REL_TOL * max(1.0, ref.abs().max().item())
            sm.check(err <= bound, f"FO1 {mode} kernel path vs plain path, "
                     f"{what}: max_abs_err={err:.3e} (bound {bound:.3e} = "
                     f"{PATH_REL_TOL:g} x max(1, max|plain|))")
    del model
    torch.cuda.empty_cache()
    return launches, per_request


# ------------------------------------------------ int4 unpack benchmark

# worst relative L2 error of one output row of the microbenchmarks' products
# against their plain versions: the same exact bf16 products, f32 sums in
# another order (the tensor cores add a k-step's 16 products with fewer
# guard bits than a chain of f32 multiply-adds; a row reads ~1e-7 - 1e-6);
# one byte's nibbles swapped in the unpack product, or a wrong slot block,
# k-step or row tile of the chained products, moves a row far above it
UNPACK_ROW_REL = 1e-4


def _device_kernels(fn):
    """Names of the device kernels one call of fn launches, from
    torch.profiler's CUDA activity (None when it recorded none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "memcpy" not in e.name.lower()
             and "memset" not in e.name.lower()]
    return names or None


def _one_kernel(sm, what, fn, kernel, counter):
    """One call of fn is one device kernel named `kernel`, counted once by
    its wrapper's counter (a zero-argument function)."""
    before = counter()
    names = _device_kernels(fn)
    counted = counter() - before
    if names is None:
        sm.check(counted == 2, f"{what}: the profiler recorded no device "
                 f"activity; the wrapper counted {counted} for 2 calls")
        return None
    sm.check(len(names) == 1 and kernel in names[0] and counted == 2,
             f"{what}: {len(names)} device kernel(s) a call "
             f"{sorted(set(n.split('<')[0][-40:] for n in names))}, the "
             f"wrapper counted {counted} for 2 calls (want one {kernel})")
    return len(names)


def _unpack_faults(g, u, ti):
    """Inputs under which the plain version returns what a faulty kernel
    would: the nibbles of one byte of gate swapped, and the up columns of
    one tile shifted by one column."""
    swap = g.clone()
    b = swap[5, 3 * ti + 7].to(torch.int32) & 0xFF
    swap[5, 3 * ti + 7] = (((b & 0xF) << 4) | (b >> 4)).to(torch.uint8).view(
        torch.int8)
    shift = u.clone()
    shift[:, 2 * ti:3 * ti] = torch.roll(u[:, 2 * ti:3 * ti], 1, dims=1)
    return [("one byte's nibbles swapped", swap, u),
            ("a tile's up columns shifted", g, shift)]


def phase_int4_unpack(sm, iu):
    """18. the fused gate/up product of tools/xp_int4_unpack.py at its
    geometry (x [8, 2048] bf16, gate and up packed [1024, 11008], tiles of
    256, seeded): for each strategy the kernel against its plain version
    (worst row relative L2 <= UNPACK_ROW_REL), o's columns past 256 zero,
    bit-equal on repeat; two planted faults through the plain version that
    must read above the bound; one device kernel a call (profiler and
    wrapper); then each strategy and the copy ring alone timed as CUDA graph
    replays over copies of the weights larger than the L2 cache, GB/s of the
    packed bytes against 3.35 TB/s, beside the plain version and two
    torch.matmul on the dequantised bf16 weights with g * u and the tile
    sum."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    ti = iu.TI
    x = torch.randn(iu.M, iu.D, generator=gen, device="cuda").to(
        torch.bfloat16)
    g, u = (torch.randint(-128, 128, (iu.D // 2, iu.I), dtype=torch.int8,
                          device="cuda", generator=gen) for _ in range(2))
    worst, max_err, outs = 0.0, 0.0, {}
    for s in iu.STRATEGIES:
        got = iu.unpack_bench(x, g, u, s)
        again = iu.unpack_bench(x, g, u, s)
        ref = iu.unpack_bench_reference(x, g, u, s)
        torch.cuda.synchronize()
        rel = _row_rel(got[:, :ti], ref[:, :ti])
        zero, same = not got[:, ti:].any(), torch.equal(got, again)
        worst = max(worst, rel)
        if s == "magic":
            max_err = (got - ref).abs().max().item()
        outs[s] = got
        sm.check(rel <= UNPACK_ROW_REL and zero and same,
                 f"int4 unpack {s}: o worst row relative L2 {rel:.2e} (bound "
                 f"{UNPACK_ROW_REL:g}), columns past {ti} zero {zero}, "
                 f"bit-equal on repeat {same}")
    sm.check(all(torch.equal(outs[s], outs["divide"])
                 for s in ("shift", "cvt", "magic")),
             "int4 unpack: shift, cvt and magic equal divide bit for bit "
             "(the same decoded values)")
    faults = {}
    for name, fg, fu in _unpack_faults(g, u, ti):
        rel = _row_rel(outs["magic"][:, :ti],
                       iu.unpack_bench_reference(x, fg, fu, "magic")[:, :ti])
        faults[name] = rel
        sm.check(rel > UNPACK_ROW_REL, f"int4 unpack planted fault ({name}) "
                 f"reads {rel:.2e} through the plain version, above the "
                 f"bound")
    grid = iu.grid_for(iu.D, iu.I, torch.cuda.get_device_properties(
        0).multi_processor_count)
    kernels = _one_kernel(sm, "int4 unpack magic",
                          lambda: iu.unpack_bench(x, g, u, "magic"),
                          "unpack_kernel", lambda: iu.unpack_bench.launches)
    nbytes = 2 * g.numel()
    copies = _copies(nbytes, lambda: (g.clone(), u.clone()))
    iu.unpack_bench.launches = 0
    strategies = {}
    for s in iu.STRATEGIES:
        ms = _graph_ms(lambda a, b: iu.unpack_bench(x, a, b, s), copies)
        rate, share = _hbm(nbytes, ms)
        strategies[s] = {"ms": ms, "gb_per_s": rate, "hbm_share": share}
    launches = iu.unpack_bench.launches
    ring_ms = _graph_ms(lambda a, b: iu.copy_ring(x, a, b), copies)
    ring_rate, ring_share = _hbm(nbytes, ring_ms)
    plain_ms = _timeit(lambda: iu.unpack_bench_reference(x, g, u, "magic"),
                       n=2)
    del copies

    def dequantised(w):
        lo, hi = iu.decode_magic(w)
        return torch.cat([lo, hi], 0)

    wg, wu = dequantised(g), dequantised(u)
    lib_copies = _copies(2 * wg.numel() * 2, lambda: (wg.clone(), wu.clone()))

    def library(a, b):
        gu = torch.matmul(x, a).float() * torch.matmul(x, b).float()
        return gu.view(iu.M, -1, ti).sum(1)

    library_ms = _graph_ms(library, lib_copies)
    del lib_copies, wg, wu
    torch.cuda.empty_cache()
    out_bytes = iu.M * iu.D * 4 + x.numel() * 2
    bound_ms, bound_by = _bound(nbytes + out_bytes, 4 * iu.M * iu.D * iu.I,
                                BF16_FLOPS)
    sm.log(f"time int4 unpack (x [{iu.M}, {iu.D}], gate and up "
           f"[{iu.D // 2}, {iu.I}] packed, {nbytes / 1e6:.1f} MB, {grid} "
           f"blocks, CUDA graph replays, copies past the L2 cache): " + ", ".join(
               f"{s} {v['ms']:.4f} ms {v['gb_per_s']:.0f} GB/s"
               for s, v in strategies.items())
           + f"; copy ring alone {ring_ms:.4f} ms {ring_rate:.0f} GB/s "
           f"({100 * ring_share:.0f}%); plain magic {plain_ms:.4f} ms "
           f"(eager); two torch.matmul on dequantised bf16 weights + g * u "
           f"+ tile sum {library_ms:.4f} ms; bound {bound_ms:.4f} ms by "
           f"{bound_by}; {launches} launches")
    return {"launches": launches, "max_abs_err": max_err, "row_rel": worst,
            "ms": strategies["magic"]["ms"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library": "two torch.matmul on dequantised bf16 weights, "
                       "g * u and the tile sum",
            "faults": faults, "kernels_per_call": kernels, "grid": grid,
            "copy_ring_ms": ring_ms,
            "copy_ring_gb_per_s": ring_rate, "strategies": strategies}


# ------------------------------------------------ MSDA microbenchmarks

def _hbm(nbytes, ms):
    """(GB/s, share of the device memory rate) of nbytes in ms."""
    rate = nbytes / ms / 1e6
    return rate, rate / (HBM_BYTES_PER_S / 1e9)


def phase_msda_dma(sm, md):
    """19. the MSDA streaming microbenchmark at tools/xp_msda_dma.py's
    geometry (8 heads x 299 query blocks of 256, val4 band [26624, 128]
    bf16): every case's out block of zeros and 32-bit checksum equal the
    plain version's exactly, then each case timed as CUDA graph replays
    (its arrays, 0.2-0.4 GB, stream past the L2 cache), ms a pass and for
    its passes, GB/s against 3.35 TB/s."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    inputs = md.make_inputs(gen, device="cuda")
    for name, flags, out_w, passes, kb in md.CASES:
        out, ck = md.dma_bench(inputs, flags, out_w, passes, kb)
        ref_out, ref_ck = md.dma_bench_reference(inputs, flags, out_w, passes)
        torch.cuda.synchronize()
        sm.check(torch.equal(out, ref_out) and ck.item() == ref_ck.item(),
                 f"msda dma {name}: zeros equal {torch.equal(out, ref_out)},"
                 f" checksum kernel {ck.item() & 0xFFFFFFFF:#010x} == plain "
                 f"{ref_ck.item() & 0xFFFFFFFF:#010x}")
    md.dma_bench.launches = 0
    cases = {}
    for name, flags, out_w, passes, kb in md.CASES:
        ms = _graph_ms(lambda: md.dma_bench(inputs, flags, out_w, passes, kb),
                       [()])
        nbytes = md.case_bytes(inputs, flags, out_w)
        rate, share = _hbm(nbytes, ms / passes)
        cases[name] = {"ms": ms, "ms_pass": ms / passes, "mb_pass":
                       nbytes / 1e6, "gb_per_s": rate, "hbm_share": share}
    launches = md.dma_bench.launches
    prod = md.CASES[5]
    plain_ms = _timeit(lambda: md.dma_bench_reference(inputs, *prod[1:4]),
                       n=3)
    nbytes = md.case_bytes(inputs, prod[1], prod[2]) * prod[3]
    bound_ms, bound_by = _bound(nbytes, 0, BF16_FLOPS)
    sm.log("time msda dma (CUDA graph replays): " + "; ".join(
        f"{n} {v['ms_pass']:.4f} ms/pass ({v['mb_pass']:.1f} MB) "
        f"{v['gb_per_s']:.0f} GB/s ({100 * v['hbm_share']:.0f}%)"
        for n, v in cases.items())
        + f"; production case {cases[prod[0]]['ms']:.4f} ms for {prod[3]} "
        f"passes, bound {bound_ms:.4f} ms by {bound_by}, plain "
        f"{plain_ms:.3f} ms; {launches} launches")
    return {"launches": launches, "max_abs_err": 0.0,
            "shape": f"{prod[0]}, {prod[3]} passes",
            "ms": cases[prod[0]]["ms"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "cases": cases}


def phase_msda_micro(sm, mm):
    """20. the MSDA gather microbenchmark at tools/xp_msda_micro.py's
    geometry (8 heads x 76,800 queries x 4 slots, val4 [16384, 128] bf16):
    for each query block (256, 512, 1024) and index layout (query-major,
    slot-major) the kernel's output equals the plain version's bit for bit
    (both sum the same exact products in slot order in float32), then each
    is timed as CUDA graph replays: ms, us a block (total over blocks), ns a
    gathered sample."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    variants = [(qb, t) for qb in mm.BLOCKS for t in (False, True)]
    inputs = {}
    for qb, t in variants:
        inputs[qb, t] = mm.make_inputs(qb, t, gen, device="cuda")
        got = mm.gather_bench(*inputs[qb, t], qb, t)
        ref = mm.gather_reference(*inputs[qb, t], qb, t)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        sm.check(torch.equal(got, ref),
                 f"msda micro qb={qb} {'slot' if t else 'query'}-major: "
                 f"bit-equal to the plain version (max_abs_err={err:.1e})")
        del got, ref
    samples = mm.HEADS * mm.LQP * mm.S
    mm.gather_bench.launches = 0
    cases = {}
    for qb, t in variants:
        args = inputs[qb, t]
        colmap = mm.column_map(args[4])
        ms = _graph_ms(lambda: mm.gather_bench(*args, qb, t, colmap), [()])
        blocks = mm.HEADS * mm.LQP // qb
        cases[f"qb{qb}{'-t' if t else ''}"] = {
            "ms": ms, "us_per_block": ms * 1e3 / blocks,
            "ns_per_sample": ms * 1e6 / samples}
    launches = mm.gather_bench.launches
    args = inputs[512, True]
    plain_ms = _timeit(lambda: mm.gather_reference(*args, 512, True), n=3)
    val4, code, delta, w4, _ = args
    nbytes = sum(x.numel() * x.element_size() for x in (val4, code, w4)) \
        + mm.HEADS * mm.LQP * (mm.S * 4 + mm.D4 * 4)
    bound_ms, bound_by = _bound(nbytes, 2 * samples * mm.D4, F32_FLOPS)
    sm.log("time msda micro (CUDA graph replays): " + "; ".join(
        f"{n} {v['ms']:.4f} ms, {v['us_per_block']:.3f} us/block, "
        f"{v['ns_per_sample']:.4f} ns/sample" for n, v in cases.items())
        + f"; bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB);"
        f" plain qb512-t {plain_ms:.3f} ms; {launches} launches")
    del inputs
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": 0.0,
            "shape": "qb512-t (512 queries a block, slot-major)",
            "ms": cases["qb512-t"]["ms"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "cases": cases}


# worst relative L2 error of one output row of the chained products against
# the plain version (UNPACK_ROW_REL's reasoning: a row of 128 columns over
# 128-512 products reads ~1e-6)
FLOOR_ROW_REL = UNPACK_ROW_REL
# the time of 600 steps over 300 on rows64: each step computed
FLOOR_STEP_RATIO = (1.8, 2.2)


def _floor_faults(mf, lhs, rhs):
    """The chain variant's tile as a faulty kernel would compute it: one
    slot's product skipped, and one k-step (16 contraction slots) of one
    slot skipped."""
    lf, rf = lhs.float()[:, :128], rhs.float()
    slot = sum(lf @ rf[s * 128:(s + 1) * 128] for s in range(mf.SLOTS)
               if s != 2)
    cut = lf.clone()
    cut[:, 48:64] = 0
    kstep = sum((cut if s == 1 else lf) @ rf[s * 128:(s + 1) * 128]
                for s in range(mf.SLOTS))
    return [("one slot skipped", slot), ("one k-step skipped", kstep)]


def _floor_library(mf, lhs, rhs, variant):
    """One stride-0 batched torch.matmul over the NSTEP steps computing the
    variant's tile at every step (bf16 out), or None (weight: no single
    call)."""
    if variant == "weight":
        return None
    a = lhs if variant == "k512" else lhs[:, :128].repeat(1, mf.SLOTS)
    b = rhs[:128].repeat(mf.SLOTS, 1) if variant == "same" else rhs
    a3 = a.expand(mf.NSTEP, *a.shape)
    b3 = b.expand(mf.NSTEP, *b.shape)
    return lambda: torch.matmul(a3, b3)


def phase_matmul_floor(sm, mf):
    """21. the chained small-product microbenchmark at
    tools/xp_matmul_floor.py's geometry (600 steps of 1024 queries x 4
    slots): each case's call, as it is timed, against the plain version of
    its tile (every step writes the same tile; worst row relative L2 <=
    FLOOR_ROW_REL), bit-equal on repeat; two planted faults through the
    plain version that must read above the bound; one device kernel a call
    (profiler and wrapper); then each case timed as CUDA graph replays: ms,
    ns a 64-query slot visit, TFLOP/s against 989 (none may read above
    it); rows64 at 300 and 600 steps in turns, the ratio of the times in
    FLOOR_STEP_RATIO; one stride-0 batched torch.matmul over the 600 steps
    for each case but weight."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    lhs, rhs, w = mf.make_inputs(gen)
    worst, max_err, chain = 0.0, 0.0, None
    for name, rows, variant in mf.CASES:
        got = mf.floor_bench(lhs, rhs, w, variant, rows)
        again = mf.floor_bench(lhs, rhs, w, variant, rows)
        ref = mf.floor_reference(lhs, rhs, w, variant)
        torch.cuda.synchronize()
        rel, same = _row_rel(got, ref), torch.equal(got, again)
        worst = max(worst, rel)
        max_err = max(max_err, (got - ref).abs().max().item())
        if name == "rows64":
            chain = got
        sm.check(rel <= FLOOR_ROW_REL and same,
                 f"matmul floor {name}: worst row relative L2 {rel:.2e} "
                 f"(bound {FLOOR_ROW_REL:g}), bit-equal on repeat {same}")
    faults = {}
    for name, bad in _floor_faults(mf, lhs, rhs):
        faults[name] = _row_rel(chain, bad)
        sm.check(faults[name] > FLOOR_ROW_REL,
                 f"matmul floor planted fault ({name}) reads "
                 f"{faults[name]:.2e} through the plain version, above the "
                 f"bound")
    kernels = _one_kernel(sm, "matmul floor rows64",
                          lambda: mf.floor_bench(lhs, rhs, w, "chain", 64),
                          "floor_kernel", lambda: mf.floor_bench.launches)
    mf.floor_bench.launches = 0
    cases = {}
    visits = mf.NSTEP * (mf.QB // 64) * mf.SLOTS
    for name, rows, variant in mf.CASES:
        ms = _graph_ms(lambda: mf.floor_bench(lhs, rhs, w, variant, rows),
                       [()])
        lib = _floor_library(mf, lhs, rhs, variant)
        tflops = mf.FLOPS / ms / 1e9
        cases[name] = {"ms": ms, "ns_per_visit": ms * 1e6 / visits,
                       "tflops": tflops,
                       "library_ms": None if lib is None
                       else _graph_ms(lib, [()])}
        sm.check(tflops <= BF16_FLOPS / 1e12,
                 f"matmul floor {name}: {tflops:.0f} TFLOP/s, not above the "
                 f"card's {BF16_FLOPS / 1e12:.0f}")
    steps = {}
    for n in (mf.NSTEP, mf.NSTEP // 2, mf.NSTEP // 2, mf.NSTEP):
        steps.setdefault(n, []).append(_graph_ms(
            lambda: mf.floor_bench(lhs, rhs, w, "chain", 64, nstep=n), [()]))
    launches = mf.floor_bench.launches
    ratio = sum(steps[mf.NSTEP]) / sum(steps[mf.NSTEP // 2])
    sm.check(FLOOR_STEP_RATIO[0] <= ratio <= FLOOR_STEP_RATIO[1],
             f"matmul floor rows64: {mf.NSTEP} steps take {ratio:.3f}x the "
             f"time of {mf.NSTEP // 2} (in {FLOOR_STEP_RATIO}: every step "
             f"computed)")
    plain_ms = _timeit(lambda: mf.floor_reference(lhs, rhs, w, "chain",
                                                  mf.NSTEP), n=2)
    nbytes = lhs.numel() // 4 * 2 + rhs.numel() * 2 + mf.QB * 128 * 4
    bound_ms, bound_by = _bound(nbytes, mf.FLOPS, BF16_FLOPS)
    sm.log("time matmul floor (CUDA graph replays): " + "; ".join(
        f"{n} {v['ms']:.4f} ms, {v['ns_per_visit']:.2f} ns/64q-slot, "
        f"{v['tflops']:.0f} TFLOP/s, stride-0 batched torch.matmul "
        + ("none" if v["library_ms"] is None else f"{v['library_ms']:.4f} ms")
        for n, v in cases.items())
        + f"; rows64 at {mf.NSTEP // 2} / {mf.NSTEP} steps "
        + ", ".join(f"{n}: " + "/".join(f"{t:.4f}" for t in ts)
                    for n, ts in steps.items())
        + f" ms (ratio {ratio:.3f}); rows64 bound {bound_ms:.4f} ms by "
        f"{bound_by}; plain {plain_ms:.3f} ms; {launches} launches")
    return {"launches": launches, "max_abs_err": max_err, "row_rel": worst,
            "shape": "rows64 chain, 600 steps of 1024 x 128 x (4 x 128)",
            "ms": cases["rows64"]["ms"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": cases["rows64"]["library_ms"],
            "library": "one stride-0 batched torch.matmul over the 600 "
                       "steps, lhs[:, :128].repeat(1, 4) @ rhs, bf16 out",
            "faults": faults, "kernels_per_call": kernels,
            "step_ratio": ratio, "step_ms": steps, "cases": cases}


# --------------------------------------------------------------- training

# MSDA backward kernel vs its plain version, relative to the largest plain
# magnitude: float32 sums in another order (grad_value's atomics in no fixed
# order at all); grad_value rounded to bf16 when value is bf16
BWD_F32_REL = 1e-4
BWD_BF16_REL = 2e-2
# card vs CPU gradients of a whole model in f32 (TF32 off), each parameter
# against its own largest CPU gradient: many layers summed in another order
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-6
BWD_NAMES = ("grad_value", "grad_loc", "grad_aw")


def _msda_bwd_cost(value, shapes, loc):
    """(bytes, flops) of the MSDA backward on these inputs: value, g,
    locations and weights read once, grad_value (value's dtype), grad_loc
    and grad_aw written once; per sample with a corner on its map ~16 FLOPs
    per channel (four corner dot products, four scaled adds) and ~30 for
    the corner weights and the location chain rule."""
    b, s, m, d = value.shape
    lq = loc.shape[1]
    nbytes = (2 * value.numel() * value.element_size() + b * lq * m * d * 4
              + 2 * loc.numel() * 4 + 2 * (loc.numel() // 2) * 4)
    return nbytes, (16 * d + 30) * _msda_samples(shapes, loc)


def _msda_bwd_rows(value, loc, grads, ref):
    """(grad_value, grad_loc) worst row relative L2 errors."""
    d = value.shape[-1]
    lp2 = loc.shape[3] * loc.shape[4] * 2
    return (_msda_row_rel(grads[0], ref[0], d),
            _msda_row_rel(grads[1], ref[1], lp2))


def _msda_bwd_compare(sm, msda, name, value, shapes, loc, aw, g,
                      faults=False):
    got = msda.ms_deform_attn_core_backward(value, shapes, loc, aw, g)
    torch.cuda.synchronize()
    ref = msda.ms_deform_attn_core_backward_reference(value.float(), shapes,
                                                      loc, aw, g)
    errs = []
    for what, x, y in zip(BWD_NAMES, got, ref):
        bf16 = what == "grad_value" and value.dtype == torch.bfloat16
        tol = BWD_BF16_REL if bf16 else BWD_F32_REL
        err = (x.float() - y).abs().max().item()
        bound = tol * max(1.0, y.abs().max().item())
        want_dtype = value.dtype if what == "grad_value" else torch.float32
        sm.check(bool(torch.isfinite(x).all()) and err <= bound
                 and x.dtype == want_dtype,
                 f"msda backward {name} {str(value.dtype)[6:]} {what} "
                 f"Lq={loc.shape[1]} max_abs_err={err:.3e} (bound "
                 f"{bound:.3e} = {tol:g} x max(1, max|plain|))")
        errs.append(err)
    rel_v, rel_l = _msda_bwd_rows(value, loc, got, ref)
    bound_v = (MSDA_ROW_REL_BF16 if value.dtype == torch.bfloat16
               else MSDA_ROW_REL)
    sm.check(rel_v <= bound_v and rel_l <= MSDA_ROW_REL,
             f"msda backward {name} {str(value.dtype)[6:]}: worst row "
             f"relative L2 grad_value {rel_v:.2e} (bound {bound_v:g}), "
             f"grad_loc {rel_l:.2e} (bound {MSDA_ROW_REL:g})")
    if faults:
        for what, v, lc, a, start, n in _msda_faults(value.float(), shapes,
                                                     loc, aw):
            bad = list(msda.ms_deform_attn_core_backward_reference(
                v, shapes, lc, a, g))
            if what.startswith("level start"):
                # a kernel that reads the level one row late scatters there
                gv = torch.zeros_like(bad[0])
                gv[:, :start] = bad[0][:, :start]
                gv[:, start + n:] = bad[0][:, start + n:]
                gv[:, start + 1:start + n] = bad[0][:, start:start + n - 1]
                bad[0] = gv
            fv, fl = _msda_bwd_rows(value, loc, bad, ref)
            sm.check(fv > bound_v and fl > MSDA_ROW_REL,
                     f"msda backward {name} planted fault ({what}, plain "
                     f"version): worst row relative L2 grad_value {fv:.3g} "
                     f"> {bound_v:g}, grad_loc {fl:.3g} > {MSDA_ROW_REL:g}")
    return errs


def _msda_bwd_time(sm, msda, name, value, shapes, loc, aw, g):
    ms = _timeit(lambda: msda.ms_deform_attn_core_backward(
        value, shapes, loc, aw, g))
    plain_ms = _timeit(lambda: msda.ms_deform_attn_core_backward_reference(
        value, shapes, loc, aw, g), n=3)
    nbytes, flops = _msda_bwd_cost(value, shapes, loc)
    bound_ms, bound_by = _bound(nbytes, flops, F32_FLOPS)
    atomics = 4 * value.shape[-1] * _msda_samples(shapes, loc)
    sm.log(f"time msda backward {name} {str(value.dtype)[6:]} "
           f"Lq={loc.shape[1]}: kernel {ms:.3f} ms (zeroed f32 map, kernel, "
           f"cast), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by "
           f"{bound_by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP, "
           f"<= {atomics / 1e9:.3f}e9 float32 atomic adds; CUDA events)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def phase_msda_bwd(sm, msda, captured):
    """13. the MSDA backward kernel vs its plain version: small levels, then
    one UPN request's own encoder and decoder inputs (phase 7) with a
    seeded upstream gradient."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    small = ((6, 8), (3, 4), (2, 2))
    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        for d in (8, 32):
            value, loc, aw = _msda_inputs(gen, small, 2, 37, 2, d, 4, dtype,
                                          -0.3, 1.3)
            g = torch.randn(2, 37, 2 * d, device="cuda", generator=gen)
            errs += _msda_bwd_compare(sm, msda, f"small D={d}", value, small,
                                      loc, aw, g)
    times = {}
    for key in ("encoder", "decoder"):
        value, shapes, loc, aw = (t.clone() if torch.is_tensor(t) else t
                                  for t in captured[key])
        g = torch.randn(value.shape[0], loc.shape[1],
                        value.shape[2] * value.shape[3], device="cuda",
                        generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            errs += _msda_bwd_compare(sm, msda, f"{key} (request 0's inputs)",
                                      value.to(dt), shapes, loc, aw, g,
                                      faults=dt == torch.bfloat16)
        times[key] = _msda_bwd_time(sm, msda, f"{key} (request 0's inputs)",
                                    value, shapes, loc, aw, g)
    return max(errs), times


def _grads(model):
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            .detach().float().cpu() for n, p in model.named_parameters()}


def _grad_worst(got, ref):
    """The parameter furthest over its bound GRAD_RTOL x max|ref_n| +
    GRAD_ATOL: (max_abs_err / bound, name, max_abs_err, bound)."""
    worst = (-1.0, "", 0.0, 0.0)
    for n, r in ref.items():
        err = (got[n] - r).abs().max().item()
        bound = GRAD_RTOL * r.abs().max().item() + GRAD_ATOL
        ratio = err / bound if err == err else float("inf")
        if ratio > worst[0]:
            worst = (ratio, n, err, bound)
    return worst


def _grad_check(sm, what, got, ref):
    """Card gradients against CPU ones, each parameter to its own bound."""
    ratio, name, err, bound = _grad_worst(got, ref)
    finite = all(bool(torch.isfinite(v).all()) for v in got.values())
    sm.check(finite and ratio <= 1.0,
             f"{what}: {len(ref)} parameter gradients finite {finite}, each "
             f"within {GRAD_RTOL:g} x its max|cpu grad| + {GRAD_ATOL:g}; "
             f"worst {name}: max_abs_err={err:.3e}, bound {bound:.3e} "
             f"({ratio:.3g} of it)")
    return err


def phase_tiny_upn_grad(sm, upn_mod, msda):
    """14. tiny UPN f32, shared weights: parameter gradients of a fixed
    scalar of pred_boxes and pred_logits on the card (both MSDA kernels)
    and on the CPU (plain versions); then, as a negative control, the card
    run again with grad_value and then grad_loc zeroed in the MSDA backward
    must fail the same check."""
    cpu, gpu, _, _ = _tiny_upn_pair(upn_mod, msda)
    nq = cpu.model.cfg.num_queries
    gen = torch.Generator().manual_seed(8)
    cb, cl = torch.randn(1, nq, 4, generator=gen), torch.randn(
        1, nq, 1, generator=gen)
    # an unpadded input: with zero biases (random_init) a zero-padded
    # region feeds LayerNorms inputs of zero variance, whose backward
    # multiplies by 1/sqrt(eps) per norm and makes the comparison one of
    # rounding noise
    image = torch.randn(1, 256, 320, 3, generator=gen)
    hw = torch.tensor([[256, 320]])

    def run(w):
        model = w.model.requires_grad_(True)
        model.zero_grad(set_to_none=True)
        x, valid = image.to(w.model.device), hw.to(w.model.device)
        before = (msda.ms_deform_attn_core.launches,
                  msda.ms_deform_attn_core_backward.launches)
        out = model.predict(x, valid)
        dev = out["pred_boxes"].device
        loss = ((out["pred_boxes"] * cb.to(dev)).sum()
                + (out["pred_logits"] * cl.to(dev)).sum())
        loss.backward()
        torch.cuda.synchronize()
        counts = (msda.ms_deform_attn_core.launches - before[0],
                  msda.ms_deform_attn_core_backward.launches - before[1])
        return _grads(model), counts

    ref, cpu_counts = run(cpu)
    got, card_counts = run(gpu)
    err = _grad_check(sm, "tiny UPN f32 gradients card == cpu", got, ref)
    sm.check(card_counts == (4, 4) and cpu_counts == (0, 0),
             f"tiny UPN backward: (msda forward, backward) launches card "
             f"{card_counts} cpu {cpu_counts}")
    real = msda.ms_deform_attn_core_backward
    scale = max(v.abs().max().item() for v in ref.values())
    for k, what in enumerate(BWD_NAMES[:2]):
        def planted(*args, k=k):
            grads = list(real(*args))
            grads[k] = torch.zeros_like(grads[k])
            return tuple(grads)
        planted.launches = 0
        msda.ms_deform_attn_core_backward = planted
        try:
            bad, _ = run(gpu)
        finally:
            msda.ms_deform_attn_core_backward = real
        ratio, name, e, bound = _grad_worst(bad, ref)
        old = max((bad[n] - r).abs().max().item() for n, r in ref.items())
        sm.check(ratio > 1.0,
                 f"tiny UPN negative control, {what} zeroed in the MSDA "
                 f"backward: rejected, worst {name} max_abs_err={e:.3e} is "
                 f"{ratio:.3g} x its bound {bound:.3e} (a single bound of "
                 f"1e-3 x the largest gradient, {1e-3 * max(scale, 1.0):.3e},"
                 f" would read {old / (1e-3 * max(scale, 1.0)):.3g} of it)")
    return err


def phase_upn_grad(sm, upn_mod, msda):
    """15. UPN at the released geometry, bf16: forward and backward of a
    fixed scalar of the outputs on a seeded 1288x966 image, twice (the
    first warms cuDNN and the allocator)."""
    upn = upn_mod.UPNWrapper.random_init(seed=0, dtype=torch.bfloat16,
                                         device="cuda")
    model = upn.model.requires_grad_(True)
    padded, hw, _ = upn.prepare(_synthetic_image(400))
    x, valid = upn.model_input(padded[None], np.array([hw], np.int32))
    gen = torch.Generator(device="cuda").manual_seed(9)
    nq = model.cfg.num_queries
    cb = torch.randn(1, nq, 4, device="cuda", generator=gen)
    cl = torch.randn(1, nq, 1, device="cuda", generator=gen)
    msda.ms_deform_attn_core.launches = 0
    msda.ms_deform_attn_core_backward.launches = 0
    runs = []
    for it in range(2):
        model.zero_grad(set_to_none=True)
        before = (msda.ms_deform_attn_core.launches,
                  msda.ms_deform_attn_core_backward.launches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = model.predict(x, valid)
        loss = ((out["pred_boxes"] * cb).sum()
                + (out["pred_logits"] * cl).sum())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated() / 2**30
        n = (msda.ms_deform_attn_core.launches - before[0],
             msda.ms_deform_attn_core_backward.launches - before[1])
        with_grad = [p.grad for p in model.parameters() if p.grad is not None]
        finite = all(bool(torch.isfinite(g).all()) for g in with_grad)
        runs.append({"forward_ms": (t1 - t0) * 1e3,
                     "backward_ms": (t2 - t1) * 1e3, "peak_gib": peak,
                     "launches": n})
        sm.log(f"UPN bf16 forward+backward {it}: forward {(t1 - t0) * 1e3:.1f}"
               f" ms, backward {(t2 - t1) * 1e3:.1f} ms, peak memory "
               f"{peak:.2f} GiB, (msda forward, backward) launches {n}, "
               f"{len(with_grad)} of {sum(1 for _ in model.parameters())} "
               f"parameters took a gradient, loss {loss.item():.4f}")
        sm.check(n == (12, 12) and finite and len(with_grad) > 0
                 and bool(torch.isfinite(loss)),
                 f"UPN backward {it}: 12 MSDA forward and 12 backward "
                 f"launches {n}, all gradients finite {finite}")
    launches = msda.ms_deform_attn_core_backward.launches
    del upn, model, out, loss, with_grad
    torch.cuda.empty_cache()
    return launches, runs


def phase_tiny_train(sm, FO1Model, FO1Config, FallbackTokenizer, OD_template,
                     train):
    """16. FO1Config.tiny() f32 (full vocabulary, so the prompt's ids are
    labels): loss and gradients of `multimodal_lm_loss` with remat on the
    card (the flash kernel in the ViT) equal the CPU's; three AdamW steps on
    the card."""
    tiny = FO1Config.tiny()
    cfg = dataclasses.replace(tiny, text=dataclasses.replace(
        tiny.text, vocab_size=151936))
    tok = FallbackTokenizer()
    cpu = FO1Model.random_init(cfg, seed=0, device="cpu", tokenizer=tok)
    gpu = FO1Model(cfg, device="cuda", tokenizer=tok)
    gpu.load_state_dict(cpu.state_dict())
    prep = cpu.prepare(_messages(1, OD_template), max_pixels=256 * 256)
    batch = train.batch_from_prepared(cfg, prep)
    kw = dict(num_windows=prep["plan"].num_windows, grid=prep["grid"])
    losses, grads = {}, {}
    for name, m in (("cpu", cpu), ("card", gpu)):
        m.requires_grad_(True)
        loss = train.multimodal_lm_loss(m, batch, remat=True, **kw)
        loss.backward()
        losses[name] = loss.item()
        grads[name] = _grads(m)
    rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    sm.check(rel <= 1e-5, f"tiny FO1 f32 training loss card "
             f"{losses['card']:.6f} == cpu {losses['cpu']:.6f} (rel "
             f"{rel:.2e} <= 1e-5)")
    err = _grad_check(sm, "tiny FO1 f32 gradients card == cpu",
                      grads["card"], grads["cpu"])
    opt = train.adamw(gpu.parameters())
    step = train.make_train_step(gpu, opt, remat=True, **kw)
    steps = [step(batch).item() for _ in range(3)]
    sm.check(all(np.isfinite(steps)), f"tiny FO1 three AdamW steps on the "
             f"card: losses {[round(v, 5) for v in steps]}")
    return err


def _path_grad_diff(got, ref, prefix=""):
    """Relative L2 distance of two gradient sets (ref on the host), over
    the parameters whose names start with `prefix`."""
    num = den = 0.0
    for n, r in ref.items():
        if n.startswith(prefix):
            r = r.to(got[n].device).float()
            num += (got[n].float() - r).pow(2).sum().item()
            den += r.pow(2).sum().item()
    return (num / den) ** 0.5


def phase_fo1_train(sm, FO1Model, FO1Config, FallbackTokenizer, OD_template,
                    train, fa, msda, n_steps=3):
    """17. FO1Config() bf16 with remat at the demo geometry (1288x966, the
    7 demo boxes): the loss and gradients with the ViT's full attention
    through the flash kernel (the default) against those through its plain
    version, with the peak memory of each; then AdamW steps on one seeded
    batch, loss, ms and peak memory per step."""
    cfg = FO1Config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = FO1Model.random_init(cfg, seed=0, dtype=torch.bfloat16,
                                 device="cuda", tokenizer=FallbackTokenizer())
    model.requires_grad_(True)
    prep = model.prepare(_messages(500, OD_template))
    batch = train.batch_from_prepared(cfg, prep)
    kw = dict(num_windows=prep["plan"].num_windows, grid=prep["grid"],
              remat=True)
    n_params = sum(p.numel() for p in model.parameters())
    sm.log(f"FO1 training: {n_params / 1e9:.3f}B parameters bf16, prompt "
           f"{prep['splice'].seq_len} tokens "
           f"({int((batch['labels'] != -100).sum())} labelled), ViT "
           f"{batch['patches'].shape[1]} padded patches, set-up "
           f"{time.perf_counter() - t0:.1f} s")
    # the loss looks up the ViT's attention in its module at call time; the
    # plain run puts the kernel's plain version there for one call
    paths = {}
    kernel_path = train.flash_attention_differentiable
    for name, attn in (("plain", fa.flash_attention_reference),
                       ("kernel", kernel_path)):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n0 = fa.flash_attention.launches
        t0 = time.perf_counter()
        train.flash_attention_differentiable = attn
        try:
            loss = train.multimodal_lm_loss(model, batch, **kw)
            loss.backward()
        finally:
            train.flash_attention_differentiable = kernel_path
        torch.cuda.synchronize()
        paths[name] = {
            "loss": loss.item(), "ms": (time.perf_counter() - t0) * 1e3,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "flash_launches": fa.flash_attention.launches - n0}
        sm.log(f"FO1 loss + backward, ViT full attention {name}: "
               + json.dumps(paths[name]))
        if name == "plain":
            plain = {n: p.grad.cpu() for n, p in model.named_parameters()
                     if p.grad is not None}
        del loss
    got = {n: p.grad for n, p in model.named_parameters()
           if p.grad is not None}
    rel_loss = abs(paths["kernel"]["loss"] - paths["plain"]["loss"]) \
        / abs(paths["plain"]["loss"])
    rel_all = _path_grad_diff(got, plain)
    rel_vit = _path_grad_diff(got, plain, "vision_tower.")
    sm.check(set(got) == set(plain) and max(rel_loss, rel_all, rel_vit)
             <= PATH_REL_TOL and paths["kernel"]["flash_launches"] == 4
             and paths["plain"]["flash_launches"] == 0,
             f"FO1 bf16 training, ViT flash kernel vs plain: loss rel "
             f"{rel_loss:.2e}, gradients relative L2 {rel_all:.2e} (vision "
             f"tower {rel_vit:.2e}; bound {PATH_REL_TOL:g}), flash launches "
             f"{paths['kernel']['flash_launches']} and "
             f"{paths['plain']['flash_launches']}, peak "
             f"{paths['kernel']['peak_gib']:.2f} against "
             f"{paths['plain']['peak_gib']:.2f} GiB")
    del plain, got
    opt = train.adamw(model.parameters())
    step = train.make_train_step(model, opt, **kw)
    fa.flash_attention.launches = 0
    msda.ms_deform_attn_core.launches = 0
    runs = []
    for i in range(n_steps):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = step(batch).item()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        runs.append({"loss": loss, "ms": ms, "peak_gib": peak})
        sm.log(f"FO1 training step {i}: loss {loss:.5f}, {ms:.1f} ms, peak "
               f"memory {peak:.2f} GiB")
    finite = all(bool(torch.isfinite(p.grad).all())
                 for p in model.parameters() if p.grad is not None)
    kernels = (fa.flash_attention.launches, msda.ms_deform_attn_core.launches)
    sm.check(all(np.isfinite(r["loss"]) for r in runs) and finite
             and kernels == (4 * n_steps, 0),
             f"FO1 training: {n_steps} AdamW steps with finite losses, last "
             f"gradients finite {finite}, (flash, msda) launches {kernels} "
             f"(4 full-attention blocks a step)")
    del model, opt, step
    torch.cuda.empty_cache()
    return runs, paths, kernels[0]


# ---------------------------------------------------- batched and serving

SERVE_NEW = 32        # tokens per request in the 3B serving runs
SERVE_BATCH = 8
# a batched row's prefill logits against the same request alone on the
# same embeddings (the trunk's prefill), relative L2
ROW_REL_TOL = 2e-2
# end to end (encode, splice, prefill) a bf16 row of the batch must be no
# farther from an f32 copy of the weights than the request alone, x this:
# the bf16 ViT alone sits ~2e-2 from f32 and B = 8 tiles its products
# differently, so batched and alone part by ~3e-2 (PERF.md §6)
F32_ANCHOR_RATIO = 1.25
DECODE_C = 1792 + SERVE_NEW   # a demo prompt's bucket + 32 tokens


def _tiny_requests(n, OD_template, sizes=((240, 320), (192, 256))):
    """n grounding prompts on seeded images, alternating the geometries in
    `sizes`, with 1..7 of the demo boxes scaled to the image."""
    from PIL import Image

    out = []
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        boxes = [[b[0] * w / 640, b[1] * h / 480, b[2] * w / 640,
                  b[3] * h / 480] for b in DEMO_BOXES[:1 + i % 7]]
        rng = np.random.default_rng(500 + i)
        img = Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))
        out.append(_messages(0, OD_template, boxes, img))
    return out


def _same_results(a, b):
    return len(a) == len(b) and all(
        np.array_equal(x.token_ids, y.token_ids)
        and x.num_steps == y.num_steps for x, y in zip(a, b))


def _tokens(results):
    return [r.token_ids.tolist() for r in results]


def phase_tiny_serving(sm, FO1Model, FO1Config, FallbackTokenizer,
                       OD_template, upn_mod, msda, serving):
    """FO1Config.tiny() (untied head) f32 with shared weights: batched,
    serving, continuous and UPN -> FO1 results on the card (kernels, decode
    from CUDA graphs) equal to the CPU's (plain versions); graph decode
    equal to eager decode on the card; launch_batch without a host wait."""
    tiny = FO1Config.tiny()
    cfg = dataclasses.replace(tiny, text=dataclasses.replace(
        tiny.text, tie_word_embeddings=False))
    tok = FallbackTokenizer()
    cpu = FO1Model.random_init(cfg, seed=0, device="cpu", tokenizer=tok)
    gpu = FO1Model(cfg, device="cuda", tokenizer=tok)
    gpu.load_state_dict(cpu.state_dict())
    reqs = _tiny_requests(10, OD_template)
    same_geom = reqs[0::2]
    batches = {"stacked": same_geom[:3], "per-item": reqs[:3]}

    def graph_vs_eager(fn):
        out = fn()
        gpu.cuda_graphs = False
        try:
            eager = fn()
        finally:
            gpu.cuda_graphs = True
        return out, eager

    for name, batch in batches.items():
        rc = cpu.generate_batch(batch, max_new_tokens=12)
        rg, re = graph_vs_eager(
            lambda: gpu.generate_batch(batch, max_new_tokens=12))
        sm.check(_same_results(rc, rg) and _same_results(rg, re),
                 f"tiny FO1 f32 generate_batch ({name}, B=3): card (graph) "
                 f"== cpu {_same_results(rc, rg)}, graph == eager on the "
                 f"card {_same_results(rg, re)}; steps "
                 f"{[r.num_steps for r in rg]}, tokens {_tokens(rg)}")
    tp = dict(max_new_tokens=12, temperature=0.8, top_p=0.9, seed=3)
    a, b = graph_vs_eager(lambda: gpu.generate_batch(batches["stacked"],
                                                     **tp))
    sm.check(_same_results(a, b), f"tiny FO1 top-p (T=0.8, p=0.9, seed 3) "
             f"generate_batch: graph == eager on the card: {_tokens(a)} vs "
             f"{_tokens(b)}")
    one_g, one_e = graph_vs_eager(
        lambda: [gpu.generate(reqs[1], max_new_tokens=12, stage_ms={})])
    sm.check(_same_results(one_g, one_e), "tiny FO1 staged single request "
             "(B=1, no prompt pad): graph == eager on the card")

    opts = serving.ServingOptions(batch_size=2, max_new_tokens=12)
    pc, pg = (serving.ServingPipeline(m, opts) for m in (cpu, gpu))
    rc, rg = pc.run(reqs[:6]), pg.run(reqs[:6])
    sm.check(_same_results(rc, rg) and pg.stats["retries"] == 0
             and pg.stats == pc.stats,
             f"tiny ServingPipeline (grouped, device preproc, 6 requests, "
             f"batch 2): card == cpu {_same_results(rc, rg)}, stats "
             f"{pg.stats}")
    copts = serving.ContinuousOptions(batch_size=2, chunk=3, refill_size=1,
                                      max_new_tokens=12)
    creqs = [{"messages": m, "max_new_tokens": 12 if i % 2 else 3}
             for i, m in enumerate(same_geom)]
    cc = serving.ContinuousServingPipeline(cpu, copts)
    rc = cc.run(creqs)
    cg, ce = (serving.ContinuousServingPipeline(gpu, copts)
              for _ in range(2))
    rg, re = graph_vs_eager(lambda: cg.run(creqs) if gpu.cuda_graphs
                            else ce.run(creqs))
    sm.check(_same_results(rc, rg) and _same_results(rg, re)
             and cg.stats == cc.stats == ce.stats,
             f"tiny ContinuousServingPipeline (5 requests, budgets 3/12, "
             f"batch 2, chunk 3): card == cpu {_same_results(rc, rg)}, "
             f"graph == eager {_same_results(rg, re)}, stats card "
             f"{cg.stats} cpu {cc.stats}")

    ucpu, ugpu, _, _ = _tiny_upn_pair(upn_mod, msda)
    images = [_synthetic_image(310 + i).resize((320, 256)) for i in range(2)]
    ureqs = [{"image": im, "text": OD_template.format("orange")}
             for im in images]
    uopts = serving.UPNFO1Options(batch_size=1, min_score=0.0, max_boxes=10,
                                  max_new_tokens=12)
    oc = serving.UPNFO1Pipeline(ucpu, cpu, uopts).run(ureqs)
    msda.ms_deform_attn_core.launches = 0
    og = serving.UPNFO1Pipeline(ugpu, gpu, uopts).run(ureqs)
    upn_launches = msda.ms_deform_attn_core.launches
    for i, (c, g) in enumerate(zip(oc, og)):
        pc_, pg_ = np.asarray(c["proposals"]), np.asarray(g["proposals"])
        if pc_.shape == pg_.shape and (pc_ == pg_).all():
            ok, how = c["text"] == g["text"], "the same proposals"
        else:
            # the filter truncates to ints: a float box a hair either side
            # of an integer on the two devices moves one coordinate by 1;
            # then the card's answer must equal the CPU FO1's over the
            # card's proposals
            msgs = [{"role": "user", "content": [
                {"type": "image_url", "image_url": {"url": images[i]}},
                {"type": "text", "text": ureqs[i]["text"]}],
                "bbox_list": g["proposals"]}]
            ref = cpu.finish_batch(cpu.launch_batch(
                [cpu.prepare(msgs, device_preproc=True)],
                max_new_tokens=12))[0]
            ok = (pc_.shape == pg_.shape and np.abs(pc_ - pg_).max() <= 1
                  and g["text"] == ref.text)
            how = (f"proposals off by at most 1 px at "
                   f"{int((pc_ != pg_).sum())} coordinates; answer equals "
                   f"the CPU FO1's over the card's proposals")
        sm.check(ok, f"tiny UPN -> FO1 pipeline request {i}: card == cpu "
                 f"({how}); {len(g['proposals'])} proposals")
    sm.check(upn_launches == 2 * 4, f"tiny UPN -> FO1 pipeline: msda "
             f"launches {upn_launches} (4 a UPN forward, 2 forwards)")

    # launch_batch enqueues without waiting for the device (the program
    # and plan tensors exist after the first launch at this shape)
    preps = [gpu.prepare(m) for m in batches["stacked"]]
    gpu.finish_batch(gpu.launch_batch(preps, max_new_tokens=12))
    torch.cuda.synchronize()
    err = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = gpu.launch_batch(preps, max_new_tokens=12)
    except RuntimeError as e:
        err, handle = e, None
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if handle is not None:
        gpu.finish_batch(handle)
    sm.check(err is None, f"tiny launch_batch with sync debug mode 'error': "
             f"no host synchronisation ({err})")


def _decode_step_ms(model, gen, b, graphs, reps=3):
    """Device ms per decode step of the model's masked step at B rows over
    a demo-request cache (C = 1792 + 32), every step live: CUDA events
    around `reps` runs of one loop program (a graph replay each, or the
    same steps eagerly). Returns (ms a step, program bytes, graph pool
    bytes)."""
    g = model._gen_cfg(SERVE_NEW, 0.0, 1.0, -1)   # no row ever finishes
    prog = gen.loop_program(model.text, model.cfg.text, g, b, DECODE_C,
                            1792, graphs)
    with torch.inference_mode():
        prog.cur.random_(0, 1000)
        prog.done.zero_()
        prog.seq_lens.fill_(1771)
        prog.rope_deltas.zero_()
        prog.step.fill_(1)
        prog.run()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            prog.step.fill_(1)
            prog.run()
        e1.record()
        torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / (reps * prog.steps)
    sizes = (prog.nbytes(), prog.captured.pool_bytes)
    gen.release_program(model.text, prog)
    return ms, *sizes


def _stage_logits(model, preps):
    """Encode, splice and prefill of a same-geometry batch, nothing else:
    (embeddings [B, L, D], last-token logits [B, V])."""
    from vlm_fo1_tpu_torch.runtime import generate as gen

    enc = model._stack_batch_inputs(preps)
    pad = gen.pad_to_bucket(max(p["splice"].seq_len for p in preps), 128)
    with torch.inference_mode():
        vision, region = model._encode_batched(enc)
        emb, *_ = model._splice_stacked(enc, vision, region, preps, pad)
    return emb, _batch_prefill(model, emb, preps)


def _batch_prefill(model, emb, preps):
    """The prefill logits of right-padded embeddings [B, L, D]."""
    from vlm_fo1_tpu_torch.runtime import generate as gen

    pad = emb.shape[1]
    pos = np.zeros((3, len(preps), pad), np.int64)
    for i, p in enumerate(preps):
        pos[:, i, :p["splice"].seq_len] = p["position_ids"][:, 0]
    seq = np.array([p["splice"].seq_len for p in preps])
    with torch.inference_mode():
        return gen.prefill(model.text, model.cfg.text, emb,
                           model._upload(pos), model._upload(seq), pad + 1,
                           attention=model.attention)[1]


def _row_rel_np(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _zero_launches(*fns):
    for fn in fns:
        fn.launches = 0


def _results_equal(sm, what, graph, eager):
    """Graph decode against eager decode of the same requests: tokens and
    num_steps equal, row by row."""
    same = _same_results(graph, eager)
    first = [next((i for i, (a, b) in enumerate(zip(g.token_ids,
                                                      e.token_ids))
                   if a != b), None) for g, e in zip(graph, eager)]
    prefill = all(np.array_equal(g.prefill_logits, e.prefill_logits)
                  for g, e in zip(graph, eager))
    sm.check(same, f"{what}: graph decode == eager decode (tokens and "
             f"num_steps) {same}; steps {[r.num_steps for r in graph]} / "
             f"{[r.num_steps for r in eager]}; prefill logits equal "
             f"{prefill}; first differing token per row {first}")
    return same


def phase_serving_3b(sm, fo1, upn, fa, msda, gen, serving, OD_template):
    """FO1Config() bf16 (the phase-6 model) and the phase-7 UPN: decode ms
    a step eager and from graphs, the staged single request and a batch of
    8 demo requests with graph decode equal to eager decode, the batch's
    rows vs each request alone, the three pipelines, and the flash kernel
    on the batch's own right-padded prefill against its plain version.
    The flash and MSDA counts are zeroed just before each main-path run
    (the batch of 8, each pipeline) and read just after it; the
    comparisons run outside those windows."""
    out = {"decode_ms_per_step": {}}
    windows = {}
    counted = (fa.flash_attention, msda.ms_deform_attn_core)

    def read(window):
        windows[window] = {f.__name__: f.launches for f in counted}
    for b in (1, SERVE_BATCH):
        for graphs in (False, True):
            ms, nbytes, pool = _decode_step_ms(fo1, gen, b, graphs,
                                               reps=3 if graphs else 1)
            key = f"B={b} {'graph' if graphs else 'eager'}"
            out["decode_ms_per_step"][key] = ms
            sm.log(f"3B bf16 decode {key}: {ms:.3f} ms a step (C = "
                   f"{DECODE_C}); program {nbytes / 2**30:.3f} GiB of which "
                   f"graph pool {pool / 2**30:.3f} GiB")
            if graphs:
                out[f"graph_bytes_B{b}"] = nbytes
                out[f"graph_pool_bytes_B{b}"] = pool
    reqs = [_messages(400 + i, OD_template) for i in range(16)]
    stages, single = {}, {}
    for graphs in (False, True):
        fo1.cuda_graphs = graphs
        st = {}
        res = fo1.generate(reqs[0], max_new_tokens=SERVE_NEW, stage_ms=st)
        stages["graph" if graphs else "eager"] = (st["decode"],
                                                  res.num_steps)
        single[graphs] = [res]
    fo1.cuda_graphs = True
    _results_equal(sm, "3B bf16 staged single request (B=1)", single[True],
                   single[False])
    out["single_decode_stage_ms"] = {k: v[0] for k, v in stages.items()}
    sm.log(f"3B bf16 single request, decode stage ({stages['graph'][1]} "
           f"tokens): eager steps {stages['eager'][0]:.1f} ms, graphs "
           f"{stages['graph'][0]:.1f} ms")

    batch = reqs[:SERVE_BATCH]
    fo1.generate_batch(batch, max_new_tokens=SERVE_NEW)   # captures B = 8
    preps = [fo1.prepare(m) for m in batch]
    with torch.inference_mode():
        enc = fo1._stack_batch_inputs(preps)
        twice = [fo1._encode_batched(enc) for _ in range(2)]
    sm.check(all(torch.equal(a, b) for a, b in zip(*twice)),
             f"3B bf16 batch of {SERVE_BATCH}: two encodes give the same "
             f"vision and region tokens, bit for bit")
    del enc, twice
    fo1.cuda_graphs = False
    res_e = fo1.finish_batch(fo1.launch_batch(preps,
                                              max_new_tokens=SERVE_NEW))
    fo1.cuda_graphs = True
    captured = {}
    attn = fo1.attention

    def record(q, k, v, **kw):
        if kw.get("causal") and q.shape[0] == SERVE_BATCH:
            captured.setdefault("qkv", (q, k, v, kw))
        return attn(q, k, v, **kw)

    fo1.attention = record
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches(*counted)
    t0 = time.perf_counter()
    res_b = fo1.finish_batch(fo1.launch_batch(preps,
                                              max_new_tokens=SERVE_NEW))
    batch_ms = (time.perf_counter() - t0) * 1e3
    read("generate_batch_b8")
    peak = torch.cuda.max_memory_allocated() / 2**30
    fo1.attention = attn
    _results_equal(sm, f"3B bf16 batch of {SERVE_BATCH}", res_b, res_e)
    steps = res_b[0].num_steps
    out["generate_batch"] = {"ms": batch_ms, "num_steps": steps,
                             "tokens_per_s": SERVE_BATCH * steps
                             / batch_ms * 1e3, "peak_gib": peak}
    sm.log(f"3B bf16 batch of {SERVE_BATCH} demo requests (launch + finish,"
           f" prepare excluded): {batch_ms:.1f} ms, {steps} steps, "
           f"{SERVE_BATCH * steps / batch_ms * 1e3:.1f} tokens/s, peak "
           f"{peak:.2f} GiB, prompts {[r.prompt_len for r in res_b]}")

    rels, agree, alone_embeds, alone_logits = [], [], [], []
    for i, m in enumerate(batch):
        alone = fo1.generate(m, max_new_tokens=SERVE_NEW)
        rels.append(_row_rel_np(res_b[i].prefill_logits,
                                alone.prefill_logits))
        n = min(len(alone.token_ids), len(res_b[i].token_ids))
        agree.append(int((alone.token_ids[:n] == res_b[i].token_ids[:n])
                         .sum()))
        emb, logits = _stage_logits(fo1, [preps[i]])
        alone_embeds.append(emb)
        alone_logits.append(logits[0])
    # the trunk: the alone requests' own embeddings as one batch of 8
    trunk = _batch_prefill(fo1, torch.cat(alone_embeds), preps)
    trunk_rel = max(_row_rel(trunk[i:i + 1], alone_logits[i][None].float())
                    for i in range(SERVE_BATCH))
    sm.check(trunk_rel <= ROW_REL_TOL,
             f"3B bf16 batched prefill (B={SERVE_BATCH}, ragged bucket) vs "
             f"each request alone on the same embeddings: worst row "
             f"relative L2 {trunk_rel:.3e} (tol {ROW_REL_TOL:g})")
    # end to end, against an f32 copy of the same weights
    f32 = type(fo1)(fo1.cfg, device="cuda", dtype=torch.float32,
                    tokenizer=fo1.tokenizer)
    f32.load_state_dict(fo1.state_dict())
    ratios, emb_rel = [], []
    for i in range(SERVE_BATCH):
        emb32, ref = _stage_logits(f32, [preps[i]])
        ref = ref[0].float().cpu().numpy()
        ratios.append(_row_rel_np(res_b[i].prefill_logits, ref) / max(
            _row_rel_np(alone_logits[i].float().cpu().numpy(), ref), 1e-6))
        emb_rel.append(((alone_embeds[i].float() - emb32).norm()
                        / emb32.norm()).item())
    del f32, emb32
    torch.cuda.empty_cache()
    sm.log(f"3B bf16 requests alone against an f32 copy of the weights: "
           f"embeddings (vision and region tokens spliced) relative L2 "
           f"{min(emb_rel):.2e}-{max(emb_rel):.2e}")
    out["row_rel"] = {"end_to_end": max(rels), "trunk": trunk_rel,
                      "f32_ratio": max(ratios),
                      "alone_embeddings_vs_f32": max(emb_rel)}
    sm.check(max(ratios) <= F32_ANCHOR_RATIO and all(np.isfinite(rels)),
             f"3B bf16 batch of {SERVE_BATCH} vs each request alone, end to "
             f"end: row relative L2 {[f'{r:.2e}' for r in rels]}; each "
             f"batched row's distance from an f32 copy of the weights over "
             f"the alone row's {[f'{r:.3f}' for r in ratios]} (tol "
             f"{F32_ANCHOR_RATIO:g}); greedy tokens agreeing per row "
             f"{agree} of {SERVE_NEW}")

    q, k, v, kw = captured["qkv"]
    got = fa.flash_attention(q, k, v, **kw)
    ref = fa.flash_attention_reference(q.float(), k.float(), v.float(), **kw)
    rel = _row_rel(got, ref)
    flash_b8 = {"shape": f"B={q.shape[0]} H={q.shape[1]} Hkv={k.shape[1]} "
                f"S={q.shape[2]} D={q.shape[3]} causal, right-padded",
                "row_rel": rel,
                "max_abs_err": (got.float() - ref).abs().max().item()}
    sm.check(rel <= BF16_TOL, f"flash kernel on the batch's own layer-0 "
             f"prefill ({flash_b8['shape']}) vs its plain version: worst row "
             f"relative L2 {rel:.3e} (tol {BF16_TOL:g})")
    del got, ref, captured

    sopts = serving.ServingOptions(batch_size=SERVE_BATCH,
                                   max_new_tokens=SERVE_NEW)
    # a pipeline holds up to max_in_flight + 1 batches' programs: capture
    # them before the timed run
    g = fo1._gen_cfg(SERVE_NEW, 0.0, 1.0, None)
    progs = [gen.loop_program(fo1.text, fo1.cfg.text, g, SERVE_BATCH,
                              DECODE_C, 1792) for _ in range(2)]
    for prog in progs:
        gen.release_program(fo1.text, prog)
    pipe = serving.ServingPipeline(fo1, sopts)
    _zero_launches(*counted)
    t0 = time.perf_counter()
    res_s = pipe.run(reqs)
    s_ms = (time.perf_counter() - t0) * 1e3
    read("serving_pipeline")
    sm.check(pipe.stats["retries"] == 0 and len(res_s) == 16
             and pipe.stats["fused_batches"] == pipe.stats["batches"],
             f"3B ServingPipeline, 16 demo requests (grouped, device "
             f"preproc, batch 8): {s_ms:.1f} ms, {16e3 / s_ms:.2f} "
             f"requests/s, stats {pipe.stats}")
    out["serving"] = {"ms": s_ms, "requests_per_s": 16e3 / s_ms,
                      "stats": pipe.stats}

    budgets = [SERVE_NEW if i % 2 else SERVE_NEW // 4 for i in range(16)]
    copts = serving.ContinuousOptions(batch_size=SERVE_BATCH, chunk=8,
                                      refill_size=2,
                                      max_new_tokens=SERVE_NEW)
    # capture the session's chunk program before the timed run
    prog = gen.acquire_program(
        fo1.text, fo1.cfg.text, fo1._gen_cfg(SERVE_NEW, 0.0, 1.0, None),
        mode="chunk", batch=SERVE_BATCH, cache_len=DECODE_C,
        prompt_pad=1792, steps=8)
    gen.release_program(fo1.text, prog)
    cpipe = serving.ContinuousServingPipeline(fo1, copts)
    _zero_launches(*counted)
    t0 = time.perf_counter()
    res_c = cpipe.run([{"messages": m, "max_new_tokens": b}
                       for m, b in zip(reqs, budgets)])
    c_ms = (time.perf_counter() - t0) * 1e3
    read("continuous_pipeline")
    sync_steps = sum(max(budgets[i:i + SERVE_BATCH]) - 1
                     for i in range(0, 16, SERVE_BATCH))
    sm.check(all(r is not None and r.num_steps <= b
                 for r, b in zip(res_c, budgets)),
             f"3B ContinuousServingPipeline, 16 demo requests (budgets "
             f"{SERVE_NEW // 4} / {SERVE_NEW}, batch 8, chunk 8, refill 2): "
             f"{c_ms:.1f} ms, "
             f"{16e3 / c_ms:.2f} requests/s, device steps "
             f"{cpipe.stats['device_steps']} against the batch-synchronous "
             f"{sync_steps}, stats {cpipe.stats}")
    out["continuous"] = {"ms": c_ms, "requests_per_s": 16e3 / c_ms,
                         "device_steps": cpipe.stats["device_steps"],
                         "batch_synchronous_steps": sync_steps}

    images = [_synthetic_image(600 + i) for i in range(2)]
    uopts = serving.UPNFO1Options(batch_size=2, min_score=0.0,
                                  max_new_tokens=SERVE_NEW)
    _zero_launches(*counted)
    t0 = time.perf_counter()
    res_u = serving.UPNFO1Pipeline(upn, fo1, uopts).run(
        [{"image": im, "text": OD_template.format("orange")}
         for im in images])
    u_ms = (time.perf_counter() - t0) * 1e3
    read("upn_fo1_pipeline")
    sm.check(len(res_u) == 2 and all(0 < len(r["proposals"]) <= 100
                                     for r in res_u)
             and windows["upn_fo1_pipeline"]["ms_deform_attn_core"] == 12,
             f"3B UPN -> FO1 pipeline, 2 images (batch 2, "
             f"{[len(r['proposals']) for r in res_u]} proposals, first run "
             f"at its shape): {u_ms:.1f} ms; answers "
             f"{[r['fo1_bboxes'] for r in res_u]}")
    sm.check(all(w["flash_attention"] > 0 for w in windows.values()),
             f"3B serving path: flash and MSDA launches, each count zeroed "
             f"just before its run and read just after: {windows}")
    out["upn_fo1_ms"] = u_ms
    out["programs_kept_bytes"] = gen._programs(fo1.text).pool_bytes()
    sm.log(f"3B bf16 decode programs kept: "
           f"{out['programs_kept_bytes'] / 2**30:.2f} GiB")
    return out, windows, flash_b8


DA_SHAPES = ((1, 1952), (8, 1952), (8, 2432))   # (B, C); H 16, Hkv 2
DA_ROW_REL = 1e-2


def _da_inputs(g, b, c):
    """Decode attention's inputs at the 3B widths: q [B, 16, 128], kc / vc
    [B, C, 2, 128] bf16, each row valid below a length in [C - 200, C]."""
    def draw(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(
            torch.bfloat16)

    lens = torch.randint(c - 200, c + 1, (b,), generator=g, device="cuda")
    mask = torch.arange(c, device="cuda")[None] < lens[:, None]
    return draw(b, 16, 128) * 3, draw(b, c, 2, 128), draw(b, c, 2, 128), mask


def _da_times(sm, da):
    """Phase 33's kernel half: each DA_SHAPES case checked and timed."""
    out = {}
    g = torch.Generator(device="cuda").manual_seed(33)
    for b, c in DA_SHAPES:
        name = f"B={b} C={c}"
        args = _da_inputs(g, b, c)
        got = da.decode_attention(*args)
        again = da.decode_attention(*args)
        ref = da.decode_attention_reference(*args)
        torch.cuda.synchronize()
        o = got.float().reshape(b, 16, 128)
        r = ref.float().reshape(o.shape)
        rel = float(((o - r).norm(dim=-1) / r.norm(dim=-1)).max())
        sm.check(rel <= DA_ROW_REL and torch.equal(got, again),
                 f"decode attention {name}: worst head row {rel:.2e} "
                 f"relative L2 of the plain version (<= {DA_ROW_REL}), "
                 f"bit-equal on repeat {torch.equal(got, again)}")
        valid = int(args[3].sum())
        nbytes = (2 * valid * 2 * 128 * 2 + 2 * b * 16 * 128 * 2
                  + args[3].numel())
        copies = _copies(2 * b * c * 2 * 128 * 2,
                         lambda: _da_inputs(g, b, c))
        ms = _graph_ms(da.decode_attention, copies)
        plain_ms = _graph_ms(da.decode_attention_reference, copies)
        eager_ms = _timeit_rotating(da.decode_attention, copies, n=50)
        bound_ms, bound_by = _bound(nbytes, 4 * 16 * valid * 128, 989e12)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "eager_ms": eager_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_share": bound_ms / ms, "row_rel": rel,
                     "gb_per_s": nbytes / ms / 1e6}
        sm.log(f"decode attention {name}: graph {ms * 1e3:.2f} us, eager "
               f"{eager_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
               f"bound {bound_ms * 1e3:.2f} us ({bound_by}, "
               f"{nbytes / 1e6:.2f} MB), {100 * bound_ms / ms:.1f}% of it")
        del copies, args
        torch.cuda.empty_cache()
    return out


def phase_decode_attention(sm, da, gen, fo1):
    out = _da_times(sm, da)
    tcfg = fo1.cfg.text
    gcfg = fo1._gen_cfg(512, 0.0, 1.0, None)
    steps = 8
    prog = gen.acquire_program(fo1.text, tcfg, gcfg, mode="chunk", batch=8,
                               cache_len=1920 + 512, prompt_pad=1920,
                               steps=steps)
    with torch.inference_mode():
        prog.done.zero_()
        prog.row_max.fill_(512)
        prog.seq_lens.fill_(1800)
        before = da.decode_attention.launches
        prog.run()
        torch.cuda.synchronize()
        per_step = (da.decode_attention.launches - before) / steps
    gen.release_program(fo1.text, prog)
    layers = tcfg.num_hidden_layers
    sm.check(per_step == layers and prog.captured.graph is not None,
             f"decode attention: a captured B = 8 chunk program of the 3B "
             f"model (C 2432, {steps} steps) launched it {per_step:g} times "
             f"a step (one a layer: {layers})")
    out["launches_per_captured_step"] = per_step
    big = out["B=8 C=2432"]
    return {"launches": da.decode_attention.launches,
            "shape": "B=8 C=2432 H=16 Hkv=2 hd=128 bf16",
            **{k: big[k] for k in ("ms", "plain_ms", "eager_ms", "bound_ms",
                                   "bound_by", "bound_share", "row_rel")},
            "library_ms": None, "shapes": out}


def phase_int4_graph(sm, quant, i4, i4mlp):
    """The int4 kernels' streaming route at M = 1, 2, 4, 8 (decode steps'
    rows) on the 3B trunk's shapes, captured in a CUDA graph and replayed:
    bit-equal to an eager call on the same inputs, one launch a product
    (two a fused MLP), held against the plain version at the bf16 bounds,
    routes asserted."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    calls = {}
    for m in DECODE_ROWS:
        for name, k, n in TRUNK_LINEARS:
            x = torch.randn(m, k, device="cuda",
                            generator=gen).to(torch.bfloat16)
            packed, scale = quant.quantize_weight_int4(
                torch.randn(n, k, device="cuda", generator=gen) * 0.02)
            calls[f"int4_matmul {name} K={k} N={n} M={m}"] = (
                i4.int4_matmul, 1, functools.partial(i4.int4_matmul, x,
                                                     packed, scale),
                functools.partial(i4.int4_matmul_reference, x.float(),
                                  packed, scale))
        x = torch.randn(m, 2048, device="cuda",
                        generator=gen).to(torch.bfloat16)
        node = _mlp_node(quant, gen, 2048, 11008)
        calls[f"int4_mlp D=2048 I=11008 M={m}"] = (
            i4mlp.int4_mlp, 2, functools.partial(i4mlp.int4_mlp, x, node),
            functools.partial(i4mlp.int4_mlp_reference, x.float(), node))
    out = {"int4_matmul": True, "int4_mlp": True}
    for what, (fn, products, call, plain) in calls.items():
        eager = call()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        routes = dict(fn.routes)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = call()
        captured = {r: fn.routes[r] - routes[r] for r in routes
                    if fn.routes[r] != routes[r]}
        graph.replay()
        graph.replay()
        torch.cuda.synchronize()
        same = torch.equal(got, eager)
        out[fn.__name__] &= same
        sm.check(same and captured == {"gemv": products},
                 f"{what} bf16 replayed from a CUDA graph: bit-equal to "
                 f"eager {same}, captured routes {captured}")
        ref = plain()
        _rel_check(sm, f"{what} bf16 from the graph vs its plain version:",
                   got, ref, BF16_TOL)
        seg = _seg_rel(got, ref)
        sm.check(seg <= INT4_SEG_BF16, f"{what} bf16 from the graph: worst "
                 f"row segment relative L2 {seg:.3e} (bound "
                 f"{INT4_SEG_BF16:g})")
        del graph
    out["kernels_per_call"] = _kernels_per_call(sm, calls)
    return out


def _kernels_per_call(sm, calls):
    """Device kernels of one eager call of each M = 8 product, from
    torch.profiler's CUDA activity: one a streaming int4_matmul, two a
    fused MLP (gate and up with the SwiGLU, then down). None where the
    profiler recorded no device activity."""
    counts = {}
    for what, (_, products, call, _) in calls.items():
        if not what.endswith(f"M={SERVE_BATCH}"):
            continue
        names = _device_kernels(call)
        counts[what] = len(names) if names else None
        if names:
            sm.check(len(names) == products and all(
                "skinny_kernel" in n for n in names),
                f"{what}: {len(names)} device kernel(s) a call, "
                f"{sorted(set(n.split('(')[0][-40:] for n in names))} "
                f"(want {products} streaming launch(es))")
        else:
            sm.log(f"{what}: the profiler recorded no device activity; "
                   f"kernels a call not measured")
    return counts


def phase_quant_serving(sm, FO1Model, FO1Config, FallbackTokenizer,
                        OD_template, quant, i4, i4mlp, gen):
    """FO1Config() in the int4 and int4-mlp modes: the first demo request
    alone and a batch of 8 (prefill on the TMA tiles, decode steps
    streaming from the decode graph), graph decode equal to eager decode
    at B = 1 and 8; the batch's launches (zeroed just before it, read just
    after) are the trunk's int4 modules once per forward; the decode ms a
    step at B = 1 and 8, eager and graph, and the first request's 32-token
    decode stage from its kept graph."""
    from vlm_fo1_tpu_torch.models.llm import Int4MLP
    from vlm_fo1_tpu_torch.nn import QLinear4

    runs, launches = {}, {}
    for mode, fn, kind in (("int4", i4.int4_matmul, QLinear4),
                           ("int4-mlp", i4mlp.int4_mlp, Int4MLP)):
        model = FO1Model.random_init(FO1Config(), seed=0,
                                     dtype=torch.bfloat16, device="cuda",
                                     tokenizer=FallbackTokenizer())
        quant.quantize_model(model, mode)
        per_forward = sum(isinstance(m, kind) for m in model.text.modules())
        batch = [_messages(700 + i, OD_template) for i in range(SERVE_BATCH)]
        eager, graph, stage = {}, {}, {}
        for graphs, res in ((False, eager), (True, graph)):
            model.cuda_graphs = graphs
            res[1] = [model.generate(batch[0], max_new_tokens=SERVE_NEW)]
            res[SERVE_BATCH] = model.generate_batch(
                batch, max_new_tokens=SERVE_NEW)   # graphs: captures
        model.cuda_graphs = True
        # the first request's 32-token decode stage from its kept graph
        model.generate(batch[0], max_new_tokens=SERVE_NEW,
                       stage_ms=stage)
        for b in (1, SERVE_BATCH):
            _results_equal(sm, f"3B {mode} B={b}", graph[b], eager[b])
        preps = [model.prepare(m) for m in batch]
        routes0 = dict(fn.routes)
        steps0 = gen.DecodeProgram.steps_run
        torch.cuda.synchronize()
        fn.launches = 0
        t0 = time.perf_counter()
        res = model.finish_batch(model.launch_batch(
            preps, max_new_tokens=SERVE_NEW))
        ms = (time.perf_counter() - t0) * 1e3
        n = fn.launches
        forwards = 1 + gen.DecodeProgram.steps_run - steps0
        routes = {r: fn.routes[r] - routes0[r] for r in routes0
                  if fn.routes[r] != routes0[r]}
        launches[fn.__name__] = n
        step = {}
        for b in (1, SERVE_BATCH):
            for graphs in (False, True):
                step[f"B={b} {'graph' if graphs else 'eager'}"] = \
                    _decode_step_ms(model, gen, b, graphs,
                                    reps=3 if graphs else 1)[0]
        runs[mode] = {"batch_ms": ms, "num_steps": res[0].num_steps,
                      "launches": n, "forwards": forwards,
                      "launches_per_forward": n / forwards, "routes": routes,
                      "graph_equals_eager": {
                          f"B={b}": _same_results(graph[b], eager[b])
                          for b in (1, SERVE_BATCH)},
                      "decode_ms_per_step": step,
                      "decode_stage_ms_32_tokens_B1": stage["decode"]}
        sm.check(n == per_forward * forwards and routes.get("tma", 0) > 0
                 and routes.get("gemv", 0) > 0 and "mma" not in routes
                 and _same_results(res, graph[SERVE_BATCH])
                 and all(np.isfinite(r.prefill_logits).all() for r in res),
                 f"3B {mode} batch of {SERVE_BATCH} demo requests: {ms:.1f} "
                 f"ms ({res[0].num_steps} steps), {fn.__name__} launches {n}"
                 f" == {per_forward} a forward x {forwards} forwards on the "
                 f"device (graph replays counted), routes {routes}; the "
                 f"same results as the batch before; decode a step (C = "
                 f"{DECODE_C}): B=1 eager {step['B=1 eager']:.3f} ms, graph "
                 f"{step['B=1 graph']:.3f} ms, B={SERVE_BATCH} eager "
                 f"{step[f'B={SERVE_BATCH} eager']:.3f} ms, graph "
                 f"{step[f'B={SERVE_BATCH} graph']:.3f} ms; the first "
                 f"request's {SERVE_NEW}-token decode stage from its graph "
                 f"{stage['decode']:.1f} ms")
        del model
        torch.cuda.empty_cache()
    return runs, launches


# ---------------------------------------- multi-image and video prompts

VIDEO_GRID = (4, 62, 84)   # 8 frames of 1288x966 under max_pixels 1024^2
MM_NEW = 32                # tokens per request in the multimodal runs


def _mm_messages(kind, seed, template):
    """A two-image request (the 7 demo boxes on the first image) or a video
    request of 8 synthetic 1288x966 frames."""
    text = {"type": "text", "text": template.format("orange")}
    if kind == "two_images":
        return [{"role": "user", "content": [
            {"type": "image_url", "image_url": {"url": _synthetic_image(s)}}
            for s in (seed, seed + 1)] + [text], "bbox_list": DEMO_BOXES}]
    frames = [_synthetic_image(seed + i) for i in range(8)]
    return [{"role": "user", "content": [
        {"type": "video_url", "video_url": {"url": frames}}, text]}]


def _stage_line(stage):
    return ", ".join(f"{k} {stage[k]:.1f} ms"
                     for k in ("prepare", "encode", "prefill", "decode"))


def phase_multimodal_3b(sm, fo1, fa, OD_template, flops):
    """The phase-6 3B bf16 model on multi-slot prompts: a two-image request
    and a video request (stage ms, peak, flash launches zeroed just before
    each and read just after: 4 per ViT encode + 36 for the prefill; each
    measured on its second staged run, after the first captured its decode
    program, whose capture the prefill stage would hold), the
    two-image request's kernel path against its plain path at full width,
    a mixed generate_batch of 8 (four single-image, two two-image, two
    video prompts; per-item encode) against each request alone, and the
    per-stage TFLOP/s of the phase-6 demo request from runtime/flops.py."""
    cfg = fo1.cfg
    layers = cfg.text.num_hidden_layers
    n_full = len(cfg.vision.fullatt_block_indexes)
    out = {}
    for kind, seed in (("two_images", 200), ("video", 210)):
        msgs = _mm_messages(kind, seed, OD_template)
        prep = fo1.prepare(msgs)
        plans = prep["plans"]
        if kind == "video":
            sm.check(tuple(prep["grid"]) == VIDEO_GRID
                     and plans[0].seq_pad == 22528,
                     f"video prep: grid {prep['grid']}, "
                     f"{plans[0].seq_pad} padded ViT tokens, "
                     f"{plans[0].num_units} video tokens in the prompt")
        # a first staged run captures the decode program of this shape
        fo1.generate(msgs, max_new_tokens=MM_NEW, stage_ms={})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stage = {}
        _zero_launches(fa.flash_attention)
        res = fo1.generate(msgs, max_new_tokens=MM_NEW, stage_ms=stage)
        n = fa.flash_attention.launches
        want = n_full * len(plans) + layers
        peak = torch.cuda.max_memory_allocated() / 2**30
        out[kind] = {"grids": [list(map(int, g)) for g in prep["grids"]],
                     "vit_tokens_padded": [p.seq_pad for p in plans],
                     "prompt_len": res.prompt_len, "stage_ms": stage,
                     "peak_gib": peak, "flash_launches": n,
                     "steps": res.num_steps}
        sm.log(f"3B {kind} request: grids {out[kind]['grids']}, padded ViT "
               f"tokens {out[kind]['vit_tokens_padded']}, prompt "
               f"{res.prompt_len} tokens, {_stage_line(stage)} "
               f"({res.num_steps} tokens), peak {peak:.2f} GiB, flash "
               f"launches {n}")
        sm.check(n == want and bool(np.isfinite(res.prefill_logits).all()),
                 f"3B {kind} request: flash launches {n} == {want} "
                 f"({n_full} per ViT encode x {len(plans)} + {layers}), "
                 f"finite prefill logits")

    # the two-image request, kernel path vs plain path at full width
    prep = fo1.prepare(_mm_messages("two_images", 200, OD_template))
    outs = {}
    info = prep["splice"]
    for name, attn in (("kernel", fa.flash_attention),
                       ("plain", fa.flash_attention_reference)):
        fo1.attention = attn
        with torch.inference_mode():   # region rows for all 14 slots
            vis, reg, _ = fo1._encode_one(prep)
            emb = fo1._splice_one(info, vis, reg, info.seq_len)[None]
        _, logits = fo1.prefill(prep, emb, info.seq_len + 1)
        outs[name] = (vis.float(), reg.float(), logits.float())
    fo1.attention = fa.flash_attention
    for i, what in enumerate(("vision tokens", "region tokens",
                              "prefill last-token logits")):
        got, ref = outs["kernel"][i], outs["plain"][i]
        err = (got - ref).abs().max().item()
        rel = ((got - ref).norm() / ref.norm()).item()
        bound = PATH_REL_TOL * max(1.0, ref.abs().max().item())
        sm.check(err <= bound, f"3B two-image kernel path vs plain path, "
                 f"{what}: max_abs_err={err:.3e} (bound {bound:.3e} = "
                 f"{PATH_REL_TOL:g} x max(1, max|plain|)); relative L2 "
                 f"{rel:.3e}")
    del outs

    # a mixed batch of 8 against each request alone
    singles = [_messages(300 + i, OD_template) for i in range(4)]
    batch = [singles[0], _mm_messages("two_images", 310, OD_template),
             _mm_messages("video", 320, OD_template), singles[1],
             singles[2], _mm_messages("two_images", 312, OD_template),
             _mm_messages("video", 330, OD_template), singles[3]]
    kinds = ["image", "two_images", "video", "image", "image",
             "two_images", "video", "image"]
    alone = [fo1.generate(m, max_new_tokens=MM_NEW) for m in batch]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches(fa.flash_attention)
    t0 = time.perf_counter()
    got = fo1.generate_batch(batch, max_new_tokens=MM_NEW)
    batch_ms = (time.perf_counter() - t0) * 1e3
    n = fa.flash_attention.launches
    want = n_full * sum({"image": 1, "two_images": 2, "video": 1}[k]
                        for k in kinds) + layers
    rels = [_row_rel_np(g.prefill_logits, a.prefill_logits)
            for g, a in zip(got, alone)]
    agree = [int(sum(x == y for x, y in zip(g.token_ids[:MM_NEW],
                                           a.token_ids[:MM_NEW])))
             for g, a in zip(got, alone)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    out["mixed_batch"] = {"kinds": kinds, "ms": batch_ms, "peak_gib": peak,
                          "flash_launches": n, "row_rel": rels,
                          "tokens_agree_of_32": agree,
                          "prompt_lens": [r.prompt_len for r in got]}
    sm.log(f"3B mixed batch of 8 ({kinds}): {batch_ms:.1f} ms (prepare "
           f"included), prompts {out['mixed_batch']['prompt_lens']}, peak "
           f"{peak:.2f} GiB, flash launches {n}; greedy tokens agreeing "
           f"with the request alone, of {MM_NEW}: {agree}")
    sm.check(n == want, f"3B mixed batch: flash launches {n} == {want}")
    sm.check(max(rels) <= ROW_REL_TOL,
             f"3B mixed batch: each row's prefill logits vs the request "
             f"alone, relative L2 {max(rels):.3e} (bound {ROW_REL_TOL:g}); "
             f"rows {[f'{r:.2e}' for r in rels]}")

    # per-stage TFLOP/s of the phase-6 demo request
    msgs = _messages(100, OD_template)
    fo1.generate(msgs, max_new_tokens=MM_NEW, stage_ms={})   # captured
    stage = {}
    res = fo1.generate(msgs, max_new_tokens=MM_NEW, stage_ms=stage)
    prep = fo1.prepare(msgs)
    _, gh, gw = (int(g) for g in prep["grid"])
    work = {
        "encode": flops.encode_flops(cfg, gh, gw, len(prep["aux_boxes"])),
        "prefill": flops.prefill_flops(cfg.text, res.prompt_len),
        "decode": flops.decode_flops(cfg.text, res.num_steps - 1,
                                     res.prompt_len),
    }
    rep = flops.mfu_report({k: (f, stage[k] / 1e3) for k, f in work.items()})
    out["tflops_demo_request"] = rep
    sm.log("3B demo request per stage (wall-clock stage ms, analytic FLOPs "
           "of runtime/flops.py, against the H100 SXM dense bf16 peak "
           f"{flops.H100_BF16_PEAK / 1e12:g} TFLOP/s): " + json.dumps(rep))
    sm.check(all(rep[k]["tflop_s"] > 0 for k, f in work.items() if f > 0),
             "3B demo request: a TFLOP/s for every stage that did work")
    return out


def phase_flash_video(sm, fa, build_vit_plan, vit_cfg):
    """The flash kernel at the 8-frame video's ViT full-attention shape
    (S = 22,528, D = 80, 16 heads, the plan's own kv_valid) in bf16 against
    its plain version on sampled query rows of every head against all keys
    (the whole plain attention would need [16, S, S] f32 logits, 32 GB),
    with the row bound and the two planted faults of phase 2; the kernel and
    scaled_dot_product_attention timed as CUDA graph replays beside the
    bound, the plain version's time on the sampled rows."""
    import torch.nn.functional as F

    plan = build_vit_plan(VIDEO_GRID, vit_cfg)
    valid = torch.from_numpy(plan.valid).cuda()
    s, h, d = plan.seq_pad, vit_cfg.num_heads, vit_cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn(1, h, s, d, device="cuda", generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    kw = {"kv_valid": valid}
    rows = valid.nonzero()[:, 0]
    pick = rows[torch.randperm(len(rows), device="cuda",
                               generator=gen)[:510]]
    pick = torch.cat([rows[:1], pick, rows[-1:]]).sort().values
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = fa.flash_attention_reference(q[:, :, pick].float(), k.float(),
                                       v.float(), **kw)
    got = out[:, :, pick].float()
    err = (got - ref).abs().max().item()
    rel = _row_rel(got, ref)
    sm.check(bool(torch.isfinite(out).all()) and rel <= BF16_TOL,
             f"flash vit_video bf16 S={s}: worst row relative L2 {rel:.3e} "
             f"over {len(pick)} sampled query rows x {h} heads (tol "
             f"{BF16_TOL:g}), max_abs_err {err:.3e}")
    faults = {}
    for fault, fkw in _planted_faults(kw, s):
        fout = fa.flash_attention(q, k, v, **fkw)[:, :, pick]
        faults[fault] = {"row_rel": _row_rel(fout, ref),
                         "max_abs_err": (fout.float() - ref).abs().max()
                         .item()}
        sm.check(faults[fault]["row_rel"] > BF16_TOL,
                 f"flash vit_video bf16 with the {fault}: worst row relative "
                 f"L2 {faults[fault]['row_rel']:.3e} (must exceed "
                 f"{BF16_TOL:g})")
    del out, ref, fout
    allowed = valid[None, :].expand(s, s).contiguous()
    kernel = (lambda: fa.flash_attention(q, k, v, **kw))
    sdpa = (lambda: F.scaled_dot_product_attention(q, k, v,
                                                   attn_mask=allowed))
    ms = _graph_ms(kernel, [()])
    lib_ms = _graph_ms(sdpa, [()])
    eager_ms = _timeit(kernel)
    plain_ms = _timeit(lambda: fa.flash_attention_reference(
        q[:, :, pick], k, v, **kw))
    n_valid = int(valid.sum().item())
    flops = 4 * h * d * n_valid * n_valid
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    bound_ms, bound_by = _bound(nbytes, flops, BF16_FLOPS)
    res = {"shape": f"vit_video B=1 H={h} S={s} ({n_valid} valid) D={d} "
                    f"bf16", "max_abs_err": err, "row_rel": rel,
           "faults": faults, "ms": ms, "library_ms": lib_ms,
           "eager_ms": eager_ms, "plain_ms_sampled_rows": plain_ms,
           "plain_rows": len(pick), "bound_ms": bound_ms,
           "bound_by": bound_by, "tflops": flops / ms / 1e9,
           "bound_share": bound_ms / ms}
    sm.log(f"time flash vit_video bf16 S={s}: kernel {ms:.4f} ms (eager "
           f"calls {eager_ms:.4f} ms), scaled_dot_product_attention "
           f"{lib_ms:.4f} ms, plain {plain_ms:.3f} ms for {len(pick)} "
           f"sampled query rows (eager), bound {bound_ms:.4f} ms by "
           f"{bound_by} ({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); "
           f"kernel {flops / ms / 1e9:.1f} TFLOP/s, "
           f"{100 * bound_ms / ms:.1f}% of the bound; CUDA graph replays")
    return res


def _fill_module(mod, seed):
    """Every parameter of a CPU module drawn from a seeded generator: norm
    weights 1 + 0.1 N(0, 1), everything else 0.05 N(0, 1)."""
    from vlm_fo1_tpu_torch import nn as tnn

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in mod.modules():
            for name, p in m.named_parameters(recurse=False):
                x = torch.randn(p.shape, generator=gen)
                if isinstance(m, tnn.LayerNorm) and name == "weight":
                    p.copy_(1.0 + 0.1 * x)
                else:
                    p.copy_(0.05 * x)
    return mod


def _card_vs_cpu(sm, what, card, cpu, tol=F32_TOL):
    got, ref = card.float().cpu(), cpu.float()
    rel = ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()
    err = (got - ref).abs().max().item()
    sm.check(bool(torch.isfinite(got).all()) and rel <= tol,
             f"{what}: card vs CPU f32 relative L2 {rel:.3e} (tol {tol:g}), "
             f"max_abs_err {err:.3e}, shape {tuple(got.shape)}")
    return rel


def phase_hfre_variants(sm, fo1, OD_template, hfre, projector):
    """Every HFRE variant on the phase-6 request's own DaViT stage maps and
    ViT captures (taken from the bf16 model, held in f32), and the
    CAbstractor and TokenPacker at the trunk's widths: the card against the
    CPU in f32, each module's parameters drawn from a seeded generator. The
    mean combinations need equal path widths: they take the first three
    captured levels (3 x 1280 = 3840 channels, the aux width)."""
    import copy
    import dataclasses

    from vlm_fo1_tpu_torch.models.vit import captures_to_feature_map

    cfg = fo1.cfg
    prep = fo1.prepare(_messages(100, OD_template))
    n = len(prep["aux_boxes"])
    with torch.inference_mode():
        enc = fo1._stack_batch_inputs([prep])
        patches, aux = fo1._normalize(enc["patches"], enc["aux"])
        rc, rs, valid, iu, it = enc["plan_arrays"]
        _, captures = fo1.vision_tower(patches, rc, rs, valid,
                                       num_windows=enc["num_windows"],
                                       inv_unit_idx=iu,
                                       attention=fo1.attention)
        vt_map = captures_to_feature_map(captures, it, enc["grid"],
                                         cfg.vision.spatial_merge_size)[0]
        maps = [m[0].float() for m in fo1.vision_tower_aux(aux)]
    vt_map = vt_map.float()
    aux_b = enc["aux_boxes"][0][:n].float()
    vt_b = enc["vt_boxes"][0][:n].float()
    aux_w = sum(cfg.hfre.aux_region_feature_dims)
    base = cfg.hfre
    variants = {}
    for comb in ("concat", "concat_aux_pos", "concat_sep_pos",
                 "concat_sep_no_vt_pos", "mean", "mean_aux_pos",
                 "mean_sep_pos", "mean_sep_no_vt_pos"):
        variants[comb] = {"region_feature_combination": comb}
    variants.update({
        "feature_map_pos": {"pos_embedding_strategy": "feature_map_based"},
        "hybrid_pos": {"pos_embedding_strategy": "hybrid"},
        "no_pos": {"apply_position_embedding": False},
        "vt_only": {"use_vt_region_feature_only": True},
        "aux_only": {"use_vision_tower_region_feature": False},
        "region_layer_norms": {"apply_region_layer_norm": True},
        "simple_fpn_norms": {"use_simple_fpn_for_vt": True,
                             "apply_region_layer_norm": True},
    })
    rels, t0 = {}, time.perf_counter()
    for i, (name, kw) in enumerate(variants.items()):
        mean = kw.get("region_feature_combination", "").startswith("mean")
        vt = vt_map[..., :aux_w] if mean else vt_map
        vt_dim = 2048 if kw.get("use_simple_fpn_for_vt") else vt.shape[-1]
        if kw.get("use_vt_region_feature_only") or mean:
            out_dim = vt_dim
        elif kw.get("use_vision_tower_region_feature") is False:
            out_dim = aux_w
        else:
            out_dim = aux_w + vt_dim
        vcfg = dataclasses.replace(base, vt_region_feature_dim=vt_dim,
                                   region_feature_dim=out_dim, **kw)
        cpu_mod = _fill_module(hfre.HFRE(vcfg, vt.shape[-1]), 40 + i)
        card_mod = copy.deepcopy(cpu_mod).cuda()
        with torch.inference_mode():
            got = card_mod(maps, aux_b, vt, vt_b)
            ref = cpu_mod([m.cpu() for m in maps], aux_b.cpu(), vt.cpu(),
                          vt_b.cpu())
        rels[name] = _card_vs_cpu(sm, f"HFRE {name} ({n} boxes, region "
                                  f"width {out_dim})", got, ref)
    with torch.inference_mode():   # one pre-concatenated aux map
        cat = hfre.upsample_concat_aux([m[None] for m in maps])[0]
        got = hfre.hfre_forward(base, cat, aux_b, vt_map, vt_b)
        ref = hfre.hfre_forward(base, cat.cpu(), aux_b.cpu(), vt_map.cpu(),
                                vt_b.cpu())
    rels["preconcatenated_aux"] = _card_vs_cpu(
        sm, "HFRE pre-concatenated aux map", got, ref)
    sm.log(f"HFRE variants: {len(rels)} in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator().manual_seed(50)
    d_in, d_out = cfg.mm_hidden_size, cfg.text.hidden_size
    x = torch.randn(1, 576, d_in, generator=gen)
    xm = torch.randn(1, 576, 4 * d_in, generator=gen)
    for kind, args, kwargs in (("cabstract", (x,), {}),
                               ("tokenpacker", ((x, xm),),
                                {"raw_grid": 24})):
        cpu_mod = _fill_module(projector.build_projector(kind, d_in, d_out),
                               51)
        card_mod = copy.deepcopy(cpu_mod).cuda()
        card_args = tuple(tuple(t.cuda() for t in a) if isinstance(a, tuple)
                          else a.cuda() for a in args)
        with torch.inference_mode():
            got = card_mod(*card_args, **kwargs)
            ref = cpu_mod(*args, **kwargs)
        rels[kind] = _card_vs_cpu(sm, f"{kind} projector {d_in} -> {d_out}",
                                  got, ref)
    return rels


def phase_eval_runners(sm, fo1, runners, coco_map, seed):
    """The evaluation runners over the 3B model on records fabricated from
    `seed` in a temporary directory under build/: 16 CountBench items (3-12
    boxes) at batch 1, 8 and pipelined 8 with equal predictions, and 8 COCO
    images with proposals and scores through eval_coco and
    score_coco_files; items/s for each."""
    import os
    import shutil
    import tempfile

    from PIL import Image

    os.makedirs("build", exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="eval_", dir="build")
    try:
        rng = np.random.default_rng(seed)
        names = [f"im{i}.jpg" for i in range(8)]
        for i, name in enumerate(names):
            size = (966, 1288) if i % 2 == 0 else (768, 1024)
            Image.fromarray(rng.integers(0, 256, (*size, 3), np.uint8)).save(
                os.path.join(tmp, name))

        def boxes(k, size=(966, 1288)):
            xy = rng.uniform(0, min(size) / 2, (k, 2))
            wh = rng.uniform(20, min(size) / 2, (k, 2))
            return np.concatenate([xy, xy + wh], 1).round(1).tolist()

        count = []
        for i in range(16):
            a = int(rng.integers(3, 13))
            count.append({"question": "How many oranges are there?",
                          "answer": a, "image": names[i % 8],
                          "bboxes": boxes(a),
                          "scores": rng.uniform(0.3, 0.9, a).round(3)
                          .tolist()})
        cpath = os.path.join(tmp, "countbench.json")
        with open(cpath, "w") as f:
            json.dump(count, f)
        rows, anns = [], []
        for i in range(8):
            k = int(rng.integers(5, 21))
            bl = boxes(k)
            rows.append({"id": i, "image": names[i], "bbox_list": bl,
                         "score_list": rng.uniform(0.3, 0.9, k).round(3)
                         .tolist(),
                         "conversations": [{"value": "Please detect cat."}]})
            anns += [{"image_id": i, "category_id": 1 + j % 2,
                      "bbox": [b[0], b[1], b[2] - b[0], b[3] - b[1]],
                      "iscrowd": 0} for j, b in enumerate(bl[::2])]
        epath = os.path.join(tmp, "coco.jsonl")
        with open(epath, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
        apath = os.path.join(tmp, "instances.json")
        with open(apath, "w") as f:
            json.dump({"images": [{"id": i} for i in range(8)],
                       "annotations": anns,
                       "categories": [{"id": 1, "name": "cat"},
                                      {"id": 2, "name": "dog"}]}, f)
        out, preds = {}, {}
        for name, bs, piped in (("countbench_b1", 1, False),
                                ("countbench_b8", 8, False),
                                ("countbench_pipelined_b8", 8, True)):
            t0 = time.perf_counter()
            r = runners.eval_countbench(fo1, cpath, tmp, max_new_tokens=16,
                                        verbose=False, batch_size=bs,
                                        pipelined=piped)
            dt = time.perf_counter() - t0
            preds[name] = r["predictions"]
            out[name] = {"items_per_s": r["total"] / dt, "s": dt,
                         "accuracy": r["accuracy"]}
            sm.log(f"eval_countbench batch {bs}{' pipelined' if piped else ''}"
                   f": {r['total']} items in {dt:.2f} s, "
                   f"{r['total'] / dt:.2f} items/s, predictions "
                   f"{r['predictions']}")
        sm.check(len(set(map(tuple, preds.values()))) == 1
                 and len(preds["countbench_b1"]) == 16,
                 "eval_countbench: equal predictions at batch 1, 8 and "
                 "pipelined 8")
        t0 = time.perf_counter()
        res = runners.eval_coco(fo1, epath, apath, tmp,
                                os.path.join(tmp, "pred.json"),
                                max_new_tokens=16, batch_size=8)
        dt = time.perf_counter() - t0
        metrics = coco_map.score_coco_files(os.path.join(tmp, "pred.json"),
                                            apath)
        out["coco_b8"] = {"items_per_s": 8 / dt, "s": dt,
                          "records": len(res), "AP": metrics["AP"]}
        sm.log(f"eval_coco batch 8: 8 images in {dt:.2f} s, {8 / dt:.2f} "
               f"items/s, {len(res)} records; score_coco_files: "
               + json.dumps(metrics))
        sm.check(len(metrics) == 12 and all(np.isfinite(list(
            metrics.values()))), "eval_coco + score_coco_files: 12 finite "
                                 "metrics")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ------------------------------------ native prepare and the parallel layer

def phase_native_prepare(sm, fo1, native, pim, OD_template):
    """Phase 30: the demo request's prepare on the native C++ path
    (counted), the three native functions within 1e-6 of their numpy path
    at the demo geometry, and stage_ms["prepare"] both ways over five
    calls."""
    msgs = _messages(100, OD_template)
    native.calls.update(native=0, numpy=0)
    fo1.prepare(msgs)
    calls = dict(native.calls)
    sm.check(calls["native"] >= 1 and calls["numpy"] == 0,
             f"native prepare: the demo request's prepare took the C++ path "
             f"({calls})")
    img = _synthetic_image(100)
    errs = {}
    for name, fn in (("qwen_image_preprocess", pim.qwen_image_preprocess),
                     ("aux_image_preprocess",
                      lambda im: pim.aux_image_preprocess(
                          im, fo1.cfg.aux_image_size)),
                     ("qwen_image_patchify_u8", pim.qwen_image_patchify_u8)):
        got = fn(img)
        native.enabled = False
        try:
            want = fn(img)
        finally:
            native.enabled = True
        if isinstance(got, tuple):
            got, want = got[0], want[0]
        errs[name] = float(np.abs(got.astype(np.float32)
                                  - want.astype(np.float32)).max())
        sm.check(got.shape == want.shape and errs[name] <= 1e-6,
                 f"native {name} at 1288x966 {got.shape} {got.dtype}: "
                 f"max_abs_err {errs[name]:.3e} vs numpy (<= 1e-6)")
    # the layout transform alone (no resize), on the smart-resized image
    raw, _ = pim.qwen_image_raw_u8(img)
    lib = native.get_lib()
    core = {}
    for path, fn in (("native", lambda: native.qwen_patchify_raw_native(
            lib, raw, 14, 2, 2)), ("numpy", lambda: pim.patchify_raw_np(raw)),
                     ("native", lambda: native.qwen_patchify_raw_native(
                         lib, raw, 14, 2, 2)),
                     ("numpy", lambda: pim.patchify_raw_np(raw))):
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            core.setdefault(path, []).append(
                (time.perf_counter() - t0) * 1e3)
    core = {p: float(np.median(v)) for p, v in core.items()}
    sm.log(f"native prepare: the raw patchify of the {raw.shape} image "
           f"alone, median of 10 host calls: native {core['native']:.3f} "
           f"ms, numpy {core['numpy']:.3f} ms")
    ms = {}
    for path, on in (("native", True), ("numpy", False), ("native", True),
                     ("numpy", False)):
        native.enabled = on
        try:
            runs = []
            for _ in range(5):
                stage = {}
                fo1.generate(msgs, max_new_tokens=2, stage_ms=stage)
                runs.append(stage["prepare"])
        finally:
            native.enabled = True
        ms.setdefault(path, []).extend(runs)
    out = {p: {"median_ms": float(np.median(v)), "runs_ms": v}
           for p, v in ms.items()}
    sm.log(f"native prepare: stage_ms['prepare'] of the demo request over "
           f"2 x 5 calls each way in turns: native median "
           f"{out['native']['median_ms']:.2f} ms, numpy median "
           f"{out['numpy']['median_ms']:.2f} ms; {json.dumps(out)}")
    return {"prepare_ms": out, "raw_patchify_ms": core, "max_abs_err": errs}


def _sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def phase_sp_prefill(sm, fo1, gen, quant, fa, i4mlp, OD_template):
    """Phase 31: the phase-6 3B model on the demo prompt padded to a
    multiple of 4, through prefill_sequence_parallel over an in-process
    world-1 NCCL group and over a LocalRing of 4 chunks, against prefill.
    In f32 (an f32 copy of the trunk, the same embeddings) the last-token
    logits and the prompt's K/V rows must agree to 2e-4 relative L2; in
    bf16 each SP prefill must lie no farther (x 1.25) from the f32 prefill
    than the bf16 prefill does. 32 greedy tokens are decoded from the SP
    and the dense bf16 caches through the decode graphs. Then the same
    with the trunk MLPs as fused int4 SwiGLUs (36 launches a prefill)."""
    import torch.distributed as dist

    from vlm_fo1_tpu_torch.parallel.dryrun import free_port
    from vlm_fo1_tpu_torch.parallel.ring_attention import LocalRing

    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        return _sp_prefill_runs(sm, fo1, gen, quant, fa, i4mlp, OD_template,
                                LocalRing)
    finally:
        dist.destroy_process_group()


def _prefill_runs(gen, text, tcfg, attention, emb, pos, seq, cache_len,
                  groups, i4mlp):
    """(cache, logits, ms, fused SwiGLU launches) of prefill and of each SP
    group, each on its second run."""
    runs = {}
    with torch.inference_mode():
        for name, group in groups:
            if name == "prefill":
                fn = functools.partial(gen.prefill, text, tcfg, emb, pos, seq,
                                       cache_len, attention=attention)
            else:
                fn = functools.partial(gen.prefill_sequence_parallel, text,
                                       tcfg, emb, pos, seq, cache_len, group)
            for _ in range(2):
                i4mlp.int4_mlp.launches = 0
                (cache, logits), ms = _sync_ms(fn)
            runs[name] = {"cache": cache, "logits": logits, "ms": ms,
                          "int4_mlp_launches": i4mlp.int4_mlp.launches}
    return runs


def _kv_rel(a, b, s):
    return max(_rel(a["cache"][k][:, :, :s], b["cache"][k][:, :, :s])
               for k in ("k", "v"))


def _sp_prefill_runs(sm, fo1, gen, quant, fa, i4mlp, OD_template,
                     LocalRing):
    import copy

    text, tcfg = fo1.text, fo1.cfg.text
    prep = fo1.prepare(_messages(100, OD_template))
    with torch.inference_mode():
        vis, reg = fo1.encode(prep)
        emb = fo1.splice(prep, vis, reg)
    s = emb.shape[1]
    sp = -(-s // 4) * 4
    emb = torch.nn.functional.pad(emb, (0, 0, 0, sp - s))
    pos = np.zeros((3, 1, sp), np.int64)
    pos[:, :, :s] = prep["position_ids"]
    pos = fo1._upload(pos)
    seq = torch.full((1,), s, device="cuda")
    deltas = fo1._upload(np.asarray(prep["rope_deltas"]).reshape(1))
    gen_cfg = gen.GenerationConfig(max_new_tokens=32, temperature=0.0,
                                   eos_token_id=-1)
    cache_len = sp + gen_cfg.max_new_tokens
    groups = (("prefill", None), ("sp_nccl_world1", None),
              ("sp_local_ring4", LocalRing(4)))
    sp_names = [n for n, _ in groups[1:]]
    out = {"prompt_len": s, "padded_len": sp}
    for mode in ("bf16", "int4-mlp"):
        if mode == "int4-mlp":
            for layer in text.layers:
                layer.mlp = quant.quantize_mlp_int4(layer.mlp)
        gen.drop_programs(text)
        # the same trunk in f32 (the int4 nodes' bytes and scales as they
        # are): the ring's arithmetic at full width, free of bf16 rounding
        t32 = copy.deepcopy(text).float()
        runs = _prefill_runs(gen, text, tcfg, fo1.attention, emb, pos, seq,
                             cache_len, groups, i4mlp)
        r32 = _prefill_runs(gen, t32, tcfg, fo1.attention, emb.float(), pos,
                            seq, cache_len, groups, i4mlp)
        del t32
        ref, ref32 = runs["prefill"], r32["prefill"]
        dense_off = _rel(ref["logits"], ref32["logits"])
        dense_kv_off = _kv_rel(ref, ref32, s)
        res = {"prefill_ms": ref["ms"], "prefill_bf16_vs_f32": dense_off}
        if mode == "bf16":
            # two dense bf16 paths (the kernel's and the plain attention)
            # differ by bf16 rounding alone: the floor for any other path
            plain = _prefill_runs(gen, text, tcfg,
                                  fa.flash_attention_reference, emb, pos,
                                  seq, cache_len, groups[:1], i4mlp)
            res["plain_vs_kernel_prefill"] = _rel(
                plain["prefill"]["logits"], ref["logits"])
            sm.log(f"SP prefill 3B bf16: prefill with the plain attention "
                   f"against the kernel's: logits relative L2 "
                   f"{res['plain_vs_kernel_prefill']:.3e} (the bf16 floor)")
        for name in sp_names:
            r, q = runs[name], r32[name]
            f32 = (_rel(q["logits"], ref32["logits"]),
                   _kv_rel(q, ref32, s))
            sm.check(max(f32) <= 2e-4,
                     f"SP prefill 3B {mode} {name} in f32: last-token logits "
                     f"relative L2 {f32[0]:.3e}, prompt K/V rows {f32[1]:.3e}"
                     f" against prefill (<= 2e-4)")
            off = (_rel(r["logits"], ref32["logits"]), _kv_rel(r, ref32, s))
            vs = (_rel(r["logits"], ref["logits"]), _kv_rel(r, ref, s))
            sm.check(off[0] <= 1.25 * dense_off
                     and off[1] <= 1.25 * dense_kv_off,
                     f"SP prefill 3B {mode} {name} in bf16: from the f32 "
                     f"prefill {off[0]:.3e} (logits) / {off[1]:.3e} (K/V), "
                     f"no farther than x 1.25 the bf16 prefill's "
                     f"{dense_off:.3e} / {dense_kv_off:.3e}; against the "
                     f"bf16 prefill {vs[0]:.3e} / {vs[1]:.3e}; {r['ms']:.2f}"
                     f" ms against prefill's {ref['ms']:.2f} ms")
            res[name] = {"ms": r["ms"], "f32_logits_rel_l2": f32[0],
                         "f32_kv_rel_l2": f32[1],
                         "bf16_vs_f32_prefill": off[0],
                         "bf16_logits_rel_l2_vs_prefill": vs[0],
                         "bf16_kv_rel_l2_vs_prefill": vs[1],
                         "int4_mlp_launches": r["int4_mlp_launches"]}
        if mode == "int4-mlp":
            n = runs["sp_nccl_world1"]["int4_mlp_launches"]
            want = tcfg.num_hidden_layers
            sm.check(n == want and ref["int4_mlp_launches"] == want,
                     f"SP prefill 3B int4-mlp: fused SwiGLU launches {n} in "
                     f"the SP prefill, {ref['int4_mlp_launches']} in "
                     f"prefill (== {want})")
        toks = {}
        for name in ("prefill", "sp_nccl_world1"):
            tokens, _ = gen.decode_loop(
                text, tcfg, gen_cfg, runs[name]["cache"],
                runs[name]["logits"], seq, deltas)
            toks[name] = tokens[0].tolist()
        agree = sum(a == b for a, b in zip(toks["prefill"],
                                           toks["sp_nccl_world1"]))
        res["decode_tokens_agree"] = agree
        sm.log(f"SP prefill 3B {mode}: 32 greedy tokens from the SP cache "
               f"through the decode graphs agree with those from the dense "
               f"cache in {agree} of 32")
        out[mode] = res
    return out


def phase_dryrun(sm):
    """Phase 32: parallel/dryrun.py at world = the visible cards on NCCL
    (the tiny suite and one 3B grounding request TP-sharded over
    (1, world), decode graphs included)."""
    world = torch.cuda.device_count()
    path = "build/dryrun.json"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "vlm_fo1_tpu_torch.parallel.dryrun",
         "--world", str(world), "--grounding-3b", "--json", path],
        capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        sm.log(f"dryrun: {line}")
    ok = proc.returncode == 0
    sm.check(ok, f"multi-chip suite at world {world} (NCCL, "
             f"{'one rank: size-1 groups' if world == 1 else 'multi-rank'})"
             f": exit {proc.returncode} in {secs:.1f} s"
             + ("" if ok else f"\n{proc.stderr[-3000:]}"))
    if not ok:
        return {"world": world, "ok": False}
    with open(path) as f:
        res = json.load(f)
    g = res["grounding_3b"]
    sm.log(f"multi-chip suite: world size {res['world']}, mesh "
           f"{res['mesh']}, 3B TP over (1, {g['model_axis']}): prefill "
           f"logits relative L2 {g['logits_rel_l2']:.3e} against dense, "
           f"greedy tokens that agree with dense in four runs "
           f"({', '.join(g['decode'])}) {g['tokens_agree']} of "
           f"{g['tokens']}, flash launches {g['flash_launches']}, stages "
           f"{g['stage_ms']}")
    return {"world": res["world"], "seconds": secs, **res}


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the evaluation runners' fabricated records")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from vlm_fo1_tpu_torch import native
    from vlm_fo1_tpu_torch.config import FO1Config
    from vlm_fo1_tpu_torch.evaluation import coco_map, runners
    from vlm_fo1_tpu_torch.models import hfre, projector
    from vlm_fo1_tpu_torch import quant
    from vlm_fo1_tpu_torch.models.fo1 import FO1Model
    from vlm_fo1_tpu_torch.ops import cuda_lib, msda
    from vlm_fo1_tpu_torch.ops import decode_attention as da
    from vlm_fo1_tpu_torch.ops import flash_attention as fa
    from vlm_fo1_tpu_torch.ops import int4_matmul as i4
    from vlm_fo1_tpu_torch.ops import int4_mlp as i4mlp
    from vlm_fo1_tpu_torch.ops import int4_unpack as iu
    from vlm_fo1_tpu_torch.ops import matmul_floor as mf
    from vlm_fo1_tpu_torch.ops import msda_dma as md
    from vlm_fo1_tpu_torch.ops import msda_micro as mm
    from vlm_fo1_tpu_torch.postprocess import extract_predictions_to_bboxes
    from vlm_fo1_tpu_torch.preprocess import image as pim
    from vlm_fo1_tpu_torch.preprocess.windowing import build_vit_plan
    from vlm_fo1_tpu_torch.runtime import generate as gen
    from vlm_fo1_tpu_torch.runtime import flops, serving
    from vlm_fo1_tpu_torch.runtime.fallback_tokenizer import (
        FallbackTokenizer,
    )
    from vlm_fo1_tpu_torch.task_templates import OD_template
    from vlm_fo1_tpu_torch.training import train_step as train
    from vlm_fo1_tpu_torch.upn import wrapper as upn_mod

    sm = Smoke(_card())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # phase 0: environment
    sm.log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
           f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}"
           f", {torch.cuda.device_count()} visible")
    import PIL
    sm.log(f"Pillow {PIL.__version__} imports")

    # phase 1: build the ten kernels, one nvcc each, started together
    t0 = time.perf_counter()
    build_s = cuda_lib.build(["flash_attention", "decode_attention", "msda",
                              "msda_bwd",
                              "int4_matmul", "int4_mlp", "int4_unpack_bench",
                              "msda_dma_bench", "msda_micro_bench",
                              "matmul_floor_bench"])
    sm.log("built in parallel: " + ", ".join(
        f"{n}.cu {s:.2f} s" for n, s in build_s.items())
        + f"; {time.perf_counter() - t0:.2f} s in all")
    t0 = time.perf_counter()
    sm.check(native.build() and native.get_lib() is not None,
             f"built {native.library()} with g++ in "
             f"{time.perf_counter() - t0:.2f} s (the native prepare path)")

    # phases 2-3: kernels vs their plain versions
    flash_err, flash_times = phase_flash(sm, fa, build_vit_plan,
                                         FO1Config().vision)
    # phase 27: the flash kernel at the 8-frame video's ViT shape
    flash_video = phase_flash_video(sm, fa, build_vit_plan,
                                    FO1Config().vision)
    torch.cuda.empty_cache()
    msda_err = phase_msda(sm, msda)

    # phases 4-5: tiny f32, card vs cpu
    phase_tiny_fo1(sm, FO1Model, FO1Config, FallbackTokenizer, OD_template)
    phase_tiny_upn(sm, upn_mod, msda)
    # phase 22: tiny batched / serving / continuous / UPN -> FO1, card vs
    # CPU, graph vs eager
    phase_tiny_serving(sm, FO1Model, FO1Config, FallbackTokenizer,
                       OD_template, upn_mod, msda, serving)

    # phases 6-8: full width
    fo1, flash_launches, flash_per_request = phase_fo1(
        sm, FO1Model, FO1Config, FallbackTokenizer, OD_template, fa,
        extract_predictions_to_bboxes)
    upn, msda_launches, msda_per_request, msda_times, msda_real_err, \
        msda_inputs = phase_upn(sm, upn_mod, msda)
    path_launches = phase_upn_fo1(sm, upn, fo1, fa, msda, OD_template,
                                  extract_predictions_to_bboxes)
    # phase 23: batched generation and the three pipelines at full width
    serve, serve_launches, flash_b8 = phase_serving_3b(
        sm, fo1, upn, fa, msda, gen, serving, OD_template)
    sm.log("3B bf16 serving: " + json.dumps(serve))
    # phase 33: the decode step's attention kernel, and its launches in a
    # captured chunk program of the 3B model
    decode_att = phase_decode_attention(sm, da, gen, fo1)
    sm.log("decode attention: " + json.dumps(decode_att))
    # phase 26: multi-image and video prompts, a mixed batch, TFLOP/s
    multimodal = phase_multimodal_3b(sm, fo1, fa, OD_template, flops)
    sm.log("3B multimodal: " + json.dumps(multimodal))
    # phase 28: the HFRE variants and projectors, card vs CPU in f32
    phase_hfre_variants(sm, fo1, OD_template, hfre, projector)
    # phase 29: the evaluation runners on fabricated records
    evals = phase_eval_runners(sm, fo1, runners, coco_map, args.seed)
    sm.log("evaluation runners: " + json.dumps(evals))
    # phase 30: the demo request's prepare on the native C++ path
    native_prep = phase_native_prepare(sm, fo1, native, pim, OD_template)
    # phase 31: sequence-parallel prefill at full width (last on the
    # phase-6 model: its int4-mlp half quantizes the trunk's MLPs)
    sp_prefill = phase_sp_prefill(sm, fo1, gen, quant, fa, i4mlp,
                                  OD_template)
    sm.log("3B SP prefill: " + json.dumps(sp_prefill))
    del fo1, upn
    torch.cuda.empty_cache()
    # phase 32: the multi-chip suite at world = the visible cards
    dryrun = phase_dryrun(sm)

    # phases 9-12: the quantized serving modes
    i4_err, i4_times = phase_int4_matmul(sm, quant, i4)
    mlp_err, mlp_times = phase_int4_mlp(sm, quant, i4mlp)
    # phase 24: the int4 streaming route replayed from a CUDA graph
    i4_graph = phase_int4_graph(sm, quant, i4, i4mlp)
    # phase 18: the int4 unpack microbenchmark, and phases 19-21: the MSDA
    # microbenchmarks (here, where torch.profiler still records the card:
    # later in the run it recorded no device activity)
    unpack = phase_int4_unpack(sm, iu)
    dma = phase_msda_dma(sm, md)
    micro = phase_msda_micro(sm, mm)
    floor = phase_matmul_floor(sm, mf)
    phase_tiny_quant(sm, FO1Model, FO1Config, FallbackTokenizer, OD_template,
                     quant, i4, i4mlp)
    quant_runs = {}
    for mode, n_req in (("int4", 2), ("int4-mlp", 2), ("int8-all", 1),
                        ("w8a8", 1)):
        quant_runs[mode] = phase_quant_fo1(
            sm, FO1Model, FO1Config, FallbackTokenizer, OD_template, quant,
            fa, i4, i4mlp, extract_predictions_to_bboxes, mode, n_req)
    # phase 25: int4 and int4-mlp batches of 8, decode from graphs
    qserve, qlaunches = phase_quant_serving(
        sm, FO1Model, FO1Config, FallbackTokenizer, OD_template, quant, i4,
        i4mlp, gen)
    sm.log("3B int4 serving: " + json.dumps(qserve))

    # phases 13-17: training (the earlier models are freed)
    bwd_err, bwd_times = phase_msda_bwd(sm, msda, msda_inputs)
    del msda_inputs
    torch.cuda.empty_cache()
    phase_tiny_upn_grad(sm, upn_mod, msda)
    bwd_launches, upn_grad_runs = phase_upn_grad(sm, upn_mod, msda)
    phase_tiny_train(sm, FO1Model, FO1Config, FallbackTokenizer, OD_template,
                     train)
    train_runs, train_paths, train_flash = phase_fo1_train(
        sm, FO1Model, FO1Config, FallbackTokenizer, OD_template, train, fa,
        msda)
    sm.log("FO1 training per step: " + json.dumps(train_runs))

    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "vlm_fo1_tpu"))
    sm.check(not bad, f"the port ran without importing jax or vlm_fo1_tpu "
             f"({bad[:5]})")
    sm.log(f"smoke took {time.perf_counter() - t_start:.1f} s after start")

    if sm.failures:
        print(f"chip_smoke: {len(sm.failures)} check(s) failed",
              file=sys.stderr)
        return 1
    vit, enc = flash_times["vit_full"], msda_times["encoder"]
    print(sm.card)
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "vlm_fo1_tpu_torch/csrc/flash_attention.cu",
        "replaces": "vlm_fo1_tpu/ops/flash_attention.py:104",
        "launches": flash_launches, "max_abs_err": flash_err,
        "ms": vit["ms"], "plain_ms": vit["plain_ms"],
        "bound_ms": vit["bound_ms"], "bound_by": vit["bound_by"],
        "library_ms": vit["library_ms"],
        **{n: vit[n] for n in ("shape", "row_rel", "faults", "eager_ms",
                               "tflops", "bound_share")},
        "prefill": flash_times["prefill"],
        "launches_per_request": flash_per_request,
        "launches_upn_fo1_path": path_launches["flash_attention"],
        "launches_3b_train_steps": train_flash,
        "train_loss_backward_vs_plain": train_paths,
        "launches_serving_path": {
            w: c["flash_attention"] for w, c in serve_launches.items()},
        "batched_prefill_b8": flash_b8,
        "video": flash_video,
        "launches_multimodal": {
            k: multimodal[k]["flash_launches"]
            for k in ("two_images", "video", "mixed_batch")},
        "launches_tp_path": {
            "world": dryrun.get("world"),
            "grounding_3b": dryrun.get("grounding_3b", {}).get(
                "flash_launches")},
    }, {
        "name": "decode_attention", "route": "cuda",
        "source": "vlm_fo1_tpu_torch/csrc/decode_attention.cu",
        "replaces": None, **decode_att,
    }, {
        "name": "ms_deform_attn_core", "route": "cuda",
        "source": "vlm_fo1_tpu_torch/csrc/msda.cu",
        "replaces": "vlm_fo1_tpu/ops/msda_pallas.py:495",
        "launches": msda_launches,
        "max_abs_err": max(msda_err, msda_real_err),
        "ms": enc["ms"], "plain_ms": enc["plain_ms"],
        "bound_ms": enc["bound_ms"], "bound_by": enc["bound_by"],
        "library_ms": None,
        "decoder": msda_times["decoder"],
        "launches_per_request": msda_per_request,
        "launches_upn_fo1_path": path_launches["ms_deform_attn_core"],
        "launches_serving_path": {
            w: c["ms_deform_attn_core"] for w, c in serve_launches.items()},
    }, {
        "name": "int4_matmul", "route": "cuda",
        "source": "vlm_fo1_tpu_torch/csrc/int4_matmul.cu",
        "replaces": "vlm_fo1_tpu/ops/int4_matmul.py:60",
        "launches": quant_runs["int4"][0]["int4_matmul"],
        "max_abs_err": i4_err, "shape": "gate_up 2048->11008 M=1 bf16",
        **i4_times["gate_up M=1"],
        "shapes": i4_times,
        "launches_per_request": quant_runs["int4"][1],
        "launches_serving_path": qlaunches["int4_matmul"],
        "graph_bit_equal_m1_to_8": i4_graph["int4_matmul"],
        "kernels_per_call": i4_graph["kernels_per_call"],
        "stream_plans": {"/".join(map(str, k[0])): v
                         for k, v in i4._PLANS.items()},
        "serving": qserve["int4"],
    }, {
        "name": "int4_mlp", "route": "cuda",
        "source": "vlm_fo1_tpu_torch/csrc/int4_mlp.cu",
        "replaces": "vlm_fo1_tpu/ops/int4_mlp.py:84",
        "launches": quant_runs["int4-mlp"][0]["int4_mlp"],
        "max_abs_err": mlp_err, "shape": "D=2048 I=11008 M=1 bf16",
        **mlp_times["M=1"],
        "shapes": mlp_times,
        "launches_per_request": quant_runs["int4-mlp"][1],
        "launches_serving_path": qlaunches["int4_mlp"],
        "graph_bit_equal_m1_to_8": i4_graph["int4_mlp"],
        "serving": qserve["int4-mlp"],
        "launches_sp_prefill": sp_prefill["int4-mlp"]["sp_nccl_world1"][
            "int4_mlp_launches"],
        "sp_prefill_ms": {k: sp_prefill["int4-mlp"][k]["ms"]
                          for k in ("sp_nccl_world1", "sp_local_ring4")},
        "prefill_ms": sp_prefill["int4-mlp"]["prefill_ms"],
    }, {
        "name": "msda_backward", "route": "cuda",
        "source": "vlm_fo1_tpu_torch/csrc/msda_bwd.cu",
        "replaces": "vlm_fo1_tpu/ops/msda_pallas_bwd.py:219",
        "launches": bwd_launches, "max_abs_err": bwd_err,
        "shape": "encoder Lq=S=85932 bf16", **bwd_times["encoder"],
        "decoder": bwd_times["decoder"],
        "upn_forward_backward": upn_grad_runs,
    }, {
        "name": "int4_unpack_bench", "route": "cuda",
        "source": "vlm_fo1_tpu_torch/csrc/int4_unpack_bench.cu",
        "replaces": "tools/xp_int4_unpack.py:84",
        "shape": "x [8, 2048] bf16, gate and up packed [1024, 11008] int8, "
                 "tiles of 256, strategy magic",
        **unpack,
    }, {
        "name": "msda_dma_bench", "route": "cuda",
        "source": "vlm_fo1_tpu_torch/csrc/msda_dma_bench.cu",
        "replaces": "tools/xp_msda_dma.py:56", **dma,
    }, {
        "name": "msda_micro_bench", "route": "cuda",
        "source": "vlm_fo1_tpu_torch/csrc/msda_micro_bench.cu",
        "replaces": "tools/xp_msda_micro.py:44", **micro,
    }, {
        "name": "matmul_floor_bench", "route": "cuda",
        "source": "vlm_fo1_tpu_torch/csrc/matmul_floor_bench.cu",
        "replaces": "tools/xp_matmul_floor.py:47", **floor,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
