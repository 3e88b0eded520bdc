"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  0. environment: torch / CUDA versions, the card, Pillow;
  1. build the five CUDA kernels from the checkout's sources, one nvcc
     each, started together;
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
     of the demo image, with kernel and plain times beside the bound;
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
     kernel timed on that request's own encoder and decoder inputs;
  8. UPN -> FO1: the first 100 proposals after filter(min_score=0,
     nms=0.8) go into one 3B grounding request (the phase-6 model); both
     kernels' launches counted over this path;
  9. the int4 matmul vs its plain version: odd small shapes (M in
     {1, 5, 9, 128}, N off every tile) in f32 with TF32 off (<= 2e-5 x
     max(1, max|plain|)) and bf16 (<= 2e-2 x the same), then the 3B trunk
     shapes (q/o 2048->2048, k/v 2048->256, gate/up 2048->11008, down
     11008->2048) at M = 1 and M = 1771, with kernel, plain and F.linear
     (pre-dequantized bf16 weight) device times from CUDA graph replays
     beside the bound, and the kernel's eager per-call time; at M = 1 the
     weights rotate through copies larger than the L2 cache, as decode
     finds them;
 10. the fused int4 SwiGLU vs its plain version the same way: the shapes of
     tests/test_quant.py, then D = 2048, I = 11008 at M = 1 and 1771, two
     runs bit-equal, kernel / plain / three-F.linear times;
 11. FO1Config.tiny() f32 (untied head) in the int4 mode, and with I = 128
     in the int4-mlp mode: greedy tokens on the card (kernels) equal those
     on the CPU (plain versions), the same quantized bytes on both;
 12. FO1Config() bf16 in the int4, int4-mlp, int8-all and w8a8 modes
     (`quant.quantize_model` on fresh random weights): grounding requests
     with the 7 demo boxes and 32 tokens, stage times, quantized bytes,
     peak memory and kernel launches per request; in the int4 and int4-mlp
     modes the first request's region tokens and prefill logits compared
     between the kernel path and the plain path;
 13. the MSDA backward vs its plain version (autograd of the plain core):
     D in {8, 32} at small levels with out-of-range locations, then phase
     7's encoder (Lq = S = 85,932) and decoder (Lq = 900) inputs with a
     seeded upstream gradient, f32 (TF32 off) and bf16, each of the three
     gradients held to 1e-4 x max(1, max|plain|) (grad_value in bf16 to
     2e-2 x the same); kernel, plain and bound times;
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
     seeded batch, loss, ms and peak memory per step.
Findings go to stdout, each line tagged with the card's name and power
limit; the line before the last is the kernels' JSON summary and the last
line is the result JSON.
"""

import dataclasses
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


def _msda_compare(sm, msda, name, value, shapes, loc, aw):
    out = msda.ms_deform_attn_core(value, shapes, loc, aw)
    torch.cuda.synchronize()
    ref = msda.ms_deform_attn_core_reference(value.float(), shapes, loc, aw)
    err = (out - ref).abs().max().item()
    tol = F32_TOL if value.dtype == torch.float32 else BF16_TOL
    sm.check(bool(torch.isfinite(out).all()) and err <= tol,
             f"msda {name} {str(value.dtype)[6:]} value={tuple(value.shape)}"
             f" Lq={loc.shape[1]} max_abs_err={err:.3e} (tol {tol:g})")
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
                                      inp[0], shapes, *inp[1:]))
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
        bound = PATH_REL_TOL * max(1.0, ref.abs().max().item())
        sm.check(err <= bound, f"FO1 kernel path vs plain path, {what}: "
                 f"max_abs_err={err:.3e} (bound {bound:.3e} = "
                 f"{PATH_REL_TOL:g} x max(1, max|plain|))")
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
                                  value, shapes, loc, aw))
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


def _both_dtypes(sm, what, kernel, plain, x, repeat=False):
    """The kernel on x in f32 (TF32 off) and bf16 against the plain version
    on the same values in f32; optionally two kernel runs bit-equal."""
    errs = []
    for dtype, tol in ((torch.float32, INT4_F32_TOL),
                       (torch.bfloat16, BF16_TOL)):
        xd = x.to(dtype)
        got = kernel(xd)
        again = kernel(xd) if repeat else got
        torch.cuda.synchronize()
        errs.append(_rel_check(sm, f"{what} {str(dtype)[6:]}", got,
                               plain(xd.float()), tol))
        if repeat:
            sm.check(torch.equal(got, again),
                     f"{what} {str(dtype)[6:]}: two runs bit-equal")
    return max(errs)


def phase_int4_matmul(sm, quant, i4):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(4)

    def weight(n, k):
        return quant.quantize_weight_int4(
            torch.randn(n, k, device="cuda", generator=gen) * 0.02)

    errs = []
    for m, k, n in ((1, 32, 24), (5, 64, 130), (9, 3420, 200),
                    (128, 96, 4100), (5, 2048, 300), (77, 256, 130)):
        packed, scale = weight(n, k)
        x = torch.randn(m, k, device="cuda", generator=gen)
        errs.append(_both_dtypes(
            sm, f"int4_matmul M={m} K={k} N={n}",
            lambda xd: i4.int4_matmul(xd, packed, scale),
            lambda xf: i4.int4_matmul_reference(xf, packed, scale), x))
    times = {}
    for name, k, n in TRUNK_LINEARS:
        packed, scale = weight(n, k)
        w_deq = (quant.unpack_int4(packed).float() * scale).t() \
            .to(torch.bfloat16).contiguous()                     # [n, k]
        for m in (1, PREFILL_ROWS):
            x = torch.randn(m, k, device="cuda", generator=gen)
            errs.append(_both_dtypes(
                sm, f"int4_matmul {name} M={m} K={k} N={n}",
                lambda xd: i4.int4_matmul(xd, packed, scale),
                lambda xf: i4.int4_matmul_reference(xf, packed, scale), x,
                repeat=True))
            xb = x.to(torch.bfloat16)
            cold = m == 1
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
                "eager_ms": eager_ms}
            sm.log(f"time int4_matmul {name} {k}->{n} M={m} bf16: kernel "
                   f"{ms:.4f} ms (eager calls {eager_ms:.4f} ms), plain "
                   f"{plain_ms:.4f} ms, F.linear on the dequantized bf16 "
                   f"weight {lib_ms:.4f} ms, bound {bound_ms:.4f} ms by "
                   f"{bound_by} ({nbytes / 1e6:.2f} MB, "
                   f"{2 * m * k * n / 1e9:.2f} GFLOP; CUDA events over CUDA "
                   f"graph replays{', weights cold' if cold else ''})")
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


def phase_int4_mlp(sm, quant, i4mlp):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(5)
    errs, times = [], {}
    for m, d, i in ((1, 64, 256), (5, 256, 768), (16, 128, 128),
                    (200, 128, 256), (300, 64, 128), (8, 48, 128)):
        node = _mlp_node(quant, gen, d, i)
        x = torch.randn(m, d, device="cuda", generator=gen)
        errs.append(_both_dtypes(
            sm, f"int4_mlp M={m} D={d} I={i}",
            lambda xd: i4mlp.int4_mlp(xd, node),
            lambda xf: i4mlp.int4_mlp_reference(xf, node), x, repeat=True))
    d, i = 2048, 11008
    node = _mlp_node(quant, gen, d, i)
    lo, hi = quant.unpack_int4_halves(node["down_pk"])
    lib_w = [(quant.unpack_int4(node[k]).float() * node[s]).t()
             .to(torch.bfloat16).contiguous()
             for k, s in (("gate_pk", "gate_s"), ("up_pk", "up_s"))]
    lib_w.append((torch.cat([lo, hi], -1).float() * node["down_s"]).t()
                 .to(torch.bfloat16).contiguous())               # [D, I]
    node_bytes = sum(t.numel() * t.element_size() for t in node.values())
    for m in (1, PREFILL_ROWS):
        x = torch.randn(m, d, device="cuda", generator=gen)
        errs.append(_both_dtypes(
            sm, f"int4_mlp D={d} I={i} M={m}",
            lambda xd: i4mlp.int4_mlp(xd, node),
            lambda xf: i4mlp.int4_mlp_reference(xf, node), x, repeat=True))
        xb = x.to(torch.bfloat16)
        cold = m == 1
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
                           "bound_by": bound_by, "eager_ms": eager_ms}
        sm.log(f"time int4_mlp D={d} I={i} M={m} bf16: kernel {ms:.4f} ms "
               f"(eager calls {eager_ms:.4f} ms), plain {plain_ms:.4f} ms, "
               f"three F.linear + silu on the dequantized bf16 weights "
               f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
               f"({nbytes / 1e6:.2f} MB, {flops / 1e9:.1f} GFLOP; CUDA "
               f"events over CUDA graph replays"
               f"{', weights cold' if cold else ''})")
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
    """FO1Config() bf16 in one serving mode on fresh random weights."""
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
    i4.int4_matmul.launches = 0
    i4mlp.int4_mlp.launches = 0
    per_request = []
    for i, m in enumerate(msgs):
        before = (i4.int4_matmul.launches, i4mlp.int4_mlp.launches)
        stage = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = model.generate(m, max_new_tokens=32, stage_ms=stage)
        total_ms = (time.perf_counter() - t0) * 1e3
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        n = (i4.int4_matmul.launches - before[0],
             i4mlp.int4_mlp.launches - before[1])
        per_request.append({"int4_matmul": n[0], "int4_mlp": n[1],
                            "forwards": res.num_steps})
        sm.log(f"FO1 {mode} request {i}: prompt {res.prompt_len} tokens, "
               f"prepare {stage['prepare']:.1f} ms, encode "
               f"{stage['encode']:.1f} ms, prefill {stage['prefill']:.1f} ms,"
               f" decode {stage['decode']:.1f} ms ({res.num_steps} tokens), "
               f"total {total_ms:.1f} ms, peak memory {peak_gb:.2f} GiB, "
               f"launches int4_matmul {n[0]} ({n[0] / res.num_steps:.1f} per "
               f"forward), int4_mlp {n[1]} ({n[1] / res.num_steps:.1f} per "
               f"forward), parsed boxes {extract(res.text, DEMO_BOXES)}")
        want = {"int4": n[0] > 0, "int4-mlp": n[1] > 0}.get(mode, True)
        sm.check(want and bool(np.isfinite(res.prefill_logits).all()),
                 f"FO1 {mode} request {i}: finite prefill logits, kernel "
                 f"launches {n}")
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


def _msda_bwd_compare(sm, msda, name, value, shapes, loc, aw, g):
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
                                      value.to(dt), shapes, loc, aw, g)
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from vlm_fo1_tpu_torch.config import FO1Config
    from vlm_fo1_tpu_torch import quant
    from vlm_fo1_tpu_torch.models.fo1 import FO1Model
    from vlm_fo1_tpu_torch.ops import cuda_lib, msda
    from vlm_fo1_tpu_torch.ops import flash_attention as fa
    from vlm_fo1_tpu_torch.ops import int4_matmul as i4
    from vlm_fo1_tpu_torch.ops import int4_mlp as i4mlp
    from vlm_fo1_tpu_torch.postprocess import extract_predictions_to_bboxes
    from vlm_fo1_tpu_torch.preprocess.windowing import build_vit_plan
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

    # phase 1: build the five kernels, one nvcc each, started together
    t0 = time.perf_counter()
    build_s = cuda_lib.build(["flash_attention", "msda", "msda_bwd",
                              "int4_matmul", "int4_mlp"])
    sm.log("built in parallel: " + ", ".join(
        f"{n}.cu {s:.2f} s" for n, s in build_s.items())
        + f"; {time.perf_counter() - t0:.2f} s in all")

    # phases 2-3: kernels vs their plain versions
    flash_err, flash_times = phase_flash(sm, fa, build_vit_plan,
                                         FO1Config().vision)
    msda_err = phase_msda(sm, msda)

    # phases 4-5: tiny f32, card vs cpu
    phase_tiny_fo1(sm, FO1Model, FO1Config, FallbackTokenizer, OD_template)
    phase_tiny_upn(sm, upn_mod, msda)

    # phases 6-8: full width
    fo1, flash_launches, flash_per_request = phase_fo1(
        sm, FO1Model, FO1Config, FallbackTokenizer, OD_template, fa,
        extract_predictions_to_bboxes)
    upn, msda_launches, msda_per_request, msda_times, msda_real_err, \
        msda_inputs = phase_upn(sm, upn_mod, msda)
    path_launches = phase_upn_fo1(sm, upn, fo1, fa, msda, OD_template,
                                  extract_predictions_to_bboxes)
    del fo1, upn
    torch.cuda.empty_cache()

    # phases 9-12: the quantized serving modes
    i4_err, i4_times = phase_int4_matmul(sm, quant, i4)
    mlp_err, mlp_times = phase_int4_mlp(sm, quant, i4mlp)
    phase_tiny_quant(sm, FO1Model, FO1Config, FallbackTokenizer, OD_template,
                     quant, i4, i4mlp)
    quant_runs = {}
    for mode, n_req in (("int4", 2), ("int4-mlp", 2), ("int8-all", 1),
                        ("w8a8", 1)):
        quant_runs[mode] = phase_quant_fo1(
            sm, FO1Model, FO1Config, FallbackTokenizer, OD_template, quant,
            fa, i4, i4mlp, extract_predictions_to_bboxes, mode, n_req)

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
    }, {
        "name": "int4_matmul", "route": "cuda",
        "source": "vlm_fo1_tpu_torch/csrc/int4_matmul.cu",
        "replaces": "vlm_fo1_tpu/ops/int4_matmul.py:60",
        "launches": quant_runs["int4"][0]["int4_matmul"],
        "max_abs_err": i4_err, "shape": "gate_up 2048->11008 M=1 bf16",
        **i4_times["gate_up M=1"],
        "shapes": i4_times,
        "launches_per_request": quant_runs["int4"][1],
    }, {
        "name": "int4_mlp", "route": "cuda",
        "source": "vlm_fo1_tpu_torch/csrc/int4_mlp.cu",
        "replaces": "vlm_fo1_tpu/ops/int4_mlp.py:84",
        "launches": quant_runs["int4-mlp"][0]["int4_mlp"],
        "max_abs_err": mlp_err, "shape": "D=2048 I=11008 M=1 bf16",
        **mlp_times["M=1"],
        "shapes": mlp_times,
        "launches_per_request": quant_runs["int4-mlp"][1],
    }, {
        "name": "msda_backward", "route": "cuda",
        "source": "vlm_fo1_tpu_torch/csrc/msda_bwd.cu",
        "replaces": "vlm_fo1_tpu/ops/msda_pallas_bwd.py:219",
        "launches": bwd_launches, "max_abs_err": bwd_err,
        "shape": "encoder Lq=S=85932 bf16", **bwd_times["encoder"],
        "decoder": bwd_times["decoder"],
        "upn_forward_backward": upn_grad_runs,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
