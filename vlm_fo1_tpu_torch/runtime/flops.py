"""Analytic FLOP counts for per-stage TFLOP/s and model-FLOPs utilisation
(counterpart of `vlm_fo1_tpu/runtime/flops.py`, the same counts).

A multiply-accumulate counts as 2 FLOPs. The counts cover the
matmul-shaped work (projections, attention score and value products,
convolutions); norms, rotary, softmax and elementwise activations are left
out (a few percent at these shapes). Modelled workload: the FO1 request
(ViT + DaViT + HFRE encode, multimodal prefill, greedy decode) and UPN
proposal generation.

The default peak is NVIDIA's published dense bf16 tensor-core rate of one
H100 SXM at its 700 W limit. A card set to a lower power limit runs slower
under load: state the limit beside any utilisation computed against it.
"""

from __future__ import annotations

from dataclasses import dataclass

H100_BF16_PEAK = 989e12  # FLOP/s, H100 SXM, dense (NVIDIA's data sheet)


def _mm(m, k, n):
    """FLOPs of an [m,k] @ [k,n] matmul."""
    return 2.0 * m * k * n


# ------------------------------------------------------------------ FO1

def vit_encode_flops(cfg, grid_h: int, grid_w: int) -> float:
    """Qwen2.5-VL ViT forward for one image of grid_h x grid_w patches
    (pre-merge), window/full attention alternation per
    fullatt_block_indexes (models/vit.py; reference
    modeling_qwen2_5_vl.py:465-551)."""
    s = grid_h * grid_w
    d = cfg.hidden_size
    i = cfg.intermediate_size
    total = _mm(s, cfg.patch_dim, d)                      # patch embed
    win = cfg.window_patches ** 2                         # 64 tokens/window
    for blk in range(cfg.depth):
        full = blk in cfg.fullatt_block_indexes
        l_att = s if full else win
        total += _mm(s, d, 3 * d)                         # qkv
        total += 2 * _mm(s, d // cfg.num_heads,
                         l_att) * cfg.num_heads           # qk^T + av
        total += _mm(s, d, d)                             # out proj
        total += 3 * _mm(s, d, i)                         # gate/up/down
    # 2x2 merger MLP: [s/4, 4d] -> [4d] -> out_hidden
    sm = s // cfg.spatial_merge_unit
    total += _mm(sm, 4 * d, 4 * d) + _mm(sm, 4 * d, cfg.out_hidden_size)
    return total


def projector_flops(cfg, n_tokens: int) -> float:
    """mlp2x_gelu image projector: mm_hidden -> text -> text."""
    d_in, d_out = cfg.mm_hidden_size, cfg.text.hidden_size
    return _mm(n_tokens, d_in, d_out) + _mm(n_tokens, d_out, d_out)


def davit_flops(cfg, image_size: int | None = None) -> float:
    """DaViT forward at the fixed aux squash size (768^2 default)."""
    hw = image_size or 768
    total = 0.0
    h = w = hw
    in_ch = cfg.in_channels
    for i in range(cfg.num_stages):
        h //= cfg.patch_stride[i]
        w //= cfg.patch_stride[i]
        c = cfg.embed_dims[i]
        n = h * w
        total += _mm(n, in_ch * cfg.patch_size[i] ** 2, c)   # conv embed
        mlp_h = int(c * cfg.mlp_ratio)
        ws = cfg.window_size
        # spatial attention runs window-padded (qkv through proj), the rest
        # unpadded (models/davit.py _window_attention pads after the norm)
        np_ = (-(-h // ws) * ws) * (-(-w // ws) * ws)
        for _ in range(cfg.depths[i]):
            # spatial block: 2 dw convs + window attn + ffn
            wt = ws ** 2
            total += 2 * (n * c * 9 * 2)                     # depthwise 3x3
            total += _mm(np_, c, 3 * c) + _mm(np_, c, c)
            total += 2 * _mm(np_, c // cfg.num_heads[i],
                             wt) * cfg.num_heads[i]
            total += _mm(n, c, mlp_h) + _mm(n, mlp_h, c)
            # channel block: 2 dw convs + channel-group attn + ffn
            gd = c // cfg.num_groups[i]
            total += 2 * (n * c * 9 * 2)
            total += _mm(n, c, 3 * c) + _mm(n, c, c)
            total += 2 * _mm(gd, n, gd) * cfg.num_groups[i]  # c^T c + attn v
            total += _mm(n, c, mlp_h) + _mm(n, mlp_h, c)
        in_ch = c
    return total


def hfre_flops(cfg, n_boxes: int, grid_h: int, grid_w: int) -> float:
    """Region path: ROI pooling is gather-bound (negligible FLOPs); the
    arithmetic is the aux upsample-concat interpolation and the
    mm_projector_aux MLP on [n_boxes, region_hidden]."""
    # bilinear upsample of stages 2-4 to stage-1 size (768/4)^2: ~8 FLOPs
    # per output element per channel
    up = 8.0 * (192 * 192) * sum([512, 1024, 2048])
    proj = (_mm(n_boxes, cfg.mm_region_hidden_size, cfg.text.hidden_size)
            + _mm(n_boxes, cfg.text.hidden_size, cfg.text.hidden_size))
    return up + proj


def encode_flops(cfg, grid_h: int, grid_w: int, n_boxes: int) -> float:
    """Everything under the `encode` stage for ONE image."""
    merged = (grid_h * grid_w) // cfg.vision.spatial_merge_unit
    return (vit_encode_flops(cfg.vision, grid_h, grid_w)
            + projector_flops(cfg, merged)
            + davit_flops(cfg.davit, cfg.aux_image_size)
            + hfre_flops(cfg, n_boxes, grid_h, grid_w))


def prefill_flops(t, seq_len: int) -> float:
    """Causal trunk prefill over seq_len tokens + one lm_head row.
    `t` is a TextConfig."""
    d = t.hidden_size
    q_dim = t.num_attention_heads * t.head_dim
    kv_dim = t.num_key_value_heads * t.head_dim
    per_layer = (_mm(seq_len, d, q_dim + 2 * kv_dim)       # qkv
                 # dense-with-causal-mask attention, as executed (s^2 keys
                 # per query; the mask zeroes, it doesn't skip)
                 + 2 * 2.0 * t.num_attention_heads * t.head_dim
                 * (seq_len * seq_len)
                 + _mm(seq_len, q_dim, d)                  # o
                 + 3 * _mm(seq_len, d, t.intermediate_size))
    return (t.num_hidden_layers * per_layer
            + _mm(1, d, t.vocab_size))


def decode_flops(t, n_tokens: int, context_len: int) -> float:
    """Greedy decode of n_tokens for ONE sequence with a cache that starts
    at context_len (attention cost grows linearly per step). `t` is a
    TextConfig."""
    d = t.hidden_size
    q_dim = t.num_attention_heads * t.head_dim
    kv_dim = t.num_key_value_heads * t.head_dim
    proj = (_mm(1, d, q_dim + 2 * kv_dim) + _mm(1, q_dim, d)
            + 3 * _mm(1, d, t.intermediate_size)) * t.num_hidden_layers
    head = _mm(1, d, t.vocab_size)
    total = 0.0
    for step in range(n_tokens):
        l = context_len + step
        attn = (2 * 2.0 * t.num_attention_heads * t.head_dim * l
                * t.num_hidden_layers)
        total += proj + attn + head
    return total


# ------------------------------------------------------------------ UPN

def swin_flops(cfg, h: int, w: int) -> float:
    """Swin backbone forward at padded input h x w."""
    total = 0.0
    gh, gw = h // cfg.patch_size, w // cfg.patch_size
    total += _mm(gh * gw, cfg.in_channels * cfg.patch_size ** 2,
                 cfg.embed_dim)
    for i, depth in enumerate(cfg.depths):
        c = cfg.embed_dim * 2 ** i
        ws = cfg.window_size
        # attention (qkv/proj/dots) runs on window-padded maps, the FFN on
        # the unpadded map (upn/swin.py _block; reference pads identically)
        np_ = (-(-gh // ws) * ws) * (-(-gw // ws) * ws)
        n = gh * gw
        wt = ws * ws
        mlp_h = int(c * cfg.mlp_ratio)
        for _ in range(depth):
            total += _mm(np_, c, 3 * c) + _mm(np_, c, c)
            total += 2 * _mm(np_, c // cfg.num_heads[i],
                             wt) * cfg.num_heads[i]
            total += _mm(n, c, mlp_h) + _mm(n, mlp_h, c)
        if i < len(cfg.depths) - 1:
            total += _mm((gh // 2) * (gw // 2), 4 * c, 2 * c)
            gh, gw = gh // 2, gw // 2
    return total


def _level_tokens(h: int, w: int, num_levels: int) -> list[int]:
    toks = []
    gh, gw = h // 4, w // 4
    for lvl in range(num_levels):
        toks.append(gh * gw)
        gh, gw = -(-gh // 2), -(-gw // 2)
    return toks


def msda_flops(d: int, n_heads: int, n_levels: int, n_points: int,
               n_query: int, n_value: int) -> float:
    """One MSDeformAttn call: projections + per-sample bilinear gathers
    (4 taps x MAC each) + weighted reduce (ops/msda.py)."""
    hd = d // n_heads
    samp = n_heads * n_levels * n_points
    return (_mm(n_value, d, d)                 # value proj
            + _mm(n_query, d, samp * 3)        # offsets + weights
            + n_query * samp * hd * (4 * 2 + 2)  # bilinear + weight-sum
            + _mm(n_query, d, d))              # output proj


def upn_flops(cfg, swin_cfg, h: int, w: int) -> float:
    """Full UPN proposal forward at padded input h x w (upn/model.py)."""
    total = swin_flops(swin_cfg, h, w)
    toks = _level_tokens(h, w, cfg.num_feature_levels)
    s = sum(toks)
    d = cfg.d_model
    # input projections (1x1 convs; extra levels are 3x3 s2)
    for lvl, n in enumerate(toks):
        in_c = (swin_cfg.num_features[lvl]
                if lvl < len(swin_cfg.num_features)
                else (swin_cfg.num_features[-1]
                      if lvl == len(swin_cfg.num_features) else d))
        k2 = 1 if lvl < len(swin_cfg.num_features) else 9
        total += _mm(n, in_c * k2, d)
    for _ in range(cfg.num_encoder_layers):
        total += msda_flops(d, cfg.n_heads, cfg.num_feature_levels,
                            cfg.n_points, s, s)
        total += _mm(s, d, cfg.d_ffn) + _mm(s, cfg.d_ffn, d)
    # two-stage: enc_output + enc bbox head + contrastive score
    total += _mm(s, d, d) + 3 * _mm(s, d, d) + _mm(s, d, 1)
    nq = cfg.num_queries
    for _ in range(cfg.num_decoder_layers):
        total += _mm(nq, 2 * d, d) + _mm(nq, d, d)        # ref_point_head
        total += _mm(nq, d, 3 * d) + _mm(nq, d, d)        # self-attn proj
        total += 2 * _mm(nq, d // cfg.n_heads, nq) * cfg.n_heads
        total += msda_flops(d, cfg.n_heads, cfg.num_feature_levels,
                            cfg.n_points, nq, s)
        total += _mm(nq, d, cfg.d_ffn) + _mm(nq, cfg.d_ffn, d)
        total += 3 * _mm(nq, d, d)                        # bbox refine MLP
    total += 3 * _mm(nq, d, d) + _mm(nq, d, 1)            # final heads
    return total


# ------------------------------------------------------------------ report

@dataclass
class StageMFU:
    flops: float
    seconds: float

    @property
    def tflop_s(self) -> float:
        return self.flops / self.seconds / 1e12 if self.seconds > 0 else 0.0

    def mfu(self, peak: float = H100_BF16_PEAK) -> float:
        return self.flops / self.seconds / peak if self.seconds > 0 else 0.0


def mfu_report(stages: dict[str, tuple[float, float]],
               peak: float = H100_BF16_PEAK) -> dict:
    """stages: {name: (flops, seconds)} -> JSON-able MFU summary."""
    out = {}
    tot_f = tot_s = 0.0
    for name, (flops, secs) in stages.items():
        m = StageMFU(flops, secs)
        out[name] = {"gflops": round(flops / 1e9, 1),
                     "s": round(secs, 4),
                     "tflop_s": round(m.tflop_s, 2),
                     "mfu": round(m.mfu(peak), 4)}
        tot_f += flops
        tot_s += secs
    if tot_s > 0:
        m = StageMFU(tot_f, tot_s)
        out["total"] = {"gflops": round(tot_f / 1e9, 1),
                        "s": round(tot_s, 4),
                        "tflop_s": round(m.tflop_s, 2),
                        "mfu": round(m.mfu(peak), 4)}
    out["peak_tflop_s"] = peak / 1e12
    return out
