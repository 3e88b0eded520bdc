"""Operations and bytes of an FO1 request and of the kernels the metrics
hold to their rooflines, from the shapes alone: a frozen copy of the
program's `runtime/flops.py` counts, with attention counted as the inputs
need it (causal: a prompt of L tokens takes L(L+1)/2 query-key pairs; the
ViT's full blocks only the real patches), not as a kernel executes it.

A multiply-accumulate counts 2. Norms, rotary, softmax and elementwise
activations are left out (a few percent at these shapes). `cfg` is a
configuration file's dict.
"""

from __future__ import annotations


def _mm(m, k, n):
    return 2.0 * m * k * n


def vit_flops(cfg: dict, gh: int, gw: int) -> float:
    v = cfg["vision_config"]
    s, d, inter = gh * gw, v["hidden_size"], v["intermediate_size"]
    win = (v["window_size"] // v["patch_size"]) ** 2
    patch_dim = 3 * v["temporal_patch_size"] * v["patch_size"] ** 2
    total = _mm(s, patch_dim, d)
    for blk in range(v["depth"]):
        keys = s if blk in v["fullatt_block_indexes"] else win
        total += _mm(s, d, 3 * d) + 2 * _mm(s, d, keys) + _mm(s, d, d)
        total += 3 * _mm(s, d, inter)
    sm = s // v["spatial_merge_size"] ** 2
    merged = d * v["spatial_merge_size"] ** 2
    return total + _mm(sm, merged, merged) + _mm(sm, merged,
                                                  v["out_hidden_size"])


def davit_flops(cfg: dict) -> float:
    dv = cfg["davit"]
    h = w = cfg["aux_image_size"]
    in_ch, total = dv["in_chans"], 0.0
    for i, c in enumerate(dv["embed_dims"]):
        h //= dv["patch_stride"][i]
        w //= dv["patch_stride"][i]
        n = h * w
        total += _mm(n, in_ch * dv["patch_size"][i] ** 2, c)
        hidden = int(c * dv["mlp_ratio"])
        ws = dv["window_size"]
        np_ = (-(-h // ws) * ws) * (-(-w // ws) * ws)
        for _ in range(dv["depths"][i]):
            total += 4 * (n * c * 9 * 2)                    # 4 dw convs
            total += _mm(np_, c, 3 * c) + _mm(np_, c, c)
            total += 2 * _mm(np_, c, ws * ws)               # window attn
            total += 2 * (_mm(n, c, hidden) + _mm(n, hidden, c))
            total += _mm(n, c, 3 * c) + _mm(n, c, c)
            gd = c // dv["num_groups"][i]
            total += 2 * _mm(gd, n, gd) * dv["num_groups"][i]
        in_ch = c
    return total


def encode_flops(cfg: dict, gh: int, gw: int, n_boxes: int) -> float:
    d = cfg["hidden_size"]
    units = gh * gw // cfg["vision_config"]["spatial_merge_size"] ** 2
    proj = _mm(units, cfg["mm_hidden_size"], d) + _mm(units, d, d)
    region = (_mm(n_boxes, cfg["mm_region_hidden_size"], d)
              + _mm(n_boxes, d, d))
    return vit_flops(cfg, gh, gw) + proj + davit_flops(cfg) + region


def _trunk_linear_flops(cfg: dict, tokens: int) -> float:
    d, inter = cfg["hidden_size"], cfg["intermediate_size"]
    hd = d // cfg["num_attention_heads"]
    q, kv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    return cfg["num_hidden_layers"] * (
        _mm(tokens, d, q + 2 * kv) + _mm(tokens, q, d)
        + 3 * _mm(tokens, d, inter))


def attention_pair_flops(cfg: dict) -> float:
    """FLOPs of one query-key pair over every layer and head (scores and
    the weighted sum)."""
    d = cfg["hidden_size"]
    return 2 * 2.0 * d * cfg["num_hidden_layers"]


def prefill_flops(cfg: dict, length: int) -> float:
    """The causal prefill of one prompt and its last row's logits."""
    pairs = length * (length + 1) / 2
    return (_trunk_linear_flops(cfg, length)
            + attention_pair_flops(cfg) * pairs
            + _mm(1, cfg["hidden_size"], cfg["vocab_size"]))


def decode_flops(cfg: dict, n_tokens: int, context: int) -> float:
    """n_tokens greedy steps after a prompt of `context` tokens (step j
    attends over context + j + 1 keys)."""
    per = (_trunk_linear_flops(cfg, 1)
           + _mm(1, cfg["hidden_size"], cfg["vocab_size"]))
    keys = n_tokens * context + n_tokens * (n_tokens + 1) / 2
    return n_tokens * per + attention_pair_flops(cfg) * keys


def request_flops(cfg: dict, gh: int, gw: int, n_boxes: int, prompt: int,
                  served: int) -> float:
    """A served request: encode, prefill, and the decode steps that
    produced its served tokens after the first (which the prefill's logits
    give)."""
    return (encode_flops(cfg, gh, gw, n_boxes) + prefill_flops(cfg, prompt)
            + decode_flops(cfg, max(0, served - 1), prompt))


# ----------------------------------------------------------- kernels

def flash_vit(cfg: dict, gh: int, gw: int, images: int):
    """(FLOPs, bytes) of the ViT's full-attention calls for a batch of
    images: the real patches attend to each other; q, k, v read and o
    written once in bf16."""
    v = cfg["vision_config"]
    s, d = gh * gw, v["hidden_size"]
    calls = len(v["fullatt_block_indexes"])
    return (calls * images * 2 * _mm(s, d, s),
            calls * images * 4 * s * d * 2)


def flash_prefill(cfg: dict, lengths: list[int]):
    """(FLOPs, bytes) of the trunk's prefill attention over prompts of
    these lengths: causal pairs, q / o at the query width and k / v at the
    kv width, once each in bf16."""
    d = cfg["hidden_size"]
    hd = d // cfg["num_attention_heads"]
    kv = cfg["num_key_value_heads"] * hd
    pairs = sum(n * (n + 1) / 2 for n in lengths)
    toks = sum(lengths)
    return (attention_pair_flops(cfg) * pairs,
            cfg["num_hidden_layers"] * toks * (2 * d + 2 * kv) * 2)


def trunk_linear_shapes(cfg: dict) -> list[tuple[int, int]]:
    """(in, out) of every trunk projection of one forward."""
    d, inter = cfg["hidden_size"], cfg["intermediate_size"]
    hd = d // cfg["num_attention_heads"]
    q, kv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    layer = [(d, q), (d, kv), (d, kv), (q, d), (d, inter), (d, inter),
             (inter, d)]
    return layer * cfg["num_hidden_layers"]


def int4_call(m: int, k: int, n: int):
    """(FLOPs, bytes) of one int4 product x [m, k] bf16 @ packed [k/2, n]
    with f32 scales [n] -> [m, n] bf16: each byte read or written once."""
    return _mm(m, k, n), k * n // 2 + 4 * n + 2 * m * k + 2 * m * n


def finished_flops(cfg: dict, records: list[dict]) -> float:
    """Model FLOPs of the finished requests of a window (`request_flops`
    at each one's own image grid, boxes, prompt and served tokens)."""
    from benchmark.reference.fo1 import smart_resize

    v = cfg["vision_config"]
    total = 0.0
    for r in records:
        res = r["result"]
        if res is None:
            continue
        w, h = r["req"]["image"].size
        hb, wb = smart_resize(h, w, v["patch_size"] * v["spatial_merge_size"],
                              cfg["min_pixels"], cfg["max_pixels"])
        total += request_flops(cfg, hb // v["patch_size"],
                               wb // v["patch_size"], len(r["req"]["boxes"]),
                               res.prompt_len, len(res.token_ids))
    return total
