"""Qwen2.5 decoder trunk with M-RoPE and GQA (counterpart of
`vlm_fo1_tpu/models/llm.py`).

The KV cache is preallocated as [L, B, C, Hkv, hd] and written in place
(the JAX package threads an updated copy through its scan instead). A
multi-token call is a prefill from cache slot 0: its attention runs through
`attention` (the flash kernel by default) over the prompt's own k/v with
`causal=True, kv_len=S`. On a right-padded batch that equals the JAX prefill
mask (`causal & in_prompt` over the cache) on every real query, since a real
query never sees a key at or past its row's length; padded queries differ,
and the decode mask keeps their keys out of every later step. A
single-token call is a decode step with static shapes, as the JAX
`_attention` decode path: its k/v are written at a device index (one slot
for all rows, or one per row) and it attends over the whole cache under an
explicit mask [B, C] through `ops.decode_attention` (the CUDA kernel
on the card), so no step depends on a host value and a run of steps can be
captured as a CUDA graph (`runtime/graphs.py`). A call with no
cache is the training forward: the whole sequence through `attention`
(`causal_attention` there).

`forward_ring` is the sequence-parallel trunk of
`runtime.generate.prefill_sequence_parallel`. Under a model axis
(`parallel.sharding.shard_model`) each attention holds its local heads
(`nh`, `nkv`), the cache holds `kv_heads` of them, and `embed` / `logits`
gather or sum over the axis.

Parameters use the checkpoint's names: `embed_tokens.weight`,
`layers.{i}.self_attn.{q,k,v,o}_proj`, `layers.{i}.mlp.*`, `norm.weight`,
and `lm_head.weight` when the head is untied. The serving modes of `quant`
swap in int8 / int4 linears, a row-int8 token table and `Int4MLP`.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vlm_fo1_tpu_torch.config import TextConfig
from vlm_fo1_tpu_torch import nn as tnn
from vlm_fo1_tpu_torch.ops.decode_attention import decode_attention
from vlm_fo1_tpu_torch.ops.flash_attention import flash_attention
from vlm_fo1_tpu_torch.ops.int4_mlp import KEYS, int4_mlp


def mrope_cos_sin(position_ids, cfg: TextConfig):
    """position_ids [3, B, S] int -> cos/sin [B, S, head_dim] fp32 with the
    t/h/w channel sections of `mrope_section`, duplicated for rotate-half."""
    hd = cfg.head_dim
    sections = list(cfg.mrope_section)
    if sum(sections) != hd // 2:
        raise ValueError("mrope sections must cover half of head_dim")
    exps = torch.arange(0, hd, 2, dtype=torch.float32,
                        device=position_ids.device) / hd
    inv_freq = 1.0 / (cfg.rope_theta ** exps)
    freqs = position_ids.float()[..., None] * inv_freq      # [3, B, S, hd/2]
    parts, start = [], 0
    for i, sec in enumerate(sections):
        parts.append(freqs[i % 3, :, :, start:start + sec])
        start += sec
    half = torch.cat(parts, dim=-1)
    emb = torch.cat([half, half], dim=-1)
    return emb.cos(), emb.sin()


def _apply_rope(x, cos, sin):
    """x [B, S, H, hd]; cos/sin [B, S, hd] fp32; multiply-add in x.dtype."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x * cos[:, :, None, :].to(x.dtype)
            + rot * sin[:, :, None, :].to(x.dtype))


def init_kv_cache(cfg: TextConfig, batch, max_len, dtype, device,
                  heads=None):
    """A zeroed cache [L, B, C, Hkv, hd]; `heads` is the kv head count of
    this rank (`TextModel.kv_heads`; the config's without a model axis)."""
    heads = cfg.num_key_value_heads if heads is None else heads
    shape = (cfg.num_hidden_layers, batch, max_len, heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def causal_attention(q, k, v, *, causal=True, kv_len=None):
    """Plain attention in the flash kernel's signature (q [B, H, S, hd],
    k/v [B, Hkv, S, hd], GQA), the general path of the JAX `_attention`:
    f32 logits, logits stored in q's dtype, the mask, an f32 softmax and
    the probabilities cast back. Differentiable: the training loss passes
    it as the trunk's `attention` (the JAX trunk never calls the flash
    kernel)."""
    b, h, s, hd = q.shape
    nkv, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, nkv, h // nkv, s, hd)
    logits = torch.einsum("bngsh,bnch->bngsc", qg.float(), k.float())
    logits = (logits * (1.0 / math.sqrt(hd))).to(q.dtype).float()
    kpos = torch.arange(sk, device=q.device)
    allowed = torch.ones(s, sk, dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(s, device=q.device)
        allowed &= kpos[None, :] <= qpos[:, None] + (sk - s)
    if kv_len is not None:
        allowed &= (kpos < kv_len)[None, :]
    logits = logits.masked_fill(~allowed, tnn.MASK_FILL)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bngsc,bnch->bngsh", probs, v).reshape(b, h, s, hd)


class Attention(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        d, hd = cfg.hidden_size, cfg.head_dim
        nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
        self.q_proj = tnn.Linear(d, nh * hd, bias=cfg.attention_bias)
        self.k_proj = tnn.Linear(d, nkv * hd, bias=cfg.attention_bias)
        self.v_proj = tnn.Linear(d, nkv * hd, bias=cfg.attention_bias)
        self.o_proj = tnn.Linear(nh * hd, d, bias=False)
        self.nh, self.nkv, self.hd = nh, nkv, hd

    def forward(self, x, cos, sin, kc, vc, offset, attention, mask=None):
        """x [B, S, D]; kc/vc this layer's cache [B, C, Hkv, hd] or None
        for a cache-free call. A multi-token call writes slots
        [offset, offset + S) with offset 0. A single-token call writes at
        `offset`, a device tensor holding one slot ([]) or one slot per row
        ([B]), and attends over all C slots where `mask` [B, C] is
        True."""
        b, s, _ = x.shape
        nh, nkv, hd = self.nh, self.nkv, self.hd
        q = _apply_rope(self.q_proj(x).reshape(b, s, nh, hd), cos, sin)
        k = _apply_rope(self.k_proj(x).reshape(b, s, nkv, hd), cos, sin)
        v = self.v_proj(x).reshape(b, s, nkv, hd)
        if s > 1 or kc is None:
            if offset != 0:
                raise ValueError("multi-token calls are prefills from slot 0")
            if kc is not None:
                kc[:, :s] = k.to(kc.dtype)
                vc[:, :s] = v.to(vc.dtype)
            out = attention(q.transpose(1, 2).contiguous(),
                            k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous(),
                            causal=True, kv_len=s)
            out = out.transpose(1, 2).reshape(b, s, nh * hd)
            return self.o_proj(out)
        # decode step: write each row's slot, attend over the whole cache
        c = kc.shape[1]
        rows = torch.arange(b, device=x.device) * c + offset
        kc.view(b * c, nkv, hd).index_copy_(0, rows, k[:, 0].to(kc.dtype))
        vc.view(b * c, nkv, hd).index_copy_(0, rows, v[:, 0].to(vc.dtype))
        out = decode_attention(q[:, 0], kc, vc, mask)
        return self.o_proj(out.reshape(b, 1, nh * hd))


class MLP(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        d, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = tnn.Linear(d, i, bias=False)
        self.up_proj = tnn.Linear(d, i, bias=False)
        self.down_proj = tnn.Linear(i, d, bias=False)
        self.act = tnn.ACT[cfg.hidden_act]

    def forward(self, x):
        return self.down_proj(self.act(self.gate_proj(x)) * self.up_proj(x))


class Int4MLP(nn.Module):
    """The int4-mlp mode's fused SwiGLU (the JAX package's `fused_int4`
    node, `quant.quantize_mlp_int4`): gate/up packed [D/2, I] along the
    contraction halves, down packed [I, D/2] along the output halves, f32
    scales. `fn` is the int4 MLP CUDA kernel on the card; set it to
    `ops.int4_mlp.int4_mlp_reference` to run the plain version."""

    def __init__(self, node: dict):
        super().__init__()
        for k in KEYS:
            self.register_buffer(k, node[k])
        self.fn = int4_mlp

    def forward(self, x):
        node = {k: getattr(self, k) for k in KEYS}
        y = self.fn(x.reshape(-1, x.shape[-1]).contiguous(), node)
        return y.reshape(x.shape)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.input_layernorm = tnn.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.post_attention_layernorm = tnn.RMSNorm(cfg.hidden_size,
                                                    cfg.rms_norm_eps)
        self.self_attn = Attention(cfg)
        self.mlp = MLP(cfg)

    def forward(self, x, cos, sin, kc, vc, offset, attention, mask=None):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, kc, vc,
                               offset, attention, mask)
        return x + self.mlp(self.post_attention_layernorm(x))


class TextModel(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = tnn.Weight(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(DecoderLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = tnn.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        if not cfg.tie_word_embeddings:
            self.lm_head = tnn.Linear(cfg.hidden_size, cfg.vocab_size,
                                      bias=False)
        self.set_tensor_parallel(None)

    def set_tensor_parallel(self, group, embed=False, head=None):
        """The model axis (`parallel.sharding.shard_model` sets it): the
        token table split over D when `embed`, and the head "dim" (the
        tied table's D columns, partial logits summed) or "vocab" (an
        untied head's rows, local logits gathered), or None."""
        self.tp_group, self.tp_embed, self.tp_head = group, embed, head

    @property
    def kv_heads(self) -> int:
        """The kv heads this rank holds (all of them without a model
        axis)."""
        return self.layers[0].self_attn.nkv

    def forward(self, hidden, cos, sin, kv_cache=None, offset=0,
                attention=flash_attention, remat=False, mask=None):
        """hidden [B, S, D] -> final-normed hidden [B, S, D]. A prefill
        (S > 1, offset 0) fills kv_cache slots [0, S) of every layer; a
        decode step (S = 1) writes slot `offset` (a device tensor, [] or
        [B]) and attends under `mask` [B, C] (see `Attention`). With
        no cache (the JAX `text_forward` with kv_cache=None) the whole
        sequence goes through `attention` under the causal mask: training
        passes the differentiable `causal_attention`, and remat=True
        recomputes each layer in the backward pass instead of storing its
        activations (the JAX `remat`, `jax.checkpoint` per scanned
        layer)."""
        x = hidden
        for i, layer in enumerate(self.layers):
            if isinstance(layer.mlp, Int4MLP) and self.cfg.hidden_act != "silu":
                raise ValueError("the fused int4 MLP computes SwiGLU only")
            kc, vc = ((None, None) if kv_cache is None
                      else (kv_cache["k"][i], kv_cache["v"][i]))
            if remat:
                x = checkpoint(layer, x, cos, sin, kc, vc, offset, attention,
                               mask, use_reentrant=False)
            else:
                x = layer(x, cos, sin, kc, vc, offset, attention, mask)
        return self.norm(x)

    def embed(self, ids):
        """Token rows; a row-int8 table dequantizes the gathered rows into
        the model's compute dtype (the final norm's). A table split over D
        gathers the rows' columns over the model axis."""
        if isinstance(self.embed_tokens, tnn.QEmbedding8):
            rows = self.embed_tokens.lookup(ids, self.norm.weight.dtype)
        else:
            rows = tnn.embedding(self.embed_tokens.weight, ids)
        if self.tp_embed:
            from vlm_fo1_tpu_torch.parallel.sharding import gather_from_model

            rows = gather_from_model(rows, self.tp_group)
        return rows

    @staticmethod
    def _head_product(hidden, head):
        if isinstance(head, (tnn.QEmbedding8, tnn.QLinear8)):
            return tnn.int8_head_logits(hidden, head.w_q, head.scale)
        if isinstance(head, tnn.QLinear4):
            return head(hidden.float())
        return F.linear(hidden.float(), head.weight.float())

    def logits(self, hidden):
        """[B, S, D] -> [B, S, V] fp32 logits (tied or untied head; int8
        and int4 heads as the JAX package's `lm_head_logits`). Under a model
        axis the f32 logits are summed over the D shards ("dim") or
        gathered over the V shards ("vocab")."""
        head = (self.embed_tokens if self.cfg.tie_word_embeddings
                else self.lm_head)
        if self.tp_head is None:
            return self._head_product(hidden, head)
        from vlm_fo1_tpu_torch.parallel.sharding import (
            copy_to_model,
            gather_from_model,
            reduce_from_model,
        )

        group = self.tp_group
        hidden = copy_to_model(hidden, group)
        if self.tp_head == "vocab":
            return gather_from_model(self._head_product(hidden, head), group)
        n = hidden.shape[-1] // dist.get_world_size(group)
        part = hidden.narrow(-1, dist.get_rank(group) * n, n)
        return reduce_from_model(self._head_product(part, head), group)

    def forward_ring(self, hidden, cos, sin, q_pos, kv_pos, kv_valid,
                     group=None):
        """The sequence-parallel trunk (the JAX `text_forward_ring`): hidden
        [B, Sl, D], cos / sin [B, Sl, hd] and the global positions q_pos /
        kv_pos and kv_valid [B, Sl] are this rank's chunk of the sequence
        (for a `LocalRing`, every chunk stacked on the batch axis). Norms,
        projections, rope and MLP are token-local; attention is
        `parallel.ring_attention.ring_attention` over `group`. The MLP is
        each layer's module, so an int4-mlp trunk runs the fused int4
        SwiGLU kernel. Returns (final-normed hidden [B, Sl, D], k, v
        [L, B, Sl, Hkv, hd])."""
        from vlm_fo1_tpu_torch.parallel.ring_attention import ring_attention

        x = hidden
        ks, vs = [], []
        for layer in self.layers:
            if (isinstance(layer.mlp, Int4MLP)
                    and self.cfg.hidden_act != "silu"):
                raise ValueError("the fused int4 MLP computes SwiGLU only")
            attn = layer.self_attn
            b, s, _ = x.shape
            h = layer.input_layernorm(x)
            q = _apply_rope(attn.q_proj(h).reshape(b, s, attn.nh, attn.hd),
                            cos, sin)
            k = _apply_rope(attn.k_proj(h).reshape(b, s, attn.nkv, attn.hd),
                            cos, sin)
            v = attn.v_proj(h).reshape(b, s, attn.nkv, attn.hd)
            out = ring_attention(q, k, v, q_pos, kv_pos, kv_valid, group)
            x = x + attn.o_proj(out.reshape(b, s, attn.nh * attn.hd))
            x = x + layer.mlp(layer.post_attention_layernorm(x))
            ks.append(k)
            vs.append(v)
        return self.norm(x), torch.stack(ks), torch.stack(vs)
