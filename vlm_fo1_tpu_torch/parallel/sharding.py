"""Tensor- and data-parallel sharding over a ("data", "model") mesh
(counterpart of `vlm_fo1_tpu/parallel/sharding.py`).

The JAX package gives each parameter a NamedSharding by the HF tp_plan of
Qwen2.5-VL (q/k/v/gate/up column-wise, o/down row-wise, the ViT's blocks
likewise, the token table over D) and lets GSPMD insert the collectives.
Here `shard_model` replaces each listed linear by its local shard on this
rank, with the collectives written out (Megatron's pairs, as
`torch.autograd.Function`s so training has the right gradients):

  column  weight [out / m, in]: the input passes `copy_to_model` (identity
          forward, all-reduce of the gradient); the output stays local;
  row     weight [out, in / m]: the product passes `reduce_from_model`
          (all-reduce forward, identity backward); the bias is added once
          after the sum;
  qkv     the ViT's fused [q; k; v] output: each of the three blocks is
          split by heads and the local thirds concatenated, so a rank holds
          whole heads of q, k and v;
  embed   the token table [V, D / m]: looked-up rows are all-gathered over
          D; the tied head multiplies this rank's D columns and all-reduces
          the f32 logits;
  vocab   an untied head [V / m, D]: local logits, all-gathered over V.

The flash and int4 kernels take raw pointers, so they see plain local
tensors, never DTensors, and attention sees whole local heads: a projection
is split by heads only when its head count divides by the model axis (for
the trunk, the kv heads, so each q group stays with its kv head); otherwise
the whole attention of that tower stays replicated. JAX shards wherever the
width divides, so at 2 kv heads and model = 4 it splits a kv head and
GSPMD moves the data; the numbers are the same, the specs differ exactly
there. MLPs shard when the intermediate width divides.

int8 leaves follow the JAX rules: `w_q` takes the weight's layout, a
linear's scale takes the out-channel shard (so a row-parallel scale stays
whole), and the token table's per-row scale stays replicated. Leaves that
no rule names stay replicated, as in JAX: int4 linears and the fused int4
MLP, DaViT, the HFRE, the projectors and the norms. A w8a8 linear
quantizes each activation row as a whole; GSPMD keeps that whole in JAX,
and here a row-parallel w8a8 shard (`w8a8_row_parallel`) makes it whole
with three more collectives: the column absmax is all-gathered, so every
rank picks the dense model's outlier columns over the full width, each
row's absmax over the rest is MAX all-reduced before quantizing, and the
int32 partial products are summed (exactly) before the scale. Its
single-row calls (decode) stay weight-only, as in the dense model.

The decode graphs (`runtime/graphs.py`) capture the collectives of the
decode step with the rest of it: NCCL allows capture on the capture
stream.

Data parallelism splits batch rows over "data" (`data_rows`); the
training step all-reduces gradients over that axis
(`training.train_step.make_train_step`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from vlm_fo1_tpu_torch import nn as tnn
from vlm_fo1_tpu_torch.models.llm import MLP, TextModel
from vlm_fo1_tpu_torch.nn import W8A8_OUTLIER_CHANNELS, exact_int_mm
from vlm_fo1_tpu_torch.models.vit import VisionTransformer
from vlm_fo1_tpu_torch.parallel.multihost import (
    all_gather_stacked,
    create_hybrid_mesh,
)


def create_mesh(data: int = 1, model: int = 1):
    """A (data, model) `DeviceMesh` over the process group's ranks."""
    return create_hybrid_mesh(ici_data=data, ici_model=model, num_slices=1)


# ------------------------------------------------------------ collectives

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather_last(x, group):
    parts = all_gather_stacked(x, group)
    return parts.movedim(0, -2).reshape(*x.shape[:-1], -1)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        group = ctx.group
        part = g.chunk(dist.get_world_size(group), dim=-1)
        return part[dist.get_rank(group)].contiguous(), None


def _tracks_grad(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_model(x, group):
    """Identity forward; the gradient is all-reduced over `group`."""
    return _CopyToModel.apply(x, group) if _tracks_grad(x) else x


def reduce_from_model(x, group):
    """Sum over `group` forward (in place when no gradient is tracked);
    identity backward."""
    if _tracks_grad(x):
        return _ReduceFromModel.apply(x, group)
    dist.all_reduce(x, group=group)
    return x


def gather_from_model(x, group):
    """All-gather over `group` along the last dim; the gradient is this
    rank's slice."""
    if _tracks_grad(x):
        return _GatherFromModel.apply(x, group)
    return _gather_last(x, group)


# ----------------------------------------------------- parallel linears

def _param(t, like):
    return nn.Parameter(t, requires_grad=like.requires_grad)


class ColumnLinear(tnn.Linear):
    def __init__(self, weight, bias, group, like):
        nn.Module.__init__(self)
        self.weight = _param(weight, like.weight)
        self.bias = None if bias is None else _param(bias, like.bias)
        self.group = group

    def forward(self, x):
        return super().forward(copy_to_model(x, self.group))


class RowLinear(tnn.Linear):
    def __init__(self, weight, bias, group, like):
        nn.Module.__init__(self)
        self.weight = _param(weight, like.weight)
        self.bias = None if bias is None else _param(bias, like.bias)
        self.group = group

    def forward(self, x):
        y = reduce_from_model(self.product(x), self.group)
        return y if self.bias is None else y + self.bias


class ColumnQLinear8(tnn.QLinear8):
    def __init__(self, w_q, scale, bias, group, like):
        super().__init__(w_q, scale, bias)
        self.a8 = like.a8
        self.group = group

    def forward(self, x):
        return super().forward(copy_to_model(x, self.group))


def w8a8_row_parallel(x, w_q, scale, group):
    """This rank's part of a row-parallel `nn.w8a8_matmul`, summed over
    `group`: x [..., in/m] and w_q [out, in/m] hold this rank's input
    columns, scale [out] is whole; returns the dense product of the whole
    rows, [..., out] in x's dtype, on every rank. Forward only.

    The outlier columns are the dense ones: the top-k (k = min(64, in/8)
    of the full width, stable sort, the lower index first) of the column
    absmax all-gathered over the group; each rank takes those in its
    slice. Each row's absmax over the other columns is MAX all-reduced,
    so every rank quantizes with the dense row scale; the int32 partial
    products are summed over the group (exact) before the scale, and the
    f32 outlier products by a sum of their own."""
    xf = x.float()
    m, r = dist.get_world_size(group), dist.get_rank(group)
    width = xf.shape[-1]
    lo = r * width
    k = min(W8A8_OUTLIER_CHANNELS, width * m // 8)
    y_out = torch.zeros(*xf.shape[:-1], w_q.shape[0], dtype=torch.float32,
                        device=x.device)
    if k > 0:
        col_amax = xf.abs().reshape(-1, width).amax(dim=0)
        full = all_gather_stacked(col_amax, group).reshape(-1)
        oidx = torch.sort(full, descending=True, stable=True).indices[:k]
        mine = oidx[(oidx >= lo) & (oidx < lo + width)] - lo
        if mine.numel():
            w_o = w_q[:, mine].float() * scale[:, None]
            y_out = xf[..., mine] @ w_o.t()
            keep = torch.ones(width, dtype=torch.float32, device=x.device)
            keep[mine] = 0.0
            xf = xf * keep
    amax = xf.abs().amax(dim=-1, keepdim=True)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    sx = torch.clamp(amax, min=1e-6) * (1.0 / 127.0)
    x_q = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    acc = exact_int_mm(x_q.reshape(-1, width), w_q.t()).contiguous()
    dist.all_reduce(acc, group=group)
    dist.all_reduce(y_out, group=group)
    acc = acc.reshape(*x.shape[:-1], w_q.shape[0])
    return (acc.float() * sx * scale + y_out).to(x.dtype)


class RowQLinear8(tnn.QLinear8):
    def __init__(self, w_q, scale, bias, group, like):
        super().__init__(w_q, scale, bias)
        self.a8 = like.a8
        self.group = group

    def forward(self, x):
        if self.a8 is not None and x.dim() >= 2 and x.shape[-2] > 1:
            y = w8a8_row_parallel(x, self.w_q, self.scale, self.group)
        else:
            y = reduce_from_model(self.product(x), self.group)
        return y if self.bias is None else y + self.bias


# ------------------------------------------------------------------ plan

_SHARDABLE = (tnn.Linear, tnn.QLinear8)


def _mlp_plan(plan, mlp, width_divides, p):
    """gate / up column-wise and down row-wise when the intermediate width
    divides and all three are plain or int8 linears."""
    if width_divides and all(isinstance(getattr(mlp, n), _SHARDABLE)
                             for n in ("gate_proj", "up_proj", "down_proj")):
        plan.update({f"{p}mlp.gate_proj": "column",
                     f"{p}mlp.up_proj": "column",
                     f"{p}mlp.down_proj": "row"})


def _text_plan(text: TextModel, m: int, prefix: str) -> dict:
    cfg = text.cfg
    plan = {}
    for i, layer in enumerate(text.layers):
        p = f"{prefix}layers.{i}."
        attn = layer.self_attn
        projs = [getattr(attn, n) for n in ("q_proj", "k_proj", "v_proj",
                                            "o_proj")]
        if (cfg.num_key_value_heads % m == 0
                and all(isinstance(x, _SHARDABLE) for x in projs)):
            for n in ("q_proj", "k_proj", "v_proj"):
                plan[f"{p}self_attn.{n}"] = "column"
            plan[f"{p}self_attn.o_proj"] = "row"
        if isinstance(layer.mlp, MLP):
            _mlp_plan(plan, layer.mlp, cfg.intermediate_size % m == 0, p)
    if (cfg.hidden_size % m == 0
            and isinstance(text.embed_tokens, (tnn.Weight, tnn.QEmbedding8))):
        plan[f"{prefix}embed_tokens"] = "embed"
    head = getattr(text, "lm_head", None)
    if (head is not None and isinstance(head, _SHARDABLE)
            and cfg.vocab_size % m == 0):
        plan[f"{prefix}lm_head"] = "vocab"
    return plan


def _vit_plan(vit: VisionTransformer, m: int, prefix: str) -> dict:
    cfg = vit.cfg
    plan = {}
    for i, blk in enumerate(vit.blocks):
        p = f"{prefix}blocks.{i}."
        if (cfg.num_heads % m == 0
                and all(isinstance(x, _SHARDABLE)
                        for x in (blk.attn.qkv, blk.attn.proj))):
            plan[f"{p}attn.qkv"] = "qkv"
            plan[f"{p}attn.proj"] = "row"
        _mlp_plan(plan, blk.mlp, cfg.intermediate_size % m == 0, p)
    return plan


def _towers(model):
    """(tower, name prefix) of the trunk and the ViT in `model`: an
    `FO1Model`, a `TextModel` or a `VisionTransformer`."""
    if isinstance(model, (TextModel, VisionTransformer)):
        return [(model, "")]
    return [(model.text, "text."), (model.vision_tower, "vision_tower.")]


def tp_plan(model, model_size: int) -> dict:
    """Module name -> "column" / "row" / "qkv" / "embed" / "vocab" for the
    modules split over a model axis of `model_size`; modules not named stay
    replicated."""
    plan = {}
    for tower, prefix in _towers(model):
        make = _text_plan if isinstance(tower, TextModel) else _vit_plan
        plan.update(make(tower, model_size, prefix))
    return plan


# the dim of each split leaf, in the port's layouts ([out, in] weights)
_LEAF_DIMS = {
    "column": {"weight": 0, "bias": 0, "w_q": 0, "scale": 0},
    "row": {"weight": 1, "w_q": 1},
    "qkv": {"weight": 0, "bias": 0, "w_q": 0, "scale": 0},
    "embed": {"weight": 1, "w_q": 1},
    "vocab": {"weight": 0, "bias": 0, "w_q": 0, "scale": 0},
}


def param_specs(model, model_size: int) -> dict:
    """Every parameter and buffer name -> the dim split over "model", or
    None where it stays replicated (the counterpart of the JAX
    `param_shardings`)."""
    plan = tp_plan(model, model_size)
    specs = {}
    for name, _ in list(model.named_parameters()) + list(
            model.named_buffers()):
        mod, _, leaf = name.rpartition(".")
        specs[name] = _LEAF_DIMS.get(plan.get(mod), {}).get(leaf)
    return specs


# --------------------------------------------------------------- sharding

def _own(t):
    """t as a tensor of its own: a slice is copied, so the full tensor it
    came from can be freed."""
    if t.numel() * t.element_size() == t.untyped_storage().nbytes():
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _cut(t, dim, r, m):
    n = t.shape[dim] // m
    return _own(t.narrow(dim, r * n, n))


def shard_leaf(t, mode: str, leaf: str, r: int, m: int):
    """Rank r's part (of m) of the leaf `leaf` ("weight", "bias", "w_q",
    "scale") of a module split in `mode`; the whole tensor where that leaf
    stays replicated."""
    dim = _LEAF_DIMS[mode].get(leaf)
    if t is None or dim is None:
        return t
    if mode == "qkv":
        return torch.cat([_cut(b, 0, r, m) for b in t.chunk(3, dim=0)])
    return _cut(t, dim, r, m)


def _shard_linear(mod, mode, group, r, m):
    def cut(leaf):
        return shard_leaf(getattr(mod, leaf), mode, leaf, r, m)

    if isinstance(mod, tnn.QLinear8):
        cls = RowQLinear8 if mode == "row" else ColumnQLinear8
        return cls(cut("w_q"), cut("scale"), cut("bias"), group, mod)
    cls = RowLinear if mode == "row" else ColumnLinear
    return cls(cut("weight"), cut("bias"), group, mod)


def _swap(root, name, new):
    parent, _, child = name.rpartition(".")
    setattr(root.get_submodule(parent) if parent else root, child, new)


@torch.no_grad()
def shard_model(model, mesh):
    """Replace the modules of `tp_plan` by this rank's shards over the
    mesh's "model" axis, in place; set the local head counts of the split
    attentions and the trunk's embedding and head modes. `model` is an
    `FO1Model`, a `TextModel` or a `VisionTransformer`; every rank of the
    mesh calls this with the same weights. Returns the model."""
    from vlm_fo1_tpu_torch.runtime.generate import drop_programs

    group = mesh.get_group("model")
    m = dist.get_world_size(group)
    r = dist.get_rank(group)
    plan = tp_plan(model, m)
    for name, mode in plan.items():
        mod = model.get_submodule(name)
        if mode == "embed":
            if isinstance(mod, tnn.QEmbedding8):
                mod.w_q = shard_leaf(mod.w_q, mode, "w_q", r, m)
            else:
                mod.weight = _param(shard_leaf(mod.weight, mode, "weight",
                                               r, m), mod.weight)
            continue
        _swap(model, name, _shard_linear(mod, mode, group, r, m))
    for tower, prefix in _towers(model):
        if isinstance(tower, TextModel):
            for i, layer in enumerate(tower.layers):
                if f"{prefix}layers.{i}.self_attn.o_proj" in plan:
                    layer.self_attn.nh //= m
                    layer.self_attn.nkv //= m
            embed = f"{prefix}embed_tokens" in plan
            tower.set_tensor_parallel(
                group, embed=embed,
                head=("dim" if embed and tower.cfg.tie_word_embeddings
                      else "vocab" if f"{prefix}lm_head" in plan else None))
            drop_programs(tower)
        else:
            for i, blk in enumerate(tower.blocks):
                if f"{prefix}blocks.{i}.attn.qkv" in plan:
                    blk.attn.tp = m
    return model


def data_rows(n: int, mesh) -> slice:
    """This rank's rows of a global batch of n over the "data" axis (the
    JAX `data_sharding` P("data"))."""
    d = mesh.size(0)
    if n % d:
        raise ValueError(f"a batch of {n} rows does not split over "
                         f"{d} data ranks")
    i = mesh.get_local_rank("data")
    return slice(i * n // d, (i + 1) * n // d)
