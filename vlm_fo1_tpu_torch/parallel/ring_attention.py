"""Ring (context-parallel) attention (counterpart of
`vlm_fo1_tpu/parallel/ring_attention.py`).

Each rank holds one sequence chunk of Q/K/V. The K/V chunks travel around
the ring (rank r sends to r + 1 and receives from r - 1) while an online
softmax accumulates, so a rank's memory stays O(S_local^2) however long the
prompt. The arithmetic of one step is `ring_step`, the JAX loop body:
GQA grouping, f32 logits times 1/sqrt(hd) (never stored in bf16), a mask
from GLOBAL positions and the key validity, fill -1e30, the running max /
sum / accumulator, and at the end a divide by max(l, 1e-30).

Who moves the chunks is a separate object:
  GroupRing(group)  one chunk per rank of a process group; the rotation is
                    one `dist.batch_isend_irecv` with every send and receive
                    of the step, so NCCL cannot deadlock on their order;
  LocalRing(n)      all n chunks in one process, stacked on the batch axis
                    (chunk c is rows [c * B, (c + 1) * B)); the rotation is a
                    roll of that axis. The same steps, on one device.

Layouts as in `models/llm.py`: q [B, Sl, Hq, hd], k/v [B, Sl, Hkv, hd],
q_pos / kv_pos [B, Sl] global positions, kv_valid [B, Sl] bool. Plain
PyTorch, as the JAX ring is plain XLA: it runs no Pallas kernel.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from vlm_fo1_tpu_torch.parallel.multihost import all_gather_stacked

NEG = -1e30


class GroupRing:
    """One sequence chunk per rank of `group` (None: the default group)."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.chunks = (self.rank,)

    def _global(self, r):
        r %= self.size
        return r if self.group is None else dist.get_global_rank(self.group,
                                                                  r)

    def rotate(self, tensors):
        """Each tensor goes to rank + 1; returns those of rank - 1."""
        if self.size == 1:
            return list(tensors)
        dst, src = self._global(self.rank + 1), self._global(self.rank - 1)
        outs = [torch.empty_like(t) for t in tensors]
        ops = ([dist.P2POp(dist.isend, t.contiguous(), dst, self.group)
                for t in tensors]
               + [dist.P2POp(dist.irecv, o, src, self.group) for o in outs])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return outs

    def gather(self, x, batch_dim: int):
        """Every rank's chunk of x concatenated in rank order along the
        sequence axis (batch_dim + 1)."""
        parts = all_gather_stacked(x, self.group)
        return torch.cat(parts.unbind(0), dim=batch_dim + 1)


class LocalRing:
    """n sequence chunks in one process, stacked on the batch axis."""

    def __init__(self, n: int):
        self.size = n
        self.chunks = tuple(range(n))

    def rotate(self, tensors):
        n = self.size
        return [t.reshape(n, -1, *t.shape[1:]).roll(1, dims=0)
                .reshape(t.shape) for t in tensors]

    def gather(self, x, batch_dim: int):
        return torch.cat(x.chunk(self.size, dim=batch_dim), dim=batch_dim + 1)


def as_ring(group):
    """A ring object: a GroupRing or LocalRing as given, else the
    GroupRing of a process group (None: the default group)."""
    if isinstance(group, (GroupRing, LocalRing)):
        return group
    return GroupRing(group)


def ring_step(qg, q_pos, kb, vb, pb, vm, m, l, acc, scale):
    """One ring step, the JAX loop body: queries qg [B, Sl, Hkv, G, hd]
    against one K/V chunk kb / vb [B, Sc, Hkv, hd] at global positions
    pb [B, Sc] with validity vm [B, Sc]; m / l [B, Hkv, G, Sl] and acc
    [B, Hkv, G, Sl, hd] f32. Returns the updated (m, l, acc)."""
    logits = torch.einsum("bsngh,bcnh->bngsc", qg.float(),
                          kb.float()) * scale
    mask = ((pb[:, None, None, None, :] <= q_pos[:, None, None, :, None])
            & vm[:, None, None, None, :])
    logits = torch.where(mask, logits, NEG)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - m_new[..., None])
    p = torch.where(mask, p, 0.0)
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bngsc,bcnh->bngsh", p,
                                               vb.float())
    return m_new, l, acc


def ring_attention(q, k, v, q_pos, kv_pos, kv_valid, group=None):
    """[B, Sl, Hq, hd] attention outputs in q's dtype. `group` is a process
    group (None: the default group), a GroupRing or a LocalRing. One step
    per chunk; the chunks rotate between steps (n - 1 rotations)."""
    ring = as_ring(group)
    b, sl, hq, hd = q.shape
    hkv = k.shape[2]
    groups = hq // hkv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, sl, hkv, groups, hd)
    m = torch.full((b, hkv, groups, sl), NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, groups, sl, hd), dtype=torch.float32,
                      device=q.device)
    # validity travels as uint8: gloo moves no bool tensors
    kb, vb, pb, vm = k, v, kv_pos, kv_valid.to(torch.uint8)
    for i in range(ring.size):
        m, l, acc = ring_step(qg, q_pos, kb, vb, pb, vm.bool(), m, l, acc,
                              scale)
        if i < ring.size - 1:
            kb, vb, pb, vm = ring.rotate([kb, vb, pb, vm])
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sl, hq, hd).to(q.dtype)
