"""Ring attention and sequence-sharded decode attention over a group of
ranks (port of `opus_pllm_tpu/parallel/ring.py`: `ring_attention` :40,
`sharded_decode_attention` :133, `make_sp_mesh` :179,
`ring_self_attention` :194).

Each rank holds one sequence shard of Q/K/V. In `ring_attention` the K/V
shards (and their validity) rotate around the ring, one neighbour hop a
step (`core.mesh.ring_shift`: `batch_isend_irecv`, through host memory on
a shared card under gloo), and each rank merges the blocks it sees into
an online softmax in fp32, the JAX merge rule. A causal shard strictly in
a rank's future is skipped (`src <= idx`); every rank still sends and
receives at every step that has a next one, so the ring stays in step
(the last rotation, which would feed nothing, is not made).

With grad on, `ring_attention` is one autograd Function whose backward is
a reverse ring written by hand (JAX gets it from transposing `ppermute`
and `cond`): every collective of the forward and of the backward runs
inside the Function, on every rank alike whatever the causal skip, so
autograd's graph is the same on every rank and a remat recompute repeats
the forward's rotations in step.
`sharded_decode_attention` merges the partial softmaxes of replicated
queries over a sequence-sharded cache with one MAX and two SUM
all-reduces. Plain torch, as the JAX module is plain jnp: no kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
import torch.distributed as dist

from ..core import mesh as mesh_mod

NEG_LARGE = -1e30


@dataclasses.dataclass
class SeqMesh:
    """The ("seq",) mesh: `size` ranks in `group`, this one at `index`."""
    size: int
    index: int
    group: object
    ranks: List[int]


def make_sp_mesh(n: Optional[int] = None, ranks=None) -> Optional[SeqMesh]:
    """The ("seq",) mesh over the first `n` of `ranks` (default: the whole
    world). Every rank of the world calls it; a rank outside the mesh gets
    None. More shards than ranks is a ValueError: a silent truncation
    would halve the sharding a user sized for memory."""
    if not dist.is_initialized():
        raise RuntimeError("make_sp_mesh needs a live process group: start "
                           "the ranks with torchrun")
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    if n is not None:
        if n > len(ranks):
            raise ValueError(f"--seq-shards {n} > {len(ranks)} devices")
        ranks = ranks[:n]
    group = dist.new_group(ranks)
    me = dist.get_rank()
    if me not in ranks:
        return None
    return SeqMesh(len(ranks), ranks.index(me), group, ranks)


def _merge(carry, qf, kb, vb, maskb, q_pos, src: int, s_loc: int,
           causal: bool):
    """One K/V block into the running (max, sum, acc), fp32."""
    m, l, acc = carry
    s_blk = torch.einsum("bqhgd,bkhd->bhgqk", qf, kb.float())
    k_pos = src * s_loc + torch.arange(s_loc, device=qf.device)
    valid = maskb.bool()[:, None, None, None, :]
    if causal:
        valid = valid & (q_pos[None, None, None, :, None]
                         >= k_pos[None, None, None, None, :])
    s_blk = torch.where(valid, s_blk, torch.full_like(s_blk, NEG_LARGE))
    m_new = torch.maximum(m, s_blk.amax(dim=-1))
    # all-masked rows keep m == m_new == NEG_LARGE: corr = 1 against zero
    # accumulators, no NaN
    corr = torch.exp(m - m_new)
    p = torch.exp(s_blk - m_new[..., None])
    l = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhgqk,bkhd->bqhgd", p, vb.float())
    acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
    return m_new, l, acc


def _ring_forward(q, k, v, kv_mask, group, causal: bool, scale: float):
    """The forward ring -> (output in q's dtype, fp32 output, running max
    m, running sum l), m and l (B, Hkv, G, S_loc)."""
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    b, s_loc, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    dev = q.device
    qf = (q.float() * scale).reshape(b, s_loc, hkv, g, d)
    q_pos = idx * s_loc + torch.arange(s_loc, device=dev)
    carry = (torch.full((b, hkv, g, s_loc), NEG_LARGE, device=dev),
             torch.zeros((b, hkv, g, s_loc), device=dev),
             torch.zeros((b, s_loc, hkv, g, d), device=dev))
    kb, vb, maskb = k, v, kv_mask.to(torch.uint8)
    for t in range(n):
        src = (idx - t) % n                     # origin of the held shard
        if not causal or src <= idx:
            carry = _merge(carry, qf, kb, vb, maskb, q_pos, src, s_loc,
                           causal)
        if t + 1 < n:
            kb, vb, maskb = mesh_mod.ring_shift([kb, vb, maskb], group)
    m, l, acc = carry
    out = acc / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    out = out.reshape(b, s_loc, hq, d)
    return out.to(q.dtype), out, m, l


class _RingAttention(torch.autograd.Function):
    """`ring_attention` with grad on. Forward: `_ring_forward`, saving q,
    k, v, the key mask, the fp32 output and each row's running max m and
    sum l (its log-sum-exp m + log l, kept apart so that a row with no
    valid key, whose m is NEG_LARGE, recomputes its uniform weights 1 / l
    exactly). Backward, on each rank: its own K/V shard and fresh dK / dV
    accumulators start the reverse ring; at each step the rank recomputes
    the held block's P = exp(s - m) / l from its queries, adds the block's
    dq locally and the block's dK / dV to the accumulators, which travel
    with their shard. Rotations: n - 1 of (K, V, mask, dK, dV), then one
    more of (dK, dV), which brings every accumulator home to its owner:
    n in all on every rank (the forward makes n - 1). The function is the
    gradient `jax.vjp` gives through the JAX ring, whose transposed
    ppermutes rotate the cotangents the other way."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, group, causal, scale):
        out, out_f, m, l = _ring_forward(q, k, v, kv_mask, group, causal,
                                         scale)
        ctx.save_for_backward(q, k, v, kv_mask, out_f, m, l)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out_f, m, l = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        n = dist.get_world_size(group)
        idx = dist.get_rank(group)
        b, s_loc, hq, d = q.shape
        hkv = k.shape[2]
        g = hq // hkv
        dev = q.device
        qf = (q.float() * scale).reshape(b, s_loc, hkv, g, d)
        do = dout.float().reshape(b, s_loc, hkv, g, d)
        # delta_i = sum_d dO_i O_i: the softmax's row term
        delta = (do * out_f.reshape(b, s_loc, hkv, g, d)).sum(-1)
        delta = delta.permute(0, 2, 3, 1)               # (B, Hkv, G, Sq)
        inv_l = 1.0 / l.clamp_min(1e-30)
        q_pos = idx * s_loc + torch.arange(s_loc, device=dev)
        dq = torch.zeros_like(qf)
        kb, vb, maskb = k, v, kv_mask.to(torch.uint8)
        dkb = torch.zeros((b, s_loc, hkv, d), device=dev)
        dvb = torch.zeros((b, s_loc, hkv, d), device=dev)
        for t in range(n):
            src = (idx - t) % n
            if not causal or src <= idx:
                kf = kb.float()
                s_blk = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf)
                k_pos = src * s_loc + torch.arange(s_loc, device=dev)
                valid = maskb.bool()[:, None, None, None, :]
                if causal:
                    valid = valid & (q_pos[None, None, None, :, None]
                                     >= k_pos[None, None, None, None, :])
                s_blk = torch.where(valid, s_blk,
                                    torch.full_like(s_blk, NEG_LARGE))
                p = torch.exp(s_blk - m[..., None]) * inv_l[..., None]
                dvb = dvb + torch.einsum("bhgqk,bqhgd->bkhd", p, do)
                dp = torch.einsum("bqhgd,bkhd->bhgqk", do, vb.float())
                ds = p * (dp - delta[..., None])
                ds = torch.where(valid, ds, torch.zeros_like(ds))
                dq = dq + torch.einsum("bhgqk,bkhd->bqhgd", ds, kf)
                dkb = dkb + torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
            if t + 1 < n:
                kb, vb, maskb, dkb, dvb = mesh_mod.ring_shift(
                    [kb, vb, maskb, dkb, dvb], group)
        # the accumulators are one hop short of their owners
        dkb, dvb = mesh_mod.ring_shift([dkb, dvb], group)
        dq = (dq * scale).reshape(b, s_loc, hq, d).to(q.dtype)
        return dq, dkb.to(k.dtype), dvb.to(v.dtype), None, None, None, None


def ring_attention(q, k, v, kv_mask, *, group, causal: bool = True,
                   scale: Optional[float] = None):
    """Blockwise ring attention on this rank's shards. q (B, S_loc, Hq,
    D); k, v (B, S_loc, Hkv, D), Hq % Hkv == 0; kv_mask (B, S_loc) the
    local keys' validity. The rank at index i of `group` holds global rows
    [i S_loc, (i + 1) S_loc); causality compares global indices (the
    right-pad contract of layers.causal_mask). Returns this rank's (B,
    S_loc, Hq, D) output, equal to single-device attention up to float
    reassociation; a row with no valid key gets the uniform mean of v,
    as attention_xla gives it. With grad on and any of q, k, v requiring
    it, the gradient runs the reverse ring of `_RingAttention`: every
    rank of `group` must call its backward too."""
    scale = (1.0 / math.sqrt(q.shape[-1])) if scale is None else scale
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _RingAttention.apply(q, k, v, kv_mask, group, causal, scale)
    return _ring_forward(q, k, v, kv_mask, group, causal, scale)[0]


def sharded_decode_attention(q, k_shard, v_shard, kv_mask, *, group,
                             scale: Optional[float] = None):
    """Decode attention over a sequence-sharded cache: every rank holds
    the same queries q (B, Sq, Hq, D) and its shard of the cache k/v (B,
    S_loc, Hkv, D) with validity kv_mask (B, S_loc). The partial softmaxes
    merge by the log-sum-exp rule: m = max m_i, l = sum l_i e^(m_i - m),
    out = sum acc_i e^(m_i - m) / l (one MAX and two SUM all-reduces). A
    slot must be valid on exactly one rank."""
    b, sq, hq, d = q.shape
    hkv = k_shard.shape[2]
    g = hq // hkv
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    qf = (q.float() * scale).reshape(b, sq, hkv, g, d)
    s_blk = torch.einsum("bqhgd,bkhd->bhgqk", qf, k_shard.float())
    s_blk = torch.where(kv_mask.bool()[:, None, None, None, :], s_blk,
                        torch.full_like(s_blk, NEG_LARGE))
    m = mesh_mod.all_reduce(s_blk.amax(dim=-1), group, dist.ReduceOp.MAX)
    p = torch.exp(s_blk - m[..., None])
    l = mesh_mod.all_reduce(p.sum(dim=-1), group)
    acc = mesh_mod.all_reduce(
        torch.einsum("bhgqk,bkhd->bqhgd", p, v_shard.float()), group)
    out = acc / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, sq, hq, d).to(q.dtype)


def ring_self_attention(mesh: SeqMesh, q, k, v, mask, *,
                        causal: bool = True):
    """GLOBAL (B, S, H, D) q/k/v and (B, S) mask on every rank -> the
    global output on every rank: the ring runs on this rank's S/n rows and
    the shards' outputs are all-gathered (the JAX shard_map wrapper's
    contract). S must divide by the mesh size."""
    n, i = mesh.size, mesh.index
    s = q.shape[1]
    if s % n:
        raise ValueError(f"sequence length {s} does not divide over "
                         f"{n} shards")
    sl = slice(i * (s // n), (i + 1) * (s // n))
    out = ring_attention(q[:, sl], k[:, sl], v[:, sl], mask[:, sl],
                         group=mesh.group, causal=causal)
    return mesh_mod.all_gather_cat(out, mesh.group, dim=1)
