"""Ring attention: K/V shards rotate around the sp group while each rank
merges partial attentions with the online-softmax correction.

The counterpart of the JAX package's kernels/ring_attention.py. Each hop is
attend_shard: the plain flash-attention kernel's stats flavor of this rank's
q shard against one K/V shard, merged into the running (out, m, l). The
rotation is point-to-point: one dist.batch_isend_irecv per hop sends the
shard to the next rank of the sp group and takes the previous rank's
(global ranks, mapped from the group's). The backward runs the FA2 dQ and
dK/dV kernels per hop against the forward's merged (global) m and l, so
each hop's recomputed probabilities are exactly the global softmax's for
those keys; dK/dV travel with their shard and one more hop sends them home.
The path when the sp degree does not divide the local head count
(parallel/sharding.sequence_parallel_attention picks it).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from versecrafter_tpu_torch.kernels.flash_attention import flash_attention_with_stats
from versecrafter_tpu_torch.kernels.flash_attention_bwd import fa_backward

Partial = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _merge(o1, m1, l1, o2, m2, l2) -> Partial:
    """Two partial attentions over disjoint key sets -> one: the weights
    exp(m_i - m) l_i / l in fp32, cast to the outputs' dtype, and the
    weighted sum in fp32, cast back once, as the jitted JAX merge computes
    it. attend_shard keeps the running output in fp32, so on the ring both
    casts are exact and the merge rounds only in its fp32 arithmetic."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m) * l1
    a2 = torch.exp(m2 - m) * l2
    l = a1 + a2
    w1 = (a1 / torch.clamp(l, min=1e-38))[..., None].to(o1.dtype)
    w2 = (a2 / torch.clamp(l, min=1e-38))[..., None].to(o2.dtype)
    return (o1.float() * w1.float() + o2.float() * w2.float()).to(o1.dtype), m, l


def attend_shard(q, k, v, acc: Optional[Partial] = None) -> Partial:
    """One hop: (out, m, l) of q [B, N, Sq, D] against the key shard k, v
    [B, N, Skv, D] through the stats kernel, merged into `acc` (the hops
    so far) when given. The running out is fp32: each hop's output is
    rounded once, by the kernel, and the merges add no rounding."""
    o, m, l = flash_attention_with_stats(q, k, v)
    return (o.float(), m, l) if acc is None else _merge(*acc, o.float(), m, l)


def hop_backward(q, k, v, o, m, l, do):
    """One hop of the backward: (dq, dk, dv) of q's attention to the key
    shard k, v, from the forward's merged (global) o, m, l and the output
    cotangent do, through the FA2 dQ and dK/dV kernels (every key of the
    shard visible)."""
    k_lens = torch.full((q.shape[0],), k.shape[2], dtype=torch.int32, device=q.device)
    return fa_backward(q, k, v, o, m, l, do, k_lens, 1.0 / math.sqrt(q.shape[-1]))


def _rotate(tensors, group, ranks):
    """Each tensor to the next rank of the group, the previous rank's in
    return (one batch of P2P ops)."""
    me = dist.get_rank(group)
    nxt, prv = ranks[(me + 1) % len(ranks)], ranks[(me - 1) % len(ranks)]
    tensors = [t.contiguous() for t in tensors]
    out = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, prv, group) for o in out]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out


def _ring_forward(q, k, v, group, ranks) -> Partial:
    acc = attend_shard(q, k, v)
    kb, vb = k, v
    for _ in range(len(ranks) - 1):
        kb, vb = _rotate((kb, vb), group, ranks)
        acc = attend_shard(q, kb, vb, acc)
    o, m, l = acc
    return o.to(q.dtype), m, l


class _RingFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, ranks):
        o, m, l = _ring_forward(q, k, v, group, ranks)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.group, ctx.ranks = group, ranks
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        group, ranks = ctx.group, ctx.ranks
        do = do.contiguous()

        def local(kb, vb):
            return hop_backward(q, kb, vb, o, m, l, do)

        dq, dkb, dvb = (t.float() for t in local(k, v))
        kb, vb = k, v
        for _ in range(len(ranks) - 1):
            # dK/dV rotate with their shard, so each accumulates where its
            # keys are
            kb, vb, dkb, dvb = _rotate((kb, vb, dkb, dvb), group, ranks)
            dq_p, dk_p, dv_p = local(kb, vb)
            dq, dkb, dvb = dq + dq_p.float(), dkb + dk_p.float(), dvb + dv_p.float()
        # after sp - 1 hops the buffers hold shard (r + 1) mod sp: one more
        # hop sends each home
        dkb, dvb = _rotate((dkb, dvb), group, ranks)
        return dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype), None, None


def ring_attention(q, k, v, group, ranks=None) -> torch.Tensor:
    """Exact (non-causal) attention of this rank's q/k/v shards [B, N,
    S/sp, D] over the whole sequence held by the ranks of `group` (in
    sequence order; `ranks` their global ranks, default the group's).
    Differentiable."""
    if ranks is None:
        ranks = dist.get_process_group_ranks(group)
    return _RingFn.apply(q.contiguous(), k.contiguous(), v.contiguous(), group, tuple(ranks))
