"""Ring attention: attention over a sequence split across the ranks of a
:class:`RankGroup` (context parallelism).

Counterpart of ``apex_tpu/parallel/ring_attention.py``. Each rank keeps
its query shard; the K / V shards travel around the ring, one hop a step,
and each rank merges the partial attention of every shard it sees by
log-sum-exp (:func:`_merge`). Every block is the port's flash kernels
(``flash_attention_fwd`` / ``flash_attention_bwd``). The backward runs the
ring once more: dK / dV accumulators travel with the K / V shards, each
rank adding its block's share as a shard passes, and a last hop brings
them home; dQ stays. The hops are exactly JAX's: n - 1 K / V hops forward,
n - 1 K / V hops and n dK / dV hops backward.

``transport="rdma"`` makes each hop a peer put
(:func:`~apex_tpu_torch.ops.remote_copy.peer_shift`: the ``peer_put`` /
``peer_wait`` kernels for CUDA tensors, its gloo plain version for CPU
tensors). ``transport="collective"`` is the gloo all-gather of
:func:`~apex_tpu_torch.ops.remote_copy.ppermute`, for CPU tensors; a CUDA
tensor there raises. The hops and the blocks run one after another on
the current stream (JAX's scheduler overlaps them; here that is later
work).

Two layouts: contiguous (:func:`ring_self_attention`, rank i holds chunk
i) and zigzag (:func:`zigzag_ring_self_attention`, rank i holds chunks i
and 2n - 1 - i of :func:`zigzag_shard`'s 2n, which balances causal work).
Causal gating selects, never multiplies: a shard in a rank's future has
its lse replaced by -1e30 and its gradients dropped, since those
partials can be non-finite.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from apex_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                flash_attention_fwd,
                                                validate_blocks)
from apex_tpu_torch.ops.remote_copy import peer_shift, ppermute

_NEG = -1e30
_f32 = torch.float32


def _merge(o1, lse1, o2, lse2):
    """Log-sum-exp merge of two partial attention results ``(o, lse)``."""
    m = torch.maximum(lse1, lse2)
    m = torch.where(torch.isfinite(m), m, 0.0)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    tot = w1 + w2
    safe = torch.where(tot > 0, tot, 1.0)
    o = (o1 * w1[..., None] + o2 * w2[..., None]) / safe[..., None]
    lse = torch.where(tot > 0, m + torch.log(safe), _NEG)
    return o, lse


def _rotate(x, group, transport):
    """One +1 hop of ``x`` around the ring."""
    if transport == "rdma":
        return peer_shift(x, group, 1)
    return ppermute(x, group, 1)


def _check(transport, block_q, block_k):
    if transport not in ("collective", "rdma"):
        raise ValueError(f"unknown transport {transport!r}")
    validate_blocks(block_q, block_k)


def _fwd(q, k, v, s, causal):
    return flash_attention_fwd(q.contiguous(), k.contiguous(),
                               v.contiguous(), scale=s, causal=causal)


def _bwd(q, k, v, o, lse, do, s, causal):
    return flash_attention_bwd(q.contiguous(), k.contiguous(),
                               v.contiguous(), o.contiguous(),
                               lse.contiguous(), do.contiguous(), scale=s,
                               causal=causal)


# ------------------------------------------------------------- the ring


def _earlier(group, step):
    """Whether the shard that made ``step + 1`` hops, rank ``(my - step -
    1) mod n``'s, precedes this rank's."""
    n, my = group.axis_size(), group.axis_index()
    return (my - step - 1) % n < my


def _ring_fwd(q, k, v, group, s, transport, diag_causal, block):
    """The ring forward: the diagonal block, then the n - 1 shards that
    arrive one hop at a time, merged. ``block(k, v, earlier)`` is one
    arriving shard's ``(o fp32, lse)``."""
    n = group.axis_size()
    o, lse = _fwd(q, k, v, s, diag_causal)
    o = o.float()

    def merge_step(o, lse, k_cur, v_cur, step):
        return _merge(o, lse, *block(k_cur, v_cur, _earlier(group, step)))

    if n > 1:
        k1 = _rotate(k, group, transport)
        v1 = _rotate(v, group, transport)
        for step in range(n - 2):
            k_nxt = _rotate(k1, group, transport)
            v_nxt = _rotate(v1, group, transport)
            o, lse = merge_step(o, lse, k1, v1, step)
            k1, v1 = k_nxt, v_nxt
        # the last step is peeled: no n-th K / V hop
        o, lse = merge_step(o, lse, k1, v1, n - 2)
    return o.to(q.dtype), lse


def _ring_bwd(q, k, v, o, lse, do, group, s, transport, diag_causal,
              block):
    """The ring backward: dK / dV travel with their K / V shards, each
    rank adding its block's share, and take an n-th hop home; dQ stays.
    ``block(k, v, earlier)`` is one shard's fp32 ``(dq, dk, dv)``."""
    n = group.axis_size()
    dq, dk, dv = (t.float() for t in _bwd(q, k, v, o, lse, do, s,
                                          diag_causal))
    if n > 1:
        k1 = _rotate(k, group, transport)
        v1 = _rotate(v, group, transport)
        dk1 = _rotate(dk, group, transport)
        dv1 = _rotate(dv, group, transport)
        for step in range(n - 2):
            dq_j, dk_j, dv_j = block(k1, v1, _earlier(group, step))
            dq = dq + dq_j
            k1 = _rotate(k1, group, transport)
            v1 = _rotate(v1, group, transport)
            dk1 = _rotate(dk1 + dk_j, group, transport)
            dv1 = _rotate(dv1 + dv_j, group, transport)
        dq_j, dk_j, dv_j = block(k1, v1, _earlier(group, n - 2))
        dq = dq + dq_j
        dk = _rotate(dk1 + dk_j, group, transport)
        dv = _rotate(dv1 + dv_j, group, transport)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _contiguous_blocks(q, o, lse, do, s, causal):
    """Contiguous layout: every arriving shard is a full non-causal block;
    under causal masking a later rank's shard is selected away (its lse
    -1e30, its gradients dropped)."""
    def fwd(k, v, earlier):
        o_i, lse_i = _fwd(q, k, v, s, False)
        if causal and not earlier:
            lse_i = torch.full_like(lse_i, _NEG)
        return o_i.float(), lse_i

    def bwd(k, v, earlier):
        dq_j, dk_j, dv_j = _bwd(q, k, v, o, lse, do, s, False)
        if causal and not earlier:
            zk = torch.zeros_like(dk_j, dtype=_f32)
            return torch.zeros_like(dq_j, dtype=_f32), zk, zk
        return dq_j.float(), dk_j.float(), dv_j.float()

    return fwd, bwd


def _zigzag_blocks(q, o, lse, do, s):
    """Zigzag layout, local [low chunk, high chunk] of c rows: an earlier
    rank's shard is seen by every local query through its low chunk only;
    a later rank's shard only by the local high queries, whole. Both cost
    the same 2c x c block."""
    c = q.shape[2] // 2

    def fwd(k, v, earlier):
        if earlier:
            o_i, lse_i = _fwd(q, k[:, :, :c], v[:, :, :c], s, False)
            return o_i.float(), lse_i
        o_hi, lse_hi = _fwd(q[:, :, c:], k, v, s, False)
        return (torch.cat([torch.zeros_like(o_hi, dtype=_f32), o_hi.float()],
                          dim=2),
                torch.cat([torch.full_like(lse_hi, _NEG), lse_hi], dim=2))

    def bwd(k, v, earlier):
        if earlier:
            dq_j, dk_lo, dv_lo = _bwd(q, k[:, :, :c], v[:, :, :c], o, lse,
                                      do, s, False)
            zeros = torch.zeros_like(dk_lo, dtype=_f32)
            return (dq_j.float(), torch.cat([dk_lo.float(), zeros], dim=2),
                    torch.cat([dv_lo.float(), zeros], dim=2))
        dq_hi, dk_j, dv_j = _bwd(q[:, :, c:], k, v, o[:, :, c:],
                                 lse[:, :, c:], do[:, :, c:], s, False)
        return (torch.cat([torch.zeros_like(dq_hi, dtype=_f32),
                           dq_hi.float()], dim=2),
                dk_j.float(), dv_j.float())

    return fwd, bwd


class _RingAttention(torch.autograd.Function):
    """JAX's ``custom_vjp``s of both layouts: saves q, k, v, o and the
    merged fp32 lse; the backward runs the ring once more. The zigzag
    layout is causal, its diagonal plain causal (the local [lo, hi] keeps
    global order)."""

    @staticmethod
    def forward(ctx, q, k, v, group, zigzag, causal, scale, transport):
        fwd, _ = (_zigzag_blocks(q, None, None, None, scale) if zigzag
                  else _contiguous_blocks(q, None, None, None, scale,
                                          causal))
        o, lse = _ring_fwd(q, k, v, group, scale, transport, causal, fwd)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (group, zigzag, causal, scale, transport)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group, zigzag, causal, scale, transport = ctx.args
        _, bwd = (_zigzag_blocks(q, o, lse, do, scale) if zigzag
                  else _contiguous_blocks(q, o, lse, do, scale, causal))
        dq, dk, dv = _ring_bwd(q, k, v, o, lse, do, group, scale, transport,
                               causal, bwd)
        return dq, dk, dv, None, None, None, None, None


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        group, causal: bool = False,
                        scale: Optional[float] = None, block_q: int = 128,
                        block_k: int = 128,
                        transport: str = "collective") -> torch.Tensor:
    """Attention of this rank's query shard ``(b, h, s_local, d)`` over
    the whole sequence, split contiguously over ``group`` (rank i holds
    chunk i). Returns the local output shard; differentiable in q, k, v.
    ``block_q`` / ``block_k`` are the JAX signature's TPU tiles, checked
    by its rule and otherwise unused. For causal training prefer
    :func:`zigzag_ring_self_attention`."""
    _check(transport, block_q, block_k)
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _RingAttention.apply(q, k, v, group, False, bool(causal),
                                float(s), transport)


def ring_attention(q, k, v, group, causal: bool = False,
                   scale: Optional[float] = None,
                   transport: str = "collective"):
    """:func:`ring_self_attention` under its conventional name."""
    return ring_self_attention(q, k, v, group, causal, scale,
                               transport=transport)


# ---------------------------------------------------------- zigzag layout


def zigzag_shard(x: torch.Tensor, n: int, axis: int = 2) -> torch.Tensor:
    """Reorder a global sequence axis so that a contiguous n-way split
    gives rank i chunks i and 2n - 1 - i of 2n."""
    s = x.shape[axis]
    assert s % (2 * n) == 0, f"seq {s} must divide 2n={2 * n}"
    chunks = torch.chunk(x, 2 * n, dim=axis)
    order = []
    for i in range(n):
        order += [chunks[i], chunks[2 * n - 1 - i]]
    return torch.cat(order, dim=axis)


def zigzag_unshard(x: torch.Tensor, n: int, axis: int = 2) -> torch.Tensor:
    """Invert :func:`zigzag_shard`."""
    chunks = torch.chunk(x, 2 * n, dim=axis)
    inv = [None] * (2 * n)
    for i in range(n):
        inv[i] = chunks[2 * i]
        inv[2 * n - 1 - i] = chunks[2 * i + 1]
    return torch.cat(inv, dim=axis)


def zigzag_ring_self_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, group,
                               scale: Optional[float] = None,
                               block_q: int = 128, block_k: int = 128,
                               transport: str = "collective"
                               ) -> torch.Tensor:
    """Causal ring attention in the zigzag layout: the global sequence
    went through :func:`zigzag_shard` before the split, so this rank
    holds chunks [i, 2n - 1 - i]. Returns the local output shard in the
    same layout (:func:`zigzag_unshard` restores the order). Every ring
    step costs the same 2c x c block."""
    _check(transport, block_q, block_k)
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _RingAttention.apply(q, k, v, group, True, True, float(s),
                                transport)
