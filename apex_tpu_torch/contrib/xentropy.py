"""Fused softmax cross-entropy with label smoothing — counterpart of
``apex_tpu/contrib/xentropy.py`` ``softmax_cross_entropy_loss``.

As in the JAX ``custom_vjp``, the forward keeps one fp32 log-sum-exp per
row beside the logits and labels it needs anyway, and the backward
rebuilds the softmax from them instead of saving the probabilities.
``padding_idx`` rows give zero loss and zero gradient whatever the
label's value (``padding_idx=-1``, the MLM ignore index, included): the
gather and the scatter read such rows at column 0 and the result is
masked afterwards, so no index is ever out of range. ``smoothing`` ε
splits the target as (1-ε)·one_hot + ε/K·uniform. Plain PyTorch: the JAX
package has no Pallas kernel here.
"""

from __future__ import annotations

from typing import Optional

import torch


def _in_range(labels: torch.Tensor, padding_idx: Optional[int]
              ) -> torch.Tensor:
    """The labels to gather / scatter at: padding rows read column 0 (their
    result is masked), so a padding label outside ``[0, K)`` is never used
    as an index."""
    if padding_idx is None:
        return labels
    return labels.masked_fill(labels == padding_idx, 0)


def _xent_fwd(x: torch.Tensor, labels: torch.Tensor, smoothing: float,
              padding_idx: Optional[int]):
    """``_xent_fwd_math`` on fp32 logits: ``(loss, lse)``."""
    m = x.amax(dim=-1, keepdim=True)
    lse = (torch.log(torch.exp(x - m).sum(dim=-1, keepdim=True))
           + m).squeeze(-1)
    picked = x.gather(-1, _in_range(labels, padding_idx)[..., None]) \
        .squeeze(-1)
    loss = lse - picked
    if smoothing > 0.0:
        loss = (1.0 - smoothing) * loss + smoothing * (lse - x.mean(dim=-1))
    if padding_idx is not None:
        loss = torch.where(labels == padding_idx, 0.0, loss)
    return loss, lse


class _SoftmaxCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, labels, smoothing, padding_idx):
        loss, lse = _xent_fwd(logits.float(), labels, smoothing,
                              padding_idx)
        ctx.save_for_backward(logits, labels, lse)
        ctx.smoothing, ctx.padding_idx = smoothing, padding_idx
        return loss

    @staticmethod
    def backward(ctx, dloss):
        logits, labels, lse = ctx.saved_tensors
        s, k = ctx.smoothing, logits.shape[-1]
        # softmax from the saved lse, minus the target, times dloss
        g = torch.exp(logits.float() - lse[..., None])
        if s > 0.0:
            g = g - s / k
        g.scatter_add_(-1, _in_range(labels, ctx.padding_idx)[..., None],
                       torch.full_like(lse[..., None], -(1.0 - s)))
        g = g * dloss[..., None].float()
        if ctx.padding_idx is not None:
            g = g.masked_fill((labels == ctx.padding_idx)[..., None], 0.0)
        return g.to(logits.dtype), None, None, None


def softmax_cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                               smoothing: float = 0.0,
                               padding_idx: Optional[int] = None
                               ) -> torch.Tensor:
    """Per-row fp32 loss, shape ``labels.shape``; logits ``(..., K)``,
    labels int64 ``(...)``."""
    return _SoftmaxCrossEntropy.apply(logits, labels.long(),
                                      float(smoothing), padding_idx)
