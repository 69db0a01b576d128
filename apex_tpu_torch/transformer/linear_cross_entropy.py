"""Chunked-vocabulary linear + cross-entropy head — counterpart of
``apex_tpu/transformer/linear_cross_entropy.py``.

``linear_cross_entropy(hidden, weight, labels)`` is the per-row loss of
``softmax_cross_entropy_loss(hidden @ weight, labels)`` without the
``(N, V)`` logits: the vocabulary is scanned in chunks of ``chunk``
columns with an online logsumexp, so one ``(N, chunk)`` fp32 tile exists at
a time. Columns of the last chunk past V are masked to -1e30. Label
smoothing ``smoothing``, ``padding_idx`` rows (zero loss and gradient) and
``logit_scale`` as in the JAX function. The ``autograd.Function`` saves
``(hidden, weight, lse)`` and the labels, and its backward scans the
chunks again, rebuilding each logits tile once. The chunk products are
``torch.matmul``, as the JAX package leaves them to XLA outside any
Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_NEG = -1e30


def _chunk_logits(hidden, weight, c0, chunk, logit_scale):
    """The fp32 ``(N, chunk)`` logits tile of columns ``c0 ..``: the product
    in hidden's dtype, then fp32 times ``logit_scale``; columns past V at
    -1e30. Returns the tile and its column indices."""
    wc = weight[:, c0:c0 + chunk]
    x = torch.matmul(hidden, wc).float() * logit_scale
    if wc.shape[1] < chunk:
        x = F.pad(x, (0, chunk - wc.shape[1]), value=_NEG)
    col = c0 + torch.arange(chunk, device=hidden.device)
    return x, col, wc


def _lce_forward(hidden, weight, labels, smoothing, padding_idx, chunk,
                 logit_scale):
    n = hidden.shape[0]
    v = weight.shape[1]
    m = torch.full((n,), _NEG, dtype=torch.float32, device=hidden.device)
    s = torch.zeros(n, dtype=torch.float32, device=hidden.device)
    picked = torch.zeros_like(s)
    xsum = torch.zeros_like(s)
    lab = labels[:, None]
    for c0 in range(0, v, chunk):
        logits, col, _ = _chunk_logits(hidden, weight, c0, chunk,
                                       logit_scale)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(dim=-1)
        m = m_new
        picked = picked + torch.where(col == lab, logits, 0.0).sum(dim=-1)
        xsum = xsum + torch.where(col < v, logits, 0.0).sum(dim=-1)
    lse = torch.log(s) + m
    loss = lse - picked
    if smoothing > 0.0:
        loss = (1.0 - smoothing) * loss + smoothing * (lse - xsum / v)
    if padding_idx is not None:
        loss = torch.where(labels == padding_idx, 0.0, loss)
    return loss, lse


class _LinearCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden, weight, labels, smoothing, padding_idx, chunk,
                logit_scale):
        loss, lse = _lce_forward(hidden, weight, labels, smoothing,
                                 padding_idx, chunk, logit_scale)
        ctx.save_for_backward(hidden, weight, labels, lse)
        ctx.args = (smoothing, padding_idx, chunk, logit_scale)
        return loss

    @staticmethod
    def backward(ctx, dloss):
        hidden, weight, labels, lse = ctx.saved_tensors
        smoothing, padding_idx, chunk, logit_scale = ctx.args
        v = weight.shape[1]
        g = dloss.float()
        if padding_idx is not None:
            g = torch.where(labels == padding_idx, 0.0, g)
        dh = torch.zeros(hidden.shape, dtype=torch.float32,
                         device=hidden.device)
        dws = []
        lab = labels[:, None]
        for c0 in range(0, v, chunk):
            logits, col, wc = _chunk_logits(hidden, weight, c0, chunk,
                                            logit_scale)
            p = torch.exp(logits - lse[:, None])
            target = (1.0 - smoothing) * (col == lab).float()
            if smoothing > 0.0:
                target = target + torch.where(col < v, smoothing / v, 0.0)
            dl = ((p - target) * g[:, None] * logit_scale)[:, :wc.shape[1]]
            # the tile in hidden's dtype, products accumulated in fp32
            dl = dl.to(hidden.dtype).float()
            dh = dh + dl @ wc.float().t()
            dws.append((hidden.float().t() @ dl).to(weight.dtype))
        return (dh.to(hidden.dtype), torch.cat(dws, dim=1), None, None, None,
                None, None)


def linear_cross_entropy(hidden: torch.Tensor, weight: torch.Tensor,
                         labels: torch.Tensor, smoothing: float = 0.0,
                         padding_idx: Optional[int] = None,
                         chunk: int = 8192,
                         logit_scale: float = 1.0) -> torch.Tensor:
    """Per-row fp32 loss ``(N,)`` of ``hidden (N, H)`` against ``weight (H,
    V)`` and integer ``labels (N,)``, without the logits matrix: the same
    values as ``softmax_cross_entropy_loss(hidden @ weight, labels,
    smoothing, padding_idx)`` on the dense logits."""
    if chunk < 1:
        raise ValueError(f"linear_cross_entropy: chunk={chunk} must be >= 1")
    return _LinearCrossEntropy.apply(hidden, weight, labels.long(),
                                     float(smoothing), padding_idx,
                                     int(chunk), float(logit_scale))
