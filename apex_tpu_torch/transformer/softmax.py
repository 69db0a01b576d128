"""The megatron attention-score softmax family — counterpart of
``apex_tpu/transformer/softmax.py`` (apex's ``scaled_softmax_cuda``,
``scaled_masked_softmax_cuda``, ``scaled_upper_triang_masked_softmax_cuda``
and ``generic_scaled_masked_softmax_cuda``).

Semantics as in the reference: scale first, masked positions (mask
nonzero / True) REPLACED by -10000 (not -inf), fully masked rows give
zeros, fp32 math whatever the IO dtype, and a backward ``(dy - sum(dy *
y)) * y * scale`` that saves only the output y (one
``torch.autograd.Function``, as the JAX ``_pallas_softmax`` custom VJP).

Routing: a CUDA tensor launches the kernels of
:mod:`apex_tpu_torch.ops.softmax_kernel` at every shape (any ``sk``, any
mask that broadcasts to x, rank >= 2); a CPU tensor runs their plain
versions. JAX's TPU routing rules (its 16,384-column limit and the mask
layouts ``_pallas_route`` accepts) do not apply: the kernels take every
case those rules send to JAX's plain route. The mask is read as "nonzero
= masked" on both devices; JAX's plain route computes ``1 - mask`` and so
differs from its own kernel for mask values other than 0 and 1.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops.softmax_kernel import softmax_bwd, softmax_fwd


class _ScaledSoftmax(torch.autograd.Function):
    """y = the scaled (masked / causal) softmax of x; saves y only."""

    @staticmethod
    def forward(ctx, x, mask, scale, causal):
        y = softmax_fwd(x, mask, scale=scale, causal=causal)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return softmax_bwd(y, dy, scale=ctx.scale), None, None, None


def scaled_softmax(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """``scaled_softmax_cuda`` (no mask). x: ``(..., sq, sk)``."""
    return _ScaledSoftmax.apply(x, None, float(scale), False)


def scaled_masked_softmax(x: torch.Tensor, mask: Optional[torch.Tensor],
                          scale: float = 1.0) -> torch.Tensor:
    """``scaled_masked_softmax_cuda``: ``mask`` is bool or integer,
    nonzero = masked, broadcastable to x; masked positions are replaced by
    -10000 after scaling."""
    if mask is None:
        return scaled_softmax(x, scale)
    return _ScaledSoftmax.apply(x, mask, float(scale), False)


def scaled_upper_triang_masked_softmax(x: torch.Tensor,
                                       scale: float = 1.0) -> torch.Tensor:
    """``scaled_upper_triang_masked_softmax_cuda`` (causal scores): position
    (i, j) of the last two dimensions is masked when j > i."""
    return _ScaledSoftmax.apply(x, None, float(scale), True)


def generic_scaled_masked_softmax(x: torch.Tensor,
                                  mask: Optional[torch.Tensor],
                                  scale: float = 1.0) -> torch.Tensor:
    """``generic_scaled_masked_softmax_cuda``, the variant of unlimited row
    length: the same kernels, whose streaming form takes rows of any
    length."""
    return scaled_masked_softmax(x, mask, scale)


def get_batch_per_block(sq: int, sk: int, b: int, np_: int) -> int:
    """API-parity helper (``scaled_masked_softmax.cpp:74``): 1, as in the
    JAX package; the kernels choose their own geometry from sk
    (:func:`apex_tpu_torch.ops.tiling.softmax_form`)."""
    return 1
