"""FusedLayerNorm — counterpart of
``apex_tpu/normalization/fused_layer_norm.py``.

The functional forms run an ``autograd.Function`` (the JAX ``custom_vjp``
``_fused_norm``) whose forward is
:func:`~apex_tpu_torch.ops.layer_norm_kernel.ln_fwd` and whose backward is
:func:`~apex_tpu_torch.ops.layer_norm_kernel.ln_bwd` (the CUDA kernels for
CUDA tensors, their plain versions for CPU tensors). Like the JAX
default (``memory_efficient=False``) it saves x, mean and invvar;
``memory_efficient=True`` belongs to a later slice and raises.
The JAX package sends hidden sizes that are not a multiple of 128 to its
jnp reference because of the TPU's 128-lane tiles; the Hopper kernel has
no such rule and takes any hidden size up to
:data:`~apex_tpu_torch.ops.tiling.LN_MAX_HIDDEN` (8192), raising above it
for CUDA tensors. ``manual_layer_norm`` is the plain reference the tests
hold the kernel path against.
"""

from __future__ import annotations

import numbers
from typing import Optional, Sequence, Union

import torch
from torch import nn

from apex_tpu_torch.ops.layer_norm_kernel import ln_bwd, ln_fwd
from apex_tpu_torch.ops.tiling import LN_MAX_HIDDEN
from apex_tpu_torch.utils.device import DeviceLike

Shape = Union[int, Sequence[int]]

__all__ = ["LN_MAX_HIDDEN", "FusedLayerNorm", "fused_layer_norm_affine",
           "manual_layer_norm"]


def _norm_size(normalized_shape: Shape) -> int:
    if isinstance(normalized_shape, numbers.Integral):
        return int(normalized_shape)
    out = 1
    for d in normalized_shape:
        out *= int(d)
    return out


def manual_layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
                      bias: Optional[torch.Tensor], normalized_shape: Shape,
                      eps: float) -> torch.Tensor:
    """Plain LayerNorm over the trailing ``normalized_shape`` (fp32 math,
    output in x's dtype)."""
    h = _norm_size(normalized_shape)
    x2 = x.reshape(-1, h).float()
    mu = x2.mean(dim=1, keepdim=True)
    xc = x2 - mu
    y = xc * torch.rsqrt((xc * xc).mean(dim=1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.reshape(1, h).float()
    if bias is not None:
        y = y + bias.reshape(1, h).float()
    return y.reshape(x.shape).to(x.dtype)


class _FusedLayerNormAffine(torch.autograd.Function):
    """``_fused_norm`` with its ``custom_vjp`` (LayerNorm, affine, x
    saved): dx, dgamma and dbeta (None without a bias) from the kernels."""

    @staticmethod
    def forward(ctx, x, weight, bias, hidden, eps):
        x2 = x.reshape(-1, hidden).contiguous()
        y, mean, invvar = ln_fwd(x2, weight, bias, eps=eps)
        ctx.save_for_backward(x2, weight, bias, mean, invvar)
        ctx.xshape = x.shape
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, weight, bias, mean, invvar = ctx.saved_tensors
        dx, dgamma, dbeta = ln_bwd(dy.reshape(x2.shape).contiguous(), x2,
                                   weight, bias, mean, invvar)
        return dx.reshape(ctx.xshape), dgamma, dbeta, None, None


def fused_layer_norm_affine(x: torch.Tensor, weight: torch.Tensor,
                            bias: Optional[torch.Tensor],
                            normalized_shape: Shape, eps: float = 1e-5,
                            memory_efficient: bool = False) -> torch.Tensor:
    """LayerNorm with fp32 ``weight`` and ``bias`` (or None) through the
    kernels, differentiable in x, weight and bias."""
    if memory_efficient:
        raise NotImplementedError(
            "fused_layer_norm_affine: memory_efficient=True is not ported "
            "yet (ROADMAP.md, port queue)")
    h = _norm_size(normalized_shape)
    return _FusedLayerNormAffine.apply(
        x, weight.reshape(h), None if bias is None else bias.reshape(h), h,
        float(eps))


class FusedLayerNorm(nn.Module):
    """LayerNorm module with fp32 ``weight`` (ones) and ``bias`` (zeros),
    the parameter names and dtype of the flax module."""

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5, *,
                 device: DeviceLike = None):
        super().__init__()
        self.normalized_shape = normalized_shape
        self.eps = eps
        h = _norm_size(normalized_shape)
        self.weight = nn.Parameter(
            torch.ones(h, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(
            torch.zeros(h, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_layer_norm_affine(x, self.weight, self.bias,
                                       self.normalized_shape, self.eps)
