"""FusedLayerNorm — counterpart of
``apex_tpu/normalization/fused_layer_norm.py``, forward only.

The functional forms run :func:`~apex_tpu_torch.ops.layer_norm_kernel.ln_fwd`
(the CUDA kernel for CUDA tensors, its plain version for CPU tensors).
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

from apex_tpu_torch.ops.layer_norm_kernel import ln_fwd
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


def fused_layer_norm_affine(x: torch.Tensor, weight: torch.Tensor,
                            bias: Optional[torch.Tensor],
                            normalized_shape: Shape,
                            eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 ``weight`` / ``bias`` through the kernel."""
    h = _norm_size(normalized_shape)
    y, _, _ = ln_fwd(x.reshape(-1, h).contiguous(), weight.reshape(h),
                     None if bias is None else bias.reshape(h), eps=eps)
    return y.reshape(x.shape)


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
