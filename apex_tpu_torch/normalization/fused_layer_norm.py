"""FusedLayerNorm / FusedRMSNorm — counterpart of
``apex_tpu/normalization/fused_layer_norm.py``.

The functional forms run one ``autograd.Function`` (the JAX
``custom_vjp`` ``_fused_norm``, with its ``rms`` and ``affine`` flags)
whose forward is :func:`~apex_tpu_torch.ops.layer_norm_kernel.ln_fwd` and
whose backward is :func:`~apex_tpu_torch.ops.layer_norm_kernel.ln_bwd`
(the CUDA kernels for CUDA tensors, their plain versions for CPU tensors).
Like the JAX default (``memory_efficient=False``) it saves x, mean and
invvar (RMSNorm saves no mean: the backward does not read it);
``memory_efficient=True`` belongs to a later slice and raises.
Every width runs the kernels: the JAX package's ``_pallas_ok`` sends
hidden sizes above 65536, or not a multiple of 128, to its plain
reference because of the TPU's VMEM and 128-lane tiles, rules the Hopper
kernels do not need. The weight and bias may be float32 or bfloat16;
their gradients come back in their own dtype, as in the JAX
``custom_vjp``. ``manual_layer_norm`` / ``manual_rms_norm`` are the plain
references the tests hold the kernel path against.
"""

from __future__ import annotations

import numbers
from typing import Optional, Sequence, Union

import torch
from torch import nn

from apex_tpu_torch.ops.layer_norm_kernel import ln_bwd, ln_fwd
from apex_tpu_torch.ops.tiling import LN_MAX_HIDDEN
from apex_tpu_torch.utils.device import DeviceLike, resolve_device

Shape = Union[int, Sequence[int]]

__all__ = ["LN_MAX_HIDDEN", "FusedLayerNorm", "FusedRMSNorm",
           "fused_layer_norm", "fused_layer_norm_affine", "fused_rms_norm",
           "fused_rms_norm_affine", "manual_layer_norm", "manual_rms_norm"]


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


def manual_rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
                    normalized_shape: Shape, eps: float) -> torch.Tensor:
    """Plain RMSNorm over the trailing ``normalized_shape`` (fp32 math,
    output in x's dtype)."""
    h = _norm_size(normalized_shape)
    x2 = x.reshape(-1, h).float()
    y = x2 * torch.rsqrt((x2 * x2).mean(dim=1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.reshape(1, h).float()
    return y.reshape(x.shape).to(x.dtype)


class _FusedNorm(torch.autograd.Function):
    """``_fused_norm`` with its ``custom_vjp`` (x saved): LayerNorm or
    RMSNorm, with a weight (and a bias, LayerNorm only) or without; dx,
    dweight and dbias (None where there is none) from the kernels, the
    last two in the weight's and the bias's dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias, hidden, eps, rms):
        x2 = x.reshape(-1, hidden).contiguous()
        y, mean, invvar = ln_fwd(x2, weight, bias, eps=eps, rms=rms)
        ctx.save_for_backward(x2, weight, bias, None if rms else mean,
                              invvar)
        ctx.xshape, ctx.rms = x.shape, rms
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, weight, bias, mean, invvar = ctx.saved_tensors
        dx, dweight, dbias = ln_bwd(dy.reshape(x2.shape).contiguous(), x2,
                                    weight, bias, mean, invvar, rms=ctx.rms)
        if dweight is not None:
            dweight = dweight.to(weight.dtype)
        if dbias is not None:
            dbias = dbias.to(bias.dtype)
        return dx.reshape(ctx.xshape), dweight, dbias, None, None, None


def _fused_norm(x, weight, bias, normalized_shape, eps, rms,
                memory_efficient, name):
    if memory_efficient:
        raise NotImplementedError(
            f"{name}: memory_efficient=True is not ported yet (ROADMAP.md, "
            f"port queue)")
    h = _norm_size(normalized_shape)
    return _FusedNorm.apply(
        x, None if weight is None else weight.reshape(h),
        None if bias is None else bias.reshape(h), h, float(eps), rms)


def fused_layer_norm_affine(x: torch.Tensor, weight: torch.Tensor,
                            bias: Optional[torch.Tensor],
                            normalized_shape: Shape, eps: float = 1e-5,
                            memory_efficient: bool = False) -> torch.Tensor:
    """LayerNorm with a float32 or bfloat16 ``weight`` and ``bias`` (or
    None) through the kernels, differentiable in x, weight and bias."""
    return _fused_norm(x, weight, bias, normalized_shape, eps, False,
                       memory_efficient, "fused_layer_norm_affine")


def fused_layer_norm(x: torch.Tensor, normalized_shape: Shape,
                     eps: float = 1e-5,
                     memory_efficient: bool = False) -> torch.Tensor:
    """LayerNorm without an affine step, differentiable in x."""
    return _fused_norm(x, None, None, normalized_shape, eps, False,
                       memory_efficient, "fused_layer_norm")


def fused_rms_norm_affine(x: torch.Tensor, weight: torch.Tensor,
                          normalized_shape: Shape, eps: float = 1e-5,
                          memory_efficient: bool = False) -> torch.Tensor:
    """RMSNorm with a float32 or bfloat16 ``weight`` through the kernels,
    differentiable in x and weight."""
    return _fused_norm(x, weight, None, normalized_shape, eps, True,
                       memory_efficient, "fused_rms_norm_affine")


def fused_rms_norm(x: torch.Tensor, normalized_shape: Shape,
                   eps: float = 1e-5,
                   memory_efficient: bool = False) -> torch.Tensor:
    """RMSNorm without an affine step, differentiable in x."""
    return _fused_norm(x, None, None, normalized_shape, eps, True,
                       memory_efficient, "fused_rms_norm")


class FusedLayerNorm(nn.Module):
    """LayerNorm module; with ``elementwise_affine`` (the default) fp32
    ``weight`` (ones) and ``bias`` (zeros), the parameter names and dtype
    of the flax module, on ``device`` (default ``cuda``)."""

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5,
                 elementwise_affine: bool = True, *,
                 device: DeviceLike = None):
        super().__init__()
        self.normalized_shape = normalized_shape
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        dev = resolve_device(device)
        if elementwise_affine:
            h = _norm_size(normalized_shape)
            self.weight = nn.Parameter(
                torch.ones(h, dtype=torch.float32, device=dev))
            self.bias = nn.Parameter(
                torch.zeros(h, dtype=torch.float32, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.elementwise_affine:
            return fused_layer_norm_affine(x, self.weight, self.bias,
                                           self.normalized_shape, self.eps)
        return fused_layer_norm(x, self.normalized_shape, self.eps)


class FusedRMSNorm(nn.Module):
    """RMSNorm module; with ``elementwise_affine`` (the default) an fp32
    ``weight`` (ones), the parameter name and dtype of the flax module, on
    ``device`` (default ``cuda``)."""

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5,
                 elementwise_affine: bool = True, *,
                 device: DeviceLike = None):
        super().__init__()
        self.normalized_shape = normalized_shape
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        dev = resolve_device(device)
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones(
                _norm_size(normalized_shape), dtype=torch.float32,
                device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.elementwise_affine:
            return fused_rms_norm_affine(x, self.weight,
                                         self.normalized_shape, self.eps)
        return fused_rms_norm(x, self.normalized_shape, self.eps)
