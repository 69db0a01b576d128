"""Fused dense layers — counterpart of
``apex_tpu/transformer/fused_dense.py``: the functions and the
:class:`FusedDense` / :class:`FusedDenseGeluDense` modules, whose
parameters carry the flax modules' names and layouts (``weight (out,
in)``, ``bias``; ``weight1`` ... ``bias2``).

In the JAX package these are plain matrix products that XLA fuses with
their bias and GELU epilogues; here they are PyTorch matrix products (no
hand-written kernel: the JAX package has no Pallas kernel for them).
The dtype steps are the JAX ones exactly: products accumulate in fp32
and come out in fp32 (``preferred_element_type=float32``), biases are
added in fp32, GELU is the exact erf form in fp32, and only then is the
result cast to the IO dtype.

Gradients: :func:`dense_gelu_dense` is an ``autograd.Function`` mirroring
the JAX ``custom_vjp`` (``_dgd_fwd`` / ``_dgd_bwd``): it saves x, the
weights and the fp32 pre-GELU h, and its backward products are fp32 as
the JAX ones are. :func:`matmul_f32` on bfloat16 is an
``autograd.Function`` too (cuBLAS's fp32-output product has no
derivative of its own): its backward products take bf16 operands and
accumulate in fp32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.utils.device import DeviceLike, resolve_device

# flax's lecun_normal draws from a normal truncated at +-2 sigma, rescaled by
# this constant so that the truncated distribution keeps variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def _mm_f32(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The forward product of :func:`matmul_f32` for a non-fp32 x."""
    if x.device.type == "cuda":
        out = torch.mm(x.reshape(-1, x.shape[-1]), weight.t(),
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], weight.shape[0])
    return torch.matmul(x.float(), weight.float().t())


def _mm_round_once(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two 2-D low-precision operands, summed in fp32 and
    rounded once to their dtype, as the JAX dot is. On the card cuBLAS
    is asked for the fp32 result and it is cast after: with a bf16
    result cuBLAS may add split-K partial sums in bf16, several roundings
    where the reference has one (the LM head's input gradient, a sum over
    the vocabulary, showed it in ``chip_smoke.py``'s cerebras check). The
    CPU's product already rounds once."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32).to(a.dtype)
    return a @ b


class _MatmulF32(torch.autograd.Function):
    """``x @ weight.T`` with an fp32 result from low-precision operands;
    the backward casts the fp32 cotangent to the operands' dtype and
    rounds each product once (:func:`_mm_round_once`)."""

    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return _mm_f32(x, weight)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g2 = g.to(x.dtype).reshape(-1, g.shape[-1])
        dx = _mm_round_once(g2, weight).reshape(*g.shape[:-1],
                                                weight.shape[1])
        dw = _mm_round_once(g2.t(), x.reshape(-1, x.shape[-1]))
        return dx, dw


def matmul_f32(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T`` (``weight (out, in)``, the same dtype as x) with
    fp32 accumulation and an fp32 result, for float32 or bfloat16 inputs.
    A bfloat16 product on the card asks cuBLAS for the fp32 output
    directly; on the CPU the bfloat16 operands are widened first, which
    computes the same products."""
    if x.dtype == torch.float32:
        return torch.matmul(x, weight.t())
    return _MatmulF32.apply(x, weight)


def linear_bias(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``y = x @ weight.T + bias`` (weight ``(out, in)``), cast to x's
    dtype."""
    y = matmul_f32(x, weight)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _gelu_grad(h: torch.Tensor) -> torch.Tensor:
    """Exact gelu'(h) for fp32 h (``_gelu_grad`` of the JAX module)."""
    phi = 0.5 * (1.0 + torch.erf(h * (1.0 / math.sqrt(2.0))))
    pdf = torch.exp(-0.5 * h * h) / math.sqrt(2.0 * math.pi)
    return phi + h * pdf


class _DenseGeluDense(torch.autograd.Function):
    """``dense_gelu_dense`` with the JAX ``custom_vjp``: residuals x, w1,
    w2 and the fp32 pre-GELU h; GELU recomputed in the backward; every
    backward product in fp32."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        h = matmul_f32(x, w1) + b1.float()
        a = F.gelu(h)
        y = matmul_f32(a.to(x.dtype), w2) + b2.float()
        ctx.save_for_backward(x, w1, w2, h)
        ctx.dtypes = (b1.dtype, b2.dtype)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w1, w2, h = ctx.saved_tensors
        n = h.shape[-1]
        dy32 = dy.float().reshape(-1, dy.shape[-1])
        h2 = h.reshape(-1, n)
        a = F.gelu(h2)
        dw2 = dy32.t() @ a
        db2 = dy32.sum(dim=0)
        dh = (dy32 @ w2.float()) * _gelu_grad(h2)
        dw1 = dh.t() @ x.reshape(-1, x.shape[-1]).float()
        db1 = dh.sum(dim=0)
        dx = (dh @ w1.float()).reshape(x.shape)
        return (dx.to(x.dtype), dw1.to(w1.dtype), db1.to(ctx.dtypes[0]),
                dw2.to(w2.dtype), db2.to(ctx.dtypes[1]))


def dense_gelu_dense(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """GEMM -> bias -> GELU -> GEMM -> bias, with weights ``(out, in)``:
    fp32 accumulate, ``+ b1`` in fp32, exact erf GELU, cast to x's dtype,
    the second GEMM, ``+ b2`` in fp32, cast."""
    return _DenseGeluDense.apply(x, w1, b1, w2, b2)


def lecun_normal_(w: torch.Tensor) -> torch.Tensor:
    """Fill a ``(out, in)`` weight in place with flax's ``lecun_normal``
    distribution (truncated normal, variance ``1 / in``)."""
    std = math.sqrt(1.0 / w.shape[-1]) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std)


def dense_param(out_f: int, in_f: int, device: torch.device,
                dtype: torch.dtype) -> nn.Parameter:
    """A lecun-normal ``(out_f, in_f)`` weight parameter."""
    w = torch.empty(out_f, in_f, device=device, dtype=torch.float32)
    return nn.Parameter(lecun_normal_(w).to(dtype))


def zeros_param(n: int, device: torch.device,
                dtype: torch.dtype) -> nn.Parameter:
    return nn.Parameter(torch.zeros(n, device=device, dtype=dtype))


class FusedDense(nn.Module):
    """``apex.fused_dense.FusedDense``: :func:`linear_bias` over ``weight
    (out, in)`` (lecun normal) and ``bias`` (zeros), built on ``device``
    (default ``cuda``) in ``param_dtype``; the weight is cast to x's dtype
    for the product (a differentiable cast)."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, param_dtype=torch.float32, *,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.weight = dense_param(out_features, in_features, device,
                                  param_dtype)
        self.bias = (zeros_param(out_features, device, param_dtype)
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_bias(x, self.weight.to(x.dtype), self.bias)


class FusedDenseGeluDense(nn.Module):
    """``apex.fused_dense.FusedDenseGeluDense``: :func:`dense_gelu_dense`
    over ``weight1 (I, in)``, ``bias1``, ``weight2 (out, I)``, ``bias2``;
    the weights are cast to x's dtype for the products."""

    def __init__(self, in_features: int, intermediate_features: int,
                 out_features: int, param_dtype=torch.float32, *,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.weight1 = dense_param(intermediate_features, in_features, device,
                                   param_dtype)
        self.bias1 = zeros_param(intermediate_features, device, param_dtype)
        self.weight2 = dense_param(out_features, intermediate_features,
                                   device, param_dtype)
        self.bias2 = zeros_param(out_features, device, param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense_gelu_dense(x, self.weight1.to(x.dtype), self.bias1,
                                self.weight2.to(x.dtype), self.bias2)
