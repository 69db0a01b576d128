"""Fused dense layers — counterpart of
``apex_tpu/transformer/fused_dense.py``, forward only.

In the JAX package these are plain matrix products that XLA fuses with
their bias and GELU epilogues; here they are PyTorch matrix products (no
hand-written kernel: the JAX package has no Pallas kernel for them).
The dtype steps are the JAX ones exactly: products accumulate in fp32
and come out in fp32 (``preferred_element_type=float32``), biases are
added in fp32, GELU is the exact erf form in fp32, and only then is the
result cast to the IO dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def matmul_f32(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T`` (``weight (out, in)``, the same dtype as x) with
    fp32 accumulation and an fp32 result, for float32 or bfloat16 inputs.
    A bfloat16 product on the card asks cuBLAS for the fp32 output
    directly; on the CPU the bfloat16 operands are widened first, which
    computes the same products."""
    if x.dtype == torch.float32:
        return torch.matmul(x, weight.t())
    if x.device.type == "cuda":
        out = torch.mm(x.reshape(-1, x.shape[-1]), weight.t(),
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], weight.shape[0])
    return torch.matmul(x.float(), weight.float().t())


def linear_bias(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``y = x @ weight.T + bias`` (weight ``(out, in)``), cast to x's
    dtype."""
    y = matmul_f32(x, weight)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def dense_gelu_dense(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """GEMM -> bias -> GELU -> GEMM -> bias, with weights ``(out, in)``:
    fp32 accumulate, ``+ b1`` in fp32, exact erf GELU, cast to x's dtype,
    the second GEMM, ``+ b2`` in fp32, cast."""
    h = matmul_f32(x, w1) + b1.float()
    a = F.gelu(h)
    y = matmul_f32(a.to(x.dtype), w2) + b2.float()
    return y.to(x.dtype)
