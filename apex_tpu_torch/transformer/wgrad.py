"""Weight-gradient GEMM accumulated into a main-grad buffer — counterpart
of ``apex_tpu/transformer/wgrad.py`` (apex's
``fused_weight_gradient_mlp_cuda``).

``grad_output^T @ input`` over every leading dimension, accumulated in
fp32, added to ``main_grad``; the updated buffer is returned (as the JAX
functions return it). A plain matrix product, as in the JAX package.
"""

from __future__ import annotations

import torch


def _wgrad_f32(input_: torch.Tensor, grad_output: torch.Tensor
               ) -> torch.Tensor:
    """``(out, in)`` fp32 sum over rows of ``grad_output (..., out)`` times
    ``input_ (..., in)``: the low-precision operands are widened first, so
    every product is exact in fp32 and the sums are fp32."""
    g = grad_output.reshape(-1, grad_output.shape[-1]).float()
    x = input_.reshape(-1, input_.shape[-1]).float()
    return g.t() @ x


def wgrad_gemm_accum_fp32(input_: torch.Tensor, grad_output: torch.Tensor,
                          main_grad: torch.Tensor) -> torch.Tensor:
    """``main_grad + grad_output^T @ input`` with an fp32 ``main_grad
    (out, in)``."""
    return main_grad + _wgrad_f32(input_, grad_output)


def wgrad_gemm_accum_fp16(input_: torch.Tensor, grad_output: torch.Tensor,
                          main_grad: torch.Tensor) -> torch.Tensor:
    """The low-precision accumulator: the sum in fp32, stored back in
    ``main_grad``'s dtype."""
    return (main_grad.float() + _wgrad_f32(input_, grad_output)).to(
        main_grad.dtype)
