"""Row LayerNorm forward: the CUDA kernel and its plain version.

Counterpart of ``apex_tpu/ops/pallas/layer_norm_kernel.py``
``ln_fwd_pallas``. :func:`ln_fwd` launches ``csrc/layer_norm.cu`` for a
CUDA tensor and runs :func:`ln_fwd_plain` for a CPU tensor; there is no
other route. The backward kernel (``ln_bwd_pallas``) belongs to the
training slice, so the wrapper refuses inputs that need a gradient.
"""

from __future__ import annotations

from typing import Tuple

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.tiling import LN_MAX_HIDDEN

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def refuse_grad(name: str, *tensors) -> None:
    """The port's kernels have no backward yet: a forward that autograd
    would record raises instead of returning a tensor without a
    gradient path."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the backward kernel is not ported yet; call under "
            f"torch.no_grad() / torch.inference_mode()")


def ln_fwd_plain(x2: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 *, eps: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2 ``(rows, hidden)``. Returns ``(y, mean, invvar)``: y in x2's
    dtype, mean and invvar ``(rows, 1)`` fp32 — the arithmetic of
    ``_ln_fwd_kernel``, stats in fp32."""
    x = x2.float()
    mu = x.mean(dim=1, keepdim=True)
    xc = x - mu
    rstd = torch.rsqrt((xc * xc).mean(dim=1, keepdim=True) + eps)
    y = xc * rstd * gamma.float() + beta.float()
    return y.to(x2.dtype), mu, rstd


def _check_param(t: torch.Tensor, x2: torch.Tensor, what: str) -> None:
    if t.device != x2.device or t.dtype != torch.float32 \
            or t.shape != (x2.shape[1],) or not t.is_contiguous():
        raise ValueError(
            f"ln_fwd: {what} must be a contiguous float32 ({x2.shape[1]},) "
            f"tensor on {x2.device}, got {tuple(t.shape)} {t.dtype} on "
            f"{t.device}")


def ln_fwd(x2: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
           eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2 ``(rows, hidden)`` float32 or bfloat16, gamma / beta float32
    ``(hidden,)``. Returns ``(y, mean,
    invvar)`` as :func:`ln_fwd_plain` does. CUDA tensors launch the kernel
    (any row count, hidden up to ``LN_MAX_HIDDEN``); CPU tensors take the
    plain version."""
    refuse_grad("ln_fwd", x2, gamma, beta)
    if x2.device.type == "cpu":
        return ln_fwd_plain(x2, gamma, beta, eps=eps)
    if x2.device.type != "cuda":
        raise ValueError(f"ln_fwd: unsupported device {x2.device}")
    if x2.dim() != 2 or x2.dtype not in _DTYPES or not x2.is_contiguous():
        raise ValueError(
            f"ln_fwd: x2 must be a contiguous 2-D float32/bfloat16 tensor, "
            f"got {tuple(x2.shape)} {x2.dtype} "
            f"contiguous={x2.is_contiguous()}")
    rows, hidden = x2.shape
    if not 0 < hidden <= LN_MAX_HIDDEN:
        raise ValueError(f"ln_fwd: hidden={hidden} outside the kernel's "
                         f"1..{LN_MAX_HIDDEN}")
    _check_param(gamma, x2, "gamma")
    _check_param(beta, x2, "beta")
    y = torch.empty_like(x2)
    mean = torch.empty((rows, 1), dtype=torch.float32, device=x2.device)
    invvar = torch.empty((rows, 1), dtype=torch.float32, device=x2.device)
    lib = _build.lib()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.apex_ln_fwd(
            x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            mean.data_ptr(), invvar.data_ptr(), rows, hidden, float(eps),
            _DTYPES[x2.dtype], stream)
    _build.launches["ln_fwd"] += 1
    _build.check(err, "ln_fwd")
    return y, mean, invvar
