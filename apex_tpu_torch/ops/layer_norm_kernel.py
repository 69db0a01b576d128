"""Row LayerNorm / RMSNorm forward and backward: the CUDA kernels and their
plain versions.

Counterpart of ``apex_tpu/ops/pallas/layer_norm_kernel.py``
``ln_fwd_pallas`` and ``ln_bwd_pallas`` with x saved: the LayerNorm form
(``rms=False``) and the RMSNorm form (``rms=True``: no centring, the mean
written as 0, no ``mean(wdy)`` term in the backward), each with gamma and
an optional beta or with neither (``gamma=None``: no affine step, no
dgamma / dbeta). :func:`ln_fwd` / :func:`ln_bwd` launch
``csrc/layer_norm.cu`` for CUDA tensors and run :func:`ln_fwd_plain` /
:func:`ln_bwd_plain` for CPU tensors; there is no other route. gamma and
beta may be float32 or bfloat16 (the JAX package takes any parameter
dtype); the kernels read them as float32, cast here (they are ``hidden``
long), and dgamma / dbeta come back in float32, as from the Pallas
kernel, for the caller to cast to the parameter's dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.tiling import (LN_MAX_HIDDEN, LN_VECTOR_BYTES,
                                       ln_bwd_geometry)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
_PARAM_DTYPES = (torch.float32, torch.bfloat16)


def ln_fwd_plain(x2: torch.Tensor, gamma: Optional[torch.Tensor],
                 beta: Optional[torch.Tensor], *, eps: float,
                 rms: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2 ``(rows, hidden)``. Returns ``(y, mean, invvar)``: y in x2's
    dtype, mean and invvar ``(rows, 1)`` fp32 — the arithmetic of
    ``_ln_fwd_kernel``, stats in fp32. ``rms`` centres on 0 and returns a
    zero mean; ``beta=None`` adds nothing; ``gamma=None`` returns xhat."""
    x = x2.float()
    if rms:
        mu = torch.zeros((x.shape[0], 1), dtype=torch.float32,
                         device=x.device)
        xc = x
    else:
        mu = x.mean(dim=1, keepdim=True)
        xc = x - mu
    rstd = torch.rsqrt((xc * xc).mean(dim=1, keepdim=True) + eps)
    y = xc * rstd
    if gamma is not None:
        y = y * gamma.float()
        if beta is not None:
            y = y + beta.float()
    return y.to(x2.dtype), mu, rstd


def ln_bwd_plain(dy2: torch.Tensor, x2: torch.Tensor,
                 gamma: Optional[torch.Tensor], beta: Optional[torch.Tensor],
                 mean: Optional[torch.Tensor], invvar: torch.Tensor, *,
                 rms: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                            Optional[torch.Tensor]]:
    """The arithmetic of ``_ln_bwd_kernel`` (x saved): returns ``(dx in
    dy2's dtype, dgamma fp32 or None, dbeta fp32 or None)``. ``beta`` only
    says whether there is a dbeta; ``gamma=None`` gives neither; ``mean``
    is not read when ``rms``."""
    dy = dy2.float()
    xhat = (x2.float() if rms else x2.float() - mean) * invvar
    wdy = dy if gamma is None else dy * gamma.float()
    c1 = (xhat * wdy).mean(dim=1, keepdim=True)
    if rms:
        dx = (wdy - xhat * c1) * invvar
    else:
        c2 = wdy.mean(dim=1, keepdim=True)
        dx = (wdy - xhat * c1 - c2) * invvar
    if gamma is None:
        return dx.to(dy2.dtype), None, None
    dbeta = dy.sum(dim=0) if beta is not None else None
    return dx.to(dy2.dtype), (dy * xhat).sum(dim=0), dbeta


def _check_device(name: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for CUDA (kernel)."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return False


def _check_rows(name: str, x2: torch.Tensor, what: str = "x2") -> None:
    if x2.dim() != 2 or x2.dtype not in _DTYPES or not x2.is_contiguous():
        raise ValueError(
            f"{name}: {what} must be a contiguous 2-D float32/bfloat16 "
            f"tensor, got {tuple(x2.shape)} {x2.dtype} "
            f"contiguous={x2.is_contiguous()}")
    if not 0 < x2.shape[1] <= LN_MAX_HIDDEN:
        raise ValueError(f"{name}: hidden={x2.shape[1]} outside the "
                         f"kernel's 1..{LN_MAX_HIDDEN}")


def _check_f32(name: str, t: torch.Tensor, shape, x2: torch.Tensor,
               what: str) -> None:
    if t.device != x2.device or t.dtype != torch.float32 \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: {what} must be a contiguous float32 {tuple(shape)} "
            f"tensor on {x2.device}, got {tuple(t.shape)} {t.dtype} on "
            f"{t.device}")


def _param_f32(name: str, t: Optional[torch.Tensor], x: torch.Tensor,
               what: str) -> Optional[torch.Tensor]:
    """A float32 or bfloat16 affine parameter as long as x's last dimension
    (LayerNorm's hidden, GroupNorm's channels) as the contiguous float32
    vector a kernel reads (the tensor itself when it is one)."""
    if t is None:
        return None
    if t.device != x.device or t.dtype not in _PARAM_DTYPES \
            or tuple(t.shape) != (x.shape[-1],):
        raise ValueError(
            f"{name}: {what} must be a float32 or bfloat16 "
            f"({x.shape[-1]},) tensor on {x.device}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return t.float().contiguous()


def _affine_f32(name: str, gamma, beta, x2: torch.Tensor):
    if gamma is None and beta is not None:
        raise ValueError(f"{name}: beta without gamma")
    return (_param_f32(name, gamma, x2, "gamma"),
            _param_f32(name, beta, x2, "beta"))


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def ln_fwd(x2: torch.Tensor, gamma: Optional[torch.Tensor],
           beta: Optional[torch.Tensor], *, eps: float, rms: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2 ``(rows, hidden)`` float32 or bfloat16, gamma float32 or
    bfloat16 ``(hidden,)`` or None, beta the same or None (only with
    gamma). Returns ``(y, mean, invvar)`` as :func:`ln_fwd_plain` does.
    CUDA tensors launch the kernel (any row count, any hidden up to
    ``LN_MAX_HIDDEN``, 2^30: rows wider than ``LN_SMEM_MAX_HIDDEN`` take
    the kernel's form that stages nothing); CPU tensors take the plain
    version."""
    if _check_device("ln_fwd", x2):
        return ln_fwd_plain(x2, gamma, beta, eps=eps, rms=rms)
    _check_rows("ln_fwd", x2)
    gamma, beta = _affine_f32("ln_fwd", gamma, beta, x2)
    rows, hidden = x2.shape
    y = torch.empty_like(x2)
    mean = torch.empty((rows, 1), dtype=torch.float32, device=x2.device)
    invvar = torch.empty((rows, 1), dtype=torch.float32, device=x2.device)
    lib = _build.lib()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.apex_ln_fwd(
            x2.data_ptr(), _ptr(gamma), _ptr(beta), y.data_ptr(),
            mean.data_ptr(), invvar.data_ptr(), rows, hidden, float(eps),
            int(rms), _DTYPES[x2.dtype], stream)
    _build.launches["ln_fwd"] += 1
    _build.check(err, "ln_fwd")
    return y, mean, invvar


def ln_bwd(dy2: torch.Tensor, x2: torch.Tensor,
           gamma: Optional[torch.Tensor], beta: Optional[torch.Tensor],
           mean: Optional[torch.Tensor], invvar: torch.Tensor, *,
           rms: bool = False
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                      Optional[torch.Tensor]]:
    """The backward from the forward's saved x2, mean and invvar
    (``(rows, 1)`` fp32; mean is not read, and may be None, when
    ``rms``). Returns ``(dx, dgamma, dbeta)`` as :func:`ln_bwd_plain`
    does (float32): dbeta is None when ``beta`` is, both are None when
    ``gamma`` is. CUDA tensors launch the kernel in the form
    :func:`~apex_tpu_torch.ops.tiling.ln_bwd_geometry` picks from the
    width, the dtype and whether dy2, x2 and gamma start on a 16-byte
    boundary (a view at an odd offset takes a form that reads scalars):
    dgamma / dbeta are summed over rows without atomics, so two runs give
    the same bits. CPU tensors take the plain version."""
    if _check_device("ln_bwd", dy2):
        return ln_bwd_plain(dy2, x2, gamma, beta, mean, invvar, rms=rms)
    _check_rows("ln_bwd", dy2, "dy2")
    rows, hidden = dy2.shape
    if x2.shape != dy2.shape or x2.dtype != dy2.dtype \
            or x2.device != dy2.device or not x2.is_contiguous():
        raise ValueError(
            f"ln_bwd: x2 must be a contiguous {tuple(dy2.shape)} "
            f"{dy2.dtype} tensor like dy2, got {tuple(x2.shape)} "
            f"{x2.dtype} on {x2.device}")
    gamma, beta = _affine_f32("ln_bwd", gamma, beta, dy2)
    if not rms:
        _check_f32("ln_bwd", mean, (rows, 1), dy2, "mean")
    _check_f32("ln_bwd", invvar, (rows, 1), dy2, "invvar")
    geo = ln_bwd_geometry(
        rows, hidden, _DTYPE_NAMES[dy2.dtype],
        aligned=all(t.data_ptr() % LN_VECTOR_BYTES == 0
                    for t in (dy2, x2, gamma) if t is not None))
    f32 = dict(dtype=torch.float32, device=dy2.device)
    dx = torch.empty_like(dy2)
    part_g = dgamma = part_b = dbeta = None
    if gamma is not None:
        part_g = torch.empty((geo.blocks, hidden), **f32)
        dgamma = torch.empty((hidden,), **f32)
        if beta is not None:
            part_b = torch.empty((geo.blocks, hidden), **f32)
            dbeta = torch.empty((hidden,), **f32)
    lib = _build.lib()
    with torch.cuda.device(dy2.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.apex_ln_bwd(
            dy2.data_ptr(), x2.data_ptr(), _ptr(gamma),
            None if rms else mean.data_ptr(), invvar.data_ptr(),
            dx.data_ptr(), _ptr(part_g), _ptr(part_b), _ptr(dgamma),
            _ptr(dbeta), rows, hidden, geo.form_id, geo.vectors, geo.warps,
            geo.blocks, int(rms), _DTYPES[dy2.dtype], stream)
    _build.launches["ln_bwd"] += 1
    _build.check(err, "ln_bwd")
    return dx, dgamma, dbeta
