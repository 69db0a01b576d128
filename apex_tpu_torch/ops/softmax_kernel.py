"""Megatron attention-score softmax, forward and backward: the CUDA kernels
and their plain versions.

Counterpart of ``apex_tpu/ops/pallas/softmax_kernel.py``
(``softmax_fwd_pallas``, ``_softmax_fwd_causal_chunked`` and
``softmax_bwd_pallas``). x is ``(..., sq, sk)`` of rank >= 2; the
forward, in fp32 whatever the IO dtype: ``v = x * scale``, masked
positions (``mask != 0``) and, with ``causal``, columns ``j > i`` (top-left
aligned) replaced by ``MASK_FILL``, ``m = max(v)``, ``e = exp(v - m)``,
``y = e * (1 / sum(e))``, and ``y = 0`` on a row whose ``m <= MASK_FILL``.
The backward is ``dx = (dy - sum(dy * y)) * y * scale``; it takes no
mask, since masked y is 0.

:func:`softmax_fwd` launches ``csrc/softmax.cu``'s forward for CUDA tensors
(counted as ``softmax_fwd``, or ``softmax_fwd_causal`` with ``causal``)
and :func:`softmax_bwd` its backward (``softmax_bwd``); CPU tensors run
:func:`softmax_fwd_plain` / :func:`softmax_bwd_plain`, which repeat the
kernels' arithmetic (replace, reciprocal-multiply, zero rows). There is
no other route: a CUDA tensor takes the kernels at any ``sk`` (the JAX
package's ``MAX_PALLAS_COLS`` route does not exist here) and with any
mask that broadcasts to x under numpy's rules, of a bool or integer dtype
and of any rank up to x's. The kernels read that mask through one stride
per dimension (0 where it broadcasts) and never expand or copy it; x and
dy are made contiguous (a copy where they are not). IO dtypes float32,
bfloat16 and float16.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.layer_norm_kernel import _check_device
from apex_tpu_torch.ops.tiling import SM_GRID_X_MAX, softmax_blocks

MASK_FILL = -10000.0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_LEAD = 8   # leading mask dimensions the kernel's plan holds


def _causal_cols(sq: int, sk: int, device) -> torch.Tensor:
    """``(sq, sk)`` bool, True above the diagonal (column j > row i)."""
    rows = torch.arange(sq, device=device)[:, None]
    return torch.arange(sk, device=device)[None, :] > rows


def softmax_fwd_plain(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                      *, scale: float, causal: bool = False) -> torch.Tensor:
    """The forward kernel's arithmetic on whole rows: y in x's dtype."""
    x32 = x.float() * scale
    if mask is not None:
        x32 = x32.masked_fill(mask != 0, MASK_FILL)
    if causal:
        x32 = x32.masked_fill(_causal_cols(*x.shape[-2:], x.device),
                              MASK_FILL)
    m = x32.amax(dim=-1, keepdim=True)
    e = torch.exp(x32 - m)
    s = e.sum(dim=-1, keepdim=True)
    return (e * torch.where(m <= MASK_FILL, 0.0, 1.0 / s)).to(x.dtype)


def softmax_bwd_plain(y: torch.Tensor, dy: torch.Tensor, *,
                      scale: float) -> torch.Tensor:
    """The backward kernel's arithmetic: dx in y's dtype."""
    y32, dy32 = y.float(), dy.float()
    c = (dy32 * y32).sum(dim=-1, keepdim=True)
    return ((dy32 - c) * y32 * scale).to(y.dtype)


def _check_x(name: str, x: torch.Tensor, what: str = "x") -> None:
    if x.dim() < 2 or not x.is_floating_point():
        raise ValueError(f"{name}: {what} must be a floating tensor of rank "
                         f">= 2 (..., sq, sk), got {tuple(x.shape)} "
                         f"{x.dtype}")


def _check_mask(name: str, mask: torch.Tensor, x: torch.Tensor) -> None:
    """Raise unless ``mask`` is a bool or integer tensor on x's device that
    broadcasts to x's shape."""
    if mask.is_floating_point() or mask.is_complex():
        raise ValueError(f"{name}: the mask must be bool or integer "
                         f"(nonzero = masked), got {mask.dtype}")
    if mask.device != x.device:
        raise ValueError(f"{name}: the mask is on {mask.device}, x on "
                         f"{x.device}")
    shape = tuple(mask.shape)
    if len(shape) > x.dim() or any(
            m not in (1, n) for m, n in zip(shape[::-1], x.shape[::-1])):
        raise ValueError(f"{name}: mask {shape} does not broadcast to x "
                         f"{tuple(x.shape)}")


def mask_plan(mask: torch.Tensor, shape) -> List[int]:
    """The kernel's view of a mask broadcast to ``shape`` (x's): ``[bytes,
    nlead, 8 lead sizes, 8 lead strides, sq stride, sk stride]`` with
    strides in elements, 0 on a broadcast dimension. x's leading
    dimensions are merged where the mask's strides allow (a broadcast run
    stays one dimension), so up to 8 remain; more raise ``ValueError``."""
    nd = len(shape)
    pad = nd - mask.dim()
    msize = (1,) * pad + tuple(mask.shape)
    mstride = (0,) * pad + tuple(mask.stride())
    strides = [0 if m == 1 else st for m, st in zip(msize, mstride)]
    lead = []   # (size, stride) of x's leading dimensions, merged
    for n, st in zip(shape[:-2], strides[:-2]):
        if n == 1:
            continue
        if lead and lead[-1][1] == st * n:
            lead[-1] = (lead[-1][0] * n, st)
        else:
            lead.append((n, st))
    if len(lead) > _MAX_LEAD:
        raise ValueError(f"softmax: the mask's broadcast over x {tuple(shape)}"
                         f" needs {len(lead)} leading dimensions, the kernel "
                         f"takes {_MAX_LEAD}")
    sizes = [n for n, _ in lead] + [1] * (_MAX_LEAD - len(lead))
    lstrides = [st for _, st in lead] + [0] * (_MAX_LEAD - len(lead))
    return [mask.element_size(), len(lead), *sizes, *lstrides, strides[-2],
            strides[-1]]


def mask_route(plan: List[int], mask_ptr: int, itemsize: int, sk: int,
               aligned: bool = True) -> str:
    """How the forward kernel reads a mask of ``plan`` (:func:`mask_plan`)
    at address ``mask_ptr``, against rows of ``sk`` values of
    ``itemsize`` bytes (x and y 16-byte aligned when ``aligned``):
    ``"vector"``, one access of a chunk's V mask entries for each 16-byte
    chunk of x (V = 16 / itemsize), where x takes 16-byte accesses, the
    mask's sk stride is 1, and its base and every row's start are aligned
    to that access (at most 16 bytes); else ``"element"``, one entry at a
    time. ``mask_vector_ok`` in ``csrc/softmax.cu``."""
    nbytes, nlead = plan[0], plan[1]
    per = 16 // itemsize
    access = min(16, per * nbytes)
    unit = access // nbytes
    strides = plan[2 + _MAX_LEAD:2 + _MAX_LEAD + nlead] + [plan[-2]]
    vector = (aligned and sk % per == 0 and plan[-1] == 1
              and mask_ptr % access == 0
              and all(st % unit == 0 for st in strides))
    return "vector" if vector else "element"


def _rows_ok(name: str, rows: int, sk: int) -> None:
    if softmax_blocks(rows, sk) > SM_GRID_X_MAX or sk >= 2 ** 31:
        raise ValueError(f"{name}: {rows} rows of {sk} exceed the kernels' "
                         f"grid")


def softmax_fwd(x: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
                scale: float, causal: bool = False) -> torch.Tensor:
    """``y`` like x. CUDA tensors launch the kernel: x float32, bfloat16 or
    float16 of rank >= 2, any sk, an optional bool / integer mask that
    broadcasts to x (True / nonzero = masked). CPU tensors take the plain
    version."""
    name = "softmax_fwd_causal" if causal else "softmax_fwd"
    cpu = _check_device(name, x)
    _check_x(name, x)
    if mask is not None:
        _check_mask(name, mask, x)
    if cpu:
        return softmax_fwd_plain(x, mask, scale=scale, causal=causal)
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name}: x must be float32, bfloat16 or float16, "
                         f"got {x.dtype}")
    x = x.contiguous()
    sq, sk = x.shape[-2], x.shape[-1]
    rows = x.numel() // sk if sk else 0
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    _rows_ok(name, rows, sk)
    plan = None
    if mask is not None:
        plan = (ctypes.c_longlong * (4 + 2 * _MAX_LEAD))(
            *mask_plan(mask, x.shape))
    lib = _build.lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.apex_softmax_fwd(
            x.data_ptr(), None if mask is None else mask.data_ptr(),
            None if plan is None else ctypes.addressof(plan), y.data_ptr(),
            rows, sq, sk, float(scale), int(causal), _DTYPES[x.dtype], stream)
    _build.launches[name] += 1
    _build.check(err, name)
    return y


def softmax_bwd(y: torch.Tensor, dy: torch.Tensor, *,
                scale: float) -> torch.Tensor:
    """``dx`` in y's dtype, for every forward form (masked y is 0, so no
    mask). CUDA tensors launch the kernel (dy is cast to y's dtype where it
    differs); CPU tensors take the plain version."""
    name = "softmax_bwd"
    cpu = _check_device(name, y)
    _check_x(name, y, "y")
    if dy.shape != y.shape or dy.device != y.device:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} on {dy.device} "
                         f"must match y {tuple(y.shape)} on {y.device}")
    if cpu:
        return softmax_bwd_plain(y, dy, scale=scale)
    if y.dtype not in _DTYPES:
        raise ValueError(f"{name}: y must be float32, bfloat16 or float16, "
                         f"got {y.dtype}")
    y = y.contiguous()
    dy = dy.to(y.dtype).contiguous()
    sk = y.shape[-1]
    rows = y.numel() // sk if sk else 0
    dx = torch.empty_like(y)
    if y.numel() == 0:
        return dx
    _rows_ok(name, rows, sk)
    lib = _build.lib()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.apex_softmax_bwd(y.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                                   rows, sk, float(scale), _DTYPES[y.dtype],
                                   stream)
    _build.launches[name] += 1
    _build.check(err, name)
    return dx
