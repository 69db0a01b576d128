"""Flash attention forward and backward: the CUDA kernels and their plain
versions.

Counterpart of ``apex_tpu/ops/pallas/flash_attention.py``
``flash_attention_fwd``, ``flash_attention_bwd`` (its kernels
``_fa_dq_kernel`` and ``_fa_dkv_kernel``) and the public
``flash_attention`` with its ``custom_vjp``. Layout as in the JAX package:
q ``(b, h, sq, d)``, k / v ``(b, h, sk, d)``; the causal mask is top-left
aligned (key ``j`` is visible to query ``i`` when ``j <= i``).

:func:`flash_attention_fwd` launches ``csrc/flash_attention.cu`` and
:func:`flash_attention_bwd` the two kernels of
``csrc/flash_attention_bwd.cu`` for CUDA tensors; CPU tensors run
:func:`flash_attention_fwd_plain` / :func:`flash_attention_bwd_plain`.
:func:`flash_attention` is differentiable: its ``autograd.Function`` saves
q, k, v, o and the fp32 lse, and its backward is
:func:`flash_attention_bwd`. The additive bias, the boolean mask and
dropout are operands the kernels do not take yet; they raise.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.tiling import FA_HEAD_DIM, FA_MAX_BATCH_HEADS

NEG_INF = -1e30
# scores at or below this are "hard masked" (as in the JAX kernel)
_MASK_EDGE = 0.5 * NEG_INF
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, scale: float,
                              causal: bool
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole-row softmax the online kernel computes: fp32 scores,
    masked scores at -1e30, p cast to v's dtype before the p.v product,
    fully masked rows give o = 0 and lse = -1e30. Returns ``(o in q's
    dtype, lse (b, h, sq) fp32)``."""
    sq, sk = q.shape[2], k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(m <= _MASK_EDGE, 0.0, m))
    denom = p.sum(dim=-1, keepdim=True)
    safe = torch.where(denom > 0, denom, 1.0)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / safe
    lse = torch.where(m <= _MASK_EDGE, NEG_INF, m + torch.log(safe))
    return o.to(q.dtype), lse.squeeze(-1)


def _bwd_p(s: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """P = exp(s - lse), exactly 0 where the score is hard masked or the
    row's lse is (fully masked rows) — ``_bwd_p`` of the JAX kernels."""
    lse = lse[..., None]
    dead = (s <= _MASK_EDGE) | (lse <= _MASK_EDGE)
    return torch.where(dead, 0.0,
                       torch.exp(s - torch.where(lse <= _MASK_EDGE, 0.0,
                                                 lse)))


def attention_dvec(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O) in fp32, ``(b, h, sq)``: the backward's per-row
    term, computed outside the kernels as the JAX wrapper computes it."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              scale: float, causal: bool
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The arithmetic of ``_fa_dq_kernel`` / ``_fa_dkv_kernel`` over whole
    rows: fp32 scores, P from the saved lse, ``ds = P (dP - D)``, and the
    casts to the IO dtype before each product (``ds * scale`` for dq and
    dk, P for dv). Returns ``(dq, dk, dv)`` in q's / k's / v's dtype."""
    sq, sk = q.shape[2], k.shape[2]
    dvec = attention_dvec(o, do)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, NEG_INF)
    p = _bwd_p(s, lse)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds_scaled = p * (dp - dvec[..., None]) * scale
    dq = torch.matmul(ds_scaled.to(k.dtype).float(), k.float())
    dk = torch.matmul(ds_scaled.to(q.dtype).float().transpose(-1, -2),
                      q.float())
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_qkv(name: str, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> bool:
    """True for CPU tensors (plain version); raises on what the CUDA
    kernels do not take."""
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be (b, h, s, d)")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"{name}: k / v shape {tuple(k.shape)} / "
                         f"{tuple(v.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v must share one dtype of "
                         f"float32 / bfloat16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q, k, v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: q, k, v must be contiguous")
    if d != FA_HEAD_DIM:
        raise NotImplementedError(
            f"{name}: the kernel is compiled for head_dim {FA_HEAD_DIM}, "
            f"got {d}")
    if b * h > FA_MAX_BATCH_HEADS:
        raise ValueError(f"{name}: batch*heads={b * h} > "
                         f"{FA_MAX_BATCH_HEADS}")
    return False


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float, causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(o, lse)``. CUDA tensors launch the kernel: contiguous
    float32 or bfloat16, one dtype for q, k and v, head_dim 64, any
    sq / sk. CPU tensors take the plain version."""
    if _check_qkv("flash_attention_fwd", q, k, v):
        return flash_attention_fwd_plain(q, k, v, scale=scale, causal=causal)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _build.lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.apex_fa_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              o.data_ptr(), lse.data_ptr(), b * h, sq, sk,
                              d, float(scale), int(causal),
                              _DTYPES[q.dtype], stream)
    _build.launches["fa_fwd"] += 1
    _build.check(err, "flash_attention_fwd")
    return o, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, scale: float, causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` from the forward's o and fp32 lse ``(b, h, sq)``.
    CUDA tensors launch the dq kernel and the dk / dv kernel (inputs as
    for :func:`flash_attention_fwd`; o and do like q); no output is summed
    across blocks, so two runs give the same bits. CPU tensors take the
    plain version."""
    name = "flash_attention_bwd"
    if _check_qkv(name, q, k, v):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, scale=scale,
                                         causal=causal)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    for what, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous "
                             f"{tuple(q.shape)} {q.dtype} tensor like q, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"{name}: lse must be a contiguous float32 "
                         f"{(b, h, sq)} tensor, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    dvec = attention_dvec(o, do)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _build.lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dvec.data_ptr())
    geo = (b * h, sq, sk, d, float(scale), int(causal), _DTYPES[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.apex_fa_bwd_dq(*args, dq.data_ptr(), *geo, stream)
        _build.launches["fa_bwd_dq"] += 1
        _build.check(err, "flash_attention_bwd (dq)")
        err = lib.apex_fa_bwd_dkv(*args, dk.data_ptr(), dv.data_ptr(), *geo,
                                  stream)
        _build.launches["fa_bwd_dkv"] += 1
        _build.check(err, "flash_attention_bwd (dk, dv)")
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The ``custom_vjp`` of the JAX ``_flash_attention``: saves q, k, v,
    o and lse; the backward runs :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, scale=scale, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         scale=ctx.scale, causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None, *,
                    bias: Optional[torch.Tensor] = None,
                    mask: Optional[torch.Tensor] = None,
                    dropout_p: float = 0.0, dropout_seed=None
                    ) -> torch.Tensor:
    """Scaled dot-product attention, differentiable in q, k and v;
    ``scale`` defaults to ``1/sqrt(d)``. ``bias``, ``mask`` and
    ``dropout_p > 0`` are operands of the JAX kernel that this port's
    kernels do not take yet: they raise ``NotImplementedError``."""
    if bias is not None or mask is not None or dropout_p > 0.0 \
            or dropout_seed is not None:
        raise NotImplementedError(
            "flash_attention: bias, mask and dropout are not ported to the "
            "CUDA kernel yet (ROADMAP.md, port queue)")
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, bool(causal), float(s))
