"""Flash-attention forward: the CUDA kernel and its plain version.

Counterpart of ``apex_tpu/ops/pallas/flash_attention.py``
``flash_attention_fwd`` and, for the forward, the public
``flash_attention``. Layout as in the JAX package: q ``(b, h, sq, d)``,
k / v ``(b, h, sk, d)``; the causal mask is top-left aligned (key ``j``
is visible to query ``i`` when ``j <= i``).

:func:`flash_attention_fwd` launches ``csrc/flash_attention.cu`` for CUDA
tensors and runs :func:`flash_attention_fwd_plain` for CPU tensors. The
additive bias, the boolean mask and dropout are operands the kernel does
not take yet, and the backward kernels belong to the training slice; all
of those raise.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.layer_norm_kernel import refuse_grad
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


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float, causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(o, lse)``. CUDA tensors launch the kernel: contiguous
    float32 or bfloat16, one dtype for q, k and v, head_dim 64, any
    sq / sk. CPU tensors take the plain version."""
    refuse_grad("flash_attention_fwd", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, scale=scale, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device "
                         f"{q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_fwd: q, k, v must be "
                         "(b, h, s, d)")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention_fwd: k / v shape "
                         f"{tuple(k.shape)} / {tuple(v.shape)} does not "
                         f"match q {tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_fwd: q, k, v must share one "
                         f"dtype of float32 / bfloat16, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention_fwd: q, k, v on different "
                         "devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd: q, k, v must be contiguous")
    if d != FA_HEAD_DIM:
        raise NotImplementedError(
            f"flash_attention_fwd: the kernel is compiled for head_dim "
            f"{FA_HEAD_DIM}, got {d}")
    if b * h > FA_MAX_BATCH_HEADS:
        raise ValueError(f"flash_attention_fwd: batch*heads={b * h} > "
                         f"{FA_MAX_BATCH_HEADS}")
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None, *,
                    bias: Optional[torch.Tensor] = None,
                    mask: Optional[torch.Tensor] = None,
                    dropout_p: float = 0.0, dropout_seed=None
                    ) -> torch.Tensor:
    """Scaled dot-product attention, forward only; ``scale`` defaults to
    ``1/sqrt(d)``. ``bias``, ``mask`` and ``dropout_p > 0`` are operands
    of the JAX kernel that this port's kernel does not take yet: they
    raise ``NotImplementedError``."""
    if bias is not None or mask is not None or dropout_p > 0.0 \
            or dropout_seed is not None:
        raise NotImplementedError(
            "flash_attention: bias, mask and dropout are not ported to the "
            "CUDA kernel yet (ROADMAP.md, port queue)")
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return flash_attention_fwd(q, k, v, scale=s, causal=causal)[0]
