"""Fused Adam / AdamW over flat fp32 buffers: the CUDA kernel and its plain
version.

Counterpart of ``apex_tpu/ops/pallas/fused_adam_kernel.py``
``fused_adam_flat``. :func:`fused_adam_flat` launches
``csrc/fused_adam.cu`` for CUDA tensors and runs
:func:`fused_adam_flat_plain` for CPU tensors. Both update p, m and v in
place (the JAX kernel donates them) and return them.

The nine scalars ``[lr, beta1, beta2, eps, wd, bc1, bc2, inv_scale,
noop]`` are packed into a float32 tensor on the buffers' device by
:func:`pack_scalars`, as ``_pack_scalars`` does, with device ops only:
``lr``, ``step``, ``inv_scale`` and ``found_inf`` may be device tensors
and never reach the host, which keeps the update free of host syncs.
"""

from __future__ import annotations

from typing import Tuple

import torch

from apex_tpu_torch.ops import _build

ADAM_MODE_L2 = 0     # Adam with L2 regularization (grad += wd * p)
ADAM_MODE_ADAMW = 1  # decoupled weight decay


def _dev_scalar(x, device: torch.device) -> torch.Tensor:
    """A one-element fp32 tensor on ``device``: a device tensor is cast
    there, a Python number is written by a fill kernel (no host copy)."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32).reshape(1)
    return torch.full((1,), float(x), dtype=torch.float32, device=device)


def pack_scalars(lr, beta1, beta2, eps, weight_decay, step, bias_correction,
                 inv_scale, found_inf, *, device: torch.device
                 ) -> torch.Tensor:
    """``_pack_scalars``: ``bc = 1 - beta ** step`` in fp32 when
    ``bias_correction`` (else 1), ``noop = float(found_inf)``."""
    b1 = _dev_scalar(beta1, device)
    b2 = _dev_scalar(beta2, device)
    if bias_correction:
        stepf = _dev_scalar(step, device)
        bc1 = 1.0 - torch.pow(b1, stepf)
        bc2 = 1.0 - torch.pow(b2, stepf)
    else:
        bc1 = bc2 = _dev_scalar(1.0, device)
    return torch.cat([_dev_scalar(lr, device), b1, b2,
                      _dev_scalar(eps, device),
                      _dev_scalar(weight_decay, device), bc1, bc2,
                      _dev_scalar(inv_scale, device),
                      _dev_scalar(found_inf, device)])


def fused_adam_flat_plain(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                          v: torch.Tensor, lr, beta1: float = 0.9,
                          beta2: float = 0.999, eps: float = 1e-8,
                          weight_decay=0.0, step=1,
                          mode: int = ADAM_MODE_ADAMW,
                          bias_correction: bool = True, inv_scale=1.0,
                          found_inf=False
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """:func:`fused_adam_flat` in plain PyTorch, on any device: the
    arithmetic of ``_adam_kernel`` on the packed scalars, in place, every
    step a separate fp32 operation in the kernel's order; a set
    ``found_inf`` keeps p, m and v bit for bit."""
    lr, b1, b2, eps, wd, bc1, bc2, inv_scale, noop = pack_scalars(
        lr, beta1, beta2, eps, weight_decay, step, bias_correction,
        inv_scale, found_inf, device=p.device).unbind(0)
    g = g.float() * inv_scale
    if mode == ADAM_MODE_L2:
        g = g + wd * p
    m_new = b1 * m + (1.0 - b1) * g
    v_new = b2 * v + (1.0 - b2) * g * g
    update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    if mode == ADAM_MODE_ADAMW:
        update = update + wd * p
    p_new = p - lr * update
    keep = noop != 0.0
    p.copy_(torch.where(keep, p, p_new))
    m.copy_(torch.where(keep, m, m_new))
    v.copy_(torch.where(keep, v, v_new))
    return p, m, v


def fused_adam_flat(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                    v: torch.Tensor, lr, beta1: float = 0.9,
                    beta2: float = 0.999, eps: float = 1e-8,
                    weight_decay=0.0, step=1, mode: int = ADAM_MODE_ADAMW,
                    bias_correction: bool = True, inv_scale=1.0,
                    found_inf=False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Adam / AdamW step over flat 1-D fp32 buffers, in place; returns
    ``(p, m, v)``. ``lr``, ``step``, ``inv_scale`` and ``found_inf`` may be
    device tensors. CUDA tensors launch the kernel (contiguous float32, one
    length, one card); CPU tensors take the plain version."""
    if p.device.type == "cpu":
        return fused_adam_flat_plain(p, g, m, v, lr, beta1, beta2, eps,
                                     weight_decay, step, mode,
                                     bias_correction, inv_scale, found_inf)
    if p.device.type != "cuda":
        raise ValueError(f"fused_adam_flat: unsupported device {p.device}")
    if mode not in (ADAM_MODE_L2, ADAM_MODE_ADAMW):
        raise ValueError(f"fused_adam_flat: unknown mode {mode}")
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if t.dim() != 1 or t.dtype != torch.float32 \
                or t.device != p.device or not t.is_contiguous() \
                or t.numel() != p.numel():
            raise ValueError(
                f"fused_adam_flat: {name} must be a contiguous 1-D float32 "
                f"tensor of {p.numel()} elements on {p.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}")
    scal = pack_scalars(lr, beta1, beta2, eps, weight_decay, step,
                        bias_correction, inv_scale, found_inf,
                        device=p.device)
    lib = _build.lib()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.apex_fused_adam(p.data_ptr(), g.data_ptr(), m.data_ptr(),
                                  v.data_ptr(), scal.data_ptr(), p.numel(),
                                  int(mode), stream)
    _build.launches["fused_adam"] += 1
    _build.check(err, "fused_adam_flat")
    # written through raw pointers: tell autograd's version counters
    for t in (p, m, v):
        torch.autograd.graph.increment_version(t)
    return p, m, v
