"""Fused Adam / AdamW over flat buffers: the CUDA kernels and their plain
versions.

Counterpart of ``apex_tpu/ops/pallas/fused_adam_kernel.py``:

- :func:`fused_adam_flat` (``fused_adam_flat``): p and g float32 or
  bfloat16, m and v float32;
- :func:`fused_adam_flat_master` (``fused_adam_flat_master``): a float32
  master p that also writes its bf16 copy in the same pass.

Each launches ``csrc/fused_adam.cu`` for CUDA tensors and runs its plain
version (``*_plain``) for CPU tensors. Both update their buffers in place
(the JAX kernels donate them) and return them.

The nine scalars ``[lr, beta1, beta2, eps, wd, bc1, bc2, inv_scale,
noop]`` are packed into a float32 tensor on the buffers' device by
:func:`pack_scalars`, as ``_pack_scalars`` does, with device ops only:
``lr``, ``step``, ``inv_scale`` and ``found_inf`` may be device tensors
and never reach the host, which keeps the update free of host syncs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops import _build

ADAM_MODE_L2 = 0     # Adam with L2 regularization (grad += wd * p)
ADAM_MODE_ADAMW = 1  # decoupled weight decay
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's dtype codes


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


def _adam_math(p32, g, m, v, scal: torch.Tensor, mode: int):
    """``_adam_kernel``'s arithmetic on the packed scalars, every step a
    separate fp32 operation in the kernel's order; returns the new p, m, v
    and the overflow flag."""
    lr, b1, b2, eps, wd, bc1, bc2, inv_scale, noop = scal.unbind(0)
    g = g.float() * inv_scale
    if mode == ADAM_MODE_L2:
        g = g + wd * p32
    m_new = b1 * m + (1.0 - b1) * g
    v_new = b2 * v + (1.0 - b2) * g * g
    update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    if mode == ADAM_MODE_ADAMW:
        update = update + wd * p32
    return p32 - lr * update, m_new, v_new, noop != 0.0


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
    arithmetic of ``_adam_kernel`` in fp32, in place, p stored back in its
    own dtype (round to nearest even for bf16); a set ``found_inf`` keeps
    p, m and v bit for bit."""
    scal = pack_scalars(lr, beta1, beta2, eps, weight_decay, step,
                        bias_correction, inv_scale, found_inf,
                        device=p.device)
    p32 = p.float()
    p_new, m_new, v_new, keep = _adam_math(p32, g, m, v, scal, mode)
    p.copy_(torch.where(keep, p32, p_new))
    m.copy_(torch.where(keep, m, m_new))
    v.copy_(torch.where(keep, v, v_new))
    return p, m, v


def fused_adam_flat_master_plain(
        p_master: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
        v: torch.Tensor, lr, beta1: float = 0.9, beta2: float = 0.999,
        eps: float = 1e-8, weight_decay=0.0, step=1,
        mode: int = ADAM_MODE_ADAMW, bias_correction: bool = True,
        inv_scale=1.0, found_inf=False,
        p_lp: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`fused_adam_flat_master` in plain PyTorch, on any device: the
    arithmetic of ``_master_adam_kernel``, the fp32 master, m and v in
    place (kept bit for bit when ``found_inf`` is set) and ``p_lp`` the
    bf16 cast of the selected master."""
    p_lp = _lp_out(p_master, p_lp)
    scal = pack_scalars(lr, beta1, beta2, eps, weight_decay, step,
                        bias_correction, inv_scale, found_inf,
                        device=p_master.device)
    p_new, m_new, v_new, keep = _adam_math(p_master, g, m, v, scal, mode)
    p_master.copy_(torch.where(keep, p_master, p_new))
    m.copy_(torch.where(keep, m, m_new))
    v.copy_(torch.where(keep, v, v_new))
    p_lp.copy_(p_master)
    return p_master, p_lp, m, v


def _lp_out(p_master: torch.Tensor, p_lp: Optional[torch.Tensor]
            ) -> torch.Tensor:
    if p_lp is None:
        return torch.empty(p_master.shape, dtype=torch.bfloat16,
                           device=p_master.device)
    if p_lp.dtype != torch.bfloat16 or p_lp.shape != p_master.shape \
            or p_lp.device != p_master.device or not p_lp.is_contiguous():
        raise ValueError(
            f"fused_adam_flat_master: p_lp must be a contiguous bfloat16 "
            f"tensor shaped like the master {tuple(p_master.shape)} on "
            f"{p_master.device}, got {tuple(p_lp.shape)} {p_lp.dtype} on "
            f"{p_lp.device}")
    return p_lp


def _check_flat(name: str, p: torch.Tensor, want) -> None:
    """Each ``(what, tensor, dtype)`` of ``want`` is a contiguous 1-D
    tensor of ``dtype`` with p's length on p's card."""
    for what, t, dtype in want:
        if t.dim() != 1 or t.dtype != dtype or t.device != p.device \
                or not t.is_contiguous() or t.numel() != p.numel():
            raise ValueError(
                f"{name}: {what} must be a contiguous 1-D {dtype} tensor of "
                f"{p.numel()} elements on {p.device}, got {tuple(t.shape)} "
                f"{t.dtype} on {t.device}")


def _launch_device(name: str, p: torch.Tensor, mode: int) -> None:
    if p.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {p.device}")
    if mode not in (ADAM_MODE_L2, ADAM_MODE_ADAMW):
        raise ValueError(f"{name}: unknown mode {mode}")


def fused_adam_flat(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                    v: torch.Tensor, lr, beta1: float = 0.9,
                    beta2: float = 0.999, eps: float = 1e-8,
                    weight_decay=0.0, step=1, mode: int = ADAM_MODE_ADAMW,
                    bias_correction: bool = True, inv_scale=1.0,
                    found_inf=False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Adam / AdamW step over flat 1-D buffers, in place; returns
    ``(p, m, v)``. p and g are float32 or bfloat16 (one dtype), m and v
    float32; ``lr``, ``step``, ``inv_scale`` and ``found_inf`` may be
    device tensors. CUDA tensors launch the kernel (contiguous, one length,
    one card); CPU tensors take the plain version."""
    if p.device.type == "cpu":
        return fused_adam_flat_plain(p, g, m, v, lr, beta1, beta2, eps,
                                     weight_decay, step, mode,
                                     bias_correction, inv_scale, found_inf)
    _launch_device("fused_adam_flat", p, mode)
    if p.dtype not in _DTYPES:
        raise ValueError(f"fused_adam_flat: p must be float32 or bfloat16, "
                         f"got {p.dtype}")
    _check_flat("fused_adam_flat", p, (("p", p, p.dtype), ("g", g, p.dtype),
                                       ("m", m, torch.float32),
                                       ("v", v, torch.float32)))
    scal = pack_scalars(lr, beta1, beta2, eps, weight_decay, step,
                        bias_correction, inv_scale, found_inf,
                        device=p.device)
    lib = _build.lib()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.apex_fused_adam(p.data_ptr(), g.data_ptr(), m.data_ptr(),
                                  v.data_ptr(), scal.data_ptr(), p.numel(),
                                  int(mode), _DTYPES[p.dtype], stream)
    _build.launches["fused_adam"] += 1
    _build.check(err, "fused_adam_flat")
    # written through raw pointers: tell autograd's version counters
    for t in (p, m, v):
        torch.autograd.graph.increment_version(t)
    return p, m, v


def fused_adam_flat_master(
        p_master: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
        v: torch.Tensor, lr, beta1: float = 0.9, beta2: float = 0.999,
        eps: float = 1e-8, weight_decay=0.0, step=1,
        mode: int = ADAM_MODE_ADAMW, bias_correction: bool = True,
        inv_scale=1.0, found_inf=False,
        p_lp: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Master-weight Adam / AdamW over flat 1-D fp32 buffers: the master,
    m and v updated in place and the bf16 copy of the (selected) master
    written into ``p_lp`` (allocated when None) in the same pass; returns
    ``(p_master, p_lp, m, v)`` as the JAX function does. CUDA tensors
    launch the kernel; CPU tensors take the plain version."""
    if p_master.device.type == "cpu":
        return fused_adam_flat_master_plain(
            p_master, g, m, v, lr, beta1, beta2, eps, weight_decay, step,
            mode, bias_correction, inv_scale, found_inf, p_lp)
    _launch_device("fused_adam_flat_master", p_master, mode)
    p_lp = _lp_out(p_master, p_lp)
    _check_flat("fused_adam_flat_master", p_master,
                (("p_master", p_master, torch.float32),
                 ("g", g, torch.float32), ("m", m, torch.float32),
                 ("v", v, torch.float32), ("p_lp", p_lp, torch.bfloat16)))
    scal = pack_scalars(lr, beta1, beta2, eps, weight_decay, step,
                        bias_correction, inv_scale, found_inf,
                        device=p_master.device)
    lib = _build.lib()
    with torch.cuda.device(p_master.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.apex_fused_adam_master(
            p_master.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            p_lp.data_ptr(), scal.data_ptr(), p_master.numel(), int(mode),
            stream)
    _build.launches["fused_adam_master"] += 1
    _build.check(err, "fused_adam_flat_master")
    for t in (p_master, p_lp, m, v):
        torch.autograd.graph.increment_version(t)
    return p_master, p_lp, m, v
