"""Fused SGD over flat buffers: the CUDA kernel and its plain version.

Counterpart of ``apex_tpu/ops/pallas/fused_sgd_kernel.py``
``fused_sgd_flat``: momentum, dampening, Nesterov, weight decay before or
after the momentum, the first-step buffer initialisation, ``inv_scale``
and the ``found_inf`` no-op. :func:`fused_sgd_flat` launches
``csrc/fused_sgd.cu`` for CUDA tensors and runs :func:`fused_sgd_flat_plain`
for CPU tensors; both update p and the momentum buffer in place (the JAX
kernel donates them) and return them.

p and g are float32 or bfloat16 (one dtype: the JAX class flattens the
gradients to its flat buffer's dtype), the momentum buffer float32. The
seven scalars ``[lr, momentum, dampening, wd, inv_scale, noop,
first_step]`` are packed into a float32 tensor on the buffers' device with
device ops only, so ``lr``, ``inv_scale``, ``found_inf`` and
``first_step`` may be device tensors that never reach the host.
"""

from __future__ import annotations

from typing import Tuple

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.fused_adam_kernel import (_DTYPES, _check_flat,
                                                  _dev_scalar)


def pack_sgd_scalars(lr, momentum, dampening, weight_decay, inv_scale,
                     found_inf, first_step, *, device: torch.device
                     ) -> torch.Tensor:
    """``[lr, momentum, dampening, wd, inv_scale, noop, first_step]`` as
    float32 on ``device``, as ``fused_sgd_flat`` stacks them."""
    return torch.cat([_dev_scalar(x, device) for x in (
        lr, momentum, dampening, weight_decay, inv_scale, found_inf,
        first_step)])


def fused_sgd_flat_plain(p: torch.Tensor, g: torch.Tensor,
                         momentum_buf: torch.Tensor, lr,
                         momentum: float = 0.0, dampening: float = 0.0,
                         weight_decay=0.0, nesterov: bool = False,
                         wd_after_momentum: bool = False, inv_scale=1.0,
                         found_inf=False, first_step=False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_sgd_flat` in plain PyTorch, on any device: the
    arithmetic of ``_sgd_kernel`` in fp32, every step a separate operation
    in the kernel's order, in place, p stored back in its own dtype; a set
    ``found_inf`` keeps p and the buffer bit for bit, and with momentum 0
    the buffer keeps its bits."""
    lr, mom, damp, wd, inv_scale, noop, first = pack_sgd_scalars(
        lr, momentum, dampening, weight_decay, inv_scale, found_inf,
        first_step, device=p.device).unbind(0)
    p32 = p.float()
    g = g.float() * inv_scale
    if not wd_after_momentum:
        g = g + wd * p32
    b_new = torch.where(first != 0.0, g,
                        mom * momentum_buf + (1.0 - damp) * g)
    use_momentum = mom != 0.0
    if nesterov:
        d = torch.where(use_momentum, g + mom * b_new, g)
    else:
        d = torch.where(use_momentum, b_new, g)
    if wd_after_momentum:
        d = d + wd * p32
    p_new = p32 - lr * d
    keep = noop != 0.0
    p.copy_(torch.where(keep, p32, p_new))
    momentum_buf.copy_(torch.where(keep | ~use_momentum, momentum_buf,
                                   b_new))
    return p, momentum_buf


def fused_sgd_flat(p: torch.Tensor, g: torch.Tensor,
                   momentum_buf: torch.Tensor, lr, momentum: float = 0.0,
                   dampening: float = 0.0, weight_decay=0.0,
                   nesterov: bool = False, wd_after_momentum: bool = False,
                   inv_scale=1.0, found_inf=False, first_step=False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One SGD step over flat 1-D buffers, in place; returns ``(p,
    momentum_buf)``. CUDA tensors launch the kernel (contiguous, one
    length, one card); CPU tensors take the plain version."""
    if p.device.type == "cpu":
        return fused_sgd_flat_plain(p, g, momentum_buf, lr, momentum,
                                    dampening, weight_decay, nesterov,
                                    wd_after_momentum, inv_scale, found_inf,
                                    first_step)
    if p.device.type != "cuda":
        raise ValueError(f"fused_sgd_flat: unsupported device {p.device}")
    if p.dtype not in _DTYPES:
        raise ValueError(f"fused_sgd_flat: p must be float32 or bfloat16, "
                         f"got {p.dtype}")
    _check_flat("fused_sgd_flat", p,
                (("p", p, p.dtype), ("g", g, p.dtype),
                 ("momentum_buf", momentum_buf, torch.float32)))
    scal = pack_sgd_scalars(lr, momentum, dampening, weight_decay,
                            inv_scale, found_inf, first_step,
                            device=p.device)
    lib = _build.lib()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.apex_fused_sgd(p.data_ptr(), g.data_ptr(),
                                 momentum_buf.data_ptr(), scal.data_ptr(),
                                 p.numel(), int(nesterov),
                                 int(wd_after_momentum), _DTYPES[p.dtype],
                                 stream)
    _build.launches["fused_sgd"] += 1
    _build.check(err, "fused_sgd_flat")
    # written through raw pointers: tell autograd's version counters
    for t in (p, momentum_buf):
        torch.autograd.graph.increment_version(t)
    return p, momentum_buf
