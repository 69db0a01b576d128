"""SyncBatchNorm — counterpart of ``apex_tpu/parallel/sync_batch_norm.py``.

Batch statistics with the JAX package's *shifted one-pass* formula: per
channel, the shift is the first element along the reduced axes
(detached), ``d = x - shift`` and ``var = max(E[d^2] - E[d]^2, 0)``, which
keeps a channel whose mean is far larger than its spread exact where
``E[x^2] - E[x]^2`` would cancel. The normalised output is made in fp32
(``(x - mean) * rsqrt(var + eps)``, then ``* weight + bias``, then the
fused ReLU) and cast back to x's dtype. Statistics and output are fp32 as
in the JAX package, or float64 for a float64 input (which the JAX package,
without 64-bit mode, never sees), so a float64 model computes in float64
throughout. Running statistics start as zeros
/ ones and move by ``momentum`` with the unbiased variance (``count /
(count - 1)``).

All of it is plain PyTorch, as it is plain XLA in the JAX package (there
is no Pallas BatchNorm kernel); autograd differentiates the formula.
``F.batch_norm`` is not used: it is another formula.

Single card only: a cross-device merge (``axis_name`` set, the
all-gather and Chan / Welford merge of :func:`_welford_merge`) raises
``NotImplementedError`` until the port's distributed slice.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from apex_tpu_torch.utils.device import DeviceLike, resolve_device

_f32 = torch.float32


def _no_merge(axis_name) -> None:
    if axis_name is not None:
        raise NotImplementedError(
            f"SyncBatchNorm across devices (axis_name={axis_name!r}): the "
            f"cross-device Welford merge comes with the port's distributed "
            f"slice; use axis_name=None on one card")


def _welford_merge(mean_a, m2_a, n_a, mean_b, m2_b, n_b):
    """Chan et al.'s pairwise merge of two (mean, m2, count) summaries, as
    the JAX package merges devices' statistics."""
    n = n_a + n_b
    delta = mean_b - mean_a
    safe_n = torch.where(n > 0, n, torch.ones_like(n))
    mean = mean_a + delta * n_b / safe_n
    m2 = m2_a + m2_b + delta * delta * n_a * n_b / safe_n
    return mean, m2, n


def sync_batch_norm_stats(x: torch.Tensor, reduce_axes: Sequence[int],
                          axis_name: Optional[str] = None,
                          axis_index_groups=None,
                          shift: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """``(mean, biased var, count)`` in fp32 (float64 for a float64 ``x``)
    over ``reduce_axes``, shaped
    like the remaining (channel) dimensions, by the shifted one-pass
    formula. ``shift`` (channel-shaped) replaces the default shift, the
    first element along the reduced axes; either is detached."""
    _no_merge(axis_name)
    del axis_index_groups  # subgroups of a cross-device merge
    cdt = torch.promote_types(x.dtype, _f32)
    x32 = x.to(cdt)
    reduce_axes = tuple(sorted(a % x.ndim for a in reduce_axes))
    n = 1
    for a in reduce_axes:
        n *= x.shape[a]
    bc = tuple(1 if a in reduce_axes else x.shape[a] for a in range(x.ndim))
    if shift is None:
        idx = tuple(0 if a in reduce_axes else slice(None)
                    for a in range(x.ndim))
        shift_c = x32[idx].detach()
    else:
        shift_c = torch.as_tensor(shift, dtype=cdt,
                                  device=x.device).detach()
    d = x32 - shift_c.reshape(bc)
    mean_d = d.mean(dim=reduce_axes)
    mean2_d = (d * d).mean(dim=reduce_axes)
    var = torch.clamp_min(mean2_d - mean_d * mean_d, 0.0)
    mean = shift_c.reshape(mean_d.shape) + mean_d
    return mean, var, torch.full((), float(n), dtype=cdt, device=x.device)


class SyncBatchNorm(nn.Module):
    """BatchNorm over every axis but ``channel_axis`` (-1: NHWC, 1: NCHW),
    with the flax module's names: parameters ``weight`` / ``bias`` (fp32,
    ones / zeros) and the running statistics as buffers ``mean`` / ``var``
    (the flax ``batch_stats``). ``forward(x, use_running_average)``
    normalises with the running statistics when asked, else with the
    batch's and moves the running ones (``track_running_stats``). Built on
    ``device`` (default ``cuda``)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True,
                 axis_name: Optional[str] = None, channel_axis: int = -1,
                 fuse_relu: bool = False, *, device: DeviceLike = None):
        super().__init__()
        _no_merge(axis_name)
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.channel_axis = channel_axis
        self.fuse_relu = fuse_relu
        kw = dict(dtype=_f32, device=resolve_device(device))
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features, **kw))
            self.bias = nn.Parameter(torch.zeros(num_features, **kw))
        self.register_buffer("mean", torch.zeros(num_features, **kw))
        self.register_buffer("var", torch.ones(num_features, **kw))

    def forward(self, x: torch.Tensor,
                use_running_average: bool = False) -> torch.Tensor:
        ca = self.channel_axis % x.ndim
        reduce_axes = tuple(a for a in range(x.ndim) if a != ca)
        bc = tuple(self.num_features if a == ca else 1
                   for a in range(x.ndim))
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            mean, var, count = sync_batch_norm_stats(x, reduce_axes)
            if self.track_running_stats:
                with torch.no_grad():
                    unbiased = var * count / torch.clamp_min(count - 1.0,
                                                             1.0)
                    self.mean.copy_((1 - self.momentum) * self.mean
                                    + self.momentum * mean)
                    self.var.copy_((1 - self.momentum) * self.var
                                   + self.momentum * unbiased)
        cdt = torch.promote_types(x.dtype, _f32)
        y = (x.to(cdt) - mean.reshape(bc)) * torch.rsqrt(
            var.reshape(bc) + self.eps)
        if self.affine:
            y = y * self.weight.reshape(bc).to(cdt) \
                + self.bias.reshape(bc).to(cdt)
        if self.fuse_relu:
            y = torch.relu(y)
        return y.to(x.dtype)
