"""NHWC GroupNorm with fused SiLU — counterpart of
``apex_tpu/contrib/group_norm.py`` (apex's ``group_norm_cuda`` /
``group_norm_v2_cuda`` and the frontend ``GroupNorm``).

:func:`group_norm_nhwc` runs one ``autograd.Function`` whose forward is
:func:`~apex_tpu_torch.ops.group_norm_kernel.gn_forward` (the one-pass
kernel or the two-pass pair, by ``algo``) and whose backward is the JAX
package's analytic chain from the saved statistics, as tensor ops (XLA in
the JAX package): the SiLU derivative folded into dy, dgamma and dbeta
summed over (n, h, w), the per-(n, g) means of ``wdy`` and ``wdy *
xhat``, dx in x's dtype, dgamma / dbeta in the parameters' dtype. CUDA
tensors take this route at every shape: the kernels take any hw. CPU
tensors, whose forward is the kernels' plain twins, keep the JAX
package's routing: hw not a multiple of 8 (the TPU's 8-sublane tiles)
takes :func:`_gn_plain`, the centred plain reference, differentiated by
autograd, and an explicit ``algo`` there raises.

The kernels' statistics are shifted by each group's first element K where
the TPU kernels take ``E[x^2] - mean^2``: they agree on well-conditioned
input and stay finite on a group whose mean dwarfs its spread, where the
TPU kernels return NaN. The backward rebuilds ``xhat`` as ``((x - K) -
mean_d) * rstd`` from the forward's ``mean_d``, as the kernels do, so the
gradients keep that precision too.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from apex_tpu_torch.ops.group_norm_kernel import ACTS, gn_forward, gn_shift
from apex_tpu_torch.utils.device import DeviceLike, resolve_device

_f32 = torch.float32


def _gn_plain(x: torch.Tensor, num_groups: int,
              weight: Optional[torch.Tensor], bias: Optional[torch.Tensor],
              eps: float, act: str) -> torch.Tensor:
    """The JAX ``_gn_jnp``: mean, then the centred variance, per (n, g) in
    fp32; the affine and SiLU; y in x's dtype."""
    n, h, w, c = x.shape
    x32 = x.to(_f32).reshape(n, h * w, num_groups, c // num_groups)
    mean = x32.mean(dim=(1, 3), keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    if weight is not None:
        y = y * weight.to(_f32)
    if bias is not None:
        y = y + bias.to(_f32)
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


class _GroupNormFn(torch.autograd.Function):
    """``_gn_pallas`` with its ``custom_vjp``: saves x, the parameters and
    the forward's mean_d / rstd; the backward is ``_gn_pallas_bwd``, with
    xhat from the shifted statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, act, algo):
        n, h, w, c = x.shape
        x3 = x.reshape(n, h * w, c).contiguous()
        y, dmean, rstd = gn_forward(x3, num_groups, weight, bias, eps, act,
                                    algo)
        ctx.save_for_backward(x3, weight, bias, dmean, rstd)
        ctx.num_groups, ctx.act = num_groups, act
        return y.reshape(n, h, w, c)

    @staticmethod
    def backward(ctx, dy):
        x3, weight, bias, dmean, rstd = ctx.saved_tensors
        n, h, w, c = dy.shape
        g = ctx.num_groups
        cpg = c // g

        def per_channel(t):
            return t.repeat_interleave(cpg, dim=1)[:, None, None, :]

        x = x3.reshape(n, h, w, c)
        # ((x - K) - mean_d) * rstd, the last two steps in place on the new
        # fp32 tensor
        xhat = (x.to(_f32) - per_channel(gn_shift(x3, g))) \
            .sub_(per_channel(dmean)).mul_(per_channel(rstd))
        dy32 = dy.to(_f32)
        if ctx.act == "silu":
            # the pre-activation z again, and silu'(z) folded into dy
            z = xhat
            if weight is not None:
                z = z * weight.to(_f32)
            if bias is not None:
                z = z + bias.to(_f32)
            sig = torch.sigmoid(z)
            dy32 = dy32 * (sig * (1.0 + z * (1.0 - sig)))
        dgamma = dbeta = None
        wdy = dy32
        if weight is not None:
            dgamma = (dy32 * xhat).sum(dim=(0, 1, 2)).to(weight.dtype)
            wdy = dy32 * weight.to(_f32)
        if bias is not None:
            dbeta = dy32.sum(dim=(0, 1, 2)).to(bias.dtype)
        # per-(n, g) means of wdy and wdy * xhat
        wdy_g = wdy.reshape(n, h * w, g, cpg)
        xhat_g = xhat.reshape(n, h * w, g, cpg)
        m1 = wdy_g.mean(dim=(1, 3), keepdim=True)
        m2 = (wdy_g * xhat_g).mean(dim=(1, 3), keepdim=True)
        dx = (wdy_g - m1 - xhat_g * m2) * rstd[:, None, :, None]
        return (dx.reshape(n, h, w, c).to(x.dtype), dgamma, dbeta, None,
                None, None, None)


def group_norm_nhwc(x: torch.Tensor, num_groups: int,
                    weight: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
                    act: str = "", algo: str = "auto") -> torch.Tensor:
    """x ``(n, h, w, c)``; ``act`` in {"", "silu"}; differentiable in x,
    weight and bias. CUDA tensors run the kernels at every shape (the
    one-pass kernel when the (n, g) slab fits its block's shared memory,
    else the two-pass pair; ``algo`` "one_pass" / "two_pass" forces one).
    CPU tensors route as the JAX package does: the kernels' plain twins
    when ``hw % 8 == 0``, else the plain reference, where an explicit
    ``algo`` raises ``ValueError``."""
    n, h, w, c = x.shape
    if c % num_groups:
        raise ValueError(f"num_groups={num_groups} must divide c={c}")
    if act not in ACTS:
        raise ValueError(f"unsupported act {act!r}")
    if x.device.type == "cpu" and (h * w) % 8:
        # the JAX package's route for shapes its TPU kernels do not tile
        if algo != "auto":
            # an explicit algorithm request must not silently run the plain
            # path
            raise ValueError(
                f"algo={algo!r} requested but the kernels need HW % 8 == 0 "
                f"(got {h}x{w}); use algo='auto' for the plain reference")
        return _gn_plain(x, num_groups, weight, bias, eps, act)
    return _GroupNormFn.apply(x, weight, bias, num_groups, float(eps), act,
                              algo)


def torch_group_norm(x: torch.Tensor, num_groups: int,
                     weight: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
                     act: str = "") -> torch.Tensor:
    """Name-parity alias for the reference's fallback (apex's
    ``group_norm.py:37``)."""
    return group_norm_nhwc(x, num_groups, weight, bias, eps, act)


class GroupNorm(nn.Module):
    """GroupNorm over NHWC input, ``act="silu"`` fusing the activation; with
    ``affine`` (the default) a ``weight`` (ones) and ``bias`` (zeros) of
    ``param_dtype``, the flax module's names, on ``device`` (default
    ``cuda``)."""

    def __init__(self, num_groups: int, num_channels: int,
                 eps: float = 1e-5, affine: bool = True, act: str = "",
                 param_dtype: torch.dtype = _f32, *,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.num_groups, self.num_channels = num_groups, num_channels
        self.eps, self.affine, self.act = eps, affine, act
        if affine:
            kw = dict(dtype=param_dtype, device=dev)
            self.weight = nn.Parameter(torch.ones(num_channels, **kw))
            self.bias = nn.Parameter(torch.zeros(num_channels, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight if self.affine else None
        b = self.bias if self.affine else None
        return group_norm_nhwc(x, self.num_groups, w, b, self.eps, self.act)
