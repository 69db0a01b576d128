"""Whole-MLP forward — counterpart of ``apex_tpu/transformer/mlp.py``
(apex's ``mlp_cuda`` and ``apex.mlp.MLP``).

Each layer: ``h @ weight.T`` with fp32 accumulation, ``+ bias`` in fp32,
the activation (``none`` / ``relu`` / ``sigmoid``) after every layer but
the last, and the layer's output cast to x's dtype. The JAX package runs
this as XLA ops, so here it is PyTorch ops and autograd.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from apex_tpu_torch.transformer.fused_dense import (dense_param, matmul_f32,
                                                    zeros_param)
from apex_tpu_torch.utils.device import DeviceLike, resolve_device

_ACTS = {
    "none": lambda h: h,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
}


def mlp_forward(x: torch.Tensor, weights: Sequence[torch.Tensor],
                biases: Optional[Sequence[torch.Tensor]],
                activation: str = "relu") -> torch.Tensor:
    """The whole MLP over weights ``(out, in)``; a weight whose dtype
    differs from the layer input's is promoted with it, as JAX promotes."""
    if activation not in _ACTS:
        raise ValueError(f"mlp_forward: activation {activation!r} not in "
                         f"{sorted(_ACTS)}")
    act = _ACTS[activation]
    h = x
    for i, w in enumerate(weights):
        dt = torch.promote_types(h.dtype, w.dtype)
        h = matmul_f32(h.to(dt), w.to(dt))
        if biases is not None:
            h = h + biases[i].float()
        if i < len(weights) - 1:
            h = act(h)
        h = h.to(x.dtype)
    return h


class MLP(nn.Module):
    """``apex.mlp.MLP(mlp_sizes, bias, activation)``: ``mlp_sizes = [in,
    hidden..., out]``, parameters ``weight_{i} (out, in)`` (lecun normal)
    and ``bias_{i}`` (zeros), the flax module's names, on ``device``
    (default ``cuda``) in ``param_dtype``."""

    def __init__(self, mlp_sizes: Sequence[int], use_bias: bool = True,
                 activation: str = "relu", param_dtype=torch.float32, *,
                 device: DeviceLike = None):
        super().__init__()
        if activation not in _ACTS:
            raise ValueError(f"MLP: activation {activation!r} not in "
                             f"{sorted(_ACTS)}")
        device = resolve_device(device)
        self.n_layers = len(mlp_sizes) - 1
        self.use_bias, self.activation = use_bias, activation
        for i in range(self.n_layers):
            setattr(self, f"weight_{i}", dense_param(
                mlp_sizes[i + 1], mlp_sizes[i], device, param_dtype))
            if use_bias:
                setattr(self, f"bias_{i}", zeros_param(
                    mlp_sizes[i + 1], device, param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ws = [getattr(self, f"weight_{i}") for i in range(self.n_layers)]
        bs = ([getattr(self, f"bias_{i}") for i in range(self.n_layers)]
              if self.use_bias else None)
        return mlp_forward(x, ws, bs, self.activation)
