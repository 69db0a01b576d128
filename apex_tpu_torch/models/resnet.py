"""ResNet — counterpart of ``apex_tpu/models/resnet.py`` (the repository's
north-star model: ``BASELINE.md`` configurations 2-3, the recipe of
``examples/imagenet/main_amp.py``).

As in the JAX model: NHWC images in, float32 parameters, products in
``compute_dtype`` (bf16 by default) with the image cast to it at the
entry, :class:`~apex_tpu_torch.parallel.SyncBatchNorm` (single card) as
the norm layer, bottleneck blocks (1x1, 3x3 with the stride, 1x1, then a
1x1 projection of the input where the shape changes), a mean over H and W
and an fp32 dense head. The flax layer names are kept
(``conv1``, ``bn1``, ``stage{s}_block{b}.{conv1,bn1,...,downsample_bn}``,
``fc``) so :mod:`apex_tpu_torch.models.convert` maps the trees one to one.

Layout: activations stay logical NHWC tensors between the layers, as in
the JAX model, and the convolutions and the max pool see them through
``permute`` views that are NCHW in PyTorch's terms and channels-last in
memory, so cuDNN runs its NHWC kernels (the layout XLA picks) and no
transpose is copied. Convolutions are ``F.conv2d`` (cuDNN), plain XLA
convolutions outside any Pallas kernel in the JAX package; padding
follows flax: a 1x1 convolution's ``SAME`` is no padding, the 3x3 ones
pad (1, 1) and the stem's 7x7 (3, 3); the max pool pads with -inf.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.parallel.sync_batch_norm import SyncBatchNorm
from apex_tpu_torch.utils.device import DeviceLike, resolve_device


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """A logical NHWC tensor as PyTorch's NCHW view (channels-last
    strides)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """A bias-free convolution with a float32 ``weight (out, in, kh, kw)``
    (flax's ``kernel (kh, kw, in, out)``), run in the input's dtype on
    NHWC activations; built empty on ``device`` (default ``cuda``)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, *, device: DeviceLike = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(
            cout, cin, k, k, device=resolve_device(device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(dtype=x.dtype, memory_format=torch.channels_last)
        return _nhwc(F.conv2d(_nchw(x), w, stride=self.stride,
                              padding=self.padding))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 bottleneck with a residual (expansion
    4); BatchNorm + ReLU after the first two convolutions, BatchNorm after
    the third, ReLU after the sum."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 *, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        bn = dict(channel_axis=-1, device=device)
        self.conv1 = Conv(in_features, features, 1, device=device)
        self.bn1 = SyncBatchNorm(features, fuse_relu=True, **bn)
        self.conv2 = Conv(features, features, 3, strides, 1, device=device)
        self.bn2 = SyncBatchNorm(features, fuse_relu=True, **bn)
        self.conv3 = Conv(features, features * 4, 1, device=device)
        self.bn3 = SyncBatchNorm(features * 4, **bn)
        self.needs_proj = in_features != features * 4 or strides != 1
        if self.needs_proj:
            self.downsample_conv = Conv(in_features, features * 4, 1,
                                        strides, device=device)
            self.downsample_bn = SyncBatchNorm(features * 4, **bn)

    def forward(self, x: torch.Tensor,
                use_running_average: bool = False) -> torch.Tensor:
        ura = use_running_average
        y = self.bn1(self.conv1(x), ura)
        y = self.bn2(self.conv2(y), ura)
        y = self.bn3(self.conv3(y), ura)
        residual = x
        if self.needs_proj:
            residual = self.downsample_bn(self.downsample_conv(x), ura)
        return torch.relu(y + residual.to(y.dtype))


class ResNet(nn.Module):
    """A bottleneck ResNet over NHWC images ``(b, h, w, 3)``; returns fp32
    logits ``(b, num_classes)`` (float64 with a float64
    ``compute_dtype``). Built empty on ``device`` (default
    ``cuda``); fill it with ``load_state_dict`` of
    :func:`~apex_tpu_torch.models.convert.init_resnet_params` or
    :func:`~apex_tpu_torch.models.convert.resnet_params_from_jax`. Single
    card (``axis_name=None``)."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 axis_name=None, compute_dtype: torch.dtype = torch.bfloat16,
                 *, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        if axis_name is not None:
            raise NotImplementedError(
                "ResNet with a cross-device SyncBatchNorm (axis_name set) "
                "comes with the port's distributed slice")
        self.compute_dtype = compute_dtype
        self.conv1 = Conv(3, 64, 7, 2, 3, device=dev)
        self.bn1 = SyncBatchNorm(64, fuse_relu=True, device=dev)
        cin, features = 64, 64
        self.blocks = []
        for stage, n_blocks in enumerate(stage_sizes):
            for blk in range(n_blocks):
                strides = 2 if (stage > 0 and blk == 0) else 1
                name = f"stage{stage}_block{blk}"
                self.add_module(name, Bottleneck(cin, features, strides,
                                                 device=dev))
                self.blocks.append(name)
                cin = features * 4
            features *= 2
        self.fc = nn.Linear(cin, num_classes, device=dev)

    @property
    def device(self) -> torch.device:
        return self.fc.weight.device

    def forward(self, x: torch.Tensor,
                use_running_average: bool = False) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        x = self.bn1(self.conv1(x), use_running_average)
        x = _nhwc(F.max_pool2d(_nchw(x), 3, 2, 1))
        for name in self.blocks:
            x = getattr(self, name)(x, use_running_average)
        x = x.mean(dim=(1, 2))
        hd = torch.promote_types(self.compute_dtype, torch.float32)
        return F.linear(x.to(hd), self.fc.weight.to(hd),
                        self.fc.bias.to(hd))


def ResNet50(num_classes: int = 1000, axis_name=None,
             compute_dtype: torch.dtype = torch.bfloat16, *,
             device: DeviceLike = None) -> ResNet:
    return ResNet([3, 4, 6, 3], num_classes, axis_name, compute_dtype,
                  device=device)


def ResNet18ish(num_classes: int = 10, axis_name=None,
                compute_dtype: torch.dtype = torch.bfloat16, *,
                device: DeviceLike = None) -> ResNet:
    """Small stand-in for fast tests (bottleneck blocks, [1, 1, 1, 1]
    stages)."""
    return ResNet([1, 1, 1, 1], num_classes, axis_name, compute_dtype,
                  device=device)

