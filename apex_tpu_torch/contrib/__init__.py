"""Contributed ops of the PyTorch port (``apex_tpu.contrib``)."""

from apex_tpu_torch.contrib.group_norm import (GroupNorm, group_norm_nhwc,
                                               torch_group_norm)

__all__ = ["GroupNorm", "group_norm_nhwc", "torch_group_norm"]
