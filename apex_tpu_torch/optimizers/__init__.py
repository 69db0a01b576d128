"""Optimizers of the PyTorch port (``apex_tpu.optimizers``)."""

from apex_tpu_torch.optimizers.functional import adam_update
from apex_tpu_torch.optimizers.fused_adam import FusedAdam, FusedAdamW

__all__ = ["FusedAdam", "FusedAdamW", "adam_update"]
