"""Optimizers of the PyTorch port (``apex_tpu.optimizers``)."""

from apex_tpu_torch.optimizers.functional import adam_update, lamb_update
from apex_tpu_torch.optimizers.fused_adam import FusedAdam, FusedAdamW
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB

__all__ = ["FusedAdam", "FusedAdamW", "FusedLAMB", "adam_update",
           "lamb_update"]
