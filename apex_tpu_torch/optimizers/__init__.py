"""Optimizers of the PyTorch port (``apex_tpu.optimizers``)."""

from apex_tpu_torch.optimizers.functional import (adagrad_update,
                                                  adam_update, lamb_update,
                                                  novograd_update,
                                                  sgd_update)
from apex_tpu_torch.optimizers.fused_adagrad import FusedAdagrad
from apex_tpu_torch.optimizers.fused_adam import FusedAdam, FusedAdamW
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB
from apex_tpu_torch.optimizers.fused_novograd import FusedNovoGrad
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD

__all__ = ["FusedAdagrad", "FusedAdam", "FusedAdamW", "FusedLAMB",
           "FusedNovoGrad", "FusedSGD", "adagrad_update", "adam_update",
           "lamb_update", "novograd_update", "sgd_update"]
