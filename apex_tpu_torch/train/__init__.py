"""Training loop of the PyTorch port (``apex_tpu.train``)."""

from apex_tpu_torch.train.config import TrainConfig
from apex_tpu_torch.train.trainer import Trainer

__all__ = ["TrainConfig", "Trainer"]
