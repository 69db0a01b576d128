"""Mixed precision of the PyTorch port (``apex_tpu.amp``): the dynamic
loss scaler."""

from apex_tpu_torch.amp.grad_scaler import (DynamicGradScaler, GradScaler,
                                            ScalerState, scale_loss)

__all__ = ["DynamicGradScaler", "GradScaler", "ScalerState", "scale_loss"]
