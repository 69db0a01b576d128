"""Host-side helpers of the PyTorch port."""

from apex_tpu_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
