"""apex_tpu_torch — the PyTorch / CUDA port of apex_tpu for NVIDIA Hopper.

The JAX package ``apex_tpu`` stays the reference; this package keeps its
module names so each counterpart is easy to find, imports only ``torch``
and ``numpy``, and runs its entry points on ``cuda`` unless the caller
asks for ``device="cpu"``. Every Pallas kernel on a ported path is a CUDA
kernel written by hand for ``sm_90a`` under ``csrc/``; plain XLA code is
plain PyTorch.
"""

from apex_tpu_torch.utils.device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__"]
