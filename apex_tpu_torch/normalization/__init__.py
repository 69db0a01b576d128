"""Normalization layers of the PyTorch port (``apex_tpu.normalization``)."""

from apex_tpu_torch.normalization.fused_layer_norm import (
    FusedLayerNorm, fused_layer_norm_affine, manual_layer_norm)

__all__ = ["FusedLayerNorm", "fused_layer_norm_affine", "manual_layer_norm"]
