"""Normalization layers of the PyTorch port (``apex_tpu.normalization``)."""

from apex_tpu_torch.normalization.fused_layer_norm import (
    FusedLayerNorm, FusedRMSNorm, fused_layer_norm, fused_layer_norm_affine,
    fused_rms_norm, fused_rms_norm_affine, manual_layer_norm,
    manual_rms_norm)

__all__ = ["FusedLayerNorm", "FusedRMSNorm", "fused_layer_norm",
           "fused_layer_norm_affine", "fused_rms_norm",
           "fused_rms_norm_affine", "manual_layer_norm", "manual_rms_norm"]
