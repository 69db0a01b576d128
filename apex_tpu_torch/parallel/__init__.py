"""Parallelism of the PyTorch port (``apex_tpu.parallel``): single-card
SyncBatchNorm so far; the cross-device merge is a later slice."""

from apex_tpu_torch.parallel.sync_batch_norm import (SyncBatchNorm,
                                                     sync_batch_norm_stats)

__all__ = ["SyncBatchNorm", "sync_batch_norm_stats"]
