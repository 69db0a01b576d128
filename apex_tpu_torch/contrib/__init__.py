"""Contributed ops of the PyTorch port (``apex_tpu.contrib``)."""

from apex_tpu_torch.contrib import nccl_p2p, peer_memory  # noqa: F401
from apex_tpu_torch.contrib.group_norm import (GroupNorm, group_norm_nhwc,
                                               torch_group_norm)
from apex_tpu_torch.contrib.peer_memory import (PeerHaloExchanger1d,
                                                PeerMemoryPool)

__all__ = ["GroupNorm", "PeerHaloExchanger1d", "PeerMemoryPool",
           "group_norm_nhwc", "nccl_p2p", "peer_memory", "torch_group_norm"]
