"""Parallelism of the PyTorch port (``apex_tpu.parallel``): rank groups
(the counterpart of a mesh axis) and spawning rank processes, the 1-D
halo exchangers, ring attention in the contiguous and zigzag layouts
(context parallelism through the peer-put kernels), and SyncBatchNorm
(its cross-rank merge is a later slice)."""

from apex_tpu_torch.parallel.halo import (HaloExchanger,
                                          HaloExchangerAllGather,
                                          HaloExchangerNoComm,
                                          HaloExchangerPeer,
                                          HaloExchangerSendRecv,
                                          halo_exchange_1d,
                                          left_right_halo_exchange)
from apex_tpu_torch.parallel.mesh import RankGroup, spawn_ranks
from apex_tpu_torch.parallel.ring_attention import (
    ring_attention, ring_self_attention, zigzag_ring_self_attention,
    zigzag_shard, zigzag_unshard)
from apex_tpu_torch.parallel.sync_batch_norm import (SyncBatchNorm,
                                                     sync_batch_norm_stats)

__all__ = ["HaloExchanger", "HaloExchangerAllGather", "HaloExchangerNoComm",
           "HaloExchangerPeer", "HaloExchangerSendRecv", "RankGroup",
           "SyncBatchNorm", "halo_exchange_1d", "left_right_halo_exchange",
           "ring_attention", "ring_self_attention", "spawn_ranks",
           "sync_batch_norm_stats", "zigzag_ring_self_attention",
           "zigzag_shard", "zigzag_unshard"]
