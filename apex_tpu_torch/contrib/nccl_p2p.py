"""Point-to-point facade of the reference's ``nccl_p2p_cuda``
(``get_unique_nccl_id``, ``init_nccl_comm``, ``left_right_halo_exchange``,
``add_delay``; apex/contrib/csrc/nccl_p2p/nccl_p2p.cpp:20-28).

Counterpart of ``apex_tpu/contrib/nccl_p2p.py``. The communicator is the
:class:`~apex_tpu_torch.parallel.mesh.RankGroup` (its gloo process group
is the rendezvous), ``p2p_shift`` is the one-sided peer put
:func:`~apex_tpu_torch.ops.remote_copy.peer_shift`, and ``add_delay``
injects latency for race tests.
"""

from __future__ import annotations

import time

import torch

from apex_tpu_torch.ops.remote_copy import \
    peer_shift as p2p_shift  # noqa: F401  (the send / recv pair)
from apex_tpu_torch.parallel.halo import left_right_halo_exchange  # noqa: F401


def get_unique_nccl_id(n: int = 1) -> torch.Tensor:
    """A placeholder id: the group's process group did the rendezvous."""
    return torch.zeros((n, 128), dtype=torch.uint8)


def init_nccl_comm(unique_id=None, my_rank: int = 0, num_ranks: int = 1,
                   group=None):
    """Returns ``group``, the port's communicator handle."""
    return group


def add_delay(delay_ms: float, x=None):
    """Latency injection (nccl_p2p.cpp:28). Without ``x``: the host
    sleeps. With a CUDA ``x``: ``torch.cuda._sleep`` spins on x's current
    stream for about ``delay_ms`` (cycles at the card's clock, 1.98 GHz
    where torch does not report it), so work
    ordered after it on the stream waits; a CPU ``x``: the host sleeps.
    Returns ``x``."""
    if x is None or x.device.type != "cuda":
        time.sleep(delay_ms / 1e3)
        return x
    with torch.cuda.device(x.device):
        khz = getattr(torch.cuda.get_device_properties(x.device),
                      "clock_rate", 1_980_000)
        torch.cuda._sleep(max(int(delay_ms * khz), 1))
    return x
