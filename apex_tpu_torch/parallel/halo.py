"""1-D halo exchange between the ranks of a :class:`RankGroup`.

Counterpart of ``apex_tpu/parallel/halo.py``: ``left_right_halo_exchange``
(the reference's ``nccl_p2p_cuda.left_right_halo_exchange``),
``halo_exchange_1d`` (pad the split axis with the neighbours' rows, zeros
beyond the first and the last rank) and the exchanger classes of the
reference's ``apex/contrib/bottleneck/halo_exchangers.py``.

The collective flavours (the base class, ``HaloExchangerSendRecv``,
``HaloExchangerAllGather``) move CPU tensors over the group's gloo
process group. A CUDA tensor there raises: the group carries no NCCL
communicator, and ranks that share one card could not have one (NCCL
refuses two ranks on one device); such tensors take the peer-put kernels,
``transport="rdma"`` or ``HaloExchangerPeer``, which are the reference's
CUDA-IPC flavour and run on CPU tensors too (their plain versions).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from apex_tpu_torch.ops.remote_copy import _p2p, halo_exchange_rdma


def _host_only(name: str, *ts: torch.Tensor) -> None:
    if any(t.device.type != "cpu" for t in ts):
        raise ValueError(
            f"{name}: the collective halo exchange moves CPU tensors over "
            f"the group's gloo process group; a CUDA tensor takes "
            f"transport='rdma' (PeerHaloExchanger1d) or HaloExchangerPeer, "
            f"the peer-put kernels")


def left_right_halo_exchange(left_output_halo: torch.Tensor,
                             right_output_halo: torch.Tensor, group
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Send my left strip to the left rank and my right strip to the
    right rank; returns ``(left_input_halo, right_input_halo)``, what came
    from the left and the right rank (zeros at the ends of the line)."""
    _host_only("left_right_halo_exchange", left_output_halo,
               right_output_halo)
    n, me = group.axis_size(), group.axis_index()
    left_in = torch.zeros_like(right_output_halo)
    right_in = torch.zeros_like(left_output_halo)
    sends, recvs = [], []
    if me + 1 < n:
        sends.append((right_output_halo.contiguous(), me + 1, 0))
        recvs.append((right_in, me + 1, 1))
    if me > 0:
        sends.append((left_output_halo.contiguous(), me - 1, 1))
        recvs.append((left_in, me - 1, 0))
    if sends:
        _p2p(group, sends, recvs)
    return left_in, right_in


def _pad(x, halo, spatial_axis, exchange):
    size = x.shape[spatial_axis]
    top = x.narrow(spatial_axis, 0, halo)
    bottom = x.narrow(spatial_axis, size - halo, halo)
    left_in, right_in = exchange(top, bottom)
    return torch.cat([left_in, x, right_in], dim=spatial_axis)


def halo_exchange_1d(x: torch.Tensor, halo: int, group,
                     spatial_axis: int = 0) -> torch.Tensor:
    """``x`` with ``halo`` rows of each neighbour on either side of
    ``spatial_axis`` (zeros beyond the first and the last rank)."""
    return _pad(x, halo, spatial_axis,
                lambda t, b: left_right_halo_exchange(t, b, group))


class HaloExchanger:
    """The exchanger interface (halo_exchangers.py): point to point over
    the group's gloo process group."""

    def __init__(self, group):
        self.group = group

    def left_right_halo_exchange(self, left_output_halo, right_output_halo):
        return left_right_halo_exchange(left_output_halo, right_output_halo,
                                        self.group)

    def __call__(self, x, halo: int, spatial_axis: int = 0):
        return _pad(x, halo, spatial_axis, self.left_right_halo_exchange)


class HaloExchangerNoComm(HaloExchanger):
    """Zero halos, no communication (the reference's correctness
    ablation); any device."""

    def left_right_halo_exchange(self, left_output_halo, right_output_halo):
        return (torch.zeros_like(right_output_halo),
                torch.zeros_like(left_output_halo))


class HaloExchangerAllGather(HaloExchanger):
    """Every rank gathers every rank's strips and keeps its neighbours'."""

    def left_right_halo_exchange(self, left_output_halo, right_output_halo):
        _host_only("HaloExchangerAllGather", left_output_halo,
                   right_output_halo)
        n, me = self.group.axis_size(), self.group.axis_index()
        if n == 1:
            return (torch.zeros_like(right_output_halo),
                    torch.zeros_like(left_output_halo))
        lefts = [torch.empty_like(left_output_halo) for _ in range(n)]
        rights = [torch.empty_like(right_output_halo) for _ in range(n)]
        dist.all_gather(lefts, left_output_halo.contiguous(),
                        group=self.group.pg)
        dist.all_gather(rights, right_output_halo.contiguous(),
                        group=self.group.pg)
        left_in = rights[me - 1] if me > 0 \
            else torch.zeros_like(right_output_halo)
        right_in = lefts[me + 1] if me + 1 < n \
            else torch.zeros_like(left_output_halo)
        return left_in, right_in


class HaloExchangerSendRecv(HaloExchanger):
    """Point to point (the reference's send / recv flavour): the base."""


class HaloExchangerPeer(HaloExchanger):
    """The reference's CUDA-IPC flavour: the strips go through
    :func:`~apex_tpu_torch.ops.remote_copy.halo_exchange_rdma`, the
    peer-put kernels for CUDA tensors (their plain versions for CPU
    tensors). Symmetric strips only."""

    def left_right_halo_exchange(self, left_output_halo, right_output_halo):
        h = left_output_halo.shape[0]
        if right_output_halo.shape[0] != h:
            raise ValueError("HaloExchangerPeer exchanges symmetric strips;"
                             f" got {h} vs {right_output_halo.shape[0]} "
                             f"rows")
        both = torch.cat([left_output_halo, right_output_halo], 0)
        return halo_exchange_rdma(both, self.group, h)

    def __call__(self, x, halo: int, spatial_axis: int = 0):
        def exchange(top, bottom):
            lo, hi = self.left_right_halo_exchange(
                top.movedim(spatial_axis, 0), bottom.movedim(spatial_axis, 0))
            return lo.movedim(0, spatial_axis), hi.movedim(0, spatial_axis)
        return _pad(x, halo, spatial_axis, exchange)
