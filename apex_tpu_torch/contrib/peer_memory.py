"""Peer memory pool and the 1-D halo exchanger over it.

Counterpart of ``apex_tpu/contrib/peer_memory.py`` (``PeerMemoryPool``,
``PeerHaloExchanger1d``), after the reference's
``apex/contrib/peer_memory/peer_memory.py`` pool: one device allocation up
front, bump-allocated at 256-byte alignment into a static and a dynamic
part with the reference's exhaustion asserts.

On CUDA the arena is an IPC arena of the group
(:class:`~apex_tpu_torch.ops.remote_copy.IpcArena`): every rank allocates
the same sizes in the same order, so an allocation sits at one offset in
every rank's arena, and :meth:`PeerMemoryPool.allocate_peer_tensors`
returns one tensor per peer rank, mapped from that rank's arena (this
rank's own entry is local). Views alias the arena: a write through one is
seen by every view of the same range, and a neighbour's peer put lands in
them. (JAX's views are copies of its arena.) On the CPU the arena is a
host tensor and every peer's entry is this rank's view.

:class:`PeerHaloExchanger1d` pads the split axis of each rank's tile with
its neighbours' edge rows: ``transport="rdma"`` through
:func:`~apex_tpu_torch.ops.remote_copy.halo_exchange_rdma` (with a
``peer_pool``, into landing buffers of the pool, allocated at the first
call of a shape and reused after), ``transport="collective"`` through
:func:`~apex_tpu_torch.parallel.halo.halo_exchange_1d` (CPU tensors).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from apex_tpu_torch.ops.remote_copy import (IpcArena, device_bytes,
                                            halo_buf_rows,
                                            halo_exchange_rdma)
from apex_tpu_torch.parallel.halo import (halo_exchange_1d,
                                          left_right_halo_exchange)
from apex_tpu_torch.utils.device import DeviceLike, resolve_device


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


class PeerMemoryPool:
    """One arena of ``static_size + dynamic_size`` bytes (each rounded up
    to 256), sub-allocated in order. ``group`` (a
    :class:`~apex_tpu_torch.parallel.mesh.RankGroup`) makes it an IPC
    arena on the group's card, built collectively; without one the arena
    is this process's alone, on ``device`` (``cuda`` unless the caller
    asks for the CPU). ``peer_ranks`` (default: every rank of the group,
    or ``[0]``) are the ranks :meth:`allocate_peer_tensors` returns a
    tensor of."""

    def __init__(self, static_size: int = 0, dynamic_size: int = 0,
                 peer_ranks=None, group=None, device: DeviceLike = None):
        self.alignment = 256
        a = self.alignment
        self.static_size = (static_size + a - 1) // a * a
        self.dynamic_size = (dynamic_size + a - 1) // a * a
        self.group = group
        self.device = group.device if group is not None \
            else resolve_device(device)
        if peer_ranks is None:
            peer_ranks = range(group.axis_size()) if group is not None \
                else [0]
        self.peer_ranks = list(peer_ranks)
        nbytes = max(self.static_size + self.dynamic_size, 1)
        self._arena = None
        if self.device.type == "cuda" and group is not None:
            self._arena = IpcArena(group, nbytes)
            self._raw = self._arena.local
        else:
            self._raw = torch.zeros(nbytes, dtype=torch.uint8,
                                    device=self.device)
        self.static_offset = 0
        self.dynamic_offset = 0
        self.allocations: list = []

    def reset(self) -> None:
        """Free the dynamic part. The records stay, marked freed, so an
        index a caller holds keeps pointing at its record."""
        self.dynamic_offset = 0
        for r in self.allocations:
            if r["dynamic"]:
                r["freed"] = True

    def free(self) -> None:
        """Drop the arena. An IPC arena stays mapped until the group
        closes (collectively); the pool refuses further use either way."""
        self._raw = None

    def _view(self, start: int, shape, dtype, rank: Optional[int] = None):
        """``shape`` / ``dtype`` at byte ``start`` of rank ``rank``'s arena
        (None: this rank's)."""
        nbytes = math.prod(shape) * torch.empty((), dtype=dtype) \
            .element_size()
        if self._arena is None or rank is None \
                or rank == self._arena.group.axis_index():
            raw = self._raw[start:start + nbytes]
        else:
            raw = device_bytes(self._arena.peer_ptr(rank, start), nbytes,
                               self.device)
        return raw.view(dtype).view(tuple(shape))

    def allocate_peer_tensors(self, shape, dtype, channels_last: bool,
                              dynamic: bool) -> list:
        """Sub-allocate ``shape`` / ``dtype``; returns one tensor per peer
        rank, each aliasing that rank's arena at the allocation's offset.
        ``channels_last`` is recorded (the tensors are contiguous in the
        given shape)."""
        if self._raw is None:
            raise RuntimeError("pool was freed")
        itemsize = torch.empty((), dtype=dtype).element_size()
        nbytes = math.prod(shape) * itemsize
        a = self.alignment
        if dynamic:
            start = (self.dynamic_offset + a - 1) // a * a
            self.dynamic_offset = start + nbytes
            assert self.dynamic_offset < self.dynamic_size, \
                "Dynamic peer memory pool exhausted"
            base = self.static_size + start
        else:
            start = (self.static_offset + a - 1) // a * a
            self.static_offset = start + nbytes
            assert self.static_offset < self.static_size, \
                "Static peer memory pool exhausted"
            base = start
        self.allocations.append(
            {"shape": tuple(shape), "dtype": _dtype_name(dtype),
             "offset": base, "nbytes": nbytes, "dynamic": dynamic,
             "channels_last": bool(channels_last)})
        return [self._view(base, shape, dtype, rank=r)
                for r in self.peer_ranks]

    def view(self, alloc_index: int) -> torch.Tensor:
        """This rank's view of an earlier allocation."""
        if self._raw is None:
            raise RuntimeError("pool was freed")
        r = self.allocations[alloc_index]
        if r.get("freed"):
            raise RuntimeError(
                f"allocation {alloc_index} was freed by reset()")
        return self._view(r["offset"], r["shape"],
                          getattr(torch, r["dtype"]))

    def allocate_halo_buffers(self, x_shape, halo: int, dtype,
                              dynamic: bool = False):
        """Landing buffers for ``halo_exchange_rdma(..., bufs=...)``,
        shaped by ``halo_buf_rows``. Returns ``(lo, hi, (idx_lo,
        idx_hi))``, this rank's views and their allocation indices."""
        rows = halo_buf_rows(x_shape[0], halo, dtype)
        shape = (rows,) + tuple(x_shape[1:])
        self.allocate_peer_tensors(shape, dtype, False, dynamic)
        idx_lo = len(self.allocations) - 1
        self.allocate_peer_tensors(shape, dtype, False, dynamic)
        idx_hi = len(self.allocations) - 1
        return self.view(idx_lo), self.view(idx_hi), (idx_lo, idx_hi)


class PeerHaloExchanger1d:
    """Pads the split axis of each rank's tile with ``half_halo`` rows of
    each neighbour (zeros beyond the first and the last rank).
    ``transport="rdma"`` runs the peer-put kernels (on CPU tensors their
    plain versions); with a ``peer_pool`` the puts land in buffers of the
    pool, allocated at the first call of each shape and reused after, so
    a steady state allocates no landing memory. ``transport="collective"``
    takes the gloo collectives of :mod:`apex_tpu_torch.parallel.halo`
    (CPU tensors). ``ranks`` and ``rank_in_group`` are accepted as in the
    reference; the group decides."""

    def __init__(self, ranks=None, rank_in_group: Optional[int] = None,
                 peer_pool: Optional[PeerMemoryPool] = None,
                 half_halo: int = 1, group=None,
                 transport: str = "collective"):
        if transport not in ("collective", "rdma"):
            raise ValueError(f"unknown transport {transport!r}")
        if group is None:
            raise ValueError("PeerHaloExchanger1d needs the RankGroup of "
                             "its ranks")
        self.group = group
        self.half_halo = half_halo
        self.transport = transport
        self.peer_pool = peer_pool
        self._bufs: dict = {}

    def _exchange(self, both: torch.Tensor, h: int):
        bufs = None
        if self.peer_pool is not None:
            key = (tuple(both.shape), both.dtype)
            if key not in self._bufs:
                lo, hi, _ = self.peer_pool.allocate_halo_buffers(
                    both.shape, h, both.dtype)
                self._bufs[key] = (lo, hi)
            bufs = self._bufs[key]
        return halo_exchange_rdma(both, self.group, h, bufs=bufs)

    def left_right_halo_exchange(self, left_output_halo: torch.Tensor,
                                 right_output_halo: torch.Tensor):
        """``(left_input_halo, right_input_halo)``: the left rank's right
        strip and the right rank's left strip."""
        if self.transport == "rdma":
            h = left_output_halo.shape[0]
            if right_output_halo.shape[0] != h:
                raise ValueError(
                    "rdma transport exchanges symmetric halos; got "
                    f"{h} vs {right_output_halo.shape[0]} rows — use "
                    "transport='collective' for asymmetric strips")
            both = torch.cat([left_output_halo, right_output_halo], 0)
            return self._exchange(both, h)
        return left_right_halo_exchange(left_output_halo, right_output_halo,
                                        self.group)

    def __call__(self, x: torch.Tensor, spatial_axis: int = 1
                 ) -> torch.Tensor:
        if self.transport == "rdma":
            # only the edge strips move: (2 * halo, ...) with the split
            # axis first, as the kernel's leading axis
            h = self.half_halo
            size = x.shape[spatial_axis]
            top = x.narrow(spatial_axis, 0, h)
            bottom = x.narrow(spatial_axis, size - h, h)
            both = torch.cat([top, bottom], dim=spatial_axis) \
                .movedim(spatial_axis, 0)
            lo, hi = self._exchange(both.contiguous(), h)
            lo = lo.movedim(0, spatial_axis)
            hi = hi.movedim(0, spatial_axis)
            return torch.cat([lo, x, hi], dim=spatial_axis)
        return halo_exchange_1d(x, self.half_halo, self.group, spatial_axis)
