"""Peer puts between the ranks of a :class:`RankGroup`: the CUDA kernels
and their plain versions.

Counterpart of ``apex_tpu/ops/pallas/remote_copy.py``: :func:`peer_shift`
(``_shift_kernel``, a one-sided put of the whole shard to rank
``(my + shift) mod n``) and :func:`halo_exchange_rdma` (``_halo_kernel``:
my low edge lands in the left rank's ``hi`` buffer, my high edge in the
right rank's ``lo``), with :func:`halo_buf_rows`, the landing-buffer
contract, row for row as in JAX.

CUDA tensors go through ``csrc/remote_copy.cu``. Each rank is a process;
each exports device memory (an :class:`IpcArena`, one ``cudaMalloc``)
through CUDA IPC and maps its peers' arenas, so a rank's kernel stores
straight into a peer's landing buffer, whether the peer's process runs on
the same card or on another. The arena is not the caching allocator's,
so ``expandable_segments`` does not touch it. A put waits for the
receiver's acknowledgement of the slot's previous message, copies, and
has an epoch flag released in the receiver's arena by the ``peer_wait``
launched right after it (its bytes are complete when that kernel
starts); the receiver's ``peer_wait`` spins (bounded, then a device trap)
until the flag arrives.
Both copy by a :func:`copy_plan` this module passes to the kernel: bulk
copies through a ring of shared-memory stages where both pointers are
16-byte aligned (after a head of bytes) and the body fills a stage,
register words otherwise.

- :func:`peer_shift` launches ``peer_put`` and ``peer_wait``: the shard
  lands in one of two slots the receiver keeps for that sender, and
  ``peer_wait`` copies it out into a fresh tensor (acknowledged when the
  receiver's next ``peer_wait`` starts), so what autograd or the caller
  holds is never a landing buffer.
- :func:`halo_exchange_rdma` launches one ``halo_put`` (both edges) and a
  ``peer_wait`` for each landing buffer. The landing buffers are the
  caller's ``bufs`` (views of a
  :class:`~apex_tpu_torch.contrib.peer_memory.PeerMemoryPool` of the
  group, or the buffers an earlier call returned) or the group's own.
  They stay put until this rank's next exchange: a rank acknowledges what
  landed in one exchange when it starts the next, as JAX's donation of
  the threaded buffers says.

CPU tensors take :func:`peer_shift_plain` / :func:`halo_exchange_plain`,
which compute the same function with ``batch_isend_irecv`` over the
group's gloo process group. A CUDA tensor never takes them.

Every rank of the group must make the same calls with tensors of the
same shape and dtype, as every device of a ``shard_map`` does: the
sender's and the receiver's epoch counts, and the landing slots, follow
from that. A message larger than a slot grows the slots, collectively;
the arena it outgrew stays mapped until the group closes, so buffers an
earlier call returned stay valid.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from apex_tpu_torch.ops import _build

# landing slots a receiver keeps for each sender of peer_shift
SHIFT_SLOTS = 2
_ALIGN = 256
# the kernels' copy (csrc/remote_copy.cu): bulk stages of at most
# STAGE_BYTES in a ring of STAGES (192 KB of shared memory a block); on
# the register route a block of 256 threads moves PASS_BYTES a pass, 64
# bytes a thread; runs of at least MIN_RUN bytes spread a message over
# the SMs
STAGE_BYTES = 32 << 10
STAGES = 6
PASS_BYTES = 256 * 64
MIN_RUN = 4 << 10


# ------------------------------------------------------------ copy plan


@dataclasses.dataclass(frozen=True)
class CopyPlan:
    """How the kernels move ``head + body + tail`` bytes: ``head`` bytes
    until both pointers are aligned to ``word``, a ``body`` of whole
    words, a ``tail`` of fewer than ``word`` bytes (both by the threads of
    the first block). The body is cut into runs of ``chunk`` bytes (at
    most ``stage``) dealt to the ``blocks`` in turn: run ``k`` of block
    ``b`` starts at ``(b + k * blocks) * chunk``. A run is one bulk copy
    through a ring of ``stages`` shared-memory stages of ``stage`` bytes
    where ``bulk`` (``word`` is then 16), else one pass of register
    words."""

    head: int
    body: int
    tail: int
    chunk: int
    stage: int
    stages: int
    blocks: int
    word: int
    bulk: bool

    def as_c(self):
        """The plan as the kernels' C entries read it (nine long longs)."""
        return (ctypes.c_longlong * 9)(
            self.head, self.body, self.tail, self.chunk, self.stage,
            self.stages, self.blocks, self.word, int(self.bulk))


def copy_plan(nbytes: int, src: int, dst: int, sms: int) -> CopyPlan:
    """The plan of a copy of ``nbytes`` from address ``src`` to ``dst``
    over at most ``sms`` blocks (one an SM).

    The word is the widest of 16, 8, 4, 2 and 1 bytes that one head can
    align both pointers to: the lowest set bit of ``(src - dst) mod 16``,
    or 16 where they agree. The bulk route needs 16 and a body of at
    least one stage (32 KB); a smaller body takes a pass or two of
    registers, which end sooner than a bulk launch's set-up (the
    barriers, a ring of shared memory) pays off. The blocks: one for each
    MIN_RUN bytes of the body, at most ``sms``; every block gets the same
    number of runs, each of at most a stage, so no block carries a
    ragged extra run."""
    mis = (src - dst) % 16
    word = 16 if mis == 0 else mis & -mis
    head = min(-src % word, nbytes)
    body = (nbytes - head) // word * word
    tail = nbytes - head - body
    bulk = word == 16 and body >= STAGE_BYTES
    stage = STAGE_BYTES if bulk else PASS_BYTES
    blocks = max(1, min(sms, -(-body // MIN_RUN)))
    per_block = max(1, -(-body // (blocks * stage)))
    chunk = -(-body // (blocks * per_block * word)) * word or word
    blocks = max(1, min(blocks, -(-body // chunk)))
    return CopyPlan(head, body, tail, chunk, stage, STAGES if bulk else 1,
                    blocks, word, bulk)


def copy_pieces(plan: CopyPlan) -> List[Tuple[int, int]]:
    """``(offset, bytes)`` of every piece the kernel moves, in the order
    of its loops (the cursor ``Runs`` in the kernel): the head, each
    block's runs, the tail."""
    pieces = [(0, plan.head)] if plan.head else []
    for b in range(plan.blocks):
        for off in range(b * plan.chunk, plan.body,
                         plan.blocks * plan.chunk):
            pieces.append((plan.head + off, min(plan.chunk,
                                                plan.body - off)))
    if plan.tail:
        pieces.append((plan.head + plan.body, plan.tail))
    return pieces


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(
        device_index).multi_processor_count


# ------------------------------------------------------ landing contract


def _tile_rows(dtype: torch.dtype) -> int:
    """The JAX kernel's sublane tile for ``dtype``: 32 rows for 1-byte,
    16 for 2-byte, 8 for wider types (``remote_copy._tile_rows``)."""
    size = torch.empty((), dtype=dtype).element_size()
    return {1: 32, 2: 16}.get(size, 8)


def _halo_plan(rows: int, halo: int, dtype: torch.dtype):
    """``(send_rows, full, buf_rows)``: the halo rounded up to whole tiles,
    whether the whole shard goes instead (a shard too small or not
    tile-aligned), and the landing buffer's rows (JAX ``_halo_plan``)."""
    t = _tile_rows(dtype)
    send_rows = -(-halo // t) * t
    full = send_rows >= rows or rows % t != 0
    return send_rows, full, (rows if full else send_rows)


def halo_buf_rows(rows: int, halo: int, dtype: torch.dtype) -> int:
    """Rows of the landing buffer :func:`halo_exchange_rdma` uses for a
    ``(rows, ...)`` input, as in JAX: whole tiles, or the full shard."""
    return _halo_plan(rows, halo, dtype)[2]


def _check_halo(rows: int, halo: int) -> None:
    if halo < 0 or halo > rows:
        raise ValueError(
            f"halo_exchange_rdma: halo {halo} must be in [0, rows={rows}]: "
            f"a halo larger than the shard would need rows of a rank "
            f"beyond the neighbour")


# --------------------------------------------------------- plain versions


def _p2p(group, sends, recvs) -> None:
    """Post every ``(tensor, peer, tag)`` send and receive at once over the
    group's gloo process group and wait for all of them."""
    ops = [dist.P2POp(dist.isend, t, group.global_rank(p), group.pg, tag)
           for t, p, tag in sends]
    ops += [dist.P2POp(dist.irecv, t, group.global_rank(p), group.pg, tag)
            for t, p, tag in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def peer_shift_plain(x: torch.Tensor, group, shift: int = 1
                     ) -> torch.Tensor:
    """:func:`peer_shift` for CPU tensors: send ``x`` to rank ``(my +
    shift) mod n``, receive from ``(my - shift) mod n`` (gloo)."""
    n, me = group.axis_size(), group.axis_index()
    dst, src = (me + shift) % n, (me - shift) % n
    x = x.contiguous()
    if dst == me:
        return x.clone()
    out = torch.empty_like(x)
    _p2p(group, [(x, dst, 0)], [(out, src, 0)])
    return out


def halo_exchange_plain(x: torch.Tensor, group, send_rows: int, full: bool,
                        lo_buf: torch.Tensor, hi_buf: torch.Tensor) -> None:
    """The landing of :func:`halo_exchange_rdma` for CPU tensors, into
    ``lo_buf`` / ``hi_buf``: the left rank's high edge (whole tiles, or its
    whole shard) into ``lo_buf``, the right rank's low edge into
    ``hi_buf`` (gloo; a periodic ring, as the kernel's)."""
    n, me = group.axis_size(), group.axis_index()
    left, right = (me - 1) % n, (me + 1) % n
    x = x.contiguous()
    rows = x.shape[0]
    src_lo = x if full else x[:send_rows]
    src_hi = x if full else x[rows - send_rows:]
    if n == 1:
        lo_buf.copy_(src_hi)
        hi_buf.copy_(src_lo)
        return
    # tag 0: a high edge travelling right; tag 1: a low edge travelling
    # left (at n == 2 both go to the same peer)
    _p2p(group, [(src_hi.contiguous(), right, 0), (src_lo.contiguous(), left,
                                                   1)],
         [(lo_buf, left, 0), (hi_buf, right, 1)])


# --------------------------------------------------------------- arenas


class _DeviceBytes:
    """A device range as ``__cuda_array_interface__``, for
    ``torch.as_tensor``: the tensor aliases the range and owns nothing."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "strides": None, "version": 2}


def device_bytes(ptr: int, nbytes: int, device: torch.device
                 ) -> torch.Tensor:
    """A uint8 tensor over ``nbytes`` of device memory at ``ptr``."""
    return torch.as_tensor(_DeviceBytes(ptr, nbytes), device=device)


def _call(fn, name, *args) -> None:
    _build.check(fn(*args), name)


class IpcArena:
    """One rank's exported device allocation and its peers' mapped ones
    (collective: every rank of ``group`` constructs it with the same
    ``nbytes``). ``local`` is a zeroed uint8 tensor over this rank's
    arena; :meth:`peer_ptr` gives the address of an offset in rank
    ``r``'s arena as this process sees it (this rank's own pointer for
    ``r`` itself: CUDA IPC does not open a handle in the process that
    made it). The group frees it on ``close()``."""

    def __init__(self, group, nbytes: int):
        if group.device.type != "cuda":
            raise ValueError("IpcArena: the group's device is not CUDA")
        lib = _build.lib()
        self.group = group
        self.nbytes = int(nbytes)
        dev = group.device.index
        ptr = ctypes.c_void_p()
        _call(lib.apex_ipc_alloc, "cudaMalloc (arena)", self.nbytes, dev,
              ctypes.byref(ptr))
        self.base = int(ptr.value)
        handle = ctypes.create_string_buffer(64)
        _call(lib.apex_ipc_handle, "cudaIpcGetMemHandle", self.base, handle)
        handles = group.all_gather_object(handle.raw)
        self.peers = []
        self._opened = []
        for r, h in enumerate(handles):
            if r == group.axis_index():
                self.peers.append(self.base)
                continue
            p = ctypes.c_void_p()
            _call(lib.apex_ipc_open, "cudaIpcOpenMemHandle",
                  ctypes.create_string_buffer(h, 64), dev, ctypes.byref(p))
            self.peers.append(int(p.value))
            self._opened.append(int(p.value))
        self.local = device_bytes(self.base, self.nbytes, group.device)
        group.arenas.append(self)

    def peer_ptr(self, rank: int, offset: int = 0) -> int:
        return self.peers[rank] + offset

    def local_ptr(self, offset: int = 0) -> int:
        return self.base + offset

    def offset_of(self, t: torch.Tensor) -> Optional[int]:
        """The byte offset of ``t`` in this rank's arena, or None when
        ``t`` does not lie inside it."""
        p = t.data_ptr()
        if self.base <= p and p + t.numel() * t.element_size() \
                <= self.base + self.nbytes:
            return p - self.base
        return None

    def unmap_peers(self) -> None:
        lib = _build.lib()
        for p in self._opened:
            _call(lib.apex_ipc_close, "cudaIpcCloseMemHandle", p)
        self._opened = []
        self.peers = []

    def free(self) -> None:
        if self.base is not None:
            _call(_build.lib().apex_ipc_free, "cudaFree (arena)", self.base)
        self.base = None
        self.local = None


def _find_arena(group, t: torch.Tensor):
    """``(arena, offset)`` of the group's arena that holds ``t``."""
    for arena in group.arenas:
        if arena.base is None:
            continue
        off = arena.offset_of(t)
        if off is not None:
            return arena, off
    raise ValueError(
        "halo_exchange_rdma: a landing buffer of a CUDA tensor must be a "
        "view of an arena of this group (a PeerMemoryPool built on the "
        "group, or a buffer an earlier call returned)")


class _Remote:
    """Per-group state of the exchanges: the flag arena (epochs), the
    landing slots and the epoch counts."""

    def __init__(self, group):
        n = group.axis_size()
        self.group = group
        self.n = n
        # uint64 epochs: shift ready [sender][slot] (a message landed),
        # shift ack [receiver][slot] (a receiver consumed the slot), halo
        # ready [lo, hi], halo ack [left, right]
        self.off_ack_shift = 8 * n * SHIFT_SLOTS
        self.off_halo_ready = 2 * self.off_ack_shift
        self.off_halo_ack = self.off_halo_ready + 16
        self.flags = IpcArena(group, -(-(self.off_halo_ack + 16) // _ALIGN)
                              * _ALIGN)
        self.sent = [0] * n
        self.received = [0] * n
        self.halo_epoch = 0
        self.last_stream = None
        # landing slots: kind -> (arena, slot bytes); "shift" holds
        # SHIFT_SLOTS a sender, "halo" a lo and a hi slot
        self.data = {}

    def ready_shift(self, sender: int, slot: int) -> int:
        return 8 * (sender * SHIFT_SLOTS + slot)

    def ack_shift(self, receiver: int, slot: int) -> int:
        return self.off_ack_shift + 8 * (receiver * SHIFT_SLOTS + slot)

    def stream(self) -> int:
        """The current stream (as a ``cudaStream_t``), made to wait for the
        one the group's previous exchange ran on: a flag a kernel releases
        announces the accesses of the exchanges before it (see
        ``csrc/remote_copy.cu``), whichever stream those ran on."""
        cur = torch.cuda.current_stream()
        if self.last_stream is not None and self.last_stream != cur:
            cur.wait_stream(self.last_stream)
        self.last_stream = cur
        return cur.cuda_stream

    def slots(self, kind: str, nbytes: int):
        """The ``(arena, slot bytes)`` of the landing slots of ``kind``,
        grown (collectively) when ``nbytes`` does not fit."""
        have = self.data.get(kind)
        if have is None or have[1] < nbytes:
            slot = -(-max(nbytes, 1) // _ALIGN) * _ALIGN
            count = self.n * SHIFT_SLOTS if kind == "shift" else 2
            have = self.data[kind] = (IpcArena(self.group, slot * count),
                                      slot)
        return have


def _remote(group) -> _Remote:
    if group.remote is None:
        group.remote = _Remote(group)
    return group.remote


def _check_cuda(name: str, x: torch.Tensor, group) -> bool:
    """True for CPU tensors (plain version); raises on what the kernels
    do not take."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.device != group.device:
        raise ValueError(f"{name}: tensor on {x.device}, group on "
                         f"{group.device}")
    return False


def _timeout_ns(group) -> int:
    return int(group.wait_timeout_s * 1e9)


def peer_shift(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Ring-shift ``x`` by ``shift`` ranks: every rank sends its ``x`` to
    rank ``(my + shift) mod n`` and returns the shard of rank ``(my -
    shift) mod n`` (JAX ``peer_shift``). Any shape and dtype; every rank
    calls it with the same ones. CUDA tensors launch ``peer_put`` and
    ``peer_wait``; with one rank (or ``shift`` a multiple of n) the put
    goes into the rank's own slot. CPU tensors take
    :func:`peer_shift_plain`."""
    if _check_cuda("peer_shift", x, group):
        return peer_shift_plain(x, group, shift)
    x = x.contiguous()
    out = torch.empty_like(x)
    nbytes = x.numel() * x.element_size()
    if nbytes == 0:
        return out
    st = _remote(group)
    n, me = st.n, group.axis_index()
    dst, src = (me + shift) % n, (me - shift) % n
    data, slot_bytes = st.slots("shift", nbytes)
    lib = _build.lib()
    tmo = _timeout_ns(group)
    sms = _sm_count(x.device.index)
    st.sent[dst] += 1
    e = st.sent[dst]
    s = e % SHIFT_SLOTS
    st.received[src] += 1
    er = st.received[src]
    rs = er % SHIFT_SLOTS
    landing = data.peer_ptr(dst, (me * SHIFT_SLOTS + s) * slot_bytes)
    put = copy_plan(nbytes, x.data_ptr(), landing, sms).as_c()
    landed = data.local_ptr((src * SHIFT_SLOTS + rs) * slot_bytes)
    wait = copy_plan(nbytes, landed, out.data_ptr(), sms).as_c()
    f = st.flags
    # the wait, launched right after the put, releases the put's ready
    # flag and the ack of the previous message from src (its copy-out
    # ran in the wait before): see csrc/remote_copy.cu
    prev = er - 1
    with torch.cuda.device(x.device):
        stream = st.stream()
        err = lib.apex_peer_put(
            x.data_ptr(), landing, ctypes.addressof(put),
            f.local_ptr(st.ack_shift(dst, s)), max(e - SHIFT_SLOTS, 0), tmo,
            stream)
        _build.launches["peer_put"] += 1
        _build.check(err, "peer_shift (peer_put)")
        err = lib.apex_peer_wait(
            f.peer_ptr(dst, st.ready_shift(me, s)), e,
            f.peer_ptr(src, st.ack_shift(me, prev % SHIFT_SLOTS))
            if prev > 0 else None, prev,
            f.local_ptr(st.ready_shift(src, rs)), er, landed,
            out.data_ptr(), ctypes.addressof(wait), tmo, stream)
        _build.launches["peer_wait"] += 1
        _build.check(err, "peer_shift (peer_wait)")
    return out


def _landing_bufs(name, x, bufs, buf_rows):
    """Validate caller-given landing buffers against the contract."""
    want = (buf_rows,) + tuple(x.shape[1:])
    lo, hi = bufs
    for b in (lo, hi):
        if tuple(b.shape) != want or b.dtype != x.dtype \
                or b.device != x.device or not b.is_contiguous():
            raise ValueError(
                f"{name}: landing buffers must be contiguous {want} "
                f"{x.dtype} on {x.device} (use halo_buf_rows); got "
                f"{tuple(b.shape)} {b.dtype} on {b.device}")
    return lo, hi


def halo_exchange_rdma(x: torch.Tensor, group, halo: int,
                       periodic: bool = False, bufs=None,
                       return_bufs: bool = False):
    """1-D halo exchange over the leading axis: returns ``(lo, hi)``, the
    ``halo`` rows that arrived from the left and the right rank (JAX
    ``halo_exchange_rdma``). ``periodic=False`` zeroes the wrap-around
    halos of the first and the last rank. ``halo`` larger than the shard's
    rows raises ``ValueError``.

    ``bufs=(lo_buf, hi_buf)``: landing buffers of
    ``(halo_buf_rows(rows, halo, dtype),) + x.shape[1:]``. For CUDA
    tensors they must be views of an arena of the group (a
    ``PeerMemoryPool`` built on it, or buffers an earlier call returned):
    the neighbours' puts land in them, and they hold what landed until
    this rank's next exchange. Without them the group's own landing slots
    serve. ``return_bufs=True`` also returns the landed buffers, to thread
    into the next call. ``lo`` and ``hi`` are copies. CUDA tensors launch
    ``halo_put`` and two ``peer_wait``; CPU tensors take
    :func:`halo_exchange_plain`."""
    name = "halo_exchange_rdma"
    rows = x.shape[0]
    _check_halo(rows, halo)
    send_rows, full, buf_rows = _halo_plan(rows, halo, x.dtype)
    cpu = _check_cuda(name, x, group)
    x = x.contiguous()
    if bufs is not None:
        lo_buf, hi_buf = _landing_bufs(name, x, bufs, buf_rows)
    if cpu:
        if bufs is None:
            shape = (buf_rows,) + tuple(x.shape[1:])
            lo_buf = x.new_empty(shape)
            hi_buf = x.new_empty(shape)
        halo_exchange_plain(x, group, send_rows, full, lo_buf, hi_buf)
    else:
        lo_buf, hi_buf = _halo_put(x, group, send_rows, full, buf_rows,
                                   None if bufs is None else (lo_buf,
                                                              hi_buf))
    lo = lo_buf[buf_rows - halo:buf_rows].clone()
    hi = hi_buf[:halo].clone()
    if not periodic:
        if group.axis_index() == 0:
            lo = torch.zeros_like(lo)
        if group.axis_index() == group.axis_size() - 1:
            hi = torch.zeros_like(hi)
    if return_bufs:
        return lo, hi, (lo_buf, hi_buf)
    return lo, hi


def _halo_put(x, group, send_rows, full, buf_rows, bufs):
    """Launch ``halo_put`` and the two ``peer_wait``; return the landed
    ``(lo_buf, hi_buf)`` of this rank."""
    st = _remote(group)
    n, me = st.n, group.axis_index()
    left, right = (me - 1) % n, (me + 1) % n
    row_bytes = x[0].numel() * x.element_size() if x.shape[0] else 0
    nbytes = buf_rows * row_bytes
    if bufs is None:
        data, slot_bytes = st.slots("halo", nbytes)
        shape = (buf_rows,) + tuple(x.shape[1:])
        lo_buf = data.local[:nbytes].view(x.dtype).view(shape)
        hi_buf = data.local[slot_bytes:slot_bytes + nbytes] \
            .view(x.dtype).view(shape)
        lo_arena, lo_off = data, 0
        hi_arena, hi_off = data, slot_bytes
    else:
        lo_buf, hi_buf = bufs
        lo_arena, lo_off = _find_arena(group, lo_buf)
        hi_arena, hi_off = _find_arena(group, hi_buf)
    src_lo = x.data_ptr()
    src_hi = x.data_ptr() + (0 if full else (x.shape[0] - send_rows)
                             * row_bytes)
    st.halo_epoch += 1
    e = st.halo_epoch
    f = st.flags
    ready_lo, ready_hi = st.off_halo_ready, st.off_halo_ready + 8
    # ack[0]: the left rank consumed what I sent it; ack[1]: the right
    ack_left, ack_right = st.off_halo_ack, st.off_halo_ack + 8
    lib = _build.lib()
    tmo = _timeout_ns(group)
    # each edge's copy takes half the SMs: the two run side by side
    sms = max(1, _sm_count(x.device.index) // 2)
    dst_lo = hi_arena.peer_ptr(left, hi_off)
    dst_hi = lo_arena.peer_ptr(right, lo_off)
    plan_lo = copy_plan(nbytes, src_lo, dst_lo, sms).as_c()
    plan_hi = copy_plan(nbytes, src_hi, dst_hi, sms).as_c()
    with torch.cuda.device(x.device):
        stream = st.stream()
        err = lib.apex_halo_put(
            src_lo, dst_lo, ctypes.addressof(plan_lo), src_hi, dst_hi,
            ctypes.addressof(plan_hi),
            # my lo landing came from the left rank (it sent right), my
            # hi landing from the right rank (it sent left)
            f.peer_ptr(left, ack_right), f.peer_ptr(right, ack_left),
            f.local_ptr(ack_left), f.local_ptr(ack_right), e - 1, tmo,
            stream)
        _build.launches["halo_put"] += 1
        _build.check(err, "halo_exchange_rdma (halo_put)")
        # the first wait releases the put's ready flags in the neighbours'
        # arenas (the put before it on the stream is done)
        released = [(f.peer_ptr(left, ready_hi), e, f.peer_ptr(right,
                                                               ready_lo), e),
                    (None, 0, None, 0)]
        for flag, rel in zip((ready_lo, ready_hi), released):
            err = lib.apex_peer_wait(*rel, f.local_ptr(flag), e, None, None,
                                     None, tmo, stream)
            _build.launches["peer_wait"] += 1
            _build.check(err, "halo_exchange_rdma (peer_wait)")
    return lo_buf, hi_buf


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """The collective form of :func:`peer_shift` (``jax.lax.ppermute``
    with the ring permutation): an all-gather over the group's gloo
    process group, then the shard of rank ``(my - shift) mod n``. For CPU
    tensors; a CUDA tensor raises, since the group carries no NCCL
    communicator (its ranks may share one card, which NCCL refuses):
    those take ``transport="rdma"``."""
    if x.device.type != "cpu":
        raise ValueError(
            "transport='collective' moves CPU tensors over the group's "
            "gloo process group; a CUDA tensor takes transport='rdma' "
            "(the peer-put kernels)")
    n, me = group.axis_size(), group.axis_index()
    x = x.contiguous()
    if n == 1:
        return x.clone()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group.pg)
    return parts[(me - shift) % n]
