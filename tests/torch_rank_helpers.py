"""Rank workers for the port's multi-process tests (no JAX here).

``apex_tpu_torch.parallel.spawn_ranks`` starts fresh processes that import
the worker by name, so the workers live in this module, which imports
neither JAX nor a test module that does. Each takes the rank's
``RankGroup`` and numpy inputs, runs a list of cases on the rank's shard,
and returns numpy results keyed by case, which the tests hold against the
JAX package.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops import remote_copy as rc

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
          "u8": torch.uint8}


def local(x: np.ndarray, group, dtype="fp32", axis=0) -> torch.Tensor:
    """This rank's contiguous shard of the global ``x`` along ``axis``,
    as a tensor of ``dtype`` on the group's device."""
    t = torch.from_numpy(np.ascontiguousarray(x)).to(DTYPES[dtype])
    part = t.chunk(group.axis_size(), dim=axis)[group.axis_index()]
    return part.contiguous().to(group.device)


def host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy (landing buffers alias an arena a later call
    overwrites); bf16 as float32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def remote_copy_cases(group, arrays, cases):
    """Cases of ``ops.remote_copy`` and the exchangers; see
    ``tests/test_torch_remote_copy.py``."""
    from apex_tpu_torch.contrib.peer_memory import (PeerHaloExchanger1d,
                                                    PeerMemoryPool)
    from apex_tpu_torch.parallel import halo as ph
    out = {}
    for key, kind, p in cases:
        x = local(arrays[p["x"]], group, p.get("dtype", "fp32"),
                  p.get("axis", 0))
        if kind == "shift":
            out[key] = host(rc.peer_shift(x, group, p["shift"]))
        elif kind == "ppermute":
            out[key] = host(rc.ppermute(x, group, p["shift"]))
        elif kind == "halo":
            lo, hi = rc.halo_exchange_rdma(x, group, p["halo"],
                                           periodic=p["periodic"])
            out[key] = (host(lo), host(hi))
        elif kind == "halo_threaded":
            # fresh landing buffers, then the returned ones threaded twice
            lo1, hi1, bufs = rc.halo_exchange_rdma(
                x, group, p["halo"], periodic=p["periodic"],
                return_bufs=True)
            landed = tuple(host(b) for b in bufs)
            lo2, hi2, bufs = rc.halo_exchange_rdma(
                x * 2, group, p["halo"], periodic=p["periodic"], bufs=bufs,
                return_bufs=True)
            out[key] = (host(lo1), host(hi1), landed, host(lo2), host(hi2),
                        tuple(host(b) for b in bufs))
        elif kind == "halo_pool":
            pool = PeerMemoryPool(static_size=1 << 16, group=group)
            lo_b, hi_b, idx = pool.allocate_halo_buffers(x.shape, p["halo"],
                                                         x.dtype)
            got = []
            bufs = (lo_b, hi_b)
            for scale in (1, 3):
                lo, hi, bufs = rc.halo_exchange_rdma(
                    x * scale, group, p["halo"], bufs=bufs,
                    return_bufs=True)
                got.append((host(lo), host(hi)))
            aliased = bufs[0].data_ptr() == pool.view(idx[0]).data_ptr()
            out[key] = (got, aliased, len(pool.allocations))
        elif kind == "exchanger":
            pool = PeerMemoryPool(static_size=1 << 16, group=group) \
                if p.get("pool") else None
            ex = PeerHaloExchanger1d(half_halo=p["halo"], group=group,
                                     transport=p["transport"],
                                     peer_pool=pool)
            res = [host(ex(x, spatial_axis=p["axis"]))
                   for _ in range(p.get("calls", 1))]
            out[key] = res
        elif kind == "left_right":
            ex = PeerHaloExchanger1d(group=group, transport=p["transport"])
            out[key] = tuple(host(t) for t in
                             ex.left_right_halo_exchange(x, x * 10))
        elif kind == "zoo":
            cls = getattr(ph, p["cls"])
            out[key] = host(cls(group)(x, p["halo"],
                                       spatial_axis=p["axis"]))
        elif kind == "halo_1d":
            out[key] = host(ph.halo_exchange_1d(x, p["halo"], group,
                                                spatial_axis=p["axis"]))
        else:
            raise ValueError(kind)
    return out


def ring_cases(group, arrays, cases):
    """Ring attention forward and gradients of q, k, v on the rank's
    sequence shard (zigzag cases: of the zigzag-ordered sequence), with
    the count of ring hops forward and backward; see
    ``tests/test_torch_ring_attention.py``."""
    import sys
    from apex_tpu_torch.parallel.ring_attention import (
        ring_self_attention, zigzag_ring_self_attention, zigzag_shard)
    ra = sys.modules["apex_tpu_torch.parallel.ring_attention"]
    hops = [0]
    shift = ra.peer_shift

    def counted(*a, **k):
        hops[0] += 1
        return shift(*a, **k)

    ra.peer_shift = counted
    out = {}
    n = group.axis_size()
    for key, layout, causal, transport in cases:
        full = {name: arrays[name] for name in ("q", "k", "v", "do")}
        if layout == "zigzag":
            full = {name: zigzag_shard(torch.from_numpy(a), n).numpy()
                    for name, a in full.items()}
        q, k, v, do = (local(full[name], group, axis=2)
                       .requires_grad_(name != "do")
                       for name in ("q", "k", "v", "do"))
        hops[0] = 0
        if layout == "zigzag":
            o = zigzag_ring_self_attention(q, k, v, group,
                                           transport=transport)
        else:
            o = ring_self_attention(q, k, v, group, causal=causal,
                                    transport=transport)
        fwd_hops = hops[0]
        o.backward(do)
        out[key] = tuple(host(t) for t in (o, q.grad, k.grad, v.grad)) + \
            ((fwd_hops, hops[0] - fwd_hops),)
    return out


# ------------------------------------------------------------ on the card


def _seeded(rank, salt, numel, dtype):
    """The input rank ``rank`` makes for case ``salt``: anyone can make it
    again from the rank's number."""
    g = torch.Generator().manual_seed(1000 * rank + salt)
    if dtype == torch.uint8:
        t = torch.randint(0, 256, (numel,), generator=g, dtype=torch.uint8)
    else:
        t = torch.randn(numel, generator=g).to(dtype)
    return t


def card_peer_bits(group, sizes, dtypes, offsets=(), offset_sizes=()):
    """On the card: ``peer_shift`` (shift 1, -1, 2) and
    ``halo_exchange_rdma`` (halo 1 and 3, periodic or not, fresh and pool
    landing buffers threaded twice) over ``sizes`` x ``dtypes``, and
    ``peer_shift`` of uint8 sources that start ``offsets`` bytes into
    their storage, of ``offset_sizes`` bytes; every result held bit for
    bit against the neighbour's input made again here from its seed.
    Returns the count of checks and the launch counts."""
    from apex_tpu_torch.contrib.peer_memory import PeerMemoryPool
    n, me = group.axis_size(), group.axis_index()
    dev = group.device
    checks = 0
    _build.reset_launches()
    pool = PeerMemoryPool(static_size=1 << 22, group=group)
    pool_bufs = {}
    for d, name in enumerate(dtypes):
        dtype = DTYPES[name]
        for salt, numel in enumerate(sizes):
            x = _seeded(me, 100 * d + salt, numel, dtype).to(dev)
            for shift in (1, -1, 2):
                got = rc.peer_shift(x, group, shift).cpu()
                want = _seeded((me - shift) % n, 100 * d + salt, numel,
                               dtype)
                assert torch.equal(got.view(torch.uint8),
                                   want.view(torch.uint8)), (name, numel,
                                                             shift)
                checks += 1
        # a source 1 element into its storage: the narrower word paths
        x = _seeded(me, 100 * d + 99, 4097, dtype).to(dev)[1:]
        want = _seeded((me - 1) % n, 100 * d + 99, 4097, dtype)[1:]
        got = rc.peer_shift(x, group, 1).cpu()
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
        checks += 1
        rows = 48
        x2 = _seeded(me, 100 * d + 50, rows * 40, dtype).view(rows, 40)
        for halo in (1, 3):
            for periodic in (False, True):
                key = (name, halo)
                if key not in pool_bufs:
                    lo_b, hi_b, _ = pool.allocate_halo_buffers(
                        (rows, 40), halo, dtype)
                    pool_bufs[key] = (lo_b, hi_b)
                for bufs0 in (None, pool_bufs[key]):
                    bufs = bufs0
                    for _ in range(2):
                        lo, hi, bufs = rc.halo_exchange_rdma(
                            x2.to(dev), group, halo, periodic=periodic,
                            bufs=bufs, return_bufs=True)
                        left = _seeded((me - 1) % n, 100 * d + 50,
                                       rows * 40, dtype).view(rows, 40)
                        right = _seeded((me + 1) % n, 100 * d + 50,
                                        rows * 40, dtype).view(rows, 40)
                        want_lo, want_hi = left[rows - halo:], right[:halo]
                        if not periodic and me == 0:
                            want_lo = torch.zeros_like(want_lo)
                        if not periodic and me == n - 1:
                            want_hi = torch.zeros_like(want_hi)
                        assert torch.equal(lo.cpu().view(torch.uint8),
                                           want_lo.view(torch.uint8))
                        assert torch.equal(hi.cpu().view(torch.uint8),
                                           want_hi.view(torch.uint8))
                        checks += 2
    for off in offsets:
        for salt, nbytes in enumerate(offset_sizes):
            salt += 700 + 10 * off
            x = _seeded(me, salt, off + nbytes, torch.uint8).to(dev)[off:]
            want = _seeded((me - 1) % n, salt, off + nbytes,
                           torch.uint8)[off:]
            got = rc.peer_shift(x, group, 1).cpu()
            assert torch.equal(got, want), (off, nbytes)
            checks += 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return checks, dict(_build.launches)


def card_shift_stress(group, sizes, count):
    """On the card: ``count`` back-to-back ``peer_shift``s of each size
    (fp32 elements), fresh seeded data each, both landing slots in turn,
    nothing synchronised until all are issued, once on the current stream
    and once alternating between two side streams; then every result held
    bit for bit against the neighbour's input made again here from its
    seed. Returns the count of checks."""
    n, me = group.axis_size(), group.axis_index()
    dev = group.device
    side = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    checks = 0
    for numel, streams in ((m, s) for m in sizes for s in (None, side)):
        xs = [_seeded(me, 2000 + i, numel, torch.float32).to(dev)
              for i in range(count)]
        torch.cuda.synchronize()
        outs = []
        for i, x in enumerate(xs):
            if streams is None:
                outs.append(rc.peer_shift(x, group, 1))
                continue
            with torch.cuda.stream(streams[i % 2]):
                outs.append(rc.peer_shift(x, group, 1))
        torch.cuda.synchronize()
        for i, got in enumerate(outs):
            want = _seeded((me - 1) % n, 2000 + i, numel, torch.float32)
            assert torch.equal(got.cpu().view(torch.uint8),
                               want.view(torch.uint8)), (numel, i)
            checks += 1
    return checks


def card_no_plain_route(group, sizes):
    """The plain versions patched to raise: CUDA tensors still pass."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor took a plain version")
    for name in ("peer_shift_plain", "halo_exchange_plain", "_p2p",
                 "ppermute"):
        setattr(rc, name, refuse)
    return card_peer_bits(group, sizes, ["fp32"])


def card_missing_signal(group, timeout_s):
    """Rank 0 shifts a tensor that rank 1 never sends back: its wait must
    trap on the device within ``timeout_s`` and the next synchronise
    raise. Returns ``(raised, seconds, message)`` on rank 0."""
    group.wait_timeout_s = timeout_s
    result = None
    x = torch.ones(1024, device=group.device)
    # both ranks map the landing slots (collective); then only rank 0 puts
    rc._remote(group).slots("shift", x.numel() * x.element_size())
    if group.axis_index() == 0:
        t0 = time.monotonic()
        try:
            rc.peer_shift(x, group, 1)
            torch.cuda.synchronize()
            result = (False, time.monotonic() - t0, "")
        except RuntimeError as e:
            result = (True, time.monotonic() - t0, str(e))
    # after a device trap this process's context is gone: nothing to free
    # (the process exits), so neither rank closes the group
    group.barrier()
    group.arenas = []
    return result


def fail_on_rank(group, bad_rank):
    """Rank ``bad_rank`` raises; the others wait for it at a barrier."""
    if group.axis_index() == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    group.barrier()
    return group.axis_index()


def hang_on_rank(group, bad_rank):
    """Rank ``bad_rank`` never returns."""
    if group.axis_index() == bad_rank:
        time.sleep(3600)
    return group.axis_index()


def hang_while_a_peer_teardown_raises(group, bad_rank):
    """Rank ``bad_rank`` never returns; the others return, and then the
    teardown of their process group raises (as ``destroy_process_group``
    may on a loaded host while a peer still runs)."""
    if group.axis_index() == bad_rank:
        time.sleep(3600)

    def teardown_fails(*args, **kwargs):
        raise RuntimeError("teardown fails on purpose")

    dist.destroy_process_group = teardown_fails
    return group.axis_index()
