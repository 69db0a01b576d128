"""Port parity: ``PeerMemoryPool`` and ``PeerHaloExchanger1d``
(apex_tpu_torch.contrib.peer_memory vs apex_tpu.contrib.peer_memory).

The pool's bookkeeping cases of ``tests/test_contrib.py`` run on the
port's host arena and its records are held equal to the JAX pool's for the
same calls. The exchanger runs in 4 gloo rank processes (spawned once for
the module) against JAX's under ``shard_map`` on 4 CPU devices, exact:
both transports, halos 1 and 2, with and without a pool, and the
pool-backed ``halo_exchange_rdma`` whose landed buffers alias the pool.
One deliberate difference: the port's views alias its arena (a write
through one is seen through another), where JAX's are copies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_rank_helpers as rh
from apex_tpu.contrib import peer_memory as jpm
from apex_tpu.ops.pallas import remote_copy as jrc
from apex_tpu.parallel import make_mesh
from apex_tpu.utils.compat import shard_map
from apex_tpu_torch.contrib.peer_memory import (PeerHaloExchanger1d,
                                                PeerMemoryPool)
from apex_tpu_torch.parallel import RankGroup, spawn_ranks

N = 4


def _pool(**kw):
    return PeerMemoryPool(device="cpu", **kw)


def test_allocation_accounting_and_views():
    pool = _pool(static_size=4096, dynamic_size=4096, peer_ranks=[0, 1, 2])
    ts = pool.allocate_peer_tensors((8, 16), torch.float32,
                                    channels_last=False, dynamic=False)
    assert len(ts) == 3
    assert ts[0].shape == (8, 16) and ts[0].dtype == torch.float32
    assert torch.equal(ts[0], torch.zeros(8, 16))
    t2 = pool.allocate_peer_tensors((4, 4), torch.bfloat16,
                                    channels_last=True, dynamic=False)
    r0, r1 = pool.allocations
    assert r1["offset"] % pool.alignment == 0
    assert r1["offset"] >= r0["offset"] + r0["nbytes"]
    assert r1["channels_last"] is True
    assert t2[0].dtype == torch.bfloat16
    pool.allocate_peer_tensors((16,), torch.int32, False, dynamic=True)
    assert pool.allocations[-1]["offset"] >= pool.static_size
    assert pool.dynamic_offset > 0
    pool.reset()
    assert pool.dynamic_offset == 0
    assert len(pool.allocations) == 3
    assert pool.allocations[2]["freed"]
    with pytest.raises(RuntimeError, match="freed by reset"):
        pool.view(2)
    pool.view(0)


def test_exhaustion_asserts():
    pool = _pool(static_size=1024, dynamic_size=512)
    with pytest.raises(AssertionError, match="Static"):
        pool.allocate_peer_tensors((1024,), torch.float32, False, False)
    with pytest.raises(AssertionError, match="Dynamic"):
        pool.allocate_peer_tensors((512,), torch.float32, False, True)


def test_view_rematerializes():
    pool = _pool(static_size=4096)
    t = pool.allocate_peer_tensors((8, 8), torch.float32, False, False)[0]
    again = pool.view(0)
    assert again.shape == t.shape and again.dtype == t.dtype
    assert torch.equal(again, t)


def test_freed_pool_refuses():
    pool = _pool(static_size=1024)
    pool.free()
    with pytest.raises(RuntimeError):
        pool.allocate_peer_tensors((4,), torch.float32, False, False)


def test_views_alias_the_arena():
    """The deliberate difference from JAX: a view is the arena's memory,
    so a write through one shows through the re-made view and every
    peer's entry (one process: all local)."""
    pool = _pool(static_size=4096, peer_ranks=[0, 1])
    a, b = pool.allocate_peer_tensors((4, 4), torch.float32, False, False)
    a.fill_(3.0)
    assert torch.equal(pool.view(0), torch.full((4, 4), 3.0))
    assert torch.equal(b, a)


ALLOCS = [((8, 16), "float32", False, False), ((4, 4), "bfloat16", True,
                                                 False),
          ((16,), "int32", False, True), ((3, 5, 7), "uint8", False, True),
          ((33,), "float32", False, False)]


def test_records_match_jax():
    """The same calls on both pools leave the same records: offsets,
    sizes, split, names; ``reset`` marks the same ones freed."""
    jp = jpm.PeerMemoryPool(static_size=8192, dynamic_size=4096)
    tp = _pool(static_size=8192, dynamic_size=4096)
    for shape, dt, cl, dyn in ALLOCS:
        jt = jp.allocate_peer_tensors(shape, getattr(jnp, dt), cl, dyn)[0]
        tt = tp.allocate_peer_tensors(shape, getattr(torch, dt), cl, dyn)[0]
        assert tuple(jt.shape) == tuple(tt.shape)
    assert tp.allocations == jp.allocations
    assert (tp.static_offset, tp.dynamic_offset, tp.static_size,
            tp.dynamic_size) == (jp.static_offset, jp.dynamic_offset,
                                 jp.static_size, jp.dynamic_size)
    jp.reset()
    tp.reset()
    assert tp.allocations == jp.allocations


@pytest.mark.parametrize("dt", ["float32", "bfloat16", "uint8"])
@pytest.mark.parametrize("shape,halo", [((16, 3), 1), ((6, 4, 2), 1),
                                        ((32, 5), 3), ((2, 7), 1)])
def test_allocate_halo_buffers_matches_jax(shape, halo, dt):
    jp = jpm.PeerMemoryPool(static_size=1 << 16)
    tp = _pool(static_size=1 << 16)
    jlo, jhi, jidx = jp.allocate_halo_buffers(shape, halo, getattr(jnp, dt))
    tlo, thi, tidx = tp.allocate_halo_buffers(shape, halo,
                                              getattr(torch, dt))
    assert tuple(tlo.shape) == tuple(jlo.shape) == tuple(thi.shape)
    assert tidx == jidx and tp.allocations == jp.allocations


def test_exchanger_needs_a_group_and_a_known_transport():
    with pytest.raises(ValueError, match="RankGroup"):
        PeerHaloExchanger1d()
    with pytest.raises(ValueError, match="transport"):
        PeerHaloExchanger1d(group=RankGroup(device="cpu"), transport="x")


# ------------------------------------------------------ across 4 ranks


def _arrays():
    rng = np.random.default_rng(3)
    return {"x": rng.standard_normal((1, N * 4, 3)).astype(np.float32),
            "e": np.arange(N * 2 * 3, dtype=np.float32).reshape(N * 2, 3),
            "p": np.arange(N * 8 * 128, dtype=np.float32).reshape(N * 8,
                                                                  128)}


EX_CASES = [(f"ex_{t}_{h}_{pool}", "exchanger",
             {"x": "x", "axis": 1, "halo": h, "transport": t, "pool": pool,
              "calls": 2})
            for t in ("collective", "rdma") for h in (1, 2)
            for pool in ((False, True) if t == "rdma" else (False,))]
EX_CASES += [(f"lr_{t}", "left_right", {"x": "e", "transport": t})
             for t in ("collective", "rdma")]
EX_CASES += [("pool", "halo_pool", {"x": "p", "halo": 2})]


@pytest.fixture(scope="module")
def port():
    arrays = _arrays()
    return arrays, spawn_ranks(rh.remote_copy_cases, N, (arrays, EX_CASES),
                               device="cpu", timeout_s=240)


def _jax(fn, args, in_specs, out_specs):
    mesh = make_mesh([N], ["sp"], jax.devices()[:N])
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False))(*args)


@pytest.mark.parametrize("key", [c[0] for c in EX_CASES
                                 if c[1] == "exchanger"])
def test_exchanger_matches_jax(port, key):
    """Each rank's padded tile (both calls: a pool's landing buffers are
    reused by the second) equals JAX's exchanger of the same transport
    (its rdma kernel in interpret mode)."""
    arrays, ranks = port
    p = next(c[2] for c in EX_CASES if c[0] == key)
    ex = jpm.PeerHaloExchanger1d(half_halo=p["halo"], axis_name="sp",
                                 transport=p["transport"])
    want = np.asarray(_jax(lambda x: ex(x, spatial_axis=1),
                           (jnp.asarray(arrays["x"]),), P(None, "sp"),
                           P(None, "sp")))
    for call in range(2):
        got = np.concatenate([r[key][call] for r in ranks], axis=1)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("transport", ["collective", "rdma"])
def test_left_right_exchange_matches_jax(port, transport):
    arrays, ranks = port
    ex = jpm.PeerHaloExchanger1d(axis_name="sp", transport=transport)
    e = jnp.asarray(arrays["e"])
    lo, hi = _jax(ex.left_right_halo_exchange, (e, e * 10.0),
                  (P("sp"), P("sp")), (P("sp"), P("sp")))
    for i, want in enumerate((lo, hi)):
        got = np.concatenate([r[f"lr_{transport}"][i] for r in ranks])
        np.testing.assert_array_equal(got, np.asarray(want))


def test_pool_landing_buffers_match_jax(port):
    """``halo_exchange_rdma`` into pool buffers, the landed ones threaded
    into a second call (with 3 x): the halos equal JAX's pool-less
    exchange of the same inputs; the landed buffers are the pool's own
    memory; the pool holds the two allocations."""
    arrays, ranks = port
    x = jnp.asarray(arrays["p"])
    for call, scale in enumerate((1, 3)):
        lo, hi = _jax(lambda x: jrc.halo_exchange_rdma(
            x * scale, "sp", 2, interpret=True), (x,), P("sp"),
            (P("sp"), P("sp")))
        got_lo = np.concatenate([r["pool"][0][call][0] for r in ranks])
        got_hi = np.concatenate([r["pool"][0][call][1] for r in ranks])
        np.testing.assert_array_equal(got_lo, np.asarray(lo))
        np.testing.assert_array_equal(got_hi, np.asarray(hi))
    assert all(r["pool"][1] for r in ranks)
    assert all(r["pool"][2] == 2 for r in ranks)
