"""Port parity: the halo exchangers (apex_tpu_torch.parallel.halo vs
apex_tpu.parallel.halo).

The exchanger classes, ``halo_exchange_1d`` and
``left_right_halo_exchange`` run in 4 gloo rank processes (spawned once
for the module) against JAX's under ``shard_map`` on 4 CPU devices, on
the same numpy arrays, split along axis 0 and along axis 1; exact (they
move rows). ``HaloExchangerPeer`` goes through the peer-put path
(``halo_exchange_rdma``'s plain version on CPU tensors) and matches the
others. A 3-tap convolution over halo-padded tiles equals the
convolution of the whole sequence (the SpatialBottleneck property), to
1e-6. The collective flavours refuse a tensor off the CPU and name the
peer-put transport.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_rank_helpers as rh
from apex_tpu.parallel import halo as jh
from apex_tpu.parallel import make_mesh
from apex_tpu.utils.compat import shard_map
from apex_tpu_torch.parallel import RankGroup, halo as th, spawn_ranks

N = 4
CLASSES = ["HaloExchanger", "HaloExchangerNoComm", "HaloExchangerAllGather",
           "HaloExchangerSendRecv", "HaloExchangerPeer"]
# (array, split / spatial axis, halo)
LAYOUTS = [("z", 0, 1), ("w", 1, 2)]


def _arrays():
    rng = np.random.default_rng(7)
    return {"z": rng.standard_normal((N * 8, 3)).astype(np.float32),
            "w": rng.standard_normal((2, N * 4, 5)).astype(np.float32),
            "c": rng.standard_normal((N * 8, 4)).astype(np.float32),
            "e": np.arange(N * 4 * 3, dtype=np.float32).reshape(N * 4, 3)}


CASES = [(f"{cls}_{a}", "zoo", {"x": a, "cls": cls, "axis": ax, "halo": h})
         for cls in CLASSES for a, ax, h in LAYOUTS]
CASES += [(f"h1d_{a}", "halo_1d", {"x": a, "axis": ax, "halo": h})
          for a, ax, h in LAYOUTS]
CASES += [("conv", "halo_1d", {"x": "c", "axis": 0, "halo": 1}),
          ("lr", "left_right", {"x": "e", "transport": "collective"})]


@pytest.fixture(scope="module")
def port():
    arrays = _arrays()
    return arrays, spawn_ranks(rh.remote_copy_cases, N, (arrays, CASES),
                               device="cpu", timeout_s=240)


def _jax(fn, x, axis, n_out=1):
    mesh = make_mesh([N], ["sp"], jax.devices()[:N])
    spec = P("sp") if axis == 0 else P(None, "sp")
    out = spec if n_out == 1 else (spec,) * n_out
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=spec, out_specs=out,
                             check_vma=False))(x)


@pytest.mark.parametrize("a,axis,halo", LAYOUTS)
@pytest.mark.parametrize("cls", CLASSES)
def test_exchanger_zoo_matches_jax(port, cls, a, axis, halo):
    arrays, ranks = port
    ex = getattr(jh, cls)("sp")
    want = _jax(lambda x: ex(x, halo, spatial_axis=axis),
                jnp.asarray(arrays[a]), axis)
    got = np.concatenate([r[f"{cls}_{a}"] for r in ranks], axis=axis)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("a,axis,halo", LAYOUTS)
def test_halo_exchange_1d_matches_jax(port, a, axis, halo):
    arrays, ranks = port
    want = _jax(lambda x: jh.halo_exchange_1d(x, halo, "sp",
                                              spatial_axis=axis),
                jnp.asarray(arrays[a]), axis)
    got = np.concatenate([r[f"h1d_{a}"] for r in ranks], axis=axis)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_left_right_exchange_matches_jax(port):
    arrays, ranks = port
    e = jnp.asarray(arrays["e"])
    lo, hi = _jax(lambda x: jh.left_right_halo_exchange(x, x * 10.0, "sp"),
                  e, 0, 2)
    for i, want in enumerate((lo, hi)):
        got = np.concatenate([r["lr"][i] for r in ranks])
        np.testing.assert_array_equal(got, np.asarray(want))


def test_halo_padded_conv_matches_full(port):
    """Each rank's 'same' 3-tap convolution over its halo-padded tile,
    put together, is the convolution of the whole sequence."""
    arrays, ranks = port
    kern = np.random.default_rng(8).standard_normal((3, 4)).astype(
        np.float32)

    def conv_rows(xp):
        return sum(xp[i:i + xp.shape[0] - 2] * kern[i] for i in range(3))

    got = np.concatenate([conv_rows(r["conv"]) for r in ranks])
    want = conv_rows(np.pad(arrays["c"], ((1, 1), (0, 0))))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_collective_flavours_refuse_device_tensors():
    """Off the CPU the collective exchangers raise and name the peer-put
    transport: the group carries no NCCL communicator (and ranks on one
    card could not have one)."""
    group = RankGroup(device="cpu")
    t = torch.empty(2, 3, device="meta")
    for call in (lambda: th.left_right_halo_exchange(t, t, group),
                 lambda: th.HaloExchangerAllGather(group)
                 .left_right_halo_exchange(t, t),
                 lambda: th.halo_exchange_1d(t, 1, group)):
        with pytest.raises(ValueError, match="rdma"):
            call()


def test_one_rank_gets_zero_halos():
    """A group of one rank: the line has no neighbours, every flavour pads
    with zeros."""
    group = RankGroup(device="cpu")
    x = torch.arange(12.0).reshape(4, 3)
    for cls in CLASSES:
        out = getattr(th, cls)(group)(x, 1)
        assert torch.equal(out[1:-1], x)
        assert torch.equal(out[0], torch.zeros(3))
        assert torch.equal(out[-1], torch.zeros(3))


def test_nccl_p2p_facade():
    """``nccl_p2p``: the id is a placeholder of JAX's shape, the
    communicator is the group, ``p2p_shift`` is the peer put and the
    exchange is the halo module's; ``add_delay`` sleeps the host (CPU
    ``x`` or none) and hands ``x`` back."""
    import time

    from apex_tpu.contrib import nccl_p2p as jp2p
    from apex_tpu_torch.contrib import nccl_p2p
    from apex_tpu_torch.ops.remote_copy import peer_shift

    assert tuple(nccl_p2p.get_unique_nccl_id(2).shape) == \
        tuple(jp2p.get_unique_nccl_id(2).shape)
    group = RankGroup(device="cpu")
    assert nccl_p2p.init_nccl_comm(group=group) is group
    assert nccl_p2p.p2p_shift is peer_shift
    assert nccl_p2p.left_right_halo_exchange is th.left_right_halo_exchange
    x = torch.ones(3)
    t0 = time.perf_counter()
    assert nccl_p2p.add_delay(20, x) is x
    assert nccl_p2p.add_delay(20) is None
    assert time.perf_counter() - t0 >= 0.04
