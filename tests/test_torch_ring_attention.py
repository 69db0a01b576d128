"""Port parity: ring attention (apex_tpu_torch.parallel.ring_attention vs
apex_tpu.parallel.ring_attention).

The same numpy q, k, v and output cotangent (1 x 2 heads x 64 per rank x
64, fp32) go through JAX's ``ring_self_attention`` (contiguous, causal and
not) and ``zigzag_ring_self_attention`` with ``transport="collective"``
under ``shard_map`` on 4 and 2 CPU devices (its flash kernels in
interpret mode), and through the port's in 4 and 2 gloo rank processes
(one spawn per world for the module; the flash kernels' plain versions on
CPU tensors) with both transports. Tolerances, relative L2 over the whole
sequence: 1e-5 for o, 1e-4 for dq / dk / dv (the port's plain flash sums
whole rows, JAX's interpret kernels block by block). The port's two
transports agree exactly; each makes JAX's hop count, n - 1 K / V hops
forward and n - 1 K / V plus n dK / dV hops backward.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_rank_helpers as rh
from apex_tpu.parallel import make_mesh
from apex_tpu.parallel.ring_attention import (
    ring_self_attention as jax_ring, zigzag_ring_self_attention as
    jax_zigzag_ring, zigzag_shard as jax_zigzag_shard)
from apex_tpu.utils.compat import shard_map
from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.parallel import (RankGroup, ring_self_attention,
                                     spawn_ranks, zigzag_ring_self_attention,
                                     zigzag_shard, zigzag_unshard)

WORLDS = [4, 2]
# (name, layout, causal)
CONFIGS = [("causal", "contig", True), ("full", "contig", False),
           ("zigzag", "zigzag", True)]
O_TOL, GRAD_TOL = 1e-5, 1e-4


def _arrays(n):
    rng = np.random.default_rng(10 + n)
    shape = (1, 2, 64 * n, 64)
    return {name: rng.standard_normal(shape).astype(np.float32)
            for name in ("q", "k", "v", "do")}


@pytest.fixture(scope="module")
def port():
    """The port's results at worlds 4 and 2, one spawn each, started
    together."""
    cases = [(f"{name}_{t}", layout, causal, t)
             for name, layout, causal in CONFIGS
             for t in ("collective", "rdma")]

    def run(n):
        return spawn_ranks(rh.ring_cases, n, (_arrays(n), cases),
                           device="cpu", timeout_s=240)

    with ThreadPoolExecutor(2) as pool:
        return dict(zip(WORLDS, pool.map(run, WORLDS)))


@functools.lru_cache(maxsize=None)
def _jax(n, layout, causal):
    """JAX's (o, dq, dk, dv) over the whole sequence (zigzag order for the
    zigzag layout)."""
    a = {k: jnp.asarray(v) for k, v in _arrays(n).items()}
    if layout == "zigzag":
        a = {k: jax_zigzag_shard(v, n) for k, v in a.items()}
        body = functools.partial(jax_zigzag_ring,
                                 axis_name="sp")
    else:
        body = functools.partial(jax_ring, axis_name="sp",
                                 causal=causal)
    mesh = make_mesh([n], ["sp"], jax.devices()[:n])
    spec = P(None, None, "sp")
    ring = shard_map(lambda q, k, v: body(q, k, v), mesh=mesh,
                     in_specs=(spec,) * 3, out_specs=spec, check_vma=False)

    @jax.jit
    def fwd_bwd(q, k, v, do):
        o, vjp = jax.vjp(ring, q, k, v)
        return (o,) + vjp(do)

    return [np.asarray(t) for t in fwd_bwd(a["q"], a["k"], a["v"], a["do"])]


def _got(ranks, key):
    return [np.concatenate([r[key][i] for r in ranks], axis=2)
            for i in range(4)]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("transport", ["collective", "rdma"])
@pytest.mark.parametrize("name,layout,causal", CONFIGS)
@pytest.mark.parametrize("n", WORLDS)
def test_ring_matches_jax(port, n, name, layout, causal, transport):
    got = _got(port[n], f"{name}_{transport}")
    want = _jax(n, layout, causal)
    assert _rel(got[0], want[0]) <= O_TOL
    for g, w in zip(got[1:], want[1:]):
        assert _rel(g, w) <= GRAD_TOL


@pytest.mark.parametrize("name,layout,causal", CONFIGS)
@pytest.mark.parametrize("n", WORLDS)
def test_transports_agree_and_count_jax_hops(port, n, name, layout, causal):
    """The peer-put transport and the collective one give the same bits;
    each rank makes 2(n - 1) peer shifts forward and 2(n - 1) + 2n
    backward with the peer-put transport (none with the collective)."""
    for r in port[n]:
        col, rdma = r[f"{name}_collective"], r[f"{name}_rdma"]
        for a, b in zip(col[:4], rdma[:4]):
            np.testing.assert_array_equal(a, b)
        assert rdma[4] == (2 * (n - 1), 2 * (n - 1) + 2 * n)
        assert col[4] == (0, 0)


@pytest.mark.parametrize("causal", [False, True])
def test_one_rank_ring_is_flash_attention(causal):
    """A group of one rank: the ring is the diagonal block alone."""
    group = RankGroup(device="cpu")
    a = _arrays(1)
    q, k, v = (torch.from_numpy(a[n]).requires_grad_(True)
               for n in ("q", "k", "v"))
    q2, k2, v2 = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    do = torch.from_numpy(a["do"])
    ring_self_attention(q, k, v, group, causal, transport="rdma").backward(do)
    flash_attention(q2, k2, v2, causal).backward(do)
    for t, u in ((q, q2), (k, k2), (v, v2)):
        assert torch.equal(t.grad, u.grad)
    o = zigzag_ring_self_attention(q.detach(), k.detach(), v.detach(), group)
    assert torch.equal(o, flash_attention(q2, k2, v2, True).detach())


def test_zigzag_shard_roundtrip_and_order_match_jax():
    x = np.arange(4 * 2 * 24 * 3, dtype=np.float32).reshape(4, 2, 24, 3)
    for n in (1, 2, 3, 4, 6):
        z = zigzag_shard(torch.from_numpy(x), n)
        np.testing.assert_array_equal(
            z.numpy(), np.asarray(jax_zigzag_shard(jnp.asarray(x), n)))
        np.testing.assert_array_equal(zigzag_unshard(z, n).numpy(), x)


def test_unknown_transport_and_bad_blocks_raise():
    group = RankGroup(device="cpu")
    q = torch.zeros(1, 1, 8, 64)
    with pytest.raises(ValueError, match="transport"):
        ring_self_attention(q, q, q, group, transport="nccl")
    with pytest.raises(ValueError, match="block"):
        ring_self_attention(q, q, q, group, block_q=12)
