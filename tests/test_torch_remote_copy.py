"""Port parity: the remote-copy kernels' functions (apex_tpu_torch vs
apex_tpu).

JAX runs ``peer_shift`` / ``halo_exchange_rdma`` in interpret mode under
``shard_map`` on 4 (and 2) of the forced CPU devices; the port runs them
in 4 (and 2) gloo rank processes, spawned once per world for the module
(``spawn_ranks``), on CPU tensors, so each rank takes the plain versions.
The same numpy arrays go to both, each rank / device holding its
contiguous shard. All comparisons are exact: the functions move bytes.
Covered: shifts +1, -1, 2 and n; halos 1 and 3, periodic on and off, the
sliced plan and the whole-shard plan in fp32 and bf16 (``_tile_rows`` 8
and 16) and uint8; landing buffers returned and threaded into a second
call; ``halo_buf_rows`` for each plan; a halo larger than the shard
raises (JAX would slice out of range); one rank is the identity.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_rank_helpers as rh
from apex_tpu.ops.pallas import remote_copy as jrc
from apex_tpu.parallel import make_mesh
from apex_tpu.utils.compat import shard_map
from apex_tpu_torch.ops import remote_copy as rc
from apex_tpu_torch.parallel import RankGroup, spawn_ranks

JNP = {"fp32": jnp.float32, "bf16": jnp.bfloat16, "u8": jnp.uint8}
TORCH = rh.DTYPES


def _arrays(n):
    rng = np.random.default_rng(n)
    out = {"a": rng.standard_normal((n * 16, 8)).astype(np.float32)}
    # rows per rank for each halo plan: 16 (fp32 sliced), 6 (fp32 whole
    # shard: not tile-aligned), 32 (bf16 sliced), 16 (bf16 whole shard:
    # one tile), 64 (uint8 sliced)
    for rows in (6, 16, 32):
        out[f"r{rows}"] = rng.standard_normal((n * rows, 5, 3)).astype(
            np.float32)
    out["u64"] = rng.integers(0, 256, (n * 64, 7)).astype(np.uint8)
    return out


HALOS = [("r16", "fp32"), ("r6", "fp32"), ("r32", "bf16"), ("r16", "bf16"),
         ("u64", "u8")]


def _cases(n):
    cases = [(f"shift{s}", "shift", {"x": "a", "shift": s})
             for s in (1, -1, 2, n)]
    cases.append(("shift_bf16", "shift", {"x": "a", "dtype": "bf16",
                                          "shift": 1}))
    for arr, dt in HALOS:
        for halo in (1, 3):
            for periodic in (False, True):
                cases.append((f"halo_{arr}_{dt}_{halo}_{periodic}", "halo",
                              {"x": arr, "dtype": dt, "halo": halo,
                               "periodic": periodic}))
    cases.append(("threaded", "halo_threaded",
                  {"x": "r16", "halo": 3, "periodic": False}))
    return cases


def _run_port(n):
    arrays = _arrays(n)
    return arrays, spawn_ranks(rh.remote_copy_cases, n,
                               (arrays, _cases(n)), device="cpu",
                               timeout_s=240)


@pytest.fixture(scope="module")
def port():
    """The port's results at worlds 4 and 2, one spawn each, started
    together."""
    with ThreadPoolExecutor(2) as pool:
        return dict(zip((4, 2), pool.map(_run_port, (4, 2))))


def _jax(n, fn, x, n_out):
    mesh = make_mesh([n], ["sp"], jax.devices()[:n])
    out_specs = P("sp") if n_out == 1 else (P("sp"),) * n_out
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=P("sp"),
                             out_specs=out_specs, check_vma=False))(x)


def _cat(ranks, key, i=None):
    parts = [r[key] if i is None else r[key][i] for r in ranks]
    return np.concatenate(parts, axis=0)


def _np(x):
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


@pytest.mark.parametrize("n", [4, 2])
@pytest.mark.parametrize("shift", [1, -1, 2, "n"])
def test_peer_shift_matches_jax(port, n, shift):
    s = n if shift == "n" else shift
    arrays, ranks = port[n]
    want = _jax(n, lambda x: jrc.peer_shift(x, "sp", s, interpret=True),
                jnp.asarray(arrays["a"]), 1)
    np.testing.assert_array_equal(_cat(ranks, f"shift{s}"), _np(want))


@pytest.mark.parametrize("n", [4, 2])
def test_peer_shift_bf16_matches_jax(port, n):
    arrays, ranks = port[n]
    x = jnp.asarray(arrays["a"]).astype(jnp.bfloat16)
    want = _jax(n, lambda x: jrc.peer_shift(x, "sp", 1, interpret=True), x,
                1)
    np.testing.assert_array_equal(_cat(ranks, "shift_bf16"), _np(want))


@pytest.mark.parametrize("n", [4, 2])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("halo", [1, 3])
@pytest.mark.parametrize("arr,dt", HALOS)
def test_halo_exchange_matches_jax(port, n, arr, dt, halo, periodic):
    arrays, ranks = port[n]
    x = jnp.asarray(arrays[arr]).astype(JNP[dt])
    lo, hi = _jax(n, lambda x: jrc.halo_exchange_rdma(
        x, "sp", halo, periodic=periodic, interpret=True), x, 2)
    key = f"halo_{arr}_{dt}_{halo}_{periodic}"
    np.testing.assert_array_equal(_cat(ranks, key, 0), _np(lo))
    np.testing.assert_array_equal(_cat(ranks, key, 1), _np(hi))


@pytest.mark.parametrize("n", [4, 2])
def test_landing_buffers_threaded_match_jax(port, n):
    """Fresh landing buffers returned, then threaded into a second call
    (with 2 x): halos and the landed buffers, both calls, as JAX's."""
    arrays, ranks = port[n]

    def body(x):
        lo1, hi1, landed = jrc.halo_exchange_rdma(x, "sp", 3,
                                                  return_bufs=True,
                                                  interpret=True)
        lo2, hi2, landed2 = jrc.halo_exchange_rdma(
            x * 2, "sp", 3, bufs=landed, return_bufs=True, interpret=True)
        return lo1, hi1, landed[0], landed[1], lo2, hi2, landed2[0], \
            landed2[1]

    want = [_np(w) for w in _jax(n, body, jnp.asarray(arrays["r16"]), 8)]
    got = [np.concatenate([r["threaded"][0] for r in ranks]),
           np.concatenate([r["threaded"][1] for r in ranks]),
           np.concatenate([r["threaded"][2][0] for r in ranks]),
           np.concatenate([r["threaded"][2][1] for r in ranks]),
           np.concatenate([r["threaded"][3] for r in ranks]),
           np.concatenate([r["threaded"][4] for r in ranks]),
           np.concatenate([r["threaded"][5][0] for r in ranks]),
           np.concatenate([r["threaded"][5][1] for r in ranks])]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dt", ["fp32", "bf16", "u8"])
@pytest.mark.parametrize("rows,halo", [(16, 1), (16, 3), (6, 1), (32, 3),
                                       (64, 17), (8, 8), (5, 5), (100, 9)])
def test_halo_buf_rows_matches_jax(rows, halo, dt):
    assert rc.halo_buf_rows(rows, halo, TORCH[dt]) == \
        jrc.halo_buf_rows(rows, halo, JNP[dt])
    assert rc._halo_plan(rows, halo, TORCH[dt]) == \
        jrc._halo_plan(rows, halo, JNP[dt])


def test_halo_larger_than_the_shard_raises():
    group = RankGroup(device="cpu")
    with pytest.raises(ValueError, match="halo"):
        rc.halo_exchange_rdma(torch.zeros(4, 3), group, 5)
    with pytest.raises(ValueError, match="halo"):
        rc.halo_exchange_rdma(torch.zeros(4, 3), group, -1)


def test_landing_buffers_of_the_wrong_shape_raise():
    group = RankGroup(device="cpu")
    x = torch.zeros(16, 3)
    bad = torch.zeros(7, 3)
    with pytest.raises(ValueError, match="halo_buf_rows"):
        rc.halo_exchange_rdma(x, group, 1, bufs=(bad, bad))


@pytest.mark.parametrize("periodic", [False, True])
def test_one_rank_is_the_identity(periodic):
    """World 1 (no process group): the shift is the identity, the halos
    the shard's own edges when periodic and zeros otherwise, as JAX's on
    one device."""
    group = RankGroup(device="cpu")
    assert group.axis_size() == 1 and group.axis_index() == 0
    x = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    got = rc.peer_shift(torch.from_numpy(x), group, 1)
    np.testing.assert_array_equal(got.numpy(), x)
    lo, hi = rc.halo_exchange_rdma(torch.from_numpy(x), group, 3,
                                   periodic=periodic)
    jlo, jhi = _jax(1, lambda x: jrc.halo_exchange_rdma(
        x, "sp", 3, periodic=periodic, interpret=True), jnp.asarray(x), 2)
    np.testing.assert_array_equal(lo.numpy(), _np(jlo))
    np.testing.assert_array_equal(hi.numpy(), _np(jhi))


def test_collective_transport_refuses_device_tensors():
    """``ppermute`` (transport='collective') is gloo, for CPU tensors; a
    tensor elsewhere raises and names the peer-put transport."""
    group = RankGroup(device="cpu")
    with pytest.raises(ValueError, match="rdma"):
        rc.ppermute(torch.empty(4, device="meta"), group)
    with pytest.raises(ValueError, match="device"):
        rc.peer_shift(torch.empty(4, device="meta"), group)


def test_spawn_ranks_returns_in_rank_order_and_raises_for_a_failed_rank():
    """A rank that raises fails the whole call, with its traceback; the
    ranks it left waiting are stopped, not left behind."""
    with pytest.raises(RuntimeError, match="fails on purpose"):
        spawn_ranks(rh.fail_on_rank, 2, (1,), device="cpu", timeout_s=120)


def test_spawn_ranks_kills_a_hung_rank():
    with pytest.raises(RuntimeError, match="did not finish within"):
        spawn_ranks(rh.hang_on_rank, 2, (0,), device="cpu", timeout_s=5)


def test_spawn_ranks_reports_a_hung_rank_whose_peer_teardown_raised():
    """Rank 1 returns its value and then its process group's teardown
    raises while rank 0 still runs: rank 1 did not fail (its value was
    delivered), so rank 0 is not stopped early as a failed rank's peer,
    and is reported hung at the deadline."""
    with pytest.raises(RuntimeError, match="did not finish within") as err:
        spawn_ranks(rh.hang_while_a_peer_teardown_raises, 2, (0,),
                    device="cpu", timeout_s=10)
    assert "rank 1" not in str(err.value)


# --------------------------------------------------------- the copy plan
# ``copy_plan`` is what the wrapper hands the kernels; ``copy_pieces``
# repeats the kernels' loops over it. Sizes around a stage (the bulk
# route's least body), a grid of 132 one-stage chunks and four times
# either, plus 17 bytes; misalignments of the source alone, of the
# destination alone and of both alike (the bulk route with a head).

_S = rc.STAGE_BYTES
_GRID = 132 * _S
PLAN_SIZES = [0, 1, 17, _S - 1, _S, _S + 1, 4 * _S + 17, _GRID - 1,
              _GRID + 1, 4 * _GRID + 17]
PLAN_MISALIGNMENTS = ([(m, 0) for m in range(16)]
                      + [(0, m) for m in range(1, 16)]
                      + [(m, m) for m in range(1, 16)])


@pytest.mark.parametrize("src_mis,dst_mis", PLAN_MISALIGNMENTS)
@pytest.mark.parametrize("nbytes", PLAN_SIZES)
def test_copy_plan_moves_every_byte_once(nbytes, src_mis, dst_mis):
    """Every byte lies in exactly one piece, no piece is longer than a
    stage, every body piece starts where both pointers are aligned to the
    route's word and is whole words, every block has a piece, and the
    ring fits in a block's shared memory."""
    src, dst = (1 << 20) + src_mis, (3 << 20) + dst_mis
    plan = rc.copy_plan(nbytes, src, dst, 132)
    pieces = rc.copy_pieces(plan)
    assert plan.head + plan.body + plan.tail == nbytes
    off = 0
    for start, n in sorted(pieces):
        assert start == off and 0 < n <= plan.stage and n <= max(
            plan.chunk, 15)
        off += n
    assert off == nbytes
    word = 16 if plan.bulk else plan.word
    assert plan.head < word and plan.tail < word
    for start, n in pieces:
        if plan.head <= start < plan.head + plan.body:
            assert (src + start) % word == 0 and (dst + start) % word == 0
            assert n % word == 0
    owners = {(start - plan.head) // plan.chunk % plan.blocks
              for start, _ in pieces
              if plan.head <= start < plan.head + plan.body}
    assert plan.blocks <= 132
    assert owners == (set(range(plan.blocks)) if plan.body else set())
    if plan.bulk:
        assert plan.stages * plan.stage <= 224 * 1024
    else:
        assert plan.stage <= rc.PASS_BYTES
    # every block has the same number of runs, give or take the last one
    runs = [len(range(b * plan.chunk, plan.body, plan.blocks * plan.chunk))
            for b in range(plan.blocks)]
    assert max(runs) - min(runs) <= 1


@pytest.mark.parametrize(
    "nbytes,src_mis,dst_mis,bulk,word,blocks,chunk", [
        # the ring's bf16 K shard: two runs a block
        (6_291_456, 0, 0, True, 16, 132, 23_840),
        (536_870_912, 0, 0, True, 16, 132, 32_544),
        (_S, 0, 0, True, 16, 8, 4096),
        (_S - 1, 0, 0, False, 16, 8, 4096),   # under a stage: registers
        (_S + 15, 3, 3, True, 16, 8, 4096),   # a 13-byte head, then bulk
        (_GRID, 2, 0, False, 2, 132, 16_384),  # no head aligns both to 16
        (_GRID, 4, 12, False, 8, 132, 16_384),
        (_GRID, 15, 0, False, 1, 132, 16_384),
        (0, 5, 0, False, 1, 1, 1),
    ])
def test_copy_plan_routes(nbytes, src_mis, dst_mis, bulk, word, blocks,
                          chunk):
    plan = rc.copy_plan(nbytes, 4096 + src_mis, 8192 + dst_mis, 132)
    assert (plan.bulk, plan.word, plan.blocks, plan.chunk) == (
        bulk, word, blocks, chunk)
