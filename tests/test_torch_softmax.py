"""Port parity: the megatron softmax family (apex_tpu_torch vs apex_tpu).

Two comparisons, each with its own tolerance, because the JAX package has
two routes that do not compute the same arithmetic: its kernels multiply
by ``1 / s``, its plain route (the one its public functions take off a
TPU) divides per element.

- The port's plain twins (``softmax_fwd_plain`` / ``softmax_bwd_plain``,
  what the CUDA kernels compute) against the Pallas kernels
  ``softmax_fwd_pallas`` / ``softmax_bwd_pallas`` (and the causal chunked
  form) in interpret mode: fp32 atol 1e-6 (summation order), bf16 one
  ulp (2^-7 relative).
- The port's public functions, forward and backward, against JAX's public
  functions: on JAX's CPU plain route (rtol 1e-6, the divide against the
  reciprocal; gradients also atol 4e-6: y's one-ulp difference carried
  through ``(dy - sum(dy * y)) * scale`` at |dy| up to 5 and scale up to
  2), and with JAX's route forced open so that its kernel runs in
  interpret mode (y atol 1e-6, summation order; gradients atol 4e-6,
  that order carried through the backward as above). Masks JAX's route
  refuses, and rows longer than its 16,384-column limit, against JAX's
  plain route.

Inputs are numpy arrays from a seed; the JAX functions are jitted once
per static configuration.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.transformer.softmax as jsm
from apex_tpu.ops.pallas.softmax_kernel import (_softmax_fwd_causal_chunked,
                                                softmax_bwd_pallas,
                                                softmax_fwd_pallas)
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.softmax_kernel import (MASK_FILL, mask_plan,
                                               mask_route, softmax_bwd,
                                               softmax_bwd_plain, softmax_fwd,
                                               softmax_fwd_plain)
from apex_tpu_torch.ops.tiling import (SM_RESIDENT_MAX_COLS, SM_WARP_COLS,
                                       SM_WARP_SHORT_COLS, softmax_blocks,
                                       softmax_form, softmax_per_thread)
from apex_tpu_torch.transformer import softmax as tsm

BF16_ULP = 2 ** -7
GRAD_ATOL = 4e-6    # gradients: y's last-bit differences carried through
DT = {"fp32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _x(shape, seed, dt="fp32", spread=3.0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal(shape) * spread)
                         .astype(np.float32)).to(DT[dt][1])
    return x, jnp.asarray(x.float().numpy()).astype(DT[dt][0])


def _close(got, want, dt):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    if dt == "fp32":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=1e-7, rtol=BF16_ULP)


@functools.lru_cache(maxsize=None)
def _jax_fwd(scale, causal, h, block_rows=None):
    return jax.jit(lambda x, m: softmax_fwd_pallas(
        x, m, scale=scale, causal=causal, h=h, interpret=True,
        block_rows=block_rows))


@functools.lru_cache(maxsize=None)
def _jax_bwd(scale):
    return jax.jit(lambda y, dy: softmax_bwd_pallas(y, dy, scale=scale,
                                                    interpret=True))


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 8, 160), (3, 5, 77), (2, 3, 1)])
def test_plain_forward_twin_matches_the_kernel(shape, dt):
    """Unmasked scores, also at ragged sk (77, 1)."""
    x, xj = _x(shape, 0, dt)
    _close(softmax_fwd_plain(x, scale=0.7),
           _jax_fwd(0.7, False, 1)(xj, None), dt)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_causal_twin_matches_the_chunked_kernel(dt):
    """(2, 32, 300): padded sk 384 >= 256 and sq >= 16; with 8-row blocks
    and 128-column chunks JAX's chunked kernel runs (it returns None where
    it would not)."""
    x, xj = _x((2, 32, 300), 1, dt)
    want = jax.jit(lambda a: _softmax_fwd_causal_chunked(
        a, scale=0.5, interpret=True, block_rows=8, chunk_cols=128))(xj)
    assert want is not None
    got = softmax_fwd_plain(x, scale=0.5, causal=True)
    _close(got, want, dt)
    _close(got, _jax_fwd(0.5, True, 1, 8)(xj, None), dt)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(3, 8, 100), (2, 12, 7)])
def test_causal_twin_matches_the_row_kernel(shape, dt):
    """Causal shapes JAX's chunked form does not take (padded sk 128),
    sq > sk included."""
    x, xj = _x(shape, 2, dt)
    _close(softmax_fwd_plain(x, scale=1.3, causal=True),
           _jax_fwd(1.3, True, 1)(xj, None), dt)


MASK_CASES = [(bm, sqm) for bm in ("1", "B/h", "B") for sqm in ("1", "sq")]


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("bm,sqm", MASK_CASES)
def test_masked_twin_matches_the_kernel(bm, sqm, dt):
    """x (b * h, sq, sk) = (6, 16, 140) with h = 3 against a mask (Bm, sqm,
    sk), Bm in {1, B/h, B}, sqm in {1, sq}; the port sees x as (b, h, sq,
    sk) and the mask as its numpy broadcast (Bm, 1 or h, sqm, sk). One
    row is fully masked (its output is 0)."""
    b, h, sq, sk = 2, 3, 16, 140
    x, xj = _x((b * h, sq, sk), 3, dt)
    nb = {"1": 1, "B/h": b, "B": b * h}[bm]
    nq = {"1": 1, "sq": sq}[sqm]
    rng = np.random.default_rng(4)
    m = (rng.random((nb, nq, sk)) < 0.3).astype(np.uint8)
    m[0, 0, :] = 1     # a fully masked row (rows, when nq == 1)
    want = _jax_fwd(0.9, False, h)(xj, jnp.asarray(m))
    mt = torch.from_numpy(m)
    m4 = mt.reshape(nb, 1, nq, sk) if nb <= b else mt.reshape(b, h, nq, sk)
    got = softmax_fwd_plain(x.reshape(b, h, sq, sk), m4, scale=0.9)
    _close(got.reshape(b * h, sq, sk), want, dt)
    assert not got.reshape(b * h, sq, sk)[0, 0].any()


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 8, 160), (2, 5, 77)])
def test_backward_twin_matches_the_kernel(shape, dt):
    x, xj = _x(shape, 5, dt)
    y = softmax_fwd_plain(x, scale=0.8, causal=True)
    dy, dyj = _x(shape, 6, dt, spread=1.0)
    yj = jnp.asarray(y.float().numpy()).astype(DT[dt][0])
    _close(softmax_bwd_plain(y, dy, scale=0.8), _jax_bwd(0.8)(yj, dyj), dt)


def _port_public(fn, x, dy):
    xt = x.clone().requires_grad_(True)
    y = fn(xt)
    y.backward(dy)
    return y.detach(), xt.grad


def _jax_public(fn, x, dy):
    y, vjp = jax.vjp(fn, x)
    return np.asarray(y), np.asarray(vjp(dy)[0])


def _public_cases(b=2, h=3, sq=8, sk=160, seed=7):
    x, xj = _x((b, h, sq, sk), seed)
    dy, dyj = _x((b, h, sq, sk), seed + 1, spread=1.0)
    rng = np.random.default_rng(seed + 2)
    m = (rng.random((b, 1, sq, sk)) < 0.3).astype(np.uint8)
    mt, mj = torch.from_numpy(m), jnp.asarray(m)
    return {
        "scaled": (lambda t: tsm.scaled_softmax(t, 2.0),
                   lambda a: jsm.scaled_softmax(a, 2.0), x, xj, dy, dyj),
        "masked": (lambda t: tsm.scaled_masked_softmax(t, mt, 1.4),
                   lambda a: jsm.scaled_masked_softmax(a, mj, 1.4),
                   x, xj, dy, dyj),
        "generic": (lambda t: tsm.generic_scaled_masked_softmax(t, mt, 0.6),
                    lambda a: jsm.generic_scaled_masked_softmax(a, mj, 0.6),
                    x, xj, dy, dyj),
        "causal": (lambda t: tsm.scaled_upper_triang_masked_softmax(t, 0.9),
                   lambda a: jsm.scaled_upper_triang_masked_softmax(a, 0.9),
                   x[..., :sq], xj[..., :sq], dy[..., :sq], dyj[..., :sq]),
        "no_mask": (lambda t: tsm.scaled_masked_softmax(t, None, 1.1),
                    lambda a: jsm.scaled_masked_softmax(a, None, 1.1),
                    x, xj, dy, dyj),
    }


@pytest.mark.parametrize("name", ["scaled", "masked", "generic", "causal",
                                  "no_mask"])
def test_public_functions_match_jax_plain_route(name):
    """JAX's public functions as they run off a TPU (plain route, a
    per-element divide) against the port's (reciprocal multiply): y rtol
    1e-6, dx rtol 1e-6 + atol 4e-6."""
    fn_t, fn_j, x, xj, dy, dyj = _public_cases()[name]
    assert not jsm._pallas_route(xj, None, 1.0, False)[0]  # plain route
    y, dx = _port_public(fn_t, x, dy)
    yj, dxj = _jax_public(jax.jit(fn_j), xj, dyj)
    np.testing.assert_allclose(y.numpy(), yj, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(dx.numpy(), dxj, rtol=1e-6, atol=GRAD_ATOL)


@pytest.mark.parametrize("name", ["scaled", "masked", "causal"])
def test_public_functions_match_jax_kernel_route(name, monkeypatch):
    """JAX's route forced open (``interpret_default`` patched to False in
    ``apex_tpu.transformer.softmax`` only, so its ``_pallas_softmax``
    custom VJP runs the Pallas kernels in interpret mode): y within atol
    1e-6, dx within atol 4e-6."""
    fn_t, fn_j, x, xj, dy, dyj = _public_cases(seed=17)[name]
    monkeypatch.setattr(jsm, "interpret_default", lambda: False)
    mask = (None if name != "masked"
            else jnp.zeros((2, 1, 8, 160), jnp.uint8))
    assert jsm._pallas_route(xj, mask, 1.0, name == "causal")[0]
    y, dx = _port_public(fn_t, x, dy)
    yj, dxj = _jax_public(jax.jit(fn_j), xj, dyj)
    np.testing.assert_allclose(y.numpy(), yj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(dx.numpy(), dxj, rtol=0, atol=GRAD_ATOL)


@pytest.mark.parametrize("mshape", [(1, 3, 8, 160), (3, 8, 160), (8, 1),
                                    (160,)])
def test_masks_jax_route_refuses(mshape, monkeypatch):
    """A (1, h, sq, sk) mask, a rank-3 one and lower ranks broadcast to
    (b, h, sq, sk) scores: JAX's ``_pallas_route`` refuses them (its plain
    route runs); the port takes every broadcastable mask. Against JAX's
    public plain route, forward and backward."""
    x, xj = _x((2, 3, 8, 160), 21)
    dy, dyj = _x((2, 3, 8, 160), 22, spread=1.0)
    rng = np.random.default_rng(23)
    m = (rng.random(mshape) < 0.25).astype(np.int32)
    jm = jnp.asarray(m)
    with monkeypatch.context() as mp:   # the route as it stands on a TPU
        mp.setattr(jsm, "interpret_default", lambda: False)
        assert not jsm._pallas_route(xj, jm, 1.0, False)[0]
    y, dx = _port_public(
        lambda t: tsm.scaled_masked_softmax(t, torch.from_numpy(m), 0.7),
        x, dy)
    yj, dxj = _jax_public(
        jax.jit(lambda a: jsm.scaled_masked_softmax(a, jm, 0.7)), xj, dyj)
    np.testing.assert_allclose(y.numpy(), yj, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(dx.numpy(), dxj, rtol=1e-6, atol=GRAD_ATOL)


def test_row_of_16385_on_the_cpu():
    """One column past JAX's ``MAX_PALLAS_COLS``: JAX takes its plain
    route; the port's CPU tensors take the twin (the card's kernels, the
    streaming form)."""
    x, xj = _x((1, 2, 3, 16385), 31)
    dy, dyj = _x((1, 2, 3, 16385), 32, spread=1.0)
    m = np.zeros((1, 1, 1, 16385), np.uint8)
    m[..., 5000:7000] = 1
    assert softmax_form(16385) == "stream"
    y, dx = _port_public(
        lambda t: tsm.scaled_masked_softmax(t, torch.from_numpy(m), 0.3),
        x, dy)
    yj, dxj = _jax_public(
        jax.jit(lambda a: jsm.scaled_masked_softmax(a, jnp.asarray(m), 0.3)),
        xj, dyj)
    np.testing.assert_allclose(y.numpy(), yj, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(dx.numpy(), dxj, rtol=1e-6, atol=GRAD_ATOL)


def test_get_batch_per_block_is_one():
    assert tsm.get_batch_per_block(1024, 1024, 4, 25) == 1
    assert tsm.get_batch_per_block(16, 16, 1, 1) == jsm.get_batch_per_block(
        16, 16, 1, 1)


def test_cpu_wrappers_run_the_twins_and_launch_nothing():
    """On CPU tensors the wrappers are the twins; fully masked rows give
    zeros (the row's max is the fill) and fp16 keeps its dtype."""
    x, _ = _x((2, 4, 33), 41)
    m = torch.zeros(2, 1, 33, dtype=torch.bool)
    m[1] = True
    _build.reset_launches()
    y = softmax_fwd(x.half(), m, scale=0.5)
    assert y.dtype == torch.float16
    torch.testing.assert_close(y, softmax_fwd_plain(x.half(), m, scale=0.5),
                               atol=0, rtol=0)
    assert not y[1].any() and torch.isfinite(y).all()
    dx = softmax_bwd(y, torch.ones_like(y), scale=0.5)
    assert not dx[1].any()
    assert sum(_build.launches.values()) == 0


def test_causal_twin_fills_above_the_diagonal_as_replaced():
    """Scores far below -10000: the replaced positions above the diagonal
    take part in the max, so such a row gives zeros, as in the JAX
    kernel's arithmetic."""
    x = torch.full((1, 3, 3), -1e6)
    x[0, 2] = torch.tensor([1.0, 2.0, 3.0])
    y = softmax_fwd_plain(x, scale=1.0, causal=True)
    assert not y[0, :2].any()
    torch.testing.assert_close(y[0, 2].sum(), torch.tensor(1.0))
    assert MASK_FILL == jsm.MASK_FILL


PLAN_CASES = [
    ((3, 1, 5, 7), torch.bool, lambda t: t, (3, 4, 5, 7)),
    ((1, 4, 1, 7), torch.int64, lambda t: t, (3, 4, 5, 7)),
    ((5, 7), torch.uint8, lambda t: t, (3, 4, 5, 7)),
    ((7, 5, 4), torch.int16, lambda t: t.permute(2, 1, 0)[:, None],
     (4, 2, 5, 7)),
    ((2, 1, 3, 1, 5, 1), torch.int32, lambda t: t, (2, 4, 3, 6, 5, 7)),
    ((3, 4, 5, 14), torch.bool, lambda t: t[..., ::2], (3, 4, 5, 7)),
]


@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
def test_mask_plan_addresses_the_broadcast_mask(case):
    """The kernel's view of a mask (the plan's lead sizes and strides, sq
    and sk strides, in elements, 0 where it broadcasts) addresses exactly
    ``mask.expand(x.shape)``: read back through ``as_strided`` on the
    mask's storage. Non-contiguous masks, lower ranks, every integer
    width, several leading dimensions."""
    shape, dtype, view_of, xshape = PLAN_CASES[case]
    g = torch.Generator().manual_seed(case)
    m = view_of((torch.rand(shape, generator=g) < 0.5).to(dtype))
    plan = mask_plan(m, xshape)
    nbytes, nlead = plan[0], plan[1]
    assert nbytes == m.element_size() and 0 <= nlead <= 8
    sizes, strides = plan[2:2 + nlead], plan[10:10 + nlead]
    view = torch.as_strided(m, (*sizes, *xshape[-2:]),
                            (*strides, plan[18], plan[19]),
                            m.storage_offset())
    assert torch.equal(view.reshape(xshape), m.expand(xshape))


def test_mask_plan_merges_leading_dimensions():
    """(b, 1, sq, sk) against (b, h, sq, sk): two leading dimensions, the
    head's stride 0; a full contiguous mask merges into one."""
    plan = mask_plan(torch.ones(2, 1, 8, 16, dtype=torch.bool), (2, 3, 8, 16))
    assert plan[1] == 2 and plan[2:4] == [2, 3] and plan[10:12] == [128, 0]
    plan = mask_plan(torch.ones(2, 3, 8, 16, dtype=torch.bool), (2, 3, 8, 16))
    assert plan[1] == 1 and plan[2] == 6 and plan[10] == 128
    plan = mask_plan(torch.ones(1, 1, 1, 16, dtype=torch.bool), (2, 3, 8, 16))
    assert plan[1] == 1 and plan[10] == 0 and plan[18:20] == [0, 1]


@pytest.mark.parametrize("bad,msg", [
    (lambda x: softmax_fwd(x, torch.ones(3, 5, 7), scale=1.0), "bool or"),
    (lambda x: softmax_fwd(x, torch.ones(2, 5, 7, dtype=torch.bool),
                           scale=1.0), "broadcast"),
    (lambda x: softmax_fwd(x[0, 0, 0], scale=1.0), "rank"),
    (lambda x: softmax_fwd(x.long(), scale=1.0), "floating"),
    (lambda x: softmax_bwd(x, x[:1], scale=1.0), "match"),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad, msg):
    x = torch.zeros(3, 4, 5, 7)
    with pytest.raises(ValueError, match=msg):
        bad(x)


def test_forms_by_row_length():
    """The kernels' geometry: a warp per row up to 1024, a 512-thread block
    per row up to 16384, the streaming form beyond; rows over grid.x."""
    assert [softmax_form(n) for n in (1, 1024, 1025, 16384, 16385,
                                      100003)] == [
        "warp", "warp", "block", "block", "stream", "stream"]
    assert SM_WARP_COLS == 1024 and SM_RESIDENT_MAX_COLS == 16384
    assert softmax_blocks(131072, 1024) == 32768
    assert softmax_blocks(131072, 2048) == 131072


def test_forward_lanes_hold_a_short_row_without_padding():
    """The forward's "warp" form holds 16 values a lane up to 512 columns
    (a short row's registers hold no padding), 32 above; the backward 32
    at every length; the grid is unchanged (4 rows a block)."""
    assert SM_WARP_SHORT_COLS == 512
    assert [softmax_per_thread(n) for n in (1, 400, 512, 513, 1024, 1025,
                                            16385)] == [16, 16, 16, 32,
                                                        32, 32, 32]
    assert [softmax_per_thread(n, backward=True)
            for n in (1, 512, 1024)] == [32, 32, 32]
    # chunk c of lane t starts at column (t + 32 c) * V in both forms: the
    # short form's 16 // V chunks a lane are the long form's first ones
    # and cover a row of 512, so such a row lands on the same lanes
    for v in (4, 8):
        starts = {(t + 32 * c) * v for t in range(32) for c in range(16 // v)}
        assert starts == set(range(0, 32 * 16, v))
    assert softmax_blocks(102400, 512) == 25600
    assert softmax_form(512) == "warp"


def _strided(shape, dtype, last):
    """A mask whose rows start ``last`` entries apart (a view of a wider
    one), so its sq stride is ``last``."""
    wide = torch.zeros(*shape[:-1], last, dtype=dtype)
    return wide[..., :shape[-1]]


ROUTE_CASES = [
    # (mask, x shape, x itemsize, mask address, x / y aligned, route)
    ("(b,1,1,sk) bool, fp32", lambda: torch.ones(4, 1, 1, 512,
                                                 dtype=torch.bool),
     (4, 25, 1024, 512), 4, 0, True, "vector"),
    ("misaligned base", lambda: torch.ones(4, 1, 1, 512, dtype=torch.bool),
     (4, 25, 1024, 512), 4, 2, True, "element"),
    ("bf16 x: 8-byte access", lambda: torch.ones(4, 1, 1, 512,
                                                 dtype=torch.bool),
     (4, 25, 1024, 512), 2, 8, True, "vector"),
    ("bf16 x, base 4 bytes in", lambda: torch.ones(4, 1, 1, 512,
                                                   dtype=torch.bool),
     (4, 25, 1024, 512), 2, 4, True, "element"),
    ("int16 mask, bf16 x", lambda: torch.ones(4, 1, 8, 512,
                                              dtype=torch.int16),
     (4, 25, 8, 512), 2, 16, True, "vector"),
    ("int32 mask, fp32", lambda: torch.ones(4, 1, 8, 512,
                                            dtype=torch.int32),
     (4, 25, 8, 512), 4, 16, True, "vector"),
    ("int64 mask: two 16-byte loads", lambda: torch.ones(
        4, 1, 8, 512, dtype=torch.int64), (4, 25, 8, 512), 4, 16, True,
     "vector"),
    ("int64 mask, base 8 bytes in", lambda: torch.ones(
        4, 1, 8, 512, dtype=torch.int64), (4, 25, 8, 512), 4, 8, True,
     "element"),
    ("(b,1,sq,sk) uint8", lambda: torch.ones(4, 1, 64, 512,
                                             dtype=torch.uint8),
     (4, 25, 64, 512), 4, 0, True, "vector"),
    ("(1,h,sq,sk) bool", lambda: torch.ones(1, 25, 64, 512,
                                            dtype=torch.bool),
     (4, 25, 64, 512), 4, 0, True, "vector"),
    ("rows 514 apart", lambda: _strided((4, 1, 8, 512), torch.bool, 514),
     (4, 25, 8, 512), 4, 0, True, "element"),
    ("sk stride 2", lambda: torch.ones(4, 1, 8, 1024,
                                       dtype=torch.bool)[..., ::2],
     (4, 25, 8, 512), 4, 0, True, "element"),
    ("broadcast over sk", lambda: torch.ones(4, 1, 8, 1, dtype=torch.bool),
     (4, 25, 8, 512), 4, 0, True, "element"),
    ("ragged sk 511", lambda: torch.ones(4, 1, 1, 511, dtype=torch.bool),
     (4, 25, 8, 511), 4, 0, True, "element"),
    ("sk 1", lambda: torch.ones(4, 1, 1, 1, dtype=torch.bool),
     (4, 25, 8, 1), 4, 0, True, "element"),
    ("x misaligned", lambda: torch.ones(4, 1, 1, 512, dtype=torch.bool),
     (4, 25, 1024, 512), 4, 0, False, "element"),
]


@pytest.mark.parametrize("case", ROUTE_CASES, ids=[c[0] for c in
                                                   ROUTE_CASES])
def test_mask_route_by_stride_alignment_width_and_sk(case):
    """The forward's mask route (``mask_route``, the kernel's
    ``mask_vector_ok``): one access of a chunk's mask entries where x
    takes 16-byte accesses, the mask's sk stride is 1 and its base and row
    starts are aligned to that access; one entry at a time otherwise."""
    _, make, xshape, itemsize, ptr, aligned, want = case
    m = make()
    assert mask_route(mask_plan(m, xshape), ptr, itemsize, xshape[-1],
                      aligned) == want
