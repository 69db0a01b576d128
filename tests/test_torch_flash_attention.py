"""Port parity: flash attention forward and backward (apex_tpu_torch vs
apex_tpu).

The same numpy q, k, v (and do), made from a seed, go through the JAX
Pallas kernels ``flash_attention_fwd`` / ``flash_attention_bwd``
(interpret mode on the CPU, block_q=64 and block_k=128 so it stays fast)
and through the port's ``flash_attention_fwd`` / ``flash_attention_bwd``
on CPU tensors, which run the CUDA kernels' plain versions; and
``jax.grad`` of the public op against the port's autograd. Both o and the
fp32 log-sum-exp are compared, causal and not, with ragged sq / sk.
Tolerances for fp32: 2e-5 absolute on o and lse, 1e-4 on dq / dk / dv
(the JAX kernels sum block by block, the plain versions over whole rows).
bf16 as stated at each test. The mask / bias cases hold the same fp32
tolerances; a fully masked row is held to exact zeros and lse -1e30. The
JAX signature's ``block_q`` / ``block_k`` and a ``dropout_seed`` at rate 0
behave as in JAX; the kernels' batch * heads grid covers any count.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention, flash_attention_bwd as
    jax_flash_attention_bwd, flash_attention_fwd as jax_flash_attention_fwd)
from apex_tpu_torch.ops.flash_attention import (flash_attention,
                                                flash_attention_bwd,
                                                flash_attention_fwd)
from apex_tpu_torch.ops.tiling import FA_GRID_DIM_MAX, fa_batch_heads_grid

D = 64
SCALE = 1.0 / math.sqrt(D)


def _qkv(b, h, sq, sk, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, D)).astype(np.float32)
    k = rng.standard_normal((b, h, sk, D)).astype(np.float32)
    v = rng.standard_normal((b, h, sk, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,sq,sk", [(1, 2, 128, 128), (1, 2, 200, 200),
                                       (2, 1, 64, 200), (1, 1, 200, 72)])
def test_fwd_matches_pallas_kernel_fp32(b, h, sq, sk, causal):
    q, k, v = _qkv(b, h, sq, sk, seed=sq + sk)
    oj, lj = jax_flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=SCALE,
        causal=causal, block_q=64, block_k=128)
    ot, lt = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), scale=SCALE,
                                 causal=causal)
    assert ot.shape == (b, h, sq, D) and ot.dtype == torch.float32
    assert lt.shape == (b, h, sq) and lt.dtype == torch.float32
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-5,
                               rtol=0)


def test_fwd_matches_pallas_kernel_bf16():
    """bf16 IO: p is cast to bf16 before the p.v product in both, but
    against a running max (JAX, per k block) or the row max (port), so the
    rounding differs; o is held to 2e-2 (a few bf16 ulps of |o| < 1) and
    the fp32 lse to 1e-3."""
    q, k, v = _qkv(1, 2, 200, 200, seed=5)
    bf = jnp.bfloat16
    oj, lj = jax_flash_attention_fwd(
        jnp.asarray(q).astype(bf), jnp.asarray(k).astype(bf),
        jnp.asarray(v).astype(bf), scale=SCALE, causal=True, block_q=64,
        block_k=128)
    ot, lt = flash_attention_fwd(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        scale=SCALE, causal=True)
    assert ot.dtype == torch.bfloat16
    np.testing.assert_allclose(ot.float().numpy(),
                               np.asarray(oj.astype(jnp.float32)),
                               atol=2e-2, rtol=0)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-3,
                               rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_public_flash_attention_matches_jax(causal):
    """The public op with its default 1/sqrt(d) scale."""
    q, k, v = _qkv(2, 2, 96, 96, seed=9)
    oj = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal)
    ot = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("kw", [
    {"bias": torch.zeros(1, 1, 8, 8)},
    {"mask": torch.zeros(1, 1, 8, 8, dtype=torch.bool), "dropout_p": 0.1,
     "dropout_seed": 1},
    {"dropout_p": 0.1, "dropout_seed": 1},
])
def test_operands_not_ported_raise(kw):
    """A differentiated bias (dbias, the default bias_requires_grad=True)
    and dropout, with or without a mask, are still to be ported."""
    q = torch.zeros(1, 1, 8, D)
    with pytest.raises(NotImplementedError):
        flash_attention(q, q, q, True, **kw)


def _bwd_inputs(b, h, sq, sk, causal, dtype, seed):
    """q, k, v, do in ``dtype`` and the JAX forward's o / lse from them."""
    q, k, v = _qkv(b, h, sq, sk, seed=seed)
    do = np.random.default_rng(seed + 1).standard_normal((b, h, sq, D)) \
        .astype(np.float32)
    jx = [jnp.asarray(a).astype(dtype) for a in (q, k, v, do)]
    o, lse = jax_flash_attention_fwd(*jx[:3], scale=SCALE, causal=causal,
                                     block_q=64, block_k=128)
    return jx, o, lse


def _to_port(a, dtype):
    t = torch.from_numpy(np.array(a.astype(jnp.float32)))
    return t if dtype == jnp.float32 else t.to(torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,sq,sk", [(1, 2, 128, 128), (1, 2, 200, 200),
                                       (2, 1, 64, 200), (1, 1, 200, 72)])
def test_bwd_matches_pallas_kernels_fp32(b, h, sq, sk, causal):
    (q, k, v, do), o, lse = _bwd_inputs(b, h, sq, sk, causal, jnp.float32,
                                        sq * sk)
    jgrads = jax_flash_attention_bwd(q, k, v, o, lse, do, scale=SCALE,
                                     causal=causal, block_q=64,
                                     block_k=128)[:3]
    tgrads = flash_attention_bwd(
        *(_to_port(a, jnp.float32) for a in (q, k, v, o)),
        torch.from_numpy(np.array(lse)), _to_port(do, jnp.float32),
        scale=SCALE, causal=causal)
    for name, tg, jg in zip(("dq", "dk", "dv"), tgrads, jgrads):
        assert tg.shape == jg.shape and tg.dtype == torch.float32, name
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-4,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_matches_pallas_kernels_bf16(causal):
    """bf16 IO: p and ds are rounded to bf16 before each product in both,
    from block-wise (JAX) or whole-row (port) fp32 scores, so a rounded
    value can differ by one bf16 ulp; gradients are held to 2e-2 absolute
    plus 2^-6 relative."""
    (q, k, v, do), o, lse = _bwd_inputs(1, 2, 200, 136, causal,
                                        jnp.bfloat16, 7)
    jgrads = jax_flash_attention_bwd(q, k, v, o, lse, do, scale=SCALE,
                                     causal=causal, block_q=64,
                                     block_k=128)[:3]
    tgrads = flash_attention_bwd(
        *(_to_port(a, jnp.bfloat16) for a in (q, k, v, o)),
        torch.from_numpy(np.array(lse)), _to_port(do, jnp.bfloat16),
        scale=SCALE, causal=causal)
    for name, tg, jg in zip(("dq", "dk", "dv"), tgrads, jgrads):
        assert tg.dtype == torch.bfloat16, name
        np.testing.assert_allclose(tg.float().numpy(),
                                   np.asarray(jg.astype(jnp.float32)),
                                   atol=2e-2, rtol=2 ** -6, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_matches_jax_grad(causal):
    """Gradients of a weighted sum of the public op: the port's
    ``autograd.Function`` against ``jax.grad`` of the JAX ``custom_vjp``
    (fp32, 1e-4)."""
    q, k, v = _qkv(2, 2, 96, 96, seed=13)
    w = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)

    def jloss(q_, k_, v_):
        return jnp.sum(jax_flash_attention(q_, k_, v_, causal) * w)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (flash_attention(tq, tk, tv, causal) * torch.from_numpy(w)).sum() \
        .backward()
    for tg, jg in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-4,
                                   rtol=0)


def test_keys_no_query_sees_get_zero_gradients():
    """Causal with sk > sq: keys past the last query are masked for every
    row, so their dk / dv are exact zeros (P is forced to 0 there), and
    every gradient is finite."""
    q, k, v = _qkv(1, 1, 8, 24, seed=1)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    flash_attention(tq, tk, tv, True).sum().backward()
    assert torch.isfinite(tq.grad).all()
    assert torch.equal(tk.grad[0, 0, 8:], torch.zeros(16, D))
    assert torch.equal(tv.grad[0, 0, 8:], torch.zeros(16, D))


def _mask(shape, seed, p=0.3):
    """A boolean mask of ``shape`` (True = masked) from a seed."""
    return np.random.default_rng(seed).random(shape) < p


# masks of every broadcast kind BERT and its users send: key padding
# (b, 1, 1, sk), per-head (1, h, sq, sk) and full (b, h, sq, sk)
MASK_SHAPES = [(2, 1, 1, 96), (1, 2, 80, 96), (2, 2, 80, 96)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mshape", MASK_SHAPES)
def test_masked_fwd_bwd_match_jax(mshape, causal):
    """o and the gradients of a weighted sum through the public op with a
    boolean mask, against JAX's ``flash_attention(mask=)`` and
    ``jax.grad`` (fp32: 2e-5 on o, 1e-4 on the gradients)."""
    q, k, v = _qkv(2, 2, 80, 96, seed=sum(mshape))
    mask = _mask(mshape, seed=len(mshape) + mshape[1])
    w = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)

    def jloss(q_, k_, v_):
        o = jax_flash_attention(q_, k_, v_, causal, mask=jnp.asarray(mask))
        return jnp.sum(o * w), o

    (_, oj), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ot = flash_attention(tq, tk, tv, causal, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(ot.detach().numpy(), np.asarray(oj),
                               atol=2e-5, rtol=0)
    (ot * torch.from_numpy(w)).sum().backward()
    for tg, jg in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-4,
                                   rtol=0)


def test_constant_bias_matches_jax_kernels():
    """A constant additive bias (``bias_requires_grad=False``, say ALiBi
    slopes) through the forward and backward kernels' plain versions,
    against ``flash_attention_fwd`` / ``flash_attention_bwd`` with the same
    bias in interpret mode (fp32: 2e-5 on o and lse, 1e-4 on gradients);
    the public op takes it without asking for dbias."""
    (q, k, v, do), _, _ = _bwd_inputs(1, 2, 72, 130, False, jnp.float32, 17)
    bias = np.random.default_rng(5).standard_normal((1, 2, 1, 130)) \
        .astype(np.float32)
    oj, lj = jax_flash_attention_fwd(q, k, v, scale=SCALE, causal=False,
                                     bias=jnp.asarray(bias), block_q=64,
                                     block_k=128)
    tb = torch.from_numpy(bias)
    ot, lt = flash_attention_fwd(*(_to_port(a, jnp.float32)
                                   for a in (q, k, v)),
                                 scale=SCALE, causal=False, bias=tb)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=2e-5, rtol=0)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-5, rtol=0)
    jgrads = jax_flash_attention_bwd(q, k, v, oj, lj, do, scale=SCALE,
                                     causal=False, bias=jnp.asarray(bias),
                                     block_q=64, block_k=128)[:3]
    tgrads = flash_attention_bwd(
        *(_to_port(a, jnp.float32) for a in (q, k, v)), ot, lt,
        _to_port(do, jnp.float32), scale=SCALE, causal=False, bias=tb)
    for name, tg, jg in zip(("dq", "dk", "dv"), tgrads, jgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-4,
                                   rtol=0, err_msg=name)
    pq = _to_port(q, jnp.float32).requires_grad_()
    o_pub = flash_attention(pq, _to_port(k, jnp.float32),
                            _to_port(v, jnp.float32), bias=tb,
                            bias_requires_grad=False)
    torch.testing.assert_close(o_pub.detach(), ot, atol=0, rtol=0)
    o_pub.sum().backward()
    assert torch.isfinite(pq.grad).all()


def test_fully_masked_rows_give_zeros():
    """Rows whose every key is masked: o = 0 and lse = -1e30 in the
    forward, and zero gradients for them, exactly, as the JAX kernels
    give."""
    q, k, v = _qkv(1, 2, 40, 64, seed=23)
    mask = _mask((1, 2, 40, 64), seed=8)
    mask[0, 0, 5] = mask[0, 1, 17:20] = True      # whole rows masked
    bias = np.where(mask, -1e30, 0.0).astype(np.float32)
    oj, lj = jax_flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=SCALE,
        causal=False, bias=jnp.asarray(bias), block_q=64, block_k=128)
    ot, lt = flash_attention_fwd(*map(torch.from_numpy, (q, k, v)),
                                 scale=SCALE, causal=False,
                                 bias=torch.from_numpy(bias))
    dead = torch.from_numpy(mask.all(axis=-1))
    assert int(dead.sum()) == 4
    assert torch.equal(ot[dead], torch.zeros(4, D))
    assert torch.equal(lt[dead], torch.full((4,), -1e30))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=2e-5, rtol=0)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-5, rtol=0)
    tq = torch.from_numpy(q).requires_grad_()
    o = flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                        mask=torch.from_numpy(mask))
    o.square().sum().backward()
    assert torch.isfinite(tq.grad).all()
    assert torch.equal(tq.grad[dead], torch.zeros(4, D))


def test_bias_shapes_the_kernels_do_not_take_raise():
    q = torch.zeros(1, 2, 8, D)
    with pytest.raises(ValueError, match="rank-4"):
        flash_attention(q, q, q, mask=torch.zeros(8, 8, dtype=torch.bool))
    with pytest.raises(ValueError, match="bias must"):
        flash_attention(q, q, q, mask=torch.zeros(1, 3, 8, 8,
                                                  dtype=torch.bool))
    with pytest.raises(ValueError, match="bias must"):
        flash_attention_fwd(q, q, q, scale=0.125, causal=False,
                            bias=torch.zeros(1, 2, 8, 8,
                                             dtype=torch.float64))


def test_dropout_rate_zero_with_a_seed_runs_plain_attention():
    """At ``dropout_p == 0`` a ``dropout_seed`` is accepted and ignored, as
    in JAX (``tests/test_flash_attention.py``'s zero-rate test): the same
    output as without it, and as JAX's (2e-5)."""
    q, k, v = _qkv(1, 2, 96, 96, seed=31)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    o = flash_attention(qt, kt, vt, True, dropout_p=0.0, dropout_seed=3)
    torch.testing.assert_close(o, flash_attention(qt, kt, vt, True),
                               atol=0, rtol=0)
    oj = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             True, None, 64, 128, dropout_p=0.0,
                             dropout_seed=3)
    np.testing.assert_allclose(o.numpy(), np.asarray(oj), atol=2e-5, rtol=0)


@pytest.mark.parametrize("blocks,ok", [
    ((128, 128), True), ((64, None), True), ((None, 256), True),
    ((12, 128), False), ((128, 100), False), ((0, 128), False),
    ((None, 64), False)])
def test_explicit_blocks_are_validated_as_in_jax(blocks, ok):
    """JAX's positional ``block_q`` / ``block_k``: valid ones change
    nothing (the CUDA kernels keep their own tiling), invalid ones raise
    ``ValueError`` on both sides (block_q a positive multiple of 8,
    block_k of 128; one given alone is checked beside the other's JAX
    default)."""
    q, k, v = _qkv(1, 1, 64, 64, seed=33)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    if ok:
        torch.testing.assert_close(
            flash_attention(qt, kt, vt, True, None, *blocks),
            flash_attention(qt, kt, vt, True), atol=0, rtol=0)
        return
    with pytest.raises(ValueError, match="block_q"):
        flash_attention(qt, kt, vt, True, None, *blocks)
    with pytest.raises(ValueError, match="block_q"):
        jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            True, None, *blocks)


@pytest.mark.parametrize("bh", [1, 65535, 65536, 200000, 65535 * 65535])
def test_batch_heads_grid_covers_any_count(bh):
    """grid.y x grid.z carry batch * heads: each dimension within 65535,
    every index covered, and no z-slice left empty."""
    gy, gz = fa_batch_heads_grid(bh)
    assert 1 <= gy <= FA_GRID_DIM_MAX and 1 <= gz <= FA_GRID_DIM_MAX
    assert gy * (gz - 1) < bh <= gy * gz


def test_batch_heads_grid_refuses_what_no_grid_holds():
    with pytest.raises(ValueError, match="batch\\*heads"):
        fa_batch_heads_grid(65535 * 65535 + 1)
