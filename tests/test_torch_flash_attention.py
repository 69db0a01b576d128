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
behave as in JAX; the kernels' batch * heads grid covers any count. A
Python copy of the bf16 tensor-core kernels' tile rule is held to the JAX
kernels' ``_causal_run`` and ``_mask_split`` at the same 64 x 64 tiles
(the kernels themselves are covered by the card tests); the dtype route
and the TMA alignment check are tested without a card. The public op
takes any layout (a transposed view, a view 2 bytes off its storage's
alignment) and hands the raw kernels contiguous, aligned operands.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.pallas.flash_attention import (
    _causal_run as _jax_causal_run, _mask_split as _jax_mask_split,
    flash_attention as jax_flash_attention, flash_attention_bwd as
    jax_flash_attention_bwd, flash_attention_fwd as jax_flash_attention_fwd)
from apex_tpu_torch.ops.flash_attention import (_tensor_core,
                                                flash_attention,
                                                flash_attention_bwd,
                                                flash_attention_fwd)
from apex_tpu_torch.ops import flash_attention as fa_mod
from apex_tpu_torch.ops.tiling import (FA_GRID_DIM_MAX, FA_TC_ALIGN,
                                       fa_batch_heads_grid, fa_route,
                                       fa_tc_fwd_geometry, fa_tc_geometry,
                                       fa_tc_misaligned)

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


def _spy_kernel_operands(monkeypatch):
    """Wraps the module's raw ``flash_attention_fwd`` / ``_bwd`` (which the
    public op's ``autograd.Function`` calls) with a check that each of q,
    k, v, o and do is contiguous and ``FA_TC_ALIGN``-byte aligned, as the
    CUDA kernels need; returns the list of calls seen."""
    seen = []
    real_fwd, real_bwd = fa_mod.flash_attention_fwd, fa_mod.flash_attention_bwd

    def check(name, **ts):
        for what, t in ts.items():
            assert t.is_contiguous(), (name, what)
            assert t.data_ptr() % FA_TC_ALIGN == 0, (name, what)
        seen.append(name)

    def fwd(q, k, v, **kw):
        check("fwd", q=q, k=k, v=v)
        return real_fwd(q, k, v, **kw)

    def bwd(q, k, v, o, lse, do, **kw):
        check("bwd", q=q, k=k, v=v, o=o, do=do)
        return real_bwd(q, k, v, o, lse, do, **kw)

    monkeypatch.setattr(fa_mod, "flash_attention_fwd", fwd)
    monkeypatch.setattr(fa_mod, "flash_attention_bwd", bwd)
    return seen


def test_public_op_takes_transposed_views(monkeypatch):
    """q, k, v and the incoming gradient as ``transpose(1, 2)`` views of
    (b, s, h, d) storage, as a user's projection gives them: the kernels
    get contiguous operands, and o and the gradients match JAX's on the
    same arrays (fp32: 2e-5 on o, 1e-4 on the gradients)."""
    seen = _spy_kernel_operands(monkeypatch)
    rng = np.random.default_rng(41)
    q, k, v, w = (rng.standard_normal((2, 72, 2, D)).astype(np.float32)
                  for _ in range(4))
    jq, jk, jv, jw = (np.ascontiguousarray(a.transpose(0, 2, 1, 3))
                      for a in (q, k, v, w))

    def jloss(q_, k_, v_):
        o = jax_flash_attention(q_, k_, v_, True)
        return jnp.sum(o * jw), o

    (_, oj), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(jq), jnp.asarray(jk), jnp.asarray(jv))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tq, tk, tv = (t.transpose(1, 2) for t in leaves)
    assert not tq.is_contiguous()
    ot = flash_attention(tq, tk, tv, True)
    np.testing.assert_allclose(ot.detach().numpy(), np.asarray(oj),
                               atol=2e-5, rtol=0)
    tw = torch.from_numpy(w).transpose(1, 2)
    (ot * tw).sum().backward()
    assert seen == ["fwd", "bwd"]
    for t, jg in zip(leaves, jgrads):
        np.testing.assert_allclose(t.grad.transpose(1, 2).numpy(),
                                   np.asarray(jg), atol=1e-4, rtol=0)


def test_public_op_takes_misaligned_bf16_views(monkeypatch):
    """bf16 q, k, v and do as contiguous views 2 bytes into their storage
    (off the TMA's 16-byte alignment): the kernels get aligned copies, o
    and the gradients have the bits of the same call on aligned copies,
    and match JAX's bf16 op within the bf16 tolerances (o 2e-2; gradients
    2e-2 plus 2^-6 relative: p and ds round to bf16 from block-wise or
    whole-row scores)."""
    shape = (1, 2, 80, D)
    n = math.prod(shape)
    rng = np.random.default_rng(43)
    q, k, v, w = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(4))

    def misaligned(a):
        store = torch.zeros(n + 8, dtype=torch.bfloat16)
        t = store[1:1 + n].view(shape)
        t.copy_(torch.from_numpy(a))
        assert t.data_ptr() % FA_TC_ALIGN == 2
        return t

    def run(make):
        leaves = [make(a).requires_grad_() for a in (q, k, v)]
        o = flash_attention(*leaves, True)
        o.backward(make(w))
        return o.detach(), [t.grad for t in leaves]

    want_o, want_g = run(lambda a: torch.from_numpy(a).to(torch.bfloat16))
    seen = _spy_kernel_operands(monkeypatch)
    got_o, got_g = run(misaligned)
    assert seen == ["fwd", "bwd"]
    assert torch.equal(got_o, want_o)
    for a, b in zip(got_g, want_g):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    bf = jnp.bfloat16
    jw = jnp.asarray(w).astype(bf).astype(jnp.float32)

    def jloss(q_, k_, v_):
        o = jax_flash_attention(q_, k_, v_, True)
        return jnp.sum(o.astype(jnp.float32) * jw), o

    (_, oj), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                         has_aux=True)(
        *(jnp.asarray(a).astype(bf) for a in (q, k, v)))
    np.testing.assert_allclose(got_o.float().numpy(),
                               np.asarray(oj.astype(jnp.float32)),
                               atol=2e-2, rtol=0)
    for name, tg, jg in zip(("dq", "dk", "dv"), got_g, jgrads):
        np.testing.assert_allclose(tg.float().numpy(),
                                   np.asarray(jg.astype(jnp.float32)),
                                   atol=2e-2, rtol=2 ** -6, err_msg=name)


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


# The bf16 tensor-core kernels' tile rule against the JAX kernels' own
# rules at the same 64 x 64 tiles: `_causal_run` says which (q tile, k
# tile) pairs run, `_mask_split` which of them take the masked arithmetic.
# The kernels compute their rule in C++ from (sq, sk, causal);
# `_tc_fwd_plan` / `_tc_dq_plan` / `_tc_dkv_plan` copy it line for line,
# so a change to one side must be made on the other:
# csrc/flash_fwd_wgmma.cu `nk`, `nk_me` and `masked`,
# csrc/flash_bwd_dq_wgmma.cu `nk`, `nk_me` and `nk_plain` (the tiles that
# take no mask first, in a loop of their own, then the masked ones),
# csrc/flash_bwd_dkv_wgmma.cu `qt0`, `q_start` (the `_causal_run` skip)
# and `q_mask` (the masked tiles first, then the rest).
# The kernels' own use of the rule is held to the plain versions by the
# card tests (tests/test_torch_cuda.py). A forward block holds 128 query
# rows, 64 a warpgroup, over key tiles of ``tile`` keys (64, or 32 at d =
# 256, where it makes two passes: ``fa_tc_fwd_geometry``). A dq block
# holds 128 query rows, 64 a warpgroup, over key tiles of ``tile`` keys
# (64, or 32 at d = 256: ``fa_tc_geometry``). A dk / dv block holds
# ``slabs`` 64-key slabs (``Layout::kSlabs``: 2, one a warpgroup, up to d
# = 128; 1 at d = 256, where both warpgroups take the slab, the one S^T
# and dV, the other dP^T and dK: its role, the last entry of a step).
WG_ROWS, TC_TILE = 64, 64            # a warpgroup's rows, a streamed tile
TC_BLOCK = 2 * WG_ROWS               # a block's query rows / keys


def _cdiv(a, b):
    return -(-a // b)


def _tc_fwd_plan(sq, sk, causal, tile=TC_TILE, passes=1):
    """The forward's work: ``(blocks, loads, steps)``. ``loads[b]`` the K /
    V tiles of ``tile`` keys block ``b`` streams in each of its
    ``passes`` passes (tiles 0 .. loads[b] - 1; `nk`); ``steps`` the ``(q
    tile, k tile, masked)`` each warpgroup computes (its 64-row q tile
    ``q`` in block ``q // 2``; `nk_me`; with two passes its pass appended,
    0 the max's, 1 the output's), ``masked`` when the tile crosses that q
    tile's diagonal or the ragged sk edge. A q tile past sq computes
    nothing."""
    block = TC_BLOCK
    nk = _cdiv(sk, tile)
    blocks = _cdiv(sq, block)
    loads, steps = [], []
    for b in range(blocks):
        q0 = b * block
        last = min(q0 + block, sq) - 1
        loads.append(min(nk, last // tile + 1) if causal else nk)
        for ps in range(passes):
            for wg in range(2):
                row0 = q0 + wg * WG_ROWS
                if row0 >= sq:
                    continue
                # `nk_me`, within the block's streamed tiles (the loop)
                mine = min(loads[b], (row0 + WG_ROWS - 1) // tile + 1
                           if causal else nk)
                for kt in range(mine):
                    k0 = kt * tile
                    masked = ((causal and k0 + tile - 1 > row0)
                              or k0 + tile > sk)
                    steps.append((row0 // WG_ROWS, kt, masked)
                                 + ((ps,) if passes == 2 else ()))
    return blocks, loads, steps


def _tc_dq_plan(sq, sk, causal, tile=TC_TILE):
    """The dq kernel's work: ``(blocks, loads, steps)``. ``loads[b]`` the
    K / V tiles of ``tile`` keys block ``b`` streams (tiles 0 .. loads[b]
    - 1; `nk`), every one released by both warpgroups; ``steps`` the ``(q
    tile, k tile, masked)`` each warpgroup computes, in its order (its
    64-row q tile ``q`` in block ``q // 2``; `nk_me`, 0 for a warpgroup
    past sq), ``masked`` for the tiles of its second loop, from
    `nk_plain` on."""
    block = TC_BLOCK
    nk_all = _cdiv(sk, tile)
    blocks = _cdiv(sq, block)
    loads, steps = [], []
    for b in range(blocks):
        q0 = b * block
        loads.append(min(nk_all, (min(q0 + block, sq) - 1) // tile + 1)
                     if causal else nk_all)
        for wg in range(2):
            row0 = q0 + wg * WG_ROWS
            active = row0 < sq
            nk_me = ((min(nk_all, (min(row0 + WG_ROWS, sq) - 1) // tile
                          + 1) if causal else nk_all) if active else 0)
            nk_plain = min(nk_me, min(sk // tile, row0 // tile)
                           if causal else sk // tile)
            for kt in range(nk_me):
                steps.append((row0 // WG_ROWS, kt, kt >= nk_plain))
    return blocks, loads, steps


def _tc_dkv_plan(sq, sk, causal, slabs=2):
    """The dk / dv kernel's work: ``(blocks, loads, steps)``. ``loads[b]``
    the Q / dO tiles block ``b`` streams, ``(first, end)`` (from the
    diagonal when causal: `qt0`); ``steps`` the ``(k tile, q tile,
    masked)`` each warpgroup computes, in its order (its 64-key k tile
    ``k`` in block ``k // slabs``, from `q_start`; at ``slabs`` 1 with its
    role appended: 0 S^T, p and dV, 1 dP^T, ds and dK), ``masked`` for
    the tiles of its first loop, up to `q_mask` (the dK warpgroup takes
    its p, masked, from the other). A k tile past sk computes nothing."""
    block = WG_ROWS * slabs
    nq = _cdiv(sq, TC_TILE)
    blocks = _cdiv(sk, block)
    loads, steps = [], []
    for b in range(blocks):
        k0 = b * block
        first = min(k0 // TC_TILE, nq) if causal else 0
        loads.append((first, nq))
        for wg in range(2):
            # the warpgroup's slab (both take the one slab at slabs 1)
            kw0 = k0 + (wg if slabs == 2 else 0) * WG_ROWS
            # the tiles before q_start are released unread
            q_start = (nq if kw0 >= sk else min(kw0 // TC_TILE, nq)
                       if causal else 0)
            q_mask = (nq if kw0 + WG_ROWS > sk else min(q_start + 1, nq)
                      if causal else q_start)
            for qt in range(q_start, nq):
                steps.append((kw0 // WG_ROWS, qt, qt < q_mask)
                             + ((wg,) if slabs == 1 else ()))
    return blocks, loads, steps

PLAN_SHAPES = [(1, 1), (64, 64), (65, 64), (64, 65), (128, 128),
               (200, 200), (200, 333), (333, 200), (70, 130), (130, 70),
               (1000, 1000), (1024, 1024), (128, 1), (1, 300)]


def _jax_pairs(sq, sk, causal):
    """{(q tile, k tile): needs_mask} of every pair the JAX kernels run
    at 64 x 64 tiles."""
    nq, nk = -(-sq // 64), -(-sk // 64)
    out = {}
    for qi in range(nq):
        for kj in range(nk):
            run, needs = _jax_mask_split(causal, qi, kj, 64, 64, sk, nk)
            if bool(run):
                out[(qi, kj)] = bool(needs)
    return out


def _live_pairs(sq, sk, causal, bk):
    """Brute force: {(q tile, k tile): masked} of the pairs of 64-row q
    tiles and ``bk``-key k tiles holding any (row, key) pair that a real
    row keeps (row < sq, key < sk, key <= row when causal), masked where
    one of the tile's pairs of real rows is dropped or its keys pass
    sk."""
    keep = ((np.arange(sk)[None, :] <= np.arange(sq)[:, None]) if causal
            else np.ones((sq, sk), dtype=bool))
    out = {}
    for qi in range(-(-sq // 64)):
        for kj in range(-(-sk // bk)):
            part = keep[qi * 64:qi * 64 + 64, kj * bk:kj * bk + bk]
            if part.any():
                out[(qi, kj)] = bool(not part.all() or kj * bk + bk > sk)
    return out


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", PLAN_SHAPES)
def test_tc_fwd_plan_matches_jax_rules(sq, sk, causal):
    blocks, loads, steps = _tc_fwd_plan(sq, sk, causal)
    assert blocks == -(-sq // 128) == len(loads)
    got = {(qt, kt): masked for qt, kt, masked in steps}
    assert len(got) == len(steps)  # no pair twice
    assert got == _jax_pairs(sq, sk, causal)
    if causal:
        assert all(_jax_causal_run(qt, kt, 64, 64) for qt, kt in got)
    # a block streams exactly the key tiles its warpgroups use
    for b in range(blocks):
        used = [kt for qt, kt, _ in steps if qt // 2 == b]
        assert loads[b] == (max(used) + 1 if used else 0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", PLAN_SHAPES)
def test_tc_dq_plan_matches_jax_rules(sq, sk, causal):
    """The dq kernel runs the JAX dq kernel's (q tile, k tile) pairs, each
    once, the masked arithmetic where `_mask_split` asks for it, and a
    block streams exactly the key tiles its warpgroups use."""
    blocks, loads, steps = _tc_dq_plan(sq, sk, causal)
    assert blocks == -(-sq // 128) == len(loads)
    got = {(qt, kt): masked for qt, kt, masked in steps}
    assert len(got) == len(steps)
    assert got == _jax_pairs(sq, sk, causal)
    if causal:
        assert all(_jax_causal_run(qt, kt, 64, 64) for qt, kt in got)
    for b in range(blocks):
        used = [kt for qt, kt, _ in steps if qt // 2 == b]
        assert loads[b] == (max(used) + 1 if used else 0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", PLAN_SHAPES)
def test_tc_dkv_plan_matches_jax_rules(sq, sk, causal):
    blocks, loads, steps = _tc_dkv_plan(sq, sk, causal)
    assert blocks == -(-sk // 128) == len(loads)
    got = {(qt, kt): masked for kt, qt, masked in steps}
    assert len(got) == len(steps)
    assert got == _jax_pairs(sq, sk, causal)
    # a block streams its q tiles from the first any of its keys sees
    # (`_q_index_map_dkv`'s first block) to the end, each used
    for b, (first, end) in enumerate(loads):
        assert end == -(-sq // 64)
        assert first == (min(b * 128 // 64, end) if causal else 0)
        used = {qt for kt, qt, _ in steps if kt // 2 == b}
        assert used == set(range(first, end)) or not used


@pytest.mark.parametrize("slabs", [2, 1])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", PLAN_SHAPES)
def test_tc_bwd_plans_run_masked_tiles_in_one_loop(sq, sk, causal, slabs):
    """Each backward warpgroup's tiles in its order, at the widths whose dk
    / dv blocks hold ``slabs`` slabs (2: d = 128, 64-key dq tiles; 1: d =
    256, 32-key dq tiles): the masked ones are one run (dq's last, dk /
    dv's first), so each kernel decides a tile's mask by its loop and never
    per tile; a tile is masked exactly where brute force finds in it a key
    past sk or, when causal, a (row, key) pair above the diagonal."""
    g = fa_tc_geometry(128 if slabs == 2 else 256)
    assert g.dkv_slabs == slabs
    keep = ((np.arange(sk)[None, :] <= np.arange(sq)[:, None]) if causal
            else np.ones((sq, sk), dtype=bool))
    for plan, last, tile in (
            (lambda *a: _tc_dq_plan(*a, tile=g.dq_tile_rows), True,
             g.dq_tile_rows),
            (lambda *a: _tc_dkv_plan(*a, slabs=slabs), False, TC_TILE)):
        _, _, steps = plan(sq, sk, causal)
        groups = {}
        for st in steps:
            groups.setdefault((st[0],) + st[3:], []).append(st)
        for key, run in groups.items():
            flags = [st[2] for st in run]
            assert flags == sorted(flags, reverse=not last)
            for st in run:
                qt, kt = st[:2] if last else st[1::-1]
                rows = slice(qt * 64, min(qt * 64 + 64, sq))
                dropped = not keep[rows, kt * tile:kt * tile + tile].all() \
                    or kt * tile + tile > sk
                assert st[2] == dropped


def test_tc_plan_causal_work_is_the_lower_triangle():
    """GPT-2's causal 1024 x 1024: 136 of the 256 tile pairs run and the
    16 on the diagonal take the masked arithmetic, in all three kernels."""
    for plan, pair in ((_tc_fwd_plan, lambda s: (s[0], s[1])),
                       (_tc_dq_plan, lambda s: (s[0], s[1])),
                       (_tc_dkv_plan, lambda s: (s[1], s[0]))):
        _, _, steps = plan(1024, 1024, True)
        assert len(steps) == 16 * 17 // 2
        assert sorted(pair(s) for s in steps if s[2]) == \
            [(i, i) for i in range(16)]


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "fma")])
def test_cuda_route_follows_the_dtype(dtype, route):
    """bf16 takes the tensor-core kernels, fp32 the FMA-pipe ones (full
    fp32 products); any other dtype is refused."""
    assert fa_route(str(dtype).removeprefix("torch.")) == route
    q = torch.zeros(1, 1, 64, 64, dtype=dtype)
    assert _tensor_core("f", q, k=q, v=q) is (route == "wgmma")


def test_cuda_route_refuses_other_dtypes():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa_route("float16")


def test_tc_alignment_check_names_misaligned_pointers():
    """TMA needs 16-byte aligned bases: the check names each pointer that
    is not, from fake addresses."""
    base = 0x7F00_0000_0000
    assert fa_tc_misaligned({"q": base, "k": base + 16, "v": base + 4096}) \
        == []
    assert fa_tc_misaligned({"q": base + 2, "k": base + 16,
                             "do": base + 8}) == ["q", "do"]


def test_tc_route_raises_on_a_misaligned_bf16_view():
    """A contiguous bf16 view one element into its storage is 2 bytes off
    the alignment TMA needs: the tensor-core route raises (it does not
    fall back); an fp32 view takes the FMA route, which reads any
    address."""
    store = torch.zeros(2 * 64 * 64 + 8, dtype=torch.bfloat16)
    ok = store[:64 * 64].view(1, 1, 64, 64)
    bad = store[1:1 + 64 * 64].view(1, 1, 64, 64)
    assert ok.data_ptr() % 16 == 0 and bad.data_ptr() % 16 == 2
    assert _tensor_core("flash_attention_fwd", ok, k=ok, v=ok)
    with pytest.raises(ValueError, match="k through TMA"):
        _tensor_core("flash_attention_fwd", ok, k=bad, v=ok)
    with pytest.raises(ValueError, match="do through TMA"):
        _tensor_core("flash_attention_bwd", ok, k=ok, v=ok, do=bad)
    f32 = torch.zeros(64 * 64 + 1)[1:].view(1, 1, 64, 64)
    assert not _tensor_core("flash_attention_fwd", f32, k=f32, v=f32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", PLAN_SHAPES)
def test_tc_plans_at_head_dim_256_match_jax_rules(sq, sk, causal):
    """At d = 256 (``fa_tc_geometry(256)``) the dq kernel (128-row blocks,
    each warpgroup its 64 rows and all columns, over 32-key tiles) runs
    the (q tile, k tile) pairs at 32-key tiles that hold a pair a real row
    keeps, each once (the JAX rule's at 64-key tiles, which a q tile past
    sq reaches no further than its real rows; at 32 it would run tiles
    past them), the masked arithmetic where the tile drops a pair of a
    real row (`_mask_split`'s rule), and a block streams exactly the tiles
    its warpgroups use; the dk / dv kernel (one 64-key
    slab a block, both warpgroups on it) runs the JAX dk / dv kernel's
    pairs once in each warpgroup (the one's S^T, p and dV, the other's
    dP^T, ds and dK), and a block streams exactly the tiles its slab
    uses. (The forward's 32-key tiles:
    ``test_tc_fwd_plan_visits_each_pair_once``.)"""
    g = fa_tc_geometry(256)
    assert (g.dq_block_rows, g.dq_tile_rows, g.cols) == (128, 32, 256)
    assert (g.dkv_slabs, g.dkv_block_rows) == (1, 64)
    blocks, loads, steps = _tc_dq_plan(sq, sk, causal, tile=g.dq_tile_rows)
    assert blocks == g.dq_blocks(sq) == len(loads)
    got = {(qt, kt): masked for qt, kt, masked in steps}
    assert len(got) == len(steps)
    assert got == _live_pairs(sq, sk, causal, g.dq_tile_rows)
    assert _live_pairs(sq, sk, causal, 64) == _jax_pairs(sq, sk, causal)
    for b in range(blocks):
        used = [kt for qt, kt, _ in steps if qt // 2 == b]
        assert loads[b] == (max(used) + 1 if used else 0)
    blocks, loads, steps = _tc_dkv_plan(sq, sk, causal, slabs=g.dkv_slabs)
    assert blocks == g.dkv_blocks(sk) == len(loads)
    assert len(set(steps)) == len(steps)
    want = _jax_pairs(sq, sk, causal)
    for role in range(2):
        got = {(qt, kt): m for kt, qt, m, r in steps if r == role}
        assert got == want
    for b, (first, end) in enumerate(loads):
        used = {s[1] for s in steps if s[0] == b}
        assert used == set(range(first, end)) or not used


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", PLAN_SHAPES)
@pytest.mark.parametrize("d", [128, 256])
def test_tc_fwd_plan_visits_each_pair_once(d, sq, sk, causal):
    """The forward at d = 128 and 256 (``fa_tc_fwd_geometry(d)``: 128-row
    blocks over 64- or 32-key tiles, two passes at 256) against brute
    force over the (row, key) pairs: in each pass every pair the softmax
    keeps (key < sk, and key <= row when causal) lies in exactly one
    computed (q tile, k tile) step: the max pass covers every key of each
    row and the output pass each pair under the diagonal once; a step
    takes the unmasked arithmetic only where every pair of its tile is
    kept; a block streams exactly the tiles its warpgroups use."""
    g = fa_tc_fwd_geometry(d)
    assert (g.block_rows, g.cols) == (TC_BLOCK, d)
    tile = g.tile_rows
    blocks, loads, steps = _tc_fwd_plan(sq, sk, causal, tile=tile,
                                        passes=g.passes)
    assert blocks == g.blocks(sq) == len(loads)
    assert len(set(steps)) == len(steps)
    live = ((np.arange(sk)[None, :] <= np.arange(sq)[:, None]) if causal
            else np.ones((sq, sk), dtype=bool))
    for ps in range(g.passes):
        seen = np.zeros((sq, sk), dtype=int)
        for step in steps:
            if g.passes == 2 and step[3] != ps:
                continue
            qt, kt, masked = step[:3]
            rows = slice(qt * WG_ROWS, min((qt + 1) * WG_ROWS, sq))
            keys = slice(kt * tile, min((kt + 1) * tile, sk))
            seen[rows, keys] += 1
            if not masked:
                assert live[rows, keys].all() and (kt + 1) * tile <= sk
        assert (seen[live] == 1).all()
    for b in range(blocks):
        used = [s[1] for s in steps if s[0] // 2 == b]
        assert loads[b] == (max(used) + 1 if used else 0)
