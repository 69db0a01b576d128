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
bf16 as stated at each test.
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
    {"mask": torch.zeros(1, 1, 8, 8, dtype=torch.bool)},
    {"dropout_p": 0.1, "dropout_seed": 1},
])
def test_operands_not_ported_raise(kw):
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
