"""Port parity: flash-attention forward (apex_tpu_torch vs apex_tpu).

The same numpy q, k, v, made from a seed, go through the JAX Pallas
kernel ``flash_attention_fwd`` (interpret mode on the CPU, block_q=64 and
block_k=128 so it stays fast) and through the port's
``flash_attention_fwd`` on CPU tensors, which runs the CUDA kernel's plain
version. Both o and the fp32 log-sum-exp are compared, causal and not,
with ragged sq / sk. Tolerance for fp32: 2e-5 absolute (the JAX kernel
sums its softmax block by block, the plain version over the whole row).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention, flash_attention_fwd as
    jax_flash_attention_fwd)
from apex_tpu_torch.ops.flash_attention import (flash_attention,
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
