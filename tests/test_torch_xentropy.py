"""Port parity: softmax cross-entropy (apex_tpu_torch vs apex_tpu).

The same numpy logits and labels, made from a seed, go through the JAX
``softmax_cross_entropy_loss`` (its ``custom_vjp``) and the port's
``autograd.Function``, with label smoothing and ``padding_idx``: the
per-row loss and ``jax.grad`` of a weighted sum against the port's
autograd. Tolerances: fp32 1e-5 absolute on the loss and 1e-6 on the
gradient; bf16 logits give an fp32 loss held to 1e-5 and a bf16 gradient
held to one bf16 ulp of 1 (2^-8) absolute. Padding rows are held to exact
zeros.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.xentropy import (
    softmax_cross_entropy_loss as jax_softmax_cross_entropy_loss)
from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy_loss

K = 97


def _inputs(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((3, 5, K)) * 3).astype(np.float32)
    labels = rng.integers(0, K, (3, 5)).astype(np.int32)
    labels[1, 2] = labels[2, 0] = 3   # rows that padding_idx=3 drops
    w = rng.standard_normal((3, 5)).astype(np.float32)
    return logits, labels, w


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("smoothing,padding_idx", [(0.0, None), (0.1, None),
                                                   (0.0, 3), (0.2, 3)])
def test_loss_and_grad_match_jax(smoothing, padding_idx, dtype):
    logits, labels, w = _inputs(int(smoothing * 10) + (padding_idx or 0))
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))

    def jloss(x):
        return jax_softmax_cross_entropy_loss(x, jnp.asarray(labels),
                                              smoothing, padding_idx)

    jx = jnp.asarray(logits).astype(jdt)
    lj = jloss(jx)
    gj = jax.grad(lambda x: jnp.sum(jloss(x) * w))(jx)
    tx = torch.from_numpy(logits).to(tdt).requires_grad_()
    lt = softmax_cross_entropy_loss(tx, torch.from_numpy(labels).long(),
                                    smoothing, padding_idx)
    (lt * torch.from_numpy(w)).sum().backward()
    assert lt.dtype == torch.float32 and lt.shape == (3, 5)
    assert tx.grad.dtype == tdt
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               np.asarray(gj.astype(jnp.float32)),
                               atol=1e-6 if dtype == "fp32" else 2 ** -8,
                               rtol=0)
    if padding_idx is not None:
        dropped = torch.from_numpy(labels == padding_idx)
        assert torch.all(lt.detach()[dropped] == 0)
        assert torch.all(tx.grad[dropped] == 0)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_padding_label_outside_the_vocabulary(smoothing):
    """``padding_idx=-1`` with labels of -1, as the MLM loss passes them:
    the JAX function's loss and gradient, exact zeros on the padding rows,
    and no gather or scatter at index -1 (which raised before)."""
    logits, labels, w = _inputs(31)
    labels[0, 1] = labels[1, 4] = labels[2, 2] = -1

    def jloss(x):
        return jax_softmax_cross_entropy_loss(x, jnp.asarray(labels),
                                              smoothing, -1)

    lj = jloss(jnp.asarray(logits))
    gj = jax.grad(lambda x: jnp.sum(jloss(x) * w))(jnp.asarray(logits))
    tx = torch.from_numpy(logits).requires_grad_()
    lt = softmax_cross_entropy_loss(tx, torch.from_numpy(labels).long(),
                                    smoothing, -1)
    (lt * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gj), atol=1e-6,
                               rtol=0)
    dropped = torch.from_numpy(labels == -1)
    assert torch.equal(lt.detach()[dropped], torch.zeros(3))
    assert torch.equal(tx.grad[dropped], torch.zeros(3, K))
