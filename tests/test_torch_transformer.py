"""Port parity: the rest of ``transformer/`` (apex_tpu_torch vs
apex_tpu.transformer).

- ``FusedDense`` / ``FusedDenseGeluDense`` modules and ``MLP`` (relu,
  sigmoid, none; bias on and off) against the flax modules with the flax
  parameters (``dense_params_from_jax``): output and every parameter's
  gradient and the input's, fp32, relative L2 <= 1e-5.
- ``wgrad_gemm_accum_fp32`` / ``_fp16`` against JAX: fp32 within 1e-5,
  the fp16 accumulator within one fp16 ulp (2^-10 relative).
- ``linear_cross_entropy`` against JAX's (loss, d hidden, d weight; fp32
  within 1e-5) and against the port's dense ``softmax_cross_entropy_loss``
  on ``hidden @ weight``: smoothing 0 and 0.1, ``padding_idx``, a chunk
  that does not divide V, ``logit_scale``.

Widths 128 and below, vocabulary 300.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.transformer import fused_dense as jfd
from apex_tpu.transformer import mlp as jmlp
from apex_tpu.transformer import wgrad as jwg
from apex_tpu.transformer.linear_cross_entropy import (
    linear_cross_entropy as jax_linear_cross_entropy)
from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.models.convert import (dense_params_from_jax,
                                           dense_params_to_jax)
from apex_tpu_torch.transformer import (MLP, FusedDense, FusedDenseGeluDense,
                                        linear_cross_entropy, mlp_forward,
                                        wgrad_gemm_accum_fp16,
                                        wgrad_gemm_accum_fp32)

REL_L2 = 1e-5


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def _rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _against_flax(jmodel, tmodel, x, seed):
    """Output, d x and every parameter's gradient of ``sum(out * r)``:
    the port module (given the flax parameters) against the flax one."""
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, params)
    y0 = jax.jit(jmodel.apply)(params, jnp.asarray(x))
    r = _np(y0.shape, seed + 1)

    def loss(p, xx):
        return jnp.sum(jmodel.apply(p, xx) * r)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    tmodel.load_state_dict(dense_params_from_jax(params))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tmodel(xt)
    (y * torch.from_numpy(r)).sum().backward()
    assert _rel_l2(y.detach(), y0) <= REL_L2
    assert _rel_l2(xt.grad, gx) <= REL_L2
    want = dense_params_from_jax(jax.tree_util.tree_map(np.asarray, gp))
    got = dict(tmodel.named_parameters())
    assert set(got) == set(want)
    for n in want:
        assert _rel_l2(got[n].grad, want[n]) <= REL_L2, n
    return params


@pytest.mark.parametrize("use_bias", [True, False])
def test_fused_dense_module_matches_flax(use_bias):
    x = _np((3, 5, 64), 1)
    params = _against_flax(jfd.FusedDense(64, 96, use_bias=use_bias),
                           FusedDense(64, 96, use_bias, device="cpu"), x, 2)
    back = dense_params_to_jax(dense_params_from_jax(params))
    for name, leaf in params["params"].items():
        np.testing.assert_array_equal(back["params"][name], leaf)


def test_fused_dense_gelu_dense_module_matches_flax():
    x = _np((4, 6, 64), 3)
    mod = FusedDenseGeluDense(64, 128, 48, device="cpu")
    assert [n for n, _ in mod.named_parameters()] == [
        "weight1", "bias1", "weight2", "bias2"]
    _against_flax(jfd.FusedDenseGeluDense(64, 128, 48), mod, x, 4)


@pytest.mark.parametrize("activation", ["relu", "sigmoid", "none"])
@pytest.mark.parametrize("use_bias", [True, False])
def test_mlp_matches_flax(activation, use_bias):
    x = _np((10, 32), 5)
    sizes = [32, 64, 48, 16]
    mod = MLP(sizes, use_bias, activation, device="cpu")
    assert sorted(n for n, _ in mod.named_parameters()) == sorted(
        [f"weight_{i}" for i in range(3)]
        + ([f"bias_{i}" for i in range(3)] if use_bias else []))
    _against_flax(jmlp.MLP(sizes, use_bias=use_bias, activation=activation),
                  mod, x, 6)


def test_mlp_forward_keeps_the_io_dtype_per_layer():
    """bf16 x: each layer's output is cast to bf16, as in JAX."""
    x = _np((4, 16), 7)
    ws = [_np((32, 16), 8, 0.2), _np((8, 32), 9, 0.2)]
    bs = [_np((32,), 10), _np((8,), 11)]
    want = jax.jit(lambda x, w0, w1, b0, b1: jmlp.mlp_forward(
        x, [w0, w1], [b0, b1], "relu"))(
        jnp.asarray(x).astype(jnp.bfloat16),
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in ws),
        *map(jnp.asarray, bs))
    got = mlp_forward(torch.from_numpy(x).bfloat16(),
                      [torch.from_numpy(w).bfloat16() for w in ws],
                      [torch.from_numpy(b) for b in bs], "relu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-2)
    with pytest.raises(ValueError, match="activation"):
        mlp_forward(torch.from_numpy(x), [], None, "gelu")


@pytest.mark.parametrize("dt", ["fp32", "fp16"])
def test_wgrad_matches_jax(dt):
    inp = _np((3, 7, 24), 12)
    go = _np((3, 7, 16), 13)
    mg = _np((16, 24), 14)
    if dt == "fp32":
        want = jwg.wgrad_gemm_accum_fp32(*map(jnp.asarray, (inp, go, mg)))
        got = wgrad_gemm_accum_fp32(*map(torch.from_numpy, (inp, go, mg)))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    else:
        args = [a.astype(np.float16) for a in (inp, go, mg)]
        want = jwg.wgrad_gemm_accum_fp16(*map(jnp.asarray, args))
        got = wgrad_gemm_accum_fp16(*map(torch.from_numpy, args))
        assert got.dtype == torch.float16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=2 ** -10, atol=1e-3)


LCE_CASES = [(0.0, None, 128, 1.0), (0.1, None, 128, 1.0),
             (0.0, 3, 64, 1.0), (0.1, 3, 77, 0.5), (0.0, None, 512, 2.0)]


@functools.lru_cache(maxsize=None)
def _jax_lce(smoothing, padding_idx, chunk, logit_scale):
    def loss(h, w, lab, r):
        return jnp.sum(jax_linear_cross_entropy(
            h, w, lab, smoothing, padding_idx, chunk, logit_scale) * r)

    fwd = jax.jit(lambda h, w, lab: jax_linear_cross_entropy(
        h, w, lab, smoothing, padding_idx, chunk, logit_scale))
    return fwd, jax.jit(jax.grad(loss, argnums=(0, 1)))


@pytest.mark.parametrize("smoothing,padding_idx,chunk,logit_scale",
                         LCE_CASES)
def test_linear_cross_entropy(smoothing, padding_idx, chunk, logit_scale):
    """N 24, H 32, V 300: chunks of 128 (300 = 2 x 128 + 44), 64, 77 and
    one of 512 past V. Against JAX (loss, d hidden, d weight; 1e-5) and
    against the dense xentropy on ``hidden @ weight * logit_scale``."""
    n, h, v = 24, 32, 300
    hid, w = _np((n, h), 15), _np((h, v), 16, 0.3)
    lab = np.random.default_rng(17).integers(0, v, n).astype(np.int32)
    lab[:4] = 3   # rows at padding_idx
    r = _np((n,), 18)
    fwd, grad = _jax_lce(smoothing, padding_idx, chunk, logit_scale)
    want = fwd(jnp.asarray(hid), jnp.asarray(w), jnp.asarray(lab))
    gh, gw = grad(jnp.asarray(hid), jnp.asarray(w), jnp.asarray(lab),
                  jnp.asarray(r))
    ht = torch.from_numpy(hid).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    loss = linear_cross_entropy(ht, wt, torch.from_numpy(lab), smoothing,
                                padding_idx, chunk, logit_scale)
    (loss * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gh), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), atol=1e-5,
                               rtol=1e-5)
    if padding_idx is not None:
        assert not loss[:4].any() and not ht.grad[:4].any()
    # the dense head: the same function with the logits materialised
    h2 = torch.from_numpy(hid).requires_grad_(True)
    w2 = torch.from_numpy(w).requires_grad_(True)
    dense = softmax_cross_entropy_loss((h2 @ w2) * logit_scale,
                                       torch.from_numpy(lab), smoothing,
                                       padding_idx)
    (dense * torch.from_numpy(r)).sum().backward()
    torch.testing.assert_close(loss.detach(), dense.detach(), atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(ht.grad, h2.grad, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(wt.grad, w2.grad, atol=1e-5, rtol=1e-5)


def test_linear_cross_entropy_refuses_a_zero_chunk():
    with pytest.raises(ValueError, match="chunk"):
        linear_cross_entropy(torch.zeros(2, 4), torch.zeros(4, 5),
                             torch.zeros(2, dtype=torch.long), chunk=0)
