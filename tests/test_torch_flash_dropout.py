"""Port parity: flash attention's dropout and differentiated-bias forms
(apex_tpu_torch vs apex_tpu).

- The keep mask: the port's ``dropout_keep`` against the JAX kernels'
  ``_dropout_keep``, bit for bit, over seeds (negative, 0, 2**31 - 1,
  -2**31), flat batch * head indices, block offsets and rates 0.1 / 0.5 /
  0.9.
- Forward (o, lse) and backward (dq, dk, dv) with dropout: the port's
  ``flash_attention_fwd`` / ``flash_attention_bwd`` on CPU tensors (the
  kernels' plain versions) against the JAX Pallas kernels in interpret
  mode (block_q=64, block_k=128), causal and not, ragged sq != sk, with
  and without a (b, 1, 1, sk) key-padding mask. fp32: 2e-5 on o and lse,
  1e-4 on the gradients (the JAX kernels sum block by block, the plain
  versions over whole rows); bf16: o 2e-2, lse 1e-3, gradients 2e-2 plus
  2^-6 relative, as the dropout-free bf16 cases of
  ``test_torch_flash_attention.py`` (a bf16 rounding of p or ds can land
  one ulp apart).
- A one-hot v (sk = 64 keys, v[j] = e_j): o is p times its keep factor
  over the row sum, so its zero pattern is the keep mask, held exactly
  against ``dropout_keep`` and against JAX's o.
- dbias: gradients of a weighted sum of the public op with respect to a
  differentiated bias, against ``jax.grad``, for bias shapes (1, h, sq,
  sk), (b, 1, 1, sk), (1, 1, sq, sk) and (b, h, sq, sk), with and without
  a mask (fp32, 1e-4; q / k / v's gradients too); the raw backward's
  dlogits against the JAX dq kernel's.
- ``SelfMultiheadAttn`` / ``EncdecMultiheadAttn`` with ``dropout_p=0.1``
  and a seed against the flax modules on the converted weights: the
  output and every parameter's gradient (fp32, relative L2 1e-5).

Each JAX function is jitted once per shape and form (interpret mode
under jit runs the grid as one XLA loop).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.pallas.flash_attention import (
    _dropout_keep, flash_attention as jax_flash_attention,
    flash_attention_bwd as jax_flash_attention_bwd,
    flash_attention_fwd as jax_flash_attention_fwd)
from apex_tpu.transformer import mha as jmha
from apex_tpu_torch.models.convert import mha_params_from_jax
from apex_tpu_torch.ops.flash_attention import (dropout_keep,
                                                dropout_seed_tensor,
                                                dropout_threshold,
                                                flash_attention,
                                                flash_attention_bwd,
                                                flash_attention_fwd)
from apex_tpu_torch.transformer.mha import (EncdecMultiheadAttn,
                                            SelfMultiheadAttn)

D = 64
SCALE = 1.0 / math.sqrt(D)
BQ, BK = 64, 128
RATE = 0.1


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def _rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _pad_mask(b, sk, lens):
    return (np.arange(sk)[None, :] >= np.asarray(lens)[:, None]
            )[:, None, None, :]


# ---------------------------------------------------------- the keep mask

@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _jax_keep(seed, bh, qi, kj, p):
    return _dropout_keep(seed, bh, qi, kj, BQ, BK, p)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("seed", [-5, 0, 2 ** 31 - 1, -2 ** 31])
@pytest.mark.parametrize("bh,qi,kj", [(0, 0, 0), (3, 1, 2), (65599, 7, 3)])
def test_keep_mask_matches_jax_bit_for_bit(seed, bh, qi, kj, p):
    want = np.asarray(_jax_keep(jnp.asarray([seed], jnp.int32), bh, qi, kj,
                                p))
    got = dropout_keep(seed, bh, qi * BQ, kj * BK, BQ, BK, p).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # a one-element int32 tensor seed is the same seed
    t = dropout_keep(torch.tensor([seed], dtype=torch.int32), bh, qi * BQ,
                     kj * BK, BQ, BK, p)
    assert torch.equal(t, torch.from_numpy(got))


def test_keep_mask_rows_and_slices_do_not_depend_on_tiling():
    """A whole (bh, 200, 136) mask equals its tiles cut anywhere: the hash
    reads global rows and keys only."""
    whole = dropout_keep(9, torch.arange(3), 0, 0, 200, 136, 0.3)
    assert whole.shape == (3, 200, 136)
    part = dropout_keep(9, 2, 17, 5, 50, 100, 0.3)
    assert torch.equal(part, whole[2, 17:67, 5:105])
    assert dropout_threshold(0.1) == 429496729
    assert dropout_threshold(1.0) == 2 ** 32 - 1
    kept = float((whole > 0).float().mean())
    assert abs(kept - 0.7) < 6 * math.sqrt(0.21 / whole.numel())


# ------------------------------------------------- forward and backward

@functools.lru_cache(maxsize=None)
def _jax_pair(causal, masked, dtype):
    """The JAX kernels' forward and backward with dropout, jitted."""
    def fwd(q, k, v, bias, seed):
        return jax_flash_attention_fwd(
            q, k, v, scale=SCALE, causal=causal,
            bias=bias if masked else None, dropout_p=RATE,
            dropout_seed=seed, block_q=BQ, block_k=BK, interpret=True)

    def bwd(q, k, v, o, lse, do, bias, seed):
        return jax_flash_attention_bwd(
            q, k, v, o, lse, do, scale=SCALE, causal=causal,
            bias=bias if masked else None, dropout_p=RATE,
            dropout_seed=seed, block_q=BQ, block_k=BK, interpret=True)[:3]

    return jax.jit(fwd), jax.jit(bwd)


FWD_BWD_CASES = [(True, False, "fp32"), (False, False, "fp32"),
                 (True, True, "fp32"), (False, True, "fp32"),
                 (True, False, "bf16"), (False, True, "bf16")]


@pytest.mark.parametrize("causal,masked,dt", FWD_BWD_CASES)
def test_dropout_fwd_bwd_match_pallas_kernels(causal, masked, dt):
    b, h, sq, sk = 2, 2, 200, 136
    q, k, v, do = (_np((b, h, s, D), i) for i, s in
                   enumerate((sq, sk, sk, sq)))
    bias = np.where(_pad_mask(b, sk, [sk, 77]), -1e30, 0.0) \
        .astype(np.float32)
    seed = -7
    jdt, tdt = ((jnp.float32, torch.float32) if dt == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    fwd, bwd = _jax_pair(causal, masked, dt)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in (q, k, v, do))
    jseed = jnp.asarray(seed, jnp.int32)
    oj, lj = fwd(jq, jk, jv, jnp.asarray(bias), jseed)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    tb = torch.from_numpy(bias) if masked else None
    ot, lt = flash_attention_fwd(tq, tk, tv, scale=SCALE, causal=causal,
                                 bias=tb, dropout_p=RATE, dropout_seed=seed)
    o_tol, l_tol = (2e-5, 2e-5) if dt == "fp32" else (2e-2, 1e-3)
    np.testing.assert_allclose(ot.float().numpy(),
                               np.asarray(oj.astype(jnp.float32)),
                               atol=o_tol, rtol=0)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=l_tol,
                               rtol=0)
    # the backward from the same o and lse on both sides
    jgrads = bwd(jq, jk, jv, oj, lj, jdo, jnp.asarray(bias), jseed)
    o_in = torch.from_numpy(np.array(oj.astype(jnp.float32))).to(tdt)
    tgrads = flash_attention_bwd(tq, tk, tv, o_in,
                                 torch.from_numpy(np.asarray(lj)), tdo,
                                 scale=SCALE, causal=causal, bias=tb,
                                 dropout_p=RATE, dropout_seed=seed)
    g_atol, g_rtol = (1e-4, 0) if dt == "fp32" else (2e-2, 2 ** -6)
    for name, tg, jg in zip(("dq", "dk", "dv"), tgrads, jgrads):
        assert tg.dtype == tdt, name
        np.testing.assert_allclose(tg.float().numpy(),
                                   np.asarray(jg.astype(jnp.float32)),
                                   atol=g_atol, rtol=g_rtol, err_msg=name)


def test_one_hot_v_shows_the_keep_mask_exactly():
    """sk = 64 keys and v[j] = e_j: o[i, j] = p_ij keep_ij / l_i, zero
    exactly where the entry is dropped (no p underflows at these
    scores), the same zeros in JAX's o; dropping changes neither l nor
    lse."""
    b, h, sq, sk = 2, 2, 96, 64
    q, k = _np((b, h, sq, D), 1, 0.3), _np((b, h, sk, D), 2, 0.3)
    v = np.broadcast_to(np.eye(sk, D, dtype=np.float32),
                        (b, h, sk, D)).copy()
    fwd, _ = _jax_pair(False, False, "fp32")
    oj, lj = fwd(*map(jnp.asarray, (q, k, v, np.zeros((1, 1, 1, 1),
                                                      np.float32))),
                 jnp.asarray(123, jnp.int32))
    ot, lt = flash_attention_fwd(*map(torch.from_numpy, (q, k, v)),
                                 scale=SCALE, causal=False, dropout_p=RATE,
                                 dropout_seed=123)
    keep = dropout_keep(123, torch.arange(b * h), 0, 0, sq, sk, RATE) \
        .view(b, h, sq, sk)
    assert torch.equal(ot == 0, keep == 0)
    assert np.array_equal(np.asarray(oj) == 0, (keep == 0).numpy())
    _, l0 = flash_attention_fwd(*map(torch.from_numpy, (q, k, v)),
                                scale=SCALE, causal=False)
    assert torch.equal(lt, l0)
    # o's kept entries are p / l times the keep factor
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=2e-5,
                               rtol=0)


def test_public_op_dropout_needs_a_seed_and_follows_it():
    q = torch.from_numpy(_np((1, 2, 40, D), 3))
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention(q, q, q, True, dropout_p=0.1)
    a = flash_attention(q, q, q, True, dropout_p=0.1, dropout_seed=1)
    b = flash_attention(q, q, q, True, dropout_p=0.1,
                        dropout_seed=torch.tensor(1, dtype=torch.int32))
    c = flash_attention(q, q, q, True, dropout_p=0.1, dropout_seed=2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    oj = jax_flash_attention(jnp.asarray(q.numpy()), jnp.asarray(q.numpy()),
                             jnp.asarray(q.numpy()), True, None, BQ, BK,
                             dropout_p=0.1, dropout_seed=1)
    np.testing.assert_allclose(a.numpy(), np.asarray(oj), atol=2e-5, rtol=0)


@pytest.mark.parametrize("wide", [2 ** 32 - 7, 2 ** 31 + 3, -2 ** 31 - 9])
def test_seed_tensor_wraps_to_int32_as_jax_does(wide):
    """An int64 seed tensor outside int32 wraps as ``jnp.asarray(seed,
    jnp.int32)`` does, in the mask and through the public op; a Python int
    outside int32 raises, as in JAX."""
    wrapped = int(np.asarray(jnp.asarray(np.array([wide], np.int64),
                                         jnp.int32))[0])
    seed = torch.tensor([wide], dtype=torch.int64)
    assert dropout_seed_tensor("t", seed, "cpu").tolist() == [wrapped]
    assert torch.equal(dropout_keep(seed, 3, 0, 0, 16, 16, 0.5),
                       dropout_keep(wrapped, 3, 0, 0, 16, 16, 0.5))
    q = torch.from_numpy(_np((1, 2, 24, D), 4))
    a = flash_attention(q, q, q, True, dropout_p=0.5, dropout_seed=seed)
    b = flash_attention(q, q, q, True, dropout_p=0.5, dropout_seed=wrapped)
    assert torch.equal(a, b)
    with pytest.raises(OverflowError):
        jnp.asarray(wide, jnp.int32)
    with pytest.raises(RuntimeError, match="overflow"):
        dropout_seed_tensor("t", wide, "cpu")


# ------------------------------------------------------------------ dbias

B, HH, SQ, SK = 2, 2, 72, 96
BIAS_SHAPES = [(1, HH, SQ, SK), (B, 1, 1, SK), (1, 1, SQ, SK),
               (B, HH, SQ, SK)]


@functools.lru_cache(maxsize=None)
def _jax_dbias_grad(causal, masked, dropout):
    def loss(q, k, v, bias, mask, w):
        o = jax_flash_attention(q, k, v, causal, None, BQ, BK, bias=bias,
                                mask=mask if masked else None,
                                dropout_p=RATE if dropout else 0.0,
                                dropout_seed=5 if dropout else None)
        return jnp.sum(o * w)

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bshape", BIAS_SHAPES)
def test_dbias_matches_jax_grad(bshape, masked):
    """The public op with a differentiated bias (the default
    ``bias_requires_grad=True``): every gradient against ``jax.grad``,
    fp32 1e-4. Causal without the mask, full with it; the full bias shape
    also under dropout."""
    causal = not masked
    dropout = bshape == (B, HH, SQ, SK)
    q, k, v, w = (_np((B, HH, s, D), i + 20) for i, s in
                  enumerate((SQ, SK, SK, SQ)))
    bias = _np(bshape, 30)
    mask = _pad_mask(B, SK, [SK, 50])
    jgrads = _jax_dbias_grad(causal, masked, dropout)(
        *map(jnp.asarray, (q, k, v, bias, mask, w)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    o = flash_attention(*ts[:3], causal, bias=ts[3],
                        mask=torch.from_numpy(mask) if masked else None,
                        dropout_p=RATE if dropout else 0.0,
                        dropout_seed=5 if dropout else None)
    (o * torch.from_numpy(w)).sum().backward()
    for name, t, jg in zip(("dq", "dk", "dv", "dbias"), ts, jgrads):
        assert t.grad.shape == t.shape, name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   atol=1e-4, rtol=0, err_msg=name)


def test_raw_dlogits_match_the_jax_dq_kernel():
    """``flash_attention_bwd(want_dbias=True)``'s fp32 dlogits ``(b, h, sq,
    sk)`` against ``flash_attention_bwd``'s reduced dbias at the full
    bias shape (the JAX dq kernel's dlogits unreduced), causal with
    dropout: zero above the diagonal."""
    q, k, v, do = (_np((B, HH, s, D), i + 40) for i, s in
                   enumerate((SQ, SK, SK, SQ)))
    bias = _np((B, HH, SQ, SK), 41)
    jargs = dict(scale=SCALE, causal=True, bias=jnp.asarray(bias),
                 dropout_p=RATE, dropout_seed=jnp.asarray(3, jnp.int32),
                 block_q=BQ, block_k=BK, interpret=True)
    oj, lj = jax.jit(lambda *a: jax_flash_attention_fwd(*a, **jargs))(
        *map(jnp.asarray, (q, k, v)))
    jd = jax.jit(lambda *a: jax_flash_attention_bwd(
        *a, want_dbias=True, **jargs)[3])(*map(jnp.asarray, (q, k, v)), oj,
                                          lj, jnp.asarray(do))
    got = flash_attention_bwd(
        *map(torch.from_numpy, (q, k, v)),
        torch.from_numpy(np.asarray(oj)), torch.from_numpy(np.asarray(lj)),
        torch.from_numpy(do), scale=SCALE, causal=True,
        bias=torch.from_numpy(bias), dropout_p=RATE, dropout_seed=3,
        want_dbias=True)
    assert len(got) == 4 and got[3].shape == (B, HH, SQ, SK)
    assert got[3].dtype == torch.float32
    np.testing.assert_allclose(got[3].numpy(), np.asarray(jd), atol=1e-4,
                               rtol=0)
    above = torch.ones(SQ, SK, dtype=torch.bool).triu(1)
    assert bool((got[3][..., above] == 0).all())
    # no bias: no dlogits, as in JAX
    assert flash_attention_bwd(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(np.asarray(oj)),
        torch.from_numpy(np.asarray(lj)), torch.from_numpy(do), scale=SCALE,
        causal=True, want_dbias=True)[3] is None


# ---------------------------------------------------------------- modules

E, H = 128, 2


def _grads_vs(named_grads, jax_grads):
    want = mha_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                      jax_grads))
    assert set(want) == set(named_grads)
    return max(_rel_l2(named_grads[n], want[n]) for n in want)


def test_self_attention_with_dropout_matches_flax():
    """Causal with RoPE, ``dropout_p=0.1``, seed 11: training mode, whose
    output differs from eval mode (no seed)."""
    s = 24
    model = jmha.SelfMultiheadAttn(E, H, causal=True, use_rope=True,
                                   dropout_p=RATE)
    x, r = _np((2, s, E), 5), _np((2, s, E), 6)
    params = jax.jit(model.init)(jax.random.PRNGKey(3), jnp.asarray(x))
    seed = jnp.asarray(11, jnp.int32)

    def loss(p, xx, rr):
        return jnp.sum(model.apply(p, xx, None, seed) * rr)

    want = jax.jit(lambda p, xx: model.apply(p, xx, None, seed))(
        params, jnp.asarray(x))
    gj = jax.jit(jax.grad(loss))(params, jnp.asarray(x), jnp.asarray(r))
    mod = SelfMultiheadAttn(E, H, causal=True, use_rope=True,
                            dropout_p=RATE, device="cpu")
    mod.load_state_dict(mha_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    out = mod(torch.from_numpy(x), dropout_seed=11)
    (out * torch.from_numpy(r)).sum().backward()
    assert _rel_l2(out.detach().numpy(), want) <= 1e-5
    got = {n: p.grad.numpy() for n, p in mod.named_parameters()}
    assert _grads_vs(got, gj) <= 1e-5
    assert _rel_l2(mod(torch.from_numpy(x)).detach().numpy(), want) > 1e-2


def test_encdec_attention_with_dropout_matches_flax():
    """A (2, 1, 1, sk) key-padding mask, ``dropout_p=0.1``, a seed tensor."""
    sq, sk = 16, 24
    model = jmha.EncdecMultiheadAttn(E, H, dropout_p=RATE)
    qx, kvx, r = _np((2, sq, E), 7), _np((2, sk, E), 8), _np((2, sq, E), 9)
    m = _pad_mask(2, sk, [sk, 7])
    params = jax.jit(model.init)(jax.random.PRNGKey(4), jnp.asarray(qx),
                                 jnp.asarray(kvx))
    seed = jnp.asarray(-3, jnp.int32)

    def loss(p, q, kv, mm, rr):
        return jnp.sum(model.apply(p, q, kv, mm, seed) * rr)

    args = tuple(map(jnp.asarray, (qx, kvx, m)))
    want = jax.jit(lambda p, *a: model.apply(p, *a, seed))(params, *args)
    gj = jax.jit(jax.grad(loss))(params, *args, jnp.asarray(r))
    mod = EncdecMultiheadAttn(E, H, dropout_p=RATE, device="cpu")
    mod.load_state_dict(mha_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    out = mod(torch.from_numpy(qx), torch.from_numpy(kvx),
              torch.from_numpy(m),
              dropout_seed=torch.tensor(-3, dtype=torch.int32))
    (out * torch.from_numpy(r)).sum().backward()
    assert _rel_l2(out.detach().numpy(), want) <= 1e-5
    got = {n: p.grad.numpy() for n, p in mod.named_parameters()}
    assert _grads_vs(got, gj) <= 1e-5
