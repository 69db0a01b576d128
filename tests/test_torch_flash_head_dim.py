"""Port parity: flash attention at head dims other than 64 (apex_tpu_torch
vs apex_tpu).

The JAX kernels take any head dim (their blocks carry the whole d); the
port's CUDA kernels are compiled at d = 64, 128 and 256 and run any other
d up to 256 zero-padded to the next of them. On the CPU the port runs the
kernels' plain versions at any d, and these tests hold them, and the
padding the card route applies, against the JAX package:

- forward (o, lse) and backward (dq, dk, dv) at d in {16, 32, 48, 80, 96,
  128, 160, 192, 256}, fp32 and bf16, in three forms: causal and ragged
  (sq 72, sk 96), a learned (1, h, sq, sk) bias with the dq kernel's
  dlogits, and dropout (rate 0.1) under a (b, 1, 1, sk) key-padding
  mask; the port's
  ``flash_attention_fwd`` / ``flash_attention_bwd`` on CPU tensors
  against the Pallas kernels in interpret mode (block_q 64, block_k 128),
  both at the default scale 1 / sqrt(d). fp32: o and lse 2e-5, gradients
  1e-4, dlogits 2e-5 + 1e-4 |dl| (``chip_smoke.py``'s FA_TOL, FA_BWD_TOL
  and DLOGITS_TOL); bf16: as ``test_torch_flash_dropout.py`` holds the
  plain versions against the JAX kernels (o 2e-2, lse 1e-3, gradients
  2e-2 plus 2^-6 relative: the JAX kernels round p and ds to bf16 from
  block-wise sums, the plain versions from whole rows, so a value can
  land one bf16 ulp apart);
- the padding identity: the plain version on inputs zero-padded along d
  to ``fa_kernel_head_dim(d)``, with the caller's scale, sliced back,
  equals the plain version on the original inputs within 1e-6 (o, lse,
  dq, dk, dv, dlogits); ``fa_kernel_head_dim`` over 1 .. 257;
- GPT-2 at d = 256 (n_embd 512, 2 heads, 2 layers), d = 128 (n_embd 256,
  2 heads, 2 layers) and d = 80 (n_embd 160, 2 heads, 2 layers), fp32:
  ``lm_loss`` and every gradient against ``jax.value_and_grad`` of the
  JAX ``lm_loss`` on the same flax weights
  through ``models/convert.py`` (loss 1e-5 relative, each gradient 1e-4
  relative L2, as ``test_torch_train.py`` holds GPT-2 tiny).

Each JAX function is jitted once per (d, dtype, form).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.gpt2 import (GPT2 as JaxGPT2, GPT2Config as
                                  JaxGPT2Config, lm_loss as jax_lm_loss)
from apex_tpu.ops.pallas.flash_attention import (
    flash_attention_bwd as jax_flash_attention_bwd,
    flash_attention_fwd as jax_flash_attention_fwd)
from apex_tpu_torch.models.convert import params_from_jax, params_to_jax
from apex_tpu_torch.models.gpt2 import GPT2, GPT2Config, lm_loss
from apex_tpu_torch.ops.flash_attention import (flash_attention,
                                                flash_attention_bwd,
                                                flash_attention_bwd_plain,
                                                flash_attention_fwd,
                                                flash_attention_fwd_plain)
from apex_tpu_torch.ops.tiling import FA_HEAD_DIMS, fa_kernel_head_dim

HEAD_DIMS = [16, 32, 48, 80, 96, 128, 160, 192, 256]
FORMS = ["causal", "dbias", "dropout"]
BQ, BK = 64, 128
B, H, SQ, SK = 1, 2, 72, 96
RATE = 0.1
# (o, lse, gradients (atol, rtol), dlogits (atol, rtol)) of each dtype
TOLS = {"fp32": (2e-5, 2e-5, (1e-4, 0.0), (2e-5, 1e-4)),
        "bf16": (2e-2, 1e-3, (2e-2, 2 ** -6), (2e-5, 1e-4))}
LEAF_REL_L2 = 1e-4


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _inputs(d, form):
    """q, k, v, do, the bias (None, learned or a key-padding mask's -1e30)
    and whether the case is causal."""
    q, k, v, do = (_np((B, H, s, d), 10 * d + i) for i, s in
                   enumerate((SQ, SK, SK, SQ)))
    bias = None
    if form == "dbias":
        bias = _np((1, H, SQ, SK), d)
    elif form == "dropout":
        bias = np.where(np.arange(SK)[None, None, None, :] >= 61, -1e30,
                        0.0).astype(np.float32)
    return q, k, v, do, bias, form != "dropout"


def _kw(d, form, causal, bias):
    kw = dict(scale=1.0 / math.sqrt(d), causal=causal, bias=bias)
    if form == "dropout":
        kw.update(dropout_p=RATE, dropout_seed=-9)
    return kw


@functools.lru_cache(maxsize=None)
def _jax_pair(d, form, dt):
    """The JAX kernels' forward and backward for one (d, form, dtype),
    jitted (the backward's dlogits with a learned bias)."""
    causal = form != "dropout"
    jkw = dict(scale=1.0 / math.sqrt(d), causal=causal, block_q=BQ,
               block_k=BK, interpret=True)
    if form == "dropout":
        jkw.update(dropout_p=RATE,
                   dropout_seed=jnp.asarray(-9, jnp.int32))

    def fwd(q, k, v, bias):
        return jax_flash_attention_fwd(q, k, v, bias=bias, **jkw)

    def bwd(q, k, v, o, lse, do, bias):
        return jax_flash_attention_bwd(q, k, v, o, lse, do, bias=bias,
                                       want_dbias=form == "dbias", **jkw)

    return jax.jit(fwd), jax.jit(bwd)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_fwd_bwd_match_pallas_kernels(d, form, dt):
    q, k, v, do, bias, causal = _inputs(d, form)
    jdt, tdt = ((jnp.float32, torch.float32) if dt == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    fwd, bwd = _jax_pair(d, form, dt)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in (q, k, v, do))
    jb = None if bias is None else jnp.asarray(bias)
    oj, lj = fwd(jq, jk, jv, jb)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    tb = None if bias is None else torch.from_numpy(bias)
    kw = _kw(d, form, causal, tb)
    ot, lt = flash_attention_fwd(tq, tk, tv, **kw)
    o_tol, l_tol, (g_atol, g_rtol), (dl_atol, dl_rtol) = TOLS[dt]
    assert ot.shape == tq.shape and ot.dtype == tdt
    np.testing.assert_allclose(ot.float().numpy(),
                               np.asarray(oj.astype(jnp.float32)),
                               atol=o_tol, rtol=0)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=l_tol,
                               rtol=0)
    # the backward from the same o and lse on both sides
    jgrads = bwd(jq, jk, jv, oj, lj, jdo, jb)
    o_in = torch.from_numpy(np.array(oj.astype(jnp.float32))).to(tdt)
    tgrads = flash_attention_bwd(tq, tk, tv, o_in,
                                 torch.from_numpy(np.array(lj)), tdo,
                                 want_dbias=form == "dbias", **kw)
    for name, tg, jg in zip(("dq", "dk", "dv"), tgrads, jgrads):
        assert tg.dtype == tdt and tg.shape[-1] == d, name
        np.testing.assert_allclose(tg.float().numpy(),
                                   np.asarray(jg.astype(jnp.float32)),
                                   atol=g_atol, rtol=g_rtol, err_msg=name)
    if form == "dbias":
        # the JAX backward reduces the dlogits to the bias's shape, here
        # the full (1, h, sq, sk) of a batch of one: the dlogits as they are
        np.testing.assert_allclose(tgrads[3].numpy(), np.asarray(jgrads[3]),
                                   atol=dl_atol, rtol=dl_rtol)


def test_kernel_head_dim_over_every_d():
    """d itself where it is compiled, else the next compiled width; None
    above the widest; nothing below 1."""
    assert FA_HEAD_DIMS == (64, 128, 256)
    for d in range(1, 258):
        want = (64 if d <= 64 else 128 if d <= 128 else 256 if d <= 256
                else None)
        assert fa_kernel_head_dim(d) == want, d
    with pytest.raises(ValueError):
        fa_kernel_head_dim(0)


def _pad(t, width):
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_padding_is_exact(d, form):
    """What the card route does at a d that is not compiled, on the plain
    versions: zero columns up to ``fa_kernel_head_dim(d)`` with the
    caller's scale, then o, dq, dk, dv sliced back; lse and the dlogits as
    they are."""
    q, k, v, do, bias, causal = (
        None if a is None else torch.from_numpy(a) if isinstance(
            a, np.ndarray) else a for a in _inputs(d, form))
    kd = fa_kernel_head_dim(d)
    kw = _kw(d, form, causal, bias)
    o, lse = flash_attention_fwd_plain(q, k, v, **kw)
    op, lsep = flash_attention_fwd_plain(*(_pad(t, kd) for t in (q, k, v)),
                                         **kw)
    torch.testing.assert_close(op[..., :d], o, atol=1e-6, rtol=0)
    assert not op[..., d:].any()
    torch.testing.assert_close(lsep, lse, atol=1e-6, rtol=0)
    bkw = dict(kw, want_dbias=True)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, **bkw)
    got = flash_attention_bwd_plain(*(_pad(t, kd) for t in (q, k, v, o)),
                                    lse, _pad(do, kd), **bkw)
    for name, g, w in zip(("dq", "dk", "dv", "dlogits"), got, want):
        if w is None:
            assert g is None and bias is None, name
            continue
        if name != "dlogits":
            assert not g[..., d:].any(), name
            g = g[..., :d]
        torch.testing.assert_close(g, w, atol=1e-6, rtol=0, msg=name)


def test_public_op_scale_is_the_callers():
    """The default scale is 1 / sqrt of the caller's d (not of a padded
    width): the public op at d = 80 equals the raw forward at that scale
    and differs from it at 1 / sqrt(128)."""
    q, k, v, _, _, _ = _inputs(80, "causal")
    q, k, v = map(torch.from_numpy, (q, k, v))
    o = flash_attention(q, k, v, True)
    want, _ = flash_attention_fwd(q, k, v, scale=1 / math.sqrt(80),
                                  causal=True)
    other, _ = flash_attention_fwd(q, k, v, scale=1 / math.sqrt(128),
                                   causal=True)
    torch.testing.assert_close(o, want, atol=0, rtol=0)
    assert not torch.allclose(o, other, atol=1e-4)


# GPT-2 at d = 256, 128 and 80: (n_embd, n_head)
GPT2_WIDTHS = {256: (512, 2), 128: (256, 2), 80: (160, 2)}
SEQ = 40


@pytest.mark.parametrize("d", sorted(GPT2_WIDTHS))
def test_gpt2_loss_and_every_gradient_match_jax(d):
    e, nh = GPT2_WIDTHS[d]
    widths = dict(vocab_size=512, n_positions=64, n_embd=e, n_layer=2,
                  n_head=nh)
    jcfg = JaxGPT2Config(compute_dtype=jnp.float32, **widths)
    tcfg = GPT2Config(compute_dtype=torch.float32, **widths)
    jmodel = JaxGPT2(jcfg)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(d), jnp.zeros((1, 8), jnp.int32)))
    tokens = np.random.default_rng(d).integers(1, 512, (2, SEQ)) \
        .astype(np.int32)
    lj, gj = jax.jit(jax.value_and_grad(
        lambda p, t: jax_lm_loss(jmodel, p, t)))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(tokens))
    model = GPT2.from_params(tcfg, params_from_jax(params), device="cpu")
    assert model.h[0].cfg.n_embd // model.h[0].cfg.n_head == d
    lt = lm_loss(model, torch.from_numpy(tokens).long())
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert all(g is not None for g in grads.values())
    got = jax.tree_util.tree_leaves_with_path(params_to_jax(grads))
    want = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, gj))
    assert len(got) == len(want)
    for (path, g), w in zip(got, want):
        name = jax.tree_util.keystr(path)
        assert np.shape(g) == np.shape(w), name
        assert _rel_l2(g, w) <= LEAF_REL_L2, (name, _rel_l2(g, w))
