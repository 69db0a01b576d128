"""Port parity: the attention modules (apex_tpu_torch vs
apex_tpu.transformer.mha).

- ``mha_reference`` (no mask, a (b, 1, 1, sk) key-padding mask, causal)
  against JAX's, forward and ``jax.vjp``: fp32 within 1e-5 (fp32 logits
  and products summed in another order).
- ``SelfMultiheadAttn`` (RoPE on and off, causal on and off, a mask) and
  ``EncdecMultiheadAttn`` against the flax modules with the flax
  parameters converted (``mha_params_from_jax``): the output and every
  parameter's gradient of ``sum(out * r)``, fp32, relative L2 <= 1e-5.
- The converters' round trip; training with dropout against eval and the
  flax module; both modules at head_dim 48 (embed 96, 2 heads) against
  the flax modules, which build and run at any head dim.
- The module against its unfused twin (``linear_bias`` -> RoPE ->
  ``mha_reference`` -> ``linear_bias`` with the module's parameters) on
  the CPU, relative L2 <= 1e-5: the identity ``chip_smoke.py`` holds at
  GPT-2 XL width on the card.

Embed 128 with 2 heads of 64, sequences up to 24.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.transformer import mha as jmha
from apex_tpu_torch.models.convert import (mha_params_from_jax,
                                           mha_params_to_jax)
from apex_tpu_torch.transformer.fused_dense import linear_bias
from apex_tpu_torch.transformer.mha import (EncdecMultiheadAttn,
                                            SelfMultiheadAttn, apply_rope_bhsd,
                                            mha_reference, rope_tables)

E, H = 128, 2
REL_L2 = 1e-5


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def _rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _pad_mask(b, sk, lens):
    m = np.arange(sk)[None, :] >= np.asarray(lens)[:, None]
    return m[:, None, None, :]


@pytest.mark.parametrize("kind", ["none", "mask", "causal"])
def test_mha_reference_matches_jax(kind):
    b, h, sq, sk, d = 2, 2, 16, 16 if kind == "causal" else 24, 64
    q, k, v = _np((b, h, sq, d), 1), _np((b, h, sk, d), 2), \
        _np((b, h, sk, d), 3)
    do = _np((b, h, sq, d), 4)
    m = _pad_mask(b, sk, [sk, 9]) if kind == "mask" else None
    causal = kind == "causal"

    def jf(q, k, v):
        return jmha.mha_reference(q, k, v, causal=causal,
                                  mask=None if m is None else jnp.asarray(m))

    oj, vjp = jax.vjp(jax.jit(jf), *map(jnp.asarray, (q, k, v)))
    gj = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = mha_reference(*ts, causal=causal,
                      mask=None if m is None else torch.from_numpy(m))
    o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(oj), atol=1e-5)
    for t, g in zip(ts, gj):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5)


SELF_CASES = [(rope, causal, masked) for rope in (False, True)
              for causal in (False, True) for masked in (False, True)
              if not (causal and masked)]


@functools.lru_cache(maxsize=None)
def _jax_self(rope, causal, masked, s):
    model = jmha.SelfMultiheadAttn(E, H, causal=causal, use_rope=rope)
    x0 = jnp.zeros((2, s, E), jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(3), x0)

    def loss(p, x, m, r):
        return jnp.sum(model.apply(p, x, m if masked else None) * r)

    return params, jax.jit(model.apply), jax.jit(jax.grad(loss))


def _grads_vs(named_grads, jax_grads):
    want = mha_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                      jax_grads))
    assert set(want) == set(named_grads)
    return max(_rel_l2(named_grads[n], want[n]) for n in want)


@pytest.mark.parametrize("rope,causal,masked", SELF_CASES)
def test_self_attention_matches_flax(rope, causal, masked):
    s = 24
    params, apply, grad = _jax_self(rope, causal, masked, s)
    x, r = _np((2, s, E), 5), _np((2, s, E), 6)
    m = _pad_mask(2, s, [s, 13])
    mod = SelfMultiheadAttn(E, H, causal=causal, use_rope=rope,
                            device="cpu")
    mod.load_state_dict(mha_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    mt = torch.from_numpy(m) if masked else None
    out = mod(torch.from_numpy(x), mt)
    (out * torch.from_numpy(r)).sum().backward()
    want = apply(params, jnp.asarray(x), jnp.asarray(m) if masked else None)
    assert _rel_l2(out.detach().numpy(), want) <= REL_L2
    gj = grad(params, jnp.asarray(x), jnp.asarray(m), jnp.asarray(r))
    got = {n: p.grad.numpy() for n, p in mod.named_parameters()}
    assert _grads_vs(got, gj) <= REL_L2


def test_encdec_attention_matches_flax():
    sq, sk = 16, 24
    model = jmha.EncdecMultiheadAttn(E, H)
    qx, kvx, r = _np((2, sq, E), 7), _np((2, sk, E), 8), _np((2, sq, E), 9)
    m = _pad_mask(2, sk, [sk, 7])
    params = jax.jit(model.init)(jax.random.PRNGKey(4), jnp.asarray(qx),
                                 jnp.asarray(kvx))

    def loss(p, q, kv, mm, rr):
        return jnp.sum(model.apply(p, q, kv, mm) * rr)

    args = tuple(map(jnp.asarray, (qx, kvx, m)))
    want = jax.jit(model.apply)(params, *args)
    gj = jax.jit(jax.grad(loss))(params, *args, jnp.asarray(r))
    mod = EncdecMultiheadAttn(E, H, device="cpu")
    mod.load_state_dict(mha_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    assert {n for n, _ in mod.named_parameters()} == {
        "q.weight", "q.bias", "kv.weight", "kv.bias", "out.weight",
        "out.bias"}
    out = mod(torch.from_numpy(qx), torch.from_numpy(kvx),
              torch.from_numpy(m))
    (out * torch.from_numpy(r)).sum().backward()
    assert _rel_l2(out.detach().numpy(), want) <= REL_L2
    got = {n: p.grad.numpy() for n, p in mod.named_parameters()}
    assert _grads_vs(got, gj) <= REL_L2


def test_converters_round_trip():
    params, _, _ = _jax_self(True, True, False, 24)
    tree = jax.tree_util.tree_map(np.asarray, params)
    sd = mha_params_from_jax(tree)
    assert sd["qkv.weight"].shape == (3 * E, E)
    np.testing.assert_array_equal(sd["qkv.weight"].numpy(),
                                  tree["params"]["qkv"]["kernel"].T)
    back = mha_params_to_jax(sd)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_dropout_and_head_dim_refusals():
    """A seed with dropout_p > 0 trains with dropout: the output differs
    from eval mode and matches the flax module's with the same seed
    (relative L2 1e-5); without a seed dropout is off (eval), the same
    output as dropout_p 0; neither drops to rate 0 or to
    ``mha_reference``. Both modules at head_dim 48 (embed 96, 2 heads)
    build and match the flax modules (output and every gradient, at
    REL_L2), as the card's padded flash route must; a non-multiple embed
    still raises."""
    x = _np((1, 8, E), 10)
    model = jmha.SelfMultiheadAttn(E, H, causal=True, dropout_p=0.1)
    params = jax.jit(model.init)(jax.random.PRNGKey(5), jnp.asarray(x))
    mod = SelfMultiheadAttn(E, H, causal=True, dropout_p=0.1, device="cpu")
    mod.load_state_dict(mha_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    xt = torch.from_numpy(x)
    train = mod(xt, dropout_seed=3)
    want = model.apply(params, jnp.asarray(x), None,
                       jnp.asarray(3, jnp.int32))
    assert _rel_l2(train.detach().numpy(), want) <= REL_L2
    assert _rel_l2(train.detach().numpy(), mod(xt).detach().numpy()) > 1e-2
    ref = SelfMultiheadAttn(E, H, causal=True, device="cpu")
    ref.load_state_dict(mod.state_dict())
    torch.testing.assert_close(mod(xt), ref(xt), atol=0, rtol=0)
    ref(xt, dropout_seed=3)   # rate 0 with a seed runs, as in JAX
    enc = EncdecMultiheadAttn(E, H, dropout_p=0.2, device="cpu")
    assert not torch.equal(enc(xt, xt, dropout_seed=1), enc(xt, xt))
    e48, s = 96, 12
    x, kv, r = _np((2, s, e48), 13), _np((2, 16, e48), 14), \
        _np((2, s, e48), 15)
    m = _pad_mask(2, 16, [16, 5])
    for jcls, cls, args in (
            (functools.partial(jmha.SelfMultiheadAttn, causal=True),
             functools.partial(SelfMultiheadAttn, causal=True), (x,)),
            (jmha.EncdecMultiheadAttn, EncdecMultiheadAttn, (x, kv, m))):
        model = jcls(e48, H)
        jargs = tuple(map(jnp.asarray, args))
        params = jax.jit(model.init)(jax.random.PRNGKey(6), *jargs)

        def loss(p, rr, *a, model=model):
            return jnp.sum(model.apply(p, *a) * rr)

        want = jax.jit(model.apply)(params, *jargs)
        gj = jax.jit(jax.grad(loss))(params, jnp.asarray(r), *jargs)
        mod = cls(e48, H, device="cpu")
        assert mod.head_dim == 48
        mod.load_state_dict(mha_params_from_jax(
            jax.tree_util.tree_map(np.asarray, params)))
        out = mod(*map(torch.from_numpy, args))
        (out * torch.from_numpy(r)).sum().backward()
        assert _rel_l2(out.detach().numpy(), want) <= REL_L2
        got = {n: p.grad.numpy() for n, p in mod.named_parameters()}
        assert _grads_vs(got, gj) <= REL_L2
    with pytest.raises(ValueError, match="multiple"):
        SelfMultiheadAttn(130, 3, device="cpu")


def unfused_self_attention(mod, x):
    """``SelfMultiheadAttn``'s function without flash: the user loop of
    ``chip_smoke.py``'s megatron phase (``linear_bias`` -> RoPE ->
    ``mha_reference`` -> ``linear_bias``) on the module's parameters."""
    b, s, e = x.shape
    h, d = mod.num_heads, mod.head_dim
    qkv = linear_bias(x, mod.qkv.weight.to(x.dtype), mod.qkv.bias)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2)
               for t in qkv.split(e, dim=-1))
    if mod.use_rope:
        cos, sin = rope_tables(s, d, mod.rope_theta, x.device)
        q, k = apply_rope_bhsd(q, cos, sin), apply_rope_bhsd(k, cos, sin)
    o = mha_reference(q, k, v, causal=mod.causal)
    return linear_bias(o.transpose(1, 2).reshape(b, s, e),
                       mod.out.weight.to(x.dtype), mod.out.bias)


@pytest.mark.parametrize("rope", [False, True])
def test_module_matches_its_unfused_twin(rope):
    torch.manual_seed(1)
    mod = SelfMultiheadAttn(E, H, causal=True, use_rope=rope, device="cpu")
    x = torch.from_numpy(_np((2, 24, E), 11))
    r = torch.from_numpy(_np((2, 24, E), 12))
    out = mod(x)
    (out * r).sum().backward()
    g1 = {n: p.grad.clone() for n, p in mod.named_parameters()}
    mod.zero_grad()
    twin = unfused_self_attention(mod, x)
    (twin * r).sum().backward()
    assert _rel_l2(out.detach(), twin.detach()) <= REL_L2
    for n, p in mod.named_parameters():
        assert _rel_l2(g1[n], p.grad) <= REL_L2, n
