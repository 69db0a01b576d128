"""Port parity: GPT-2 (apex_tpu_torch vs apex_tpu) on ``GPT2Config.tiny()``
in fp32.

One flax init, converted to numpy, feeds both models
(``params_from_jax``). The full forward (Pallas kernels in interpret mode
on the JAX side, the kernels' plain versions on the port side) is held to
1e-4 on the logits; one serving decode step over a seeded cache is held
to 1e-4 on the logits and 1e-5 on the cache rows it writes, with every
other cache byte unchanged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.gpt2 import (GPT2 as JaxGPT2, GPT2Config as
                                  JaxGPT2Config, gpt2_token_forward as
                                  jax_gpt2_token_forward)
from apex_tpu.serve.kv_cache import KVCache as JaxKVCache
from apex_tpu_torch.models.convert import init_gpt2_params, params_from_jax
from apex_tpu_torch.models.gpt2 import (GPT2, GPT2Config, gpt2_token_forward,
                                       in_dtype)
from apex_tpu_torch.serve.kv_cache import KVCache

JCFG = dataclasses.replace(JaxGPT2Config.tiny(), compute_dtype=jnp.float32)
TCFG = dataclasses.replace(GPT2Config.tiny(), compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def jax_params():
    model = JaxGPT2(JCFG)
    return model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))


@pytest.fixture(scope="module")
def port_model(jax_params):
    tree = jax.tree.map(np.asarray, jax_params)
    return GPT2.from_params(TCFG, params_from_jax(tree), device="cpu")


def test_config_presets_match():
    for name in ("tiny", "small", "xl"):
        j, t = getattr(JaxGPT2Config, name)(), getattr(GPT2Config, name)()
        for f in ("vocab_size", "n_positions", "n_embd", "n_layer",
                  "n_head"):
            assert getattr(j, f) == getattr(t, f), (name, f)
        assert t.compute_dtype == torch.bfloat16


@pytest.mark.parametrize("offset", [0, 5])
def test_full_forward_matches_jax(jax_params, port_model, offset):
    rng = np.random.default_rng(offset)
    tokens = rng.integers(0, TCFG.vocab_size, (2, 24), dtype=np.int32)
    lj = JaxGPT2(JCFG).apply(jax_params, jnp.asarray(tokens),
                             position_offset=offset)
    with torch.no_grad():
        lt = port_model(torch.from_numpy(tokens).long(),
                        position_offset=offset)
    assert lt.shape == (2, 24, TCFG.vocab_size) and lt.dtype == torch.float32
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("write", ["load_state_dict", "copy_"])
@torch.no_grad()
def test_compute_dtype_copies_are_kept_until_written(write):
    """Without autograd (as serving runs) the bf16 copies the matrix
    products read are made once, reused on the next forward, and made
    again after the fp32 parameter changes."""
    cfg = dataclasses.replace(TCFG, n_layer=1)
    old, new = init_gpt2_params(cfg, seed=1), init_gpt2_params(cfg, seed=2)
    cfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    model = GPT2.from_params(cfg, old, device="cpu")
    tokens = torch.arange(8).reshape(1, 8)
    model(tokens)
    wte = in_dtype(model, "wte", torch.bfloat16)
    model(tokens)
    assert in_dtype(model, "wte", torch.bfloat16) is wte
    assert in_dtype(model, "wte", torch.float32) is model.wte
    if write == "load_state_dict":
        model.load_state_dict(new)
    else:
        for name, p in model.named_parameters():
            p.copy_(new[name])
    assert in_dtype(model, "wte", torch.bfloat16) is not wte
    fresh = GPT2.from_params(cfg, new, device="cpu")
    torch.testing.assert_close(model(tokens), fresh(tokens), atol=0, rtol=0)


def test_compute_dtype_casts_are_graph_ops_under_autograd():
    """While autograd records, each cast is a fresh graph op (so the
    gradient reaches the fp32 parameter) and nothing is cached; the
    gradients of a bf16-compute model are fp32 and finite."""
    cfg = dataclasses.replace(GPT2Config.tiny(), n_layer=1)
    model = GPT2.from_params(cfg, init_gpt2_params(cfg, seed=1),
                             device="cpu")
    a = in_dtype(model, "wte", torch.bfloat16)
    assert a.requires_grad and a.grad_fn is not None
    assert in_dtype(model, "wte", torch.bfloat16) is not a
    assert "_casts" not in model.__dict__
    model(torch.arange(8).reshape(1, 8)).float().mean().backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name


def test_hidden_states_match_jax(jax_params, port_model):
    tokens = np.arange(16, dtype=np.int32).reshape(1, 16)
    hj = JaxGPT2(JCFG).apply(jax_params, jnp.asarray(tokens),
                             return_hidden=True)
    with torch.no_grad():
        ht = port_model(torch.from_numpy(tokens).long(), return_hidden=True)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-4,
                               rtol=0)


def test_token_forward_step_matches_jax(jax_params, port_model):
    """One decode step: 3 slots, slot 1 masked off, on a cache filled
    with seeded random K/V."""
    c = TCFG
    h, d = c.n_head, c.n_embd // c.n_head
    slots, max_len = 3, 32
    rng = np.random.default_rng(1)
    shape = (c.n_layer, slots, max_len, h, d)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    lengths = np.array([5, 9, 0], np.int32)
    tokens = np.array([3, 700, 42], np.int32)
    mask = np.array([True, False, True])
    positions = lengths.copy()

    jcache = JaxKVCache(k=jnp.asarray(k0), v=jnp.asarray(v0),
                        lengths=jnp.asarray(lengths))
    lj, jcache = jax_gpt2_token_forward(
        JCFG, jax_params, jcache, jnp.asarray(tokens),
        jnp.asarray(positions), jnp.asarray(mask), block_k=16)
    tcache = KVCache(k=torch.from_numpy(k0.copy()),
                     v=torch.from_numpy(v0.copy()),
                     lengths=torch.from_numpy(lengths.copy()))
    with torch.no_grad():
        lt, tcache = gpt2_token_forward(
            TCFG, port_model, tcache, torch.from_numpy(tokens).long(),
            torch.from_numpy(positions), torch.from_numpy(mask), block_k=16)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                               rtol=0)
    for port_buf, jax_buf, before in ((tcache.k, jcache.k, k0),
                                      (tcache.v, jcache.v, v0)):
        port_buf = port_buf.numpy()
        np.testing.assert_allclose(port_buf, np.asarray(jax_buf),
                                   atol=1e-5, rtol=0)
        written = np.zeros(shape[:3], bool)
        for s in np.flatnonzero(mask):
            written[:, s, positions[s]] = True
        np.testing.assert_array_equal(port_buf[~written], before[~written])


def test_init_gpt2_params_shapes_and_distributions(jax_params):
    """The torch init has the flax tree's shapes (after the layout
    change of params_from_jax) and its distributions."""
    tree = params_from_jax(jax.tree.map(np.asarray, jax_params))
    ours = init_gpt2_params(TCFG, seed=0)
    assert ours.keys() == tree.keys()
    for name, t in ours.items():
        assert t.shape == tree[name].shape and t.dtype == torch.float32, \
            name
    assert abs(ours["wte"].std().item() - 0.02) < 1e-3
    assert abs(ours["wpe"].std().item() - 0.01) < 1e-3
    w = ours["h.0.attn_qkv.weight"]   # lecun normal: var 1 / fan_in
    assert abs(w.std().item() - (1.0 / TCFG.n_embd) ** 0.5) < 2e-3
    assert w.abs().max().item() <= 2.0 * (1.0 / TCFG.n_embd) ** 0.5 \
        / 0.87962566103423978 + 1e-6
    assert torch.equal(ours["h.1.ln_2.weight"], torch.ones(TCFG.n_embd))
    assert torch.equal(ours["h.1.mlp_fc_b"], torch.zeros(4 * TCFG.n_embd))
    again = init_gpt2_params(TCFG, seed=0)
    assert all(torch.equal(again[k], ours[k]) for k in ours)
