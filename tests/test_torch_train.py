"""Port parity: GPT-2 training (apex_tpu_torch vs apex_tpu) on
``GPT2Config.tiny()`` in fp32.

One flax init, converted to numpy, feeds both sides (``params_from_jax``;
gradients and moments come back with ``params_to_jax``).

- ``lm_loss`` and every gradient against ``jax.value_and_grad(lm_loss)``
  (Pallas kernels in interpret mode on the JAX side, the kernels' plain
  versions on the port's): loss to 1e-5 relative, each gradient leaf to
  1e-4 relative L2 (fp32 sums in other orders through 2 layers).
- 3 ``Trainer`` steps against the JAX ``Trainer(loss_fn=...)`` on the same
  initial parameters and batches, with 2 gradient shards and a forced
  overflow at step 1: the same losses (1e-5 relative), the same skipped
  step, the scaler state exactly, and parameters, m and v per leaf to
  1e-4 relative L2. One slice is held differently: the key third of
  each ``attn_qkv`` bias has an exact gradient of zero (the softmax does
  not change when a constant is added to every score of a row), so both
  sides see only rounding noise there, and Adam, which divides by
  sqrt(v), turns noise into updates of up to lr of either sign. That
  slice is held to |Δ| <= 2 lr per applied step.
- A train step, and the pytree helpers it runs on, free what they
  allocate without Python's garbage collector: no tensor is left in a
  reference cycle (on the card such a cycle held flat gradient copies
  until a collection ran).
"""

import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.gpt2 import (GPT2 as JaxGPT2, GPT2Config as
                                  JaxGPT2Config, lm_loss as jax_lm_loss)
from apex_tpu.train import TrainConfig as JaxTrainConfig, Trainer as \
    JaxTrainer
from apex_tpu_torch.models.convert import (init_gpt2_params,
                                           params_from_jax, params_to_jax)
from apex_tpu_torch.models.gpt2 import GPT2, GPT2Config, in_dtype, lm_loss
from apex_tpu_torch.ops import _build
from apex_tpu_torch.train import TrainConfig, Trainer
from apex_tpu_torch.utils.tree import tree_flatten, tree_map

JCFG = dataclasses.replace(JaxGPT2Config.tiny(), compute_dtype=jnp.float32)
TCFG = dataclasses.replace(GPT2Config.tiny(), compute_dtype=torch.float32)
JMODEL = JaxGPT2(JCFG)
SEQ = 32
LEAF_REL_L2 = 1e-4


@pytest.fixture(scope="module")
def jax_params():
    tree = JMODEL.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(np.asarray, tree)


def _port_model(jax_params):
    return GPT2.from_params(TCFG, params_from_jax(jax_params), device="cpu")


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _assert_trees_close(port_tree, jax_tree, noise_atol=None):
    """Each leaf to LEAF_REL_L2; with ``noise_atol``, the key third of the
    attn_qkv biases to that absolute limit instead (see the docstring)."""
    pl, jl = jax.tree_util.tree_leaves_with_path(port_tree), \
        jax.tree_util.tree_leaves(jax_tree)
    assert len(pl) == len(jl)
    e = TCFG.n_embd
    for (path, p), j in zip(pl, jl):
        name = jax.tree_util.keystr(path)
        p, j = np.asarray(p), np.asarray(j)
        assert p.shape == j.shape, name
        if noise_atol is not None and "attn_qkv']['bias" in name:
            np.testing.assert_allclose(p[e:2 * e], j[e:2 * e],
                                       atol=noise_atol, rtol=0)
            p, j = np.delete(p, np.s_[e:2 * e]), np.delete(j, np.s_[e:2 * e])
        assert _rel_l2(p, j) <= LEAF_REL_L2, (name, _rel_l2(p, j))


def _batch(step, n=4):
    rng = np.random.default_rng(100 + step)
    tokens = rng.integers(1, TCFG.vocab_size, (n, SEQ)).astype(np.int32)
    if step == 1:
        tokens[0, 0] = 0  # the marker the loss turns into an overflow
    return tokens


def test_lm_loss_and_every_gradient_match_jax(jax_params):
    tokens = _batch(0, n=2)
    lj, gj = jax.value_and_grad(
        lambda p: jax_lm_loss(JMODEL, p, jnp.asarray(tokens)))(
            jax.tree.map(jnp.asarray, jax_params))
    model = _port_model(jax_params)
    lt = lm_loss(model, torch.from_numpy(tokens).long())
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert all(g is not None for g in grads.values())
    _assert_trees_close(params_to_jax(grads), jax.tree.map(np.asarray, gj))


def test_trainer_tracks_jax_trainer_with_an_overflow_step(jax_params):
    steps, shards, lr = 3, 2, 1e-3

    def jloss(params, tokens):
        bad = jnp.where(tokens[0, 0] == 0, jnp.inf, 1.0)
        return jax_lm_loss(JMODEL, params, tokens) * bad

    def tloss(model, tokens):
        bad = torch.where(tokens[0, 0] == 0, float("inf"), 1.0)
        return lm_loss(model, tokens) * bad

    jt = JaxTrainer(
        JaxTrainConfig(steps=steps, batch=4, seq=SEQ, lr=lr,
                       grad_shards=shards, amp="dynamic"),
        loss_fn=jloss, init_params=jax_params,
        batch_fn=lambda t: jnp.asarray(_batch(t)))
    jlosses = []
    jrep = jt.run(on_step=lambda t, loss: jlosses.append(loss))

    model = _port_model(jax_params)
    tt = Trainer(TrainConfig(steps=steps, batch=4, seq=SEQ, lr=lr,
                             grad_shards=shards, amp="dynamic"),
                 loss_fn=tloss, init_params=model,
                 batch_fn=lambda t: torch.from_numpy(_batch(t)).long())
    tlosses = []
    _build.reset_launches()
    trep = tt.run(on_step=lambda t, loss: tlosses.append(loss))
    assert sum(_build.launches.values()) == 0  # CPU: plain versions only

    assert trep["final_step"] == jrep["final_step"] == steps - 1
    assert trep["skipped_steps"] == jrep["skipped_steps"] == 1
    assert np.isinf(tlosses[1]) and np.isinf(jlosses[1])
    np.testing.assert_allclose([tlosses[0], tlosses[2]],
                               [jlosses[0], jlosses[2]], rtol=1e-5)
    for port, ref in zip(tt.sstate, jt.sstate):
        assert port.item() == np.asarray(ref).item()
    assert tt.sstate.scale.item() == 2.0 ** 11  # backed off once
    params = {n: p for n, p in model.named_parameters()}
    _assert_trees_close(params_to_jax(params), jt.params,
                        noise_atol=2 * lr * (steps - 1))
    moments = tt.moments()
    _assert_trees_close(params_to_jax(moments["m"]), jt.m)
    _assert_trees_close(params_to_jax(moments["v"]), jt.v)


def test_overflow_step_leaves_the_model_bit_identical():
    cfg = dataclasses.replace(TCFG, n_layer=1)
    model = GPT2.from_params(cfg, init_gpt2_params(cfg, seed=3),
                             device="cpu")

    def loss_fn(m, tokens):
        return lm_loss(m, tokens) * float("nan")

    tr = Trainer(TrainConfig(steps=1, batch=2, seq=16),
                 loss_fn=loss_fn, init_params=model,
                 batch_fn=lambda t: torch.arange(32).reshape(2, 16))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    assert tr.run()["skipped_steps"] == 1
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), before[n]), n
    assert torch.count_nonzero(tr.m) == 0 and torch.count_nonzero(tr.v) == 0


def test_trained_weights_reach_the_serving_cache():
    """A bf16 model serves (its compute-dtype copies are cached), trains
    one step, and then serves exactly like a fresh model built from the
    trained weights: the update reaches the parameters and the caches."""
    cfg = dataclasses.replace(GPT2Config.tiny(), n_layer=1)
    model = GPT2.from_params(cfg, init_gpt2_params(cfg, seed=4),
                             device="cpu")
    tokens = torch.arange(24).reshape(2, 12)
    with torch.no_grad():
        stale = model(tokens)
        wte = in_dtype(model, "wte", torch.bfloat16)
    Trainer(TrainConfig(steps=1, batch=2, seq=12, lr=1e-2),
            loss_fn=lm_loss, init_params=model,
            batch_fn=lambda t: tokens).run()
    fresh = GPT2.from_params(
        cfg, {n: p.detach().clone() for n, p in
              model.state_dict().items()}, device="cpu")
    with torch.no_grad():
        assert in_dtype(model, "wte", torch.bfloat16) is not wte
        served = model(tokens)
        assert not torch.equal(served, stale)
        torch.testing.assert_close(served, fresh(tokens), atol=0, rtol=0)


@pytest.mark.parametrize("field,value", [
    ("world", 2), ("tp", 2), ("checkpoint_dir", "/nonexistent"),
    ("save_every", 5), ("telemetry_jsonl", "t.jsonl"),
    ("trace_jsonl", "t.json"), ("watchdog_timeout_s", 1.0),
    ("max_consecutive_overflows", 8), ("scale_floor", 2.0 ** -14)])
def test_later_slice_fields_raise(field, value):
    with pytest.raises(NotImplementedError, match=field):
        TrainConfig(**{field: value}).validate()


def test_config_refuses_bad_geometry():
    with pytest.raises(ValueError, match="divide"):
        TrainConfig(batch=6, grad_shards=4).validate()
    with pytest.raises(ValueError, match="amp"):
        TrainConfig(amp="static").validate()
    model = GPT2.from_params(TCFG, init_gpt2_params(TCFG), device="cpu")
    with pytest.raises(ValueError, match="loss_fn"):
        Trainer(TrainConfig(), loss_fn=None, init_params=model,
                batch_fn=lambda t: None)


def _cyclic_tensors(fn):
    """The tensors that ``fn()`` leaves in reference cycles: collected with
    every unreachable object saved, the collector off while it runs."""
    gc.collect()
    gc.disable()
    try:
        fn()
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        return [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()


def test_tree_helpers_hold_no_reference_cycle():
    """A mapped tree's new leaves and a flattened tree's leaves are freed
    when the caller drops them, without a collection."""
    def check():
        out = tree_map(lambda x: x * 2, {"a": torch.ones(3),
                                         "b": [torch.ones(2)]})
        mapped = weakref.ref(out["a"])
        leaves, _ = tree_flatten({"c": (torch.zeros(4),)})
        flat = weakref.ref(leaves[0])
        del out, leaves
        assert mapped() is None and flat() is None

    assert _cyclic_tensors(check) == []


def test_train_steps_leave_no_tensor_in_a_cycle():
    cfg = dataclasses.replace(TCFG, n_layer=1)
    model = GPT2.from_params(cfg, init_gpt2_params(cfg, seed=5),
                             device="cpu")
    tokens = torch.arange(32).reshape(2, 16)
    tr = Trainer(TrainConfig(steps=2, batch=2, seq=16),
                 loss_fn=lm_loss, init_params=model,
                 batch_fn=lambda t: tokens)
    assert _cyclic_tensors(tr.run) == []
