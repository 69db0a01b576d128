"""Port parity: BERT MLM pretraining (apex_tpu_torch vs apex_tpu).

The flax BERT is initialised from a seed, its parameters converted with
``bert_params_from_jax``, and the same numpy token ids go through both
models: the logits, ``mlm_loss`` and the gradient of every parameter,
without and with an ``attn_mask`` (padding), on a 2-layer, hidden-128
configuration with head_dim 64 (the CUDA kernels' head size); then 3
``FusedLAMB`` steps on the configuration of the JAX package's own
``test_pretrain_with_fused_lamb_descends``. Everything in fp32
(``compute_dtype=float32`` on both sides) so the comparison is of the
algorithm, not of two frameworks' bf16 rounding.

Tolerances: logits 1e-4 absolute; losses 1e-5; gradients 1e-5 absolute
plus 1e-3 relative (sums of products in other orders through two layers
and a vocabulary-wide softmax); parameters after 3 LAMB steps
2e-5 absolute plus 1e-4 relative (the trust ratios divide two norms of
the gradients above).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.bert import (Bert as JaxBert, BertConfig as
                                  JaxBertConfig, mlm_loss as jax_mlm_loss)
from apex_tpu.optimizers.fused_lamb import FusedLAMB as JaxFusedLAMB
from apex_tpu_torch.models.bert import Bert, BertConfig, mlm_loss
from apex_tpu_torch.models.convert import (bert_params_from_jax,
                                           bert_params_to_jax,
                                           init_bert_params)
from apex_tpu_torch.optimizers import FusedLAMB

SMALL = dict(vocab_size=256, max_position_embeddings=64, hidden_size=128,
             num_hidden_layers=2, num_attention_heads=2,
             intermediate_size=256)
# tests/test_models.py::TestBert::test_pretrain_with_fused_lamb_descends
LAMB_CFG = dict(vocab_size=64, max_position_embeddings=32, hidden_size=32,
                num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=64)


def _configs(widths):
    return (JaxBertConfig(**widths, compute_dtype=jnp.float32),
            BertConfig(**widths, compute_dtype=torch.float32))


def _models(widths, ids, seed):
    jcfg, tcfg = _configs(widths)
    jmodel = JaxBert(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(seed),
                                   jnp.asarray(ids))
    tparams = bert_params_from_jax(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, Bert.from_params(tcfg, tparams, device="cpu")


def _batch(b, s, vocab, seed):
    """ids, MLM labels (15 % of positions keep their token, the rest -1;
    those positions read id 3) and a padding mask (1 = real token)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, (b, s)).astype(np.int32)
    pick = rng.random((b, s)) < 0.15
    pick[:, 0] = True
    labels = np.where(pick, ids, -1).astype(np.int32)
    inputs = np.where(pick, 3, ids).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, s - 20:] = 0
    return inputs, labels, mask


def _grads_close(tmodel, jgrads):
    want = bert_params_from_jax(jax.tree.map(np.asarray, jgrads))
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        if g is None:   # token types unused: JAX gives zeros
            assert not np.any(want[name].numpy()), name
            continue
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5,
                                   rtol=1e-3, err_msg=name)


def test_logits_mlm_loss_and_every_gradient_match_jax():
    ids, labels, _ = _batch(2, 48, SMALL["vocab_size"], 0)
    jmodel, jparams, tmodel = _models(SMALL, ids, 1)
    lj, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_mlm_loss(jmodel, p, jnp.asarray(ids),
                               jnp.asarray(labels))))(jparams)
    tids = torch.from_numpy(ids).long()
    lt = mlm_loss(tmodel, tids, torch.from_numpy(labels).long())
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), atol=1e-5, rtol=0)
    _grads_close(tmodel, jgrads)
    with torch.no_grad():
        np.testing.assert_allclose(
            tmodel(tids).numpy(),
            np.asarray(jax.jit(jmodel.apply)(jparams, jnp.asarray(ids))),
            atol=1e-4, rtol=0)


def test_masked_logits_and_gradients_match_jax():
    """``attn_mask`` (the second sequence's last 20 tokens are padding)
    through the flash kernels' mask operand; loss = the MLM loss of the
    logits at the labelled positions."""
    ids, labels, mask = _batch(2, 48, SMALL["vocab_size"], 2)
    jmodel, jparams, tmodel = _models(SMALL, ids, 3)
    w = np.where(labels >= 0, 1.0, 0.0).astype(np.float32)

    def jloss(p):
        logits = jmodel.apply(p, jnp.asarray(ids), attn_mask=jnp.asarray(
            mask))
        lse = jax.nn.logsumexp(logits, axis=-1)
        picked = jnp.take_along_axis(
            logits, jnp.asarray(np.maximum(labels, 0))[..., None],
            axis=-1)[..., 0]
        return jnp.sum((lse - picked) * w), logits

    (lj, logits_j), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jparams)
    logits_t = tmodel(torch.from_numpy(ids).long(),
                      attn_mask=torch.from_numpy(mask))
    tlab = torch.from_numpy(np.maximum(labels, 0)).long()
    lt = ((torch.logsumexp(logits_t, -1)
           - logits_t.gather(-1, tlab[..., None])[..., 0])
          * torch.from_numpy(w)).sum()
    lt.backward()
    np.testing.assert_allclose(logits_t.detach().numpy(),
                               np.asarray(logits_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    _grads_close(tmodel, jgrads)


def test_three_fused_lamb_steps_match_the_jax_loop():
    """The JAX package's BERT + FusedLAMB loop (lr 5e-3, labels = ids),
    3 steps, flat LAMB on both sides: the losses and every parameter."""
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 64, (4, 32)).astype(np.int32)
    jmodel, jparams, tmodel = _models(LAMB_CFG, ids, 5)
    jopt = JaxFusedLAMB(jparams, lr=5e-3)
    named = dict(tmodel.named_parameters())
    topt = FusedLAMB(named, lr=5e-3)
    with torch.no_grad():
        for name, view in topt.parameters.items():
            named[name].data = view     # train in place
    grads_fn = jax.jit(jax.value_and_grad(
        lambda p: jax_mlm_loss(jmodel, p, jnp.asarray(ids),
                               jnp.asarray(ids))))
    tids = torch.from_numpy(ids).long()
    p = jopt.parameters
    for _ in range(3):
        lj, g = grads_fn(p)
        p = jopt.step(g)
        for t in named.values():
            t.grad = None
        lt = mlm_loss(tmodel, tids, tids)
        lt.backward()
        topt.step({n: t.grad if t.grad is not None else torch.zeros_like(t)
                   for n, t in named.items()})
        np.testing.assert_allclose(lt.item(), float(lj), atol=1e-5, rtol=0)
    want = bert_params_from_jax(jax.tree.map(np.asarray, p))
    for name, t in named.items():
        np.testing.assert_allclose(t.detach().numpy(), want[name].numpy(),
                                   atol=2e-5, rtol=1e-4, err_msg=name)


def test_converters_round_trip_and_init_matches_the_flax_tree():
    ids = np.zeros((1, 8), np.int32)
    jcfg, tcfg = _configs(SMALL)
    jparams = jax.tree.map(np.asarray, jax.jit(JaxBert(jcfg).init)(
        jax.random.PRNGKey(0), jnp.asarray(ids)))
    tparams = bert_params_from_jax(jparams)
    back = bert_params_to_jax(tparams)
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_b[path], leaf)
    mine = init_bert_params(tcfg, seed=0)
    assert {k: tuple(v.shape) for k, v in mine.items()} \
        == {k: tuple(v.shape) for k, v in tparams.items()}
    assert all(v.dtype == torch.float32 for v in mine.values())
    assert torch.equal(mine["layer.1.mlp_norm.weight"], torch.ones(128))
    assert torch.equal(mine["layer.0.qkv.bias"], torch.zeros(384))
    model = Bert.from_params(tcfg, mine, device="cpu")
    assert dataclasses.asdict(model.cfg) == dataclasses.asdict(tcfg)


def test_large_config_has_the_published_widths():
    c = BertConfig.large()
    assert (c.vocab_size, c.max_position_embeddings, c.hidden_size,
            c.num_hidden_layers, c.num_attention_heads, c.intermediate_size,
            c.type_vocab_size) == (30522, 512, 1024, 24, 16, 4096, 2)
    assert dataclasses.asdict(c) != dataclasses.asdict(BertConfig.tiny())
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            Bert(BertConfig.tiny())
