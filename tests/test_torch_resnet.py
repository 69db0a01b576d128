"""Port parity: ResNet training (apex_tpu_torch vs apex_tpu).

The flax ResNet is initialised from a seed, its variables converted with
``resnet_params_from_jax``, and the same numpy images and labels go
through both models with the loss of ``examples/imagenet/main_amp.py``
(``-mean(sum(log_softmax(logits) * onehot))``, written out on both sides
as the example does): the logits, the loss, the gradient of every
parameter and the new ``batch_stats`` of one training-mode forward, on
``ResNet18ish`` at 32 x 32, batch 4; then 3 flat ``FusedSGD`` steps of
the imagenet recipe (momentum 0.9, weight decay 1e-4) against the same
loop in JAX. The BatchNorm statistics are held on their own, including a
channel whose mean is 10^4 times its spread (where E[x^2] - E[x]^2 would
cancel).

Tolerances (fp32 compute on both sides, so the comparison is of the
algorithm, not of two frameworks' bf16 rounding): the loss 1e-4 relative
(1e-5 absolute); logits, gradients and ``batch_stats`` 1e-4 relative plus
1e-4 of each tensor's largest entry (convolutions sum in other orders,
and BatchNorm over the last stage's 4 values per channel divides by a
spread made of such sums); after 3 SGD steps, each parameter's and
running statistic's move from its start 1e-3 in relative L2 (each step's
gradient errors feed the next step's gradients). BatchNorm statistics
1e-5 relative (1e-6 absolute). With bf16 compute (the default) every
convolution rounds its operands and output to bf16 in both frameworks, at
other places, and the tiny model's BatchNorm amplifies it: JAX's own bf16
logits are 3-6 % (relative L2) from its fp32 ones. The port's bf16 logits
are held within twice JAX's own bf16 error of the fp32 logits, and within
10 % of JAX's bf16 logits. The converters round-trip exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from apex_tpu.models.resnet import (ResNet18ish as JaxResNet18ish,
                                    ResNet50 as JaxResNet50)
from apex_tpu.optimizers.fused_sgd import FusedSGD as JaxFusedSGD
from apex_tpu.parallel.sync_batch_norm import (
    SyncBatchNorm as JaxSyncBatchNorm, _welford_merge as jax_welford_merge,
    sync_batch_norm_stats as jax_sync_batch_norm_stats)
from apex_tpu_torch.models.convert import (init_resnet_params,
                                           resnet_params_from_jax,
                                           resnet_params_to_jax)
from apex_tpu_torch.models.resnet import ResNet18ish
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.parallel import SyncBatchNorm, sync_batch_norm_stats
from apex_tpu_torch.parallel.sync_batch_norm import _welford_merge

CLASSES = 10


def _batch(seed, b=4, hw=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, hw, hw, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, b).astype(np.int32)
    return x, y


@functools.lru_cache(maxsize=None)
def _jax(dtype):
    """The flax ResNet18ish of ``dtype`` compute and its jitted init,
    training-mode forward and loss-and-gradient, compiled once for the
    file."""
    model = JaxResNet18ish(num_classes=CLASSES, compute_dtype=dtype)

    def loss_fn(params, bstats, x, y):
        logits, mut = model.apply({"params": params, "batch_stats": bstats},
                                  x, mutable=["batch_stats"])
        onehot = jax.nn.one_hot(y, CLASSES)
        loss = -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot,
                                 axis=-1))
        return loss, (mut["batch_stats"], logits)

    forward = jax.jit(lambda v, x: model.apply(v, x, mutable=["batch_stats"]))
    return (model, jax.jit(model.init), forward,
            jax.jit(jax.value_and_grad(loss_fn, has_aux=True)))


def _jax_model(x, seed, dtype=jnp.float32):
    model, init, _, _ = _jax(dtype)
    variables = init(jax.random.PRNGKey(seed), jnp.asarray(x[:2]))
    return model, jax.tree.map(np.asarray, variables)


def _port_model(variables, dtype=torch.float32):
    model = ResNet18ish(num_classes=CLASSES, compute_dtype=dtype,
                        device="cpu")
    model.load_state_dict(resnet_params_from_jax(variables), strict=True)
    return model


def _port_loss(logits, y):
    onehot = F.one_hot(y.long(), CLASSES).float()
    return -(F.log_softmax(logits, dim=-1) * onehot).sum(dim=-1).mean()


def _close(port, ref, rtol=1e-4, atol=1e-5, err_msg=""):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32), rtol=rtol,
                               atol=atol, err_msg=err_msg)


def _stats(model):
    return {n: b for n, b in model.state_dict().items()
            if n.endswith((".mean", ".var"))}


@pytest.mark.parametrize("reduce_axes", [(0, 1, 2), (0, 2, 3)])
def test_batch_norm_stats_match_jax(reduce_axes):
    """Mean, biased variance and count, with one channel whose mean is
    1e4 and spread 1 and one constant channel (variance clamped at 0)."""
    rng = np.random.default_rng(0)
    shape = (4, 5, 6, 7) if reduce_axes == (0, 1, 2) else (4, 7, 5, 6)
    x = rng.standard_normal(shape).astype(np.float32)
    ch = [slice(None)] * 4
    ca = ({0, 1, 2, 3} - set(reduce_axes)).pop()
    ch[ca] = 2
    x[tuple(ch)] += 1e4
    ch[ca] = 5
    x[tuple(ch)] = 3.0
    jm, jv, jn = jax_sync_batch_norm_stats(jnp.asarray(x), reduce_axes)
    tm, tv, tn = sync_batch_norm_stats(torch.from_numpy(x), reduce_axes)
    _close(tm.numpy(), jm, rtol=1e-5, atol=1e-6)
    _close(tv.numpy(), jv, rtol=1e-5, atol=1e-6)
    assert float(tn) == float(jn) == x.size / x.shape[ca]
    assert float(tv[5]) == 0.0
    # the shifted formula keeps the large-mean channel's variance (~1)
    assert abs(float(tv[2]) - float(np.var(x[tuple(
        slice(None) if a != ca else 2 for a in range(4))]
        .astype(np.float64)))) < 1e-3


def test_welford_merge_matches_jax():
    rng = np.random.default_rng(1)
    a = [rng.standard_normal(6).astype(np.float32) for _ in range(4)]
    na, nb = np.float32(5.0), np.float32(0.0)
    for n_b in (nb, np.float32(7.0)):
        args = (a[0], np.abs(a[1]), na, a[2], np.abs(a[3]), n_b)
        want = jax_welford_merge(*map(jnp.asarray, args))
        got = _welford_merge(*map(torch.as_tensor, args))
        for g, w in zip(got, want):
            _close(g.numpy(), w, rtol=1e-6, atol=0)


@pytest.mark.parametrize("fuse_relu", [False, True])
def test_sync_batch_norm_module_matches_flax(fuse_relu):
    """Training-mode output and the new running statistics, then an
    evaluation-mode output from them; bf16 input comes back bf16."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 4, 4, 8)) * 2 + 1).astype(np.float32)
    jbn = JaxSyncBatchNorm(8, axis_name=None, fuse_relu=fuse_relu)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    w = rng.standard_normal(8).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    variables = {"params": {"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                 "batch_stats": variables["batch_stats"]}
    jy, mut = jbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = SyncBatchNorm(8, fuse_relu=fuse_relu, device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    ty = bn(torch.from_numpy(x))
    _close(ty.detach().numpy(), jy)
    _close(bn.mean.numpy(), mut["batch_stats"]["mean"])
    _close(bn.var.numpy(), mut["batch_stats"]["var"])
    variables["batch_stats"] = mut["batch_stats"]
    jy2 = jbn.apply(variables, jnp.asarray(x), use_running_average=True)
    ty2 = bn(torch.from_numpy(x), use_running_average=True)
    _close(ty2.detach().numpy(), jy2)
    assert bn(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16
    # a float64 input is normalised in float64 (fp32 for anything narrower)
    y64 = bn(torch.from_numpy(x).double(), use_running_average=True)
    assert y64.dtype == torch.float64
    _close(y64.detach().numpy(),
           bn(torch.from_numpy(x), use_running_average=True).detach())
    with pytest.raises(NotImplementedError, match="axis_name"):
        SyncBatchNorm(8, axis_name="data", device="cpu")


def test_logits_loss_gradients_and_batch_stats_match_jax():
    x, y = _batch(0)
    _, variables = _jax_model(x, 1)
    (jloss, (jstats, jlogits)), jgrads = _jax(jnp.float32)[3](
        variables["params"], variables["batch_stats"], jnp.asarray(x),
        jnp.asarray(y))
    model = _port_model(variables)
    logits = model(torch.from_numpy(x))
    loss = _port_loss(logits, torch.from_numpy(y))
    loss.backward()
    jl = np.asarray(jlogits)
    _close(logits.detach().numpy(), jl, atol=1e-4 * np.abs(jl).max())
    _close(loss.item(), float(jloss))
    want = resnet_params_from_jax({"params": jax.tree.map(np.asarray,
                                                          jgrads)})
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want) and len(got) == 53
    for name, g in got.items():
        w = want[name].numpy()
        _close(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
               err_msg=name)
    want_stats = resnet_params_from_jax(
        {"batch_stats": jax.tree.map(np.asarray, jstats)})
    got_stats = _stats(model)
    assert set(got_stats) == set(want_stats) and len(got_stats) == 34
    for name, s in got_stats.items():
        w = want_stats[name].numpy()
        _close(s.numpy(), w, atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_bf16_compute_logits_match_jax():
    x, _ = _batch(3, b=8)
    logits = {}
    for name, jdt, tdt in (("bf16", jnp.bfloat16, torch.bfloat16),
                           ("fp32", jnp.float32, torch.float32)):
        _, variables = _jax_model(x, 4, jdt)
        jl, _ = _jax(jdt)[2](variables, jnp.asarray(x))
        with torch.no_grad():
            tl = _port_model(variables, tdt)(torch.from_numpy(x))
        assert tl.dtype == torch.float32
        logits[name] = (np.asarray(jl, np.float32), tl.numpy())

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    (jb, tb), (jf, _) = logits["bf16"], logits["fp32"]
    assert rel(tb, jf) <= 2 * rel(jb, jf), (rel(tb, jf), rel(jb, jf))
    assert rel(tb, jb) <= 0.1, rel(tb, jb)


def test_three_flat_fused_sgd_steps_match_the_jax_loop():
    """The imagenet recipe's optimizer (lr 0.1 x batch / 256, momentum
    0.9, weight decay 1e-4) over 3 steps on one batch: the model trains in
    place as views of the flat buffer, the loss falls, and the parameters
    and running statistics follow the JAX loop."""
    x, y = _batch(5)
    _, variables = _jax_model(x, 6)
    kw = dict(lr=0.1 * len(x) / 256, momentum=0.9, weight_decay=1e-4,
              use_flat=True)
    grad_fn = _jax(jnp.float32)[3]
    jopt = JaxFusedSGD(variables["params"], **kw)
    jstats = variables["batch_stats"]
    model = _port_model(variables)
    start = {n: t.numpy().copy() for n, t in model.state_dict().items()}
    named = dict(model.named_parameters())
    opt = FusedSGD(named, **kw)
    with torch.no_grad():
        for n, view in opt.parameters.items():
            named[n].data = view
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    losses = []
    for _ in range(3):
        (jloss, (jstats, _)), jgrads = grad_fn(
            jopt.parameters, jstats, jnp.asarray(x), jnp.asarray(y))
        jopt.step(jgrads)
        for p in named.values():
            p.grad = None
        loss = _port_loss(model(tx), ty)
        loss.backward()
        opt.step({n: p.grad for n, p in named.items()})
        _close(loss.item(), float(jloss), rtol=1e-4)
        losses.append(loss.item())
    assert losses[-1] < losses[0]
    want = resnet_params_from_jax({
        "params": jax.tree.map(np.asarray, jopt.parameters),
        "batch_stats": jax.tree.map(np.asarray, jstats)})
    for name, t in model.state_dict().items():
        move = want[name].numpy() - start[name]
        err = np.linalg.norm(t.numpy() - start[name] - move)
        assert err <= 1e-3 * np.linalg.norm(move), (name, err)


def test_converters_round_trip_exactly_and_name_resnet50():
    """flax -> port -> flax is exact; ``init_resnet_params`` gives
    ResNet-50's names and shapes as the flax ResNet50's (its
    ``eval_shape``, nothing computed) and 25,557,032 parameters."""
    x, _ = _batch(7, b=2)
    _, variables = _jax_model(x, 8)
    back = resnet_params_to_jax(resnet_params_from_jax(variables))
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    shapes = jax.eval_shape(JaxResNet50().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3)))
    want = resnet_params_from_jax(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    got = init_resnet_params(0)
    assert {n: tuple(t.shape) for n, t in got.items()} \
        == {n: tuple(t.shape) for n, t in want.items()}
    assert sum(t.numel() for n, t in got.items()
               if not n.endswith((".mean", ".var"))) == 25_557_032
    conv = got["stage0_block0.conv2.weight"]
    assert abs(conv.std().item() - (1 / (64 * 9)) ** 0.5) < 2e-3
    assert torch.equal(got["bn1.var"], torch.ones(64))
