"""Port parity of the GroupNorm slice as a whole: a stack of two UNet ResNet
blocks (apex_tpu_torch vs apex_tpu).

Each block is ``GroupNorm(4, cin, act="silu")`` -> conv3x3 (cin -> cout)
-> ``GroupNorm(4, cout, act="silu")`` -> conv3x3 (cout -> cout), plus the
input (through a 1x1 conv where cin != cout): the block of Stable
Diffusion's UNet that ``chip_smoke.py``'s ``unet`` phase runs at full
width, here GN(4, 16) and GN(4, 32) at 8 x 8, batch 2, fp32. The JAX side
is built from ``flax.linen.Conv`` and ``apex_tpu.contrib.group_norm
.GroupNorm``, the port's from its ``Conv`` and ``GroupNorm``, the weights
carried across by ``resnet_params_from_jax``. Held: the output, the
MSE loss and every gradient (1e-4: convolutions and the GroupNorm
backward sum in other orders), then 3 flat ``FusedAdam`` steps against the
same loop in JAX (each step's loss 1e-4 relative; each parameter's move
from its start 1e-3 in relative L2, as the ResNet loop is held). The
converters round-trip exactly.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch import nn

from apex_tpu.contrib.group_norm import GroupNorm as JaxGroupNorm
from apex_tpu.optimizers.fused_adam import FusedAdam as JaxFusedAdam
from apex_tpu_torch.contrib.group_norm import GroupNorm
from apex_tpu_torch.models.convert import (resnet_params_from_jax,
                                           resnet_params_to_jax)
from apex_tpu_torch.models.resnet import Conv
from apex_tpu_torch.optimizers import FusedAdam

GROUPS = 4
WIDTHS = ((16, 32), (32, 32))


class JaxBlock(fnn.Module):
    cin: int
    cout: int

    @fnn.compact
    def __call__(self, x):
        h = JaxGroupNorm(GROUPS, self.cin, act="silu", name="norm1")(x)
        h = fnn.Conv(self.cout, (3, 3), padding="SAME", use_bias=False,
                     name="conv1")(h)
        h = JaxGroupNorm(GROUPS, self.cout, act="silu", name="norm2")(h)
        h = fnn.Conv(self.cout, (3, 3), padding="SAME", use_bias=False,
                     name="conv2")(h)
        if self.cin != self.cout:
            x = fnn.Conv(self.cout, (1, 1), use_bias=False, name="skip")(x)
        return h + x


class JaxStack(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        for i, (cin, cout) in enumerate(WIDTHS):
            x = JaxBlock(cin, cout, name=f"block{i}")(x)
        return x


class Block(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.norm1 = GroupNorm(GROUPS, cin, act="silu", device="cpu")
        self.conv1 = Conv(cin, cout, 3, padding=1, device="cpu")
        self.norm2 = GroupNorm(GROUPS, cout, act="silu", device="cpu")
        self.conv2 = Conv(cout, cout, 3, padding=1, device="cpu")
        self.skip = (Conv(cin, cout, 1, device="cpu") if cin != cout
                     else None)

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        return h + (x if self.skip is None else self.skip(x))


class Stack(nn.Module):
    def __init__(self):
        super().__init__()
        for i, (cin, cout) in enumerate(WIDTHS):
            self.add_module(f"block{i}", Block(cin, cout))

    def forward(self, x):
        for block in self.children():
            x = block(x)
        return x


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 8, WIDTHS[0][0])).astype(np.float32)
    t = rng.standard_normal((2, 8, 8, WIDTHS[-1][1])).astype(np.float32)
    return x, t


@functools.lru_cache(maxsize=None)
def _jax():
    """The flax stack's jitted init, forward and loss-and-gradient,
    compiled once for the file."""
    model = JaxStack()

    def loss_fn(params, x, t):
        return jnp.mean((model.apply({"params": params}, x) - t) ** 2)

    return (jax.jit(model.init), jax.jit(model.apply),
            jax.jit(jax.value_and_grad(loss_fn)))


def _models(seed=1):
    x, _ = _data()
    init, _, _ = _jax()
    variables = jax.tree.map(np.asarray,
                             init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    # random GroupNorm affines, so their gradients are not at ones / zeros
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (a + 0.1 * rng.standard_normal(a.shape)).astype(
            np.float32) if p[-1].key in ("weight", "bias") else a,
        variables["params"])
    port = Stack()
    port.load_state_dict(resnet_params_from_jax({"params": params}),
                         strict=True)
    return params, port


def _loss(model, x, t):
    return ((model(x) - t) ** 2).mean()


def test_forward_loss_and_every_gradient_match_jax():
    x, t = _data()
    params, port = _models()
    _, apply, grad_fn = _jax()
    yj = apply({"params": params}, jnp.asarray(x))
    lj, gj = grad_fn(params, jnp.asarray(x), jnp.asarray(t))
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    yt = port(xt)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj),
                               atol=1e-4, rtol=1e-4)
    loss = _loss(port, xt, tt)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(lj), rtol=1e-5)
    want = resnet_params_from_jax(
        {"params": jax.tree.map(np.asarray, gj)})
    got = {n: p.grad for n, p in port.named_parameters()}
    assert set(got) == set(want) and len(got) == 13
    for name, g in got.items():
        scale = float(np.abs(want[name].numpy()).max())
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   atol=1e-4 * scale, rtol=1e-4,
                                   err_msg=name)


def test_three_flat_fused_adam_steps_match_the_jax_loop():
    """Flat ``FusedAdam`` (lr 1e-3) over the stack, the parameters rebound
    to their views of the flat buffer as in the other loops: each step's
    loss and the parameters after 3 steps follow the JAX loop, and the
    loss falls."""
    x, t = _data(2)
    params, port = _models(3)
    grad_fn = _jax()[2]
    jopt = JaxFusedAdam(jax.tree.map(jnp.asarray, params), lr=1e-3,
                        use_flat=True)
    start = {n: p.detach().clone() for n, p in port.named_parameters()}
    named = dict(port.named_parameters())
    opt = FusedAdam(named, lr=1e-3, use_flat=True)
    with torch.no_grad():
        for n, view in opt.parameters.items():
            named[n].data = view
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    losses = []
    for _ in range(3):
        jloss, jgrads = grad_fn(jopt.parameters, jnp.asarray(x),
                                jnp.asarray(t))
        jopt.step(jgrads)
        for p in named.values():
            p.grad = None
        loss = _loss(port, xt, tt)
        loss.backward()
        opt.step({n: p.grad for n, p in named.items()})
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
        losses.append(loss.item())
    assert losses[-1] < losses[0]
    want = resnet_params_from_jax(
        {"params": jax.tree.map(np.asarray, jopt.parameters)})
    for name, p in port.named_parameters():
        move = want[name] - start[name]
        err = (p.detach() - start[name] - move).norm()
        assert err <= 1e-3 * move.norm(), (name, err)


def test_converters_round_trip_exactly():
    params, port = _models(4)
    back = resnet_params_to_jax(resnet_params_from_jax(
        {"params": params}))
    a = jax.tree_util.tree_leaves_with_path({"params": params})
    b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (_, u), (_, v) in zip(a, b):
        np.testing.assert_array_equal(u, v)
    sd = port.state_dict()
    assert sd["block0.conv1.weight"].shape == (32, 16, 3, 3)
    assert sd["block0.skip.weight"].shape == (32, 16, 1, 1)
    assert "block1.skip.weight" not in sd
    np.testing.assert_array_equal(
        sd["block0.conv1.weight"].numpy(),
        params["block0"]["conv1"]["kernel"].transpose(3, 2, 0, 1))
