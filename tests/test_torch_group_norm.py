"""Port parity: NHWC GroupNorm + SiLU (apex_tpu_torch vs apex_tpu).

The same numpy inputs, made from a seed, go through the JAX Pallas entry
``group_norm_nhwc_pallas`` (interpret mode on the CPU, as the JAX
package's own tests run it) and through the port's
``group_norm_nhwc_fwd`` on CPU tensors, which composes the CUDA kernels'
plain versions (``gn_one_pass_plain``; ``gn_stats_plain``, the moments,
``gn_apply_plain``); then the public ``group_norm_nhwc``, the
``GroupNorm`` module and every gradient against the JAX function,
``jax.grad`` and the flax module. Tolerances are ``tests/test_contrib.py``'s
for the JAX kernels: fp32 y and mean 1e-5, rstd 1e-4 relative, bf16 y
2e-2; gradients 1e-4. The port shifts each group's values by its first
element where the TPU kernels take ``E[x^2] - mean^2``: on well-conditioned
input the two agree at those tolerances; on a group with mean 1000 and std
0.01 the JAX kernels return NaN and the port stays within 1e-4 of a
float64 reference (the centred ``_gn_jnp`` is itself ~1e-2 from float64
there, since a mean near 1000 rounds to fp32 steps of 6e-5 and rstd is
100).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.group_norm import (GroupNorm as JaxGroupNorm,
                                         _gn_jnp,
                                         group_norm_nhwc as jax_group_norm)
from apex_tpu.ops.pallas.group_norm_kernel import group_norm_nhwc_pallas
from apex_tpu_torch.contrib.group_norm import (GroupNorm, _gn_plain,
                                               group_norm_nhwc,
                                               torch_group_norm)
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.group_norm_kernel import (
    gn_apply, gn_forward, gn_one_pass, gn_shift, gn_stats,
    group_norm_nhwc_fwd)
from apex_tpu_torch.ops.tiling import (GN_ONE_PASS_SMEM_BYTES, gn_hw_block,
                                       gn_one_pass_ok)

EPS = 1e-5
G = 8


def _inputs(shape=(2, 8, 8, 32), seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 1).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, w, b


@functools.lru_cache(maxsize=None)
def _jax_pallas(groups, affine, act, algo, hw_block):
    """``group_norm_nhwc_pallas`` in interpret mode, jitted once per
    static configuration for the file."""
    def f(x, w, b):
        return group_norm_nhwc_pallas(
            x, groups, w if affine else None, b if affine else None, EPS,
            act, interpret=True, algo=algo, hw_block=hw_block)
    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(groups, act, algo):
    def loss(x, w, b, r):
        return jnp.sum(jax_group_norm(x, groups, w, b, EPS, act, algo) * r)
    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))


TWIN_CASES = [(algo, affine, act, dt, hwb)
              for algo, hwb in (("one_pass", None), ("two_pass", None),
                                ("two_pass", 16))
              for affine in (True, False) for act in ("", "silu")
              for dt in ("fp32", "bf16")
              if hwb is None or (affine and dt == "fp32")]


@pytest.mark.parametrize("algo,affine,act,dt,hw_block", TWIN_CASES)
def test_plain_twins_match_pallas_interpret(algo, affine, act, dt,
                                            hw_block):
    """y, mean and rstd of the plain twins (composed by ``group_norm_nhwc_fwd``)
    against the Pallas kernels: both algorithms (two-pass also over four
    16-pixel tiles), with and without the affine and SiLU, fp32 and
    bf16."""
    x, w, b = _inputs(seed=TWIN_CASES.index((algo, affine, act, dt,
                                             hw_block)))
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    yj, mj, rj = _jax_pallas(G, affine, act, algo, hw_block)(
        jnp.asarray(x).astype(jdt), jnp.asarray(w), jnp.asarray(b))
    _build.reset_launches()
    yt, mt, rt = group_norm_nhwc_fwd(
        torch.from_numpy(x).to(tdt), G,
        torch.from_numpy(w) if affine else None,
        torch.from_numpy(b) if affine else None, EPS, act, algo, hw_block)
    assert sum(_build.launches.values()) == 0   # CPU: no kernel
    assert yt.dtype == tdt and mt.shape == rt.shape == (2, G)
    tol = 1e-5 if dt == "fp32" else 2e-2
    np.testing.assert_allclose(yt.float().numpy(),
                               np.asarray(yj.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=0,
                               rtol=1e-4)


def test_twin_wrappers_compose_like_the_forward():
    """``gn_stats`` / ``gn_apply`` and ``gn_one_pass`` on CPU tensors are
    the plain twins; the two algorithms agree."""
    x, w, b = _inputs((2, 8, 8, 32), seed=3)
    x3 = torch.from_numpy(x).reshape(2, 64, 32)
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    y1, d1, r1 = gn_one_pass(x3, G, wt, bt, eps=EPS, act="silu")
    shift = gn_shift(x3, G)
    assert torch.equal(shift, x3[:, 0, ::4])
    psum, psq = gn_stats(x3, shift, gn_hw_block(64, 32, 16))
    assert psum.shape == psq.shape == (2, 4, G)
    y2, d2, r2 = gn_forward(x3, G, wt, bt, EPS, "silu", "two_pass", 16)
    y3 = gn_apply(x3, shift, d2, r2, wt, bt, 16, act="silu")
    torch.testing.assert_close(y2, y3, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(y1, y3, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(d1, d2, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(r1, r2, atol=0, rtol=1e-4)
    _, m4, _ = group_norm_nhwc_fwd(x3.reshape(2, 8, 8, 32), G, wt, bt, EPS,
                                   "silu", "two_pass", 16)
    torch.testing.assert_close(m4, shift + d2)


@pytest.mark.parametrize("algo", ["one_pass", "two_pass"])
def test_ill_conditioned_group_stays_finite(algo):
    """One group with mean 1000 and std 0.01 (fp32): the JAX kernels'
    E[x^2] - mean^2 cancels to NaN; the port's shifted statistics stay
    within 1e-4 of float64, and no further from the centred ``_gn_jnp``
    than ``_gn_jnp`` is from float64 (plus 1e-4)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    x[0, :, :, :4] = 1000 + 0.01 * rng.standard_normal((8, 8, 4))
    x = x.astype(np.float32)
    yt, _, rt = group_norm_nhwc_fwd(torch.from_numpy(x), 4, algo=algo)
    yt = yt.numpy()
    x64 = x.astype(np.float64).reshape(2, 64, 4, 4)
    m64 = x64.mean(axis=(1, 3), keepdims=True)
    v64 = ((x64 - m64) ** 2).mean(axis=(1, 3), keepdims=True)
    y64 = ((x64 - m64) / np.sqrt(v64 + EPS)).reshape(x.shape)
    yjnp = np.asarray(_gn_jnp(jnp.asarray(x), 4, None, None, EPS, ""))
    assert np.isfinite(yt).all() and np.isfinite(rt.numpy()).all()
    assert np.abs(yt - y64).max() <= 1e-4
    assert np.abs(yt - yjnp).max() <= np.abs(yjnp - y64).max() + 1e-4
    yp = np.asarray(_jax_pallas(4, False, "", algo, None)(
        jnp.asarray(x), jnp.ones(16), jnp.zeros(16))[0])
    assert not np.isfinite(yp).all()   # the deviation this port makes


@pytest.mark.parametrize("algo", ["one_pass", "two_pass"])
def test_ill_conditioned_group_gradients_match_float64(algo):
    """The backward on the mean-1000 / std-0.01 group rebuilds xhat from
    the forward's shift K and mean_d, as the kernels do: dx, dweight and
    dbias within 1e-4 (relative to each tensor's largest value) of float64
    autograd. Rebuilding it from the rounded fp32 ``mean = K + mean_d``
    costs ~3e-4 there."""
    rng = np.random.default_rng(19)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    x[0, :, :, :4] = 1000 + 0.01 * rng.standard_normal((8, 8, 4))
    x = x.astype(np.float32)
    _, w, b = _inputs((2, 8, 8, 16), seed=19)
    r = rng.standard_normal(x.shape).astype(np.float32)
    grads = {}
    for dt in (torch.float32, torch.float64):
        xt, wt, bt = (torch.from_numpy(a).to(dt).requires_grad_()
                      for a in (x, w, b))
        if dt == torch.float32:
            y = group_norm_nhwc(xt, 4, wt, bt, EPS, "silu", algo)
        else:
            y = torch.nn.functional.silu(torch.nn.functional.group_norm(
                xt.permute(0, 3, 1, 2), 4, wt, bt, EPS).permute(0, 2, 3, 1))
        (y * torch.from_numpy(r).to(dt)).sum().backward()
        grads[dt] = [t.grad.double() for t in (xt, wt, bt)]
    for got, want in zip(grads[torch.float32], grads[torch.float64]):
        assert torch.isfinite(got).all()
        err = ((got - want).abs().max() / want.abs().max()).item()
        assert err <= 1e-4, err


def test_kernel_route_takes_any_hw():
    """The kernels' route (here their plain twins, which CUDA tensors'
    kernels mirror) at hw % 8 != 0, both algorithms and a tile of 7
    pixels: the same y as the plain reference, finite gradients."""
    x, w, b = _inputs((2, 7, 7, 32), seed=23)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    want = _gn_plain(xt, G, wt, bt, EPS, "silu")
    assert gn_hw_block(49, 4096) == 7
    for algo in ("one_pass", "two_pass"):
        y, _, _ = group_norm_nhwc_fwd(xt, G, wt, bt, EPS, "silu", algo)
        torch.testing.assert_close(y, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("algo", ["auto", "one_pass", "two_pass"])
@pytest.mark.parametrize("act", ["", "silu"])
def test_group_norm_nhwc_and_gradients_match_jax(act, algo):
    """The public function's value and the gradients of x, weight and bias
    (against a random cotangent) against ``jax.value_and_grad`` of the JAX
    function, at 1e-4."""
    x, w, b = _inputs((2, 4, 4, 32), seed=len(act) + len(algo))
    r = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    vj, gj = _jax_value_and_grad(G, act, algo)(
        *(jnp.asarray(a) for a in (x, w, b, r)))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    y = group_norm_nhwc(xt, G, wt, bt, EPS, act, algo)
    np.testing.assert_allclose(
        y.detach().numpy(),
        np.asarray(jax_group_norm(jnp.asarray(x), G, jnp.asarray(w),
                                  jnp.asarray(b), EPS, act, algo)),
        atol=1e-5, rtol=1e-5)
    loss = (y * torch.from_numpy(r)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(vj), rtol=1e-4, atol=1e-4)
    for got, want in zip((xt, wt, bt), gj):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)


def test_gradients_without_affine_and_in_bf16_parameters():
    """No weight / bias: only dx; bf16 parameters: dweight / dbias come
    back in bf16, as from the JAX ``custom_vjp``."""
    x, w, b = _inputs((2, 4, 4, 32), seed=9)
    xt = torch.from_numpy(x).requires_grad_()
    group_norm_nhwc(xt, G, act="silu").square().sum().backward()
    gx = jax.grad(lambda x: jnp.sum(jax_group_norm(
        x, G, None, None, EPS, "silu") ** 2))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-4,
                               rtol=1e-4)
    wj = jnp.asarray(w).astype(jnp.bfloat16)
    bj = jnp.asarray(b).astype(jnp.bfloat16)
    gw, gb = jax.grad(lambda w, b: jnp.sum(jax_group_norm(
        jnp.asarray(x), G, w, b, EPS, "") ** 2), (0, 1))(wj, bj)
    wt = torch.from_numpy(w).bfloat16().requires_grad_()
    bt = torch.from_numpy(b).bfloat16().requires_grad_()
    group_norm_nhwc(torch.from_numpy(x), G, wt, bt).square().sum() \
        .backward()
    assert wt.grad.dtype == bt.grad.dtype == torch.bfloat16
    for got, want in ((wt.grad, gw), (bt.grad, gb)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=2 ** -7, atol=1e-3)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_module_matches_flax(param_dtype):
    """Parameter names, values and dtype of ``GroupNorm`` against the flax
    module's, and its output."""
    x, _, _ = _inputs((2, 4, 4, 32), seed=13)
    jdt = getattr(jnp, param_dtype)
    mod = JaxGroupNorm(num_groups=G, num_channels=32, act="silu",
                       param_dtype=jdt)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    yj = mod.apply(variables, jnp.asarray(x))
    port = GroupNorm(G, 32, act="silu", param_dtype=getattr(torch,
                                                            param_dtype),
                     device="cpu")
    params = dict(port.named_parameters())
    assert set(params) == set(variables["params"]) == {"weight", "bias"}
    for name, p in params.items():
        ref = np.asarray(variables["params"][name].astype(jnp.float32))
        assert p.dtype == getattr(torch, param_dtype)
        np.testing.assert_array_equal(p.detach().float().numpy(), ref)
    with torch.no_grad():
        yt = port(torch.from_numpy(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5,
                               rtol=1e-5)
    assert not hasattr(GroupNorm(G, 32, affine=False, device="cpu"),
                       "weight")


def test_odd_hw_takes_the_plain_reference():
    """hw % 8 != 0 on CPU tensors: ``algo="auto"`` runs the plain reference
    (the JAX ``_gn_jnp`` route), differentiable, and launches nothing; an
    explicit algorithm raises ``ValueError`` as in JAX. (CUDA tensors run
    the kernels at any hw: ``tests/test_torch_cuda.py``.)"""
    x, w, b = _inputs((1, 3, 3, 16), seed=17)
    xt = torch.from_numpy(x).requires_grad_()
    _build.reset_launches()
    y = torch_group_norm(xt, 4, torch.from_numpy(w), torch.from_numpy(b),
                         act="silu")
    assert sum(_build.launches.values()) == 0
    yj = jax_group_norm(jnp.asarray(x), 4, jnp.asarray(w), jnp.asarray(b),
                        EPS, "silu")
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(yj),
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(y, _gn_plain(xt, 4, torch.from_numpy(w),
                                            torch.from_numpy(b), EPS,
                                            "silu"))
    y.sum().backward()
    gx = jax.grad(lambda x: jnp.sum(jax_group_norm(
        x, 4, jnp.asarray(w), jnp.asarray(b), EPS, "silu")))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-4,
                               rtol=1e-4)
    for algo in ("one_pass", "two_pass"):
        with pytest.raises(ValueError, match="HW % 8"):
            group_norm_nhwc(torch.from_numpy(x), 4, algo=algo)
        with pytest.raises(ValueError, match="HW % 8"):
            jax_group_norm(jnp.asarray(x), 4, algo=algo)


def test_bad_arguments_raise_value_error():
    """A bad ``algo`` or ``hw_block`` or ``act`` raises ``ValueError`` on
    both sides, before any kernel."""
    x = torch.zeros(1, 4, 4, 16)
    with pytest.raises(ValueError, match="algo"):
        group_norm_nhwc(x, 4, algo="three_pass")
    with pytest.raises(ValueError, match="algo"):
        group_norm_nhwc_pallas(jnp.zeros((1, 4, 4, 16)), 4,
                               algo="three_pass", interpret=True)
    for blk in (12, 0, 32, 4):
        with pytest.raises(ValueError, match="hw_block"):
            group_norm_nhwc_fwd(x, 4, algo="two_pass", hw_block=blk)
        with pytest.raises(ValueError, match="hw_block"):
            group_norm_nhwc_pallas(jnp.zeros((1, 4, 4, 16)), 4,
                                   algo="two_pass", hw_block=blk,
                                   interpret=True)
    for bad in (lambda: group_norm_nhwc(x, 4, act="relu"),
                lambda: jax_group_norm(jnp.zeros((1, 4, 4, 16)), 4,
                                       act="relu"),
                lambda: group_norm_nhwc(x, 5)):
        with pytest.raises((ValueError, AssertionError)):
            bad()


@pytest.mark.parametrize("hw,c,g,one_pass", [
    (64 * 64, 320, 32, True),      # 160 KB: SD's 320 @ 64 x 64
    (64 * 64, 960, 32, False),     # 480 KB: up_blocks.3.resnets.0
    (32 * 32, 640, 32, True),
    (16 * 16, 1280, 32, True),
    (32 * 32, 256, 32, True),      # the JAX package's AOT shape
    (512 * 512, 128, 32, False),   # the SD VAE decoder's last norm
    (63, 16, 4, True),             # hw % 8 != 0: the kernels take it
    (GN_ONE_PASS_SMEM_BYTES // 4, 1, 1, True),
    (GN_ONE_PASS_SMEM_BYTES // 4 + 1, 1, 1, False),
])
def test_one_pass_gate_both_sides(hw, c, g, one_pass):
    """The port's one-pass gate: the (n, g) slab, hw * c / g fp32 values,
    in the one-pass block's shared memory (227 KB less 1 KB)."""
    assert gn_one_pass_ok(hw, c, g) is one_pass


def test_hw_block_default_tiles():
    """The default two-pass tile: the largest divisor of hw with tile * c
    <= 32768 (at least 1), any hw; a given tile as given."""
    assert gn_hw_block(64 * 64, 960) == 32
    assert gn_hw_block(512 * 512, 128) == 256
    assert gn_hw_block(32 * 32, 256) == 128
    assert gn_hw_block(64, 32) == 64
    assert gn_hw_block(24, 4096) == 8
    assert gn_hw_block(63, 16) == 63
    assert gn_hw_block(7 * 7, 2048) == 7
    assert gn_hw_block(4099, 1280) == 1      # a prime hw
    assert gn_hw_block(4096, 320, 64) == 64
