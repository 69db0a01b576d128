"""Port parity: fused Adam (apex_tpu_torch vs apex_tpu).

The same numpy parameters and gradients, made from a seed, go through the
JAX Pallas kernel ``fused_adam_flat`` (interpret mode on the CPU, as the
JAX package's own tests run it), the JAX tree update ``adam_update`` and
the JAX ``FusedAdam``, and through the port's counterparts on CPU tensors
(the port's kernel wrapper runs its plain version there), over 3 steps.

Tolerances: 1e-6 absolute plus 1e-5 relative on parameters and moments
(both sides compute in fp32 with the same operations; the bias
corrections come from two ``pow`` implementations, which may differ in
the last bit). bf16 parameters (the flat buffer of a bf16 tree, and the
bf16 copy the master form writes) are held to one bf16 ulp (2^-7
relative): an fp32 result one bit apart can round to the neighbouring
bf16 value; the count of such elements is asserted small. An overflow
step is held to identical bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.pallas.fused_adam_kernel import (
    fused_adam_flat as jax_fused_adam_flat,
    fused_adam_flat_master as jax_fused_adam_flat_master)
from apex_tpu.optimizers.functional import adam_update as jax_adam_update
from apex_tpu.optimizers.fused_adam import FusedAdam as JaxFusedAdam
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.fused_adam_kernel import (
    ADAM_MODE_ADAMW, ADAM_MODE_L2, fused_adam_flat, fused_adam_flat_master,
    fused_adam_flat_master_plain, fused_adam_flat_plain)
from apex_tpu_torch.optimizers import FusedAdam, FusedAdamW, adam_update

TOL = dict(atol=1e-6, rtol=1e-5)
# ragged leaves: none is a multiple of the 128-element alignment
SHAPES = {"w": (3, 50), "b": (7,), "e": (130,), "s": ()}


def _tree(seed, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(rng.standard_normal(s), np.float32)
            for k, s in shapes.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(a)) for k, a in tree.items()}


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32), **(tol or TOL))


@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("mode", [ADAM_MODE_L2, ADAM_MODE_ADAMW])
def test_flat_kernel_matches_pallas_over_3_steps(mode, bias_correction):
    n = 2048
    rng = np.random.default_rng(mode + 2 * bias_correction)
    p0 = rng.standard_normal(n).astype(np.float32)
    jp, jm, jv = jnp.asarray(p0), jnp.zeros(n), jnp.zeros(n)
    tp, tm, tv = torch.from_numpy(p0.copy()), torch.zeros(n), torch.zeros(n)
    _build.reset_launches()
    for step in (1, 2, 3):
        g = rng.standard_normal(n).astype(np.float32)
        kw = dict(lr=1e-2, weight_decay=0.1, step=step, mode=mode,
                  bias_correction=bias_correction, inv_scale=0.5)
        jp, jm, jv = jax_fused_adam_flat(jp, jnp.asarray(g), jm, jv, **kw)
        out = fused_adam_flat(tp, torch.from_numpy(g), tm, tv, **kw)
        assert out[0] is tp and out[1] is tm and out[2] is tv  # in place
        for port, ref in ((tp, jp), (tm, jm), (tv, jv)):
            _close(port.numpy(), ref)
    assert sum(_build.launches.values()) == 0  # CPU: the plain version


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_tree_update_matches_adam_update(adam_w_mode, master):
    params, grads = _tree(0), _tree(1)
    m, v = _tree(2), {k: np.abs(a) for k, a in _tree(3).items()}
    kw = dict(step=3, lr=1e-2, weight_decay=0.05, adam_w_mode=adam_w_mode,
              inv_scale=0.25, found_inf=False)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = _t(params)
    jout = jax_adam_update(
        jparams, jax.tree.map(jnp.asarray, grads),
        jax.tree.map(jnp.asarray, m), jax.tree.map(jnp.asarray, v),
        master=jparams if master else None, **kw)
    tout = adam_update(tparams, _t(grads), _t(m), _t(v),
                       master=tparams if master else None, **kw)
    assert len(jout) == len(tout) == (4 if master else 3)
    for jt, tt in zip(jout, tout):
        for k in SHAPES:
            _close(tt[k].numpy(), jt[k])


@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("use_flat", [True, False])
@pytest.mark.parametrize("cls,adam_w_mode", [("FusedAdam", False),
                                             ("FusedAdamW", True)])
def test_fused_adam_matches_jax_over_3_steps(cls, adam_w_mode, use_flat,
                                             bias_correction):
    """Ragged leaves through both paths; the flat layout pads each leaf to
    128 elements and the buffer to 1024, as the JAX one does."""
    params = _tree(4)
    kw = dict(lr=1e-2, weight_decay=0.1, use_flat=use_flat,
              bias_correction=bias_correction, adam_w_mode=adam_w_mode)
    jopt = JaxFusedAdam(jax.tree.map(jnp.asarray, params), **kw)
    topt = {"FusedAdam": FusedAdam, "FusedAdamW": FusedAdamW}[cls](
        _t(params), **kw)
    if use_flat:
        assert topt._flat_p.numel() == jopt._flat_p.size
        assert topt._spec.offsets == jopt._spec.offsets
    for step in range(3):
        grads = _tree(10 + step)
        jp = jopt.step(jax.tree.map(jnp.asarray, grads), inv_scale=0.5)
        tp = topt.step(_t(grads), inv_scale=0.5)
        for k in SHAPES:
            assert tuple(tp[k].shape) == SHAPES[k]
            _close(tp[k].numpy(), jp[k])
    assert int(topt._step) == int(jopt._step) == 3


@pytest.mark.parametrize("use_flat", [True, False])
def test_overflow_step_is_a_bitwise_noop(use_flat):
    """found_inf leaves parameters and moments bit for bit and does not
    advance the step count; the plain kernel version does the same."""
    opt = FusedAdam(_t(_tree(5)), lr=1e-2, use_flat=use_flat)
    opt.step(_t(_tree(6)))
    before = ({k: t.clone() for k, t in opt.parameters.items()},
              {k: (t.clone() if torch.is_tensor(t) else
                   {n: x.clone() for n, x in t.items()})
               for k, t in opt.state.items()})
    bad = {k: torch.full(s, float("nan")) for k, s in SHAPES.items()}
    opt.step(bad, found_inf=torch.tensor(True))
    assert int(opt._step) == 1
    for k, t in opt.parameters.items():
        assert torch.equal(t, before[0][k])
    for k, t in opt.state.items():
        if torch.is_tensor(t):
            assert torch.equal(t, before[1][k])
        else:
            assert all(torch.equal(x, before[1][k][n]) for n, x in t.items())
    p, g, m, v = (torch.randn(1024) for _ in range(4))
    ref = [t.clone() for t in (p, m, v)]
    fused_adam_flat_plain(p, g, m, v, lr=1.0, step=1, found_inf=True)
    assert all(torch.equal(a, b) for a, b in zip((p, m, v), ref))


@pytest.mark.parametrize("use_flat", [True, False])
def test_master_weights_match_jax(use_flat):
    """bf16 parameters with fp32 masters: the masters are updated and the
    parameters are their bf16 cast."""
    params = _tree(7)
    kw = dict(lr=1e-2, weight_decay=0.01, master_weights=True,
              use_flat=use_flat)
    jopt = JaxFusedAdam(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                     params), **kw)
    topt = FusedAdam({k: t.bfloat16() for k, t in _t(params).items()},
                     **kw)
    for step in range(3):
        grads = _tree(20 + step)
        jp = jopt.step(jax.tree.map(jnp.asarray, grads))
        tp = topt.step(_t(grads))
    jm, tm = jopt.master_parameters, topt.master_parameters
    for k in SHAPES:
        assert tp[k].dtype == torch.bfloat16 and tm[k].dtype == torch.float32
        _close(tm[k].numpy(), jm[k])
        np.testing.assert_array_equal(
            tp[k].float().numpy(),
            np.asarray(jnp.asarray(tm[k].numpy()).astype(jnp.bfloat16)
                       .astype(jnp.float32)))
        _close(tp[k].float().numpy(), np.asarray(jp[k], np.float32),
               atol=0, rtol=2 ** -7)


def test_flat_path_refuses_low_precision_without_master():
    """The flat path used to refuse low-precision parameters without
    ``master_weights``; it now keeps them in a flat buffer of their dtype,
    as the JAX class does (the parameters are views of it). AMSGrad is
    still refused."""
    opt = FusedAdam({"w": torch.zeros(4, dtype=torch.bfloat16)})
    assert opt._flat_p.dtype == torch.bfloat16
    assert opt.state["m"].dtype == opt.state["v"].dtype == torch.float32
    w = opt.parameters["w"]
    assert w.dtype == torch.bfloat16 \
        and w.untyped_storage().data_ptr() \
        == opt._flat_p.untyped_storage().data_ptr()
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam({"w": torch.zeros(4)}, amsgrad=True)


def _bf16_close(port, ref, max_off=0.01):
    """bf16 values within one bf16 ulp, and at most ``max_off`` of them
    not equal."""
    port = np.asarray(port, np.float32)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(port, ref, atol=0, rtol=2 ** -7)
    assert np.mean(port != ref) <= max_off


@pytest.mark.parametrize("mode", [ADAM_MODE_L2, ADAM_MODE_ADAMW])
def test_bf16_flat_kernel_matches_pallas_over_3_steps(mode):
    """bf16 p and g, fp32 m and v (the buffers of the JAX class over a
    bf16 tree): the plain version and the wrapper's CPU route against the
    Pallas kernel, then an overflow step that changes no bit."""
    n = 2048
    rng = np.random.default_rng(10 + mode)
    p0 = rng.standard_normal(n).astype(np.float32)
    jp = jnp.asarray(p0, jnp.bfloat16)
    jm, jv = jnp.zeros(n, jnp.float32), jnp.zeros(n, jnp.float32)
    tp = torch.from_numpy(p0).bfloat16()
    tm, tv = torch.zeros(n), torch.zeros(n)
    wp, wm, wv = tp.clone(), tm.clone(), tv.clone()
    for step in (1, 2, 3):
        g = rng.standard_normal(n).astype(np.float32)
        kw = dict(lr=1e-2, weight_decay=0.1, step=step, mode=mode,
                  inv_scale=0.5)
        jp, jm, jv = jax_fused_adam_flat(jp, jnp.asarray(g, jnp.bfloat16),
                                         jm, jv, **kw)
        tg = torch.from_numpy(g).bfloat16()
        fused_adam_flat_plain(tp, tg, tm, tv, **kw)
        fused_adam_flat(wp, tg, wm, wv, **kw)
        assert tp.dtype == torch.bfloat16
        _bf16_close(tp.float().numpy(), np.asarray(jp, np.float32))
        _close(tm.numpy(), jm, atol=1e-5, rtol=1e-2)
        _close(tv.numpy(), jv, atol=1e-5, rtol=1e-2)
        assert all(torch.equal(a, b) for a, b in
                   ((wp, tp), (wm, tm), (wv, tv)))
    before = [t.clone() for t in (tp, tm, tv)]
    fused_adam_flat(tp, torch.full((n,), float("nan"), dtype=torch.bfloat16),
                    tm, tv, lr=1e-2, step=4, found_inf=torch.tensor(True))
    assert all(torch.equal(a, b) for a, b in zip((tp, tm, tv), before))


@pytest.mark.parametrize("mode", [ADAM_MODE_L2, ADAM_MODE_ADAMW])
def test_master_kernel_matches_pallas_over_3_steps(mode):
    """``fused_adam_flat_master``: the fp32 master, m and v against the
    Pallas kernel's, the bf16 copy the exact cast of the master (and
    within one ulp of the Pallas copy); an overflow step keeps the master,
    m and v and rewrites the same copy bits."""
    n = 2048
    rng = np.random.default_rng(20 + mode)
    p0 = rng.standard_normal(n).astype(np.float32)
    jp = jnp.asarray(p0)
    jm, jv = jnp.zeros(n, jnp.float32), jnp.zeros(n, jnp.float32)
    tp, tm, tv = torch.from_numpy(p0.copy()), torch.zeros(n), torch.zeros(n)
    lp = torch.empty(n, dtype=torch.bfloat16)
    wp, wm, wv = tp.clone(), tm.clone(), tv.clone()
    for step in (1, 2, 3):
        g = rng.standard_normal(n).astype(np.float32)
        kw = dict(lr=1e-2, weight_decay=0.1, step=step, mode=mode,
                  inv_scale=0.5)
        jp, jlp, jm, jv = jax_fused_adam_flat_master(jp, jnp.asarray(g), jm,
                                                     jv, **kw)
        out = fused_adam_flat_master_plain(tp, torch.from_numpy(g), tm, tv,
                                           p_lp=lp, **kw)
        assert out[0] is tp and out[1] is lp and out[2] is tm
        wout = fused_adam_flat_master(wp, torch.from_numpy(g), wm, wv, **kw)
        for port, ref in ((tp, jp), (tm, jm), (tv, jv)):
            _close(port.numpy(), ref)
        assert torch.equal(lp, tp.bfloat16())
        _bf16_close(lp.float().numpy(), np.asarray(jlp, np.float32))
        assert all(torch.equal(a, b) for a, b in
                   ((wout[0], tp), (wout[1], lp), (wout[2], tm),
                    (wout[3], tv)))
    before = [t.clone() for t in (tp, lp, tm, tv)]
    fused_adam_flat_master(tp, torch.full((n,), float("inf")), tm, tv,
                           p_lp=lp, lr=1e-2, step=4,
                           found_inf=torch.tensor(True))
    assert all(torch.equal(a, b) for a, b in zip((tp, lp, tm, tv), before))


def test_bf16_fused_adam_matches_jax_with_an_overflow_step():
    """``FusedAdam(use_flat=True)`` over a bf16 tree without
    ``master_weights`` (which raised before): 3 steps, the second a forced
    overflow, against the JAX class on the same tree. The bf16 parameters
    are equal to the JAX ones, bit for bit, after every step (no fp32
    result lands on the other side of a bf16 rounding boundary here); the
    overflow step changes no bit and does not advance the step count."""
    params = _tree(30)
    jopt = JaxFusedAdam(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                     params), lr=1e-2, weight_decay=0.01)
    topt = FusedAdam({k: t.bfloat16() for k, t in _t(params).items()},
                     lr=1e-2, weight_decay=0.01)
    for step in range(3):
        grads = _tree(31 + step)
        overflow = step == 1
        if overflow:
            grads["w"][0, 0] = np.inf
            before = {k: t.clone() for k, t in topt.parameters.items()}
        jp = jopt.step(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                    grads), found_inf=overflow)
        tp = topt.step({k: t.bfloat16() for k, t in _t(grads).items()},
                       found_inf=torch.tensor(overflow))
        if overflow:
            assert all(torch.equal(tp[k], before[k]) for k in SHAPES)
        for k in SHAPES:
            assert tp[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(tp[k].float().numpy(),
                                          np.asarray(jp[k], np.float32))
    assert int(topt._step) == int(jopt._step) == 2
