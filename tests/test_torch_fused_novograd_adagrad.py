"""Port parity: fused NovoGrad and Adagrad (apex_tpu_torch vs apex_tpu).

The same numpy parameters and gradients, made from a seed, go through the
JAX Pallas kernels ``fused_novograd_flat`` and ``fused_adagrad_flat``
(interpret mode on the CPU, as the JAX package's own tests run them), the
JAX tree updates ``novograd_update`` and ``adagrad_update`` and the JAX
classes, and through the port's counterparts on CPU tensors (the port's
kernel wrappers run their plain versions there), over 3 steps, on a
ragged flat layout (no leaf a multiple of the 128-element alignment).

Tolerances: 1e-6 relative plus 1e-6 absolute on parameters and moments of
order 1 (both sides run the same fp32 operations; XLA may contract a
product and a sum, the bias corrections come from two ``pow``
implementations, and NovoGrad's per-tensor sums of squares add in other
orders); NovoGrad's per-tensor moments 1e-5 relative (sums of up to 2,800
squares in another order). The flat and tree paths are each held against
their own JAX path (the tree path squares the norm's square root, the
flat path keeps the sum of squares). Overflow steps are held to identical
bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.pallas.fused_opt_kernels import (
    fused_adagrad_flat as jax_fused_adagrad_flat,
    fused_novograd_flat as jax_fused_novograd_flat,
    row_segment_ids as jax_row_segment_ids)
from apex_tpu.optimizers._base import scalar_zeros as jax_scalar_zeros
from apex_tpu.optimizers.functional import (
    adagrad_update as jax_adagrad_update,
    novograd_update as jax_novograd_update)
from apex_tpu.optimizers.fused_adagrad import FusedAdagrad as JaxFusedAdagrad
from apex_tpu.optimizers.fused_novograd import (
    FusedNovoGrad as JaxFusedNovoGrad)
from apex_tpu.utils.flatten import (flat_spec as jax_flat_spec,
                                    flatten as jax_flatten)
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.fused_opt_kernels import (
    fused_adagrad_flat, fused_adagrad_flat_plain, fused_novograd_flat,
    fused_novograd_flat_plain, row_segment_ids, row_segments)
from apex_tpu_torch.optimizers import (FusedAdagrad, FusedNovoGrad,
                                       adagrad_update, novograd_update)
from apex_tpu_torch.optimizers._base import scalar_zeros
from apex_tpu_torch.utils.flatten import flat_spec, flatten

TOL = dict(atol=1e-6, rtol=1e-6)
SHAPES = {"w": (3, 50), "b": (7,), "e": (300,), "s": (), "m": (40, 70)}


def _tree(seed, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(rng.standard_normal(s), np.float32)
            for k, s in shapes.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(a)) for k, a in tree.items()}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32), **(tol or TOL))


def _flat(params):
    """The same flat layout on both sides: (jax flat p, jax row ids, port
    flat p, port row ids, port segments, port spec)."""
    jspec = jax_flat_spec(_j(params))
    jp = jax_flatten(_j(params), jspec, dtype=jnp.float32, pad_to=1024)
    tspec = flat_spec(_t(params))
    tp = flatten(_t(params), tspec, dtype=torch.float32, pad_to=1024)
    ids = row_segment_ids(tspec, tp.numel())
    return (jp, jax_row_segment_ids(jspec, jp.size), tp, ids,
            row_segments(ids, tspec.num_leaves), tspec)


def _grads(seed, spec):
    return flatten(_t(_tree(seed)), spec, dtype=torch.float32, pad_to=1024)


# ---------------------------------------------------------------- NovoGrad


@pytest.mark.parametrize("init_zero,grad_averaging,bias_correction",
                         [(False, False, False), (True, True, True),
                          (False, True, True)])
def test_novograd_flat_matches_pallas_over_3_steps(init_zero,
                                                   grad_averaging,
                                                   bias_correction):
    """The plain update (the CPU route of the wrapper) against the Pallas
    kernel over 3 steps with a loss scale, then an overflow step that
    changes no bit."""
    jp, jids, tp, ids, seg, spec = _flat(_tree(0))
    n, t = tp.numel(), spec.num_leaves
    jm, jv = jnp.zeros(n, jnp.float32), jnp.zeros(t, jnp.float32)
    tm, tv = torch.zeros(n), torch.zeros(t)
    wp, wm, wv = tp.clone(), tm.clone(), tv.clone()   # the wrapper's copy
    kw = dict(num_tensors=t, lr=0.05, weight_decay=0.01,
              grad_averaging=grad_averaging, init_zero=init_zero,
              bias_correction=bias_correction, inv_scale=0.5)
    _build.reset_launches()
    for step in (1, 2, 3):
        g = _grads(10 + step, spec) * 2
        jp, jm, jv = jax_fused_novograd_flat(jp, jnp.asarray(g.numpy()), jm,
                                             jv, jids, step=step, **kw)
        out = fused_novograd_flat_plain(tp, g, tm, tv, ids, step=step,
                                        segments=seg, **kw)
        assert out[0] is tp and out[1] is tm and out[2] is tv  # in place
        fused_novograd_flat(wp, g, wm, wv, ids, step=step, **kw)
        _close(tp.numpy(), jp)
        _close(tm.numpy(), jm)
        _close(tv.numpy(), jv, atol=0, rtol=1e-5)
        for a, b in ((wp, tp), (wm, tm), (wv, tv)):
            assert torch.equal(a, b)      # the same plain operations
    assert sum(_build.launches.values()) == 0   # CPU: the plain update
    before = [x.clone() for x in (tp, tm, tv)]
    bad = torch.full((n,), float("inf"))
    fused_novograd_flat(tp, bad, tm, tv, ids, step=4, segments=seg,
                        found_inf=torch.tensor(True), **kw)
    for a, b in zip((tp, tm, tv), before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("norm_type", [0, 2])
@pytest.mark.parametrize("init_zero", [False, True])
def test_novograd_tree_update_matches_novograd_update(norm_type, init_zero):
    params, grads, m = _tree(1), _tree(2), _tree(3)
    kw = dict(lr=0.05, weight_decay=0.01, grad_averaging=True,
              bias_correction=True, norm_type=norm_type,
              init_zero=init_zero, inv_scale=0.25, found_inf=False)
    jv, tv = jax_scalar_zeros(_j(params)), scalar_zeros(_t(params))
    for step in (1, 2):
        jout = jax_novograd_update(_j(params), _j(grads), _j(m), jv,
                                   step=step, **kw)
        tout = novograd_update(_t(params), _t(grads), _t(m), tv, step=step,
                               **kw)
        for jt, tt in zip(jout, tout):
            for k in SHAPES:
                _close(tt[k].numpy(), jt[k])
        jv, tv = jout[2], tout[2]
        assert all(tv[k].shape == () for k in SHAPES)


@pytest.mark.parametrize("norm_type,use_flat",
                         [(2, None), (2, False), (0, None)])
def test_fused_novograd_matches_jax_over_3_steps(norm_type, use_flat):
    """The class against the JAX class (flat when ``norm_type == 2``, the
    tree otherwise or when asked): 3 steps, then an overflow step that
    changes no bit of the parameters, the moments or the step count."""
    params = _tree(4)
    kw = dict(lr=0.05, weight_decay=1e-3, norm_type=norm_type,
              use_flat=use_flat)
    jopt = JaxFusedNovoGrad(_j(params), **kw)
    topt = FusedNovoGrad(_t(params), **kw)
    assert topt.use_flat == jopt.use_flat == (norm_type == 2
                                              and use_flat is None)
    for step in range(3):
        grads = _tree(20 + step)
        jp = jopt.step(_j(grads), inv_scale=0.5)
        tp = topt.step(_t(grads), inv_scale=0.5)
        for k in SHAPES:
            assert tuple(tp[k].shape) == SHAPES[k]
            _close(tp[k].numpy(), jp[k])
    if topt.use_flat:
        _close(topt.state["v"].numpy(), jopt.state["v"], atol=0, rtol=1e-5)
    before = {k: t.clone() for k, t in tp.items()}
    bad = {k: torch.full(s, float("nan")) for k, s in SHAPES.items()}
    tp = topt.step(bad, found_inf=torch.tensor(True))
    assert int(topt._step) == int(jopt._step) == 3
    for k, t in tp.items():
        assert torch.equal(t, before[k])


def test_novograd_refusals():
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedNovoGrad({"w": torch.zeros(4)}, amsgrad=True)
    with pytest.raises(ValueError, match="norm_type=2"):
        FusedNovoGrad({"w": torch.zeros(4)}, norm_type=0, use_flat=True)


# ----------------------------------------------------------------- Adagrad


@pytest.mark.parametrize("adagrad_w_mode", [False, True])
def test_adagrad_flat_matches_pallas_over_3_steps(adagrad_w_mode):
    jp, _, tp, _, _, spec = _flat(_tree(5))
    n = tp.numel()
    jh, th = jnp.zeros(n, jnp.float32), torch.zeros(n)
    wp, wh = tp.clone(), th.clone()
    kw = dict(lr=0.05, weight_decay=0.01, adagrad_w_mode=adagrad_w_mode,
              inv_scale=0.5)
    _build.reset_launches()
    for step in (1, 2, 3):
        g = _grads(30 + step, spec) * 2
        jp, jh = jax_fused_adagrad_flat(jp, jnp.asarray(g.numpy()), jh, **kw)
        out = fused_adagrad_flat_plain(tp, g, th, **kw)
        assert out[0] is tp and out[1] is th
        fused_adagrad_flat(wp, g, wh, **kw)
        _close(tp.numpy(), jp)
        _close(th.numpy(), jh)
        assert torch.equal(wp, tp) and torch.equal(wh, th)
    assert sum(_build.launches.values()) == 0
    before = (tp.clone(), th.clone())
    bad = torch.full((n,), float("nan"))
    fused_adagrad_flat(tp, bad, th, found_inf=torch.tensor(True), **kw)
    assert torch.equal(tp, before[0]) and torch.equal(th, before[1])


@pytest.mark.parametrize("adagrad_w_mode", [False, True])
def test_adagrad_tree_update_matches_adagrad_update(adagrad_w_mode):
    params, grads = _tree(6), _tree(7)
    h = {k: np.abs(a) for k, a in _tree(8).items()}
    kw = dict(lr=0.05, weight_decay=0.01, adagrad_w_mode=adagrad_w_mode,
              inv_scale=0.25, found_inf=False)
    jout = jax_adagrad_update(_j(params), _j(grads), _j(h), **kw)
    tout = adagrad_update(_t(params), _t(grads), _t(h), **kw)
    for jt, tt in zip(jout, tout):
        for k in SHAPES:
            _close(tt[k].numpy(), jt[k])


@pytest.mark.parametrize("use_flat", [True, False])
def test_fused_adagrad_matches_jax_over_3_steps(use_flat):
    params = _tree(9)
    kw = dict(lr=1e-2, weight_decay=1e-3, use_flat=use_flat)
    jopt = JaxFusedAdagrad(_j(params), **kw)
    topt = FusedAdagrad(_t(params), **kw)
    for step in range(3):
        grads = _tree(40 + step)
        jp = jopt.step(_j(grads), inv_scale=0.5)
        tp = topt.step(_t(grads), inv_scale=0.5)
        for k in SHAPES:
            _close(tp[k].numpy(), jp[k])
    if use_flat:
        assert all(t.untyped_storage().data_ptr()
                   == topt._flat_p.untyped_storage().data_ptr()
                   for t in tp.values())
    before = {k: t.clone() for k, t in tp.items()}
    bad = {k: torch.full(s, float("inf")) for k, s in SHAPES.items()}
    tp = topt.step(bad, found_inf=torch.tensor(True))
    assert int(topt._step) == int(jopt._step) == 3
    for k, t in tp.items():
        assert torch.equal(t, before[k])
