"""Port parity: fused SGD (apex_tpu_torch vs apex_tpu).

The same numpy parameters and gradients, made from a seed, go through the
JAX Pallas kernel ``fused_sgd_flat`` (interpret mode on the CPU, as the
JAX package's own tests run it), the JAX tree update ``sgd_update`` and
the JAX ``FusedSGD``, and through the port's counterparts on CPU tensors
(the port's kernel wrapper runs its plain version there), over 3 steps,
on a ragged flat layout (no leaf a multiple of the 128-element
alignment).

Tolerances: fp32 parameters and momentum buffers 1e-6 relative plus 1e-6
absolute on values of order 1 (both sides run the same fp32 operations,
but XLA may contract a product and a sum into one rounding, which moves a
nearly cancelled result by an ulp of its operands); bf16 parameters one
bf16 ulp
(2^-7 relative, 1e-6 absolute), where an fp32 result that differs in its
last bit rounds to the neighbouring bf16 value. Overflow steps are held
to identical bits, the step counter included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.pallas.fused_sgd_kernel import (
    fused_sgd_flat as jax_fused_sgd_flat)
from apex_tpu.optimizers.functional import sgd_update as jax_sgd_update
from apex_tpu.optimizers.fused_sgd import FusedSGD as JaxFusedSGD
from apex_tpu.utils.flatten import (flat_spec as jax_flat_spec,
                                    flatten as jax_flatten)
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.fused_sgd_kernel import (fused_sgd_flat,
                                                 fused_sgd_flat_plain)
from apex_tpu_torch.optimizers import FusedSGD, sgd_update
from apex_tpu_torch.utils.flatten import flat_spec, flatten

TOL = {"fp32": dict(atol=1e-6, rtol=1e-6),
       "bf16": dict(atol=1e-6, rtol=2 ** -7)}
SHAPES = {"w": (3, 50), "b": (7,), "e": (300,), "s": (), "m": (40, 70)}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
# (momentum, dampening, nesterov, wd_after_momentum)
FLAGS = [(0.9, 0.0, False, False), (0.9, 0.1, False, True),
         (0.9, 0.0, True, False), (0.9, 0.0, True, True),
         (0.0, 0.0, False, False)]


def _tree(seed, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(rng.standard_normal(s), np.float32)
            for k, s in shapes.items()}


def _t(tree, dtype=torch.float32):
    return {k: torch.from_numpy(np.array(a)).to(dtype)
            for k, a in tree.items()}


def _j(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _close(port, ref, dt="fp32"):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32), **TOL[dt])


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("momentum,dampening,nesterov,wd_after", FLAGS)
def test_flat_kernel_matches_pallas_over_3_steps(momentum, dampening,
                                                 nesterov, wd_after, dt):
    """The plain version (the CPU route of the wrapper) against the Pallas
    kernel over 3 steps with a loss scale (the first initialises the
    buffer), then an overflow step that changes no bit."""
    params = _tree(0)
    jspec = jax_flat_spec(_j(params))
    jp = jax_flatten(_j(params), jspec, dtype=JDT[dt], pad_to=1024)
    tspec = flat_spec(_t(params))
    tp = flatten(_t(params), tspec, dtype=TDT[dt], pad_to=1024)
    assert tp.numel() == jp.size and tp.dtype == TDT[dt]
    n = tp.numel()
    jb, tb = jnp.zeros(n, jnp.float32), torch.zeros(n)
    wp, wb = tp.clone(), tb.clone()    # through the wrapper
    kw = dict(lr=0.05, momentum=momentum, dampening=dampening,
              weight_decay=0.01, nesterov=nesterov,
              wd_after_momentum=wd_after, inv_scale=0.5)
    _build.reset_launches()
    for step in (1, 2, 3):
        g = flatten(_t(_tree(10 + step)), tspec, dtype=TDT[dt],
                    pad_to=1024) * 2
        jp, jb = jax_fused_sgd_flat(
            jp, jnp.asarray(g.float().numpy(), JDT[dt]), jb,
            first_step=step == 1, **kw)
        out = fused_sgd_flat_plain(tp, g, tb, first_step=step == 1, **kw)
        assert out[0] is tp and out[1] is tb           # in place
        fused_sgd_flat(wp, g, wb, first_step=step == 1, **kw)
        _close(tp.float().numpy(), jp, dt)
        _close(tb.numpy(), jb)
        assert torch.equal(wp, tp) and torch.equal(wb, tb)
    assert sum(_build.launches.values()) == 0   # CPU: the plain version
    if momentum == 0.0:
        assert not tb.any()      # no momentum: the buffer keeps its zeros
    before = (tp.clone(), tb.clone())
    bad = torch.full((n,), float("inf"), dtype=TDT[dt])
    fused_sgd_flat(tp, bad, tb, found_inf=torch.tensor(True), **kw)
    assert torch.equal(tp, before[0]) and torch.equal(tb, before[1])


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("momentum,dampening,nesterov,wd_after", FLAGS[:3])
def test_tree_update_matches_sgd_update(momentum, dampening, nesterov,
                                        wd_after, master):
    params, grads, buf = _tree(1), _tree(2), _tree(3)
    kw = dict(lr=0.05, momentum=momentum, dampening=dampening,
              weight_decay=0.01, nesterov=nesterov,
              wd_after_momentum=wd_after, inv_scale=0.25, found_inf=False)
    for first in (True, False):
        jout = jax_sgd_update(_j(params), _j(grads), _j(buf),
                              first_step=first,
                              master=_j(params) if master else None, **kw)
        tout = sgd_update(_t(params), _t(grads), _t(buf), first_step=first,
                          master=_t(params) if master else None, **kw)
        assert len(jout) == len(tout) == (3 if master else 2)
        for jt, tt in zip(jout, tout):
            for k in SHAPES:
                _close(tt[k].numpy(), jt[k])


@pytest.mark.parametrize("use_flat", [True, False])
@pytest.mark.parametrize("momentum,nesterov,wd_after",
                         [(0.9, False, False), (0.9, True, True),
                          (0.0, False, False)])
def test_fused_sgd_matches_jax_over_3_steps(momentum, nesterov, wd_after,
                                            use_flat):
    """The class, flat and tree, against the JAX class: 3 steps, then an
    overflow step that changes no bit of the parameters, the buffers or
    the step count; the flat path hands back views of its buffer."""
    params = _tree(4)
    kw = dict(lr=0.05, momentum=momentum, weight_decay=1e-4,
              nesterov=nesterov, wd_after_momentum=wd_after,
              use_flat=use_flat)
    jopt = JaxFusedSGD(_j(params), **kw)
    topt = FusedSGD(_t(params), **kw)
    for step in range(3):
        grads = _tree(20 + step)
        jp = jopt.step(_j(grads), inv_scale=0.5)
        tp = topt.step(_t(grads), inv_scale=0.5)
        for k in SHAPES:
            assert tuple(tp[k].shape) == SHAPES[k]
            _close(tp[k].numpy(), jp[k])
    if use_flat:
        assert topt._flat_p.numel() == jopt._flat_p.size
        assert all(t.untyped_storage().data_ptr()
                   == topt._flat_p.untyped_storage().data_ptr()
                   for t in tp.values())
    before = ({k: t.clone() for k, t in tp.items()},
              {k: (t.clone() if torch.is_tensor(t) else
                   {n: x.clone() for n, x in t.items()})
               for k, t in topt.state.items()})
    bad = {k: torch.full(s, float("nan")) for k, s in SHAPES.items()}
    tp = topt.step(bad, found_inf=torch.tensor(True))
    assert int(topt._step) == int(jopt._step) == 3
    for k, t in tp.items():
        assert torch.equal(t, before[0][k])
    for k, t in topt.state.items():
        if torch.is_tensor(t):
            assert torch.equal(t, before[1][k])
        else:
            assert all(torch.equal(x, before[1][k][n]) for n, x in t.items())


@pytest.mark.parametrize("use_flat", [True, False])
def test_overflowed_first_step_leaves_the_next_step_first(use_flat):
    """A first step that overflows: the flat path's first step is ``step
    == 0`` before the counter advances and the tree path's ``step == 1``
    after it, so in both the next applied step initialises the buffer, as
    in the JAX class."""
    params = _tree(5)
    kw = dict(lr=0.1, momentum=0.9, dampening=0.5, use_flat=use_flat)
    jopt = JaxFusedSGD(_j(params), **kw)
    topt = FusedSGD(_t(params), **kw)
    bad = _tree(30)
    jopt.step(_j(bad), found_inf=True)
    topt.step(_t(bad), found_inf=torch.tensor(True))
    for step in range(2):
        grads = _tree(31 + step)
        jp = jopt.step(_j(grads))
        tp = topt.step(_t(grads))
        for k in SHAPES:
            _close(tp[k].numpy(), jp[k])
    assert int(topt._step) == int(jopt._step) == 2


@pytest.mark.parametrize("use_flat", [True, False])
def test_master_weights_match_jax(use_flat):
    """bf16 parameters with fp32 masters (the flat buffer is the master on
    the flat path): the parameters are the masters' bf16 cast."""
    params = _tree(6)
    kw = dict(lr=0.05, momentum=0.9, weight_decay=1e-4, master_weights=True,
              use_flat=use_flat)
    jopt = JaxFusedSGD(_j(params, jnp.bfloat16), **kw)
    topt = FusedSGD(_t(params, torch.bfloat16), **kw)
    for step in range(3):
        grads = _tree(40 + step)
        jp = jopt.step(_j(grads, jnp.bfloat16))
        tp = topt.step(_t(grads, torch.bfloat16))
    for k in SHAPES:
        assert tp[k].dtype == torch.bfloat16
        _close(tp[k].float().numpy(), np.asarray(jp[k], np.float32), "bf16")


def test_nesterov_needs_momentum_and_no_dampening():
    for kw in (dict(momentum=0.0), dict(momentum=0.9, dampening=0.1)):
        with pytest.raises(ValueError, match="Nesterov"):
            FusedSGD({"w": torch.zeros(4)}, lr=0.1, nesterov=True, **kw)
