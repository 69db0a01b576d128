"""Port parity: fused LAMB (apex_tpu_torch vs apex_tpu).

The same numpy parameters and gradients, made from a seed, go through the
JAX Pallas kernels of ``fused_lamb_flat`` (interpret mode on the CPU, as
the JAX package's own tests run them), the JAX tree update ``lamb_update``
and the JAX ``FusedLAMB``, and through the port's counterparts on CPU
tensors (the port's kernel wrappers run their plain stages there), over 3
steps.

Tolerances: 1e-6 absolute plus 1e-5 relative on parameters and moments
(both sides compute in fp32 with the same operations; the per-tensor
norms add their squares in other orders and the bias corrections come
from two ``pow`` implementations, which may differ in the last bit), and
1e-5 relative on the global gradient norm. An overflow step is held to
identical bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.pallas.fused_opt_kernels import (
    fused_lamb_flat as jax_fused_lamb_flat, row_segment_ids as
    jax_row_segment_ids)
from apex_tpu.optimizers.functional import lamb_update as jax_lamb_update
from apex_tpu.optimizers.fused_lamb import FusedLAMB as JaxFusedLAMB
from apex_tpu.utils.flatten import (flat_spec as jax_flat_spec,
                                    flatten as jax_flatten)
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.fused_opt_kernels import (
    fused_lamb_flat, fused_lamb_flat_plain, row_segment_ids, row_segments,
    segment_sums)
from apex_tpu_torch.optimizers import FusedLAMB, lamb_update
from apex_tpu_torch.utils.flatten import flat_spec, flatten

TOL = dict(atol=1e-6, rtol=1e-5)
# ragged leaves (none a multiple of the 128-element alignment), a scalar,
# and a zero leaf (a freshly initialised bias: ||p|| = 0, where use_nvlamb
# changes the trust ratio)
SHAPES = {"w": (3, 50), "b": (7,), "e": (300,), "s": (), "z": (9,),
          "m": (40, 70)}


def _tree(seed, shapes=SHAPES, zero=("z",)):
    rng = np.random.default_rng(seed)
    return {k: (np.zeros(s, np.float32) if k in zero
                else np.asarray(rng.standard_normal(s), np.float32))
            for k, s in shapes.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(a)) for k, a in tree.items()}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32), **(tol or TOL))


def test_row_segment_ids_and_layout_match_jax():
    params = _tree(0)
    jspec = jax_flat_spec(_j(params))
    tspec = flat_spec(_t(params))
    assert tspec.offsets == jspec.offsets
    jflat = jax_flatten(_j(params), jspec, dtype=jnp.float32, pad_to=1024)
    tflat = flatten(_t(params), tspec, dtype=torch.float32, pad_to=1024)
    assert tflat.numel() == jflat.size
    jids = jax_row_segment_ids(jspec, jflat.size)
    tids = row_segment_ids(tspec, tflat.numel())
    assert tids.dtype == torch.int32
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))


def test_segment_sums_equal_a_segment_sum():
    """The two-level per-tensor reduction against a plain segment sum,
    with tensors that span many chunks, sit inside one, or straddle one
    edge (fp32, 1e-5 relative: another order of additions)."""
    sizes = [5, 3000, 128, 70000, 1, 256 * 128, 7]
    tree = {f"t{i}": torch.zeros(n) for i, n in enumerate(sizes)}
    spec = flat_spec(tree)
    n = -(-spec.total_size // 1024) * 1024
    ids = row_segment_ids(spec, n)
    vals = torch.rand(ids.numel(), generator=torch.Generator().manual_seed(0))
    want = torch.zeros(len(sizes) + 1, dtype=torch.float64).index_add_(
        0, ids.long(), vals.double())[:-1]
    got = segment_sums(vals, row_segments(ids, len(sizes)))
    torch.testing.assert_close(got.double(), want, atol=0, rtol=1e-5)


@pytest.mark.parametrize("use_nvlamb", [False, True])
@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_flat_matches_pallas_over_3_steps_and_overflow(adam_w_mode,
                                                       use_nvlamb):
    """The plain stages (and the CPU route of the kernel wrapper) against
    the Pallas kernels over 3 steps with a loss scale, then an overflow
    step that changes no bit."""
    params = _tree(1)
    jspec = jax_flat_spec(_j(params))
    jp = jax_flatten(_j(params), jspec, dtype=jnp.float32, pad_to=1024)
    n = jp.size
    jm, jv = jnp.zeros(n, jnp.float32), jnp.zeros(n, jnp.float32)
    jids = jax_row_segment_ids(jspec, n)
    tspec = flat_spec(_t(params))
    tp = flatten(_t(params), tspec, dtype=torch.float32, pad_to=1024)
    tm, tv = torch.zeros(n), torch.zeros(n)
    wp, wm, wv = tp.clone(), tm.clone(), tv.clone()   # the wrapper's copy
    ids = row_segment_ids(tspec, n)
    seg = row_segments(ids, tspec.num_leaves)
    kw = dict(num_tensors=tspec.num_leaves, lr=1e-2, weight_decay=0.05,
              adam_w_mode=adam_w_mode, use_nvlamb=use_nvlamb,
              max_grad_norm=1.0)
    _build.reset_launches()
    for step in (1, 2, 3):
        gtree = _tree(10 + step, zero=())
        g = flatten(_t(gtree), tspec, dtype=torch.float32, pad_to=1024) * 4
        jp, jm, jv, jn = jax_fused_lamb_flat(
            jp, jnp.asarray(g.numpy()), jm, jv, jids, step=step,
            inv_scale=0.25, **kw)
        tn = fused_lamb_flat_plain(tp, g, tm, tv, ids, step=step,
                                   inv_scale=0.25, segments=seg, **kw)
        wn = fused_lamb_flat(wp, g, wm, wv, ids, step=step, inv_scale=0.25,
                             **kw)
        for port, ref in ((tp, jp), (tm, jm), (tv, jv)):
            _close(port.numpy(), ref)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-5)
        for a, b in ((wp, tp), (wm, tm), (wv, tv), (wn, tn)):
            assert torch.equal(a, b)       # the same plain operations
    assert sum(_build.launches.values()) == 0  # CPU: the plain stages
    before = [t.clone() for t in (tp, tm, tv)]
    bad = torch.full((n,), float("inf"))
    fused_lamb_flat_plain(tp, bad, tm, tv, ids, step=4, found_inf=True,
                          segments=seg, **kw)
    for a, b in zip((tp, tm, tv), before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("use_nvlamb,adam_w_mode,max_grad_norm",
                         [(False, True, 1.0), (True, False, 0.0)])
def test_tree_update_matches_lamb_update(use_nvlamb, adam_w_mode,
                                         max_grad_norm):
    params, grads = _tree(2), _tree(3, zero=())
    m, v = _tree(4, zero=()), {k: np.abs(a) for k, a in
                              _tree(5, zero=()).items()}
    kw = dict(step=3, lr=1e-2, weight_decay=0.05, adam_w_mode=adam_w_mode,
              use_nvlamb=use_nvlamb, max_grad_norm=max_grad_norm,
              inv_scale=0.5, found_inf=False)
    jout = jax_lamb_update(_j(params), _j(grads), _j(m), _j(v), **kw)
    tout = lamb_update(_t(params), _t(grads), _t(m), _t(v), **kw)
    for jt, tt in zip(jout[:3], tout[:3]):
        for k in SHAPES:
            _close(tt[k].numpy(), jt[k])
    np.testing.assert_allclose(float(tout[3]), float(jout[3]), rtol=1e-5)


@pytest.mark.parametrize("use_flat", [True, False])
def test_fused_lamb_matches_jax_over_3_steps(use_flat):
    """The optimizer class, flat and tree, against the JAX class: the same
    parameters, step count and global norm after 3 steps and an overflow
    step; the flat path hands back views of its buffer."""
    params = _tree(6)
    kw = dict(lr=1e-2, weight_decay=0.01, use_flat=use_flat)
    jopt = JaxFusedLAMB(_j(params), **kw)
    topt = FusedLAMB(_t(params), **kw)
    for step in range(3):
        grads = _tree(20 + step, zero=())
        jp = jopt.step(_j(grads), inv_scale=0.5)
        tp = topt.step(_t(grads), inv_scale=0.5)
        for k in SHAPES:
            assert tuple(tp[k].shape) == SHAPES[k]
            _close(tp[k].numpy(), jp[k])
    if use_flat:
        np.testing.assert_allclose(float(topt.last_grad_norm),
                                   float(jopt.last_grad_norm), rtol=1e-5)
        assert all(t.untyped_storage().data_ptr()
                   == topt._flat_p.untyped_storage().data_ptr()
                   for t in tp.values())
    before = {k: t.clone() for k, t in tp.items()}
    bad = {k: torch.full(s, float("nan")) for k, s in SHAPES.items()}
    tp = topt.step(bad, found_inf=torch.tensor(True))
    assert int(topt._step) == int(jopt._step) == 3
    for k, t in tp.items():
        assert torch.equal(t, before[k])


def test_amsgrad_raises():
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedLAMB({"w": torch.zeros(4)}, amsgrad=True)
