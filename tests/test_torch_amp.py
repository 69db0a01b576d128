"""Port parity: dynamic loss scaling, multi-tensor ops and flat buffers
(apex_tpu_torch vs apex_tpu).

- The scaler's state machine is held to the JAX one **exactly** (scale,
  growth tracker and hysteresis tracker, every step) over a scripted
  found_inf sequence, with hysteresis 1 and 2, growth included, and at a
  scale whose growth would overflow fp32.
- ``unscale_and_norm``: the unscaled gradients exactly (one fp32 multiply
  each), the global norm to 1e-6 relative (squares summed in another
  order), found_inf exactly.
- ``flat_spec`` offsets, padded sizes and totals equal the JAX planner's,
  and ``flatten`` gives the same buffer (zero padding included) exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.amp.grad_scaler import DynamicGradScaler as JaxScaler
from apex_tpu.multi_tensor.functional import (
    multi_tensor_scale as jax_multi_tensor_scale)
from apex_tpu.utils.flatten import (flat_spec as jax_flat_spec,
                                    flatten as jax_flatten)
from apex_tpu_torch.amp import DynamicGradScaler, GradScaler
from apex_tpu_torch.multi_tensor.functional import multi_tensor_scale
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.utils.flatten import flat_spec, flatten, unflatten

SCRIPT = [False, False, True, False, False, False, True, True, False, True,
          True, True, False, False, False, False, False, True, False, False]


def _state(s):
    return (np.float32(np.asarray(s.scale)), int(np.asarray(
        s.growth_tracker)), int(np.asarray(s.hysteresis_tracker)))


@pytest.mark.parametrize("init_scale", [2.0 ** 12, 2.0 ** 127])
@pytest.mark.parametrize("hysteresis", [1, 2])
def test_scaler_state_equals_jax_exactly(hysteresis, init_scale):
    kw = dict(init_scale=init_scale, growth_interval=3,
              hysteresis=hysteresis)
    js, ts = JaxScaler(**kw), DynamicGradScaler(**kw)
    jstate, tstate = js.init(), ts.init(device="cpu")
    assert _state(tstate) == _state(jstate)
    seen = set()
    for found in SCRIPT:
        jstate = js.update(jstate, jnp.asarray(found))
        tstate = ts.update(tstate, torch.tensor(found))
        assert tstate.scale.dtype == torch.float32
        assert tstate.growth_tracker.dtype == torch.int32
        assert _state(tstate) == _state(jstate), found
        seen.add(_state(tstate)[0])
    assert len(seen) >= 3  # the script both grows and backs off


@pytest.mark.parametrize("poison", [False, True])
def test_unscale_and_norm_matches_jax(poison):
    rng = np.random.default_rng(3)
    grads = {"a": rng.standard_normal((5, 7)).astype(np.float32) * 512,
             "b": rng.standard_normal(33).astype(np.float32) * 512}
    if poison:
        grads["b"][4] = np.inf
    js, ts = JaxScaler(init_scale=512.0), DynamicGradScaler(init_scale=512.0)
    jg, jn, jf = js.unscale_and_norm({k: jnp.asarray(a) for k, a in
                                      grads.items()}, js.init())
    tg, tn, tf = ts.unscale_and_norm({k: torch.from_numpy(a) for k, a in
                                      grads.items()}, ts.init(device="cpu"))
    assert bool(tf) == bool(jf) == poison
    ug, uf = ts.unscale({k: torch.from_numpy(a) for k, a in grads.items()},
                        ts.init(device="cpu"))
    assert bool(uf) == poison
    for k in grads:
        np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
        np.testing.assert_array_equal(ug[k].numpy(), np.asarray(jg[k]))
    if not poison:
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    # the plain scale op: same values and flag as the JAX one
    out, found = multi_tensor_scale([torch.from_numpy(grads["a"])], 0.25)
    jout, jfound = jax_multi_tensor_scale([jnp.asarray(grads["a"])], 0.25)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jout[0]))
    assert bool(found) == bool(jfound) is False


def test_disabled_scaler_is_the_identity():
    ts = DynamicGradScaler(enabled=False)
    st = ts.init(device="cpu")
    loss = torch.tensor(3.0)
    assert ts.scale(loss, st) is loss
    g = {"a": torch.ones(3)}
    out, norm, found = ts.unscale_and_norm(g, st)
    assert out is g and float(norm) == pytest.approx(3 ** 0.5)
    assert not bool(found) and ts.update(st, torch.tensor(True)) is st


def test_grad_scaler_step_skips_overflow_and_backs_off():
    opt = FusedAdam({"w": torch.ones(4)}, lr=0.1)
    sc = GradScaler(device="cpu", init_scale=8.0)
    sc.step(opt, {"w": torch.full((4,), 8.0)})
    after = opt.parameters["w"].clone()
    assert not torch.equal(after, torch.ones(4))
    sc.step(opt, {"w": torch.full((4,), float("inf"))})
    assert torch.equal(opt.parameters["w"], after)
    assert sc.get_scale() == 4.0 and int(opt._step) == 1


SPEC_TREES = [
    {"w": (3, 50), "b": (7,), "e": (130,), "s": ()},
    {"h": {"k": (64, 3), "z": (128,)}, "a": (1,), "m": (129, 2)},
]


@pytest.mark.parametrize("shapes", SPEC_TREES)
def test_flat_spec_offsets_equal_jax(shapes):
    rng = np.random.default_rng(0)

    def build(sh):
        if isinstance(sh, dict):
            return {k: build(v) for k, v in sh.items()}
        return np.asarray(rng.standard_normal(sh), np.float32)

    tree = build(shapes)

    def convert(t, mk):
        if isinstance(t, dict):
            return {k: convert(v, mk) for k, v in t.items()}
        return mk(t)

    jtree = convert(tree, jnp.asarray)
    ttree = convert(tree, lambda a: torch.from_numpy(np.array(a)))
    js, ts = jax_flat_spec(jtree), flat_spec(ttree)
    assert ts.offsets == js.offsets
    assert ts.padded_sizes == js.padded_sizes
    assert ts.total_size == js.total_size
    assert ts.shapes == js.shapes
    jflat = jax_flatten(jtree, js, pad_to=1024)
    tflat = flatten(ttree, ts, pad_to=1024)
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    back = unflatten(tflat, ts)
    assert convert(back, lambda t: t.numpy().tolist()) == \
        convert(ttree, lambda t: t.numpy().tolist())
