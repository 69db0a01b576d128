"""Port parity: LayerNorm forward and backward (apex_tpu_torch vs
apex_tpu).

The same numpy inputs, made from a seed, go through the JAX Pallas kernels
``ln_fwd_pallas`` / ``ln_bwd_pallas`` (interpret mode on the CPU, as the
JAX package's own tests run them) or the JAX ``fused_layer_norm_affine``
(and its ``jax.grad``), and through the port's ``ln_fwd`` / ``ln_bwd`` on
CPU tensors, which run the CUDA kernels' plain versions, and the port's
autograd. Tolerances: fp32 1e-5 absolute; bf16 outputs compared in fp32 to
one bf16 ulp of the JAX value (the two frameworks may round the last bit
differently); fp32 statistics 1e-5; dgamma / dbeta (fp32 sums over rows,
in another order) 1e-4 absolute; bf16 dx two bf16 ulps. The RMSNorm and
no-gamma forms are held to the same tolerances as the LayerNorm form.
bfloat16 weights and biases, and rows wider than the kernels take (the
JAX ``_pallas_ok`` route to the plain reference), are held against JAX as
stated at their tests.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.normalization.fused_layer_norm import (
    FusedLayerNorm as JaxFusedLayerNorm, FusedRMSNorm as JaxFusedRMSNorm,
    fused_layer_norm as jax_fused_layer_norm, fused_layer_norm_affine as
    jax_fused_layer_norm_affine, fused_rms_norm as jax_fused_rms_norm,
    fused_rms_norm_affine as jax_fused_rms_norm_affine)
from apex_tpu.ops.pallas.layer_norm_kernel import (ln_bwd_pallas,
                                                   ln_fwd_pallas)
from apex_tpu_torch.normalization.fused_layer_norm import (
    FusedLayerNorm, FusedRMSNorm, fused_layer_norm, fused_layer_norm_affine,
    fused_rms_norm, fused_rms_norm_affine, manual_layer_norm,
    manual_rms_norm)
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.layer_norm_kernel import (ln_bwd, ln_bwd_plain,
                                                  ln_fwd, ln_fwd_plain)

EPS = 1e-5
DTYPES = {"fp32": (np.float32, jnp.float32, torch.float32),
          "bf16": (None, jnp.bfloat16, torch.bfloat16)}


def _inputs(rows, hidden, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, hidden)) * 2.0 + 0.5).astype(np.float32)
    g = rng.standard_normal(hidden).astype(np.float32)
    b = rng.standard_normal(hidden).astype(np.float32)
    return x, g, b


def _bf16_ulp(ref: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each reference value (8 significant bits)."""
    _, e = np.frexp(np.abs(ref).astype(np.float64))
    return np.ldexp(1.0, e - 8)


def _assert_y(port, ref, dtype, ulps=1):
    port = np.asarray(port, np.float32)
    ref = np.asarray(ref, np.float32)
    if dtype == "fp32":
        np.testing.assert_allclose(port, ref, atol=1e-5, rtol=0)
    else:
        assert np.all(np.abs(port - ref) <= ulps * _bf16_ulp(ref)), \
            np.max(np.abs(port - ref))


def _to_jax(a, dtype):
    return jnp.asarray(a).astype(DTYPES[dtype][1])


def _to_torch(a, dtype):
    return torch.from_numpy(a).to(DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("rows", [16, 13, 1])
def test_ln_fwd_matches_pallas_kernel(rows, dtype):
    """y, mean and invvar of the port's kernel path against the Pallas
    kernel, ragged row counts included (the TPU kernel pads to 8, the
    port's kernel does not need to)."""
    x, g, b = _inputs(rows, 256, seed=rows)
    yj, mj, ivj = ln_fwd_pallas(_to_jax(x, dtype), jnp.asarray(g),
                                jnp.asarray(b), eps=EPS, rms=False)
    yt, mt, ivt = ln_fwd(_to_torch(x, dtype), torch.from_numpy(g),
                         torch.from_numpy(b), eps=EPS)
    assert yt.dtype == DTYPES[dtype][2] and yt.shape == (rows, 256)
    assert mt.shape == ivt.shape == (rows, 1)
    _assert_y(yt.float().numpy(), np.asarray(yj.astype(jnp.float32)),
              dtype)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(ivt.numpy(), np.asarray(ivj), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("hidden", [256, 96])
def test_fused_layer_norm_affine_matches_jax(hidden, dtype):
    """The functional form over a 3-D input. At hidden 96 the JAX package
    takes its jnp fallback (not a multiple of 128); the port's kernel
    takes any hidden size up to its stated limit."""
    x, g, b = _inputs(2 * 5, hidden, seed=hidden)
    x3 = x.reshape(2, 5, hidden)
    yj = jax_fused_layer_norm_affine(_to_jax(x3, dtype), jnp.asarray(g),
                                     jnp.asarray(b), hidden, EPS)
    yt = fused_layer_norm_affine(_to_torch(x3, dtype), torch.from_numpy(g),
                                 torch.from_numpy(b), hidden, EPS)
    assert yt.shape == (2, 5, hidden)
    _assert_y(yt.float().numpy(), np.asarray(yj.astype(jnp.float32)),
              dtype)


def test_fused_layer_norm_module_matches_flax():
    x, _, _ = _inputs(6, 256, seed=7)
    x3 = x.reshape(2, 3, 256)
    mod = JaxFusedLayerNorm(256)
    variables = mod.init(__import__("jax").random.PRNGKey(0),
                         jnp.asarray(x3))
    yj = mod.apply(variables, jnp.asarray(x3))
    port = FusedLayerNorm(256, device="cpu")
    assert port.weight.dtype == torch.float32
    np.testing.assert_array_equal(
        port.weight.detach().numpy(),
        np.asarray(variables["params"]["weight"]))
    with torch.no_grad():
        yt = port(torch.from_numpy(x3))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5,
                               rtol=0)


def test_kernel_path_agrees_with_manual_reference_and_counts_nothing():
    """On CPU tensors the wrapper runs the plain version — the same
    numbers as the plain reference — and launches no kernel."""
    x, g, b = _inputs(9, 96, seed=11)
    _build.reset_launches()
    xt, gt, bt = map(torch.from_numpy, (x, g, b))
    y = fused_layer_norm_affine(xt, gt, bt, 96, EPS)
    torch.testing.assert_close(y, manual_layer_norm(xt, gt, bt, 96, EPS),
                               atol=1e-6, rtol=0)
    torch.testing.assert_close(ln_fwd(xt, gt, bt, eps=EPS)[0],
                               ln_fwd_plain(xt, gt, bt, eps=EPS)[0],
                               atol=0, rtol=0)
    assert sum(_build.launches.values()) == 0


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("rows", [16, 13])
def test_ln_bwd_matches_pallas_kernel(rows, dtype, with_bias):
    """dx, dgamma and dbeta (None without a bias) of the port's kernel path
    against ``ln_bwd_pallas`` on the same saved statistics."""
    x, g, b = _inputs(rows, 256, seed=rows + 1)
    dy = np.random.default_rng(rows).standard_normal((rows, 256)) \
        .astype(np.float32)
    jb = jnp.asarray(b) if with_bias else None
    _, mj, ivj = ln_fwd_pallas(_to_jax(x, dtype), jnp.asarray(g), jb,
                               eps=EPS, rms=False)
    dxj, dgj, dbj = ln_bwd_pallas(_to_jax(dy, dtype), _to_jax(x, dtype),
                                  jnp.asarray(g), jb, mj, ivj, rms=False,
                                  memory_efficient=False)
    dxt, dgt, dbt = ln_bwd(
        _to_torch(dy, dtype), _to_torch(x, dtype), torch.from_numpy(g),
        torch.from_numpy(b) if with_bias else None,
        torch.from_numpy(np.array(mj)), torch.from_numpy(np.array(ivj)))
    assert dxt.dtype == DTYPES[dtype][2] and dgt.dtype == torch.float32
    _assert_y(dxt.float().numpy(), np.asarray(dxj.astype(jnp.float32)),
              dtype, ulps=2)
    np.testing.assert_allclose(dgt.numpy(), np.asarray(dgj), atol=1e-4,
                               rtol=1e-5)
    if with_bias:
        np.testing.assert_allclose(dbt.numpy(), np.asarray(dbj), atol=1e-4,
                                   rtol=1e-5)
    else:
        assert dbt is None and dbj is None


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("hidden", [256, 96])
def test_autograd_matches_jax_grad(hidden, with_bias):
    """Gradients of a weighted sum of ``fused_layer_norm_affine`` with
    respect to x, weight and bias: the port's autograd (through ln_bwd)
    against ``jax.grad`` (through ln_bwd_pallas; the jnp path at hidden
    96)."""
    x, g, b = _inputs(2 * 6, hidden, seed=hidden + with_bias)
    x3 = x.reshape(2, 6, hidden)
    w = np.random.default_rng(1).standard_normal(x3.shape).astype(np.float32)

    def jloss(x_, g_, b_):
        y = jax_fused_layer_norm_affine(x_, g_, b_, hidden, EPS)
        return jnp.sum(y * w)

    argn = (0, 1, 2) if with_bias else (0, 1)
    jgrads = jax.grad(jloss, argnums=argn)(
        jnp.asarray(x3), jnp.asarray(g), jnp.asarray(b) if with_bias
        else None)
    xt, gt = (torch.from_numpy(a).requires_grad_() for a in (x3, g))
    bt = torch.from_numpy(b).requires_grad_() if with_bias else None
    y = fused_layer_norm_affine(xt, gt, bt, hidden, EPS)
    (y * torch.from_numpy(w)).sum().backward()
    tgrads = (xt.grad, gt.grad) + ((bt.grad,) if with_bias else ())
    for tg, jg in zip(tgrads, jgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-4,
                                   rtol=1e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_bias_none_matches_upstream(dtype):
    """``fused_layer_norm_affine(x, w, None, h)`` as upstream takes it: no
    bias is added (this raised AttributeError in the first slice)."""
    x, g, _ = _inputs(8, 256, seed=21)
    yj = jax_fused_layer_norm_affine(_to_jax(x, dtype), jnp.asarray(g), None,
                                     256, EPS)
    yt = fused_layer_norm_affine(_to_torch(x, dtype), torch.from_numpy(g),
                                 None, 256, EPS)
    _assert_y(yt.float().numpy(), np.asarray(yj.astype(jnp.float32)), dtype)
    with pytest.raises(NotImplementedError, match="memory_efficient"):
        fused_layer_norm_affine(_to_torch(x, dtype), torch.from_numpy(g),
                                None, 256, EPS, memory_efficient=True)


def test_ln_bwd_plain_is_the_autograd_of_the_plain_forward():
    """The plain backward is the exact derivative of the plain forward:
    held against torch autograd of ``ln_fwd_plain`` (fp32, 1e-5)."""
    x, g, b = _inputs(7, 96, seed=5)
    xt, gt, bt = (torch.from_numpy(a).double().requires_grad_()
                  for a in (x, g, b))
    y, mean, invvar = ln_fwd_plain(xt.float(), gt.float(), bt.float(),
                                   eps=EPS)
    dy = torch.randn(7, 96, generator=torch.Generator().manual_seed(0))
    y.backward(dy)
    dx, dg, db = ln_bwd_plain(dy, xt.detach().float(), gt.detach().float(),
                              bt.detach().float(), mean.detach(),
                              invvar.detach())
    for mine, ref in ((dx, xt.grad), (dg, gt.grad), (db, bt.grad)):
        torch.testing.assert_close(mine, ref.float(), atol=1e-5, rtol=1e-5)


# (rms, affine): RMSNorm with and without gamma, LayerNorm without gamma
FORMS = [(True, True), (True, False), (False, False)]


@pytest.mark.parametrize("rms,affine", FORMS)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("hidden", [128, 256])
def test_rms_and_no_gamma_fwd_bwd_match_pallas_kernels(hidden, dtype, rms,
                                                       affine):
    """y, the statistics (a zero mean for RMSNorm), dx and dgamma (None
    without gamma) of the port's kernel path against ``ln_fwd_pallas`` /
    ``ln_bwd_pallas`` in interpret mode, ragged rows (13)."""
    rows = 13
    x, g, _ = _inputs(rows, hidden, seed=hidden + 2 * rms + affine)
    dy = np.random.default_rng(hidden + 100).standard_normal(
        (rows, hidden)).astype(np.float32)
    jg = jnp.asarray(g) if affine else None
    tg = torch.from_numpy(g) if affine else None
    yj, mj, ivj = ln_fwd_pallas(_to_jax(x, dtype), jg, None, eps=EPS,
                                rms=rms)
    yt, mt, ivt = ln_fwd(_to_torch(x, dtype), tg, None, eps=EPS, rms=rms)
    _assert_y(yt.float().numpy(), np.asarray(yj.astype(jnp.float32)), dtype)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-5,
                               rtol=0)
    if rms:
        assert torch.equal(mt, torch.zeros(rows, 1))
    np.testing.assert_allclose(ivt.numpy(), np.asarray(ivj), atol=1e-5,
                               rtol=1e-5)
    dxj, dgj, _ = ln_bwd_pallas(_to_jax(dy, dtype), _to_jax(x, dtype), jg,
                                None, mj, ivj, rms=rms,
                                memory_efficient=False)
    dxt, dgt, dbt = ln_bwd(_to_torch(dy, dtype), _to_torch(x, dtype), tg,
                           None, None if rms else mt, ivt, rms=rms)
    assert dbt is None
    _assert_y(dxt.float().numpy(), np.asarray(dxj.astype(jnp.float32)),
              dtype, ulps=2)
    if affine:
        np.testing.assert_allclose(dgt.numpy(), np.asarray(dgj), atol=1e-4,
                                   rtol=1e-5)
    else:
        assert dgt is None and dgj is None


@pytest.mark.parametrize("rms,affine", FORMS)
@pytest.mark.parametrize("hidden", [128, 96])
def test_rms_and_no_gamma_functions_match_jax(hidden, rms, affine):
    """The functional forms and their gradients against the JAX functions
    and ``jax.grad`` (Pallas at 128, the jnp path at 96); fp32, 1e-5 on y
    and 1e-4 on the gradients."""
    x, g, _ = _inputs(2 * 6, hidden, seed=3 * hidden + rms)
    x3 = x.reshape(2, 6, hidden)
    w = np.random.default_rng(4).standard_normal(x3.shape).astype(np.float32)
    jfn = {(True, True): lambda x_, g_: jax_fused_rms_norm_affine(
               x_, g_, hidden, EPS),
           (True, False): lambda x_, g_: jax_fused_rms_norm(x_, hidden, EPS),
           (False, False): lambda x_, g_: jax_fused_layer_norm(
               x_, hidden, EPS)}[(rms, affine)]
    tfn = {(True, True): lambda x_, g_: fused_rms_norm_affine(
               x_, g_, hidden, EPS),
           (True, False): lambda x_, g_: fused_rms_norm(x_, hidden, EPS),
           (False, False): lambda x_, g_: fused_layer_norm(
               x_, hidden, EPS)}[(rms, affine)]
    yj = jfn(jnp.asarray(x3), jnp.asarray(g))
    jgrads = jax.grad(lambda x_, g_: jnp.sum(jfn(x_, g_) * w),
                      argnums=(0, 1))(jnp.asarray(x3), jnp.asarray(g))
    xt, gt = (torch.from_numpy(a).requires_grad_() for a in (x3, g))
    yt = tfn(xt, gt)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj),
                               atol=1e-5, rtol=0)
    (yt * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrads[0]),
                               atol=1e-4, rtol=1e-5)
    if affine:
        np.testing.assert_allclose(gt.grad.numpy(), np.asarray(jgrads[1]),
                                   atol=1e-4, rtol=1e-5)
    else:
        assert gt.grad is None
    manual = (manual_rms_norm(xt, gt if affine else None, hidden, EPS)
              if rms else manual_layer_norm(xt, None, None, hidden, EPS))
    torch.testing.assert_close(yt, manual, atol=1e-5, rtol=0)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("rms", [True, False])
def test_norm_modules_match_flax(rms, affine):
    """``FusedRMSNorm`` / ``FusedLayerNorm(elementwise_affine=...)``
    against the flax modules: parameter names, values and dtype, and the
    output (fp32, 1e-5)."""
    x, _, _ = _inputs(6, 128, seed=9)
    x3 = x.reshape(2, 3, 128)
    jcls, tcls = ((JaxFusedRMSNorm, FusedRMSNorm) if rms
                  else (JaxFusedLayerNorm, FusedLayerNorm))
    mod = jcls(128, elementwise_affine=affine)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x3))
    port = tcls(128, elementwise_affine=affine, device="cpu")
    jnames = set(variables.get("params", {}))
    assert {n for n, _ in port.named_parameters()} == jnames
    for name, p in port.named_parameters():
        assert p.dtype == torch.float32
        np.testing.assert_array_equal(p.detach().numpy(),
                                      np.asarray(variables["params"][name]))
    with torch.no_grad():
        yt = port(torch.from_numpy(x3))
    np.testing.assert_allclose(yt.numpy(),
                               np.asarray(mod.apply(variables,
                                                    jnp.asarray(x3))),
                               atol=1e-5, rtol=0)


def test_rms_bwd_plain_is_the_autograd_of_the_plain_forward():
    """The RMSNorm plain backward is the exact derivative of the plain
    forward, with and without gamma (fp32, 1e-5)."""
    x, g, _ = _inputs(7, 96, seed=6)
    dy = torch.randn(7, 96, generator=torch.Generator().manual_seed(1))
    for affine in (True, False):
        xt, gt = (torch.from_numpy(a).requires_grad_() for a in (x, g))
        y, mean, invvar = ln_fwd_plain(xt, gt if affine else None, None,
                                       eps=EPS, rms=True)
        y.backward(dy)
        dx, dg, db = ln_bwd_plain(dy, xt.detach(), gt.detach() if affine
                                  else None, None, None, invvar.detach(),
                                  rms=True)
        assert db is None and (dg is None) == (not affine)
        torch.testing.assert_close(dx, xt.grad, atol=1e-5, rtol=1e-5)
        if affine:
            torch.testing.assert_close(dg, gt.grad, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_bf16_parameters_match_jax_module(dtype):
    """bfloat16 weight and bias, as the JAX ``FusedLayerNorm(param_dtype=
    bfloat16)`` holds them: y and dx against ``jax.grad`` of the flax
    module, and dweight / dbias come back in bfloat16 with JAX's values
    (one bf16 ulp of the JAX value, plus 1e-3 for fp32 sums over rows in
    another order)."""
    x, g, b = _inputs(2 * 5, 256, seed=41)
    x3 = x.reshape(2, 5, 256)
    r = np.random.default_rng(42).standard_normal(x3.shape).astype(
        np.float32)
    wj = jnp.asarray(g).astype(jnp.bfloat16)
    bj = jnp.asarray(b).astype(jnp.bfloat16)
    mod = JaxFusedLayerNorm(256, param_dtype=jnp.bfloat16)

    def jloss(x_, w_, b_):
        y = mod.apply({"params": {"weight": w_, "bias": b_}}, x_)
        return jnp.sum(y.astype(jnp.float32) * r), y

    (_, yj), (dxj, dwj, dbj) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(_to_jax(x3, dtype), wj, bj)
    xt = _to_torch(x3, dtype).requires_grad_()
    wt = torch.from_numpy(g).bfloat16().requires_grad_()
    bt = torch.from_numpy(b).bfloat16().requires_grad_()
    y = fused_layer_norm_affine(xt, wt, bt, 256, EPS)
    (y.float() * torch.from_numpy(r)).sum().backward()
    _assert_y(y.detach().float().numpy(), np.asarray(yj.astype(jnp.float32)),
              dtype)
    _assert_y(xt.grad.float().numpy(), np.asarray(dxj.astype(jnp.float32)),
              dtype, ulps=2)
    assert wt.grad.dtype == bt.grad.dtype == torch.bfloat16
    for got, want in ((wt.grad, dwj), (bt.grad, dbj)):
        want = np.asarray(want.astype(jnp.float32))
        assert np.all(np.abs(got.float().numpy() - want)
                      <= _bf16_ulp(want) + 1e-3)


@pytest.mark.parametrize("rms", [False, True])
def test_rows_wider_than_65536_take_the_kernel_route(rms, monkeypatch):
    """Above 65536, where the JAX package's ``_pallas_ok`` sends rows to
    its plain reference, the port keeps the kernels' autograd function
    (on CPU tensors their plain twins; on CUDA the wide forms,
    ``tests/test_torch_cuda.py``): y equals ``manual_layer_norm`` /
    ``manual_rms_norm``, and y and the gradients equal JAX's (1e-5; 1e-4
    for dweight)."""
    fln = importlib.import_module(
        "apex_tpu_torch.normalization.fused_layer_norm")
    calls = []
    apply = fln._FusedNorm.apply
    monkeypatch.setattr(fln._FusedNorm, "apply",
                        lambda *a: calls.append(a[3]) or apply(*a))
    hidden = 65536 + 64
    x, g, b = _inputs(2, hidden, seed=43)
    _build.reset_launches()
    xt, gt = (torch.from_numpy(a).requires_grad_() for a in (x, g))
    bt = torch.from_numpy(b).requires_grad_()
    if rms:
        y = fused_rms_norm_affine(xt, gt, hidden, EPS)
        jf = lambda x_, g_: jax_fused_rms_norm_affine(x_, g_, hidden, EPS)
        torch.testing.assert_close(y, manual_rms_norm(xt, gt, hidden, EPS))
    else:
        y = fused_layer_norm_affine(xt, gt, bt, hidden, EPS)
        jf = lambda x_, g_: jax_fused_layer_norm_affine(
            x_, g_, jnp.asarray(b), hidden, EPS)
        torch.testing.assert_close(y, manual_layer_norm(xt, gt, bt, hidden,
                                                        EPS))
    y.square().sum().backward()
    assert calls == [hidden]
    assert sum(_build.launches.values()) == 0   # CPU: no kernel
    yj = jf(jnp.asarray(x), jnp.asarray(g))
    gxj, ggj = jax.grad(lambda x_, g_: jnp.sum(jf(x_, g_) ** 2),
                        (0, 1))(jnp.asarray(x), jnp.asarray(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(yj),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gxj), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(gt.grad.numpy(), np.asarray(ggj), atol=1e-4,
                               rtol=1e-5)
