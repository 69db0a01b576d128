"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (at run time, not at collection) where
there is no CUDA device, and runs on an H100 with
``python -m pytest tests/test_torch_cuda.py -q``. ``chip_smoke.py`` holds
the kernels at the main path's full shapes; these are quick checks at
small ones. Tolerances: LayerNorm fp32 1e-5, bf16 outputs compared in fp32
to 2 bf16 ulps (2 * 2^-8 relative); dgamma / dbeta (fp32 sums over rows in
another order) 1e-4 relative. Flash forward fp32 2e-5, bf16 2e-3 absolute
plus 2^-7 relative. Flash backward fp32 1e-4 absolute (sums of 64-term
products in another order); bf16 gradients 1e-2 absolute plus 2^-6
relative (the kernel rounds p and ds to bf16 from its own fp32 scores, the
plain version from whole-row ones, so a value can land one bf16 ulp
apart before a 64-term product). Fused Adam: the kernel performs the plain
version's operations in its order, held to 1e-7 relative. The
determinism tests ask for identical bits from two runs.
"""

import pytest
import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.flash_attention import (
    flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
    flash_attention_fwd_plain)
from apex_tpu_torch.ops.fused_adam_kernel import (ADAM_MODE_ADAMW,
                                                  ADAM_MODE_L2,
                                                  fused_adam_flat,
                                                  fused_adam_flat_plain)
from apex_tpu_torch.ops.layer_norm_kernel import (ln_bwd, ln_bwd_plain,
                                                  ln_fwd, ln_fwd_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,hidden", [(64, 768), (5, 1600), (3, 96)])
def test_ln_kernel_matches_plain(dev, rows, hidden, dtype):
    g = torch.Generator(device=dev).manual_seed(rows)
    x = torch.randn(rows, hidden, device=dev, generator=g).to(dtype)
    gamma = torch.randn(hidden, device=dev, generator=g)
    beta = torch.randn(hidden, device=dev, generator=g)
    before = _build.launches["ln_fwd"]
    with torch.no_grad():
        y, m, iv = ln_fwd(x, gamma, beta, eps=1e-5)
        yp, mp, ivp = ln_fwd_plain(x, gamma, beta, eps=1e-5)
    torch.cuda.synchronize()
    assert _build.launches["ln_fwd"] == before + 1
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(y.float(), yp.float(), atol=1e-5, rtol=tol)
    torch.testing.assert_close(m, mp, atol=1e-5, rtol=0)
    torch.testing.assert_close(iv, ivp, atol=1e-5, rtol=1e-5)


def test_ln_kernel_without_beta(dev):
    """beta=None: the forward adds nothing, the backward gives no
    dbeta."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(40, 768, device=dev, generator=g)
    gamma = torch.randn(768, device=dev, generator=g)
    y, m, iv = ln_fwd(x, gamma, None, eps=1e-5)
    yp, _, _ = ln_fwd_plain(x, gamma, None, eps=1e-5)
    torch.testing.assert_close(y, yp, atol=1e-5, rtol=1e-5)
    dy = torch.randn(40, 768, device=dev, generator=g)
    dx, dg, db = ln_bwd(dy, x, gamma, None, m, iv)
    dxp, dgp, dbp = ln_bwd_plain(dy, x, gamma, None, m, iv)
    torch.cuda.synchronize()
    assert db is None and dbp is None
    torch.testing.assert_close(dx, dxp, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dg, dgp, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,hidden", [(4096, 768), (5, 1600), (37, 96),
                                         (3000, 8192)])
def test_ln_bwd_kernel_matches_plain(dev, rows, hidden, dtype):
    g = torch.Generator(device=dev).manual_seed(rows + hidden)
    x = (torch.randn(rows, hidden, device=dev, generator=g) * 2 + 0.5) \
        .to(dtype)
    dy = torch.randn(rows, hidden, device=dev, generator=g).to(dtype)
    gamma = torch.randn(hidden, device=dev, generator=g)
    beta = torch.randn(hidden, device=dev, generator=g)
    _, mean, invvar = ln_fwd_plain(x, gamma, beta, eps=1e-5)
    before = _build.launches["ln_bwd"]
    dx, dg, db = ln_bwd(dy, x, gamma, beta, mean, invvar)
    dxp, dgp, dbp = ln_bwd_plain(dy, x, gamma, beta, mean, invvar)
    torch.cuda.synchronize()
    assert _build.launches["ln_bwd"] == before + 1
    assert dx.dtype == dtype and dg.dtype == db.dtype == torch.float32
    if dtype == torch.float32:
        torch.testing.assert_close(dx, dxp, atol=1e-5, rtol=1e-5)
    else:
        torch.testing.assert_close(dx.float(), dxp.float(), atol=1e-5,
                                   rtol=2 ** -7)
    torch.testing.assert_close(dg, dgp, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(db, dbp, atol=1e-3, rtol=1e-4)


def test_ln_bwd_is_deterministic(dev):
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(4096, 768, device=dev, generator=g).bfloat16()
    dy = torch.randn(4096, 768, device=dev, generator=g).bfloat16()
    gamma = torch.randn(768, device=dev, generator=g)
    _, mean, invvar = ln_fwd(x, gamma, gamma, eps=1e-5)
    a = ln_bwd(dy, x, gamma, gamma, mean, invvar)
    b = ln_bwd(dy, x, gamma, gamma, mean, invvar)
    torch.cuda.synchronize()
    for ta, tb in zip(a, b):
        assert torch.equal(ta, tb)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(128, 128), (200, 200), (70, 130)])
def test_flash_kernel_matches_plain(dev, sq, sk, causal, dtype):
    g = torch.Generator(device=dev).manual_seed(sq + sk)
    q, k, v = (torch.randn(2, 3, s, 64, device=dev, generator=g).to(dtype)
               for s in (sq, sk, sk))
    before = _build.launches["fa_fwd"]
    with torch.no_grad():
        o, lse = flash_attention_fwd(q, k, v, scale=0.125, causal=causal)
        op, lsep = flash_attention_fwd_plain(q, k, v, scale=0.125,
                                             causal=causal)
    torch.cuda.synchronize()
    assert _build.launches["fa_fwd"] == before + 1
    if dtype == torch.float32:
        torch.testing.assert_close(o, op, atol=2e-5, rtol=0)
    else:
        torch.testing.assert_close(o.float(), op.float(), atol=2e-3,
                                   rtol=2 ** -7)
    torch.testing.assert_close(lse, lsep, atol=2e-5, rtol=0)


def _flash_bwd_inputs(dev, b, h, sq, sk, causal, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b, h, s, 64, device=dev, generator=g).to(dtype)
               for s in (sq, sk, sk))
    do = torch.randn(b, h, sq, 64, device=dev, generator=g).to(dtype)
    o, lse = flash_attention_fwd_plain(q, k, v, scale=0.125, causal=causal)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(128, 128), (200, 200), (70, 130),
                                   (130, 70)])
def test_flash_bwd_kernels_match_plain(dev, sq, sk, causal, dtype):
    q, k, v, o, lse, do = _flash_bwd_inputs(dev, 2, 3, sq, sk, causal,
                                            dtype, sq * sk)
    before = (_build.launches["fa_bwd_dq"], _build.launches["fa_bwd_dkv"])
    got = flash_attention_bwd(q, k, v, o, lse, do, scale=0.125,
                              causal=causal)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, scale=0.125,
                                     causal=causal)
    torch.cuda.synchronize()
    assert (_build.launches["fa_bwd_dq"], _build.launches["fa_bwd_dkv"]) \
        == (before[0] + 1, before[1] + 1)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == w.shape, name
        if dtype == torch.float32:
            torch.testing.assert_close(a, w, atol=1e-4, rtol=0, msg=name)
        else:
            torch.testing.assert_close(a.float(), w.float(), atol=1e-2,
                                       rtol=2 ** -6, msg=name)


def test_flash_bwd_is_deterministic(dev):
    args = _flash_bwd_inputs(dev, 2, 4, 256, 256, True, torch.bfloat16, 5)
    a = flash_attention_bwd(*args, scale=0.125, causal=True)
    b = flash_attention_bwd(*args, scale=0.125, causal=True)
    torch.cuda.synchronize()
    for ta, tb in zip(a, b):
        assert torch.equal(ta, tb)


@pytest.mark.parametrize("mode", [ADAM_MODE_L2, ADAM_MODE_ADAMW])
@pytest.mark.parametrize("n", [4096, 1001])
def test_fused_adam_kernel_matches_plain(dev, mode, n):
    g = torch.Generator(device=dev).manual_seed(n + mode)
    p, grad, m = (torch.randn(n, device=dev, generator=g) for _ in range(3))
    v = torch.rand(n, device=dev, generator=g)
    ref = [t.clone() for t in (p, grad, m, v)]
    step = torch.tensor(3, dtype=torch.int32, device=dev)
    kw = dict(lr=1e-3, weight_decay=0.01, step=step, mode=mode,
              inv_scale=0.5, found_inf=torch.tensor(False, device=dev))
    before = _build.launches["fused_adam"]
    fused_adam_flat(p, grad, m, v, **kw)
    fused_adam_flat_plain(*ref, **kw)
    torch.cuda.synchronize()
    assert _build.launches["fused_adam"] == before + 1
    for got, want in zip((p, m, v), (ref[0], ref[2], ref[3])):
        torch.testing.assert_close(got, want, atol=0, rtol=1e-7)


def test_fused_adam_overflow_step_is_a_bitwise_noop(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    p, grad, m = (torch.randn(2048, device=dev, generator=g)
                  for _ in range(3))
    v = torch.rand(2048, device=dev, generator=g)
    before = [t.clone() for t in (p, m, v)]
    grad[5] = float("inf")
    fused_adam_flat(p, grad, m, v, lr=1e-3, step=1,
                    found_inf=torch.tensor(True, device=dev))
    torch.cuda.synchronize()
    for t, b in zip((p, m, v), before):
        assert torch.equal(t, b)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    with torch.no_grad():
        q = torch.randn(1, 1, 8, 32, device=dev)
        with pytest.raises(NotImplementedError, match="head_dim"):
            flash_attention_fwd(q, q, q, scale=1.0, causal=False)
        q = torch.randn(1, 1, 8, 64, device=dev, dtype=torch.float16)
        with pytest.raises(ValueError, match="dtype"):
            flash_attention_fwd(q, q, q, scale=1.0, causal=False)
        x, g = torch.randn(2, 9000, device=dev), torch.ones(9000, device=dev)
        with pytest.raises(ValueError, match="hidden"):
            ln_fwd(x, g, g, eps=1e-5)
        x, g = torch.randn(8, 4, device=dev).t(), torch.ones(8, device=dev)
        with pytest.raises(ValueError, match="contiguous"):
            ln_fwd(x, g, g, eps=1e-5)
        x, g = torch.randn(4, 64, device=dev), torch.ones(64, device=dev)
        with pytest.raises(ValueError, match="gamma"):
            ln_fwd(x, g.double(), g, eps=1e-5)
        p = torch.zeros(8, device=dev, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="float32"):
            fused_adam_flat(p, p, p, p, lr=1.0)
