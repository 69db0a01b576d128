"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (at run time, not at collection) where
there is no CUDA device, and runs on an H100 with
``python -m pytest tests/test_torch_cuda.py -q``. ``chip_smoke.py`` holds
the kernels at the main path's full shapes; these are quick checks at
small ones. Tolerances: fp32 2e-5 (flash) / 1e-5 (LayerNorm); bf16 outputs
compared in fp32 to 2 bf16 ulps (2 * 2^-8 relative, plus 2e-3 absolute
for attention outputs near zero).
"""

import pytest
import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                flash_attention_fwd_plain)
from apex_tpu_torch.ops.layer_norm_kernel import ln_fwd, ln_fwd_plain

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
