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
version's operations in its order, held to 1e-7 relative; so do the two
LAMB stages (row sums included), held to the same. RMSNorm and the
no-gamma forms take the LayerNorm tolerances; the masked flash kernels
the flash ones, and exact zeros on fully masked rows. The determinism
tests ask for identical bits from two runs. The flat SGD, NovoGrad and
Adagrad kernels, the bf16 form of fused Adam and its master-weight form
repeat their plain versions' operations in order and are held to
identical bits (bf16 stores round to nearest even on both sides). The
GroupNorm kernels: y fp32 (1e-5, 1e-5), bf16 (1e-5 absolute, 2^-7
relative: one bf16 ulp), mean 1e-5, rstd 1e-4 relative, two runs
identical. The wide LayerNorm forms take the LayerNorm tolerances; the
flash kernels over a batch * heads above 65535 the flash ones. The
megatron softmax kernels: fp32 1e-6 absolute (summation order), bf16 and
fp16 one ulp (2^-7 / 2^-10 relative, plus one subnormal step), the
backward also 1e-6 absolute (the row sum's order); two runs identical.
The peer-put kernels run between rank processes that share the card
(``spawn_ranks``) and are held to identical bits; ring attention over
them (fp32) to the full-sequence flash at 1e-5 (o) and 1e-4 (gradients)
relative L2. The flash tests also read from torch.profiler which kernels
ran: bf16 the tensor-core forward, dq and dk / dv kernels
(``fa_fwd_kernel_wgmma``, ``fa_bwd_dq_kernel_wgmma``,
``fa_bwd_dkv_kernel_wgmma``), fp32 the FMA-pipe ones (the forward at d =
64 ``fa_fwd_kernel``, at d = 128 and 256 the split-TF32 tensor-core
forward ``fa_fwd_kernel_tf32``, held to the same fp32 tolerances at its
block and tile heights and one below and above them, in every form, at
d = 80, 96, 128, 192 and 256, over a batch * heads above 65535, on
misaligned views, two runs identical, and on scores drawn at twice unit
scale, beside fp32 SDPA's error on the same inputs; the backward
pair ``fa_bwd_dq_kernel_fma`` / ``fa_bwd_dkv_kernel_fma``, also held at
sq / sk one below, at and one above its 64- and 128-row tiles and over
the 16 broadcast forms of the bias, two runs identical). The dropout and
dlogits forms take the flash tolerances (the same keep mask on both
sides), the keep pattern exact, the dlogits the backward's tolerance;
the public op's bias gradient through a mask and dropout against the
same call on the CPU (its sum over the batch and queries 10 times the
backward's absolute tolerance). The public
``flash_attention`` takes transposed and misaligned views, and gives the
bits of the same call on contiguous copies. The six flash kernels at head
dims 16, 32, 48, 64, 80, 96, 128, 160, 192 and 256 in every form (plain, a
key-padding bias, dropout, dlogits), causal, BERT-style and ragged, take
the same tolerances: 64, 128 and 256 launch as they are, the others
zero-padded to the next of them (each launch counted under its width and
pad keys); the public op at 48, 80, 128, 192 and 256 against the same
call on the CPU; 320 raises.
Run the flash tests with ``python -m pytest tests/test_torch_cuda.py -q
-k flash``.
"""

import ctypes

import pytest
import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.flash_attention import (
    dropout_keep, flash_attention, flash_attention_bwd,
    flash_attention_bwd_plain, flash_attention_fwd,
    flash_attention_fwd_plain)
from apex_tpu_torch.ops.fused_adam_kernel import (
    ADAM_MODE_ADAMW, ADAM_MODE_L2, fused_adam_flat, fused_adam_flat_master,
    fused_adam_flat_master_plain, fused_adam_flat_plain)
from apex_tpu_torch.ops.fused_opt_kernels import (
    fused_adagrad_flat, fused_adagrad_flat_plain, fused_lamb_flat,
    fused_lamb_flat_plain, fused_novograd_flat, fused_novograd_flat_plain,
    row_segment_ids, row_segments)
from apex_tpu_torch.ops.fused_sgd_kernel import (fused_sgd_flat,
                                                 fused_sgd_flat_plain)
from apex_tpu_torch.ops.group_norm_kernel import (
    gn_apply, gn_apply_plain, gn_moments, gn_one_pass_plain, gn_shift,
    gn_stats, gn_stats_plain, group_norm_nhwc_fwd)
from apex_tpu_torch.ops.layer_norm_kernel import (ln_bwd, ln_bwd_plain,
                                                  ln_fwd, ln_fwd_plain)
from apex_tpu_torch.ops.remote_copy import STAGE_BYTES
from apex_tpu_torch.ops.tiling import (fa_fwd_route, fa_kernel_head_dim,
                                      fa_tf32_fwd_geometry, gn_hw_block,
                                      gn_one_pass_ok)
from apex_tpu_torch.utils.flatten import flat_spec, flatten

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# windows of torch.profiler tried before a test fails for want of records
PROFILE_TRIES = 5


def _kernel_names(fn):
    """The names of the device kernels a call of ``fn`` ran, from
    torch.profiler (the tests call it beside the call they check, on the
    same inputs). A PyTorch kernel opens the window: under pytest on the
    card, a window that held only the wrappers' kernels (launched through
    ctypes) was mostly recorded empty, where a script alone recorded them
    every time; a window with no flash kernel still came back now and
    then, and is tried again, up to PROFILE_TRIES windows."""
    act = torch.profiler.ProfilerActivity
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            torch.ones(1, device="cuda").add_(1)
            fn()
            torch.cuda.synchronize()
        names = {e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        if any("fa_" in n for n in names):
            return names
    raise AssertionError(f"torch.profiler recorded no flash kernel in "
                         f"{PROFILE_TRIES} windows: {names}")


# the fp32 kernels' names as the profiler shows them: the FMA-pipe
# forward's template (d = 64), the split-TF32 forward's (d = 128, 256) and
# the fp32 backward's `_fma` templates
_FMA_NAMES = {"fa_fwd_kernel": "fa_fwd_kernel<",
              "fa_bwd_dq_kernel": "fa_bwd_dq_kernel_fma<",
              "fa_bwd_dkv_kernel": "fa_bwd_dkv_kernel_fma<"}
_TF32_NAME = "fa_fwd_kernel_tf32<"


def _assert_flash_route(names, dtype, fwd=False, bwd=False, width=64):
    """bf16 ran the tensor-core kernels, fp32 the FMA-pipe ones (the
    template names ``fa_fwd_kernel<``, ``fa_bwd_dq_kernel_fma<`` and
    ``fa_bwd_dkv_kernel_fma<``), the fp32 forward at a kernel ``width`` of
    128 or 256 the split-TF32 one (``fa_fwd_kernel_tf32<``) and no other
    forward; ``bwd``: both backward kernels."""
    tc = dtype == torch.bfloat16
    for want, kernel in ((fwd, "fa_fwd_kernel"), (bwd, "fa_bwd_dq_kernel"),
                         (bwd, "fa_bwd_dkv_kernel")):
        if not want:
            continue
        ran_tc = any(kernel + "_wgmma" in n for n in names)
        ran_fma = any(_FMA_NAMES[kernel] in n for n in names)
        ran_tf32 = any(_TF32_NAME in n for n in names)
        tf32 = kernel == "fa_fwd_kernel" and not tc and width != 64
        assert (ran_tc, ran_fma, ran_tf32) == (tc, not tc and not tf32,
                                               tf32), (kernel, dtype, names)


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


# GPT-2's 4 x 12 heads at 1024 (and a ragged 1000); 2 x 3 heads otherwise
def _flash_heads(sq):
    return (4, 12) if sq >= 1000 else (2, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(128, 128), (200, 200), (70, 130),
                                   (1024, 1024), (1000, 1000), (200, 333),
                                   (130, 70), (1, 300), (65, 1)])
def test_flash_kernel_matches_plain(dev, sq, sk, causal, dtype):
    g = torch.Generator(device=dev).manual_seed(sq + sk)
    b, h = _flash_heads(sq)
    q, k, v = (torch.randn(b, h, s, 64, device=dev, generator=g).to(dtype)
               for s in (sq, sk, sk))
    before = _build.launches["fa_fwd"]
    with torch.no_grad():
        o, lse = flash_attention_fwd(q, k, v, scale=0.125, causal=causal)
        op, lsep = flash_attention_fwd_plain(q, k, v, scale=0.125,
                                             causal=causal)
    torch.cuda.synchronize()
    assert _build.launches["fa_fwd"] == before + 1
    _assert_flash_route(_kernel_names(lambda: flash_attention_fwd(
        q, k, v, scale=0.125, causal=causal)), dtype, fwd=True)
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
                                   (130, 70), (1024, 1024), (1000, 1000),
                                   (200, 333), (1, 300), (65, 1)])
def test_flash_bwd_kernels_match_plain(dev, sq, sk, causal, dtype):
    q, k, v, o, lse, do = _flash_bwd_inputs(dev, *_flash_heads(sq), sq, sk,
                                            causal, dtype, sq * sk)
    before = (_build.launches["fa_bwd_dq"], _build.launches["fa_bwd_dkv"])
    got = flash_attention_bwd(q, k, v, o, lse, do, scale=0.125,
                              causal=causal)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, scale=0.125,
                                     causal=causal)
    torch.cuda.synchronize()
    assert (_build.launches["fa_bwd_dq"], _build.launches["fa_bwd_dkv"]) \
        == (before[0] + 1, before[1] + 1)
    _assert_flash_route(_kernel_names(lambda: flash_attention_bwd(
        q, k, v, o, lse, do, scale=0.125, causal=causal)), dtype, bwd=True)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == w.shape, name
        if dtype == torch.float32:
            torch.testing.assert_close(a, w, atol=1e-4, rtol=0, msg=name)
        else:
            torch.testing.assert_close(a.float(), w.float(), atol=1e-2,
                                       rtol=2 ** -6, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,s", [(2, 4, 256), (4, 12, 1024)])
def test_flash_bwd_is_deterministic(dev, b, h, s, dtype):
    """Two runs give the same bits (no atomics: each block owns its
    rows), the bf16 dq and dk / dv from the tensor-core kernels, the fp32
    ones from the FMA-pipe pair."""
    args = _flash_bwd_inputs(dev, b, h, s, s, True, dtype, 5)
    a = flash_attention_bwd(*args, scale=0.125, causal=True)
    b = flash_attention_bwd(*args, scale=0.125, causal=True)
    torch.cuda.synchronize()
    _assert_flash_route(_kernel_names(lambda: flash_attention_bwd(
        *args, scale=0.125, causal=True)), dtype, bwd=True)
    for ta, tb in zip(a, b):
        assert torch.equal(ta, tb)


# the fp32 backward's tile heights (fa_fma_bwd_geometry: blocks of 128
# rows, tiles of 64) and the sizes one below and one above each
_FMA_EDGES = [63, 64, 65, 127, 128, 129]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sk", _FMA_EDGES)
@pytest.mark.parametrize("sq", _FMA_EDGES)
def test_fp32_flash_bwd_at_tile_edges(dev, sq, sk, causal):
    """The fp32 dq and dk / dv kernels where sq and sk cross their block
    and tile heights: within 1e-4 of the plain version, two runs the same
    bits."""
    q, k, v, o, lse, do = _flash_bwd_inputs(dev, 1, 2, sq, sk, causal,
                                            torch.float32, 1000 * sq + sk)
    got = flash_attention_bwd(q, k, v, o, lse, do, scale=0.125,
                              causal=causal)
    again = flash_attention_bwd(q, k, v, o, lse, do, scale=0.125,
                                causal=causal)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, scale=0.125,
                                     causal=causal)
    torch.cuda.synchronize()
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, w, atol=1e-4, rtol=0, msg=name)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("form", range(16))
def test_fp32_flash_bwd_bias_broadcast_forms(dev, form):
    """Every broadcast form of the fp32 score bias (each of b, h, sq, sk
    full or 1, bit 3 - i of ``form`` for dimension i) at ragged 129 x 65:
    dq, dk and dv within 1e-4 of the plain version; a row masked whole
    (where the bias has rows) gives exact zeros in dq, a key masked whole
    (where it has keys but no rows) exact zeros in dk and dv."""
    dims = (2, 3, 129, 65)
    shape = tuple(n if form >> (3 - i) & 1 else 1
                  for i, n in enumerate(dims))
    g = torch.Generator(device=dev).manual_seed(300 + form)
    q, k, v, do = (torch.randn(2, 3, s, 64, device=dev, generator=g)
                   for s in (129, 65, 65, 129))
    bias = torch.randn(shape, device=dev, generator=g)
    if shape[2] != 1:
        bias[..., 5, :] = -1e30
    elif shape[3] != 1:
        bias[..., 7] = -1e30
    o, lse = flash_attention_fwd_plain(q, k, v, scale=0.125, causal=False,
                                       bias=bias)
    got = flash_attention_bwd(q, k, v, o, lse, do, scale=0.125,
                              causal=False, bias=bias)
    _assert_flash_route(_kernel_names(lambda: flash_attention_bwd(
        q, k, v, o, lse, do, scale=0.125, causal=False, bias=bias)),
        torch.float32, bwd=True)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, scale=0.125,
                                     causal=False, bias=bias)
    torch.cuda.synchronize()
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, w, atol=1e-4, rtol=0, msg=name)
    masked = (bias <= -0.5e30).expand(dims)
    dead, unseen = masked.all(dim=-1), masked.all(dim=-2)
    assert shape[2] == 1 or bool(dead.any())
    assert torch.equal(got[0][dead], torch.zeros_like(got[0][dead]))
    for grad in got[1:]:
        assert torch.equal(grad[unseen], torch.zeros_like(grad[unseen]))


def test_tc_flash_refuses_misaligned_views(dev):
    """The bf16 kernels read q, k, v and do through TMA tensor maps, which
    need 16-byte aligned bases: a contiguous view 2 bytes into its storage
    raises, with no other route; an fp32 view 4 bytes into its storage
    runs on the FMA kernels, the backward's by 4-byte copies."""
    g = torch.Generator(device=dev).manual_seed(9)
    store = torch.randn(2 * 64 * 64 + 8, device=dev, generator=g)
    bad = store.bfloat16()[1:1 + 64 * 64].view(1, 1, 64, 64)
    ok = bad.clone()
    assert bad.data_ptr() % 16 and ok.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="TMA"):
        flash_attention_fwd(ok, bad, ok, scale=0.125, causal=True)
    o, lse = flash_attention_fwd(ok, ok, ok, scale=0.125, causal=True)
    with pytest.raises(ValueError, match="TMA"):
        flash_attention_bwd(ok, ok, ok, o, lse, bad, scale=0.125,
                            causal=True)
    f32 = store[1:1 + 64 * 64].view(1, 1, 64, 64)
    o, lse = flash_attention_fwd(f32, f32, f32, scale=0.125, causal=True)
    op, lsep = flash_attention_fwd_plain(f32, f32, f32, scale=0.125,
                                         causal=True)
    got = flash_attention_bwd(f32, f32, f32, op, lsep, f32, scale=0.125,
                              causal=True)
    want = flash_attention_bwd_plain(f32, f32, f32, op, lsep, f32,
                                     scale=0.125, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, op, atol=2e-5, rtol=0)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, w, atol=1e-4, rtol=0, msg=name)


# the fp32 forward's tile heights (fa_fma_fwd_geometry: blocks of 64
# query rows, K / V tiles of 64), one below and above them and their
# double, and 1
_FWD_EDGES = [1, 63, 64, 65, 127, 128, 129]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(a, b) for a in _FWD_EDGES
                                   for b in _FWD_EDGES] + [(200, 333),
                                                           (333, 200)])
def test_fp32_flash_fwd_at_tile_edges(dev, sq, sk, causal):
    """The fp32 forward where sq and sk cross its block and tile heights
    (causal with sq != sk too): o and lse within 2e-5 of the plain
    version, the FMA-pipe kernel ran, two runs the same bits."""
    g = torch.Generator(device=dev).manual_seed(1000 * sq + sk)
    q, k, v = (torch.randn(1, 2, s, 64, device=dev, generator=g)
               for s in (sq, sk, sk))
    o, lse = flash_attention_fwd(q, k, v, scale=0.125, causal=causal)
    o2, lse2 = flash_attention_fwd(q, k, v, scale=0.125, causal=causal)
    op, lsep = flash_attention_fwd_plain(q, k, v, scale=0.125,
                                         causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, op, atol=2e-5, rtol=0)
    torch.testing.assert_close(lse, lsep, atol=2e-5, rtol=0)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    _assert_flash_route(_kernel_names(lambda: flash_attention_fwd(
        q, k, v, scale=0.125, causal=causal)), torch.float32, fwd=True)


@pytest.mark.parametrize("b,h,s,d", [(2, 4, 256, 64), (4, 12, 1024, 64),
                                     (2, 4, 256, 128), (2, 4, 256, 256),
                                     (2, 16, 1024, 128), (2, 8, 1024, 256)])
def test_fp32_flash_fwd_is_deterministic(dev, b, h, s, d):
    """Two runs of the fp32 forward give the same bits (each block owns
    its query rows, no atomics), causal and not, on the FMA kernel (d =
    64) and the split-TF32 one (d = 128, 256)."""
    g = torch.Generator(device=dev).manual_seed(s + d)
    q, k, v = (torch.randn(b, h, s, d, device=dev, generator=g)
               for _ in range(3))
    for causal in (True, False):
        a = flash_attention_fwd(q, k, v, scale=0.125, causal=causal)
        c = flash_attention_fwd(q, k, v, scale=0.125, causal=causal)
        torch.cuda.synchronize()
        assert torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("form", range(16))
def test_fp32_flash_fwd_bias_broadcast_forms(dev, form, d):
    """Every broadcast form of the fp32 score bias (each of b, h, sq, sk
    full or 1, bit 3 - i of ``form`` for dimension i) at ragged 129 x 65,
    causal for the odd forms, on the FMA forward (d = 64) and the
    split-TF32 one (128, 256): o and lse within 2e-5 of the plain version;
    a row masked whole (where the bias has rows) gives o = 0 and lse =
    -1e30 exactly."""
    dims = (2, 3, 129, 65)
    shape = tuple(n if form >> (3 - i) & 1 else 1
                  for i, n in enumerate(dims))
    causal = bool(form & 1)
    g = torch.Generator(device=dev).manual_seed(500 + form + d)
    q, k, v = (torch.randn(2, 3, s, d, device=dev, generator=g)
               for s in (129, 65, 65))
    bias = torch.randn(shape, device=dev, generator=g)
    if shape[2] != 1:
        bias[..., 5, :] = -1e30
    elif shape[3] != 1:
        bias[..., 7] = -1e30
    kw = dict(scale=d ** -0.5, causal=causal, bias=bias)
    o, lse = flash_attention_fwd(q, k, v, **kw)
    _assert_flash_route(_kernel_names(lambda: flash_attention_fwd(
        q, k, v, **kw)), torch.float32, fwd=True, width=d)
    op, lsep = flash_attention_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, op, atol=2e-5, rtol=0)
    torch.testing.assert_close(lse, lsep, atol=2e-5, rtol=0)
    dead = (bias <= -0.5e30).expand(dims).all(dim=-1)
    assert shape[2] == 1 or bool(dead.any())
    assert torch.equal(o[dead], torch.zeros_like(o[dead]))
    assert bool((lse[dead] == -1e30).all())


@pytest.mark.parametrize("d", [64, 128, 256])
def test_fp32_flash_fwd_misaligned_view_gives_the_aligned_bits(dev, d):
    """An fp32 q, k, v and o 4 bytes off the 16-byte alignment take the
    forward's 4-byte copies and stores (the FMA kernel at d = 64, the
    split-TF32 one at 128 and 256): the bits of the same call on aligned
    copies; the public op hands the kernel an aligned copy
    (``_kernel_operand``) and gives the same bits again."""
    from apex_tpu_torch.ops.flash_attention import _kernel_operand
    n = 2 * 3 * 200 * d
    g = torch.Generator(device=dev).manual_seed(41 + d)
    store = torch.randn(3 * n + 8, device=dev, generator=g)
    views = [store[1 + i * n:1 + (i + 1) * n].view(2, 3, 200, d)
             for i in range(3)]
    assert all(t.data_ptr() % 16 for t in views)
    copies = [t.clone() for t in views]
    assert all(_kernel_operand(t).data_ptr() % 16 == 0 for t in views)
    for causal in (True, False):
        got = flash_attention_fwd(*views, scale=0.125, causal=causal)
        want = flash_attention_fwd(*copies, scale=0.125, causal=causal)
        public = flash_attention(*views, causal, 0.125)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(public, want[0])


# the split-TF32 forward's forms: (bias, dropout)
_TF32_FORMS = {"plain": (False, False), "bias": (True, False),
               "dropout": (False, True), "both": (True, True)}


def _tf32_edges(d):
    """The fp32 forward's block and tile heights at head dim d
    (fa_tf32_fwd_geometry of its kernel width: 64-row blocks over 32-key
    tiles at 128, 128 over 16 at 256), one below and one above each."""
    g = fa_tf32_fwd_geometry(fa_kernel_head_dim(d))
    return sorted({n + e for n in (g.block_rows, g.tile_rows)
                   for e in (-1, 0, 1)})


def _fp32_fwd_check(dev, q, k, v, causal, form, seed, route=True):
    """The fp32 forward of (q, k, v) in ``form`` (a (1, h, sq, sk) bias
    with a row and a key masked whole, dropout at 0.1 from a device seed)
    against the plain version: o and lse within 2e-5, two runs the same
    bits, fully masked rows o = 0 and lse = -1e30, one launch counted at
    the kernel's width (and pad key) in its form; with ``route``, the
    profiler's names show the split-TF32 kernel ran."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    with_bias, dropout = _TF32_FORMS[form]
    g = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(scale=d ** -0.5, causal=causal)
    if with_bias:
        bias = torch.randn(1, h, sq, sk, device=dev, generator=g)
        bias[..., sq // 2, :] = -1e30
        bias[..., sk - 1] = -1e30
        kw["bias"] = bias
    if dropout:
        kw.update(dropout_p=0.1, dropout_seed=torch.tensor(
            [seed], dtype=torch.int32, device=dev))
    _build.reset_launches()
    o, lse = flash_attention_fwd(q, k, v, **kw)
    o2, lse2 = flash_attention_fwd(q, k, v, **kw)
    op, lsep = flash_attention_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    kd = fa_kernel_head_dim(d)
    expect = {f"fa_fwd:tf32:d{kd}": 2}
    if d != kd:
        expect[f"fa_fwd:tf32:pad{d}"] = 2
    if dropout:
        expect[f"fa_fwd:tf32:d{kd}:dropout"] = 2
    assert dict(_build.form_launches) == expect
    torch.testing.assert_close(o, op, atol=2e-5, rtol=0)
    torch.testing.assert_close(lse, lsep, atol=2e-5, rtol=0)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    if with_bias:
        dead = (kw["bias"] <= -0.5e30).expand(b, h, sq, sk).all(dim=-1)
        assert torch.equal(o[dead], torch.zeros_like(o[dead]))
        assert bool((lse[dead] == -1e30).all())
    if route:
        _assert_flash_route(_kernel_names(lambda: flash_attention_fwd(
            q, k, v, **kw)), torch.float32, fwd=True, width=kd)


@pytest.mark.parametrize("form", sorted(_TF32_FORMS))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [128, 96, 80, 256, 192])
def test_fp32_flash_fwd_at_wide_tile_edges(dev, d, causal, form):
    """The fp32 forward's twin of ``test_fp32_flash_fwd_at_tile_edges`` on
    the split-TF32 kernel at head width 128 (d = 96 and 80 padded) and 256
    (d = 192 padded): sq and sk each at every one of its block and tile
    heights and one below and above (``_tf32_edges``), causal and full, in
    each form (``_fp32_fwd_check``; the kernel's name read once)."""
    edges = _tf32_edges(d)
    for sq in edges:
        for sk in edges:
            g = torch.Generator(device=dev).manual_seed(
                d + 1000 * sq + sk + causal)
            q, k, v = (torch.randn(1, 2, s, d, device=dev, generator=g)
                       for s in (sq, sk, sk))
            _fp32_fwd_check(dev, q, k, v, causal, form, d + sq + len(form),
                            route=sq == sk == edges[-1])


@pytest.mark.parametrize("d", [128, 256])
def test_fp32_flash_fwd_over_65535_batch_heads(dev, d):
    """batch * heads = 65,600 (1025 x 64) through grid.x x grid.z on the
    split-TF32 forward, 48 rows, causal, with dropout and without: o and
    lse against the plain version."""
    g = torch.Generator(device=dev).manual_seed(53 + d)
    q, k, v = (torch.randn(1025, 64, 48, d, device=dev, generator=g)
               for _ in range(3))
    for form in ("plain", "dropout"):
        _fp32_fwd_check(dev, q, k, v, True, form, 59 + d)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [128, 256])
def test_fp32_flash_fwd_holds_the_tolerance_on_large_scores(dev, d,
                                                            causal):
    """q and k drawn at twice unit scale (a peaked softmax: the split's
    error grows with |q| |k|): the split-TF32 forward's o and lse within
    2e-5 of the plain version, as fp32 SDPA's o is; the message gives the
    largest errors beside the tolerance and SDPA's on the same inputs."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    g = torch.Generator(device=dev).manual_seed(61 + d + causal)
    q, k = (2.0 * torch.randn(2, 8, 512, d, device=dev, generator=g)
            for _ in range(2))
    v = torch.randn(2, 8, 512, d, device=dev, generator=g)
    kw = dict(scale=d ** -0.5, causal=causal)
    o, lse = flash_attention_fwd(q, k, v, **kw)
    op, lsep = flash_attention_fwd_plain(q, k, v, **kw)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        osd = torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=d ** -0.5)
    torch.cuda.synchronize()
    err, lerr = ((o - op).abs().max().item(),
                 (lse - lsep).abs().max().item())
    serr = (osd - op).abs().max().item()
    assert err <= 2e-5 and lerr <= 2e-5, (
        f"d = {d} causal = {causal}: o error {err}, lse error {lerr} "
        f"(tolerance 2e-5); fp32 SDPA's o error {serr}")


# the dropout and dlogits forms: the fp32 tile edges and the tensor-core
# kernels' 64 / 128-row tiles, ragged, causal with keys past the last
# query, GPT-2's shape
_FORM_SHAPES = [(64, 64), (65, 129), (128, 128), (129, 63), (200, 333),
                (1, 300), (1024, 1024)]


def _form_tols(dtype):
    return ((2e-5, 0, 1e-4, 0) if dtype == torch.float32
            else (2e-3, 2 ** -7, 1e-2, 2 ** -6))


# the dq kernels' fp32 dlogits against the plain version's on the same
# inputs, in either dtype: they differ only in the order of the fp32 sums
# of the score and of dP (chip_smoke.py's DLOGITS_TOL)
_DLOGITS_TOL = (2e-5, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", _FORM_SHAPES)
def test_flash_dropout_kernels_match_plain(dev, sq, sk, causal, dtype):
    """The forward, dq and dk / dv kernels' dropout form (rate 0.1, the
    seed a device tensor) against the plain versions on the same inputs
    and the same keep mask (the flash tolerances), with a (b, 1, 1, sk)
    padding mask on the non-causal cases; each launch counted in its
    form; two runs the same bits."""
    b, h = _flash_heads(sq)
    q, k, v, _, _, do = _flash_bwd_inputs(dev, b, h, sq, sk, causal, dtype,
                                          sq + 3 * sk)
    bias = None
    if not causal:
        lens = torch.arange(b, device=dev) * 7 % sk + 1
        bias = torch.zeros(b, 1, 1, sk, device=dev).masked_fill_(
            torch.arange(sk, device=dev) >= lens[:, None, None, None],
            -1e30)
    seed = torch.tensor([sq - sk], dtype=torch.int32, device=dev)
    kw = dict(scale=0.125, causal=causal, bias=bias, dropout_p=0.1,
              dropout_seed=seed)
    fa, fr, ba, br = _form_tols(dtype)
    _build.reset_launches()
    o, lse = flash_attention_fwd(q, k, v, **kw)
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    op, lsep = flash_attention_fwd_plain(q, k, v, **kw)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    route = "wgmma" if dtype == torch.bfloat16 else "fma"
    assert dict(_build.form_launches) == {
        f"fa_fwd:{route}:dropout": 1, f"fa_bwd_dq:{route}:dropout": 2,
        f"fa_bwd_dkv:{route}:dropout": 2}
    torch.testing.assert_close(o.float(), op.float(), atol=fa, rtol=fr)
    torch.testing.assert_close(lse, lsep, atol=2e-5, rtol=0)
    for name, a, w, a2 in zip(("dq", "dk", "dv"), got, want, again):
        torch.testing.assert_close(a.float(), w.float(), atol=ba, rtol=br,
                                   msg=name)
        assert torch.equal(a, a2), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_dropout_keep_pattern_is_the_plain_mask(dev, dtype):
    """A one-hot v (64 keys, v[j] = e_j): the forward kernel's o is 0
    exactly where ``dropout_keep`` drops, for b * h past one grid slice
    and a negative seed."""
    b, h, sq, sk = 3, 7, 200, 64
    g = torch.Generator(device=dev).manual_seed(9)
    q, k = ((torch.randn(b, h, n, 64, device=dev, generator=g) * 0.3)
            .to(dtype) for n in (sq, sk))
    v = torch.eye(sk, 64, device=dev).expand(b, h, sk, 64).contiguous() \
        .to(dtype)
    o, _ = flash_attention_fwd(q, k, v, scale=0.125, causal=False,
                               dropout_p=0.3, dropout_seed=-123456)
    keep = dropout_keep(-123456, torch.arange(b * h, device=dev), 0, 0, sq,
                        sk, 0.3, device=dev).view(b, h, sq, sk)
    assert torch.equal(o == 0, keep == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", _FORM_SHAPES)
def test_flash_dbias_kernels_match_plain(dev, sq, sk, causal, dtype):
    """The dq kernels' dlogits form with a (1, h, sq, sk) bias (and
    dropout on the causal cases): dq, dk, dv (the flash backward
    tolerances) and the fp32 dlogits (``_DLOGITS_TOL``) against the plain
    version, zero above the diagonal when causal, two runs the same
    bits."""
    b, h = _flash_heads(sq)
    q, k, v, _, _, do = _flash_bwd_inputs(dev, b, h, sq, sk, causal, dtype,
                                          7 * sq + sk)
    g = torch.Generator(device=dev).manual_seed(sk)
    bias = torch.randn(1, h, sq, sk, device=dev, generator=g)
    kw = dict(scale=0.125, causal=causal, bias=bias, want_dbias=True)
    if causal:
        kw.update(dropout_p=0.2, dropout_seed=5)
    o, lse = flash_attention_fwd_plain(q, k, v, scale=0.125, causal=causal,
                                       bias=bias)
    _build.reset_launches()
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    route = "wgmma" if dtype == torch.bfloat16 else "fma"
    assert _build.form_launches[f"fa_bwd_dq:{route}:dbias"] == 2
    _, _, ba, br = _form_tols(dtype)
    assert got[3].shape == (b, h, sq, sk) and got[3].dtype == torch.float32
    for name, a, w, a2 in zip(("dq", "dk", "dv", "dbias"), got, want,
                              again):
        at, rt = _DLOGITS_TOL if name == "dbias" else (ba, br)
        torch.testing.assert_close(a.float(), w.float(), atol=at, rtol=rt,
                                   msg=lambda m, name=name: f"{name}: {m}")
        assert torch.equal(a, a2), name
    if causal:
        above = torch.ones(sq, sk, dtype=torch.bool, device=dev).triu(1)
        assert bool((got[3][..., above] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_public_flash_trains_a_bias_with_dropout(dev, dtype):
    """The public op with a differentiated (1, h, 1, sk) bias, a (b, 1,
    1, sk) mask and dropout: every gradient against the same call on the
    CPU (the plain versions; fp32 1e-4, bf16 the flash backward's
    tolerance, ten times its atol for the bias's), the bias's reduced over
    the broadcast dimensions."""
    b, h, sq, sk = 2, 3, 130, 70
    g = torch.Generator().manual_seed(3)
    q, k, v, w = (torch.randn(b, h, n, 64, generator=g)
                  for n in (sq, sk, sk, sq))
    bias = torch.randn(1, h, 1, sk, generator=g)
    mask = torch.arange(sk) >= torch.tensor([sk, 41])[:, None, None, None]
    out = {}
    for where in ("cuda", "cpu"):
        ts = [t.to(where, dtype).requires_grad_() for t in (q, k, v)]
        tb = bias.to(where).requires_grad_()
        o = flash_attention(*ts, bias=tb, mask=mask.to(where),
                            dropout_p=0.1, dropout_seed=77)
        (o.float() * w.to(where)).sum().backward()
        out[where] = [t.grad.float().cpu() for t in (*ts, tb)]
    _, _, ba, br = _form_tols(dtype)
    for name, a, c in zip(("dq", "dk", "dv", "dbias"), out["cuda"],
                          out["cpu"]):
        # a bf16 bias gradient sums dlogits from o and lse that the card's
        # forward and the CPU's round to bf16 apart
        wide = name == "dbias" and dtype == torch.bfloat16
        torch.testing.assert_close(a, c, atol=ba * (1 + 9 * wide), rtol=br,
                                   msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_public_flash_takes_any_layout_on_the_card(dev, dtype):
    """The public op on ``transpose(1, 2)`` views and on contiguous views 2
    bytes into their storage (off the TMA's 16-byte alignment): o and the
    gradients are the bits of the same call on contiguous copies, forward
    and backward, the incoming gradient a view of the same kind."""
    _any_layout_check(dev, dtype, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_public_flash_takes_any_layout_on_the_card_at_256(dev, dtype):
    """The same at head width 256, the fp32 scores split by depth."""
    _any_layout_check(dev, dtype, 256)


def test_public_flash_takes_any_layout_on_the_card_at_128(dev):
    """The same in fp32 at head width 128, the scores split by depth into
    two parts, two blocks an SM."""
    _any_layout_check(dev, torch.float32, 128)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_fp32_flash_bwd_misaligned_view_gives_the_aligned_bits(dev, d):
    """An fp32 q, k, v, o and do 4 bytes off the 16-byte alignment take the
    backward pair's 4-byte copies and stores (``vec`` = 0), causal and
    full, with dropout: dq, dk and dv are the bits of the same call on
    aligned copies."""
    n = 2 * 3 * 100 * d
    g = torch.Generator(device=dev).manual_seed(43 + d)
    store = torch.randn(5 * n + 8, device=dev, generator=g)
    views = [store[1 + i * n:1 + (i + 1) * n].view(2, 3, 100, d)
             for i in range(5)]
    assert all(t.data_ptr() % 16 for t in views)
    copies = [t.clone() for t in views]
    for causal in (True, False):
        kw = dict(scale=d ** -0.5, causal=causal, dropout_p=0.1,
                  dropout_seed=7)
        q, k, v, _, do = copies
        o, lse = flash_attention_fwd(q, k, v, **kw)
        views[3].copy_(o)
        got = flash_attention_bwd(*views[:4], lse, views[4], **kw)
        want = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            assert torch.equal(a, w), (causal, name)


def _any_layout_check(dev, dtype, d):
    shape = (2, 3, 200, d)
    n = 2 * 3 * 200 * d
    g = torch.Generator(device=dev).manual_seed(29)
    base = [torch.randn(shape, device=dev, generator=g).to(dtype)
            for _ in range(4)]

    def transposed(t):
        return t.transpose(1, 2).contiguous().transpose(1, 2)

    def misaligned(t):
        store = torch.zeros(n + 8, device=dev, dtype=dtype)
        view = store[1:1 + n].view(shape)
        view.copy_(t)
        return view

    def run(make):
        leaves = [make(t).requires_grad_() for t in base[:3]]
        o = flash_attention(*leaves, True)
        o.backward(make(base[3]))
        return [o.detach()] + [t.grad for t in leaves]

    want = run(lambda t: t.clone())
    for make in (transposed, misaligned):
        assert not make(base[0]).is_contiguous() or \
            make(base[0]).data_ptr() % 16
        got = run(make)
        torch.cuda.synchronize()
        for name, a, w in zip(("o", "dq", "dk", "dv"), got, want):
            assert torch.equal(a, w), (make.__name__, name)


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
        # head dim 32 runs (padded to 64) and matches its plain version;
        # 320, above the widest compiled width (256), raises
        q = torch.randn(1, 1, 8, 32, device=dev)
        o, lse = flash_attention_fwd(q, q, q, scale=1.0, causal=False)
        op, lsep = flash_attention_fwd_plain(q, q, q, scale=1.0,
                                             causal=False)
        torch.testing.assert_close(o, op, atol=2e-5, rtol=0)
        torch.testing.assert_close(lse, lsep, atol=2e-5, rtol=0)
        q = torch.randn(1, 1, 8, 320, device=dev)
        with pytest.raises(NotImplementedError, match="head_dim 320"):
            flash_attention_fwd(q, q, q, scale=1.0, causal=False)
        with pytest.raises(NotImplementedError, match="head_dim 320"):
            flash_attention(q, q, q)
        q = torch.randn(1, 1, 8, 64, device=dev, dtype=torch.float16)
        with pytest.raises(ValueError, match="dtype"):
            flash_attention_fwd(q, q, q, scale=1.0, causal=False)
        x = torch.randn(2, 0, device=dev)   # rows of any width but none
        g = torch.ones(0, device=dev)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rms,affine", [(True, True), (True, False),
                                        (False, False)])
@pytest.mark.parametrize("rows,hidden", [(64, 1024), (37, 96)])
def test_rms_and_no_gamma_kernels_match_plain(dev, rows, hidden, rms,
                                              affine, dtype):
    g = torch.Generator(device=dev).manual_seed(rows + hidden + rms)
    x = (torch.randn(rows, hidden, device=dev, generator=g) * 2 + 0.5) \
        .to(dtype)
    dy = torch.randn(rows, hidden, device=dev, generator=g).to(dtype)
    gamma = torch.randn(hidden, device=dev, generator=g) if affine else None
    y, m, iv = ln_fwd(x, gamma, None, eps=1e-5, rms=rms)
    yp, mp, ivp = ln_fwd_plain(x, gamma, None, eps=1e-5, rms=rms)
    mean = None if rms else m
    dx, dg, db = ln_bwd(dy, x, gamma, None, mean, iv, rms=rms)
    dxp, dgp, _ = ln_bwd_plain(dy, x, gamma, None, mean, iv, rms=rms)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(y.float(), yp.float(), atol=1e-5, rtol=tol)
    torch.testing.assert_close(m, mp, atol=1e-5, rtol=0)
    torch.testing.assert_close(iv, ivp, atol=1e-5, rtol=1e-5)
    if rms:
        assert torch.equal(m, torch.zeros_like(m))
    torch.testing.assert_close(dx.float(), dxp.float(), atol=1e-5, rtol=tol)
    assert db is None and (dg is None) == (not affine)
    if affine:
        torch.testing.assert_close(dg, dgp, atol=1e-3, rtol=1e-4)


# head dims on the card: the compiled 64, 128 and 256 and padded ones
# below each
_HEAD_DIMS = [16, 32, 48, 64, 80, 96, 128, 160, 192, 256]
# (b, h, sq, sk, causal, bias kind, form): causal, BERT-style key padding,
# a ragged causal 200 x 333, dropout with key padding, dlogits of a learned
# bias (with dropout)
_HEAD_DIM_CASES = {"causal": (2, 3, 200, 200, True, None, None),
                   "pad": (4, 16, 128, 128, False, "pad", None),
                   "ragged": (2, 3, 200, 333, True, None, None),
                   "dropout": (2, 3, 130, 129, False, "pad", "dropout"),
                   "dbias": (2, 3, 129, 200, True, "bias", "dbias")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(_HEAD_DIM_CASES))
@pytest.mark.parametrize("d", _HEAD_DIMS)
def test_flash_head_dims_match_plain(dev, d, case, dtype):
    """The forward, dq and dk / dv kernels at head dim d in every form
    (plain, a key-padding bias, dropout, the dlogits of a learned bias)
    against the plain versions on the same inputs (the flash tolerances,
    the dlogits ``_DLOGITS_TOL``), the default scale 1 / sqrt(d): d = 64,
    128 and 256 launch as they are, any other d zero-padded to the next
    compiled width, each launch counted under its width and, padded, its
    pad key; two runs the same bits."""
    b, h, sq, sk, causal, kind, form = _HEAD_DIM_CASES[case]
    g = torch.Generator(device=dev).manual_seed(d * 7 + sq)
    q, k, v, do = (torch.randn(b, h, s, d, device=dev, generator=g)
                   .to(dtype) for s in (sq, sk, sk, sq))
    bias = None
    if kind == "pad":
        lens = torch.arange(b, device=dev) * 37 % sk + 1
        lens[0] = sk
        bias = torch.zeros(b, 1, 1, sk, device=dev).masked_fill_(
            torch.arange(sk, device=dev) >= lens[:, None, None, None],
            -1e30)
    elif kind == "bias":
        bias = torch.randn(1, h, sq, sk, device=dev, generator=g)
    kw = dict(scale=d ** -0.5, causal=causal, bias=bias)
    if form:
        kw.update(dropout_p=0.1, dropout_seed=torch.tensor(
            [d - sq], dtype=torch.int32, device=dev))
    bkw = dict(kw, want_dbias=form == "dbias")
    fa, fr, ba, br = _form_tols(dtype)
    _build.reset_launches()
    o, lse = flash_attention_fwd(q, k, v, **kw)
    got = flash_attention_bwd(q, k, v, o, lse, do, **bkw)
    again = flash_attention_bwd(q, k, v, o, lse, do, **bkw)
    op, lsep = flash_attention_fwd_plain(q, k, v, **kw)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, **bkw)
    torch.cuda.synchronize()
    kd = fa_kernel_head_dim(d)
    width = "" if kd == 64 else f":d{kd}"
    expect = {}
    for name, n in (("fa_fwd", 1), ("fa_bwd_dq", 2), ("fa_bwd_dkv", 2)):
        # the fp32 forward at 128 and 256 runs the split-TF32 kernel
        route = (fa_fwd_route(str(dtype)[6:], kd) if name == "fa_fwd"
                 else "wgmma" if dtype == torch.bfloat16 else "fma")
        if kd != 64:
            expect[f"{name}:{route}:d{kd}"] = n
        if d != kd:
            expect[f"{name}:{route}:pad{d}"] = n
        if form:   # dropout, with the dlogits too
            expect[f"{name}:{route}{width}:dropout"] = n
    if form == "dbias":
        expect[f"fa_bwd_dq:{route}{width}:dbias"] = 2
    assert dict(_build.form_launches) == expect
    _assert_flash_route(_kernel_names(lambda: flash_attention_fwd(
        q, k, v, **kw)), dtype, fwd=True, width=kd)
    assert o.shape == q.shape and all(
        t.shape == w.shape for t, w in zip(got[:3], (q, k, v)))
    torch.testing.assert_close(o.float(), op.float(), atol=fa, rtol=fr)
    torch.testing.assert_close(lse, lsep, atol=2e-5, rtol=0)
    for name, a, w, a2 in zip(("dq", "dk", "dv", "dbias"), got, want,
                              again):
        at, rt = _DLOGITS_TOL if name == "dbias" else (ba, br)
        torch.testing.assert_close(a.float(), w.float(), atol=at, rtol=rt,
                                   msg=lambda m, name=name: f"{name}: {m}")
        assert torch.equal(a, a2), name
    _assert_flash_route(_kernel_names(lambda: flash_attention_bwd(
        q, k, v, o, lse, do, **bkw)), dtype, bwd=True)


def _planted_last_tile_max(g, b, h, s, d, dev):
    """Random q, k, v, with the key at every fifth row's own position made
    half that row's q: its score, about sqrt(d) / 2, is the row's max
    and, causal, lies in the row's last key tile."""
    q, k, v = (torch.randn(b, h, s, d, device=dev, generator=g)
               for _ in range(3))
    rows = torch.arange(0, s, 5, device=dev)
    k[:, :, rows] = 0.5 * q[:, :, rows]
    return rows, tuple(t.to(torch.bfloat16) for t in (q, k, v))


def _near_midpoints(g, b, h, s, d, dev):
    """q, k whose every p = exp(s - max) lies within a few fp32 ulps of a
    bf16 rounding midpoint: key j's first three columns carry the bf16
    parts of t_j = log(m_j) / scale (m_j the midpoint above a random bf16
    value in [0.02, 0.99); t_0 = 0, every row's max, the key every causal row
    sees), q's first three columns are 1, and the other columns are random
    in q and the same for every key of a head. A score is then scale *
    (t_j + a row's shared term), summed over all d columns, so the last
    bits that decide bf16(p) are those of the summation order."""
    scale = d ** -0.5
    x = torch.rand(b, h, s, device=dev, generator=g, dtype=torch.float64)
    lo = (0.02 + 0.97 * x).to(torch.bfloat16)  # below 1: t_0 = 0 is the max
    up = (lo.view(torch.int16) + 1).view(torch.bfloat16)  # the next bf16
    t = torch.log((lo.double() + up.double()) / 2) / scale
    t[:, :, 0] = 0.0
    parts = []
    for _ in range(3):
        part = t.to(torch.bfloat16)
        parts.append(part)
        t = t - part.double()
    k = torch.randn(b, h, 1, d, device=dev, generator=g).expand(
        b, h, s, d).clone()
    k[..., :3] = torch.stack(parts, dim=-1).float()
    q = torch.randn(b, h, s, d, device=dev, generator=g)
    q[..., :3] = 1.0
    v = torch.randn(b, h, s, d, device=dev, generator=g)
    return tuple(u.to(torch.bfloat16) for u in (q, k, v))


_EXACT_P_FORMS = {"plain": (False, False), "bias": (True, False),
                  "dropout": (False, True), "both": (True, True)}


@pytest.mark.parametrize("form", sorted(_EXACT_P_FORMS))
@pytest.mark.parametrize("d", [128, 192, 256])
@pytest.mark.parametrize("kind", ["last_tile_max", "midpoints"])
def test_bf16_flash_fwd_exact_p_cases(dev, kind, d, form):
    """The bf16 forward where exact p is hardest, at head dims 128, 192
    (padded to 256) and 256 in every form (a bias, dropout, both, or
    neither): rows whose max arrives in their last key tile (a planted
    score), and scores whose p all sit near bf16 rounding midpoints, where
    only the plain version's summation order decides bf16(p). o and lse
    against the plain version within the flash tolerances, two runs the
    same bits, the launch counted at its width."""
    b, h, s = 2, 3, 300 if kind == "last_tile_max" else 257
    g = torch.Generator(device=dev).manual_seed(d * 11 + len(form))
    if kind == "last_tile_max":
        rows, (q, k, v) = _planted_last_tile_max(g, b, h, s, d, dev)
        sc = torch.matmul(q.float(), k.float().transpose(-1, -2))
        sc = sc.masked_fill(torch.ones(s, s, dtype=torch.bool,
                                       device=dev).triu(1), -1e30)
        # the construction: the planted key is its row's max
        assert (sc.argmax(-1)[:, :, rows] == rows).float().mean() > 0.9
    else:
        q, k, v = _near_midpoints(g, b, h, s, d, dev)
        sc = torch.matmul(q.double(), k.double().transpose(-1, -2)) \
            * d ** -0.5
        live = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
        pr = torch.exp(sc - sc.masked_fill(~live, -1e30).amax(
            -1, keepdim=True))[:, :, live].float()
        # the construction: in exact arithmetic nearly every p lies within
        # 8 fp32 ulps of a bf16 midpoint (each row's max, p = 1, does not)
        low = pr.view(torch.int32) & 0xFFFF
        assert ((low - 0x8000).abs() <= 8).float().mean() > 0.9
    with_bias, dropout = _EXACT_P_FORMS[form]
    kw = dict(scale=d ** -0.5, causal=True)
    if with_bias:
        # a per-row shift (exact in fp32) or a learned-like bias
        kw["bias"] = ((torch.arange(s, device=dev) % 4) * 0.25).view(
            1, 1, s, 1) if kind == "midpoints" else torch.randn(
            1, h, s, s, device=dev, generator=g) * 0.5
    if dropout:
        kw.update(dropout_p=0.1, dropout_seed=torch.tensor(
            [d + s], dtype=torch.int32, device=dev))
    _build.reset_launches()
    o, lse = flash_attention_fwd(q, k, v, **kw)
    o2, lse2 = flash_attention_fwd(q, k, v, **kw)
    op, lsep = flash_attention_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    kd = fa_kernel_head_dim(d)
    assert _build.form_launches[f"fa_fwd:wgmma:d{kd}"] == 2
    torch.testing.assert_close(o.float(), op.float(), atol=2e-3,
                               rtol=2 ** -7)
    torch.testing.assert_close(lse, lsep, atol=2e-5, rtol=0)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


# the bf16 backward pair at d = 128 and 256 (csrc/flash_bwd_{dq,dkv}_wgmma.cu):
# forms as (bias, dropout, dlogits)
_BWD128_FORMS = {"plain": (False, False, False), "bias": (True, False, False),
                 "dropout": (False, True, False), "both": (True, True, False),
                 "dlogits": (True, False, True),
                 "dlogits_dropout": (True, True, True)}


def _bf16_bwd_check(dev, q, k, v, do, causal, form, seed):
    """The backward of (q, k, v, do) in ``form`` (a learned-like (1, h,
    sq, sk) bias, dropout, the dlogits) against the plain version on the
    same inputs and the forward's o and lse: dq, dk, dv within the flash
    backward's tolerance of their dtype (bf16: the tensor-core pair; fp32:
    the FMA-pipe pair, 1e-4), the dlogits within ``_DLOGITS_TOL``; two runs
    the same bits; one launch of each kernel at its width (and pad key) and
    in its forms."""
    b, h, sq, d = q.shape
    route = "wgmma" if q.dtype == torch.bfloat16 else "fma"
    tol = (1e-2, 2 ** -6) if q.dtype == torch.bfloat16 else (1e-4, 0)
    sk = k.shape[2]
    with_bias, dropout, dlogits = _BWD128_FORMS[form]
    g = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(scale=d ** -0.5, causal=causal)
    if with_bias:
        kw["bias"] = torch.randn(1, h, sq, sk, device=dev, generator=g)
    if dropout:
        kw.update(dropout_p=0.1, dropout_seed=torch.tensor(
            [seed], dtype=torch.int32, device=dev))
    o, lse = flash_attention_fwd(q, k, v, **kw)
    bkw = dict(kw, want_dbias=dlogits)
    _build.reset_launches()
    got = flash_attention_bwd(q, k, v, o, lse, do, **bkw)
    again = flash_attention_bwd(q, k, v, o, lse, do, **bkw)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, **bkw)
    torch.cuda.synchronize()
    kd = fa_kernel_head_dim(d)
    assert kd in (128, 256)
    expect = {}
    for name in ("fa_bwd_dq", "fa_bwd_dkv"):
        expect[f"{name}:{route}:d{kd}"] = 2
        if d != kd:
            expect[f"{name}:{route}:pad{d}"] = 2
        if dropout:
            expect[f"{name}:{route}:d{kd}:dropout"] = 2
    if dlogits:
        expect[f"fa_bwd_dq:{route}:d{kd}:dbias"] = 2
    assert dict(_build.form_launches) == expect
    failures = []
    for name, a, w, a2 in zip(("dq", "dk", "dv", "dbias"), got, want,
                              again):
        at, rt = _DLOGITS_TOL if name == "dbias" else tol
        try:
            torch.testing.assert_close(a.float(), w.float(), atol=at,
                                       rtol=rt)
        except AssertionError as err:
            failures.append(f"{name}: {err}")
        if not torch.equal(a, a2):
            failures.append(f"{name}: two runs gave different bits")
    assert not failures, "\n".join(failures)


@pytest.mark.parametrize("form", sorted(_BWD128_FORMS))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(256, 256), (200, 333)])
@pytest.mark.parametrize("d", [128, 80, 96])
def test_bf16_flash_bwd_at_128_matches_plain(dev, d, sq, sk, causal, form):
    """The bf16 dq and dk / dv kernels at head width 128 (d = 80 and 96
    through the zero-padded route) in every form, causal and full, square
    and ragged (200 x 333: the sk edge in a key tile, a warpgroup of keys
    past the queries), against the plain versions."""
    g = torch.Generator(device=dev).manual_seed(d + sq + sk + causal)
    q, k, v, do = (torch.randn(2, 3, s, d, device=dev, generator=g)
                   .to(torch.bfloat16) for s in (sq, sk, sk, sq))
    _bf16_bwd_check(dev, q, k, v, do, causal, form, d * 3 + len(form))


@pytest.mark.parametrize("form", ["plain", "dropout", "dlogits"])
def test_bf16_flash_bwd_at_128_planted_last_tile_max(dev, form):
    """Rows whose max lies in their last key tile (a planted score, every
    fifth row) through the bf16 backward pair at d = 128, causal."""
    g = torch.Generator(device=dev).manual_seed(len(form))
    _, (q, k, v) = _planted_last_tile_max(g, 2, 3, 300, 128, dev)
    do = torch.randn(2, 3, 300, 128, device=dev, generator=g).to(
        torch.bfloat16)
    _bf16_bwd_check(dev, q, k, v, do, True, form, 11)


def test_bf16_flash_bwd_at_128_over_65535_batch_heads(dev):
    """batch * heads = 65,600 (1025 x 64) through grid.y x grid.z at d =
    128, causal, with dropout: the pair against the plain versions."""
    g = torch.Generator(device=dev).manual_seed(19)
    q, k, v, do = (torch.randn(1025, 64, 64, 128, device=dev, generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    _bf16_bwd_check(dev, q, k, v, do, True, "dropout", 23)


@pytest.mark.parametrize("form", sorted(_BWD128_FORMS))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(256, 256), (200, 333), (100, 333)])
@pytest.mark.parametrize("d", [256, 192, 144])
def test_bf16_flash_bwd_at_256_matches_plain(dev, d, sq, sk, causal, form):
    """The bf16 dq and dk / dv kernels at head width 256 (d = 192 and 144
    through the zero-padded route) in every form, causal and full, square
    and ragged: 200 x 333 puts the sk edge inside a key tile; 100 x 333
    puts sq inside a dq block's second warpgroup and, in dk / dv, inside
    the second warpgroup's half of a query tile, the sk edge inside a key
    slab; against the plain versions."""
    g = torch.Generator(device=dev).manual_seed(d + sq + sk + causal)
    q, k, v, do = (torch.randn(2, 3, s, d, device=dev, generator=g)
                   .to(torch.bfloat16) for s in (sq, sk, sk, sq))
    _bf16_bwd_check(dev, q, k, v, do, causal, form, d * 3 + len(form))


@pytest.mark.parametrize("form", ["plain", "dropout", "dlogits"])
def test_bf16_flash_bwd_at_256_planted_last_tile_max(dev, form):
    """Rows whose max lies in their last key tile (a planted score, every
    fifth row) through the bf16 backward pair at d = 256, causal."""
    g = torch.Generator(device=dev).manual_seed(len(form))
    _, (q, k, v) = _planted_last_tile_max(g, 2, 3, 300, 256, dev)
    do = torch.randn(2, 3, 300, 256, device=dev, generator=g).to(
        torch.bfloat16)
    _bf16_bwd_check(dev, q, k, v, do, True, form, 11)


def test_bf16_flash_bwd_at_256_over_65535_batch_heads(dev):
    """batch * heads = 65,600 (1025 x 64) through grid.y x grid.z at d =
    256, causal, with dropout: the pair against the plain versions."""
    g = torch.Generator(device=dev).manual_seed(19)
    q, k, v, do = (torch.randn(1025, 64, 64, 256, device=dev, generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    _bf16_bwd_check(dev, q, k, v, do, True, "dropout", 23)


# the fp32 backward's block and tile heights at d = 256 (fa_fma_bwd_geometry:
# blocks of 32 rows over tiles of 32, the scores split by depth) and the
# sizes one below and one above
_FMA256_EDGES = [31, 32, 33]


@pytest.mark.parametrize("form", sorted(_BWD128_FORMS))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sk", _FMA256_EDGES)
@pytest.mark.parametrize("sq", _FMA256_EDGES)
@pytest.mark.parametrize("d", [256, 192, 144])
def test_fp32_flash_bwd_at_256_tile_edges(dev, d, sq, sk, causal, form):
    """The fp32 dq and dk / dv kernels at head width 256 (d = 192 and 144
    through the zero-padded route) where sq and sk cross their block and
    tile heights, causal and full, in every form: within 1e-4 of the plain
    version (the dlogits within ``_DLOGITS_TOL``), two runs the same
    bits."""
    g = torch.Generator(device=dev).manual_seed(d + 100 * sq + sk + causal)
    q, k, v, do = (torch.randn(1, 2, s, d, device=dev, generator=g)
                   for s in (sq, sk, sk, sq))
    _bf16_bwd_check(dev, q, k, v, do, causal, form, d + len(form))


@pytest.mark.parametrize("form", sorted(_BWD128_FORMS))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(256, 256), (200, 333), (100, 333)])
@pytest.mark.parametrize("d", [256, 192, 144])
def test_fp32_flash_bwd_at_256_matches_plain(dev, d, sq, sk, causal, form):
    """The fp32 pair at head width 256 (d = 192 and 144 padded) over many
    blocks and tiles, square and ragged (200 x 333: the sk edge inside a
    key tile; 100 x 333: sq inside a query tile, keys past every query),
    in every form, against the plain versions."""
    g = torch.Generator(device=dev).manual_seed(d + sq + sk + causal + 1)
    q, k, v, do = (torch.randn(2, 3, s, d, device=dev, generator=g)
                   for s in (sq, sk, sk, sq))
    _bf16_bwd_check(dev, q, k, v, do, causal, form, d * 3 + len(form))


def test_fp32_flash_bwd_at_256_over_65535_batch_heads(dev):
    """batch * heads = 65,600 (1025 x 64) through grid.y x grid.z at d =
    256 in fp32, 48 rows (a block and a half), causal, with dropout: the
    pair against the plain versions."""
    g = torch.Generator(device=dev).manual_seed(29)
    q, k, v, do = (torch.randn(1025, 64, 48, 256, device=dev, generator=g)
                   for _ in range(4))
    _bf16_bwd_check(dev, q, k, v, do, True, "dropout", 31)


# the fp32 backward's block and tile heights at d = 128 (fa_fma_bwd_geometry:
# blocks of 32 rows over tiles of 32, the scores split by depth into two
# parts, two blocks an SM) and the sizes one below and one above
_FMA128_EDGES = [31, 32, 33]


@pytest.mark.parametrize("form", sorted(_BWD128_FORMS))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sk", _FMA128_EDGES)
@pytest.mark.parametrize("sq", _FMA128_EDGES)
@pytest.mark.parametrize("d", [128, 96, 80])
def test_fp32_flash_bwd_at_128_tile_edges(dev, d, sq, sk, causal, form):
    """The fp32 dq and dk / dv kernels at head width 128 (d = 96 and 80
    through the zero-padded route) where sq and sk cross their block and
    tile heights, causal and full, in every form: within 1e-4 of the plain
    version (the dlogits within ``_DLOGITS_TOL``), two runs the same
    bits."""
    g = torch.Generator(device=dev).manual_seed(d + 100 * sq + sk + causal)
    q, k, v, do = (torch.randn(1, 2, s, d, device=dev, generator=g)
                   for s in (sq, sk, sk, sq))
    _bf16_bwd_check(dev, q, k, v, do, causal, form, d + len(form))


@pytest.mark.parametrize("form", sorted(_BWD128_FORMS))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(256, 256), (200, 333), (100, 333)])
@pytest.mark.parametrize("d", [128, 96, 80])
def test_fp32_flash_bwd_at_128_matches_plain(dev, d, sq, sk, causal, form):
    """The fp32 pair at head width 128 (d = 96 and 80 padded) over many
    blocks and tiles, square and ragged (200 x 333: the sk edge inside a
    key tile; 100 x 333: sq inside a query tile, keys past every query),
    in every form, against the plain versions."""
    g = torch.Generator(device=dev).manual_seed(d + sq + sk + causal + 1)
    q, k, v, do = (torch.randn(2, 3, s, d, device=dev, generator=g)
                   for s in (sq, sk, sk, sq))
    _bf16_bwd_check(dev, q, k, v, do, causal, form, d * 3 + len(form))


def test_fp32_flash_bwd_at_128_over_65535_batch_heads(dev):
    """batch * heads = 65,600 (1025 x 64) through grid.y x grid.z at d =
    128 in fp32, 48 rows (a block and a half), causal, with dropout: the
    pair against the plain versions."""
    g = torch.Generator(device=dev).manual_seed(37)
    q, k, v, do = (torch.randn(1025, 64, 48, 128, device=dev, generator=g)
                   for _ in range(4))
    _bf16_bwd_check(dev, q, k, v, do, True, "dropout", 41)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [48, 80, 128, 192, 256])
def test_public_flash_at_head_dims_matches_the_cpu(dev, d, dtype):
    """The public op (default scale from the caller's d, a differentiated
    (1, h, 1, sk) bias, a key-padding mask) at padded and compiled head
    dims up to the widest: o and every gradient against the same call on
    the CPU (fp32 1e-4, bf16 the flash backward's tolerance, ten times its
    atol for the bias's)."""
    b, h, sq, sk = 2, 3, 70, 90
    g = torch.Generator().manual_seed(d)
    q, k, v, do = (torch.randn(b, h, s, d, generator=g).to(dtype)
                   for s in (sq, sk, sk, sq))
    bias = torch.randn(1, h, 1, sk, generator=g)
    mask = (torch.arange(sk) >= torch.tensor([sk, 40])[:, None])[
        :, None, None, :]
    outs = {}
    for where in ("cpu", dev):
        ins = [t.detach().to(where).requires_grad_(True)
               for t in (q, k, v, bias)]
        o = flash_attention(*ins[:3], True, bias=ins[3],
                            mask=mask.to(where))
        o.backward(do.to(where))
        outs[str(where)] = [o.detach().cpu()] + [t.grad.cpu() for t in ins]
    atol = 1e-4 if dtype == torch.float32 else 1e-2
    rtol = 0 if dtype == torch.float32 else 2 ** -6
    for i, (a, w) in enumerate(zip(outs[str(dev)], outs["cpu"])):
        torch.testing.assert_close(a.float(), w.float(),
                                   atol=atol * (10 if i == 4 else 1),
                                   rtol=rtol, msg=f"output {i}")


def _masked_inputs(dev, b, h, sq, sk, mshape, dtype, seed, kind="mask"):
    """q, k, v, do and a bias of shape ``mshape`` (None: no bias): a mask
    (-1e30 where masked; a full-row mask masks whole rows, and with full
    columns a key no query sees) or, for ``kind="bias"``, random values."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b, h, s, 64, device=dev, generator=g).to(dtype)
               for s in (sq, sk, sk))
    do = torch.randn(b, h, sq, 64, device=dev, generator=g).to(dtype)
    if mshape is None:
        return q, k, v, do, None
    if kind == "bias":
        return q, k, v, do, torch.randn(mshape, device=dev, generator=g)
    mask = torch.rand(mshape, device=dev, generator=g) < 0.3
    if mshape[2] != 1:
        mask[0, 0, 3] = True           # whole rows masked
        mask[-1, -1, sq - 1] = True
        if mshape[3] != 1:
            mask[0, 0, :, 5] = True    # a key no query sees
    bias = torch.zeros(mshape, device=dev).masked_fill_(mask, -1e30)
    return q, k, v, do, bias


# (b, h, sq, sk), the bias's shape (None: none) and its kind: key-padding,
# full and per-head masks at 2 x 3 x 70 x 130; BERT-large's 32 x 16 x 128
# x 128 plain, with its (b, 1, 1, sk) padding mask and with a full mask;
# an additive bias broadcast over the batch
MASK_CASES = [((2, 3, 70, 130), (2, 1, 1, 130), "mask"),
              ((2, 3, 70, 130), (2, 3, 70, 130), "mask"),
              ((2, 3, 70, 130), (1, 3, 70, 1), "mask"),
              ((32, 16, 128, 128), None, "mask"),
              ((32, 16, 128, 128), (32, 1, 1, 128), "mask"),
              ((32, 16, 128, 128), (32, 16, 128, 128), "mask"),
              ((2, 3, 70, 130), (1, 3, 70, 130), "bias")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims,mshape,kind", MASK_CASES)
def test_masked_flash_kernels_match_plain(dev, dims, mshape, kind, dtype):
    b, h, sq, sk = dims
    # the seed: the bias's shape summed (the first three cases' seeds
    # before the table grew), else the dimensions'
    q, k, v, do, bias = _masked_inputs(dev, b, h, sq, sk, mshape, dtype,
                                       sum(mshape or dims), kind)
    o, lse = flash_attention_fwd(q, k, v, scale=0.125, causal=False,
                                 bias=bias)
    _assert_flash_route(_kernel_names(lambda: flash_attention_fwd(
        q, k, v, scale=0.125, causal=False, bias=bias)), dtype, fwd=True)
    op, lsep = flash_attention_fwd_plain(q, k, v, scale=0.125, causal=False,
                                         bias=bias)
    got = flash_attention_bwd(q, k, v, op, lsep, do, scale=0.125,
                              causal=False, bias=bias)
    _assert_flash_route(_kernel_names(lambda: flash_attention_bwd(
        q, k, v, op, lsep, do, scale=0.125, causal=False, bias=bias)), dtype,
        bwd=True)
    want = flash_attention_bwd_plain(q, k, v, op, lsep, do, scale=0.125,
                                     causal=False, bias=bias)
    again = flash_attention_bwd(q, k, v, op, lsep, do, scale=0.125,
                                causal=False, bias=bias)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(o, op, atol=2e-5, rtol=0)
    else:
        torch.testing.assert_close(o.float(), op.float(), atol=2e-3,
                                   rtol=2 ** -7)
    torch.testing.assert_close(lse, lsep, atol=2e-5, rtol=0)
    masked = (torch.zeros(dims, dtype=torch.bool, device=dev)
              if bias is None else (bias <= -0.5e30).expand(dims))
    dead = masked.all(dim=-1)        # rows that see no key
    unseen = masked.all(dim=-2)      # keys no row sees
    assert torch.equal(o[dead], torch.zeros_like(o[dead]))
    assert bool((lse[dead] == -1e30).all())
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        if dtype == torch.float32:
            torch.testing.assert_close(a, w, atol=1e-4, rtol=0, msg=name)
        else:
            torch.testing.assert_close(a.float(), w.float(), atol=1e-2,
                                       rtol=2 ** -6, msg=name)
    assert torch.equal(got[0][dead], torch.zeros_like(got[0][dead]))
    for grad in got[1:]:
        assert torch.equal(grad[unseen], torch.zeros_like(grad[unseen]))
    assert mshape is None or kind == "bias" or mshape[2] == 1 \
        or mshape[3] == 1 or bool(unseen.any())
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_public_flash_mask_matches_plain_bias(dev):
    """The public op's boolean mask equals the plain version's -1e30 bias,
    forward and backward, and launches the three kernels once each."""
    q, k, v, do, bias = _masked_inputs(dev, 2, 2, 64, 64, (2, 1, 1, 64),
                                       torch.float32, 9)
    mask = bias <= -0.5e30
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    before = dict(_build.launches)
    o = flash_attention(qq, kk, vv, mask=mask)
    o.backward(do)
    torch.cuda.synchronize()
    for name in ("fa_fwd", "fa_bwd_dq", "fa_bwd_dkv"):
        assert _build.launches[name] == before.get(name, 0) + 1
    op, lsep = flash_attention_fwd_plain(q, k, v, scale=0.125, causal=False,
                                         bias=bias)
    want = flash_attention_bwd_plain(q, k, v, op, lsep, do, scale=0.125,
                                     causal=False, bias=bias)
    torch.testing.assert_close(o.detach(), op, atol=2e-5, rtol=0)
    for a, w in zip((qq.grad, kk.grad, vv.grad), want):
        torch.testing.assert_close(a, w, atol=1e-4, rtol=0)


def _lamb_buffers(dev, seed):
    shapes = [(3, 50), (7,), (300,), (), (9,), (40, 70), (1024, 129)]
    g = torch.Generator(device=dev).manual_seed(seed)
    tree = {f"t{i}": torch.randn(s, device=dev, generator=g)
            for i, s in enumerate(shapes)}
    tree["t4"].zero_()                 # a zero leaf: ||p|| = 0
    spec = flat_spec(tree)
    p = flatten(tree, spec, dtype=torch.float32, pad_to=1024)
    grads = flatten({k: torch.randn(t.shape, device=dev, generator=g)
                     for k, t in tree.items()}, spec, dtype=torch.float32,
                    pad_to=1024)
    m = torch.randn(p.numel(), device=dev, generator=g) * 0.1
    v = torch.rand(p.numel(), device=dev, generator=g) * 0.1
    ids = row_segment_ids(spec, p.numel(), device=dev)
    return p, grads, m, v, ids, row_segments(ids, spec.num_leaves), spec


@pytest.mark.parametrize("adam_w_mode,use_nvlamb", [(True, False),
                                                    (False, True)])
def test_lamb_kernels_match_plain(dev, adam_w_mode, use_nvlamb):
    p, grads, m, v, ids, seg, spec = _lamb_buffers(dev, 3 + adam_w_mode)
    ref = [t.clone() for t in (p, m, v)]
    kw = dict(num_tensors=spec.num_leaves, lr=1e-2, weight_decay=0.01,
              step=torch.tensor(3, dtype=torch.int32, device=dev),
              adam_w_mode=adam_w_mode, use_nvlamb=use_nvlamb,
              inv_scale=0.5, found_inf=torch.tensor(False, device=dev),
              segments=seg)
    before = (_build.launches["lamb_stage1"], _build.launches["lamb_stage2"])
    gn = fused_lamb_flat(p, grads, m, v, ids, **kw)
    gp = fused_lamb_flat_plain(*ref[:1], grads, *ref[1:], ids, **kw)
    torch.cuda.synchronize()
    assert (_build.launches["lamb_stage1"], _build.launches["lamb_stage2"]) \
        == (before[0] + 1, before[1] + 1)
    for got, want in zip((p, m, v, gn), ref + [gp]):
        torch.testing.assert_close(got, want, atol=0, rtol=1e-7)


def test_lamb_is_deterministic_and_overflow_is_a_bitwise_noop(dev):
    runs = []
    for _ in range(2):
        p, grads, m, v, ids, seg, spec = _lamb_buffers(dev, 7)
        fused_lamb_flat(p, grads, m, v, ids, num_tensors=spec.num_leaves,
                        lr=1e-3, step=1, segments=seg)
        runs.append((p, m, v))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    p, m, v = runs[0]
    before = [t.clone() for t in (p, m, v)]
    grads[5] = float("inf")
    fused_lamb_flat(p, grads, m, v, ids, num_tensors=spec.num_leaves,
                    lr=1e-3, step=2, found_inf=torch.tensor(True, device=dev),
                    segments=seg)
    torch.cuda.synchronize()
    for t, b in zip((p, m, v), before):
        assert torch.equal(t, b)


def test_bert_step_on_the_card(dev):
    """A 2-layer bf16 BERT (head_dim 64) takes one MLM step with flat
    FusedLAMB: a finite loss, finite parameters that moved, and one launch
    of each kernel per norm / layer / stage."""
    from apex_tpu_torch.models.bert import Bert, BertConfig, mlm_loss
    from apex_tpu_torch.models.convert import init_bert_params
    from apex_tpu_torch.optimizers import FusedLAMB
    cfg = BertConfig(vocab_size=512, max_position_embeddings=64,
                     hidden_size=128, num_hidden_layers=2,
                     num_attention_heads=2, intermediate_size=256)
    model = Bert.from_params(cfg, init_bert_params(cfg, 0), device=dev)
    named = dict(model.named_parameters())
    opt = FusedLAMB(named, lr=1e-3, weight_decay=0.01)
    with torch.no_grad():
        for name, view in opt.parameters.items():
            named[name].data = view
    g = torch.Generator(device=dev).manual_seed(0)
    ids = torch.randint(5, 512, (4, 64), device=dev, generator=g)
    labels = torch.where(torch.rand(4, 64, device=dev, generator=g) < 0.15,
                         ids, -1)
    start = {n: t.detach().clone() for n, t in named.items()}
    _build.reset_launches()
    loss = mlm_loss(model, torch.where(labels >= 0, 103 % 512, ids), labels)
    loss.backward()
    opt.step({n: t.grad if t.grad is not None else torch.zeros_like(t)
              for n, t in named.items()})
    torch.cuda.synchronize()
    assert dict(_build.launches) == {
        "ln_fwd": 5, "ln_bwd": 5, "fa_fwd": 2, "fa_bwd_dq": 2,
        "fa_bwd_dkv": 2, "lamb_stage1": 1, "lamb_stage2": 1}
    assert torch.isfinite(loss) and torch.isfinite(opt.last_grad_norm)
    assert all(torch.isfinite(t).all() for t in named.values())
    assert not torch.equal(named["layer.0.qkv.weight"],
                           start["layer.0.qkv.weight"])


def _same(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _run_both(kernel, plain, bufs, name, **kw):
    """The kernel on ``bufs`` and the plain version on copies; one launch
    of ``name``; returns both buffer lists."""
    ref = [t.clone() for t in bufs]
    before = _build.launches[name]
    kernel(*bufs, **kw)
    plain(*ref, **kw)
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 1
    return bufs, ref


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("momentum,nesterov,wd_after",
                         [(0.9, False, False), (0.9, True, False),
                          (0.9, False, True), (0.9, True, True),
                          (0.0, False, False)])
@pytest.mark.parametrize("n", [4096, 1001])
def test_fused_sgd_kernel_matches_plain(dev, n, momentum, nesterov,
                                        wd_after, dtype):
    g = torch.Generator(device=dev).manual_seed(n)
    bufs = [torch.randn(n, device=dev, generator=g).to(dtype),
            torch.randn(n, device=dev, generator=g).to(dtype),
            torch.randn(n, device=dev, generator=g)]
    for first in (True, False):
        got, want = _run_both(
            fused_sgd_flat, fused_sgd_flat_plain, bufs, "fused_sgd",
            lr=0.05, momentum=momentum, dampening=0.0 if nesterov else 0.1,
            weight_decay=1e-4, nesterov=nesterov,
            wd_after_momentum=wd_after, inv_scale=0.5,
            found_inf=torch.tensor(False, device=dev),
            first_step=torch.tensor(first, device=dev))
        _same(got, want)


@pytest.mark.parametrize("mode", [ADAM_MODE_L2, ADAM_MODE_ADAMW])
@pytest.mark.parametrize("n", [4096, 1001])
def test_fused_adam_bf16_kernel_matches_plain(dev, mode, n):
    g = torch.Generator(device=dev).manual_seed(n + mode)
    bufs = [torch.randn(n, device=dev, generator=g).bfloat16(),
            torch.randn(n, device=dev, generator=g).bfloat16(),
            torch.randn(n, device=dev, generator=g),
            torch.rand(n, device=dev, generator=g)]
    got, want = _run_both(fused_adam_flat, fused_adam_flat_plain, bufs,
                          "fused_adam", lr=1e-2, weight_decay=0.01,
                          step=torch.tensor(3, device=dev), mode=mode,
                          inv_scale=0.5)
    _same(got, want)


@pytest.mark.parametrize("mode", [ADAM_MODE_L2, ADAM_MODE_ADAMW])
@pytest.mark.parametrize("n", [4096, 1001])
def test_fused_adam_master_kernel_matches_plain(dev, mode, n):
    g = torch.Generator(device=dev).manual_seed(n + mode)
    bufs = [torch.randn(n, device=dev, generator=g),
            torch.randn(n, device=dev, generator=g),
            torch.randn(n, device=dev, generator=g),
            torch.rand(n, device=dev, generator=g)]
    lp, lp_ref = (torch.empty(n, device=dev, dtype=torch.bfloat16)
                  for _ in range(2))
    ref = [t.clone() for t in bufs]
    kw = dict(lr=1e-2, weight_decay=0.01, step=torch.tensor(3, device=dev),
              mode=mode, inv_scale=0.5)
    before = _build.launches["fused_adam_master"]
    fused_adam_flat_master(*bufs, p_lp=lp, **kw)
    fused_adam_flat_master_plain(*ref, p_lp=lp_ref, **kw)
    torch.cuda.synchronize()
    assert _build.launches["fused_adam_master"] == before + 1
    _same(bufs + [lp], ref + [lp_ref])
    assert torch.equal(lp, bufs[0].bfloat16())
    keep = [t.clone() for t in bufs + [lp]]
    bad = torch.full((n,), float("inf"), device=dev)
    fused_adam_flat_master(bufs[0], bad, bufs[2], bufs[3], p_lp=lp,
                           found_inf=torch.tensor(True, device=dev), **kw)
    torch.cuda.synchronize()
    _same(bufs[:1] + bufs[2:] + [lp], keep[:1] + keep[2:])


@pytest.mark.parametrize("grad_averaging,init_zero", [(True, False),
                                                      (False, True)])
def test_fused_novograd_kernel_matches_plain(dev, grad_averaging,
                                             init_zero):
    shapes = [(3, 50), (7,), (300,), (), (9,), (40, 70), (1024, 129)]
    g = torch.Generator(device=dev).manual_seed(5)
    tree = {f"t{i}": torch.randn(s, device=dev, generator=g)
            for i, s in enumerate(shapes)}
    spec = flat_spec(tree)
    p = flatten(tree, spec, dtype=torch.float32, pad_to=1024)
    grads = flatten({k: torch.randn(t.shape, device=dev, generator=g)
                     for k, t in tree.items()}, spec, dtype=torch.float32,
                    pad_to=1024)
    m = torch.randn(p.numel(), device=dev, generator=g)
    v = torch.rand(spec.num_leaves, device=dev, generator=g)
    ids = row_segment_ids(spec, p.numel(), device=dev)
    kw = dict(num_tensors=spec.num_leaves, lr=1e-2, weight_decay=0.01,
              step=torch.tensor(2, dtype=torch.int32, device=dev),
              grad_averaging=grad_averaging, init_zero=init_zero,
              bias_correction=True, inv_scale=0.5,
              segments=row_segments(ids, spec.num_leaves))
    ref = [t.clone() for t in (p, m, v)]
    runs = [[t.clone() for t in (p, m, v)] for _ in range(2)]
    before = _build.launches["fused_novograd"]
    for a in runs:
        fused_novograd_flat(a[0], grads, a[1], a[2], ids, **kw)
    fused_novograd_flat_plain(ref[0], grads, ref[1], ref[2], ids, **kw)
    torch.cuda.synchronize()
    assert _build.launches["fused_novograd"] == before + 2
    _same(runs[0], ref)
    _same(runs[1], runs[0])          # two runs, the same bits
    keep = [t.clone() for t in runs[0]]
    grads[7] = float("nan")
    fused_novograd_flat(*runs[0][:1], grads, *runs[0][1:], ids,
                        found_inf=torch.tensor(True, device=dev), **kw)
    torch.cuda.synchronize()
    _same(runs[0], keep)


@pytest.mark.parametrize("w_mode", [False, True])
@pytest.mark.parametrize("n", [4096, 1001])
def test_fused_adagrad_kernel_matches_plain(dev, w_mode, n):
    g = torch.Generator(device=dev).manual_seed(n + w_mode)
    bufs = [torch.randn(n, device=dev, generator=g),
            torch.randn(n, device=dev, generator=g),
            torch.rand(n, device=dev, generator=g)]
    kw = dict(lr=1e-2, weight_decay=0.01, adagrad_w_mode=w_mode,
              inv_scale=0.5)
    got, want = _run_both(fused_adagrad_flat, fused_adagrad_flat_plain,
                          bufs, "fused_adagrad", **kw)
    _same(got, want)
    keep = [t.clone() for t in bufs]
    fused_adagrad_flat(bufs[0], torch.full((n,), float("nan"), device=dev),
                       bufs[2], found_inf=torch.tensor(True, device=dev),
                       **kw)
    torch.cuda.synchronize()
    _same([bufs[0], bufs[2]], [keep[0], keep[2]])


def test_flat_sgd_and_adam_overflow_steps_are_bitwise_noops(dev):
    g = torch.Generator(device=dev).manual_seed(9)
    p, grad, b = (torch.randn(2048, device=dev, generator=g)
                  for _ in range(3))
    keep = [p.clone(), b.clone()]
    grad[3] = float("inf")
    fused_sgd_flat(p, grad, b, lr=0.1, momentum=0.9,
                   found_inf=torch.tensor(True, device=dev))
    pb = p.bfloat16()
    m, v = torch.zeros(2048, device=dev), torch.zeros(2048, device=dev)
    keep_b = [pb.clone(), m.clone(), v.clone()]
    fused_adam_flat(pb, grad.bfloat16(), m, v, lr=0.1, step=1,
                    found_inf=torch.tensor(True, device=dev))
    torch.cuda.synchronize()
    _same([p, b, pb, m, v], keep + keep_b)


def test_resnet_step_on_the_card(dev):
    """A bf16-compute ResNet18ish takes one flat FusedSGD step and one
    master-weight FusedAdam step over bf16 parameters: finite losses,
    parameters that moved, one launch of each optimizer kernel."""
    import torch.nn.functional as F
    from apex_tpu_torch.models.convert import init_resnet_params
    from apex_tpu_torch.models.resnet import ResNet18ish
    from apex_tpu_torch.optimizers import FusedAdam, FusedSGD
    params = init_resnet_params(0, stage_sizes=(1, 1, 1, 1), num_classes=10)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(8, 64, 64, 3, device=dev, generator=g)
    y = torch.randint(0, 10, (8,), device=dev, generator=g)
    for kernel, bf16, make in (
            ("fused_sgd", False, lambda n: FusedSGD(
                n, lr=0.1, momentum=0.9, weight_decay=1e-4, use_flat=True)),
            ("fused_adam_master", True, lambda n: FusedAdam(
                n, lr=1e-3, master_weights=True, use_flat=True))):
        model = ResNet18ish(device=dev)
        model.load_state_dict(params)
        if bf16:
            for t in model.parameters():
                t.data = t.data.bfloat16()
        named = dict(model.named_parameters())
        opt = make(named)
        with torch.no_grad():
            for name, view in opt.parameters.items():
                named[name].data = view
        start = {n: t.detach().clone() for n, t in named.items()}
        _build.reset_launches()
        logits = model(x)
        loss = -(F.log_softmax(logits, -1) * F.one_hot(y, 10)).sum(-1).mean()
        loss.backward()
        opt.step({n: t.grad for n, t in named.items()})
        torch.cuda.synchronize()
        assert dict(_build.launches) == {kernel: 1}
        assert torch.isfinite(loss)
        assert all(torch.isfinite(t).all() for t in named.values())
        assert not torch.equal(named["fc.weight"], start["fc.weight"])


# (n, h, w, c, dtype, act, affine, algo, hw_block): the kernel phase's
# shapes at a small batch, and the ragged forms
GN_CASES = [
    (2, 64, 64, 320, torch.bfloat16, "silu", "wb", "auto", None),
    (1, 64, 64, 960, torch.bfloat16, "silu", "wb", "auto", None),
    (2, 32, 32, 256, torch.float32, "silu", "wb", "one_pass", None),
    (2, 32, 32, 256, torch.float32, "silu", "wb", "two_pass", None),
    (2, 32, 32, 256, torch.bfloat16, "", "wb", "one_pass", None),
    (2, 32, 32, 256, torch.bfloat16, "", "wb", "two_pass", None),
    (1, 64, 64, 960, torch.float32, "silu", "wb", "one_pass", None),
    (2, 16, 16, 64, torch.float32, "silu", None, "auto", None),
    (2, 16, 16, 64, torch.float32, "", "w", "two_pass", 32),
    (2, 16, 16, 64, torch.bfloat16, "silu", "b", "one_pass", None),
    # hw % 8 != 0, which the TPU kernels do not take
    (2, 7, 7, 320, torch.bfloat16, "silu", "wb", "auto", None),
    (1, 63, 63, 960, torch.bfloat16, "silu", "wb", "auto", None),
    (2, 7, 7, 64, torch.float32, "", "wb", "two_pass", None),
]


def _gn_inputs(dev, n, h, w, c, dtype, affine, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(n, h, w, c, device=dev, generator=g) * 2 + 0.5) \
        .to(dtype)
    wt = 1 + 0.1 * torch.randn(c, device=dev, generator=g)
    bt = 0.1 * torch.randn(c, device=dev, generator=g)
    return (x, wt if affine and "w" in affine else None,
            bt if affine and "b" in affine else None)


def _gn_close(got, want, dtype):
    rtol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), atol=1e-5,
                               rtol=rtol)


@pytest.mark.parametrize("case", GN_CASES)
def test_group_norm_kernels_match_plain(dev, case):
    """Each GroupNorm kernel the case's route launches against its plain
    twin on the same card inputs, each kernel on its own inputs;
    ``group_norm_nhwc_fwd`` launches exactly the kernels its route
    names."""
    n, h, w, c, dtype, act, affine, algo, hwb = case
    x, wt, bt = _gn_inputs(dev, n, h, w, c, dtype, affine, sum(case[:4]))
    groups = 32
    x3 = x.reshape(n, h * w, c)
    _build.reset_launches()
    y, mean, rstd = group_norm_nhwc_fwd(x, groups, wt, bt, 1e-5, act, algo,
                                        hwb)
    torch.cuda.synchronize()
    one = algo == "one_pass" or (algo == "auto"
                                 and gn_one_pass_ok(h * w, c, groups))
    want_launches = ({"gn_one_pass": 1} if one
                     else {"gn_stats": 1, "gn_apply": 1})
    assert dict(_build.launches) == want_launches
    shift = gn_shift(x3, groups)
    if one:
        yp, dp, rp = gn_one_pass_plain(x3, groups, wt, bt, eps=1e-5, act=act)
    else:
        blk = gn_hw_block(h * w, c, hwb)
        ps, pq = gn_stats(x3, shift, blk)
        ps_p, pq_p = gn_stats_plain(x3, shift, blk)
        torch.testing.assert_close(ps, ps_p, atol=1e-3, rtol=1e-5)
        torch.testing.assert_close(pq, pq_p, atol=1e-3, rtol=1e-5)
        dp, rp = gn_moments(ps_p, pq_p, h * w * c // groups, 1e-5)
        yk = gn_apply(x3, shift, dp, rp, wt, bt, act=act, hw_block=blk)
        yp = gn_apply_plain(x3, shift, dp, rp, wt, bt, act=act)
        _gn_close(yk, yp, dtype)
    _gn_close(y.reshape(yp.shape), yp, dtype)
    torch.testing.assert_close(mean, shift + dp, atol=1e-5, rtol=0)
    torch.testing.assert_close(rstd, rp, atol=0, rtol=1e-4)
    again = group_norm_nhwc_fwd(x, groups, wt, bt, 1e-5, act, algo, hwb)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((y, mean, rstd), again))


@pytest.mark.parametrize("algo", ["one_pass", "two_pass"])
def test_group_norm_ill_conditioned_group_is_finite(dev, algo):
    """A group with mean 1000 and std 0.01 (fp32): the shifted statistics
    stay finite and within 1e-4 of a float64 reference."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(2, 16, 16, 64, device=dev, generator=g)
    x[0, :, :, :2] = 1000 + 0.01 * torch.randn(16, 16, 2, device=dev,
                                               generator=g)
    y, _, rstd = group_norm_nhwc_fwd(x, 32, algo=algo)
    x64 = x.double().reshape(2, 256, 32, 2)
    m = x64.mean(dim=(1, 3), keepdim=True)
    v = ((x64 - m) ** 2).mean(dim=(1, 3), keepdim=True)
    y64 = ((x64 - m) / torch.sqrt(v + 1e-5)).reshape(x.shape)
    assert torch.isfinite(y).all() and torch.isfinite(rstd).all()
    assert (y.double() - y64).abs().max().item() <= 1e-4


def test_group_norm_module_on_the_card_matches_cpu(dev):
    """``GroupNorm`` forward and backward (the torch-op backward from the
    kernels' saved statistics) on the card against the same module on the
    CPU, both algorithms, fp32, no TF32 in play (1e-4)."""
    from apex_tpu_torch.contrib.group_norm import GroupNorm
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 16, 16, 64, generator=g)
    r = torch.randn(2, 16, 16, 64, generator=g)
    grads = {}
    for where in ("cpu", dev):
        m = GroupNorm(8, 64, act="silu", device=where)
        with torch.no_grad():
            m.weight.copy_(1 + 0.1 * torch.arange(64.0) / 64)
            m.bias.copy_(0.01 * torch.arange(64.0))
        xx = x.to(where).detach().requires_grad_()
        (m(xx) * r.to(where)).sum().backward()
        grads[str(where)] = [t.detach().cpu() for t in
                             (xx.grad, m.weight.grad, m.bias.grad)]
    for a, b in zip(grads["cpu"], grads[str(dev)]):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("algo", ["auto", "one_pass", "two_pass"])
def test_group_norm_odd_hw_runs_the_kernels(dev, algo):
    """hw = 49 (not a multiple of 8) on the card: ``group_norm_nhwc``
    launches the kernels of its route, an explicit ``algo`` included (the
    CPU route, as JAX's, takes the plain reference there), and y and every
    gradient equal the CPU's (fp32, 1e-4)."""
    from apex_tpu_torch.contrib.group_norm import group_norm_nhwc
    g = torch.Generator().manual_seed(29)
    x = torch.randn(2, 7, 7, 64, generator=g) * 2 + 0.5
    wt = 1 + 0.1 * torch.randn(64, generator=g)
    bt = 0.1 * torch.randn(64, generator=g)
    r = torch.randn(2, 7, 7, 64, generator=g)
    out = {}
    for where in ("cpu", dev):
        xx, ww, bb = (t.to(where).detach().requires_grad_()
                      for t in (x, wt, bt))
        _build.reset_launches()
        y = group_norm_nhwc(xx, 8, ww, bb, 1e-5, "silu",
                            "auto" if where == "cpu" else algo)
        (y * r.to(where)).sum().backward()
        torch.cuda.synchronize()
        launches = dict(_build.launches)
        out[str(where)] = [t.detach().cpu() for t in
                           (y, xx.grad, ww.grad, bb.grad)]
    assert launches == ({"gn_stats": 1, "gn_apply": 1} if algo == "two_pass"
                        else {"gn_one_pass": 1})
    for a, b in zip(out["cpu"], out[str(dev)]):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("algo", ["one_pass", "two_pass"])
def test_group_norm_ill_conditioned_gradients_on_the_card(dev, algo):
    """The mean-1000 / std-0.01 group through the kernels and the
    backward from their shift and mean_d: dx, dweight and dbias within
    1e-4 (relative to each tensor's largest value) of float64 autograd."""
    g = torch.Generator().manual_seed(31)
    x = torch.randn(2, 16, 16, 64, generator=g)
    x[0, :, :, :2] = 1000 + 0.01 * torch.randn(16, 16, 2, generator=g)
    wt = 1 + 0.1 * torch.randn(64, generator=g)
    bt = 0.1 * torch.randn(64, generator=g)
    r = torch.randn(2, 16, 16, 64, generator=g)
    from apex_tpu_torch.contrib.group_norm import group_norm_nhwc
    xx, ww, bb = (t.to(dev).requires_grad_() for t in (x, wt, bt))
    (group_norm_nhwc(xx, 32, ww, bb, 1e-5, "silu", algo) * r.to(dev)) \
        .sum().backward()
    xd, wd, bd = (t.double().requires_grad_() for t in (x, wt, bt))
    y64 = torch.nn.functional.group_norm(xd.permute(0, 3, 1, 2), 32, wd, bd,
                                         1e-5).permute(0, 2, 3, 1)
    (torch.nn.functional.silu(y64) * r.double()).sum().backward()
    for got, want in ((xx.grad, xd.grad), (ww.grad, wd.grad),
                      (bb.grad, bd.grad)):
        got = got.double().cpu()
        assert torch.isfinite(got).all()
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-4


@pytest.mark.parametrize("pdtype", [torch.float32, torch.bfloat16])
def test_ln_bf16_parameters_on_the_card(dev, pdtype):
    """bf16 (or fp32) weight and bias through ``fused_layer_norm_affine`` on
    the card: no refusal, and y, dx, dweight and dbias (in the parameters'
    dtype) equal the CPU route's within the LayerNorm tolerances."""
    from apex_tpu_torch.normalization.fused_layer_norm import (
        fused_layer_norm_affine)
    g = torch.Generator().manual_seed(13)
    x = torch.randn(64, 768, generator=g) * 2 + 0.5
    w = (torch.randn(768, generator=g)).to(pdtype)
    b = (torch.randn(768, generator=g)).to(pdtype)
    r = torch.randn(64, 768, generator=g)
    out = {}
    for where in ("cpu", dev):
        xx, ww, bb = (t.to(where).detach().requires_grad_()
                      for t in (x, w, b))
        y = fused_layer_norm_affine(xx, ww, bb, 768, 1e-5)
        (y * r.to(where)).sum().backward()
        out[str(where)] = [t.detach().cpu() for t in
                           (y, xx.grad, ww.grad, bb.grad)]
    cpu, card = out["cpu"], out[str(dev)]
    assert card[2].dtype == card[3].dtype == pdtype
    torch.testing.assert_close(card[0], cpu[0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(card[1], cpu[1], atol=1e-4, rtol=1e-5)
    for a, c in zip(card[2:], cpu[2:]):
        torch.testing.assert_close(a.float(), c.float(), atol=1e-3,
                                   rtol=2 ** -7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rms,affine", [(False, True), (True, True),
                                        (False, False)])
@pytest.mark.parametrize("rows,hidden", [(16, 12288), (5, 16384),
                                         (3, 65536), (300, 8200),
                                         (2, 200003)])
def test_wide_ln_kernels_match_plain(dev, rows, hidden, rms, affine, dtype):
    """Rows wider than the shared-memory form (8192), past the JAX
    package's 65536: the forward and backward forms that stage nothing,
    against the plain versions with the LayerNorm tolerances; the backward
    twice gives the same bits."""
    g = torch.Generator(device=dev).manual_seed(rows + hidden)
    x = (torch.randn(rows, hidden, device=dev, generator=g) * 2 + 0.5) \
        .to(dtype)
    dy = torch.randn(rows, hidden, device=dev, generator=g).to(dtype)
    gamma = torch.randn(hidden, device=dev, generator=g) if affine else None
    beta = (torch.randn(hidden, device=dev, generator=g)
            if affine and not rms else None)
    y, mean, invvar = ln_fwd(x, gamma, beta, eps=1e-5, rms=rms)
    yp, mp, ivp = ln_fwd_plain(x, gamma, beta, eps=1e-5, rms=rms)
    torch.cuda.synchronize()
    rtol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(y.float(), yp.float(), atol=1e-5, rtol=rtol)
    torch.testing.assert_close(mean, mp, atol=1e-5, rtol=0)
    torch.testing.assert_close(invvar, ivp, atol=0, rtol=1e-5)
    args = (dy, x, gamma, beta, None if rms else mp, ivp)
    got = ln_bwd(*args, rms=rms)
    want = ln_bwd_plain(*args, rms=rms)
    again = ln_bwd(*args, rms=rms)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=1e-5,
                               rtol=rtol)
    for a, b in zip(got[1:], want[1:]):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-4)
    assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_over_65535_batch_heads(dev, dtype):
    """batch * heads = 65600 (1025 x 64) runs through grid.y x grid.z:
    o, lse, dq, dk and dv against the plain versions, each checked
    whatever the others give (the failures are collected), and bf16 on
    the tensor-core forward, dq and dk / dv kernels."""
    b, h, s = 1025, 64, 64
    g = torch.Generator(device=dev).manual_seed(17)
    q, k, v, do = (torch.randn(b, h, s, 64, device=dev, generator=g)
                   .to(dtype) for _ in range(4))
    o, lse = flash_attention_fwd(q, k, v, scale=0.125, causal=True)
    _assert_flash_route(_kernel_names(lambda: flash_attention_fwd(
        q, k, v, scale=0.125, causal=True)), dtype, fwd=True)
    op, lsep = flash_attention_fwd_plain(q, k, v, scale=0.125, causal=True)
    got = flash_attention_bwd(q, k, v, o, lse, do, scale=0.125, causal=True)
    _assert_flash_route(_kernel_names(lambda: flash_attention_bwd(
        q, k, v, o, lse, do, scale=0.125, causal=True)), dtype, bwd=True)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, scale=0.125,
                                     causal=True)
    torch.cuda.synchronize()
    fp32 = dtype == torch.float32
    fwd_tol = (2e-5, 0.0) if fp32 else (2e-3, 2 ** -7)
    bwd_tol = (1e-4, 0.0) if fp32 else (1e-2, 2 ** -6)
    checks = [("o", o, op, fwd_tol), ("lse", lse, lsep, (2e-5, 0.0))]
    checks += [(name, a, c, bwd_tol)
               for name, a, c in zip(("dq", "dk", "dv"), got, want)]
    failures = []
    for name, a, c, (atol, rtol) in checks:
        try:
            torch.testing.assert_close(a.float(), c.float(), atol=atol,
                                       rtol=rtol)
        except AssertionError as err:
            failures.append(f"{name}: {err}")
    assert not failures, "\n".join(failures)


@pytest.mark.parametrize("rms", [False, True])
def test_public_norm_over_65536_launches_the_kernels(dev, rms):
    """``fused_layer_norm_affine`` / ``fused_rms_norm_affine`` at hidden
    70000 on the card launch ``ln_fwd`` and ``ln_bwd`` (no plain route),
    and y and the gradients equal the CPU's within the LayerNorm
    tolerances."""
    from apex_tpu_torch.normalization.fused_layer_norm import (
        fused_layer_norm_affine, fused_rms_norm_affine)
    hidden = 70000
    g = torch.Generator().manual_seed(37)
    x = torch.randn(3, hidden, generator=g) * 2 + 0.5
    w = torch.randn(hidden, generator=g)
    b = torch.randn(hidden, generator=g)
    r = torch.randn(3, hidden, generator=g)
    out = {}
    for where in ("cpu", dev):
        xx, ww, bb = (t.to(where).detach().requires_grad_()
                      for t in (x, w, b))
        _build.reset_launches()
        y = (fused_rms_norm_affine(xx, ww, hidden, 1e-5) if rms else
             fused_layer_norm_affine(xx, ww, bb, hidden, 1e-5))
        (y * r.to(where)).sum().backward()
        torch.cuda.synchronize()
        launches = dict(_build.launches)
        out[str(where)] = [t.detach().cpu() for t in (y, xx.grad, ww.grad)]
    assert launches == {"ln_fwd": 1, "ln_bwd": 1}
    cpu, card = out["cpu"], out[str(dev)]
    torch.testing.assert_close(card[0], cpu[0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(card[1], cpu[1], atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(card[2], cpu[2], atol=1e-3, rtol=1e-4)


SM_TOL = {torch.float32: (1e-6, 0.0), torch.bfloat16: (2.0 ** -126, 2 ** -7),
          torch.float16: (2.0 ** -24, 2 ** -10)}


def _sm_inputs(dev, shape, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(shape, device=dev, generator=g) * 3).to(dtype)
    dy = torch.randn(shape, device=dev, generator=g).to(dtype)
    m = torch.rand(shape[0], 1, *shape[2:], device=dev, generator=g) < 0.3
    return x, dy, m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("sk", [1, 31, 1024, 16385, 100003])
@pytest.mark.parametrize("form", ["plain", "mask", "causal"])
def test_softmax_kernels_match_plain(dev, form, sk, dtype):
    """Each form of the forward and the backward against the plain
    versions at rows of 1 .. 100,003 (the warp, block and streaming
    forms), two runs bit-identical."""
    from apex_tpu_torch.ops.softmax_kernel import (
        softmax_bwd, softmax_bwd_plain, softmax_fwd, softmax_fwd_plain)
    shape = (2, 3, 5, sk) if sk < 16385 else (1, 2, 3, sk)
    x, dy, m = _sm_inputs(dev, shape, dtype, sk)
    kw = dict(scale=0.37, causal=form == "causal",
              mask=m if form == "mask" else None)
    before = dict(_build.launches)
    y = softmax_fwd(x, kw["mask"], scale=kw["scale"], causal=kw["causal"])
    y2 = softmax_fwd(x, kw["mask"], scale=kw["scale"], causal=kw["causal"])
    yp = softmax_fwd_plain(x, kw["mask"], scale=kw["scale"],
                           causal=kw["causal"])
    dx = softmax_bwd(y, dy, scale=0.37)
    dx2 = softmax_bwd(y, dy, scale=0.37)
    dxp = softmax_bwd_plain(y, dy, scale=0.37)
    torch.cuda.synchronize()
    name = "softmax_fwd_causal" if form == "causal" else "softmax_fwd"
    assert _build.launches[name] == before.get(name, 0) + 2
    atol, rtol = SM_TOL[dtype]
    torch.testing.assert_close(y.float(), yp.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(dx.float(), dxp.float(),
                               atol=max(atol, 1e-6), rtol=rtol)
    assert torch.equal(y, y2) and torch.equal(dx, dx2)
    assert y.dtype == dtype and dx.dtype == dtype


_SM_MASK_DTYPES = [torch.bool, torch.uint8, torch.int16, torch.int32,
                   torch.int64]


@pytest.mark.parametrize("sk", [1, 511, 512, 513, 1024])
@pytest.mark.parametrize("mshape", ["b11k", "b1qk", "1hqk"])
@pytest.mark.parametrize("mdtype", _SM_MASK_DTYPES)
def test_masked_softmax_over_widths_and_broadcasts(dev, mdtype, mshape, sk):
    """The masked forward at every mask width and at (b, 1, 1, sk), (b, 1,
    sq, sk) and (1, h, sq, sk) masks, rows of 1 .. 1024 (the short and
    long warp forms, ragged and 16-byte rows; the vector route where
    ``mask_route`` says so, the element route otherwise), in fp32 and
    bf16: within SM_TOL of the plain version, fully masked rows exactly
    0, two runs the same bits."""
    from apex_tpu_torch.ops.softmax_kernel import (mask_plan, mask_route,
                                                   softmax_fwd,
                                                   softmax_fwd_plain)
    b, h, sq = 3, 4, 6
    g = torch.Generator(device=dev).manual_seed(sk + 7 * len(mshape))
    dims = {"b11k": (b, 1, 1, sk), "b1qk": (b, 1, sq, sk),
            "1hqk": (1, h, sq, sk)}[mshape]
    m = (torch.rand(dims, device=dev, generator=g) < 0.3).to(mdtype)
    if mdtype != torch.bool:
        m = m * torch.randint(1, 100, dims, device=dev, generator=g).to(
            mdtype)   # nonzero entries other than 1 mask too
    m[-1, -1] = 1  # whole rows masked
    dead = (m != 0).expand(b, h, sq, sk).all(dim=-1)
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn(b, h, sq, sk, device=dev, generator=g) * 3).to(
            dtype)
        y = softmax_fwd(x, m, scale=0.37)
        y2 = softmax_fwd(x, m, scale=0.37)
        yp = softmax_fwd_plain(x, m, scale=0.37)
        torch.cuda.synchronize()
        atol, rtol = SM_TOL[dtype]
        torch.testing.assert_close(y.float(), yp.float(), atol=atol,
                                   rtol=rtol)
        assert torch.equal(y, y2)
        assert bool(dead.any()) and not y[dead].any()
        route = mask_route(mask_plan(m, x.shape), m.data_ptr(),
                           x.element_size(), sk)
        assert route == ("vector" if sk % (16 // x.element_size()) == 0
                         else "element")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_softmax_element_route_gives_the_vector_bits(dev, dtype):
    """The same mask values through a non-contiguous mask (sk stride 2), a
    misaligned base and rows that start off the access (element route)
    give the bits of a contiguous aligned copy (vector route), causal and
    not."""
    from apex_tpu_torch.ops.softmax_kernel import (mask_plan, mask_route,
                                                   softmax_fwd,
                                                   softmax_fwd_plain)
    b, h, sq, sk = 2, 3, 40, 512
    g = torch.Generator(device=dev).manual_seed(77)
    x = (torch.randn(b, h, sq, sk, device=dev, generator=g) * 3).to(dtype)
    base = torch.rand(b, 1, sq, sk, device=dev, generator=g) < 0.3
    wide = torch.zeros(b, 1, sq, 2 * sk, dtype=torch.bool, device=dev)
    wide[..., ::2] = base
    strided = wide[..., ::2]
    store = torch.zeros(base.numel() + 1, dtype=torch.bool, device=dev)
    shifted = store[1:].view(base.shape)
    shifted.copy_(base)
    rows = torch.zeros(b, 1, sq, sk + 2, dtype=torch.bool, device=dev)
    rows[..., :sk] = base
    offrows = rows[..., :sk]
    plan = lambda t: mask_plan(t, x.shape)  # noqa: E731
    assert mask_route(plan(base), base.data_ptr(), x.element_size(),
                      sk) == "vector"
    for t in (strided, shifted, offrows):
        assert torch.equal(t, base)
        assert mask_route(plan(t), t.data_ptr(), x.element_size(),
                          sk) == "element"
    for causal in (False, True):
        want = softmax_fwd(x, base, scale=0.5, causal=causal)
        for t in (strided, shifted, offrows):
            got = softmax_fwd(x, t, scale=0.5, causal=causal)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
        atol, rtol = SM_TOL[dtype]
        torch.testing.assert_close(
            want.float(), softmax_fwd_plain(x, base, scale=0.5,
                                            causal=causal).float(),
            atol=atol, rtol=rtol)


def test_softmax_on_cuda_takes_the_kernels_at_every_shape(dev, monkeypatch):
    """A (1, h, sq, sk) mask (JAX's route refuses it), a rank-3 one, rows
    of 32,768 (past JAX's 16,384 columns) and a non-contiguous x run the
    kernels through the public functions: the launches are counted and no
    plain version is called."""
    from apex_tpu_torch.ops import softmax_kernel as sk_mod
    from apex_tpu_torch.transformer import softmax as tsm

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on a CUDA tensor")

    ref = {}
    cases = []
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(2, 4, 64, 96, device=dev, generator=g)
    m1 = torch.rand(1, 4, 64, 96, device=dev, generator=g) < 0.3
    m3 = (torch.rand(4, 64, 96, device=dev, generator=g) < 0.3).to(torch.int64)
    xl = torch.randn(1, 2, 4, 32768, device=dev, generator=g)
    xt = torch.randn(2, 4, 96, 64, device=dev, generator=g).transpose(-1, -2)
    cases = [(x, m1), (x, m3), (xl, None), (xt, None)]
    for xi, mi in cases:
        ref[id(xi), id(mi)] = sk_mod.softmax_fwd_plain(xi, mi, scale=0.5)
    monkeypatch.setattr(sk_mod, "softmax_fwd_plain", refuse)
    monkeypatch.setattr(sk_mod, "softmax_bwd_plain", refuse)
    _build.reset_launches()
    for xi, mi in cases:
        xg = xi.clone().requires_grad_(True)
        y = tsm.generic_scaled_masked_softmax(xg, mi, 0.5)
        y.sum().backward()
        torch.testing.assert_close(y.detach(), ref[id(xi), id(mi)],
                                   atol=1e-6, rtol=0)
        assert xg.grad is not None
    torch.cuda.synchronize()
    assert _build.launches == {"softmax_fwd": 4, "softmax_bwd": 4}


# ------------------------------------------------ peer puts between ranks
# Rank processes share the one card through CUDA IPC (spawn_ranks): the
# peer-put kernels store into another process's arena. Exact: a copy.

# Elements, in fp32, bf16 and uint8: small and odd sizes, then one byte
# (one element) under, at and over a bulk stage (the register route below
# it; in fp32 one element under and over), under and over a grid of 132
# one-stage runs, and a few MB (many runs a block, a ragged tail).
_STAGE = STAGE_BYTES
PEER_SIZES = [1, 3, 1000, 4097, 65536 + 5,
              _STAGE - 1, _STAGE, _STAGE + 1, _STAGE // 4 - 1,
              _STAGE // 4 + 1, 132 * _STAGE - 1, 132 * _STAGE + 1,
              3_000_001]
# uint8 sources this many bytes into their storage (the landing slot is
# aligned: words of 1, 2, 4, 8 and 1 bytes), below and above a stage
PEER_OFFSETS = [1, 2, 4, 8, 15]
PEER_OFFSET_SIZES = [1000, 3 * _STAGE + 7, 132 * _STAGE + 1]


@pytest.mark.parametrize("world", [2, 4])
def test_peer_kernels_between_rank_processes(dev, world):
    """``peer_shift`` (shift 1, -1, 2, and of a source that is an offset
    view) and ``halo_exchange_rdma`` (halo 1 and 3, periodic or not, fresh
    and pool landing buffers threaded twice) in fp32, bf16 and uint8,
    and ``peer_shift`` of uint8 sources 1, 2, 4, 8 and 15 bytes into
    their storage, every result bit-equal to the neighbour's
    input made again from its seed; one ``peer_put`` per shift, one
    ``halo_put`` per exchange and a ``peer_wait`` for each landing."""
    import torch_rank_helpers as rh
    from apex_tpu_torch.parallel import spawn_ranks
    _build.build()
    dtypes = ["fp32", "bf16", "u8"]
    res = spawn_ranks(rh.card_peer_bits, world,
                      (PEER_SIZES, dtypes, PEER_OFFSETS, PEER_OFFSET_SIZES),
                      device="cuda", timeout_s=240)
    # shifts 1, -1, 2 at each size, and one of an offset (unaligned) view
    shifts = (3 * len(PEER_SIZES) + 1) * len(dtypes) \
        + len(PEER_OFFSETS) * len(PEER_OFFSET_SIZES)
    halos = 2 * 2 * 2 * 2 * len(dtypes)
    for checks, launches in res:
        assert checks == shifts + 2 * halos
        assert launches == {"peer_put": shifts, "halo_put": halos,
                            "peer_wait": shifts + 2 * halos}


@pytest.mark.parametrize("world", [2, 4])
def test_peer_shift_stress_back_to_back(dev, world):
    """64 ``peer_shift``s issued back to back without a synchronise, fresh
    seeded data each, through both landing slots in turn, on the bulk
    route (262,147 fp32: a ragged tail) and the register route (1,000),
    on one stream and alternating between two: every result bit-equal. A
    flag released before all the bulk stores it announces were done, or
    an ack released before the copy-out had read the slot (as on a stream
    the previous copy-out did not run on), shows here as stale bytes."""
    import torch_rank_helpers as rh
    from apex_tpu_torch.parallel import spawn_ranks
    _build.build()
    sizes = [262_147, 1000]
    res = spawn_ranks(rh.card_shift_stress, world, (sizes, 64),
                      device="cuda", timeout_s=240)
    assert res == [2 * 64 * len(sizes)] * world


# (source, destination) misalignments in bytes: both alike (the bulk
# route after a head), one side only, and pairs no head aligns to 16
COPY_MISALIGNMENTS = [(0, 0), (1, 1), (8, 8), (15, 15), (1, 0), (0, 1),
                      (2, 0), (4, 12), (8, 0), (15, 3)]


@pytest.mark.parametrize("src_mis,dst_mis", COPY_MISALIGNMENTS)
@pytest.mark.parametrize("nbytes", [1, 17, _STAGE - 1, _STAGE + 15,
                                    132 * _STAGE + 1, 3_000_017])
def test_copy_routes_at_any_alignment(dev, nbytes, src_mis, dst_mis):
    """The C entries themselves, in this process: ``apex_peer_put`` by
    ``copy_plan`` from ``src + src_mis`` to ``dst + dst_mis``, then
    ``apex_peer_wait`` (which first releases the flag it waits for, as a
    self-put's does) copying that on to ``out + src_mis``. Every byte
    arrives, and no byte beside the message changes: every route (bulk
    with a head and a tail, register words of 16 down to 1 byte) at its
    edges."""
    from apex_tpu_torch.ops import remote_copy as rc
    lib = _build.lib()
    g = torch.Generator(device=dev).manual_seed(nbytes + 16 * src_mis
                                                + dst_mis)
    pad = 64
    src = torch.randint(0, 256, (nbytes + pad,), generator=g, device=dev,
                        dtype=torch.uint8)
    dst = torch.full((nbytes + pad,), 0xA5, device=dev, dtype=torch.uint8)
    out = torch.full((nbytes + pad,), 0x5A, device=dev, dtype=torch.uint8)
    flags = torch.zeros(4, device=dev, dtype=torch.int64)
    fp = flags.data_ptr()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    s, d, o = (src.data_ptr() + src_mis, dst.data_ptr() + dst_mis,
               out.data_ptr() + src_mis)
    put = rc.copy_plan(nbytes, s, d, sms).as_c()
    wait = rc.copy_plan(nbytes, d, o, sms).as_c()
    stream = torch.cuda.current_stream().cuda_stream
    _build.check(lib.apex_peer_put(s, d, ctypes.addressof(put), fp, 0,
                                   int(5e9), stream), "apex_peer_put")
    _build.check(lib.apex_peer_wait(fp + 8, 1, fp + 16, 2, fp + 8, 1, d, o,
                                    ctypes.addressof(wait), int(5e9),
                                    stream), "apex_peer_wait")
    torch.cuda.synchronize()
    msg = src[src_mis:src_mis + nbytes]
    assert torch.equal(dst[dst_mis:dst_mis + nbytes], msg)
    assert torch.equal(out[src_mis:src_mis + nbytes], msg)
    assert bool((dst[:dst_mis] == 0xA5).all()
                and (dst[dst_mis + nbytes:] == 0xA5).all())
    assert bool((out[:src_mis] == 0x5A).all()
                and (out[src_mis + nbytes:] == 0x5A).all())
    assert flags.tolist() == [0, 1, 2, 0]


def test_cuda_tensors_never_take_plain_versions(dev):
    """With the plain versions (and gloo's point to point) patched to
    raise in every rank, the CUDA exchanges still pass: no fallback."""
    import torch_rank_helpers as rh
    from apex_tpu_torch.parallel import spawn_ranks
    _build.build()
    res = spawn_ranks(rh.card_no_plain_route, 2, ([7, 4097],),
                      device="cuda", timeout_s=240)
    assert all(checks > 0 for checks, _ in res)


def test_peer_wait_without_signal_traps_within_its_bound(dev):
    """A rank whose neighbour never puts: its bounded wait traps on the
    device and the next synchronise raises, within the bound plus the
    launch's slack, instead of hanging."""
    import torch_rank_helpers as rh
    from apex_tpu_torch.parallel import spawn_ranks
    _build.build()
    res = spawn_ranks(rh.card_missing_signal, 2, (1.0,), device="cuda",
                      timeout_s=120)
    raised, seconds, msg = res[0]
    assert raised, msg
    assert 1.0 <= seconds < 20.0, seconds


@pytest.mark.parametrize("world", [2, 4])
def test_ring_attention_rdma_on_the_card(dev, world):
    """Ring attention (contiguous causal and not, zigzag) over rank
    processes on the card, fp32, against the full-sequence flash forward
    and backward on the same card: o 1e-5, gradients 1e-4 relative L2."""
    import numpy as np
    import torch_rank_helpers as rh
    from apex_tpu_torch.parallel import spawn_ranks, zigzag_shard
    from apex_tpu_torch.ops.flash_attention import flash_attention
    _build.build()
    rng = np.random.default_rng(world)
    shape = (1, 2, 128 * world, 64)
    arrays = {n: rng.standard_normal(shape).astype(np.float32)
              for n in ("q", "k", "v", "do")}
    cases = [("c", "contig", True, "rdma"), ("n", "contig", False, "rdma"),
             ("z", "zigzag", True, "rdma")]
    res = spawn_ranks(rh.ring_cases, world, (arrays, cases), device="cuda",
                      timeout_s=240)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    for key, causal in (("c", True), ("n", False), ("z", True)):
        # concatenated shards; the zigzag ones stay in zigzag order
        got = [np.concatenate([r[key][i] for r in res], axis=2)
               for i in range(4)]
        assert all(r[key][4] == (2 * (world - 1), 4 * world - 2)
                   for r in res), key
        q, k, v = (torch.from_numpy(arrays[n]).to(dev).requires_grad_(True)
                   for n in ("q", "k", "v"))
        o = flash_attention(q, k, v, causal)
        o.backward(torch.from_numpy(arrays["do"]).to(dev))
        want = [t.detach().cpu().numpy() for t in (o, q.grad, k.grad,
                                                   v.grad)]
        if key == "z":
            want = [zigzag_shard(torch.from_numpy(w), world).numpy()
                    for w in want]
        assert rel(got[0], want[0]) <= 1e-5, key
        for g, w in zip(got[1:], want[1:]):
            assert rel(g, w) <= 1e-4, key


# the LayerNorm backward's register form at every width step (a lane's
# vectors, 1 .. 4 for bf16, 1 .. 8 for fp32), one vector past the step,
# and its 1024-column limit one vector under, at and over it (over: the
# shared-memory form)
def _ln_reg_widths(vec):
    steps = [32 * vec * v for v in range(1, 32 // vec + 1)]
    return sorted({vec, steps[0] + vec, *steps, 1024 - vec, 1024 + vec})


_LN_REG_CASES = [(dt, h) for dt, vec in ((torch.bfloat16, 8),
                                         (torch.float32, 4))
                 for h in _ln_reg_widths(vec)]


def _ln_bwd_check(dev, rows, hidden, dtype, rms=False, affine=True,
                  offset=0, seed=0, gamma_offset=0):
    """ln_bwd against its plain version on the same card inputs (dy and x
    ``offset`` elements into their storage, gamma ``gamma_offset``), with
    the LayerNorm tolerances, and a second run with the same bits;
    returns the form the geometry took."""
    from apex_tpu_torch.ops.tiling import ln_bwd_geometry
    g = torch.Generator(device=dev).manual_seed(seed + rows + hidden)
    n = rows * hidden

    def make(scale, shift):
        t = (torch.randn(n + offset, device=dev, generator=g) * scale
             + shift).to(dtype)
        return t[offset:].view(rows, hidden)

    x, dy = make(2, 0.5), make(1, 0)
    gamma = (torch.randn(hidden + gamma_offset, device=dev,
                         generator=g)[gamma_offset:] if affine else None)
    beta = (torch.randn(hidden, device=dev, generator=g)
            if affine and not rms else None)
    _, mean, invvar = ln_fwd_plain(x, gamma, beta, eps=1e-5, rms=rms)
    args = (dy, x, gamma, beta, None if rms else mean, invvar)
    got = ln_bwd(*args, rms=rms)
    want = ln_bwd_plain(*args, rms=rms)
    again = ln_bwd(*args, rms=rms)
    torch.cuda.synchronize()
    rtol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=1e-5,
                               rtol=rtol)
    for a, b in zip(got[1:], want[1:]):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-4)
    assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))
    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    return ln_bwd_geometry(rows, hidden, name,
                           aligned=all(t.data_ptr() % 16 == 0
                                       for t in (dy, x, gamma)
                                       if t is not None)).form


@pytest.mark.parametrize("dtype,hidden", _LN_REG_CASES)
def test_ln_bwd_register_form_at_each_width_step(dev, dtype, hidden):
    """The register form at each count of vectors a lane holds, a ragged
    last vector, and its limit one vector under, at and over (the
    shared-memory form): dx, dgamma and dbeta against the plain version,
    two runs identical."""
    form = _ln_bwd_check(dev, 300, hidden, dtype)
    assert form == ("reg" if hidden <= 1024 else "smem")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 2, 4097])
def test_ln_bwd_register_form_row_counts(dev, rows, dtype):
    """1, 2 and 4097 rows at GPT-2's width: warps without rows, and a
    grid that deals a row more to some warps."""
    assert _ln_bwd_check(dev, rows, 768, dtype) == "reg"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rms,affine", [(True, True), (True, False),
                                        (False, False)])
@pytest.mark.parametrize("hidden", [768, 1024])
def test_ln_bwd_register_form_rms_and_no_gamma(dev, hidden, rms, affine,
                                               dtype):
    assert _ln_bwd_check(dev, 1000, hidden, dtype, rms=rms,
                         affine=affine) == "reg"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_bwd_odd_offset_view_takes_the_scalar_form(dev, dtype):
    """Rows that start one element past a 16-byte boundary: the geometry
    sends them to the shared-memory form, which gives the plain version's
    results too."""
    assert _ln_bwd_check(dev, 512, 768, dtype, offset=1) == "smem"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rms", [False, True])
def test_ln_bwd_misaligned_gamma_takes_the_scalar_form(dev, rms, dtype):
    """A gamma that is a view one float past a 16-byte boundary (a slice
    of a flat parameter buffer) beside aligned dy and x: the register
    form reads gamma as vectors, so the geometry sends the rows to the
    shared-memory form, which gives the plain version's results."""
    assert _ln_bwd_check(dev, 512, 768, dtype, rms=rms,
                         gamma_offset=1) == "smem"


def test_ln_bwd_register_form_refuses_a_misaligned_gamma(dev):
    """The C entry refuses the register form for a gamma that is not
    16-byte aligned (cudaErrorInvalidValue, nothing launched)."""
    from apex_tpu_torch.ops.tiling import ln_bwd_geometry
    rows, hidden = 64, 768
    f32 = dict(dtype=torch.float32, device=dev)
    x = torch.randn(rows, hidden, **f32).to(torch.bfloat16)
    dy = torch.randn(rows, hidden, **f32).to(torch.bfloat16)
    gamma = torch.randn(hidden + 1, **f32)[1:]
    mean = torch.zeros(rows, 1, **f32)
    invvar = torch.ones(rows, 1, **f32)
    dx = torch.empty_like(dy)
    dgamma = torch.empty(hidden, **f32)
    # the geometry of these rows were gamma aligned
    geo = ln_bwd_geometry(rows, hidden, "bfloat16")
    assert geo.form == "reg"
    part = torch.empty(geo.blocks, hidden, **f32)
    lib = _build.lib()
    err = lib.apex_ln_bwd(
        dy.data_ptr(), x.data_ptr(), gamma.data_ptr(), mean.data_ptr(),
        invvar.data_ptr(), dx.data_ptr(), part.data_ptr(), None,
        dgamma.data_ptr(), None, rows, hidden, geo.form_id, geo.vectors,
        geo.warps, geo.blocks, 0, 1, torch.cuda.current_stream().cuda_stream)
    assert err == 1  # cudaErrorInvalidValue


# one-pass GroupNorm shapes (n, h, w, c): the UNet's six distinct one-pass
# shapes (its nine a step), hw = 1 and 16 x 16 x 64 (slabs the staged
# route takes), hw = 5625 (75 x 75), cpg odd (c = 96 in 32 groups), an odd
# batch
_GN_ONE_PASS_SHAPES = [(8, 64, 64, 320), (8, 32, 32, 320), (8, 32, 32, 640),
                       (8, 16, 16, 640), (8, 16, 16, 1280), (8, 8, 8, 1280),
                       (4, 1, 1, 320), (2, 16, 16, 64), (2, 75, 75, 320),
                       (2, 64, 64, 96), (3, 32, 32, 640)]


def _gn_one_pass_check(dev, shape, dtype, act="silu", affine="wb",
                       offset=0, ill=False):
    """gn_one_pass on the card against its plain version on the same
    inputs (x ``offset`` elements into its storage), the GroupNorm
    tolerances, two runs identical; returns the route the geometry took
    and y."""
    from apex_tpu_torch.ops.group_norm_kernel import gn_one_pass
    from apex_tpu_torch.ops.tiling import gn_one_pass_geometry
    n, h, w, c = shape
    x, wt, bt = _gn_inputs(dev, n, h, w, c, torch.float32, affine,
                           sum(shape) + offset)
    if ill:
        x[0, :, :, :c // 32] = 1000 + 0.01 * torch.randn(
            h, w, c // 32, device=dev,
            generator=torch.Generator(device=dev).manual_seed(3))
    buf = torch.empty(x.numel() + offset, dtype=dtype, device=dev)
    x3 = buf[offset:].view(n, h * w, c)
    x3.copy_(x.reshape(n, h * w, c))
    got = gn_one_pass(x3, 32, wt, bt, eps=1e-5, act=act)
    again = gn_one_pass(x3, 32, wt, bt, eps=1e-5, act=act)
    want = gn_one_pass_plain(x3, 32, wt, bt, eps=1e-5, act=act)
    torch.cuda.synchronize()
    _gn_close(got[0], want[0], dtype)
    torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=2 ** -23)
    torch.testing.assert_close(got[2], want[2], atol=0, rtol=1e-4)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    geo = gn_one_pass_geometry(n, h * w, c, 32, name,
                               aligned=x3.data_ptr() % 16 == 0)
    return geo.route, got[0], x3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _GN_ONE_PASS_SHAPES)
def test_gn_one_pass_cluster_route_matches_plain(dev, shape, dtype):
    """The one-pass kernel at the UNet's shapes, hw = 1, hw = 5625 and an
    odd cpg against the plain version, two runs identical: the cluster
    route, the staged one for slabs of at most GN_STAGED_MAX_SLAB."""
    from apex_tpu_torch.ops.tiling import GN_STAGED_MAX_SLAB
    n, h, w, c = shape
    route, _, _ = _gn_one_pass_check(dev, shape, dtype)
    assert route == ("staged" if h * w * c // 32 <= GN_STAGED_MAX_SLAB
                     else "cluster")


@pytest.mark.parametrize("act,affine", [("", None), ("", "w"),
                                        ("silu", "b")])
def test_gn_one_pass_cluster_route_forms(dev, act, affine):
    """The cluster route without SiLU, without affine, with gamma or beta
    alone."""
    route, _, _ = _gn_one_pass_check(dev, (2, 32, 32, 320), torch.bfloat16,
                                     act=act, affine=affine)
    assert route == "cluster"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_one_pass_misaligned_view_takes_the_staged_route(dev, dtype):
    """x one element past a 16-byte boundary: the staged route, the plain
    version's results."""
    route, _, _ = _gn_one_pass_check(dev, (2, 16, 16, 320), dtype, offset=1)
    assert route == "staged"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_one_pass_cluster_ill_conditioned_group(dev, dtype):
    """A group of mean 1000 and std 0.01 through the cluster route (no
    affine, no SiLU): y finite and, in fp32, within 1e-4 of float64; the
    bf16 input is held against float64 of its own (rounded) values, to
    one bf16 ulp of the output."""
    route, y, x3 = _gn_one_pass_check(dev, (2, 16, 16, 320), dtype, act="",
                                      affine=None, ill=True)
    assert route == "cluster"
    x64 = x3.double().reshape(2, 256, 32, 10)
    m = x64.mean(dim=(1, 3), keepdim=True)
    v = ((x64 - m) ** 2).mean(dim=(1, 3), keepdim=True)
    y64 = ((x64 - m) / torch.sqrt(v + 1e-5)).reshape(y.shape)
    assert torch.isfinite(y).all()
    err = (y.double() - y64).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4
    else:
        assert bool((err <= 1e-4 + 2 ** -7 * y64.abs()).all())


def _gn_two_pass_check(dev, shape, dtype, act="silu", affine="wb",
                       offset=0, hw_block=None, groups=32, ill=False):
    """gn_stats and gn_apply on the card against their plain versions on
    the same inputs (x ``offset`` elements into its storage, tiles of
    ``hw_block`` pixels or gn_hw_block's default): psum / psq to the
    partial sums' tolerance, the moments to the GroupNorm ones, y (apply
    on the plain moments) to the GroupNorm tolerances; two runs of each
    give the same bits, and the public forward launches the pair once
    each. Returns the route the geometry took, y of the kernels' own
    moments, x3 and the moments."""
    from apex_tpu_torch.ops.tiling import gn_two_pass_geometry
    n, h, w, c = shape
    hw = h * w
    x, wt, bt = _gn_inputs(dev, n, h, w, c, torch.float32, affine,
                           sum(shape) + offset + groups)
    if ill:   # one group: mean 1000, std 0.01
        x[0, :, :, :c // groups] = 1000 + 0.01 * torch.randn(
            h, w, c // groups, device=dev,
            generator=torch.Generator(device=dev).manual_seed(3))
    buf = torch.empty(x.numel() + offset, dtype=dtype, device=dev)
    x3 = buf[offset:].view(n, hw, c)
    x3.copy_(x.reshape(n, hw, c))
    blk = gn_hw_block(hw, c, hw_block)
    cnt = hw * (c // groups)
    shift = gn_shift(x3, groups)
    ps, pq = gn_stats(x3, shift, blk)
    again_s = gn_stats(x3, shift, blk)
    ps_p, pq_p = gn_stats_plain(x3, shift, blk)
    md, rstd = gn_moments(ps, pq, cnt, 1e-5)
    md_p, rstd_p = gn_moments(ps_p, pq_p, cnt, 1e-5)
    y = gn_apply(x3, shift, md_p, rstd_p, wt, bt, blk, act=act)
    again_a = gn_apply(x3, shift, md_p, rstd_p, wt, bt, blk, act=act)
    y_p = gn_apply_plain(x3, shift, md_p, rstd_p, wt, bt, act=act)
    y_own = gn_apply(x3, shift, md, rstd, wt, bt, blk, act=act)
    torch.cuda.synchronize()
    assert ps.shape == (n, hw // blk, groups)
    torch.testing.assert_close(ps, ps_p, atol=1e-3, rtol=1e-5)
    torch.testing.assert_close(pq, pq_p, atol=1e-3, rtol=1e-5)
    torch.testing.assert_close(md, md_p, atol=1e-5, rtol=2 ** -23)
    torch.testing.assert_close(rstd, rstd_p, atol=0, rtol=1e-4)
    _gn_close(y, y_p, dtype)
    assert torch.equal(ps, again_s[0]) and torch.equal(pq, again_s[1])
    assert torch.equal(y, again_a)
    _build.reset_launches()
    x4 = x3.view(n, h, w, c)
    group_norm_nhwc_fwd(x4, groups, wt, bt, 1e-5, act, "two_pass",
                        hw_block)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"gn_stats": 1, "gn_apply": 1}
    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    geo = gn_two_pass_geometry(n, hw, c, groups, name,
                               aligned=x3.data_ptr() % 16 == 0, tile=blk)
    return geo.route, y_own, x3, (md, rstd)


# (n, h, w, c, hw_block): the vector route at 960 (the UNet's two-pass
# width), 128 (the VAE's) and 64 channels, cpg = 3 (vectors spanning
# groups), hw = 1, hw = 5625 (25-pixel tiles), explicit 8-pixel tiles (one
# slot a stats block; two a stats block)
_GN_TWO_PASS_SHAPES = [(2, 64, 64, 960, None), (1, 64, 64, 128, None),
                       (2, 32, 32, 64, None), (2, 16, 16, 96, None),
                       (4, 1, 1, 960, None), (2, 75, 75, 960, None),
                       (2, 16, 16, 64, 8), (8, 64, 64, 64, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _GN_TWO_PASS_SHAPES)
def test_gn_two_pass_vector_route_matches_plain(dev, shape, dtype):
    """The two-pass pair on the vector route against the plain versions,
    two runs identical."""
    route, _, _, _ = _gn_two_pass_check(dev, shape[:4], dtype,
                                        hw_block=shape[4])
    assert route == "vector"


@pytest.mark.parametrize("act,affine", [("", None), ("", "w"),
                                        ("silu", "b"), ("silu", None)])
def test_gn_two_pass_vector_route_forms(dev, act, affine):
    """The vector route without SiLU, without affine, with gamma or beta
    alone."""
    route, _, _, _ = _gn_two_pass_check(dev, (2, 32, 32, 960),
                                        torch.bfloat16, act=act,
                                        affine=affine)
    assert route == "vector"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_two_pass_scalar_routes(dev, dtype):
    """x one element past a 16-byte boundary, and (bf16) 36 channels in 4
    groups (72 bytes a pixel), take the scalar kernels, held to the plain
    versions as the vector route is."""
    route, _, _, _ = _gn_two_pass_check(dev, (2, 16, 16, 960), dtype,
                                        offset=1)
    assert route == "scalar"
    route, _, _, _ = _gn_two_pass_check(dev, (2, 16, 16, 36), dtype,
                                        groups=4)
    assert route == ("scalar" if dtype == torch.bfloat16 else "vector")


def test_gn_two_pass_vector_route_ill_conditioned_group(dev):
    """A group of mean 1000 and std 0.01 (fp32, no affine, no SiLU) through
    the vector route with the kernels' own moments: y finite and within
    1e-4 of float64."""
    route, y, x3, _ = _gn_two_pass_check(dev, (2, 32, 32, 960),
                                         torch.float32, act="",
                                         affine=None, ill=True)
    assert route == "vector"
    x64 = x3.double().reshape(2, 1024, 32, 30)
    m = x64.mean(dim=(1, 3), keepdim=True)
    v = ((x64 - m) ** 2).mean(dim=(1, 3), keepdim=True)
    y64 = ((x64 - m) / torch.sqrt(v + 1e-5)).reshape(y.shape)
    assert torch.isfinite(y).all()
    assert (y.double() - y64).abs().max().item() <= 1e-4


def test_gn_two_pass_refuses_a_bad_vector_geometry(dev):
    """The C entries check the geometry they are given: a vector launch
    for misaligned x returns cudaErrorInvalidValue, launching nothing."""
    from apex_tpu_torch.ops.tiling import gn_two_pass_geometry
    buf = torch.zeros(2 * 64 * 960 + 1, dtype=torch.bfloat16, device=dev)
    x3 = buf[1:].view(2, 64, 960)
    geo = gn_two_pass_geometry(2, 64, 960, 32, "bfloat16")
    assert geo.route == "vector"
    shift = torch.zeros(2, 32, device=dev)
    psum = torch.empty(2, 64 // geo.tile, 32, device=dev)
    err = _build.lib().apex_gn_stats(
        x3.data_ptr(), shift.data_ptr(), psum.data_ptr(), psum.data_ptr(),
        2, 64, 960, 32, geo.tile, geo.route_id, geo.rows, geo.threads,
        geo.stats_tiles, 1, torch.cuda.current_stream().cuda_stream)
    assert err == 1  # cudaErrorInvalidValue


@pytest.mark.parametrize("rows", [256, 4096])
def test_matmul_f32_backward_rounds_each_product_once(dev, rows):
    """``matmul_f32``'s bf16 backward at the LM head's shape (2560 wide,
    vocabulary 50,257): dx sums 50,257 terms and dw ``rows``; each is the
    float64 product within one bf16 step (2^-7 of the value), as one fp32
    sum rounded once gives, and not several bf16 roundings of partial
    sums (atol 1e-4 of the largest entry: the fp32 sum's own error where
    terms cancel)."""
    from apex_tpu_torch.transformer.fused_dense import matmul_f32
    g = torch.Generator(device=dev).manual_seed(rows)
    x = torch.randn(rows, 2560, device=dev, generator=g).to(torch.bfloat16)
    w = (torch.randn(50257, 2560, device=dev, generator=g) * 0.02).to(
        torch.bfloat16)
    x.requires_grad_()
    w.requires_grad_()
    gy = torch.randn(rows, 50257, device=dev, generator=g) / rows
    matmul_f32(x, w).backward(gy)
    gb = gy.to(torch.bfloat16).double()
    for name, got, want in (("dx", x.grad, gb @ w.detach().double()),
                            ("dw", w.grad, gb.t() @ x.detach().double())):
        torch.testing.assert_close(
            got.double(), want, rtol=2 ** -7,
            atol=1e-4 * want.abs().max().item(),
            msg=lambda m, n=name: f"{n}: {m}")
