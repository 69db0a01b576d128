"""Port parity: fused RoPE (apex_tpu_torch vs apex_tpu.transformer.rope).

The four variants, value and gradient (``jax.vjp`` against the port's
``autograd.Function``), on the same numpy inputs: fp32 within 1e-6
(cos / sin of the same fp32 angles, one product and one sum each), bf16
within one bf16 ulp (2^-7 relative, plus 1e-6). Partial rotary (the
trailing channels pass through), ``position_offset`` as an int and as a
0-d tensor, packed ``thd`` with three sequences, 2-D at 4 x 6, and the
backward as the inverse rotation.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.transformer import rope as jrope
from apex_tpu_torch.transformer import rope as trope

DT = {"fp32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _arr(shape, seed, dt="fp32"):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(DT[dt][1])
    return t, jnp.asarray(t.float().numpy()).astype(DT[dt][0])


def _freqs(s, d2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 6, (s, d2))).astype(np.float32)


def _close(got, want, dt):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    rtol = 0.0 if dt == "fp32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-6,
                               rtol=rtol)


def _both(fn_t, fn_j, t, tj, dy, dyj):
    tt = t.clone().requires_grad_(True)
    y = fn_t(tt)
    y.backward(dy)
    yj, vjp = jax.vjp(fn_j, tj)
    return (y.detach(), tt.grad), (yj, vjp(dyj)[0])


CASES = [(dt, d2, off) for dt in ("fp32", "bf16") for d2 in (16, 10)
         for off in (0, 3, "tensor")]


@functools.lru_cache(maxsize=None)
def _jax_rope(d2, off):
    def f(t, freqs, o):
        kw = {} if off == 0 else {"position_offset": o}
        return jrope.fused_rope(t, freqs, **kw)
    return jax.jit(f)


@pytest.mark.parametrize("dt,d2,off", CASES)
def test_fused_rope_sbhd(dt, d2, off):
    """t (s, b, h, d) = (6, 2, 3, 16); freqs (12, d2) (partial rotary at
    d2 = 10); offset 0, 3, or a 0-d tensor 4."""
    t, tj = _arr((6, 2, 3, 16), 1, dt)
    dy, dyj = _arr((6, 2, 3, 16), 2, dt)
    fr = _freqs(12, d2)
    o = 4 if off == "tensor" else off
    ot = torch.tensor(o) if off == "tensor" else o
    kw = {} if off == 0 else {"position_offset": ot}
    jf = _jax_rope(d2, off)
    (y, g), (yj, gj) = _both(
        lambda a: trope.fused_rope(a, torch.from_numpy(fr), **kw),
        lambda a: jf(a, jnp.asarray(fr), jnp.int32(o)), t, tj, dy, dyj)
    assert y.dtype == t.dtype
    _close(y, yj, dt)
    _close(g, gj, dt)
    if d2 < 16:   # the trailing channels pass through, both ways
        assert torch.equal(y[..., d2:], t[..., d2:])
        assert torch.equal(g[..., d2:], dy[..., d2:])


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("table_rank", [2, 4])
def test_fused_rope_cached(dt, table_rank):
    t, tj = _arr((5, 2, 2, 8), 3, dt)
    dy, dyj = _arr((5, 2, 2, 8), 4, dt)
    f = _freqs(9, 8, 5)
    cos, sin = np.cos(f), np.sin(f)
    if table_rank == 4:
        cos, sin = cos[:, None, None, :], sin[:, None, None, :]
    (y, g), (yj, gj) = _both(
        lambda a: trope.fused_rope_cached(
            a, torch.from_numpy(cos), torch.from_numpy(sin),
            position_offset=2),
        jax.jit(lambda a: jrope.fused_rope_cached(
            a, jnp.asarray(cos), jnp.asarray(sin), position_offset=2)),
        t, tj, dy, dyj)
    _close(y, yj, dt)
    _close(g, gj, dt)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_fused_rope_thd_three_sequences(dt):
    """Packed (total 11, h 2, d 8), sequences of 4, 5 and 2 tokens; each
    token rotates by its position within its sequence."""
    t, tj = _arr((11, 2, 8), 6, dt)
    dy, dyj = _arr((11, 2, 8), 7, dt)
    cu = np.array([0, 4, 9, 11], np.int32)
    fr = _freqs(8, 6, 8)
    (y, g), (yj, gj) = _both(
        lambda a: trope.fused_rope_thd(a, torch.from_numpy(cu),
                                       torch.from_numpy(fr)),
        jax.jit(lambda a: jrope.fused_rope_thd(a, jnp.asarray(cu),
                                               jnp.asarray(fr))),
        t, tj, dy, dyj)
    _close(y, yj, dt)
    _close(g, gj, dt)
    # token 4 starts the second sequence: rotated like token 0
    y0 = trope.fused_rope(t[None, 4:5], torch.from_numpy(fr)[:1])
    torch.testing.assert_close(y[4], y0[0, 0])


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_fused_rope_2d(dt):
    """t (b 2, 4 x 6, h 2, d 12): 4 channels by the row frequency, 4 by
    the column frequency, 4 through."""
    t, tj = _arr((2, 24, 2, 12), 9, dt)
    dy, dyj = _arr((2, 24, 2, 12), 10, dt)
    fh, fw = _freqs(4, 4, 11), _freqs(6, 4, 12)
    (y, g), (yj, gj) = _both(
        lambda a: trope.fused_rope_2d(a, 4, 6, torch.from_numpy(fh),
                                      torch.from_numpy(fw)),
        jax.jit(lambda a: jrope.fused_rope_2d(a, 4, 6, jnp.asarray(fh),
                                              jnp.asarray(fw))),
        t, tj, dy, dyj)
    _close(y, yj, dt)
    _close(g, gj, dt)
    with pytest.raises(ValueError, match="img_h"):
        trope.fused_rope_2d(t, 5, 6, torch.from_numpy(fh),
                            torch.from_numpy(fw))


def test_backward_is_the_inverse_rotation():
    """The backward rotates the cotangent by -f; rotating it back by f
    recovers the cotangent. With the frequencies repeated over both halves
    (the rotate-half convention, as the modules build them) the rotation
    is orthogonal and this is autograd through the products."""
    t, _ = _arr((7, 1, 2, 16), 13)
    dy, _ = _arr((7, 1, 2, 16), 14)
    half = torch.from_numpy(_freqs(7, 8, 15))
    fr = torch.cat([half, half], dim=-1)
    tt = t.clone().requires_grad_(True)
    trope.fused_rope(tt, fr).backward(dy)
    cos, sin = torch.cos(fr)[:, None, None], torch.sin(fr)[:, None, None]
    torch.testing.assert_close(tt.grad,
                               trope._apply_rope(dy, cos, -sin))
    torch.testing.assert_close(trope._apply_rope(tt.grad, cos, sin), dy,
                               atol=1e-6, rtol=1e-6)
    t2 = t.clone().requires_grad_(True)
    (t2 * cos + trope._rot_half(t2) * sin).backward(dy)
    torch.testing.assert_close(tt.grad, t2.grad, atol=1e-6, rtol=1e-6)


def test_tensor_offset_gathers_without_a_host_read():
    """A 0-d tensor offset selects the same rows as the int (clamped into
    the table as ``dynamic_slice`` clamps), through a gather."""
    t, _ = _arr((3, 1, 1, 8), 16)
    fr = torch.from_numpy(_freqs(10, 8, 17))
    for o in (0, 5, 9):
        torch.testing.assert_close(
            trope.fused_rope(t, fr, position_offset=torch.tensor(o)),
            trope.fused_rope(t, fr, position_offset=o), atol=0, rtol=0)
    torch.testing.assert_close(
        trope.fused_rope(t, fr, position_offset=9),
        trope.fused_rope(t, fr, position_offset=7), atol=0, rtol=0)
