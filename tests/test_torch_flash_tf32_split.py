"""The split-TF32 arithmetic of the fp32 flash forward at head widths 128
and 256 (``apex_tpu_torch/csrc/flash_fwd_tf32.cu``), emulated on the CPU.

The kernel runs only on the card. What it computes is held here through a
plain-torch emulation of its arithmetic, for the tests only:

- TF32 rounding as ``cvt.rna.tf32.f32`` does it (the nearest value with a
  10-bit mantissa, ties away from zero), by integer operations on the
  fp32 bits; the split of x into big = rna(x) and small = x - big; a
  tensor core reading a TF32 operand's top 19 bits;
- an m16n8k8 product step: 8 exact products of TF32 operands summed with
  the accumulator and rounded toward zero to fp32 (the tensor cores'
  truncation, the reason the kernel gives each 64 columns of the big
  products, and each key tile of p.V, a fresh accumulator);
- the score product as the kernel orders it: each step's 8 columns in
  ``Tf32FwdGeometry.depth_columns`` order, the small products into their
  own accumulator, the big ones of each ``kChunk`` columns into a fresh
  one added to the score in fp32;
- the online softmax over each warp's part of the kernel's key tiles and
  p.V as three split products a step, the keys of each group of 8 in
  ``key_order``, a tile's product in a fresh accumulator merged into o as
  ``fma(o, alpha, acc)``; at d = 256 the two key parts of a row group
  merged at the end as the kernel merges them.

Checked: (a) big + small == x exactly and big has no bits below TF32's
mantissa; (b) ties round away from zero, and +-0, +-inf and NaN pass
through; (c) the emulated forward at d = 128 and 256 (b = 1, h = 2, s 33
and 64, causal and full, a bias in one case at each width) against the
JAX package's ``flash_attention_fwd`` in interpret mode within FA_TOL
fp32 (2e-5 on o) and LSE_TOL (2e-5); (d) the same inputs through one TF32
product a step (no split) miss FA_TOL, so the tolerance tells the split
from a single TF32 product. Eight JAX calls, each compiled once.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.pallas.flash_attention import (
    flash_attention_fwd as jax_flash_attention_fwd)
from apex_tpu_torch.ops.tiling import fa_tf32_fwd_geometry

FA_TOL, LSE_TOL = 2e-5, 2e-5
NEG_INF, MASK_EDGE = -1e30, -0.5e30
# the kernel's columns of a fresh big-product accumulator
CHUNK = 64
# (d, s, causal, bias): each width at both lengths, causal and full, a
# learned (1, h, s, s) bias at s = 33
CASES = [(d, s, causal, s == 33 and not causal) for d in (128, 256)
         for s, causal in ((33, True), (64, False), (64, True), (33, False))]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: x rounded to a 10-bit mantissa, ties away from
    zero (add half of the dropped part's weight to the magnitude bits,
    then clear the 13 low bits); inf stays inf, NaN stays NaN."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    out = (bits + 0x1000) & 0xFFFFE000
    out = torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)
    return torch.where(torch.isnan(x), x, out.view(torch.float32))


def tf32_read(x: torch.Tensor) -> torch.Tensor:
    """The value a tensor core reads from a TF32 operand register: its top
    19 bits (the low 13 ignored)."""
    bits = x.contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32_rna(x)
    return big, x - big


def _round_to_zero(x64: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero."""
    f = x64.float()
    away = f.double().abs() > x64.abs()
    return torch.where(away, torch.nextafter(f, torch.zeros_like(f)), f)


def mma(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """One m16n8k8 step over whole tiles: acc (.., m, n) + a (.., m, 8) @
    b (.., 8, n), the TF32 operands' products exact, the sum rounded
    toward zero to fp32."""
    prod = torch.matmul(tf32_read(a).double(), tf32_read(b).double())
    return _round_to_zero(acc.double() + prod)


def split_scores(q, k, g, single=False):
    """q . k^T as the kernel sums it (see the module docstring); with
    ``single`` one TF32 product a step of rna(q) . rna(k), no split."""
    d = q.shape[-1]
    s = torch.zeros(q.shape[:-1] + (k.shape[-2],))
    sl = torch.zeros_like(s)
    kt = k.transpose(-1, -2)
    for c0 in range(0, d, CHUNK):
        part = torch.zeros_like(s)
        for c in range(c0, c0 + CHUNK, 16):
            for step in (0, 1):
                cols = [c + x for x in g.depth_columns(step)]
                qa, kb = q[..., cols], kt[..., cols, :]
                if single:
                    s = mma(s, tf32_rna(qa), tf32_rna(kb))
                    continue
                (ab, as_), (bb, bs) = split(qa), split(kb)
                sl = mma(sl, as_, bb)
                sl = mma(sl, ab, bs)
                part = mma(part, ab, bb)
        if not single:
            s = s + part
    return s if single else s + sl


def split_out(p, v, g, single=False):
    """p (.., m, tile keys) . v (.., tile keys, d) in a fresh accumulator,
    each 8 keys one step in ``key_order``, three split products a step
    (one TF32 product with ``single``)."""
    acc = torch.zeros(p.shape[:-1] + (v.shape[-1],))
    for j in range(0, p.shape[-1], 8):
        keys = [j + x for x in g.key_order]
        pa, vb = p[..., keys], v[..., keys, :]
        if single:
            acc = mma(acc, tf32_rna(pa), tf32_rna(vb))
            continue
        (ab, as_), (bb, bs) = split(pa), split(vb)
        acc = mma(acc, as_, bb)
        acc = mma(acc, ab, bs)
        acc = mma(acc, ab, bb)
    return acc


def emulated_fwd(q, k, v, *, scale, causal, bias=None, single=False):
    """The kernel's forward (fp32 torch on the CPU): each key part (half
    of every tile at d = 256, ``key_split``) streamed with its own online
    softmax, the parts merged as the kernel merges them; ``(o, lse)``."""
    d, sq, sk = q.shape[-1], q.shape[-2], k.shape[-2]
    g = fa_tf32_fwd_geometry(d)
    bn, wk = g.tile_rows, g.warp_keys
    pad = -sk % bn
    kp = torch.nn.functional.pad(k, (0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, pad))
    s_all = split_scores(q, kp, g, single)
    rows = torch.arange(sq)[:, None]
    parts = []
    for h in range(g.key_split):
        m = torch.full(q.shape[:-1] + (1,), NEG_INF)
        l = torch.zeros_like(m)
        o = torch.zeros_like(q)
        for k0 in range(h * wk, sk + pad, bn):
            keys = torch.arange(k0, k0 + wk)[None, :]
            a = s_all[..., k0:k0 + wk] * scale
            if bias is not None:
                a = a + torch.nn.functional.pad(
                    bias, (0, pad))[..., k0:k0 + wk]
            dead = (keys >= sk) | ((keys > rows) & causal)
            a = a.masked_fill(dead, NEG_INF)
            m_new = torch.maximum(m, a.amax(-1, keepdim=True))
            m_safe = torch.where(m_new <= MASK_EDGE, 0.0, m_new)
            alpha = torch.exp(torch.where(m <= MASK_EDGE, NEG_INF, m)
                              - m_safe)
            p = torch.exp(a - m_safe)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = split_out(p, vp[..., k0:k0 + wk, :], g, single)
            o = (o.double() * alpha.double() + acc.double()).float()
            m = m_new
        parts.append((m, l, o))
    m, l, o = parts[0]
    for m1, l1, o1 in parts[1:]:
        m_new = torch.maximum(m, m1)
        m_safe = torch.where(m_new <= MASK_EDGE, 0.0, m_new)
        a0, a1 = (torch.exp(torch.where(x <= MASK_EDGE, NEG_INF, x) - m_safe)
                  for x in (m, m1))
        l = l * a0 + l1 * a1
        o = (o.double() * a0.double() + (o1 * a1).double()).float()
        m = m_new
    safe = torch.where(l > 0, l, 1.0)
    lse = torch.where(m <= MASK_EDGE, NEG_INF, m + torch.log(safe))
    return o / safe, lse.squeeze(-1)


def _inputs(d, s, with_bias):
    rng = np.random.default_rng(7 * d + s)
    q, k, v = (rng.standard_normal((1, 2, s, d)).astype(np.float32)
               for _ in range(3))
    bias = (rng.standard_normal((1, 2, s, s)).astype(np.float32)
            if with_bias else None)
    return q, k, v, bias


@functools.lru_cache(maxsize=None)
def _jax_case(d, s, causal, with_bias):
    """The JAX kernel's (o, lse) of one case, in interpret mode."""
    q, k, v, bias = _inputs(d, s, with_bias)
    o, lse = jax_flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        bias=None if bias is None else jnp.asarray(bias),
        scale=1.0 / math.sqrt(d), causal=causal, block_q=64, block_k=128,
        interpret=True)
    return np.asarray(o), np.asarray(lse)


def _emulated(d, s, causal, with_bias, single=False):
    q, k, v, bias = (None if a is None else torch.from_numpy(a)
                     for a in _inputs(d, s, with_bias))
    return emulated_fwd(q, k, v, scale=1.0 / math.sqrt(d), causal=causal,
                        bias=bias, single=single)


def test_split_is_exact_and_big_is_tf32():
    """(a) big + small is x bit for bit, big has no bits below TF32's
    10-bit mantissa, |small| is at most half a TF32 unit of x, over values
    from subnormal to near the fp32 maximum."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(20000) * np.exp2(rng.integers(-140, 120,
                                                           20000))) \
        .astype(np.float32)
    x = torch.from_numpy(x)
    big, small = split(x)
    assert torch.equal(big + small, x)
    assert not (big.view(torch.int32) & 0x1FFF).any()
    finite = big.isfinite() & (x.abs() > 1e-30)
    assert (small[finite].abs() <= x[finite].abs() * 2.0 ** -11).all()
    # a tensor core reading big reads it whole
    assert torch.equal(tf32_read(big), big)


def test_rounding_ties_zeros_infinities_and_nan():
    """(b) cvt.rna's cases: a tie (the dropped 13 bits exactly 0x1000)
    rounds away from zero in both signs, below a tie rounds down, +-0 keep
    their sign, +-inf stay, NaN stays NaN; the largest finite value rounds
    up to inf as the magnitude's carry says."""
    def f(bits):
        return torch.tensor([bits], dtype=torch.int64).to(torch.int32) \
            .view(torch.float32)
    tie = f(0x3F801000)                      # 1 + 2^-11
    assert tf32_rna(tie).view(torch.int32).item() == 0x3F802000
    assert tf32_rna(-tie).item() == -tf32_rna(tie).item()
    assert tf32_rna(f(0x3F800FFF)).view(torch.int32).item() == 0x3F800000
    assert tf32_rna(f(0x3F803000)).view(torch.int32).item() == 0x3F804000
    z = torch.tensor([0.0, -0.0])
    assert torch.equal(tf32_rna(z).view(torch.int32), z.view(torch.int32))
    inf = torch.tensor([math.inf, -math.inf])
    assert torch.equal(tf32_rna(inf), inf)
    assert torch.isnan(tf32_rna(torch.tensor([math.nan]))).all()
    assert tf32_rna(f(0x7F7FFFFF)).item() == math.inf


@pytest.mark.parametrize("d,s,causal,with_bias", CASES)
def test_emulated_forward_matches_the_jax_kernel(d, s, causal, with_bias):
    """(c) The emulated kernel against the JAX kernel in interpret mode:
    o within FA_TOL, lse within LSE_TOL."""
    oj, lj = _jax_case(d, s, causal, with_bias)
    o, lse = _emulated(d, s, causal, with_bias)
    np.testing.assert_allclose(o.numpy(), oj, atol=FA_TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), lj, atol=LSE_TOL, rtol=0)


@pytest.mark.parametrize("d", [128, 256])
def test_one_tf32_product_misses_the_tolerance(d):
    """(d) One TF32 product a step (rna(q) . rna(k), rna(p) . rna(v)) on
    the same inputs lands past FA_TOL, several times over: the tolerance
    tells the split from it."""
    oj, _ = _jax_case(d, 64, True, False)
    o, _ = _emulated(d, 64, True, False, single=True)
    err = np.abs(o.numpy() - oj).max()
    assert err > 5 * FA_TOL, err
    o3, _ = _emulated(d, 64, True, False)
    assert np.abs(o3.numpy() - oj).max() < FA_TOL
