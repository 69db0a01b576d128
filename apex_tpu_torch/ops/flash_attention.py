"""Flash attention forward and backward: the CUDA kernels and their plain
versions.

Counterpart of ``apex_tpu/ops/pallas/flash_attention.py``
``flash_attention_fwd``, ``flash_attention_bwd`` (its kernels
``_fa_dq_kernel`` and ``_fa_dkv_kernel``) and the public
``flash_attention`` with its ``custom_vjp``. Layout as in the JAX package:
q ``(b, h, sq, d)``, k / v ``(b, h, sk, d)``; the causal mask is top-left
aligned (key ``j`` is visible to query ``i`` when ``j <= i``). An optional
additive fp32 score bias, broadcastable to ``(b, h, sq, sk)`` with each
dimension 1 or full, is added to the scaled scores; the kernels read it
through per-dimension strides (0 on a broadcast dimension) and it is
never expanded (the JAX ``_BiasPlan`` rule), so BERT's ``(b, 1, 1, sk)``
padding mask stays ``b * sk`` floats. A score at or below -0.5e30 is out
of the softmax support.

For CUDA tensors the route follows the dtype and the head width, in the
open (:func:`~apex_tpu_torch.ops.tiling.fa_fwd_route`,
:func:`~apex_tpu_torch.ops.tiling.fa_route`): bf16 runs the tensor-core
kernels (``wgmma`` products on tiles that TMA brings into shared memory):
the forward ``csrc/flash_fwd_wgmma.cu``, the dq kernel
``csrc/flash_bwd_dq_wgmma.cu`` and the dk / dv kernel
``csrc/flash_bwd_dkv_wgmma.cu``. In fp32, the forward at d >= 65 (kernel
widths 128 and 256) runs split-TF32 products on the tensor cores
(``csrc/flash_fwd_tf32.cu``: three TF32 ``mma.sync`` products a pair of
split operands, as fp32 SDPA runs them, within the same fp32 tolerances),
and the forward at d <= 64 and the whole fp32 backward stay on the FMA
pipes (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``: full
fp32 products). The bf16
tensor-core kernels read q, k, v and do through TMA tensor maps, which
need 16-byte aligned base addresses: the raw :func:`flash_attention_fwd`
/ :func:`flash_attention_bwd` raise ``ValueError`` on a misaligned view
(no other route takes it), and both take contiguous tensors only. The
public :func:`flash_attention` takes any layout: it hands the kernels a
contiguous, aligned copy of an operand that is neither, and the operand
itself otherwise (no copy on the main path). CPU tensors run
:func:`flash_attention_fwd_plain` / :func:`flash_attention_bwd_plain`.
:func:`flash_attention` is differentiable: its ``autograd.Function`` saves
q, k, v, the bias, o and the fp32 lse, and its backward is
:func:`flash_attention_bwd`. A boolean ``mask`` (True = masked) becomes
the bias -1e30 where it is True, as in the JAX ``flash_attention``; a
``bias`` passed with ``bias_requires_grad=False`` is the same operand.
A differentiated bias (the default ``bias_requires_grad=True``) gets its
gradient from the dq kernels' dlogits form, which also writes ``dl = P
(dP - D)`` in fp32 for every (query, key), reduced to the bias's
broadcast shape (``_fa_dq_kernel``'s ``want_dbias``). Attention dropout
(``dropout_p > 0``) runs in every kernel from the keep mask of
:func:`dropout_keep`, the JAX kernels' ``_dropout_keep``: a stateless
hash of (seed, flat batch * head, query row, key), so the backward
regenerates the forward's mask and the mask is JAX's bit for bit
whatever the tiles. The kernels read the int32 seed from device memory,
so a per-step seed tensor costs no host sync. The kernels spread ``batch * heads`` over grid.y and grid.z
(:func:`~apex_tpu_torch.ops.tiling.fa_batch_heads_grid`), so any count
runs.

Every kernel is compiled at the head widths
:data:`~apex_tpu_torch.ops.tiling.FA_HEAD_DIMS` (64, 128 and 256). On the
card a call at a compiled d launches as it is; any other d up to 256 is
zero-padded along d to the next compiled width
(:func:`~apex_tpu_torch.ops.tiling.fa_kernel_head_dim`): q, k and v (and
do in the backward) gain zero columns, the kernels run at that width and
o, dq, dk and dv are sliced back; the wrappers that launch count the
launch under its pad key. The padding is exact: zero
columns add exact zeros to every score, to D = rowsum(dO * O) and to o,
and the bias, the dropout mask, lse and the dlogits do not depend on d.
The scale is the caller's (the default ``1/sqrt(d)`` from the caller's
d). The kernel runs on every such call; a head dim above 256 raises
``NotImplementedError`` on the card (ROADMAP.md). CPU tensors take any d.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

import torch.nn.functional as F

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.tiling import (FA_HEAD_DIMS, FA_TC_ALIGN,
                                       fa_batch_heads_grid, fa_fwd_route,
                                       fa_kernel_head_dim, fa_route,
                                       fa_tc_misaligned)

NEG_INF = -1e30
# scores at or below this are "hard masked" (as in the JAX kernel)
_MASK_EDGE = 0.5 * NEG_INF
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the JAX package's default TPU tiles, which fill in the side an explicit
# block leaves out before the pair is validated
_JAX_BLOCK_Q, _JAX_BLOCK_K = 512, 1024

# `_dropout_keep`'s hash: the multipliers of the query row, the key, the
# flat batch * head index and the seed, then the two of its finalizer
_HASH_ROW, _HASH_COL, _HASH_BH, _HASH_SEED = (0xD2511F53, 0xCD9E8D57,
                                              0x85EBCA6B, 0x9E3779B9)
_HASH_MIX = (0x7FEB352D, 0x846CA68B)
_U32 = 0xFFFFFFFF


def dropout_threshold(p: float) -> int:
    """The uint32 a kept entry's hash reaches: ``min(int(p * 2**32),
    2**32 - 1)``, as the JAX kernels compute it."""
    return min(int(p * (2.0 ** 32)), 2 ** 32 - 1)


def dropout_scale(p: float) -> float:
    """The factor of a kept entry, ``1 / (1 - p)`` rounded to fp32 as the
    JAX kernels' weakly typed constant is."""
    return float(torch.tensor(1.0 / (1.0 - p), dtype=torch.float32))


def dropout_seed_tensor(name: str, seed, device) -> torch.Tensor:
    """The dropout seed as the kernels read it: a one-element int32 tensor
    on ``device``. A Python int must fit int32 (None is 0, as in JAX); a
    one-element integer tensor wraps to int32, as JAX's
    ``jnp.asarray(seed, jnp.int32)`` does, on every device, and one that is
    already an int32 tensor there is used as it is (no copy, no host
    sync)."""
    if isinstance(seed, torch.Tensor):
        if seed.numel() != 1 or seed.is_floating_point() \
                or seed.is_complex():
            raise ValueError(f"{name}: dropout_seed must be one integer, "
                             f"got {seed.dtype} {tuple(seed.shape)}")
        return seed.detach().to(device=device, dtype=torch.int32).reshape(1)
    return torch.tensor([0 if seed is None else int(seed)],
                        dtype=torch.int32, device=device)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32): two 16-bit halves
    of ``c``, so no product leaves int64 (CPU torch has no uint32
    multiply)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def dropout_keep(seed, bh, row0: int, col0: int, rows: int, cols: int,
                 p: float, device=None) -> torch.Tensor:
    """The attention-dropout keep factors of rows ``row0 ..`` (queries)
    and columns ``col0 ..`` (keys) of the flat batch * head slice ``bh``
    (an int, or an integer tensor of slices) under ``seed`` (as
    :func:`dropout_seed_tensor` takes it): fp32 ``1 / (1 - p)`` where
    kept, 0 where dropped, shaped ``bh``'s shape + ``(rows, cols)``.

    The counterpart of the JAX kernels' ``_dropout_keep``: the same
    stateless hash of (seed, bh, global row, global column) in uint32
    arithmetic (here int64 masked to 32 bits), kept where the hash is at
    least :func:`dropout_threshold`. It does not depend on any tiling, so
    every kernel and this plain version give JAX's mask bit for bit."""
    i64 = dict(dtype=torch.int64, device=device)
    bh = torch.as_tensor(bh, **i64)
    row = torch.arange(rows, **i64) + row0
    col = torch.arange(cols, **i64) + col0
    seed = dropout_seed_tensor("dropout_keep", seed, row.device) \
        .to(torch.int64).reshape(()) & _U32
    head = _mul32(bh, _HASH_BH) ^ _mul32(seed, _HASH_SEED)
    x = (_mul32(row, _HASH_ROW)[:, None] ^ _mul32(col, _HASH_COL)[None, :]
         ^ head[..., None, None])
    x = x ^ (x >> 16)
    x = _mul32(x, _HASH_MIX[0])
    x = x ^ (x >> 15)
    x = _mul32(x, _HASH_MIX[1])
    x = x ^ (x >> 16)
    return torch.where(x >= dropout_threshold(p), dropout_scale(p), 0.0)


def _keep_all(seed, q: torch.Tensor, k: torch.Tensor, p: float):
    """The keep factors of every (b, h, query, key), ``(b, h, sq, sk)``
    fp32."""
    b, h, sq, _ = q.shape
    return dropout_keep(seed, torch.arange(b * h, device=q.device), 0, 0, sq,
                        k.shape[2], p, device=q.device).view(
                            b, h, sq, k.shape[2])


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float, causal: bool,
            bias: Optional[torch.Tensor]) -> torch.Tensor:
    """fp32 ``(q . k) * scale + bias``, causal positions at -1e30."""
    sq, sk = q.shape[2], k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, NEG_INF)
    return s


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, scale: float,
                              causal: bool,
                              bias: Optional[torch.Tensor] = None,
                              dropout_p: float = 0.0, dropout_seed=None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole-row softmax the online kernel computes: fp32 scores plus
    the bias, masked scores at -1e30, p times its keep factor (dropout,
    :func:`dropout_keep`; a seed of None is 0, as in JAX) cast to v's
    dtype before the p.v product, the row sum and lse from the undropped
    p, fully masked rows give o = 0 and lse = -1e30. Returns ``(o in q's
    dtype, lse (b, h, sq) fp32)``."""
    s = _scores(q, k, scale, causal, bias)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(m <= _MASK_EDGE, 0.0, m))
    denom = p.sum(dim=-1, keepdim=True)
    safe = torch.where(denom > 0, denom, 1.0)
    if dropout_p > 0.0:
        p = p * _keep_all(dropout_seed, q, k, dropout_p)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / safe
    lse = torch.where(m <= _MASK_EDGE, NEG_INF, m + torch.log(safe))
    return o.to(q.dtype), lse.squeeze(-1)


def _bwd_p(s: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """P = exp(s - lse), exactly 0 where the score is hard masked or the
    row's lse is (fully masked rows) — ``_bwd_p`` of the JAX kernels."""
    lse = lse[..., None]
    dead = (s <= _MASK_EDGE) | (lse <= _MASK_EDGE)
    return torch.where(dead, 0.0,
                       torch.exp(s - torch.where(lse <= _MASK_EDGE, 0.0,
                                                 lse)))


def attention_dvec(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O) in fp32, ``(b, h, sq)``: the backward's per-row
    term, computed outside the kernels as the JAX wrapper computes it."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              scale: float, causal: bool,
                              bias: Optional[torch.Tensor] = None,
                              dropout_p: float = 0.0, dropout_seed=None,
                              want_dbias: bool = False) -> tuple:
    """The arithmetic of ``_fa_dq_kernel`` / ``_fa_dkv_kernel`` over whole
    rows: fp32 scores plus the bias, P from the saved lse, dP times the
    keep factor under dropout, ``dl = P (dP - D)``, and the casts to the IO
    dtype before each product (``dl * scale`` for dq and dk, P times the
    keep factor for dv). Returns ``(dq, dk, dv)`` in q's / k's / v's
    dtype; with ``want_dbias`` also the fp32 dlogits ``dl`` ``(b, h, sq,
    sk)`` (0 where masked; None without a bias, as in JAX)."""
    dvec = attention_dvec(o, do)
    s = _scores(q, k, scale, causal, bias)
    p = _bwd_p(s, lse)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    p_v = p
    if dropout_p > 0.0:
        keep = _keep_all(dropout_seed, q, k, dropout_p)
        dp = dp * keep
        p_v = p * keep
    dl = p * (dp - dvec[..., None])
    ds_scaled = dl * scale
    dq = torch.matmul(ds_scaled.to(k.dtype).float(), k.float())
    dk = torch.matmul(ds_scaled.to(q.dtype).float().transpose(-1, -2),
                      q.float())
    dv = torch.matmul(p_v.to(do.dtype).float().transpose(-1, -2),
                      do.float())
    grads = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
    if want_dbias:
        return grads + (dl if bias is not None else None,)
    return grads


def _check_qkv(name: str, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> bool:
    """True for CPU tensors (plain version); raises on what the CUDA
    kernels do not take (a head dim above the widest compiled one:
    ``NotImplementedError``)."""
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be (b, h, s, d)")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"{name}: k / v shape {tuple(k.shape)} / "
                         f"{tuple(v.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v must share one dtype of "
                         f"float32 / bfloat16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q, k, v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: q, k, v must be contiguous")
    if fa_kernel_head_dim(d) is None:
        raise NotImplementedError(
            f"{name}: head_dim {d}; the kernels are compiled for head dims "
            f"{FA_HEAD_DIMS} and take any d up to {FA_HEAD_DIMS[-1]} "
            f"(zero-padded); wider heads are still to be ported "
            f"(ROADMAP.md, port queue)")
    return False


def _pad_d(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` with zero columns appended along d up to ``width`` (a fresh
    contiguous tensor, so aligned), or ``t`` itself at that width."""
    d = t.shape[-1]
    return t if d == width else F.pad(t, (0, width - d))


def _bias_args(name: str, bias: Optional[torch.Tensor],
               q: torch.Tensor, k: torch.Tensor):
    """``(pointer, (stride_b, stride_h, stride_q, stride_k))`` of the bias
    for the kernels: strides in elements, 0 on a broadcast dimension.
    Raises, on either route, on a bias the kernels do not take."""
    if bias is None:
        return None, (0, 0, 0, 0)
    b, h, sq, _ = q.shape
    full = (b, h, sq, k.shape[2])
    if bias.dim() != 4 or bias.dtype != torch.float32 \
            or bias.device != q.device \
            or any(n not in (1, f) for n, f in zip(bias.shape, full)):
        raise ValueError(
            f"{name}: bias must be a rank-4 float32 tensor on {q.device} "
            f"whose every dimension is 1 or that of {full}, got "
            f"{tuple(bias.shape)} {bias.dtype} on {bias.device}")
    strides = tuple(0 if n == 1 else st
                    for n, st in zip(bias.shape, bias.stride()))
    return bias.data_ptr(), strides


def _dropout_args(name: str, p: float, seed, device):
    """``((seed pointer, threshold, keep factor), seed tensor)`` of the
    kernels' dropout operands: a null pointer at ``p == 0``, else the seed
    as :func:`dropout_seed_tensor` gives it, which the caller keeps alive
    over the launch."""
    if not p > 0.0:
        return (None, 0, 0.0), None
    if not p < 1.0:
        raise ValueError(f"{name}: dropout_p must be below 1, got {p}")
    st = dropout_seed_tensor(name, seed, device)
    return (st.data_ptr(), dropout_threshold(p), dropout_scale(p)), st


def _tensor_core(name: str, q: torch.Tensor,
                 **others: torch.Tensor) -> bool:
    """True when the call takes the tensor-core kernels (q in bf16);
    those read q and ``others`` through TMA, so each must be 16-byte
    aligned, else ``ValueError``."""
    if fa_route(str(q.dtype).removeprefix("torch.")) != "wgmma":
        return False
    bad = fa_tc_misaligned({"q": q.data_ptr(), **{
        n: t.data_ptr() for n, t in others.items()}})
    if bad:
        raise ValueError(
            f"{name}: the bf16 kernels read {', '.join(bad)} through TMA, "
            f"which needs a {FA_TC_ALIGN}-byte aligned base address; pass "
            f"a copy (.clone())")
    return True


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float, causal: bool,
                        bias: Optional[torch.Tensor] = None,
                        dropout_p: float = 0.0, dropout_seed=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(o, lse)``. CUDA tensors launch a kernel: contiguous
    float32 or bfloat16, one dtype for q, k and v, any head dim up to 256
    (64, 128 and 256 as they are, others zero-padded to the next of them,
    o sliced back), any batch * heads and sq / sk, an optional fp32 bias
    broadcastable to
    ``(b, h, sq, sk)`` (any strides), attention dropout at ``dropout_p``
    from ``dropout_seed`` (an int or a one-element integer tensor; None
    is 0, as in JAX). bf16 launches the tensor-core kernel (q, k and v
    16-byte aligned, else ``ValueError``), fp32 at a kernel width of 128 or
    256 the split-TF32 tensor-core kernel and at 64 the FMA-pipe kernel
    (both take 4-byte aligned views). CPU tensors take the plain
    version."""
    name = "flash_attention_fwd"
    cpu = _check_qkv(name, q, k, v)
    bptr, bstrides = _bias_args(name, bias, q, k)
    if cpu:
        return flash_attention_fwd_plain(q, k, v, scale=scale, causal=causal,
                                         bias=bias, dropout_p=dropout_p,
                                         dropout_seed=dropout_seed)
    d = q.shape[-1]
    q, k, v = (_pad_d(t, fa_kernel_head_dim(d)) for t in (q, k, v))
    _tensor_core(name, q, k=k, v=v)   # raises on a misaligned bf16 operand
    route = fa_fwd_route(str(q.dtype).removeprefix("torch."), q.shape[-1])
    drop, _seed = _dropout_args(name, dropout_p, dropout_seed, q.device)
    b, h, sq, kd = q.shape
    sk = k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _build.lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bptr, o.data_ptr(),
            lse.data_ptr(), b * h, *fa_batch_heads_grid(b * h), h, sq, sk,
            kd, float(scale), int(causal), *bstrides, *drop)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "wgmma":
            err = lib.apex_fa_fwd_wgmma(*args, stream)
        elif route == "tf32":
            err = lib.apex_fa_fwd_tf32(*args, stream)
        else:
            err = lib.apex_fa_fwd(*args, _DTYPES[q.dtype], stream)
    _count("fa_fwd", route, d, kd, dropout=drop[0] is not None)
    _build.check(err, name)
    return (o if kd == d else o[..., :d].contiguous()), lse


def _count(name: str, route: str, d: int, kd: int, **forms: bool) -> None:
    """One launch of flash kernel ``name`` on ``route`` (``"wgmma"``,
    ``"tf32"`` or ``"fma"``) at compiled width ``kd`` for a call at head
    dim ``d``: its count, its route's and those of the forms it ran
    (``fa_fwd:wgmma:dropout``, ``fa_bwd_dq:fma:dbias``). A width other
    than 64 has its own keys (``fa_fwd:wgmma:d128``, one a launch,
    ``fa_fwd:tf32:d256:dropout``, ``fa_bwd_dq:fma:d256:dbias``), and a
    call that ran zero-padded one more (``fa_fwd:wgmma:pad80``,
    ``fa_bwd_dkv:fma:pad192``)."""
    route = f"{name}:{route}"
    _build.launches[name] += 1
    _build.route_launches[route] += 1
    width = route if kd == 64 else f"{route}:d{kd}"
    if kd != 64:
        _build.form_launches[width] += 1
    if d != kd:
        _build.form_launches[f"{route}:pad{d}"] += 1
    for form, on in forms.items():
        if on:
            _build.form_launches[f"{width}:{form}"] += 1


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, scale: float, causal: bool,
                        bias: Optional[torch.Tensor] = None,
                        dropout_p: float = 0.0, dropout_seed=None,
                        want_dbias: bool = False) -> tuple:
    """``(dq, dk, dv)`` from the forward's o and fp32 lse ``(b, h, sq)``,
    the forward's bias and its dropout rate and seed; with ``want_dbias``
    also the fp32 dlogits ``(b, h, sq, sk)`` that a differentiated bias
    reduces (None without a bias). CUDA tensors launch the dq kernel
    (in its dlogits form with ``want_dbias`` and a bias) and the dk / dv
    kernel (inputs as for :func:`flash_attention_fwd`, padded the same
    way; o and do like q):
    for bf16 the two tensor-core kernels (do 16-byte aligned too), for
    fp32 the two FMA-pipe kernels; no output is summed across blocks, so
    two runs give the same bits. CPU tensors take the plain version."""
    name = "flash_attention_bwd"
    cpu = _check_qkv(name, q, k, v)
    bptr, bstrides = _bias_args(name, bias, q, k)
    if cpu:
        return flash_attention_bwd_plain(
            q, k, v, o, lse, do, scale=scale, causal=causal, bias=bias,
            dropout_p=dropout_p, dropout_seed=dropout_seed,
            want_dbias=want_dbias)
    b, h, sq, d = q.shape
    for what, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous "
                             f"{tuple(q.shape)} {q.dtype} tensor like q, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"{name}: lse must be a contiguous float32 "
                         f"{(b, h, sq)} tensor, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    dvec = attention_dvec(o, do)
    kd = fa_kernel_head_dim(d)
    q, k, v, do = (_pad_d(t, kd) for t in (q, k, v, do))
    sk = k.shape[2]
    tc = _tensor_core(name, q, k=k, v=v, do=do)
    drop, _seed = _dropout_args(name, dropout_p, dropout_seed, q.device)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    # the dq kernel writes every (query, key) entry of the dlogits
    dl = (torch.empty((b, h, sq, sk), dtype=torch.float32, device=q.device)
          if want_dbias and bias is not None else None)
    lib = _build.lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bptr, do.data_ptr(),
            lse.data_ptr(), dvec.data_ptr())
    geo = (b * h, *fa_batch_heads_grid(b * h), h, sq, sk, kd, float(scale),
           int(causal), *bstrides, *drop)
    # the tensor-core entries take no dtype: they are bf16 only
    dq_fn, dkv_fn, dtype = (
        (lib.apex_fa_bwd_dq_wgmma, lib.apex_fa_bwd_dkv_wgmma, ()) if tc
        else (lib.apex_fa_bwd_dq, lib.apex_fa_bwd_dkv, (_DTYPES[q.dtype],)))
    dropout = drop[0] is not None
    route = "wgmma" if tc else "fma"
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = dq_fn(*args, dq.data_ptr(), *geo,
                    None if dl is None else dl.data_ptr(), *dtype, stream)
        _count("fa_bwd_dq", route, d, kd, dropout=dropout,
               dbias=dl is not None)
        _build.check(err, "flash_attention_bwd (dq)")
        err = dkv_fn(*args, dk.data_ptr(), dv.data_ptr(), *geo, *dtype,
                     stream)
        _count("fa_bwd_dkv", route, d, kd, dropout=dropout)
        _build.check(err, "flash_attention_bwd (dk, dv)")
    if kd != d:
        dq, dk, dv = (g[..., :d].contiguous() for g in (dq, dk, dv))
    if want_dbias:
        return dq, dk, dv, dl
    return dq, dk, dv


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when it is contiguous and ``FA_TC_ALIGN``-byte
    aligned, as the kernels take it; else a contiguous copy (a fresh
    allocation, so aligned)."""
    if t.is_contiguous() and t.data_ptr() % FA_TC_ALIGN == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _reduce_dlogits(dl: torch.Tensor, shape) -> torch.Tensor:
    """The dlogits ``(b, h, sq, sk)`` summed over each dimension the bias
    broadcasts (1 in ``shape``), kept as size 1: the bias's gradient, as
    the JAX wrapper reduces it."""
    dims = tuple(i for i, n in enumerate(shape) if n == 1 and dl.shape[i] != 1)
    return dl.sum(dim=dims, keepdim=True) if dims else dl


class _FlashAttention(torch.autograd.Function):
    """The ``custom_vjp`` of the JAX ``_flash_attention`` and
    ``_flash_attention_dropout``: saves q, k, v, the bias, o, lse and the
    dropout seed (rate and seed regenerate the forward's keep mask); the
    backward runs :func:`flash_attention_bwd`, with the dlogits form when
    the bias needs a gradient, reduced to the bias's shape. q, k, v and
    the incoming gradient reach the kernels contiguous and aligned
    (:func:`_kernel_operand`), so any layout the JAX function takes runs
    here too. The saved tensors keep the caller's head dim: the wrappers
    pad what a kernel reads, and neither o nor lse is read at the padded
    width (D = rowsum(dO o) is taken at the caller's)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, causal, scale, dropout_p):
        q, k, v = (_kernel_operand(t) for t in (q, k, v))
        o, lse = flash_attention_fwd(q, k, v, scale=scale, causal=causal,
                                     bias=bias, dropout_p=dropout_p,
                                     dropout_seed=seed)
        ctx.save_for_backward(q, k, v, bias, o, lse, seed)
        ctx.causal, ctx.scale, ctx.dropout_p = causal, scale, dropout_p
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse, seed = ctx.saved_tensors
        want_dbias = bias is not None and ctx.needs_input_grad[3]
        grads = flash_attention_bwd(q, k, v, o, lse, _kernel_operand(do),
                                    scale=ctx.scale, causal=ctx.causal,
                                    bias=bias, dropout_p=ctx.dropout_p,
                                    dropout_seed=seed,
                                    want_dbias=want_dbias)
        dbias = _reduce_dlogits(grads[3], bias.shape) if want_dbias else None
        return (*grads[:3], dbias, None, None, None, None)


def validate_blocks(block_q: int, block_k: int) -> None:
    """The JAX package's rule for explicit flash blocks (its
    ``validate_blocks``): ``block_q`` a positive multiple of 8 and
    ``block_k`` a positive multiple of 128, else ``ValueError``."""
    ok = (isinstance(block_q, int) and isinstance(block_k, int)
          and block_q > 0 and block_q % 8 == 0
          and block_k > 0 and block_k % 128 == 0)
    if not ok:
        raise ValueError(
            f"flash_attention block_q={block_q!r}/block_k={block_k!r} "
            f"invalid: block_q must be a positive multiple of 8 and "
            f"block_k a positive multiple of 128")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None, *,
                    bias: Optional[torch.Tensor] = None,
                    mask: Optional[torch.Tensor] = None,
                    dropout_p: float = 0.0, dropout_seed=None,
                    bias_requires_grad: bool = True) -> torch.Tensor:
    """Scaled dot-product attention, differentiable in q, k and v;
    ``scale`` defaults to ``1/sqrt(d)``. ``block_q`` / ``block_k`` are the
    JAX signature's TPU tiles: explicit values are validated by its rule
    (:func:`validate_blocks`; one given alone is checked beside the JAX
    default of the other, 512 or 1024) and change nothing else: the CUDA
    kernels keep their own tiles (the fp32 forward's by head width,
    :func:`~apex_tpu_torch.ops.tiling.fa_fma_fwd_geometry` at 64 and
    :func:`~apex_tpu_torch.ops.tiling.fa_tf32_fwd_geometry` at 128 and
    256, the fp32 backward's
    :func:`~apex_tpu_torch.ops.tiling.fa_fma_bwd_geometry`; the bf16
    tensor-core forward's blocks of 128 rows in two 64-row warpgroups
    over 64-key tiles, 32 at d = 256,
    :func:`~apex_tpu_torch.ops.tiling.fa_tc_fwd_geometry`; the backward
    pair's of 128 rows over 64-row tiles, at d = 256 dq's over 32-key
    tiles and dk / dv's of one 64-key slab whose two warpgroups exchange
    p and ds, :func:`~apex_tpu_torch.ops.tiling.fa_tc_geometry`).
    ``mask`` is a rank-4 boolean tensor broadcastable to ``(b, h, sq,
    sk)``, True = masked; a fully masked row gives zero output and zero
    gradients. ``bias`` is an additive logits bias of the same
    broadcastability; with ``bias_requires_grad`` (the default) it is
    differentiable, its gradient from the dq kernels' dlogits (which costs
    a ``(b, h, sq, sk)`` fp32 write in the backward), else a constant. The
    mask's -1e30 term is a constant added to it outside the autograd
    function, so the gradient reaches only the user's bias.
    ``dropout_p`` applies attention dropout with the in-kernel keep mask
    (:func:`dropout_keep`) and needs ``dropout_seed`` (an int or a
    one-element integer tensor, varied per step); at ``dropout_p == 0`` a
    ``dropout_seed`` is accepted and ignored, as in JAX."""
    if block_q is not None or block_k is not None:
        validate_blocks(_JAX_BLOCK_Q if block_q is None else block_q,
                        _JAX_BLOCK_K if block_k is None else block_k)
    if bias is not None:
        bias = bias.float() if bias_requires_grad else bias.detach().float()
    if mask is not None:
        if mask.dim() != 4:
            raise ValueError("mask must be rank-4 broadcastable to "
                             "(b, h, sq, sk)")
        mbias = torch.zeros(mask.shape, dtype=torch.float32,
                            device=mask.device).masked_fill_(mask.bool(),
                                                            NEG_INF)
        bias = mbias if bias is None else bias + mbias
    seed = None
    if dropout_p > 0.0:
        if dropout_seed is None:
            raise ValueError(
                "dropout_p > 0 requires dropout_seed (vary it per training "
                "step — a fixed seed would drop the same attention entries "
                "every step)")
        seed = dropout_seed_tensor("flash_attention", dropout_seed,
                                   q.device)
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, bias, seed, bool(causal),
                                 float(s), float(dropout_p))
