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

For CUDA tensors the route follows the dtype, in the open
(:func:`~apex_tpu_torch.ops.tiling.fa_route`): bf16 runs the tensor-core
kernels (``wgmma`` products on tiles that TMA brings into shared memory):
the forward ``csrc/flash_fwd_wgmma.cu``, the dq kernel
``csrc/flash_bwd_dq_wgmma.cu`` and the dk / dv kernel
``csrc/flash_bwd_dkv_wgmma.cu``; fp32 runs the FMA-pipe kernels of
``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``, whose
full fp32 products the fp32 results keep (a TF32 product would not). The
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
Its gradient (``dbias``) and dropout at a rate above 0 are not ported yet
and raise. The kernels spread ``batch * heads`` over grid.y and grid.z
(:func:`~apex_tpu_torch.ops.tiling.fa_batch_heads_grid`), so any count
runs.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.tiling import (FA_HEAD_DIM, FA_TC_ALIGN,
                                       fa_batch_heads_grid, fa_route,
                                       fa_tc_misaligned)

NEG_INF = -1e30
# scores at or below this are "hard masked" (as in the JAX kernel)
_MASK_EDGE = 0.5 * NEG_INF
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the JAX package's default TPU tiles, which fill in the side an explicit
# block leaves out before the pair is validated
_JAX_BLOCK_Q, _JAX_BLOCK_K = 512, 1024


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
                              bias: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole-row softmax the online kernel computes: fp32 scores plus
    the bias, masked scores at -1e30, p cast to v's dtype before the p.v
    product, fully masked rows give o = 0 and lse = -1e30. Returns ``(o in
    q's dtype, lse (b, h, sq) fp32)``."""
    s = _scores(q, k, scale, causal, bias)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(m <= _MASK_EDGE, 0.0, m))
    denom = p.sum(dim=-1, keepdim=True)
    safe = torch.where(denom > 0, denom, 1.0)
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
                              bias: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The arithmetic of ``_fa_dq_kernel`` / ``_fa_dkv_kernel`` over whole
    rows: fp32 scores plus the bias, P from the saved lse,
    ``ds = P (dP - D)``, and the casts to the IO dtype before each product
    (``ds * scale`` for dq and dk, P for dv). Returns ``(dq, dk, dv)`` in
    q's / k's / v's dtype."""
    dvec = attention_dvec(o, do)
    s = _scores(q, k, scale, causal, bias)
    p = _bwd_p(s, lse)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds_scaled = p * (dp - dvec[..., None]) * scale
    dq = torch.matmul(ds_scaled.to(k.dtype).float(), k.float())
    dk = torch.matmul(ds_scaled.to(q.dtype).float().transpose(-1, -2),
                      q.float())
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_qkv(name: str, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> bool:
    """True for CPU tensors (plain version); raises on what the CUDA
    kernels do not take."""
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
    if d != FA_HEAD_DIM:
        raise NotImplementedError(
            f"{name}: the kernel is compiled for head_dim {FA_HEAD_DIM}, "
            f"got {d}")
    return False


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
                        bias: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(o, lse)``. CUDA tensors launch a kernel: contiguous
    float32 or bfloat16, one dtype for q, k and v, head_dim 64, any
    batch * heads and sq / sk, an optional fp32 bias broadcastable to
    ``(b, h, sq, sk)`` (any strides). bf16 launches the tensor-core
    kernel (q, k and v 16-byte aligned, else ``ValueError``), fp32 the
    FMA-pipe kernel. CPU tensors take the plain version."""
    name = "flash_attention_fwd"
    cpu = _check_qkv(name, q, k, v)
    bptr, bstrides = _bias_args(name, bias, q, k)
    if cpu:
        return flash_attention_fwd_plain(q, k, v, scale=scale, causal=causal,
                                         bias=bias)
    tc = _tensor_core(name, q, k=k, v=v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _build.lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bptr, o.data_ptr(),
            lse.data_ptr(), b * h, *fa_batch_heads_grid(b * h), h, sq, sk, d,
            float(scale), int(causal), *bstrides)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tc:
            err = lib.apex_fa_fwd_wgmma(*args, stream)
        else:
            err = lib.apex_fa_fwd(*args, _DTYPES[q.dtype], stream)
    _build.launches["fa_fwd"] += 1
    _build.route_launches["fa_fwd:" + ("wgmma" if tc else "fma")] += 1
    _build.check(err, name)
    return o, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, scale: float, causal: bool,
                        bias: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` from the forward's o and fp32 lse ``(b, h, sq)``
    and the forward's bias (no dbias). CUDA tensors launch the dq kernel
    and the dk / dv kernel (inputs as for :func:`flash_attention_fwd`; o
    and do like q): for bf16 the two tensor-core kernels (do 16-byte
    aligned too), for fp32 the two FMA-pipe kernels;
    no output is summed across blocks, so two runs give the same bits.
    CPU tensors take the plain version."""
    name = "flash_attention_bwd"
    cpu = _check_qkv(name, q, k, v)
    bptr, bstrides = _bias_args(name, bias, q, k)
    if cpu:
        return flash_attention_bwd_plain(q, k, v, o, lse, do, scale=scale,
                                         causal=causal, bias=bias)
    b, h, sq, d = q.shape
    sk = k.shape[2]
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
    tc = _tensor_core(name, q, k=k, v=v, do=do)
    dvec = attention_dvec(o, do)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _build.lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bptr, do.data_ptr(),
            lse.data_ptr(), dvec.data_ptr())
    geo = (b * h, *fa_batch_heads_grid(b * h), h, sq, sk, d, float(scale),
           int(causal), *bstrides)
    # the tensor-core entries take no dtype: they are bf16 only
    dq_fn, dkv_fn, dtype = (
        (lib.apex_fa_bwd_dq_wgmma, lib.apex_fa_bwd_dkv_wgmma, ()) if tc
        else (lib.apex_fa_bwd_dq, lib.apex_fa_bwd_dkv, (_DTYPES[q.dtype],)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        route = "wgmma" if tc else "fma"
        err = dq_fn(*args, dq.data_ptr(), *geo, *dtype, stream)
        _build.launches["fa_bwd_dq"] += 1
        _build.route_launches["fa_bwd_dq:" + route] += 1
        _build.check(err, "flash_attention_bwd (dq)")
        err = dkv_fn(*args, dk.data_ptr(), dv.data_ptr(), *geo, *dtype,
                     stream)
        _build.launches["fa_bwd_dkv"] += 1
        _build.route_launches["fa_bwd_dkv:" + route] += 1
        _build.check(err, "flash_attention_bwd (dk, dv)")
    return dq, dk, dv


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when it is contiguous and ``FA_TC_ALIGN``-byte
    aligned, as the kernels take it; else a contiguous copy (a fresh
    allocation, so aligned)."""
    if t.is_contiguous() and t.data_ptr() % FA_TC_ALIGN == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


class _FlashAttention(torch.autograd.Function):
    """The ``custom_vjp`` of the JAX ``_flash_attention`` without dbias:
    saves q, k, v, the bias, o and lse; the backward runs
    :func:`flash_attention_bwd`. q, k, v and the incoming gradient reach
    the kernels contiguous and aligned (:func:`_kernel_operand`), so any
    layout the JAX function takes runs here too."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale):
        q, k, v = (_kernel_operand(t) for t in (q, k, v))
        o, lse = flash_attention_fwd(q, k, v, scale=scale, causal=causal,
                                     bias=bias)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse,
                                         _kernel_operand(do),
                                         scale=ctx.scale, causal=ctx.causal,
                                         bias=bias)
        return dq, dk, dv, None, None, None


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
    kernels keep their own tiles (the fp32 forward blocks of 64 rows, the
    fp32 backward blocks of 128, over 64-row tiles,
    :func:`~apex_tpu_torch.ops.tiling.fa_fma_fwd_geometry` and
    :func:`~apex_tpu_torch.ops.tiling.fa_fma_bwd_geometry`; the bf16
    tensor-core kernels blocks of 128 rows in two 64-row warpgroups over
    64-row tiles).
    ``mask`` is a rank-4 boolean tensor broadcastable to ``(b, h, sq,
    sk)``, True = masked; a fully masked row gives zero output and zero
    gradients. ``bias`` is an
    additive logits bias of the same broadcastability, taken as a constant
    (``bias_requires_grad=False``). At ``dropout_p == 0`` a
    ``dropout_seed`` is accepted and ignored, as in JAX. A differentiated
    bias (the default ``bias_requires_grad=True``, whose ``dbias`` the JAX
    kernel emits) and ``dropout_p > 0`` are not ported yet and raise
    ``NotImplementedError``."""
    if block_q is not None or block_k is not None:
        validate_blocks(_JAX_BLOCK_Q if block_q is None else block_q,
                        _JAX_BLOCK_K if block_k is None else block_k)
    if dropout_p > 0.0:
        raise NotImplementedError(
            "flash_attention: dropout is not ported to the CUDA kernels yet "
            "(ROADMAP.md, port queue)")
    if bias is not None and bias_requires_grad:
        raise NotImplementedError(
            "flash_attention: a differentiated bias (dbias) is not ported "
            "to the CUDA kernels yet (ROADMAP.md, port queue); pass "
            "bias_requires_grad=False for a constant bias")
    if bias is not None:
        bias = bias.detach().float()
    if mask is not None:
        if mask.dim() != 4:
            raise ValueError("mask must be rank-4 broadcastable to "
                             "(b, h, sq, sk)")
        mbias = torch.zeros(mask.shape, dtype=torch.float32,
                            device=mask.device).masked_fill_(mask.bool(),
                                                            NEG_INF)
        bias = mbias if bias is None else bias + mbias
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, bias, bool(causal), float(s))
