"""NHWC GroupNorm (+ SiLU) forward: the CUDA kernels and their plain
versions.

Counterpart of ``apex_tpu/ops/pallas/group_norm_kernel.py``: the one-pass
kernel (``_group_norm_one_pass``), the two-pass pair of
``group_norm_nhwc_pallas`` (``_stats_kernel``, then the mean / var / rstd as
tensor ops, then ``_apply_kernel``), the function that runs them with its
``algo`` switch, :func:`gn_forward`, and the JAX forward's signature over
it, :func:`group_norm_nhwc_fwd`. x is ``(n, h, w, c)``, seen by the
kernels as ``(n, hw, c)``; group g is channels ``[g *
cpg, (g + 1) * cpg)``; any hw. The statistics are shifted by each
group's first element K (:func:`gn_shift`; ``csrc/group_norm.cu`` says
why and where this differs from the TPU kernels' ``E[x^2] - mean^2``):
the one-pass form takes the mean of ``x - K`` and then the variance
centred over the group; the two-pass form sums ``x - K`` and its square
per (sample, HW tile, group) and combines the partials in tile order.
Both give ``mean_d = mean - K`` and rstd, from which the backward rebuilds
``(x - K) - mean_d`` without the rounding of ``K + mean_d``.

:func:`gn_one_pass`, :func:`gn_stats` and :func:`gn_apply` launch the
kernels for CUDA tensors and run :func:`gn_one_pass_plain`,
:func:`gn_stats_plain` and :func:`gn_apply_plain` for CPU tensors; there
is no other route. weight and bias may be float32 or bfloat16 (cast to
float32 for the kernels); y comes back in x's dtype, mean_d and rstd as
``(n, groups)`` float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.layer_norm_kernel import (_DTYPE_NAMES, _DTYPES,
                                                  _check_device, _param_f32,
                                                  _ptr)
from apex_tpu_torch.ops.tiling import (GN_VECTOR_BYTES, gn_hw_block,
                                       gn_one_pass_geometry, gn_one_pass_ok,
                                       gn_two_pass_geometry)

ACTS = ("", "silu")
Stats = Tuple[torch.Tensor, torch.Tensor]


def _epilogue(v: torch.Tensor, weight: Optional[torch.Tensor],
              bias: Optional[torch.Tensor], act: str) -> torch.Tensor:
    """``v * weight + bias``, then SiLU, in fp32 over the last (channel)
    dimension."""
    if weight is not None:
        v = v * weight.float()
    if bias is not None:
        v = v + bias.float()
    if act == "silu":
        v = v * torch.sigmoid(v)
    return v


def gn_one_pass_plain(x3: torch.Tensor, groups: int,
                      weight: Optional[torch.Tensor],
                      bias: Optional[torch.Tensor], *, eps: float,
                      act: str = "") -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """The one-pass kernel's arithmetic: per (sample, group), d = x - K
    (K the group's first element), mean_d = mean(d), the centred variance
    mean((d - mean_d)^2), y from ``(d - mean_d) * rstd``. Returns ``(y in
    x3's dtype, mean_d, rstd)``, the last two ``(n, groups)`` fp32."""
    n, hw, c = x3.shape
    x = x3.float().reshape(n, hw, groups, c // groups)
    k = x[:, :1, :, :1]
    d = x - k
    md = d.mean(dim=(1, 3), keepdim=True)
    dc = d - md
    rstd = torch.rsqrt((dc * dc).mean(dim=(1, 3), keepdim=True) + eps)
    y = _epilogue((dc * rstd).reshape(n, hw, c), weight, bias, act)
    return (y.to(x3.dtype), md.reshape(n, groups), rstd.reshape(n, groups))


def gn_shift(x3: torch.Tensor, groups: int) -> torch.Tensor:
    """K of every (sample, group): its first element ``x3[n, 0, g *
    cpg]`` as ``(n, groups)`` fp32."""
    return x3[:, 0, ::x3.shape[2] // groups].float().contiguous()


def gn_stats_plain(x3: torch.Tensor, shift: torch.Tensor, hw_block: int
                   ) -> Stats:
    """The stats kernel's arithmetic: per (sample, HW tile, group) the sums
    of ``d = x - K`` and of ``d^2``, each channel summed over the tile's
    pixels first, then a group's channels. Returns ``(psum, psq)``, each
    ``(n, hw / hw_block, groups)`` fp32."""
    n, hw, c = x3.shape
    groups = shift.shape[1]
    d = x3.float().reshape(n, hw // hw_block, hw_block, groups,
                           c // groups) - shift.reshape(n, 1, 1, groups, 1)
    return d.sum(dim=2).sum(dim=-1), (d * d).sum(dim=2).sum(dim=-1)


def gn_moments(psum: torch.Tensor, psq: torch.Tensor, count: int,
               eps: float) -> Stats:
    """Between the two launches (XLA in the JAX package): the partials
    added in tile order, ``mean_d = sum(d) / count``, ``var = max(sum(d^2)
    / count - mean_d^2, 0)``. Returns ``(mean_d, rstd)``, each ``(n,
    groups)`` fp32."""
    md = psum.sum(dim=1) / count
    var = torch.clamp_min(psq.sum(dim=1) / count - md * md, 0.0)
    return md, torch.rsqrt(var + eps)


def gn_apply_plain(x3: torch.Tensor, shift: torch.Tensor,
                   dmean: torch.Tensor, rstd: torch.Tensor,
                   weight: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], *, act: str = ""
                   ) -> torch.Tensor:
    """The apply kernel's arithmetic: ``((x - K) - mean_d) * rstd`` with
    its group's K, mean_d and rstd, then the affine and SiLU; y in x3's
    dtype."""
    cpg = x3.shape[2] // shift.shape[1]

    def per_channel(t):
        return t.repeat_interleave(cpg, dim=1)[:, None, :]

    y = ((x3.float() - per_channel(shift)) - per_channel(dmean)) \
        * per_channel(rstd)
    return _epilogue(y, weight, bias, act).to(x3.dtype)


def _check_x(name: str, x3: torch.Tensor, groups: int) -> None:
    if x3.dim() != 3 or x3.dtype not in _DTYPES or not x3.is_contiguous():
        raise ValueError(
            f"{name}: x3 must be a contiguous (n, hw, c) float32/bfloat16 "
            f"tensor, got {tuple(x3.shape)} {x3.dtype} "
            f"contiguous={x3.is_contiguous()}")
    n, hw, c = x3.shape
    if groups < 1 or c % groups or hw < 1 or hw * (c // groups) >= 2 ** 31:
        raise ValueError(f"{name}: groups={groups} must divide c={c}, with "
                         f"hw * c / groups < 2^31 (hw={hw})")


def _check_act(name: str, act: str) -> None:
    if act not in ACTS:
        raise ValueError(f"{name}: unsupported act {act!r}")


def _check_tile(name: str, hw: int, hw_block: int) -> None:
    if hw_block < 1 or hw % hw_block:
        raise ValueError(f"{name}: hw_block={hw_block} does not divide "
                         f"hw={hw}")


def _check_stats(name: str, x3: torch.Tensor, groups: int, **ts) -> None:
    for what, t in ts.items():
        if t.device != x3.device or t.dtype != torch.float32 \
                or tuple(t.shape) != (x3.shape[0], groups) \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: {what} must be a contiguous float32 "
                f"{(x3.shape[0], groups)} tensor on {x3.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}")


def gn_one_pass(x3: torch.Tensor, groups: int,
                weight: Optional[torch.Tensor],
                bias: Optional[torch.Tensor], *, eps: float, act: str = ""
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-pass GroupNorm of x3 ``(n, hw, c)``: ``(y, mean_d, rstd)`` as
    :func:`gn_one_pass_plain` returns them. CUDA tensors launch the kernel
    on the route :func:`~apex_tpu_torch.ops.tiling.gn_one_pass_geometry`
    picks: thread block clusters over (sample, channel slice) whose blocks
    stage their pixels' tile in shared memory; one block per (group,
    sample) staging its slab as fp32 where a slice cannot be 16-byte
    aligned; or, over :func:`~apex_tpu_torch.ops.tiling.gn_one_pass_ok`,
    reading x from device memory in each pass. CPU tensors take the plain
    version."""
    _check_act("gn_one_pass", act)
    if _check_device("gn_one_pass", x3):
        return gn_one_pass_plain(x3, groups, weight, bias, eps=eps, act=act)
    _check_x("gn_one_pass", x3, groups)
    w = _param_f32("gn_one_pass", weight, x3, "weight")
    b = _param_f32("gn_one_pass", bias, x3, "bias")
    n, hw, c = x3.shape
    geo = gn_one_pass_geometry(
        n, hw, c, groups, _DTYPE_NAMES[x3.dtype],
        aligned=x3.data_ptr() % GN_VECTOR_BYTES == 0)
    y = torch.empty_like(x3)
    dmean = torch.empty((n, groups), dtype=torch.float32, device=x3.device)
    rstd = torch.empty_like(dmean)
    lib = _build.lib()
    with torch.cuda.device(x3.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.apex_gn_one_pass(
            x3.data_ptr(), _ptr(w), _ptr(b), y.data_ptr(), dmean.data_ptr(),
            rstd.data_ptr(), n, hw, c, groups, float(eps),
            int(act == "silu"), geo.route_id,
            geo.slice_c, geo.cluster, geo.pixels, geo.threads,
            _DTYPES[x3.dtype], stream)
    _build.launches["gn_one_pass"] += 1
    _build.check(err, "gn_one_pass")
    return y, dmean, rstd


def _two_pass_geometry(x3: torch.Tensor, groups: int, hw_block: int):
    """The pair's launch for x3 in tiles of ``hw_block`` pixels
    (:func:`~apex_tpu_torch.ops.tiling.gn_two_pass_geometry`); the vector
    route only for 16-byte aligned x (y is a fresh, aligned tensor)."""
    n, hw, c = x3.shape
    return gn_two_pass_geometry(
        n, hw, c, groups, _DTYPE_NAMES[x3.dtype],
        aligned=x3.data_ptr() % GN_VECTOR_BYTES == 0, tile=hw_block)


def gn_stats(x3: torch.Tensor, shift: torch.Tensor, hw_block: int
             ) -> Stats:
    """The two-pass statistics of x3 ``(n, hw, c)`` about ``shift`` (K,
    ``(n, groups)`` fp32, :func:`gn_shift`): ``(psum, psq)`` as
    :func:`gn_stats_plain` returns them. CUDA tensors launch the kernel on
    the route :func:`~apex_tpu_torch.ops.tiling.gn_two_pass_geometry`
    picks: blocks of 16-byte vector columns over one or two consecutive
    (sample, HW tile of ``hw_block`` pixels) slots, or one block per
    (tile, sample) with scalar loads; each slot is written once, so two
    runs give the same bits. CPU tensors take the plain version."""
    if _check_device("gn_stats", x3):
        return gn_stats_plain(x3, shift, hw_block)
    groups = shift.shape[1] if shift.dim() == 2 else 0
    _check_x("gn_stats", x3, groups)
    _check_stats("gn_stats", x3, groups, shift=shift)
    n, hw, c = x3.shape
    _check_tile("gn_stats", hw, hw_block)
    geo = _two_pass_geometry(x3, groups, hw_block)
    psum = torch.empty((n, hw // hw_block, groups), dtype=torch.float32,
                       device=x3.device)
    psq = torch.empty_like(psum)
    lib = _build.lib()
    with torch.cuda.device(x3.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.apex_gn_stats(x3.data_ptr(), shift.data_ptr(),
                                psum.data_ptr(), psq.data_ptr(), n, hw, c,
                                groups, hw_block, geo.route_id, geo.rows,
                                geo.threads, geo.stats_tiles,
                                _DTYPES[x3.dtype], stream)
    _build.launches["gn_stats"] += 1
    _build.check(err, "gn_stats")
    return psum, psq


def gn_apply(x3: torch.Tensor, shift: torch.Tensor, dmean: torch.Tensor,
             rstd: torch.Tensor, weight: Optional[torch.Tensor],
             bias: Optional[torch.Tensor], hw_block: int, *,
             act: str = "") -> torch.Tensor:
    """``((x - K) - mean_d) * rstd``, the affine and SiLU over x3 ``(n, hw,
    c)`` with each group's K, mean_d and rstd (``(n, groups)`` fp32); y in
    x3's dtype, as :func:`gn_apply_plain` computes it. CUDA tensors launch
    the kernel on the stats kernel's route, one block per (HW tile of
    ``hw_block`` pixels, sample). CPU tensors take the plain version."""
    _check_act("gn_apply", act)
    if _check_device("gn_apply", x3):
        return gn_apply_plain(x3, shift, dmean, rstd, weight, bias, act=act)
    groups = shift.shape[1] if shift.dim() == 2 else 0
    _check_x("gn_apply", x3, groups)
    _check_stats("gn_apply", x3, groups, shift=shift, dmean=dmean,
                 rstd=rstd)
    w = _param_f32("gn_apply", weight, x3, "weight")
    b = _param_f32("gn_apply", bias, x3, "bias")
    n, hw, c = x3.shape
    _check_tile("gn_apply", hw, hw_block)
    geo = _two_pass_geometry(x3, groups, hw_block)
    y = torch.empty_like(x3)
    lib = _build.lib()
    with torch.cuda.device(x3.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.apex_gn_apply(
            x3.data_ptr(), shift.data_ptr(), dmean.data_ptr(),
            rstd.data_ptr(), _ptr(w), _ptr(b), y.data_ptr(), n, hw, c,
            groups, hw_block, geo.route_id, geo.rows, geo.threads,
            int(act == "silu"), _DTYPES[x3.dtype], stream)
    _build.launches["gn_apply"] += 1
    _build.check(err, "gn_apply")
    return y


def gn_forward(x3: torch.Tensor, groups: int,
               weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
               act: str = "", algo: str = "auto",
               hw_block: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GroupNorm of x3 ``(n, hw, c)`` by ``algo``: "auto" (one-pass when
    :func:`~apex_tpu_torch.ops.tiling.gn_one_pass_ok` says the (sample,
    group) slab fits the one-pass block's shared memory, else the two-pass
    pair), "one_pass" or "two_pass"; anything else raises ``ValueError``.
    ``hw_block`` sets the two-pass HW tile (validated as in the JAX
    package). Returns ``(y, mean_d, rstd)``, mean_d about
    :func:`gn_shift`."""
    n, hw, c = x3.shape
    if algo == "auto":
        algo = "one_pass" if gn_one_pass_ok(hw, c, groups) else "two_pass"
    elif algo not in ("one_pass", "two_pass"):
        raise ValueError(f"algo must be auto|one_pass|two_pass, got {algo!r}")
    if algo == "one_pass":
        return gn_one_pass(x3, groups, weight, bias, eps=eps, act=act)
    hwb = gn_hw_block(hw, c, hw_block)
    shift = gn_shift(x3, groups)
    psum, psq = gn_stats(x3, shift, hwb)
    dmean, rstd = gn_moments(psum, psq, hw * (c // groups), eps)
    y = gn_apply(x3, shift, dmean, rstd, weight, bias, hwb, act=act)
    return y, dmean, rstd


def group_norm_nhwc_fwd(x: torch.Tensor, num_groups: int,
                        weight: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None,
                        eps: float = 1e-5, act: str = "",
                        algo: str = "auto", hw_block: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward of ``group_norm_nhwc_pallas``: x ``(n, h, w, c)``; returns
    ``(y, mean, rstd)`` with mean / rstd ``(n, groups)`` fp32, through
    :func:`gn_forward` (``algo`` and ``hw_block`` as there)."""
    n, h, w, c = x.shape
    x3 = x.reshape(n, h * w, c).contiguous()
    y, dmean, rstd = gn_forward(x3, num_groups, weight, bias, eps, act, algo,
                                hw_block)
    return y.reshape(n, h, w, c), gn_shift(x3, num_groups) + dmean, rstd
