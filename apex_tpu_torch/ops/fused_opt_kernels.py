"""Flat-buffer LAMB, NovoGrad and Adagrad: the CUDA kernels and their plain
versions.

Counterpart of ``apex_tpu/ops/pallas/fused_opt_kernels.py``
(``row_segment_ids``, ``_per_tensor_sumsq``, ``fused_lamb_flat``,
``fused_novograd_flat``, ``fused_adagrad_flat``). The flat fp32 buffers
are viewed as ``(rows, 128)``; every tensor of the flat layout starts on a
128-element boundary, so each row belongs to one tensor and ``row_ids``
names it (the tail padding rows name ``num_tensors``).

:func:`fused_lamb_flat` runs, as the JAX function does:

1. the global gradient norm and its clip divisor, and the packed scalars
   (device ops only: the step, the norm and the overflow flag never reach
   the host);
2. **stage 1** (:func:`lamb_stage1`, ``csrc/fused_lamb.cu`` for CUDA
   tensors, :func:`lamb_stage1_plain` for CPU ones): the update term u and
   the new moments, in place, plus each row's sum of squares of p and of
   u;
3. the per-tensor norms and trust ratios, plain PyTorch shared by both
   routes: the row sums are added per tensor by :func:`segment_sums`, a
   fixed two-level reduction without atomics, so two runs give the same
   bits;
4. **stage 2** (:func:`lamb_stage2` / :func:`lamb_stage2_plain`):
   ``p -= lr * ratio * u`` in place.

:func:`fused_lamb_flat_plain` is the same with both plain stages on any
device; the plain stages repeat the kernels' operations in their order,
row sums included, so the two agree bit for bit on the card.

:func:`fused_novograd_flat` computes the per-tensor second moments of the
scaled gradients and their denominators in plain PyTorch (row sums of
squares in the LAMB kernel's order, :func:`segment_sums`), as plain XLA
does in the JAX package, then launches one elementwise kernel
(:func:`novograd_update_rows`, ``csrc/fused_novograd.cu``) that reads each
row's denominator through ``row_ids``. :func:`fused_adagrad_flat` is one
elementwise kernel (``csrc/fused_adagrad.cu``). Each has a ``*_plain``
version that repeats the kernel's operations in order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.fused_adam_kernel import _check_flat as _check_same
from apex_tpu_torch.ops.fused_adam_kernel import _dev_scalar
from apex_tpu_torch.utils.flatten import LANE, FlatSpec

LAMB_STAGE1_SCALARS = 10  # [beta1, beta2, beta3, eps, wd, bc1, bc2, clip,
#                            inv_scale, noop]
SEGMENT_CHUNK = 256       # rows per chunk of the per-tensor reduction


def row_segment_ids(spec: FlatSpec, total_size: int,
                    device=None) -> torch.Tensor:
    """``(rows,)`` int32 tensor id of each 128-element row of the flat
    buffer; rows of the tail padding get ``spec.num_leaves``."""
    ids = np.full((total_size // LANE,), spec.num_leaves, np.int32)
    for t, (off, padded) in enumerate(zip(spec.offsets,
                                          spec.padded_sizes)):
        ids[off // LANE:(off + padded) // LANE] = t
    return torch.from_numpy(ids).to(device)


@dataclasses.dataclass(frozen=True)
class RowSegments:
    """Index tensors of :func:`segment_sums` for one ``row_ids``: the rows
    are cut into chunks of ``SEGMENT_CHUNK``; ``chunk_idx (T, C)`` names
    the chunks that lie wholly inside each tensor and ``part_idx (T, P)``
    its rows outside those chunks, both padded with an index that reads
    0."""

    num_tensors: int
    rows: int
    chunk_idx: torch.Tensor
    part_idx: torch.Tensor


def row_segments(row_ids: torch.Tensor, num_tensors: int) -> RowSegments:
    """The :class:`RowSegments` of sorted ``row_ids`` (one host copy of
    them; build it once per layout)."""
    ids = row_ids.detach().cpu().numpy()
    rows, c = ids.shape[0], SEGMENT_CHUNK
    nch = -(-rows // c)
    chunks, parts = [], []
    for t in range(num_tensors):
        a = int(np.searchsorted(ids, t, "left"))
        b = int(np.searchsorted(ids, t, "right"))
        j0, j1 = -(-a // c), b // c
        if j1 < j0:  # the tensor lies inside one chunk
            j1 = j0
        chunks.append(list(range(j0, j1)))
        parts.append(list(range(a, min(j0 * c, b)))
                     + list(range(max(j1 * c, j0 * c), b)))

    def pad(lists, fill):
        width = max([1] + [len(x) for x in lists])
        out = np.full((len(lists), width), fill, np.int64)
        for i, x in enumerate(lists):
            out[i, :len(x)] = x
        return torch.from_numpy(out).to(row_ids.device)

    return RowSegments(num_tensors, rows, pad(chunks, nch),
                       pad(parts, nch * c))


def segment_sums(row_vals: torch.Tensor, seg: RowSegments) -> torch.Tensor:
    """``(T,)`` per-tensor sums of per-row fp32 values: chunk sums, then
    the chunks and the leftover rows of each tensor gathered into padded
    rows and summed. Only gathers and sums over a dimension: the same bits
    on every run, on every device type's own reduction."""
    c = SEGMENT_CHUNK
    nch = -(-seg.rows // c)
    vals = torch.cat([row_vals, row_vals.new_zeros(nch * c - seg.rows + 1)])
    chunk = vals[:nch * c].view(nch, c).sum(dim=1)
    chunk = torch.cat([chunk, chunk.new_zeros(1)])
    return chunk[seg.chunk_idx].sum(dim=1) + vals[seg.part_idx].sum(dim=1)


def _row_sumsq(x: torch.Tensor) -> torch.Tensor:
    """Per-row sums of squares in the kernel's order: per lane of 4
    elements ``((a^2 + b^2) + c^2) + d^2``, then the warp's butterfly over
    32 lanes (lane i adds lane i + w for w = 16, 8, 4, 2, 1)."""
    sq = x.view(-1, 32, 4)
    sq = sq * sq
    s = ((sq[..., 0] + sq[..., 1]) + sq[..., 2]) + sq[..., 3]
    for w in (16, 8, 4, 2, 1):
        s = s[:, :w] + s[:, w:2 * w]
    return s[:, 0]


def lamb_stage1_plain(p, g, m, v, u, row_p, row_u, scal1: torch.Tensor,
                      adam_w: bool) -> None:
    """``_lamb_stage1_kernel`` in plain PyTorch: writes u, the per-row
    sums of squares of p and u, and (unless noop) m and v, in place."""
    beta1, beta2, beta3, eps, wd, bc1, bc2, clip, inv_scale, noop = \
        scal1.unbind(0)
    gg = g * inv_scale / clip
    if not adam_w:
        gg = gg + wd * p
    m_new = beta1 * m + beta3 * gg
    v_new = beta2 * v + (1.0 - beta2) * gg * gg
    upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    if adam_w:
        upd = upd + wd * p
    keep = noop != 0.0
    u.copy_(torch.where(keep, 0.0, upd))
    m.copy_(torch.where(keep, m, m_new))
    v.copy_(torch.where(keep, v, v_new))
    row_p.copy_(_row_sumsq(p))
    row_u.copy_(_row_sumsq(u))


def lamb_stage2_plain(p, u, ratios: torch.Tensor, row_ids: torch.Tensor,
                      scal2: torch.Tensor) -> None:
    """``_lamb_stage2_kernel`` in plain PyTorch: ``p -= (lr * ratio) * u``
    in place, nothing when noop."""
    lr, noop = scal2.unbind(0)
    t = lr * ratios[row_ids.long()]
    p_new = p.view(-1, LANE) - t[:, None] * u.view(-1, LANE)
    p.copy_(torch.where(noop != 0.0, p, p_new.view(-1)))


def _check_flat(name: str, p: torch.Tensor, others) -> None:
    n = p.numel()
    for what, t in (("p", p),) + tuple(others):
        if t.dim() != 1 or t.dtype != torch.float32 \
                or t.device != p.device or not t.is_contiguous() \
                or t.numel() != n or t.data_ptr() % 16:
            raise ValueError(
                f"{name}: {what} must be a contiguous, 16-byte aligned 1-D "
                f"float32 tensor of {n} elements on {p.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if n % LANE:
        raise ValueError(f"{name}: {n} elements is not a multiple of {LANE}")


def lamb_stage1(p, g, m, v, u, row_p, row_u, scal1: torch.Tensor,
                adam_w: bool) -> None:
    """Stage 1 over flat fp32 buffers of ``rows * 128`` elements: the
    kernel for CUDA tensors, :func:`lamb_stage1_plain` for CPU tensors."""
    if p.device.type == "cpu":
        return lamb_stage1_plain(p, g, m, v, u, row_p, row_u, scal1, adam_w)
    if p.device.type != "cuda":
        raise ValueError(f"lamb_stage1: unsupported device {p.device}")
    _check_flat("lamb_stage1", p, (("g", g), ("m", m), ("v", v),
                                   ("u", u)))
    rows = p.numel() // LANE
    for what, t, n in (("row_p", row_p, rows), ("row_u", row_u, rows),
                       ("scal1", scal1, LAMB_STAGE1_SCALARS)):
        if t.dtype != torch.float32 or t.device != p.device \
                or not t.is_contiguous() or t.numel() != n:
            raise ValueError(f"lamb_stage1: {what} must be a contiguous "
                             f"float32 tensor of {n} elements on {p.device}")
    lib = _build.lib()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.apex_lamb_stage1(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            u.data_ptr(), row_p.data_ptr(), row_u.data_ptr(),
            scal1.data_ptr(), rows, int(adam_w), stream)
    _build.launches["lamb_stage1"] += 1
    _build.check(err, "lamb_stage1")
    # written through raw pointers: tell autograd's version counters
    for t in (m, v, u):
        torch.autograd.graph.increment_version(t)


def lamb_stage2(p, u, ratios: torch.Tensor, row_ids: torch.Tensor,
                scal2: torch.Tensor) -> None:
    """Stage 2: the kernel for CUDA tensors, :func:`lamb_stage2_plain` for
    CPU tensors."""
    if p.device.type == "cpu":
        return lamb_stage2_plain(p, u, ratios, row_ids, scal2)
    if p.device.type != "cuda":
        raise ValueError(f"lamb_stage2: unsupported device {p.device}")
    _check_flat("lamb_stage2", p, (("u", u),))
    rows = p.numel() // LANE
    if row_ids.dtype != torch.int32 or row_ids.numel() != rows \
            or row_ids.device != p.device or not row_ids.is_contiguous():
        raise ValueError(f"lamb_stage2: row_ids must be a contiguous int32 "
                         f"tensor of {rows} rows on {p.device}")
    for what, t in (("ratios", ratios), ("scal2", scal2)):
        if t.dtype != torch.float32 or t.device != p.device \
                or not t.is_contiguous():
            raise ValueError(f"lamb_stage2: {what} must be a contiguous "
                             f"float32 tensor on {p.device}")
    lib = _build.lib()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.apex_lamb_stage2(p.data_ptr(), u.data_ptr(),
                                   ratios.data_ptr(), row_ids.data_ptr(),
                                   scal2.data_ptr(), rows, stream)
    _build.launches["lamb_stage2"] += 1
    _build.check(err, "lamb_stage2")
    torch.autograd.graph.increment_version(p)


def _lamb(p, g, m, v, row_ids, num_tensors, lr, beta1, beta2, eps,
          weight_decay, step, bias_correction, grad_averaging,
          max_grad_norm, use_nvlamb, adam_w_mode, inv_scale, found_inf,
          segments, stage1, stage2) -> torch.Tensor:
    dev = p.device
    if segments is None:
        segments = row_segments(row_ids, num_tensors)
    if segments.num_tensors != num_tensors \
            or segments.rows * LANE != p.numel():
        raise ValueError("fused_lamb_flat: segments were built for another "
                         "layout")
    g32 = g if not torch.is_tensor(inv_scale) and inv_scale == 1.0 \
        else g * _dev_scalar(inv_scale, dev)
    gnorm = torch.sqrt((g32 * g32).sum())
    del g32
    if max_grad_norm is not None and max_grad_norm > 0:
        clip = torch.clamp_min(gnorm / max_grad_norm, 1.0).reshape(1)
    else:
        clip = _dev_scalar(1.0, dev)
    b1, b2 = _dev_scalar(beta1, dev), _dev_scalar(beta2, dev)
    if bias_correction:
        stepf = _dev_scalar(step, dev)
        bc1 = 1.0 - torch.pow(b1, stepf)
        bc2 = 1.0 - torch.pow(b2, stepf)
    else:
        bc1 = bc2 = _dev_scalar(1.0, dev)
    noop = _dev_scalar(found_inf, dev)
    scal1 = torch.cat([b1, b2,
                       _dev_scalar(1.0 - beta1 if grad_averaging else 1.0,
                                   dev),
                       _dev_scalar(eps, dev), _dev_scalar(weight_decay, dev),
                       bc1, bc2, clip, _dev_scalar(inv_scale, dev), noop])
    rows = p.numel() // LANE
    u = torch.empty_like(p)
    row_p = torch.empty(rows, dtype=torch.float32, device=dev)
    row_u = torch.empty_like(row_p)
    stage1(p, g, m, v, u, row_p, row_u, scal1, adam_w_mode)
    w_norm = torch.sqrt(segment_sums(row_p, segments))
    u_norm = torch.sqrt(segment_sums(row_u, segments))
    if use_nvlamb:
        ratios = torch.where(u_norm > 0, w_norm / u_norm, 1.0)
    else:
        ratios = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                             1.0)
    ratios = torch.cat([ratios, ratios.new_ones(1)])  # the padding rows
    stage2(p, u, ratios, row_ids,
           torch.cat([_dev_scalar(lr, dev), noop]))
    return gnorm


def fused_lamb_flat(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                    v: torch.Tensor, row_ids: torch.Tensor, *,
                    num_tensors: int, lr, beta1: float = 0.9,
                    beta2: float = 0.999, eps: float = 1e-6,
                    weight_decay: float = 0.01, step=1,
                    bias_correction: bool = True,
                    grad_averaging: bool = True,
                    max_grad_norm: float = 1.0, use_nvlamb: bool = False,
                    adam_w_mode: bool = True, inv_scale=1.0,
                    found_inf=False,
                    segments: Optional[RowSegments] = None
                    ) -> torch.Tensor:
    """One LAMB step over flat 1-D fp32 buffers of a multiple of 128
    elements, p, m and v updated in place; returns the global gradient
    norm (fp32, on the device). ``row_ids`` comes from
    :func:`row_segment_ids`; ``segments`` (:func:`row_segments` of it,
    built once) saves a host copy of ``row_ids`` per call. ``lr``,
    ``step``, ``inv_scale`` and ``found_inf`` may be device tensors. CUDA
    tensors launch the two kernels; CPU tensors take the plain stages."""
    return _lamb(p, g, m, v, row_ids, num_tensors, lr, beta1, beta2, eps,
                 weight_decay, step, bias_correction, grad_averaging,
                 max_grad_norm, use_nvlamb, adam_w_mode, inv_scale,
                 found_inf, segments, lamb_stage1, lamb_stage2)


def fused_lamb_flat_plain(p: torch.Tensor, g: torch.Tensor,
                          m: torch.Tensor, v: torch.Tensor,
                          row_ids: torch.Tensor, *, num_tensors: int, lr,
                          beta1: float = 0.9, beta2: float = 0.999,
                          eps: float = 1e-6, weight_decay: float = 0.01,
                          step=1, bias_correction: bool = True,
                          grad_averaging: bool = True,
                          max_grad_norm: float = 1.0,
                          use_nvlamb: bool = False, adam_w_mode: bool = True,
                          inv_scale=1.0, found_inf=False,
                          segments: Optional[RowSegments] = None
                          ) -> torch.Tensor:
    """:func:`fused_lamb_flat` with both stages in plain PyTorch, on any
    device."""
    return _lamb(p, g, m, v, row_ids, num_tensors, lr, beta1, beta2, eps,
                 weight_decay, step, bias_correction, grad_averaging,
                 max_grad_norm, use_nvlamb, adam_w_mode, inv_scale,
                 found_inf, segments, lamb_stage1_plain, lamb_stage2_plain)


# ---------------------------------------------------------------- NovoGrad

NOVOGRAD_SCALARS = 7  # [lr, beta1, beta3, wd, bc1, inv_scale, noop]


def novograd_update_rows_plain(p, g, m, denom: torch.Tensor,
                               row_ids: torch.Tensor,
                               scal: torch.Tensor) -> None:
    """``_novograd_kernel`` in plain PyTorch: each row's gradient divided
    by its tensor's denominator (``denom[row_ids]``), then the momentum and
    parameter update, in place; nothing when noop."""
    lr, beta1, beta3, wd, bc1, inv_scale, noop = scal.unbind(0)
    p2, m2 = p.view(-1, LANE), m.view(-1, LANE)
    gg = g.view(-1, LANE) * inv_scale
    gg = gg / denom[row_ids.long()][:, None]
    gg = gg + wd * p2
    m_new = beta1 * m2 + beta3 * gg
    p_new = p2 - lr * (m_new / bc1)
    keep = noop != 0.0
    p2.copy_(torch.where(keep, p2, p_new))
    m2.copy_(torch.where(keep, m2, m_new))


def novograd_update_rows(p, g, m, denom: torch.Tensor,
                         row_ids: torch.Tensor, scal: torch.Tensor) -> None:
    """The NovoGrad elementwise update over flat fp32 buffers of ``rows *
    128`` elements: the kernel for CUDA tensors,
    :func:`novograd_update_rows_plain` for CPU tensors."""
    if p.device.type == "cpu":
        return novograd_update_rows_plain(p, g, m, denom, row_ids, scal)
    if p.device.type != "cuda":
        raise ValueError(f"fused_novograd: unsupported device {p.device}")
    _check_flat("fused_novograd", p, (("g", g), ("m", m)))
    rows = p.numel() // LANE
    if row_ids.dtype != torch.int32 or row_ids.numel() != rows \
            or row_ids.device != p.device or not row_ids.is_contiguous():
        raise ValueError(f"fused_novograd: row_ids must be a contiguous "
                         f"int32 tensor of {rows} rows on {p.device}")
    for what, t, n in (("denom", denom, None),
                       ("scal", scal, NOVOGRAD_SCALARS)):
        if t.dtype != torch.float32 or t.device != p.device \
                or not t.is_contiguous() or (n is not None
                                             and t.numel() != n):
            raise ValueError(f"fused_novograd: {what} must be a contiguous "
                             f"float32 tensor on {p.device}")
    lib = _build.lib()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.apex_fused_novograd(p.data_ptr(), g.data_ptr(),
                                      m.data_ptr(), denom.data_ptr(),
                                      row_ids.data_ptr(), scal.data_ptr(),
                                      rows, stream)
    _build.launches["fused_novograd"] += 1
    _build.check(err, "fused_novograd")
    # written through raw pointers: tell autograd's version counters
    for t in (p, m):
        torch.autograd.graph.increment_version(t)


def _novograd(p, g, m, v, row_ids, num_tensors, lr, beta1, beta2, eps,
              weight_decay, step, grad_averaging, bias_correction,
              norm_type, init_zero, inv_scale, found_inf, segments,
              update_rows):
    if norm_type != 2:
        raise NotImplementedError(
            "fused_novograd_flat: norm_type=0 (inf-norm) rides the tree "
            "path (optimizers/functional.py novograd_update)")
    dev = p.device
    if segments is None:
        segments = row_segments(row_ids, num_tensors)
    if segments.num_tensors != num_tensors \
            or segments.rows * LANE != p.numel() or v.numel() != num_tensors:
        raise ValueError("fused_novograd_flat: segments or v were built for "
                         "another layout")
    stepf = _dev_scalar(step, dev)
    one = _dev_scalar(1.0, dev)
    if bias_correction:
        bc1 = one - torch.pow(_dev_scalar(beta1, dev), stepf)
        bc2 = one - torch.pow(_dev_scalar(beta2, dev), stepf)
    else:
        bc1 = bc2 = one
    noop = _dev_scalar(found_inf, dev)
    inv = _dev_scalar(inv_scale, dev)
    # the per-tensor second moments of the scaled gradients
    g32 = g if not torch.is_tensor(inv_scale) and inv_scale == 1.0 \
        else g * inv
    gn_sq = segment_sums(_row_sumsq(g32), segments)
    del g32
    v_upd = beta2 * v + (1.0 - beta2) * gn_sq
    first = stepf <= 1.0
    v_new = torch.where(first, (1.0 - beta2) * gn_sq if init_zero else gn_sq,
                        v_upd)
    denom = torch.cat([torch.sqrt(v_new / bc2) + eps, one])  # padding rows
    v.copy_(torch.where(noop != 0.0, v, v_new))
    scal = torch.cat([_dev_scalar(lr, dev), _dev_scalar(beta1, dev),
                      _dev_scalar(1.0 - beta1 if grad_averaging else 1.0,
                                  dev),
                      _dev_scalar(weight_decay, dev), bc1, inv, noop])
    update_rows(p, g, m, denom, row_ids, scal)
    return p, m, v


def fused_novograd_flat(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                        v_per_tensor: torch.Tensor, row_ids: torch.Tensor,
                        *, num_tensors: int, lr, beta1: float = 0.95,
                        beta2: float = 0.98, eps: float = 1e-8,
                        weight_decay: float = 0.0, step=1,
                        grad_averaging: bool = False,
                        bias_correction: bool = False, norm_type: int = 2,
                        init_zero: bool = False, inv_scale=1.0,
                        found_inf=False,
                        segments: Optional[RowSegments] = None):
    """One NovoGrad step over flat 1-D fp32 buffers of a multiple of 128
    elements with per-tensor second moments ``v_per_tensor (num_tensors,)``;
    p, m and v are updated in place and returned as ``(p, m, v)``. ``lr``,
    ``step``, ``inv_scale`` and ``found_inf`` may be device tensors. CUDA
    tensors launch the kernel; CPU tensors take the plain update."""
    return _novograd(p, g, m, v_per_tensor, row_ids, num_tensors, lr, beta1,
                     beta2, eps, weight_decay, step, grad_averaging,
                     bias_correction, norm_type, init_zero, inv_scale,
                     found_inf, segments, novograd_update_rows)


def fused_novograd_flat_plain(p: torch.Tensor, g: torch.Tensor,
                              m: torch.Tensor, v_per_tensor: torch.Tensor,
                              row_ids: torch.Tensor, *, num_tensors: int,
                              lr, beta1: float = 0.95, beta2: float = 0.98,
                              eps: float = 1e-8, weight_decay: float = 0.0,
                              step=1, grad_averaging: bool = False,
                              bias_correction: bool = False,
                              norm_type: int = 2, init_zero: bool = False,
                              inv_scale=1.0, found_inf=False,
                              segments: Optional[RowSegments] = None):
    """:func:`fused_novograd_flat` with the plain update, on any device."""
    return _novograd(p, g, m, v_per_tensor, row_ids, num_tensors, lr, beta1,
                     beta2, eps, weight_decay, step, grad_averaging,
                     bias_correction, norm_type, init_zero, inv_scale,
                     found_inf, segments, novograd_update_rows_plain)


# ----------------------------------------------------------------- Adagrad


def pack_adagrad_scalars(lr, eps, weight_decay, inv_scale, found_inf, *,
                         device: torch.device) -> torch.Tensor:
    """``[lr, eps, wd, inv_scale, noop]`` as float32 on ``device``."""
    return torch.cat([_dev_scalar(x, device) for x in (
        lr, eps, weight_decay, inv_scale, found_inf)])


def fused_adagrad_flat_plain(p: torch.Tensor, g: torch.Tensor,
                             h: torch.Tensor, *, lr, eps: float = 1e-10,
                             weight_decay: float = 0.0,
                             adagrad_w_mode: bool = False, inv_scale=1.0,
                             found_inf=False):
    """:func:`fused_adagrad_flat` in plain PyTorch, on any device: the
    arithmetic of ``_adagrad_kernel`` in the kernel's order, in place; a
    set ``found_inf`` keeps p and h bit for bit."""
    lr, eps, wd, inv_scale, noop = pack_adagrad_scalars(
        lr, eps, weight_decay, inv_scale, found_inf,
        device=p.device).unbind(0)
    g = g * inv_scale
    if not adagrad_w_mode:
        g = g + wd * p
    h_new = h + g * g
    upd = g / (torch.sqrt(h_new) + eps)
    if adagrad_w_mode:
        upd = upd + wd * p
    p_new = p - lr * upd
    keep = noop != 0.0
    p.copy_(torch.where(keep, p, p_new))
    h.copy_(torch.where(keep, h, h_new))
    return p, h


def fused_adagrad_flat(p: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                       *, lr, eps: float = 1e-10, weight_decay: float = 0.0,
                       adagrad_w_mode: bool = False, inv_scale=1.0,
                       found_inf=False):
    """One Adagrad (``adagrad_w_mode``: decoupled weight decay) step over
    flat 1-D fp32 buffers, in place; returns ``(p, h)``. CUDA tensors
    launch the kernel (contiguous, one length, one card); CPU tensors take
    the plain version."""
    kw = dict(lr=lr, eps=eps, weight_decay=weight_decay,
              adagrad_w_mode=adagrad_w_mode, inv_scale=inv_scale,
              found_inf=found_inf)
    if p.device.type == "cpu":
        return fused_adagrad_flat_plain(p, g, h, **kw)
    if p.device.type != "cuda":
        raise ValueError(f"fused_adagrad_flat: unsupported device {p.device}")
    _check_same("fused_adagrad_flat", p, (("p", p, torch.float32),
                                          ("g", g, torch.float32),
                                          ("h", h, torch.float32)))
    scal = pack_adagrad_scalars(lr, eps, weight_decay, inv_scale, found_inf,
                                device=p.device)
    lib = _build.lib()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.apex_fused_adagrad(p.data_ptr(), g.data_ptr(),
                                     h.data_ptr(), scal.data_ptr(),
                                     p.numel(), int(adagrad_w_mode), stream)
    _build.launches["fused_adagrad"] += 1
    _build.check(err, "fused_adagrad_flat")
    for t in (p, h):
        torch.autograd.graph.increment_version(t)
    return p, h
