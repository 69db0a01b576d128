"""Fused rotary positional embedding — counterpart of
``apex_tpu/transformer/rope.py`` (apex's
``fused_rotary_positional_embedding``).

Variants:

- :func:`fused_rope` — sbhd ``t (s, b, h, d)``, ``freqs (s_max, 1, 1, d2)``
  or ``(s_max, d2)``;
- :func:`fused_rope_cached` — precomputed cos / sin tables;
- :func:`fused_rope_thd` — packed sequences ``t (total, h, d)`` with
  ``cu_seqlens``;
- :func:`fused_rope_2d` — image rotary, rows then columns.

Only the first ``d2`` channels rotate (NeoX rotate-half pairing: ``out =
x * cos(f) + rot_half(x) * sin(f)``, ``rot_half(x) = [-x2, x1]``); the
trailing ``d - d2`` pass through. Math in fp32, the IO dtype kept. The
backward is an ``autograd.Function`` that rotates the cotangent by ``-f``
(``_rope_cached`` of the JAX module), not autograd through the products.
The JAX package has no Pallas kernel for RoPE, so there is none here:
these are PyTorch ops.
"""

from __future__ import annotations

from typing import Union

import torch

Offset = Union[int, torch.Tensor]


def _rot_half(x: torch.Tensor) -> torch.Tensor:
    d2 = x.shape[-1]
    return torch.cat([-x[..., d2 // 2:], x[..., : d2 // 2]], dim=-1)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    """x ``(..., d)``; cos / sin fp32, broadcastable to ``(..., d2)``,
    ``d2 <= d``."""
    d2 = cos.shape[-1]
    x32 = x.float()
    head = x32[..., :d2]
    out = head * cos + _rot_half(head) * sin
    if d2 < x.shape[-1]:
        out = torch.cat([out, x32[..., d2:]], dim=-1)
    return out.to(x.dtype)


class _RopeCached(torch.autograd.Function):
    """Rotation by the tables; the backward rotates by -f (R(-f) is R(f)
    transposed) and gives the tables no gradient."""

    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.save_for_backward(cos, sin)
        return _apply_rope(x, cos, sin)

    @staticmethod
    def backward(ctx, dy):
        cos, sin = ctx.saved_tensors
        return _apply_rope(dy, cos, -sin), None, None


def _offset_rows(table: torch.Tensor, position_offset: Offset,
                 s: int) -> torch.Tensor:
    """Rows ``position_offset .. position_offset + s`` of a table whose
    axis 0 is the position. The start is clamped into ``[0, len - s]`` as
    ``jax.lax.dynamic_slice`` clamps it. A tensor offset (a 0-d integer
    tensor, e.g. a decode step's position on the card) is never read on
    the host: the rows are gathered at ``offset + arange(s)``."""
    n = table.shape[0]
    if isinstance(position_offset, torch.Tensor):
        start = position_offset.to(table.device, torch.long).clamp(
            0, max(n - s, 0))
        idx = start + torch.arange(s, device=table.device)
        return table.index_select(0, idx)
    start = min(max(int(position_offset), 0), max(n - s, 0))
    return table[start:start + s]


def fused_rope(t: torch.Tensor, freqs: torch.Tensor,
               transpose_output_memory: bool = False, *,
               position_offset: Offset = 0) -> torch.Tensor:
    """sbhd variant: ``t (s, b, h, d)``, ``freqs (s_max, 1, 1, d2)`` or
    ``(s_max, d2)``; token row j rotates by frequency row ``position_offset
    + j``. ``transpose_output_memory`` is apex's memory-layout knob,
    accepted and ignored as in the JAX package."""
    if freqs.dim() == 2:
        freqs = freqs[:, None, None, :]
    freqs = _offset_rows(freqs, position_offset, t.shape[0]).float()
    return _RopeCached.apply(t, torch.cos(freqs), torch.sin(freqs))


def fused_rope_cached(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                      *, position_offset: Offset = 0) -> torch.Tensor:
    """Cached-tables variant: cos / sin indexed at the tokens' positions
    (axis 0), same offset contract as :func:`fused_rope`."""
    while cos.dim() < t.dim():
        cos = cos.unsqueeze(1)
        sin = sin.unsqueeze(1)
    cos = _offset_rows(cos, position_offset, t.shape[0]).float()
    sin = _offset_rows(sin, position_offset, t.shape[0]).float()
    return _RopeCached.apply(t, cos, sin)


def fused_rope_thd(t: torch.Tensor, cu_seqlens: torch.Tensor,
                   freqs: torch.Tensor) -> torch.Tensor:
    """Packed variant: ``t (total, h, d)``, ``cu_seqlens (b + 1,)`` the
    sequences' cumulative starts; each token rotates by its position
    within its own sequence."""
    total = t.shape[0]
    cu = cu_seqlens.to(t.device, torch.long)
    tok = torch.arange(total, device=t.device)
    seq = (torch.searchsorted(cu, tok, right=True) - 1).clamp(
        0, cu.shape[0] - 2)
    pos = tok - cu[seq]
    if freqs.dim() > 2:
        freqs = freqs.reshape(freqs.shape[0], freqs.shape[-1])
    f = freqs.float()[pos]
    return _RopeCached.apply(t, torch.cos(f)[:, None, :],
                             torch.sin(f)[:, None, :])


def fused_rope_2d(t: torch.Tensor, img_h: int, img_w: int,
                  freqs_h: torch.Tensor, freqs_w: torch.Tensor
                  ) -> torch.Tensor:
    """Image variant: ``t (b, img_h * img_w, h, d)``; the first ``d2h``
    channels rotate by the row frequency, the next ``d2w`` by the column
    frequency, the rest pass through."""
    b, s, h, d = t.shape
    if s != img_h * img_w:
        raise ValueError(f"fused_rope_2d: sequence {s} != img_h * img_w = "
                         f"{img_h * img_w}")
    if freqs_h.dim() > 2:
        freqs_h = freqs_h.reshape(freqs_h.shape[-2], freqs_h.shape[-1])
        freqs_w = freqs_w.reshape(freqs_w.shape[-2], freqs_w.shape[-1])
    d2h, d2w = freqs_h.shape[-1], freqs_w.shape[-1]
    fh = freqs_h.float()[:img_h].repeat_interleave(img_w, dim=0)
    fw = freqs_w.float()[:img_w].repeat(img_h, 1)
    out_h = _RopeCached.apply(t[..., :d2h], torch.cos(fh)[None, :, None, :],
                              torch.sin(fh)[None, :, None, :])
    out_w = _RopeCached.apply(t[..., d2h:d2h + d2w],
                              torch.cos(fw)[None, :, None, :],
                              torch.sin(fw)[None, :, None, :])
    return torch.cat([out_h, out_w, t[..., d2h + d2w:]], dim=-1)
