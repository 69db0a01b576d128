"""Decode attention over the slot KV cache — counterpart of
``apex_tpu/serve/attention.py`` (``resolve_block_k``, ``_combine_chunks``,
``cached_attention``).

One query token per slot against that slot's cached keys and values. The
key axis is the cache's static ``max_len``; reachability is a mask
(``key_pos <= position``), so a slot's result depends only on that slot's
bytes. The softmax is computed in chunks of ``block_k`` cached rows, in
the JAX package's order: the row max over all chunks first, then the
exponentials summed chunk by chunk. All math is fp32 with masked scores at
-1e30; the output comes back in q's dtype. This is plain PyTorch, as the
JAX version is plain XLA; a hand-written decode kernel is later work.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from apex_tpu_torch.ops.tiling import decode_attention_block

NEG_INF = -1e30


def resolve_block_k(max_len: int, block_k: Optional[int] = None) -> int:
    """The decode KV chunk: an explicit value (it must divide
    ``max_len``), else the committed heuristic. The JAX package's tuner
    cache is not ported."""
    if block_k is not None:
        bk = int(block_k)
        if bk <= 0 or max_len % bk:
            raise ValueError(
                f"block_k={bk} must be positive and divide the cache "
                f"max_len={max_len} (the chunked softmax tiles the static "
                f"key axis exactly)")
        return bk
    return decode_attention_block(max_len)


def _combine_chunks(q: torch.Tensor, positions: torch.Tensor, L: int,
                    bk: int, scale: float,
                    fetch: Callable[[int], Tuple[torch.Tensor,
                                                 torch.Tensor]]
                    ) -> torch.Tensor:
    """``fetch(i)`` returns chunk ``i``'s ``(k_rows, v_rows)`` as
    ``[b, block_k, heads, head_dim]``. The global row max equals the max
    over chunk maxima; only the sum order depends on ``block_k``."""
    q32 = q.float()
    pos = positions.long()[:, None, None]
    chunks = []
    for i in range(L // bk):
        ks, vs = fetch(i)
        sc = torch.einsum("bhd,bkhd->bhk", q32, ks.float()) * scale
        kpos = torch.arange(i * bk, (i + 1) * bk, device=q.device)
        reach = kpos[None, None, :] <= pos
        chunks.append((sc.masked_fill(~reach, NEG_INF), reach, vs))
    m = chunks[0][0].amax(dim=-1, keepdim=True)
    for sc, _, _ in chunks[1:]:
        m = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
    b, h, d = q.shape
    num = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
    den = torch.zeros((b, h), dtype=torch.float32, device=q.device)
    for sc, reach, vs in chunks:
        e = torch.where(reach, torch.exp(sc - m), 0.0)
        den = den + e.sum(dim=-1)
        num = num + torch.einsum("bhk,bkhd->bhd", e, vs.float())
    return (num / den[..., None]).to(q.dtype)


def cached_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, positions: torch.Tensor, *,
                     scale: Optional[float] = None,
                     block_k: Optional[int] = None) -> torch.Tensor:
    """Single-token attention over slot-contiguous cached K/V.

    ``q``: ``[num_slots, heads, head_dim]``; ``k_cache`` / ``v_cache``:
    ``[num_slots, max_len, heads, head_dim]``; ``positions``:
    ``[num_slots]`` — slot ``b`` attends to cached positions ``0 ..
    positions[b]`` inclusive. Returns ``[num_slots, heads, head_dim]`` in
    q's dtype."""
    _, L, _, d = k_cache.shape
    bk = resolve_block_k(L, block_k)
    s = scale if scale is not None else 1.0 / (d ** 0.5)

    def fetch(i):
        sl = slice(i * bk, (i + 1) * bk)
        return k_cache[:, sl], v_cache[:, sl]

    return _combine_chunks(q, positions, L, bk, s, fetch)
