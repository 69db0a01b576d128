"""The slot KV cache — counterpart of ``apex_tpu/serve/kv_cache.py``
(``KVCache`` and its mutators; the paged pool is a later slice).

``k`` / ``v`` are ``[n_layer, num_slots, max_len, heads, head_dim]`` and
``lengths`` is ``[num_slots]`` int32. Shapes never change after
:func:`init_cache`; admission, completion and eviction move values only.

Unlike the JAX package's pure functions, the mutators here update the
cache **in place** (a decode step would otherwise copy the whole cache)
and return the same object for the caller's convenience. The semantics
are the JAX ones: a masked-off slot gets its current token written back,
so its bytes are untouched; positions are clipped into ``[0, max_len)``;
eviction only moves ``lengths``, and the attention mask (``key_pos <=
position``) makes the stale rows unreachable.
"""

from __future__ import annotations

import dataclasses

import torch

from apex_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor        # [n_layer, num_slots, max_len, heads, head_dim]
    v: torch.Tensor        # same shape as k
    lengths: torch.Tensor  # [num_slots] int32 — tokens resident per slot

    @property
    def num_slots(self) -> int:
        return self.k.shape[1]

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_cache(n_layer: int, num_slots: int, max_len: int, heads: int,
               head_dim: int, dtype: torch.dtype = torch.float32, *,
               device: DeviceLike = None) -> KVCache:
    """An empty cache of zeros on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    shape = (n_layer, num_slots, max_len, heads, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev),
                   lengths=torch.zeros(num_slots, dtype=torch.int32,
                                       device=dev))


def write_token(cache: KVCache, layer: int, k_tok: torch.Tensor,
                v_tok: torch.Tensor, positions: torch.Tensor,
                mask: torch.Tensor) -> KVCache:
    """Write one token's K/V per slot at ``positions[slot]`` where
    ``mask[slot]``, in place. ``k_tok`` / ``v_tok``: ``[num_slots, heads,
    head_dim]``; ``positions``: ``[num_slots]`` int; ``mask``:
    ``[num_slots]`` bool."""
    slots = torch.arange(cache.num_slots, device=cache.k.device)
    pos = positions.long().clamp(0, cache.max_len - 1)
    keep = mask[:, None, None]
    for buf, tok in ((cache.k[layer], k_tok), (cache.v[layer], v_tok)):
        cur = buf[slots, pos]
        buf[slots, pos] = torch.where(keep, tok.to(buf.dtype), cur)
    return cache


def advance(cache: KVCache, mask: torch.Tensor) -> KVCache:
    """Bump ``lengths`` by one for masked slots (after a decode append)."""
    cache.lengths += mask.to(torch.int32)
    return cache


def reset_slots(cache: KVCache, mask: torch.Tensor) -> KVCache:
    """Zero masked slots' lengths (the insertion prologue)."""
    cache.lengths.masked_fill_(mask, 0)
    return cache


def set_lengths(cache: KVCache, mask: torch.Tensor,
                new_lengths: torch.Tensor) -> KVCache:
    """Set masked slots' lengths (the prefill epilogue)."""
    cache.lengths.copy_(torch.where(mask, new_lengths.to(torch.int32),
                                    cache.lengths))
    return cache


def evict_slots(cache: KVCache, mask: torch.Tensor) -> KVCache:
    """Free masked slots: only ``lengths`` moves, the data stays in place
    and the next insert overwrites it."""
    return reset_slots(cache, mask)
