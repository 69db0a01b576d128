"""Flatten / unflatten — counterpart of ``apex_tpu/utils/flatten.py``.

One contiguous 1-D buffer per group of tensors: the layout the fused
optimizer kernel updates in one launch. Offsets stay aligned to 128
elements and the gaps are zero, exactly as in the JAX package, so the
flat layout (and its zero padding) is the same in both.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import torch

from apex_tpu_torch.utils.tree import tree_flatten, tree_unflatten

LANE = 128  # per-leaf offsets are aligned to this many elements


def plan_flat(sizes: Sequence[int], align: int = LANE
              ) -> Tuple[List[int], List[int], int]:
    """``(offsets, padded_sizes, total)``: each leaf (at least one element)
    padded up to a multiple of ``align``, laid end to end — the Python
    planner of ``apex_tpu/_native/api.py`` ``plan_flat``."""
    offsets, padded, off = [], [], 0
    for s in sizes:
        p = (max(int(s), 1) + align - 1) // align * align
        offsets.append(off)
        padded.append(p)
        off += p
    return offsets, padded, off


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Static packing plan for a pytree of tensors into one flat buffer."""

    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]
    padded_sizes: Tuple[int, ...]
    total_size: int
    treedef: Any = None

    @property
    def num_leaves(self) -> int:
        return len(self.shapes)


def flat_spec(tensors: Any, align: int = LANE) -> FlatSpec:
    """The packing plan of a tensor, a list or a (nested) dict of them."""
    leaves, treedef = tree_flatten(tensors)
    offsets, padded, total = plan_flat([t.numel() for t in leaves], align)
    return FlatSpec(shapes=tuple(tuple(t.shape) for t in leaves),
                    dtypes=tuple(t.dtype for t in leaves),
                    offsets=tuple(offsets), padded_sizes=tuple(padded),
                    total_size=total, treedef=treedef)


def _round_up(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def flatten(tensors: Any, spec: Optional[FlatSpec] = None,
            dtype: Optional[torch.dtype] = None,
            pad_to: Optional[int] = None) -> torch.Tensor:
    """Pack the leaves into one zero-padded 1-D buffer on their device, in
    ``dtype`` (default: the first leaf's). ``pad_to`` rounds the total
    length up to a multiple of it."""
    leaves, _ = tree_flatten(tensors)
    if spec is None:
        spec = flat_spec(tensors)
    dtype = dtype or spec.dtypes[0]
    total = spec.total_size if pad_to is None \
        else _round_up(spec.total_size, pad_to)
    device = leaves[0].device if leaves else None
    flat = torch.zeros(total, dtype=dtype, device=device)
    for leaf, off in zip(leaves, spec.offsets):
        n = leaf.numel()
        flat[off:off + n].copy_(leaf.reshape(-1))
    return flat


def unflatten(flat: torch.Tensor, spec: FlatSpec, cast: bool = True) -> Any:
    """The leaves back in their shapes: views of ``flat``, or copies cast
    to each leaf's dtype where that differs and ``cast`` is set."""
    out = []
    for shape, dtype, off in zip(spec.shapes, spec.dtypes, spec.offsets):
        n = math.prod(shape)
        piece = flat[off:off + n].view(shape)
        out.append(piece.to(dtype) if cast else piece)
    if spec.treedef is not None:
        return tree_unflatten(spec.treedef, out)
    return out
