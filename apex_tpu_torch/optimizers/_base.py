"""Shared machinery of the stateful optimizer front ends — counterpart of
``apex_tpu/optimizers/_base.py``.

As in the JAX package, an optimizer owns a copy of the parameters (a
pytree of tensors), its state, and a step counter, all on the device;
``step(grads)`` returns the updated parameters. The step counter
advances only on steps whose ``found_inf`` is clear, by device
arithmetic, so a step causes no host sync.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from apex_tpu_torch.utils.tree import tree_leaves, tree_map


def _flag(found_inf, device) -> torch.Tensor:
    if torch.is_tensor(found_inf):
        return found_inf.to(device=device, dtype=torch.bool)
    return torch.full((), bool(found_inf), dtype=torch.bool, device=device)


class FusedOptimizerBase:
    """Subclasses implement ``_update(params, grads, state, step, lr,
    inv_scale, found_inf) -> (params, state)`` and build ``self.state``."""

    def __init__(self, params: Any, lr: float):
        self._params = tree_map(lambda p: p.detach().clone(), params)
        self._lr = lr
        self.device = tree_leaves(self._params)[0].device
        self._step = torch.zeros((), dtype=torch.int32, device=self.device)
        self.state: Dict[str, Any] = {}

    def _update(self, params, grads, state, step, lr, inv_scale, found_inf):
        raise NotImplementedError

    def _advance(self, found_inf) -> torch.Tensor:
        """The step counter after this step (+1 unless it overflowed)."""
        found = _flag(found_inf, self.device)
        self._step = self._step + (~found).to(torch.int32)
        return found

    def step(self, grads: Any, lr: Optional[float] = None, inv_scale=1.0,
             found_inf=False):
        """Apply one step; returns (and keeps) the updated parameters."""
        found = self._advance(found_inf)
        self._params, self.state = self._update(
            self._params, grads, self.state, self._step,
            self._lr if lr is None else lr, inv_scale, found)
        return self._params

    @property
    def parameters(self):
        return self._params


def zeros_like_f32(tree: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), tree)


def scalar_zeros(tree: Any) -> Any:
    """One fp32 zero scalar per leaf (NovoGrad's per-tensor moments)."""
    return tree_map(lambda p: torch.zeros((), dtype=torch.float32,
                                          device=p.device), tree)


def master_copy(tree: Any) -> Any:
    return tree_map(lambda p: p.detach().float().clone(), tree)
