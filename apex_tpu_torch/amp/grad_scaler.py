"""Dynamic loss scaling — counterpart of ``apex_tpu/amp/grad_scaler.py``.

The state (:class:`ScalerState`) is three device tensors carried through
the train step, so scaling the loss, unscaling the gradients with their
norm and overflow flag, and advancing the scale cause no host sync: the
one sync a step needs is the caller's read of ``found_inf``.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.multi_tensor.functional import (
    multi_tensor_l2norm, multi_tensor_scale, multi_tensor_unscale_l2norm,
    tree_check_finite, update_scale_hysteresis)
from apex_tpu_torch.utils.device import DeviceLike, resolve_device


class ScalerState(NamedTuple):
    scale: torch.Tensor               # fp32 0-d
    growth_tracker: torch.Tensor      # int32 0-d
    hysteresis_tracker: torch.Tensor  # int32 0-d

    @classmethod
    def create(cls, init_scale: float = 2.0 ** 16, hysteresis: int = 1, *,
               device: DeviceLike = None) -> "ScalerState":
        dev = resolve_device(device)
        return cls(torch.full((), init_scale, dtype=torch.float32,
                              device=dev),
                   torch.zeros((), dtype=torch.int32, device=dev),
                   torch.full((), hysteresis, dtype=torch.int32,
                              device=dev))


def scale_loss(loss: torch.Tensor, state: ScalerState) -> torch.Tensor:
    """``loss * scale`` in the loss's dtype."""
    return loss * state.scale.to(loss.dtype)


class DynamicGradScaler:
    """Configuration of the dynamic scaler; the state is explicit."""

    def __init__(self, init_scale: float = 2.0 ** 16,
                 growth_factor: float = 2.0, backoff_factor: float = 0.5,
                 growth_interval: int = 2000, hysteresis: int = 1,
                 enabled: bool = True, min_scale: Optional[float] = None):
        self.init_scale = init_scale
        self.growth_factor = growth_factor
        self.backoff_factor = backoff_factor
        self.growth_interval = growth_interval
        self.hysteresis = hysteresis
        self.enabled = enabled
        self.min_scale = min_scale

    def init(self, device: DeviceLike = None) -> ScalerState:
        return ScalerState.create(self.init_scale, self.hysteresis,
                                  device=device)

    def scale(self, loss: torch.Tensor, state: ScalerState) -> torch.Tensor:
        return scale_loss(loss, state) if self.enabled else loss

    def unscale(self, grads: Any, state: ScalerState
                ) -> Tuple[Any, torch.Tensor]:
        """``(unscaled grads, found_inf)``."""
        if not self.enabled:
            return grads, torch.zeros((), dtype=torch.bool,
                                      device=state.scale.device)
        return multi_tensor_scale(grads, 1.0 / state.scale)

    def unscale_and_norm(self, grads: Any, state: ScalerState
                         ) -> Tuple[Any, torch.Tensor, torch.Tensor]:
        """Unscale, global gradient norm and overflow check:
        ``(unscaled grads, grad_norm, found_inf)``."""
        if not self.enabled:
            gnorm, _ = multi_tensor_l2norm(grads)
            return grads, gnorm, tree_check_finite(grads)
        out, gnorm, _, found_inf = multi_tensor_unscale_l2norm(
            grads, 1.0 / state.scale)
        return out, gnorm, found_inf

    def update(self, state: ScalerState, found_inf: torch.Tensor,
               freeze_growth: bool = False) -> ScalerState:
        """Advance the state machine by this step's found_inf.
        ``freeze_growth`` permits backoff but no growth; ``min_scale``
        floors the backoff."""
        if not self.enabled:
            return state
        s, g, h = update_scale_hysteresis(
            state.scale, state.growth_tracker, state.hysteresis_tracker,
            found_inf, self.growth_factor, self.backoff_factor,
            self.growth_interval, self.hysteresis)
        if freeze_growth:
            s = torch.minimum(s, state.scale)
        if self.min_scale is not None:
            s = torch.clamp(s, min=float(self.min_scale))
        return ScalerState(s, g, h)


class GradScaler(DynamicGradScaler):
    """Stateful ``torch.amp.GradScaler``-style facade: ``step(optimizer,
    grads)`` probes the scaled grads for overflow, runs the optimizer
    with ``inv_scale`` and the flag (a no-op on overflow) and advances the
    scale."""

    def __init__(self, device: DeviceLike = None, **kw):
        super().__init__(**kw)
        self.state = self.init(device)

    def step(self, optimizer, grads: Any, lr=None):
        found_inf = tree_check_finite(grads)
        params = optimizer.step(grads, lr=lr,
                                inv_scale=1.0 / self.state.scale,
                                found_inf=found_inf)
        self.state = self.update(self.state, found_inf)
        return params

    def get_scale(self) -> float:
        return float(self.state.scale)
