"""FusedAdagrad — counterpart of ``apex_tpu/optimizers/fused_adagrad.py``.

Adagrad with L2 weight decay, or decoupled weight decay with
``adagrad_w_mode``. Two paths, as in the JAX package:

- flat (default, ``use_flat=True``): the parameters, the sum of squares
  and each step's gradients are packed into one contiguous 128-aligned
  fp32 buffer each and updated in place by one launch of
  :func:`~apex_tpu_torch.ops.fused_opt_kernels.fused_adagrad_flat`; the
  parameters handed back are views of the flat buffer (casts from it for
  low-precision parameters);
- tree: :func:`~apex_tpu_torch.optimizers.functional.adagrad_update`.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from apex_tpu_torch.ops.fused_opt_kernels import fused_adagrad_flat
from apex_tpu_torch.optimizers._base import FusedOptimizerBase, zeros_like_f32
from apex_tpu_torch.optimizers.functional import adagrad_update
from apex_tpu_torch.optimizers.fused_adam import FLAT_PAD
from apex_tpu_torch.utils.flatten import flat_spec, flatten, unflatten


class FusedAdagrad(FusedOptimizerBase):
    def __init__(self, params: Any, lr: float = 1e-2, eps: float = 1e-10,
                 weight_decay: float = 0.0, adagrad_w_mode: bool = False,
                 set_grad_none: bool = True, use_flat: bool = True):
        del set_grad_none  # signature parity only
        super().__init__(params, lr)
        self.eps = eps
        self.weight_decay = weight_decay
        self.adagrad_w_mode = adagrad_w_mode
        self.use_flat = use_flat
        if use_flat:
            self._spec = flat_spec(self._params)
            self._flat_p = flatten(self._params, self._spec,
                                   dtype=torch.float32, pad_to=FLAT_PAD)
            self.state = {"sum": torch.zeros_like(self._flat_p)}
            self._params = unflatten(self._flat_p, self._spec)
        else:
            self.state = {"sum": zeros_like_f32(self._params)}

    def _kw(self):
        return dict(eps=self.eps, weight_decay=self.weight_decay,
                    adagrad_w_mode=self.adagrad_w_mode)

    def _update(self, params, grads, state, step, lr, inv_scale, found_inf):
        p, h = adagrad_update(params, grads, state["sum"], lr=lr,
                              inv_scale=inv_scale, found_inf=found_inf,
                              **self._kw())
        return p, {"sum": h}

    def step(self, grads: Any, lr: Optional[float] = None, inv_scale=1.0,
             found_inf=False):
        if not self.use_flat:
            return super().step(grads, lr=lr, inv_scale=inv_scale,
                                found_inf=found_inf)
        found = self._advance(found_inf)
        flat_g = flatten(grads, self._spec, dtype=torch.float32,
                         pad_to=self._flat_p.numel())
        fused_adagrad_flat(self._flat_p, flat_g, self.state["sum"],
                           lr=self._lr if lr is None else lr,
                           inv_scale=inv_scale, found_inf=found,
                           **self._kw())
        self._params = unflatten(self._flat_p, self._spec)
        return self._params
