"""FusedSGD — counterpart of ``apex_tpu/optimizers/fused_sgd.py``.

SGD with momentum, dampening and Nesterov, weight decay before or after
the momentum (``wd_after_momentum``), optional fp32 ``master_weights``
and a ``found_inf`` / ``inv_scale`` channel for the loss scaler. Two
paths, as in the JAX package (the tree path is the default there, and
here):

- tree (``use_flat=False``): :func:`~apex_tpu_torch.optimizers.
  functional.sgd_update` over the parameter tree; the first applied step
  (``step == 1`` after the counter advances) sets the momentum buffers;
- flat (``use_flat=True``): the parameters, the momentum buffer and each
  step's gradients are packed into one contiguous 128-aligned buffer each
  (the parameters in the first parameter's dtype, or fp32 with
  ``master_weights``; the gradients in the parameters' buffer dtype; the
  momentum fp32) and updated in place by one launch of
  :func:`~apex_tpu_torch.ops.fused_sgd_kernel.fused_sgd_flat`. Its first
  step is ``step == 0`` before the counter advances, as in the JAX class,
  so a first step that overflows leaves the next applied step first too.
  The parameters handed back are views of the flat buffer (casts from it
  where a parameter's dtype differs, e.g. bf16 parameters over the fp32
  master).

``state_dict`` / ``load_state_dict`` come with FusedAdam's in a later
slice.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from apex_tpu_torch.ops.fused_sgd_kernel import fused_sgd_flat
from apex_tpu_torch.optimizers._base import (FusedOptimizerBase,
                                             master_copy, zeros_like_f32)
from apex_tpu_torch.optimizers.functional import sgd_update
from apex_tpu_torch.optimizers.fused_adam import FLAT_PAD
from apex_tpu_torch.utils.flatten import flat_spec, flatten, unflatten


class FusedSGD(FusedOptimizerBase):
    def __init__(self, params: Any, lr: float, momentum: float = 0.0,
                 dampening: float = 0.0, weight_decay: float = 0.0,
                 nesterov: bool = False, wd_after_momentum: bool = False,
                 materialize_master_grads: bool = True,
                 master_weights: bool = False, use_flat: bool = False):
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError(
                "Nesterov momentum requires a momentum and zero dampening")
        super().__init__(params, lr)
        self.momentum = momentum
        self.dampening = dampening
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        self.wd_after_momentum = wd_after_momentum
        self.materialize_master_grads = materialize_master_grads
        self.master_weights = master_weights
        self.use_flat = use_flat
        if use_flat:
            self._spec = flat_spec(self._params)
            # master_weights: the flat buffer is the fp32 master
            self._flat_p = flatten(
                self._params, self._spec,
                dtype=torch.float32 if master_weights else None,
                pad_to=FLAT_PAD)
            self.state = {"momentum_buffer": torch.zeros_like(
                self._flat_p, dtype=torch.float32)}
            self._params = unflatten(self._flat_p, self._spec)
        else:
            self.state = {"momentum_buffer": zeros_like_f32(self._params)}
            if master_weights:
                self.state["master"] = master_copy(self._params)

    def _kw(self):
        return dict(momentum=self.momentum, dampening=self.dampening,
                    weight_decay=self.weight_decay, nesterov=self.nesterov,
                    wd_after_momentum=self.wd_after_momentum)

    def _update(self, params, grads, state, step, lr, inv_scale, found_inf):
        out = sgd_update(params, grads, state["momentum_buffer"], lr=lr,
                         first_step=step == 1, inv_scale=inv_scale,
                         found_inf=found_inf, master=state.get("master"),
                         **self._kw())
        if self.master_weights:
            p, buf, mst = out
            return p, {"momentum_buffer": buf, "master": mst}
        p, buf = out
        return p, {"momentum_buffer": buf}

    def step(self, grads: Any, lr: Optional[float] = None, inv_scale=1.0,
             found_inf=False):
        if not self.use_flat:
            return super().step(grads, lr=lr, inv_scale=inv_scale,
                                found_inf=found_inf)
        first = self._step == 0
        found = self._advance(found_inf)
        flat_g = flatten(grads, self._spec, dtype=self._flat_p.dtype,
                         pad_to=self._flat_p.numel())
        fused_sgd_flat(self._flat_p, flat_g, self.state["momentum_buffer"],
                       lr=self._lr if lr is None else lr,
                       inv_scale=inv_scale, found_inf=found,
                       first_step=first, **self._kw())
        self._params = unflatten(self._flat_p, self._spec)
        return self._params
