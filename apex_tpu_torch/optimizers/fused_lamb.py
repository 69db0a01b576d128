"""FusedLAMB — counterpart of ``apex_tpu/optimizers/fused_lamb.py``.

LAMB with the two-phase semantics of the reference: the global gradient
norm sets a clip divisor, then each tensor takes the Adam-style update
term scaled by its trust ratio. Two paths, as in the JAX package:

- flat (default, ``use_flat=True``): the parameters and moments live in
  one contiguous 128-aligned fp32 buffer each, padded to a multiple of
  1024 (:mod:`apex_tpu_torch.utils.flatten`), with the per-row tensor ids
  and the per-tensor reduction plan built once on the device; each step
  packs the gradients and runs
  :func:`~apex_tpu_torch.ops.fused_opt_kernels.fused_lamb_flat` (its two
  kernels) in place. The parameters handed back are views of the flat
  buffer (casts from it for low-precision parameters);
- tree: :func:`~apex_tpu_torch.optimizers.functional.lamb_update`.

``last_grad_norm`` is the global gradient norm of the last step, a device
tensor. ``state_dict`` / ``load_state_dict`` are a later slice.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from apex_tpu_torch.ops.fused_opt_kernels import (fused_lamb_flat,
                                                  row_segment_ids,
                                                  row_segments)
from apex_tpu_torch.optimizers._base import FusedOptimizerBase, zeros_like_f32
from apex_tpu_torch.optimizers.functional import lamb_update
from apex_tpu_torch.optimizers.fused_adam import FLAT_PAD
from apex_tpu_torch.utils.flatten import flat_spec, flatten, unflatten


class FusedLAMB(FusedOptimizerBase):
    def __init__(self, params: Any, lr: float = 1e-3,
                 bias_correction: bool = True, betas=(0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.01,
                 amsgrad: bool = False, adam_w_mode: bool = True,
                 grad_averaging: bool = True, max_grad_norm: float = 1.0,
                 use_nvlamb: bool = False, use_flat: bool = True):
        if amsgrad:
            raise RuntimeError(
                "FusedLAMB does not support the AMSGrad variant.")
        super().__init__(params, lr)
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.bias_correction = bias_correction
        self.adam_w_mode = adam_w_mode
        self.grad_averaging = grad_averaging
        self.max_grad_norm = max_grad_norm
        self.use_nvlamb = use_nvlamb
        self.use_flat = use_flat
        self.last_grad_norm: Optional[torch.Tensor] = None
        if use_flat:
            self._spec = flat_spec(self._params)
            self._flat_p = flatten(self._params, self._spec,
                                   dtype=torch.float32, pad_to=FLAT_PAD)
            self._row_ids = row_segment_ids(self._spec, self._flat_p.numel(),
                                            device=self.device)
            self._segments = row_segments(self._row_ids,
                                          self._spec.num_leaves)
            self.state = {"m": torch.zeros_like(self._flat_p),
                          "v": torch.zeros_like(self._flat_p)}
            self._params = unflatten(self._flat_p, self._spec)
        else:
            self.state = {"m": zeros_like_f32(self._params),
                          "v": zeros_like_f32(self._params)}

    def _kw(self):
        return dict(beta1=self.betas[0], beta2=self.betas[1], eps=self.eps,
                    weight_decay=self.weight_decay,
                    bias_correction=self.bias_correction,
                    grad_averaging=self.grad_averaging,
                    max_grad_norm=self.max_grad_norm,
                    use_nvlamb=self.use_nvlamb,
                    adam_w_mode=self.adam_w_mode)

    def _update(self, params, grads, state, step, lr, inv_scale, found_inf):
        p, m, v, self.last_grad_norm = lamb_update(
            params, grads, state["m"], state["v"], step=step, lr=lr,
            inv_scale=inv_scale, found_inf=found_inf, **self._kw())
        return p, {"m": m, "v": v}

    def step(self, grads: Any, lr: Optional[float] = None, inv_scale=1.0,
             found_inf=False):
        if not self.use_flat:
            return super().step(grads, lr=lr, inv_scale=inv_scale,
                                found_inf=found_inf)
        found = self._advance(found_inf)
        flat_g = flatten(grads, self._spec, dtype=torch.float32,
                         pad_to=self._flat_p.numel())
        self.last_grad_norm = fused_lamb_flat(
            self._flat_p, flat_g, self.state["m"], self.state["v"],
            self._row_ids, num_tensors=self._spec.num_leaves,
            lr=self._lr if lr is None else lr, step=self._step,
            inv_scale=inv_scale, found_inf=found, segments=self._segments,
            **self._kw())
        self._params = unflatten(self._flat_p, self._spec)
        return self._params
