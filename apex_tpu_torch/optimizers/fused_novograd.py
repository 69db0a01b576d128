"""FusedNovoGrad — counterpart of ``apex_tpu/optimizers/fused_novograd.py``.

NovoGrad with one second-moment scalar per parameter tensor
(``exp_avg_sq``: of the gradient's L2 norm squared, ``norm_type=2``, or
of its max-norm, ``norm_type=0``), ``init_zero`` initialisation, bias
correction and gradient averaging. Two paths, as in the JAX package:

- flat (on by default when ``norm_type == 2``): the parameters, the first
  moment and each step's gradients are packed into one contiguous
  128-aligned fp32 buffer each, with the per-row tensor ids and the
  per-tensor reduction plan built once on the device; each step runs
  :func:`~apex_tpu_torch.ops.fused_opt_kernels.fused_novograd_flat` (the
  per-tensor moments in plain PyTorch, then one kernel launch) in place,
  with the moments a ``(num_tensors,)`` fp32 vector. The parameters handed
  back are views of the flat buffer (casts from it for low-precision
  parameters);
- tree: :func:`~apex_tpu_torch.optimizers.functional.novograd_update`.

The tree path takes the square of the norm's square root and the flat
path the sum of squares itself, as in the JAX package, so the two agree
to rounding, not bit for bit.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from apex_tpu_torch.ops.fused_opt_kernels import (fused_novograd_flat,
                                                  row_segment_ids,
                                                  row_segments)
from apex_tpu_torch.optimizers._base import (FusedOptimizerBase,
                                             scalar_zeros, zeros_like_f32)
from apex_tpu_torch.optimizers.functional import novograd_update
from apex_tpu_torch.optimizers.fused_adam import FLAT_PAD
from apex_tpu_torch.utils.flatten import flat_spec, flatten, unflatten


class FusedNovoGrad(FusedOptimizerBase):
    def __init__(self, params: Any, lr: float = 1e-3,
                 bias_correction: bool = True, betas=(0.95, 0.98),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 amsgrad: bool = False, reg_inside_moment: bool = False,
                 grad_averaging: bool = True, norm_type: int = 2,
                 init_zero: bool = False, set_grad_none: bool = True,
                 use_flat: Optional[bool] = None):
        if amsgrad:
            raise RuntimeError(
                "FusedNovoGrad does not support the AMSGrad variant.")
        del reg_inside_moment, set_grad_none  # signature parity only
        super().__init__(params, lr)
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.bias_correction = bias_correction
        self.grad_averaging = grad_averaging
        self.norm_type = norm_type
        self.init_zero = init_zero
        # the flat path needs the L2 norm_type (the max-norm: tree path)
        self.use_flat = (norm_type == 2) if use_flat is None else use_flat
        if self.use_flat and norm_type != 2:
            raise ValueError("use_flat requires norm_type=2")
        if self.use_flat:
            self._spec = flat_spec(self._params)
            self._flat_p = flatten(self._params, self._spec,
                                   dtype=torch.float32, pad_to=FLAT_PAD)
            self._row_ids = row_segment_ids(self._spec, self._flat_p.numel(),
                                            device=self.device)
            self._segments = row_segments(self._row_ids,
                                          self._spec.num_leaves)
            self.state = {"m": torch.zeros_like(self._flat_p),
                          "v": torch.zeros(self._spec.num_leaves,
                                           dtype=torch.float32,
                                           device=self.device)}
            self._params = unflatten(self._flat_p, self._spec)
        else:
            self.state = {"m": zeros_like_f32(self._params),
                          "v": scalar_zeros(self._params)}

    def _kw(self):
        return dict(beta1=self.betas[0], beta2=self.betas[1], eps=self.eps,
                    weight_decay=self.weight_decay,
                    grad_averaging=self.grad_averaging,
                    bias_correction=self.bias_correction,
                    norm_type=self.norm_type, init_zero=self.init_zero)

    def _update(self, params, grads, state, step, lr, inv_scale, found_inf):
        p, m, v = novograd_update(params, grads, state["m"], state["v"],
                                  step=step, lr=lr, inv_scale=inv_scale,
                                  found_inf=found_inf, **self._kw())
        return p, {"m": m, "v": v}

    def step(self, grads: Any, lr: Optional[float] = None, inv_scale=1.0,
             found_inf=False):
        if not self.use_flat:
            return super().step(grads, lr=lr, inv_scale=inv_scale,
                                found_inf=found_inf)
        found = self._advance(found_inf)
        flat_g = flatten(grads, self._spec, dtype=torch.float32,
                         pad_to=self._flat_p.numel())
        fused_novograd_flat(
            self._flat_p, flat_g, self.state["m"], self.state["v"],
            self._row_ids, num_tensors=self._spec.num_leaves,
            lr=self._lr if lr is None else lr, step=self._step,
            inv_scale=inv_scale, found_inf=found, segments=self._segments,
            **self._kw())
        self._params = unflatten(self._flat_p, self._spec)
        return self._params
