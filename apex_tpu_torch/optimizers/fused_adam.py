"""FusedAdam — counterpart of ``apex_tpu/optimizers/fused_adam.py``.

Adam / AdamW with ``adam_w_mode``, ``bias_correction``, optional fp32
``master_weights`` and a ``found_inf`` / ``inv_scale`` channel for the
loss scaler. Two paths, as in the JAX package:

- flat (default, ``use_flat=True``): the parameters, moments and each
  step's gradients are packed into one contiguous 128-aligned buffer each
  (:mod:`apex_tpu_torch.utils.flatten`) and updated in place by one
  kernel launch. As in the JAX class, the parameter buffer takes the
  first parameter's dtype (fp32 or bf16, the gradients flattened to it;
  m and v fp32) and :func:`~apex_tpu_torch.ops.fused_adam_kernel.
  fused_adam_flat` updates it. With ``master_weights`` the buffer is the
  fp32 master; over bf16 parameters :func:`~apex_tpu_torch.ops.
  fused_adam_kernel.fused_adam_flat_master` also writes a persistent bf16
  flat buffer in the same pass, so no cast runs per step. The parameters
  handed back are views of the flat buffer they live in (casts from it
  for a mixed-dtype tree);
- tree: :func:`~apex_tpu_torch.optimizers.functional.adam_update` over
  the parameter tree.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from apex_tpu_torch.ops.fused_adam_kernel import (ADAM_MODE_ADAMW,
                                                  ADAM_MODE_L2,
                                                  fused_adam_flat,
                                                  fused_adam_flat_master)
from apex_tpu_torch.optimizers._base import (FusedOptimizerBase,
                                             master_copy, zeros_like_f32)
from apex_tpu_torch.optimizers.functional import adam_update
from apex_tpu_torch.utils.flatten import flat_spec, flatten, unflatten

FLAT_PAD = 1024  # the flat buffers' length is a multiple of this


class FusedAdam(FusedOptimizerBase):
    def __init__(self, params: Any, lr: float = 1e-3,
                 bias_correction: bool = True, betas=(0.9, 0.999),
                 eps: float = 1e-8, adam_w_mode: bool = True,
                 weight_decay: float = 0.0, amsgrad: bool = False,
                 capturable: bool = True, master_weights: bool = False,
                 use_flat: bool = True):
        if amsgrad:
            raise RuntimeError(
                "FusedAdam does not support the AMSGrad variant.")
        super().__init__(params, lr)
        del capturable  # always on: the update never syncs with the host
        self.betas = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.weight_decay = weight_decay
        self.bias_correction = bias_correction
        self.master_weights = master_weights
        self.use_flat = use_flat
        if use_flat:
            self._spec = flat_spec(self._params)
            # the bf16 copy the master kernel writes, over bf16 parameters
            self._flat_lp = None
            if master_weights:
                self._flat_p = flatten(self._params, self._spec,
                                       dtype=torch.float32, pad_to=FLAT_PAD)
                if set(self._spec.dtypes) == {torch.bfloat16}:
                    self._flat_lp = flatten(self._params, self._spec,
                                            pad_to=FLAT_PAD)
            else:
                self._flat_p = flatten(self._params, self._spec,
                                       pad_to=FLAT_PAD)
            self.state = {"m": torch.zeros_like(self._flat_p,
                                                dtype=torch.float32),
                          "v": torch.zeros_like(self._flat_p,
                                                dtype=torch.float32)}
            if master_weights:
                self.state["master"] = self._flat_p
            self._params = self._unflat()
        else:
            self.state = {"m": zeros_like_f32(self._params),
                          "v": zeros_like_f32(self._params)}
            if master_weights:
                self.state["master"] = master_copy(self._params)

    def _update(self, params, grads, state, step, lr, inv_scale, found_inf):
        out = adam_update(
            params, grads, state["m"], state["v"], step=step, lr=lr,
            beta1=self.betas[0], beta2=self.betas[1], eps=self.eps,
            weight_decay=self.weight_decay, adam_w_mode=self.adam_w_mode,
            bias_correction=self.bias_correction, inv_scale=inv_scale,
            found_inf=found_inf, master=state.get("master"))
        if self.master_weights:
            p, m, v, mst = out
            return p, {"m": m, "v": v, "master": mst}
        p, m, v = out
        return p, {"m": m, "v": v}

    def step(self, grads: Any, lr: Optional[float] = None, inv_scale=1.0,
             found_inf=False):
        if not self.use_flat:
            return super().step(grads, lr=lr, inv_scale=inv_scale,
                                found_inf=found_inf)
        found = self._advance(found_inf)
        flat_g = flatten(grads, self._spec, dtype=self._flat_p.dtype,
                         pad_to=self._flat_p.numel())
        kw = dict(lr=self._lr if lr is None else lr, beta1=self.betas[0],
                  beta2=self.betas[1], eps=self.eps,
                  weight_decay=self.weight_decay, step=self._step,
                  mode=ADAM_MODE_ADAMW if self.adam_w_mode else ADAM_MODE_L2,
                  bias_correction=self.bias_correction, inv_scale=inv_scale,
                  found_inf=found)
        if self._flat_lp is not None:
            fused_adam_flat_master(self._flat_p, flat_g, self.state["m"],
                                   self.state["v"], p_lp=self._flat_lp, **kw)
        else:
            fused_adam_flat(self._flat_p, flat_g, self.state["m"],
                            self.state["v"], **kw)
        self._params = self._unflat()
        return self._params

    def _unflat(self):
        """The parameters: views of the bf16 copy or of the flat buffer."""
        return unflatten(self._flat_p if self._flat_lp is None
                         else self._flat_lp, self._spec)

    @property
    def master_parameters(self):
        """fp32 master weights: views of the flat buffer (flat path) or the
        ``state['master']`` tree (tree path)."""
        if self.use_flat and self.master_weights:
            return unflatten(self._flat_p, self._spec, cast=False)
        return self.state.get("master")


class FusedAdamW(FusedAdam):
    """FusedAdam with decoupled weight decay on by default."""

    def __init__(self, params, lr: float = 1e-3, **kw):
        kw.setdefault("adam_w_mode", True)
        super().__init__(params, lr=lr, **kw)
