"""FusedAdam — counterpart of ``apex_tpu/optimizers/fused_adam.py``.

Adam / AdamW with ``adam_w_mode``, ``bias_correction``, optional fp32
``master_weights`` and a ``found_inf`` / ``inv_scale`` channel for the
loss scaler. Two paths, as in the JAX package:

- flat (default, ``use_flat=True``): the parameters, moments and each
  step's gradients are packed into one contiguous 128-aligned fp32 buffer
  each (:mod:`apex_tpu_torch.utils.flatten`) and updated in place by one
  launch of the fused Adam kernel
  (:func:`~apex_tpu_torch.ops.fused_adam_kernel.fused_adam_flat`); the
  parameters handed back are views of (or, for low-precision parameters
  with ``master_weights``, casts from) the flat buffer;
- tree: :func:`~apex_tpu_torch.optimizers.functional.adam_update` over
  the parameter tree.

The flat path keeps fp32 buffers: low-precision parameters need
``master_weights=True`` there (the JAX package would keep a
low-precision flat buffer, which the kernel does not take).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from apex_tpu_torch.ops.fused_adam_kernel import (ADAM_MODE_ADAMW,
                                                  ADAM_MODE_L2,
                                                  fused_adam_flat)
from apex_tpu_torch.optimizers._base import (FusedOptimizerBase,
                                             master_copy, zeros_like_f32)
from apex_tpu_torch.optimizers.functional import adam_update
from apex_tpu_torch.utils.flatten import flat_spec, flatten, unflatten
from apex_tpu_torch.utils.tree import tree_leaves

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
            if not master_weights and any(
                    p.dtype != torch.float32
                    for p in tree_leaves(self._params)):
                raise NotImplementedError(
                    "FusedAdam(use_flat=True): the flat kernel updates "
                    "fp32 buffers; low-precision parameters need "
                    "master_weights=True")
            self._spec = flat_spec(self._params)
            self._flat_p = flatten(self._params, self._spec,
                                   dtype=torch.float32, pad_to=FLAT_PAD)
            self.state = {"m": torch.zeros_like(self._flat_p),
                          "v": torch.zeros_like(self._flat_p)}
            if master_weights:
                self.state["master"] = self._flat_p
            self._params = unflatten(self._flat_p, self._spec)
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
        flat_g = flatten(grads, self._spec, dtype=torch.float32,
                         pad_to=self._flat_p.numel())
        fused_adam_flat(
            self._flat_p, flat_g, self.state["m"], self.state["v"],
            lr=self._lr if lr is None else lr, beta1=self.betas[0],
            beta2=self.betas[1], eps=self.eps,
            weight_decay=self.weight_decay, step=self._step,
            mode=ADAM_MODE_ADAMW if self.adam_w_mode else ADAM_MODE_L2,
            bias_correction=self.bias_correction, inv_scale=inv_scale,
            found_inf=found)
        self._params = unflatten(self._flat_p, self._spec)
        return self._params

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
