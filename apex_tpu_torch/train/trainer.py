"""``Trainer`` — counterpart of ``apex_tpu/train/trainer.py`` for one card.

``Trainer(config, loss_fn=, init_params=, batch_fn=).run()`` trains the
module ``init_params`` in place: ``loss_fn(module, tokens)`` returns the
scalar loss (:func:`~apex_tpu_torch.models.gpt2.lm_loss` for GPT-2) and
``batch_fn(step)`` the step's token batch on the module's device. One
step, as the JAX trainer's ``_step`` / ``_make_apply`` and the normal path
of ``ResilientStep._post`` run it:

1. the batch is cut into ``grad_shards`` micro-shards; each one's scaled
   loss is differentiated and the gradients are summed in shard-index
   order (autograd accumulates them in that order);
2. the gradients are packed into one flat fp32 buffer, divided by the
   shard count, and unscaled with their norm and overflow flag
   (``DynamicGradScaler.unscale_and_norm``);
3. one launch of the fused Adam kernel updates the flat fp32 parameter,
   m and v buffers in place, with ``step = t + 1``, ``inv_scale = 1`` and
   the overflow flag as its no-op (an overflow step changes nothing);
4. the scaler state advances.

The module's parameters are views of the flat parameter buffer, so they
see each update without a copy; their version counters are bumped so the
model's cached compute-dtype copies (for serving) are made again. The
step's one host sync is the read of the overflow flag, as in the JAX
trainer; ``on_step(step, loss)`` costs one more. Data and tensor
parallelism, checkpointing, telemetry and the overflow-storm guard are
later slices (:class:`~apex_tpu_torch.train.config.TrainConfig`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from apex_tpu_torch.amp.grad_scaler import DynamicGradScaler, ScalerState
from apex_tpu_torch.ops.fused_adam_kernel import (ADAM_MODE_ADAMW,
                                                  fused_adam_flat)
from apex_tpu_torch.optimizers.fused_adam import FLAT_PAD
from apex_tpu_torch.train.config import TrainConfig
from apex_tpu_torch.utils.flatten import flat_spec, flatten, unflatten


class Trainer:
    """The single-card train loop (see the module docstring)."""

    def __init__(self, config: TrainConfig, *,
                 loss_fn: Callable[[nn.Module, torch.Tensor], torch.Tensor],
                 init_params: nn.Module,
                 batch_fn: Callable[[int], torch.Tensor]):
        self.config = config.validate()
        if loss_fn is None or init_params is None or batch_fn is None:
            raise ValueError("the trainer needs loss_fn, init_params (the "
                             "module to train) and batch_fn")
        self.model = init_params
        self._loss_fn = loss_fn
        self._batch_fn = batch_fn
        self.G = config.grad_shards
        self.scaler = DynamicGradScaler(init_scale=config.init_scale,
                                        enabled=config.amp != "off")
        named = dict(self.model.named_parameters())
        bad = [n for n, p in named.items() if p.dtype != torch.float32]
        if bad:
            raise ValueError(f"the trainer keeps fp32 parameters; not fp32: "
                             f"{bad[:4]}")
        self._params = named
        self._spec = flat_spec(named)
        self.flat_p = flatten(named, self._spec, dtype=torch.float32,
                              pad_to=FLAT_PAD)
        self.m = torch.zeros_like(self.flat_p)
        self.v = torch.zeros_like(self.flat_p)
        # the module trains in place: its parameters become views of the
        # flat buffer the Adam kernel updates
        with torch.no_grad():
            for name, view in unflatten(self.flat_p, self._spec,
                                        cast=False).items():
                named[name].data = view
        self.sstate: ScalerState = self.scaler.init(self.flat_p.device)
        self._next_step = 0
        self.skipped_steps = 0

    def moments(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Adam's m and v by parameter name (views of the flat buffers)."""
        return {"m": unflatten(self.m, self._spec, cast=False),
                "v": unflatten(self.v, self._spec, cast=False)}

    def _step(self, t: int):
        tokens = self._batch_fn(t)
        n = tokens.shape[0]
        if n % self.G:
            raise ValueError(f"batch_fn returned leading dim {n}, not "
                             f"divisible by grad_shards {self.G}")
        shards = tokens.reshape((self.G, n // self.G)
                                + tuple(tokens.shape[1:]))
        params = self._params
        for p in params.values():
            p.grad = None
        loss_sum: Optional[torch.Tensor] = None
        for i in range(self.G):
            loss = self._loss_fn(self.model, shards[i])
            self.scaler.scale(loss, self.sstate).backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        gsum = flatten({k: p.grad if p.grad is not None
                        else torch.zeros_like(p) for k, p in params.items()},
                       self._spec, dtype=torch.float32,
                       pad_to=self.flat_p.numel())
        for p in params.values():
            p.grad = None
        inv = 1.0 / float(self.G)
        grads, _, found_inf = self.scaler.unscale_and_norm(gsum * inv,
                                                           self.sstate)
        fused_adam_flat(self.flat_p, grads, self.m, self.v,
                        lr=self.config.lr, step=t + 1, mode=ADAM_MODE_ADAMW,
                        inv_scale=1.0, found_inf=found_inf)
        self.sstate = self.scaler.update(self.sstate, found_inf)
        for p in params.values():
            torch.autograd.graph.increment_version(p)
        # the step's one host sync: the skip flag
        return loss_sum * inv, bool(found_inf)

    def run(self, *, on_step: Optional[Callable[[int, float], None]] = None
            ) -> Dict[str, Any]:
        """Run to ``config.steps``; ``on_step(step, loss)`` after each."""
        while self._next_step < self.config.steps:
            t = self._next_step
            loss, skipped = self._step(t)
            self.skipped_steps += int(skipped)
            if on_step is not None:
                on_step(t, float(loss))
            self._next_step = t + 1
        return {"rank": 0, "world": 1, "final_step": self._next_step - 1,
                "skipped_steps": self.skipped_steps}
