"""Multi-tensor primitives — counterpart of
``apex_tpu/multi_tensor/functional.py``.

Plain PyTorch over pytrees of tensors (the JAX package has no Pallas
kernel here either): fp32 math whatever the storage dtype, a single
``found_inf`` flag as a device tensor, and no host sync anywhere, so the
loss-scaling flow stays on the card. The trainer hands these one flat
buffer, which makes each a single pass.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from apex_tpu_torch.utils.tree import tree_leaves, tree_map


def tree_check_finite(tree: Any) -> torch.Tensor:
    """found_inf: a 0-d bool tensor, True if any element is inf or nan."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.bool)
    acc = ~torch.isfinite(leaves[0]).all()
    for leaf in leaves[1:]:
        acc = acc | ~torch.isfinite(leaf).all()
    return acc


def multi_tensor_scale(tree: Any, scale, check_finite: bool = True
                       ) -> Tuple[Any, torch.Tensor]:
    """``out = in * scale`` (fp32 math, input dtype out) and found_inf of
    the input."""
    out = tree_map(lambda x: (x.float() * scale).to(x.dtype), tree)
    found_inf = (tree_check_finite(tree) if check_finite
                 else torch.zeros((), dtype=torch.bool))
    return out, found_inf


def multi_tensor_l2norm(tree: Any, per_tensor: bool = False):
    """``(global L2 norm, per-tensor norms or None)`` as fp32 0-d / 1-d
    tensors; squares summed leaf by leaf in fp32."""
    leaves = tree_leaves(tree)
    if not leaves:
        z = torch.zeros((), dtype=torch.float32)
        return z, (torch.zeros((0,), dtype=torch.float32) if per_tensor
                   else None)
    sqs = [leaf.float().square().sum() for leaf in leaves]
    total = sqs[0]
    for s in sqs[1:]:
        total = total + s
    gnorm = torch.sqrt(total)
    return gnorm, (torch.sqrt(torch.stack(sqs)) if per_tensor else None)


def multi_tensor_unscale_l2norm(tree: Any, inv_scale,
                                per_tensor: bool = False):
    """Fused unscale + L2 norm: ``(unscaled tree, global norm, per-tensor
    norms or None, found_inf of the input)``."""
    out = tree_map(lambda x: (x.float() * inv_scale).to(x.dtype), tree)
    gnorm, pt = multi_tensor_l2norm(out, per_tensor)
    return out, gnorm, pt, tree_check_finite(tree)


def update_scale_hysteresis(scale: torch.Tensor,
                            growth_tracker: torch.Tensor,
                            hysteresis_tracker: torch.Tensor,
                            found_inf: torch.Tensor,
                            growth_factor: float = 2.0,
                            backoff_factor: float = 0.5,
                            growth_interval: int = 2000,
                            hysteresis: int = 1):
    """The dynamic loss-scale state machine, branch for branch as the JAX
    one (``csrc/update_scale_hysteresis.cu`` of apex):

    - found_inf: hysteresis -= 1; while it is still > 0 only the growth
      tracker resets; once <= 0 every further inf step backs the scale
      off. A backoff does not replenish the hysteresis.
    - clean step: growth_tracker += 1; at ``growth_interval`` the scale
      grows if the result is finite; hysteresis is replenished.

    Takes and returns device tensors: ``(scale fp32, growth_tracker int32,
    hysteresis_tracker int32)``."""
    found_inf = found_inf.to(torch.bool)
    hys_after = hysteresis_tracker - 1
    backoff_now = found_inf & (hys_after <= 0)
    scale_inf = torch.where(backoff_now, scale * backoff_factor, scale)

    gt_after = growth_tracker + 1
    grow_now = gt_after == growth_interval
    grown = scale * growth_factor
    grown = torch.where(torch.isfinite(grown), grown, scale)
    scale_ok = torch.where(grow_now, grown, scale)
    gt_ok = torch.where(grow_now, torch.zeros_like(gt_after), gt_after)

    new_scale = torch.where(found_inf, scale_inf, scale_ok)
    new_gt = torch.where(found_inf, torch.zeros_like(gt_ok), gt_ok)
    new_hys = torch.where(found_inf, hys_after,
                          torch.full_like(hys_after, hysteresis))
    return new_scale, new_gt, new_hys
