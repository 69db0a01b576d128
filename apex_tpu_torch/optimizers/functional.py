"""Functional optimizer updates over pytrees — counterpart of
``apex_tpu/optimizers/functional.py`` (``adam_update``, ``sgd_update``,
``lamb_update``, ``novograd_update``, ``adagrad_update``).

The tree paths of the port's fused optimizers: all math in fp32 whatever the
storage dtype, a ``found_inf`` flag that makes the whole update a no-op,
gradients that may carry a loss scale removed through ``inv_scale``, and
with a fp32 ``master`` tree the master is updated and the params are its
cast. Returns new tensors; nothing is updated in place.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from apex_tpu_torch.multi_tensor.functional import multi_tensor_l2norm
from apex_tpu_torch.utils.tree import tree_flatten, tree_unflatten, tree_map

_f32 = torch.float32


def _keep(noop: torch.Tensor, old, new):
    """``where(noop, old, new)`` in old's dtype."""
    return tree_map(lambda o, n: torch.where(noop, o.float(), n).to(o.dtype),
                    old, new)


def _as_tensor(x, device, dtype=_f32) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.full((), x, dtype=dtype, device=device)


def adam_update(params: Any, grads: Any, exp_avg: Any, exp_avg_sq: Any, *,
                step, lr, beta1: float = 0.9, beta2: float = 0.999,
                eps: float = 1e-8, weight_decay: float = 0.0,
                adam_w_mode: bool = True, bias_correction: bool = True,
                inv_scale=1.0, found_inf=False,
                master: Optional[Any] = None):
    """Adam / AdamW over trees. Returns ``(params, m, v[, master])``."""
    src = master if master is not None else params
    dev = tree_flatten(src)[0][0].device
    noop = _as_tensor(found_inf, dev, torch.bool)
    stepf = _as_tensor(step, dev)
    lr = _as_tensor(lr, dev)
    inv_scale = _as_tensor(inv_scale, dev)
    if bias_correction:
        bc1 = 1.0 - torch.pow(_as_tensor(beta1, dev), stepf)
        bc2 = 1.0 - torch.pow(_as_tensor(beta2, dev), stepf)
    else:
        bc1 = bc2 = _as_tensor(1.0, dev)

    def leaf(p, g, m, v):
        p32 = p.float()
        g32 = g.float() * inv_scale
        if not adam_w_mode:
            g32 = g32 + weight_decay * p32
        m_new = beta1 * m.float() + (1.0 - beta1) * g32
        v_new = beta2 * v.float() + (1.0 - beta2) * g32 * g32
        upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        if adam_w_mode:
            upd = upd + weight_decay * p32
        return p32 - lr * upd, m_new, v_new

    leaves, treedef = tree_flatten(src)
    new = [leaf(*xs) for xs in zip(leaves, tree_flatten(grads)[0],
                                   tree_flatten(exp_avg)[0],
                                   tree_flatten(exp_avg_sq)[0])]
    p_new, m_new, v_new = (tree_unflatten(treedef, [t[i] for t in new])
                           for i in range(3))
    m_out = _keep(noop, exp_avg, m_new)
    v_out = _keep(noop, exp_avg_sq, v_new)
    if master is not None:
        master_out = _keep(noop, master, p_new)
        p_out = tree_map(
            lambda p, pm: torch.where(noop, p.float(), pm.float())
            .to(p.dtype), params, master_out)
        return p_out, m_out, v_out, master_out
    return _keep(noop, params, p_new), m_out, v_out


def _split(new, treedef, k):
    """k trees from the per-leaf tuples of ``new``."""
    return tuple(tree_unflatten(treedef, [t[i] for t in new])
                 for i in range(k))


def sgd_update(params: Any, grads: Any, momentum_buf: Any, *, lr,
               momentum: float = 0.0, dampening: float = 0.0,
               weight_decay: float = 0.0, nesterov: bool = False,
               wd_after_momentum: bool = False, first_step=False,
               inv_scale=1.0, found_inf=False,
               master: Optional[Any] = None):
    """SGD over trees (momentum, dampening, Nesterov, weight decay before
    or after the momentum). ``first_step`` (a bool or a device tensor)
    makes the buffer the (weight-decayed) gradient. Returns ``(params,
    momentum_buf[, master])``."""
    src = master if master is not None else params
    dev = tree_flatten(src)[0][0].device
    noop = _as_tensor(found_inf, dev, torch.bool)
    lr = _as_tensor(lr, dev)
    inv_scale = _as_tensor(inv_scale, dev)
    first = _as_tensor(first_step, dev, torch.bool)

    def leaf(p, g, b):
        p32 = p.float()
        g32 = g.float() * inv_scale
        b32 = b.float()
        if weight_decay != 0.0 and not wd_after_momentum:
            g32 = g32 + weight_decay * p32
        if momentum != 0.0:
            b_new = torch.where(first, g32,
                                momentum * b32 + (1.0 - dampening) * g32)
            d = g32 + momentum * b_new if nesterov else b_new
        else:
            b_new = b32
            d = g32
        if weight_decay != 0.0 and wd_after_momentum:
            d = d + weight_decay * p32
        return p32 - lr * d, b_new

    leaves, treedef = tree_flatten(src)
    p_new, b_new = _split([leaf(*xs) for xs in zip(
        leaves, tree_flatten(grads)[0], tree_flatten(momentum_buf)[0])],
        treedef, 2)
    b_out = _keep(noop, momentum_buf, b_new)
    if master is not None:
        master_out = _keep(noop, master, p_new)
        p_out = tree_map(
            lambda p, pm: torch.where(noop, p.float(), pm.float())
            .to(p.dtype), params, master_out)
        return p_out, b_out, master_out
    return _keep(noop, params, p_new), b_out


def lamb_update(params: Any, grads: Any, exp_avg: Any, exp_avg_sq: Any, *,
                step, lr, beta1: float = 0.9, beta2: float = 0.999,
                eps: float = 1e-6, weight_decay: float = 0.01,
                bias_correction: bool = True, grad_averaging: bool = True,
                max_grad_norm: float = 1.0, use_nvlamb: bool = False,
                adam_w_mode: bool = True, inv_scale=1.0, found_inf=False):
    """LAMB over trees, two-phase as the JAX ``lamb_update``: the global
    gradient norm (:func:`~apex_tpu_torch.multi_tensor.functional.
    multi_tensor_l2norm`) sets the clip divisor, then each leaf takes the
    Adam-style update term scaled by its trust ratio ``||p|| / ||u||``
    (1 where a norm is 0, or only where ``||u||`` is 0 with
    ``use_nvlamb``). Returns ``(params, m, v, global_grad_norm)``."""
    dev = tree_flatten(params)[0][0].device
    noop = _as_tensor(found_inf, dev, torch.bool)
    stepf = _as_tensor(step, dev)
    lr = _as_tensor(lr, dev)
    inv_scale = _as_tensor(inv_scale, dev)
    grads32 = tree_map(lambda g: g.float() * inv_scale, grads)
    gnorm, _ = multi_tensor_l2norm(grads32)
    if max_grad_norm is not None and max_grad_norm > 0:
        clip = torch.clamp_min(gnorm / max_grad_norm, 1.0)
    else:
        clip = _as_tensor(1.0, dev)
    beta3 = 1.0 - beta1 if grad_averaging else 1.0
    if bias_correction:
        bc1 = 1.0 - torch.pow(_as_tensor(beta1, dev), stepf)
        bc2 = 1.0 - torch.pow(_as_tensor(beta2, dev), stepf)
    else:
        bc1 = bc2 = _as_tensor(1.0, dev)

    def leaf(p, g, m, v):
        p32 = p.float()
        g32 = g / clip
        if not adam_w_mode:
            g32 = g32 + weight_decay * p32
        m_new = beta1 * m.float() + beta3 * g32
        v_new = beta2 * v.float() + (1.0 - beta2) * g32 * g32
        upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        if adam_w_mode and weight_decay != 0.0:
            upd = upd + weight_decay * p32
        w_norm = torch.sqrt((p32 * p32).sum())
        u_norm = torch.sqrt((upd * upd).sum())
        if use_nvlamb:
            ratio = torch.where(u_norm > 0, w_norm / u_norm, 1.0)
        else:
            ratio = torch.where((w_norm > 0) & (u_norm > 0),
                                w_norm / u_norm, 1.0)
        return p32 - lr * ratio * upd, m_new, v_new

    leaves, treedef = tree_flatten(params)
    new = [leaf(*xs) for xs in zip(leaves, tree_flatten(grads32)[0],
                                   tree_flatten(exp_avg)[0],
                                   tree_flatten(exp_avg_sq)[0])]
    p_new, m_new, v_new = (tree_unflatten(treedef, [t[i] for t in new])
                           for i in range(3))
    return (_keep(noop, params, p_new), _keep(noop, exp_avg, m_new),
            _keep(noop, exp_avg_sq, v_new), gnorm)


def novograd_update(params: Any, grads: Any, exp_avg: Any, exp_avg_sq: Any,
                    *, step, lr, beta1: float = 0.95, beta2: float = 0.98,
                    eps: float = 1e-8, weight_decay: float = 0.0,
                    grad_averaging: bool = False,
                    bias_correction: bool = False, norm_type: int = 2,
                    init_zero: bool = False, inv_scale=1.0,
                    found_inf=False):
    """NovoGrad over trees: ``exp_avg_sq`` holds one fp32 scalar per
    tensor (its second moment: of the gradient's L2 norm squared with
    ``norm_type`` 2, of its max-norm with 0); the first step (``step <=
    1``) sets it, or scales it by ``1 - beta2`` with ``init_zero``.
    Returns ``(params, m, v)``."""
    dev = tree_flatten(params)[0][0].device
    noop = _as_tensor(found_inf, dev, torch.bool)
    stepf = _as_tensor(step, dev)
    lr = _as_tensor(lr, dev)
    inv_scale = _as_tensor(inv_scale, dev)
    first = stepf <= 1.0
    beta3 = 1.0 - beta1 if grad_averaging else 1.0
    if bias_correction:
        bc1 = 1.0 - torch.pow(_as_tensor(beta1, dev), stepf)
        bc2 = 1.0 - torch.pow(_as_tensor(beta2, dev), stepf)
    else:
        bc1 = bc2 = _as_tensor(1.0, dev)

    def leaf(p, g, m, v):
        p32 = p.float()
        g32 = g.float() * inv_scale
        v32 = v.float()
        if norm_type == 0:
            gn = g32.abs().max()
            v_upd = torch.maximum(beta2 * v32, gn)
            v_new = v_upd if init_zero else torch.where(first, gn, v_upd)
            denom = v_new / bc2 + eps
        else:
            gn = torch.sqrt((g32 * g32).sum())
            v_upd = beta2 * v32 + (1.0 - beta2) * gn * gn
            v_new = torch.where(
                first, (1.0 - beta2) * gn * gn if init_zero else gn * gn,
                v_upd)
            denom = torch.sqrt(v_new / bc2) + eps
        gg = g32 / denom
        if weight_decay != 0.0:
            gg = gg + weight_decay * p32
        m_new = beta1 * m.float() + beta3 * gg
        return p32 - lr * (m_new / bc1), m_new, v_new

    leaves, treedef = tree_flatten(params)
    p_new, m_new, v_new = _split([leaf(*xs) for xs in zip(
        leaves, tree_flatten(grads)[0], tree_flatten(exp_avg)[0],
        tree_flatten(exp_avg_sq)[0])], treedef, 3)
    return (_keep(noop, params, p_new), _keep(noop, exp_avg, m_new),
            _keep(noop, exp_avg_sq, v_new))


def adagrad_update(params: Any, grads: Any, state_sum: Any, *, lr,
                   eps: float = 1e-10, weight_decay: float = 0.0,
                   adagrad_w_mode: bool = False, inv_scale=1.0,
                   found_inf=False):
    """Adagrad over trees (``adagrad_w_mode``: decoupled weight decay).
    Returns ``(params, state_sum)``."""
    dev = tree_flatten(params)[0][0].device
    noop = _as_tensor(found_inf, dev, torch.bool)
    lr = _as_tensor(lr, dev)
    inv_scale = _as_tensor(inv_scale, dev)

    def leaf(p, g, h):
        p32 = p.float()
        g32 = g.float() * inv_scale
        if not adagrad_w_mode and weight_decay != 0.0:
            g32 = g32 + weight_decay * p32
        h_new = h.float() + g32 * g32
        upd = g32 / (torch.sqrt(h_new) + eps)
        if adagrad_w_mode and weight_decay != 0.0:
            upd = upd + weight_decay * p32
        return p32 - lr * upd, h_new

    leaves, treedef = tree_flatten(params)
    p_new, h_new = _split([leaf(*xs) for xs in zip(
        leaves, tree_flatten(grads)[0], tree_flatten(state_sum)[0])],
        treedef, 2)
    return _keep(noop, params, p_new), _keep(noop, state_sum, h_new)
