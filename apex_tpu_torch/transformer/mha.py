"""Multi-head attention modules — counterpart of
``apex_tpu/transformer/mha.py`` (the capability of apex's
``fast_multihead_attn``).

- :func:`mha_reference`: unfused attention, fp32 logits by
  ``torch.matmul``, the megatron softmax kernels (causal or masked), fp32
  ``probs @ v`` cast to q's dtype. The JAX package's oracle for flash.
- :class:`SelfMultiheadAttn`: fused QKV projection (``qkv``), optional
  RoPE on q and k, flash attention, output projection (``out``).
- :class:`EncdecMultiheadAttn`: projections ``q`` and ``kv``, flash
  attention, ``out``.

The submodules carry the flax modules' names; their ``weight`` is the
flax ``kernel`` transposed (``models/convert.py`` ``mha_params_from_jax``).
The projections compute in the input's dtype, the parameters cast to it,
as flax's ``Dense(dtype=x.dtype)`` does. The modules run flash attention
as in the JAX package, never :func:`mha_reference`. A ``dropout_seed``
(an int or a one-element integer tensor, varied per step) switches on
attention dropout at ``dropout_p`` inside the flash kernels, the JAX
modules' training mode; without a seed dropout is off (eval), as in JAX.
The modules build at any head dim on either device, as the JAX ones do;
on the card flash runs every head dim up to 128 (64 and 128 as they are,
others zero-padded) and a wider head raises ``NotImplementedError`` at
the call.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.transformer.fused_dense import dense_param, zeros_param
from apex_tpu_torch.transformer.rope import fused_rope_cached
from apex_tpu_torch.transformer.softmax import (
    scaled_masked_softmax, scaled_upper_triang_masked_softmax)
from apex_tpu_torch.utils.device import DeviceLike, resolve_device


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = False, mask: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Unfused attention over ``(b, h, s, d)`` q / k / v through the
    megatron softmax ops; ``mask`` nonzero = masked, broadcastable to
    ``(b, h, sq, sk)``."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if causal:
        probs = scaled_upper_triang_masked_softmax(logits, s)
    else:
        probs = scaled_masked_softmax(logits, mask, s)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


class Dense(nn.Module):
    """flax ``nn.Dense``'s port: ``weight (out, in)`` (the flax kernel
    transposed, lecun normal) and ``bias`` (zeros), computed in the input's
    dtype."""

    def __init__(self, in_features: int, out_features: int,
                 param_dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.weight = dense_param(out_features, in_features, device,
                                  param_dtype)
        self.bias = zeros_param(out_features, device, param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def _head_dim(name: str, embed_dim: int, num_heads: int) -> int:
    if embed_dim % num_heads:
        raise ValueError(f"{name}: embed_dim {embed_dim} is not a multiple "
                         f"of num_heads {num_heads}")
    return embed_dim // num_heads


def rope_tables(s: int, d: int, theta: float, device):
    """The module's RoPE ``(cos, sin)``, ``(s, 1, 1, d)`` fp32: position
    times ``theta ** (-2i / d)``, the frequencies repeated over both
    halves."""
    pos = torch.arange(s, dtype=torch.float32, device=device)
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                  device=device) / d)
    f = pos[:, None] * inv[None, :]
    f = torch.cat([f, f], dim=-1)[:, None, None, :]
    return torch.cos(f), torch.sin(f)


def apply_rope_bhsd(t: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor) -> torch.Tensor:
    """:func:`fused_rope_cached` on a ``(b, h, s, d)`` tensor (the sequence
    moved first and back)."""
    return fused_rope_cached(t.permute(2, 0, 1, 3), cos, sin).permute(
        1, 2, 0, 3)


class SelfMultiheadAttn(nn.Module):
    """Self-attention, ``fast_multihead_attn``'s ``SelfMultiheadAttn``:
    input ``(b, s, e)``; ``qkv`` projection, RoPE on q and k with
    ``use_rope``, flash attention (causal or full, an optional boolean
    mask, True = masked), ``out`` projection. Built on ``device`` (default
    ``cuda``) in ``param_dtype``."""

    def __init__(self, embed_dim: int, num_heads: int, causal: bool = False,
                 use_rope: bool = False, rope_theta: float = 10000.0,
                 dropout_p: float = 0.0, param_dtype=torch.float32, *,
                 device: DeviceLike = None):
        super().__init__()
        self.head_dim = _head_dim("SelfMultiheadAttn", embed_dim, num_heads)
        device = resolve_device(device)
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.causal, self.use_rope = causal, use_rope
        self.rope_theta, self.dropout_p = rope_theta, dropout_p
        self.qkv = Dense(embed_dim, 3 * embed_dim, param_dtype, device)
        self.out = Dense(embed_dim, embed_dim, param_dtype, device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                dropout_seed=None) -> torch.Tensor:
        b, s, e = x.shape
        h, d = self.num_heads, self.head_dim
        # the rate flash runs at: 0 without a seed (eval), as in JAX
        p = self.dropout_p if dropout_seed is not None else 0.0
        q, k, v = self.qkv(x).split(e, dim=-1)
        q, k, v = (t.reshape(b, s, h, d).transpose(1, 2) for t in (q, k, v))
        if self.use_rope:
            cos, sin = rope_tables(s, d, self.rope_theta, x.device)
            q, k = apply_rope_bhsd(q, cos, sin), apply_rope_bhsd(k, cos, sin)
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            self.causal, mask=mask, dropout_p=p,
                            dropout_seed=dropout_seed)
        return self.out(o.transpose(1, 2).reshape(b, s, e))


class EncdecMultiheadAttn(nn.Module):
    """Cross-attention, ``fast_multihead_attn``'s ``EncdecMultiheadAttn``:
    ``q`` projection of the query ``(b, sq, e)``, ``kv`` projection of the
    keys / values ``(b, sk, e)``, flash attention with an optional boolean
    mask (True = masked), ``out`` projection."""

    def __init__(self, embed_dim: int, num_heads: int,
                 dropout_p: float = 0.0, param_dtype=torch.float32, *,
                 device: DeviceLike = None):
        super().__init__()
        self.head_dim = _head_dim("EncdecMultiheadAttn", embed_dim,
                                  num_heads)
        device = resolve_device(device)
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout_p = dropout_p
        self.q = Dense(embed_dim, embed_dim, param_dtype, device)
        self.kv = Dense(embed_dim, 2 * embed_dim, param_dtype, device)
        self.out = Dense(embed_dim, embed_dim, param_dtype, device)

    def forward(self, query: torch.Tensor, key_value: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                dropout_seed=None) -> torch.Tensor:
        b, sq, e = query.shape
        sk = key_value.shape[1]
        h, d = self.num_heads, self.head_dim
        p = self.dropout_p if dropout_seed is not None else 0.0
        q = self.q(query).reshape(b, sq, h, d).transpose(1, 2)
        k, v = self.kv(key_value).split(e, dim=-1)
        k = k.reshape(b, sk, h, d).transpose(1, 2)
        v = v.reshape(b, sk, h, d).transpose(1, 2)
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            False, mask=mask, dropout_p=p,
                            dropout_seed=dropout_seed)
        return self.out(o.transpose(1, 2).reshape(b, sq, e))
