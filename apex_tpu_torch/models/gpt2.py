"""GPT-2 — counterpart of ``apex_tpu/models/gpt2.py``.

:class:`GPT2` is the full-sequence forward (``GPT2.__call__`` in the JAX
package): every ``FusedLayerNorm`` runs the LayerNorm kernel and the causal
attention runs the flash-attention kernel, 2 * n_layer + 1 and n_layer
launches per forward, and as many of their backward kernels per backward
(:func:`lm_loss` is the training loss). :func:`gpt2_token_forward` is the
serving engine's one-token-per-slot forward over the slot KV cache; it
reads the same parameters, runs the LayerNorm kernel too (2 * n_layer + 1
launches per step) and leaves decode attention to the chunked softmax of
:mod:`apex_tpu_torch.serve.attention`, as the JAX package leaves it to XLA.

Parameters are float32 and the matrix products use them in
``compute_dtype``, as the JAX model does; the LayerNorm parameters stay
float32. Without autograd (``torch.no_grad()`` /
``torch.inference_mode()``, as serving runs) the cast copies are made
once, on first use, and kept until the parameter is written again
(:func:`in_dtype`), so a decode step does not cast the 50257 x 768
embedding anew. While autograd records, each forward casts each weight
once as an ordinary graph op, as the JAX model does, so the gradient
reaches the fp32 parameter.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.normalization.fused_layer_norm import (
    FusedLayerNorm, fused_layer_norm_affine)
from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.transformer.fused_dense import (dense_gelu_dense,
                                                    matmul_f32)
from apex_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    compute_dtype: torch.dtype = torch.bfloat16

    @classmethod
    def tiny(cls):
        return cls(vocab_size=1024, n_positions=256, n_embd=256, n_layer=2,
                   n_head=4)

    @classmethod
    def small(cls):
        return cls()

    @classmethod
    def xl(cls):  # GPT-2 1.5B
        return cls(n_embd=1600, n_layer=48, n_head=25)


def in_dtype(mod: nn.Module, name: str, dtype: torch.dtype) -> torch.Tensor:
    """Parameter ``name`` of ``mod`` in ``dtype``. While autograd records
    the parameter, a cast in the graph. Otherwise a copy kept on ``mod``
    and made again only when the parameter's storage or version changes
    (``load_state_dict``, ``.to()`` and the trainer's update change one of
    them)."""
    p = getattr(mod, name)
    if p.dtype == dtype:
        return p
    if torch.is_grad_enabled() and p.requires_grad:
        return p.to(dtype)
    casts = mod.__dict__.setdefault("_casts", {})
    stamp = (p.data_ptr(), p._version)
    hit = casts.get((name, dtype))
    if hit is None or hit[0] != stamp:
        hit = casts[(name, dtype)] = (stamp, p.detach().to(dtype))
    return hit[1]


class Dense(nn.Module):
    """``y = x @ weight.T + bias`` in the compute dtype (flax ``nn.Dense``
    with ``dtype=compute_dtype``); weight stored ``(out, in)`` float32."""

    def __init__(self, in_f: int, out_f: int, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_f, in_f, device=device))
        self.bias = nn.Parameter(torch.empty(out_f, device=device))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return (x.to(dtype) @ in_dtype(self, "weight", dtype).t()
                + in_dtype(self, "bias", dtype))


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config, *, device=None):
        super().__init__()
        e = cfg.n_embd
        self.cfg = cfg
        self.ln_1 = FusedLayerNorm(e, device=device)
        self.attn_qkv = Dense(e, 3 * e, device=device)
        self.attn_out = Dense(e, e, device=device)
        self.ln_2 = FusedLayerNorm(e, device=device)
        self.mlp_fc_w = nn.Parameter(torch.empty(4 * e, e, device=device))
        self.mlp_fc_b = nn.Parameter(torch.empty(4 * e, device=device))
        self.mlp_proj_w = nn.Parameter(torch.empty(e, 4 * e, device=device))
        self.mlp_proj_b = nn.Parameter(torch.empty(e, device=device))

    def mlp(self, y: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        return dense_gelu_dense(
            y, *(in_dtype(self, n, dt) for n in (
                "mlp_fc_w", "mlp_fc_b", "mlp_proj_w", "mlp_proj_b")))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        h, d = c.n_head, c.n_embd // c.n_head
        b, s, e = x.shape
        qkv = self.attn_qkv(self.ln_1(x), c.compute_dtype)

        def heads(t):
            return t.reshape(b, s, h, d).transpose(1, 2).contiguous()

        q, k, v = (heads(t) for t in qkv.split(e, dim=-1))
        o = flash_attention(q, k, v, True)
        o = o.transpose(1, 2).reshape(b, s, e)
        x = x + self.attn_out(o, c.compute_dtype)
        return x + self.mlp(self.ln_2(x))


class GPT2(nn.Module):
    """GPT-2 with the flax model's parameter names (see
    :mod:`apex_tpu_torch.models.convert`). Built empty on ``device``
    (default ``cuda``); fill it with :meth:`from_params`."""

    def __init__(self, cfg: GPT2Config, *, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        e = cfg.n_embd
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, e, device=dev))
        self.wpe = nn.Parameter(torch.empty(cfg.n_positions, e, device=dev))
        self.h = nn.ModuleList(Block(cfg, device=dev)
                               for _ in range(cfg.n_layer))
        self.ln_f = FusedLayerNorm(e, device=dev)

    @classmethod
    def from_params(cls, cfg: GPT2Config, params: Dict[str, torch.Tensor],
                    *, device: DeviceLike = None) -> "GPT2":
        """A model holding ``params`` (a dict from
        :func:`~apex_tpu_torch.models.convert.params_from_jax` or
        :func:`~apex_tpu_torch.models.convert.init_gpt2_params`)."""
        model = cls(cfg, device=device)
        model.load_state_dict(params, strict=True)
        return model

    @property
    def device(self) -> torch.device:
        return self.wte.device

    def forward(self, tokens: torch.Tensor, return_hidden: bool = False,
                position_offset: int = 0) -> torch.Tensor:
        """``tokens (b, s)`` int. Token column ``j`` reads
        ``wpe[position_offset + j]``; ``position_offset + s`` must not
        exceed ``n_positions``. Returns fp32 logits ``(b, s, vocab)``, or
        the final hidden states in the compute dtype."""
        c = self.cfg
        dt = c.compute_dtype
        s = tokens.shape[1]
        off = int(position_offset)
        if off < 0 or off + s > c.n_positions:
            raise ValueError(f"positions {off}..{off + s - 1} outside the "
                             f"table of n_positions={c.n_positions}")
        wte = in_dtype(self, "wte", dt)
        if torch.is_grad_enabled() and self.wte.requires_grad:
            # gather the fp32 rows, then cast (the JAX order): the
            # embedding gradient is summed into the fp32 table
            x = self.wte[tokens].to(dt) + self.wpe[off:off + s].to(dt)[None]
        else:
            x = wte[tokens] + in_dtype(self, "wpe", dt)[off:off + s][None]
        for blk in self.h:
            x = blk(x)
        x = self.ln_f(x)
        if return_hidden:
            return x
        return matmul_f32(x, wte)


def lm_loss(model: GPT2, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens (b, s)`` under ``model``
    (``lm_loss`` of the JAX package): fp32 logits through
    :func:`~apex_tpu_torch.contrib.xentropy.softmax_cross_entropy_loss`."""
    logits = model(tokens)
    return softmax_cross_entropy_loss(logits[:, :-1],
                                      tokens[:, 1:]).mean()


def gpt2_token_forward(cfg: GPT2Config, model: GPT2, cache, tokens,
                       positions, write_mask, *,
                       block_k: Optional[int] = None):
    """One decode token per slot through GPT-2 with the slot KV cache.

    ``tokens`` / ``positions`` / ``write_mask``: ``[num_slots]`` (int, int,
    bool) on the model's device. Each masked slot's K/V is written into
    ``cache`` at ``positions[slot]`` (in place) and the slot attends over
    cached positions ``0..positions[slot]``; masked-off slots compute
    values that are discarded and write nothing. Returns ``(logits
    [num_slots, vocab] fp32, cache)``."""
    from apex_tpu_torch.serve.attention import cached_attention
    from apex_tpu_torch.serve.kv_cache import write_token

    c = cfg
    dt = c.compute_dtype
    h, d, e = c.n_head, c.n_embd // c.n_head, c.n_embd
    pos = positions.long()
    wte = in_dtype(model, "wte", dt)
    x = (wte[tokens]
         + in_dtype(model, "wpe", dt)[pos.clamp(0, c.n_positions - 1)])
    for i, blk in enumerate(model.h):
        y = fused_layer_norm_affine(x, blk.ln_1.weight, blk.ln_1.bias, e)
        q, k, v = blk.attn_qkv(y, dt).split(e, dim=-1)
        q, k, v = (t.reshape(-1, h, d) for t in (q, k, v))
        write_token(cache, i, k, v, pos, write_mask)
        o = cached_attention(q, cache.k[i], cache.v[i], pos, block_k=block_k)
        x = x + blk.attn_out(o.reshape(-1, e), dt)
        y = fused_layer_norm_affine(x, blk.ln_2.weight, blk.ln_2.bias, e)
        x = x + blk.mlp(y)
    x = fused_layer_norm_affine(x, model.ln_f.weight, model.ln_f.bias, e)
    return matmul_f32(x, wte), cache
