"""BERT — counterpart of ``apex_tpu/models/bert.py`` (the repository's
benchmark configuration 4: BERT-large MLM pretraining with FusedLAMB,
FusedRMSNorm and the fused cross-entropy).

An encoder of the port's fused pieces: bidirectional flash attention
(the flash kernels, with the padding mask as their bias operand), the
RMSNorm form of the LayerNorm kernels (``FusedRMSNorm``: one after the
embeddings and two per layer, so ``2 * layers + 1`` launches of each
LayerNorm kernel per forward / backward), the ``dense_gelu_dense`` MLP
and :func:`~apex_tpu_torch.contrib.xentropy.softmax_cross_entropy_loss`
for :func:`mlm_loss`. Parameters are float32 and the products run in
``compute_dtype`` (bf16 by default), as in the JAX model. Two places
differ from the port's GPT-2 on purpose, because the JAX BERT does:
the embedding sum is made in fp32 and then cast, and the logits are fp32
from bf16 operands (:func:`~apex_tpu_torch.transformer.fused_dense.
matmul_f32`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.models.gpt2 import Dense, in_dtype
from apex_tpu_torch.normalization.fused_layer_norm import FusedRMSNorm
from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.transformer.fused_dense import (dense_gelu_dense,
                                                    matmul_f32)
from apex_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    max_position_embeddings: int = 512
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    type_vocab_size: int = 2
    compute_dtype: torch.dtype = torch.bfloat16

    @classmethod
    def tiny(cls):
        return cls(vocab_size=1024, max_position_embeddings=128,
                   hidden_size=128, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=512)

    @classmethod
    def large(cls):
        """The published BERT-large widths."""
        return cls()


class BertLayer(nn.Module):
    """Attention, residual, RMSNorm, MLP, residual, RMSNorm (post-norm),
    with the flax layer's parameter names."""

    def __init__(self, cfg: BertConfig, *, device=None):
        super().__init__()
        e, i = cfg.hidden_size, cfg.intermediate_size
        self.cfg = cfg
        self.qkv = Dense(e, 3 * e, device=device)
        self.attn_out = Dense(e, e, device=device)
        self.attn_norm = FusedRMSNorm(e, device=device)
        self.mlp_fc_w = nn.Parameter(torch.empty(i, e, device=device))
        self.mlp_fc_b = nn.Parameter(torch.empty(i, device=device))
        self.mlp_proj_w = nn.Parameter(torch.empty(e, i, device=device))
        self.mlp_proj_b = nn.Parameter(torch.empty(e, device=device))
        self.mlp_norm = FusedRMSNorm(e, device=device)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        dt = c.compute_dtype
        h = c.num_attention_heads
        b, s, e = x.shape
        qkv = self.qkv(x, dt)

        def heads(t):
            return t.reshape(b, s, h, e // h).transpose(1, 2).contiguous()

        q, k, v = (heads(t) for t in qkv.split(e, dim=-1))
        o = flash_attention(q, k, v, False, mask=mask)
        o = o.transpose(1, 2).reshape(b, s, e)
        x = self.attn_norm(x + self.attn_out(o, dt))
        mlp = dense_gelu_dense(x, *(in_dtype(self, n, dt) for n in (
            "mlp_fc_w", "mlp_fc_b", "mlp_proj_w", "mlp_proj_b")))
        return self.mlp_norm(x + mlp)


class Bert(nn.Module):
    """BERT with the flax model's parameter names (see
    :mod:`apex_tpu_torch.models.convert`). Built empty on ``device``
    (default ``cuda``); fill it with :meth:`from_params`."""

    def __init__(self, cfg: BertConfig, *, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        e = cfg.hidden_size
        self.word_embeddings = nn.Parameter(
            torch.empty(cfg.vocab_size, e, device=dev))
        self.position_embeddings = nn.Parameter(
            torch.empty(cfg.max_position_embeddings, e, device=dev))
        self.token_type_embeddings = nn.Parameter(
            torch.empty(cfg.type_vocab_size, e, device=dev))
        self.emb_norm = FusedRMSNorm(e, device=dev)
        self.layer = nn.ModuleList(BertLayer(cfg, device=dev)
                                   for _ in range(cfg.num_hidden_layers))

    @classmethod
    def from_params(cls, cfg: BertConfig, params: Dict[str, torch.Tensor],
                    *, device: DeviceLike = None) -> "Bert":
        """A model holding ``params`` (a dict from
        :func:`~apex_tpu_torch.models.convert.bert_params_from_jax` or
        :func:`~apex_tpu_torch.models.convert.init_bert_params`)."""
        model = cls(cfg, device=device)
        model.load_state_dict(params, strict=True)
        return model

    @property
    def device(self) -> torch.device:
        return self.word_embeddings.device

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``input_ids (b, s)`` int; ``attn_mask (b, s)``, 1 = a real token,
        0 = padding (keys that no query attends to). Returns fp32 logits
        ``(b, s, vocab)``."""
        c = self.cfg
        s = input_ids.shape[1]
        x = self.word_embeddings[input_ids] \
            + self.position_embeddings[:s][None]
        if token_type_ids is not None:
            x = x + self.token_type_embeddings[token_type_ids]
        x = self.emb_norm(x.to(c.compute_dtype))
        mask = None
        if attn_mask is not None:
            # the flash kernels' operand: True = masked, (b, 1, 1, s),
            # streamed without expanding to (b, h, s, s)
            mask = (attn_mask == 0)[:, None, None, :]
        for layer in self.layer:
            x = layer(x, mask)
        return matmul_f32(x, in_dtype(self, "word_embeddings",
                                      c.compute_dtype))


def mlm_loss(model: Bert, input_ids: torch.Tensor, labels: torch.Tensor,
             ignore_index: int = -1) -> torch.Tensor:
    """Masked-LM loss (``mlm_loss`` of the JAX package): the fused
    cross-entropy with ``padding_idx=ignore_index`` zeroes the ignored
    positions, and the sum is divided by the count of the others (at least
    1)."""
    logits = model(input_ids)
    loss = softmax_cross_entropy_loss(logits, labels,
                                      padding_idx=ignore_index)
    n = torch.clamp_min((labels != ignore_index).sum(), 1)
    return loss.sum() / n
