"""Prefill + one-token decode over the slot KV cache — counterpart of
``apex_tpu/serve/engine.py`` (``EngineConfig`` and ``Engine``).

- ``prefill`` runs the *same* single-token forward
  (:func:`~apex_tpu_torch.models.gpt2.gpt2_token_forward`) position by
  position over the prompts at the full ``[num_slots]`` width, with the
  slots that are not being admitted masked off — the JAX engine's
  ``lax.scan``, written as a loop. There is no separate prefill path, so a
  token's logits in prefill and in decode come from identical arithmetic.
  The loop stops at the longest prompt; the JAX scan runs on to the pow2
  bucket, and the extra steps there write nothing and change nothing.
- ``decode_step`` feeds every active slot its last token and samples the
  next one.
- ``evict`` frees slots by resetting their lengths.

Sampling is greedy at ``temperature == 0``, else temperature / top-k
sampling from the engine's own ``torch.Generator`` (seeded at build and on
:meth:`Engine.reset`); the JAX engine's PRNG keys give other numbers from
the same seed, so only greedy streams can be compared across the two.

The engine runs on ``cuda`` unless it is built with ``device="cpu"``. It
works under ``torch.inference_mode()``. The options of the JAX engine that
belong to later slices of the port (paged cache, prefix cache, tensor
parallelism, speculative decoding, decode policies, KV quantization)
raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from apex_tpu_torch.models.gpt2 import GPT2, GPT2Config, gpt2_token_forward
from apex_tpu_torch.serve import kv_cache
from apex_tpu_torch.serve.attention import resolve_block_k
from apex_tpu_torch.utils.device import DeviceLike, resolve_device

# EngineConfig fields whose JAX features are not ported yet, with the
# value that leaves them off
_LATER = {"page_size": None, "num_pages": None, "prefix_cache": False,
          "tp": 1, "spec_draft_len": 0, "decode_policy": None,
          "kv_quant": None}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving-side knobs (the model config stays ``GPT2Config``)."""

    num_slots: int = 4
    max_len: Optional[int] = None      # default: model n_positions
    temperature: float = 1.0           # 0 => greedy argmax
    top_k: int = 0                     # 0 => full vocab
    block_k: Optional[int] = None      # decode-attention KV chunk
    # keep per-position prefill logits (parity checks / scoring):
    # O(P * B * V) memory
    keep_prefill_logits: bool = False
    # later slices of the port (ROADMAP.md): any other value raises
    page_size: Optional[int] = None
    num_pages: Optional[int] = None
    prefix_cache: bool = False
    tp: int = 1
    spec_draft_len: int = 0
    decode_policy: Optional[str] = None
    kv_quant: Optional[str] = None


class Engine:
    """A servable GPT-2: the slot cache plus prefill / decode.

    ``params`` is the port's parameter dict
    (:func:`~apex_tpu_torch.models.convert.init_gpt2_params` or
    :func:`~apex_tpu_torch.models.convert.params_from_jax`), loaded onto
    ``device``, or a :class:`~apex_tpu_torch.models.gpt2.GPT2` already on
    it."""

    def __init__(self, model_cfg: GPT2Config,
                 params: Union[GPT2, Dict[str, torch.Tensor]],
                 config: EngineConfig = EngineConfig(), *, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        for name, off in _LATER.items():
            if getattr(config, name) != off:
                raise NotImplementedError(
                    f"EngineConfig.{name}={getattr(config, name)!r}: not "
                    f"ported yet — the paged / prefix cache, tensor "
                    f"parallelism, speculative decoding, decode policies "
                    f"and KV quantization come in later slices of the "
                    f"port (ROADMAP.md)")
        self.model_cfg = model_cfg
        self.config = config
        if isinstance(params, GPT2):
            if params.device != self.device:
                raise ValueError(f"model is on {params.device}, engine "
                                 f"device is {self.device}")
            self.model = params
        else:
            self.model = GPT2.from_params(model_cfg, params,
                                          device=self.device)
        self.max_len = int(config.max_len or model_cfg.n_positions)
        if self.max_len > model_cfg.n_positions:
            raise ValueError(
                f"max_len={self.max_len} exceeds the model's "
                f"n_positions={model_cfg.n_positions}")
        self.block_k = resolve_block_k(self.max_len, config.block_k)
        self._init_state(seed)

    def _init_state(self, seed: int) -> None:
        """All mutable serving state (shared by __init__ and reset)."""
        c = self.model_cfg
        b = self.config.num_slots
        self.cache = kv_cache.init_cache(
            c.n_layer, b, self.max_len, c.n_head, c.n_embd // c.n_head,
            c.compute_dtype, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self.last_tokens = np.zeros((b,), np.int32)
        # host mirror of cache.lengths: decode_step checks the context
        # bound without reading the device
        self._host_lengths = np.zeros((b,), np.int64)
        self.decode_calls = 0
        self.prefill_calls = 0
        self.prefill_requests = 0
        self.prefill_scanned_tokens = 0

    def reset(self, seed: int = 0) -> "Engine":
        """Drop all serving state: empty cache, fresh generator."""
        self._init_state(seed)
        return self

    # ------------------------------------------------------------ steps
    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        t = float(self.config.temperature)
        k = int(self.config.top_k)
        if t <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        scaled = logits.float() / t
        if 0 < k < logits.shape[-1]:
            kth = torch.topk(scaled, k, dim=-1).values[..., -1:]
            scaled = torch.where(scaled < kth, -1e30, scaled)
        probs = torch.softmax(scaled, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0] \
            .to(torch.int32)

    def _token_step(self, tokens, positions, mask):
        logits, _ = gpt2_token_forward(self.model_cfg, self.model,
                                       self.cache, tokens, positions, mask,
                                       block_k=self.block_k)
        return logits

    def _dev(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    @torch.inference_mode()
    def prefill(self, prompts: Dict[int, Sequence[int]]):
        """Insert ``{slot: prompt token ids}``: reset the target slots,
        run the single-token forward over the prompt positions (the other
        slots masked off) and sample each admitted slot's first token.
        Returns ``(first_tokens [B] np.ndarray, last_logits [B, vocab],
        all_logits [P, B, vocab] | None)``; only the admitted slots' rows
        are meaningful."""
        if not prompts:
            raise ValueError("prefill needs at least one slot: prompt")
        b = self.config.num_slots
        max_p = max(len(t) for t in prompts.values())
        if max_p < 1:
            raise ValueError("empty prompt")
        tokens = np.zeros((b, max_p), np.int64)
        admit = np.zeros((b,), bool)
        lens = np.zeros((b,), np.int64)
        for slot, toks in prompts.items():
            if not 0 <= slot < b:
                raise ValueError(f"slot {slot} out of range 0..{b - 1}")
            if len(toks) > self.max_len:
                raise ValueError(
                    f"prompt of {len(toks)} tokens exceeds max_len="
                    f"{self.max_len}")
            tokens[slot, :len(toks)] = np.asarray(toks, np.int64)
            admit[slot] = True
            lens[slot] = len(toks)

        toks_d = self._dev(tokens, torch.long)
        admit_d = self._dev(admit, torch.bool)
        lens_d = self._dev(lens, torch.long)
        kv_cache.reset_slots(self.cache, admit_d)
        last_logits = torch.zeros((b, self.model_cfg.vocab_size),
                                  dtype=torch.float32, device=self.device)
        kept = []
        for p in range(max_p):
            write = admit_d & (p < lens_d)
            positions = torch.where(write, p, self.cache.lengths.long())
            logits = self._token_step(toks_d[:, p], positions, write)
            last_logits = torch.where(write[:, None], logits, last_logits)
            if self.config.keep_prefill_logits:
                kept.append(logits)
        kv_cache.set_lengths(self.cache, admit_d, lens_d)
        first = self._sample(last_logits).cpu().numpy()
        self.prefill_calls += 1
        self.prefill_requests += len(prompts)
        self.prefill_scanned_tokens += max_p
        self.last_tokens = np.where(admit, first, self.last_tokens)
        self._host_lengths = np.where(admit, lens, self._host_lengths)
        all_logits = torch.stack(kept) if kept else None
        return first, last_logits, all_logits

    @torch.inference_mode()
    def decode_step(self, last_tokens, active):
        """One decode step for every slot: feed each active slot its last
        token, get its next. ``last_tokens`` ``[num_slots]`` int,
        ``active`` ``[num_slots]`` bool. Returns ``(next_tokens
        np.ndarray, logits [num_slots, vocab] fp32 tensor)``."""
        act_np = np.asarray(active, bool)
        full = act_np & (self._host_lengths >= self.max_len)
        if full.any():
            # the cache write would clip and overwrite the newest K/V row
            raise ValueError(
                f"slot(s) {np.flatnonzero(full).tolist()} are at max_len="
                f"{self.max_len}; evict before decoding further")
        act = self._dev(act_np, torch.bool)
        positions = self.cache.lengths.long()
        logits = self._token_step(self._dev(last_tokens, torch.long),
                                  positions, act)
        next_tokens = self._sample(logits)
        kv_cache.advance(self.cache, act)
        next_np = next_tokens.cpu().numpy()
        self.decode_calls += 1
        self.last_tokens = np.where(act_np, next_np, self.last_tokens)
        self._host_lengths = self._host_lengths + act_np
        return next_np, logits

    @torch.inference_mode()
    def evict(self, slots) -> None:
        """Free the given slot indices."""
        mask = np.zeros((self.config.num_slots,), bool)
        mask[np.asarray(list(slots), np.int64)] = True
        kv_cache.evict_slots(self.cache, self._dev(mask, torch.bool))
        self._host_lengths = np.where(mask, 0, self._host_lengths)

    @property
    def lengths(self) -> np.ndarray:
        return self.cache.lengths.cpu().numpy()

    @property
    def resident_tokens(self) -> int:
        """Cache tokens live across all slots (host mirror)."""
        return int(self._host_lengths.sum())
