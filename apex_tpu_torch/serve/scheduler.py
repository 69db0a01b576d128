"""Continuous-batching request scheduler — counterpart of
``apex_tpu/serve/scheduler.py`` (``Request``, ``ServeStats``,
``ServeScheduler``).

The serving loop between decode steps, in host Python:

admission queue -> slot assignment (one batched prefill) -> decode ->
per-slot termination (EOS / max new tokens / context full) -> eviction ->
backfill from the queue -> next decode step.

Ported: admission, backfill, the three ends of a request, mid-stream
abort and the shutdown drain, with the JAX scheduler's accounting.
Not ported yet (ROADMAP.md): the tick journal and warm restart, admission
control and deadlines, live metrics, tracing, the event bus, speculative
decoding and the paged-pool hooks.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np

from apex_tpu_torch.serve.engine import Engine


def percentile(values, p: float) -> float:
    """Exact nearest-rank percentile (the JAX package's rule): the value
    at 1-based rank ``ceil(p * n)`` of the sorted values; 0.0 when
    empty."""
    vals = sorted(values)
    if not vals:
        return 0.0
    rank = max(1, math.ceil(p * len(vals)))
    return vals[min(rank, len(vals)) - 1]


# eq=False: the queue holds request objects, not values
@dataclasses.dataclass(eq=False)
class Request:
    """One generation request and its accounting."""

    request_id: Any
    tokens: Sequence[int]                  # prompt token ids
    max_new_tokens: int = 16
    eos_id: Optional[int] = None

    # filled in by the scheduler
    generated: List[int] = dataclasses.field(default_factory=list)
    state: str = "queued"     # queued | running | completed | evicted
    finish_reason: Optional[str] = None    # eos|length|context|aborted|...
    slot: Optional[int] = None
    submit_t: Optional[float] = None
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_t is None or self.submit_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def latency_s(self) -> Optional[float]:
        if self.done_t is None or self.submit_t is None:
            return None
        return self.done_t - self.submit_t

    def record(self) -> Dict[str, Any]:
        out = {"request_id": self.request_id, "state": self.state,
               "finish_reason": self.finish_reason,
               "prompt_tokens": len(self.tokens),
               "new_tokens": len(self.generated),
               "generated": list(self.generated)}
        for k in ("ttft_s", "latency_s"):
            v = getattr(self, k)
            if v is not None:
                out[k] = round(v, 6)
        lat = self.latency_s
        if lat and self.generated:
            out["tokens_per_s"] = round(len(self.generated) / lat, 3)
        return out


@dataclasses.dataclass
class ServeStats:
    """Aggregate accounting over a scheduler run."""

    requests: List[Dict[str, Any]]
    decode_steps: int
    decode_step_s: List[float]
    decode_tokens: int          # tokens produced BY decode steps
    total_new_tokens: int       # plus each request's prefill-sampled one
    wall_s: float
    admitted: int = 0
    peak_resident_tokens: int = 0

    def summary(self) -> Dict[str, Any]:
        lat = list(self.decode_step_s)
        ttfts = [r["ttft_s"] for r in self.requests if "ttft_s" in r]
        decode_s = sum(lat)
        return {
            "requests": len(self.requests),
            "completed": sum(r["state"] == "completed"
                             for r in self.requests),
            "evicted": sum(r["state"] == "evicted" for r in self.requests),
            "decode_steps": self.decode_steps,
            "new_tokens": self.total_new_tokens,
            "peak_resident_tokens": self.peak_resident_tokens,
            # decode-produced tokens over decode-step time only: the
            # prefill-sampled first tokens ride TTFT
            "tokens_per_s": round(self.decode_tokens / decode_s, 3)
            if decode_s else 0.0,
            "p50_step_ms": round(percentile(lat, 0.50) * 1e3, 3),
            "p99_step_ms": round(percentile(lat, 0.99) * 1e3, 3),
            "ttft_p50_ms": round(percentile(ttfts, 0.50) * 1e3, 3),
            "ttft_p99_ms": round(percentile(ttfts, 0.99) * 1e3, 3),
            "wall_s": round(self.wall_s, 6),
        }


class ServeScheduler:
    """Drive an :class:`Engine` over a request stream with continuous
    batching. :meth:`submit` and :meth:`abort` may be called from other
    threads while :meth:`run` drives the loop: one reentrant lock
    serializes every queue / slot mutation, so such a call lands between
    ticks."""

    def __init__(self, engine: Engine):
        self.engine = engine
        self._lock = threading.RLock()
        self.queue: Deque[Request] = collections.deque()
        self.slots: List[Optional[Request]] = \
            [None] * engine.config.num_slots
        self.done: List[Request] = []
        self.decode_steps = 0
        self.decode_step_s: List[float] = []
        self.decode_tokens = 0
        self.admitted = 0
        self.peak_resident_tokens = 0
        self._to_evict: set = set()   # slots freed, device reset pending
        self._t0: Optional[float] = None

    # --------------------------------------------------------- admission
    def submit(self, req: Request) -> bool:
        """Enqueue ``req``; an empty prompt, or one that leaves no room to
        generate under ``max_len``, raises."""
        if not len(req.tokens):
            raise ValueError(f"request {req.request_id!r}: empty prompt")
        if len(req.tokens) >= self.engine.max_len:
            raise ValueError(
                f"request {req.request_id!r}: prompt of {len(req.tokens)} "
                f"tokens leaves no room to generate under max_len="
                f"{self.engine.max_len}")
        req.submit_t = time.perf_counter()
        req.state = "queued"
        with self._lock:
            self.queue.append(req)
        return True

    def _admit(self) -> None:
        """Fill free slots from the queue with ONE batched prefill and
        record each admitted request's first sampled token."""
        # caller holds self._lock (step())
        free = [i for i, r in enumerate(self.slots) if r is None]
        batch: Dict[int, Request] = {}
        while free and self.queue:
            slot = free.pop(0)
            req = self.queue.popleft()
            req.slot = slot
            self.slots[slot] = req
            batch[slot] = req
        if not batch:
            return
        now = time.perf_counter()
        for req in batch.values():
            req.admit_t = now
            req.state = "running"
            self.admitted += 1
        first, _last, _all = self.engine.prefill(
            {slot: req.tokens for slot, req in batch.items()})
        t_first = time.perf_counter()
        for slot, req in batch.items():
            req.first_token_t = t_first
            self._accept_token(req, int(first[slot]))

    # -------------------------------------------------------- lifecycle
    def _accept_token(self, req: Request, tok: int) -> None:
        # caller holds self._lock (step()/_admit())
        req.generated.append(tok)
        if req.eos_id is not None and tok == req.eos_id:
            self._finish(req, "eos")
        elif len(req.generated) >= req.max_new_tokens:
            self._finish(req, "length")
        elif len(req.tokens) + len(req.generated) >= self.engine.max_len:
            self._finish(req, "context")

    def _finish(self, req: Request, reason: str) -> None:
        req.state = "completed"
        req.finish_reason = reason
        req.done_t = time.perf_counter()
        self.done.append(req)
        self._release(req)

    def _evict(self, req: Request, reason: str) -> None:
        req.state = "evicted"
        req.finish_reason = reason
        req.done_t = time.perf_counter()
        self.done.append(req)
        self._release(req)

    def _release(self, req: Request) -> None:
        # the device-side length reset is deferred and batched: a slot
        # backfilled on the next tick needs no eviction at all (prefill
        # resets admitted slots itself)
        if req.slot is not None and self.slots[req.slot] is req:
            self.slots[req.slot] = None
            self._to_evict.add(req.slot)

    def _flush_evictions(self) -> None:
        """One engine.evict for every slot freed since the last flush,
        skipping slots a prefill already reclaimed."""
        pending = {s for s in self._to_evict if self.slots[s] is None}
        if pending:
            self.engine.evict(sorted(pending))
        self._to_evict.clear()

    def abort(self, request_id) -> bool:
        """Evict a running request or drop a queued one (reason
        ``aborted``); the other slots are untouched."""
        with self._lock:
            for req in list(self.queue):
                if req.request_id == request_id:
                    self.queue.remove(req)
                    self._evict(req, "aborted")
                    return True
            for req in self.slots:
                if req is not None and req.request_id == request_id:
                    self._evict(req, "aborted")
                    return True
            return False

    # ------------------------------------------------------------- steps
    def step(self) -> bool:
        """One tick: backfill -> one decode step -> per-slot termination
        -> eviction. Returns False when idle (nothing running or
        queued)."""
        with self._lock:
            if self._t0 is None:
                self._t0 = time.perf_counter()
            self._admit()
            self.peak_resident_tokens = max(self.peak_resident_tokens,
                                            self.engine.resident_tokens)
            active = np.array([r is not None for r in self.slots], bool)
            if not active.any():
                self._flush_evictions()
                return bool(self.queue)
            t0 = time.perf_counter()
            next_tokens, _logits = self.engine.decode_step(
                self.engine.last_tokens, active)
            dt = time.perf_counter() - t0
            self.decode_steps += 1
            self.decode_step_s.append(dt)
            self.peak_resident_tokens = max(self.peak_resident_tokens,
                                            self.engine.resident_tokens)
            self.decode_tokens += int(active.sum())
            for slot, req in enumerate(self.slots):
                if req is not None:
                    self._accept_token(req, int(next_tokens[slot]))
            self._flush_evictions()
            return any(r is not None for r in self.slots) \
                or bool(self.queue)

    def run(self, max_steps: Optional[int] = None) -> ServeStats:
        """Run until idle (or ``max_steps`` decode steps); unfinished
        requests are evicted with reason ``shutdown``."""
        while self.step():
            if max_steps is not None and self.decode_steps >= max_steps:
                break
        with self._lock:
            for req in list(self.queue) + [r for r in self.slots
                                           if r is not None]:
                if req in self.queue:
                    self.queue.remove(req)
                self._evict(req, "shutdown")
            self._flush_evictions()
        return self.stats()

    def stats(self) -> ServeStats:
        wall = (time.perf_counter() - self._t0) if self._t0 else 0.0
        records = [r.record() for r in self.done]
        return ServeStats(requests=records,
                          decode_steps=self.decode_steps,
                          decode_step_s=list(self.decode_step_s),
                          decode_tokens=self.decode_tokens,
                          total_new_tokens=sum(r["new_tokens"]
                                               for r in records),
                          wall_s=wall, admitted=self.admitted,
                          peak_resident_tokens=self.peak_resident_tokens)
