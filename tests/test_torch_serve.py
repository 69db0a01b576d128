"""Port parity: the serving engine and scheduler (apex_tpu_torch vs
apex_tpu) on ``GPT2Config.tiny()`` in fp32, greedy.

One flax init feeds both engines. Prefill's last logits and every decode
step's logits are held to 1e-4; the greedy token streams of four requests
through two slots (backfill, one mid-stream abort) must be equal token
for token. Equality is only meaningful when no argmax sits on a near-tie,
so the smallest top-1 / top-2 logit gap seen on these inputs is checked
to be far above the logit tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from apex_tpu.serve.engine import (Engine as JaxEngine, EngineConfig as
                                   JaxEngineConfig, init_gpt2_params as
                                   jax_init_params)
from apex_tpu.serve.scheduler import (Request as JaxRequest,
                                      ServeScheduler as JaxScheduler)
from apex_tpu_torch.models.convert import params_from_jax
from apex_tpu_torch.models.gpt2 import GPT2Config
from apex_tpu_torch.serve.engine import Engine, EngineConfig
from apex_tpu_torch.serve.scheduler import Request, ServeScheduler

JCFG = dataclasses.replace(JaxGPT2Config.tiny(), compute_dtype=jnp.float32)
TCFG = dataclasses.replace(GPT2Config.tiny(), compute_dtype=torch.float32)
MAX_LEN, BLOCK_K = 64, 32
LOGIT_TOL = 1e-4
# the smallest top-1 / top-2 logit gaps these inputs produce on the port
# are 5.6e-3 (prefill / decode test) and 8.6e-3 (stream test); holding
# them above 20x the logit tolerance makes token equality a real check and
# not luck
MIN_GAP = 20 * LOGIT_TOL


@pytest.fixture(scope="module")
def params():
    jp = jax_init_params(JCFG, seed=0)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


class _GapEngine(Engine):
    """The port's engine, recording the top-2 logit gap of every row
    it samples from."""

    gaps: list

    def prefill(self, prompts):
        first, last, all_ = super().prefill(prompts)
        self.gaps.append(_top2_gap(last[sorted(prompts)].numpy()))
        return first, last, all_

    def decode_step(self, last_tokens, active):
        nxt, logits = super().decode_step(last_tokens, active)
        self.gaps.append(_top2_gap(logits[np.asarray(active)].numpy()))
        return nxt, logits


def _engines(params, num_slots):
    jp, tp = params
    je = JaxEngine(JCFG, jp, JaxEngineConfig(
        num_slots=num_slots, max_len=MAX_LEN, temperature=0.0,
        block_k=BLOCK_K, keep_prefill_logits=True))
    te = _GapEngine(TCFG, tp, EngineConfig(
        num_slots=num_slots, max_len=MAX_LEN, temperature=0.0,
        block_k=BLOCK_K, keep_prefill_logits=True), device="cpu")
    te.gaps = []
    return je, te


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, JCFG.vocab_size, int(rng.integers(3, 12)))
            .tolist() for _ in range(n)]


def _top2_gap(logits) -> float:
    top = np.sort(np.asarray(logits, np.float64), axis=-1)[..., -2:]
    return float(np.min(top[..., 1] - top[..., 0]))


def test_prefill_and_decode_logits_match_jax(params):
    je, te = _engines(params, num_slots=3)
    prompts = {0: _prompts(3)[0], 2: _prompts(3)[2]}
    fj, lj, allj = je.prefill(prompts)
    ft, lt, allt = te.prefill(prompts)
    np.testing.assert_array_equal(ft[[0, 2]], np.asarray(fj)[[0, 2]])
    for s in prompts:
        np.testing.assert_allclose(lt[s].numpy(), np.asarray(lj)[s],
                                   atol=LOGIT_TOL, rtol=0)
        n = len(prompts[s])
        np.testing.assert_allclose(allt[:n, s].numpy(),
                                   np.asarray(allj)[:n, s],
                                   atol=LOGIT_TOL, rtol=0)
    np.testing.assert_array_equal(te.lengths, np.asarray(je.lengths))
    active = np.array([True, False, True])
    for _ in range(6):
        nj, lgj = je.decode_step(je.last_tokens, active)
        nt, lgt = te.decode_step(te.last_tokens, active)
        np.testing.assert_array_equal(nt[active], np.asarray(nj)[active])
        np.testing.assert_allclose(lgt[active].numpy(),
                                   np.asarray(lgj)[active],
                                   atol=LOGIT_TOL, rtol=0)
    assert min(te.gaps) > MIN_GAP, min(te.gaps)


def _drive(sched_cls, req_cls, engine, prompts):
    """4 requests through 2 slots: backfill as requests finish, and
    req-1 aborted after the third decode step."""
    sched = sched_cls(engine)
    for i, toks in enumerate(prompts):
        sched.submit(req_cls(request_id=f"req-{i}", tokens=toks,
                             max_new_tokens=8 + 3 * i))
    for _ in range(3):
        sched.step()
    assert sched.abort("req-1")
    stats = sched.run()
    return {r["request_id"]: (r["state"], r["finish_reason"],
                              r["generated"]) for r in stats.requests}


def test_greedy_streams_equal_jax_with_backfill_and_abort(params):
    je, te = _engines(params, num_slots=2)
    prompts = _prompts(4, seed=3)
    got_j = _drive(JaxScheduler, JaxRequest, je, prompts)
    got_t = _drive(ServeScheduler, Request, te, prompts)
    assert got_t == got_j
    assert got_t["req-1"][:2] == ("evicted", "aborted")
    assert sum(s == "completed" for s, _, _ in got_t.values()) == 3
    # backfill happened: 4 requests were served through 2 slots
    assert te.prefill_requests == 4
    assert min(te.gaps) > MIN_GAP, min(te.gaps)


def test_context_full_and_eos_ends_match_jax(params):
    """A request that runs into max_len ends with ``context``; an EOS id
    ends one early — identically in both schedulers."""
    je, te = _engines(params, num_slots=2)
    long_prompt = np.random.default_rng(5).integers(
        0, JCFG.vocab_size, MAX_LEN - 4).tolist()
    out = []
    for sched_cls, req_cls, eng in ((JaxScheduler, JaxRequest, je),
                                    (ServeScheduler, Request, te)):
        sched = sched_cls(eng)
        sched.submit(req_cls(request_id="ctx", tokens=long_prompt,
                             max_new_tokens=100))
        stats = sched.run()
        out.append([(r["finish_reason"], r["generated"])
                    for r in stats.requests])
    assert out[0] == out[1]
    assert out[1][0][0] == "context"
    assert len(out[1][0][1]) == 4
    eos = out[1][0][1][1]
    for eng, sched_cls, req_cls in ((je, JaxScheduler, JaxRequest),
                                    (te, ServeScheduler, Request)):
        eng.reset()
        sched = sched_cls(eng)
        sched.submit(req_cls(request_id="eos", tokens=long_prompt,
                             max_new_tokens=100, eos_id=eos))
        rec = sched.run().requests[0]
        assert rec["finish_reason"] == "eos"
        assert rec["generated"][-1] == eos
