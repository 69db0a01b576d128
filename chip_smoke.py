#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``apex_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout around this
file; it imports no JAX. Phases, each printing one JSON line (``phase``):

1. ``env``: the card (``nvidia-smi`` name and power limit), torch / CUDA
   versions, and the build of every ``apex_tpu_torch/csrc/*.cu`` for
   ``sm_90a`` from the checkout, with its seconds.
2. ``kernel``: each CUDA kernel against its plain PyTorch version on the
   same card inputs, at the main path's shapes and a few ragged ones, in
   bf16 and fp32: max error and tolerance; kernel / plain / library times
   on the device (``ms``: the summed durations of the kernels each call
   ran, from torch.profiler) and per call as a caller sees them
   (``call_ms``: CUDA events around a loop, host dispatch included),
   with inputs rotated through more than the 50 MB L2; and the least
   time the card could take (bytes at 3.35 TB/s, operations at
   989 TFLOP/s bf16 or 67 TFLOP/s fp32).
3. ``forward``: GPT-2 small in bf16, batch 4 x 1024 tokens, through
   ``GPT2``: exactly 25 LayerNorm and 12 flash-attention launches, logits
   held against the same weights in fp32 on the CPU (plain versions) and
   in fp32 on the card, tokens/s, and the device time by kind of kernel.
4. ``serve``: ``ServeScheduler(Engine(GPT-2 small bf16, 4 slots, max_len
   1024, greedy))`` answers 8 requests (prompts of 16..256 tokens, 32 new
   tokens each); every request completes and the LayerNorm kernel runs
   25 times per token step. A decode step's wall time is set beside the
   device's busy time. Then an fp32 engine's per-position prefill logits
   are held against the full forward's at the same positions.
5. ``cli``: ``apex-tpu-torch-serve --config small --dtype bf16
   --requests 8`` in process.

Then a ``{"kernels": [...]}`` line (launches counted over the main path:
the forward of phase 3 plus the serve run of phase 4, each with the
counts zeroed just before it), the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero without that last line; without CUDA, or away from the
checkout, it exits 2 at once.
"""

from __future__ import annotations

import dataclasses
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS = {"bf16": 989e12,        # dense tensor-core bf16
            "fp32": 67e12}         # fp32 outside the tensor cores
L2_BYTES = 50e6
# tolerances of the kernel-vs-plain checks (see the kernel phase)
LN_TOL = {"fp32": (1e-5, 1e-5), "bf16": (1e-5, 2 ** -7)}   # (atol, rtol)
FA_TOL = {"fp32": (2e-5, 0.0), "bf16": (2e-3, 2 ** -7)}
LSE_TOL = 2e-5
FWD_BF16_REL_L2 = 5e-2   # bf16 card logits vs fp32 CPU, relative L2
FWD_FP32_ATOL = 1e-3     # fp32 card logits vs fp32 CPU
SERVE_FP32_ATOL = 1e-3   # fp32 engine prefill logits vs full forward


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "measures the port on a CUDA card", file=sys.stderr)
        return 2
    if not (ROOT / "apex_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no apex_tpu_torch/csrc beside {__file__}; run "
              f"it from a checkout of the repository", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F

    from apex_tpu_torch.models.convert import init_gpt2_params
    from apex_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_fwd_plain)
    from apex_tpu_torch.ops.layer_norm_kernel import ln_fwd, ln_fwd_plain
    from apex_tpu_torch.serve import cli
    from apex_tpu_torch.serve.engine import Engine, EngineConfig
    from apex_tpu_torch.serve.scheduler import Request, ServeScheduler

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    card = f"{kind}, {smi.split(',')[-1].strip()} limit"

    # ---------------------------------------------------------- 1. build
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t0
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         sources=[p.relative_to(ROOT).as_posix() for p in _build.sources()],
         nvcc_flags=_build.NVCC_FLAGS, build_s=build_s)

    # ------------------------------------------------ 2. kernel vs plain
    def bench_ms(fn, sets, reps):
        """Mean ms of ``fn(*sets[i % len(sets)])`` over ``reps`` calls
        between two CUDA events, after a warm-up: the time per call as a
        caller sees it, host dispatch included."""
        for a in sets[:2]:
            fn(*a)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for i in range(reps):
            fn(*sets[i % len(sets)])
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    def device_profile(fn):
        """Run ``fn()`` under torch.profiler; returns ``{kernel name: us}``,
        the summed durations of the device kernels it ran."""
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                out[ev.name] = (out.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us())
        return out

    def device_ms(fn, sets, reps):
        """Mean device ms per call of ``fn``: the summed durations of the
        kernels it launched (torch.profiler), over ``reps`` calls."""
        for a in sets[:2]:
            fn(*a)

        def loop():
            for i in range(reps):
                fn(*sets[i % len(sets)])

        kern = device_profile(loop)
        require(bool(kern), "torch.profiler recorded no device kernel")
        return sum(kern.values()) / 1e3 / reps

    def by_kind(kern):
        """Device ms of a profile, summed by kind of kernel."""
        out = {"flash": 0.0, "layer_norm": 0.0, "matmul": 0.0,
               "other": 0.0}
        for name, us in kern.items():
            low = name.lower()
            cat = ("flash" if "fa_fwd_kernel" in name else
                   "layer_norm" if "ln_fwd_kernel" in name else
                   "matmul" if any(s in low for s in (
                       "gemm", "cutlass", "xmma", "nvjet", "cublas"))
                   else "other")
            out[cat] += us / 1e3
        out["total"] = sum(out.values())
        return out

    def timed(fn, sets, reps):
        return {"ms": device_ms(fn, sets, reps),
                "call_ms": bench_ms(fn, sets, reps)}

    def n_sets(bytes_per_set):
        """Input copies to cycle so each call finds its data out of L2."""
        return int(min(16, max(2, math.ceil(2 * L2_BYTES / bytes_per_set))))

    def bound(nbytes, ops, dt):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = ops / PEAK_OPS[dt]
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")

    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16}
    gen = torch.Generator(device=dev).manual_seed(0)
    summary = {}

    def ln_case(rows, hidden, dt, main=False):
        es = torch.tensor([], dtype=tdt[dt]).element_size()
        nbytes = rows * hidden * 2 * es + 2 * hidden * 4 + rows * 8
        sets = []
        for _ in range(n_sets(nbytes)):
            x = (torch.randn(rows, hidden, device=dev, generator=gen) * 2
                 + 0.5).to(tdt[dt])
            g = torch.randn(hidden, device=dev, generator=gen)
            b = torch.randn(hidden, device=dev, generator=gen)
            sets.append((x, g, b))
        x, g, b = sets[0]
        y, mu, iv = ln_fwd(x, g, b, eps=1e-5)
        yp, mup, ivp = ln_fwd_plain(x, g, b, eps=1e-5)
        torch.cuda.synchronize()
        atol, rtol = LN_TOL[dt]
        dy = (y.float() - yp.float()).abs()
        ok_y = bool((dy <= atol + rtol * yp.float().abs()).all())
        err_stats = max((mu - mup).abs().max().item(),
                        ((iv - ivp).abs() / ivp.abs()).max().item())
        require(ok_y and err_stats <= 1e-5,
                f"ln_fwd {rows}x{hidden} {dt}: y err {dy.max().item()} "
                f"(atol {atol} rtol {rtol}), stats err {err_stats}")
        reps = 50
        kt = timed(lambda x, g, b: ln_fwd(x, g, b, eps=1e-5), sets, reps)
        pt = timed(lambda x, g, b: ln_fwd_plain(x, g, b, eps=1e-5), sets,
                   reps // 5)
        # the library call takes gamma / beta in x's dtype: cast once here
        lsets = [(x, g.to(x.dtype), b.to(x.dtype)) for x, g, b in sets]
        lt = timed(lambda x, g, b: F.layer_norm(x, (hidden,), g, b, 1e-5),
                   lsets, reps)
        bms, by = bound(nbytes, 8 * rows * hidden, "fp32")
        rec = dict(kernel="ln_fwd", rows=rows, hidden=hidden, dtype=dt,
                   max_abs_err=dy.max().item(), stats_err=err_stats,
                   tol={"atol": atol, "rtol": rtol}, ms=kt["ms"],
                   plain_ms=pt["ms"], library_ms=lt["ms"], bound_ms=bms,
                   bound_by=by, call_ms=kt["call_ms"],
                   plain_call_ms=pt["call_ms"],
                   library_call_ms=lt["call_ms"], bytes=nbytes)
        emit("kernel", **rec)
        if main:
            summary["ln_fwd"] = rec

    def fa_case(b, h, sq, sk, causal, dt, main=False):
        d = 64
        es = torch.tensor([], dtype=tdt[dt]).element_size()
        nbytes = b * h * (2 * sq + 2 * sk) * d * es + b * h * sq * 4
        pairs = (sum(min(i + 1, sk) for i in range(sq)) if causal
                 else sq * sk)
        ops = 4 * b * h * d * pairs
        sets = [tuple(torch.randn(b, h, s, d, device=dev, generator=gen)
                      .to(tdt[dt]) for s in (sq, sk, sk))
                for _ in range(n_sets(nbytes))]
        q, k, v = sets[0]
        scale = 1.0 / math.sqrt(d)
        o, lse = flash_attention_fwd(q, k, v, scale=scale, causal=causal)
        op, lsep = flash_attention_fwd_plain(q, k, v, scale=scale,
                                             causal=causal)
        torch.cuda.synchronize()
        atol, rtol = FA_TOL[dt]
        do = (o.float() - op.float()).abs()
        ok_o = bool((do <= atol + rtol * op.float().abs()).all())
        dl = (lse - lsep).abs().max().item()
        require(ok_o and dl <= LSE_TOL,
                f"fa_fwd {b}x{h}x{sq}x{sk} causal={causal} {dt}: o err "
                f"{do.max().item()} (atol {atol} rtol {rtol}), lse err {dl}")
        reps = 30
        kt = timed(lambda q, k, v: flash_attention_fwd(
            q, k, v, scale=scale, causal=causal), sets, reps)
        pt = timed(lambda q, k, v: flash_attention_fwd_plain(
            q, k, v, scale=scale, causal=causal), sets, 5)
        # SDPA's causal mask is top-left aligned like the kernel's, and
        # it returns o only (no lse): the same o for this yardstick
        lt = timed(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale), sets, reps)
        bms, by = bound(nbytes, ops, dt)
        rec = dict(kernel="fa_fwd", b=b, h=h, sq=sq, sk=sk, causal=causal,
                   dtype=dt, max_abs_err=do.max().item(), lse_err=dl,
                   tol={"atol": atol, "rtol": rtol, "lse_atol": LSE_TOL},
                   ms=kt["ms"], plain_ms=pt["ms"], library_ms=lt["ms"],
                   bound_ms=bms, bound_by=by, call_ms=kt["call_ms"],
                   plain_call_ms=pt["call_ms"],
                   library_call_ms=lt["call_ms"], bytes=nbytes, flops=ops)
        emit("kernel", **rec)
        if main:
            summary["fa_fwd"] = rec

    with torch.inference_mode():
        for dt in ("bf16", "fp32"):
            ln_case(4 * 1024, 768, dt, main=dt == "bf16")
            ln_case(4, 768, dt)
            ln_case(1000, 768, dt)
            ln_case(37, 1600, dt)
            for causal in (True, False):
                fa_case(4, 12, 1024, 1024, causal, dt,
                        main=dt == "bf16" and causal)
            fa_case(4, 12, 1000, 1000, True, dt)
            fa_case(2, 3, 200, 333, False, dt)

    # ------------------------------------------------------ 3. forward
    cfg = GPT2Config.small()
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    n_layer = cfg.n_layer
    ln_per_fwd = 2 * n_layer + 1
    params = init_gpt2_params(cfg, seed=0)
    model = GPT2.from_params(cfg, params, device=dev)
    model32 = GPT2.from_params(cfg32, params, device=dev)
    cpu_gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 1024), generator=cpu_gen)
    tok_d = tokens.to(dev)
    main_launches = {}
    with torch.inference_mode():
        model(tok_d[:, :16])       # first touch of cuBLAS etc.
        torch.cuda.synchronize()
        _build.reset_launches()
        logits = model(tok_d)
        torch.cuda.synchronize()
        fwd_launches = dict(_build.launches)
        require(fwd_launches == {"ln_fwd": ln_per_fwd, "fa_fwd": n_layer},
                f"forward launches {fwd_launches}, expected "
                f"{ln_per_fwd} ln_fwd and {n_layer} fa_fwd")
        require(logits.shape == (4, 1024, cfg.vocab_size)
                and logits.dtype == torch.float32
                and bool(torch.isfinite(logits).all()),
                "forward logits not finite / wrong shape")
        for name, n in fwd_launches.items():
            main_launches[name] = main_launches.get(name, 0) + n
        fwd_ms = bench_ms(lambda t: model(t), [(tok_d,)], 5)
        fwd_busy = by_kind(device_profile(lambda: model(tok_d)))
        ref = GPT2.from_params(cfg32, params, device="cpu")(tokens[:1])
        card32 = model32(tok_d[:1]).cpu()
        lb = logits[:1].cpu()
        rel_l2 = ((lb - ref).norm() / ref.norm()).item()
        err32 = (card32 - ref).abs().max().item()
        require(rel_l2 <= FWD_BF16_REL_L2,
                f"bf16 forward vs fp32 CPU: relative L2 {rel_l2}")
        require(err32 <= FWD_FP32_ATOL,
                f"fp32 forward on the card vs fp32 CPU: max abs {err32}")
        del logits, ref, card32, lb
    emit("forward", config="GPT2Config.small", dtype="bf16",
         batch=4, seq=1024, launches=fwd_launches,
         bf16_vs_cpu_fp32_rel_l2=rel_l2, bf16_rel_l2_tol=FWD_BF16_REL_L2,
         fp32_card_vs_cpu_max_abs=err32, fp32_atol=FWD_FP32_ATOL,
         ms=fwd_ms, tokens_per_s=4 * 1024 / fwd_ms * 1e3,
         device_busy_ms=fwd_busy, idle_share=1 - fwd_busy["total"] / fwd_ms,
         card=card)

    # -------------------------------------------------------- 4. serve
    prompt_lens = [16, 256, 48, 128, 200, 32, 96, 64]
    new_tokens = 32
    eng = Engine(cfg, model, EngineConfig(num_slots=4, max_len=1024,
                                          temperature=0.0), device=dev)
    eng.prefill({0: [1, 2, 3]})    # first touch, then a clean engine
    eng.reset()
    rng = np.random.default_rng(2)
    sched = ServeScheduler(eng)
    for i, n in enumerate(prompt_lens):
        sched.submit(Request(request_id=f"req-{i}",
                             tokens=rng.integers(0, cfg.vocab_size, n)
                             .tolist(), max_new_tokens=new_tokens))
    torch.cuda.synchronize()
    _build.reset_launches()
    stats = sched.run()
    torch.cuda.synchronize()
    serve_launches = dict(_build.launches)
    decode_steps = eng.decode_calls
    prefill_steps = eng.prefill_scanned_tokens
    steps = decode_steps + prefill_steps
    done = [r for r in stats.requests if r["state"] == "completed"
            and r["finish_reason"] == "length"
            and r["new_tokens"] == new_tokens]
    require(len(done) == len(prompt_lens),
            f"serve: {len(done)} of {len(prompt_lens)} requests completed "
            f"with {new_tokens} tokens: {stats.requests}")
    require(serve_launches.get("ln_fwd", 0) == ln_per_fwd * steps > 0,
            f"serve: ln_fwd launches {serve_launches}, expected "
            f"{ln_per_fwd} x {steps} token steps")
    for name, n in serve_launches.items():
        main_launches[name] = main_launches.get(name, 0) + n
    summ = stats.summary()

    # where a decode step's time goes: 4 active slots at 64 cached tokens,
    # wall per step (host clock) against the device's busy time (profile)
    eng.reset()
    eng.prefill({s: rng.integers(0, cfg.vocab_size, 64).tolist()
                 for s in range(4)})
    active = np.ones(4, bool)

    def decode(n):
        for _ in range(n):
            eng.decode_step(eng.last_tokens, active)

    decode(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode(8)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 8 * 1e3
    step_busy = {k: v / 8 for k, v in
                 by_kind(device_profile(lambda: decode(8))).items()}

    # fp32 cross-check: per-position prefill logits == full forward's
    eng32 = Engine(cfg32, model32, EngineConfig(
        num_slots=2, max_len=1024, temperature=0.0,
        keep_prefill_logits=True), device=dev)
    p0, p1 = tokens[0, :64].tolist(), tokens[1, :40].tolist()
    _, _, kept = eng32.prefill({0: p0, 1: p1})
    with torch.inference_mode():
        full = model32(tok_d[:2, :64])
    serve_err = max((kept[:64, 0] - full[0]).abs().max().item(),
                    (kept[:40, 1] - full[1, :40]).abs().max().item())
    require(serve_err <= SERVE_FP32_ATOL,
            f"fp32 engine prefill logits vs full forward: {serve_err}")
    del eng32, kept, full
    emit("serve", config="GPT2Config.small", dtype="bf16", num_slots=4,
         max_len=1024, requests=len(prompt_lens), prompt_lens=prompt_lens,
         new_tokens=new_tokens, launches=serve_launches, token_steps=steps,
         decode_steps=decode_steps, prefill_steps=prefill_steps,
         decode_tokens_per_s=summ["tokens_per_s"],
         p50_step_ms=summ["p50_step_ms"], p99_step_ms=summ["p99_step_ms"],
         ttft_p50_ms=summ["ttft_p50_ms"], ttft_p99_ms=summ["ttft_p99_ms"],
         wall_s=summ["wall_s"], decode_step_ms=step_ms,
         decode_step_device_busy_ms=step_busy,
         decode_idle_share=1 - step_busy["total"] / step_ms,
         fp32_prefill_vs_forward_max_abs=serve_err,
         fp32_atol=SERVE_FP32_ATOL, card=card)

    # ---------------------------------------------------------- 5. cli
    rc = cli.main(["--config", "small", "--dtype", "bf16", "--requests",
                   "8"])
    require(rc == 0, f"apex-tpu-torch-serve exited {rc}")
    emit("cli", argv="--config small --dtype bf16 --requests 8", rc=rc)

    replaces = {
        "ln_fwd": ("apex_tpu_torch/csrc/layer_norm.cu",
                   "apex_tpu/ops/pallas/layer_norm_kernel.py:102"),
        "fa_fwd": ("apex_tpu_torch/csrc/flash_attention.cu",
                   "apex_tpu/ops/pallas/flash_attention.py:430"),
    }
    kernels = []
    for name, (src, tpu) in replaces.items():
        rec = summary[name]
        require(main_launches.get(name, 0) > 0,
                f"{name} was not launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": main_launches[name],
            "launches_forward": fwd_launches.get(name, 0),
            "launches_serve": serve_launches.get(name, 0),
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "call_ms": rec["call_ms"],
            "shape": {k: rec[k] for k in ("rows", "hidden", "b", "h", "sq",
                                          "sk", "causal", "dtype")
                      if k in rec}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
