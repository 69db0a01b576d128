"""``apex-tpu-torch-serve``: a scripted request stream through the port's
engine — counterpart of ``apex_tpu/serve/cli.py`` for its single-engine
path.

    apex-tpu-torch-serve --config small --dtype bf16 --requests 8

Random GPT-2 weights are made from ``--seed``; prompts of ``--prompt-len``
random token ids, one per request. Runs on ``cuda`` unless ``--device
cpu`` is given (then on the kernels' plain versions). Prints one JSON
object: the run summary, each request's record, the device and the
kernel launch counts. Exit code 2 on a usage error.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List, Optional

import numpy as np
import torch


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="apex-tpu-torch-serve",
        description="run a scripted token-id request stream through the "
                    "apex_tpu_torch serve engine")
    ap.add_argument("--config", default="tiny",
                    choices=["tiny", "small", "xl"],
                    help="GPT2Config preset (default tiny)")
    ap.add_argument("--dtype", default="fp32", choices=["fp32", "bf16"],
                    help="compute dtype (default fp32)")
    ap.add_argument("--num-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64,
                    help="per-slot context bound (prompt + generated)")
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=4,
                    help="scripted request count")
    ap.add_argument("--prompt-len", type=int, default=8,
                    help="scripted prompt length")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the engine runs (default cuda; cpu runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    from apex_tpu_torch.models.convert import init_gpt2_params
    from apex_tpu_torch.models.gpt2 import GPT2Config
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.serve.engine import Engine, EngineConfig
    from apex_tpu_torch.serve.scheduler import Request, ServeScheduler
    from apex_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = getattr(GPT2Config, args.config)()
    cfg = dataclasses.replace(
        cfg, compute_dtype=(torch.float32 if args.dtype == "fp32"
                            else torch.bfloat16))
    max_len = min(args.max_len, cfg.n_positions)
    if max_len < args.max_len:
        print(f"apex-tpu-torch-serve: --max-len {args.max_len} clamped to "
              f"the model's n_positions={max_len}", file=sys.stderr)
    if args.requests < 1 or args.num_slots < 1:
        print("apex-tpu-torch-serve: --requests and --num-slots must be "
              ">= 1", file=sys.stderr)
        return 2
    rng = np.random.RandomState(args.seed)
    plen = max(1, min(args.prompt_len, max_len - 1))
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, plen)]
               for _ in range(args.requests)]

    engine = Engine(cfg, init_gpt2_params(cfg, seed=args.seed),
                    EngineConfig(num_slots=args.num_slots, max_len=max_len,
                                 temperature=args.temperature,
                                 top_k=args.top_k),
                    seed=args.seed, device=device)
    sched = ServeScheduler(engine)
    for i, toks in enumerate(prompts):
        sched.submit(Request(request_id=f"req-{i}", tokens=toks,
                             max_new_tokens=args.max_new_tokens,
                             eos_id=args.eos_id))
    _build.reset_launches()
    stats = sched.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(json.dumps({
        "summary": stats.summary(),
        "requests": stats.requests,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "kernel_launches": dict(_build.launches),
    }, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
