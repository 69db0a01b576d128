#!/usr/bin/env python3
"""One element of the bf16 flash backward's dv, term by term, on both sides.

    python3 -m tools.flash_dv_probe [--index B,H,KEY,COL]

Needs a CUDA card (about 40 GB of its memory). Rebuilds the inputs of the
card test ``test_bf16_flash_bwd_at_256_over_65535_batch_heads`` (its
generator seed 19, 1025 x 64 heads of 64 x 256, causal, dropout 0.1 with
seed 23, the port's forward for o and lse) and, at one element of dv
(by default the one that test reports, (237, 12, 2, 10)):

- the kernel's and the plain version's dv there, and their difference;
- for every query i, the term of that sum on each side: the plain
  version's fp32 score s, p = exp(s - lse), the keep factor, bf16(p *
  keep) as its dV product takes it, and dO[i, col]; the kernel's bf16(p *
  keep), read back through a probe backward whose dO is one-hot (column c
  of the probe's dO is 1 at query c and 0 elsewhere, so the kernel's dv
  at (key, c) is its bf16(p * keep) of query c, exactly);
- the queries whose bf16(p * keep) differ, with how far the plain
  version's p * keep lies from the bf16 rounding midpoint between the two
  values (in units of that bf16 spacing), and the sum of those flips times
  dO, which accounts for the difference if the flips are its cause.

Prints one JSON line, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--index", default="237,12,2,10")
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_dv_probe: no CUDA card", file=sys.stderr)
        return 2
    from apex_tpu_torch.ops.flash_attention import (
        _bwd_p, _scores, dropout_keep, flash_attention_bwd,
        flash_attention_bwd_plain, flash_attention_fwd)
    bi, hi, key, col = (int(x) for x in a.index.split(","))
    dev = torch.device("cuda", 0)
    b, h, s, d = 1025, 64, 64, 256
    rate, seed_value = 0.1, 23
    g = torch.Generator(device=dev).manual_seed(19)
    q, k, v, do = (torch.randn(b, h, s, d, device=dev, generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    seed = torch.tensor([seed_value], dtype=torch.int32, device=dev)
    kw = dict(scale=d ** -0.5, causal=True, dropout_p=rate,
              dropout_seed=seed)
    o, lse = flash_attention_fwd(q, k, v, **kw)
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)[2][
        bi, hi, key, col].float().item()
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)[2][
        bi, hi, key, col].float().item()
    torch.cuda.empty_cache()

    # the plain version's terms, for the one (batch, head) slice
    qs, ks = q[bi:bi + 1, hi:hi + 1], k[bi:bi + 1, hi:hi + 1]
    sc = _scores(qs, ks, d ** -0.5, True, None)[0, 0]
    p = _bwd_p(sc[None, None], lse[bi:bi + 1, hi:hi + 1])[0, 0]
    keep = dropout_keep(seed, bi * h + hi, 0, 0, s, s, rate, device=dev)
    pk_plain = (p * keep).to(torch.bfloat16).float()

    # the kernel's bf16(p * keep): a probe backward over batches 0..bi
    # (the slice keeps its flat batch * head index, so its dropout mask)
    n = bi + 1
    probe = torch.zeros(n, h, s, d, device=dev, dtype=torch.bfloat16)
    probe[bi, hi, torch.arange(s), torch.arange(s)] = 1
    dv_probe = flash_attention_bwd(q[:n], k[:n], v[:n], o[:n], lse[:n],
                                   probe, **kw)[2]
    pk_kernel = dv_probe[bi, hi, :, :s].float().t()  # [query, key]

    terms, flips = [], []
    for i in range(key, s):
        pp, kk = pk_plain[i, key].item(), pk_kernel[i, key].item()
        dov = do[bi, hi, i, col].float().item()
        exact = (p[i, key] * keep[i, key]).item()
        rec = {"query": i, "s": sc[i, key].item(), "p": p[i, key].item(),
               "keep": keep[i, key].item(), "p_keep": exact,
               "plain_bf16": pp, "kernel_bf16": kk, "dO": dov}
        terms.append(rec)
        if pp != kk:
            spacing = abs(pp - kk)
            mid = (pp + kk) / 2
            flips.append(dict(rec, spacings_from_midpoint=(exact - mid)
                              / spacing, delta=(kk - pp) * dov))
    out = {"index": [bi, hi, key, col], "kernel_dv": got, "plain_dv": want,
           "difference": got - want,
           "allowed": 1e-2 + 2 ** -6 * abs(want),
           "flips": flips, "flips_sum": sum(f["delta"] for f in flips),
           "terms_plain_sum": sum(t["plain_bf16"] * t["dO"] for t in terms),
           "terms_kernel_sum": sum(t["kernel_bf16"] * t["dO"]
                                   for t in terms),
           "terms": terms}
    print(json.dumps(out), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
