#!/usr/bin/env python3
"""Where the bf16 flash forward's o departs from the whole-row plain version.

    python3 -m tools.flash_p_rounding

Needs a CUDA card. The online softmax rounds p to bf16 against the
running row max and rescales when a later key tile raises it (the TPU
kernel's algorithm); the plain version rounds against the row's max.
For each case of the card test ``test_flash_head_dims_match_plain``
named below (its seeds and shapes), prints the elements of o past FA_TOL
(and the largest difference) for kernel vs plain, kernel vs a 64-key-tile
online reference written here in PyTorch, and that reference vs plain,
and how many elements of o the kernel and the reference differ in at
all. A kernel that rounds against the running max matches the online
reference; one that takes each row's exact max first (the d = 256
forward's two passes) matches the plain version.
"""

import torch

from apex_tpu_torch.ops.flash_attention import (
    _keep_all, _scores, flash_attention_fwd, flash_attention_fwd_plain)

FA_TOL = (2e-3, 2 ** -7)       # chip_smoke.py's bf16 FA_TOL
TILE = 64                      # the tensor-core kernels' key tile
# (d, form): the card test's "dbias" case (a learned bias with dropout)
# and "causal" case
CASES = [(192, "dbias"), (160, "dbias"), (256, "dbias"), (128, "dbias"),
         (192, "causal")]


def online(q, k, v, scale, causal, bias, p, seed):
    """o of the online softmax over TILE-key tiles, p rounded to v's
    dtype against the running max, l from the undropped p."""
    s = _scores(q, k, scale, causal, bias)
    keep = _keep_all(seed, q, k, p) if p > 0 else torch.ones_like(s)
    b, h, sq, sk = s.shape
    m = torch.full((b, h, sq, 1), -1e30, device=q.device)
    l = torch.zeros(b, h, sq, 1, device=q.device)
    acc = torch.zeros(b, h, sq, v.shape[-1], device=q.device)
    for t in range(0, sk, TILE):
        st = s[..., t:t + TILE]
        mt = torch.maximum(m, st.amax(-1, keepdim=True))
        ms = torch.where(mt <= -0.5e30, 0.0, mt)
        alpha = torch.exp(torch.where(m <= -0.5e30, -1e30, m) - ms)
        pt = torch.exp(st - ms)
        l = l * alpha + pt.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(
            (pt * keep[..., t:t + TILE]).to(v.dtype).float(),
            v[..., t:t + TILE, :].float())
        m = mt
    return (acc / torch.where(l > 0, l, 1.0)).to(q.dtype)


def past(a, b):
    d = (a.float() - b.float()).abs()
    return (int((d > FA_TOL[0] + FA_TOL[1] * b.float().abs()).sum()),
            d.max().item())


def main():
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    for d, form in CASES:
        b, h, sq, sk = (2, 3, 129, 200) if form == "dbias" else (2, 3, 200,
                                                                 200)
        g = torch.Generator(device=dev).manual_seed(d * 7 + sq)
        q, k, v, _ = (torch.randn(b, h, s, d, device=dev, generator=g)
                      .to(torch.bfloat16) for s in (sq, sk, sk, sq))
        bias = (torch.randn(1, h, sq, sk, device=dev, generator=g)
                if form == "dbias" else None)
        rate = 0.1 if form == "dbias" else 0.0
        seed = torch.tensor([d - sq], dtype=torch.int32, device=dev)
        kw = dict(scale=d ** -0.5, causal=True, bias=bias)
        if rate:
            kw.update(dropout_p=rate, dropout_seed=seed)
        o, _ = flash_attention_fwd(q, k, v, **kw)
        op, _ = flash_attention_fwd_plain(q, k, v, **kw)
        oo = online(q, k, v, d ** -0.5, True, bias, rate, seed)
        print(f"d={d} {form}: kernel-plain {past(o, op)} kernel-online "
              f"{past(o, oo)} online-plain {past(oo, op)} kernel != online "
              f"{int((o != oo).sum())} of {o.numel()}", flush=True)


if __name__ == "__main__":
    main()
