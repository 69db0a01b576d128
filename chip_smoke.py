#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``apex_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout around this
file; it imports no JAX. Phases, each printing one JSON line (``phase``):

1. ``env``: the card (``nvidia-smi`` name and power limit), torch / CUDA
   versions, and the build of every ``apex_tpu_torch/csrc/*.cu`` for
   ``sm_90a`` from the checkout, with its seconds; ptxas's registers,
   spills and stack of the tensor-core flash kernels (every form at each
   compiled head width, 64, 128 and 256), of the fp32
   route's FMA-pipe forward (64) and backward pair, of its split-TF32
   forward (128, 256), of every instantiation of
   the LayerNorm backward's register form, of the one-pass GroupNorm's
   cluster route and of the two-pass pair's vector route (``-Xptxas
   -v``; the fp32 flash pair's and forwards' unbiased forms, the bf16
   forward and the bf16 backward pair at head dim 128 in every form,
   every register-form
   LayerNorm backward, the bf16 vector-route stats kernel and every
   vector-route apply kernel must spill nothing, and no tensor-core
   flash kernel may have its wgmma pipeline serialised); the resident
   blocks an SM of every form of the fp32 backward pair and of the
   split-TF32 forward, as their geometries claim.
2. ``kernel``: each CUDA kernel against its plain PyTorch version on the
   same card inputs, at the main path's shapes and a few ragged ones, in
   bf16 and fp32: max error and tolerance; kernel / plain / library times
   on the device (``ms``: the summed durations of the kernels each call
   ran, from torch.profiler) and per call as a caller sees them
   (``call_ms``: CUDA events around a loop, host dispatch included),
   with inputs rotated through more than the 50 MB L2; and the least
   time the card could take (bytes at 3.35 TB/s, operations at
   989 TFLOP/s bf16 or 67 TFLOP/s fp32, the split-TF32 forward's at 495 / 3
   TFLOP/s with its FMA bound beside). Kernels: LayerNorm forward and
   backward (LayerNorm at GPT-2's shapes and BERT-large's 4096 x 1024
   bf16; RMSNorm with and without gamma
   and LayerNorm without gamma at BERT-large's 4096 x 1024; LayerNorm and
   RMSNorm at 64 x 12288, the form for rows wider than 8192),
   flash-attention forward, its backward's dq and dk / dv kernels (one
   wrapper call launches both; each gets its own device time and bound,
   and the plain and library times are the whole backward's; bf16 runs
   the tensor-core forward, dq and dk / dv kernels, fp32 the FMA-pipe ones
   but the forward at 128 and 256 the split-TF32 one,
   each read from the profiler's kernel names; achieved TFLOP/s and the
   share of the bound beside each) at GPT-2's shapes, at BERT-large's
   32 x 16 x 128 x 64, plain, with a (b, 1, 1, sk) key-padding mask and
   with a full mask that masks whole rows, and at b * h = 65,600 (1025 x
   64 x 64 x 64 causal: the grid's y x z slices), with a census of that
   shape's bf16 o past FA_TOL (kernel and plain version each against
   float64) and of the score's summation-order error on the tensor cores
   against the bound the bf16 forward assumes; the flash kernels' dropout
   form (forward, dq, dk / dv at FA_DROP_RATE from a device seed) and
   the dq kernels' dlogits form (a learned bias's gradient) at GPT-2 XL's
   causal 4 x 25 x 1024 x 64, at BERT's shape with its key-padding mask
   and at 2 x 3 x 200 x 333 causal, in bf16 and fp32, each against its
   plain version (the same keep mask; the dlogits to DLOGITS_TOL), two
   runs identical, with SDPA (``dropout_p``; a float ``attn_mask`` that
   requires grad) as the library yardstick, and a one-hot v whose o is 0 exactly where the
   mask drops, the kept share within KEEP_SIGMAS binomial deviations;
   the six flash kernels at head dim 128 in every form at Cerebras-GPT
   1.3B's causal 2 x 16 x 2048 x 128 (plain, dropout, dlogits; the
   summary's d128 rows), at BERT's shape with its padding mask and 2 x 3
   x 200 x 333 causal, and the padded route at Cerebras-GPT 2.7B's 2 x 32
   x 2048 x 80 (``kernel_ms`` the kernel at 128, ``pad_ms`` / ``dvec_ms``
   the pad and slice copies, SDPA at d = 80), with the summation-order
   census again at d = 128 (half of its kOrderUnits = 32); the same at
   head dim 256, GPT-J 6B's causal 2 x 16 x 2048 x 256 (the summary's
   d256 rows), BERT's shape with its padding mask, 2 x 3 x 200 x 333
   causal, the padded route at Nemotron-4's d = 192 (1 x 8 x 2048, the
   d192 rows) and the census at d = 256 (half of 64);
   fused Adam over the GPT-2 small flat buffer; the two LAMB stages over the BERT-large flat
   buffer (334M fp32) and a ragged one, with two runs bit-identical and
   an overflow step that changes no bit; and the flat optimizer kernels
   of the ResNet path at ResNet-50's flat layout (25.6M fp32) and at a
   ragged one: fused SGD over every
   flag combination with fp32 and bf16 p, the master-weight Adam, the
   bf16 form of fused Adam, NovoGrad, Adagrad (both weight-decay modes),
   each held to the plain version's bits, two runs identical, an overflow
   step that changes no bit, with the library call beside it where one
   computes the same function (``torch._fused_sgd_``,
   ``torch._fused_adamw_`` plus a bf16 cast, ``torch._fused_adagrad_``);
   and the NHWC GroupNorm kernels (32 groups): one-pass at Stable
   Diffusion's 8 x 64 x 64 x 320 (bf16, SiLU) and the UNet stack's 8 x
   32 x 32 x 640, 8 x 16 x 16 x 1280 and 8 x 8 x 8 x 1280, stats + apply
   at 8 x 64 x 64 x 960 and the VAE decoder's 1 x 512 x 512 x 128, both
   algorithms at the JAX package's AOT shape 8 x 32 x 32 x 256 in fp32
   and bf16, the one-pass form for a slab over its gate, ragged forms
   (no affine, gamma only, no SiLU, a given tile), 75 x 75 latents (hw
   not a multiple of 8) on both routes, stats + apply in fp32 at 8 x 64 x
   64 x 960 and 2 x 75 x 75 x 960, and a group of mean 1000 and std
   0.01
   (finite, within 1e-4 of float64), each against its plain version, two
   runs bit-identical, with ``F.group_norm`` (+ ``F.silu``) on the NCHW
   view as the library yardstick; and the megatron softmax kernels
   (``softmax_fwd``, ``softmax_fwd_causal``, ``softmax_bwd``): GPT-2 XL's
   causal scores 4 x 25 x 1024 x 1024 in fp32 (as ``mha_reference`` feeds
   them), bf16 and fp16 with their backward, the megatron phase's
   cross-attention scores with its key-padding mask, the JAX package's
   AOT shape 128 x 1024 x 1024 fp32 (causal, a full bool mask, backward),
   a (b, 1, sq, sk) uint8 mask, a (1, h, sq, sk) mask, a padding mask
   that masks whole rows, rows of 16,385, 32,768 and 100,003 (the
   streaming form) and 4 x 25 x 1024 x 32768 bf16 (past 2^31 elements),
   each within SM_TOL of its plain version, two runs bit-identical, with
   ``torch.softmax`` / ``torch._softmax_backward_data`` as the library
   yardstick.
3. ``forward``: GPT-2 small in bf16, batch 4 x 1024 tokens, through
   ``GPT2``: exactly 25 LayerNorm and 12 flash-attention launches (the
   tensor-core forward, by the profiler's names), logits
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
6. ``train``: GPT-2 small (fp32 parameters, bf16 compute) trained by
   ``apex_tpu_torch.train.Trainer`` (``amp="dynamic"``) for 5 steps on
   one fixed 4 x 1024 batch: every loss finite and the last below the
   first; per step exactly 25 ``ln_fwd``, 25 ``ln_bwd``, 12 ``fa_fwd``,
   12 ``fa_bwd_dq``, 12 ``fa_bwd_dkv`` and 1 ``fused_adam`` launches,
   the flash forward, dq and dk / dv the tensor-core kernels;
   step ms, training tokens/s (batch x (seq - 1) per step), the device
   time of one more step by kind of kernel, its idle share, the peak
   device memory, and the time of the step's gradient packing into the
   flat buffer. An fp32 cross-check: one step's gradients of an fp32
   model at 2 x 256 tokens on the card against the same on the CPU
   (plain versions), per parameter. Then the trained model serves
   through ``Engine``: its prefill logits follow the trained weights,
   not the initial ones.
7. ``bert``: BERT-large (``BertConfig.large()``, fp32 parameters, bf16
   compute) pretrains with flat ``FusedLAMB`` (lr 1e-3, weight decay
   0.01) for 5 MLM steps on one fixed 32 x 128 batch (15 % of positions
   read id 103 and carry their token as label, the rest -1): every loss
   finite and the last below the first; per step exactly 49 ``ln_fwd``,
   49 ``ln_bwd``, 24 ``fa_fwd``, 24 ``fa_bwd_dq``, 24 ``fa_bwd_dkv`` and
   one launch of each LAMB stage (flash forward and dk / dv on the
   tensor cores); step ms, sequences/s and tokens/s, one
   more step's device time by kind and idle share, peak memory, gradient
   packing time, each LAMB stage's device ms against its bound. An fp32
   cross-check of one step's gradients (4 layers at full width, 2 x 128
   tokens, card vs CPU), and a padded batch: an fp32 BERT-large forward
   of 4 sequences of lengths 128 / 100 / 64 / 17 padded to 128 with
   ``attn_mask`` gives each sequence's own logits at its valid positions,
   and a backward through the mask gives finite gradients.
8. ``resnet``: ResNet-50 (fp32 parameters, bf16 compute, NHWC /
   channels-last) on one fixed batch of 128 random 224 x 224 x 3 images
   with labels in 0..999 from seed 0, the loss of
   ``examples/imagenet/main_amp.py`` through the port's
   ``DynamicGradScaler``: 5 flat ``FusedSGD`` steps of the imagenet
   recipe (lr 0.1 x 128 / 256, momentum 0.9, weight decay 1e-4), every
   loss finite and the fifth below the first, exactly one ``fused_sgd``
   launch a step; step ms, images/s, one more step's device time by kind
   and idle share, peak memory, ``fused_sgd``'s device ms against its
   bound, the gradient packing time. Then 3 steps each of master-weight
   ``FusedAdam`` over bf16 parameters (the parameters views of the bf16
   copy its kernel writes), ``FusedNovoGrad`` and ``FusedAdagrad``, one
   launch of their kernel a step; a forced overflow step through each of
   the four optimizers changes no bit of the flat buffers, the state or
   the step counter. Last, one step's gradients and new running
   statistics of a ResNet-50 at 2 x 64 x 64, card vs CPU, per tensor,
   beside two CPU runs that differ only in their thread count: held in
   float64, and reported in fp32 (where this network at initialisation
   amplifies summation order beyond any fp32 gate).
9. ``unet``: a stack of Stable Diffusion v1.5 UNet ResNet blocks
   (:func:`build_unet`: 320, 640, 1280, 1280 channels, 32 groups, and
   ``up_blocks.3.resnets.0``'s 960 -> 320) on one fixed batch of 8 random
   64 x 64 x 320 latents (bf16 NHWC, fp32 parameters), the MSE of two
   outputs against fixed targets through ``DynamicGradScaler`` and flat
   ``FusedAdam`` (lr 1e-4): 5 steps, every loss finite and the fifth below
   the first; per step exactly 9 ``gn_one_pass``, 1 ``gn_stats``, 1
   ``gn_apply`` and 1 ``fused_adam`` launches (the GroupNorm backward is
   tensor ops); step ms, images/s, one more step's device time by kind,
   its count of device kernels and idle share, each GroupNorm kernel's
   device ms, peak memory. Then 20 more steps for the spread of step
   times, each with the host's time to issue it (no sync inside a step:
   the count of synchronising calls is reported) and its thread's CPU
   time, to set the host beside the device's busy time. Then one
   step's fp32 gradients at batch 1, card vs CPU per tensor (relative L2
   1e-3), beside two CPU runs that differ only in their thread count.
10. ``megatron``: attention at GPT-2 XL's widths (1600 wide, 25 heads x
   64, 4 x 1024 tokens; BASELINE.md config 5). (a) the unfused causal
   layer, :func:`unfused_self_attention` on ``SelfMultiheadAttn``'s
   parameters (bf16 compute, fp32 parameters), 5 flat ``FusedAdam``
   steps (lr 1e-4) on an MSE through ``DynamicGradScaler``: every loss
   finite, the fifth below the first, exactly 1 ``softmax_fwd_causal``,
   1 ``softmax_bwd`` and 1 ``fused_adam`` launch a step and no flash
   launch; step ms, tokens/s, one more step's device time by kind, idle
   share, peak memory. (b) fp32 at batch 1: ``SelfMultiheadAttn`` (flash)
   against (a)'s unfused layer with the same weights (output and every
   parameter's gradient, relative L2 1e-4; the FMA-pipe flash kernels),
   the same module on a bf16 input (the tensor-core kernels; output
   within 5e-2 relative L2 of fp32, gradients finite), and
   ``mha_reference`` against
   ``flash_attention`` on the same q, k, v (FA_TOL / FA_BWD_TOL fp32).
   (c) ``EncdecMultiheadAttn`` at sq 1024 / sk 512 with a (4, 1, 1, 512)
   key-padding mask against :func:`unfused_encdec` (one ``softmax_fwd``
   and one ``softmax_bwd``; the module one launch of each flash kernel).
   (d) ``FusedDenseGeluDense(1600, 6400, 1600)`` and ``MLP([1600, 6400,
   1600])`` card vs CPU, and ``linear_cross_entropy`` over the XL head
   (4096 x 1600 against 1600 x 50257 fp32) against the dense head on the
   card and against itself on the CPU, with the peak memory of each head.
   (e) ``SelfMultiheadAttn(1600, 25, causal, RoPE, dropout_p=0.1)``, bf16
   compute, 5 flat ``FusedAdam`` steps through ``DynamicGradScaler`` with
   a new device seed each step: exactly one launch of each flash
   kernel's dropout form (tensor cores) and one ``fused_adam`` a step,
   losses finite and falling. (f) a learned (1, 25, 1024, 1024) fp32
   attention bias trained through ``flash_attention(bias=...)`` on bf16
   q, k, v (5 flat ``FusedAdam`` steps, the dq kernel's dlogits form a
   step, loss falling), then fp32 o and the gradients of q, k, v and the
   bias against autograd of the unfused softmax. (g) fp32
   ``EncdecMultiheadAttn(dropout_p=0.1)`` with (c)'s mask and a seed on
   the FMA-pipe kernels' dropout forms against the same module on the CPU.

11. ``kernel`` rows of the remote-copy kernels (``peer_put``,
   ``peer_wait``, ``halo_put``), in rank processes that share this card
   through CUDA IPC (``spawn_ranks``; the library is built first, in this
   process), at worlds 4 and 2: ``peer_shift`` (shift 1, -1, 2) over
   bf16, fp32 and uint8 at 1 element, sizes that are no multiple of 16
   bytes and the ring's K shards at both worlds (1 x 12 x 4096 x 64 and 1
   x 12 x 8192 x 64: 6.29 and 12.6 MB bf16, 12.6 and 25.2 MB fp32), and
   ``halo_exchange_rdma`` (halo 1 and 3, periodic or not,
   fresh and ``PeerMemoryPool`` landing buffers threaded twice) on the
   halo phase's strips, a sliced plan and an odd shard: every result bit
   for bit equal to the neighbour's input made again from its seed, to a
   second run and to the plain version (gloo, CPU tensors), with exact
   launch counts. Each kernel's ``ms`` is its device time alone as a
   self-put, in a group of this one process (the put lands in its own
   arena), and ``library_ms`` a ``dst.copy_(src)`` into an arena in the
   same set-up, both at the ring's K shard (6.29 MB bf16, 12.6 MB fp32:
   the writes fit in the 50 MB L2, ``writes_fit_l2``) and at 512 MiB and
   1 GiB (``sizes``), where no kernel and no ``copy_`` may read under its
   bytes bound (and where a profile counts only if its records cover 90 %
   of the card's clock over the same calls, ``SOLO_MIN_COVER``), with
   lines through each pair (``fit``: a fixed ms and a
   streaming TB/s); the halo strips and strips of 512 MiB an edge for
   ``halo_put``. Beside them rank 0's device time inside the 4- and
   2-rank rings (which includes the other processes' time slices), the
   plain version's host time, and the ``copy_`` into a peer-mapped view
   at world 2. ``python3 chip_smoke.py remote-copy [ROOT]`` runs these
   self-put timings alone, and ``python3 chip_smoke.py ring [ROOT]`` the
   4-rank ring's and halo's timings (phases 12 and 13), for the checkout
   at ROOT; ``python3 chip_smoke.py flash-fwd [ROOT]`` and
   ``python3 chip_smoke.py flash-bwd [ROOT]`` time the fp32 flash
   forward, and the backward's dq and dk / dv kernels, against fp32
   SDPA's forward and backward at GPT-2's causal and BERT's shapes, 200 x
   333 and b * h = 65,600, ``python3 chip_smoke.py softmax [ROOT]``
   the megatron softmax kernels at row 7's masked case, rows 6 and 8 and
   the kernel phase's other masked cases against ``torch.softmax``, and
   ``python3 chip_smoke.py norm [ROOT]`` the two-pass GroupNorm's
   ``gn_stats``, ``gn_apply`` and whole two-pass forward at 8 x 64 x 64 x
   960, 1 x 512 x 512 x 128 and 2 x 75 x 75 x 960 (bf16, SiLU, gamma and
   beta) against ``F.group_norm`` + ``F.silu``, with the LayerNorm
   backward (4096 x 768) and forward and the one-pass GroupNorm (8 x 64
   x 64 x 320) as witnesses, the same way (parent and change in turns in
   one call).
12. ``ring``: ring attention at GPT-2 small's attention widths (12 heads x
   64, batch 1) over a 16,384-token bf16 context at worlds 4 and 2
   (``transport="rdma"``): causal contiguous, causal zigzag and
   non-causal, forward and backward through autograd; the gathered o and
   gradients against the full-sequence flash on this card (rel L2 1e-2 /
   2e-2; an fp32 run at 1,024 tokens a rank 1e-5 / 1e-4); exactly n
   ``fa_fwd``, n ``fa_bwd_dq``, n ``fa_bwd_dkv`` and 2(n-1) + 2(n-1) + 2n
   ``peer_put`` / ``peer_wait`` a rank a step, rank 0's flash forward,
   dq and dk / dv the tensor-core kernels (bf16); step ms per rank,
   tokens/s, and the same attention as one full-sequence flash forward +
   backward in this process as the yardstick.
13. ``halo``: ResNet-50 stage 1's 3x3 conv input (32 x 56 x 56 x 64 bf16
   NHWC) split 4 ways in H; each rank pads its tile through
   ``PeerHaloExchanger1d(transport="rdma", peer_pool=pool)`` (halo rows
   bit for bit its neighbours' edge rows) and runs the conv VALID in H;
   the tiles' outputs against the image's SAME conv (rel L2 1e-2); one
   ``halo_put`` and two ``peer_wait`` an exchange;
   ``memory_allocated`` flat over 10 iterations, and the landing buffers
   (IPC arenas, which ``memory_allocated`` does not see) the pool's two,
   with no arena made or grown after the first exchange.

14. ``cerebras``: Cerebras-GPT 1.3B (the GPT-2 architecture: 2048 wide,
   24 layers, 16 heads of 128, 2048 positions; random weights from a
   seed) trained by ``Trainer`` (fp32 parameters, bf16 compute, flat
   AdamW under the dynamic scaler) for 5 steps on one 2 x 2048 batch:
   losses finite and falling, per step exactly 49 ``ln_fwd`` / ``ln_bwd``,
   24 of each flash kernel, all in their d = 128 tensor-core forms (no
   padded call), and one ``fused_adam``; step ms, tokens/s, peak memory
   beside the 20 bytes a parameter reckoned before activations, one more
   step's device time by kind and idle share. The trained weights serve 8
   requests through ``Engine`` (4 slots), and the served prefill logits
   are held against the trained forward (FWD_BF16_REL_L2). (b) 2 layers
   at its widths in fp32, 1 x 256 tokens: loss and every gradient card vs
   CPU (relative L2 1e-3; the split-TF32 forward and the FMA backward
   pair at d = 128). (c) 2 layers at
   Cerebras-GPT 2.7B's widths (2560, 32 heads of 80: the padded route) in
   bf16 (2.5e-2) and fp32 (1e-3) against the fp32 CPU. (d) the d = 128
   dropout and dlogits forms of all six kernels: ``SelfMultiheadAttn(2048,
   16, dropout_p=0.1)`` bf16 5 flat FusedAdam steps, a learned (1, 16,
   2048, 2048) bias trained through ``flash_attention(bias=...)`` on bf16
   q, k, v, fp32 ``EncdecMultiheadAttn(dropout_p=0.1)`` with a padding
   mask card vs CPU, an fp32 learned bias against autograd of the unfused
   function.
15. ``gptj``: the GPT-2 architecture at GPT-J 6B's widths (4096 wide, 16
   heads of 256, 2048 positions, vocabulary 50,400; random weights from a
   seed), cut to 8 of its 28 layers (memory) and without GPT-J's parallel
   residual, partial rotary embedding and untied head (the GPT-2
   architecture has none of them): trained by ``Trainer`` as cerebras
   (a) for 5 steps on one 2 x 2048 batch, losses finite and falling, per
   step exactly 17 ``ln_fwd`` / ``ln_bwd``, 8 of each flash kernel, all in
   their d = 256 tensor-core forms, and one ``fused_adam``; step ms,
   tokens/s, peak memory beside the reckoned bytes, device time by kind
   and idle share; the trained weights serve 8 requests through
   ``Engine`` (4 slots) and the served prefill logits follow the trained
   forward. (b) 2 layers at its widths in fp32, 1 x 256 tokens, card vs
   CPU (the split-TF32 forward and the FMA backward pair at d = 256).
   (c) the public op at Nemotron-4 340B's head dim 192 (1 x 8 x 2048,
   causal; padded to 256), bf16 and
   fp32, forward and backward against the plain versions, with the pad
   and slice ms beside the kernels'. (d) every d = 256 form through the
   modules and the public op, as cerebras (d).

Then a ``profiler`` line (the passes of torch.profiler this process made
to time kernels, how many of them lost records and were made again, the
cover of each that was held to the card's clock, and each that covered
too little and was made again),
a ``{"kernels": [...]}`` line (launches counted over the main path:
the forward of phase 3, the serve run of phase 4, the 5 train steps of
phase 6, the 5 BERT steps of phase 7, the optimizer steps of phase 8,
the 5 UNet steps of phase 9, phase 10's loop and cross-attention, one
counted step of each bf16 ring run of phase 12 (all ranks) and one
exchange of phase 13 (all ranks), each with the counts zeroed just
before it; every kernel of ``KERNELS`` with the ``pl.pallas_call`` lines
it replaces, the flash ones with their launches split by route; then the
fp32 route's flash kernels, ``fa_fwd_fp32``, ``fa_bwd_dq_fp32`` and
``fa_bwd_dkv_fp32`` (the FMA-pipe kernels of ``csrc/flash_attention.cu``
and ``csrc/flash_attention_bwd.cu``, at GPT-2's causal shape with the
BERT row beside), launched by the fp32 runs of those paths: the fp32 ring
runs of phase 12 and phase 10's cross-attention; then the forms of
``FORM_KERNELS`` at GPT-2 XL's causal shape, launched by phase 10's
(e)-(g), the six kernels' d = 128 forms at Cerebras-GPT 1.3B's
attention (the fp32 forward's the split-TF32 kernel of
``csrc/flash_fwd_tf32.cu``, with its FMA bound beside the split-TF32
one), launched by phase 14, each base form with its padded d = 80
call beside it, and their d = 256 forms at GPT-J 6B's attention,
launched by phase 15, with the padded d = 192 call beside each base
form),
the ``nvidia-smi`` line, and last ``{"ok": true,
"device": {...}}``. Any failed check raises and the
script exits non-zero without that last line; without CUDA, or away from
the checkout, it exits 2 at once.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS = {"bf16": 989e12,        # dense tensor-core bf16
            "fp32": 67e12,         # fp32 outside the tensor cores
            # fp32 as split-TF32 products on the tensor cores: three TF32
            # products (495 TFLOP/s dense) for each fp32 one
            "tf32x3": 495e12 / 3}
L2_BYTES = 50e6
# tolerances of the kernel-vs-plain checks (see the kernel phase)
LN_TOL = {"fp32": (1e-5, 1e-5), "bf16": (1e-5, 2 ** -7)}   # (atol, rtol)
FA_TOL = {"fp32": (2e-5, 0.0), "bf16": (2e-3, 2 ** -7)}
LSE_TOL = 2e-5
FWD_BF16_REL_L2 = 5e-2   # bf16 card logits vs fp32 CPU, relative L2
FWD_FP32_ATOL = 1e-3     # fp32 card logits vs fp32 CPU
SERVE_FP32_ATOL = 1e-3   # fp32 engine prefill logits vs full forward
LN_BWD_TOL = {"fp32": (1e-5, 1e-5), "bf16": (1e-5, 2 ** -7)}  # dx
LN_PARAM_GRAD_TOL = (1e-3, 1e-4)   # dgamma / dbeta: fp32 sums over rows
FA_BWD_TOL = {"fp32": (1e-4, 0.0), "bf16": (1e-2, 2 ** -6)}
# the dq kernels' fp32 dlogits: computed from the same operands as the
# plain version's, they differ only in the order of the fp32 sums of the
# score and of dP (tensor cores or FMA tiles against cuBLAS); 3.8e-6 to
# 7.6e-6 at most on the kernel phase's bf16 cases, 0 in fp32 (H100)
DLOGITS_TOL = (2e-5, 1e-4)
FA_DROP_RATE = 0.1       # attention dropout of the flash forms' checks
KEEP_SIGMAS = 6          # the keep share's band, in binomial std devs
ADAM_RTOL = 1e-7         # the kernel runs the plain version's operations
LAMB_RTOL = 1e-7         # the same for both LAMB stages, row sums included
TRAIN_GRAD_REL_L2 = 1e-3  # fp32 card vs CPU gradients, per parameter
TRAIN_STEPS = 5
TRAIN_LR = 3e-4
BERT_STEPS = 5           # BERT-large MLM (bench.py's bench_bert_lamb shape)
BERT_BATCH, BERT_SEQ = 32, 128
BERT_LR, BERT_WD = 1e-3, 0.01
BERT_GRAD_REL_L2 = 1e-3  # fp32 card vs CPU gradients, per parameter
BERT_PAD_ATOL = 1e-3     # padded-batch logits vs each sequence alone
PAD_LENS = [128, 100, 64, 17]
# the flat optimizer kernels of the ResNet path run the plain versions'
# operations in the same order, so they are held to the same bits
OPT_TOL = 0.0
RESNET_BATCH = 128       # examples/imagenet/main_amp.py's recipe, 224 x 224
RESNET_LR = 0.1 * RESNET_BATCH / 256
RESNET_MOMENTUM, RESNET_WD = 0.9, 1e-4
RESNET_SGD_STEPS = 5
RESNET_OTHER_STEPS = 3   # master-weight FusedAdam, FusedNovoGrad, Adagrad
RESNET_GRAD_REL_L2 = 1e-3  # float64 card vs CPU gradients, per tensor
# GroupNorm kernels vs their plain versions: y (atol, rtol) — fp32 allows
# summation order, bf16 one ulp; mean absolute, rstd relative
GN_TOL = {"fp32": (1e-5, 1e-5), "bf16": (1e-5, 2 ** -7)}
GN_MEAN_ATOL, GN_RSTD_RTOL = 1e-5, 1e-4
GN_ILL_ATOL = 1e-4       # mean 1000 / std 0.01 group vs float64
GN_GROUPS = 32           # Stable Diffusion v1.5 UNet's norm_num_groups
UNET_BATCH = 8           # the JAX package's AOT GroupNorm batch
UNET_STEPS = 5
UNET_TIMED_STEPS = 20    # more steps: the spread, the host's issue time
UNET_LR = 1e-4
UNET_GRAD_REL_L2 = 1e-3  # fp32 card vs CPU gradients, per tensor
# megatron softmax kernels vs their plain versions: (atol, rtol). fp32
# summation order; bf16 / fp16 one ulp (the smallest normal of bf16, one
# subnormal step of fp16, absolute); the backward also 1e-6 absolute (the
# row sum's order, times y * scale, where dy - sum(dy * y) cancels)
SM_TOL = {"fp32": (1e-6, 0.0), "bf16": (2.0 ** -126, 2 ** -7),
          "fp16": (2.0 ** -24, 2 ** -10)}
SM_BWD_ATOL = 1e-6
XL_EMBED, XL_HEADS, XL_SEQ = 1600, 25, 1024   # GPT2Config.xl() widths
XL_VOCAB = 50257
MEGATRON_BATCH = 4
MEGATRON_STEPS = 5
MEGATRON_LR = 1e-4
BIAS_LR = 1e-2           # the learned attention bias of megatron (f)
MEGATRON_REL_L2 = 1e-4   # module vs unfused twin, card vs CPU (fp32)
MHA_BF16_REL_L2 = 5e-2   # the module on a bf16 input vs fp32: output, grads
LCE_REL_L2 = 1e-5        # chunked head vs the dense head on the card (fp32)
LCE_CHECK_ROWS = 512     # rows of the card-vs-CPU checks of (d)
# Cerebras-GPT, the GPT-2 architecture (huggingface.co/cerebras/
# Cerebras-GPT-1.3B config.json; Dey et al. 2023, arXiv 2304.03208, Table
# 1): 1.3B is 2048 wide, 24 layers, 16 heads of 128, 2048 positions;
# 2.7B 2560 wide, 32 heads of 80
CG_EMBD, CG_LAYERS, CG_HEADS, CG_CTX = 2048, 24, 16, 2048
CG27_EMBD, CG27_HEADS = 2560, 32
CG_BATCH = 2             # 2 x 2048 tokens a step
CG_STEPS = 5
CG_LR = 2e-4             # Cerebras-GPT 1.3B's published peak rate
CG_CHECK_LAYERS = 2      # the card-vs-CPU checks: 2 layers at full width,
CG_CHECK_SEQ = 256       # 1 x 256 tokens
# card vs the fp32 CPU, per parameter. bf16: one rounding of each product
# reads 0.013 at the 2.7B widths, bf16 sums of split-K partials in the LM
# head's input gradient 0.048 (PERF.md)
CG_GRAD_REL_L2 = {"fp32": 1e-3, "bf16": 2.5e-2}
CG_FORM_SEQ = 512        # the fp32 forms' card-vs-CPU checks of (d)
# GPT-J 6B's widths in the GPT-2 architecture (huggingface.co/EleutherAI/
# gpt-j-6b config.json; Wang & Komatsuzaki 2021): 4096 wide, 16 heads of
# 256, 2048 positions, vocabulary 50,400; 8 of its 28 layers, 1.83 B
# parameters (the 20 bytes a parameter reckoned before activations:
# 36.5 GB at 8 layers, 117 GB at 28). Nemotron-4 340B's heads are 192
# wide (arXiv 2406.11704,
# Table 1): the padded route's case, 8 of its 96 heads
GJ_EMBD, GJ_LAYERS, GJ_HEADS, GJ_CTX, GJ_VOCAB = 4096, 8, 16, 2048, 50400
GJ_BATCH = 2             # 2 x 2048 tokens a step, as cerebras
NEMO_D, NEMO_HEADS = 192, 8

# Every kernel of the port: its source, the function of the JAX package it
# replaces (file:line of the ``def``: the kernel's entry or, for the flash
# backward and LAMB, the kernel body) and the lines of the ``pl.pallas_call``
# sites that run it. ``softmax_fwd_causal`` also takes the causal form of
# ``softmax_fwd_pallas``'s own call. ``TO_PORT`` holds the calls no kernel
# of the port replaces yet (none is left); together the two are every
# ``pl.pallas_call`` in ``apex_tpu/ops/pallas/`` (tests/test_torch_package.py
# checks it).
_P = "apex_tpu/ops/pallas/"
KERNELS = {
    "ln_fwd": ("apex_tpu_torch/csrc/layer_norm.cu",
               _P + "layer_norm_kernel.py:102", (139,)),
    "ln_bwd": ("apex_tpu_torch/csrc/layer_norm.cu",
               _P + "layer_norm_kernel.py:211", (279,)),
    # flash: the bf16 main path's tensor-core kernels (fp32 keeps the
    # FMA-pipe kernels of flash_attention.cu / flash_attention_bwd.cu)
    "fa_fwd": ("apex_tpu_torch/csrc/flash_fwd_wgmma.cu",
               _P + "flash_attention.py:430", (466,)),
    "fa_bwd_dq": ("apex_tpu_torch/csrc/flash_bwd_dq_wgmma.cu",
                  _P + "flash_attention.py:505", (687,)),
    "fa_bwd_dkv": ("apex_tpu_torch/csrc/flash_bwd_dkv_wgmma.cu",
                   _P + "flash_attention.py:559", (729,)),
    "fused_adam": ("apex_tpu_torch/csrc/fused_adam.cu",
                   _P + "fused_adam_kernel.py:178", (206,)),
    "lamb_stage1": ("apex_tpu_torch/csrc/fused_lamb.cu",
                    _P + "fused_opt_kernels.py:82", (169,)),
    "lamb_stage2": ("apex_tpu_torch/csrc/fused_lamb.cu",
                    _P + "fused_opt_kernels.py:114", (196,)),
    "fused_sgd": ("apex_tpu_torch/csrc/fused_sgd.cu",
                  _P + "fused_sgd_kernel.py:65", (91,)),
    "fused_adam_master": ("apex_tpu_torch/csrc/fused_adam.cu",
                          _P + "fused_adam_kernel.py:227", (260,)),
    "fused_novograd": ("apex_tpu_torch/csrc/fused_novograd.cu",
                       _P + "fused_opt_kernels.py:240", (292,)),
    "fused_adagrad": ("apex_tpu_torch/csrc/fused_adagrad.cu",
                      _P + "fused_opt_kernels.py:338", (357,)),
    "gn_one_pass": ("apex_tpu_torch/csrc/group_norm.cu",
                    _P + "group_norm_kernel.py:202", (227,)),
    "gn_stats": ("apex_tpu_torch/csrc/group_norm.cu",
                 _P + "group_norm_kernel.py:242", (283,)),
    "gn_apply": ("apex_tpu_torch/csrc/group_norm.cu",
                 _P + "group_norm_kernel.py:242", (313,)),
    "softmax_fwd": ("apex_tpu_torch/csrc/softmax.cu",
                    _P + "softmax_kernel.py:200", (250,)),
    "softmax_fwd_causal": ("apex_tpu_torch/csrc/softmax.cu",
                           _P + "softmax_kernel.py:140", (181,)),
    "softmax_bwd": ("apex_tpu_torch/csrc/softmax.cu",
                    _P + "softmax_kernel.py:265", (280,)),
    "peer_put": ("apex_tpu_torch/csrc/remote_copy.cu",
                 _P + "remote_copy.py:45", (54,)),
    "halo_put": ("apex_tpu_torch/csrc/remote_copy.cu",
                 _P + "remote_copy.py:127", (177, 187)),
    # the receiving half of both Pallas kernels (their DMA semaphore
    # waits): the landing flag, the copy-out, the acknowledgement
    "peer_wait": ("apex_tpu_torch/csrc/remote_copy.cu",
                  _P + "remote_copy.py:34", (54, 177, 187)),
}
TO_PORT: dict = {}
# the fp32 route's flash kernels (FMA pipes) as the profiler names them:
# the forward's template (d = 64) and the backward's `_fma` templates; the
# fp32 forward at d = 128 and 256 is TF32_FWD_NAME's (split-TF32 products
# on the tensor cores)
FMA_FLASH_NAMES = {"fa_fwd_kernel": "fa_fwd_kernel<",
                   "fa_bwd_dq_kernel": "fa_bwd_dq_kernel_fma<",
                   "fa_bwd_dkv_kernel": "fa_bwd_dkv_kernel_fma<"}
TF32_FWD_NAME = "fa_fwd_kernel_tf32<"
# the fp32 route's flash kernels, reported beside KERNELS under their own
# names: (source, the launch count's name, the KERNELS entry whose TPU
# kernel they replace too)
FMA_KERNELS = {
    "fa_fwd_fp32": ("apex_tpu_torch/csrc/flash_attention.cu", "fa_fwd",
                    "fa_fwd"),
    "fa_bwd_dq_fp32": ("apex_tpu_torch/csrc/flash_attention_bwd.cu",
                       "fa_bwd_dq", "fa_bwd_dq"),
    "fa_bwd_dkv_fp32": ("apex_tpu_torch/csrc/flash_attention_bwd.cu",
                        "fa_bwd_dkv", "fa_bwd_dkv"),
}
# the flash kernels' dropout and dlogits forms (template instantiations of
# the kernels above), reported beside them under their own names: (source,
# the KERNELS entry whose TPU kernel they replace with it, route, form)
FORM_KERNELS = {
    "fa_fwd_dropout": ("apex_tpu_torch/csrc/flash_fwd_wgmma.cu", "fa_fwd",
                       "wgmma", "dropout"),
    "fa_bwd_dq_dropout": ("apex_tpu_torch/csrc/flash_bwd_dq_wgmma.cu",
                          "fa_bwd_dq", "wgmma", "dropout"),
    "fa_bwd_dkv_dropout": ("apex_tpu_torch/csrc/flash_bwd_dkv_wgmma.cu",
                           "fa_bwd_dkv", "wgmma", "dropout"),
    "fa_bwd_dq_dbias": ("apex_tpu_torch/csrc/flash_bwd_dq_wgmma.cu",
                        "fa_bwd_dq", "wgmma", "dbias"),
    "fa_fwd_fp32_dropout": ("apex_tpu_torch/csrc/flash_attention.cu",
                            "fa_fwd", "fma", "dropout"),
    "fa_bwd_dq_fp32_dropout": ("apex_tpu_torch/csrc/flash_attention_bwd.cu",
                               "fa_bwd_dq", "fma", "dropout"),
    "fa_bwd_dkv_fp32_dropout": ("apex_tpu_torch/csrc/flash_attention_bwd.cu",
                                "fa_bwd_dkv", "fma", "dropout"),
    "fa_bwd_dq_fp32_dbias": ("apex_tpu_torch/csrc/flash_attention_bwd.cu",
                             "fa_bwd_dq", "fma", "dbias"),
}
# the six flash kernels compiled for head dims 128 and 256, each form
# (template instantiations of the same kernels at kD = 128 and 256),
# launched by the cerebras and gptj phases: form "d128" is the kernel's
# own, "d128:<form>" its dropout or dlogits form (keys of
# ``_build.form_launches``), the same with d256
# (the fp32 forward at these widths is the split-TF32 kernel of
# flash_fwd_tf32.cu, route ``tf32``)
for _width, _route, _tail in ((w, r, t) for w in (128, 256) for r, t in (
        ("wgmma", ""), ("fma", "_fp32"))):
    _srcs = ({"fa_fwd": ("flash_fwd_wgmma.cu", "wgmma"), "fa_bwd_dq":
              ("flash_bwd_dq_wgmma.cu", "wgmma"),
              "fa_bwd_dkv": ("flash_bwd_dkv_wgmma.cu", "wgmma")}
             if _route == "wgmma" else
             {"fa_fwd": ("flash_fwd_tf32.cu", "tf32"),
              "fa_bwd_dq": ("flash_attention_bwd.cu", "fma"),
              "fa_bwd_dkv": ("flash_attention_bwd.cu", "fma")})
    for _twin, (_src, _r) in _srcs.items():
        for _form in ("", "dropout") + (("dbias",) if _twin == "fa_bwd_dq"
                                         else ()):
            FORM_KERNELS[f"{_twin}{_tail}_d{_width}" + (
                f"_{_form}" if _form else "")] = (
                "apex_tpu_torch/csrc/" + _src, _twin, _r,
                f"d{_width}" + (f":{_form}" if _form else ""))
del _width, _route, _tail, _srcs, _twin, _src, _r, _form


def fa_route_of(kernel, dt, width):
    """The launch-count route of flash wrapper ``kernel`` (``fa_fwd``,
    ``fa_bwd_dq``, ``fa_bwd_dkv``) in dtype ``dt`` at kernel width
    ``width``: bf16 ``wgmma``; fp32 ``fma``, but the forward at 128 and 256
    ``tf32``."""
    if dt == "bf16":
        return "wgmma"
    return "tf32" if kernel == "fa_fwd" and width != 64 else "fma"
# the lines of the JAX package's flash kernels that each form replaces:
# `_dropout_keep` and its uses; the dq kernel's dlogits output; the
# BlockSpecs and scratch that carry the whole head dim d (d128, d256)
FORM_TPU = {"dropout": _P + "flash_attention.py:207,305,536,583",
            "dbias": _P + "flash_attention.py:509,540,549",
            "d128": _P + "flash_attention.py:436,450-453,473",
            "d256": _P + "flash_attention.py:436,450-453,473,659-661,"
                         "710-711"}


def form_lines(form):
    """The JAX lines a form replaces (``d128:dropout``: both parts')."""
    return ";".join(FORM_TPU[f] for f in form.split(":"))


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


def image_loss(logits, labels):
    """``-mean(sum(log_softmax(logits) * onehot))``: the loss of
    ``examples/imagenet/main_amp.py``, written out as the example does."""
    import torch.nn.functional as F
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
    return -(F.log_softmax(logits, dim=-1) * onehot).sum(dim=-1).mean()


def scaled_trainer(model, make_opt, device, loss_fn=None):
    """A training loop over a flat fused optimizer: ``(opt, named,
    step)``. The model's parameters are rebound to their views of the
    optimizer's flat buffer, so the model trains in place. ``step(*batch,
    poison=False)`` runs ``loss_fn(model, *batch)`` (by default the
    imagenet loss of ``model(images)`` against ``labels``) through the
    port's ``DynamicGradScaler``, the backward of the scaled loss, the
    overflow check of the gradients and one optimizer step with
    ``inv_scale`` and ``found_inf`` as device tensors; ``poison`` writes an
    inf into one gradient first, a forced overflow. Returns the loss as a
    device tensor."""
    import torch
    from apex_tpu_torch.amp.grad_scaler import DynamicGradScaler
    from apex_tpu_torch.multi_tensor.functional import tree_check_finite
    named = dict(model.named_parameters())
    opt = make_opt(named)
    with torch.no_grad():
        for name, view in opt.parameters.items():
            named[name].data = view
    scaler = DynamicGradScaler()
    state = {"scaler": scaler.init(device)}

    if loss_fn is None:
        def loss_fn(model, images, labels):
            return image_loss(model(images), labels)

    def step(*batch, poison=False):
        for t in named.values():
            t.grad = None
        loss = loss_fn(model, *batch)
        scaler.scale(loss, state["scaler"]).backward()
        grads = {n: t.grad for n, t in named.items()}
        if poison:
            g = next(iter(grads.values()))
            g[(0,) * g.dim()] = float("inf")
        found = tree_check_finite(grads)
        opt.step(grads, inv_scale=1.0 / state["scaler"].scale,
                 found_inf=found)
        for t in named.values():      # written through raw pointers
            torch.autograd.graph.increment_version(t)
        state["scaler"] = scaler.update(state["scaler"], found)
        state["grads"] = grads
        return loss.detach()

    step.state = state
    return opt, named, step


def optimizer_snapshot(opt):
    """Copies of everything a flat optimizer step may write: the flat
    buffer(s), the state tensors and the step counter."""
    from apex_tpu_torch.utils.tree import tree_leaves
    bufs = [opt._flat_p, getattr(opt, "_flat_lp", None), opt._step,
            *tree_leaves(opt.state)]
    return [t.clone() for t in bufs if t is not None]


def resnet_grads(params, images, labels, device, dtype):
    """One training-mode step of a ResNet-50 holding ``params`` on
    ``device``, parameters, statistics and compute in ``dtype`` (float32 or
    float64): every parameter's loss gradient and the new running
    statistics, on the CPU."""
    import torch
    from apex_tpu_torch.models.resnet import ResNet50
    model = ResNet50(compute_dtype=dtype, device=device)
    model.load_state_dict(params)
    model.to(dtype)
    image_loss(model(images.to(device, dtype)),
               labels.to(device)).backward()
    stats = {n: b.detach().cpu() for n, b in model.state_dict().items()
             if n.endswith((".mean", ".var"))}
    return {n: p.grad.detach().cpu()
            for n, p in model.named_parameters()}, stats


def build_unet(device, seed=0):
    """The ``unet`` phase's stack of Stable Diffusion v1.5 UNet ResNet
    blocks (without the time embedding) at its GroupNorm shapes, on
    ``device``, from ``seed``: block A (320 -> 320) at the input's size, a
    stride-2 conv3x3, B (320 -> 640), down, C (640 -> 1280), down, D (1280
    -> 1280); E (960 -> 320, ``up_blocks.3.resnets.0``) takes A's output
    beside a nearest x2 upsample of B's. A block is ``GroupNorm(32, cin,
    act="silu")`` -> conv3x3 -> ``GroupNorm(32, cout, act="silu")`` ->
    conv3x3, plus the input (through a 1x1 conv where the width changes).
    ``forward(x)`` returns E's and D's outputs. Conv weights are drawn
    normal with variance 1 / fan_in from a CPU generator (the same numbers
    on every device), GroupNorm's ones and zeros."""
    import torch
    from apex_tpu_torch.contrib.group_norm import GroupNorm
    from apex_tpu_torch.models.resnet import Conv

    class Block(torch.nn.Module):
        def __init__(self, cin, cout):
            super().__init__()
            self.norm1 = GroupNorm(GN_GROUPS, cin, act="silu", device=device)
            self.conv1 = Conv(cin, cout, 3, padding=1, device=device)
            self.norm2 = GroupNorm(GN_GROUPS, cout, act="silu",
                                   device=device)
            self.conv2 = Conv(cout, cout, 3, padding=1, device=device)
            self.skip = (Conv(cin, cout, 1, device=device) if cin != cout
                         else None)

        def forward(self, x):
            h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
            return h + (x if self.skip is None else self.skip(x))

    class Stack(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.A, self.down_a = Block(320, 320), Conv(320, 320, 3, 2, 1,
                                                        device=device)
            self.B, self.down_b = Block(320, 640), Conv(640, 640, 3, 2, 1,
                                                        device=device)
            self.C, self.down_c = Block(640, 1280), Conv(1280, 1280, 3, 2,
                                                         1, device=device)
            self.D = Block(1280, 1280)
            self.E = Block(960, 320)

        def forward(self, x):
            a = self.A(x)
            b = self.B(self.down_a(a))
            d = self.D(self.down_c(self.C(self.down_b(b))))
            up = b.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            return self.E(torch.cat([a, up], dim=-1)), d

    model = Stack()
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for name, t in model.state_dict().items():
        if t.dim() == 4:
            state[name] = torch.randn(t.shape, generator=gen) \
                / math.sqrt(t[0].numel())
        else:
            state[name] = (torch.ones if name.endswith("weight")
                           else torch.zeros)(t.shape)
    model.load_state_dict(state)
    return model


def unet_loss(model, x, target_e, target_d):
    """MSE of E's output against its target plus MSE of D's, in fp32."""
    e, d = model(x)
    return ((e.float() - target_e) ** 2).mean() \
        + ((d.float() - target_d) ** 2).mean()


def unfused_self_attention(mod, x):
    """``SelfMultiheadAttn``'s function without flash, built from the port's
    public functions on the module's parameters: ``linear_bias`` (qkv) ->
    ``fused_rope_cached`` on q and k -> ``mha_reference`` (the causal
    softmax kernels) -> ``linear_bias`` (out); the weights cast to x's
    dtype."""
    from apex_tpu_torch.transformer import linear_bias, mha_reference
    from apex_tpu_torch.transformer.mha import apply_rope_bhsd, rope_tables
    b, s, e = x.shape
    h, d = mod.num_heads, mod.head_dim
    qkv = linear_bias(x, mod.qkv.weight.to(x.dtype), mod.qkv.bias)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2)
               for t in qkv.split(e, dim=-1))
    if mod.use_rope:
        cos, sin = rope_tables(s, d, mod.rope_theta, x.device)
        q, k = apply_rope_bhsd(q, cos, sin), apply_rope_bhsd(k, cos, sin)
    o = mha_reference(q, k, v, causal=mod.causal)
    return linear_bias(o.transpose(1, 2).reshape(b, s, e),
                       mod.out.weight.to(x.dtype), mod.out.bias)


def unfused_encdec(mod, query, key_value, mask):
    """``EncdecMultiheadAttn``'s function without flash: its projections by
    ``linear_bias`` around ``mha_reference(mask=...)`` (the masked softmax
    kernels)."""
    from apex_tpu_torch.transformer import linear_bias, mha_reference
    b, sq, e = query.shape
    sk = key_value.shape[1]
    h, d = mod.num_heads, mod.head_dim
    q = linear_bias(query, mod.q.weight, mod.q.bias)
    k, v = linear_bias(key_value, mod.kv.weight, mod.kv.bias).split(e, -1)
    q = q.reshape(b, sq, h, d).transpose(1, 2)
    k = k.reshape(b, sk, h, d).transpose(1, 2)
    v = v.reshape(b, sk, h, d).transpose(1, 2)
    o = mha_reference(q, k, v, mask=mask)
    return linear_bias(o.transpose(1, 2).reshape(b, sq, e), mod.out.weight,
                       mod.out.bias)


def megatron_loss(model, x, target):
    """MSE of the unfused layer's output against a fixed target, fp32."""
    return ((unfused_self_attention(model, x).float() - target) ** 2).mean()


# ------------------------------------------- phases 11-13: rank processes
# The remote-copy kernels, ring attention and the halo exchange run in rank
# processes spawned on the one card (``spawn_ranks``); each maps its peers'
# arenas through CUDA IPC. These workers run in those processes.

RING_HEADS, RING_HEAD_DIM = 12, 64     # GPT2Config.small: 12 heads x 64
RING_TOKENS = 16384                    # the ring's global context, bf16
RING_FP32_PER_RANK = 1024              # the fp32 cross-check's tokens a rank
RING_LAYOUTS = [("contig", True), ("zigzag", True), ("contig", False)]
RING_TOL = {"bf16": (1e-2, 2e-2), "fp32": (1e-5, 1e-4)}  # rel L2 (o, grads)
RING_TIMED_STEPS = 3
HALO_IMAGE = (32, 56, 56, 64)   # ResNet-50 stage 1's 3x3 conv input, NHWC
HALO_WORLD = 4                  # H split 4 ways: 14 rows a rank
HALO_ITERS = 10                 # iterations after the first: memory flat
HALO_CONV_TOL = 1e-2            # rel L2, bf16 conv of tiles vs the image
# what the remote-copy rows' ms and library_ms time; the cross-process
# readings are their ms_in_ring and library_ms_world2
SELF_PUT = ("self-put: a one-process group, the put lands in its own arena;"
            " library_ms is a copy_ into that arena")
PEER_SPEC = {
    # peer_shift sizes (elements): one element, sizes that are no multiple
    # of 16 bytes, the ring's K shards at world 4 (1 x 12 x 4096 x 64:
    # 6.29 MB bf16, 12.6 MB fp32 as its dK) and at world 2 (1 x 12 x 8192
    # x 64: 12.6 MB bf16, 25.2 MB fp32), each checked at both worlds
    "shift_sizes": {"bf16": [1, 3, 1_000_003, 3_145_728, 6_291_456],
                    "fp32": [1, 3, 1_000_003, 3_145_728, 6_291_456],
                    "u8": [1, 4097, 3_145_728]},
    # halo_exchange_rdma shards: the halo phase's strips (the whole-shard
    # plan), a sliced plan (fp32 / bf16), an odd small one
    "halo_shapes": [(2, 32, 56, 64), (48, 2048), (5, 7)],
    "timed_shift": 3_145_728,
    "timed_strips": (2, 32, 56, 64),
}
_PEER_DTYPES = ("bf16", "fp32", "u8")


def _tdtype(name):
    import torch
    return {"bf16": torch.bfloat16, "fp32": torch.float32,
            "u8": torch.uint8}[name]


def _seeded(rank, salt, numel, dtype, device):
    """The input rank ``rank`` makes for case ``salt``: any rank can make
    it again from the rank's number."""
    import torch
    g = torch.Generator(device=device).manual_seed(1000 * rank + salt)
    if dtype == torch.uint8:
        return torch.randint(0, 256, (numel,), generator=g, device=device,
                             dtype=torch.uint8)
    return torch.randn(numel, generator=g, device=device).to(dtype)


def _same_bits(a, b) -> bool:
    import torch
    return (tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype
            and a.device == b.device
            and torch.equal(a.reshape(-1).view(torch.uint8),
                            b.reshape(-1).view(torch.uint8)))


# passes of torch.profiler before a profile that lost records fails: on an
# H100 host a pass now and then recorded no device kernel, or only some
# (1 of 30 flash launches once, 15 of 20 memcpys once, 1 of 2 gemms of an
# fp32 MLP's one-call profile in 1 pass of 20)
PROFILE_TRIES = 8
# spin kernels that open (``lead``) and close (``trail``) each profile
# window, of SPIN_CYCLES clock cycles each (about 50 us at the H100's
# 1.98 GHz): a side whose spins were all lost is doubled for later windows,
# up to SPIN_MAX
PROFILE_EDGES = {"lead": 16, "trail": 4}
SPIN_CYCLES = 100_000
SPIN_MAX = 256
# passes of ``_per_call_ms`` in this process, those whose profile lost
# records, the cover of each pass held to the clock (``min_cover``: its
# records' device ms over the clock's), and each such pass whose records
# covered too little (``short``: device and clock ms a call); profile
# windows, and of them, by count of spins lost, those that lost spins at
# the lead and at the trail (``{spins lost: windows}``); the ``profiler``
# line reports them with the spins the last window took
PROFILE_PASSES = {"passes": 0, "lost": 0, "covers": [], "short": [],
                  "windows": 0, "lead_lost": {}, "trail_lost": {},
                  "edges": PROFILE_EDGES}


def _profile(fn):
    """``({kernel: us}, {kernel: runs}, edges_kept)``: the summed durations
    and the count of the device kernels (and copies) ``fn()`` ran, from
    torch.profiler, and whether the window kept a spin at each end.

    Spin kernels (PROFILE_EDGES) open and close the window and are left
    out. On H100 hosts a window's first device records were lost, in every
    window of a run and whatever they were: the first two on one host, on
    another four 10 us spins and the first kernel of ``fn`` after them (a
    fill, or a halo put). That fits kineto's dropping of records that
    start before its window opens, on a host where the card's timestamps
    run early against the host's clock. A lead spin starts before ``fn``'s
    first record (``fn`` queues behind them, and NCCL's streams wait on
    this one), a trail spin after it, so the records say how many of each
    side the window kept. Where it kept none of one side, ``fn``'s records
    at that end may be lost too: ``edges_kept`` is False and that side's
    spins are doubled for later windows."""
    import torch
    lead, trail = PROFILE_EDGES["lead"], PROFILE_EDGES["trail"]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(lead):
            torch.cuda._sleep(SPIN_CYCLES)
        fn()
        for _ in range(trail):
            torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
    us, runs, spins, first = {}, {}, [], math.inf
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "spin_kernel" in ev.name:
            spins.append(ev.time_range.start)
            continue
        us[ev.name] = us.get(ev.name, 0.0) + ev.time_range.elapsed_us()
        runs[ev.name] = runs.get(ev.name, 0) + 1
        first = min(first, ev.time_range.start)
    kept_lead = sum(t < first for t in spins) if runs else 0
    kept = {"lead": kept_lead, "trail": len(spins) - kept_lead}
    PROFILE_PASSES["windows"] += 1
    for side, n in (("lead", lead), ("trail", trail)):
        if kept[side] < n:
            hist = PROFILE_PASSES[f"{side}_lost"]
            hist[n - kept[side]] = hist.get(n - kept[side], 0) + 1
        if not kept[side]:
            PROFILE_EDGES[side] = min(2 * n, SPIN_MAX)
    return us, runs, bool(kept["lead"] and kept["trail"])


def _per_call_ms(fn, reps, one, min_cover=None):
    """``({kernel: mean device ms per call}, the runs of one call)`` of
    ``fn`` over ``reps`` calls, or ``({}, what was seen)`` where the
    profile of the calls did not record ``reps`` times each kernel of one
    call. ``one`` carries, from pass to pass, the most runs of each kernel
    that a call has shown: a profile of one call, and the calls' profile
    divided by ``reps``, each raise it. The profiler loses records and
    never adds one, so a pass counts only where the calls' profile holds
    ``reps`` times that count of every kernel: a record lost in the
    calls' profile fails the pass, one lost in the one-call profile
    does not. With ``min_cover``, for calls that keep the card busy back
    to back, the pass also fails where the records' durations add up to
    less than that share of the calls' time between two CUDA events (the
    card's own clock): records whose time ranges were cut short. A pass
    whose windows lost every spin at one end (``_profile``) fails too."""
    import torch
    _, now, now_kept = _profile(fn)
    clock = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def loop():
        clock[0].record()
        for _ in range(reps):
            fn()
        clock[1].record()

    us, runs, kept = _profile(loop)
    for k, n in list(now.items()) + [(k, n // reps) for k, n in runs.items()]:
        one[k] = max(one.get(k, 0), n)
    PROFILE_PASSES["passes"] += 1
    if (not (now_kept and kept) or not one
            or runs != {k: n * reps for k, n in one.items()}):
        PROFILE_PASSES["lost"] += 1
        return {}, {"one call": now, f"{reps} calls": runs,
                    "most seen in one call": dict(one),
                    "spins kept at both ends": [now_kept, kept]}
    if min_cover is not None:
        device, wall = sum(us.values()) / 1e3, clock[0].elapsed_time(clock[1])
        PROFILE_PASSES["covers"].append(device / wall)
        if device < min_cover * wall:
            PROFILE_PASSES["short"].append(
                {"device_ms": device / reps, "clock_ms": wall / reps,
                 "kernels": {k: t / 1e3 / reps for k, t in us.items()}})
            return {}, {"records' device ms": device, "clock ms": wall}
    return {k: t / 1e3 / reps for k, t in us.items()}, dict(one)


def _rank_profile(fn, reps):
    """``{kernel: mean device ms per call}`` of ``fn`` over ``reps`` calls
    under torch.profiler: the first of PROFILE_TRIES passes that recorded
    every call's kernels. Every rank runs all the passes (the calls
    exchange data, so the ranks' loops must match)."""
    found, seen, one = {}, None, {}
    for _ in range(PROFILE_TRIES):
        got, seen_now = _per_call_ms(fn, reps, one)
        if not found:
            found, seen = got, seen_now
    if not found:
        raise RuntimeError(f"torch.profiler lost device kernels in "
                           f"{PROFILE_TRIES} passes: {seen}")
    return found


def _event_ms(fn, reps):
    """Mean ms per call of ``fn`` between two CUDA events."""
    import torch
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _l2_sets(rank, salt, numel, dtype, device):
    """Copies of a seeded input, as bytes, enough that cycling through them
    finds each out of the 50 MB L2."""
    import torch
    one = _seeded(rank, salt, numel, dtype, device).view(torch.uint8)
    count = int(min(16, max(2, math.ceil(2 * L2_BYTES / one.numel()))))
    return [one.clone() for _ in range(count)]


def _cycle(items):
    while True:
        yield from items


def _pick(prof, key):
    return sum(ms for name, ms in prof.items() if key in name)


def _rank_checks(group, spec):
    """The remote-copy kernels between distinct rank processes:
    ``peer_shift`` (shift 1, -1, 2) and ``halo_exchange_rdma`` (halo 1 and
    3, periodic or not, fresh and pool landing buffers threaded twice) in
    bf16, fp32 and uint8, each result bit for bit equal to the neighbour's
    input made again from its seed, to a second run, and to the plain
    version (gloo) on the same inputs. Then the kernels timed in the ring
    (rank 0) and the library copy into a peer-mapped view."""
    import torch
    from apex_tpu_torch.contrib.peer_memory import PeerMemoryPool
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import remote_copy as rc
    n, me, dev = group.axis_size(), group.axis_index(), group.device
    shift_checks = halo_checks = 0
    for d, name in enumerate(_PEER_DTYPES):
        dtype = _tdtype(name)
        for i, numel in enumerate(spec["shift_sizes"][name]):
            salt = 100 * d + i
            x = _seeded(me, salt, numel, dtype, dev)
            for shift in (1, -1, 2):
                got = rc.peer_shift(x, group, shift)
                again = rc.peer_shift(x, group, shift)
                plain = rc.peer_shift_plain(x.cpu(), group, shift)
                want = _seeded((me - shift) % n, salt, numel, dtype, dev)
                require(_same_bits(got, want) and _same_bits(again, got)
                        and _same_bits(got.cpu(), plain),
                        f"rank {me}/{n}: peer_shift {name} x {numel} shift "
                        f"{shift} differs from the neighbour's input, the "
                        f"second run or the plain version")
                shift_checks += 1
        # a source that starts 1 element into its storage: the kernel's
        # 8-, 4-, 2- and 1-byte word paths (the landing slot is aligned)
        salt = 100 * d + 99
        x = _seeded(me, salt, 4097, dtype, dev)[1:]
        got = rc.peer_shift(x, group, 1)
        want = _seeded((me - 1) % n, salt, 4097, dtype, dev)[1:]
        require(_same_bits(got, want.contiguous()),
                f"rank {me}/{n}: peer_shift {name} of an offset view")
        shift_checks += 1
    pool = PeerMemoryPool(static_size=16 << 20, group=group)
    for d, name in enumerate(_PEER_DTYPES):
        dtype = _tdtype(name)
        for i, shape in enumerate(spec["halo_shapes"]):
            rows, numel = shape[0], math.prod(shape)
            salt = 500 + 10 * d + i
            x = _seeded(me, salt, numel, dtype, dev).view(shape)
            left = _seeded((me - 1) % n, salt, numel, dtype, dev).view(shape)
            right = _seeded((me + 1) % n, salt, numel, dtype,
                            dev).view(shape)
            for halo in (1, 3):
                if halo > rows:
                    continue
                pool_bufs = pool.allocate_halo_buffers(shape, halo,
                                                       dtype)[:2]
                for periodic in (False, True):
                    want_lo = left[rows - halo:]
                    want_hi = right[:halo]
                    if not periodic and me == 0:
                        want_lo = torch.zeros_like(want_lo)
                    if not periodic and me == n - 1:
                        want_hi = torch.zeros_like(want_hi)
                    plo, phi = rc.halo_exchange_rdma(x.cpu(), group, halo,
                                                     periodic=periodic)
                    for bufs in (None, pool_bufs):
                        for _ in range(2):
                            lo, hi, bufs = rc.halo_exchange_rdma(
                                x, group, halo, periodic=periodic,
                                bufs=bufs, return_bufs=True)
                            require(_same_bits(lo, want_lo)
                                    and _same_bits(hi, want_hi)
                                    and _same_bits(lo.cpu(), plo)
                                    and _same_bits(hi.cpu(), phi),
                                    f"rank {me}/{n}: halo {name} {shape} "
                                    f"halo {halo} periodic {periodic} "
                                    f"pool {bufs is not None}")
                            halo_checks += 1
    torch.cuda.synchronize()
    check_launches = dict(_build.launches)
    # the kernels in the ring: every rank runs the same loops; rank 0's
    # device times include its waits on the peers' time slices
    timed = {}
    for name in ("bf16", "fp32"):
        x = _seeded(me, 900, spec["timed_shift"], _tdtype(name), dev)
        timed[f"shift_{name}"] = _rank_profile(
            lambda: rc.peer_shift(x, group, 1), 20)
        timed[f"shift_{name}_call_ms"] = _event_ms(
            lambda: rc.peer_shift(x, group, 1), 20)
        xc = x.cpu()
        t0 = time.perf_counter()
        for _ in range(3):
            rc.peer_shift_plain(xc, group, 1)
        timed[f"shift_{name}_plain_ms"] = (time.perf_counter() - t0) * 1e3 / 3
    strips = _seeded(me, 901, math.prod(spec["timed_strips"]),
                     _tdtype("bf16"), dev).view(spec["timed_strips"])
    timed["halo"] = _rank_profile(
        lambda: rc.halo_exchange_rdma(strips, group, 1), 20)
    timed["halo_call_ms"] = _event_ms(
        lambda: rc.halo_exchange_rdma(strips, group, 1), 20)
    sc = strips.cpu()
    t0 = time.perf_counter()
    for _ in range(3):
        rc.halo_exchange_rdma(sc, group, 1)
    timed["halo_plain_ms"] = (time.perf_counter() - t0) * 1e3 / 3
    # the library call: dst.copy_(src) into the next rank's mapped memory,
    # the sources rotated through more than the 50 MB L2 as the kernels'
    for name in ("bf16", "fp32"):
        srcs = _l2_sets(me, 902, spec["timed_shift"], _tdtype(name), dev)
        nbytes = srcs[0].numel()
        scratch = rc.IpcArena(group, nbytes)
        if me == 0:
            view = rc.device_bytes(scratch.peer_ptr((me + 1) % n), nbytes,
                                   dev)
            it = _cycle(srcs)
            prof = _rank_profile(lambda: view.copy_(next(it)), 20)
            timed[f"library_{name}"] = sum(prof.values())
            timed[f"library_{name}_call_ms"] = _event_ms(
                lambda: view.copy_(next(it)), 20)
        del srcs
        torch.cuda.synchronize()
        group.barrier()
    # one halo_put of the strips (the whole-shard plan) moves the shard to
    # each neighbour: two copies of its bytes
    strip_bytes = math.prod(spec["timed_strips"]) * 2
    srcs = _l2_sets(me, 903, strip_bytes // 2, _tdtype("bf16"), dev)
    scratch = rc.IpcArena(group, strip_bytes)
    if me == 0:
        view = rc.device_bytes(scratch.peer_ptr((me + 1) % n), strip_bytes,
                               dev)
        it = _cycle(srcs)
        prof = _rank_profile(lambda: (view.copy_(next(it)),
                                      view.copy_(next(it))), 20)
        timed["library_halo"] = sum(prof.values())
    torch.cuda.synchronize()
    group.barrier()
    return {"shift_checks": shift_checks, "halo_checks": halo_checks,
            "launches": check_launches, "timed": timed if me == 0 else None}


def _rank_ring(group, spec):
    """Ring attention at GPT-2 small's attention widths over the group,
    ``transport="rdma"``: causal contiguous, causal zigzag and non-causal,
    forward and backward through autograd; bf16 at a global 16,384 tokens
    and fp32 at 1,024 a rank. Returns each run's local o / dq / dk / dv
    (bf16 as int16 bits), its launches in one step, the step times (bf16)
    and rank 0's device time of one step by kernel."""
    import torch
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.parallel import (ring_self_attention,
                                         zigzag_ring_self_attention,
                                         zigzag_shard)
    n, me, dev = group.axis_size(), group.axis_index(), group.device
    out = {}
    for dt, tokens in (("bf16", RING_TOKENS), ("fp32",
                                                RING_FP32_PER_RANK * n)):
        dtype = _tdtype(dt)
        full = _ring_inputs(tokens, dtype, dev)
        for layout, causal in RING_LAYOUTS:
            arrs = [zigzag_shard(t, n) if layout == "zigzag" else t
                    for t in full]
            q, k, v, do = (t.chunk(n, dim=2)[me].contiguous() for t in arrs)

            def step():
                qs, ks, vs = (t.detach().requires_grad_(True)
                              for t in (q, k, v))
                if layout == "zigzag":
                    o = zigzag_ring_self_attention(qs, ks, vs, group,
                                                   transport="rdma")
                else:
                    o = ring_self_attention(qs, ks, vs, group, causal=causal,
                                            transport="rdma")
                o.backward(do)
                return o.detach(), qs.grad, ks.grad, vs.grad

            step()
            torch.cuda.synchronize()
            _build.reset_launches()
            res = step()
            torch.cuda.synchronize()
            launches = dict(_build.launches)
            rec = {"launches": launches,
                   "routes": dict(_build.route_launches)}
            if dt == "bf16":
                times = []
                for _ in range(RING_TIMED_STEPS):
                    group.barrier()
                    t0 = time.perf_counter()
                    step()
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                rec["step_ms"] = times
                prof = _rank_profile(step, 1)
                rec["profile"] = {
                    "flash_fwd": _pick(prof, "fa_fwd_kernel"),
                    "flash_bwd": _pick(prof, "fa_bwd_"),
                    "flash_fwd_wgmma": _pick(prof, "fa_fwd_kernel_wgmma"),
                    "flash_bwd_dq_wgmma": _pick(prof,
                                                "fa_bwd_dq_kernel_wgmma"),
                    "flash_bwd_dkv_wgmma": _pick(prof,
                                                 "fa_bwd_dkv_kernel_wgmma"),
                    "flash_fma": sum(_pick(prof, n)
                                     for n in FMA_FLASH_NAMES.values()),
                    "peer_put": _pick(prof, "peer_put_kernel"),
                    "peer_wait": _pick(prof, "peer_wait_kernel"),
                    "total": sum(prof.values())} if me == 0 else None
            rec["tensors"] = [
                (t.view(torch.int16) if dt == "bf16" else t).cpu().numpy()
                for t in res]
            out[(dt, layout, causal)] = rec
    return out


def _ring_inputs(tokens, dtype, device):
    """Global q, k, v and the output gradient (1, 12, tokens, 64), made
    on the card from one seed: every rank and the parent make the same."""
    import torch
    g = torch.Generator(device=device).manual_seed(tokens)
    shape = (1, RING_HEADS, tokens, RING_HEAD_DIM)
    return [torch.randn(shape, generator=g, device=device).to(dtype)
            for _ in range(4)]


def _halo_inputs(device):
    """The image (NHWC, bf16) and the 3x3 conv weight (OIHW, bf16)."""
    import torch
    g = torch.Generator(device=device).manual_seed(56)
    x = torch.randn(HALO_IMAGE, generator=g, device=device).to(
        torch.bfloat16)
    c = HALO_IMAGE[-1]
    w = (torch.randn(c, c, 3, 3, generator=g, device=device) / 24).to(
        torch.bfloat16)
    return x, w


def _rank_halo(group, spec):
    """H of ResNet-50 stage 1's conv input split over the ranks: each
    pads its tile with the neighbours' edge rows through
    ``PeerHaloExchanger1d(transport="rdma", peer_pool=pool)`` and runs the
    3x3 conv VALID in H. Checks the halo rows bit for bit, counts one
    exchange's launches, times the exchange, and reads the device memory
    after each of ``HALO_ITERS`` more iterations."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.contrib.peer_memory import (PeerHaloExchanger1d,
                                                    PeerMemoryPool)
    from apex_tpu_torch.ops import _build
    n, me, dev = group.axis_size(), group.axis_index(), group.device
    x, w = _halo_inputs(dev)
    rows = HALO_IMAGE[1] // n
    tile = x[:, me * rows:(me + 1) * rows].contiguous()
    pool = PeerMemoryPool(static_size=4 << 20, group=group)
    ex = PeerHaloExchanger1d(half_halo=1, group=group, transport="rdma",
                             peer_pool=pool)

    def step():
        padded = ex(tile, spatial_axis=1)
        y = F.conv2d(padded.permute(0, 3, 1, 2), w, padding=(0, 1))
        return padded, y.permute(0, 2, 3, 1)

    step()
    torch.cuda.synchronize()
    _build.reset_launches()
    padded, y = step()
    torch.cuda.synchronize()
    launches = dict(_build.launches)

    def arena_state():
        # the landing buffers live in IPC arenas (cudaMalloc), which
        # memory_allocated does not see
        return (len(group.arenas), sum(a.nbytes for a in group.arenas))

    arenas = [arena_state()]
    top = x[:, me * rows - 1] if me > 0 else torch.zeros_like(x[:, 0])
    bottom = x[:, (me + 1) * rows] if me < n - 1 \
        else torch.zeros_like(x[:, 0])
    require(_same_bits(padded[:, 0].contiguous(), top.contiguous())
            and _same_bits(padded[:, -1].contiguous(), bottom.contiguous())
            and _same_bits(padded[:, 1:-1].contiguous(), tile),
            f"rank {me}: the padded tile's halo rows are not the "
            f"neighbours' edge rows")
    y_out = y.contiguous().view(torch.int16).cpu().numpy()
    del padded, y
    mem = []
    for _ in range(HALO_ITERS):
        padded, y = step()
        del padded, y
        torch.cuda.synchronize()
        mem.append(torch.cuda.memory_allocated(dev))
        arenas.append(arena_state())
    group.barrier()
    exch_ms = _event_ms(lambda: ex(tile, spatial_axis=1), 20)
    step_ms = _event_ms(step, 20)
    prof = _rank_profile(lambda: ex(tile, spatial_axis=1), 20)
    return {"y": y_out, "launches": launches, "memory_allocated": mem,
            "arenas": arenas,
            "exchange_call_ms": exch_ms, "step_call_ms": step_ms,
            "exchange_profile": {
                "halo_put": _pick(prof, "halo_put_kernel"),
                "peer_wait": _pick(prof, "peer_wait_kernel"),
                "total": sum(prof.values())} if me == 0 else None,
            "pool_allocations": len(pool.allocations)}


def _rank_path(group, spec):
    """Everything a rank process runs: the kernel checks, the ring, and at
    ``HALO_WORLD`` ranks the halo exchange."""
    res = {"checks": _rank_checks(group, spec),
           "ring": _rank_ring(group, spec)}
    if group.axis_size() == HALO_WORLD:
        res["halo"] = _rank_halo(group, spec)
    return res


# Phase 11 (a)'s sizes. The ring's K shard in bf16 and in fp32 (6.29 and
# 12.6 MB: the self-put's two landing slots, the copy-out and the copy_'s
# destination fit in the 50 MB L2, so a reading there can beat the bytes
# bound) and two messages of about 10 and 20 times the L2, whose slots,
# copy-outs and copy_ destinations do not: a kernel or a copy_ that read
# under its bytes bound there would have moved bytes faster than the HBM
# can. A line through each pair gives a fixed cost and a streaming rate.
SOLO_SHIFTS = [("bf16", PEER_SPEC["timed_shift"]),
               ("fp32", PEER_SPEC["timed_shift"]),
               ("bf16", 256 << 20), ("bf16", 512 << 20)]
# the halo rows': the halo phase's strips, and strips whose edges are 512
# MiB each (both the whole-shard plan: each edge is the whole shard)
SOLO_STRIPS = [PEER_SPEC["timed_strips"], (2, 16384, 8192)]
# the least share of a profile's clock (CUDA events around its calls) that
# the calls' device records must cover for a reading beyond the L2 to
# count: those calls keep the card busy back to back (the host enqueues
# far faster than a ~0.7 ms copy drains), so records that cover less lost
# time, and the pass is made again like one that lost records
SOLO_MIN_COVER = 0.9


def _abs_err(got, want):
    """0.0 where ``got`` has ``want``'s bits, else their largest absolute
    difference."""
    if _same_bits(got, want):
        return 0.0
    return (got.float() - want.float()).abs().max().item()


def _halo_bytes(shape, dtype):
    """``(edge bytes, bytes a halo_put of halo 1 must move)``: each input
    read once (the shard once under the whole-shard plan, else the two
    edges) and both landing buffers written once."""
    import torch
    from apex_tpu_torch.ops import remote_copy as rc
    rows = shape[0]
    _, full, buf_rows = rc._halo_plan(rows, 1, dtype)
    edge = buf_rows * math.prod(shape[1:]) * torch.empty(
        (), dtype=dtype).element_size()
    return edge, (1 if full else 2) * edge + 2 * edge


def _remote_copy_solo(dev):
    """Phase 11 (a): each remote-copy kernel alone, in a group of this one
    process whose puts land in its own arena (self-puts), so no other
    process's time slice is in the times: ``peer_shift`` at SOLO_SHIFTS
    and ``halo_exchange_rdma`` (halo 1) at SOLO_STRIPS, each result held
    bit for bit. Beside each, the library call in the same set-up: a
    ``copy_`` into an arena view for ``peer_put``, into a fresh tensor for
    ``peer_wait``'s copy-out, two of the strips into an arena view for
    ``halo_put``. Inputs are rotated past the L2 (``n_sets``)."""
    import torch
    from apex_tpu_torch.ops import remote_copy as rc
    from apex_tpu_torch.parallel import RankGroup
    g1 = RankGroup(device=dev)

    def arena_view(nbytes):
        return rc.device_bytes(rc.IpcArena(g1, nbytes).local_ptr(), nbytes,
                               dev)

    def shift(x):
        return rc.peer_shift(x, g1, 1)

    def halo(x):
        return rc.halo_exchange_rdma(x, g1, 1, periodic=True)

    shifts, strips = [], []
    for i, (dt, numel) in enumerate(SOLO_SHIFTS):
        dtype = _tdtype(dt)
        nbytes = numel * dtype.itemsize
        sets = [(_seeded(0, 950 + 20 * i + j, numel, dtype, dev),)
                for j in range(n_sets(2 * nbytes))]
        err = max(_abs_err(shift(x), x) for (x,) in sets)
        # readings beyond the L2 are held to their bytes bound: their
        # profiles are held to the clock too
        cover = SOLO_MIN_COVER if 2 * nbytes >= 2 * L2_BYTES else None
        kern = device_kernels(shift, sets, 20, cover)
        outs = [(torch.empty_like(x), x) for (x,) in sets]
        view = arena_view(nbytes)
        raw = [(x.view(torch.uint8),) for (x,) in sets]
        shifts.append({
            "dtype": dt, "n": numel, "bytes": nbytes, "err": err,
            "put": _pick(kern, "peer_put_kernel"),
            "wait": _pick(kern, "peer_wait_kernel"),
            "call_ms": bench_ms(shift, sets, 20),
            # peer_wait's copy-out as one library call
            "copy_ms": device_ms(lambda o, x: o.copy_(x), outs, 20, cover),
            # peer_put's: one copy_ into the arena
            "library_ms": device_ms(lambda x: view.copy_(x), raw, 20, cover),
            "library_call_ms": bench_ms(lambda x: view.copy_(x), raw, 20)})
        del sets, outs, raw, view, kern
        torch.cuda.empty_cache()
    for i, shape in enumerate(SOLO_STRIPS):
        edge, moved = _halo_bytes(shape, torch.bfloat16)
        sets = [(_seeded(0, 960 + 20 * i + j, math.prod(shape),
                         torch.bfloat16, dev).view(shape),)
                for j in range(n_sets(2 * edge))]
        err = 0.0
        for (x,) in sets:
            lo, hi = halo(x)
            err = max(err, _abs_err(lo, x[-1:]), _abs_err(hi, x[:1]))
            del lo, hi
        cover = SOLO_MIN_COVER if edge >= L2_BYTES else None
        kern = device_kernels(halo, sets, 20, cover)
        view = arena_view(edge)
        raw = [(x.reshape(-1).view(torch.uint8),) for (x,) in sets]
        # halo_put's: one copy_ of the strips into the arena for each
        # neighbour
        strips.append({
            "shape": list(shape), "edge_bytes": edge, "moved_bytes": moved,
            "err": err, "put": _pick(kern, "halo_put_kernel"),
            "wait": _pick(kern, "peer_wait_kernel"),
            "call_ms": bench_ms(halo, sets, 20),
            "library_ms": device_ms(lambda x: (view.copy_(x), view.copy_(x)),
                                    raw, 20, cover)})
        del sets, raw, view, kern
        torch.cuda.empty_cache()
    g1.close()
    torch.cuda.empty_cache()
    return {"shift": shifts, "strips": strips}


def _fit(b1, t1, b2, t2, moved):
    """The line through two ``(message bytes, ms)`` readings: its
    intercept (a fixed cost, ms) and the rate ``moved`` bytes a message
    byte stream at along its slope (TB/s)."""
    slope = (t2 - t1) / (b2 - b1)
    return {"fixed_ms": t1 - slope * b1,
            "streaming_tb_s": moved / slope / 1e9 if slope > 0 else None}


def _solo_fits(solo):
    """Lines through phase 11 (a)'s readings (``_fit``): for each kernel
    and library call of the shift rows through the ring's two sizes
    (``in_l2``) and through the two beyond the L2 (``beyond_l2``); for
    ``halo_put`` and its two ``copy_`` through the two strips."""
    shifts, (strip, big) = solo["shift"], solo["strips"]
    pairs = {"in_l2": [r for r in shifts
                       if r["n"] == PEER_SPEC["timed_shift"]],
             "beyond_l2": [r for r in shifts if r["bytes"] >= 2 * L2_BYTES]}
    out = {key: {name: _fit(a["bytes"], a[key], b["bytes"], b[key], 2)
                 for name, (a, b) in pairs.items()}
           for key in ("put", "wait", "copy_ms", "library_ms")}
    out["halo_put"] = _fit(strip["edge_bytes"], strip["put"],
                           big["edge_bytes"], big["put"], 3)
    out["halo_library"] = _fit(strip["edge_bytes"], strip["library_ms"],
                               big["edge_bytes"], big["library_ms"], 4)
    return out


def _rank_steps(group, spec):
    """The ring (``_rank_ring``) and the halo exchange (``_rank_halo``) of
    one rank, without their output tensors: step ms per layout and the
    halo's exchange ms."""
    ring = _rank_ring(group, spec)
    return {"ring": {f"{dt}_{layout}_{'causal' if causal else 'full'}":
                     rec["step_ms"] for (dt, layout, causal), rec
                     in ring.items() if "step_ms" in rec},
            "halo_exchange_call_ms":
                _rank_halo(group, spec)["exchange_call_ms"]}


# The fp32 flash shapes of the ``flash-fwd`` and ``flash-bwd`` modes, (b,
# h, sq, sk, causal) at head_dim 64, as in the kernel phase: GPT-2 small's
# causal attention, BERT-large's, the ragged 200 x 333 and b * h = 65,600
FLASH_FP32_SHAPES = [(4, 12, 1024, 1024, True), (32, 16, 128, 128, False),
                     (2, 3, 200, 333, False), (1025, 64, 64, 64, True)]
# the bf16 (tensor-core) cases of the solo modes, (b, h, sq, sk, causal,
# head dim): GPT-2's and GPT-2 XL's causal attention and BERT's at 64;
# Cerebras-GPT 1.3B's causal attention at 128, 2.7B's at 80 (padded to
# 128), GPT-J 6B's at 256 and Nemotron-4 340B's head of 192 (padded to
# 256; the gptj phase's (c))
FLASH_BF16_SHAPES = [(4, 12, 1024, 1024, True, 64),
                     (4, 25, 1024, 1024, True, 64),
                     (32, 16, 128, 128, False, 64),
                     (2, 16, 2048, 2048, True, 128),
                     (2, 32, 2048, 2048, True, 80),
                     (2, 16, 2048, 2048, True, 256),
                     (1, NEMO_HEADS, 2048, 2048, True, NEMO_D)]
_SOLO_CASES = ([(*c, 64, "fp32") for c in FLASH_FP32_SHAPES]
               + [(*c, "bf16") for c in FLASH_BF16_SHAPES])
# the ``flash-bwd`` mode's bf16 cases with attention dropout (FA_DROP_RATE):
# GPT-J 6B's causal attention at 256
FLASH_BWD_DROPOUT_SHAPES = [(2, 16, 2048, 2048, True, 256)]
# the ``flash-bwd`` mode's fp32 cases at the wider heads, (b, h, sq, sk,
# causal, head dim, form): Cerebras-GPT 1.3B's causal attention at 128 and
# GPT-J 6B's at 256 (each with dropout too), Cerebras-GPT 2.7B's head of 80
# (padded to 128) and Nemotron-4's of 192 (padded to 256); the dlogits form
# (a learned (1, h, sq, sk) bias, ``want_dbias``) at 128 and 256, beside
# SDPA's backward with a float ``attn_mask`` that takes a gradient
FLASH_BWD_FP32_WIDE = [(2, 16, 2048, 2048, True, 128, "plain"),
                       (2, 16, 2048, 2048, True, 128, "dropout"),
                       (2, 32, 2048, 2048, True, 80, "plain"),
                       (2, 16, 2048, 2048, True, 256, "plain"),
                       (2, 16, 2048, 2048, True, 256, "dropout"),
                       (1, NEMO_HEADS, 2048, 2048, True, NEMO_D, "plain"),
                       (2, 16, 2048, 2048, True, 128, "dlogits"),
                       (2, 16, 2048, 2048, True, 256, "dlogits")]
# SDPA's bf16 backends the ``flash-bwd`` mode times, each alone
SDPA_BWD_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION")
# the ``flash-fwd`` mode's fp32 cases at the wider heads (the split-TF32
# forward), (b, h, sq, sk, causal, head dim, form): Cerebras-GPT 1.3B's
# causal attention at 128 and GPT-J 6B's at 256, each with dropout too,
# Cerebras-GPT 2.7B's head of 80 (padded to 128) and Nemotron-4's of 192
# (padded to 256)
FLASH_FWD_FP32_WIDE = [(2, 16, 2048, 2048, True, 128, "plain"),
                       (2, 16, 2048, 2048, True, 128, "dropout"),
                       (2, 32, 2048, 2048, True, 80, "plain"),
                       (2, 16, 2048, 2048, True, 256, "plain"),
                       (2, 16, 2048, 2048, True, 256, "dropout"),
                       (1, NEMO_HEADS, 2048, 2048, True, NEMO_D, "plain")]
# the ``flash-fwd`` mode's large-score cases: q and k drawn at twice unit
# scale (a peaked softmax), (b, h, s, head dim, causal), the split-TF32
# forward's and fp32 SDPA's o against the plain version
FLASH_FWD_LARGE_SCORES = [(2, 8, 512, d, c) for d in (128, 256)
                          for c in (True, False)]


def sdpa_backend(kernel_names):
    """Which SDPA backend ran, from the names of the kernels a profile of
    its call recorded: cuDNN's (whose names may also say "flash") first,
    then the flash backend's, the memory-efficient one's (CUTLASS's
    fmha), else the math one (matrix products and a softmax)."""
    names = " ".join(kernel_names).lower()
    for backend, marks in (("CUDNN_ATTENTION", ("cudnn",)),
                           ("FLASH_ATTENTION", ("flash",)),
                           ("EFFICIENT_ATTENTION", ("fmha", "efficient"))):
        if any(m in names for m in marks):
            return backend
    return "MATH"


def _solo_key(b, h, sq, sk, causal, d, dt):
    """A solo case's key: d = 64's without a width (the keys of the trees
    before the wider cases), others with ``_d<d>``."""
    return (f"{'bf16_' if dt == 'bf16' else ''}{b}x{h}x{sq}x{sk}"
            f"{'_causal' if causal else ''}{'' if d == 64 else f'_d{d}'}")


def _causal_pairs(sq, sk, causal):
    """The (query, key) pairs a causal or full score matrix keeps."""
    return sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk


def _flash_bwd_solo(dev):
    """The flash backward at FLASH_FP32_SHAPES in fp32 and
    FLASH_BF16_SHAPES in bf16, without dropout or dlogits, at
    FLASH_BWD_DROPOUT_SHAPES in bf16 with dropout (keys ending in
    ``_dropout``; SDPA with the same rate, its backend named), and at
    FLASH_BWD_FP32_WIDE in fp32 in its forms (dlogits keys ending in
    ``_dlogits``: a learned bias, SDPA's float ``attn_mask`` with grad, the
    causal mask filled in as -inf): the dq and
    dk / dv kernels' device ms (torch.profiler, inputs rotated beyond the
    L2), the whole backward as a caller runs it (D = rowsum(dO o), a
    padded d's pad and slice copies and both kernels), the least time the
    card could take for each kernel (operations at the dtype's peak), and
    SDPA's whole backward timed the same way (TF32 off; the forward graph
    built once, ``autograd.grad`` timed alone): in bf16 on each backend of
    SDPA_BWD_BACKENDS that takes the shape, named, ``library_ms`` the
    fastest; in fp32 on PyTorch's own choice among its other backends."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from apex_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                    flash_attention_fwd)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    seed = torch.tensor([1234], dtype=torch.int32, device=dev)
    for b, h, sq, sk, causal, d, dt, form in (
            [(*c, "plain") for c in _SOLO_CASES]
            + [(*c, "bf16", "dropout") for c in FLASH_BWD_DROPOUT_SHAPES]
            + [(*c[:6], "fp32", c[6]) for c in FLASH_BWD_FP32_WIDE]):
        scale = d ** -0.5
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        drop, dlogits = form == "dropout", form == "dlogits"
        kw = dict(scale=scale, causal=causal)
        if drop:
            kw.update(dropout_p=FA_DROP_RATE, dropout_seed=seed)
        if dlogits:
            kw["bias"] = torch.randn(1, h, sq, sk, device=dev, generator=gen)
        sets = []
        for _ in range(n_sets(3 * b * h * (sq + sk) * d * 4)):
            q, k, v, do = (torch.randn(b, h, n, d, device=dev,
                                       generator=gen).to(dtype)
                           for n in (sq, sk, sk, sq))
            o, lse = flash_attention_fwd(q, k, v, **kw)
            sets.append((q, k, v, o, lse, do))
        split = device_kernels(lambda *a: flash_attention_bwd(
            *a, **kw, want_dbias=dlogits), sets, 20)
        dq = sum(t for n, t in split.items() if "fa_bwd_dq_kernel" in n)
        dkv = sum(t for n, t in split.items() if "fa_bwd_dkv_kernel" in n)
        whole = sum(split.values())
        libs, ran = {}, {}
        backends = ({n: [getattr(SDPBackend, n)] for n in SDPA_BWD_BACKENDS}
                    if dt == "bf16" else
                    {"auto": [SDPBackend.EFFICIENT_ATTENTION,
                              SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH]})
        if drop:
            # and PyTorch's own choice, as the kernel phase's yardstick
            backends["auto"] = [SDPBackend.FLASH_ATTENTION,
                                SDPBackend.EFFICIENT_ATTENTION,
                                SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH]
        for name, chosen in backends.items():
            lsets = []
            try:
                for q, k, v, _, _, do in sets:
                    ins = [t.detach().requires_grad_() for t in (q, k, v)]
                    am = None
                    if dlogits:
                        ins.append(kw["bias"].detach().clone()
                                   .requires_grad_())
                        am = ins[3].masked_fill(torch.ones(
                            sq, sk, dtype=torch.bool, device=dev).triu(1),
                            float("-inf")) if causal else ins[3]
                    with sdpa_kernel(chosen), torch.enable_grad():
                        oo = F.scaled_dot_product_attention(
                            *ins[:3], attn_mask=am,
                            is_causal=causal and am is None, scale=scale,
                            dropout_p=FA_DROP_RATE if drop else 0.0)
                    lsets.append((oo, tuple(ins), do))
                kern = device_kernels(
                    lambda oo, ins, do: torch.autograd.grad(
                        oo, ins, do, retain_graph=True), lsets, 20)
                libs[name] = sum(kern.values())
                ran[name] = sdpa_backend(kern)
            except RuntimeError as e:  # the backend refuses the shape
                libs[name] = f"refused: {str(e).splitlines()[0][:120]}"
            del lsets
        timed_libs = {n: t for n, t in libs.items() if isinstance(t, float)}
        best = min(timed_libs, key=timed_libs.get) if timed_libs else None
        ops = 2 * b * h * d * _causal_pairs(sq, sk, causal)
        # the dlogits form also writes every (query, key)'s dl and reads
        # the bias once
        dl_bytes = 4 * (b * h * sq * sk + kw["bias"].numel()) if dlogits \
            else 0
        out[_solo_key(b, h, sq, sk, causal, d, dt)
            + ("" if form == "plain" else f"_{form}")] = dict(
            dq_ms=dq, dkv_ms=dkv, pair_ms=dq + dkv, whole_ms=whole,
            outside_ms=whole - dq - dkv,
            library_ms=timed_libs.get(best), library_backend=best,
            library_by_backend=libs, library_ran=ran,
            bound_dq_ms=max(3 * ops / PEAK_OPS[dt],
                            dl_bytes / HBM_BYTES_PER_S) * 1e3,
            bound_dkv_ms=4 * ops / PEAK_OPS[dt] * 1e3,
            kernels=sorted(n.split("(")[0] for n in split
                           if "fa_bwd_" in n))
        del sets
    return out


def _flash_fwd_solo(dev):
    """The flash forward at FLASH_FP32_SHAPES in fp32 and
    FLASH_BF16_SHAPES in bf16, without dropout: the kernel's device ms
    (torch.profiler, inputs rotated beyond the L2), the least time the
    card could take (two products' operations at the dtype's peak), and
    SDPA's forward on the same inputs timed the same way (TF32 off), as
    the kernel phase times it. Then at FLASH_FWD_FP32_WIDE in fp32 (keys
    ``_d<d>``, ``_dropout``): the split-TF32 kernel's device ms (and the
    pad and slice copies' at a padded d), its bounds as split-TF32 products
    (``bound_ms``, three TF32 products at 495 TFLOP/s) and on the FMA
    pipes (``bound_fma_ms``), fp32 SDPA's forward with the same dropout
    rate (its backend named) and, without dropout, max |o - plain| of the
    kernel and of SDPA against the plain version on the same inputs. Then
    at FLASH_FWD_LARGE_SCORES (``large_scores``): the kernel's o and lse
    errors and SDPA's o error against the plain version beside FA_TOL."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from apex_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                    flash_attention_fwd_plain)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for b, h, sq, sk, causal, d, dt in _SOLO_CASES:
        scale = d ** -0.5
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        sets = [tuple(torch.randn(b, h, n, d, device=dev, generator=gen)
                      .to(dtype) for n in (sq, sk, sk))
                for _ in range(n_sets(2 * b * h * (sq + sk) * d * 4))]
        split = device_kernels(lambda q, k, v: flash_attention_fwd(
            q, k, v, scale=scale, causal=causal), sets, 30)
        library = device_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale), sets, 30)
        ops = 4 * b * h * d * _causal_pairs(sq, sk, causal)
        ms = sum(t for n, t in split.items() if "fa_fwd_kernel" in n)
        out[_solo_key(b, h, sq, sk, causal, d, dt)] = dict(
            ms=ms, library_ms=library,
            bound_ms=ops / PEAK_OPS[dt] * 1e3,
            kernels=sorted(n.split("(")[0] for n in split))
        del sets
    seed = torch.tensor([1234], dtype=torch.int32, device=dev)
    sdpa = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
            SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH]
    for b, h, sq, sk, causal, d, form in FLASH_FWD_FP32_WIDE:
        scale = d ** -0.5
        drop = form == "dropout"
        kw = dict(scale=scale, causal=causal)
        if drop:
            kw.update(dropout_p=FA_DROP_RATE, dropout_seed=seed)
        sets = [tuple(torch.randn(b, h, n, d, device=dev, generator=gen)
                      for n in (sq, sk, sk))
                for _ in range(n_sets(2 * b * h * (sq + sk) * d * 4))]
        split = device_kernels(lambda q, k, v: flash_attention_fwd(
            q, k, v, **kw), sets, 20)
        ms = sum(t for n, t in split.items() if "fa_fwd_kernel" in n)

        def library(q, k, v):
            with sdpa_kernel(sdpa):
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, scale=scale,
                    dropout_p=FA_DROP_RATE if drop else 0.0)

        lib_kern = device_kernels(library, sets, 20)
        q, k, v = sets[0]
        o, _ = flash_attention_fwd(q, k, v, **kw)
        op, _ = flash_attention_fwd_plain(q, k, v, **kw)
        err = (o - op).abs().max().item()
        lib_err = None if drop else (library(q, k, v) - op).abs().max() \
            .item()
        del o, op
        ops = 4 * b * h * d * _causal_pairs(sq, sk, causal)
        bound_ms = ops / PEAK_OPS["tf32x3"] * 1e3
        bound_fma_ms = ops / PEAK_OPS["fp32"] * 1e3
        out[_solo_key(b, h, sq, sk, causal, d, "fp32")
            + ("_dropout" if drop else "")] = dict(
            ms=ms, pad_ms=sum(split.values()) - ms,
            library_ms=sum(lib_kern.values()),
            library_backend=sdpa_backend(lib_kern),
            bound_ms=bound_ms, bound_share=bound_ms / ms,
            bound_fma_ms=bound_fma_ms, bound_fma_share=bound_fma_ms / ms,
            max_abs_err=err, library_max_abs_err=lib_err,
            tol=FA_TOL["fp32"][0],
            kernels=sorted(n.split("(")[0] for n in split))
        del sets
    large = {}
    for b, h, s, d, causal in FLASH_FWD_LARGE_SCORES:
        q, k = (2.0 * torch.randn(b, h, s, d, device=dev, generator=gen)
                for _ in range(2))
        v = torch.randn(b, h, s, d, device=dev, generator=gen)
        kw = dict(scale=d ** -0.5, causal=causal)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        op, lsep = flash_attention_fwd_plain(q, k, v, **kw)
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            osd = F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                 scale=d ** -0.5)
        rec = dict(o_err=(o - op).abs().max().item(),
                   lse_err=(lse - lsep).abs().max().item(),
                   sdpa_efficient_o_err=(osd - op).abs().max().item(),
                   tol=FA_TOL["fp32"][0], lse_tol=LSE_TOL)
        large[f"{b}x{h}x{s}_d{d}{'_causal' if causal else ''}"] = rec
        require(rec["o_err"] <= FA_TOL["fp32"][0]
                and rec["lse_err"] <= LSE_TOL,
                f"fp32 flash forward on large scores, d = {d}: {rec}")
    out["large_scores"] = large
    return out


# The softmax cases of ``softmax`` mode, as in the kernel phase: (name,
# scores, dtype, op, mask, causal); the masks as the kernel phase makes
# them ("pad": the megatron cross-attention's key padding of lengths 512 /
# 400 / 256 / 17, "pad0" with a length 0; "full": a (scores) bool mask;
# "b1qk" a (b, 1, sq, sk) uint8 one; "1hqk" a (1, h, sq, sk) bool one;
# "row": a (1, 1, 1, sk) bool one)
_XL = (4, 25, 1024, 1024)
SOFTMAX_SOLO_CASES = [
    ("row 7: masked, pad", (4, 25, 1024, 512), "fp32", "fwd", "pad", False),
    ("row 6: causal", _XL, "fp32", "fwd", None, True),
    ("row 8: backward", _XL, "fp32", "bwd", None, True),
    ("full mask (AOT)", (128, 1024, 1024), "fp32", "fwd", "full", False),
    ("(b, 1, sq, sk) uint8", _XL, "fp32", "fwd", "b1qk", False),
    ("(1, h, sq, sk) bf16", _XL, "bf16", "fwd", "1hqk", False),
    ("pad with a length 0", (4, 25, 1024, 512), "fp32", "fwd", "pad0",
     False),
    ("sk 100,003 masked", (1, 1, 256, 100003), "fp32", "fwd", "row", False),
]


def _softmax_solo(dev):
    """The megatron softmax kernels at SOFTMAX_SOLO_CASES: device ms
    (torch.profiler, inputs rotated beyond the L2) beside the bytes bound
    (x read once, the lower triangle only for causal, the mask once, y
    written once; the backward y and dy read, dx written) and, for the
    forward, ``torch.softmax`` on the pre-scaled, pre-masked input (the
    scale and mask passes excluded), as the kernel phase times them."""
    import torch

    from apex_tpu_torch.ops.softmax_kernel import (MASK_FILL, softmax_bwd,
                                                   softmax_fwd)
    gen = torch.Generator(device=dev).manual_seed(0)
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16}
    scale = 0.125
    out = {}
    for name, shape, dt, op, kind, causal in SOFTMAX_SOLO_CASES:
        sq, sk = shape[-2], shape[-1]
        if kind in ("pad", "pad0"):
            lens = torch.tensor([512, 400, 0 if kind == "pad0" else 256, 17],
                                device=dev)
            mask = (torch.arange(sk, device=dev)[None, :] >= lens[:, None]
                    )[:, None, None, :]
        elif kind is not None:
            mshape = {"full": shape, "b1qk": (shape[0], 1, sq, sk),
                      "1hqk": (1, shape[1], sq, sk),
                      "row": (1, 1, 1, sk)}[kind]
            mask = torch.rand(mshape, device=dev, generator=gen) < 0.3
            if kind == "b1qk":
                mask = mask.to(torch.uint8)
        else:
            mask = None
        n = math.prod(shape)
        es = torch.tensor([], dtype=tdt[dt]).element_size()
        read = (n // sk // sq) * _causal_pairs(sq, sk, True) if causal else n
        nbytes = (read * es + n * es + (0 if mask is None else
                                        mask.numel() * mask.element_size())
                  if op == "fwd" else 3 * n * es)
        sets = []
        for _ in range(n_sets(nbytes)):
            x = torch.randn(shape, device=dev, generator=gen,
                            dtype=tdt[dt]) * 3
            if op == "fwd":
                sets.append((x,))
            else:
                sets.append((softmax_fwd(x, scale=scale, causal=causal),
                             torch.randn(shape, device=dev, generator=gen,
                                         dtype=tdt[dt])))
                del x
        if op == "fwd":
            ms = device_ms(lambda x: softmax_fwd(x, mask, scale=scale,
                                                 causal=causal), sets, 20)
            lsets = []
            for (x,) in sets:
                x32 = x.float() * scale
                if mask is not None:
                    x32 = x32.masked_fill(mask != 0, MASK_FILL)
                if causal:
                    x32 = x32.masked_fill(torch.ones(
                        sq, sk, dtype=torch.bool, device=dev).triu(1),
                        MASK_FILL)
                lsets.append((x32.to(x.dtype),))
            library = device_ms(lambda x: torch.softmax(x, dim=-1), lsets,
                                20)
            del lsets
        else:
            ms = device_ms(lambda y, dy: softmax_bwd(y, dy, scale=scale),
                           sets, 20)
            library = device_ms(lambda y, dy: torch._softmax_backward_data(
                dy, y, -1, y.dtype), sets, 20)
        out[name] = dict(ms=ms, library_ms=library,
                         bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                         scores=list(shape), dtype=dt,
                         mask=None if mask is None else list(mask.shape))
        del sets
        torch.cuda.empty_cache()
    return out


# the cases of ``norm`` mode: the two-pass GroupNorm pair (``gn_stats``,
# ``gn_apply`` and the whole two-pass forward) at the UNet's
# up_blocks.3.resnets.0 960 channels, the SD VAE decoder's last GroupNorm
# and 75 x 75 latents (n, h, w, c; bf16, SiLU, weight and bias), and as
# witnesses the LayerNorm backward and forward and the one-pass GroupNorm
# at their main shapes
NORM_LN_BWD = [(4096, 768, "bf16", False, True)]
NORM_GN_ONE_PASS = [(8, 64, 64, 320, "bf16", "silu", "wb")]
NORM_LN_FWD = (4096, 768)
NORM_GN_TWO_PASS = [(8, 64, 64, 960), (1, 512, 512, 128), (2, 75, 75, 960)]


def _norm_solo(dev):
    """The norm kernels at the NORM_* cases: device ms (torch.profiler,
    inputs rotated beyond the L2; ``kernels`` splits a call's ms by
    kernel) beside the bytes bound (each input read once, each output
    written once; the two-pass kernels' partial sums by the tile count
    gn_hw_block picks, which the pair's geometry keeps; the pair's that of
    the GroupNorm it computes, x read once) and the library
    call: for ``ln_bwd`` ``native_layer_norm_backward`` (none for
    RMSNorm), for ``ln_fwd`` ``F.layer_norm``, for the GroupNorm kernels
    ``F.group_norm`` (+ ``F.silu``) on the NCHW view (for each two-pass
    kernel and the pair: the whole GroupNorm)."""
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.ops.group_norm_kernel import (
        gn_apply, gn_forward, gn_moments, gn_one_pass, gn_shift, gn_stats)
    from apex_tpu_torch.ops.layer_norm_kernel import (ln_bwd, ln_fwd,
                                                      ln_fwd_plain)
    from apex_tpu_torch.ops.tiling import gn_hw_block
    gen = torch.Generator(device=dev).manual_seed(0)
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16}
    bf = torch.bfloat16

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, device=dev, generator=gen).to(dtype)

    def record(kern, nbytes, library, **shape):
        return dict(ms=sum(kern.values()), kernels=kern, library_ms=library,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes,
                    **shape)

    out = {}
    for rows, hidden, dt, rms, affine in NORM_LN_BWD:
        t, es = tdt[dt], 2 if dt == "bf16" else 4
        nparam = (0 if not affine else 2 if rms else 3) * hidden * 4
        nbytes = 3 * rows * hidden * es + rows * (4 if rms else 8) + nparam
        sets, lsets = [], []
        for _ in range(n_sets(nbytes)):
            x, dy = randn(rows, hidden, dtype=t), randn(rows, hidden,
                                                        dtype=t)
            g = randn(hidden) if affine else None
            b = randn(hidden) if affine and not rms else None
            _, mu, iv = ln_fwd_plain(x, g, b, eps=1e-5, rms=rms)
            sets.append((dy, x, g, b, None if rms else mu, iv))
            if not rms:
                gl = None if g is None else g.to(t)
                bl = None if b is None else b.to(t)
                _, lmu, lrs = torch.ops.aten.native_layer_norm(
                    x, [hidden], gl, bl, 1e-5)
                lsets.append((dy, x, lmu, lrs, gl, bl))
        kern = device_kernels(lambda *a: ln_bwd(*a, rms=rms), sets, 50)
        library = None if rms else device_ms(
            lambda dy, x, mu, rs, gl, bl:
            torch.ops.aten.native_layer_norm_backward(
                dy, x, [hidden], mu, rs, gl, bl,
                [True, gl is not None, bl is not None]), lsets, 50)
        form = ("rms" if rms else "ln") + ("" if affine else "_nogamma")
        out[f"ln_bwd {form} {rows}x{hidden} {dt} (witness)"] = record(
            kern, nbytes, library, rows=rows, hidden=hidden, dtype=dt,
            form=form)
        del sets, lsets
    rows, hidden = NORM_LN_FWD
    nbytes = 2 * rows * hidden * 2 + 2 * hidden * 4 + rows * 8
    sets = [(randn(rows, hidden, dtype=bf), randn(hidden), randn(hidden))
            for _ in range(n_sets(nbytes))]
    kern = device_kernels(lambda x, g, b: ln_fwd(x, g, b, eps=1e-5), sets,
                          50)
    lsets = [(x, g.to(bf), b.to(bf)) for x, g, b in sets]
    library = device_ms(lambda x, g, b: F.layer_norm(x, (hidden,), g, b,
                                                     1e-5), lsets, 50)
    out[f"ln_fwd {rows}x{hidden} bf16 (witness)"] = record(
        kern, nbytes, library, rows=rows, hidden=hidden, dtype="bf16")
    del sets, lsets

    def gn_sets(n, h, w, c, t, affine, nbytes):
        return [(randn(n, h * w, c, dtype=t),
                 1 + 0.1 * randn(c) if affine and "w" in affine else None,
                 0.1 * randn(c) if affine and "b" in affine else None)
                for _ in range(n_sets(nbytes))]

    def gn_library(sets, n, h, w, c, act):
        def call(x, wt, bt):
            y = F.group_norm(x.view(n, h, w, c).permute(0, 3, 1, 2),
                             GN_GROUPS, None if wt is None else wt.to(x.dtype),
                             None if bt is None else bt.to(x.dtype), 1e-5)
            return F.silu(y) if act == "silu" else y
        return device_ms(call, sets, 20)

    for n, h, w, c, dt, act, affine in NORM_GN_ONE_PASS:
        t, es = tdt[dt], 2 if dt == "bf16" else 4
        elems = n * h * w * c
        nbytes = (2 * elems * es + len(affine or "") * c * 4
                  + 2 * n * GN_GROUPS * 4)
        sets = gn_sets(n, h, w, c, t, affine, nbytes)
        kern = device_kernels(lambda x, wt, bt: gn_one_pass(
            x, GN_GROUPS, wt, bt, eps=1e-5, act=act), sets, 20)
        out[f"gn_one_pass {n}x{h}x{w}x{c} {dt} {act or 'no act'} "
            f"{affine or 'no affine'} (witness)"] = record(
            kern, nbytes, gn_library(sets, n, h, w, c, act),
            shape=[n, h, w, c], dtype=dt, act=act, affine=affine)
        del sets
    for n, h, w, c in NORM_GN_TWO_PASS:
        hw, elems, stats = h * w, n * h * w * c, n * GN_GROUPS * 4
        blk = gn_hw_block(hw, c)
        partials = 2 * n * (hw // blk) * GN_GROUPS * 4
        stats_bytes = elems * 2 + stats + partials
        apply_bytes = 2 * elems * 2 + 2 * c * 4 + 3 * stats
        # the whole GroupNorm's: x read once, y, mean and rstd written
        pair_bytes = 2 * elems * 2 + 2 * c * 4 + 2 * stats
        sets = gn_sets(n, h, w, c, bf, "wb", 2 * elems * 2)
        shifts = [gn_shift(x, GN_GROUPS) for x, _, _ in sets]
        moments = [gn_moments(*gn_stats(x, k, blk), hw * (c // GN_GROUPS),
                              1e-5)
                   for (x, _, _), k in zip(sets, shifts)]
        library = gn_library(sets, n, h, w, c, "silu")
        shape = dict(shape=[n, h, w, c], dtype="bf16", tile=blk)
        tag = f"{n}x{h}x{w}x{c} bf16"
        ssets = [(x, k) for (x, _, _), k in zip(sets, shifts)]
        kern = device_kernels(lambda x, k: gn_stats(x, k, blk), ssets, 20)
        out[f"gn_stats {tag}"] = record(kern, stats_bytes, library,
                                        **shape)
        asets = [(x, k, md, rs, wt, bt) for (x, wt, bt), k, (md, rs)
                 in zip(sets, shifts, moments)]
        kern = device_kernels(lambda x, k, md, rs, wt, bt: gn_apply(
            x, k, md, rs, wt, bt, blk, act="silu"), asets, 20)
        out[f"gn_apply {tag}"] = record(kern, apply_bytes, library, **shape)
        # the pair as the model calls it: K, the stats kernel, the
        # moments' tensor ops, the apply kernel
        kern = device_kernels(lambda x, wt, bt: gn_forward(
            x, GN_GROUPS, wt, bt, 1e-5, "silu", "two_pass"), sets, 20)
        out[f"gn two-pass pair {tag}"] = record(kern, pair_bytes, library,
                                                **shape)
        del sets, ssets, asets, shifts, moments
        torch.cuda.empty_cache()
    return out


def mode_main(mode, root) -> int:
    """``python3 chip_smoke.py
    remote-copy|ring|flash-fwd|flash-bwd|softmax|norm|ptxas [ROOT]``: one
    part of the run alone, for the ``apex_tpu_torch`` of the checkout at ROOT
    (by default this one), so that two checkouts can be timed in turns on
    one card in one run. ``remote-copy``: phase 11 (a),
    one ``remote_copy_solo`` line. ``ring``: phases 12 and 13 at world 4
    (the bf16 ring's step ms by layout and the halo's exchange ms on every
    rank), one ``ring_steps`` line. ``flash-fwd``: the flash forward and
    SDPA's forward at FLASH_FP32_SHAPES (fp32) and FLASH_BF16_SHAPES
    (bf16), the fp32 forward at FLASH_FWD_FP32_WIDE beside fp32 SDPA's
    (the split-TF32 kernel: device ms, both bounds, errors against the
    plain version) and its errors at FLASH_FWD_LARGE_SCORES, one
    ``flash_fwd_solo`` line. ``flash-bwd``: the flash
    backward's dq and dk / dv kernels and SDPA's backward at the same
    shapes, one ``flash_bwd_solo`` line. ``softmax``: the megatron softmax
    kernels and ``torch.softmax`` at SOFTMAX_SOLO_CASES, one
    ``softmax_solo`` line. ``norm``: the
    two-pass GroupNorm pair (each kernel and the whole two-pass forward)
    at the NORM_GN_TWO_PASS shapes, with the LayerNorm backward and
    forward and the one-pass GroupNorm at their main shapes as witnesses,
    against their library calls, one ``norm_solo`` line. ``ptxas``:
    the ptxas report of PTXAS_SOURCES (registers, spills, stack of every
    instantiation, as the env line has it, without requiring this
    script's list of flash forms: an older checkout names its kernels
    without a head width), one ``ptxas`` line. Then the ``profiler`` line
    and the ``nvidia-smi`` line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    root = Path(root).resolve()
    if not (root / "apex_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no apex_tpu_torch/csrc under {root}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from apex_tpu_torch.ops import _build
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = smi_line()
    t0 = time.perf_counter()
    _build.lib()
    common = dict(root=str(root), build_s=time.perf_counter() - t0,
                  card=f"{torch.cuda.get_device_name(0)}, "
                       f"{smi.split(',')[-1].strip()} limit")
    if mode == "remote-copy":
        solo = _remote_copy_solo(dev)
        emit("remote_copy_solo", fits=_solo_fits(solo), **common, **solo)
    elif mode == "flash-fwd":
        emit("flash_fwd_solo", **common, shapes=_flash_fwd_solo(dev))
    elif mode == "flash-bwd":
        emit("flash_bwd_solo", **common, shapes=_flash_bwd_solo(dev))
    elif mode == "softmax":
        emit("softmax_solo", **common, cases=_softmax_solo(dev))
    elif mode == "norm":
        emit("norm_solo", **common, cases=_norm_solo(dev))
    elif mode == "ptxas":
        emit("ptxas", **common, ptxas=ptxas_report(_build, PTXAS_SOURCES,
                                                   forms=False))
    else:
        from apex_tpu_torch.parallel import spawn_ranks
        ranks = spawn_ranks(_rank_steps, HALO_WORLD, (PEER_SPEC,),
                            device=dev, timeout_s=600)
        emit("ring_steps", world=HALO_WORLD, tokens=RING_TOKENS,
             step_ms={k: [r["ring"][k] for r in ranks]
                      for k in ranks[0]["ring"]},
             halo_exchange_call_ms=[r["halo_exchange_call_ms"]
                                    for r in ranks], **common)
    emit("profiler", **PROFILE_PASSES)
    print(smi, flush=True)
    return 0


# the kernels whose ptxas report the env line carries, by source: the
# flash tensor-core kernels and the fp32 route's FMA-pipe forward and
# backward pair, each in every form (_FLASH_FORMS); the LayerNorm
# backward's register form, the one-pass GroupNorm's cluster route and
# the two-pass pair's vector route, every instantiation
PTXAS_SOURCES = {"flash_fwd_wgmma.cu": ("fa_fwd_kernel_wgmma",),
                 "flash_fwd_tf32.cu": ("fa_fwd_kernel_tf32",),
                 "flash_bwd_dq_wgmma.cu": ("fa_bwd_dq_kernel_wgmma",),
                 "flash_bwd_dkv_wgmma.cu": ("fa_bwd_dkv_kernel_wgmma",),
                 "flash_attention.cu": ("fa_fwd_kernel",),
                 "flash_attention_bwd.cu": ("fa_bwd_dq_kernel_fma",
                                            "fa_bwd_dkv_kernel_fma"),
                 "layer_norm.cu": ("ln_bwd_kernel_reg",),
                 "group_norm.cu": ("gn_one_pass_kernel_cluster",
                                   "gn_stats_kernel_vec",
                                   "gn_apply_kernel_vec")}
# the report's kernels that must keep every value in registers (no
# spill), by the start of their key: the fp32 flash forward's and
# backward's unbiased forms (the backward's at every width, the forward's
# on the FMA kernel at 64 and the split-TF32 one at 128 and 256), the bf16
# tensor-core forward and backward
# pair in every form at every width (their consumers' setmaxnreg
# registers), every form of the LayerNorm backward's
# register form, the two-pass GroupNorm's bf16 vector stats kernel and
# every form of its vector apply kernel (the fp32 stats kernel spills 8
# bytes at 40 registers, which PERF.md reports)
NO_SPILL_KERNELS = ("fa_fwd_kernel<64,false,false>", "fa_fwd_kernel_wgmma<",
                    "fa_fwd_kernel_tf32<128,false,",
                    "fa_fwd_kernel_tf32<256,false,",
                    "fa_bwd_dq_kernel_wgmma<",
                    "fa_bwd_dkv_kernel_wgmma<",
                    "fa_bwd_dq_kernel_fma<64,false,false,false>",
                    "fa_bwd_dkv_kernel_fma<64,false,false>",
                    "fa_bwd_dq_kernel_fma<128,false,false,false>",
                    "fa_bwd_dkv_kernel_fma<128,false,false>",
                    "fa_bwd_dq_kernel_fma<256,false,false,false>",
                    "fa_bwd_dkv_kernel_fma<256,false,false>",
                    "ln_bwd_kernel_reg<",
                    "gn_stats_kernel_vec<bf16>", "gn_apply_kernel_vec<")
# the flash kernels' forms, each reported at every compiled head width
# (the fp32 forward's FMA kernel at 64, its split-TF32 one at 128 and
# 256): (width, bias, dropout), and the dq kernels' (width, bias, dropout,
# dlogits), dlogits only with a bias
_FORMS2 = tuple(f"{w},{b},{d}" for w in (64, 128, 256)
                for b in ("false", "true") for d in ("false", "true"))
_FORMS_DQ = tuple(f"{w},{f}" for w in (64, 128, 256) for f in (
    "false,false,false", "false,true,false", "true,false,false",
    "true,true,false", "true,false,true", "true,true,true"))
_FLASH_FORMS = {"fa_fwd_kernel_wgmma": _FORMS2,
                "fa_bwd_dq_kernel_wgmma": _FORMS_DQ,
                "fa_bwd_dkv_kernel_wgmma": _FORMS2,
                "fa_fwd_kernel": tuple(f for f in _FORMS2
                                       if f.startswith("64,")),
                "fa_fwd_kernel_tf32": tuple(f for f in _FORMS2
                                            if not f.startswith("64,")),
                "fa_bwd_dq_kernel_fma": _FORMS_DQ,
                "fa_bwd_dkv_kernel_fma": _FORMS2}
# a mangled template argument as the report names it
_TEMPLATE_ARGS = {"f": "float", "13__nv_bfloat16": "bf16"}


def _template_args(mangled):
    """The template arguments of a mangled instantiation (``I...E``): its
    types, int literals and bools, as ``float,4,false,true``."""
    import re
    out = []
    for tok in re.findall(r"13__nv_bfloat16|f|L[ib]\d+E", mangled):
        if tok in _TEMPLATE_ARGS:
            out.append(_TEMPLATE_ARGS[tok])
        elif tok.startswith("Lb"):
            out.append("true" if tok[2:-1] == "1" else "false")
        else:
            out.append(tok[2:-1])
    return ",".join(out)


def ptxas_report(build, sources, forms=True):
    """``{kernel: {registers, spill_stores, spill_loads, stack}}`` from
    ``nvcc -Xptxas -v`` on ``sources`` (``{source: kernel names}``, one
    compile each, together, after the library's build), each kernel named
    by its function and template arguments (``fa_fwd_kernel<64,false,true>``,
    ``ln_bwd_kernel_reg<bf16,3,false,true>``); every named kernel must
    appear, the flash kernels in every form of ``_FLASH_FORMS`` (with
    ``forms``)."""
    import re
    import tempfile
    names = list(sources)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        procs = [subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             str(build.CSRC / n), "-o", str(Path(tmp) / f"{n}.o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for n in names]
        outs = [p.communicate()[0] for p in procs]
    wanted = "|".join(sorted({k for ks in sources.values() for k in ks},
                             key=len, reverse=True))
    mangled = r"_Z\w*?\d(" + wanted + r")I((?:13__nv_bfloat16|f|L[ib]\d+E)+)E"
    out, kernel = {}, None
    for line in "\n".join(outs).splitlines():
        m = re.search(r"Compiling entry function '" + mangled, line)
        if m:
            kernel = f"{m.group(1)}<{_template_args(m.group(2))}>"
            out[kernel] = {}
        elif "Compiling entry function" in line:
            kernel = None
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and kernel:
            out[kernel].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out[kernel]["registers"] = int(m.group(1))
        # ptxas serialises a kernel's wgmma pipeline (no overlap of the
        # products with other work) where it cannot prove the accumulator
        # registers untouched while a product is in flight
        m = re.search(mangled, line)
        if m and "serialized" in line:
            out.setdefault(f"{m.group(1)}<{_template_args(m.group(2))}>",
                           {})["wgmma_serialized"] = \
                line.split(":", 2)[-1].strip()
    want = {f"{k}<{f}>" for k, fs in _FLASH_FORMS.items() for f in fs
            if forms and any(k in ks for ks in sources.values())}
    missing = [k for ks in sources.values() for k in ks
               if not any(key.startswith(k + "<") for key in out)]
    require(want <= set(out) and not missing,
            f"ptxas report: {sorted(out)}, expected {sorted(want)} and "
            f"every one of {sorted(sources.values())}")
    return out


def bench_ms(fn, sets, reps):
    """Mean ms of ``fn(*sets[i % len(sets)])`` over ``reps`` calls
    between two CUDA events, after a warm-up: the time per call as a
    caller sees it, host dispatch included."""
    import torch
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


def device_kernels(fn, sets, reps, min_cover=None):
    """``{kernel name: mean device ms per call}`` of ``fn`` over
    ``reps`` calls cycling through ``sets`` (torch.profiler), after a
    warm-up; a pass counts only if it recorded ``reps`` times every
    kernel of one call (and, with ``min_cover``, covered that share of
    the card's clock: ``_per_call_ms``), up to PROFILE_TRIES passes."""
    for a in sets[:2]:
        fn(*a)
    it = _cycle(sets)
    one = {}
    for _ in range(PROFILE_TRIES):
        got, seen = _per_call_ms(lambda: fn(*next(it)), reps, one,
                                 min_cover)
        if got:
            return got
    require(False, f"torch.profiler lost device kernels in "
                   f"{PROFILE_TRIES} passes: {seen}")


def device_ms(fn, sets, reps, min_cover=None):
    """Mean device ms per call of ``fn``: the summed durations of the
    kernels it launched (torch.profiler), over ``reps`` calls."""
    return sum(device_kernels(fn, sets, reps, min_cover).values())


def fma_bwd_occupancy(build):
    """``{kernel<d,bias,dropout[,dlogits]>: {"blocks": n, "want": m}}``:
    the blocks of each form of the fp32 backward pair
    (``fa_bwd_dq_kernel_fma``, ``fa_bwd_dkv_kernel_fma``) at each compiled
    width that an SM of this card holds at once, as the kernels are
    launched (``apex_fa_bwd_fma_occupancy``: the CUDA occupancy
    calculator), beside the geometry's ``blocks_per_sm``."""
    import ctypes

    from apex_tpu_torch.ops.tiling import FA_HEAD_DIMS, fa_fma_bwd_geometry
    lib, out = build.lib(), {}
    # (kernel, bias, dropout, dlogits): dlogits in dq only, with a bias
    forms = [(k, b, dr, dl) for k in (0, 1) for b in (0, 1) for dr in (0, 1)
             for dl in (0, 1) if not dl or (k == 0 and b)]
    for d in FA_HEAD_DIMS:
        for kernel, b, dr, dl in forms:
            n = ctypes.c_int(0)
            build.check(lib.apex_fa_bwd_fma_occupancy(
                d, kernel, b, dr, dl, ctypes.byref(n)),
                "apex_fa_bwd_fma_occupancy")
            name = ("fa_bwd_dq_kernel_fma" if kernel == 0
                    else "fa_bwd_dkv_kernel_fma")
            args = ",".join(["true" if x else "false" for x in
                             (b, dr, dl)[:3 if kernel == 0 else 2]])
            out[f"{name}<{d},{args}>"] = {
                "blocks": n.value,
                "want": fa_fma_bwd_geometry(d).blocks_per_sm}
    return out


def tf32_fwd_occupancy(build):
    """``{fa_fwd_kernel_tf32<d,bias,dropout>: {"blocks": n, "want": m}}``:
    the blocks of each form of the split-TF32 forward at d = 128 and 256
    that an SM of this card holds at once, as the kernel is launched
    (``apex_fa_fwd_tf32_occupancy``: the CUDA occupancy calculator),
    beside the geometry's ``blocks_per_sm``."""
    import ctypes

    from apex_tpu_torch.ops.tiling import fa_tf32_fwd_geometry
    lib, out = build.lib(), {}
    for d in (128, 256):
        for b in (0, 1):
            for dr in (0, 1):
                n = ctypes.c_int(0)
                build.check(lib.apex_fa_fwd_tf32_occupancy(
                    d, b, dr, ctypes.byref(n)), "apex_fa_fwd_tf32_occupancy")
                args = ",".join("true" if x else "false" for x in (b, dr))
                out[f"fa_fwd_kernel_tf32<{d},{args}>"] = {
                    "blocks": n.value,
                    "want": fa_tf32_fwd_geometry(d).blocks_per_sm}
    return out


def n_sets(bytes_per_set):
    """Input copies to cycle so each call finds its data out of L2."""
    return int(min(16, max(2, math.ceil(2 * L2_BYTES / bytes_per_set))))


def bound(nbytes, ops, dt):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dt]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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

    from apex_tpu_torch.contrib.group_norm import _gn_plain
    from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy_loss
    from apex_tpu_torch.models.bert import Bert, BertConfig, mlm_loss
    from apex_tpu_torch.models.convert import (init_bert_params,
                                               init_gpt2_params)
    from apex_tpu_torch.models.gpt2 import GPT2, GPT2Config, lm_loss
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops.flash_attention import (
        NEG_INF, dropout_keep, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_fwd, flash_attention_fwd_plain)
    from apex_tpu_torch.models.convert import init_resnet_params
    from apex_tpu_torch.models.resnet import ResNet50
    from apex_tpu_torch.ops.fused_adam_kernel import (
        fused_adam_flat, fused_adam_flat_master, fused_adam_flat_master_plain,
        fused_adam_flat_plain)
    from apex_tpu_torch.ops.fused_opt_kernels import (
        fused_adagrad_flat, fused_adagrad_flat_plain, fused_lamb_flat,
        fused_lamb_flat_plain, fused_novograd_flat, fused_novograd_flat_plain,
        row_segment_ids, row_segments)
    from apex_tpu_torch.ops.fused_sgd_kernel import (fused_sgd_flat,
                                                     fused_sgd_flat_plain)
    from apex_tpu_torch.ops.group_norm_kernel import (
        gn_apply, gn_apply_plain, gn_moments, gn_one_pass, gn_one_pass_plain,
        gn_shift, gn_stats, gn_stats_plain)
    from apex_tpu_torch.ops.layer_norm_kernel import (ln_bwd, ln_bwd_plain,
                                                      ln_fwd, ln_fwd_plain)
    from apex_tpu_torch.ops.softmax_kernel import (
        MASK_FILL, mask_plan, mask_route, softmax_bwd, softmax_bwd_plain,
        softmax_fwd, softmax_fwd_plain)
    from apex_tpu_torch.ops.tiling import fa_kernel_head_dim, softmax_form
    from apex_tpu_torch.ops.flash_attention import flash_attention
    from apex_tpu_torch.transformer import (
        MLP, EncdecMultiheadAttn, FusedDenseGeluDense, SelfMultiheadAttn,
        linear_cross_entropy, mha_reference)
    from apex_tpu_torch.optimizers import (FusedAdagrad, FusedAdam,
                                           FusedLAMB, FusedNovoGrad,
                                           FusedSGD)
    from apex_tpu_torch.ops.tiling import gn_hw_block, gn_one_pass_ok
    from apex_tpu_torch.optimizers.fused_adam import FLAT_PAD
    from apex_tpu_torch.serve import cli
    from apex_tpu_torch.serve.engine import Engine, EngineConfig
    from apex_tpu_torch.serve.scheduler import Request, ServeScheduler
    from apex_tpu_torch.train import TrainConfig, Trainer
    from apex_tpu_torch.utils.flatten import flat_spec, flatten

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
    ptxas = ptxas_report(_build, PTXAS_SOURCES)
    # the fp32 flash forward's and backward's unbiased forms and the
    # LayerNorm backward's register form keep every value in registers
    for prefix in NO_SPILL_KERNELS:
        reps = {k: r for k, r in ptxas.items() if k.startswith(prefix)}
        require(bool(reps), f"ptxas report: no {prefix} kernel")
        for name, rep in reps.items():
            require(rep.get("spill_stores") == 0
                    and rep.get("spill_loads") == 0,
                    f"{name} spills: {rep}")
    # no tensor-core kernel's wgmma pipeline is serialised (the forward,
    # dq and dK·dV in every form at every width)
    serial = {k: r["wgmma_serialized"] for k, r in ptxas.items()
              if k.startswith(("fa_fwd_kernel_wgmma<",
                               "fa_bwd_dq_kernel_wgmma<",
                               "fa_bwd_dkv_kernel_wgmma<"))
              and "wgmma_serialized" in r}
    require(not serial, f"ptxas serialises a wgmma pipeline: {serial}")
    # every form of the fp32 backward pair keeps its geometry's blocks an
    # SM resident (two at d = 128)
    fma_blocks = fma_bwd_occupancy(_build)
    wrong = {k: r for k, r in fma_blocks.items() if r["blocks"] != r["want"]}
    require(not wrong, f"fp32 flash backward blocks an SM: {wrong}")
    # and every form of the split-TF32 forward (two at d = 128)
    tf32_blocks = tf32_fwd_occupancy(_build)
    wrong = {k: r for k, r in tf32_blocks.items()
             if r["blocks"] != r["want"]}
    require(not wrong, f"fp32 split-TF32 forward blocks an SM: {wrong}")
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         sources=[p.relative_to(ROOT).as_posix() for p in _build.sources()],
         nvcc_flags=_build.NVCC_FLAGS, build_s=build_s, ptxas=ptxas,
         fma_bwd_blocks_per_sm=fma_blocks,
         tf32_fwd_blocks_per_sm=tf32_blocks)

    # ------------------------------------------------ 2. kernel vs plain
    def device_profile(fn, counts=None, passes=1):
        """Run ``fn()`` under torch.profiler (``_profile``); returns
        ``{kernel name: us}``, the summed durations of the device kernels
        it ran (and fills ``counts``, if given, with ``{kernel name:
        runs}``). A pass in which the profiler recorded no device kernel
        at all (seen once in five runs on an H100 host), or lost every spin
        at one end of its window, is run again, up to PROFILE_TRIES
        passes. With ``passes`` > 1, ``fn()`` runs under
        that many profiles and the names are those any of them recorded
        (durations summed over them): a route check of a kernel launched
        once a call then fails only if every profile lost its record."""
        out = {}
        for _ in range(passes):
            for _ in range(PROFILE_TRIES):
                got, runs, kept = _profile(fn)
                if got and kept:
                    break
            for name, us in got.items():
                out[name] = out.get(name, 0.0) + us
        if counts is not None:
            counts.update(runs)
        return out

    def kind_of(name):
        low = name.lower()
        return ("flash" if "fa_fwd_kernel" in name else
                "flash_bwd" if "fa_bwd_" in name else
                "layer_norm" if ("ln_fwd_kernel" in name
                                 or "ln_bwd_" in name) else
                "adam" if "fused_adam_kernel" in name else
                "adam_master" if "fused_adam_master_kernel" in name else
                "lamb" if "lamb_stage" in name else
                "sgd" if "fused_sgd_kernel" in name else
                "novograd" if "fused_novograd_kernel" in name else
                "adagrad" if "fused_adagrad_kernel" in name else
                "group_norm" if any(k in name for k in (
                    "gn_one_pass_kernel", "gn_stats_kernel",
                    "gn_apply_kernel")) else
                "softmax" if any(k in name for k in (
                    "sm_fwd_resident", "sm_fwd_stream", "sm_bwd_resident",
                    "sm_bwd_stream")) else
                "conv" if any(s in low for s in (
                    "fprop", "dgrad", "wgrad", "conv", "implicit_gemm",
                    "cudnn")) else
                "matmul" if any(s in low for s in (
                    "gemm", "cutlass", "xmma", "nvjet", "cublas"))
                else "other")

    def require_flash_route(kern, dt, what,
                            kernels=("fa_fwd_kernel", "fa_bwd_dq_kernel",
                                     "fa_bwd_dkv_kernel"), width=64):
        """From a profile's kernel names: bf16 flash ran the tensor-core
        kernels (``<kernel>_wgmma``), fp32 the FMA-pipe ones (the
        templates named in FMA_FLASH_NAMES), the fp32 forward at a kernel
        ``width`` of 128 or 256 the split-TF32 one (TF32_FWD_NAME), and
        not another."""
        for kern_name in kernels:
            tc = any(kern_name + "_wgmma" in n for n in kern)
            fma = any(FMA_FLASH_NAMES[kern_name] in n for n in kern)
            tf32 = any(TF32_FWD_NAME in n for n in kern)
            want_tf32 = (kern_name == "fa_fwd_kernel" and dt != "bf16"
                         and width != 64)
            require((tc, fma, tf32) == (dt == "bf16",
                                        dt != "bf16" and not want_tf32,
                                        want_tf32),
                    f"{what} ({dt}): {kern_name} tensor-core {tc}, FMA "
                    f"{fma}, split-TF32 {tf32}")

    def by_kind(kern):
        """Device ms of a profile, summed by kind of kernel."""
        out = {"flash": 0.0, "flash_bwd": 0.0, "layer_norm": 0.0,
               "adam": 0.0, "adam_master": 0.0, "lamb": 0.0, "sgd": 0.0,
               "novograd": 0.0, "adagrad": 0.0, "group_norm": 0.0,
               "softmax": 0.0, "conv": 0.0, "matmul": 0.0, "other": 0.0}
        for name, us in kern.items():
            out[kind_of(name)] += us / 1e3
        out["total"] = sum(out.values())
        return out

    def top_kernels(kern, keep, n=12):
        """The ``n`` largest device ms of a profile among the kernels
        ``keep`` selects, by name cut to 90 characters (kernels whose cut
        names agree are added together)."""
        out = {}
        for name, us in kern.items():
            if keep(name):
                out[name[:90]] = out.get(name[:90], 0.0) + us / 1e3
        return dict(sorted(out.items(), key=lambda kv: -kv[1])[:n])

    def timed(fn, sets, reps):
        return {"ms": device_ms(fn, sets, reps),
                "call_ms": bench_ms(fn, sets, reps)}

    def close(got, want, atol, rtol):
        """``(ok, max |got - want|)`` under ``atol + rtol * |want|``."""
        d = (got.float() - want.float()).abs()
        return (bool((d <= atol + rtol * want.float().abs()).all()),
                d.max().item() if d.numel() else 0.0)

    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16,
           "fp16": torch.float16}
    gen = torch.Generator(device=dev).manual_seed(0)
    summary = {}

    def ln_form(rms, affine):
        return ("rms" if rms else "ln") + ("" if affine else "_nogamma")

    def ln_case(rows, hidden, dt, main=None, rms=False, affine=True):
        """LayerNorm forward (gamma and beta), or RMSNorm (gamma, no beta)
        with ``rms``, or either without gamma; ``main`` names the summary
        record of a main-path shape."""
        es = torch.tensor([], dtype=tdt[dt]).element_size()
        nparam = (0 if not affine else 1 if rms else 2) * hidden * 4
        nbytes = rows * hidden * 2 * es + nparam + rows * 8
        sets = []
        for _ in range(n_sets(nbytes)):
            x = (torch.randn(rows, hidden, device=dev, generator=gen) * 2
                 + 0.5).to(tdt[dt])
            g = torch.randn(hidden, device=dev, generator=gen)
            b = torch.randn(hidden, device=dev, generator=gen)
            sets.append((x, g if affine else None,
                         b if affine and not rms else None))
        x, g, b = sets[0]
        kw = dict(eps=1e-5, rms=rms)
        y, mu, iv = ln_fwd(x, g, b, **kw)
        yp, mup, ivp = ln_fwd_plain(x, g, b, **kw)
        torch.cuda.synchronize()
        atol, rtol = LN_TOL[dt]
        dy = (y.float() - yp.float()).abs()
        ok_y = bool((dy <= atol + rtol * yp.float().abs()).all())
        err_stats = max((mu - mup).abs().max().item(),
                        ((iv - ivp).abs() / ivp.abs()).max().item())
        require(ok_y and err_stats <= 1e-5
                and (not rms or not bool(mu.any())),
                f"ln_fwd {ln_form(rms, affine)} {rows}x{hidden} {dt}: y err "
                f"{dy.max().item()} (atol {atol} rtol {rtol}), stats err "
                f"{err_stats}")
        reps = 50
        kt = timed(lambda x, g, b: ln_fwd(x, g, b, **kw), sets, reps)
        pt = timed(lambda x, g, b: ln_fwd_plain(x, g, b, **kw), sets,
                   reps // 5)
        # the library call takes gamma / beta in x's dtype: cast once here
        lsets = [(x, None if g is None else g.to(x.dtype),
                  None if b is None else b.to(x.dtype)) for x, g, b in sets]
        if rms:
            lt = timed(lambda x, g, b: F.rms_norm(x, (hidden,), g, 1e-5),
                       lsets, reps)
        else:
            lt = timed(lambda x, g, b: F.layer_norm(x, (hidden,), g, b,
                                                    1e-5), lsets, reps)
        bms, by = bound(nbytes, 8 * rows * hidden, "fp32")
        rec = dict(kernel="ln_fwd", form=ln_form(rms, affine), rows=rows,
                   hidden=hidden, dtype=dt,
                   max_abs_err=dy.max().item(), stats_err=err_stats,
                   tol={"atol": atol, "rtol": rtol}, ms=kt["ms"],
                   plain_ms=pt["ms"], library_ms=lt["ms"], bound_ms=bms,
                   bound_by=by, call_ms=kt["call_ms"],
                   plain_call_ms=pt["call_ms"],
                   library_call_ms=lt["call_ms"], bytes=nbytes)
        emit("kernel", **rec)
        if main:
            summary[main] = rec

    def make_mask(b, h, sq, sk, kind):
        """``(bias, boolean mask)`` of a mask kind, True = masked, from the
        seeded generator: ``"pad"`` is a (b, 1, 1, sk) key-padding mask of
        random lengths (the first batch entry keeps all keys); ``"full"``
        a (b, h, sq, sk) mask of random entries with whole rows masked."""
        if kind == "pad":
            lens = torch.randint(1, sk + 1, (b,), device=dev, generator=gen)
            lens[0] = sk
            mask = (torch.arange(sk, device=dev)[None, :] >= lens[:, None]
                    )[:, None, None, :]
        else:
            mask = torch.rand(b, h, sq, sk, device=dev, generator=gen) < 0.3
            mask[0, 0, :4] = True
            mask[-1, -1, sq // 2] = True
        return (torch.zeros(mask.shape, device=dev)
                .masked_fill_(mask, -1e30), mask)

    def require_flash_form(kern, what, name, width, *form):
        """From a profile's kernel names: kernel ``name`` ran in the
        instantiation of the compiled head width ``width`` and the
        template arguments ``form`` (bools: bias, dropout and, for the dq
        kernels, dlogits)."""
        args = ",".join([str(width)] + [str(bool(f)).lower() for f in form])
        ok = any(f"{name}<{args}>" in n.replace(" ", "") for n in kern)
        require(ok, f"{what}: no {name}<{args}> among {sorted(kern)}")

    def split_pad(kern, names):
        """``(ms of the kernels named, ms of the rest)`` of a profile: at
        a padded head dim the rest is the pad and slice copies."""
        ms = sum(v for k, v in kern.items() if any(n in k for n in names))
        return ms, sum(kern.values()) - ms

    def fa_case(b, h, sq, sk, causal, dt, main=None, mask_kind=None,
                dropout=False, d=64):
        """The flash forward at one shape against its plain version on the
        same card inputs (FA_TOL, LSE_TOL), two runs bit-identical; with
        ``dropout`` at FA_DROP_RATE from a seed in device memory (the same
        keep mask) and SDPA with ``dropout_p`` as the library yardstick
        (its Philox mask is not ours; the work is the same). ``d``: the
        head dim (64 and 128 run as they are, any other zero-padded to the
        next: ``pad_ms`` is then the pad and slice copies, ``kernel_ms``
        the kernel's own time, ``ms`` both), at the scale 1 / sqrt(d)."""
        es = torch.tensor([], dtype=tdt[dt]).element_size()
        bias, mask = (make_mask(b, h, sq, sk, mask_kind) if mask_kind
                      else (None, None))
        nbytes = b * h * (2 * sq + 2 * sk) * d * es + b * h * sq * 4 \
            + (0 if bias is None else bias.numel() * 4)
        if mask is not None:
            # count what this run's data needs: the unmasked pairs
            pairs = int((~mask).expand(b, h, sq, sk).sum().item()) // (b * h)
        else:
            pairs = _causal_pairs(sq, sk, causal)
        ops = 4 * b * h * d * pairs
        sets = [tuple(torch.randn(b, h, s, d, device=dev, generator=gen)
                      .to(tdt[dt]) for s in (sq, sk, sk))
                for _ in range(n_sets(nbytes))]
        q, k, v = sets[0]
        scale = 1.0 / math.sqrt(d)
        kw = dict(scale=scale, causal=causal, bias=bias)
        if dropout:
            kw.update(dropout_p=FA_DROP_RATE, dropout_seed=torch.tensor(
                [1234], dtype=torch.int32, device=dev))
        o, lse = flash_attention_fwd(q, k, v, **kw)
        again = flash_attention_fwd(q, k, v, **kw)
        op, lsep = flash_attention_fwd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        atol, rtol = FA_TOL[dt]
        do = (o.float() - op.float()).abs()
        ok_o = bool((do <= atol + rtol * op.float().abs()).all())
        dl = (lse - lsep).abs().max().item()
        det = torch.equal(o, again[0]) and torch.equal(lse, again[1])
        dead_ok = True
        if mask is not None:
            dead = mask.expand(b, h, sq, sk).all(dim=-1)
            dead_ok = bool((o[dead] == 0).all()) \
                and bool((lse[dead] == NEG_INF).all())
        form = "dropout" if dropout else None
        what = (f"fa_fwd {b}x{h}x{sq}x{sk}x{d} causal={causal} "
                f"mask={mask_kind} form={form} {dt}")
        require(ok_o and dl <= LSE_TOL and dead_ok and det,
                f"{what}: o err {do.max().item()} (atol {atol} rtol {rtol}), "
                f"lse err {dl}, fully masked rows zero {dead_ok}, "
                f"deterministic {det}")
        del again
        reps = 30

        def fwd(q, k, v):
            return flash_attention_fwd(q, k, v, **kw)

        kern = device_kernels(fwd, sets, reps)
        kd = fa_kernel_head_dim(d)
        route = fa_route_of("fa_fwd", dt, kd)
        require_flash_route(kern, dt, what, ("fa_fwd_kernel",), width=kd)
        require_flash_form(kern, what, "fa_fwd_kernel" + {
            "wgmma": "_wgmma", "tf32": "_tf32", "fma": ""}[route], kd,
            bias is not None, dropout)
        kernel_ms, pad_ms = split_pad(kern, ("fa_fwd_kernel",))
        kt = {"ms": sum(kern.values()), "call_ms": bench_ms(fwd, sets, reps)}
        pt = timed(lambda q, k, v: flash_attention_fwd_plain(q, k, v, **kw),
                   sets, 5)
        # SDPA's causal mask is top-left aligned like the kernel's, and
        # it returns o only (no lse): the same o for this yardstick. Its
        # boolean mask means True = attend, the kernel's True = masked
        keep = None if mask is None else ~mask
        lt = timed(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, attn_mask=keep, is_causal=causal, scale=scale,
            dropout_p=FA_DROP_RATE if dropout else 0.0), sets, reps)
        # the split-TF32 kernel's bound: three TF32 products for each
        # fp32 one on the tensor cores; the FMA pipes' beside it
        bms, by = bound(nbytes, ops, "tf32x3" if route == "tf32" else dt)
        fma_bound = {}
        if route == "tf32":
            fma_ms = bound(nbytes, ops, "fp32")[0]
            fma_bound = {"bound_fma_ms": fma_ms,
                         "bound_fma_share": fma_ms / kt["ms"]}
        rec = dict(kernel="fa_fwd", b=b, h=h, sq=sq, sk=sk, d=d,
                   width=kd, route=route, **fma_bound, causal=causal,
                   mask=mask_kind, dtype=dt, form=form,
                   kernel_ms=kernel_ms, pad_ms=pad_ms,
                   max_abs_err=do.max().item(), lse_err=dl,
                   tol={"atol": atol, "rtol": rtol, "lse_atol": LSE_TOL},
                   deterministic=det,
                   ms=kt["ms"], plain_ms=pt["ms"], library_ms=lt["ms"],
                   bound_ms=bms, bound_by=by, call_ms=kt["call_ms"],
                   plain_call_ms=pt["call_ms"],
                   library_call_ms=lt["call_ms"], bytes=nbytes, flops=ops,
                   tflops=ops / kt["ms"] / 1e9, bound_share=bms / kt["ms"])
        emit("kernel", **rec)
        if main:
            summary[main] = rec

    def fa_order_census(d=64):
        """The bf16 forward's summation order at head dim ``d`` (64, 128
        or 256): at d = 64 the card tests' b * h = 65,600 causal s = 64
        case (the same seed), at d = 128 b * h = 32,800, at d = 256 16,400
        (the same bytes): o past FA_TOL against
        the plain version (required: none) and, for the record, each
        against a float64 evaluation of the same function (p rounded to
        bf16 from float64 scores); and the score's order error, in units
        of 2^-24 |q| |k|, of a tensor-core product (cuBLAS, bf16 in, fp32
        out) and of the plain version's fp32 product, on the first 64
        heads. The kernel sums again, in the plain version's order, the
        scores whose bf16 p the tensor cores' order could move, on a bound
        of kOrderUnits = 16 d / 64 such units (csrc/flash_fwd_wgmma.cu):
        required here, at most half of it."""
        b, h, s = 1025, 64 * 64 // d, 64
        units = 16.0 * d / 64
        scale = d ** -0.5
        g = torch.Generator(device=dev).manual_seed(17)
        q, k, v = (torch.randn(b, h, s, d, device=dev, generator=g)
                   .to(torch.bfloat16) for _ in range(3))
        o, _ = flash_attention_fwd(q, k, v, scale=scale, causal=True)
        op, _ = flash_attention_fwd_plain(q, k, v, scale=scale,
                                          causal=True)
        s64 = torch.matmul(q.double(), k.double().transpose(-1, -2)) \
            * scale
        s64.masked_fill_(torch.ones(s, s, dtype=torch.bool,
                                    device=dev).triu(1), NEG_INF)
        p64 = torch.exp(s64 - s64.amax(-1, keepdim=True))
        del s64
        o64 = torch.matmul(p64.to(torch.bfloat16).double(), v.double()) \
            / p64.sum(-1, keepdim=True)
        del p64
        atol, rtol = FA_TOL["bf16"]

        def past(got, want):
            d = (got.double() - want).abs()
            return int((d > atol + rtol * want.abs()).sum())

        qs, ks = q[:1].reshape(-1, s, d), k[:1].reshape(-1, s, d)
        exact = torch.matmul(qs.double(), ks.double().transpose(-1, -2))
        unit = 2.0 ** -24 * (qs.double().norm(dim=-1)[..., :, None]
                             * ks.double().norm(dim=-1)[..., None, :])
        fp32 = torch.matmul(qs.float(), ks.float().transpose(-1, -2))
        tc = torch.stack([torch.mm(qs[i], ks[i].t(), out_dtype=torch.float32)
                          for i in range(qs.shape[0])])
        rec = dict(kernel="fa_fwd", check="bf16 summation order", b=b, h=h,
                   sq=s, sk=s, d=d, causal=True, elements=o.numel(),
                   order_units_bound=units,
                   tol={"atol": atol, "rtol": rtol},
                   past_tol_kernel_vs_plain=past(o, op.double()),
                   past_tol_kernel_vs_float64=past(o, o64),
                   past_tol_plain_vs_float64=past(op, o64),
                   score_units_tc_vs_fp32=((tc - fp32).abs() / unit)
                   .max().item(),
                   score_units_fp32_vs_float64=((fp32 - exact).abs() / unit)
                   .max().item(),
                   score_units_tc_vs_float64=((tc - exact).abs() / unit)
                   .max().item())
        emit("kernel", **rec)
        require(rec["past_tol_kernel_vs_plain"] == 0,
                f"bf16 fa_fwd past FA_TOL at b*h = {b * h}: {rec}")
        require(rec["score_units_tc_vs_fp32"] <= units / 2,
                f"the tensor cores' score order error is past half the "
                f"kernel's bound: {rec}")
        del q, k, v, o, op, o64, exact, unit, fp32, tc
        torch.cuda.empty_cache()

    with torch.inference_mode():
        for dt in ("bf16", "fp32"):
            ln_case(4 * 1024, 768, dt, main="ln_fwd" if dt == "bf16"
                    else None)
            ln_case(4, 768, dt)
            ln_case(1000, 768, dt)
            ln_case(37, 1600, dt)
            # BERT-large's norms: 32 x 128 rows of 1024
            ln_case(4096, 1024, dt, rms=True,
                    main="ln_fwd_rms" if dt == "bf16" else None)
            ln_case(4096, 1024, dt, rms=True, affine=False)
            ln_case(4096, 1024, dt, affine=False)
            # rows wider than the shared-memory form: GPT-3's 12288
            ln_case(64, 12288, dt)
            ln_case(64, 12288, dt, rms=True)
            for causal in (True, False):
                fa_case(4, 12, 1024, 1024, causal, dt,
                        main=(("fa_fwd" if dt == "bf16" else "fa_fwd_fp32")
                              if causal else None))
            fa_case(4, 12, 1000, 1000, True, dt)
            fa_case(2, 3, 200, 333, False, dt)
            # BERT-large's attention: 32 x 16 heads x 128 x 64, full,
            # plain and with a key-padding mask; a full mask with whole
            # rows masked
            fa_case(32, 16, 128, 128, False, dt,
                    main="fa_fwd_bert" if dt == "bf16"
                    else "fa_fwd_fp32_bert")
            fa_case(32, 16, 128, 128, False, dt, mask_kind="pad")
            fa_case(4, 16, 128, 128, False, dt, mask_kind="full")
            # b * h = 65,600: the grid's y x z slices
            fa_case(1025, 64, 64, 64, True, dt)
            # the dropout form: GPT-2 XL's causal attention (the summary's
            # row), BERT's with its key-padding mask, and a ragged causal
            # shape with keys past the last query
            fa_case(4, XL_HEADS, XL_SEQ, XL_SEQ, True, dt, dropout=True,
                    main="fa_fwd" + ("" if dt == "bf16" else "_fp32")
                    + "_dropout")
            fa_case(32, 16, 128, 128, False, dt, mask_kind="pad",
                    dropout=True)
            fa_case(2, 3, 200, 333, True, dt, dropout=True)
            # head dim 128: Cerebras-GPT 1.3B's causal attention (2 x 16 x
            # 2048 x 128; the summary's rows) plain and with dropout,
            # BERT's shape with its key-padding mask, a ragged causal
            # shape; the padded route at Cerebras-GPT 2.7B's head dim 80
            # (2 x 32 x 2048: the d = 80 summary rows)
            t = "" if dt == "bf16" else "_fp32"
            fa_case(CG_BATCH, CG_HEADS, CG_CTX, CG_CTX, True, dt, d=128,
                    main="fa_fwd" + t + "_d128")
            fa_case(CG_BATCH, CG_HEADS, CG_CTX, CG_CTX, True, dt, d=128,
                    dropout=True, main="fa_fwd" + t + "_d128_dropout")
            fa_case(32, 16, 128, 128, False, dt, mask_kind="pad", d=128)
            fa_case(32, 16, 128, 128, False, dt, mask_kind="pad", d=128,
                    dropout=True)
            fa_case(2, 3, 200, 333, True, dt, d=128)
            fa_case(CG_BATCH, CG27_HEADS, CG_CTX, CG_CTX, True, dt, d=80,
                    main="fa_fwd" + t + "_d80")
            # head dim 256: GPT-J 6B's causal attention (2 x 16 x 2048 x
            # 256; the summary's d256 rows) plain and with dropout, BERT's
            # shape with its key-padding mask, a ragged causal shape; the
            # padded route at Nemotron-4 340B's head dim 192 (1 x 8 x 2048:
            # the d192 rows)
            fa_case(GJ_BATCH, GJ_HEADS, GJ_CTX, GJ_CTX, True, dt, d=256,
                    main="fa_fwd" + t + "_d256")
            fa_case(GJ_BATCH, GJ_HEADS, GJ_CTX, GJ_CTX, True, dt, d=256,
                    dropout=True, main="fa_fwd" + t + "_d256_dropout")
            fa_case(32, 16, 128, 128, False, dt, mask_kind="pad", d=256,
                    dropout=True)
            fa_case(2, 3, 200, 333, True, dt, d=256)
            fa_case(1, NEMO_HEADS, GJ_CTX, GJ_CTX, True, dt, d=NEMO_D,
                    main="fa_fwd" + t + "_d192")
        fa_order_census()
        fa_order_census(128)
        fa_order_census(256)

    def ln_bwd_case(rows, hidden, dt, main=None, rms=False, affine=True):
        es = torch.tensor([], dtype=tdt[dt]).element_size()
        # dy and x read, dx written, mean / invvar / gamma read,
        # dgamma / dbeta written
        nparam = (0 if not affine else 2 if rms else 3) * hidden * 4
        nbytes = 3 * rows * hidden * es + rows * (4 if rms else 8) + nparam
        sets = []
        for _ in range(n_sets(nbytes)):
            x = (torch.randn(rows, hidden, device=dev, generator=gen) * 2
                 + 0.5).to(tdt[dt])
            dy = torch.randn(rows, hidden, device=dev, generator=gen) \
                .to(tdt[dt])
            g = torch.randn(hidden, device=dev, generator=gen)
            b = torch.randn(hidden, device=dev, generator=gen)
            g = g if affine else None
            b = b if affine and not rms else None
            _, mu, iv = ln_fwd_plain(x, g, b, eps=1e-5, rms=rms)
            sets.append((dy, x, g, b, None if rms else mu, iv))
        got = ln_bwd(*sets[0], rms=rms)
        want = ln_bwd_plain(*sets[0], rms=rms)
        torch.cuda.synchronize()
        atol, rtol = LN_BWD_TOL[dt]
        ok_dx, err = close(got[0], want[0], atol, rtol)
        ok_g, err_g, ok_b, err_b = True, None, True, None
        if got[1] is not None:
            ok_g, err_g = close(got[1], want[1], *LN_PARAM_GRAD_TOL)
        if got[2] is not None:
            ok_b, err_b = close(got[2], want[2], *LN_PARAM_GRAD_TOL)
        shapes_ok = all((a is None) == (c is None)
                        for a, c in zip(got, want))
        again = ln_bwd(*sets[0], rms=rms)
        deterministic = all(a is None or torch.equal(a, c)
                            for a, c in zip(got, again))
        require(ok_dx and ok_g and ok_b and deterministic and shapes_ok,
                f"ln_bwd {ln_form(rms, affine)} {rows}x{hidden} {dt}: dx "
                f"err {err} (atol {atol} rtol {rtol}), dgamma err {err_g}, "
                f"dbeta err {err_b}, deterministic {deterministic}")
        reps = 50
        kt = timed(lambda *a: ln_bwd(*a, rms=rms), sets, reps)
        pt = timed(lambda *a: ln_bwd_plain(*a, rms=rms), sets, reps // 5)
        # the library call takes gamma / beta in x's dtype and its own
        # (rows, 1) fp32 statistics; RMSNorm has no backward op of its
        # own: autograd of F.rms_norm, the graph built once, the backward
        # timed alone
        lsets = []
        for dy, x, g, b, _, _ in sets:
            gl = None if g is None else g.to(x.dtype)
            bl = None if b is None else b.to(x.dtype)
            if rms:
                with torch.enable_grad():
                    xx = x.detach().requires_grad_()
                    gg = (None if gl is None
                          else gl.detach().clone().requires_grad_())
                    yy = F.rms_norm(xx, (hidden,), gg, 1e-5)
                lsets.append((yy, tuple(t for t in (xx, gg)
                                        if t is not None), dy))
            else:
                _, mu, rs = torch.ops.aten.native_layer_norm(
                    x, [hidden], gl, bl, 1e-5)
                lsets.append((dy, x, mu, rs, gl, bl))
        if rms:
            lt = timed(lambda yy, ins, dy: torch.autograd.grad(
                yy, ins, dy, retain_graph=True), lsets, reps)
        else:
            lt = timed(lambda dy, x, mu, rs, gl, bl:
                       torch.ops.aten.native_layer_norm_backward(
                           dy, x, [hidden], mu, rs, gl, bl,
                           [True, gl is not None, bl is not None]),
                       lsets, reps)
        bms, by = bound(nbytes, 12 * rows * hidden, "fp32")
        rec = dict(kernel="ln_bwd", form=ln_form(rms, affine), rows=rows,
                   hidden=hidden, dtype=dt,
                   max_abs_err=err, dgamma_err=err_g, dbeta_err=err_b,
                   deterministic=deterministic,
                   tol={"atol": atol, "rtol": rtol,
                        "param_grad": LN_PARAM_GRAD_TOL},
                   ms=kt["ms"], plain_ms=pt["ms"], library_ms=lt["ms"],
                   bound_ms=bms, bound_by=by, call_ms=kt["call_ms"],
                   plain_call_ms=pt["call_ms"],
                   library_call_ms=lt["call_ms"], bytes=nbytes)
        emit("kernel", **rec)
        if main:
            summary[main] = rec

    def fa_bwd_case(b, h, sq, sk, causal, dt, main=None, mask_kind=None,
                    dropout=False, dbias=False, d=64):
        """The flash backward's dq and dk / dv kernels at one shape against
        the plain version on the same card inputs (FA_BWD_TOL), two runs
        bit-identical. ``dropout``: at FA_DROP_RATE from a seed in device
        memory (the same keep mask), SDPA with ``dropout_p`` as the library
        yardstick (backward alone, and forward + backward; its Philox mask
        is not ours, the work is the same). ``dbias``: the dq kernel's
        dlogits of a learned (1, h, sq, sk) bias (plus the mask's -1e30
        with ``mask_kind``), held to DLOGITS_TOL; SDPA's backward with a
        float ``attn_mask`` that requires grad as the yardstick. ``main``
        keeps the records in the summary as ``fa_bwd_dq<main>`` and
        ``fa_bwd_dkv<main>``. ``d``: the head dim, as in ``fa_case``
        (``dvec_ms`` is all outside the two kernels: D's sum and, at a
        padded d, the pad and slice copies)."""
        scale = 1.0 / math.sqrt(d)
        es = torch.tensor([], dtype=tdt[dt]).element_size()
        mbias, mask = (make_mask(b, h, sq, sk, mask_kind) if mask_kind
                       else (None, None))
        if mask is not None:
            pairs = int((~mask).expand(b, h, sq, sk).sum().item()) // (b * h)
        else:
            pairs = _causal_pairs(sq, sk, causal)
        bias = mbias
        if dbias:
            learned = torch.randn(1, h, sq, sk, device=dev, generator=gen)
            bias = learned if mbias is None else learned + mbias
        io = b * h * d * es
        stats = b * h * sq * 8          # lse and D, fp32
        extra = 0 if bias is None else bias.numel() * 4
        dl_bytes = b * h * sq * sk * 4 if dbias else 0
        # dq: reads q, k, v, do, lse, D (and the bias), writes dq (and the
        # dlogits); dk / dv: reads the same, writes dk and dv
        bytes_dq = io * (3 * sq + 2 * sk) + stats + extra + dl_bytes
        bytes_dkv = io * (2 * sq + 4 * sk) + stats + extra
        ops_dq = 3 * 2 * b * h * d * pairs    # S, dP, dq
        ops_dkv = 4 * 2 * b * h * d * pairs   # S, dP, dv, dk
        kw = dict(scale=scale, causal=causal, bias=bias)
        if dropout:
            kw.update(dropout_p=FA_DROP_RATE, dropout_seed=torch.tensor(
                [1234], dtype=torch.int32, device=dev))
        sets = []
        for _ in range(n_sets(bytes_dkv + dl_bytes)):
            q, k, v = (torch.randn(b, h, s, d, device=dev, generator=gen)
                       .to(tdt[dt]) for s in (sq, sk, sk))
            do = torch.randn(b, h, sq, d, device=dev, generator=gen) \
                .to(tdt[dt])
            o, lse = flash_attention_fwd(q, k, v, **kw)
            sets.append((q, k, v, o, lse, do))
        bkw = dict(kw, want_dbias=dbias)
        got = flash_attention_bwd(*sets[0], **bkw)
        want = flash_attention_bwd_plain(*sets[0], **bkw)
        again = flash_attention_bwd(*sets[0], **bkw)
        torch.cuda.synchronize()
        form = "+".join(f for f, on in (("dropout", dropout),
                                        ("dbias", dbias)) if on) or None
        what = (f"fa_bwd {b}x{h}x{sq}x{sk}x{d} causal={causal} "
                f"mask={mask_kind} form={form} {dt}")
        atol, rtol = FA_BWD_TOL[dt]
        errs, share = {}, {}
        for name, g_, w_ in zip(("dq", "dk", "dv", "dbias"), got, want):
            ta, tr = DLOGITS_TOL if name == "dbias" else (atol, rtol)
            diff = (g_.float() - w_.float()).abs()
            errs[name] = diff.max().item()
            share[name] = (diff / (ta + tr * w_.float().abs())).max().item()
            require(share[name] <= 1.0,
                    f"{what}: {name} err {errs[name]} (atol {ta} rtol {tr})")
            del diff
        if mask is not None:
            dead = mask.expand(b, h, sq, sk).all(dim=-1)
            require(bool((got[0][dead] == 0).all()),
                    f"{what}: a fully masked row has a nonzero dq")
        deterministic = all(torch.equal(x, y) for x, y in zip(got, again))
        require(deterministic, f"{what}: two runs gave different bits")
        dl_stats = {}
        if dbias:
            # the dlogits' scale beside their error: the largest entry and
            # the median of the entries the kernel computes (not 0)
            mag = want[3].abs()
            dl_stats = dict(dl_max=mag.max().item(),
                            dl_typical=mag[mag > 0].median().item())
            del mag
        del got, want, again
        reps = 20

        def bwd(*a):
            return flash_attention_bwd(*a, **bkw)

        split = device_kernels(bwd, sets, reps)
        require_flash_route(split, dt, what,
                            ("fa_bwd_dq_kernel", "fa_bwd_dkv_kernel"))
        tail = "_wgmma" if dt == "bf16" else "_fma"
        kd = fa_kernel_head_dim(d)
        require_flash_form(split, what, "fa_bwd_dq_kernel" + tail, kd,
                           bias is not None, dropout, dbias)
        require_flash_form(split, what, "fa_bwd_dkv_kernel" + tail, kd,
                           bias is not None, dropout)
        ms_dq = sum(v for k, v in split.items() if "fa_bwd_dq_kernel" in k)
        ms_dkv = sum(v for k, v in split.items()
                     if "fa_bwd_dkv_kernel" in k)
        call = bench_ms(bwd, sets, reps)
        pt = timed(lambda *a: flash_attention_bwd_plain(*a, **bkw), sets, 3)
        library = lib_both = None
        if mask_kind != "full":
            # SDPA's backward, timed alone: the forward graph is built
            # once and only autograd.grad is timed; the flash backend for
            # bf16 without a mask or a float bias, PyTorch's own choice
            # otherwise, in fp32 (its flash backend takes neither; TF32 is
            # off, above), with dropout, and where the flash backend
            # refuses the shape (causal with sq != sk)
            from torch.nn.attention import SDPBackend, sdpa_kernel
            others = [SDPBackend.EFFICIENT_ATTENTION,
                      SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH]
            backends = others
            if mask is None and dt == "bf16" and not dbias:
                backends = [SDPBackend.FLASH_ATTENTION] + (
                    others if dropout or (causal and sq != sk) else [])

            def sdpa(q, k, v, do, timed_alone):
                qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
                ins = [qq, kk, vv]
                am = None if mask is None else ~mask
                with sdpa_kernel(backends), torch.enable_grad():
                    if dbias:
                        bb = learned.detach().clone().requires_grad_()
                        am = bb if mbias is None else bb + mbias
                        if causal:
                            am = am.masked_fill(torch.ones(
                                sq, sk, dtype=torch.bool, device=dev)
                                .triu(1), float("-inf"))
                        am = am.to(tdt[dt])
                        ins.append(bb)
                    oo = F.scaled_dot_product_attention(
                        qq, kk, vv, attn_mask=am,
                        is_causal=causal and am is None, scale=scale,
                        dropout_p=FA_DROP_RATE if dropout else 0.0)
                if timed_alone:
                    return oo, tuple(ins), do
                torch.autograd.grad(oo, ins, do)

            lsets = [sdpa(q, k, v, do, True) for q, k, v, _, _, do in sets]

            def lib_bwd(oo, ins, do):
                torch.autograd.grad(oo, ins, do, retain_graph=True)

            lib_kern = device_kernels(lib_bwd, lsets, reps)
            library = {"ms": sum(lib_kern.values()),
                       "call_ms": bench_ms(lib_bwd, lsets, reps),
                       "backend": sdpa_backend(lib_kern)}
            del lsets
            if dropout:
                # SDPA's forward + backward with dropout beside ours
                lib_both = device_ms(lambda q, k, v, o, lse, do: sdpa(
                    q, k, v, do, False), sets, 10)
        common = dict(b=b, h=h, sq=sq, sk=sk, d=d, width=kd, causal=causal,
                      mask=mask_kind,
                      dtype=dt, form=form, tol={"atol": atol, "rtol": rtol},
                      deterministic=deterministic, call_ms=call,
                      plain_ms=pt["ms"], plain_call_ms=pt["call_ms"],
                      library_ms=library and library["ms"],
                      library_backend=library and library["backend"],
                      library_call_ms=library and library["call_ms"],
                      dvec_ms=sum(split.values()) - ms_dq - ms_dkv)
        if dropout:
            common["library_fwd_bwd_ms"] = lib_both
            if main is not None:
                common["fwd_bwd_ms"] = sum(split.values()) \
                    + summary["fa_fwd" + main]["ms"]
        bq, byq = bound(bytes_dq, ops_dq, dt)
        bk, byk = bound(bytes_dkv, ops_dkv, dt)
        rq = dict(kernel="fa_bwd_dq",
                  max_abs_err=max(errs["dq"], errs.get("dbias", 0.0)),
                  dq_err=errs["dq"], ms=ms_dq,
                  bound_ms=bq, bound_by=byq, bytes=bytes_dq, flops=ops_dq,
                  tflops=ops_dq / ms_dq / 1e9, bound_share=bq / ms_dq,
                  **common)
        if dbias:
            rq.update(dbias_err=errs["dbias"], dbias_tol=DLOGITS_TOL,
                      dbias_err_over_tol=share["dbias"], **dl_stats)
        rk = dict(kernel="fa_bwd_dkv", max_abs_err=max(errs["dk"],
                                                      errs["dv"]),
                  dk_err=errs["dk"], dv_err=errs["dv"], ms=ms_dkv,
                  bound_ms=bk, bound_by=byk, bytes=bytes_dkv, flops=ops_dkv,
                  tflops=ops_dkv / ms_dkv / 1e9, bound_share=bk / ms_dkv,
                  **common)
        emit("kernel", **rq)
        emit("kernel", **rk)
        if main is not None:
            summary["fa_bwd_dq" + main] = rq
            summary["fa_bwd_dkv" + main] = rk
        del sets
        torch.cuda.empty_cache()

    def fa_keep_probe(dt):
        """The dropout mask on the card, exactly: a one-hot v (sk = 64
        keys, v[j] = e_j) makes o[i, j] = p_ij keep_ij / l_i, so o is 0
        exactly where ``dropout_keep`` drops (at these small scores no p
        underflows); the share kept over b * h * sq * sk entries within
        KEEP_SIGMAS binomial standard deviations of 1 - FA_DROP_RATE."""
        b, h, sq, sk = 4, 25, 1024, 64
        g = torch.Generator(device=dev).manual_seed(5)
        q, k = ((torch.randn(b, h, n, 64, device=dev, generator=g) * 0.3)
                .to(tdt[dt]) for n in (sq, sk))
        v = torch.eye(sk, 64, device=dev).expand(b, h, sk, 64) \
            .contiguous().to(tdt[dt])
        seed = torch.tensor([-77], dtype=torch.int32, device=dev)
        o, _ = flash_attention_fwd(q, k, v, scale=0.125, causal=False,
                                   dropout_p=FA_DROP_RATE, dropout_seed=seed)
        keep = dropout_keep(seed, torch.arange(b * h, device=dev), 0, 0, sq,
                            sk, FA_DROP_RATE, device=dev).view(b, h, sq, sk)
        same = torch.equal(o == 0, keep == 0)
        n = keep.numel()
        share = (keep > 0).sum().item() / n
        p = 1.0 - FA_DROP_RATE
        band = KEEP_SIGMAS * math.sqrt(p * (1 - p) / n)
        rec = dict(kernel="fa_fwd", check="dropout keep pattern", dtype=dt,
                   b=b, h=h, sq=sq, sk=sk, zeros_equal_mask=same,
                   keep_share=share, expected=p, band=band,
                   mismatched=int(((o == 0) != (keep == 0)).sum().item()))
        emit("kernel", **rec)
        require(same and abs(share - p) <= band,
                f"dropout keep pattern ({dt}): {rec}")

    def adam_case(n, main=False):
        nbytes = 28 * n + 36   # p, g, m, v read; p, m, v written
        sets = []
        for _ in range(2):
            p, g, m = (torch.randn(n, device=dev, generator=gen)
                       for _ in range(3))
            v = torch.rand(n, device=dev, generator=gen)
            sets.append((p, g, m, v))
        kw = dict(lr=1e-3, weight_decay=0.01, step=3)
        ref = [t.clone() for t in sets[0]]
        fused_adam_flat(*sets[0], **kw)
        fused_adam_flat_plain(*ref, **kw)
        torch.cuda.synchronize()
        err = 0.0
        for got, want in zip((sets[0][0], sets[0][2], sets[0][3]),
                             (ref[0], ref[2], ref[3])):
            ok, e = close(got, want, 0.0, ADAM_RTOL)
            err = max(err, e)
            require(ok, f"fused_adam n={n}: err {e} (rtol {ADAM_RTOL})")
        # an overflow step leaves every buffer bit-identical
        before = [t.clone() for t in sets[0]]
        fused_adam_flat(*sets[0], found_inf=torch.ones((), device=dev,
                                                       dtype=torch.bool),
                        **kw)
        torch.cuda.synchronize()
        require(all(torch.equal(a, c) for a, c in zip(sets[0], before)),
                "fused_adam: the overflow step changed a buffer")
        del ref, before
        reps = 20
        kt = timed(lambda *a: fused_adam_flat(*a, **kw), sets, reps)
        pt = timed(lambda *a: fused_adam_flat_plain(*a, **kw), sets, 3)
        lsets = [(p, g, m, v, torch.full((), 3.0, device=dev))
                 for p, g, m, v in sets]
        lt = timed(lambda p, g, m, v, st: torch._fused_adamw_(
            [p], [g], [m], [v], [], [st], lr=1e-3, beta1=0.9, beta2=0.999,
            weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False),
            lsets, reps)
        bms, by = bound(nbytes, 15 * n, "fp32")
        rec = dict(kernel="fused_adam", n=n, dtype="fp32",
                   max_abs_err=err, tol={"rtol": ADAM_RTOL}, ms=kt["ms"],
                   plain_ms=pt["ms"], library_ms=lt["ms"], bound_ms=bms,
                   bound_by=by, call_ms=kt["call_ms"],
                   plain_call_ms=pt["call_ms"],
                   library_call_ms=lt["call_ms"], bytes=nbytes)
        emit("kernel", **rec)
        if main:
            summary["fused_adam"] = rec

    def lamb_bytes(n):
        """Bytes each LAMB stage must move over ``n`` elements: stage 1
        reads p, g, m, v and writes u, m, v and two row sums; stage 2 reads
        p, u and the row ids and writes p."""
        rows = n // 128
        return 28 * n + 8 * rows, 12 * n + 4 * rows

    def lamb_case(tree, main=False):
        """Both LAMB stages over the flat layout of ``tree`` (parameter
        shapes): the kernels against the plain stages on the same buffers
        (the same operations in the same order, so held to 1e-7 relative
        and expected to agree bit for bit), two runs bit-identical, an
        overflow step that changes no bit; then each stage's device time
        and the plain version's."""
        spec = flat_spec(tree)
        n = -(-spec.total_size // FLAT_PAD) * FLAT_PAD
        ids = row_segment_ids(spec, n, device=dev)
        seg = row_segments(ids, spec.num_leaves)
        p = torch.randn(n, device=dev, generator=gen) * 0.05
        g = torch.randn(n, device=dev, generator=gen) * 1e-3
        m = torch.randn(n, device=dev, generator=gen) * 1e-4
        v = torch.rand(n, device=dev, generator=gen) * 1e-6
        kw = dict(num_tensors=spec.num_leaves, lr=1e-3, weight_decay=0.01,
                  step=torch.tensor(3, dtype=torch.int32, device=dev),
                  inv_scale=0.5, segments=seg)
        ref = [t.clone() for t in (p, m, v)]
        start = [t.clone() for t in (p, m, v)]
        gn = fused_lamb_flat(p, g, m, v, ids, **kw)
        gp = fused_lamb_flat_plain(ref[0], g, ref[1], ref[2], ids, **kw)
        torch.cuda.synchronize()
        err = 0.0
        for got, want in zip((p, m, v, gn), ref + [gp]):
            ok, e = close(got, want, 0.0, LAMB_RTOL)
            err = max(err, e)
            require(ok, f"fused_lamb n={n}: err {e} (rtol {LAMB_RTOL})")
        del ref
        again = [t.clone() for t in start]
        fused_lamb_flat(again[0], g, again[1], again[2], ids, **kw)
        torch.cuda.synchronize()
        deterministic = all(torch.equal(a, c)
                            for a, c in zip(again, (p, m, v)))
        require(deterministic, "fused_lamb: two runs gave different bits")
        del again, start
        before = [t.clone() for t in (p, m, v)]
        bad = g.clone()
        bad[n // 3] = float("inf")
        fused_lamb_flat(p, bad, m, v, ids, found_inf=torch.ones(
            (), dtype=torch.bool, device=dev), **kw)
        torch.cuda.synchronize()
        require(all(torch.equal(a, c) for a, c in zip((p, m, v), before)),
                "fused_lamb: the overflow step changed a buffer")
        del before, bad
        reps = 10
        args = [(p, g, m, v)]
        split = device_kernels(lambda *a: fused_lamb_flat(*a, ids, **kw),
                               args, reps)
        ms1 = sum(x for k, x in split.items() if "lamb_stage1_kernel" in k)
        ms2 = sum(x for k, x in split.items() if "lamb_stage2_kernel" in k)
        call = bench_ms(lambda *a: fused_lamb_flat(*a, ids, **kw), args,
                        reps)
        pt = timed(lambda *a: fused_lamb_flat_plain(*a, ids, **kw), args, 3)
        b1, b2 = lamb_bytes(n)
        bm1, by1 = bound(b1, 20 * n, "fp32")
        bm2, by2 = bound(b2, 2 * n, "fp32")
        common = dict(n=n, tensors=spec.num_leaves, dtype="fp32",
                      max_abs_err=err, tol={"rtol": LAMB_RTOL},
                      deterministic=deterministic, call_ms=call,
                      plain_ms=pt["ms"], plain_call_ms=pt["call_ms"],
                      library_ms=None, library_call_ms=None,
                      other_ms=sum(split.values()) - ms1 - ms2)
        r1 = dict(kernel="lamb_stage1", ms=ms1, bound_ms=bm1, bound_by=by1,
                  bytes=b1, **common)
        r2 = dict(kernel="lamb_stage2", ms=ms2, bound_ms=bm2, bound_by=by2,
                  bytes=b2, **common)
        emit("kernel", **r1)
        emit("kernel", **r2)
        if main:
            summary["lamb_stage1"], summary["lamb_stage2"] = r1, r2

    cfg = GPT2Config.small()
    params = init_gpt2_params(cfg, seed=0)
    # the trainer's flat buffer for GPT-2 small: 128-aligned leaves,
    # padded to a multiple of FLAT_PAD
    flat_n = -(-flat_spec(params).total_size // FLAT_PAD) * FLAT_PAD
    for dt in ("bf16", "fp32"):
        bf = dt == "bf16"
        ln_bwd_case(4 * 1024, 768, dt, main="ln_bwd" if bf else None)
        if bf:   # BERT-large's rows: 32 x 128 tokens of 1024
            ln_bwd_case(4096, 1024, dt, main="ln_bwd_bert")
        ln_bwd_case(1000, 768, dt)
        ln_bwd_case(37, 1600, dt)
        ln_bwd_case(4096, 1024, dt, rms=True,
                    main="ln_bwd_rms" if bf else None)
        ln_bwd_case(4096, 1024, dt, rms=True, affine=False)
        ln_bwd_case(4096, 1024, dt, affine=False)
        ln_bwd_case(64, 12288, dt)
        ln_bwd_case(64, 12288, dt, rms=True)
        # the summary's keys: fa_bwd_dq / fa_bwd_dkv (+ "_bert") for the
        # bf16 tensor-core kernels, fa_bwd_dq_fp32 / fa_bwd_dkv_fp32 (+
        # "_bert") for the fp32 FMA-pipe pair
        fa_bwd_case(4, 12, 1024, 1024, True, dt, main="" if bf else "_fp32")
        fa_bwd_case(4, 12, 1000, 1000, True, dt)
        fa_bwd_case(2, 3, 200, 333, False, dt)
        fa_bwd_case(32, 16, 128, 128, False, dt,
                    main="_bert" if bf else "_fp32_bert")
        fa_bwd_case(32, 16, 128, 128, False, dt, mask_kind="pad")
        fa_bwd_case(4, 16, 128, 128, False, dt, mask_kind="full")
        fa_bwd_case(1025, 64, 64, 64, True, dt)
        # the dropout and dlogits forms: GPT-2 XL's causal attention (the
        # summary's rows), BERT's with its key-padding mask, and a ragged
        # causal shape with keys past the last query
        for form in ("dropout", "dbias"):
            fa_bwd_case(4, XL_HEADS, XL_SEQ, XL_SEQ, True, dt,
                        main=("" if bf else "_fp32") + "_" + form,
                        **{form: True})
            fa_bwd_case(32, 16, 128, 128, False, dt, mask_kind="pad",
                        **{form: True})
            fa_bwd_case(2, 3, 200, 333, True, dt, **{form: True})
        fa_keep_probe(dt)
        # head dim 128 as in the forward's cases (the summary's keys
        # fa_bwd_dq / fa_bwd_dkv + "_d128" (+ "_dropout" / "_dbias"), with
        # "_fp32" before it for the FMA pair), and the padded d = 80
        t = "" if bf else "_fp32"
        fa_bwd_case(CG_BATCH, CG_HEADS, CG_CTX, CG_CTX, True, dt, d=128,
                    main=t + "_d128")
        for form in ("dropout", "dbias"):
            fa_bwd_case(CG_BATCH, CG_HEADS, CG_CTX, CG_CTX, True, dt, d=128,
                        main=t + "_d128_" + form, **{form: True})
        fa_bwd_case(32, 16, 128, 128, False, dt, mask_kind="pad", d=128)
        fa_bwd_case(32, 16, 128, 128, False, dt, mask_kind="pad", d=128,
                    dropout=True)
        fa_bwd_case(2, 3, 200, 333, True, dt, d=128, dbias=True,
                    dropout=True)
        fa_bwd_case(CG_BATCH, CG27_HEADS, CG_CTX, CG_CTX, True, dt, d=80,
                    main=t + "_d80")
        # head dim 256 and the padded d = 192 as in the forward's cases
        # (the summary's keys ... + "_d256" (+ "_dropout" / "_dbias") and
        # "_d192")
        fa_bwd_case(GJ_BATCH, GJ_HEADS, GJ_CTX, GJ_CTX, True, dt, d=256,
                    main=t + "_d256")
        for form in ("dropout", "dbias"):
            fa_bwd_case(GJ_BATCH, GJ_HEADS, GJ_CTX, GJ_CTX, True, dt, d=256,
                        main=t + "_d256_" + form, **{form: True})
        fa_bwd_case(32, 16, 128, 128, False, dt, mask_kind="pad", d=256,
                    dropout=True)
        fa_bwd_case(2, 3, 200, 333, True, dt, d=256, dbias=True,
                    dropout=True)
        fa_bwd_case(1, NEMO_HEADS, GJ_CTX, GJ_CTX, True, dt, d=NEMO_D,
                    main=t + "_d192")
    adam_case(flat_n, main=True)
    adam_case(1001)
    torch.cuda.empty_cache()
    # BERT-large's parameters (made once, on the CPU, from seed 0): their
    # flat layout is the LAMB kernels' main-path shape
    bcfg = BertConfig.large()
    bert_params = init_bert_params(bcfg, seed=0)
    lamb_case(bert_params, main=True)
    lamb_case({"w": torch.empty(3, 50), "b": torch.empty(7),
               "e": torch.empty(300), "s": torch.empty(()),
               "z": torch.empty(9), "m": torch.empty(77, 7)})
    torch.cuda.empty_cache()

    # the flat optimizer kernels of the ResNet path, at ResNet-50's flat
    # layout (its parameters, made once on the CPU from seed 0; 25.6M
    # fp32, above the 50 MB L2) and at a ragged one of a few tensors
    rparams = init_resnet_params(0)
    rtree = {k: t for k, t in rparams.items()
             if not k.endswith((".mean", ".var"))}
    ragged = {"w": torch.empty(3, 50), "b": torch.empty(7),
              "e": torch.empty(300), "s": torch.empty(()),
              "m": torch.empty(77, 7)}

    def flat_n(tree):
        return -(-flat_spec(tree).total_size // FLAT_PAD) * FLAT_PAD

    def opt_case(name, make, kernel, plain, nbytes, ops, library=None,
                 main=False, **shape):
        """One flat optimizer kernel: ``make()`` draws one input set (a
        list of tensors the step updates in place), ``kernel(*set,
        found_inf=...)`` and ``plain(*set)`` run one step. The kernel
        against the plain version on copies of one set (the same
        operations in the same order: held to OPT_TOL), a second run from
        the same start bit-identical, an overflow step that changes no
        bit; then the kernel's own device time (``ms``; ``other_ms`` is
        the rest of the call's device time: scalar packing and, for
        NovoGrad, the per-tensor moments), the call, the plain version and
        the library call."""
        start = make()
        runs = [[t.clone() for t in start] for _ in range(3)]
        kernel(*runs[0])
        plain(*runs[1])
        kernel(*runs[2])
        torch.cuda.synchronize()
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(runs[0], runs[1]))
        require(err <= OPT_TOL, f"{name} {shape}: kernel vs plain err {err}")
        deterministic = all(torch.equal(a, c)
                            for a, c in zip(runs[0], runs[2]))
        require(deterministic, f"{name} {shape}: two runs gave other bits")
        before = [t.clone() for t in runs[0]]
        kernel(*runs[0], found_inf=torch.ones((), dtype=torch.bool,
                                              device=dev))
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(runs[0], before)),
                f"{name} {shape}: the overflow step changed a buffer")
        del runs, before
        sets = [start] + [make() for _ in range(n_sets(nbytes) - 1)]
        reps = 20
        split = device_kernels(kernel, sets, reps)
        ms = sum(x for k, x in split.items() if name + "_kernel" in k)
        call = bench_ms(kernel, sets, reps)
        pt = timed(plain, sets, 3)
        lt = timed(library, sets, reps) if library else None
        bms, by = bound(nbytes, ops, "fp32")
        rec = dict(kernel=name, max_abs_err=err, tol=OPT_TOL,
                   deterministic=deterministic, ms=ms,
                   other_ms=sum(split.values()) - ms, call_ms=call,
                   plain_ms=pt["ms"], plain_call_ms=pt["call_ms"],
                   library_ms=lt and lt["ms"],
                   library_call_ms=lt and lt["call_ms"], bound_ms=bms,
                   bound_by=by, bytes=nbytes, **shape)
        emit("kernel", **rec)
        if main:
            summary[name] = rec
        del sets, start
        torch.cuda.empty_cache()

    def randn(n, scale=1.0, dtype=torch.float32):
        return (torch.randn(n, device=dev, generator=gen) * scale).to(dtype)

    def sgd_cases(n, dt, main=False, flags=((0.9, False, False),)):
        es = 2 if dt == "bf16" else 4

        def make():
            return [randn(n, 0.05, tdt[dt]), randn(n, 1e-3 * 1024, tdt[dt]),
                    randn(n, 1e-3)]

        for momentum, nesterov, wd_after in flags:
            kw = dict(lr=RESNET_LR, momentum=momentum, weight_decay=RESNET_WD,
                      nesterov=nesterov, wd_after_momentum=wd_after,
                      inv_scale=1.0 / 1024)
            # p and g read, p written; the buffer read and written only
            # with a momentum
            nbytes = 3 * es * n + (8 * n if momentum else 0)
            library = None
            if dt == "fp32" and momentum:
                def library(p, g, b, kw=kw):
                    torch._fused_sgd_(
                        [p], [g], [b], weight_decay=kw["weight_decay"],
                        momentum=kw["momentum"], lr=kw["lr"], dampening=0.0,
                        nesterov=kw["nesterov"], maximize=False,
                        is_first_step=False, grad_scale=None,
                        found_inf=None)
            opt_case("fused_sgd",
                     make, lambda p, g, b, found_inf=False, kw=kw:
                     fused_sgd_flat(p, g, b, found_inf=found_inf, **kw),
                     lambda p, g, b, kw=kw: fused_sgd_flat_plain(p, g, b,
                                                                 **kw),
                     nbytes, 8 * n, library,
                     main=main and (momentum, nesterov, wd_after)
                     == flags[0], n=n, dtype=dt, momentum=momentum,
                     nesterov=nesterov, wd_after_momentum=wd_after)

    def adam_master_case(n, main=False):
        kw = dict(lr=1e-3, weight_decay=1e-4, step=3, inv_scale=1.0 / 1024)

        def make():
            return [randn(n, 0.05), randn(n, 1e-3 * 1024), randn(n, 1e-4),
                    torch.rand(n, device=dev, generator=gen) * 1e-6,
                    torch.empty(n, dtype=torch.bfloat16, device=dev)]

        st = torch.full((), 3.0, device=dev)

        def library(pm, g, m, v, lp):
            torch._fused_adamw_([pm], [g], [m], [v], [], [st], lr=1e-3,
                                beta1=0.9, beta2=0.999, weight_decay=1e-4,
                                eps=1e-8, amsgrad=False, maximize=False)
            lp.copy_(pm)

        opt_case("fused_adam_master", make,
                 lambda pm, g, m, v, lp, found_inf=False:
                 fused_adam_flat_master(pm, g, m, v, p_lp=lp,
                                        found_inf=found_inf, **kw),
                 lambda pm, g, m, v, lp: fused_adam_flat_master_plain(
                     pm, g, m, v, p_lp=lp, **kw),
                 30 * n, 15 * n, library, main=main, n=n, dtype="fp32",
                 lp_dtype="bf16")

    def adam_bf16_case(n):
        """The bf16 form of fused Adam (a bf16 flat buffer without master
        weights): p and g bf16, m and v fp32."""
        kw = dict(lr=1e-3, weight_decay=1e-4, step=3)

        def make():
            return [randn(n, 1.0, torch.bfloat16),
                    randn(n, 1e-3, torch.bfloat16), randn(n, 1e-4),
                    torch.rand(n, device=dev, generator=gen) * 1e-6]

        opt_case("fused_adam", make,
                 lambda p, g, m, v, found_inf=False: fused_adam_flat(
                     p, g, m, v, found_inf=found_inf, **kw),
                 lambda p, g, m, v: fused_adam_flat_plain(p, g, m, v, **kw),
                 22 * n, 15 * n, n=n, dtype="bf16")

    def novograd_case(tree, main=False):
        spec = flat_spec(tree)
        n = flat_n(tree)
        ids = row_segment_ids(spec, n, device=dev)
        seg = row_segments(ids, spec.num_leaves)
        kw = dict(num_tensors=spec.num_leaves, lr=1e-3, weight_decay=1e-3,
                  step=torch.tensor(3, dtype=torch.int32, device=dev),
                  grad_averaging=True, bias_correction=True,
                  inv_scale=1.0 / 1024, segments=seg)

        def make():
            return [randn(n, 0.05), randn(n, 1e-3 * 1024), randn(n, 1e-4),
                    torch.rand(spec.num_leaves, device=dev,
                               generator=gen) * 1e-3]

        # the kernel reads p, g, m and each row's id, writes p and m
        opt_case("fused_novograd", make,
                 lambda p, g, m, v, found_inf=False: fused_novograd_flat(
                     p, g, m, v, ids, found_inf=found_inf, **kw),
                 lambda p, g, m, v: fused_novograd_flat_plain(p, g, m, v,
                                                              ids, **kw),
                 20 * n + 4 * (n // 128) + 4 * (spec.num_leaves + 1),
                 10 * n, main=main, n=n, tensors=spec.num_leaves,
                 dtype="fp32")

    def adagrad_case(n, w_mode=False, main=False):
        kw = dict(lr=1e-2, weight_decay=1e-4, adagrad_w_mode=w_mode,
                  inv_scale=1.0 / 1024)

        def make():
            return [randn(n, 0.05), randn(n, 1e-3 * 1024),
                    torch.rand(n, device=dev, generator=gen) * 1e-4]

        library = None
        if not w_mode:
            st = torch.full((), 3.0, device=dev)

            def library(p, g, h):
                torch._fused_adagrad_([p], [g], [h], [st], lr=1e-2,
                                      lr_decay=0.0, weight_decay=1e-4,
                                      eps=1e-10, maximize=False)

        opt_case("fused_adagrad", make,
                 lambda p, g, h, found_inf=False: fused_adagrad_flat(
                     p, g, h, found_inf=found_inf, **kw),
                 lambda p, g, h: fused_adagrad_flat_plain(p, g, h, **kw),
                 20 * n, 9 * n, library, main=main, n=n, dtype="fp32",
                 adagrad_w_mode=w_mode)

    rn = flat_n(rtree)
    sgd_cases(rn, "fp32", main=True, flags=(
        (0.9, False, False), (0.9, True, False), (0.9, False, True),
        (0.9, True, True), (0.0, False, False)))
    sgd_cases(rn, "bf16", flags=((0.9, False, False), (0.9, True, False),
                                 (0.9, False, True), (0.9, True, True)))
    sgd_cases(1001, "fp32")
    adam_master_case(rn, main=True)
    adam_master_case(1001)
    adam_bf16_case(rn)
    adam_bf16_case(1001)
    novograd_case(rtree, main=True)
    novograd_case(ragged)
    adagrad_case(rn, main=True)
    adagrad_case(rn, w_mode=True)
    adagrad_case(1001)
    torch.cuda.empty_cache()

    # the GroupNorm kernels (NHWC, 32 groups), each against its plain
    # version on the same card inputs, two runs bit-identical; the library
    # yardstick is F.group_norm on the NCHW view of the same memory (plus
    # F.silu), whose memory format is reported
    def gn_inputs(n, h, w, c, dt, affine, ill=False):
        x = (torch.randn(n, h, w, c, device=dev, generator=gen) * 2
             + 0.5)
        if ill:   # one group: mean 1000, std 0.01
            cpg = c // GN_GROUPS
            x[0, :, :, :cpg] = 1000 + 0.01 * torch.randn(
                h, w, cpg, device=dev, generator=gen)
        wt = 1 + 0.1 * torch.randn(c, device=dev, generator=gen)
        bt = 0.1 * torch.randn(c, device=dev, generator=gen)
        return (x.to(tdt[dt]), wt if affine and "w" in affine else None,
                bt if affine and "b" in affine else None)

    def gn_y_err(name, got, want, dt):
        """max |y - y_plain|, required within GN_TOL."""
        atol, rtol = GN_TOL[dt]
        ok, err = close(got, want, atol, rtol)
        require(ok, f"{name}: y err {err} (atol {atol} rtol {rtol})")
        return err

    def gn_stats_err(name, mean, rstd, mean_p, rstd_p):
        """max of |mean_d - mean_d_plain| (the mean less the group's
        first element, as the kernels return it) and rstd's relative
        error, each required within its tolerance (the mean's plus one
        fp32 ulp of its value)."""
        dm = (mean - mean_p).abs()
        em = dm.max().item()
        er = ((rstd - rstd_p).abs() / rstd_p.abs()).max().item()
        ok_m = bool((dm <= GN_MEAN_ATOL + 2 ** -23 * mean_p.abs()).all())
        require(ok_m and er <= GN_RSTD_RTOL,
                f"{name}: mean err {em} (atol {GN_MEAN_ATOL}), rstd rel "
                f"err {er} (rtol {GN_RSTD_RTOL})")
        return max(em, er)

    def gn_library(sets, act):
        """F.group_norm (+ F.silu) on the NCHW views of each set, timed;
        and the memory format of its output."""
        def call(x, wt, bt):
            y = F.group_norm(
                x.permute(0, 3, 1, 2), GN_GROUPS,
                None if wt is None else wt.to(x.dtype),
                None if bt is None else bt.to(x.dtype), 1e-5)
            return F.silu(y) if act == "silu" else y

        out = call(*sets[0])
        fmt = ("channels_last" if out.is_contiguous(
            memory_format=torch.channels_last) else "contiguous")
        return timed(call, sets, 20), fmt

    def gn_case(n, h, w, c, dt, act="silu", affine="wb", algo="auto",
                hw_block=None, main=False, ill=False):
        """One GroupNorm shape through the route ``algo`` picks: the
        one-pass kernel, or the stats and apply kernels, each on the same
        inputs as its plain version (the stats kernel's partial sums give
        the mean / rstd compared; the apply kernel runs on the plain
        statistics). With ``ill`` one group has mean 1000 and std 0.01 and
        the kernels' y is also held against float64."""
        hw, es = h * w, torch.tensor([], dtype=tdt[dt]).element_size()
        one = algo == "one_pass" or (
            algo == "auto" and gn_one_pass_ok(hw, c, GN_GROUPS))
        elems = n * hw * c
        params = 4 * c * len(affine or "")
        stats = n * GN_GROUPS * 4
        sets = [gn_inputs(n, h, w, c, dt, affine, ill)
                for _ in range(n_sets(2 * elems * es))]
        x, wt, bt = sets[0]
        x3 = x.reshape(n, hw, c)
        shape = dict(n=n, h=h, w=w, c=c, groups=GN_GROUPS, dtype=dt,
                     act=act, affine=affine, algo=algo, hw_block=hw_block,
                     ill_conditioned=ill)
        lib_t, lib_fmt = gn_library(sets, act)
        tag = f"{shape}"
        # per kernel: (max error, deterministic, bytes, ops, kernel call,
        # plain call)
        done = {}
        if one:
            kw = dict(eps=1e-5, act=act)
            got = gn_one_pass(x3, GN_GROUPS, wt, bt, **kw)
            want = gn_one_pass_plain(x3, GN_GROUPS, wt, bt, **kw)
            again = gn_one_pass(x3, GN_GROUPS, wt, bt, **kw)
            torch.cuda.synchronize()
            err = max(gn_y_err("gn_one_pass " + tag, got[0], want[0], dt),
                      gn_stats_err("gn_one_pass " + tag, *got[1:],
                                   *want[1:]))
            y_ill = got[0]
            done["gn_one_pass"] = (
                err, all(torch.equal(a, b) for a, b in zip(got, again)),
                2 * elems * es + params + 2 * stats, 10 * elems,
                lambda x, wt, bt: gn_one_pass(x.reshape(n, hw, c),
                                              GN_GROUPS, wt, bt, **kw),
                lambda x, wt, bt: gn_one_pass_plain(x.reshape(n, hw, c),
                                                    GN_GROUPS, wt, bt, **kw))
        else:
            blk = gn_hw_block(hw, c, hw_block)
            shape["tile"] = blk
            shift = gn_shift(x3, GN_GROUPS)
            cnt = hw * (c // GN_GROUPS)
            ps, pq = gn_stats(x3, shift, blk)
            again_s = gn_stats(x3, shift, blk)
            ps_p, pq_p = gn_stats_plain(x3, shift, blk)
            md, rstd = gn_moments(ps, pq, cnt, 1e-5)
            md_p, rstd_p = gn_moments(ps_p, pq_p, cnt, 1e-5)
            y = gn_apply(x3, shift, md_p, rstd_p, wt, bt, act=act,
                         hw_block=blk)
            again_a = gn_apply(x3, shift, md_p, rstd_p, wt, bt, act=act,
                               hw_block=blk)
            y_p = gn_apply_plain(x3, shift, md_p, rstd_p, wt, bt, act=act)
            y_ill = gn_apply(x3, shift, md, rstd, wt, bt, act=act,
                             hw_block=blk) if ill else None
            torch.cuda.synchronize()
            done["gn_stats"] = (
                gn_stats_err("gn_stats " + tag, md, rstd, md_p, rstd_p),
                torch.equal(ps, again_s[0]) and torch.equal(pq, again_s[1]),
                elems * es + stats + 2 * n * (hw // blk) * GN_GROUPS * 4,
                4 * elems,
                lambda x, wt, bt: gn_stats(x.reshape(n, hw, c), shift, blk),
                lambda x, wt, bt: gn_stats_plain(x.reshape(n, hw, c), shift,
                                                 blk))
            done["gn_apply"] = (
                gn_y_err("gn_apply " + tag, y, y_p, dt),
                torch.equal(y, again_a), 2 * elems * es + params + 3 * stats,
                8 * elems,
                lambda x, wt, bt: gn_apply(
                    x.reshape(n, hw, c), shift, md_p, rstd_p, wt, bt,
                    act=act, hw_block=blk),
                lambda x, wt, bt: gn_apply_plain(
                    x.reshape(n, hw, c), shift, md_p, rstd_p, wt, bt,
                    act=act))
        ill_err = None
        if ill:
            # held against float64; the centred plain reference (the mean,
            # then the variance, as _gn_plain) has its own error here
            x64 = x.double().reshape(n, hw, GN_GROUPS, c // GN_GROUPS)
            m64 = x64.mean(dim=(1, 3), keepdim=True)
            v64 = ((x64 - m64) ** 2).mean(dim=(1, 3), keepdim=True)
            y64 = ((x64 - m64) / torch.sqrt(v64 + 1e-5)).reshape(x.shape)
            ill_err = (y_ill.reshape(x.shape).double() - y64).abs().max() \
                .item()
            shape["plain_reference_err_vs_float64"] = (
                _gn_plain(x, GN_GROUPS, None, None, 1e-5, "").double()
                - y64).abs().max().item()
            require(bool(torch.isfinite(y_ill).all())
                    and ill_err <= GN_ILL_ATOL,
                    f"GroupNorm ill-conditioned {tag}: err vs float64 "
                    f"{ill_err}")
        for name, (err, det, nbytes, ops, run, plain) in done.items():
            require(det, f"{name} {tag}: two runs gave other bits")
            kt = timed(run, sets, 20)
            pt = timed(plain, sets, 5)
            bms, by = bound(nbytes, ops, "fp32")
            rec = dict(kernel=name, max_abs_err=err, ill_err=ill_err,
                       tol={"y": GN_TOL[dt], "mean_atol": GN_MEAN_ATOL,
                            "rstd_rtol": GN_RSTD_RTOL},
                       deterministic=det, ms=kt["ms"], call_ms=kt["call_ms"],
                       plain_ms=pt["ms"], plain_call_ms=pt["call_ms"],
                       library_ms=lib_t["ms"],
                       library_call_ms=lib_t["call_ms"],
                       library="F.group_norm" + (" + F.silu" if act else "")
                       + ", the whole GroupNorm",
                       library_memory_format=lib_fmt, bound_ms=bms,
                       bound_by=by, bytes=nbytes, **shape)
            emit("kernel", **rec)
            if main:
                summary[name] = rec
        del sets, done
        torch.cuda.empty_cache()

    with torch.no_grad():
        # Stable Diffusion v1.5's UNet: 320 @ 64 x 64 (one-pass) and
        # up_blocks.3.resnets.0's 960 @ 64 x 64 (two-pass), batch 8
        gn_case(8, 64, 64, 320, "bf16", main=True)
        gn_case(8, 64, 64, 960, "bf16", main=True)
        # the UNet stack's smaller one-pass shapes (build_unet)
        gn_case(8, 32, 32, 640, "bf16")
        gn_case(8, 16, 16, 1280, "bf16")
        gn_case(8, 8, 8, 1280, "bf16")
        # the JAX package's AOT shape, both algorithms explicitly
        for dt in ("fp32", "bf16"):
            for algo in ("one_pass", "two_pass"):
                gn_case(8, 32, 32, 256, dt, algo=algo)
        # the SD VAE decoder's last GroupNorm (two-pass)
        gn_case(1, 512, 512, 128, "bf16")
        # a slab over the gate, forced one-pass: the form that reads x
        # from device memory in each pass
        gn_case(8, 64, 64, 960, "bf16", algo="one_pass")
        # ragged forms: no affine, gamma only, no SiLU, a given tile
        gn_case(2, 16, 16, 64, "fp32", affine=None)
        gn_case(2, 16, 16, 64, "bf16", affine="w", act="")
        gn_case(2, 16, 16, 64, "fp32", act="", algo="two_pass",
                hw_block=32)
        # 600 x 600 images' 75 x 75 latents: hw = 5625, not a multiple of
        # 8 (the TPU kernels' tiling); 320 channels one-pass (225 KB
        # slab), 960 two-pass (a tile of 25 pixels)
        gn_case(2, 75, 75, 320, "bf16")
        gn_case(2, 75, 75, 960, "bf16")
        # the two-pass pair in fp32: the UNet's 960 channels (one pixel row
        # of 240 vector columns a block) and 75 x 75 latents
        gn_case(8, 64, 64, 960, "fp32")
        gn_case(2, 75, 75, 960, "fp32")
        for algo in ("one_pass", "two_pass"):
            gn_case(2, 32, 32, 256, "fp32", affine=None, act="", algo=algo,
                    ill=True)

    def key_padding(lens, sk):
        """(b, 1, 1, sk) bool key-padding mask, True past each length."""
        lens = torch.tensor(lens, device=dev)
        return (torch.arange(sk, device=dev)[None, :] >= lens[:, None]
                )[:, None, None, :]

    def sm_case(shape, dt, op, mask=None, causal=False, main=None,
                rows_per_check=None):
        """One megatron softmax kernel (``op`` "fwd" or "bwd") against its
        plain version at ``shape``: max error against SM_TOL, two runs
        bit-identical, fully masked rows exactly 0, device ms beside the
        bound (bytes: x read once, the lower triangle only for causal, the
        mask once, y written once; the backward y and dy read, dx
        written), the plain version's ms and the library's
        (``torch.softmax`` on the pre-scaled, pre-masked input; for the
        backward ``torch._softmax_backward_data``, the scale pass
        excluded). With ``rows_per_check`` (inputs past 2^31 elements) one
        input set, the plain version run on slices of that many rows, and
        neither it nor the library timed."""
        scale = 1.0 / math.sqrt(64)
        es = torch.tensor([], dtype=tdt[dt]).element_size()
        sq, sk = shape[-2], shape[-1]
        n = math.prod(shape)
        rows = n // sk
        if op == "fwd":
            read = (rows // sq) * sum(min(q + 1, sk) for q in range(sq)) \
                if causal else n
            nbytes = read * es + n * es + (
                0 if mask is None else mask.numel() * mask.element_size())
            ops = 8 * n
        else:
            nbytes, ops = 3 * n * es, 5 * n
        big = rows_per_check is not None
        sets = []
        for _ in range(1 if big else n_sets(nbytes)):
            x = torch.randn(shape, device=dev, generator=gen,
                            dtype=tdt[dt]) * 3
            if op == "fwd":
                sets.append((x,))
            else:
                y = softmax_fwd(x, mask, scale=scale, causal=causal)
                del x
                sets.append((y, torch.randn(shape, device=dev, generator=gen,
                                            dtype=tdt[dt])))
        if op == "fwd":
            def run(x):
                return softmax_fwd(x, mask, scale=scale, causal=causal)

            def plain(x):
                return softmax_fwd_plain(x, mask, scale=scale, causal=causal)

            def premasked(x):
                x32 = x.float() * scale
                if mask is not None:
                    x32 = x32.masked_fill(mask != 0, MASK_FILL)
                if causal:
                    x32 = x32.masked_fill(torch.ones(
                        sq, sk, dtype=torch.bool, device=dev).triu(1),
                        MASK_FILL)
                return (x32.to(x.dtype),)

            def library(x):
                return torch.softmax(x, dim=-1)

            lib_name = "torch.softmax (pre-scaled, pre-masked input)"
        else:
            def run(y, dy):
                return softmax_bwd(y, dy, scale=scale)

            def plain(y, dy):
                return softmax_bwd_plain(y, dy, scale=scale)

            def premasked(y, dy):
                return (y, dy)

            def library(y, dy):
                return torch._softmax_backward_data(dy, y, -1, y.dtype)

            lib_name = "torch._softmax_backward_data (no scale pass)"
        got = run(*sets[0])
        again = run(*sets[0])
        torch.cuda.synchronize()
        det = torch.equal(got, again)
        del again
        atol, rtol = SM_TOL[dt]
        if op == "bwd":
            atol = max(atol, SM_BWD_ATOL)
        if big:   # row slices: every row of the plain version, in pieces
            ok, err = True, 0.0
            flat = [t.reshape(-1, sk) for t in sets[0]]
            g2 = got.reshape(-1, sk)
            for r0 in range(0, rows, rows_per_check):
                want = plain(*(t[r0:r0 + rows_per_check] for t in flat))
                o, e = close(g2[r0:r0 + rows_per_check], want, atol, rtol)
                ok, err = ok and o, max(err, e)
                del want
        else:
            ok, err = close(got, plain(*sets[0]), atol, rtol)
        dead_ok = True
        if mask is not None and op == "fwd":
            dead = (mask != 0).expand(shape).all(dim=-1)
            dead_ok = not bool(got[dead].any())
        tag = (f"softmax {op} {tuple(shape)} {dt} causal={causal} mask="
               f"{None if mask is None else tuple(mask.shape)}")
        require(ok and det and dead_ok,
                f"{tag}: max err {err} (atol {atol} rtol {rtol}), "
                f"deterministic {det}, fully masked rows zero {dead_ok}")
        del got
        name = ("softmax_bwd" if op == "bwd" else
                "softmax_fwd_causal" if causal else "softmax_fwd")
        kt = timed(run, sets, 3 if big else 20)
        pt = lt = {"ms": None, "call_ms": None}
        if not big:
            pt = timed(plain, sets, 3)
            lsets = [premasked(*a) for a in sets]
            lt = timed(library, lsets, 20)
            del lsets
        bms, by = bound(nbytes, ops, "fp32")
        rec = dict(kernel=name, form=softmax_form(sk), scores=list(shape),
                   dtype=dt, causal=causal,
                   mask_shape=None if mask is None else list(mask.shape),
                   mask_dtype=None if mask is None else str(mask.dtype),
                   mask_route=None if mask is None or op == "bwd" else
                   mask_route(mask_plan(mask, shape), mask.data_ptr(), es,
                              sk),
                   max_abs_err=err, tol={"atol": atol, "rtol": rtol},
                   deterministic=det, ms=kt["ms"], call_ms=kt["call_ms"],
                   plain_ms=pt["ms"], plain_call_ms=pt["call_ms"],
                   library_ms=lt["ms"], library_call_ms=lt["call_ms"],
                   library=lib_name, bound_ms=bms, bound_by=by,
                   bytes=nbytes, elements=n)
        emit("kernel", **rec)
        if main:
            summary[name] = rec
        del sets
        torch.cuda.empty_cache()

    with torch.no_grad():
        xl = (MEGATRON_BATCH, XL_HEADS, XL_SEQ, XL_SEQ)
        # GPT-2 XL's causal scores as mha_reference feeds them (fp32), and
        # in bf16 and fp16; their backward
        for dt in ("fp32", "bf16", "fp16"):
            sm_case(xl, dt, "fwd", causal=True,
                    main="softmax_fwd_causal" if dt == "fp32" else None)
            sm_case(xl, dt, "bwd", causal=True,
                    main="softmax_bwd" if dt == "fp32" else None)
        # the megatron phase's cross-attention scores with its key-padding
        # mask (lengths 512 / 400 / 256 / 17)
        sm_case((MEGATRON_BATCH, XL_HEADS, XL_SEQ, 512), "fp32", "fwd",
                mask=key_padding([512, 400, 256, 17], 512),
                main="softmax_fwd")
        # the JAX package's AOT shape (128, 1024, 1024) fp32: causal, a full
        # bool mask, the backward
        aot = (128, 1024, 1024)
        sm_case(aot, "fp32", "fwd", causal=True)
        sm_case(aot, "fp32", "fwd", mask=torch.rand(
            aot, device=dev, generator=gen) < 0.3)
        sm_case(aot, "fp32", "bwd")
        # a (b, 1, sq, sk) uint8 mask against (b, h, sq, sk) scores, a
        # (1, h, sq, sk) mask (JAX's route refuses it), a padding mask
        # that masks whole rows (a batch entry of length 0)
        sm_case(xl, "fp32", "fwd", mask=(torch.rand(
            MEGATRON_BATCH, 1, XL_SEQ, XL_SEQ, device=dev, generator=gen)
            < 0.3).to(torch.uint8))
        sm_case(xl, "bf16", "fwd", mask=torch.rand(
            1, XL_HEADS, XL_SEQ, XL_SEQ, device=dev, generator=gen) < 0.3)
        sm_case((MEGATRON_BATCH, XL_HEADS, XL_SEQ, 512), "fp32", "fwd",
                mask=key_padding([512, 400, 0, 17], 512))
        # rows past the register-resident forms: the streaming form
        sm_case((1, 1, 1024, 16385), "fp32", "fwd")
        sm_case((1, 1, 1024, 16385), "fp32", "bwd")
        sm_case((1, 1, 1024, 32768), "bf16", "fwd", causal=True)
        sm_case((1, 1, 1024, 32768), "bf16", "bwd")
        sm_case((1, 1, 256, 100003), "fp32", "fwd",
                mask=torch.rand(1, 1, 1, 100003, device=dev,
                                generator=gen) < 0.3)
        sm_case((1, 1, 256, 100003), "fp32", "bwd")
        # past 2^31 elements (64-bit offsets): 4 x 25 x 1024 x 32768 bf16
        big = (MEGATRON_BATCH, XL_HEADS, XL_SEQ, 32768)
        sm_case(big, "bf16", "fwd", rows_per_check=4096)
        sm_case(big, "bf16", "bwd", rows_per_check=4096)

    # ------------------------------------------------------ 3. forward
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    n_layer = cfg.n_layer
    ln_per_fwd = 2 * n_layer + 1
    model = GPT2.from_params(cfg, params, device=dev)
    model32 = GPT2.from_params(cfg32, params, device=dev)
    cpu_gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 1024), generator=cpu_gen)
    tok_d = tokens.to(dev)
    main_launches = {}
    # the flash wrappers' launches by route on each path of the main run,
    # and of their dropout and dlogits forms (``_build.form_launches``)
    path_routes = {}
    main_forms = collections.Counter()
    form_phases = {}     # the same by phase (megatron, cerebras, gptj)
    with torch.inference_mode():
        model(tok_d[:, :16])       # first touch of cuBLAS etc.
        torch.cuda.synchronize()
        _build.reset_launches()
        logits = model(tok_d)
        torch.cuda.synchronize()
        fwd_launches = dict(_build.launches)
        path_routes["forward"] = dict(_build.route_launches)
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
        fkern = device_profile(lambda: model(tok_d))
        require_flash_route(fkern, "bf16", "GPT-2 forward",
                            ("fa_fwd_kernel",))
        fwd_busy = by_kind(fkern)
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
    path_routes["serve"] = dict(_build.route_launches)
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

    # -------------------------------------------------------- 6. train
    tmodel = GPT2.from_params(cfg, params, device=dev)
    trainer = Trainer(
        TrainConfig(steps=TRAIN_STEPS, batch=4, seq=1024, lr=TRAIN_LR,
                    amp="dynamic"),
        loss_fn=lm_loss, init_params=tmodel, batch_fn=lambda t: tok_d)
    losses, step_s = [], []
    clock = [time.perf_counter()]

    def on_step(t, loss):
        now = time.perf_counter()
        step_s.append(now - clock[0])
        clock[0] = now
        losses.append(loss)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    clock[0] = time.perf_counter()
    report = trainer.run(on_step=on_step)
    torch.cuda.synchronize()
    train_launches = dict(_build.launches)
    path_routes["train"] = dict(_build.route_launches)
    peak_bytes = torch.cuda.max_memory_allocated()
    per_step = {"ln_fwd": ln_per_fwd, "ln_bwd": ln_per_fwd,
                "fa_fwd": n_layer, "fa_bwd_dq": n_layer,
                "fa_bwd_dkv": n_layer, "fused_adam": 1}
    expect = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    require(train_launches == expect,
            f"train launches {train_launches}, expected {expect}")
    require(all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0] and report["skipped_steps"] == 0,
            f"train losses {losses}, report {report}")
    for name, n in train_launches.items():
        main_launches[name] = main_launches.get(name, 0) + n
    # steady step: the steps after the first (which pays first touches)
    steady_ms = sorted(step_s[1:])[len(step_s[1:]) // 2] * 1e3
    tokens_per_step = 4 * (1024 - 1)
    # one more step under the profiler: device time by kind of kernel,
    # set against the unprofiled steady step's wall time
    trainer.config.steps = TRAIN_STEPS + 1
    tkern = device_profile(lambda: trainer.run())
    require_flash_route(tkern, "bf16", "train step")
    train_busy = by_kind(tkern)
    # the step's gradient packing on its own: one zero fill and one copy
    # per parameter into the flat fp32 buffer (tensors of the gradients'
    # shapes stand in for them)
    named = dict(tmodel.named_parameters())
    pack = timed(lambda: flatten(named, trainer._spec, dtype=torch.float32,
                                 pad_to=trainer.flat_p.numel()), [()], 10)

    # fp32 cross-check: one step's gradients at 2 x 256 on the card and
    # on the CPU (plain versions), parameter by parameter
    small = tokens[:2, :256]
    grads = {}
    for where in ("cpu", dev):
        m32 = GPT2.from_params(cfg32, params, device=where)
        lm_loss(m32, small.to(where)).backward()
        grads[str(where)] = {n: p.grad.detach().cpu()
                             for n, p in m32.named_parameters()}
        del m32
    worst, worst_name = 0.0, None
    for name, ref_g in grads["cpu"].items():
        card_g = grads[str(dev)][name]
        rel = ((card_g - ref_g).norm() / ref_g.norm().clamp_min(1e-30)) \
            .item()
        if rel > worst:
            worst, worst_name = rel, name
    require(worst <= TRAIN_GRAD_REL_L2,
            f"fp32 card vs CPU gradients: {worst_name} relative L2 "
            f"{worst}")
    del grads

    # the trained model serves: its engine's prefill logits follow the
    # trained weights (full forward of the trained model), not the
    # initial ones (the forward phase's model)
    prompt = tokens[0, :32].tolist()
    eng_t = Engine(cfg, tmodel, EngineConfig(
        num_slots=1, max_len=64, temperature=0.0,
        keep_prefill_logits=True), device=dev)
    first, _, kept_t = eng_t.prefill({0: prompt})
    nxt, _ = eng_t.decode_step(eng_t.last_tokens, np.ones(1, bool))
    with torch.inference_mode():
        trained = tmodel(tok_d[:1, :32])[0]
        initial = model(tok_d[:1, :32])[0]

    def rel_l2(a, b):
        return ((a - b).norm() / b.norm()).item()

    served = kept_t[:, 0]
    serve_vs_trained = rel_l2(served, trained)
    serve_vs_initial = rel_l2(served, initial)
    require(serve_vs_trained <= FWD_BF16_REL_L2
            and serve_vs_initial > 2 * serve_vs_trained
            and 0 <= int(nxt[0]) < cfg.vocab_size,
            f"serving the trained model: relative L2 {serve_vs_trained} "
            f"to the trained forward, {serve_vs_initial} to the initial")
    del eng_t, kept_t, trained, initial
    emit("train", config="GPT2Config.small", params="fp32",
         compute="bf16", batch=4, seq=1024, steps=TRAIN_STEPS,
         lr=TRAIN_LR, amp="dynamic", losses=losses,
         launches=train_launches, launches_per_step=per_step,
         step_ms=[x * 1e3 for x in step_s], steady_step_ms=steady_ms,
         tokens_per_step=tokens_per_step,
         tokens_per_s=tokens_per_step / steady_ms * 1e3,
         step_device_busy_ms=train_busy,
         idle_share=1 - train_busy["total"] / steady_ms,
         grad_flatten_ms=pack["ms"], grad_flatten_call_ms=pack["call_ms"],
         max_memory_allocated=peak_bytes,
         loss_scale=trainer.sstate.scale.item(),
         fp32_grad_worst_rel_l2=worst, fp32_grad_worst_param=worst_name,
         fp32_grad_rel_l2_tol=TRAIN_GRAD_REL_L2,
         serve_vs_trained_rel_l2=serve_vs_trained,
         serve_vs_initial_rel_l2=serve_vs_initial,
         served_tokens=[int(first[0]), int(nxt[0])], card=card)

    # --------------------------------------------------------- 7. bert
    del tmodel, trainer, model, model32
    torch.cuda.empty_cache()
    bmodel = Bert.from_params(bcfg, bert_params, device=dev)
    named = dict(bmodel.named_parameters())
    opt = FusedLAMB(named, lr=BERT_LR, weight_decay=BERT_WD)
    with torch.no_grad():
        for name, view in opt.parameters.items():
            named[name].data = view       # the model trains in place
    bgen = torch.Generator().manual_seed(3)
    bids = torch.randint(999, bcfg.vocab_size, (BERT_BATCH, BERT_SEQ),
                         generator=bgen)
    picked = torch.rand(BERT_BATCH, BERT_SEQ, generator=bgen) < 0.15
    blabels = torch.where(picked, bids, -1).to(dev)
    binputs = torch.where(picked, 103, bids).to(dev)
    kept = {}

    def bert_step():
        for t in named.values():
            t.grad = None
        loss = mlm_loss(bmodel, binputs, blabels)
        loss.backward()
        grads = {n: t.grad if t.grad is not None else torch.zeros_like(t)
                 for n, t in named.items()}
        opt.step(grads)
        for t in named.values():      # written through raw pointers
            torch.autograd.graph.increment_version(t)
        kept["grads"] = grads
        return loss.detach()

    blosses, bstep_s = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    for _ in range(BERT_STEPS):
        t0 = time.perf_counter()
        blosses.append(float(bert_step()))   # the step's host sync
        torch.cuda.synchronize()
        bstep_s.append(time.perf_counter() - t0)
    bert_launches = dict(_build.launches)
    path_routes["bert"] = dict(_build.route_launches)
    bpeak = torch.cuda.max_memory_allocated()
    n_norm = 2 * bcfg.num_hidden_layers + 1
    bper_step = {"ln_fwd": n_norm, "ln_bwd": n_norm,
                 "fa_fwd": bcfg.num_hidden_layers,
                 "fa_bwd_dq": bcfg.num_hidden_layers,
                 "fa_bwd_dkv": bcfg.num_hidden_layers,
                 "lamb_stage1": 1, "lamb_stage2": 1}
    bexpect = {k: x * BERT_STEPS for k, x in bper_step.items()}
    require(bert_launches == bexpect,
            f"bert launches {bert_launches}, expected {bexpect}")
    require(all(math.isfinite(x) for x in blosses)
            and blosses[-1] < blosses[0], f"bert losses {blosses}")
    for name, n in bert_launches.items():
        main_launches[name] = main_launches.get(name, 0) + n
    bsteady = sorted(bstep_s[1:])[len(bstep_s[1:]) // 2] * 1e3
    bkern = device_profile(bert_step)
    require_flash_route(bkern, "bf16", "bert step")
    bbusy = by_kind(bkern)
    # the largest kernels of "other", to see where that time goes
    top_other = top_kernels(bkern, lambda k: kind_of(k) == "other")
    lamb_dev = {k: sum(x / 1e3 for n, x in bkern.items()
                       if k + "_kernel" in n)
                for k in ("lamb_stage1", "lamb_stage2")}
    bpack = timed(lambda: flatten(kept["grads"], opt._spec,
                                  dtype=torch.float32,
                                  pad_to=opt._flat_p.numel()), [()], 10)
    lb1, lb2 = lamb_bytes(opt._flat_p.numel())
    lamb_bound = {"lamb_stage1": bound(lb1, 20 * opt._flat_p.numel(),
                                       "fp32")[0],
                  "lamb_stage2": bound(lb2, 2 * opt._flat_p.numel(),
                                       "fp32")[0]}
    nparams = sum(t.numel() for t in named.values())
    del opt, bmodel, named, kept
    torch.cuda.empty_cache()

    # fp32 cross-check: one MLM step's gradients of a 4-layer fp32 BERT at
    # full width, 2 x 128 tokens, on the card and on the CPU (plain
    # versions), parameter by parameter
    cfg4 = dataclasses.replace(bcfg, num_hidden_layers=4,
                               compute_dtype=torch.float32)
    p4 = {k: t for k, t in bert_params.items()
          if not k.startswith("layer.") or int(k.split(".")[1]) < 4}
    bgrads = {}
    for where in ("cpu", dev):
        m4 = Bert.from_params(cfg4, p4, device=where)
        mlm_loss(m4, binputs[:2].to(where), blabels[:2].to(where)).backward()
        bgrads[str(where)] = {n: t.grad.detach().cpu()
                              for n, t in m4.named_parameters()
                              if t.grad is not None}
        del m4
    bworst, bworst_name = 0.0, None
    for name, ref_g in bgrads["cpu"].items():
        rel = ((bgrads[str(dev)][name] - ref_g).norm()
               / ref_g.norm().clamp_min(1e-30)).item()
        if rel > bworst:
            bworst, bworst_name = rel, name
    require(bworst <= BERT_GRAD_REL_L2 and len(bgrads["cpu"]) > 0,
            f"fp32 BERT card vs CPU gradients: {bworst_name} relative L2 "
            f"{bworst}")
    del bgrads

    # padded batch: fp32 BERT-large, 4 sequences of different lengths
    # padded to 128 with attn_mask; the logits at the valid positions
    # equal each sequence's own forward at its own length, and a backward
    # through the mask gives finite gradients
    cfg32b = dataclasses.replace(bcfg, compute_dtype=torch.float32)
    mpad = Bert.from_params(cfg32b, bert_params, device=dev)
    pad_ids = bids[:4].to(dev)
    pad_mask = (torch.arange(BERT_SEQ)[None, :]
                < torch.tensor(PAD_LENS)[:, None]).to(torch.int32).to(dev)
    pad_err = 0.0
    with torch.no_grad():
        padded = mpad(pad_ids, attn_mask=pad_mask)
        for i, n in enumerate(PAD_LENS):
            alone = mpad(pad_ids[i:i + 1, :n])[0]
            pad_err = max(pad_err,
                          (padded[i, :n] - alone).abs().max().item())
    require(pad_err <= BERT_PAD_ATOL,
            f"padded batch vs each sequence alone: max abs {pad_err}")
    _build.reset_launches()
    out = mpad(pad_ids, attn_mask=pad_mask)
    plabels = torch.where(pad_mask.bool() & blabels[:4].ge(0), blabels[:4],
                          -1)
    softmax_cross_entropy_loss(out, plabels, padding_idx=-1).sum().backward()
    torch.cuda.synchronize()
    pad_launches = dict(_build.launches)
    pad_finite = all(t.grad is not None and bool(torch.isfinite(t.grad).all())
                     for n, t in mpad.named_parameters()
                     if n != "token_type_embeddings")
    require(pad_finite and pad_launches.get("fa_bwd_dq", 0)
            == bcfg.num_hidden_layers,
            f"backward through the mask: finite {pad_finite}, launches "
            f"{pad_launches}")
    del mpad, padded, out
    torch.cuda.empty_cache()
    emit("bert", config="BertConfig.large", params="fp32", compute="bf16",
         parameters=nparams, batch=BERT_BATCH, seq=BERT_SEQ,
         steps=BERT_STEPS, optimizer="FusedLAMB(flat)", lr=BERT_LR,
         weight_decay=BERT_WD, losses=blosses, launches=bert_launches,
         launches_per_step=bper_step, step_ms=[x * 1e3 for x in bstep_s],
         steady_step_ms=bsteady,
         seqs_per_s=BERT_BATCH / bsteady * 1e3,
         tokens_per_s=BERT_BATCH * BERT_SEQ / bsteady * 1e3,
         step_device_busy_ms=bbusy, top_other_ms=top_other,
         idle_share=1 - bbusy["total"] / bsteady,
         max_memory_allocated=bpeak, grad_flatten_ms=bpack["ms"],
         grad_flatten_call_ms=bpack["call_ms"],
         lamb_device_ms=lamb_dev, lamb_bound_ms=lamb_bound,
         fp32_grad_worst_rel_l2=bworst, fp32_grad_worst_param=bworst_name,
         fp32_grad_rel_l2_tol=BERT_GRAD_REL_L2, fp32_check_layers=4,
         padded_lens=PAD_LENS, padded_max_abs=pad_err,
         padded_atol=BERT_PAD_ATOL, padded_backward_finite=pad_finite,
         padded_launches=pad_launches, card=card)

    # ------------------------------------------------------- 8. resnet
    rgen = torch.Generator().manual_seed(0)
    rimages = torch.randn(RESNET_BATCH, 224, 224, 3, generator=rgen).to(dev)
    rlabels = torch.randint(0, 1000, (RESNET_BATCH,), generator=rgen).to(dev)
    resnet_launches = {}

    def resnet_run(kernel, make_opt, steps, bf16_params=False):
        """A fresh ResNet-50 (seed-0 parameters, bf16 compute; bf16
        parameters for the O2 recipe) trained ``steps`` steps by the
        optimizer ``make_opt`` builds: exactly one ``kernel`` launch per
        step, every loss finite; then a forced overflow step changes no
        bit of the flat buffers, the state or the step counter."""
        model = ResNet50(device=dev)
        model.load_state_dict(rparams)
        if bf16_params:
            for p in model.parameters():
                p.data = p.data.bfloat16()
        opt, named, step = scaled_trainer(model, make_opt, dev)
        losses, step_s = [], []
        torch.cuda.synchronize()
        _build.reset_launches()
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(float(step(rimages, rlabels)))  # the host sync
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        launches = dict(_build.launches)
        require(launches == {kernel: steps},
                f"resnet {kernel}: launches {launches}, expected {steps}")
        require(all(math.isfinite(x) for x in losses),
                f"resnet {kernel}: losses {losses}")
        for name, n in launches.items():
            resnet_launches[name] = resnet_launches.get(name, 0) + n
        return model, opt, named, step, losses, step_s

    def overflow_noop(opt, step):
        before = optimizer_snapshot(opt)
        step(rimages, rlabels, poison=True)
        torch.cuda.synchronize()
        return all(torch.equal(a, b)
                   for a, b in zip(before, optimizer_snapshot(opt)))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, opt, named, step, rlosses, rstep_s = resnet_run(
        "fused_sgd", lambda named: FusedSGD(
            named, lr=RESNET_LR, momentum=RESNET_MOMENTUM,
            weight_decay=RESNET_WD, use_flat=True), RESNET_SGD_STEPS)
    rpeak = torch.cuda.max_memory_allocated()
    require(rlosses[-1] < rlosses[0], f"resnet SGD losses {rlosses}")
    rsteady = sorted(rstep_s[1:])[len(rstep_s[1:]) // 2] * 1e3
    rkern = device_profile(lambda: step(rimages, rlabels))
    rbusy = by_kind(rkern)
    rtop = top_kernels(rkern, lambda k: True)
    sgd_n = opt._flat_p.numel()
    sgd_dev_ms = sum(x / 1e3 for k, x in rkern.items()
                     if "fused_sgd_kernel" in k)
    sgd_bound = bound(20 * sgd_n, 8 * sgd_n, "fp32")[0]
    rpack = timed(lambda: flatten(step.state["grads"], opt._spec,
                                  dtype=torch.float32, pad_to=sgd_n),
                  [()], 10)
    rparams_n = sum(t.numel() for t in named.values())
    sgd_noop = overflow_noop(opt, step)
    require(sgd_noop, "resnet SGD: the overflow step changed a bit")
    del model, opt, named, step
    torch.cuda.empty_cache()

    others = {}
    for kernel, make_opt, bf16_params in (
            ("fused_adam_master", lambda named: FusedAdam(
                named, lr=1e-3, weight_decay=RESNET_WD, master_weights=True,
                use_flat=True), True),
            ("fused_novograd", lambda named: FusedNovoGrad(named), False),
            ("fused_adagrad", lambda named: FusedAdagrad(named, lr=1e-2),
             False)):
        model, opt, named, step, losses, step_s = resnet_run(
            kernel, make_opt, RESNET_OTHER_STEPS, bf16_params)
        views = None
        if bf16_params:
            # the O2 recipe: the bf16 parameters are views of the bf16
            # copy the kernel writes
            views = all(t.dtype == torch.bfloat16
                        and t.untyped_storage().data_ptr()
                        == opt._flat_lp.untyped_storage().data_ptr()
                        for t in named.values())
            require(views, "resnet Adam: the bf16 parameters are not views "
                           "of the kernel's bf16 output")
        noop = overflow_noop(opt, step)
        require(noop, f"resnet {kernel}: the overflow step changed a bit")
        others[kernel] = dict(losses=losses,
                              step_ms=[x * 1e3 for x in step_s],
                              overflow_noop=noop, bf16_param_views=views)
        del model, opt, named, step
        torch.cuda.empty_cache()

    # card vs CPU: one step's gradients and new running statistics of a
    # ResNet-50 at 2 x 64 x 64, per tensor, beside the spread of two CPU
    # runs that differ only in their thread count. Gated in float64: in
    # fp32 this network at initialisation amplifies summation order so
    # far that the two CPU runs alone disagree by more than 1e-3, so an
    # fp32 gate could not tell a fault from rounding; fp32 is reported.
    cgen = torch.Generator().manual_seed(1)
    cimages = torch.randn(2, 64, 64, 3, generator=cgen)
    clabels = torch.randint(0, 1000, (2,), generator=cgen)

    def worst_rel(got, want):
        """(largest relative L2 over the tensors, its name)"""
        return max((((got[n] - ref).norm() / ref.norm().clamp_min(1e-30))
                    .item(), n) for n, ref in want.items())

    def card_vs_cpu(dtype):
        cpu = resnet_grads(rparams, cimages, clabels, "cpu", dtype)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            cpu1 = resnet_grads(rparams, cimages, clabels, "cpu", dtype)
        finally:
            torch.set_num_threads(threads)
        card = resnet_grads(rparams, cimages, clabels, dev, dtype)
        both = [{**g, **st} for g, st in (cpu, cpu1, card)]
        return worst_rel(both[2], both[0]), worst_rel(both[1], both[0])

    (rworst, rworst_name), rspread = card_vs_cpu(torch.float64)
    require(rworst <= RESNET_GRAD_REL_L2,
            f"float64 ResNet-50 card vs CPU: {rworst_name} relative L2 "
            f"{rworst}")
    (rworst32, rworst32_name), rspread32 = card_vs_cpu(torch.float32)
    for name, n in resnet_launches.items():
        main_launches[name] = main_launches.get(name, 0) + n
    emit("resnet", config="ResNet50", params="fp32", compute="bf16",
         layout="NHWC (channels_last)", parameters=rparams_n,
         batch=RESNET_BATCH, image=[224, 224, 3],
         optimizer="FusedSGD(flat)", lr=RESNET_LR, momentum=RESNET_MOMENTUM,
         weight_decay=RESNET_WD, steps=RESNET_SGD_STEPS, losses=rlosses,
         launches=resnet_launches, step_ms=[x * 1e3 for x in rstep_s],
         steady_step_ms=rsteady, images_per_s=RESNET_BATCH / rsteady * 1e3,
         step_device_busy_ms=rbusy, top_kernels_ms=rtop,
         idle_share=1 - rbusy["total"] / rsteady,
         max_memory_allocated=rpeak, flat_n=sgd_n,
         fused_sgd_device_ms=sgd_dev_ms, fused_sgd_bound_ms=sgd_bound,
         grad_flatten_ms=rpack["ms"], grad_flatten_call_ms=rpack["call_ms"],
         sgd_overflow_noop=sgd_noop, others=others,
         fp64_grad_worst_rel_l2=rworst, fp64_grad_worst_param=rworst_name,
         fp64_grad_rel_l2_tol=RESNET_GRAD_REL_L2,
         fp64_cpu_thread_spread=rspread, fp32_grad_worst_rel_l2=rworst32,
         fp32_grad_worst_param=rworst32_name,
         fp32_cpu_thread_spread=rspread32, grad_check_batch=2,
         grad_check_image=[64, 64, 3], card=card)

    # --------------------------------------------------------- 9. unet
    # SD v1.5 UNet ResNet blocks at batch 8 on 64 x 64 latents: bf16 NHWC
    # activations, fp32 parameters, the loss through DynamicGradScaler and
    # flat FusedAdam; per step 9 one-pass GroupNorms and one two-pass (E's
    # 960 channels), all with SiLU
    ugen = torch.Generator().manual_seed(0)
    ux = torch.randn(UNET_BATCH, 64, 64, 320, generator=ugen) \
        .to(dev, torch.bfloat16)
    ute = torch.randn(UNET_BATCH, 64, 64, 320, generator=ugen).to(dev)
    utd = torch.randn(UNET_BATCH, 8, 8, 1280, generator=ugen).to(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    umodel = build_unet(dev)
    uopt, unamed, ustep = scaled_trainer(
        umodel, lambda named: FusedAdam(named, lr=UNET_LR, use_flat=True),
        dev, unet_loss)
    uparams_n = sum(t.numel() for t in unamed.values())
    ulosses, ustep_s = [], []
    torch.cuda.synchronize()
    _build.reset_launches()
    for _ in range(UNET_STEPS):
        t0 = time.perf_counter()
        ulosses.append(float(ustep(ux, ute, utd)))   # the host sync
        torch.cuda.synchronize()
        ustep_s.append(time.perf_counter() - t0)
    unet_launches = dict(_build.launches)
    upeak = torch.cuda.max_memory_allocated()
    uper_step = {"gn_one_pass": 9, "gn_stats": 1, "gn_apply": 1,
                 "fused_adam": 1}
    uexpect = {k: v * UNET_STEPS for k, v in uper_step.items()}
    require(unet_launches == uexpect,
            f"unet launches {unet_launches}, expected {uexpect}")
    require(all(math.isfinite(x) for x in ulosses)
            and ulosses[-1] < ulosses[0], f"unet losses {ulosses}")
    for name, n in unet_launches.items():
        main_launches[name] = main_launches.get(name, 0) + n
    usteady = sorted(ustep_s[1:])[len(ustep_s[1:]) // 2] * 1e3
    uruns = {}
    ukern = device_profile(lambda: ustep(ux, ute, utd), counts=uruns)
    ubusy = by_kind(ukern)
    utop = top_kernels(ukern, lambda k: True)
    gn_dev = {k: sum(x / 1e3 for n, x in ukern.items()
                     if k + "_kernel" in n)
              for k in ("gn_one_pass", "gn_stats", "gn_apply")}
    # the spread of step times, and the host beside the device: each
    # step's wall ms to its loss on the host, the ms the host took to
    # issue it (the step holds no sync: the synchronising calls in it are
    # counted) and the host thread's CPU ms over that issue
    uwall, uissue, uhost_cpu, usyncs = [], [], [], 0
    for _ in range(UNET_TIMED_STEPS):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0, c0 = time.perf_counter(), time.thread_time()
                loss = ustep(ux, ute, utd)
                t1, c1 = time.perf_counter(), time.thread_time()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        usyncs += sum("synchroniz" in str(w.message) for w in caught)
        float(loss)
        t2 = time.perf_counter()
        uwall.append((t2 - t0) * 1e3)
        uissue.append((t1 - t0) * 1e3)
        uhost_cpu.append((c1 - c0) * 1e3)

    def spread(ms):
        o = sorted(ms)
        return {"min": o[0], "median": o[len(o) // 2],
                "p90": o[(9 * len(o)) // 10], "max": o[-1]}

    uscale = ustep.state["scaler"].scale.item()
    del umodel, uopt, unamed, ustep, ux, ute, utd
    torch.cuda.empty_cache()

    # fp32 cross-check: one step's gradients of the same stack at batch 1
    # (E still two-pass), card vs CPU per tensor, beside two CPU runs that
    # differ only in their thread count
    cgen = torch.Generator().manual_seed(1)
    cbatch = (torch.randn(1, 64, 64, 320, generator=cgen),
              torch.randn(1, 64, 64, 320, generator=cgen),
              torch.randn(1, 8, 8, 1280, generator=cgen))

    def unet_grads(where):
        m = build_unet(where)
        unet_loss(m, *(t.to(where) for t in cbatch)).backward()
        return {n: p.grad.detach().cpu() for n, p in m.named_parameters()}

    ucpu = unet_grads("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ucpu1 = unet_grads("cpu")
    finally:
        torch.set_num_threads(threads)
    _build.reset_launches()
    ucard = unet_grads(dev)
    ucheck_launches = dict(_build.launches)
    uworst, uworst_name = worst_rel(ucard, ucpu)
    uspread, uspread_name = worst_rel(ucpu1, ucpu)
    require(uworst <= UNET_GRAD_REL_L2
            and ucheck_launches.get("gn_stats", 0) == 1,
            f"fp32 UNet card vs CPU gradients: {uworst_name} relative L2 "
            f"{uworst} (CPU thread spread {uspread}), launches "
            f"{ucheck_launches}")
    del ucpu, ucpu1, ucard
    emit("unet", config="SD v1.5 UNet ResNet blocks (320/640/1280/1280, "
         "32 groups, 64x64 latents)", params="fp32", compute="bf16",
         layout="NHWC", parameters=uparams_n, batch=UNET_BATCH,
         optimizer="FusedAdam(flat)", lr=UNET_LR, steps=UNET_STEPS,
         losses=ulosses, launches=unet_launches,
         launches_per_step=uper_step, step_ms=[x * 1e3 for x in ustep_s],
         steady_step_ms=usteady,
         images_per_s=UNET_BATCH / usteady * 1e3,
         step_device_busy_ms=ubusy, top_kernels_ms=utop,
         idle_share=1 - ubusy["total"] / usteady,
         device_kernels_per_step=sum(uruns.values()),
         timed_steps=UNET_TIMED_STEPS, timed_step_ms=uwall,
         timed_step_ms_spread=spread(uwall),
         host_issue_ms_spread=spread(uissue),
         host_cpu_ms_spread=spread(uhost_cpu), host_syncs_in_steps=usyncs,
         timed_idle_share_median=1 - ubusy["total"] / spread(uwall)["median"],
         group_norm_device_ms=gn_dev, max_memory_allocated=upeak,
         loss_scale=uscale, fp32_grad_worst_rel_l2=uworst,
         fp32_grad_worst_param=uworst_name,
         fp32_grad_rel_l2_tol=UNET_GRAD_REL_L2,
         fp32_cpu_thread_spread=uspread,
         fp32_cpu_thread_spread_param=uspread_name,
         fp32_check_launches=ucheck_launches, grad_check_batch=1,
         card=card)

    # ----------------------------------------------------- 10. megatron
    # BASELINE.md config 5 at GPT-2 XL's widths (1600 wide, 25 heads x 64,
    # seq 1024), batch 4, bf16 compute, fp32 parameters. (a) the unfused
    # causal layer as a user loop (linear_bias -> fused_rope_cached ->
    # mha_reference -> linear_bias) on SelfMultiheadAttn's parameters, 5
    # flat FusedAdam steps on an MSE through DynamicGradScaler
    torch.cuda.empty_cache()
    mgen = torch.Generator().manual_seed(0)
    mx = torch.randn(MEGATRON_BATCH, XL_SEQ, XL_EMBED, generator=mgen) \
        .to(dev, torch.bfloat16)
    mtarget = torch.randn(MEGATRON_BATCH, XL_SEQ, XL_EMBED,
                          generator=mgen).to(dev)
    torch.manual_seed(0)
    amod = SelfMultiheadAttn(XL_EMBED, XL_HEADS, causal=True, use_rope=True,
                             device=dev)
    torch.cuda.reset_peak_memory_stats()
    _, _, mstep = scaled_trainer(
        amod, lambda named: FusedAdam(named, lr=MEGATRON_LR, use_flat=True),
        dev, megatron_loss)
    mlosses, mstep_s = [], []
    torch.cuda.synchronize()
    _build.reset_launches()
    for _ in range(MEGATRON_STEPS):
        t0 = time.perf_counter()
        mlosses.append(float(mstep(mx, mtarget)))
        torch.cuda.synchronize()
        mstep_s.append(time.perf_counter() - t0)
    loop_launches = dict(_build.launches)
    megatron_routes = collections.Counter(_build.route_launches)
    mpeak = torch.cuda.max_memory_allocated()
    mper_step = {"softmax_fwd_causal": 1, "softmax_bwd": 1, "fused_adam": 1}
    mexpect = {k: v * MEGATRON_STEPS for k, v in mper_step.items()}
    require(loop_launches == mexpect,
            f"megatron launches {loop_launches}, expected {mexpect} (no "
            f"fa_*)")
    require(all(math.isfinite(x) for x in mlosses)
            and mlosses[-1] < mlosses[0], f"megatron losses {mlosses}")
    msteady = sorted(mstep_s[1:])[len(mstep_s[1:]) // 2] * 1e3
    mkern = device_profile(lambda: mstep(mx, mtarget))
    mbusy = by_kind(mkern)
    msoftmax = {k: sum(x / 1e3 for n, x in mkern.items() if k in n)
                for k in ("sm_fwd_resident", "sm_bwd_resident")}
    mscale = mstep.state["scaler"].scale.item()
    del mstep, mx, mtarget
    torch.cuda.empty_cache()

    # (b) fp32, batch 1: SelfMultiheadAttn (flash) against (a)'s unfused
    # layer with the same weights, output and every parameter's gradient;
    # then mha_reference against flash_attention on the same q, k, v
    torch.manual_seed(1)
    m32 = SelfMultiheadAttn(XL_EMBED, XL_HEADS, causal=True, use_rope=True,
                            device=dev)
    x1 = torch.randn(1, XL_SEQ, XL_EMBED, generator=mgen).to(dev)
    r1 = torch.randn(1, XL_SEQ, XL_EMBED, generator=mgen).to(dev)

    def out_and_grads(fn, module, r, *args):
        """``fn(*args)`` and every parameter's gradient of ``sum(out *
        r)``."""
        module.zero_grad()
        y = fn(*args)
        (y * r).sum().backward()
        return y.detach(), {n: p.grad.detach().clone()
                            for n, p in module.named_parameters()}

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    runs = {}
    fkern = device_profile(lambda: runs.update(
        fa=out_and_grads(m32, m32, r1, x1)), passes=2)
    require_flash_route(fkern, "fp32", "SelfMultiheadAttn (flash)")
    y_fa, g_fa = runs["fa"]
    # the same module on a bf16 input: the tensor-core kernels, the output
    # and every parameter's gradient near the fp32 ones
    hkern = device_profile(lambda: runs.update(
        bf=out_and_grads(m32, m32, r1, x1.to(torch.bfloat16))), passes=2)
    require_flash_route(hkern, "bf16", "SelfMultiheadAttn (flash)")
    self_bf16_out = rel(runs["bf"][0].float(), y_fa)
    self_bf16_grad, self_bf16_grad_name = worst_rel(
        {n: g.float() for n, g in runs["bf"][1].items()}, g_fa)
    require(self_bf16_out <= MHA_BF16_REL_L2
            and self_bf16_grad <= MHA_BF16_REL_L2,
            f"SelfMultiheadAttn bf16 vs fp32: output rel L2 "
            f"{self_bf16_out}, {self_bf16_grad_name} gradient "
            f"{self_bf16_grad}")
    del runs
    y_un, g_un = out_and_grads(lambda x: unfused_self_attention(m32, x), m32,
                               r1, x1)
    self_out = rel(y_fa, y_un)
    self_grad, self_grad_name = worst_rel(g_fa, g_un)
    require(self_out <= MEGATRON_REL_L2 and self_grad <= MEGATRON_REL_L2,
            f"SelfMultiheadAttn vs its unfused twin (fp32): output rel L2 "
            f"{self_out}, {self_grad_name} gradient {self_grad}")
    del m32, g_fa, g_un
    qkv = [torch.randn(MEGATRON_BATCH, XL_HEADS, XL_SEQ, 64, device=dev,
                       generator=gen) for _ in range(4)]
    ref_in = [t.clone().requires_grad_(True) for t in qkv[:3]]
    fa_in = [t.clone().requires_grad_(True) for t in qkv[:3]]
    o_ref = mha_reference(*ref_in, causal=True)
    o_ref.backward(qkv[3])
    o_fa = flash_attention(*fa_in, True)
    o_fa.backward(qkv[3])
    torch.cuda.synchronize()
    ok_o, err_o = close(o_fa.detach(), o_ref.detach(), *FA_TOL["fp32"])
    grad_errs = [close(a.grad, b.grad, *FA_BWD_TOL["fp32"])
                 for a, b in zip(fa_in, ref_in)]
    require(ok_o and all(ok for ok, _ in grad_errs),
            f"flash vs mha_reference at GPT-2 XL width (fp32): o err "
            f"{err_o}, dq / dk / dv errs {[e for _, e in grad_errs]}")
    del qkv, ref_in, fa_in, o_ref, o_fa

    # (c) cross-attention, sq 1024 / sk 512, a (4, 1, 1, 512) key-padding
    # mask: EncdecMultiheadAttn (flash) against its unfused twin through
    # mha_reference(mask=...), fp32 forward and backward
    torch.manual_seed(2)
    emod = EncdecMultiheadAttn(XL_EMBED, XL_HEADS, device=dev)
    eq = torch.randn(MEGATRON_BATCH, XL_SEQ, XL_EMBED, generator=mgen).to(dev)
    ekv = torch.randn(MEGATRON_BATCH, 512, XL_EMBED, generator=mgen).to(dev)
    er = torch.randn(MEGATRON_BATCH, XL_SEQ, XL_EMBED, generator=mgen) \
        .to(dev)
    elens = [512, 400, 256, 17]
    emask = key_padding(elens, 512)
    _build.reset_launches()
    ye_mod, ge_mod = out_and_grads(emod, emod, er, eq, ekv, emask)
    torch.cuda.synchronize()
    enc_mod_launches = dict(_build.launches)
    megatron_routes.update(_build.route_launches)
    path_routes["megatron"] = dict(megatron_routes)
    _build.reset_launches()
    ye_un, ge_un = out_and_grads(lambda *a: unfused_encdec(emod, *a), emod,
                                 er, eq, ekv, emask)
    torch.cuda.synchronize()
    enc_twin_launches = dict(_build.launches)
    enc_out = rel(ye_mod, ye_un)
    enc_grad, enc_grad_name = worst_rel(ge_mod, ge_un)
    require(enc_mod_launches == {"fa_fwd": 1, "fa_bwd_dq": 1,
                                 "fa_bwd_dkv": 1}
            and enc_twin_launches == {"softmax_fwd": 1, "softmax_bwd": 1},
            f"cross-attention launches: module {enc_mod_launches}, twin "
            f"{enc_twin_launches}")
    require(enc_out <= MEGATRON_REL_L2 and enc_grad <= MEGATRON_REL_L2,
            f"EncdecMultiheadAttn vs its unfused twin (fp32): output rel L2 "
            f"{enc_out}, {enc_grad_name} gradient {enc_grad}")
    # (e) training with attention dropout: SelfMultiheadAttn(1600, 25,
    # causal, RoPE, dropout_p=FA_DROP_RATE), bf16 compute, fp32
    # parameters, 5 flat FusedAdam steps on an MSE through
    # DynamicGradScaler, a new seed each step (a device tensor: no host
    # sync); exactly one launch of each flash kernel, in its dropout form
    # on the tensor-core route, and one fused_adam a step
    torch.manual_seed(4)
    dmod = SelfMultiheadAttn(XL_EMBED, XL_HEADS, causal=True, use_rope=True,
                             dropout_p=FA_DROP_RATE, device=dev)
    dx = torch.randn(MEGATRON_BATCH, XL_SEQ, XL_EMBED, generator=mgen) \
        .to(dev, torch.bfloat16)
    dtarget = torch.randn(MEGATRON_BATCH, XL_SEQ, XL_EMBED,
                          generator=mgen).to(dev)
    dseeds = torch.arange(MEGATRON_STEPS, dtype=torch.int32,
                          device=dev) * 7919 + 11

    def dropout_loss(model, x, target, seed):
        return ((model(x, dropout_seed=seed).float() - target) ** 2).mean()

    _, _, dstep = scaled_trainer(
        dmod, lambda named: FusedAdam(named, lr=MEGATRON_LR, use_flat=True),
        dev, dropout_loss)
    dlosses, dstep_s = [], []
    torch.cuda.synchronize()
    _build.reset_launches()
    for i in range(MEGATRON_STEPS):
        t0 = time.perf_counter()
        dlosses.append(float(dstep(dx, dtarget, dseeds[i])))
        torch.cuda.synchronize()
        dstep_s.append(time.perf_counter() - t0)
    drop_parts = (dict(_build.launches), dict(_build.route_launches),
                  dict(_build.form_launches))
    flash3 = ("fa_fwd", "fa_bwd_dq", "fa_bwd_dkv")
    per5 = {k: MEGATRON_STEPS for k in (*flash3, "fused_adam")}
    require(drop_parts == (
        per5, {f"{k}:wgmma": MEGATRON_STEPS for k in flash3},
        {f"{k}:wgmma:dropout": MEGATRON_STEPS for k in flash3}),
        f"megatron (e) launches, routes, forms {drop_parts}, expected "
        f"{per5} on the tensor-core route, all in the dropout form")
    require(all(math.isfinite(x) for x in dlosses)
            and dlosses[-1] < dlosses[0], f"megatron (e) losses {dlosses}")
    dsteady = sorted(dstep_s[1:])[len(dstep_s[1:]) // 2] * 1e3
    dkern = device_profile(lambda: dstep(dx, dtarget, dseeds[0]))
    dbusy = by_kind(dkern)
    del dstep, dmod, dx, dtarget
    torch.cuda.empty_cache()

    # (f) a learned (1, 25, 1024, 1024) fp32 attention bias (a
    # relative-position table) trained through flash_attention(bias=...,
    # bias_requires_grad=True) on fixed bf16 q, k, v: 5 flat FusedAdam
    # steps (lr BIAS_LR) on an MSE through DynamicGradScaler, one launch of
    # each flash kernel a step, the dq kernel in its dlogits form. Then
    # fp32, one step on the trained table: o and the gradients of q, k, v
    # and the bias against autograd through the unfused function (fp32
    # scores plus the bias, causal mask, torch.softmax, p v)
    class BiasTable(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.bias = torch.nn.Parameter(torch.zeros(
                1, XL_HEADS, XL_SEQ, XL_SEQ, device=dev))

    table = BiasTable()
    bqkv = [torch.randn(MEGATRON_BATCH, XL_HEADS, XL_SEQ, 64, device=dev,
                        generator=gen) for _ in range(4)]

    def bias_loss(model, q, k, v, target):
        o = flash_attention(q, k, v, True, bias=model.bias,
                            bias_requires_grad=True)
        return ((o.float() - target) ** 2).mean()

    _, _, bstep = scaled_trainer(
        table, lambda named: FusedAdam(named, lr=BIAS_LR, use_flat=True),
        dev, bias_loss)
    bf_qkv = [t.to(torch.bfloat16) for t in bqkv[:3]]
    blosses = []
    torch.cuda.synchronize()
    _build.reset_launches()
    for _ in range(MEGATRON_STEPS):
        blosses.append(float(bstep(*bf_qkv, bqkv[3])))
    torch.cuda.synchronize()
    bias_parts = (dict(_build.launches), dict(_build.route_launches),
                  dict(_build.form_launches))
    require(bias_parts == (
        per5, {f"{k}:wgmma": MEGATRON_STEPS for k in flash3},
        {"fa_bwd_dq:wgmma:dbias": MEGATRON_STEPS}),
        f"megatron (f) launches, routes, forms {bias_parts}, expected "
        f"{per5} on the tensor-core route, the dq kernel's dlogits form")
    require(all(math.isfinite(x) for x in blosses)
            and blosses[-1] < blosses[0], f"megatron (f) losses {blosses}")
    bias32 = table.bias.detach().clone().requires_grad_(True)
    fa_in = [t.clone().requires_grad_(True) for t in bqkv[:3]]
    ref_in = [t.clone().requires_grad_(True) for t in bqkv[:3]]
    _build.reset_launches()
    o_fa = flash_attention(*fa_in, True, bias=bias32)
    o_fa.backward(bqkv[3])
    torch.cuda.synchronize()
    bias32_parts = (dict(_build.launches), dict(_build.route_launches),
                    dict(_build.form_launches))
    fa_dbias = bias32.grad.clone()
    bias32.grad = None
    scores = torch.matmul(ref_in[0], ref_in[1].transpose(-1, -2)) * 0.125 \
        + bias32
    scores = scores.masked_fill(torch.ones(XL_SEQ, XL_SEQ, dtype=torch.bool,
                                           device=dev).triu(1), NEG_INF)
    o_ref = torch.matmul(torch.softmax(scores, dim=-1), ref_in[2])
    o_ref.backward(bqkv[3])
    del scores
    torch.cuda.synchronize()
    ok_bo, err_bo = close(o_fa.detach(), o_ref.detach(), *FA_TOL["fp32"])
    bias_errs = [close(a.grad, b.grad, *FA_BWD_TOL["fp32"])
                 for a, b in zip(fa_in, ref_in)]
    bias_errs.append(close(fa_dbias, bias32.grad, *FA_BWD_TOL["fp32"]))
    require(ok_bo and all(ok for ok, _ in bias_errs)
            and bias32_parts[2] == {"fa_bwd_dq:fma:dbias": 1},
            f"learned bias (fp32) vs autograd: o err {err_bo}, dq / dk / "
            f"dv / dbias errs {[e for _, e in bias_errs]}; forms "
            f"{bias32_parts[2]}")
    del bstep, table, bqkv, bf_qkv, bias32, fa_in, ref_in, o_fa, o_ref
    del fa_dbias
    torch.cuda.empty_cache()

    # (g) fp32 EncdecMultiheadAttn(dropout_p=FA_DROP_RATE) with (c)'s
    # key-padding mask and a seed: forward and backward on the FMA-pipe
    # kernels' dropout forms against the same module on the CPU (the
    # plain versions, the same keep mask), output and every parameter's
    # gradient
    torch.manual_seed(5)
    gmod = EncdecMultiheadAttn(XL_EMBED, XL_HEADS, dropout_p=FA_DROP_RATE,
                               device=dev)
    gcpu = EncdecMultiheadAttn(XL_EMBED, XL_HEADS, dropout_p=FA_DROP_RATE,
                               device="cpu")
    gcpu.load_state_dict({k: v.cpu() for k, v in gmod.state_dict().items()})
    gq = torch.randn(MEGATRON_BATCH, XL_SEQ, XL_EMBED, generator=mgen)
    gkv = torch.randn(MEGATRON_BATCH, 512, XL_EMBED, generator=mgen)
    gr = torch.randn(MEGATRON_BATCH, XL_SEQ, XL_EMBED, generator=mgen)
    _build.reset_launches()
    yg_card, gg_card = out_and_grads(
        lambda *a: gmod(*a, dropout_seed=torch.tensor(
            31, dtype=torch.int32, device=dev)), gmod, gr.to(dev),
        gq.to(dev), gkv.to(dev), emask)
    torch.cuda.synchronize()
    encdrop_parts = (dict(_build.launches), dict(_build.route_launches),
                     dict(_build.form_launches))
    yg_cpu, gg_cpu = out_and_grads(
        lambda *a: gcpu(*a, dropout_seed=31), gcpu, gr, gq, gkv,
        emask.cpu())
    encdrop_out = rel(yg_card.cpu(), yg_cpu)
    encdrop_grad, encdrop_grad_name = worst_rel(
        {n: g.cpu() for n, g in gg_card.items()}, gg_cpu)
    require(encdrop_parts == (
        {k: 1 for k in flash3}, {f"{k}:fma": 1 for k in flash3},
        {f"{k}:fma:dropout": 1 for k in flash3}),
        f"megatron (g) launches, routes, forms {encdrop_parts}")
    require(encdrop_out <= MEGATRON_REL_L2
            and encdrop_grad <= MEGATRON_REL_L2,
            f"EncdecMultiheadAttn with dropout, card vs CPU (fp32): output "
            f"rel L2 {encdrop_out}, {encdrop_grad_name} gradient "
            f"{encdrop_grad}")
    del gmod, gcpu, yg_card, gg_card, yg_cpu, gg_cpu
    torch.cuda.empty_cache()
    form_phases["megatron"] = collections.Counter()
    for part in (drop_parts, bias_parts, bias32_parts, encdrop_parts):
        megatron_routes.update(part[1])
        main_forms.update(part[2])
        form_phases["megatron"].update(part[2])
    path_routes["megatron"] = dict(megatron_routes)

    megatron_launches = dict(loop_launches)
    for part in (enc_mod_launches, enc_twin_launches, drop_parts[0],
                 bias_parts[0], bias32_parts[0], encdrop_parts[0]):
        for name, n in part.items():
            megatron_launches[name] = megatron_launches.get(name, 0) + n
    for name, n in megatron_launches.items():
        main_launches[name] = main_launches.get(name, 0) + n
    del emod, eq, ekv, er, ye_mod, ge_mod, ye_un, ge_un
    torch.cuda.empty_cache()

    # (d) the rest of transformer/ at GPT-2 XL's widths, fp32: the dense
    # modules and the MLP on 4096 tokens, held on their first rows against
    # the same function on the CPU; linear_cross_entropy over the XL head
    # against the dense head (logits + xentropy) on the card and against
    # itself on the CPU
    def module_vs_cpu(make, x):
        torch.manual_seed(3)
        card_mod = make(dev)
        cpu_mod = make("cpu")
        cpu_mod.load_state_dict({k: v.cpu() for k, v in
                                 card_mod.state_dict().items()})
        r = torch.randn(x.shape[0], XL_EMBED, generator=mgen)
        out = {}
        for where, m in (("card", card_mod), ("cpu", cpu_mod)):
            xi = x.to(dev if where == "card" else "cpu").clone() \
                .requires_grad_(True)
            y = m(xi)
            (y * r.to(xi.device)).sum().backward()
            out[where] = (y.detach().cpu(), xi.grad.cpu(),
                          {n: p.grad.cpu() for n, p in m.named_parameters()})
        worst = max(rel(out["card"][0], out["cpu"][0]),
                    rel(out["card"][1], out["cpu"][1]),
                    worst_rel(out["card"][2], out["cpu"][2])[0])
        return worst, card_mod

    xrows = torch.randn(LCE_CHECK_ROWS, XL_EMBED, generator=mgen)
    dgd_err, dgd = module_vs_cpu(
        lambda d: FusedDenseGeluDense(XL_EMBED, 4 * XL_EMBED, XL_EMBED,
                                      device=d), xrows)
    mlp_err, mlpm = module_vs_cpu(
        lambda d: MLP([XL_EMBED, 4 * XL_EMBED, XL_EMBED], device=d), xrows)
    require(dgd_err <= MEGATRON_REL_L2 and mlp_err <= MEGATRON_REL_L2,
            f"card vs CPU (fp32): FusedDenseGeluDense rel L2 {dgd_err}, MLP "
            f"{mlp_err}")
    xfull = torch.randn(MEGATRON_BATCH * XL_SEQ, XL_EMBED, generator=mgen) \
        .to(dev)
    dense_ms = {
        "FusedDenseGeluDense": bench_ms(lambda x: dgd(x).sum().backward(),
                                        [(xfull,)], 5),
        "MLP": bench_ms(lambda x: mlpm(x).sum().backward(), [(xfull,)], 5)}
    del dgd, mlpm
    head_w = (torch.randn(XL_EMBED, XL_VOCAB, generator=mgen) * 0.02).to(dev)
    head_h = torch.randn(MEGATRON_BATCH * XL_SEQ, XL_EMBED,
                         generator=mgen).to(dev)
    head_lab = torch.randint(0, XL_VOCAB, (MEGATRON_BATCH * XL_SEQ,),
                             generator=mgen).to(dev)
    head_r = torch.rand(MEGATRON_BATCH * XL_SEQ, generator=mgen).to(dev)

    def head(fn, h, w, lab, r):
        """Loss and the gradients of hidden and weight, with the peak
        device memory over the call beyond what was allocated before."""
        h = h.clone().requires_grad_(True)
        w = w.clone().requires_grad_(True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = fn(h, w, lab)
        (loss * r).sum().backward()
        torch.cuda.synchronize()
        return (loss.detach(), h.grad, w.grad,
                torch.cuda.max_memory_allocated() - base,
                (time.perf_counter() - t0) * 1e3)

    lce = head(lambda h, w, lab: linear_cross_entropy(h, w, lab), head_h,
               head_w, head_lab, head_r)
    dense = head(lambda h, w, lab: softmax_cross_entropy_loss(h @ w, lab),
                 head_h, head_w, head_lab, head_r)
    lce_vs_dense = [rel(a, b) for a, b in zip(lce[:3], dense[:3])]
    n = LCE_CHECK_ROWS
    lce_card = head(lambda h, w, lab: linear_cross_entropy(h, w, lab),
                    head_h[:n], head_w, head_lab[:n], head_r[:n])
    hc = head_h[:n].cpu().requires_grad_(True)
    wc = head_w.cpu().requires_grad_(True)
    lc = linear_cross_entropy(hc, wc, head_lab[:n].cpu())
    (lc * head_r[:n].cpu()).sum().backward()
    lce_vs_cpu = [rel(a.cpu(), b) for a, b in zip(
        lce_card[:3], (lc.detach(), hc.grad, wc.grad))]
    require(max(lce_vs_dense) <= LCE_REL_L2
            and max(lce_vs_cpu) <= MEGATRON_REL_L2,
            f"linear_cross_entropy vs the dense head (loss, dh, dw rel L2) "
            f"{lce_vs_dense}, vs the CPU {lce_vs_cpu}")
    lce_peak, lce_ms, dense_peak, dense_head_ms = lce[3], lce[4], dense[3], \
        dense[4]
    del head_w, head_h, lce, dense, lce_card, hc, wc, lc
    torch.cuda.empty_cache()
    emit("megatron", config="GPT-2 XL attention (1600 wide, 25 heads x 64, "
         "seq 1024; BASELINE.md config 5)", params="fp32", compute="bf16",
         batch=MEGATRON_BATCH, seq=XL_SEQ, optimizer="FusedAdam(flat)",
         lr=MEGATRON_LR, steps=MEGATRON_STEPS, losses=mlosses,
         launches=loop_launches, launches_per_step=mper_step,
         step_ms=[x * 1e3 for x in mstep_s], steady_step_ms=msteady,
         tokens_per_s=MEGATRON_BATCH * XL_SEQ / msteady * 1e3,
         step_device_busy_ms=mbusy, idle_share=1 - mbusy["total"] / msteady,
         softmax_device_ms=msoftmax, top_kernels_ms=top_kernels(
             mkern, lambda k: True), max_memory_allocated=mpeak,
         loss_scale=mscale, self_attn_vs_unfused_rel_l2=self_out,
         self_attn_bf16_vs_fp32_rel_l2=self_bf16_out,
         self_attn_bf16_vs_fp32_grad_worst_rel_l2=self_bf16_grad,
         self_attn_grad_worst_rel_l2=self_grad,
         self_attn_grad_worst_param=self_grad_name,
         flash_vs_mha_reference={"o": err_o, "dq_dk_dv": [
             e for _, e in grad_errs], "tol": {"o": FA_TOL["fp32"],
                                              "grads": FA_BWD_TOL["fp32"]}},
         encdec_lengths=elens, encdec_vs_unfused_rel_l2=enc_out,
         encdec_grad_worst_rel_l2=enc_grad,
         encdec_grad_worst_param=enc_grad_name,
         encdec_launches={"module": enc_mod_launches,
                          "twin": enc_twin_launches},
         dropout_train={"dropout_p": FA_DROP_RATE, "losses": dlosses,
                        "step_ms": [x * 1e3 for x in dstep_s],
                        "steady_step_ms": dsteady,
                        "tokens_per_s": MEGATRON_BATCH * XL_SEQ / dsteady
                        * 1e3, "step_device_busy_ms": dbusy,
                        "idle_share": 1 - dbusy["total"] / dsteady,
                        "launches": drop_parts[0], "forms": drop_parts[2]},
         learned_bias={"shape": [1, XL_HEADS, XL_SEQ, XL_SEQ],
                       "lr": BIAS_LR, "losses": blosses,
                       "launches": bias_parts[0], "forms": bias_parts[2],
                       "fp32_vs_autograd": {
                           "o": err_bo, "dq_dk_dv_dbias": [
                               e for _, e in bias_errs]}},
         encdec_dropout={"card_vs_cpu_rel_l2": encdrop_out,
                         "grad_worst_rel_l2": encdrop_grad,
                         "grad_worst_param": encdrop_grad_name,
                         "forms": encdrop_parts[2]},
         rel_l2_tol=MEGATRON_REL_L2,
         dense_card_vs_cpu_rel_l2={"FusedDenseGeluDense": dgd_err,
                                   "MLP": mlp_err},
         dense_fwd_bwd_call_ms_4096_tokens=dense_ms,
         lce_vs_dense_rel_l2={"loss": lce_vs_dense[0],
                              "d_hidden": lce_vs_dense[1],
                              "d_weight": lce_vs_dense[2]},
         lce_vs_cpu_rel_l2=lce_vs_cpu, lce_rel_l2_tol=LCE_REL_L2,
         lce_peak_bytes_over_inputs=lce_peak,
         dense_head_peak_bytes_over_inputs=dense_peak,
         dense_head_logits_bytes=MEGATRON_BATCH * XL_SEQ * XL_VOCAB * 4,
         lce_fwd_bwd_wall_ms=lce_ms, dense_head_fwd_bwd_wall_ms=dense_head_ms,
         card=card)

    # -------------- 11. the remote-copy kernels (rows 19-21), 12. ring,
    # 13. halo: rank processes on this card
    from apex_tpu_torch.ops import remote_copy as rc
    from apex_tpu_torch.parallel import spawn_ranks, zigzag_shard
    torch.cuda.empty_cache()

    # (a) each kernel alone, at the ring's sizes and beyond the L2
    solo = _remote_copy_solo(dev)

    # (b) worlds 4 and 2: the checks, the ring and (at 4) the halo phase
    path, spawn_s = {}, {}
    for world in (HALO_WORLD, 2):
        t0 = time.perf_counter()
        path[world] = spawn_ranks(_rank_path, world, (PEER_SPEC,),
                                  device=dev, timeout_s=600)
        spawn_s[world] = time.perf_counter() - t0
    n_shift = 3 * sum(len(v) for v in PEER_SPEC["shift_sizes"].values()) \
        + len(_PEER_DTYPES)
    n_halo = 2 * 2 * 2 * sum(
        sum(1 for h in (1, 3) if h <= shape[0])
        for shape in PEER_SPEC["halo_shapes"]) * len(_PEER_DTYPES)
    # two runs of each checked shift, one of each offset view
    n_puts = 2 * n_shift - len(_PEER_DTYPES)
    check_launches = {"peer_put": n_puts, "halo_put": n_halo,
                      "peer_wait": n_puts + 2 * n_halo}
    for world, ranks in path.items():
        for r, res in enumerate(ranks):
            c = res["checks"]
            require(c["shift_checks"] == n_shift
                    and c["halo_checks"] == n_halo
                    and c["launches"] == check_launches,
                    f"world {world} rank {r}: {c['shift_checks']} shift / "
                    f"{c['halo_checks']} halo checks, launches "
                    f"{c['launches']}; expected {n_shift} / {n_halo}, "
                    f"{check_launches}")
    tw = {world: ranks[0]["checks"]["timed"] for world, ranks in path.items()}
    # every size's reading beside its bound; lines through the ring's two
    # sizes (in the L2) and through the two beyond it
    shifts, strips = solo["shift"], solo["strips"]
    for rec in shifts + strips:
        require(rec["err"] == 0.0,
                f"self-put of {rec.get('bytes', rec.get('shape'))}: max "
                f"abs err {rec['err']} (a copy: exact)")
    l2_pair = [r for r in shifts if r["n"] == PEER_SPEC["timed_shift"]]
    big_pair = [r for r in shifts if r["bytes"] >= 2 * L2_BYTES]
    for rec in big_pair:
        b = bound(2 * rec["bytes"], 0, "fp32")[0]
        for key in ("put", "wait", "copy_ms", "library_ms"):
            require(rec[key] >= b,
                    f"{key} of {rec['bytes']} bytes read {rec[key]} ms, "
                    f"under its bytes bound {b} ms: faster than the HBM")
    for rec in strips:
        if rec["edge_bytes"] >= L2_BYTES:
            b = bound(rec["moved_bytes"], 0, "fp32")[0]
            for key in ("put", "library_ms"):
                require(rec[key] >= b,
                        f"halo {key} of {rec['shape']} read {rec[key]} ms, "
                        f"under its bytes bound {b} ms")

    def sizes(key, lib_key):
        return [{"bytes": r["bytes"], "dtype": r["dtype"], "ms": r[key],
                 "library_ms": r[lib_key],
                 "bound_ms": bound(2 * r["bytes"], 0, "fp32")[0],
                 # both landing slots (or the copy_'s destination)
                 "writes_fit_l2": rc.SHIFT_SLOTS * r["bytes"] <= L2_BYTES}
                for r in shifts]

    fit = _solo_fits(solo)
    for ring in l2_pair:
        dt, nb = ring["dtype"], ring["bytes"]
        bms, by = bound(2 * nb, 0, "fp32")
        common = dict(setup=SELF_PUT, n=ring["n"], dtype=dt, bytes=nb,
                      max_abs_err=ring["err"], bound_ms=bms, bound_by=by,
                      writes_fit_l2=rc.SHIFT_SLOTS * nb <= L2_BYTES,
                      call_ms=ring["call_ms"],
                      plain_ms=tw[2][f"shift_{dt}_plain_ms"],
                      checks_per_rank=n_shift,
                      shift_call_ms_world={w: tw[w][f"shift_{dt}_call_ms"]
                                           for w in tw}, card=card)
        rput = dict(kernel="peer_put", ms=ring["put"],
                    ms_in_ring={w: _pick(tw[w][f"shift_{dt}"],
                                         "peer_put_kernel") for w in tw},
                    library_ms=ring["library_ms"],
                    library_call_ms=ring["library_call_ms"],
                    library_ms_world2=tw[2][f"library_{dt}"],
                    library_call_ms_world2=tw[2][f"library_{dt}_call_ms"],
                    sizes=sizes("put", "library_ms"), fit=fit["put"],
                    library_fit=fit["library_ms"], **common)
        rwait = dict(kernel="peer_wait", ms=ring["wait"],
                     ms_in_ring={w: _pick(tw[w][f"shift_{dt}"],
                                          "peer_wait_kernel") for w in tw},
                     library_ms=ring["copy_ms"],
                     sizes=sizes("wait", "copy_ms"), fit=fit["wait"],
                     library_fit=fit["copy_ms"], **common)
        emit("kernel", **rput)
        emit("kernel", **rwait)
        if dt == "bf16":
            summary["peer_put"], summary["peer_wait"] = rput, rwait
    strip = strips[0]
    hb, hby = bound(strip["moved_bytes"], 0, "fp32")
    rhalo = dict(kernel="halo_put", setup=SELF_PUT, rows=strip["shape"][0],
                 shape=strip["shape"], dtype="bf16",
                 bytes=strip["moved_bytes"], max_abs_err=strip["err"],
                 ms=strip["put"], wait_ms=strip["wait"],
                 ms_in_ring={w: _pick(tw[w]["halo"], "halo_put_kernel")
                             for w in tw},
                 call_ms=strip["call_ms"],
                 halo_call_ms_world={w: tw[w]["halo_call_ms"] for w in tw},
                 plain_ms=tw[2]["halo_plain_ms"],
                 library_ms=strip["library_ms"],
                 library_ms_world2=tw[2]["library_halo"], bound_ms=hb,
                 bound_by=hby, writes_fit_l2=2 * strip["edge_bytes"]
                 <= L2_BYTES, checks_per_rank=n_halo,
                 sizes=[{"shape": r["shape"], "edge_bytes": r["edge_bytes"],
                         "ms": r["put"], "wait_ms": r["wait"],
                         "library_ms": r["library_ms"],
                         "bound_ms": bound(r["moved_bytes"], 0, "fp32")[0],
                         "writes_fit_l2": 2 * r["edge_bytes"] <= L2_BYTES}
                        for r in strips],
                 fit=fit["halo_put"], library_fit=fit["halo_library"],
                 card=card)
    emit("kernel", **rhalo)
    summary["halo_put"] = rhalo

    # (c) the ring, held against the full-sequence flash on this card
    ring_launches, ring_out, single_ms = {}, {}, {}
    ring_routes = collections.Counter()
    for world, ranks in path.items():
        for dt, tokens in (("bf16", RING_TOKENS),
                           ("fp32", RING_FP32_PER_RANK * world)):
            full = _ring_inputs(tokens, tdt[dt], dev)
            o_tol, g_tol = RING_TOL[dt]
            for layout, causal in RING_LAYOUTS:
                q, k, v = (t.detach().requires_grad_(True)
                           for t in full[:3])
                o = flash_attention(q, k, v, causal)
                o.backward(full[3])
                want = [o.detach(), q.grad, k.grad, v.grad]
                if dt == "bf16" and world == HALO_WORLD:
                    # the yardstick: the same attention in this one
                    # process, one full-sequence flash forward + backward
                    def one():
                        qq, kk, vv = (t.detach().requires_grad_(True)
                                      for t in full[:3])
                        flash_attention(qq, kk, vv, causal).backward(full[3])
                    one()
                    single_ms[causal] = bench_ms(one, [()], 3)
                if layout == "zigzag":
                    want = [zigzag_shard(t, world) for t in want]
                recs = [res["ring"][(dt, layout, causal)] for res in ranks]
                got = []
                for i in range(4):
                    parts = [torch.from_numpy(rec["tensors"][i])
                             for rec in recs]
                    t = torch.cat(parts, dim=2).to(dev)
                    got.append(t.view(torch.bfloat16) if dt == "bf16" else t)
                errs = [rel_l2(g.float(), w_.float())
                        for g, w_ in zip(got, want)]
                name = f"{layout}_{'causal' if causal else 'full'}"
                require(errs[0] <= o_tol and max(errs[1:]) <= g_tol,
                        f"ring {name} world {world} {dt}: rel L2 o "
                        f"{errs[0]}, dq / dk / dv {errs[1:]} (tol {o_tol} /"
                        f" {g_tol})")
                expect = {"fa_fwd": world, "fa_bwd_dq": world,
                          "fa_bwd_dkv": world,
                          "peer_put": 2 * (world - 1) + 2 * (world - 1)
                          + 2 * world}
                expect["peer_wait"] = expect["peer_put"]
                require(all(rec["launches"] == expect for rec in recs),
                        f"ring {name} world {world} {dt}: launches "
                        f"{[rec['launches'] for rec in recs]}, expected "
                        f"{expect} a rank")
                row = {"rel_l2": {"o": errs[0], "dq": errs[1], "dk": errs[2],
                                  "dv": errs[3]}, "launches_per_rank": expect}
                for rec in recs:
                    ring_routes.update(rec["routes"])
                if dt == "bf16":
                    for rec in recs:
                        for kname, cnt in rec["launches"].items():
                            ring_launches[kname] = \
                                ring_launches.get(kname, 0) + cnt
                    span = recs[0]["profile"]
                    require(span["flash_fwd_wgmma"] > 0
                            and span["flash_bwd_dq_wgmma"] > 0
                            and span["flash_bwd_dkv_wgmma"] > 0
                            and span["flash_fma"] == 0,
                            f"ring {name} world {world}: rank 0's flash "
                            f"kernels not the tensor-core ones: {span}")
                    step_ms = [rec["step_ms"] for rec in recs]
                    slowest = max(sorted(s)[len(s) // 2] for s in step_ms)
                    # rank 0's kernel spans include the other ranks'
                    # time slices: the card runs one context at a time
                    row.update(step_ms_per_rank=step_ms,
                               tokens_per_s=RING_TOKENS / (slowest / 1e3),
                               rank0_kernel_span_ms=recs[0]["profile"],
                               single_process_flash_ms=single_ms[causal])
                ring_out[f"world{world}_{dt}_{name}"] = row
            del full, q, k, v, o, want, got
    emit("ring", config="GPT2Config.small attention (12 heads x 64), batch 1",
         tokens=RING_TOKENS, fp32_tokens_per_rank=RING_FP32_PER_RANK,
         worlds=sorted(path), transport="rdma", tol=RING_TOL,
         runs=ring_out, spawn_s=spawn_s, card=card)
    for name, n in ring_launches.items():
        main_launches[name] = main_launches.get(name, 0) + n
    path_routes["ring"] = dict(ring_routes)

    # (d) the halo: the tiles' VALID-in-H convs against the image's conv
    hres = [res["halo"] for res in path[HALO_WORLD]]
    hx, hw = _halo_inputs(dev)
    y_full = F.conv2d(hx.permute(0, 3, 1, 2), hw, padding=1).permute(
        0, 2, 3, 1)
    y_got = torch.cat([torch.from_numpy(h["y"]) for h in hres],
                      dim=1).to(dev).view(torch.bfloat16)
    conv_err = rel_l2(y_got.float(), y_full.float())
    require(conv_err <= HALO_CONV_TOL,
            f"halo conv: tiles vs the image's conv rel L2 {conv_err} (tol "
            f"{HALO_CONV_TOL})")
    halo_launches = {}
    for r, h in enumerate(hres):
        require(h["launches"] == {"halo_put": 1, "peer_wait": 2},
                f"halo rank {r}: one exchange launched {h['launches']}")
        require(len(set(h["memory_allocated"])) == 1,
                f"halo rank {r}: memory_allocated over {HALO_ITERS} "
                f"iterations {h['memory_allocated']}")
        # the landing buffers: the pool's lo / hi, allocated at the first
        # exchange, and no arena made or grown after it
        require(h["pool_allocations"] == 2
                and len(set(h["arenas"])) == 1,
                f"halo rank {r}: {h['pool_allocations']} pool allocations, "
                f"IPC arenas (count, bytes) after the first exchange and "
                f"each later one {h['arenas']}")
        for kname, cnt in h["launches"].items():
            halo_launches[kname] = halo_launches.get(kname, 0) + cnt
    emit("halo", image=list(HALO_IMAGE), layout="NHWC", dtype="bf16",
         world=HALO_WORLD, rows_per_rank=HALO_IMAGE[1] // HALO_WORLD,
         conv_rel_l2=conv_err, tol=HALO_CONV_TOL,
         conv_max_abs=(y_got.float() - y_full.float()).abs().max().item(),
         launches_per_rank=hres[0]["launches"],
         memory_allocated_per_rank=[h["memory_allocated"] for h in hres],
         ipc_arenas_per_rank=[h["arenas"][-1] for h in hres],
         exchange_call_ms=[h["exchange_call_ms"] for h in hres],
         step_call_ms=[h["step_call_ms"] for h in hres],
         rank0_exchange_device_ms=hres[0]["exchange_profile"],
         pool_allocations=hres[0]["pool_allocations"], card=card)
    for name, n in halo_launches.items():
        main_launches[name] = main_launches.get(name, 0) + n
    del hx, hw, y_full, y_got

    # ------------------------------------- 14. cerebras and 15. gptj
    # Two GPT-2-architecture models at full width from a seed, each of one
    # compiled head width: Cerebras-GPT 1.3B (16 heads of d = 128, 24
    # layers) and GPT-J 6B's widths (16 heads of d = 256, 8 of 28 layers).
    # For each: (a) trained 5 steps at 2 x 2048 and served; (b) 2 layers at
    # its widths in fp32, card vs CPU (the FMA kernels at its d); (c)
    # cerebras: 2 layers at Cerebras-GPT 2.7B's widths (32 heads of d = 80:
    # the padded route) in bf16 and fp32, card vs CPU; gptj: the public op
    # at Nemotron-4's d = 192 (padded to 256) against the plain versions;
    # (d) the width's dropout and dlogits forms of all six kernels through
    # the modules and the public op
    flash3 = ("fa_fwd", "fa_bwd_dq", "fa_bwd_dkv")

    def width_train_serve(what, cfg, d, seed):
        """(a): ``cfg`` (fp32 parameters from ``seed``, bf16 compute)
        trained by ``Trainer`` for CG_STEPS AdamW steps under the dynamic
        scaler on one CG_BATCH x n_positions batch, every flash launch in
        its d tensor-core form, then served; returns ``(record, launches,
        forms, tokens)``."""
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()  # what earlier phases hold
        t0 = time.perf_counter()
        model = GPT2.from_params(cfg, init_gpt2_params(cfg, seed=seed),
                                 device=dev)
        init_s = time.perf_counter() - t0
        n = sum(p.numel() for p in model.parameters())
        # fp32 parameters, the flat fp32 buffers of the parameters, their
        # gradients and Adam's two moments, and the model's fp32 gradients
        # before they are packed: 20 bytes a parameter before activations
        reckoned = 20 * n
        tgen = torch.Generator().manual_seed(seed + 1)
        tok = torch.randint(0, cfg.vocab_size, (CG_BATCH, cfg.n_positions),
                            generator=tgen)
        tok_d = tok.to(dev)
        trainer = Trainer(
            TrainConfig(steps=CG_STEPS, batch=CG_BATCH, seq=cfg.n_positions,
                        lr=CG_LR, amp="dynamic"),
            loss_fn=lm_loss, init_params=model, batch_fn=lambda t: tok_d)
        losses, step_s = [], []
        clock = [time.perf_counter()]

        def on_step(t, loss):
            now = time.perf_counter()
            step_s.append(now - clock[0])
            clock[0] = now
            losses.append(loss)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        clock[0] = time.perf_counter()
        report = trainer.run(on_step=on_step)
        torch.cuda.synchronize()
        parts = (dict(_build.launches), dict(_build.route_launches),
                 dict(_build.form_launches))
        peak = torch.cuda.max_memory_allocated()
        layers = cfg.n_layer
        per = {"ln_fwd": 2 * layers + 1, "ln_bwd": 2 * layers + 1,
               "fa_fwd": layers, "fa_bwd_dq": layers, "fa_bwd_dkv": layers,
               "fused_adam": 1}
        nfa = layers * CG_STEPS
        require(parts == ({k: v * CG_STEPS for k, v in per.items()},
                          {f"{k}:wgmma": nfa for k in flash3},
                          {f"{k}:wgmma:d{d}": nfa for k in flash3}),
                f"{what} (a) launches, routes, forms {parts}: expected "
                f"{per} a step, flash only in its d = {d} tensor-core "
                f"forms and no padded call")
        require(all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0] and report["skipped_steps"] == 0,
                f"{what} (a) losses {losses}, report {report}")
        steady = sorted(step_s[1:])[len(step_s[1:]) // 2] * 1e3
        tokens = CG_BATCH * (cfg.n_positions - 1)
        trainer.config.steps = CG_STEPS + 1
        kern = device_profile(lambda: trainer.run())
        require_flash_route(kern, "bf16", f"{what} train step")
        for kname in ("fa_fwd_kernel_wgmma", "fa_bwd_dkv_kernel_wgmma"):
            require_flash_form(kern, f"{what} train step", kname, d, False,
                               False)
        require_flash_form(kern, f"{what} train step",
                           "fa_bwd_dq_kernel_wgmma", d, False, False, False)
        busy = by_kind(kern)
        flash_ms = {k: v / 1e3 for k, v in kern.items() if "fa_" in k}

        # serving the trained weights: 8 requests on 4 slots, then the
        # served prefill logits against the trained model's forward
        prompts = [16, 256, 48, 128, 200, 32, 96, 64]
        new = 16
        eng = Engine(cfg, model, EngineConfig(num_slots=4, max_len=512,
                                              temperature=0.0), device=dev)
        rng = np.random.default_rng(seed + 3)
        sched = ServeScheduler(eng)
        for i, plen in enumerate(prompts):
            sched.submit(Request(request_id=f"{what}-{i}",
                                 tokens=rng.integers(0, cfg.vocab_size, plen)
                                 .tolist(), max_new_tokens=new))
        torch.cuda.synchronize()
        _build.reset_launches()
        stats = sched.run()
        torch.cuda.synchronize()
        serve_launches = dict(_build.launches)
        done = [r for r in stats.requests if r["state"] == "completed"
                and r["new_tokens"] == new]
        require(len(done) == len(prompts),
                f"{what} serve: {len(done)} of {len(prompts)} requests "
                f"completed: {stats.requests}")
        summ = stats.summary()
        del eng, sched
        eng = Engine(cfg, model, EngineConfig(
            num_slots=1, max_len=64, temperature=0.0,
            keep_prefill_logits=True), device=dev)
        first, _, kept = eng.prefill({0: tok[0, :32].tolist()})
        with torch.inference_mode():
            trained = model(tok_d[:1, :32])[0]
        serve_rel = ((kept[:, 0] - trained).norm() / trained.norm()).item()
        require(serve_rel <= FWD_BF16_REL_L2,
                f"{what}: served logits vs the trained forward, relative "
                f"L2 {serve_rel}")
        scale = trainer.sstate.scale.item()
        del eng, kept, trained, trainer, model
        torch.cuda.empty_cache()
        rec = dict(
            params=n, init_s=init_s, compute="bf16", batch=CG_BATCH,
            seq=cfg.n_positions, steps=CG_STEPS, lr=CG_LR, amp="dynamic",
            losses=losses, launches=parts[0], launches_per_step=per,
            forms=parts[2], step_ms=[x * 1e3 for x in step_s],
            steady_step_ms=steady, tokens_per_step=tokens,
            tokens_per_s=tokens / steady * 1e3, step_device_busy_ms=busy,
            idle_share=1 - busy["total"] / steady, step_flash_ms=flash_ms,
            max_memory_allocated=peak, allocated_before=before,
            peak_bytes_per_param=(peak - before) / n,
            reckoned_bytes_before_activations=reckoned, loss_scale=scale,
            serve=dict(num_slots=4, max_len=512, requests=len(prompts),
                       prompt_lens=prompts, new_tokens=new,
                       launches=serve_launches,
                       decode_tokens_per_s=summ["tokens_per_s"],
                       p50_step_ms=summ["p50_step_ms"],
                       ttft_p50_ms=summ["ttft_p50_ms"],
                       wall_s=summ["wall_s"],
                       served_vs_trained_rel_l2=serve_rel,
                       tol=FWD_BF16_REL_L2, first_token=int(first[0])))
        return rec, parts[0], parts[2], tok

    def cg_grads(cfgx, params, where, tokens):
        """(loss, {name: fp32 gradient on the CPU}) of one lm_loss
        backward of a GPT-2 holding ``params`` on ``where``."""
        m = GPT2.from_params(cfgx, params, device=where)
        loss = lm_loss(m, tokens.to(where))
        loss.backward()
        return loss.item(), {n: p.grad.detach().float().cpu()
                             for n, p in m.named_parameters()}

    def cg_check(cfgx, params, dts, what, d, tokens, form_parts):
        """The card's loss and gradients in each of ``dts`` against the
        CPU's in fp32 (the plain versions): the worst parameter's relative
        L2, held to CG_GRAD_REL_L2 of the dtype; the flash forms each card
        run launched (the compiled width's, padded where d is not
        compiled), appended to ``form_parts``."""
        tokens = tokens[:1, :CG_CHECK_SEQ]
        kd = fa_kernel_head_dim(d)
        cpu_loss, cpu_g = cg_grads(dataclasses.replace(
            cfgx, compute_dtype=tdt["fp32"]), params, "cpu", tokens)
        out = {}
        for dt in dts:
            cx = dataclasses.replace(cfgx, compute_dtype=tdt[dt])
            _build.reset_launches()
            loss, got = cg_grads(cx, params, dev, tokens)
            torch.cuda.synchronize()
            forms = dict(_build.form_launches)
            want = {f"{k}:{fa_route_of(k, dt, kd)}:d{kd}": cfgx.n_layer
                    for k in flash3}
            if d != kd:
                want.update({f"{k}:{fa_route_of(k, dt, kd)}:pad{d}":
                             cfgx.n_layer for k in flash3})
            require(forms == want, f"{what} {dt}: forms {forms}, expected "
                                   f"{want}")
            worst, wname = worst_rel(got, cpu_g)
            tol = CG_GRAD_REL_L2[dt]
            require(worst <= tol and abs(loss - cpu_loss) <= tol * abs(
                cpu_loss), f"{what} {dt} card vs fp32 CPU: loss {loss} vs "
                           f"{cpu_loss}, {wname} gradient relative L2 "
                           f"{worst} (tolerance {tol})")
            out[dt] = dict(loss=loss, cpu_loss=cpu_loss, worst_rel_l2=worst,
                           worst_param=wname, tol=tol, forms=forms)
            form_parts.append(forms)
            torch.cuda.empty_cache()
        return out

    def width_forms(what, embd, heads, d, form_parts, rope=False):
        """(d): the dropout and dlogits forms of all six kernels at head
        width d (embd = heads x d) on the main path. (d1) SelfMultiheadAttn
        at these widths (RoPE with ``rope``) with dropout_p = 0.1, bf16,
        CG_STEPS flat FusedAdam steps with a new device seed each: each
        flash kernel's dropout form a step. (d2) a learned (1, heads, s,
        s) fp32 attention bias trained through flash_attention(bias=...)
        on bf16 q, k, v: the dq kernel's dlogits form a step. (d3) fp32
        EncdecMultiheadAttn with dropout_p = 0.1, a key-padding mask and a
        seed, card vs CPU: the FMA kernels' dropout forms. (d4) an fp32
        learned bias through flash_attention against autograd of the
        unfused function: the FMA dq kernel's dlogits form. Appends each
        part's forms to ``form_parts``; returns the record."""
        w = f"d{d}"
        s_len = CG_CTX
        fgen = torch.Generator().manual_seed(d + 4)
        torch.manual_seed(7)
        fmod = SelfMultiheadAttn(embd, heads, causal=True, use_rope=rope,
                                 dropout_p=FA_DROP_RATE, device=dev)
        fx = torch.randn(CG_BATCH, s_len, embd, generator=fgen) \
            .to(dev, torch.bfloat16)
        ftarget = torch.randn(CG_BATCH, s_len, embd, generator=fgen).to(dev)
        fseeds = torch.arange(CG_STEPS, dtype=torch.int32,
                              device=dev) * 31 + 7

        def dropout_loss(model, x, target, seed):
            return ((model(x, dropout_seed=seed).float() - target) ** 2) \
                .mean()

        _, _, fstep = scaled_trainer(
            fmod, lambda named: FusedAdam(named, lr=MEGATRON_LR,
                                          use_flat=True),
            dev, dropout_loss)
        flosses = []
        _build.reset_launches()
        for i in range(CG_STEPS):
            flosses.append(float(fstep(fx, ftarget, fseeds[i])))
        torch.cuda.synchronize()
        fparts = dict(_build.form_launches)
        require(fparts == {f"{k}:wgmma:{w}{f}": CG_STEPS for k in flash3
                           for f in ("", ":dropout")}
                and all(math.isfinite(x) for x in flosses)
                and flosses[-1] < flosses[0],
                f"{what} (d1) forms {fparts}, losses {flosses}")
        form_parts.append(fparts)
        del fmod, fx, ftarget, fstep

        class LearnedBias(torch.nn.Module):
            def __init__(self, sq):
                super().__init__()
                self.bias = torch.nn.Parameter(torch.zeros(
                    1, heads, sq, sq, device=dev))

        def bias_loss(model, q, k, v, target):
            o = flash_attention(q, k, v, True, bias=model.bias)
            return ((o.float() - target) ** 2).mean()

        table = LearnedBias(s_len)
        bq = [torch.randn(CG_BATCH, heads, s_len, d, device=dev,
                          generator=gen) for _ in range(4)]
        _, _, tstep = scaled_trainer(
            table, lambda named: FusedAdam(named, lr=BIAS_LR, use_flat=True),
            dev, bias_loss)
        bf_q = [t.to(torch.bfloat16) for t in bq[:3]]
        tlosses = []
        _build.reset_launches()
        for _ in range(CG_STEPS):
            tlosses.append(float(tstep(*bf_q, bq[3])))
        torch.cuda.synchronize()
        tparts = dict(_build.form_launches)
        require(tparts == {**{f"{k}:wgmma:{w}": CG_STEPS for k in flash3},
                           f"fa_bwd_dq:wgmma:{w}:dbias": CG_STEPS}
                and all(math.isfinite(x) for x in tlosses)
                and tlosses[-1] < tlosses[0],
                f"{what} (d2) forms {tparts}, losses {tlosses}")
        form_parts.append(tparts)
        del table, bq, bf_q, tstep
        torch.cuda.empty_cache()

        torch.manual_seed(8)
        gmod = EncdecMultiheadAttn(embd, heads, dropout_p=FA_DROP_RATE,
                                   device=dev)
        gcpu = EncdecMultiheadAttn(embd, heads, dropout_p=FA_DROP_RATE,
                                   device="cpu")
        gcpu.load_state_dict({k: v.cpu()
                              for k, v in gmod.state_dict().items()})
        gq = torch.randn(CG_BATCH, CG_FORM_SEQ, embd, generator=fgen)
        gkv = torch.randn(CG_BATCH, CG_FORM_SEQ // 2, embd, generator=fgen)
        gr = torch.randn(CG_BATCH, CG_FORM_SEQ, embd, generator=fgen)
        gmask = key_padding([CG_FORM_SEQ // 2, 77], CG_FORM_SEQ // 2)
        _build.reset_launches()
        yg_card, gg_card = out_and_grads(
            lambda *a: gmod(*a, dropout_seed=torch.tensor(
                13, dtype=torch.int32, device=dev)), gmod, gr.to(dev),
            gq.to(dev), gkv.to(dev), gmask)
        torch.cuda.synchronize()
        gparts = dict(_build.form_launches)
        yg_cpu, gg_cpu = out_and_grads(
            lambda *a: gcpu(*a, dropout_seed=13), gcpu, gr, gq, gkv,
            gmask.cpu())
        enc_out = rel(yg_card.cpu(), yg_cpu)
        enc_grad, enc_name = worst_rel(
            {n: g.cpu() for n, g in gg_card.items()}, gg_cpu)
        require(gparts == {f"{k}:{fa_route_of(k, 'fp32', d)}:{w}{f}": 1
                           for k in flash3 for f in ("", ":dropout")}
                and enc_out <= MEGATRON_REL_L2
                and enc_grad <= MEGATRON_REL_L2,
                f"{what} (d3) forms {gparts}; EncdecMultiheadAttn with "
                f"dropout card vs CPU (fp32): output {enc_out}, {enc_name} "
                f"gradient {enc_grad}")
        form_parts.append(gparts)
        del gmod, gcpu, yg_card, gg_card, yg_cpu, gg_cpu

        bias32 = torch.randn(1, heads, CG_FORM_SEQ, CG_FORM_SEQ, device=dev,
                             generator=gen).requires_grad_(True)
        cq = [torch.randn(CG_BATCH, heads, CG_FORM_SEQ, d, device=dev,
                          generator=gen) for _ in range(4)]
        fa_in = [t.clone().requires_grad_(True) for t in cq[:3]]
        ref_in = [t.clone().requires_grad_(True) for t in cq[:3]]
        _build.reset_launches()
        o_fa = flash_attention(*fa_in, True, bias=bias32)
        o_fa.backward(cq[3])
        torch.cuda.synchronize()
        bparts = dict(_build.form_launches)
        fa_dbias = bias32.grad.clone()
        bias32.grad = None
        scores = torch.matmul(ref_in[0], ref_in[1].transpose(-1, -2)) \
            * d ** -0.5 + bias32
        scores = scores.masked_fill(torch.ones(
            CG_FORM_SEQ, CG_FORM_SEQ, dtype=torch.bool, device=dev).triu(1),
            NEG_INF)
        o_ref = torch.matmul(torch.softmax(scores, dim=-1), ref_in[2])
        o_ref.backward(cq[3])
        torch.cuda.synchronize()
        ok_o, err_o = close(o_fa.detach(), o_ref.detach(), *FA_TOL["fp32"])
        berrs = [close(a.grad, b.grad, *FA_BWD_TOL["fp32"])
                 for a, b in zip(fa_in, ref_in)]
        berrs.append(close(fa_dbias, bias32.grad, *FA_BWD_TOL["fp32"]))
        require(ok_o and all(ok for ok, _ in berrs)
                and bparts == {**{f"{k}:{fa_route_of(k, 'fp32', d)}:{w}": 1
                                  for k in flash3},
                               f"fa_bwd_dq:fma:{w}:dbias": 1},
                f"{what} (d4) learned bias (fp32) vs autograd: o err "
                f"{err_o}, dq / dk / dv / dbias errs "
                f"{[e for _, e in berrs]}; forms {bparts}")
        form_parts.append(bparts)
        del bias32, cq, fa_in, ref_in, o_fa, o_ref, scores, fa_dbias
        torch.cuda.empty_cache()
        return dict(forms_d1_dropout=fparts, d1_losses=flosses,
                    d1_rope=rope, forms_d2_dbias=tparts, d2_losses=tlosses,
                    forms_d3_fp32_dropout=gparts, d3_out_rel_l2=enc_out,
                    d3_grad_rel_l2=enc_grad, forms_d4_fp32_dbias=bparts,
                    d4_errs=[err_o] + [e for _, e in berrs])

    def width_phase_done(name, form_parts, train_launches):
        """The phase's forms into the main path's tallies; its launches of
        the kernels other than flash (whose d = 64 rows keep their meaning:
        this phase's flash launches are its width's rows) into
        ``main_launches``; returns those."""
        forms = collections.Counter()
        for part in form_parts:
            forms.update(part)
        main_forms.update(forms)
        form_phases[name] = forms
        others = {k: v for k, v in train_launches.items()
                  if not k.startswith("fa_")}
        for k, n in others.items():
            main_launches[k] = main_launches.get(k, 0) + n
        return others

    cg_cfg = GPT2Config(vocab_size=XL_VOCAB, n_positions=CG_CTX,
                        n_embd=CG_EMBD, n_layer=CG_LAYERS, n_head=CG_HEADS)
    cg_rec, cg_launches, cg_forms, ctok = width_train_serve(
        "cerebras", cg_cfg, 128, seed=3)
    cg_form_parts = [cg_forms]
    c2 = dataclasses.replace(cg_cfg, n_layer=CG_CHECK_LAYERS)
    check_13 = cg_check(c2, init_gpt2_params(c2, seed=5), ("fp32",),
                        "cerebras (b) 1.3B widths, 2 layers", 128, ctok,
                        cg_form_parts)
    c27 = dataclasses.replace(c2, n_embd=CG27_EMBD, n_head=CG27_HEADS)
    check_27 = cg_check(c27, init_gpt2_params(c27, seed=6),
                        ("bf16", "fp32"),
                        "cerebras (c) 2.7B widths, 2 layers", 80, ctok,
                        cg_form_parts)
    cg_d = width_forms("cerebras", CG_EMBD, CG_HEADS, 128, cg_form_parts)
    cerebras_launches = width_phase_done("cerebras", cg_form_parts,
                                         cg_launches)
    emit("cerebras", config="Cerebras-GPT 1.3B (GPT2Config n_embd 2048, "
         "n_layer 24, n_head 16, n_positions 2048; d = 128)",
         source="huggingface.co/cerebras/Cerebras-GPT-1.3B config.json; "
         "arXiv 2304.03208 Table 1", **cg_rec, check_13b_fp32=check_13,
         check_27b=check_27, **cg_d, card=card)

    # gptj: GPT-J 6B's widths, 8 of its 28 layers
    gj_cfg = GPT2Config(vocab_size=GJ_VOCAB, n_positions=GJ_CTX,
                        n_embd=GJ_EMBD, n_layer=GJ_LAYERS, n_head=GJ_HEADS)
    gj_rec, gj_launches, gj_forms, gtok = width_train_serve(
        "gptj", gj_cfg, 256, seed=11)
    gj_form_parts = [gj_forms]
    g2 = dataclasses.replace(gj_cfg, n_layer=CG_CHECK_LAYERS)
    check_gj = cg_check(g2, init_gpt2_params(g2, seed=13), ("fp32",),
                        "gptj (b) GPT-J widths, 2 layers", 256, gtok,
                        gj_form_parts)

    def nemo_case(dt):
        """(c) the padded route at Nemotron-4 340B's head dim 192: the
        public op forward and backward (causal, the default scale) against
        the plain versions on the kernels' o and lse, at FA_TOL /
        FA_BWD_TOL; the kernels' device ms beside the pad, slice and D
        copies'."""
        q, k, v, do = (torch.randn(1, NEMO_HEADS, GJ_CTX, NEMO_D,
                                   device=dev, generator=gen).to(tdt[dt])
                       for _ in range(4))
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        _build.reset_launches()
        o = flash_attention(*ins, True)
        o.backward(do)
        torch.cuda.synchronize()
        parts = dict(_build.form_launches)
        require(parts == {f"{n}:{fa_route_of(n, dt, 256)}:{f}": 1
                          for n in flash3 for f in ("d256", f"pad{NEMO_D}")},
                f"gptj (c) d = {NEMO_D} {dt}: forms {parts}")
        gj_form_parts.append(parts)
        kw = dict(scale=NEMO_D ** -0.5, causal=True)
        ok_, lse_ = flash_attention_fwd(q, k, v, **kw)
        op, _ = flash_attention_fwd_plain(q, k, v, **kw)
        want = flash_attention_bwd_plain(q, k, v, ok_, lse_, do, **kw)
        ok_o, err_o = close(o.detach(), op, *FA_TOL[dt])
        gerrs = [close(t.grad, w_, *FA_BWD_TOL[dt])
                 for t, w_ in zip(ins, want)]
        require(ok_o and all(ok for ok, _ in gerrs),
                f"gptj (c) d = {NEMO_D} {dt}: o err {err_o}, dq / dk / dv "
                f"errs {[e for _, e in gerrs]}")

        def fwd_bwd(q, k, v, do):
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
            flash_attention(qq, kk, vv, True).backward(do)

        kern = device_kernels(fwd_bwd, [(q, k, v, do)], 10)
        kernel_ms = {n: sum(t for key, t in kern.items()
                            if f"{n}_kernel" in key) for n in flash3}
        return dict(b=1, h=NEMO_HEADS, sq=GJ_CTX, sk=GJ_CTX, d=NEMO_D,
                    causal=True, o_err=err_o,
                    grad_errs=[e for _, e in gerrs], forms=parts,
                    kernel_ms=kernel_ms,
                    outside_ms=sum(kern.values()) - sum(kernel_ms.values()),
                    fwd_bwd_ms=sum(kern.values()))

    nemo = {dt: nemo_case(dt) for dt in ("bf16", "fp32")}
    torch.cuda.empty_cache()
    gj_d = width_forms("gptj", GJ_EMBD, GJ_HEADS, 256, gj_form_parts,
                       rope=True)
    gptj_launches = width_phase_done("gptj", gj_form_parts, gj_launches)
    emit("gptj", config="the GPT-2 architecture at GPT-J 6B's widths "
         "(GPT2Config n_embd 4096, n_head 16, n_positions 2048, vocab "
         "50400; d = 256), 8 of its 28 layers",
         source="huggingface.co/EleutherAI/gpt-j-6b config.json; Wang & "
         "Komatsuzaki 2021 (mesh-transformer-jax)",
         cut="depth 28 -> 8 layers (memory: 20 bytes a parameter, 117 GB "
         "at 28); GPT-J's parallel "
         "residual, rotary embedding on 64 of 256 channels and untied LM "
         "head are not in the GPT-2 architecture", **gj_rec, check_fp32=check_gj,
         padded_d192=nemo, **gj_d, card=card)

    def by_route(name):
        """``{route: {path: launches}}`` of a flash wrapper on the main
        paths (the bf16 runs take the tensor-core kernels, the fp32 runs
        the FMA-pipe ones)."""
        out = {}
        for path, routes in path_routes.items():
            for key, n in routes.items():
                wrapper, route = key.split(":")
                if wrapper == name:
                    out.setdefault(route, {})[path] = n
        return out

    kernels = []
    for name, (src, tpu, calls) in KERNELS.items():
        rec = summary[name]
        require(main_launches.get(name, 0) > 0,
                f"{name} was not launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "pallas_call": [f"{tpu.split(':')[0]}:{c}" for c in calls],
            "launches": main_launches[name],
            "launches_forward": fwd_launches.get(name, 0),
            "launches_serve": serve_launches.get(name, 0),
            "launches_train": train_launches.get(name, 0),
            "launches_bert": bert_launches.get(name, 0),
            "launches_resnet": resnet_launches.get(name, 0),
            "launches_unet": unet_launches.get(name, 0),
            "launches_megatron": megatron_launches.get(name, 0),
            "launches_ring": ring_launches.get(name, 0),
            "launches_halo": halo_launches.get(name, 0),
            "launches_cerebras": cerebras_launches.get(name, 0),
            "launches_gptj": gptj_launches.get(name, 0),
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "call_ms": rec["call_ms"],
            **({"setup": rec["setup"]} if "setup" in rec else {}),
            **({"launches_by_route": by_route(name)}
               if name.startswith("fa_") else {}),
            **{k: rec[k] for k in ("tflops", "bound_share") if k in rec},
            "shape": {k: rec[k] for k in (
                "form", "rows", "hidden", "b", "h", "sq", "sk", "causal",
                "mask", "n", "tensors", "w", "c", "groups", "act", "algo",
                "tile", "scores", "mask_shape", "dtype", "bytes",
                "shape") if k in rec}})
    # the fp32 forward and backward pair (FMA pipes), at GPT-2's causal
    # shape (the BERT row beside), launched by the fp32 runs of the main
    # paths
    for name, (src, wrapper, twin) in FMA_KERNELS.items():
        rec, bert = summary[name], summary[name.replace("_fp32",
                                                        "_fp32_bert")]
        paths = by_route(wrapper).get("fma", {})
        launches = sum(paths.values())
        require(launches > 0, f"{name} was not launched on the main path")
        tpu, calls = KERNELS[twin][1:]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "pallas_call": [f"{tpu.split(':')[0]}:{c}" for c in calls],
            "launches": launches,
            **{f"launches_{p}": n for p, n in paths.items()},
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "call_ms": rec["call_ms"], "tflops": rec["tflops"],
            "bound_share": rec["bound_share"],
            "bert": {k: bert[k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "library_ms",
                                          "bound_share")},
            "shape": {k: rec[k] for k in ("b", "h", "sq", "sk", "causal",
                                          "dtype", "bytes")}})
    # the flash kernels' dropout and dlogits forms at GPT-2 XL's causal
    # shape, launched by megatron (e)-(g); the six kernels at head dim 128
    # in each form at Cerebras-GPT 1.3B's causal attention (2 x 16 x 2048
    # x 128), launched by the cerebras phase, each base form with the
    # padded d = 80 call (2 x 32 x 2048) beside it; at head dim 256 at
    # GPT-J 6B's (2 x 16 x 2048 x 256), launched by the gptj phase, with
    # the padded d = 192 call (1 x 8 x 2048) beside each base form
    padded_of = {"d128": "d80", "d256": "d192"}
    for name, (src, twin, route, form) in FORM_KERNELS.items():
        rec = summary[name]
        key = f"{twin}:{route}:{form}"
        launches = main_forms.get(key, 0)
        require(launches > 0, f"{name} was not launched on the main path")
        tpu, calls = KERNELS[twin][1:]
        padded = (summary.get(name.replace(f"_{form}",
                                           f"_{padded_of[form]}"))
                  if form in padded_of else None)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "pallas_call": [f"{tpu.split(':')[0]}:{c}" for c in calls],
            "form": form, "form_lines": form_lines(form),
            "launches": launches,
            **{f"launches_{ph}": c[key] for ph, c in form_phases.items()
               if c.get(key)},
            **({f"padded_{padded_of[form]}": {k: padded.get(k) for k in (
                "ms", "kernel_ms", "pad_ms", "dvec_ms", "plain_ms",
                "library_ms", "bound_ms", "bound_share")
                if k in padded}} if padded else {}),
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "call_ms": rec["call_ms"], "tflops": rec["tflops"],
            "bound_share": rec["bound_share"],
            **{k: rec[k] for k in ("bound_fma_ms", "bound_fma_share")
               if k in rec},
            **({"library_fwd_bwd_ms": rec["library_fwd_bwd_ms"],
                "fwd_bwd_ms": rec["fwd_bwd_ms"]}
               if "fwd_bwd_ms" in rec else {}),
            **{k: rec[k] for k in ("dbias_err", "dbias_tol", "dl_typical",
                                   "dl_max") if k in rec},
            "shape": {k: rec[k] for k in ("b", "h", "sq", "sk", "d",
                                          "causal", "dtype", "bytes")}})
    emit("profiler", **PROFILE_PASSES)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] in ("remote-copy", "ring",
                                              "flash-fwd", "flash-bwd",
                                              "softmax", "norm", "ptxas"):
        sys.exit(mode_main(sys.argv[1], sys.argv[2] if len(sys.argv) > 2
                           else ROOT))
    sys.exit(main())
