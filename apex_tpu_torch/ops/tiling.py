"""Block-size arithmetic for the port's kernels on sm_90.

Two helpers are copied from ``apex_tpu/ops/pallas/tiling.py`` because the
serving code keys on them (``pow2_ceil`` buckets prompt lengths,
``decode_attention_block`` picks the decode softmax chunk). The kernel
geometry below is the Hopper kernels' own and mirrors the constants
compiled into ``csrc/*.cu``; the wrappers check inputs against it. None
of the TPU's VMEM budgets apply here: a Hopper block has at most 227 KB
of shared memory, and registers, not a scratchpad, hold the working set.
"""

from __future__ import annotations

# LayerNorm (csrc/layer_norm.cu): one warp per row, LN_WARPS_PER_BLOCK rows
# per block, each row staged as fp32 in dynamic shared memory.
LN_WARPS_PER_BLOCK = 4
# the widest row the kernel takes: 4 warps x 8192 x 4 bytes = 128 KB of
# shared memory per block, inside the 227 KB a Hopper block may use
LN_MAX_HIDDEN = 8192

# flash attention (csrc/flash_attention.cu): 64 query rows per block
# (16 per warp), 64-row K/V tiles, compiled for head_dim 64 only.
FA_BLOCK_Q = 64
FA_BLOCK_K = 64
FA_HEAD_DIM = 64
# grid.y carries batch * heads
FA_MAX_BATCH_HEADS = 65535


def pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1) — the prompt-length bucket."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def decode_attention_block(max_len: int) -> int:
    """Serving decode-attention KV chunk (``serve.attention``): how many
    cached rows each partial softmax covers. The largest divisor of
    ``max_len`` that is <= 512; lengths with no divisor above 1 get one
    chunk of ``max_len``. Same rule as the JAX package, so the two engines
    sum their softmax partials in the same order."""
    max_len = max(int(max_len), 1)
    for blk in range(min(max_len, 512), 1, -1):
        if max_len % blk == 0:
            return blk
    return max_len
