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

# LayerNorm backward (csrc/layer_norm.cu): one warp per row; each warp
# stages xhat and dy of its row and keeps running dgamma / dbeta sums, four
# fp32 rows of `hidden` in shared memory. Warps per block fill up to
# LN_BWD_SMEM_BYTES (8 warps at hidden 768, 1 at 8192); at most
# LN_BWD_MAX_BLOCKS blocks (2 per SM of an H100), each writing one row of
# dgamma / dbeta partial sums that a second launch adds up.
LN_BWD_SMEM_BYTES = 128 * 1024
LN_BWD_MAX_WARPS = 8
LN_BWD_MAX_BLOCKS = 264


def ln_bwd_geometry(rows: int, hidden: int):
    """``(warps per block, blocks)`` of the LayerNorm backward launch."""
    warps = max(1, min(LN_BWD_MAX_WARPS, LN_BWD_SMEM_BYTES // (16 * hidden)))
    blocks = max(1, min(LN_BWD_MAX_BLOCKS, -(-rows // warps)))
    return warps, blocks


# flash attention (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu):
# 64 query rows per block (16 per warp), 64-row K/V tiles, compiled for
# head_dim 64 only; the backward's dk / dv kernel takes 64-row K/V tiles
# per block and streams 64-row Q / dO tiles.
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
