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

import dataclasses
import math

# LayerNorm (csrc/layer_norm.cu), two compile-time forms chosen by width:
# - up to LN_SMEM_MAX_HIDDEN: one warp per row, LN_WARPS_PER_BLOCK rows per
#   block, each row staged as fp32 in dynamic shared memory (4 warps x 8192
#   x 4 bytes = 128 KB, inside the 227 KB a Hopper block may use);
# - above it: one block of LN_WIDE_WARPS warps per row, nothing staged: the
#   forward reads the row three times, the backward x and dy twice, each
#   read after the first from L2 while a row fits there. Any width up to
#   LN_MAX_HIDDEN, the bound of the kernels' int32 column index (the JAX
#   package sends rows above 65536 to its plain reference; the port's
#   kernels need no such cut).
LN_WARPS_PER_BLOCK = 4
LN_SMEM_MAX_HIDDEN = 8192
LN_MAX_HIDDEN = 2 ** 30
LN_WIDE_WARPS = 16

# LayerNorm backward (csrc/layer_norm.cu), three forms chosen by
# ln_bwd_geometry, each writing one row of dgamma / dbeta partial sums a
# block that a second launch adds up (blocks of LN_REDUCE_THREADS threads
# over ln_reduce_cols columns each, the partial rows split over the rest
# of the threads in a fixed order):
# - "reg": one warp per row, each lane holding its `vectors` 16-byte
#   vectors of x and dy in registers (at most LN_REG_LANE_VALUES values a
#   lane: 4 bf16 or 8 fp32 vectors, rows up to 1024 columns) and its
#   columns' running dgamma / dbeta sums across every row its warp takes.
#   Blocks of LN_REG_WARPS warps, LN_REG_BLOCKS_PER_SM of them on each of
#   LN_SMS SMs at most (the persistent grid). Only rows whose width is a
#   whole number of vectors, from 16-byte aligned dy, x and gamma (read
#   as vectors too), take it.
# - "smem": one warp per row; each warp stages xhat and dy of its row and
#   keeps running dgamma / dbeta sums, four fp32 rows of `hidden` in
#   shared memory. Warps per block fill up to LN_BWD_SMEM_BYTES (8 warps
#   at hidden 768, 1 at 8192); at most LN_BWD_MAX_BLOCKS blocks.
# - "wide", rows above LN_SMEM_MAX_HIDDEN: a block of LN_WIDE_WARPS warps
#   per strided set of rows, its running sums in its partial row.
LN_BWD_FORMS = ("reg", "smem", "wide")
LN_REG_WARPS = 8
LN_REG_LANE_VALUES = 32
LN_REG_BLOCKS_PER_SM = {"bfloat16": 2, "float32": 1}
LN_SMS = 132
LN_VECTOR_BYTES = 16
LN_BWD_SMEM_BYTES = 128 * 1024
LN_BWD_MAX_WARPS = 8
LN_BWD_MAX_BLOCKS = 264
LN_REDUCE_THREADS = 256
LN_REDUCE_COLS = (8, 32)
LN_REDUCE_WIDE_COLS = 4224
LN_REDUCE_FEW_ROWS = 32
_ITEMSIZE = {"bfloat16": 2, "float32": 4}


@dataclasses.dataclass(frozen=True)
class LnBwdGeometry:
    """The LayerNorm backward's launch, mirrored by the ``constexpr``
    values of ``csrc/layer_norm.cu``: its ``form`` (one of
    ``LN_BWD_FORMS``), the 16-byte ``vectors`` of a row each lane holds
    (the "reg" form; 0 otherwise), ``warps`` a block and ``blocks``, each
    block one row of the (blocks, hidden) partial sums."""
    form: str
    vectors: int
    warps: int
    blocks: int

    @property
    def form_id(self) -> int:
        """The form as the C entry takes it."""
        return LN_BWD_FORMS.index(self.form)


def ln_reduce_cols(hidden: int, nblk: int) -> int:
    """Columns a block of the dgamma / dbeta reduce launch takes over
    ``nblk`` partial rows of ``hidden``: 8 (one 32-byte sector of each
    partial row, so a short row's sum spreads over many blocks) where the
    partial rows are more than LN_REDUCE_FEW_ROWS and the row is shorter
    than LN_REDUCE_WIDE_COLS (32 SMs' worth of 32-column blocks), else 32
    (fewer, larger blocks)."""
    narrow, wide = LN_REDUCE_COLS
    if nblk > LN_REDUCE_FEW_ROWS and hidden < LN_REDUCE_WIDE_COLS:
        return narrow
    return wide


def ln_bwd_geometry(rows: int, hidden: int, dtype: str = "bfloat16",
                    aligned: bool = True) -> LnBwdGeometry:
    """The LayerNorm backward's geometry for ``rows`` x ``hidden`` of
    ``dtype`` ("bfloat16" or "float32"); ``aligned``: dy, x and gamma
    (where there is one) start on a 16-byte boundary. The "reg" form
    takes every width up to ``32 * LN_REG_LANE_VALUES`` that is a whole
    number of 16-byte vectors from aligned tensors; other rows up to
    ``LN_SMEM_MAX_HIDDEN`` take the "smem" form, wider ones "wide"."""
    vec = LN_VECTOR_BYTES // _ITEMSIZE[dtype]
    if aligned and hidden % vec == 0 \
            and hidden <= 32 * LN_REG_LANE_VALUES:
        blocks = max(1, min(LN_SMS * LN_REG_BLOCKS_PER_SM[dtype],
                            -(-rows // LN_REG_WARPS)))
        return LnBwdGeometry("reg", -(-hidden // (32 * vec)), LN_REG_WARPS,
                             blocks)
    if hidden > LN_SMEM_MAX_HIDDEN:
        return LnBwdGeometry("wide", 0, LN_WIDE_WARPS,
                             max(1, min(LN_BWD_MAX_BLOCKS, rows)))
    warps = max(1, min(LN_BWD_MAX_WARPS, LN_BWD_SMEM_BYTES // (16 * hidden)))
    blocks = max(1, min(LN_BWD_MAX_BLOCKS, -(-rows // warps)))
    return LnBwdGeometry("smem", 0, warps, blocks)


# flash attention, compiled for the head widths FA_HEAD_DIMS; a call at
# any other d up to the widest is zero-padded along d to the next compiled
# width (fa_kernel_head_dim), which changes no score, lse or output. The
# fp32 forward runs the FMA kernel of csrc/flash_attention.cu at d = 64
# (fa_fma_fwd_geometry) and the split-TF32 tensor-core kernel of
# csrc/flash_fwd_tf32.cu at d = 128 and 256 (fa_tf32_fwd_geometry(d)); the
# fp32 backward (csrc/flash_attention_bwd.cu) takes fa_fma_bwd_geometry(d).
FA_HEAD_DIMS = (64, 128, 256)


def fa_kernel_head_dim(d: int):
    """The compiled head width a call at head dim ``d`` runs at: the
    smallest of FA_HEAD_DIMS at or above ``d`` (``d`` itself where it is
    compiled), or None above the widest (d > 256: no kernel)."""
    if d < 1:
        raise ValueError(f"flash attention head dim must be positive, got "
                         f"{d}")
    return next((w for w in FA_HEAD_DIMS if w >= d), None)


def _fa_check_width(head_dim: int) -> int:
    if head_dim not in FA_HEAD_DIMS:
        raise ValueError(f"the flash kernels are compiled for head dims "
                         f"{FA_HEAD_DIMS}, got {head_dim}")
    return head_dim


class _FwdBlocks:
    """The fp32 forwards' shared launch: blocks of ``block_rows`` query
    rows, ``warp_rows`` to a warp, over ``tile_rows``-key tiles whose keys
    ``key_split`` warps of a row group share, each its own part. The grid
    is ``(grid.y of fa_batch_heads_grid, query blocks, grid.z)``: x,
    dispatched first, runs over batch * heads, y over the query blocks in
    the order :meth:`order` (heaviest first)."""
    key_split = 1

    def blocks(self, sq: int) -> int:
        """Query blocks (grid.y) over ``sq`` rows."""
        return -(-sq // self.block_rows)

    def grid(self, bh: int, sq: int) -> tuple:
        """The launch's ``(grid.x, grid.y, grid.z)`` for ``bh = batch *
        heads``."""
        gy, gz = fa_batch_heads_grid(bh)
        return gy, self.blocks(sq), gz

    def order(self, sq: int) -> list:
        """The query block each grid.y index takes: the last (heaviest
        when causal) first."""
        n = self.blocks(sq)
        return [n - 1 - y for y in range(n)]

    def key_tiles(self, qb: int, sq: int, sk: int, causal: bool):
        """The key tiles query block ``qb`` visits: all of sk, or (causal)
        up to the diagonal of its last row below sq."""
        n = -(-sk // self.tile_rows)
        if causal:
            last = min((qb + 1) * self.block_rows, sq) - 1
            n = min(n, last // self.tile_rows + 1)
        return range(n)

    def warp_busy(self, qb: int, warp: int, tile: int, sq: int,
                  causal: bool, sk=None) -> bool:
        """Whether ``warp`` of query block ``qb`` runs the products of key
        tile ``tile``: some of its rows lie below sq and (causal) see some
        of its part of the tile's keys, and (given ``sk``) that part
        starts below sk. Warp w takes row group w % (block_rows /
        warp_rows) and key part w // that."""
        groups = self.block_rows // self.warp_rows
        row0 = qb * self.block_rows + warp % groups * self.warp_rows
        key0 = (tile * self.tile_rows
                + warp // groups * (self.tile_rows // self.key_split))
        return row0 < sq and (sk is None or key0 < sk) and not (
            causal and key0 > row0 + self.warp_rows - 1)


@dataclasses.dataclass(frozen=True)
class FmaFwdGeometry(_FwdBlocks):
    """The fp32 flash forward's FMA-pipe kernel at head width 64, mirrored
    by the ``constexpr`` values of ``FwdGeometry<64>`` in
    ``csrc/flash_attention.cu``. A block of ``threads`` owns
    ``block_rows`` query rows, ``warp_rows`` to a warp, ``blocks_per_sm``
    blocks an SM, and streams ``tile_rows``-row K / V tiles through
    ``stages`` shared-memory stages; every Q, K and V row is
    ``row_stride`` floats (the head dim padded to spread a quarter-warp's
    16-byte loads over distinct banks), every p strip row
    ``strip_stride`` (the tile's keys, padded the same way); a lane holds
    ``micro`` = (rows, keys) of S (its keys ``tile_rows / micro[1]``
    apart) and, in each of ``head_dim / 64`` groups of 64 d columns,
    (rows, 4 columns) of o, a warp all of a tile's keys for its rows."""
    block_rows: int = 64
    tile_rows: int = 64
    head_dim: int = 64
    threads: int = 128
    warp_rows: int = 16
    blocks_per_sm: int = 2
    stages: int = 2
    row_stride: int = 68
    strip_stride: int = 68
    micro: tuple = (8, 4)

    @property
    def smem_bytes(self) -> int:
        """Q (block rows), the p strip, K / V of each stage."""
        return 4 * (self.row_stride * (self.block_rows
                                       + 2 * self.stages * self.tile_rows)
                    + self.strip_stride * self.block_rows)

    @property
    def col_groups(self) -> int:
        """Groups of 64 d columns in a lane's o (4 columns in each)."""
        return self.head_dim // 64


_FMA_FWD = FmaFwdGeometry()


def fa_fma_fwd_geometry(head_dim: int = 64) -> FmaFwdGeometry:
    """The geometry of the fp32 flash forward's FMA kernel, which runs at
    head width 64 only (fp32 at 128 and 256 runs the split-TF32 kernel:
    :func:`fa_tf32_fwd_geometry`)."""
    if head_dim != 64:
        raise ValueError(f"the fp32 FMA forward is compiled for head dim "
                         f"64, got {head_dim}")
    return _FMA_FWD


@dataclasses.dataclass(frozen=True)
class Tf32FwdGeometry(_FwdBlocks):
    """The fp32 flash forward's split-TF32 tensor-core kernel at head
    width 128 or 256, mirrored by the ``constexpr`` values of
    ``TfGeometry<head_dim>`` / ``Tf`` in ``csrc/flash_fwd_tf32.cu``. A
    block of :attr:`threads` owns ``block_rows`` query rows, ``warp_rows``
    (one m16n8k8 row fragment) to a warp, ``blocks_per_sm`` blocks an SM,
    and streams ``tile_rows``-key K / V tiles through ``stages``
    shared-memory stages; ``key_split`` warps share a row group, each
    taking :attr:`warp_keys` of a tile's keys with its own online softmax,
    and meet at the end through the stages (:attr:`part_bytes` a row
    group); Q and K rows are :attr:`qk_stride` floats, V
    rows :attr:`v_stride` (the head dim padded so that a quarter-warp's
    float4 fragments fall in 32 distinct banks). Lane ``(g, t) = (lane //
    4, lane % 4)``: S's accumulator holds rows g and g + 8 at keys 8j + 2t
    and 8j + 2t + 1 (:meth:`score_entries`); p.V takes a key group's keys
    in :attr:`key_order` as its k positions; Q and K take d columns in
    :meth:`depth_columns` order; o's n-tile (c, e) holds d columns 32c +
    4n + e (:meth:`out_entries`)."""
    head_dim: int
    blocks_per_sm: int
    block_rows: int = 64
    tile_rows: int = 32
    key_split: int = 1
    warp_rows: int = 16
    stages: int = 2

    @property
    def threads(self) -> int:
        return 32 * self.block_rows // self.warp_rows * self.key_split

    @property
    def warp_keys(self) -> int:
        """A warp's keys of a tile."""
        return self.tile_rows // self.key_split

    @property
    def part_bytes(self) -> int:
        """A key part's m, l and o of a row group's 32 lanes, handed to
        the group's first part at the end (0 without a split)."""
        return 0 if self.key_split == 1 else 4 * 32 * (self.head_dim // 2
                                                        + 4)

    @property
    def qk_stride(self) -> int:
        return self.head_dim + 16

    @property
    def v_stride(self) -> int:
        return self.head_dim + 4

    @property
    def smem_bytes(self) -> int:
        """Q (block rows), then K and V of each stage."""
        return 4 * (self.block_rows * self.qk_stride + self.stages
                    * self.tile_rows * (self.qk_stride + self.v_stride))

    @property
    def key_order(self) -> tuple:
        """The key (0..7 of a group of 8) at each k position of p.V's
        m16n8k8 step: key 2t at position t, 2t + 1 at t + 4, so that S's
        accumulator is p.V's A fragment as it stands."""
        return tuple(2 * kp if kp < 4 else 2 * (kp - 4) + 1
                     for kp in range(8))

    @staticmethod
    def depth_columns(step: int) -> tuple:
        """The d columns (0..15 of a group of 16) at each k position of
        the score product's two 8-deep steps (``step`` 0 or 1): lane t's
        float4 holds columns 4t .. 4t + 3, its first two at positions t and
        t + 4 of step 0, its last two of step 1."""
        return tuple(4 * (kp % 4) + 2 * step + kp // 4 for kp in range(8))

    @staticmethod
    def score_entries(lane: int, j: int):
        """The (row of the warp, key of the tile) of accumulator registers
        0..3 of S's n-tile ``j`` in ``lane``."""
        g, t = lane // 4, lane % 4
        return [(g + 8 * (e >> 1), 8 * j + 2 * t + (e & 1))
                for e in range(4)]

    @staticmethod
    def out_entries(lane: int, c: int, e: int):
        """The (row of the warp, d column) of accumulator registers 0..3
        of o's n-tile (c, e) in ``lane``."""
        g, t = lane // 4, lane % 4
        return [(g + 8 * (u >> 1), 32 * c + 4 * (2 * t + (u & 1)) + e)
                for u in range(4)]


# d = 128: Q (64 rows of 144 floats) and two stages of 32-key K (144) and V
# (132) tiles take 105 KB, two blocks (8 warps) an SM; d = 256: a lane's o
# is 128 fp32, so one block an SM, of 64 rows over 32-key tiles (Q 272-float
# rows, K 272, V 260: 201 KB) whose keys two warps of each row group share
# (8 warps: the causal grid's heaviest block holds half a 128-row block's
# work)
_TF32_FWD = {128: Tf32FwdGeometry(head_dim=128, blocks_per_sm=2),
             256: Tf32FwdGeometry(head_dim=256, blocks_per_sm=1,
                                  key_split=2)}


def fa_tf32_fwd_geometry(head_dim: int) -> Tf32FwdGeometry:
    """The geometry of the fp32 flash forward's split-TF32 kernel at a
    compiled head width of 128 or 256."""
    if _fa_check_width(head_dim) not in _TF32_FWD:
        raise ValueError(f"the split-TF32 forward is compiled for head dims "
                         f"{tuple(_TF32_FWD)}, got {head_dim}")
    return _TF32_FWD[head_dim]


@dataclasses.dataclass(frozen=True)
class FmaBwdGeometry:
    """The fp32 flash backward's two FMA-pipe kernels (dq and dk / dv) at
    one compiled head width, mirrored by the ``constexpr`` values of
    ``BwdGeometry<head_dim>`` in ``csrc/flash_attention_bwd.cu``. A block
    of ``threads`` owns ``block_rows`` rows (queries in dq, keys in dk /
    dv) and streams ``tile_rows``-row tiles (keys in dq, queries in dk /
    dv) through ``stages`` shared-memory stages; every Q, K, V and dO row
    is ``row_stride`` floats (the head dim padded to spread a
    quarter-warp's 16-byte loads over distinct banks), every p / ds strip
    row ``strip_stride`` (the tile's rows, padded the same way, or at d =
    128 and 256 by 8 floats, so that a warp's 4-byte stores of one
    partial score fall in 32 banks); a lane (ly, lx) is (lane // 8, lane %
    8): a quarter-warp shares ly; an SM holds ``blocks_per_sm`` blocks.
    With ``score_parts`` 1 (d = 64), warps go in pairs (``splits``)
    over ``4 * micro[0]`` rows: each sums its rows' scores over all of d for
    half the streamed rows, a lane ``micro`` = (rows ly + 4 i, streamed
    rows lx + 8 j) of S or dP, and holds, in each of ``col_groups`` groups
    of 32 d columns of its half of d, rows ly + 4 i by columns 4 lx .. + 3
    of each output. With ``score_parts`` P > 1 (2 at d = 128, 4 at d =
    256) the scores are split by depth and S and dP run side by side: warp
    w = (product, p) = (w // P, w % P) of the block's ``splits`` = 2 P sums
    its product (S, or dP) over all the block's rows and the tile's
    streamed rows and over part p of d, a lane ``micro`` = (rows ly + 4 i,
    streamed rows lx + 8 j); the P parts of an entry meet in shared memory
    (``2 * (score_parts - 1)`` planes of strip rows, S's and dP's) and are
    added in part order by the product's warp whose ``own_cols`` of a
    lane's streamed rows hold it (S's writes p, dP's then ds); each warp
    then holds ``head_dim / splits`` columns of each output, a lane rows ly
    + 4 i by columns 4 lx + 32 c .. + 3. The grid is ``(grid.y
    of fa_batch_heads_grid, row blocks, grid.z)``: x, dispatched first,
    runs over batch * heads, y over the row blocks in the order
    :meth:`dq_order` / :meth:`dkv_order` (heaviest first)."""
    block_rows: int = 128
    tile_rows: int = 64
    head_dim: int = 64
    threads: int = 256
    stages: int = 2
    row_stride: int = 68
    strip_stride: int = 68
    micro: tuple = (8, 4)
    splits: int = 2
    score_parts: int = 1
    blocks_per_sm: int = 1

    @property
    def dq_strips(self) -> int:
        """Strips of block rows in dq: the ds strip, or split by depth the
        partial scores' planes (the first of dP's is the strip)."""
        return 2 * (self.score_parts - 1) if self.score_parts > 1 else 1

    @property
    def dkv_strips(self) -> int:
        """In dk / dv: the p and ds strips, or the planes (the first of
        each product's are the strips)."""
        return 2 * (self.score_parts - 1) if self.score_parts > 1 else 2

    @property
    def products(self) -> int:
        """Score products that run side by side: 2 (S and dP) split by
        depth, else 1 (each warp runs both in turn)."""
        return self.splits // self.score_parts if self.score_parts > 1 else 1

    @property
    def own_cols(self) -> int:
        """Split by depth: the streamed rows of a lane's micro-tile whose
        entries its warp finishes."""
        return self.micro[1] // self.score_parts

    @property
    def dq_smem_bytes(self) -> int:
        """Q and dO (block rows), the strips, K / V of each stage."""
        return 4 * (self.row_stride * (2 * self.block_rows
                                       + 2 * self.stages * self.tile_rows)
                    + self.dq_strips * self.strip_stride * self.block_rows)

    @property
    def dkv_smem_bytes(self) -> int:
        """K and V (block rows), the strips, Q / dO and the lse / D slices
        of each stage."""
        return 4 * (self.row_stride * (2 * self.block_rows
                                       + 2 * self.stages * self.tile_rows)
                    + self.dkv_strips * self.strip_stride * self.block_rows
                    + 2 * self.stages * self.tile_rows)

    @property
    def col_groups(self) -> int:
        """Groups of 32 d columns in a lane's share of an output (4
        columns in each)."""
        return self.head_dim // (32 * self.splits)

    def blocks(self, s: int) -> int:
        """Row blocks (grid.y) over ``s`` rows."""
        return -(-s // self.block_rows)

    def dq_order(self, sq: int) -> list:
        """The query block each grid.y index of the dq kernel takes: the
        last (heaviest when causal) first."""
        n = self.blocks(sq)
        return [n - 1 - y for y in range(n)]

    def dkv_order(self, sk: int) -> list:
        """The key block each grid.y index of the dk / dv kernel takes:
        the first (heaviest when causal) first."""
        return list(range(self.blocks(sk)))

    def dq_key_tiles(self, qb: int, sq: int, sk: int, causal: bool):
        """The key tiles query block ``qb`` visits: all of sk, or (causal)
        up to the diagonal of its last row below sq."""
        n = -(-sk // self.tile_rows)
        if causal:
            last = min((qb + 1) * self.block_rows, sq) - 1
            n = min(n, last // self.tile_rows + 1)
        return range(n)

    def dkv_query_tiles(self, kb: int, sq: int, causal: bool):
        """The query tiles key block ``kb`` visits: all of sq, or (causal)
        from the tile of its first key on."""
        first = kb * self.block_rows // self.tile_rows if causal else 0
        return range(first, max(first, -(-sq // self.tile_rows)))


# d = 128: 128-row blocks of 132-float rows would not fit (the dq kernel
# 338 KB, dk / dv 407 KB); 64-row blocks of two warp pairs over 32-row
# tiles (144 KB and 154 KB) ran one block an SM, one warp a scheduler, a
# lane's score 8 x 2 (10 loads for 64 FFMAs). So a block owns 32 rows
# over 32-row tiles and the scores are split by depth over 4 warps, S's
# two and dP's two side by side: 8 x 4 a lane over half of d, two planes
# of 40-float rows for the parts, 109 KB (dq) and 109.5 KB (dk / dv), two
# blocks an SM (eight warps, two a scheduler), a lane 64 dk / dv
# accumulators. d = 256: 64-row blocks of 260-float rows would take 269 KB
# and 279 KB, and a pair's lane 256 dk / dv accumulators; blocks of 32
# rows, one group of four warps, over 32-row tiles; split by streamed
# rows, a lane's score would be 8 x 1 (9 loads for 32 FFMAs) and each
# scheduler would hold one warp, so the scores are split by depth over 8
# warps, S's four and dP's four side by side: 8 x 4 a lane over a quarter
# of d, six planes of 40-float rows for the parts, 225 KB (dq) and 225.5
# KB (dk / dv), a lane 64 dk / dv accumulators
_FMA_BWD = {64: FmaBwdGeometry(),
            128: FmaBwdGeometry(block_rows=32, tile_rows=32, head_dim=128,
                                threads=128, row_stride=132,
                                strip_stride=40, micro=(8, 4), splits=4,
                                score_parts=2, blocks_per_sm=2),
            256: FmaBwdGeometry(block_rows=32, tile_rows=32, head_dim=256,
                                threads=256, row_stride=260,
                                strip_stride=40, micro=(8, 4), splits=8,
                                score_parts=4)}


def fa_fma_bwd_geometry(head_dim: int = 64) -> FmaBwdGeometry:
    """The geometry of the fp32 flash backward's FMA kernels at a compiled
    head width."""
    return _FMA_BWD[_fa_check_width(head_dim)]


# The tensor-core kernels (bf16; csrc/flash_fwd_wgmma.cu,
# csrc/flash_bwd_dq_wgmma.cu, csrc/flash_bwd_dkv_wgmma.cu) take the
# geometry of fa_tc_fwd_geometry(d) (the forward) and fa_tc_geometry(d)
# (the backward pair), mirrored by their `Layout<d>`: two consumer
# warpgroups and a producer, a row of d columns arriving as d / 64 boxes of
# 64 columns. In the backward pair, the dq kernel streams key tiles and
# the dk / dv kernel query tiles, each with its own rows and stages. TMA reads each tensor from a base address aligned to
# FA_TC_ALIGN bytes.
FA_TC_ALIGN = 16
FA_TC_TILE_ROWS = 64


@dataclasses.dataclass(frozen=True)
class TcFwdGeometry:
    """The bf16 tensor-core forward's block at one compiled head width,
    mirrored by ``Layout<head_dim>`` in ``csrc/flash_fwd_wgmma.cu``: 128
    query rows, 64 a consumer warpgroup, each holding all ``head_dim``
    columns of o; K / V tiles of ``tile_rows`` keys stream through
    ``stages`` stages; with ``two_pass`` a first pass over the keys (K
    alone) takes each row's exact max and a second the output. Each of the
    8 consumer warps has a re-sum scratch of ``fix_bytes``: a value slot
    per (S element, lane), with one pass a second for p, and a 2-byte list
    entry."""
    head_dim: int
    tile_rows: int
    stages: int
    two_pass: bool
    block_rows: int = 128

    @property
    def cols(self) -> int:
        """Columns of o a consumer warpgroup holds (all of them)."""
        return self.head_dim

    @property
    def passes(self) -> int:
        return 2 if self.two_pass else 1

    @property
    def fix_bytes(self) -> int:
        slots = 32 * self.tile_rows // 2
        return slots * (4 * (1 if self.two_pass else 2) + 2)

    @property
    def smem_bytes(self) -> int:
        """Q, the K / V stages, each stage's two K norms, the re-sum
        scratch, the barriers and the 1 KB of alignment."""
        tile = self.tile_rows * self.head_dim * 2
        return (self.block_rows * self.head_dim * 2
                + self.stages * (2 * tile + 8) + 8 * self.fix_bytes
                + (3 * self.stages + 1) * 8 + 1024)

    def blocks(self, s: int) -> int:
        """Blocks (grid.x) over ``s`` query rows."""
        return -(-s // self.block_rows)


# d = 256: a warpgroup's 64 rows of o are 128 fp32 a thread, so S takes
# 32-key tiles (16 fp32 a thread) and Q's 64 KB leave room for four
# stages; d = 128: three stages beside the scratch of one pass
_TC_FWD = {64: TcFwdGeometry(64, tile_rows=64, stages=4, two_pass=False),
           128: TcFwdGeometry(128, tile_rows=64, stages=3, two_pass=False),
           256: TcFwdGeometry(256, tile_rows=32, stages=4, two_pass=True)}


def fa_tc_fwd_geometry(head_dim: int = 64) -> TcFwdGeometry:
    """The geometry of the bf16 tensor-core flash forward at a compiled
    head width."""
    return _TC_FWD[_fa_check_width(head_dim)]


@dataclasses.dataclass(frozen=True)
class TcGeometry:
    """The tensor-core backward pair's blocks at one compiled head width,
    mirrored by ``Layout<head_dim>`` in each source. dq: a block owns 128
    query rows, a 64-row slab a consumer warpgroup holding all
    ``head_dim`` columns of its dq, over K / V tiles of ``dq_tile_rows``
    keys in ``dq_stages`` stages. dk / dv: a block owns ``dkv_slabs``
    64-key slabs, one a consumer warpgroup holding dk and dv, or
    (``dkv_slabs`` 1, d = 256) one slab that both warpgroups take, the
    one computing S^T, p and dv, the other dP^T, ds and dk, p crossing
    between them through two buffers of ``exchange_bytes`` (64 keys x 64
    queries of fp32); 64-query tiles stream through ``dkv_stages``
    stages. Each product of the backward runs once a block, and each
    warpgroup holds all ``head_dim`` columns of the outputs it
    accumulates."""
    head_dim: int
    dq_tile_rows: int
    dq_stages: int
    dkv_slabs: int
    dkv_stages: int

    dq_block_rows = 128
    dkv_tile_rows = FA_TC_TILE_ROWS

    @property
    def cols(self) -> int:
        """Columns of each output a consumer warpgroup holds (all of them:
        d / 2 fp32 a thread an output)."""
        return self.head_dim

    @property
    def dkv_block_rows(self) -> int:
        return 64 * self.dkv_slabs

    @property
    def exchange_bytes(self) -> int:
        """One exchange buffer (64 keys x 64 queries of fp32 p); 0 where
        each warpgroup computes its own p."""
        return 64 * self.dkv_tile_rows * 4 if self.dkv_slabs == 1 else 0

    def _tile(self, rows: int) -> int:
        return rows * self.head_dim * 2

    @property
    def dq_smem_bytes(self) -> int:
        """Q and dO, the K / V stages, the barriers (full and empty a
        stage, the resident rows', a sink for the release before a
        warpgroup's first tile), the alignment."""
        return (2 * self._tile(self.dq_block_rows)
                + self.dq_stages * 2 * self._tile(self.dq_tile_rows)
                + (2 * self.dq_stages + 2) * 8 + 1024)

    @property
    def dkv_smem_bytes(self) -> int:
        """K and V, the Q / dO stages, two exchange buffers, the stages'
        l2 / D slices, the barriers (full and empty a stage, K / V's), the
        alignment."""
        return (2 * self._tile(self.dkv_block_rows)
                + self.dkv_stages * 2 * self._tile(self.dkv_tile_rows)
                + 2 * self.exchange_bytes
                + self.dkv_stages * 2 * self.dkv_tile_rows * 4
                + (2 * self.dkv_stages + 1) * 8 + 1024)

    def dq_blocks(self, sq: int) -> int:
        """dq blocks (grid.x) over ``sq`` query rows."""
        return -(-sq // self.dq_block_rows)

    def dkv_blocks(self, sk: int) -> int:
        """dk / dv blocks (grid.x) over ``sk`` keys."""
        return -(-sk // self.dkv_block_rows)


# d = 256: a dq warpgroup's 256 columns are 128 fp32 a thread, so its key
# tiles are 32 keys (S and dP 16 fp32 a thread) beside 128 rows of Q and
# dO (128 KB) in three stages; dk and dv over 256 columns would be 256 fp32
# a thread, and 128 keys of K and V (128 KB) beside two stages would not
# fit: one 64-key slab, a warpgroup an output, p exchanged
_TC = {64: TcGeometry(64, dq_tile_rows=64, dq_stages=4, dkv_slabs=2,
                      dkv_stages=4),
       128: TcGeometry(128, dq_tile_rows=64, dq_stages=4, dkv_slabs=2,
                       dkv_stages=4),
       256: TcGeometry(256, dq_tile_rows=32, dq_stages=3, dkv_slabs=1,
                       dkv_stages=2)}


def fa_tc_geometry(head_dim: int = 64) -> TcGeometry:
    """The geometry of the bf16 tensor-core flash backward pair at a
    compiled head width."""
    return _TC[_fa_check_width(head_dim)]


def fa_route(dtype_name: str) -> str:
    """Which backward kernels a CUDA flash call runs, by the dtype of q, k
    and v: ``"wgmma"`` (the tensor-core dq and dk / dv, bf16) or ``"fma"``
    (the FMA-pipe pair, fp32: full fp32 products). The forward's route is
    :func:`fa_fwd_route`."""
    routes = {"bfloat16": "wgmma", "float32": "fma"}
    if dtype_name not in routes:
        raise ValueError(f"flash attention takes float32 or bfloat16, got "
                         f"{dtype_name}")
    return routes[dtype_name]


def fa_fwd_route(dtype_name: str, head_dim: int) -> str:
    """Which forward kernel a CUDA flash call runs, by the dtype of q, k
    and v and the compiled head width it runs at: ``"wgmma"`` (bf16, the
    tensor-core kernel), ``"fma"`` (fp32 at d = 64, the FMA-pipe kernel,
    full fp32 products) or ``"tf32"`` (fp32 at d = 128 and 256: every
    d from 65 up, padded; split-TF32 tensor-core products, three TF32
    products a pair of split operands, within the same fp32 tolerances, as
    fp32 SDPA runs them)."""
    route = fa_route(dtype_name)
    if route == "fma" and _fa_check_width(head_dim) != 64:
        return "tf32"
    return route


def fa_tc_misaligned(ptrs: dict) -> list:
    """The names among ``{name: data pointer}`` whose address is not
    ``FA_TC_ALIGN``-byte aligned, which the tensor maps refuse."""
    return [n for n, p in ptrs.items() if p % FA_TC_ALIGN]


# grid.y and grid.z together carry batch * heads: a grid dimension above x
# holds at most FA_GRID_DIM_MAX blocks
FA_GRID_DIM_MAX = 65535


def fa_batch_heads_grid(bh: int):
    """``(grid.y, grid.z)`` over which the flash kernels spread ``bh =
    batch * heads`` (bh >= 1): flat index ``z * grid.y + y``; blocks at or
    past ``bh`` in the last z-slice return at once."""
    gy = min(bh, FA_GRID_DIM_MAX)
    gz = -(-bh // gy)
    if gz > FA_GRID_DIM_MAX:
        raise ValueError(f"batch*heads={bh} exceeds the kernels' grid "
                         f"({FA_GRID_DIM_MAX} x {FA_GRID_DIM_MAX})")
    return gy, gz


# GroupNorm (csrc/group_norm.cu); the kernels take any hw. Two-pass: one
# block per (hw tile, sample), a tile of at most GN_TILE_ELEMS pixels x
# channels unless the caller names its hw_block. One-pass, when the (sample,
# group) slab fits GN_ONE_PASS_SMEM_BYTES as fp32 (gn_one_pass_ok: the 227
# KB a Hopper block may use, less 1 KB for a block's static scratch), in
# one of three routes (gn_one_pass_geometry):
# - "cluster": a thread block cluster of `cluster` blocks takes a (sample,
#   channel slice) of `slice_c` channels, whole groups and a whole number
#   of 16-byte vectors; its blocks split the sample's pixels, `pixels`
#   each, and stage their (pixels x slice_c) tile in x's dtype in shared
#   memory, copied 16 bytes at a time. The per-group sums (the mean, then
#   the centred squares) are added across the cluster through distributed
#   shared memory. Clusters of at most GN_CLUSTER_MAX blocks (the portable
#   size), each block's shared memory within GN_ONE_PASS_SMEM_BYTES, the
#   cluster doubled while the grid holds fewer than GN_MIN_BLOCKS blocks.
#   `threads` is a multiple of the slice's vectors and of 32, so each
#   thread keeps one vector column of the tile, at most GN_CLUSTER_THREADS
#   and no more than give each thread GN_THREAD_VECTORS of the tile's
#   vectors (small tiles: smaller blocks, more of them an SM).
# - "staged": one block per (group, sample) stages the group's hw x cpg
#   values as fp32 and reads them with scalar loads; slices that cannot be
#   16-byte aligned, x not 16-byte aligned, and slabs of at most
#   GN_STAGED_MAX_SLAB values take it (there a block's few loads a thread
#   cost less than the cluster route's two block reductions and barriers).
#   The threshold keeps only small ragged cases off the cluster route,
#   such as chip_smoke.py's 2 x 16 x 16 x 64 (512 a slab), which its norm
#   mode timed about twice as fast staged on an H100; no launch of the
#   UNet stack falls under it (its smallest slab, 8 x 8 x 8 x 1280, is
#   2560 values and timed 8 % faster on the cluster route), and the cut
#   between 512 and 2560 was not timed finer.
# - "unstaged": an explicit one-pass over the gate reads x from device
#   memory in each of its passes.
GN_ONE_PASS_ROUTES = ("cluster", "staged", "unstaged")
GN_ONE_PASS_SMEM_BYTES = 227 * 1024 - 1024
GN_TILE_ELEMS = 32768
GN_CLUSTER_MAX = 8
GN_CLUSTER_THREADS = 512
GN_MIN_BLOCKS = 128
GN_THREAD_VECTORS = 4
GN_VECTOR_BYTES = 16
GN_STAGED_THREADS = 512
GN_STAGED_MAX_SLAB = 2048


def gn_one_pass_ok(hw: int, c: int, g: int) -> bool:
    """One (sample, group) slab, ``hw * (c / g)`` fp32 values, fits the
    one-pass block's shared memory. ``algo="auto"`` then takes the one-pass
    kernel, which stages the slab there: GN(32, 320) at 64 x 64 (160 KB)
    does, GN(32, 960) at 64 x 64 (480 KB) goes to the two-pass pair. An
    explicit one-pass over the gate reads x from device memory in each of
    its passes."""
    return hw * (c // g) * 4 <= GN_ONE_PASS_SMEM_BYTES


@dataclasses.dataclass(frozen=True)
class GnOnePassGeometry:
    """The one-pass GroupNorm launch, mirrored by ``csrc/group_norm.cu``:
    its ``route`` ("cluster", "staged" or "unstaged"), the channels a
    block takes (``slice_c``: whole groups), the blocks of a cluster that
    split a sample's pixels, ``pixels`` a block (the last may take fewer),
    ``threads`` a block and its dynamic shared memory (``smem_bytes``).
    The grid is (cluster, c / slice_c, n) on the "cluster" route, else
    (groups, n)."""
    route: str
    slice_c: int
    cluster: int
    pixels: int
    threads: int
    smem_bytes: int

    @property
    def route_id(self) -> int:
        """The route as the C entry takes it."""
        return GN_ONE_PASS_ROUTES.index(self.route)


def _gn_cluster_smem(pixels: int, slice_c: int, itemsize: int,
                     threads: int, cpg: int) -> int:
    """The "cluster" block's dynamic shared memory: the tile in x's dtype,
    one fp32 sum a value each thread holds (threads x vector values), and
    five fp32 words a group of the slice (its two block sums, K, the mean
    and rstd)."""
    vec = GN_VECTOR_BYTES // itemsize
    return (pixels * slice_c * itemsize
            + 4 * (threads * vec + 5 * (slice_c // cpg)))


def gn_one_pass_geometry(n: int, hw: int, c: int, groups: int,
                         dtype: str = "bfloat16",
                         aligned: bool = True) -> GnOnePassGeometry:
    """The one-pass GroupNorm's geometry for x ``(n, hw, c)`` of ``dtype``
    ("bfloat16" or "float32") in ``groups`` groups; ``aligned``: x starts
    on a 16-byte boundary. A shape over :func:`gn_one_pass_ok` takes
    "unstaged"; a slab of more than GN_STAGED_MAX_SLAB values whose slice
    of whole groups is a whole number of 16-byte vectors, from aligned x,
    "cluster" (the smallest such slice; the
    smallest cluster whose tile fits, doubled up to GN_CLUSTER_MAX while
    the grid is under GN_MIN_BLOCKS blocks and every block keeps a pixel);
    any other shape "staged", one block per (group, sample)."""
    cpg = c // groups
    if not gn_one_pass_ok(hw, c, groups):
        return GnOnePassGeometry("unstaged", cpg, 1, hw, GN_STAGED_THREADS,
                                 0)
    staged = GnOnePassGeometry("staged", cpg, 1, hw, GN_STAGED_THREADS,
                               hw * cpg * 4)
    itemsize = _ITEMSIZE[dtype]
    vec = GN_VECTOR_BYTES // itemsize
    slice_c = math.lcm(cpg, vec)
    step = math.lcm(slice_c // vec, 32)
    if (not aligned or c % slice_c or step > GN_CLUSTER_THREADS
            or hw * cpg <= GN_STAGED_MAX_SLAB):
        return staged
    nj = slice_c // vec

    def threads_for(cl):   # GN_THREAD_VECTORS of the tile's vectors each
        need = -(-(-(-hw // cl) * nj) // GN_THREAD_VECTORS)
        return min(GN_CLUSTER_THREADS // step * step, -(-need // step) * step)

    def smem(cl):
        return _gn_cluster_smem(-(-hw // cl), slice_c, itemsize,
                                threads_for(cl), cpg)

    cluster = 1
    while cluster < GN_CLUSTER_MAX and smem(cluster) > GN_ONE_PASS_SMEM_BYTES:
        cluster *= 2
    if smem(cluster) > GN_ONE_PASS_SMEM_BYTES:
        return staged
    slices = c // slice_c
    while (cluster < GN_CLUSTER_MAX and n * slices * cluster < GN_MIN_BLOCKS
           and (2 * cluster - 1) * -(-hw // (2 * cluster)) < hw):
        cluster *= 2
    pixels = -(-hw // cluster)
    return GnOnePassGeometry("cluster", slice_c, cluster, pixels,
                             threads_for(cluster), smem(cluster))


# The two-pass pair (stats, then apply) in one of two routes
# (gn_two_pass_geometry), both over gn_hw_block's tiles:
# - "vector": x 16-byte aligned and c a whole number nj of 16-byte vectors,
#   at most GN_TWO_PASS_MAX_THREADS of them. A block has `rows` pixel rows
#   of nj threads, one vector column each (rows * nj near
#   GN_TWO_PASS_THREADS, no more rows than a tile has pixels), padded to
#   whole warps; every thread issues its 16-byte loads in batches of
#   GN_STATS_UNROLL (stats) or GN_APPLY_UNROLL (apply), a batch all before
#   the first is used. An apply block takes one (sample, tile) slot; a
#   stats block takes `stats_tiles` consecutive slots, two where its grid
#   keeps GN_STATS_MIN_BLOCKS blocks (a wave of two blocks an SM), which
#   halves its block reductions, else one. The stats block's shared
#   memory holds its rows' per-channel sums of d and d^2.
# - "scalar": any other shape, one block of GN_SCALAR_THREADS per (tile,
#   sample) walking channels with 2- or 4-byte loads.
GN_TWO_PASS_ROUTES = ("vector", "scalar")
GN_TWO_PASS_THREADS = 256
GN_TWO_PASS_MAX_THREADS = 512
GN_STATS_UNROLL = 16
GN_APPLY_UNROLL = 8
GN_STATS_MIN_BLOCKS = 2 * LN_SMS
GN_SCALAR_THREADS = 256


@dataclasses.dataclass(frozen=True)
class GnTwoPassGeometry:
    """The two-pass GroupNorm launch, mirrored by ``csrc/group_norm.cu``:
    its ``route`` ("vector" or "scalar"), the HW ``tile`` (pixels a
    psum slot), and on the vector route the pixel ``rows`` of a block,
    its ``threads`` and the slots a stats block takes (``stats_tiles``;
    an apply block takes one). The scalar route's grid is (hw / tile, n)
    of GN_SCALAR_THREADS threads, one slot a block."""
    route: str
    tile: int
    rows: int
    threads: int
    stats_tiles: int

    @property
    def route_id(self) -> int:
        """The route as the C entries take it."""
        return GN_TWO_PASS_ROUTES.index(self.route)


def gn_two_pass_geometry(n: int, hw: int, c: int, groups: int,
                         dtype: str = "bfloat16", aligned: bool = True,
                         tile=None) -> GnTwoPassGeometry:
    """The two-pass GroupNorm's geometry for x ``(n, hw, c)`` of ``dtype``
    ("bfloat16" or "float32") in ``groups`` groups; ``aligned``: x (and
    y) start on a 16-byte boundary; ``tile``: the HW tile, any divisor of
    hw (the kernels' wrappers take one; ``None``: :func:`gn_hw_block`'s
    default), else ``ValueError``."""
    if tile is None:
        tile = gn_hw_block(hw, c)
    if not (isinstance(tile, int) and tile >= 1 and hw % tile == 0):
        raise ValueError(f"group_norm tile={tile!r} does not divide hw={hw}")
    vec = GN_VECTOR_BYTES // _ITEMSIZE[dtype]
    nj = c // vec
    if not aligned or c % vec or nj > GN_TWO_PASS_MAX_THREADS:
        return GnTwoPassGeometry("scalar", tile, 0, GN_SCALAR_THREADS, 1)
    rows = max(1, min(GN_TWO_PASS_THREADS // nj, tile))
    threads = -(-rows * nj // 32) * 32
    slots = n * (hw // tile)
    stats_tiles = 2 if -(-slots // 2) >= GN_STATS_MIN_BLOCKS else 1
    return GnTwoPassGeometry("vector", tile, rows, threads, stats_tiles)


def gn_hw_block(hw: int, c: int, hw_block=None) -> int:
    """The two-pass HW tile. An explicit ``hw_block`` is validated as the
    JAX package validates it (a positive multiple of 8 that divides hw,
    else ``ValueError``) and honoured; otherwise the largest divisor of hw
    with ``tile * c <= GN_TILE_ELEMS`` (at least 1)."""
    if hw_block is not None:
        if not (isinstance(hw_block, int) and hw_block >= 8
                and hw_block % 8 == 0 and hw % hw_block == 0):
            raise ValueError(
                f"group_norm hw_block={hw_block!r} invalid for hw={hw}: "
                f"must be a positive multiple of 8 that divides hw")
        return hw_block
    blk = max(1, min(hw, GN_TILE_ELEMS // c))
    while hw % blk:  # ends at 1 at the latest
        blk -= 1
    return blk


# megatron softmax (csrc/softmax.cu): the forms of each launch, chosen by
# the row length sk. Every element is fp32 in registers; a thread holds at
# most SM_PER_THREAD of a row (a multiple of the 16-byte load's 4 fp32 or
# 8 16-bit values).
# - "warp": one warp per row, SM_WARP_ROWS rows a block, rows up to
#   SM_WARP_COLS (32 lanes x SM_PER_THREAD) held in registers; the
#   forward's lanes hold SM_PER_THREAD_SHORT values for rows up to
#   SM_WARP_SHORT_COLS, so a short row's registers hold no padding
#   (softmax_per_thread);
# - "block": one block of SM_BLOCK_THREADS threads per row, rows up to
#   SM_RESIDENT_MAX_COLS held in registers (the megatron warp kernels' 16384);
# - "stream": one block of SM_BLOCK_THREADS per row at any sk: the forward
#   reads the row once for an online max and sum and once to write, the
#   backward once for sum(dy * y) and once to write.
# Rows (batch * sq) run over grid.x, which holds 2^31 - 1 blocks.
SM_PER_THREAD = 32
SM_PER_THREAD_SHORT = 16
SM_WARP_ROWS = 4
SM_WARP_COLS = 32 * SM_PER_THREAD
SM_WARP_SHORT_COLS = 32 * SM_PER_THREAD_SHORT
SM_BLOCK_THREADS = 512
SM_RESIDENT_MAX_COLS = SM_BLOCK_THREADS * SM_PER_THREAD
SM_GRID_X_MAX = 2 ** 31 - 1


def softmax_form(sk: int) -> str:
    """The form the softmax kernels take for rows of ``sk`` (>= 1)."""
    if sk <= SM_WARP_COLS:
        return "warp"
    if sk <= SM_RESIDENT_MAX_COLS:
        return "block"
    return "stream"


def softmax_per_thread(sk: int, backward: bool = False) -> int:
    """The values of a row of ``sk`` (>= 1) each thread holds: 16 in the
    forward's "warp" form up to SM_WARP_SHORT_COLS columns, else
    SM_PER_THREAD (the streaming form holds one 16-byte access at a
    time, but its grid and block are the "block" form's)."""
    if not backward and sk <= SM_WARP_SHORT_COLS:
        return SM_PER_THREAD_SHORT
    return SM_PER_THREAD


def softmax_blocks(rows: int, sk: int) -> int:
    """grid.x of a softmax launch over ``rows`` rows of ``sk``."""
    if softmax_form(sk) == "warp":
        return -(-rows // SM_WARP_ROWS)
    return rows


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
