"""The LayerNorm backward's and the one-pass GroupNorm's geometry on the CPU.

The kernels of ``apex_tpu_torch/csrc/layer_norm.cu`` and
``apex_tpu_torch/csrc/group_norm.cu`` run only on the card; what decides
their form, their lanes' columns, their grids and their shared memory is
``ln_bwd_geometry`` / ``gn_one_pass_geometry`` in ``ops/tiling.py``, held
here against brute force and the card's limits: the register form's lanes
cover a row's columns once with whole 16-byte vectors and take only
aligned rows within its limit; its blocks and shared memory fit an SM; a
GroupNorm slice holds whole groups and whole vectors; the clusters'
slices and pixel ranges tile (hw, c) once; every shape the one-pass gate
admits gets a geometry within 227 KB a block and a portable cluster; and
the sources' ``constexpr`` values match the Python mirror. The two-pass
pair's ``gn_two_pass_geometry``: its slots tile hw and the samples once,
each block's tiles whole and consecutive; on the vector route its threads'
16-byte columns cover every (pixel, channel) of a tile once, a route taken
only for aligned widths that are whole vectors; an explicit tile is
honoured and an invalid ``hw_block`` raises; threads, grid and shared
memory stay within the card's limits. No JAX: nothing here has a
counterpart there (``tests/test_torch_group_norm.py`` holds the tile rule
against the JAX package).
"""

import math
import re
from pathlib import Path

import pytest

from apex_tpu_torch.ops.tiling import (
    GN_CLUSTER_MAX, GN_CLUSTER_THREADS, GN_MIN_BLOCKS,
    GN_ONE_PASS_SMEM_BYTES, GN_SCALAR_THREADS, GN_STAGED_MAX_SLAB,
    GN_STAGED_THREADS, GN_TWO_PASS_MAX_THREADS, GN_STATS_MIN_BLOCKS,
    GN_APPLY_UNROLL, GN_STATS_UNROLL,
    GN_TWO_PASS_ROUTES, GN_TWO_PASS_THREADS, GN_VECTOR_BYTES,
    LN_BWD_MAX_BLOCKS, LN_REDUCE_COLS, LN_REDUCE_FEW_ROWS,
    LN_REDUCE_THREADS, LN_REDUCE_WIDE_COLS,
    LN_REG_BLOCKS_PER_SM, LN_REG_LANE_VALUES, LN_REG_WARPS, LN_SMEM_MAX_HIDDEN,
    LN_SMS, LN_VECTOR_BYTES, LN_WIDE_WARPS, gn_hw_block,
    gn_one_pass_geometry, gn_one_pass_ok, gn_two_pass_geometry,
    ln_bwd_geometry, ln_reduce_cols)

CSRC = Path(__file__).resolve().parent.parent / "apex_tpu_torch" / "csrc"
SMEM_LIMIT = 232448          # bytes of shared memory a Hopper block may use
SM_SMEM = 233472             # bytes of shared memory an SM holds for blocks
SM_REGS = 65536              # 32-bit registers an SM holds
SM_THREADS = 2048
ITEMSIZE = {"bfloat16": 2, "float32": 4}
DTYPES = sorted(ITEMSIZE)


def _lane_columns(geo, lane, hidden, dtype):
    """The columns a lane of the "reg" form holds: vector v of lane l is
    columns ``(v * 32 + l) * vec`` onwards, those below hidden."""
    vec = LN_VECTOR_BYTES // ITEMSIZE[dtype]
    return [c for v in range(geo.vectors)
            for c in range((v * 32 + lane) * vec, (v * 32 + lane + 1) * vec)
            if c < hidden]


def _ln_smem_bytes(geo, hidden):
    """Dynamic shared memory a block of the LayerNorm backward: the "reg"
    form's warp sums (one warp-ordered combine of dgamma, then of dbeta),
    the "smem" form's four fp32 rows a warp, none for "wide"."""
    if geo.form == "reg":
        return geo.warps * hidden * 4
    return geo.warps * 4 * hidden * 4 if geo.form == "smem" else 0


def _gn_grid(geo, n, c):
    """``(grid.x, grid.y, grid.z)`` of the one-pass GroupNorm: the
    cluster's blocks, the slices of c, the samples ("staged": groups,
    samples, 1)."""
    if geo.route == "cluster":
        return geo.cluster, c // geo.slice_c, n
    return c // geo.slice_c, n, 1


def _block_pixels(geo, rank, hw):
    """The pixels block ``rank`` of a cluster stages."""
    return range(min(rank * geo.pixels, hw),
                 min((rank + 1) * geo.pixels, hw))


def _constexprs(name):
    """``{name: value}`` of a source's integer ``constexpr``s."""
    text = (CSRC / name).read_text()
    return {m.group(1): m.group(2) for m in re.finditer(
        r"constexpr int (k\w+) = ([^;]+);", text)}


# ------------------------------------------------------------ LayerNorm

def test_ln_geometry_mirrors_the_source():
    c = _constexprs("layer_norm.cu")
    assert int(c["kRegWarps"]) == LN_REG_WARPS
    assert int(c["kRegLaneValues"]) == LN_REG_LANE_VALUES
    assert int(c["kReduceThreads"]) == LN_REDUCE_THREADS
    assert (int(c["kReduceNarrow"]), int(c["kReduceWide"])) \
        == LN_REDUCE_COLS
    assert int(c["kReduceWideCols"]) == LN_REDUCE_WIDE_COLS
    assert int(c["kReduceFewRows"]) == LN_REDUCE_FEW_ROWS
    assert int(c["kSmemMaxHidden"]) == LN_SMEM_MAX_HIDDEN
    assert int(c["kWideWarps"]) == LN_WIDE_WARPS
    text = (CSRC / "layer_norm.cu").read_text()
    # RegForm's blocks an SM by element size, as LN_REG_BLOCKS_PER_SM
    assert "kBlocksPerSM = sizeof(T) == 2 ? 2 : 1;" in text
    assert LN_REG_BLOCKS_PER_SM == {"bfloat16": 2, "float32": 1}
    assert "kFormReg = 0, kFormSmem = 1, kFormWide = 2" in text


# widths around every register-form step, its limit and the other forms'
LN_WIDTHS = sorted({1, 2, 3, 4, 7, 8, 12, 16, 96, 100, 127, 128, 129, 132,
                    255, 256, 264, 384, 512, 640, 768, 896, 1016, 1020,
                    1024, 1028, 1032, 1536, 1600, 2048, 8192, 8200, 12288})
LN_ROWS = [1, 2, 7, 8, 9, 1000, 4096, 4097, 100000]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hidden", LN_WIDTHS)
def test_ln_register_form_covers_each_column_once(hidden, dtype):
    """On the register route, lane l's vectors v hold columns (v * 32 + l)
    * vec onwards: every column of the row exactly once, in whole 16-byte
    vectors (no vector straddles the row's end), and the last vector of
    some lane is needed (no lane holds only empty vectors). The route is
    taken exactly for aligned widths that are whole vectors within 32 *
    LN_REG_LANE_VALUES columns."""
    vec = LN_VECTOR_BYTES // ITEMSIZE[dtype]
    geo = ln_bwd_geometry(4096, hidden, dtype)
    reg = hidden % vec == 0 and hidden <= 32 * LN_REG_LANE_VALUES
    assert (geo.form == "reg") == reg
    if not reg:
        assert geo.vectors == 0
        assert geo.form == ("wide" if hidden > LN_SMEM_MAX_HIDDEN
                            else "smem")
        return
    assert 1 <= geo.vectors and geo.vectors * vec <= LN_REG_LANE_VALUES
    cols = [c for lane in range(32)
            for c in _lane_columns(geo, lane, hidden, dtype)]
    assert sorted(cols) == list(range(hidden))
    assert geo.vectors * 32 * vec >= hidden > (geo.vectors - 1) * 32 * vec
    assert all(len(_lane_columns(geo, lane, hidden, dtype)) % vec == 0
               for lane in range(32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hidden", [256, 768, 1024])
def test_ln_misaligned_rows_take_the_shared_memory_form(hidden, dtype):
    assert ln_bwd_geometry(4096, hidden, dtype).form == "reg"
    assert ln_bwd_geometry(4096, hidden, dtype, aligned=False).form == "smem"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", LN_ROWS)
@pytest.mark.parametrize("hidden", [8, 768, 1024, 1600, 8192, 12288])
def test_ln_blocks_and_shared_memory_fit_the_card(rows, hidden, dtype):
    """Blocks x warps deal every row to a warp (the register and
    shared-memory forms) or a block (wide); the register form's grid is
    persistent (LN_REG_BLOCKS_PER_SM blocks on each of LN_SMS SMs at
    most), its blocks fit an SM in shared memory, registers (the 128 or
    255 a thread its launch bounds allow) and threads; the shared-memory
    form's block fits 227 KB."""
    geo = ln_bwd_geometry(rows, hidden, dtype)
    assert geo.blocks >= 1 and 1 <= geo.warps <= 32
    smem = _ln_smem_bytes(geo, hidden)
    assert smem <= SMEM_LIMIT
    if geo.form == "reg":
        per_sm = LN_REG_BLOCKS_PER_SM[dtype]
        assert geo.warps == LN_REG_WARPS
        assert geo.blocks == min(LN_SMS * per_sm, -(-rows // geo.warps))
        assert per_sm * (smem + 1024) <= SM_SMEM
        threads = 32 * geo.warps
        assert per_sm * threads <= SM_THREADS
        regs = min(255, SM_REGS // (per_sm * threads))
        assert per_sm * threads * regs <= SM_REGS
    elif geo.form == "smem":
        assert geo.blocks <= LN_BWD_MAX_BLOCKS
        assert geo.blocks * geo.warps >= min(rows, LN_BWD_MAX_BLOCKS
                                             * geo.warps)
    else:
        assert geo.warps == LN_WIDE_WARPS and smem == 0
        assert geo.blocks == min(LN_BWD_MAX_BLOCKS, rows)


@pytest.mark.parametrize("rows", [1, 5, 1000, 4097])
def test_ln_register_form_deals_every_row_to_one_warp(rows):
    """Warp w of block b takes rows b * warps + w + k * blocks * warps:
    each row exactly once."""
    geo = ln_bwd_geometry(rows, 768, "bfloat16")
    stride = geo.blocks * geo.warps
    seen = [r for b in range(geo.blocks) for w in range(geo.warps)
            for r in range(b * geo.warps + w, rows, stride)]
    assert sorted(seen) == list(range(rows))


@pytest.mark.parametrize("hidden", [1, 8, 9, 768, 1024, 1600, 4223, 4224,
                                    12288])
@pytest.mark.parametrize("nblk", [1, 8, 32, 33, 64, 264])
def test_ln_reduce_launch_covers_every_column(hidden, nblk):
    """The reduce launch: a block per ln_reduce_cols columns (8: one
    32-byte sector of each fp32 partial row; 32: a warp's), its threads'
    slices covering the partial rows once; GPT-2's and BERT's 264 partial
    rows of 768 / 1024 spread over 96 / 128 blocks."""
    cols = ln_reduce_cols(hidden, nblk)
    assert cols in LN_REDUCE_COLS and LN_REDUCE_THREADS % cols == 0
    assert cols == (8 if nblk > 32 and hidden < 4224 else 32)
    blocks = -(-hidden // cols)
    assert {b * cols + t for b in range(blocks)
            for t in range(cols)} >= set(range(hidden))
    slices = LN_REDUCE_THREADS // cols
    assert 32 % cols == 0 or cols % 32 == 0
    rows = sorted(k for s in range(slices) for k in range(s, nblk, slices))
    assert rows == list(range(nblk))
    if (hidden, nblk) in ((768, 264), (1024, 264)):
        assert blocks == hidden // 8


# ------------------------------------------------------------ GroupNorm

def test_gn_geometry_mirrors_the_source():
    c = _constexprs("group_norm.cu")
    assert int(c["kClusterMax"]) == GN_CLUSTER_MAX
    assert int(c["kClusterThreads"]) == GN_CLUSTER_THREADS
    assert int(c["kVectorBytes"]) == GN_VECTOR_BYTES
    assert int(c["kOnePassThreads"]) == GN_STAGED_THREADS
    assert c["kSmemBytes"] == "227 * 1024 - 1024"
    assert GN_ONE_PASS_SMEM_BYTES == 227 * 1024 - 1024


# the UNet stack's nine one-pass norms a step (build_unet in
# chip_smoke.py): 3 at 64 x 64 x 320, then 32 x 32 x 320 / 640, 16 x 16 x
# 640 / 1280 and 2 at 8 x 8 x 1280, batch 8
UNET_ONE_PASS = [(8, 4096, 320), (8, 4096, 320), (8, 4096, 320),
                 (8, 1024, 320), (8, 1024, 640), (8, 256, 640),
                 (8, 256, 1280), (8, 64, 1280), (8, 64, 1280)]
GN_SHAPES = sorted(set(UNET_ONE_PASS) | {
    (2, 5625, 320),     # 75 x 75 latents: a 225 KB fp32 slab
    (8, 1024, 256),     # the JAX package's AOT shape
    (1, 1, 64), (3, 1, 320), (2, 49, 96), (2, 5625, 96), (2, 7, 320),
    (1, 3969, 960), (8, 4096, 960), (2, 256, 64), (1, 262144, 128),
    (4, 1000, 32), (2, 300, 3 * 32), (1, 4096, 32 * 5), (2, 100, 32 * 7)})


def _geometries():
    for n, hw, c in GN_SHAPES:
        for dtype in DTYPES:
            yield (n, hw, c, dtype)


@pytest.mark.parametrize("n,hw,c,dtype", list(_geometries()))
def test_gn_one_pass_geometry_tiles_hw_and_c_once(n, hw, c, dtype):
    """A slice holds whole groups and whole 16-byte vectors; the slices
    cover c once; the cluster's blocks' pixel ranges cover hw once, each
    block with at least one pixel; each thread keeps one vector column
    (threads a multiple of the slice's vectors and of 32)."""
    groups = 32
    geo = gn_one_pass_geometry(n, hw, c, groups, dtype)
    cpg = c // groups
    if not gn_one_pass_ok(hw, c, groups):
        assert geo.route == "unstaged"
        return
    assert geo.slice_c % cpg == 0 and c % geo.slice_c == 0
    gx, gy, gz = _gn_grid(geo, n, c)
    if geo.route == "staged":
        assert geo.slice_c == cpg and (gx, gy) == (groups, n)
        return
    vec = GN_VECTOR_BYTES // ITEMSIZE[dtype]
    assert geo.route == "cluster"
    assert geo.slice_c % vec == 0
    assert geo.slice_c == math.lcm(cpg, vec)
    assert (gx, gy, gz) == (geo.cluster, c // geo.slice_c, n)
    chans = sorted(s * geo.slice_c + k for s in range(gy)
                   for k in range(geo.slice_c))
    assert chans == list(range(c))
    pix = [p for r in range(geo.cluster) for p in _block_pixels(geo, r, hw)]
    assert pix == list(range(hw))
    assert all(len(_block_pixels(geo, r, hw)) >= 1
               for r in range(geo.cluster))
    nj = geo.slice_c // vec
    assert geo.threads % nj == 0 and geo.threads % 32 == 0
    assert 32 <= geo.threads <= GN_CLUSTER_THREADS
    assert geo.slice_c // cpg <= geo.threads   # a thread loads each K
    rsteps = geo.threads // nj
    # thread t = (j, r0) walks pixels r0, r0 + R, ...: every (pixel,
    # vector column) of a block's tile once
    for r in range(geo.cluster):
        npx = len(_block_pixels(geo, r, hw))
        cells = sorted((p, t % nj) for t in range(geo.threads)
                       for p in range(t // nj, npx, rsteps))
        assert cells == [(p, j) for p in range(npx) for j in range(nj)]


@pytest.mark.parametrize("n,hw,c,dtype", list(_geometries()))
def test_gn_one_pass_geometry_fits_a_block_and_a_portable_cluster(
        n, hw, c, dtype):
    """Every shape the gate admits stages its tile within 227 KB a block
    (the tile in x's dtype plus the reduction scratch), in a cluster of at
    most GN_CLUSTER_MAX blocks (the portable size, no non-portable
    attribute); the cluster is the smallest that fits, doubled only while
    the grid is under GN_MIN_BLOCKS blocks."""
    groups = 32
    geo = gn_one_pass_geometry(n, hw, c, groups, dtype)
    if geo.route == "unstaged":
        return
    assert geo.smem_bytes <= GN_ONE_PASS_SMEM_BYTES <= SMEM_LIMIT
    assert 1 <= geo.cluster <= GN_CLUSTER_MAX
    assert geo.cluster & (geo.cluster - 1) == 0
    if geo.route == "staged":
        assert geo.smem_bytes == hw * (c // groups) * 4
        return
    item = ITEMSIZE[dtype]
    vec = GN_VECTOR_BYTES // item
    tile = geo.pixels * geo.slice_c * item
    assert geo.smem_bytes == tile + 4 * (
        geo.threads * vec + 5 * (geo.slice_c // (c // groups)))
    if geo.cluster > 1:
        # half the cluster: its tile would not fit, or its grid is small
        blocks_half = n * (c // geo.slice_c) * geo.cluster // 2
        tile_half = -(-hw // (geo.cluster // 2)) * geo.slice_c * item
        assert (tile_half + geo.smem_bytes - tile
                > GN_ONE_PASS_SMEM_BYTES or blocks_half < GN_MIN_BLOCKS)


def test_gn_unet_shapes_take_the_cluster_route_in_one_wave():
    """The UNet's nine one-pass norms and the AOT / 75 x 75 shapes take
    the cluster route; the 64 x 64 x 320 one fills 128 blocks of 160 KB
    tiles, one wave of one block an SM."""
    for n, hw, c in UNET_ONE_PASS + [(2, 5625, 320), (8, 1024, 256)]:
        for dtype in DTYPES:
            assert gn_one_pass_geometry(n, hw, c, 32, dtype).route \
                == "cluster"
    geo = gn_one_pass_geometry(8, 4096, 320, 32, "bfloat16")
    assert (geo.slice_c, geo.cluster, geo.pixels) == (40, 2, 2048)
    assert math.prod(_gn_grid(geo, 8, 320)) == 128
    assert geo.pixels * geo.slice_c * 2 == 160 * 1024


@pytest.mark.parametrize("dtype", DTYPES)
def test_gn_misaligned_unsliceable_or_small_shapes_take_the_staged_route(
        dtype):
    """x off a 16-byte boundary, a slice of whole groups and vectors that
    does not divide c (c = 30 in 3 groups of 10), or a slab of at most
    GN_STAGED_MAX_SLAB values (2 x 16 x 16 x 64: 512) takes the staged
    route (one block per group and sample); the smallest UNet slab (8 x 8
    x 8 x 1280: 2560) does not."""
    assert gn_one_pass_geometry(2, 256, 320, 32, dtype,
                                aligned=False).route == "staged"
    assert gn_one_pass_geometry(2, 256, 30, 3, dtype).route == "staged"
    assert gn_one_pass_geometry(2, 256, 320, 32, dtype).route == "cluster"
    assert gn_one_pass_geometry(2, 256, 64, 32, dtype).route == "staged"
    assert 256 * 2 <= GN_STAGED_MAX_SLAB < 64 * 40
    assert gn_one_pass_geometry(8, 64, 1280, 32, dtype).route == "cluster"


# ------------------------------------------------ GroupNorm, two passes

# (n, hw, c, hw_block) the pair runs: the UNet's 64 x 64 x 960, the SD VAE
# decoder's last GroupNorm, 75 x 75 latents (25-pixel tiles), the JAX
# package's AOT shape, a given tile, a ragged hw, hw = 1, and many 8-pixel
# tiles (two a stats block)
GN_TWO_PASS_SHAPES = [(8, 4096, 960, None), (1, 262144, 128, None),
                      (2, 5625, 960, None), (8, 1024, 256, None),
                      (2, 256, 64, 32), (2, 49, 64, None), (2, 1, 960, None),
                      (3, 1, 64, None), (8, 4096, 64, 8), (2, 256, 96, None)]


def _two_pass_cases():
    for n, hw, c, hwb in GN_TWO_PASS_SHAPES:
        for dtype in DTYPES:
            yield (n, hw, c, hwb, dtype)


def gn_two_pass_blocks(geo, n, hw, stats=False):
    """The grid of a launch of ``geo`` over x ``(n, hw, c)``, as
    ``csrc/group_norm.cu`` launches it: ceil(slots / slots a block), the
    stats kernel's (``stats``) or apply's (one slot a block)."""
    slots = n * (hw // geo.tile)
    return -(-slots // (geo.stats_tiles if stats else 1))


def _gn_stats_smem(geo, c):
    """The vector stats block's dynamic shared memory, as
    ``two_pass_smem`` in ``csrc/group_norm.cu`` sizes it: two fp32 sums a
    pixel row and channel."""
    return 2 * geo.rows * c * 4


def _slots_of(per, blk, slots):
    """The (sample, tile) slots block ``blk`` of the vector route takes,
    ``per`` a block."""
    return range(blk * per, min((blk + 1) * per, slots))


def _thread_cells(geo, nj, t):
    """(pixel of the tile, vector column) of every vector thread ``t``
    walks in a tile, in its order (the kernels' VecLane and
    walk_column)."""
    if t >= geo.rows * nj:
        return []
    j, r0 = t % nj, t // nj
    m = (geo.tile - 1 - r0) // geo.rows + 1
    return [(r0 + k * geo.rows, j) for k in range(m)]


def test_gn_two_pass_geometry_mirrors_the_source():
    c = _constexprs("group_norm.cu")
    assert int(c["kTwoPassMaxThreads"]) == GN_TWO_PASS_MAX_THREADS
    assert int(c["kStatsUnroll"]) == GN_STATS_UNROLL
    assert int(c["kApplyUnroll"]) == GN_APPLY_UNROLL
    assert int(c["kTileThreads"]) == GN_SCALAR_THREADS
    assert int(c["kRouteVector"]) == GN_TWO_PASS_ROUTES.index("vector")
    assert GN_TWO_PASS_THREADS <= GN_TWO_PASS_MAX_THREADS


@pytest.mark.parametrize("n,hw,c,hwb,dtype", list(_two_pass_cases()))
def test_gn_two_pass_slots_tile_hw_once(n, hw, c, hwb, dtype):
    """The tile divides hw and is the caller's when given (else
    gn_hw_block's default); psum's (n, hw / tile) slots are covered once
    by each kernel's blocks, each block taking whole, consecutive slots
    (the vector route: one an apply block, ``stats_tiles`` a stats block)
    or one (tile, sample) (the scalar route)."""
    tile = gn_hw_block(hw, c, hwb)
    geo = gn_two_pass_geometry(n, hw, c, 32, dtype, tile=tile)
    assert geo.tile == tile and hw % tile == 0
    assert tile == (hwb if hwb is not None else gn_hw_block(hw, c))
    slots = n * (hw // tile)
    if geo.route == "scalar":
        assert geo.stats_tiles == 1
        assert gn_two_pass_blocks(geo, n, hw) == slots
        return
    for stats, per in ((False, 1), (True, geo.stats_tiles)):
        blocks = gn_two_pass_blocks(geo, n, hw, stats)
        seen = [s for b in range(blocks) for s in _slots_of(per, b, slots)]
        assert seen == list(range(slots))
        assert all(len(_slots_of(per, b, slots)) >= 1
                   for b in range(blocks))
        assert blocks == -(-slots // per)


@pytest.mark.parametrize("n,hw,c,hwb,dtype", list(_two_pass_cases()))
def test_gn_two_pass_vector_columns_cover_each_tile_once(n, hw, c, hwb,
                                                         dtype):
    """On the vector route (taken exactly for aligned widths that are a
    whole number of 16-byte vectors, at most GN_TWO_PASS_MAX_THREADS of
    them), thread t < rows * nj keeps vector column t % nj down pixels t //
    nj, + rows, ...: every (pixel, vector) of a tile once, every row of a
    block with a pixel; the threads are whole warps with fewer than 32
    idle."""
    item = ITEMSIZE[dtype]
    vec = GN_VECTOR_BYTES // item
    geo = gn_two_pass_geometry(n, hw, c, 32, dtype,
                               tile=gn_hw_block(hw, c, hwb))
    vector = (c * item) % GN_VECTOR_BYTES == 0 \
        and c // vec <= GN_TWO_PASS_MAX_THREADS
    assert (geo.route == "vector") == vector
    if not vector:
        return
    nj = c // vec
    assert nj * vec == c
    assert 1 <= geo.rows <= geo.tile
    assert geo.threads % 32 == 0 and 0 <= geo.threads - geo.rows * nj < 32
    cells = sorted(cell for t in range(geo.threads)
                   for cell in _thread_cells(geo, nj, t))
    assert cells == [(p, j) for p in range(geo.tile) for j in range(nj)]
    # the channels of a thread: one whole vector, the same in every pixel
    assert all(len({j for _, j in _thread_cells(geo, nj, t)}) <= 1
               for t in range(geo.threads))


@pytest.mark.parametrize("n,hw,c,hwb,dtype", list(_two_pass_cases()))
def test_gn_two_pass_fits_the_card(n, hw, c, hwb, dtype):
    """Threads within GN_TWO_PASS_MAX_THREADS (the kernels' launch bound),
    the stats block's shared memory (two fp32 sums a row and channel)
    within the 48 KB a launch takes unasked, the grids within grid.x; a
    stats block two slots exactly where its grid keeps GN_STATS_MIN_BLOCKS
    blocks, else one."""
    geo = gn_two_pass_geometry(n, hw, c, 32, dtype,
                               tile=gn_hw_block(hw, c, hwb))
    if geo.route == "scalar":
        assert geo.threads == GN_SCALAR_THREADS
        return
    assert 32 <= geo.threads <= GN_TWO_PASS_MAX_THREADS
    assert _gn_stats_smem(geo, c) <= 48 * 1024
    slots = n * (hw // geo.tile)
    assert gn_two_pass_blocks(geo, n, hw) <= 2 ** 31 - 1
    blocks = gn_two_pass_blocks(geo, n, hw, stats=True)
    doubled = -(-slots // 2) >= GN_STATS_MIN_BLOCKS
    assert geo.stats_tiles == (2 if doubled else 1)
    assert geo.stats_tiles == 1 or blocks >= GN_STATS_MIN_BLOCKS
    # rows fill GN_TWO_PASS_THREADS where the tile has the pixels
    vec = GN_VECTOR_BYTES // ITEMSIZE[dtype]
    assert geo.rows == max(1, min(GN_TWO_PASS_THREADS // (c // vec),
                                  geo.tile))


def test_gn_two_pass_main_shapes():
    """The UNet's 8 x 64 x 64 x 960 bf16: 32-pixel tiles, 2 rows of 120
    vector columns, 1024 apply blocks of one tile, 512 stats blocks of
    two (a thread's 16 vectors a tile one batch); the VAE's 1 x 512 x 512
    x 128: 256-pixel tiles, 16 rows of 16 columns, the same grids; 2 x 75
    x 75 x 960: 450 blocks of a 25-pixel tile for both (225 stats blocks
    of two would be under a wave); 8-pixel tiles of 64 channels: 8 rows
    of 8 columns, 4096 apply blocks, 2048 stats blocks of two; 7.5 KB of
    stats shared memory at 960 fp32 (1 row of 240 columns)."""
    geo = gn_two_pass_geometry(8, 4096, 960, 32, "bfloat16")
    assert (geo.route, geo.tile, geo.rows, geo.threads,
            geo.stats_tiles) == ("vector", 32, 2, 256, 2)
    assert (gn_two_pass_blocks(geo, 8, 4096),
            gn_two_pass_blocks(geo, 8, 4096, True)) == (1024, 512)
    geo = gn_two_pass_geometry(1, 262144, 128, 32, "bfloat16")
    assert (geo.tile, geo.rows, geo.threads, geo.stats_tiles) \
        == (256, 16, 256, 2)
    assert (gn_two_pass_blocks(geo, 1, 262144),
            gn_two_pass_blocks(geo, 1, 262144, True)) == (1024, 512)
    geo = gn_two_pass_geometry(2, 5625, 960, 32, "bfloat16")
    assert (geo.tile, geo.stats_tiles, gn_two_pass_blocks(geo, 2, 5625),
            gn_two_pass_blocks(geo, 2, 5625, True)) == (25, 1, 450, 450)
    geo = gn_two_pass_geometry(8, 4096, 64, 32, "bfloat16", tile=8)
    assert (geo.rows, geo.threads, geo.stats_tiles,
            gn_two_pass_blocks(geo, 8, 4096),
            gn_two_pass_blocks(geo, 8, 4096, True)) == (8, 64, 2, 4096, 2048)
    geo = gn_two_pass_geometry(8, 4096, 960, 32, "float32")
    assert (geo.rows, geo.threads, _gn_stats_smem(geo, 960)) \
        == (1, 256, 7680)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gn_two_pass_ragged_shapes_take_the_scalar_route(dtype):
    """x off a 16-byte boundary, a pixel that is not whole 16-byte
    vectors (36 bf16 channels: 72 bytes; 36 fp32 channels, 144 bytes, are
    nine) or wider than GN_TWO_PASS_MAX_THREADS vectors takes the scalar
    route."""
    vec = GN_VECTOR_BYTES // ITEMSIZE[dtype]
    assert gn_two_pass_geometry(2, 256, 960, 32, dtype,
                                aligned=False).route == "scalar"
    assert gn_two_pass_geometry(2, 256, 36, 4, dtype).route \
        == ("scalar" if 36 % vec else "vector")
    assert gn_two_pass_geometry(2, 256, 30, 3, dtype).route == "scalar"
    wide = (GN_TWO_PASS_MAX_THREADS + 1) * vec
    assert gn_two_pass_geometry(1, 16, wide, 32, dtype).route == "scalar"
    assert gn_two_pass_geometry(
        1, 16, GN_TWO_PASS_MAX_THREADS * vec, 32, dtype).route == "vector"


@pytest.mark.parametrize("hw,c,hwb", [(4096, 960, 12), (4096, 960, 0),
                                      (4096, 960, -8), (4096, 960, 48),
                                      (49, 64, 7), (5625, 960, 25),
                                      (4096, 960, 8.0), (4096, 960, "8")])
def test_gn_two_pass_invalid_hw_block_raises(hw, c, hwb):
    """An explicit hw_block that is not a positive multiple of 8 dividing
    hw raises ValueError, as the JAX package's does; a tile that does not
    divide hw is refused by the geometry."""
    with pytest.raises(ValueError, match="hw_block"):
        gn_hw_block(hw, c, hwb)
    if isinstance(hwb, int) and (hwb < 1 or hw % hwb):
        with pytest.raises(ValueError, match="tile"):
            gn_two_pass_geometry(1, hw, c, 32, tile=hwb)
