"""The fp32 flash backward's geometry (``fa_fma_bwd_geometry``) on the CPU.

The dq and dk / dv kernels of ``apex_tpu_torch/csrc/flash_attention_bwd.cu``
run only on the card; what decides which rows and tiles they visit is held
here against brute force at each compiled head width (64, 128 and 256):
shared memory within a Hopper block, the padded row strides (every
operand load and, where the scores are split by depth, every partial
score's store free of bank conflicts), the blocks an SM holds, the lanes
covering a warp group's rows (a pair's, or at d = 128 and 256 the
block's four or eight, half S's and half dP's), every (row, streamed row,
d column) term of a score and every output element once each, at d = 128
and 256 the two or four partial scores of each entry stored once and
added back in part order by the warp that owns the entry, the grid
covering every row, the tiles a causal block visits against a count of the tiles
holding any unmasked (query, key) pair, dq's heaviest-first order, and
the ``constexpr`` values of the source (``BwdGeometry<d>``) against the
Python mirror; and of the bf16 tensor-core pair
(``csrc/flash_bwd_{dq,dkv}_wgmma.cu``, ``fa_tc_geometry``): that it waits
without a trap instruction, that each kernel's shared memory, its regions
laid out one after another on their boundaries, fits a Hopper block, that
each product of the backward runs once a block at every width (the
warpgroups' shares of S, dP and dQ, or of S^T, dP^T, dV and dK, counted
element by element), and that p's exchange between dk / dv's warpgroups
at d = 256 hands each thread back the values of its own fragment, each
warp's accesses one contiguous run. No JAX: nothing here has a
counterpart there.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from apex_tpu_torch.ops.tiling import (FA_HEAD_DIMS, fa_fma_bwd_geometry,
                                       fa_tc_geometry)

SRC = (Path(__file__).resolve().parent.parent / "apex_tpu_torch" / "csrc"
       / "flash_attention_bwd.cu")
TC_BWD_SRCS = ("flash_bwd_dq_wgmma.cu", "flash_bwd_dkv_wgmma.cu")
SIZES = [1, 63, 64, 65, 127, 129, 200, 333, 1000, 1024]
SMEM_LIMIT = 232448          # bytes of shared memory a Hopper block may use
SM_SMEM = 233472             # an SM's, 1 KB of it reserved for each block
G = fa_fma_bwd_geometry()
WIDTHS = pytest.mark.parametrize("d", FA_HEAD_DIMS)
# the widths whose scores are split by depth, with each one's parts
SPLIT_PARTS = {128: 2, 256: 4}


def _constexprs(d):
    """``{name: value}`` of the source's integer ``constexpr``s: those of
    the namespace, ``Bwd``'s derived ones, then those of
    ``BwdGeometry<d>``."""
    text = SRC.read_text()
    out = {m.group(1): m.group(2) for m in re.finditer(
        r"^constexpr int (k\w+) = ([^;]+);", text, re.M)}
    out.update((m.group(1), " ".join(m.group(2).split())) for m in
               re.finditer(r"^  static constexpr int (k\w+) =\s*([^;]+);",
                           text, re.M))
    body = re.search(r"struct BwdGeometry<%d> \{(.*?)\};" % d, text,
                     re.S).group(1)
    out.update((m.group(1), m.group(2)) for m in re.finditer(
        r"static constexpr int (k\w+) = ([^;]+);", body))
    return out


def test_widths_and_their_geometries():
    """The compiled widths, each with its own geometry; the default is
    d = 64's; no other width has one."""
    assert FA_HEAD_DIMS == (64, 128, 256)
    assert G == fa_fma_bwd_geometry(64)
    for d in FA_HEAD_DIMS:
        assert fa_fma_bwd_geometry(d).head_dim == d
    with pytest.raises(ValueError, match="compiled"):
        fa_fma_bwd_geometry(80)


@WIDTHS
def test_geometry_mirrors_the_source(d):
    g = fa_fma_bwd_geometry(d)
    c = _constexprs(d)
    assert int(c["kBM"]) == g.block_rows
    assert int(c["kBN"]) == g.tile_rows
    assert int(c["kStages"]) == g.stages
    assert int(c["kStride"]) == g.row_stride == g.head_dim + 4
    assert int(c["kSStride"]) == g.strip_stride == g.tile_rows + (
        4 if g.score_parts == 1 else 8)
    assert int(c["kSplit"]) == g.splits
    assert int(c["kScoreParts"]) == g.score_parts
    assert g.score_parts == SPLIT_PARTS.get(d, 1)
    assert int(c["kBlocksPerSM"]) == g.blocks_per_sm
    # kThreads = 32 * kSplit * kBM / kGroupRows, kGroupRows = 4 * kMI
    assert c["kGroupRows"] == "4 * kMI"
    assert c["kThreads"] == "32 * kSplit * kBM / kGroupRows"
    assert 32 * g.splits * g.block_rows // (4 * int(c["kMI"])) == g.threads
    assert c["kGroups"] == "kD / (32 * kSplit)"
    assert g.col_groups == d // (32 * g.splits)
    assert c["kNJ"] == "kBN / (kSplit * kColStep)"
    # the depth split's lanes: the row halves of the scores, a lane's rows
    # 8 apart and streamed rows 4 apart, those its warp finishes, its
    # output rows and the warp's output columns
    assert c["kProducts"] == "kSplit / kScoreParts"
    assert c["kDMI"] == "kBM / kRowStep"
    assert c["kDNJ"] == "kBN / kColStep"
    assert c["kOwnCols"] == "kDNJ / kScoreParts"
    assert c["kOMI"] == "kBM / kRowStep" and c["kOutCols"] == "kD / kSplit"
    assert (int(c["kRowStep"]), int(c["kColStep"])) == (4, 8)
    if g.score_parts == 1:
        # each lane's streamed rows are lx + kColStep * j, j < kNJ, over
        # the 8 lanes of its warp's part
        assert int(c["kMI"]) == g.micro[0]
        assert int(c["kColStep"]) * g.micro[1] * g.splits == g.tile_rows
    else:
        assert g.products == g.splits // g.score_parts == 2
        assert g.micro == (g.block_rows // 4, g.tile_rows // 8)
        assert g.own_cols == g.micro[1] // g.score_parts
        assert g.block_rows == 4 * int(c["kMI"])  # one group of warps


@WIDTHS
def test_shared_memory_fits_a_block(d):
    """Each kernel's bytes, as the source sums them, within a block's
    limit, and ``blocks_per_sm`` blocks (each with its reserved 1 KB, no
    more) within an SM's: two at d = 128, one elsewhere."""
    g = fa_fma_bwd_geometry(d)
    assert g.dq_smem_bytes <= SMEM_LIMIT
    assert g.dkv_smem_bytes <= SMEM_LIMIT
    for nbytes in (g.dq_smem_bytes, g.dkv_smem_bytes):
        assert g.blocks_per_sm * (nbytes + 1024) <= SM_SMEM
    assert (g.blocks_per_sm + 1) * (g.dq_smem_bytes + 1024) > SM_SMEM
    assert g.blocks_per_sm == (2 if d == 128 else 1)
    # the source's sums of tiles, in floats, as the Python bytes count them
    c = _constexprs(d)
    assert c["kDqSmemFloats"] == \
        "2 * kBlockTile + kDqStrips * kStrip + kStages * 2 * kTile"
    assert c["kDkvSmemFloats"] == ("2 * kBlockTile + kDkvStrips * kStrip + "
                                   "kStages * 2 * kTile + kStages * 2 * kBN")
    assert c["kStrip"] == "kBM * kSStride"
    assert c["kDqStrips"] == \
        "kScoreParts > 1 ? 2 * (kScoreParts - 1) : 1"
    assert c["kDkvStrips"] == \
        "kScoreParts > 1 ? 2 * (kScoreParts - 1) : 2"
    block, tile = g.block_rows * g.row_stride, g.tile_rows * g.row_stride
    strip = g.block_rows * g.strip_stride
    # dq: the ds strip; dk / dv: the p and ds strips; split by depth, the
    # score_parts - 1 planes of S's partial scores and as many of dP's, the
    # strips among them
    planes = 2 * (g.score_parts - 1)
    strips = (1, 2) if g.score_parts == 1 else (planes, planes)
    assert (g.dq_strips, g.dkv_strips) == strips
    assert g.dq_smem_bytes == 4 * (2 * block + strips[0] * strip
                                   + g.stages * 2 * tile)
    assert g.dkv_smem_bytes == 4 * (2 * block + strips[1] * strip
                                    + g.stages * 2 * tile
                                    + g.stages * 2 * g.tile_rows)
    # the bytes of each width's layout (d = 128: two blocks of 32 rows an
    # SM, where 64-row blocks took 144,384 and 154,112, one an SM)
    assert (g.dq_smem_bytes, g.dkv_smem_bytes) == {
        64: (174080, 209920), 128: (111616, 112128),
        256: (230400, 230912)}[d]


def _banks(offsets, width=1):
    """The 4-byte banks that accesses of ``width`` floats at these float
    offsets touch, as a list (a repeat means a conflict)."""
    return [(o + w) % 32 for o in offsets for w in range(width)]


@WIDTHS
def test_row_stride_is_whole_float4s_in_distinct_banks(d):
    """Every 16-byte operand load of a product is free of bank conflicts
    within the lanes that the shared memory serves together (a quarter-warp
    with its 8 addresses, or two quarter-warps with one each): the streamed
    rows a score reads, the block's own rows, a tile row's 4-float columns
    and a gradient product's strip rows. Split by depth, a warp's 4-byte
    stores of one (i, j) of its partial scores (row ly + 4 i, column lx + 8
    j) fall in 32 distinct banks."""
    g = fa_fma_bwd_geometry(d)
    for stride in (g.row_stride, g.strip_stride):
        assert stride % 4 == 0
    # 8 consecutive rows' 16-byte chunks fall in 8 distinct groups of 4
    # banks: the stride in chunks is odd
    chunks = g.row_stride // 4
    assert chunks % 2 == 1
    assert len({(r * chunks) % 8 for r in range(8)}) == 8
    rs, ss = g.row_stride, g.strip_stride
    mi, nj = g.micro
    # a quarter reads one row ly of the block's rows and of a strip (4 i
    # apart; two quarters meet in a pass), 8 streamed rows lx, 8 chunks
    rows = [[(ly + 4 * i) * rs for ly in range(4)] for i in range(mi)]
    cols = [[(lx + 8 * j) * rs for lx in range(8)] for j in range(nj)]
    outs = [[4 * lx for lx in range(8)]]
    out_rows = g.block_rows // 4 if g.score_parts > 1 else mi
    strips = [[(ly + 4 * i) * ss for ly in range(4)]
              for i in range(out_rows)]
    for group in rows + cols + outs:
        assert len(set(_banks(group, 4))) == 4 * len(group)
    for group in strips:
        for pair in (group[:2], group[2:]):
            assert len(set(_banks(pair, 4))) == 8
    if g.score_parts == 1:
        assert (ss // 4) % 2 == 1
    else:
        for i in range(mi):
            for j in range(nj):
                at = [(ly + 4 * i) * ss + lx + 8 * j
                      for ly in range(4) for lx in range(8)]
                assert len(set(_banks(at))) == 32


def _score_terms(g, product=0):
    """For one group's tile: how often each (row, streamed row, d column)
    term of a score (S, or with ``product`` 1 dP) is summed over the
    group's warps and lanes, lane (ly, lx) = (lane // 8, lane % 8).
    ``score_parts`` 1: warp ``part`` of a group of ``splits``
    sums rows ly + 4 i of the group's 32 and streamed rows lx + 8 j of its
    half of the tile over all of d, S and then dP. ``score_parts`` 4: warp
    (product, p) sums its product's rows ly + 4 i and streamed rows lx + 8
    j of the whole tile over part p of d."""
    mi, nj = g.micro
    terms = np.zeros((4 * mi, g.tile_rows, g.head_dim), dtype=int)
    for w in range(g.splits):
        if g.score_parts == 1:
            c0, d0, dn = w * g.tile_rows // g.splits, 0, g.head_dim
        else:
            prod, part = divmod(w, g.score_parts)
            if prod != product:
                continue
            dn = g.head_dim // g.score_parts
            c0, d0 = 0, part * dn
        for lane in range(32):
            ly, lx = divmod(lane, 8)
            for i in range(mi):
                for j in range(nj):
                    terms[ly + 4 * i, c0 + lx + 8 * j, d0:d0 + dn] += 1
    return terms


def _output_cells(g):
    """How often each (row, d column) of a group's output is held over its
    warps and lanes: ``score_parts`` 1, rows ly + 4 i by columns part * d
    / splits + 32 g + 4 lx .. + 3; 4, rows ly + 4 i of the block's by
    columns w * d / splits + 32 c + 4 lx .. + 3."""
    rows = g.block_rows if g.score_parts > 1 else 4 * g.micro[0]
    outs = np.zeros((rows, g.head_dim), dtype=int)
    width = g.head_dim // g.splits
    for w in range(g.splits):
        for lane in range(32):
            ly, lx = divmod(lane, 8)
            if g.score_parts == 1:
                cells = [(ly + 4 * i, w * width + 32 * grp + 4 * lx + u)
                         for i in range(g.micro[0])
                         for grp in range(g.col_groups) for u in range(4)]
            else:
                cells = [(ly + 4 * i, w * width + 32 * c + 4 * lx + u)
                         for i in range(g.block_rows // 4)
                         for c in range(width // 32) for u in range(4)]
            for r, col in cells:
                outs[r, col] += 1
    return outs


@WIDTHS
def test_lanes_cover_a_pair_once(d):
    """The lanes of a group of warps (a pair, or the block's four at d =
    128 and eight at d = 256, half for S and half for dP) hold every (row,
    streamed row, d column) term of S and of dP and every (row, d column)
    of each output exactly once; a lane holds at most 64 accumulators of
    dq, and of dk and of dv each."""
    g = fa_fma_bwd_geometry(d)
    assert (_score_terms(g) == 1).all()
    assert (_score_terms(g, 1) == 1).all()
    outs = _output_cells(g)
    assert (outs == 1).all()
    rows = outs.shape[0]  # a group's: 32
    assert rows == 32 and g.threads == 32 * g.splits * g.block_rows // rows
    assert outs.size // (32 * g.splits) <= 64


@pytest.mark.parametrize("d,owner", [(d, o) for d, parts in
                                     SPLIT_PARTS.items()
                                     for o in range(parts)])
def test_partial_scores_meet_once_in_part_order(d, owner):
    """d = 128 and 256, scores split by depth into P = 2 or 4 parts
    (``put_partials`` / ``whole_score`` in the source): lane (ly, lx) of
    warp (product, p) stores its partial of entry (ly + 4 i, lx + 8 j) into
    plane p - (p > o) of its product's P - 1, where o = j // own_cols is
    the part whose warp finishes it, at row * kSStride + column. Each
    (plane, offset) is stored once; the lane of the product's warp o that
    holds the entry reads it back and finds the P parts in part order 0,
    1, ..., each from the warp of that part, of the same entry; warp o
    finishes columns 32 o / P .. 32 (o + 1) / P - 1 of the tile, every row
    once, and S's and dP's warp o the same entries; the first plane's entry
    that S's writes p over, and dP's then reads back (and, in dk / dv,
    overwrites with p * keep), and the one dP's writes ds over, are ones
    only those two lanes touch."""
    g = fa_fma_bwd_geometry(d)
    assert g.score_parts == SPLIT_PARTS[d]
    mi, nj = g.micro
    ss, parts = g.strip_stride, g.score_parts
    stored = {}
    for p in range(parts):  # S's warps; dP's lay their planes out alike
        for lane in range(32):
            ly, lx = divmod(lane, 8)
            for j in range(nj):
                o = j // g.own_cols
                if o == p:
                    continue
                for i in range(mi):
                    row, col = ly + 4 * i, lx + 8 * j
                    e = row * ss + col
                    assert e < g.block_rows * ss
                    key = (p - (p > o), e)
                    assert key not in stored
                    stored[key] = (p, row, col)
    assert len(stored) == (parts - 1) * g.block_rows * g.tile_rows
    finished = np.zeros((g.block_rows, g.tile_rows), dtype=int)
    for lane in range(32):
        ly, lx = divmod(lane, 8)
        for i in range(mi):
            for jj in range(g.own_cols):
                row, col = ly + 4 * i, lx + 8 * (g.own_cols * owner + jj)
                e = row * ss + col
                order = [(owner, row, col) if w == owner
                         else stored[(w - (w > owner), e)]
                         for w in range(parts)]
                assert order == [(w, row, col) for w in range(parts)]
                finished[row, col] += 1
                # the strip entry (first plane) is this entry's own slot
                assert stored[(0, e)][0] == (0 if owner > 0 else 1)
    cols = finished.sum(axis=0)
    width = g.tile_rows // parts
    assert (cols[width * owner:width * owner + width] == g.block_rows).all()
    assert cols.sum() == width * g.block_rows and finished.max() == 1


@WIDTHS
@pytest.mark.parametrize("s", SIZES)
def test_grid_covers_every_row(s, d):
    g = fa_fma_bwd_geometry(d)
    n = g.blocks(s)
    assert n * g.block_rows >= s > (n - 1) * g.block_rows
    rows = np.zeros(s, dtype=int)
    for qb in g.dq_order(s):
        rows[qb * g.block_rows:(qb + 1) * g.block_rows] += 1
    assert (rows == 1).all()
    assert sorted(g.dkv_order(s)) == list(range(n))


def _tiles_with_pairs(sq, sk, causal, rows_of, cols_of, block, tile):
    """Brute force: for each block of ``block`` rows along ``rows_of``, the
    tiles of ``tile`` rows along ``cols_of`` that hold any unmasked
    (query, key) pair."""
    q = np.arange(sq)[:, None]
    k = np.arange(sk)[None, :]
    live = (k <= q) if causal else np.ones((sq, sk), dtype=bool)
    if rows_of == "k":
        live = live.T
    nr, nc = live.shape
    out = []
    for b0 in range(0, nr, block):
        part = live[b0:b0 + block]
        out.append([t for t in range(-(-nc // tile))
                    if part[:, t * tile:(t + 1) * tile].any()])
    return out


@WIDTHS
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sk", SIZES)
@pytest.mark.parametrize("sq", SIZES)
def test_visited_tiles_match_brute_force(sq, sk, causal, d):
    g = fa_fma_bwd_geometry(d)
    want_dq = _tiles_with_pairs(sq, sk, causal, "q", "k", g.block_rows,
                                g.tile_rows)
    got_dq = [list(g.dq_key_tiles(qb, sq, sk, causal))
              for qb in range(g.blocks(sq))]
    assert got_dq == want_dq
    want_dkv = _tiles_with_pairs(sq, sk, causal, "k", "q", g.block_rows,
                                 g.tile_rows)
    got_dkv = [list(g.dkv_query_tiles(kb, sq, causal))
               for kb in range(g.blocks(sk))]
    assert got_dkv == want_dkv


@WIDTHS
@pytest.mark.parametrize("s", SIZES)
def test_dispatch_order_is_heaviest_first(s, d):
    """grid.y's order is a permutation of the row blocks, each block's
    causal work (tiles visited) never above the one dispatched before."""
    g = fa_fma_bwd_geometry(d)
    for order, work in (
            (g.dq_order(s),
             lambda b: len(g.dq_key_tiles(b, s, s, True))),
            (g.dkv_order(s),
             lambda b: len(g.dkv_query_tiles(b, s, True)))):
        assert sorted(order) == list(range(g.blocks(s)))
        loads = [work(b) for b in order]
        assert loads == sorted(loads, reverse=True)


@pytest.mark.parametrize("src", TC_BWD_SRCS)
def test_tensor_core_pair_waits_without_a_trap(src):
    """The bf16 backward pair waits on its barriers with ``mbar_wait_nt``
    alone: no ``mbar_wait(`` call and no ``__trap`` in the code (comments
    aside). ptxas gives a consumer warpgroup the registers of its
    ``setmaxnreg.inc`` (232) only in a kernel without a trap instruction;
    with one, the consumers keep the launch bound's 168 and spill."""
    code = re.sub(r"//[^\n]*", "", (SRC.parent / src).read_text())
    assert not re.search(r"\bmbar_wait\s*\(", code)
    assert "__trap" not in code
    assert re.search(r"\bmbar_wait_nt\s*\(", code)


def _packed(regions):
    """Bytes of ``[(bytes, align), ...]`` laid out in order, each region
    starting on its alignment, plus the 1 KB a kernel spends aligning its
    dynamic shared memory to 1024 bytes."""
    at = 0
    for size, align in regions:
        at = -(-at // align) * align + size
    return at + 1024


@WIDTHS
def test_tensor_core_pair_fits_a_block(d):
    """Each tensor-core backward kernel's shared memory from its regions
    (swizzled tiles on 1024-byte boundaries, the l2 / D slices, 8-byte
    barriers) against the mirror's count and a Hopper block's 232,448
    bytes. dq: Q and dO of the block's 128 rows, each stage's K and V
    tiles, full and empty a stage, Q / dO's and a sink. dk / dv: K and V of
    its keys, each stage's Q and dO, at d = 256 two buffers of p's exchange
    (fp32), each stage's 64 l2 and 64 D, full and empty a stage and K /
    V's."""
    g = fa_tc_geometry(d)
    row = d * 2
    dq = ([(g.dq_block_rows * row, 1024)] * 2
          + [(g.dq_tile_rows * row, 1024)] * (2 * g.dq_stages)
          + [(8, 8)] * (2 * g.dq_stages + 2))
    assert _packed(dq) == g.dq_smem_bytes <= SMEM_LIMIT
    x = [(64 * g.dkv_tile_rows * 4, 1024)] * 2 if g.dkv_slabs == 1 else []
    dkv = ([(g.dkv_block_rows * row, 1024)] * 2
           + [(g.dkv_tile_rows * row, 1024)] * (2 * g.dkv_stages) + x
           + [(g.dkv_tile_rows * 4, 4)] * (2 * g.dkv_stages)
           + [(8, 8)] * (2 * g.dkv_stages + 1))
    assert _packed(dkv) == g.dkv_smem_bytes <= SMEM_LIMIT
    assert g.exchange_bytes == (16384 if d == 256 else 0)


def _dq_shares(g):
    """For one dq block and one key tile, how often each (row, key) of S
    (and of dP: the same shape) and each (row, column, key) term of dQ = dS
    K is computed over both warpgroups: each warpgroup its 64 of the
    block's 128 rows, S and dP over the tile's keys, dQ over all of its
    rows' columns."""
    s = np.zeros((g.dq_block_rows, g.dq_tile_rows), dtype=int)
    dq = np.zeros((g.dq_block_rows, g.head_dim, g.dq_tile_rows), dtype=int)
    for wg in range(2):
        rows = slice(64 * wg, 64 * wg + 64)
        s[rows] += 1
        dq[rows, :g.cols] += 1
    return s, dq


def _dkv_shares(g):
    """The same for one dk / dv block and one query tile: S^T and dP^T over
    (key, query), dV and dK over (key, column, query). Two slabs: each
    warpgroup all four on its 64 keys. One slab (d = 256): warpgroup 0
    S^T and dV, warpgroup 1 dP^T and dK, over the slab's keys, the tile's
    queries and all columns."""
    shape = (g.dkv_block_rows, g.dkv_tile_rows)
    st, dpt = np.zeros(shape, dtype=int), np.zeros(shape, dtype=int)
    wide = (g.dkv_block_rows, g.head_dim, g.dkv_tile_rows)
    dv, dk = np.zeros(wide, dtype=int), np.zeros(wide, dtype=int)
    for wg in range(2):
        if g.dkv_slabs == 2:
            keys = slice(64 * wg, 64 * wg + 64)
            for a in (st, dpt, dv, dk):
                a[keys] += 1
        else:
            for a in ((st, dv) if wg == 0 else (dpt, dk)):
                a[:, :g.cols] += 1
    return st, dpt, dv, dk


@WIDTHS
def test_tensor_core_pair_runs_each_product_once(d):
    """At every width each product of the backward runs once a block: every
    (row, key) of S and dP, every (row, column, key) term of dQ, every
    (key, query) of S^T and dP^T and every (key, column, query) term of dV
    and dK exactly once over the two warpgroups. The tensor-core work of a
    block is then 3/3 of one S, one dP and one dQ (dq) and 4/4 of one S^T,
    dP^T, dV and dK (dk / dv); at d = 256 the layouts these replace (one
    64-row slab a block, both warpgroups running its S and dP, or its S^T
    and dP^T, each half of the outputs' columns) did 5/3 and 6/4."""
    g = fa_tc_geometry(d)
    s, dq = _dq_shares(g)
    assert (s == 1).all() and (dq == 1).all()
    assert 2 * s.sum() * d + dq.sum() == \
        3 * g.dq_block_rows * g.dq_tile_rows * d
    shares = _dkv_shares(g)
    assert all((a == 1).all() for a in shares)
    st, dpt, dv, dk = shares
    assert (st.sum() + dpt.sum()) * d + dv.sum() + dk.sum() == \
        4 * g.dkv_block_rows * g.dkv_tile_rows * d
    if d == 256:
        # the replaced layouts, per 64 x 64 tile: S and dP (or S^T and dP^T)
        # in both warpgroups, dQ (or dV and dK) once
        unit = 64 * 64 * d
        assert (2 * 2 * unit + unit) * 3 == 5 * (3 * unit)
        assert (2 * 2 * unit + 2 * unit) * 4 == 6 * (4 * unit)


@pytest.mark.parametrize("warp", range(4))
def test_tensor_core_p_exchange_round_trips(warp):
    """dk / dv at d = 256 (``dkv_pbuf``): thread t (warp w, lane l) of the
    dV warpgroup stores its 32 values of p (keys 16 w + l / 4 and + 8,
    queries 8 j + 2 (l % 4) + {0, 1}: element 4 j + 2 h + {0, 1}) as
    eight 16-byte chunks, chunk h of elements 4 h .. 4 h + 3 at (128 h +
    t) * 16 bytes of a buffer of ``exchange_bytes``; thread t of the dK
    warpgroup, whose dP^T fragment holds the same (key, query) pairs,
    loads chunks 2 kk and 2 kk + 1 for its step of depth kk. Each (key,
    query) of the 64 x 64 is stored once and read back by the thread
    that holds it, and each warp's store (or load) of one chunk is one
    run of 512 contiguous bytes. Under dropout a dropped entry's p (>= 0)
    is stored negated: the sign bit carries the keep bit, -0 for 0
    included, and the magnitude p's bits unchanged."""
    p = np.array([0.0, 1e-38, 2.5e-8, 0.37, 1.0], dtype=np.float32)
    stored = np.where(np.array([0, 1, 0, 1, 0]) == 1, p, -p)
    assert list(stored.view(np.int32) < 0) == [True, False, True, False,
                                                True]
    assert np.array_equal(np.abs(stored).view(np.int32), p.view(np.int32))
    g = fa_tc_geometry(256)
    owner = {}
    for t in range(128):
        w, lane = t // 32, t % 32
        for x in range(32):
            j, e = x // 4, x % 4
            pair = (16 * w + lane // 4 + 8 * (e >> 1),
                    8 * j + 2 * (lane % 4) + (e & 1))
            at = (128 * (x // 4) + t) * 16 + 4 * (x % 4)
            assert at < g.exchange_bytes and pair not in owner
            owner[pair] = (t, at)
    assert len(owner) == 64 * 64
    stored = {at: pair for pair, (t, at) in owner.items()}
    for lane in range(32):
        t = 32 * warp + lane
        for kk in range(4):
            for e in range(8):
                x = 8 * kk + e
                chunk = 2 * kk + e // 4
                at = (128 * chunk + t) * 16 + 4 * (e % 4)
                pair = stored[at]
                assert owner[pair][0] == t
    for h in range(8):
        runs = sorted((128 * h + 32 * warp + lane) * 16 for lane in range(32))
        assert runs == list(range(runs[0], runs[0] + 512, 16))
