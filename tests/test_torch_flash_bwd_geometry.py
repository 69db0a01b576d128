"""The fp32 flash backward's geometry (``fa_fma_bwd_geometry``) on the CPU.

The dq and dk / dv kernels of ``apex_tpu_torch/csrc/flash_attention_bwd.cu``
run only on the card; what decides which rows and tiles they visit is held
here against brute force at each compiled head width (64, 128 and 256):
shared memory within a Hopper block, the padded row strides, the lanes
covering a warp group's rows (a pair's, four warps' at d = 256),
streamed rows and d columns once each, the grid covering
every row, the tiles a causal block visits against a count of the tiles
holding any unmasked (query, key) pair, dq's heaviest-first order, and
the ``constexpr`` values of the source (``BwdGeometry<d>``) against the
Python mirror; and that the bf16 tensor-core pair
(``csrc/flash_bwd_{dq,dkv}_wgmma.cu``) waits without a trap instruction.
No JAX: nothing here has a counterpart there.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from apex_tpu_torch.ops.tiling import FA_HEAD_DIMS, fa_fma_bwd_geometry

SRC = (Path(__file__).resolve().parent.parent / "apex_tpu_torch" / "csrc"
       / "flash_attention_bwd.cu")
TC_BWD_SRCS = ("flash_bwd_dq_wgmma.cu", "flash_bwd_dkv_wgmma.cu")
SIZES = [1, 63, 64, 65, 127, 129, 200, 333, 1000, 1024]
SMEM_LIMIT = 232448          # bytes of shared memory a Hopper block may use
G = fa_fma_bwd_geometry()
WIDTHS = pytest.mark.parametrize("d", FA_HEAD_DIMS)


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
    assert int(c["kMI"]) == g.micro[0]
    assert int(c["kStride"]) == g.row_stride == g.head_dim + 4
    assert c["kSStride"] == "kBN + 4" and g.strip_stride == g.tile_rows + 4
    assert int(c["kSplit"]) == g.splits
    # kThreads = 32 * kSplit * kBM / kGroupRows, kGroupRows = 4 * kMI
    assert c["kGroupRows"] == "4 * kMI"
    assert c["kThreads"] == "32 * kSplit * kBM / kGroupRows"
    assert 32 * g.splits * g.block_rows // (4 * g.micro[0]) == g.threads
    # each lane's streamed rows are lx + kColStep * j, j < kNJ, over the 8
    # lanes of its warp's part
    assert c["kNJ"] == "kBN / (kSplit * kColStep)"
    assert int(c["kColStep"]) * g.micro[1] * g.splits == g.tile_rows
    assert c["kGroups"] == "kD / (32 * kSplit)"
    assert g.col_groups == d // (32 * g.splits)


@WIDTHS
def test_shared_memory_fits_a_block(d):
    g = fa_fma_bwd_geometry(d)
    assert g.dq_smem_bytes <= SMEM_LIMIT
    assert g.dkv_smem_bytes <= SMEM_LIMIT
    # the source's sums of tiles, in floats, as the Python bytes count them
    c = _constexprs(d)
    assert c["kDqSmemFloats"] == \
        "2 * kBlockTile + kBM * kSStride + kStages * 2 * kTile"
    assert c["kDkvSmemFloats"] == ("2 * kBlockTile + 2 * kBM * kSStride + "
                                   "kStages * 2 * kTile + kStages * 2 * kBN")
    block, tile = g.block_rows * g.row_stride, g.tile_rows * g.row_stride
    strip = g.block_rows * g.strip_stride
    assert g.dq_smem_bytes == 4 * (2 * block + strip + g.stages * 2 * tile)
    assert g.dkv_smem_bytes == 4 * (2 * block + 2 * strip
                                    + g.stages * 2 * tile
                                    + g.stages * 2 * g.tile_rows)


@WIDTHS
def test_row_stride_is_whole_float4s_in_distinct_banks(d):
    g = fa_fma_bwd_geometry(d)
    for stride in (g.row_stride, g.strip_stride):
        assert stride % 4 == 0
        # 8 consecutive rows' 16-byte chunks fall in 8 distinct groups of
        # 4 banks: the stride in chunks is odd
        chunks = stride // 4
        assert chunks % 2 == 1
        assert len({(r * chunks) % 8 for r in range(8)}) == 8


@WIDTHS
def test_lanes_cover_a_pair_once(d):
    """Warp (group, part) of a group of ``splits`` warps, lane (ly, lx) =
    (lane // 8, lane % 8) holds rows ly + 4 i of its group's 32, streamed
    rows part * tile / splits + lx + 8 j and d columns part * d / splits
    + 32 g + 4 lx .. + 3: every (row, streamed row) of a group's tile and
    every (row, d column) of its outputs exactly once."""
    g = fa_fma_bwd_geometry(d)
    mi, nj = g.micro
    rows = 4 * mi
    scores = np.zeros((rows, g.tile_rows), dtype=int)
    outs = np.zeros((rows, g.head_dim), dtype=int)
    for part in range(g.splits):
        for lane in range(32):
            ly, lx = lane // 8, lane % 8
            for i in range(mi):
                for j in range(nj):
                    scores[ly + 4 * i,
                           part * g.tile_rows // g.splits + lx + 8 * j] += 1
                for grp in range(g.col_groups):
                    for u in range(4):
                        outs[ly + 4 * i, part * g.head_dim // g.splits
                             + 32 * grp + 4 * lx + u] += 1
    assert (scores == 1).all() and (outs == 1).all()
    assert g.threads == 32 * g.splits * g.block_rows // rows
    # a lane's accumulators: of dq, and of dk and of dv each
    assert g.col_groups * mi * 4 <= 64


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
