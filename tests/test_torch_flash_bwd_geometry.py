"""The fp32 flash backward's geometry (``fa_fma_bwd_geometry``) on the CPU.

The dq and dk / dv kernels of ``apex_tpu_torch/csrc/flash_attention_bwd.cu``
run only on the card; what decides which rows and tiles they visit is held
here against brute force: shared memory within a Hopper block, the padded
row stride, the grid covering every row, the tiles a causal block visits
against a count of the tiles holding any unmasked (query, key) pair, dq's
heaviest-first order, and the ``constexpr`` values of the source against
the Python mirror. No JAX: nothing here has a counterpart there.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from apex_tpu_torch.ops.tiling import FA_HEAD_DIM, fa_fma_bwd_geometry

SRC = (Path(__file__).resolve().parent.parent / "apex_tpu_torch" / "csrc"
       / "flash_attention_bwd.cu")
SIZES = [1, 63, 64, 65, 127, 129, 200, 333, 1000, 1024]
SMEM_LIMIT = 232448          # bytes of shared memory a Hopper block may use
G = fa_fma_bwd_geometry()


def _constexprs():
    """``{name: value}`` of the source's integer ``constexpr``s."""
    text = SRC.read_text()
    return {m.group(1): m.group(2) for m in re.finditer(
        r"constexpr int (k\w+) = ([^;]+);", text)}


def test_geometry_mirrors_the_source():
    c = _constexprs()
    assert int(c["kD"]) == G.head_dim == FA_HEAD_DIM
    assert int(c["kBM"]) == G.block_rows
    assert int(c["kBN"]) == G.tile_rows
    assert int(c["kStages"]) == G.stages
    assert int(c["kMI"]) == G.micro[0]
    assert c["kStride"] == "kD + 4" and G.row_stride == G.head_dim + 4
    # kThreads = 64 * kBM / kPairRows, kPairRows = 4 * kMI
    assert c["kPairRows"] == "4 * kMI"
    assert c["kThreads"] == "64 * kBM / kPairRows"
    assert 64 * G.block_rows // (4 * G.micro[0]) == G.threads
    # each lane's streamed rows are lx + kColStep * j over 8 lanes
    assert int(c["kColStep"]) * G.micro[1] * 2 == G.tile_rows


def test_shared_memory_fits_a_block():
    assert G.dq_smem_bytes <= SMEM_LIMIT
    assert G.dkv_smem_bytes <= SMEM_LIMIT
    # the source's sums of tiles, in floats, as the Python bytes count them
    c = _constexprs()
    assert c["kDqSmemFloats"] == "3 * kBlockTile + kStages * 2 * kTile"
    block, tile = G.block_rows * G.row_stride, G.tile_rows * G.row_stride
    assert G.dq_smem_bytes == 4 * (3 * block + G.stages * 2 * tile)
    assert G.dkv_smem_bytes == 4 * (4 * block + G.stages * 2 * tile
                                    + G.stages * 2 * G.tile_rows)


def test_row_stride_is_whole_float4s_in_distinct_banks():
    assert G.row_stride % 4 == 0
    # 8 consecutive rows' 16-byte chunks fall in 8 distinct groups of 4
    # banks: the stride in chunks is odd
    chunks = G.row_stride // 4
    assert chunks % 2 == 1
    assert len({(r * chunks) % 8 for r in range(8)}) == 8


@pytest.mark.parametrize("s", SIZES)
def test_grid_covers_every_row(s):
    n = G.blocks(s)
    assert n * G.block_rows >= s > (n - 1) * G.block_rows
    rows = np.zeros(s, dtype=int)
    for qb in G.dq_order(s):
        rows[qb * G.block_rows:(qb + 1) * G.block_rows] += 1
    assert (rows == 1).all()
    assert sorted(G.dkv_order(s)) == list(range(n))


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


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sk", SIZES)
@pytest.mark.parametrize("sq", SIZES)
def test_visited_tiles_match_brute_force(sq, sk, causal):
    want_dq = _tiles_with_pairs(sq, sk, causal, "q", "k", G.block_rows,
                                G.tile_rows)
    got_dq = [list(G.dq_key_tiles(qb, sq, sk, causal))
              for qb in range(G.blocks(sq))]
    assert got_dq == want_dq
    want_dkv = _tiles_with_pairs(sq, sk, causal, "k", "q", G.block_rows,
                                 G.tile_rows)
    got_dkv = [list(G.dkv_query_tiles(kb, sq, causal))
               for kb in range(G.blocks(sk))]
    assert got_dkv == want_dkv


@pytest.mark.parametrize("s", SIZES)
def test_dispatch_order_is_heaviest_first(s):
    """grid.y's order is a permutation of the row blocks, each block's
    causal work (tiles visited) never above the one dispatched before."""
    for order, work in (
            (G.dq_order(s),
             lambda b: len(G.dq_key_tiles(b, s, s, True))),
            (G.dkv_order(s),
             lambda b: len(G.dkv_query_tiles(b, s, True)))):
        assert sorted(order) == list(range(G.blocks(s)))
        loads = [work(b) for b in order]
        assert loads == sorted(loads, reverse=True)
