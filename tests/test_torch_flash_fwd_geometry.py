"""The fp32 flash forward's geometry (``fa_fma_fwd_geometry``) on the CPU.

The kernel of ``apex_tpu_torch/csrc/flash_attention.cu`` runs only on the
card; what decides which rows, keys and tiles it visits is held here
against brute force at each compiled head width (64, 128 and 256): shared
memory for the blocks an SM the source claims, the padded row strides,
the lanes' micro-tiles covering a warp's rows, keys and d columns once
each, the grid covering every query row, the key tiles a causal block
visits against a count of the tiles holding any unmasked (query, key)
pair, the warps that skip a visited tile against the rows that see none
of its keys, the heaviest-first order, and the ``constexpr`` values of
the source (``FwdGeometry<d>``, ``Fwd``) against the Python mirror. The
bf16 tensor-core kernels' blocks (``fa_tc_fwd_geometry``, ``Layout<d>``
of ``csrc/flash_fwd_wgmma.cu``; ``fa_tc_geometry``, that of the two
backward sources) likewise: the source's ``Layout`` evaluated at each
width against the mirror, shared memory within a block's and the
warpgroups covering each block's output rows and columns once. No JAX:
nothing here has a counterpart there.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from apex_tpu_torch.ops.tiling import (FA_HEAD_DIMS, fa_batch_heads_grid,
                                       fa_fma_fwd_geometry,
                                       fa_tc_fwd_geometry, fa_tc_geometry)

CSRC = Path(__file__).resolve().parent.parent / "apex_tpu_torch" / "csrc"
SRC = CSRC / "flash_attention.cu"
TC_FWD_SRC = "flash_fwd_wgmma.cu"
TC_SRCS = ("flash_bwd_dq_wgmma.cu", "flash_bwd_dkv_wgmma.cu")
SIZES = [1, 63, 64, 65, 127, 128, 129, 200, 333, 1000, 1024]
SMEM_LIMIT = 232448          # bytes of shared memory a Hopper block may use
SM_SMEM = 233472             # bytes of shared memory an SM holds for blocks
G = fa_fma_fwd_geometry()
WIDTHS = pytest.mark.parametrize("d", FA_HEAD_DIMS)


def _constexprs(d):
    """``{name: value}`` of the source's integer ``constexpr``s: those of
    the namespace, ``Fwd``'s derived ones, then those of
    ``FwdGeometry<d>``."""
    text = SRC.read_text()
    out = {m.group(1): m.group(2) for m in re.finditer(
        r"^constexpr int (k\w+) = ([^;]+);", text, re.M)}
    out.update((m.group(1), " ".join(m.group(2).split())) for m in
               re.finditer(r"^  static constexpr int (k\w+) =\s*([^;]+);",
                           text, re.M))
    body = re.search(r"struct FwdGeometry<%d> \{(.*?)\};" % d, text,
                     re.S).group(1)
    out.update((m.group(1), m.group(2)) for m in re.finditer(
        r"static constexpr int (k\w+) = ([^;]+);", body))
    return out


def test_widths_and_their_geometries():
    """The compiled widths, each with its own geometry; the default is
    d = 64's; no other width has one."""
    assert FA_HEAD_DIMS == (64, 128, 256)
    assert G == fa_fma_fwd_geometry(64)
    for d in FA_HEAD_DIMS:
        assert fa_fma_fwd_geometry(d).head_dim == d
    with pytest.raises(ValueError, match="compiled"):
        fa_fma_fwd_geometry(96)


@WIDTHS
def test_geometry_mirrors_the_source(d):
    g = fa_fma_fwd_geometry(d)
    c = _constexprs(d)
    assert g.head_dim == d
    assert int(c["kBM"]) == g.block_rows
    assert int(c["kBlocksPerSM"]) == g.blocks_per_sm
    assert int(c["kBN"]) == g.tile_rows
    assert int(c["kStages"]) == g.stages
    assert int(c["kMI"]) == g.micro[0]
    assert int(c["kWarpRows"]) == g.warp_rows
    assert int(c["kStride"]) == g.row_stride == g.head_dim + 4
    assert c["kSStride"] == "kBN + 4" and g.strip_stride == g.tile_rows + 4
    assert c["kThreads"] == "32 * kBM / kWarpRows"
    assert 32 * g.block_rows // g.warp_rows == g.threads
    assert c["kRowStep"] == "kWarpRows / kMI"
    # a lane's keys are lx + kColStep * j, j < kNJ, over the 16 lanes of a
    # row
    assert c["kNJ"] == "kBN / kColStep"
    assert int(c["kColStep"]) * g.micro[1] == g.tile_rows


@WIDTHS
def test_shared_memory_fits_two_blocks_an_sm(d):
    """Each block's shared memory within a Hopper block's; the blocks an
    SM the geometry claims (two at d = 64, one at d = 128 and 256) within
    the SM's."""
    g = fa_fma_fwd_geometry(d)
    assert g.smem_bytes <= SMEM_LIMIT
    # each block with the 1 KB the hardware reserves
    assert g.blocks_per_sm * (g.smem_bytes + 1024) <= SM_SMEM
    assert (g.blocks_per_sm + 1) * (g.smem_bytes + 1024) > SM_SMEM
    assert g.blocks_per_sm == (2 if d == 64 else 1)
    src = SRC.read_text()
    assert ("kBM * kStride + kBM * kSStride + kStages * 2 * kTile"
            in " ".join(src.split()))
    block, tile = g.block_rows * g.row_stride, g.tile_rows * g.row_stride
    assert g.smem_bytes == 4 * (block + g.block_rows * g.strip_stride
                                + g.stages * 2 * tile)


@WIDTHS
def test_row_stride_is_whole_float4s_in_distinct_banks(d):
    g = fa_fma_fwd_geometry(d)
    for stride in (g.row_stride, g.strip_stride):
        assert stride % 4 == 0
        # 8 consecutive rows' 16-byte chunks fall in 8 distinct groups of
        # 4 banks: the stride in chunks is odd
        chunks = stride // 4
        assert chunks % 2 == 1
        assert len({(r * chunks) % 8 for r in range(8)}) == 8


@WIDTHS
def test_micro_tiles_cover_a_warp_once(d):
    """Lane (ly, lx) = (lane // 16, lane % 16) holds rows ly + 2 i, keys
    lx + 16 j of S and d columns 64 g + 4 lx .. + 3 of o (g over the
    64-column groups): every (row, key) of the warp's rows over a tile and
    every (row, d column) exactly once, and a quarter-warp's 8 keys in 8
    distinct bank groups."""
    g = fa_fma_fwd_geometry(d)
    mi, nj = g.micro
    step = g.warp_rows // mi
    col_step = g.tile_rows // nj
    scores = np.zeros((g.warp_rows, g.tile_rows), dtype=int)
    outs = np.zeros((g.warp_rows, g.head_dim), dtype=int)
    for lane in range(32):
        ly, lx = lane // 16, lane % 16
        for i in range(mi):
            for j in range(nj):
                scores[ly + step * i, lx + col_step * j] += 1
            for grp in range(g.col_groups):
                for u in range(4):
                    outs[ly + step * i, 64 * grp + 4 * lx + u] += 1
    assert (scores == 1).all() and (outs == 1).all()
    chunks = g.row_stride // 4
    for quarter in range(4):
        for j in range(nj):
            keys = [lane % 16 + col_step * j
                    for lane in range(8 * quarter, 8 * quarter + 8)]
            assert len({(k * chunks) % 8 for k in keys}) == 8


@pytest.mark.parametrize("s", SIZES)
def test_grid_covers_every_row(s):
    n = G.blocks(s)
    assert n * G.block_rows >= s > (n - 1) * G.block_rows
    rows = np.zeros(s, dtype=int)
    for qb in G.order(s):
        rows[qb * G.block_rows:(qb + 1) * G.block_rows] += 1
    assert (rows == 1).all()


@pytest.mark.parametrize("bh", [1, 48, 512, 65535, 65600])
def test_grid_puts_batch_heads_on_x(bh):
    gx, gy, gz = G.grid(bh, 1000)
    assert (gx, gz) == fa_batch_heads_grid(bh) and gy == G.blocks(1000)
    assert gx * gz >= bh > gx * (gz - 1)


def _tiles_with_pairs(sq, sk, causal):
    """Brute force: for each query block, the key tiles that hold any
    unmasked (query, key) pair."""
    q = np.arange(sq)[:, None]
    k = np.arange(sk)[None, :]
    live = (k <= q) if causal else np.ones((sq, sk), dtype=bool)
    out = []
    for b0 in range(0, sq, G.block_rows):
        part = live[b0:b0 + G.block_rows]
        out.append([t for t in range(-(-sk // G.tile_rows))
                    if part[:, t * G.tile_rows:(t + 1) * G.tile_rows].any()])
    return out


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sk", SIZES)
@pytest.mark.parametrize("sq", SIZES)
def test_visited_tiles_match_brute_force(sq, sk, causal):
    want = _tiles_with_pairs(sq, sk, causal)
    got = [list(G.key_tiles(qb, sq, sk, causal))
           for qb in range(G.blocks(sq))]
    assert got == want


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [33, 64, 65, 129, 200, 1024])
def test_busy_warps_match_brute_force(s, causal):
    """A warp runs a visited tile's products exactly when one of its rows
    below sq sees one of the tile's keys (a skipped warp's m, l and o
    would not change)."""
    warps = G.threads // 32
    for qb in range(G.blocks(s)):
        for t in G.key_tiles(qb, s, s, causal):
            for w in range(warps):
                r0 = qb * G.block_rows + w * G.warp_rows
                rows = np.arange(r0, min(r0 + G.warp_rows, s))
                keys = np.arange(t * G.tile_rows,
                                 min((t + 1) * G.tile_rows, s))
                sees = bool(rows.size) and (
                    not causal or bool((keys[None, :] <= rows[:, None])
                                       .any()))
                assert G.warp_busy(qb, w, t, s, causal) == sees


@pytest.mark.parametrize("s", SIZES)
def test_dispatch_order_is_heaviest_first(s):
    """grid.y's order is a permutation of the query blocks, each block's
    causal work (tiles visited) never above the one dispatched before."""
    order = G.order(s)
    assert sorted(order) == list(range(G.blocks(s)))
    loads = [len(G.key_tiles(b, s, s, True)) for b in order]
    assert loads == sorted(loads, reverse=True)


WIDE = pytest.mark.parametrize("d", [w for w in FA_HEAD_DIMS if w != 64])
WIDE_SIZES = [1, 31, 32, 33, 63, 64, 65, 200, 1024]


@WIDE
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sk", WIDE_SIZES)
@pytest.mark.parametrize("sq", WIDE_SIZES)
def test_wide_visited_tiles_and_rows_match_brute_force(sq, sk, causal, d):
    """At the wider head dims' own tiles (32 keys at d = 256): the grid
    covers every query row once and each block visits exactly the key
    tiles that hold an unmasked (query, key) pair."""
    g = fa_fma_fwd_geometry(d)
    rows = np.zeros(sq, dtype=int)
    for qb in g.order(sq):
        rows[qb * g.block_rows:(qb + 1) * g.block_rows] += 1
    assert (rows == 1).all()
    live = ((np.arange(sk)[None, :] <= np.arange(sq)[:, None]) if causal
            else np.ones((sq, sk), dtype=bool))
    for qb in range(g.blocks(sq)):
        part = live[qb * g.block_rows:(qb + 1) * g.block_rows]
        want = [t for t in range(-(-sk // g.tile_rows))
                if part[:, t * g.tile_rows:(t + 1) * g.tile_rows].any()]
        assert list(g.key_tiles(qb, sq, sk, causal)) == want


def _ternary(expr, d):
    """The value of the source's ``kD == w ? a : b`` at head width d."""
    m = re.fullmatch(r"kD == (\d+) \? (\d+) : (\d+)", expr)
    return int(m.group(2)) if d == int(m.group(1)) else int(m.group(3))


def _layout_values(src, d):
    """``{name: value}`` of the ``static constexpr`` ints and bools of
    ``Layout`` in ``src`` at head width ``d``, each expression evaluated
    in order as C++ would (integer division, ``a ? b : c``), with the
    namespace's integer ``constexpr``s (``kRowsWG``, ``kBK``, ...)."""
    text = (CSRC / src).read_text()
    body = re.search(r"struct Layout \{(.*?)\};", text, re.S).group(1)
    env = {"kD": d}
    env.update((m.group(1), int(m.group(2))) for m in re.finditer(
        r"^constexpr int (k\w+) = (\d+);", text, re.M))
    for m in re.finditer(r"static constexpr (?:int|bool) (k\w+) =\s*"
                         r"([^;]+);", body):
        expr = " ".join(m.group(2).split()).replace("/", "//")
        t = re.fullmatch(r"(.+?) \? (.+?) : (.+)", expr)
        if t:
            expr = f"({t.group(2)}) if ({t.group(1)}) else ({t.group(3)})"
        env[m.group(1)] = eval(expr, {}, dict(env))
    return env


@WIDTHS
def test_tensor_core_forward_block_mirrors_the_source(d):
    """``fa_tc_fwd_geometry(d)`` against ``Layout<d>`` of the forward's
    source, evaluated: its key tile, stages, passes, rows, columns, the
    re-sum scratch and the shared memory the kernel asks for (within a
    Hopper block's); the two consumer warpgroups cover the block's 128
    rows and every head dim column exactly once; a consumer's o (d / 2
    fp32) beside its S tile (tile_rows / 2) leaves room in its 232
    registers."""
    g = fa_tc_fwd_geometry(d)
    c = _layout_values(TC_FWD_SRC, d)
    assert c["kBK"] == g.tile_rows and c["kStages"] == g.stages
    assert c["kTwoPass"] == g.two_pass == (d == 256)
    assert c["kBQ"] == g.block_rows == 128 and c["kCols"] == g.cols == d
    assert c["kFixBytes"] == g.fix_bytes
    assert c["kSmemBytes"] == g.smem_bytes <= SMEM_LIMIT
    held = np.zeros((g.block_rows, d), dtype=int)
    for wg in range(2):
        held[64 * wg:64 * wg + 64, :] += 1
    assert (held == 1).all()
    assert d // 2 + g.tile_rows // 2 <= 144
    assert g.blocks(1000) * g.block_rows >= 1000


@pytest.mark.parametrize("src", TC_SRCS)
@WIDTHS
def test_tensor_core_blocks_mirror_the_sources(src, d):
    """``fa_tc_geometry(d)`` against each tensor-core backward source's
    ``Layout<d>``, evaluated: dq's 128-row block, key tile, stages and
    columns; dk / dv's slabs, stages, columns and exchange buffer; the
    shared memory each kernel asks for, within a Hopper block's; the two
    consumer warpgroups cover each output's block rows and head dim
    columns exactly once (dk / dv at one slab a block: the one warpgroup
    dv, the other dk), each holding 64 fp32 an output a thread for each
    64 columns, at most 128."""
    g = fa_tc_geometry(d)
    c = _layout_values(src, d)
    assert c["kCols"] == g.cols == d and g.cols // 64 * 32 <= 128
    if "_dq_" in src:
        assert c["kBQ"] == g.dq_block_rows == 128
        assert c["kBK"] == g.dq_tile_rows and c["kStages"] == g.dq_stages
        assert c["kE"] == g.dq_tile_rows // 2
        assert c["kSmemBytes"] == g.dq_smem_bytes
        held = {"dq": np.zeros((128, d), dtype=int)}
        for wg in range(2):
            held["dq"][64 * wg:64 * wg + 64, :] += 1
        assert g.dq_blocks(1000) * g.dq_block_rows >= 1000
    else:
        assert c["kSlabs"] == g.dkv_slabs and c["kStages"] == g.dkv_stages
        assert c["kBK"] == g.dkv_block_rows
        assert c["kXBytes"] == g.exchange_bytes
        assert c["kSmemBytes"] == g.dkv_smem_bytes
        held = {o: np.zeros((g.dkv_block_rows, d), dtype=int)
                for o in ("dk", "dv")}
        for wg in range(2):
            if g.dkv_slabs == 2:
                for o in ("dk", "dv"):
                    held[o][64 * wg:64 * wg + 64, :] += 1
            else:
                held["dv" if wg == 0 else "dk"][:, :] += 1
        assert g.dkv_slabs * g.cols // 2 <= 128
        assert g.dkv_blocks(1000) * g.dkv_block_rows >= 1000
    assert all((h == 1).all() for h in held.values())
    assert max(g.dq_smem_bytes, g.dkv_smem_bytes) <= SMEM_LIMIT


def test_tensor_core_smem_matches_the_kernels_sums():
    """The mirror's bytes at the widths the sources were sized for: the
    forward 165,000 at d = 64, 214,120 at d = 128 and 222,344 at d = 256;
    the backward pair at d = 128 and 256 (dq with a sink barrier beside a
    stage's two; at d = 256 dq's 128 rows of Q and dO and three stages of
    32-key K and V, dk / dv's two buffers of p's exchange), all under the
    232,448 a block may have."""
    assert fa_tc_fwd_geometry(64).smem_bytes == 165000
    assert fa_tc_fwd_geometry(128).smem_bytes == 214120
    assert fa_tc_fwd_geometry(256).smem_bytes == 222344
    assert fa_tc_geometry(128).dq_smem_bytes == 197712
    assert fa_tc_geometry(128).dkv_smem_bytes == 199752
    assert fa_tc_geometry(256).dq_smem_bytes == 230464
    assert fa_tc_geometry(256).dkv_smem_bytes == 231464
