"""The fp32 flash forward's geometry on the CPU: the FMA kernel at d = 64
(``fa_fma_fwd_geometry``) and the split-TF32 kernel at d = 128 and 256
(``fa_tf32_fwd_geometry``).

The kernels of ``apex_tpu_torch/csrc/flash_attention.cu`` and
``csrc/flash_fwd_tf32.cu`` run only on the card; what decides which rows,
keys and tiles they visit is held here against brute force at each
compiled head width (64 on the FMA kernel, 128 and 256 on the split-TF32
one): shared memory for the blocks an SM the source claims, the padded
row strides and their banks, the lanes' micro-tiles (d = 64) or mma
fragments (d = 128, 256: S's accumulator, p.V's A fragment through the
key order inside a group of 8, V's B fragment, o's accumulator, the
score product's depth order) covering a warp's rows, keys and d columns
once each, the grid covering every query row, the key tiles a causal
block visits against a count of the tiles holding any unmasked (query,
key) pair, the warps that skip a visited tile against the rows that see
none of its keys, the heaviest-first order, and the ``constexpr`` values
of the sources (``FwdGeometry<64>``, ``Fwd``; ``TfGeometry<d>``, ``Tf``)
against the Python mirrors. The
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
                                       fa_fma_fwd_geometry, fa_fwd_route,
                                       fa_tc_fwd_geometry, fa_tc_geometry,
                                       fa_tf32_fwd_geometry)

CSRC = Path(__file__).resolve().parent.parent / "apex_tpu_torch" / "csrc"
SRC = CSRC / "flash_attention.cu"
TF32_SRC = CSRC / "flash_fwd_tf32.cu"
TC_FWD_SRC = "flash_fwd_wgmma.cu"
TC_SRCS = ("flash_bwd_dq_wgmma.cu", "flash_bwd_dkv_wgmma.cu")
SIZES = [1, 63, 64, 65, 127, 128, 129, 200, 333, 1000, 1024]
SMEM_LIMIT = 232448          # bytes of shared memory a Hopper block may use
SM_SMEM = 233472             # bytes of shared memory an SM holds for blocks
G = fa_fma_fwd_geometry()
WIDTHS = pytest.mark.parametrize("d", FA_HEAD_DIMS)


def _constexprs(d=64):
    """``{name: value}`` of the FMA source's integer ``constexpr``s: those
    of the namespace, ``Fwd``'s derived ones, then those of
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


def _tf32_values(d):
    """``{name: value}`` of the split-TF32 source's integer ``constexpr``s
    at head width ``d``: the namespace's, ``TfGeometry<d>``'s, then
    ``Tf``'s derived ones evaluated in order as C++ would (integer
    division)."""
    text = TF32_SRC.read_text()
    env = {"kD": d}
    env.update((m.group(1), int(m.group(2))) for m in re.finditer(
        r"^constexpr int (k\w+) = (\d+);", text, re.M))
    body = re.search(r"struct TfGeometry<%d> \{(.*?)\};" % d, text,
                     re.S).group(1)
    env.update((m.group(1), int(m.group(2))) for m in re.finditer(
        r"static constexpr int (k\w+) = (\d+);", body))
    tf = re.search(r"struct Tf : TfGeometry<kD> \{(.*?)\n\};", text,
                   re.S).group(1)
    for m in re.finditer(r"static constexpr int (k\w+) =\s*([^;]+);", tf):
        env[m.group(1)] = eval(" ".join(m.group(2).split())
                               .replace("/", "//"), {}, dict(env))
    return env


def test_widths_and_their_geometries():
    """The compiled widths, each with its own geometry: d = 64 the FMA
    kernel's (the default), 128 and 256 the split-TF32 kernel's; neither
    mirror has another width, and the forward's route follows them."""
    assert FA_HEAD_DIMS == (64, 128, 256)
    assert G == fa_fma_fwd_geometry(64) and G.head_dim == 64
    for d in FA_HEAD_DIMS:
        if d == 64:
            assert fa_fwd_route("float32", d) == "fma"
            with pytest.raises(ValueError, match="128"):
                fa_tf32_fwd_geometry(d)
        else:
            assert fa_tf32_fwd_geometry(d).head_dim == d
            assert fa_fwd_route("float32", d) == "tf32"
            with pytest.raises(ValueError, match="64"):
                fa_fma_fwd_geometry(d)
        assert fa_fwd_route("bfloat16", d) == "wgmma"
    with pytest.raises(ValueError, match="compiled"):
        fa_tf32_fwd_geometry(96)
    with pytest.raises(ValueError, match="compiled"):
        fa_fwd_route("float32", 96)


@WIDTHS
def test_geometry_mirrors_the_source(d):
    if d != 64:
        g, c = fa_tf32_fwd_geometry(d), _tf32_values(d)
        assert g.head_dim == d
        assert c["kBM"] == g.block_rows and c["kBN"] == g.tile_rows
        assert c["kBlocksPerSM"] == g.blocks_per_sm
        assert c["kWarpRows"] == g.warp_rows and c["kStages"] == g.stages
        assert c["kKeySplit"] == g.key_split == (2 if d == 256 else 1)
        assert c["kWarpKeys"] == g.warp_keys
        assert c["kThreads"] == g.threads
        assert 4 * c["kPartFloats"] * (g.key_split > 1) == g.part_bytes
        assert c["kQKStride"] == g.qk_stride == d + 16
        assert c["kVStride"] == g.v_stride == d + 4
        assert 4 * c["kSmemFloats"] == g.smem_bytes
        assert c["kNT"] * 8 == g.warp_keys and c["kOC"] * 32 == d
        assert d % c["kChunk"] == 0 and c["kChunk"] % 16 == 0
        return
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
    SM the geometry claims (two at d = 64 and at d = 128, one at d = 256)
    within the SM's, and no more; at d = 128 and 256 the threads of those
    blocks leave each at least the registers of the kernel's launch bound
    (65,536 an SM), and the source's sum of Q and the stages is the
    mirror's."""
    g = fa_fma_fwd_geometry(d) if d == 64 else fa_tf32_fwd_geometry(d)
    assert g.smem_bytes <= SMEM_LIMIT
    # each block with the 1 KB the hardware reserves
    assert g.blocks_per_sm * (g.smem_bytes + 1024) <= SM_SMEM
    assert (g.blocks_per_sm + 1) * (g.smem_bytes + 1024) > SM_SMEM
    assert g.blocks_per_sm == (1 if d == 256 else 2)
    if d != 64:
        assert g.blocks_per_sm * g.threads * 255 <= 65536
        # a key part's m, l and o for each of a block's row groups, handed
        # over through the stages
        stages = 4 * g.stages * g.tile_rows * (g.qk_stride + g.v_stride)
        assert ((g.key_split - 1) * (g.block_rows // g.warp_rows)
                * g.part_bytes <= stages)
        assert ("kBM * kQKStride + kStages * (kKTile + kVTile)"
                in " ".join(TF32_SRC.read_text().split()))
        assert g.smem_bytes == 4 * (g.block_rows * g.qk_stride + g.stages
                                    * g.tile_rows * (g.qk_stride
                                                     + g.v_stride))
        return
    src = SRC.read_text()
    assert ("kBM * kStride + kBM * kSStride + kStages * 2 * kTile"
            in " ".join(src.split()))
    block, tile = g.block_rows * g.row_stride, g.tile_rows * g.row_stride
    assert g.smem_bytes == 4 * (block + g.block_rows * g.strip_stride
                                + g.stages * 2 * tile)


def _quarter_banks(addrs):
    """Per quarter-warp (8 lanes: one pass of 16-byte loads), the 4-bank
    groups of its float4 addresses (in floats)."""
    return [sorted((a // 4) % 8 for a in addrs[8 * p:8 * p + 8])
            for p in range(4)]


@WIDTHS
def test_row_stride_is_whole_float4s_in_distinct_banks(d):
    if d != 64:
        # split-TF32: lane (g, t) reads Q / K row g at column 4t (one float4
        # of a 16-column step) and V rows 2t and 2t + 1 at column 4g: each
        # quarter-warp's eight float4s fall in eight distinct 4-bank groups
        g = fa_tf32_fwd_geometry(d)
        assert g.qk_stride % 32 == 16 and g.v_stride % 32 == 4
        qk = [(lane // 4) * g.qk_stride + 4 * (lane % 4)
              for lane in range(32)]
        v0 = [2 * (lane % 4) * g.v_stride + 4 * (lane // 4)
              for lane in range(32)]
        v1 = [a + g.v_stride for a in v0]
        for addrs in (qk, v0, v1):
            assert all(b == list(range(8)) for b in _quarter_banks(addrs))
        return
    g = fa_fma_fwd_geometry(d)
    for stride in (g.row_stride, g.strip_stride):
        assert stride % 4 == 0
        # 8 consecutive rows' 16-byte chunks fall in 8 distinct groups of
        # 4 banks: the stride in chunks is odd
        chunks = stride // 4
        assert chunks % 2 == 1
        assert len({(r * chunks) % 8 for r in range(8)}) == 8


def _tf32_fragments_cover_a_warp_once(g):
    """S's accumulator over a tile's n-tiles covers each (row, key) of the
    warp once; p.V's A fragment (S's registers 0, 2, 1, 3) is p at (row,
    key_order[k position]) for every lane and register, and V's B
    fragment reads rows key_order[t] and key_order[t + 4] (2t, 2t + 1),
    so both products sum p times V over the same keys; the key order is a
    permutation of each group of 8; the score product's two steps take
    each of 16 columns once, the same for Q and K; o's accumulator covers
    each (row, d column) once."""
    scores = np.zeros((g.warp_rows, g.warp_keys), dtype=int)
    for lane in range(32):
        for j in range(g.warp_keys // 8):
            for row, key in g.score_entries(lane, j):
                scores[row, key] += 1
    assert (scores == 1).all()
    order = g.key_order
    assert sorted(order) == list(range(8))
    for lane in range(32):
        gg, t = lane // 4, lane % 4
        acc = g.score_entries(lane, 0)
        # a_i = (row g + 8 (i & 1), k position t + 4 (i >> 1)) = acc[[0, 2,
        # 1, 3][i]]
        for i, u in enumerate((0, 2, 1, 3)):
            row, key = acc[u]
            assert row == gg + 8 * (i & 1)
            assert key == order[t + 4 * (i >> 1)]
        # b0 / b1 of V: rows 2t and 2t + 1
        assert (order[t], order[t + 4]) == (2 * t, 2 * t + 1)
    steps = [g.depth_columns(s) for s in (0, 1)]
    assert sorted(steps[0] + steps[1]) == list(range(16))
    for lane in range(32):
        t = lane % 4
        # lane t's float4 (columns 4t .. 4t + 3): positions t, t + 4 of
        # step 0, then of step 1
        assert (steps[0][t], steps[0][t + 4], steps[1][t],
                steps[1][t + 4]) == tuple(range(4 * t, 4 * t + 4))
    outs = np.zeros((g.warp_rows, g.head_dim), dtype=int)
    for lane in range(32):
        for c in range(g.head_dim // 32):
            for e in range(4):
                for row, col in g.out_entries(lane, c, e):
                    outs[row, col] += 1
    assert (outs == 1).all()
    # a lane's columns of one row are 8 contiguous floats a group: two
    # float4 stores
    for lane in range(32):
        cols = sorted(col for c in range(g.head_dim // 32) for e in
                      range(4) for row, col in g.out_entries(lane, c, e)
                      if row == lane // 4)
        assert all(cols[8 * i:8 * i + 8] == list(range(cols[8 * i],
                                                       cols[8 * i] + 8))
                   for i in range(len(cols) // 8))


@WIDTHS
def test_micro_tiles_cover_a_warp_once(d):
    """d = 64: lane (ly, lx) = (lane // 16, lane % 16) holds rows ly + 2 i,
    keys lx + 16 j of S and d columns 64 g + 4 lx .. + 3 of o (g over the
    64-column groups): every (row, key) of the warp's rows over a tile and
    every (row, d column) exactly once, and a quarter-warp's 8 keys in 8
    distinct bank groups. d = 128 and 256: the split-TF32 kernel's mma
    fragments (``_tf32_fragments_cover_a_warp_once``)."""
    if d != 64:
        _tf32_fragments_cover_a_warp_once(fa_tf32_fwd_geometry(d))
        return
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
    """At the wider head dims' own blocks and tiles (the split-TF32
    kernel's: 64 rows over 32 keys at d = 128, 128 rows over 16 keys at d
    = 256): the grid covers every query row once and each block visits
    exactly the key tiles that hold an unmasked (query, key) pair."""
    g = fa_tf32_fwd_geometry(d)
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


@WIDE
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [15, 16, 17, 33, 64, 129, 200])
def test_wide_busy_warps_match_brute_force(s, causal, d):
    """The split-TF32 kernel's warps run a visited tile exactly when one
    of their 16 rows below sq sees one of their part's keys below sk (at
    d = 256 two warps share a row group, each half of a tile's keys), and
    the warps cover each (row, key) pair of a visited tile once."""
    g = fa_tf32_fwd_geometry(d)
    groups = g.block_rows // g.warp_rows
    assert g.threads // 32 == groups * g.key_split
    for qb in range(g.blocks(s)):
        for t in g.key_tiles(qb, s, s, causal):
            held = np.zeros((g.block_rows, g.tile_rows), dtype=int)
            for w in range(g.threads // 32):
                r0 = qb * g.block_rows + w % groups * g.warp_rows
                k0 = t * g.tile_rows + w // groups * g.warp_keys
                held[r0 - qb * g.block_rows:][:g.warp_rows,
                     k0 - t * g.tile_rows:][:, :g.warp_keys] += 1
                rows = np.arange(r0, min(r0 + g.warp_rows, s))
                keys = np.arange(k0, min(k0 + g.warp_keys, s))
                sees = bool(rows.size) and bool(keys.size) and (
                    not causal or bool((keys[None, :] <= rows[:, None])
                                       .any()))
                assert g.warp_busy(qb, w, t, s, causal, sk=s) == sees
            assert (held == 1).all()


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
