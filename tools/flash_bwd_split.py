#!/usr/bin/env python3
"""Where the flash backward pair's time goes, tile by tile.

    python3 -m tools.flash_bwd_split [ROOT] [--route bf16|fp32]
                                     [--shape B,H,SQ,SK,CAUSAL,D]
                                     [--forms plain,dropout,bias,dlogits]
                                     [--reps N]
                                     [--sub 'OLD=>NEW' ...]
    python3 -m tools.flash_bwd_split [ROOT] --ptxas-only [--route ...]
                                     [--sub ...] [--spills dkv:128,1,1]

Needs a CUDA card and nvcc. Builds two copies of the dq and dK·dV
kernels of one route of the checkout at ROOT (by default this one): bf16,
the tensor-core pair (``apex_tpu_torch/csrc/flash_bwd_{dq,dkv}_wgmma.cu``),
or fp32, the FMA-pipe pair (``apex_tpu_torch/csrc/flash_attention_bwd.cu``,
both kernels in one source), each into its own shared library: one as the
source stands, one with ``clock64()`` stamps. The stamps are the sources'
``APEX_SPLIT(slot, tile, "phase")`` points (empty in the port's build,
``hopper.cuh`` and ``flash_attention_bwd.cu``); a source without them (the
bf16 sources before the redesign of the pair at d = 128, the fp32 source
before that at d = 256) gets them inserted beside the statements of
``_PARENT_ANCHORS``. At a stamp the first thread of each 128-thread group
(a consumer warpgroup of the bf16 pair; the fp32 pair's first four warps,
and its next four where a block has eight) writes the SM's clock into slot ``slot`` of
tile ``tile`` (its count of tiles from 0).

For each kernel and form (``bias``: a learned-like (1, h, sq, sk) bias;
``dlogits``: the same bias and dq's dlogits, dK·dV with the bias alone),
at the shape given (by default Cerebras-GPT 1.3B's causal attention, 2 x
16 x 2048 x 128), on inputs of the route's dtype, prints one JSON line:
mean cycles a warpgroup spends per tile in each phase (the cycles from
one stamp to the next, over every tile that reached all of its stamps),
the mean tile (its first stamp to its last), the tiles counted, both
copies' device ms (CUDA events, inputs rotated beyond the L2) and ptxas's
registers and spills of both. The stamps' own cost is the difference of
the two times. Then the card's name and power limit.

``--sub`` replaces text in both sources and the headers beside them
before the build (a variant of the design, timed or compiled beside the
tree's); ``--no-stamps`` builds and times only the copies as they stand;
``--ptxas-only`` builds the copies as they stand and prints, for
each kernel, every instantiation's registers, spills and any serialised
wgmma pipeline (ptxas) with the highest register its SASS uses, and with
``--spills`` the SASS around each spill of one instantiation.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

# each route's kernels: (source, kernel, C entry)
ROUTES = {
    "bf16": {"dq": ("flash_bwd_dq_wgmma.cu", "fa_bwd_dq_kernel_wgmma",
                    "apex_fa_bwd_dq_wgmma"),
             "dkv": ("flash_bwd_dkv_wgmma.cu", "fa_bwd_dkv_kernel_wgmma",
                     "apex_fa_bwd_dkv_wgmma")},
    "fp32": {"dq": ("flash_attention_bwd.cu", "fa_bwd_dq_kernel_fma",
                    "apex_fa_bwd_dq"),
             "dkv": ("flash_attention_bwd.cu", "fa_bwd_dkv_kernel_fma",
                     "apex_fa_bwd_dkv")}}
KERNELS = ROUTES["bf16"]
SLOTS = 8

# The stamps of a source without APEX_SPLIT points (the bf16 pair before
# its redesign at d = 128, keys "dq" and "dkv"; the fp32 pair before its
# redesign at d = 256, "fp32_dq" and "fp32_dkv"): (statement, the text
# after it that makes it unique, stamps before it, stamps after it)
_PARENT_ANCHORS = {
    "dkv": [
        ("mbar_wait(&full[st], (i / kStages) & 1);", "",
         [(0, "i", "start")], [(1, "i", "wait full")]),
        ("fence_regs(tp);", "", [], [(2, "i", "S^T, dP^T")]),
        ("to_a_operand(s, ap);", "", [(3, "i", "p, ds")], []),
        ("to_a_operand(tp, ads);", "", [], [(4, "i", "pack")]),
        ("fence_regs(ads);", "\n      }", [], [(5, "i", "dV, dK")]),
    ],
    "dq": [
        ("mbar_wait(&full[st], (kt / kStages) & 1);",
         "\n      const uint32_t", [(0, "kt", "start")],
         [(1, "kt", "wait full")]),
        ("if (kt > 0) mbar_arrive(&empty[(kt - 1) % kStages]);", "",
         [(2, "kt", "S, dP (+ the previous dQ)")], []),
        ("to_a_operand(s, ads);", "", [(3, "kt", "p, ds")],
         [(4, "kt", "pack")]),
        ("wgmma_commit();", "\n    }\n    wgmma_wait<0>();", [],
         [(5, "kt", "dQ issue")]),
    ],
    "fp32_dq": [
        ("  for (int kt = 0; kt < nk; ++kt) {", "", [],
         [(0, "kt", "start")]),
        ("    __syncthreads();", "\n    if (kt + 1 < nk) {", [],
         [(1, "kt", "wait tile")]),
        ("    if (kt == 0) {  // dO and the first V", "",
         [(2, "kt", "S, p")], []),
        ("      group_sync<G::kSplit>(grp);  // the group's strip rows are "
         "whole", "\n      // the 32-column groups of the warp's part of d, "
         "a product each", [(3, "kt", "dP, ds")],
         [(4, "kt", "group barrier")]),
        ("    } else if (kDbias) {  // rows past sq", "",
         [(5, "kt", "dQ")], []),
    ],
    "fp32_dkv": [
        ("  for (int it = 0; it < nq; ++it) {", "", [],
         [(0, "it", "start")]),
        ("    __syncthreads();", "\n    if (it + 1 < nq) {", [],
         [(1, "it", "wait tile")]),
        ("    if (it == 0) {  // V, the first dO and D", "",
         [(2, "it", "S^T, p")], []),
        ("      group_sync<G::kSplit>(grp);  // the group's strip rows are "
         "whole", "\n      // the 32-column groups of the warp's part of d, "
         "a loop each", [(3, "it", "dP^T, ds")],
         [(4, "it", "group barrier")]),
        ("                         dst + r0 * kSStride, qs + col);\n      }",
         "\n    }\n  }", [], [(5, "it", "dV, dK")]),
    ],
}

# -include'd before the stamped copy: the stamp and the entry that points
# it at a buffer of (block, warpgroup, tile, slot) clocks
_STAMP_HEADER = r"""
#pragma once
#include <cuda_runtime.h>
__device__ unsigned long long* apex_split_buf;
__device__ int apex_split_tiles;
#define APEX_SPLIT(slot, tile, name)                                        \
  do {                                                                      \
    if ((threadIdx.x & 127) == 0 && threadIdx.x < 256) {                    \
      const unsigned long long b_ =                                         \
          blockIdx.x + (unsigned long long)gridDim.x *                      \
                           (blockIdx.y + (unsigned long long)gridDim.y *    \
                                             blockIdx.z);                   \
      apex_split_buf[((b_ * 2 + threadIdx.x / 128) * apex_split_tiles +     \
                      (tile)) * 8 + (slot)] = clock64();                    \
    }                                                                       \
  } while (0)
extern "C" int apex_split_set(void* buf, int tiles) {
  cudaMemcpyToSymbol(apex_split_buf, &buf, sizeof(buf));
  cudaMemcpyToSymbol(apex_split_tiles, &tiles, sizeof(int));
  return (int)cudaGetLastError();
}
"""

_POINT = re.compile(r'APEX_SPLIT\((\d+),\s*(\w+),\s*"([^"]*)"\)')


def stamped(text: str, which: str) -> str:
    """The source with its stamps: its own APEX_SPLIT points, or those of
    _PARENT_ANCHORS[which] inserted."""
    if _POINT.search(text):
        return text
    for stmt, follow, before, after in _PARENT_ANCHORS[which]:
        if text.count(stmt + follow) != 1:
            raise SystemExit(f"{which}: anchor {stmt + follow!r} found "
                             f"{text.count(stmt + follow)} times")
        pre = "".join(f'APEX_SPLIT({s}, {t}, "{n}"); ' for s, t, n in before)
        post = "".join(f' APEX_SPLIT({s}, {t}, "{n}");'
                       for s, t, n in after)
        text = text.replace(stmt + follow, pre + stmt + post + follow)
    return text


# a function of the fp32 source whose name says its kernel (dq_rows,
# dkv_depth, fa_bwd_dq_kernel_fma, ...)
_FUNC = re.compile(r"\n(?:__device__|__global__)(?:[^;{(]|\([^)]*\))*?"
                   r"\b((?:fa_bwd_|dq_|dkv_)\w*)\s*\(")


def kernel_text(text: str, which: str) -> str:
    """The functions of a source holding both kernels (the fp32 pair's)
    that belong to kernel ``which`` ("dq" or "dkv"), joined."""
    marks = list(_FUNC.finditer(text))
    out = []
    for m, nxt in zip(marks, marks[1:] + [None]):
        name = m.group(1)
        if name.startswith(f"{which}_") or name.startswith(
                f"fa_bwd_{which}_"):
            out.append(text[m.start():nxt.start() if nxt else len(text)])
    return "".join(out)


def phases(text: str) -> dict:
    """``{slot: phase name}`` of the stamped source's points (the names of
    one slot in the tiles of two layouts, by rows at d = 64 and by depth at
    d = 128 and 256, joined by " | ")."""
    out = {}
    for m in _POINT.finditer(text):
        names = out.setdefault(int(m.group(1)), [])
        if m.group(3) not in names:
            names.append(m.group(3))
    return {slot: " | ".join(names) for slot, names in out.items()}


def build(root: Path, tmp: Path, flags: list, subs=(),
          stamps=(False, True), route: str = "bf16") -> dict:
    """The copies of the route's sources (``subs``, ``(old, new)`` pairs,
    replaced in each), built together: ``{(which, stamped): (library path,
    ptxas text, phases)}``."""
    from apex_tpu_torch.ops import _build
    csrc = root / "apex_tpu_torch" / "csrc"
    header = tmp / "apex_split.cuh"
    header.write_text(_STAMP_HEADER)
    jobs = {}
    for which, (src, _, _) in ROUTES[route].items():
        anchors = which if route == "bf16" else f"{route}_{which}"
        for stamp in stamps:
            d = tmp / f"{which}_{int(stamp)}"
            d.mkdir()
            for h in csrc.glob("*.cuh"):
                head = h.read_text()
                for old, new in subs:
                    head = head.replace(old, new)
                (d / h.name).write_text(head)
            text = (csrc / src).read_text()
            for old, new in subs:
                text = text.replace(old, new)
            if stamp:
                text = stamped(text, anchors)
            (d / src).write_text(text)
            cmd = [_build.nvcc(), *flags, "-Xptxas", "-v", "-shared",
                   *(["-include", str(header)] if stamp else []),
                   str(d / src), "-o", str(d / "lib.so")]
            jobs[(which, stamp)] = (d, text, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    out = {}
    for key, (d, text, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc {key}:\n{log}")
        out[key] = (d / "lib.so", log, phases(
            text if route == "bf16" else kernel_text(text, key[0])))
    return out


def ptxas(log: str, kernel: str) -> dict:
    """``{template arguments: [registers, spill bytes stored, loaded, any
    serialisation warning]}`` of ``kernel``'s instantiations in a
    ``-Xptxas -v`` log (``"128,0,1,0"``: d = 128, no bias, dropout, no
    dlogits)."""
    inst = kernel + r"I((?:L[ib]\d+E)+)E"
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(inst, line)
        key = ",".join(re.findall(r"L[ib](\d+)E", m.group(1))) if m else None
        if "serialized" in line and key:
            out.setdefault(key, [None, None, None]).append(
                line.split(":", 2)[-1].strip())
        if "Compiling entry function" in line:
            name = key
            if name:
                out.setdefault(name, [None, None, None])
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name][1:3] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name][0] = int(m.group(1))
    return out


def sass_registers(so: Path, kernel: str) -> dict:
    """``{template arguments: highest register + 1}`` of ``kernel``'s
    instantiations in a library's SASS (``cuobjdump -sass``): above the
    launch bound's 168 where a warpgroup's ``setmaxnreg.inc`` took more."""
    from apex_tpu_torch.ops import _build
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, timeout=300).stdout
    out, key = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            m = re.search(kernel + r"I((?:L[ib]\d+E)+)E", line)
            key = (",".join(re.findall(r"L[ib](\d+)E", m.group(1)))
                   if m else None)
            if key:
                out[key] = 0
        elif key:
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", line)]
            if regs:
                out[key] = max(out[key], max(regs) + 1)
    return out


def sass_spills(so: Path, kernel: str, args: str, context: int = 6) -> list:
    """The SASS lines around each local-memory spill (STL / LDL) of the
    instantiation of ``kernel`` with template arguments ``args``
    (``"128,1,1"``)."""
    from apex_tpu_torch.ops import _build
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, timeout=300).stdout
    lines, body = text.splitlines(), None
    for n, line in enumerate(lines):
        if "Function :" in line:
            m = re.search(kernel + r"I((?:L[ib]\d+E)+)E", line)
            found = m and ",".join(re.findall(r"L[ib](\d+)E",
                                              m.group(1))) == args
            if body is not None:
                break
            if found:
                body = []
        elif body is not None:
            body.append(line.strip())
    out = []
    for n, line in enumerate(body or []):
        if re.search(r"\b(STL|LDL)\b", line):
            out.append(body[max(0, n - context):n + context + 1])
    return out


def stamp_counts(root: Path, d: int, sq: int, sk: int,
                 route: str = "bf16") -> tuple:
    """``(tiles, blocks)`` that a stamp buffer must hold for the tree at
    ROOT at head dim ``d``: the most tiles a consumer warpgroup counts
    (dq: key tiles, dk / dv: query tiles) and the most row blocks either
    kernel has over one head, from that tree's own geometry (its
    ``ops/tiling.py``, loaded from ROOT: two trees may lay the kernels out
    differently): ``fa_tc_geometry(d)`` of the bf16 pair, whose trees
    without per-kernel tiles stream 64-row tiles in blocks of at least 64
    rows, or ``fa_fma_bwd_geometry(d)`` of the fp32 pair."""
    spec = importlib.util.spec_from_file_location(
        "_split_tiling", root / "apex_tpu_torch" / "ops" / "tiling.py")
    tiling = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = tiling  # its dataclasses look themselves up
    try:
        spec.loader.exec_module(tiling)
        g = (tiling.fa_tc_geometry(d) if route == "bf16"
             else tiling.fa_fma_bwd_geometry(d))
    finally:
        del sys.modules[spec.name]
    if route != "bf16":
        return (max(-(-sk // g.tile_rows), -(-sq // g.tile_rows)),
                max(g.blocks(sq), g.blocks(sk)))
    if not hasattr(g, "dq_tile_rows"):
        return max(-(-sq // 64), -(-sk // 64)), -(-max(sq, sk) // 64)
    return (max(-(-sk // g.dq_tile_rows), -(-sq // g.dkv_tile_rows)),
            max(g.dq_blocks(sq), g.dkv_blocks(sk)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?", default=".")
    ap.add_argument("--route", choices=sorted(ROUTES), default="bf16",
                    help="bf16: the tensor-core pair; fp32: the FMA pair")
    ap.add_argument("--shape", default="2,16,2048,2048,1,128")
    ap.add_argument("--forms", default="plain,dropout")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sub", action="append", default=[],
                    help="OLD=>NEW, replaced in both kernel sources and the "
                         "headers beside them")
    ap.add_argument("--spills", default=None, metavar="KERNEL:ARGS",
                    help="with --ptxas-only, print the SASS around each "
                         "spill of one instantiation (dkv:128,1,1)")
    ap.add_argument("--ptxas-only", action="store_true",
                    help="build the copies as they stand and print ptxas's "
                         "report of each; time nothing")
    ap.add_argument("--no-stamps", action="store_true",
                    help="build and time only the copies as they stand "
                         "(half the build): no phases")
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_split: no CUDA card", file=sys.stderr)
        return 2
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops.flash_attention import (
        attention_dvec, dropout_scale, dropout_threshold,
        flash_attention_fwd)
    from apex_tpu_torch.ops.tiling import fa_batch_heads_grid
    b, h, sq, sk, causal, d = (int(x) for x in a.shape.split(","))
    dev = torch.device("cuda", 0)
    root = Path(a.root).resolve()
    subs = [tuple(x.split("=>", 1)) for x in a.sub]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if a.ptxas_only:
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
            libs = build(root, Path(tmp), _build.NVCC_FLAGS, subs, (False,),
                         a.route)
            for which, (_, kernel, _) in ROUTES[a.route].items():
                so, log, _ = libs[(which, False)]
                print(json.dumps({"kernel": which, "route": a.route,
                                  "subs": a.sub,
                                  "ptxas": ptxas(log, kernel),
                                  "sass_registers": sass_registers(
                                      so, kernel)}), flush=True)
                if a.spills and a.spills.split(":")[0] == which:
                    for block in sass_spills(so, kernel,
                                             a.spills.split(":")[1]):
                        print("\n".join(block), "\n----", flush=True)
        return 0
    _build.lib()  # the port's forward gives o and lse
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        stamps = (False,) if a.no_stamps else (False, True)
        libs = build(root, Path(tmp), _build.NVCC_FLAGS, subs, stamps,
                     a.route)
        dtype = torch.bfloat16 if a.route == "bf16" else torch.float32
        tail = () if a.route == "bf16" else (0,)  # the fp32 entries' dtype
        gen = torch.Generator(device=dev).manual_seed(0)
        nset = max(2, -(-2 * 50 * 2 ** 20 // (5 * b * h * sq * d * 2)))
        seed = torch.tensor([1234], dtype=torch.int32, device=dev)
        for form in a.forms.split(","):
            rate = 0.1 if form == "dropout" else 0.0
            drop = ((seed.data_ptr(), dropout_threshold(rate),
                     dropout_scale(rate)) if rate else (None, 0, 0.0))
            bias = (torch.randn(1, h, sq, sk, device=dev, generator=gen)
                    if form in ("bias", "dlogits") else None)
            strides = (0, sq * sk, sk, 1) if bias is not None else (0,) * 4
            dlogits = (torch.empty(b * h * sq * sk, device=dev)
                       if form == "dlogits" else None)
            sets = []
            for _ in range(nset):
                q, k, v, do = (torch.randn(b, h, n, d, device=dev,
                                           generator=gen)
                               .to(dtype) for n in (sq, sk, sk, sq))
                kw = dict(dropout_p=rate, dropout_seed=seed) if rate else {}
                o, lse = flash_attention_fwd(q, k, v, scale=d ** -0.5,
                                             causal=bool(causal), bias=bias,
                                             **kw)
                sets.append((q, k, v, do, lse, attention_dvec(o, do),
                             torch.empty_like(q), torch.empty_like(k),
                             torch.empty_like(v)))
            geo = (b * h, *fa_batch_heads_grid(b * h), h, sq, sk, d,
                   d ** -0.5, causal, *strides, *drop)
            for which, (src, kernel, entry) in ROUTES[a.route].items():
                rec = {"kernel": which, "route": a.route, "form": form,
                       "shape": a.shape, "subs": a.sub}
                for stamp in stamps:
                    so, log, names = libs[(which, stamp)]
                    lib = ctypes.CDLL(str(so))
                    fn = getattr(lib, entry)
                    fn.argtypes = _build.SIGNATURES[entry]
                    fn.restype = ctypes.c_int

                    def call(s):
                        q, k, v, do, lse, dvec, dq, dk, dv = s
                        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                None if bias is None else bias.data_ptr(),
                                do.data_ptr(), lse.data_ptr(),
                                dvec.data_ptr())
                        stream = torch.cuda.current_stream().cuda_stream
                        if which == "dq":
                            err = fn(*args, dq.data_ptr(), *geo,
                                     None if dlogits is None
                                     else dlogits.data_ptr(), *tail, stream)
                        else:
                            err = fn(*args, dk.data_ptr(), dv.data_ptr(),
                                     *geo, *tail, stream)
                        if err:
                            raise RuntimeError(f"{entry}: cudaError {err}")
                    tiles, blocks = stamp_counts(root, d, sq, sk, a.route)
                    buf = torch.zeros(blocks * b * h * 2 * tiles * SLOTS,
                                      dtype=torch.int64, device=dev)
                    if stamp:
                        lib.apex_split_set.argtypes = [ctypes.c_void_p,
                                                       ctypes.c_int]
                        assert lib.apex_split_set(buf.data_ptr(), tiles) == 0
                    for s in sets[:2]:
                        call(s)
                    torch.cuda.synchronize()
                    e0, e1 = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                    e0.record()
                    for i in range(a.reps):
                        call(sets[i % len(sets)])
                    e1.record()
                    torch.cuda.synchronize()
                    tag = "stamped" if stamp else "plain"
                    rec[f"{tag}_ms"] = e0.elapsed_time(e1) / a.reps
                    rec[f"{tag}_ptxas"] = ptxas(log, kernel)
                    if not stamp:
                        continue
                    buf.zero_()
                    call(sets[0])
                    torch.cuda.synchronize()
                    # the slots this layout stamps
                    view = buf.view(-1, tiles, SLOTS)
                    used = [s for s in sorted(names)
                            if bool((view[:, :, s] > 0).any())]
                    t = view[:, :, used].double()
                    full = (t > 0).all(-1)
                    t = t[full]
                    rec["tiles"] = int(full.sum())
                    rec["phases"] = {
                        names[used[i + 1]]: (t[:, i + 1] - t[:, i])
                        .mean().item() for i in range(len(used) - 1)}
                    rec["tile_cycles"] = (t[:, -1] - t[:, 0]).mean().item()
                print(json.dumps(rec), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
