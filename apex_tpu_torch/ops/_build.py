"""Build and load the port's CUDA kernels.

Every ``apex_tpu_torch/csrc/*.cu`` (with the shared ``*.cuh`` headers
beside them) is compiled with ``nvcc`` for
``sm_90a`` at first use, one ``nvcc`` process per source started
together, and the objects are linked into one shared library with a plain
C interface, loaded with :mod:`ctypes`. Pointers and the stream go over as
``c_void_p``; each C entry returns ``cudaGetLastError()`` after its launch
and :func:`check` raises when that is not 0.

The library lands in ``apex_tpu_torch/_build/`` under a name that carries
a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is loaded as it is. Without ``nvcc`` the build raises: there
is no prebuilt library and no CPU stand-in for a CUDA tensor.

``launches`` counts kernel launches by name. Each wrapper adds one where it
launches its kernel and nowhere else, so a caller can zero the counts,
drive a path and read which kernels that path went through;
``route_launches`` splits the flash wrappers' counts by route (the
tensor-core, split-TF32 or FMA-pipe kernels) and ``form_launches`` counts
their dropout and dlogits forms, their launches at head widths 128 and 256
and those of calls padded to a compiled width.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_vp = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong
_f = ctypes.c_float
_u64 = ctypes.c_ulonglong
_u = ctypes.c_uint
# C signatures of the entries the wrappers call (all return cudaError_t)
SIGNATURES = {
    # x, gamma, beta (both may be null), y, mean, invvar, rows, hidden,
    # eps, rms, dtype, stream
    "apex_ln_fwd": [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _f, _i, _i, _vp],
    # dy, x, gamma, mean, invvar, dx, part_g, part_b, dgamma, dbeta (gamma
    # and the four last may be null), rows, hidden, form, vectors, warps,
    # blocks (tiling.ln_bwd_geometry), rms, dtype, stream
    "apex_ln_bwd": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i,
                    _i, _i, _i, _i, _i, _i, _i, _vp],
    # q, k, v, bias (may be null), o, lse, bh, grid_y, grid_z, heads, sq,
    # sk, d, scale, causal, the bias's four strides, the dropout seed
    # (int32 on the device; null: no dropout), its uint32 threshold and
    # keep factor, dtype, stream
    "apex_fa_fwd": [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i,
                    _i, _f, _i, _ll, _ll, _ll, _ll, _vp, _u, _f, _i, _vp],
    # the same without dtype: the bf16 tensor-core forward
    "apex_fa_fwd_wgmma": [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i,
                          _i, _i, _f, _i, _ll, _ll, _ll, _ll, _vp, _u, _f,
                          _vp],
    # the same: the fp32 split-TF32 forward (d 128 or 256)
    "apex_fa_fwd_tf32": [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i,
                         _i, _i, _f, _i, _ll, _ll, _ll, _ll, _vp, _u, _f,
                         _vp],
    # d, bias, dropout, out int: the blocks of that form of the split-TF32
    # forward an SM holds at once
    "apex_fa_fwd_tf32_occupancy": [_i, _i, _i, _vp],
    # q, k, v, bias, do, lse, dvec, dq, bh, grid_y, grid_z, heads, sq, sk,
    # d, scale, causal, the bias's four strides, the dropout seed,
    # threshold and keep factor, dlogits (fp32 [bh, sq, sk]; null: none),
    # dtype, stream
    "apex_fa_bwd_dq": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i,
                       _i, _i, _i, _i, _f, _i, _ll, _ll, _ll, _ll, _vp, _u,
                       _f, _vp, _i, _vp],
    # q, k, v, bias, do, lse, dvec, dk, dv, bh, grid_y, grid_z, heads, sq,
    # sk, d, scale, causal, the bias's four strides, the dropout seed,
    # threshold and keep factor, dtype, stream
    "apex_fa_bwd_dkv": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i,
                        _i, _i, _i, _i, _i, _i, _f, _i, _ll, _ll, _ll, _ll,
                        _vp, _u, _f, _i, _vp],
    # d, kernel (0 dq, 1 dk / dv), bias, dropout, dlogits, out int: the
    # blocks of that fp32 FMA-pipe kernel an SM holds at once
    "apex_fa_bwd_fma_occupancy": [_i, _i, _i, _i, _i, _vp],
    # the same without dtype: the bf16 tensor-core dq kernel
    "apex_fa_bwd_dq_wgmma": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i,
                             _i, _i, _i, _i, _i, _i, _f, _i, _ll, _ll, _ll,
                             _ll, _vp, _u, _f, _vp, _vp],
    # the same without dtype: the bf16 tensor-core dk / dv kernel
    "apex_fa_bwd_dkv_wgmma": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                              _i, _i, _i, _i, _i, _i, _i, _f, _i, _ll, _ll,
                              _ll, _ll, _vp, _u, _f, _vp],
    # p, g, m, v, scalars, n, mode, dtype (of p and g), stream
    "apex_fused_adam": [_vp, _vp, _vp, _vp, _vp, _ll, _i, _i, _vp],
    # p_master, g, m, v, p_lp (bf16, written), scalars, n, mode, stream
    "apex_fused_adam_master": [_vp, _vp, _vp, _vp, _vp, _vp, _ll, _i, _vp],
    # p, g, momentum buffer, scalars, n, nesterov, wd_after_momentum,
    # dtype (of p and g), stream
    "apex_fused_sgd": [_vp, _vp, _vp, _vp, _ll, _i, _i, _i, _vp],
    # p, g, m, denominators, row_ids, scalars, rows, stream
    "apex_fused_novograd": [_vp, _vp, _vp, _vp, _vp, _vp, _ll, _vp],
    # p, g, h, scalars, n, w_mode, stream
    "apex_fused_adagrad": [_vp, _vp, _vp, _vp, _ll, _i, _vp],
    # p, g, m, v, u, row_p, row_u, scalars, rows, adam_w, stream
    "apex_lamb_stage1": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _ll, _i,
                         _vp],
    # p, u, ratios, row_ids, scalars, rows, stream
    "apex_lamb_stage2": [_vp, _vp, _vp, _vp, _vp, _ll, _vp],
    # x, w, b (both may be null), y, dmean, rstd, n, hw, c, groups, eps,
    # silu, route, slice_c, cluster, pixels, threads
    # (tiling.gn_one_pass_geometry), dtype, stream
    "apex_gn_one_pass": [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _f,
                         _i, _i, _i, _i, _i, _i, _i, _vp],
    # x, shift, psum, psq, n, hw, c, groups, hw_block, route, rows,
    # threads, slots a stats block (stats_tiles;
    # tiling.gn_two_pass_geometry), dtype, stream
    "apex_gn_stats": [_vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i,
                      _i, _i, _vp],
    # x, shift, dmean, rstd, w, b (both may be null), y, n, hw, c, groups,
    # hw_block, route, rows, threads, silu, dtype, stream
    "apex_gn_apply": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i,
                      _i, _i, _i, _i, _i, _vp],
    # x, mask (may be null), mask plan (20 long longs, null without a
    # mask), y, rows, sq, sk, scale, causal, dtype, stream
    "apex_softmax_fwd": [_vp, _vp, _vp, _vp, _ll, _i, _i, _f, _i, _i, _vp],
    # y, dy, dx, rows, sk, scale, dtype, stream
    "apex_softmax_bwd": [_vp, _vp, _vp, _ll, _i, _f, _i, _vp],
    # the IPC arenas: nbytes, device, out pointer / pointer, out handle /
    # handle, device, out pointer / pointer / pointer
    "apex_ipc_alloc": [_ll, _i, _vp],
    "apex_ipc_handle": [_vp, _vp],
    "apex_ipc_open": [_vp, _i, _vp],
    "apex_ipc_close": [_vp],
    "apex_ipc_free": [_vp],
    # src, dst (peer), copy plan (nine long longs, remote_copy.CopyPlan),
    # ack, ack_need, timeout_ns, stream
    "apex_peer_put": [_vp, _vp, _vp, _vp, _u64, _u64, _vp],
    # src_lo, dst_lo (left's hi), plan_lo, src_hi, dst_hi (right's lo),
    # plan_hi, ack_out_left, ack_out_right, ack_in_left, ack_in_right,
    # prev, timeout_ns, stream
    "apex_halo_put": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                      _u64, _u64, _vp],
    # flags to release first and their values (f0, v0, f1, v1; a flag may
    # be null), ready, epoch, landing, out, copy plan (the three may be
    # null), timeout_ns, stream
    "apex_peer_wait": [_vp, _u64, _vp, _u64, _vp, _u64, _vp, _vp, _vp, _u64,
                       _vp],
}

launches: collections.Counter = collections.Counter()
# the same launches by route, for the wrappers whose call runs one of
# several kernels: ``"<name>:<route>"`` (the flash wrappers:
# ``fa_fwd:wgmma``, ``fa_fwd:tf32``, ``fa_bwd_dq:fma``, ...; see
# tiling.fa_fwd_route and tiling.fa_route)
route_launches: collections.Counter = collections.Counter()
# the flash wrappers' launches of a kernel's optional forms, as
# ``"<name>:<route>:<form>"``: ``fa_fwd:wgmma:dropout``,
# ``fa_bwd_dkv:fma:dropout``, the dq kernel's dlogits
# ``fa_bwd_dq:wgmma:dbias``, ``fa_fwd:tf32:d128:dropout``, ...; at head
# width 128 or 256 each launch
# also counts ``"<name>:<route>:d128"`` (``d256``) and its forms carry the
# width (``fa_bwd_dq:fma:d256:dbias``); a call at a head dim that is not
# compiled, run zero-padded, counts ``"<name>:<route>:pad<d>"``
# (``fa_fwd:wgmma:pad80``); d = 64's launches keep the keys without a
# width
form_launches: collections.Counter = collections.Counter()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    launches.clear()
    route_launches.clear()
    form_launches.clear()


def sources() -> list:
    """The translation units, one ``nvcc`` each."""
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # sources and shared headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
        path = str(cand / "nvcc") if (cand / "nvcc").exists() else None
    if path is None:
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the apex_tpu_torch "
            "CUDA kernels are built from csrc/*.cu at first use and there "
            "is no prebuilt library")
    return path


def _run_all(cmds) -> None:
    """Run the commands together and raise with the compiler's output if
    any of them fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    tag = _digest()
    so = BUILD_DIR / f"libapex_tpu_torch_{tag}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    # every file this process writes carries its pid, so processes that
    # build in one checkout at once never read each other's half-written
    # objects; the finished library lands under its final name atomically
    pid = os.getpid()
    objs = [BUILD_DIR / f"{s.stem}_{tag}.{pid}.o" for s in srcs]
    tmp = so.with_name(f"{so.name}.{pid}.tmp")
    try:
        _run_all([[cc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                  for s, o in zip(srcs, objs)])
        _run_all([[cc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
                   str(tmp)]])
        os.replace(tmp, so)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(err: int, name: str) -> None:
    """Raise when a C entry reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError "
                           f"{err}")
