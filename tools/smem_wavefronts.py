#!/usr/bin/env python3
"""What a shared-memory load costs the SM, by the pattern of its addresses.

    python3 -m tools.smem_wavefronts

Needs a CUDA card and nvcc. Builds a small kernel that loads shared
memory in a loop (``ld.volatile.shared``, so that no load is merged or
hoisted; one add per load), one block of 32 warps on every SM, and
prints, for each pattern, the SM clock cycles per warp-wide load: with
the shared memory the limit, the wavefronts (128-byte passes) each load
takes. The patterns are those of the fp32 flash kernels' register-blocked
products (``csrc/fma_tiles.cuh``, ``csrc/flash_attention_bwd.cu``):
16-byte loads of 32 distinct addresses, of 8 (or 4) distinct addresses
read by all four quarter-warps (the streamed rows of a score), of 2
addresses a quarter-warp, of one address a quarter-warp (the block's own
rows) and of one address for the whole warp; 8-byte loads of 32 distinct
addresses, of the first halves of 8 distinct 16-byte chunks read by all
four quarter-warps and of one address a quarter; and 4-byte loads of 32
distinct addresses, of 8 read by all quarters and of one. Then the card's
name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

# name: (bytes a lane loads, the byte offset of lane l's address)
PATTERNS = {
    "v4_32_distinct": (16, "l * 16"),
    "v4_8_per_quarter_same": (16, "(l & 7) * 16"),
    "v4_4_per_quarter_same": (16, "(l & 3) * 16"),
    "v4_2_per_quarter": (16, "(l >> 2) * 16"),
    "v4_one_per_quarter": (16, "(l >> 3) * 16"),
    "v4_warp_broadcast": (16, "0"),
    "v2_32_distinct": (8, "l * 8"),
    "v2_8_per_quarter_same": (8, "(l & 7) * 16"),
    "v2_one_per_quarter": (8, "(l >> 3) * 8"),
    "f32_32_distinct": (4, "l * 4"),
    "f32_8_per_quarter_same": (4, "(l & 7) * 16"),
    "f32_warp_broadcast": (4, "0"),
}

_SRC = r"""
#include <cuda_runtime.h>
#define LOAD16(a)                                                     \
  asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"   \
               : "=f"(x), "=f"(y), "=f"(z), "=f"(w) : "r"(a))
#define LOAD8(a)                                                      \
  asm volatile("ld.volatile.shared.v2.f32 {%0, %1}, [%2];"           \
               : "=f"(x), "=f"(y) : "r"(a))
#define LOAD4(a) \
  asm volatile("ld.volatile.shared.f32 %0, [%1];" : "=f"(x) : "r"(a))
template <int kBytes, int kPattern>
__global__ void __launch_bounds__(1024, 1) probe(float* out,
                                                 long long* cycles,
                                                 int iters) {
  __shared__ __align__(16) float sm[8192];
  for (int i = threadIdx.x; i < 8192; i += blockDim.x) sm[i] = (float)i;
  __syncthreads();
  const int l = threadIdx.x & 31;
  const unsigned base = (unsigned)__cvta_generic_to_shared(sm);
  unsigned off = 0;
  switch (kPattern) {
PATTERN_CASES
  }
  float acc = 0.f, x = 0.f, y = 0.f, z = 0.f, w = 0.f;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const unsigned a =
          base + off + (unsigned)(((u + 16 * (it & 1)) * 512) & 16383);
      if (kBytes == 16) LOAD16(a);
      else if (kBytes == 8) LOAD8(a);
      else LOAD4(a);
      acc += x;
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc + y + z + w;
}
extern "C" int run(int which, float* out, long long* cycles, int iters,
                   int blocks) {
  switch (which) {
LAUNCH_CASES
  }
  return (int)cudaDeviceSynchronize();
}
"""


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("smem_wavefronts: no CUDA card", file=sys.stderr)
        return 2
    from apex_tpu_torch.ops import _build
    names = list(PATTERNS)
    cases = "\n".join(f"    case {i}: off = {PATTERNS[n][1]}; break;"
                      for i, n in enumerate(names))
    launches = "\n".join(
        f"    case {i}: probe<{PATTERNS[n][0]}, {i}><<<blocks, 1024>>>"
        f"(out, cycles, iters); break;" for i, n in enumerate(names))
    src = _SRC.replace("PATTERN_CASES", cases).replace("LAUNCH_CASES",
                                                       launches)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        cu, so = Path(tmp) / "probe.cu", Path(tmp) / "probe.so"
        cu.write_text(src)
        subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-shared",
                        str(cu), "-o", str(so)], check=True)
        lib = ctypes.CDLL(str(so))
        lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_int, ctypes.c_int]
        blocks = torch.cuda.get_device_properties(0).multi_processor_count
        out = torch.empty(blocks * 1024, device="cuda")
        cycles = torch.empty(blocks, dtype=torch.int64, device="cuda")
        iters = 256
        res = {}
        for i, name in enumerate(names):
            for _ in range(2):  # the second call is read
                assert lib.run(i, out.data_ptr(), cycles.data_ptr(), iters,
                               blocks) == 0
            loads = 32 * iters * 16  # warp-wide loads of one SM
            res[name] = cycles.double().mean().item() / loads
        print(json.dumps({"cycles_per_warp_load": res,
                          "warps_per_sm": 32}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
