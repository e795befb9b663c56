"""Count, on the host, how K6 splits the soft step's two rows at a shape.

    python -m fourd_ray_tracing_tpu_torch.tools.soft_rows [W H S B]

K6's sweep of row b (the scene with its sphere zeroed) runs only where
row b traces apart from row a: on the pixels whose bounce 0 hits the
sphere (row b sweeps them whole), and on the samples of the other pixels
whose path hits it (csrc/gradkernel.cu, adjoint.cuh soft_row_sweep). This
tool builds the kernels' own per-pixel code (trace.cuh, adjoint.cuh) with
g++ and counts those pixels and samples at the soft bench's scene, object
and camera (room_with_sphere, sphere 0, the bench camera, seed 1; default
1280x720, 8 spp, 4 bounces), then the rounds the card's sweeps run per
warp of 32 pixels: row b's sweep runs as many rounds as the busiest lane
of the warp has samples. One JSON line; the counts are exact, no time is
measured.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

from fourd_ray_tracing_tpu_torch.models import library, params
from fourd_ray_tracing_tpu_torch.ops.cuda import build
from fourd_ray_tracing_tpu_torch.tools import common

SHIM = r"""
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __launch_bounds__(x)
inline float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }
inline int __ffs(int x) { return __builtin_ffs(x); }
"""

COUNT = r"""
#include "adjoint.cuh"

// Per pixel of view 0: whether bounce 0 hits the zero map's sphere, and
// else the mask of the samples whose recorded path hits it.
extern "C" int count(const float* P, const int* layout, int n_zero, const int* zero_idx,
                     const float* zero_val, int width, int height, int samples, int R,
                     float indent, uint32_t seed, int* whole, int* mask) {
  Layout L;
  memcpy(&L, layout, sizeof(int) * kLayoutInts);
  ZeroMap zm;
  zm.n = n_zero;
  for (int i = 0; i < n_zero; ++i) {
    zm.idx[i] = zero_idx[i];
    zm.val[i] = zero_val[i];
  }
  const int obj = zero_map_object(L, zm);
  for (int lin = 0; lin < width * height; ++lin) {
    const Pixel p = setup_pixel(P, L, 0, lin % width, lin / width, width, height, indent);
    whole[lin] = obj < 0 || (p.h0.hit && p.h0.idx == obj);
    mask[lin] = 0;
    if (whole[lin] || !p.h0.hit || R <= 0) continue;
    for (int s = 0; s < samples; ++s) {
      Bounce rec[kMaxBounces];
      bool mirror0;
      V4 v0;
      const int n = record_sample<kMaxBounces>(P, L, p, s, seed, R, indent, rec, mirror0, v0);
      for (int i = 0; i < n; ++i) {
        if (rec[i].hit && rec[i].idx == obj) mask[lin] |= 1 << s;
      }
    }
  }
  return obj;
}
"""


def main(argv=None) -> int:
    args = common.parse_tool_args(__doc__, argv, calls=1, rounds=1)
    width, height, samples, bounces = args.shape
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no g++ to build the kernels' per-pixel code for the host")
    scene, camera = library.room_with_sphere("cpu"), common.default_camera("cpu")
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    zero_map = params.soft_zero_map(scene, camera, ("spheres", 0))
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        (work / "cuda_runtime.h").write_text(SHIM)
        (work / "count.cpp").write_text(COUNT)
        subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                        *build.DEFINES, f"-I{work}", f"-I{build.CSRC_DIR}", "-o",
                        str(work / "count.so"), str(work / "count.cpp")], check=True)
        lib = ctypes.CDLL(str(work / "count.so"))
        whole = np.zeros(width * height, np.int32)
        mask = np.zeros(width * height, np.int32)
        ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
        idx = np.array([i for i, _ in zero_map], np.int32)
        val = np.array([v for _, v in zero_map], np.float32)
        obj = lib.count(ptr(packed), (ctypes.c_int * len(lay))(*lay), len(idx), ptr(idx),
                        ptr(val), width, height, samples, bounces, ctypes.c_float(0.005),
                        ctypes.c_uint32(1), ptr(whole), ptr(mask))
    alone = np.array([bin(m).count("1") for m in mask])
    warps = lambda a: a[: a.size // 32 * 32].reshape(-1, 32)  # noqa: E731
    lane_b = np.where(whole == 1, samples, alone)
    print(json.dumps({
        "tool": "soft_rows", "shape": [width, height, samples, bounces], "object": obj,
        "pixels_whole": float(whole.mean()),
        "samples_alone_of_others": float(alone.sum() / max(1, (whole == 0).sum() * samples)),
        "warps_with_a_whole_pixel": float((warps(whole).max(1) > 0).mean()),
        "row_b_rounds_per_warp_over_samples": float(warps(lane_b).max(1).mean() / samples),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
