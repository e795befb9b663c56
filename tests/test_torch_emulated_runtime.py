"""The CPU stand-in for the card that the emulated launch tests share
(test_torch_grad_launch_emulated.py, test_torch_soft_launch_emulated.py,
test_torch_hinted_launch_emulated.py, test_torch_grad_modes_emulated.py,
test_torch_forward_launch_emulated.py, test_torch_ablate_modes_emulated.py),
and the host-array calls of the gradient launches; it holds no test.

EMU stands in for the CUDA runtime: a launch runs its blocks one after
another, each block as blockDim.x std::threads; __shfl_*_sync,
__ballot_sync and __syncthreads are barriers over the warp's or the
block's threads, so a shuffle that not every lane of a warp reaches hangs
(the test's timeout fails it). g++ builds the csrc/*.cu files a test file
names with the launch syntax rewritten (``k<<<g, b, s, st>>>(a)`` becomes
``emu_launch(k, g, b, s, st, a)``), and build.bind types the entry points
as on the card.
"""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fourd_ray_tracing_tpu_torch import camera as tcam
from fourd_ray_tracing_tpu_torch import diff
from fourd_ray_tracing_tpu_torch.models import params, renderer
from fourd_ray_tracing_tpu_torch.ops.cuda import build, gradkernel

from test_torch_adjoint_host import ptr

CPU = torch.device("cpu")
VIEWS_1 = ("yxz",)
# Wide enough for a warp to hold pixels whose rows part at bounce 0 and
# pixels whose rows share row a's traces.
SHAPE = dict(width=48, height=24, samples=4, reflections_amount=4, rng_mode="per_sample",
             light_coefficient=0.7)
# The gradient launches' sources (gradkernel.cu hands a composite scene to
# gradcomposite.cu and softcomposite.cu) with K8's production one, and
# their entry points.
GRAD_SOURCES = ("gradkernel.cu", "gradcomposite.cu", "softcomposite.cu", "ablate.cu")
GRAD_ENTRIES = ("fourd_grad_scratch_cols", "fourd_loss_grad_launch", "fourd_light_vjp_launch",
                "fourd_soft_loss_grad_launch", "fourd_ablate_launch")
# The pixels of a gradient kernel's block (csrc/reduce.cuh kGradBlock).
K_BLOCK = 64

EMU = r"""// A CPU stand-in for the CUDA runtime: a launch runs its blocks one after
// another, each as blockDim.x std::threads; warp shuffles, ballots and
// __syncthreads are barriers over the warp's or the block's threads.
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>
#include <stddef.h>
#include <algorithm>
#include <barrier>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __device__
#define __global__
#define __host__
#define __noinline__
#define __forceinline__ inline
#define __constant__
#define __shared__ static
#define __restrict__
#define __launch_bounds__(...)
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
typedef void* cudaStream_t;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct U3 { unsigned x, y, z; };
inline thread_local U3 threadIdx, blockIdx;
inline U3 blockDim, gridDim;
inline std::vector<float> emu_smem;
struct EmuWarp {
  std::barrier<> bar{32};
  uint64_t vals[32];
};
inline std::barrier<>* emu_block_bar;
inline EmuWarp* emu_warps;
inline EmuWarp& emu_warp() { return emu_warps[threadIdx.x / 32]; }
inline void __syncthreads() { emu_block_bar->arrive_and_wait(); }
template <class T> T emu_exchange(T v, int src, bool keep) {
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x & 31;
  uint64_t u = 0;
  memcpy(&u, &v, sizeof(T));
  w.vals[lane] = u;
  w.bar.arrive_and_wait();
  T out = v;
  if (!keep) memcpy(&out, &w.vals[src & 31], sizeof(T));
  w.bar.arrive_and_wait();
  return out;
}
template <class T> T __shfl_sync(unsigned, T v, int src) { return emu_exchange(v, src, false); }
template <class T> T __shfl_up_sync(unsigned, T v, unsigned off) {
  const int src = static_cast<int>(threadIdx.x & 31) - static_cast<int>(off);
  return emu_exchange(v, src, src < 0);
}
template <class T> T __shfl_down_sync(unsigned, T v, unsigned off) {
  const int src = static_cast<int>(threadIdx.x & 31) + static_cast<int>(off);
  return emu_exchange(v, src, src > 31);
}
inline unsigned __ballot_sync(unsigned, int pred) {
  EmuWarp& w = emu_warp();
  w.vals[threadIdx.x & 31] = pred != 0;
  w.bar.arrive_and_wait();
  unsigned bits = 0;
  for (int l = 0; l < 32; ++l) bits |= static_cast<unsigned>(w.vals[l]) << l;
  w.bar.arrive_and_wait();
  return bits;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }
inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, const void*, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
template <class F, class... A>
void emu_launch(F f, dim3 grid, dim3 block, size_t smem, cudaStream_t, A... a) {
  gridDim = {grid.x, grid.y, grid.z};
  blockDim = {block.x, block.y, block.z};
  const int n = static_cast<int>(block.x);
  for (unsigned by = 0; by < grid.y; ++by) {
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      emu_smem.assign(smem / sizeof(float) + 1, 0.0f);
      std::barrier<> bar(n);
      std::vector<EmuWarp> warps((n + 31) / 32);
      emu_block_bar = &bar;
      emu_warps = warps.data();
      std::vector<std::thread> threads;
      for (int t = 0; t < n; ++t) {
        threads.emplace_back([=] {
          threadIdx = {static_cast<unsigned>(t), 0, 0};
          blockIdx = {bx, by, 0};
          f(a...);
        });
      }
      for (auto& th : threads) th.join();
    }
  }
}
"""


def config(**kw):
    return renderer.RenderConfig(**dict(SHAPE, **kw))


# The composite scenes' launches run at a smaller shape (a launch of the
# CPU stand-in costs its pixels times its threads).
COMPOSITE_SHAPE = dict(width=32, height=16, samples=2)


def config_for(name, **kw):
    """config(**kw), at COMPOSITE_SHAPE for a scene with composites."""
    if name not in ("room_with_sphere", "sphere_plane_light"):
        kw = dict(COMPOSITE_SHAPE, **kw)
    return config(**kw)


def emulated_library(work, names=None):
    """g++ builds the csrc/*.cu files ``names`` (all by default) behind EMU
    in ``work`` and links them; returns the shared library's path. Skips
    the test where there is no g++."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the kernels for the host")
    (work / "cuda_runtime.h").write_text(EMU)
    # Every rewritten file is written before any compiler starts: a source
    # includes headers that sort after it.
    sources = sorted(build.CSRC_DIR.iterdir())
    for src in sources:
        text = src.read_text()
        text = re.sub(r"extern __shared__ float (\w+)\[\];", r"float* \1 = emu_smem.data();", text)
        text = re.sub(r"(\w+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\(",
                      lambda m: f"emu_launch({m.group(1)}, {m.group(2)}, ", text, flags=re.S)
        (work / src.name).write_text('#include "cuda_runtime.h"\n' + text)
    procs = [subprocess.Popen(
        [cxx, "-O2", "-std=c++20", "-ffp-contract=off", "-fPIC", "-pthread",
         *build.DEFINES, f"-I{work}", "-c", "-o", str(work / f"{src.stem}.o"), "-x",
         "c++", str(work / src.name)], stderr=subprocess.PIPE, text=True)
        for src in sources if src.suffix == ".cu" and (names is None or src.name in names)]
    for proc in procs:
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
    so = work / "libemulated.so"
    proc = subprocess.run([cxx, "-shared", "-pthread", "-o", str(so),
                           *map(str, sorted(work.glob("*.o")))], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return so


def layout_table(lay):
    return (ctypes.c_int * len(lay))(*lay)


def scratch_cols(lib, table, cfg, n_rows, n_frames=1):
    n_cols = lib.fourd_grad_scratch_cols(ctypes.addressof(table), cfg.width, n_rows, n_frames)
    assert n_cols > 0
    return n_cols


def f32(x):
    return float(np.float32(x))


def soft_launch(lib, packed, lay, cfg, seed, target, alpha, zero_map, rows, hints=None):
    """fourd_soft_loss_grad_launch on host arrays, as launch_soft_loss_grad
    makes it on the card: (loss, grad, alpha cotangent). ``hints``: the
    (descriptor, keep mask) of a launch under the freeze_hints contract."""
    row0, n_rows = rows
    table = layout_table(lay)
    n_cols = scratch_cols(lib, table, cfg, n_rows, n_frames=2)
    slots = (ctypes.c_int * len(zero_map))(*(i for i, _ in zero_map))
    values = (ctypes.c_float * len(zero_map))(*(v for _, v in zero_map))
    sums = np.zeros((2, *target.shape), np.float32)
    row_b = np.zeros(alpha.shape, np.uint32)
    grad_parts = np.zeros((lay.size, n_cols), np.float32)
    loss_parts = np.zeros(n_cols, np.float64)
    grad, loss = np.zeros(lay.size, np.float32), np.zeros(1, np.float32)
    alpha_cot = np.zeros(alpha.shape, np.float32)
    scale = f32(1.0 / (lay.n_views * cfg.height * cfg.width * 3))
    err = lib.fourd_soft_loss_grad_launch(
        ptr(packed), seed, ctypes.addressof(table), len(zero_map), ctypes.addressof(slots),
        ctypes.addressof(values), cfg.width, cfg.height, row0, n_rows, cfg.samples,
        cfg.reflections_amount, f32(cfg.small_indent), f32(cfg.light_coefficient), ptr(target),
        ptr(alpha), scale, ptr(sums), ptr(row_b), ptr(grad_parts), ptr(loss_parts), ptr(grad),
        ptr(loss), ptr(alpha_cot), *hint_args(hints), None)
    assert err == 0
    return loss[0], grad, alpha_cot


def hint_args(hints):
    """The launch's hints and keep arguments: null, or the descriptor's
    address (null for none) and the mask's pointer (null for none)."""
    if hints is None:
        return None, None
    words, keep = hints
    return (None if words is None else ctypes.addressof(words)), \
        (None if keep is None else ptr(keep))


def launch_args(scene, camera, cfg):
    """The (descriptor, keep mask) a wrapper hands a launch under ``cfg``
    (gradkernel.launch_words: a scene with composites always takes one;
    the mask under the contract), or None for neither."""
    lay = params.layout(scene, camera)
    words = gradkernel.launch_words(lay, cfg)
    keep = params.freeze_mask(cfg, scene, lay.size)
    if words is None and keep is None:
        return None
    return words, None if keep is None else keep.numpy()


def frozen_hints(scene, camera, cfg):
    """(cfg under the freeze_hints contract, (descriptor, keep mask), frozen
    slots) of the scene: the kernels' hints, as the wrappers hand them."""
    hcfg = diff.with_frozen_hints(cfg, scene)
    hints = launch_args(scene, camera, hcfg)
    return hcfg, hints, hints[1] == 0


def assert_contract(hinted, unhinted, frozen):
    """The freeze_hints contract on a packed gradient (P,) or (F, P): every
    kept slot equal to the unhinted launch's (== takes -0 for +0), some of
    them not 0, and every frozen slot 0."""
    assert np.array_equal(hinted[..., ~frozen], unhinted[..., ~frozen])
    assert np.abs(hinted[..., ~frozen]).max() > 0.0
    assert np.all(hinted[..., frozen] == 0.0)


def rows_of(x, rows, channels):
    band = slice(rows[0], rows[0] + rows[1])
    return np.ascontiguousarray(x[..., band, :, :] if channels else x[..., band, :])


# The soft object of each scene of the K6 launches.
SOFT_REFS = {"room_with_sphere": ("spheres", 0), "sphere_plane_light": ("spheres", 1),
             "duocylinder": ("cylinders_union", None), "tiger": ("tiger", None),
             "hypercube": ("hypercube", None), "cylinders": ("cylinders", 1),
             "sphere_composites": ("spheres", 0)}


def loss_grad_launch(lib, packed, lay, cfg, seeds, target, hints=None, rows=None, split=1,
                     scratch=False):
    """fourd_loss_grad_launch on host arrays: (loss, grad); ``rows`` =
    (row0, n_rows), the launch over those image rows, ``target`` their
    block; ``split`` the sweep's sample chunks a pixel; with ``scratch``,
    the (P, n_cols x split) gradient partials, zeroed before the launch,
    after them."""
    row0, n_rows = rows or (0, cfg.height)
    table = layout_table(lay)
    n_cols = scratch_cols(lib, table, cfg, n_rows, len(seeds))
    g_mean = np.zeros((len(seeds), *target.shape), np.float32)
    grad_parts = np.zeros((lay.size, n_cols * split), np.float32)
    loss_parts = np.zeros(n_cols, np.float64)
    grad, loss = np.zeros(lay.size, np.float32), np.zeros(1, np.float32)
    err = lib.fourd_loss_grad_launch(
        ptr(packed), ptr(seeds), len(seeds), split, ctypes.addressof(table), cfg.width,
        cfg.height, row0, n_rows, cfg.samples, cfg.reflections_amount, f32(cfg.small_indent),
        f32(cfg.light_coefficient), ptr(target),
        f32(1.0 / (len(seeds) * target.size // n_rows * cfg.height)),
        ptr(g_mean), ptr(grad_parts), ptr(loss_parts), ptr(grad), ptr(loss), *hint_args(hints),
        None)
    assert err == 0
    return (loss[0], grad, grad_parts) if scratch else (loss[0], grad)


def light_vjp_launch(lib, rows, lay, cfg, cot, hints=None):
    """fourd_light_vjp_launch on host arrays over (F, P) params rows: the
    (F, P) gradient."""
    table = layout_table(lay)
    n_cols = scratch_cols(lib, table, cfg, cfg.height)
    grad_parts = np.zeros((len(rows) * lay.size, n_cols), np.float32)
    grad = np.zeros((len(rows), lay.size), np.float32)
    err = lib.fourd_light_vjp_launch(
        ptr(rows), lay.size, len(rows), 9, ctypes.addressof(table), cfg.width, cfg.height, 0,
        cfg.height, cfg.samples, cfg.reflections_amount, f32(cfg.small_indent), ptr(cot),
        ptr(grad_parts), ptr(grad), *hint_args(hints), None)
    assert err == 0
    return grad


def ablate_launch(lib, mode, packed, lay, cfg, target, words=None, codes=None):
    """K8 on host arrays: the variant's sum; fourd_ablate_launch, or with
    ``codes`` (fold, sampler, sampler_iters) fourd_ablate_modes. Its scratch
    holds a column per block of K_BLOCK pixels (fourd_grad_scratch_cols of
    one frame)."""
    table = layout_table(lay)
    loss_parts = np.zeros(-(-lay.n_views * cfg.height * cfg.width // K_BLOCK), np.float64)
    value = np.zeros(1, np.float32)
    args = (mode, ptr(packed), 3, ctypes.addressof(table), cfg.width, cfg.height, cfg.samples,
            cfg.reflections_amount, f32(cfg.small_indent), f32(cfg.light_coefficient),
            ptr(target), ptr(loss_parts), ptr(value),
            None if words is None else ctypes.addressof(words), None)
    err = lib.fourd_ablate_launch(*args) if codes is None else lib.fourd_ablate_modes(*codes, *args)
    assert err == 0
    return value[0]


# The launches under the freeze_hints contract: the room at the main bounce
# count (its own instance, RoomFold) and at 3 (AnyFold), the lamp scene's
# single floor plane (AnyFold), 1 and 3 views; the composites (K4, K5 and
# K8): the duocylinder and the tiger at the main bounce count (their own
# instances) and the two cylinders (the generic composite fold under the
# hints: one hinted, one not). The hypercube's hinted instance runs in
# tests/test_torch_adjoint_host.py (a launch here costs about its P in
# sum_parts blocks of the CPU stand-in).
HINTED = [("room_with_sphere", VIEWS_1, 4), ("room_with_sphere", VIEWS_1, 3),
          ("sphere_plane_light", tcam.VIEWS_ALL, 4)]
HINTED_IDS = ["room_main", "room_generic", "lamp_3view"]
COMPOSITE_HINTED = [("duocylinder", VIEWS_1, 4), ("tiger", VIEWS_1, 4),
                    ("cylinders", VIEWS_1, 4)]
COMPOSITE_HINTED_IDS = ["duocylinder", "tiger", "cylinders"]
