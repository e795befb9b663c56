"""The gradient launches themselves (csrc/gradkernel.cu: K4, K5 and K6 with
their pass-1 kernels, sweeps, warp schedules and fixed-order reductions),
compiled for the host and run by a CPU stand-in for the card, against
torch autograd over the plain pipeline.

tests/test_torch_adjoint_host.py holds the per-pixel math; this file
holds what only the kernels do: the blocks' shared memory, the per-thread
columns and their reduction, sum_parts_kernel, and K6's split of its rows
over its kernels (row a's sweep leaves each pixel's row-b work in scratch,
row b's sweep takes it). EMU stands in for the CUDA runtime: a launch runs
its blocks one after another, each block as blockDim.x std::threads;
__shfl_*_sync, __ballot_sync and __syncthreads are barriers over the
warp's or the block's threads, so a shuffle that not every lane of a warp
reaches hangs (the test's timeout fails it). g++ builds every csrc/*.cu
with the launch syntax rewritten (``k<<<g, b, s, st>>>(a)`` becomes
``emu_launch(k, g, b, s, st, a)``), and build.bind types the entry
points as on the card. The card's own runs are chip_smoke.py's phases 8,
11, 12 and 14.
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
from fourd_ray_tracing_tpu_torch.models import library, params, renderer
from fourd_ray_tracing_tpu_torch.models import scene as tscene
from fourd_ray_tracing_tpu_torch.ops.cuda import ablate, build, gradkernel, megakernel

from test_torch_adjoint_host import (assert_grad_close, camera_of, grad_scene, image_shape,
                                     pattern_floor, ptr, second_row)

CPU = torch.device("cpu")
VIEWS_1 = ("yxz",)
# Wide enough for a warp to hold pixels whose rows part at bounce 0 and
# pixels whose rows share row a's traces.
SHAPE = dict(width=48, height=24, samples=4, reflections_amount=4, rng_mode="per_sample",
             light_coefficient=0.7)

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
    procs = []
    for src in sorted(build.CSRC_DIR.iterdir()):
        text = src.read_text()
        text = re.sub(r"extern __shared__ float (\w+)\[\];", r"float* \1 = emu_smem.data();", text)
        text = re.sub(r"(\w+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\(",
                      lambda m: f"emu_launch({m.group(1)}, {m.group(2)}, ", text, flags=re.S)
        (work / src.name).write_text('#include "cuda_runtime.h"\n' + text)
        if src.suffix == ".cu" and (names is None or src.name in names):
            procs.append(subprocess.Popen(
                [cxx, "-O2", "-std=c++20", "-ffp-contract=off", "-fPIC", "-pthread",
                 *build.DEFINES, f"-I{work}", "-c", "-o", str(work / f"{src.stem}.o"), "-x",
                 "c++", str(work / src.name)], stderr=subprocess.PIPE, text=True))
    for proc in procs:
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
    so = work / "libemulated.so"
    proc = subprocess.run([cxx, "-shared", "-pthread", "-o", str(so),
                           *map(str, sorted(work.glob("*.o")))], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return so


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build.bind(ctypes.CDLL(str(emulated_library(
        tmp_path_factory.mktemp("grad_launch_emulated")))))


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


@pytest.mark.parametrize("name,ref,views,bounces,rows,wider", [
    ("room_with_sphere", ("spheres", 0), VIEWS_1, 4, None, False),
    ("room_with_sphere", ("spheres", 0), VIEWS_1, 3, None, False),
    ("room_with_sphere", ("spheres", 0), VIEWS_1, 4, (5, 13), False),
    ("room_with_sphere", ("spheres", 0), VIEWS_1, 4, None, True),
    ("sphere_plane_light", ("spheres", 1), tcam.VIEWS_ALL, 4, None, False),
], ids=["room_main", "room_generic", "room_row_block", "room_wider_zero_map", "lamp_3view"])
def test_soft_launch_matches_autograd(lib, name, ref, views, bounces, rows, wider):
    """K6's launch: pass 1 on both rows, then the sweep's job rounds, its
    reduction and sum_parts, against the plain blend by autograd (loss rtol
    1e-6, gradient and alpha cotangent the mixed-scale 1e-3 of the host
    tests); bitwise across two launches. ``wider``: a zero map that also
    rewrites wall 0's color, whose rows are swept apart on every pixel."""
    cfg = config(reflections_amount=bounces)
    scene, camera = library.SCENES[name](CPU), camera_of(views)
    rows = rows or (0, cfg.height)
    rng = np.random.default_rng(5)
    target = rng.uniform(0, 1, (*image_shape(views, cfg), 3)).astype(np.float32)
    alpha = rng.uniform(0, 1, image_shape(views, cfg)).astype(np.float32)
    lay = params.layout(scene, camera)
    zero_map = params.soft_zero_map(scene, camera, ref)
    if wider:
        zero_map = [*zero_map, *((lay.spaces + 10 + k, 0.25) for k in range(3))]
    packed = params.pack(scene, camera).numpy()
    block_t, block_a = rows_of(target, rows, True), rows_of(alpha, rows, False)
    out = soft_launch(lib, packed, lay, cfg, 3, block_t, block_a, zero_map, rows)
    again = soft_launch(lib, packed, lay, cfg, 3, block_t, block_a, zero_map, rows)
    assert all(np.array_equal(a, b) for a, b in zip(out, again))
    ref_loss, ref_grad, ref_acot = gradkernel.render_soft_loss_and_grad_plain(
        torch.from_numpy(packed), scene, camera, cfg, 3, torch.from_numpy(block_t),
        torch.from_numpy(block_a), zero_map, rows=rows)
    np.testing.assert_allclose(out[0], float(ref_loss), rtol=1e-6)
    assert_grad_close(out[1], ref_grad.numpy())
    assert_grad_close(out[2], ref_acot.numpy())


# The soft object of each scene of the K6 launches.
SOFT_REFS = {"room_with_sphere": ("spheres", 0), "sphere_plane_light": ("spheres", 1),
             "duocylinder": ("cylinders_union", None), "tiger": ("tiger", None),
             "hypercube": ("hypercube", None), "cylinders": ("cylinders", 1),
             "sphere_composites": ("spheres", 0)}


@pytest.mark.parametrize("name,views,bounces,rows,frozen", [
    ("tiger", VIEWS_1, 4, None, True),
    ("hypercube", VIEWS_1, 4, (3, 9), False),
    ("duocylinder", tcam.VIEWS_ALL, 4, None, False),
    ("cylinders", VIEWS_1, 3, None, False),
    ("sphere_composites", VIEWS_1, 4, None, False),
    ("sphere_composites", VIEWS_1, 4, None, True),
], ids=["tiger_library", "hypercube_row_block", "duocylinder_3view", "cylinders_generic",
        "sphere_beside_composites", "sphere_beside_composites_frozen"])
def test_composite_soft_launch_matches_autograd(lib, name, views, bounces, rows, frozen):
    """K6's launch over the composite folds, its row b the scene with the
    object zeroed by its radii (0, the hypercube's -1), swept whole: the
    tiger under its frozen hints at the main bounce count (its library
    instance), the hypercube on a row block and the duocylinder on 3 views
    unhinted (the generic composite fold), the two cylinders at 3 bounces
    (the generic fold's rolled instance), the turned one zeroed. A sphere
    in front of a hypercube and a tiger, the soft object, unhinted and
    under the frozen hints: the composite fold with a sample-level split,
    row a's sweep carrying row b's cotangent where the sphere is not the
    primary hit (zero_map_object). Against
    autograd over the plain blend (loss rtol 1e-6, gradient and alpha
    cotangent the mixed-scale 1e-3 with the composites' pattern floor),
    every output finite, bitwise across two launches."""
    cfg = config_for(name, reflections_amount=bounces)
    scene, camera = grad_scene(name), camera_of(views)
    hints = launch_args(scene, camera, cfg)
    if frozen:
        cfg, hints, _ = frozen_hints(scene, camera, cfg)
    rows = rows or (0, cfg.height)
    rng = np.random.default_rng(5)
    target = rng.uniform(0, 1, (*image_shape(views, cfg), 3)).astype(np.float32)
    alpha = rng.uniform(0, 1, image_shape(views, cfg)).astype(np.float32)
    lay = params.layout(scene, camera)
    zero_map = params.soft_zero_map(scene, camera, SOFT_REFS[name])
    packed = params.pack(scene, camera).numpy()
    block_t, block_a = rows_of(target, rows, True), rows_of(alpha, rows, False)
    out = soft_launch(lib, packed, lay, cfg, 3, block_t, block_a, zero_map, rows, hints)
    again = soft_launch(lib, packed, lay, cfg, 3, block_t, block_a, zero_map, rows, hints)
    assert all(np.array_equal(a, b) for a, b in zip(out, again))
    assert all(np.isfinite(x).all() for x in out)
    ref_loss, ref_grad, ref_acot = gradkernel.render_soft_loss_and_grad_plain(
        torch.from_numpy(packed), scene, camera, cfg, 3, torch.from_numpy(block_t),
        torch.from_numpy(block_a), zero_map, rows=rows)
    np.testing.assert_allclose(out[0], float(ref_loss), rtol=1e-6)
    assert_grad_close(out[1], ref_grad.numpy(), pattern_floor(scene))
    assert_grad_close(out[2], ref_acot.numpy())


def test_soft_launch_refuses_a_long_zero_map(lib):
    """K6 holds at most FOURD_K6_MAX_ZERO_SLOTS zero-map slots: a map of
    one more is refused (cudaErrorInvalidValue), never cut, and the
    wrapper raises before it launches; the hypercube's 9 slots fit."""
    cfg = config(reflections_amount=2, width=8, height=4)
    scene, camera = library.hypercube(CPU), camera_of(VIEWS_1)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    zero_map = list(params.soft_zero_map(scene, camera, ("hypercube", None)))
    longer = zero_map + [(lay.spaces + k, 0.5)
                         for k in range(gradkernel.MAX_ZERO_SLOTS + 1 - len(zero_map))]
    assert len(zero_map) == 9 and len(longer) == gradkernel.MAX_ZERO_SLOTS + 1
    target = np.zeros((cfg.height, cfg.width, 3), np.float32)
    alpha = np.full((cfg.height, cfg.width), 0.5, np.float32)
    args = (lib, packed, lay, cfg, 3, target, alpha)
    hints = launch_args(scene, camera, cfg)
    loss, grad, _ = soft_launch(*args, longer[:-1], (0, cfg.height), hints)
    assert np.isfinite(loss) and np.isfinite(grad).all()
    with pytest.raises(AssertionError, match="assert 1 == 0"):  # cudaErrorInvalidValue
        soft_launch(*args, longer, (0, cfg.height), hints)
    with pytest.raises(ValueError, match="zero map"):
        gradkernel.check_zero_map(longer, lay)


def loss_grad_launch(lib, packed, lay, cfg, seeds, target, hints=None, rows=None):
    """fourd_loss_grad_launch on host arrays: (loss, grad); ``rows`` =
    (row0, n_rows), the launch over those image rows, ``target`` their
    block."""
    row0, n_rows = rows or (0, cfg.height)
    table = layout_table(lay)
    n_cols = scratch_cols(lib, table, cfg, n_rows, len(seeds))
    g_mean = np.zeros((len(seeds), *target.shape), np.float32)
    grad_parts = np.zeros((lay.size, n_cols), np.float32)
    loss_parts = np.zeros(n_cols, np.float64)
    grad, loss = np.zeros(lay.size, np.float32), np.zeros(1, np.float32)
    err = lib.fourd_loss_grad_launch(
        ptr(packed), ptr(seeds), len(seeds), ctypes.addressof(table), cfg.width, cfg.height, row0,
        n_rows, cfg.samples, cfg.reflections_amount, f32(cfg.small_indent),
        f32(cfg.light_coefficient), ptr(target),
        f32(1.0 / (len(seeds) * target.size // n_rows * cfg.height)),
        ptr(g_mean), ptr(grad_parts), ptr(loss_parts), ptr(grad), ptr(loss), *hint_args(hints),
        None)
    assert err == 0
    return loss[0], grad


@pytest.mark.parametrize("name,bounces,rows", [
    ("room_with_sphere", 4, None), ("duocylinder", 4, None), ("tiger", 4, None),
    ("hypercube", 3, None), ("cylinders", 4, None), ("tiger", 4, (3, 9))],
    ids=["room", "duocylinder", "tiger", "hypercube_generic", "cylinders", "tiger_row_block"])
def test_loss_grad_launch_matches_autograd(lib, name, bounces, rows):
    """K4's launch over two frames (its pass-1 kernel with the loss
    reduction, the sweep over frame rows, sum_parts) against
    loss_and_grad_plain; a scene with composites unhinted, through the
    generic composite fold (its descriptor: n_singles -1, no axis hint);
    ``rows`` a row block (K3's sharded launch) against its plain rows."""
    cfg = config_for(name, reflections_amount=bounces)
    scene, camera = grad_scene(name), camera_of(VIEWS_1)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    target = np.random.default_rng(4).uniform(0, 1, (cfg.height, cfg.width, 3)).astype(np.float32)
    if rows is not None:
        target = rows_of(target, rows, True)
    seeds = np.array([0x12345678, 9], np.uint32)
    loss, grad = loss_grad_launch(lib, packed, lay, cfg, seeds, target,
                                  launch_args(scene, camera, cfg), rows)
    ref_loss, ref_grad = gradkernel.loss_and_grad_plain(
        torch.from_numpy(packed), scene, camera, cfg, seeds, torch.from_numpy(target), rows=rows)
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-6)
    assert_grad_close(grad, ref_grad.numpy(), pattern_floor(scene))


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


@pytest.mark.parametrize("name,views,bounces", HINTED + COMPOSITE_HINTED,
                         ids=HINTED_IDS + COMPOSITE_HINTED_IDS)
def test_hinted_loss_grad_launch_keeps_the_unhinted_values(lib, name, views, bounces):
    """K4 under the contract: the loss bitwise the unhinted launch's, every
    kept slot equal, the frozen ones (the hyperplane normals) 0; bitwise
    across launches; within the mixed-scale bound of autograd over the
    unhinted plain pipeline with the slots frozen."""
    cfg = config_for(name, reflections_amount=bounces)
    scene, camera = grad_scene(name), camera_of(views)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    target = np.random.default_rng(4).uniform(
        0, 1, (*image_shape(views, cfg), 3)).astype(np.float32)
    seeds = np.array([0x12345678, 9], np.uint32)
    hcfg, hints, frozen = frozen_hints(scene, camera, cfg)
    loss, grad = loss_grad_launch(lib, packed, lay, hcfg, seeds, target, hints)
    again = loss_grad_launch(lib, packed, lay, hcfg, seeds, target, hints)
    loss_u, grad_u = loss_grad_launch(lib, packed, lay, cfg, seeds, target,
                                      launch_args(scene, camera, cfg))
    assert loss == loss_u and loss == again[0] and np.array_equal(grad, again[1])
    assert_contract(grad, grad_u, frozen)
    # The mask alone decides which slots come out 0: freeze a live slot too.
    live = int(np.flatnonzero(grad)[0])
    words, keep = hints
    keep = keep.copy()
    keep[live] = 0.0
    _, masked = loss_grad_launch(lib, packed, lay, hcfg, seeds, target, (words, keep))
    assert masked[live] == 0.0 and np.array_equal(np.delete(masked, live), np.delete(grad, live))
    _, ref = gradkernel.loss_and_grad_plain(torch.from_numpy(packed), scene, camera, cfg, seeds,
                                            torch.from_numpy(target))
    assert_grad_close(grad, np.where(frozen, 0.0, ref.numpy()).astype(np.float32),
                      pattern_floor(scene))


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


@pytest.mark.parametrize("name", ["room_with_sphere", "duocylinder", "tiger", "cylinders"])
def test_light_vjp_launch_matches_autograd(lib, name):
    """K5's launch over two params rows (the scene and its zero_object
    copy, as the soft pair sends them; a scene with composites and a copy
    with its floor moved, unhinted) against render_light_vjp_plain."""
    cfg = config_for(name)
    scene, camera = grad_scene(name), camera_of(VIEWS_1)
    lay = params.layout(scene, camera)
    rows = params.stack_rows([scene, second_row(scene)], camera).numpy()
    cot = np.random.default_rng(7).normal(0, 1, (2, cfg.height, cfg.width, 3)).astype(np.float32)
    grad = light_vjp_launch(lib, rows, lay, cfg, cot, launch_args(scene, camera, cfg))
    ref = gradkernel.render_light_vjp_plain(torch.from_numpy(rows), scene, camera, cfg, 9,
                                            torch.from_numpy(cot)).numpy()
    assert_grad_close(grad, ref, pattern_floor(scene))


@pytest.mark.parametrize("name,views,bounces", HINTED + COMPOSITE_HINTED,
                         ids=HINTED_IDS + COMPOSITE_HINTED_IDS)
def test_hinted_light_vjp_launch_keeps_the_unhinted_values(lib, name, views, bounces):
    """K5 under the contract over the scene and its zero_object copy (a
    scene with composites: a copy with its floor moved; each row builds its
    own table): every kept slot of both rows equal to the unhinted
    launch's, the frozen ones 0."""
    cfg = config_for(name, reflections_amount=bounces)
    scene, camera = grad_scene(name), camera_of(views)
    lay = params.layout(scene, camera)
    rows = params.stack_rows([scene, second_row(scene)], camera).numpy()
    cot = np.random.default_rng(7).normal(
        0, 1, (2, *image_shape(views, cfg), 3)).astype(np.float32)
    hcfg, hints, frozen = frozen_hints(scene, camera, cfg)
    grad = light_vjp_launch(lib, rows, lay, hcfg, cot, hints)
    assert_contract(grad, light_vjp_launch(lib, rows, lay, cfg, cot,
                                           launch_args(scene, camera, cfg)), frozen)
    assert np.array_equal(grad, light_vjp_launch(lib, rows, lay, hcfg, cot, hints))


@pytest.mark.parametrize("name,views,bounces", HINTED + COMPOSITE_HINTED,
                         ids=HINTED_IDS + COMPOSITE_HINTED_IDS)
def test_hinted_soft_launch_keeps_the_unhinted_values(lib, name, views, bounces):
    """K6 under the contract (both rows fold over their own tables, row b's
    with the zero map applied; a composite's: the zeroed object's library
    instance or the generic composite fold): the loss and the alpha
    cotangent bitwise the unhinted launch's, every kept slot equal, the
    frozen ones 0."""
    cfg = config_for(name, reflections_amount=bounces)
    scene, camera = grad_scene(name), camera_of(views)
    ref = SOFT_REFS[name]
    rng = np.random.default_rng(5)
    target = rng.uniform(0, 1, (*image_shape(views, cfg), 3)).astype(np.float32)
    alpha = rng.uniform(0, 1, image_shape(views, cfg)).astype(np.float32)
    lay = params.layout(scene, camera)
    zero_map = params.soft_zero_map(scene, camera, ref)
    packed = params.pack(scene, camera).numpy()
    rows = (0, cfg.height)
    hcfg, hints, frozen = frozen_hints(scene, camera, cfg)
    out = soft_launch(lib, packed, lay, hcfg, 3, target, alpha, zero_map, rows, hints)
    plain = soft_launch(lib, packed, lay, cfg, 3, target, alpha, zero_map, rows,
                        launch_args(scene, camera, cfg))
    assert out[0] == plain[0] and np.array_equal(out[2], plain[2])
    assert_contract(out[1], plain[1], frozen)


def ablate_launch(lib, mode, packed, lay, cfg, target, words=None):
    """fourd_ablate_launch (K8) on host arrays: the variant's sum."""
    table = layout_table(lay)
    loss_parts = np.zeros(scratch_cols(lib, table, cfg, cfg.height), np.float64)
    value = np.zeros(1, np.float32)
    err = lib.fourd_ablate_launch(
        mode, ptr(packed), 3, ctypes.addressof(table), cfg.width, cfg.height, cfg.samples,
        cfg.reflections_amount, f32(cfg.small_indent), f32(cfg.light_coefficient), ptr(target),
        ptr(loss_parts), ptr(value), None if words is None else ctypes.addressof(words), None)
    assert err == 0
    return value[0]


@pytest.mark.parametrize("name,views,bounces", HINTED + COMPOSITE_HINTED,
                         ids=HINTED_IDS + COMPOSITE_HINTED_IDS)
def test_hinted_ablate_launch_keeps_the_unhinted_values(lib, name, views, bounces):
    """K8 under the contract, every mode: bitwise the unhinted launch (the
    hinted fold's light is the unhinted fold's; a scene with composites
    unhinted folds over its descriptor without hints), and the loss mode
    within the plain version's rounding of its double sum (a scene with
    composites)."""
    cfg = config_for(name, reflections_amount=bounces)
    scene, camera = grad_scene(name), camera_of(views)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    target = np.random.default_rng(4).uniform(
        0, 1, (*image_shape(views, cfg), 3)).astype(np.float32)
    hcfg, (words, _), _ = frozen_hints(scene, camera, cfg)
    unhinted = gradkernel.launch_words(lay, cfg)
    for mode in range(3):
        assert (ablate_launch(lib, mode, packed, lay, hcfg, target, words)
                == ablate_launch(lib, mode, packed, lay, cfg, target, unhinted)), mode
    if lay.composite_kinds():
        ref = ablate.variant_plain("loss", scene, camera, cfg, 3, torch.from_numpy(target))
        np.testing.assert_allclose(ablate_launch(lib, 1, packed, lay, cfg, target, unhinted),
                                   float(ref), rtol=1e-6)


def test_launches_refuse_composite_hints(lib):
    """Once refused by K6, now taken by every gradient launch: the tiger's
    descriptor under the contract goes to K4's, K5's, K6's and K8's
    composite folds. K6 takes it with the tiger's own zero map and with a
    map that names no radius (wall 0's color: both rows keep the tiger),
    each with a finite loss and gradient, the frozen slots 0."""
    cfg = config(reflections_amount=2, width=8, height=4)
    scene, camera = library.tiger(CPU), camera_of(VIEWS_1)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    hcfg, (words, keep), _ = frozen_hints(scene, camera, cfg)
    target = np.zeros((cfg.height, cfg.width, 3), np.float32)
    table = layout_table(lay)
    loss_parts = np.zeros(scratch_cols(lib, table, cfg, cfg.height), np.float64)
    value = np.zeros(1, np.float32)
    err = lib.fourd_ablate_launch(
        0, ptr(packed), 3, ctypes.addressof(table), cfg.width, cfg.height, cfg.samples,
        cfg.reflections_amount, f32(cfg.small_indent), f32(cfg.light_coefficient), ptr(target),
        ptr(loss_parts), ptr(value), ctypes.addressof(words), None)
    assert err == 0 and value[0] > 0.0
    cot = np.ones((1, cfg.height, cfg.width, 3), np.float32)
    grad_parts = np.zeros((lay.size, scratch_cols(lib, table, cfg, cfg.height)), np.float32)
    grad = np.zeros((1, lay.size), np.float32)
    err = lib.fourd_light_vjp_launch(
        ptr(packed), 0, 1, 9, ctypes.addressof(table), cfg.width, cfg.height, 0, cfg.height,
        cfg.samples, cfg.reflections_amount, f32(cfg.small_indent), ptr(cot), ptr(grad_parts),
        ptr(grad), ctypes.addressof(words), ptr(keep), None)
    assert err == 0 and np.abs(grad).max() > 0.0
    loss, grad = loss_grad_launch(lib, packed, lay, hcfg, np.array([3], np.uint32), target,
                                  (words, keep))
    assert loss > 0.0 and np.abs(grad).max() > 0.0
    alpha = np.full((cfg.height, cfg.width), 0.5, np.float32)
    for zero_map in (params.soft_zero_map(scene, camera, ("tiger", None)),
                     [(lay.spaces + 10, 0.25)]):
        loss, grad, alpha_cot = soft_launch(lib, packed, lay, hcfg, 3, target, alpha, zero_map,
                                            (0, cfg.height), (words, keep))
        assert loss > 0.0 and np.abs(grad).max() > 0.0 and np.isfinite(alpha_cot).all()
        assert np.all(grad[keep == 0] == 0.0)


def test_many_planes_launch_writes_the_frozen_slots(lib):
    """The hint cap: room_with_sphere with 57 more floor planes (65
    hyperplanes, more than the table holds hints for) under the contract.
    The wrapper's rule of the plane count gives it no descriptor (the
    unhinted fold) and the mask of all 260 normal slots. Its 895 packed
    floats are more than the gradient kernels hold (build.K4_MAX_PARAMS):
    the launch refuses it (cudaErrorInvalidValue) and the wrapper raises
    first. K4's plain version under the contract: the loss and every kept
    slot the unhinted plain gradient's, the frozen slots 0."""
    from test_torch_freeze_hints import many_planes

    cfg = config(width=16, height=8)
    scene, camera = many_planes(tscene, CPU), camera_of(VIEWS_1)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    hcfg, hints, frozen = frozen_hints(scene, camera, cfg)
    assert hcfg.plane_hints is not None and hints[0] is None and frozen.sum() == 4 * 65
    assert lay.size > gradkernel.MAX_PARAMS
    target = np.random.default_rng(4).uniform(0, 1, (cfg.height, cfg.width, 3)).astype(np.float32)
    seeds = np.array([0x12345678, 9], np.uint32)
    with pytest.raises(AssertionError, match="assert 1 == 0"):  # cudaErrorInvalidValue
        loss_grad_launch(lib, packed, lay, hcfg, seeds, target, hints)
    with pytest.raises(ValueError, match="packed parameters"):
        gradkernel.check_shape(lay, hcfg)
    args = (torch.from_numpy(packed), scene, camera)
    loss, grad = gradkernel.loss_and_grad_plain(*args, hcfg, seeds, torch.from_numpy(target))
    loss_u, grad_u = gradkernel.loss_and_grad_plain(*args, cfg, seeds, torch.from_numpy(target))
    assert torch.equal(loss, loss_u)
    assert_contract(grad.numpy(), grad_u.numpy(), frozen)
