"""The gradient kernels' device math, compiled for the host, against torch
autograd over the plain pipeline.

The CUDA kernels themselves run only on a card (chip_smoke.py phases 8,
11, 12, 14 and 17). Their per-pixel code, csrc/trace.cuh and
csrc/adjoint.cuh, uses no CUDA API, so g++ builds it behind a small header
that defines the CUDA keywords and bit casts it needs. The accumulator is a
template parameter of the sweep: here a dense array of P cotangents (the
card adds to per-thread shared-memory columns, reduce.cuh). These tests
call each kernel's per-pixel functions for every pixel and sum in double:

* K4's pass 1 with ``loss_cot``, then the pixel sweep, against
  ``loss_and_grad_plain``, and its light against the plain render;
* K5's pixel sweep alone with a seeded random light cotangent against
  ``render_light_vjp_plain``, one row and two rows (a scene and its
  ``zero_object`` copy);
* K6 split as the card splits it (pass 1 on each row, ``soft_blend`` of
  both rows' sums, row a's sweep carrying row b's cotangent where the
  rows trace alike, row b's sweeps where they part, without the zero
  map's slots) against ``render_soft_loss_and_grad_plain``;

each at SHAPE's 3 bounces through the generic instance of the bounce
records, and at the main paths' count through the unrolled instance the
card runs there (K4 through the generic one too). K4 and K5 also run on
the composite scenes, over K1's fold table as the card's composite folds
do (the harness builds it, HostRow), unhinted and, for K4, under the
freeze_hints contract through each library scene's own instance.

That holds the hand-written adjoint (every partial derivative of the
trace) to autograd on the CPU: losses within rtol 1e-6, every gradient
and K6's alpha cotangent within the mixed-scale relative error 1e-3 of
test_torch_gradkernel.py with the same non-zero pattern, and the light
within the port's image bounds (built with -ffp-contract=off it matches
torch's CPU pipeline to an ulp).
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from helpers import assert_images_close

from fourd_ray_tracing_tpu_torch import camera as tcam
from fourd_ray_tracing_tpu_torch import diff
from fourd_ray_tracing_tpu_torch.models import library, params, renderer
from fourd_ray_tracing_tpu_torch.models import scene as tscene
from fourd_ray_tracing_tpu_torch.ops import geometry
from fourd_ray_tracing_tpu_torch.ops.cuda import build, gradkernel
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4

CPU = torch.device("cpu")
# The scenes of hyperplanes and spheres, the composite library scenes and a
# floor with two standalone cylinders, one on unit axes, one turned
# (test_torch_freeze_hints.py custom_scene).
GRAD_SCENES = ["room_with_sphere", "sphere_plane_light"]
COMPOSITE_SCENES = ["duocylinder", "tiger", "hypercube", "cylinders"]
SHAPE = dict(width=32, height=16, samples=2, reflections_amount=3, rng_mode="per_sample",
             light_coefficient=0.7)

SHIM = r"""
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __constant__
#define __launch_bounds__(x)
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }
inline int __ffs(int x) { return __builtin_ffs(x); }
"""

HARNESS = r"""
#include "adjoint.cuh"

// The host's accumulator of adjoint.cuh: a dense array of P cotangents;
// skip marks the slots whose values are dropped (K6's row b).
struct DenseAcc {
  float* g;
  const unsigned char* skip;
  void add(const Slots& c) {
    if (c.key < 0) return;
    for (int k = 0; k < c.n; ++k) {
      const int slot = c.key + k * c.stride;
      if (skip == nullptr || skip[slot] == 0) g[slot] += c.v[k];
    }
  }
};

// The pixel sweep's instance: kMainBounces (reflections must equal it) or
// the generic kMaxBounces; only, obj and g_shared as K6's rows take them;
// Fold the fold of the re-trace (ParamsFold without a table).
template <class Fold = ParamsFold>
static unsigned sweep(bool generic, const float* P, const Layout& L, const Pixel& p, int view,
                      int samples, int reflections, float indent, uint32_t seed, V3 g_light,
                      DenseAcc& acc, unsigned only = 0u, int obj = -1,
                      V3 g_shared = {0.0f, 0.0f, 0.0f}) {
  if (generic) {
    return pixel_sweep<kMaxBounces, Fold>(P, L, p, view, 0, samples, reflections, indent, seed,
                                          g_light, acc, only, obj, g_shared);
  }
  return pixel_sweep<kMainBounces, Fold>(P, L, p, view, 0, samples, reflections, indent, seed,
                                         g_light, acc, only, obj, g_shared);
}

// A launch's fold and its params row: fold 0 is ParamsFold over P; 1-4
// the composite folds of the gradient kernels (reduce.cuh CompFold,
// UnionFold, TigerFold, CubeFold), over a copy of P followed by K1's fold
// table of the descriptor ``hints``, as a block builds it (one thread).
struct HostRow {
  alignas(16) float buf[kMaxParams + 4 + 4 * 512];
  const float* P;
};
static void host_row(HostRow& row, int fold, const float* P, const Layout& L, const int* hints) {
  row.P = P;
  if (fold == 0) return;
  for (int k = 0; k < L.size; ++k) row.buf[k] = P[k];
  build_fold_table(row.buf, L, hints_from(hints), 0, 1);
  row.P = row.buf;
}
template <class F> static void with_host_fold(int fold, F&& f) {
  switch (fold) {
    case 0: f(ParamsFold{}); break;
    case 1: f(GradCompositeFold<-1, -1, -1, -1, -1>{}); break;
    case 2: f(GradCompositeFold<-1, -1, kCompUnion, kLibraryFams, -1>{}); break;
    case 3: f(GradCompositeFold<-1, -1, kCompTiger, kLibraryFams, -1>{}); break;
    default: f(GradCompositeFold<-1, -1, kCompHypercube, -1, kLibraryCube>{}); break;
  }
}

extern "C" void host_loss_grad(int generic, const float* P0, const uint32_t* seeds, int n_frames,
                               const int* layout, int width, int height, int samples,
                               int reflections, float indent, float coef, const float* target,
                               double* loss_out, double* grad_out, float* light_out, int fold,
                               const int* hints) {
  Layout L;
  memcpy(&L, layout, sizeof(int) * kLayoutInts);
  static HostRow row;
  host_row(row, fold, P0, L, hints);
  const float* P = row.P;
  const long long total = (long long)L.n_views * height * width;
  with_host_fold(fold, [&](auto fold_tag) {
    using Fold = decltype(fold_tag);
    for (long long f = 0; f < n_frames; ++f) {
      for (long long lin = 0; lin < total; ++lin) {
        const int view = lin / (height * width), rem = lin % (height * width);
        const int py = rem / width, px = rem % width;
        float g[kMaxParams] = {0.0f};
        DenseAcc acc{g, nullptr};
        const Pixel p = setup_pixel<Fold>(P, L, view, px, py, width, height, indent);
        const V3 sum = pixel_light_sum<Fold>(P, L, p, samples, reflections, indent, seeds[f]);
        const LossCot lc = loss_cot(sum, target + lin * 3, coef, samples);
        *loss_out += lc.loss;
        sweep<Fold>(generic, P, L, p, view, samples, reflections, indent, seeds[f],
                    mul3s(lc.g_mean, 1.0f / (float)samples), acc);
        for (int k = 0; k < L.size; ++k) grad_out[k] += g[k];
        const float inv = 1.0f / (float)samples;
        float* out = light_out + (f * total + lin) * 3;
        out[0] = sum.x * inv;
        out[1] = sum.y * inv;
        out[2] = sum.z * inv;
      }
    }
  });
}

extern "C" void host_light_vjp(int generic, const float* P, int n_rows, uint32_t seed,
                               const int* layout, int width, int height, int samples,
                               int reflections, float indent, const float* cot,
                               double* grad_out, int fold, const int* hints) {
  Layout L;
  memcpy(&L, layout, sizeof(int) * kLayoutInts);
  const long long total = (long long)L.n_views * height * width;
  with_host_fold(fold, [&](auto fold_tag) {
    using Fold = decltype(fold_tag);
    for (long long r = 0; r < n_rows; ++r) {
      static HostRow row;
      host_row(row, fold, P + r * L.size, L, hints);
      const float* Pr = row.P;
      for (long long lin = 0; lin < total; ++lin) {
        const int view = lin / (height * width), rem = lin % (height * width);
        const int py = rem / width, px = rem % width;
        float g[kMaxParams] = {0.0f};
        DenseAcc acc{g, nullptr};
        const Pixel p = setup_pixel<Fold>(Pr, L, view, px, py, width, height, indent);
        const V3 g_light = mul3s(ld3(cot + (r * total + lin) * 3), 1.0f / (float)samples);
        sweep<Fold>(generic, Pr, L, p, view, samples, reflections, indent, seed, g_light, acc);
        for (int k = 0; k < L.size; ++k) grad_out[r * L.size + k] += g[k];
      }
    }
  });
}

// K6 split as the card splits it: pass 1 on each row (soft_sum_kernel's
// row blocks), the blend of both rows' sums, then row a's sweep
// (soft_row_a_kernel), carrying row b's cotangent on the samples that
// trace alike when bounce 0 misses the zero map's sphere, and row b's
// (soft_row_b_kernel): whole where bounce 0 hits the sphere (or for a map
// zero_map_object refuses), else the samples row a's sweep left to it;
// row b's without the zero map's slots. paths counts the pixels whose row
// b is swept whole and the samples row b sweeps alone.
extern "C" void host_soft_loss_grad(int generic, const float* P, int n_zero, const int* zero_idx,
                                    const float* zero_val, const int* layout, int width,
                                    int height, int samples, int reflections, float indent,
                                    float coef, uint32_t seed, const float* target,
                                    const float* alpha, double* loss_out, double* grad_out,
                                    float* alpha_cot_out, long long* paths) {
  Layout L;
  memcpy(&L, layout, sizeof(int) * kLayoutInts);
  float Pb[kMaxParams];
  unsigned char skip[kMaxParams] = {0};
  ZeroMap zm;
  zm.n = n_zero;
  for (int k = 0; k < L.size; ++k) Pb[k] = P[k];
  for (int i = 0; i < n_zero; ++i) {
    zm.idx[i] = zero_idx[i];
    zm.val[i] = zero_val[i];
    Pb[zero_idx[i]] = zero_val[i];
    skip[zero_idx[i]] = 1;
  }
  const int obj = samples <= 32 ? zero_map_object(L, zm) : -1;
  const long long total = (long long)L.n_views * height * width;
  for (long long lin = 0; lin < total; ++lin) {
    const int view = lin / (height * width), rem = lin % (height * width);
    const int py = rem / width, px = rem % width;
    const Pixel pa = setup_pixel(P, L, view, px, py, width, height, indent);
    const Pixel pb = setup_pixel(Pb, L, view, px, py, width, height, indent);
    const V3 sum_a = pixel_light_sum(P, L, pa, samples, reflections, indent, seed);
    const V3 sum_b = pixel_light_sum(Pb, L, pb, samples, reflections, indent, seed);
    const SoftBlend b = soft_blend(sum_a, sum_b, alpha[lin], target + lin * 3, coef, samples);
    float g[kMaxParams] = {0.0f};
    DenseAcc acc_a{g, nullptr};
    DenseAcc acc_b{g, skip};
    const float inv = 1.0f / (float)samples;
    const V3 g_a = mul3s(b.g_a, inv), g_b = mul3s(b.g_b, inv);
    const bool whole = obj < 0 || (pa.h0.hit && pa.h0.idx == obj);
    const unsigned alone = sweep(generic, P, L, pa, view, samples, reflections, indent, seed, g_a,
                                 acc_a, 0u, whole ? -1 : obj, whole ? V3{0.0f, 0.0f, 0.0f} : g_b);
    if (whole) {
      sweep(generic, Pb, L, pb, view, samples, reflections, indent, seed, g_b, acc_b);
      paths[0] += 1;
    } else if (alone != 0) {
      sweep(generic, Pb, L, pb, view, samples, reflections, indent, seed, g_b, acc_b, alone);
      paths[1] += __builtin_popcount(alone);
    }
    *loss_out += b.loss;
    alpha_cot_out[lin] = b.g_alpha;
    for (int k = 0; k < L.size; ++k) grad_out[k] += g[k];
  }
}
"""

# (reflections_amount, instance) of the cases beyond SHAPE's 3 bounces,
# which the generic instance (kMaxBounces) runs: the main paths' unrolled
# instance at its own count (kMainBounces), and the generic one at it too.
MAIN_BOUNCES = gradkernel.MAIN_BOUNCES
INSTANCES = [(MAIN_BOUNCES, "main"), (MAIN_BOUNCES, "generic")]


def config(bounces=SHAPE["reflections_amount"]):
    return renderer.RenderConfig(**dict(SHAPE, reflections_amount=bounces))


def is_generic(instance):
    return ctypes.c_int(instance == "generic")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the kernel's device math for the host")
    work = tmp_path_factory.mktemp("adjoint_host")
    (work / "cuda_runtime.h").write_text(SHIM)
    (work / "harness.cpp").write_text(HARNESS)
    lib = work / "libadjoint_host.so"
    proc = subprocess.run(
        [cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC", *build.DEFINES,
         f"-I{work}", f"-I{build.CSRC_DIR}", "-o", str(lib), str(work / "harness.cpp")],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(lib))


def grad_scene(name):
    """A library scene, or test_torch_freeze_hints.py's custom scene
    ``name`` under sphere_plane_light's sun and sky: "cylinders", a floor
    and two standalone cylinders (the first on unit axes, hinted; the
    second turned, not); "hypercube_tiger"; or "sphere_composites",
    hypercube_tiger with a sphere between the camera and the composites."""
    if name in library.SCENES:
        return library.SCENES[name](CPU)
    from test_torch_freeze_hints import custom_scene

    base = "hypercube_tiger" if name == "sphere_composites" else name
    scene = custom_scene(base, tscene, geometry, Vec4, CPU)
    scene = scene._replace(environment=library.sphere_plane_light(CPU).environment)
    if name == "sphere_composites":
        ball = tscene.sphere((0.0, 0.2, 0.3, 0.1), 0.6,
                             tscene.material(0, 0, (0.9, 0.9, 0.2), CPU), CPU)
        scene = scene._replace(spheres=(ball,))
    return scene


def axis_plane_scene():
    """(scene, camera): grad_scene("cylinders") seen level from (0, -2, 0,
    0), one view. Some of its sampled rays pass through the turned
    cylinder's axis plane, where perp2 = l2 - b^2 rounds below 0."""
    orient = tcam.orientation_from_angles(*tcam.CameraAngles.of(0.0, 0.0, 0.0, device=CPU), CPU)
    camera = tcam.make_camera(Vec4.of(0.0, -2.0, 0.0, 0.0, device=CPU), orient, 1.5, 2.0,
                              ("yxz",), CPU)
    return grad_scene("cylinders"), camera


# The harness's folds (HostRow): 0 ParamsFold, 1 the generic composite
# fold, 2-4 the library duocylinder's, tiger's and hypercube's instances.
LIBRARY_FOLDS = {"duocylinder": 2, "tiger": 3, "hypercube": 4}


def fold_args(scene, camera, cfg, library_instance=False):
    """(fold, descriptor or None) of the harness for ``scene`` under
    ``cfg``: a scene with composites folds over K1's table of cfg's
    descriptor (gradkernel.launch_words), through its library instance
    when asked (the card takes it under the hints at the main bounce
    count), else the generic one."""
    lay = params.layout(scene, camera)
    words = gradkernel.launch_words(lay, cfg)
    if not lay.composite_kinds():
        return 0, words
    name = next((n for n, f in LIBRARY_FOLDS.items()
                 if lay.composite_kinds() == library.SCENES[n](CPU).composite_kinds()), None)
    return (LIBRARY_FOLDS[name] if library_instance else 1), words


def host_loss_grad(lib, scene, camera, cfg, seeds, target, instance="generic",
                   library_instance=False):
    lay = params.layout(scene, camera)
    fold, words = fold_args(scene, camera, cfg, library_instance)
    packed = params.pack(scene, camera).numpy()
    seeds = np.asarray(seeds, np.uint32)
    total = lay.n_views * cfg.height * cfg.width
    loss, grad = ctypes.c_double(0.0), np.zeros(lay.size, np.float64)
    light = np.zeros((len(seeds), total * 3), np.float32)
    table = (ctypes.c_int * len(lay))(*lay)
    lib.host_loss_grad(is_generic(instance), ptr(packed), ptr(seeds), ctypes.c_int(len(seeds)),
                       table, ctypes.c_int(cfg.width), ctypes.c_int(cfg.height),
                       ctypes.c_int(cfg.samples), ctypes.c_int(cfg.reflections_amount),
                       ctypes.c_float(cfg.small_indent), ctypes.c_float(cfg.light_coefficient),
                       ptr(target), ctypes.byref(loss), ptr(grad), ptr(light),
                       ctypes.c_int(fold), words)
    scale = 1.0 / (len(seeds) * total * 3)
    return loss.value * scale, (grad * scale).astype(np.float32), light


def check_loss_grad(lib, name, views, cfg, instance):
    """K4's pass 1, loss_cot and sweep over every pixel against autograd,
    and its pass-1 light against the plain render."""
    scene = grad_scene(name)
    camera = camera_of(views)
    shape = (len(views), cfg.height, cfg.width, 3) if len(views) > 1 else (cfg.height, cfg.width, 3)
    target = np.random.default_rng(4).uniform(0, 1, shape).astype(np.float32)
    seeds = np.array([0x12345678, 9], np.uint32)
    loss, grad, light = host_loss_grad(lib, scene, camera, cfg, seeds, target, instance)
    ref_loss, ref_grad = gradkernel.loss_and_grad_plain(
        params.pack(scene, camera), scene, camera, cfg, seeds, torch.from_numpy(target))
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-6)
    assert_grad_close(grad, ref_grad.numpy(), pattern_floor(scene))
    ref_light = renderer.render_light(scene, camera, cfg, seeds).numpy()
    assert_images_close(light.reshape(ref_light.shape), ref_light, atol=1e-5,
                        boundary_frac=0.02, mean_atol=0.05)


@pytest.mark.parametrize("views", [("yxz",), tcam.VIEWS_ALL], ids=["1view", "3view"])
@pytest.mark.parametrize("name", GRAD_SCENES + COMPOSITE_SCENES)
def test_host_adjoint_matches_autograd(host_lib, name, views):
    """K4's per-pixel body, generic instance, at SHAPE's 3 bounces; a
    scene with composites through the generic composite fold, unhinted."""
    check_loss_grad(host_lib, name, views, config(), "generic")


@pytest.mark.parametrize("views", [("yxz",), tcam.VIEWS_ALL], ids=["1view", "3view"])
@pytest.mark.parametrize("name", GRAD_SCENES + COMPOSITE_SCENES)
@pytest.mark.parametrize("bounces,instance", INSTANCES, ids=[i for _, i in INSTANCES])
def test_host_adjoint_instances_match_autograd(host_lib, name, views, bounces, instance):
    """K4's per-pixel body at the main paths' bounce count, through the
    unrolled instance the card runs there and through the generic one."""
    check_loss_grad(host_lib, name, views, config(bounces), instance)


def ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def camera_of(views):
    orient = tcam.orientation_from_angles(*tcam.CameraAngles.of(0.1, -0.2, 0.3, device=CPU), CPU)
    return tcam.make_camera(Vec4.of(0.0, -2.0, 0.3, 0.1, device=CPU), orient, 1.5, 2.0, views, CPU)


def image_shape(views, cfg):
    return (len(views), cfg.height, cfg.width) if len(views) > 1 else (cfg.height, cfg.width)


def assert_grad_close(grad, ref, pattern_floor=0.0):
    """Mixed-scale relative error under 1e-3 and the same non-zero pattern
    on the slots above ``pattern_floor`` times the largest. A composite
    scene takes a floor of 1e-7: a face's radius and the axis-aligned
    families' point components collect cotangents that cancel to a
    residue of float32 rounding (the near-cancelling terms of the
    normal's 1/r and the circle's sqrt), exactly 0 in one order of sums
    and up to 1e-8 of the largest slot in the other (the tiger's inner
    radius); the mixed-scale bound holds on those slots too."""
    assert grad.shape == ref.shape and np.isfinite(grad).all()
    scale = np.maximum(np.abs(ref), 1e-3 * np.abs(ref).max() + 1e-8)
    assert (np.abs(grad - ref) / scale).max() < 1e-3
    big = np.maximum(np.abs(grad), np.abs(ref)) > pattern_floor * np.abs(ref).max()
    np.testing.assert_array_equal((grad != 0)[big], (ref != 0)[big])
    assert np.abs(ref).max() > 0


def pattern_floor(scene):
    """assert_grad_close's floor of the non-zero pattern for ``scene``."""
    return 1e-7 if scene.composite_kinds() else 0.0


def second_row(scene):
    """The second params row of a two-row K5: the scene's zero_object copy
    (sphere 0) as the soft pair sends it, or, for a scene with composites,
    the scene with its floor moved."""
    if not scene.composite_kinds():
        return diff.zero_object(scene, ("spheres", 0))
    floor = scene.spaces[0]
    return scene._replace(spaces=(floor._replace(point=floor.point._replace(
        z=floor.point.z - 0.25)), *scene.spaces[1:]))


def check_light_vjp(lib, name, views, rows, cfg, instance):
    scene = grad_scene(name)
    camera = camera_of(views)
    scenes = [scene, second_row(scene)][:rows]
    fold, words = fold_args(scene, camera, cfg)
    packed = params.stack_rows(scenes, camera)
    cot = np.random.default_rng(7).normal(
        0, 1, (rows, *image_shape(views, cfg), 3)).astype(np.float32)
    lay = params.layout(scene, camera)
    table = (ctypes.c_int * len(lay))(*lay)
    grad = np.zeros(rows * lay.size, np.float64)
    lib.host_light_vjp(is_generic(instance), ptr(packed.numpy()), ctypes.c_int(rows),
                       ctypes.c_uint32(9), table, ctypes.c_int(cfg.width),
                       ctypes.c_int(cfg.height), ctypes.c_int(cfg.samples),
                       ctypes.c_int(cfg.reflections_amount), ctypes.c_float(cfg.small_indent),
                       ptr(cot), ptr(grad), ctypes.c_int(fold), words)
    ref = gradkernel.render_light_vjp_plain(packed, scene, camera, cfg, 9,
                                            torch.from_numpy(cot)).numpy()
    assert_grad_close(grad.astype(np.float32).reshape(rows, lay.size), ref, pattern_floor(scene))


@pytest.mark.parametrize("rows", [1, 2], ids=["single", "two_rows"])
@pytest.mark.parametrize("views", [("yxz",), tcam.VIEWS_ALL], ids=["1view", "3view"])
@pytest.mark.parametrize("name", GRAD_SCENES + COMPOSITE_SCENES)
def test_host_light_vjp_matches_autograd(host_lib, name, views, rows):
    """K5's pixel sweep (generic instance, 3 bounces) with a seeded random
    light cotangent; two rows are the scene and its zero_object copy
    (sphere 0), as the soft pair sends, or with composites the scene and a
    copy with its floor moved."""
    check_light_vjp(host_lib, name, views, rows, config(), "generic")


@pytest.mark.parametrize("rows", [1, 2], ids=["single", "two_rows"])
@pytest.mark.parametrize("views", [("yxz",), tcam.VIEWS_ALL], ids=["1view", "3view"])
@pytest.mark.parametrize("name", GRAD_SCENES + COMPOSITE_SCENES)
def test_host_light_vjp_main_instance_matches_autograd(host_lib, name, views, rows):
    """K5's pixel sweep through the unrolled instance, at its bounce count."""
    check_light_vjp(host_lib, name, views, rows, config(MAIN_BOUNCES), "main")


def check_soft(lib, name, ref, views, cfg, instance, alpha_of, extra=()):
    """K6's split (pass 1 on each row, the blend of both rows' sums, row
    a's sweep carrying row b's cotangent where the rows trace alike, row
    b's sweeps of the pixels and samples where they part, without the zero
    map's slots) against autograd over the plain blend; ``extra`` adds
    (slot, value) pairs to the object's zero map. Returns the gradient and
    the counts of pixels swept apart and of samples swept on row b alone."""
    scene = library.SCENES[name](CPU)
    camera = camera_of(views)
    rng = np.random.default_rng(5)
    target = rng.uniform(0, 1, (*image_shape(views, cfg), 3)).astype(np.float32)
    alpha = alpha_of(rng, image_shape(views, cfg)).astype(np.float32)
    zero_map = [*params.soft_zero_map(scene, camera, ref), *extra]
    packed = params.pack(scene, camera)
    lay = params.layout(scene, camera)
    table = (ctypes.c_int * len(lay))(*lay)
    idx = np.array([i for i, _ in zero_map], np.int32)
    val = np.array([v for _, v in zero_map], np.float32)
    loss, grad = ctypes.c_double(0.0), np.zeros(lay.size, np.float64)
    alpha_cot = np.zeros(alpha.shape, np.float32)
    paths = np.zeros(2, np.int64)
    lib.host_soft_loss_grad(
        is_generic(instance), ptr(packed.numpy()), ctypes.c_int(len(idx)), ptr(idx), ptr(val),
        table, ctypes.c_int(cfg.width), ctypes.c_int(cfg.height), ctypes.c_int(cfg.samples),
        ctypes.c_int(cfg.reflections_amount), ctypes.c_float(cfg.small_indent),
        ctypes.c_float(cfg.light_coefficient), ctypes.c_uint32(3), ptr(target), ptr(alpha),
        ctypes.byref(loss), ptr(grad), ptr(alpha_cot), ptr(paths))
    scale = 1.0 / target.size
    ref_loss, ref_grad, ref_acot = gradkernel.render_soft_loss_and_grad_plain(
        packed, scene, camera, cfg, 3, torch.from_numpy(target), torch.from_numpy(alpha), zero_map)
    np.testing.assert_allclose(loss.value * scale, float(ref_loss), rtol=1e-6)
    assert_grad_close((grad * scale).astype(np.float32), ref_grad.numpy())
    assert_grad_close(alpha_cot * np.float32(scale), ref_acot.numpy())
    return grad, paths


SOFT_OBJECTS = [("room_with_sphere", ("spheres", 0)), ("sphere_plane_light", ("spheres", 1))]


def pixels(views, cfg):
    return len(views) * cfg.height * cfg.width


@pytest.mark.parametrize("views", [("yxz",), tcam.VIEWS_ALL], ids=["1view", "3view"])
@pytest.mark.parametrize("name,ref", SOFT_OBJECTS)
def test_host_soft_loss_grad_matches_autograd(host_lib, name, ref, views):
    """K6's per-pixel body (generic instance, 3 bounces): both rows, the
    alpha blend, the loss, both sweeps and the alpha cotangent, with a
    seeded random alpha and target. The sphere's own zero map: some pixels
    share row a's traces."""
    _, paths = check_soft(host_lib, name, ref, views, config(), "generic",
                          lambda rng, shape: rng.uniform(0, 1, shape))
    assert paths[0] < pixels(views, config())


@pytest.mark.parametrize("views", [("yxz",), tcam.VIEWS_ALL], ids=["1view", "3view"])
@pytest.mark.parametrize("name,ref", SOFT_OBJECTS)
def test_host_soft_shared_rows_main_instance(host_lib, name, ref, views):
    """K6 through the unrolled instance the card runs at the main paths'
    bounce count, with the sphere's own zero map: pixels swept apart (bounce
    0 on the sphere), pixels whose rows share row a's traces, and samples
    that hit the sphere swept again on row b alone all occur."""
    cfg = config(MAIN_BOUNCES)
    _, paths = check_soft(host_lib, name, ref, views, cfg, "main",
                          lambda rng, shape: rng.uniform(0, 1, shape))
    assert 0 < paths[0] < pixels(views, cfg) and paths[1] > 0


@pytest.mark.parametrize("views", [("yxz",), tcam.VIEWS_ALL], ids=["1view", "3view"])
@pytest.mark.parametrize("name,ref", SOFT_OBJECTS)
@pytest.mark.parametrize("rows", ["both", "row_b"])
def test_host_soft_rows_skip_zero_map(host_lib, name, ref, views, rows):
    """K6's split through the unrolled instance with a zero map that also
    rewrites wall 0's color, which row b's sweep does reach: row b must
    drop its cotangents of those slots, and no pixel shares row a's traces
    (zero_map_object refuses the map). ``row_b``: alpha 0, so the loss sees
    row b alone and row a's sweep adds zeros."""
    wall = params.layout(library.SCENES[name](CPU), camera_of(views)).spaces + 10
    alpha = ((lambda rng, shape: rng.uniform(0, 1, shape)) if rows == "both"
             else (lambda rng, shape: np.zeros(shape)))
    grad, paths = check_soft(host_lib, name, ref, views, config(MAIN_BOUNCES), "main", alpha,
                             extra=[(wall + k, 0.25) for k in range(3)])
    assert np.abs(grad[wall:wall + 3]).max() > 0 or rows == "row_b"
    assert paths[0] == pixels(views, config(MAIN_BOUNCES))


@pytest.mark.parametrize("name", COMPOSITE_SCENES)
def test_host_adjoint_under_the_contract(host_lib, name):
    """K4's per-pixel body on a composite scene under with_frozen_hints,
    through the instance the card takes there (a library scene's own at
    the main bounce count, else the generic composite fold) with the
    mask applied as sum_parts_kernel applies it: the loss and the light
    bitwise the unhinted fold's, every kept slot equal (== takes -0 for
    +0), the frozen slots (the hyperplane normals, the hinted axes) 0 and
    some of them not 0 unhinted; and within the mixed-scale bound of
    autograd over the unhinted plain pipeline with them frozen."""
    cfg = config(MAIN_BOUNCES)
    scene, camera = grad_scene(name), camera_of(("yxz",))
    hcfg = diff.with_frozen_hints(cfg, scene)
    keep = params.freeze_mask(hcfg, scene, params.layout(scene, camera).size).numpy()
    frozen = keep == 0
    target = np.random.default_rng(4).uniform(0, 1, (cfg.height, cfg.width, 3)).astype(np.float32)
    seeds = np.array([0x12345678, 9], np.uint32)
    loss_h, grad_h, light_h = host_loss_grad(host_lib, scene, camera, hcfg, seeds, target, "main",
                                             library_instance=name in LIBRARY_FOLDS)
    loss_u, grad_u, light_u = host_loss_grad(host_lib, scene, camera, cfg, seeds, target, "main")
    assert loss_h == loss_u and np.array_equal(light_h, light_u)
    grad_h = np.where(frozen, np.float32(0.0), grad_h)
    assert np.array_equal(grad_h[~frozen], grad_u[~frozen])
    assert np.abs(grad_u[frozen]).max() > 0.0 and np.abs(grad_h[~frozen]).max() > 0.0
    _, ref = gradkernel.loss_and_grad_plain(params.pack(scene, camera), scene, camera, cfg, seeds,
                                            torch.from_numpy(target))
    assert_grad_close(grad_h, np.where(frozen, 0.0, ref.numpy()).astype(np.float32),
                      pattern_floor(scene))
