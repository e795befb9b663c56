"""The gradient kernels' device math, compiled for the host, against torch
autograd over the plain pipeline.

The CUDA kernels themselves run only on a card (chip_smoke.py phases 8,
11 and 12). Their per-pixel code, csrc/trace.cuh and csrc/adjoint.cuh,
uses no CUDA API, so g++ builds it behind a small header that defines the
CUDA keywords and bit casts it needs; these tests call each kernel's
per-pixel function for every pixel and sum in double:

* K4's ``pixel_loss_grad`` (pass 1 and the pixel sweep) against
  ``loss_and_grad_plain``, and its light against the plain render;
* K5's ``pixel_light_vjp`` (the pixel sweep alone) with a seeded random
  light cotangent against ``render_light_vjp_plain``, one row and two
  rows (a scene and its ``zero_object`` copy);
* K6's ``pixel_soft_loss_grad`` (both rows, the blend, both sweeps)
  against ``render_soft_loss_and_grad_plain``.

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
from fourd_ray_tracing_tpu_torch.ops.cuda import build, gradkernel
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4

CPU = torch.device("cpu")
SHAPE = dict(width=32, height=16, samples=2, reflections_amount=3, rng_mode="per_sample",
             light_coefficient=0.7)

SHIM = r"""
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>
#define __device__
#define __global__
#define __forceinline__ inline
#define __constant__
#define __launch_bounds__(x)
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }
"""

HARNESS = r"""
#include "adjoint.cuh"
extern "C" void host_loss_grad(const float* P, const uint32_t* seeds, int n_frames,
                               const int* layout, int width, int height, int samples,
                               int reflections, float indent, float coef, const float* target,
                               double* loss_out, double* grad_out, float* light_out) {
  Layout L;
  memcpy(&L, layout, sizeof(int) * kLayoutInts);
  const long long total = (long long)L.n_views * height * width;
  for (long long f = 0; f < n_frames; ++f) {
    for (long long lin = 0; lin < total; ++lin) {
      const int view = lin / (height * width), rem = lin % (height * width);
      const int py = rem / width, px = rem % width;
      float g[kMaxParams] = {0.0f};
      *loss_out += pixel_loss_grad(P, L, view, px, py, width, height, samples, reflections,
                                   indent, coef, seeds[f], target + lin * 3, g);
      for (int k = 0; k < L.size; ++k) grad_out[k] += g[k];
      const Pixel p = setup_pixel(P, L, view, px, py, width, height, indent);
      V3 acc = {0.0f, 0.0f, 0.0f};
      for (int s = 0; s < samples; ++s)
        acc = add3(acc, trace_sample<false>(P, L, p, s, seeds[f], reflections, indent, nullptr,
                                            nullptr, nullptr, nullptr));
      const float inv = 1.0f / (float)samples;
      float* out = light_out + (f * total + lin) * 3;
      out[0] = acc.x * inv;
      out[1] = acc.y * inv;
      out[2] = acc.z * inv;
    }
  }
}

extern "C" void host_light_vjp(const float* P, int n_rows, uint32_t seed, const int* layout,
                               int width, int height, int samples, int reflections, float indent,
                               const float* cot, double* grad_out) {
  Layout L;
  memcpy(&L, layout, sizeof(int) * kLayoutInts);
  const long long total = (long long)L.n_views * height * width;
  for (long long r = 0; r < n_rows; ++r) {
    for (long long lin = 0; lin < total; ++lin) {
      const int view = lin / (height * width), rem = lin % (height * width);
      const int py = rem / width, px = rem % width;
      float g[kMaxParams] = {0.0f};
      pixel_light_vjp(P + r * L.size, L, view, px, py, width, height, samples, reflections,
                      indent, seed, cot + (r * total + lin) * 3, g);
      for (int k = 0; k < L.size; ++k) grad_out[r * L.size + k] += g[k];
    }
  }
}

extern "C" void host_soft_loss_grad(const float* P, int n_zero, const int* zero_idx,
                                    const float* zero_val, const int* layout, int width,
                                    int height, int samples, int reflections, float indent,
                                    float coef, uint32_t seed, const float* target,
                                    const float* alpha, double* loss_out, double* grad_out,
                                    float* alpha_cot_out) {
  Layout L;
  memcpy(&L, layout, sizeof(int) * kLayoutInts);
  ZeroMap zm;
  zm.n = n_zero;
  float Pb[kMaxParams];
  for (int k = 0; k < L.size; ++k) Pb[k] = P[k];
  for (int i = 0; i < n_zero; ++i) {
    zm.idx[i] = zero_idx[i];
    zm.val[i] = zero_val[i];
    Pb[zero_idx[i]] = zero_val[i];
  }
  const long long total = (long long)L.n_views * height * width;
  for (long long lin = 0; lin < total; ++lin) {
    const int view = lin / (height * width), rem = lin % (height * width);
    const int py = rem / width, px = rem % width;
    float g[kMaxParams] = {0.0f};
    *loss_out += pixel_soft_loss_grad(P, Pb, L, zm, view, px, py, width, height, samples,
                                      reflections, indent, coef, seed, target + lin * 3,
                                      alpha[lin], g, alpha_cot_out + lin);
    for (int k = 0; k < L.size; ++k) grad_out[k] += g[k];
  }
}
"""


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


def host_loss_grad(lib, scene, camera, cfg, seeds, target):
    lay = params.layout(scene, camera)
    packed = params.pack(scene, camera).numpy()
    seeds = np.asarray(seeds, np.uint32)
    total = lay.n_views * cfg.height * cfg.width
    loss, grad = ctypes.c_double(0.0), np.zeros(lay.size, np.float64)
    light = np.zeros((len(seeds), total * 3), np.float32)
    table = (ctypes.c_int * len(lay))(*lay)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    lib.host_loss_grad(ptr(packed), ptr(seeds), ctypes.c_int(len(seeds)), table,
                       ctypes.c_int(cfg.width), ctypes.c_int(cfg.height),
                       ctypes.c_int(cfg.samples), ctypes.c_int(cfg.reflections_amount),
                       ctypes.c_float(cfg.small_indent), ctypes.c_float(cfg.light_coefficient),
                       ptr(target), ctypes.byref(loss), ptr(grad), ptr(light))
    scale = 1.0 / (len(seeds) * total * 3)
    return loss.value * scale, (grad * scale).astype(np.float32), light


@pytest.mark.parametrize("views", [("yxz",), tcam.VIEWS_ALL], ids=["1view", "3view"])
@pytest.mark.parametrize("name", sorted(library.SCENES))
def test_host_adjoint_matches_autograd(host_lib, name, views):
    cfg = renderer.RenderConfig(**SHAPE)
    scene = library.SCENES[name](CPU)
    orient = tcam.orientation_from_angles(*tcam.CameraAngles.of(0.1, -0.2, 0.3, device=CPU), CPU)
    camera = tcam.make_camera(Vec4.of(0.0, -2.0, 0.3, 0.1, device=CPU), orient, 1.5, 2.0, views,
                              CPU)
    shape = (len(views), cfg.height, cfg.width, 3) if len(views) > 1 else (cfg.height, cfg.width, 3)
    target = np.random.default_rng(4).uniform(0, 1, shape).astype(np.float32)
    seeds = np.array([0x12345678, 9], np.uint32)
    loss, grad, light = host_loss_grad(host_lib, scene, camera, cfg, seeds, target)
    ref_loss, ref_grad = gradkernel.loss_and_grad_plain(
        params.pack(scene, camera), scene, camera, cfg, seeds, torch.from_numpy(target))
    ref_grad = ref_grad.numpy()
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-6)
    scale = np.maximum(np.abs(ref_grad), 1e-3 * np.abs(ref_grad).max() + 1e-8)
    assert (np.abs(grad - ref_grad) / scale).max() < 1e-3
    np.testing.assert_array_equal(grad != 0, ref_grad != 0)
    ref_light = renderer.render_light(scene, camera, cfg, seeds).numpy()
    assert_images_close(light.reshape(ref_light.shape), ref_light, atol=1e-5,
                        boundary_frac=0.02, mean_atol=0.05)


def ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def camera_of(views):
    orient = tcam.orientation_from_angles(*tcam.CameraAngles.of(0.1, -0.2, 0.3, device=CPU), CPU)
    return tcam.make_camera(Vec4.of(0.0, -2.0, 0.3, 0.1, device=CPU), orient, 1.5, 2.0, views, CPU)


def image_shape(views, cfg):
    return (len(views), cfg.height, cfg.width) if len(views) > 1 else (cfg.height, cfg.width)


def assert_grad_close(grad, ref):
    """Mixed-scale relative error under 1e-3 and the same non-zero pattern."""
    assert grad.shape == ref.shape and np.isfinite(grad).all()
    scale = np.maximum(np.abs(ref), 1e-3 * np.abs(ref).max() + 1e-8)
    assert (np.abs(grad - ref) / scale).max() < 1e-3
    np.testing.assert_array_equal(grad != 0, ref != 0)
    assert np.abs(ref).max() > 0


@pytest.mark.parametrize("rows", [1, 2], ids=["single", "two_rows"])
@pytest.mark.parametrize("views", [("yxz",), tcam.VIEWS_ALL], ids=["1view", "3view"])
@pytest.mark.parametrize("name", sorted(library.SCENES))
def test_host_light_vjp_matches_autograd(host_lib, name, views, rows):
    """K5's pixel sweep with a seeded random light cotangent; two rows are
    the scene and its zero_object copy (sphere 0), as the soft pair sends."""
    cfg = renderer.RenderConfig(**SHAPE)
    scene = library.SCENES[name](CPU)
    camera = camera_of(views)
    scenes = [scene, diff.zero_object(scene, ("spheres", 0))][:rows]
    packed = params.stack_rows(scenes, camera)
    cot = np.random.default_rng(7).normal(
        0, 1, (rows, *image_shape(views, cfg), 3)).astype(np.float32)
    lay = params.layout(scene, camera)
    table = (ctypes.c_int * len(lay))(*lay)
    grad = np.zeros(rows * lay.size, np.float64)
    host_lib.host_light_vjp(ptr(packed.numpy()), ctypes.c_int(rows), ctypes.c_uint32(9), table,
                            ctypes.c_int(cfg.width), ctypes.c_int(cfg.height),
                            ctypes.c_int(cfg.samples), ctypes.c_int(cfg.reflections_amount),
                            ctypes.c_float(cfg.small_indent), ptr(cot), ptr(grad))
    ref = gradkernel.render_light_vjp_plain(packed, scene, camera, cfg, 9,
                                            torch.from_numpy(cot)).numpy()
    assert_grad_close(grad.astype(np.float32).reshape(rows, lay.size), ref)


@pytest.mark.parametrize("views", [("yxz",), tcam.VIEWS_ALL], ids=["1view", "3view"])
@pytest.mark.parametrize("name,ref", [("room_with_sphere", ("spheres", 0)),
                                      ("sphere_plane_light", ("spheres", 1))])
def test_host_soft_loss_grad_matches_autograd(host_lib, name, ref, views):
    """K6's per-pixel body: both rows, the alpha blend, the loss, both
    sweeps and the alpha cotangent, with a seeded random alpha and target."""
    cfg = renderer.RenderConfig(**SHAPE)
    scene = library.SCENES[name](CPU)
    camera = camera_of(views)
    rng = np.random.default_rng(5)
    target = rng.uniform(0, 1, (*image_shape(views, cfg), 3)).astype(np.float32)
    alpha = rng.uniform(0, 1, image_shape(views, cfg)).astype(np.float32)
    zero_map = params.soft_zero_map(scene, camera, ref)
    packed = params.pack(scene, camera)
    lay = params.layout(scene, camera)
    table = (ctypes.c_int * len(lay))(*lay)
    idx = np.array([i for i, _ in zero_map], np.int32)
    val = np.array([v for _, v in zero_map], np.float32)
    loss, grad = ctypes.c_double(0.0), np.zeros(lay.size, np.float64)
    alpha_cot = np.zeros(alpha.shape, np.float32)
    host_lib.host_soft_loss_grad(
        ptr(packed.numpy()), ctypes.c_int(len(idx)), ptr(idx), ptr(val), table,
        ctypes.c_int(cfg.width), ctypes.c_int(cfg.height), ctypes.c_int(cfg.samples),
        ctypes.c_int(cfg.reflections_amount), ctypes.c_float(cfg.small_indent),
        ctypes.c_float(cfg.light_coefficient), ctypes.c_uint32(3), ptr(target), ptr(alpha),
        ctypes.byref(loss), ptr(grad), ptr(alpha_cot))
    scale = 1.0 / target.size
    ref_loss, ref_grad, ref_acot = gradkernel.render_soft_loss_and_grad_plain(
        packed, scene, camera, cfg, 3, torch.from_numpy(target), torch.from_numpy(alpha), zero_map)
    np.testing.assert_allclose(loss.value * scale, float(ref_loss), rtol=1e-6)
    assert_grad_close((grad * scale).astype(np.float32), ref_grad.numpy())
    assert_grad_close(alpha_cot * np.float32(scale), ref_acot.numpy())
