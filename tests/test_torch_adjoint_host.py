"""The value-and-grad kernel's device math, compiled for the host, against
torch autograd over the plain pipeline.

The CUDA kernel itself runs only on a card (chip_smoke.py phase 8). Its
per-pixel code, csrc/trace.cuh and csrc/gradkernel.cu up to the
``// --- kernels`` line, uses no CUDA API, so g++ builds it behind a small
header that defines the CUDA keywords and bit casts it needs; this test
calls ``pixel_loss_grad`` for every pixel and sums in double. That holds
the hand-written adjoint (every partial derivative of the trace) to
autograd on the CPU: loss within rtol 1e-6, every gradient within the
mixed-scale relative error 1e-3 of test_torch_gradkernel.py with the same
non-zero pattern, and the light within the port's image bounds (built
with -ffp-contract=off it matches torch's CPU pipeline to an ulp).
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from helpers import assert_images_close

from fourd_ray_tracing_tpu_torch import camera as tcam
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
#include "grad_device.inc"
}  // namespace
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
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the kernel's device math for the host")
    work = tmp_path_factory.mktemp("adjoint_host")
    source = (build.CSRC_DIR / "gradkernel.cu").read_text()
    (work / "grad_device.inc").write_text(source[:source.index("// --- kernels")])
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
