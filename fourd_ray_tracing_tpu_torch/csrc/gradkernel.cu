// Gradient kernels for Hopper (sm_90a) over the hand-written adjoint of
// adjoint.cuh:
//
// K4, loss_grad_kernel: the masked tone-mapped MSE of a render against a
// target, and its cotangent for every packed scene, environment and camera
// parameter. Replaces fourd_ray_tracing_tpu/ops/pallas/gradkernel.py::
// _loss_grad_kernel (launched by _launch). Per pixel it runs pass 1 (the
// light, bitwise K1's), the loss and its light cotangent, then the pixel
// sweep (adjoint.cuh pixel_loss_grad).
//
// K5, light_vjp_kernel: the VJP of the mean light for a given per-pixel
// light cotangent, so that any torch loss over rendered light trains on
// the kernels (diff.RenderLight, diff.render_light_pair). Replaces
// gradkernel.py::_light_vjp_kernel (launched by _render_light_vjp_jit and,
// with frame_params, by _render_light_vjp_multi_jit). It is the pixel
// sweep alone: no loss, no pass 1. A launch takes F parameter rows (row
// stride 0 for one scene, P for F same-structure scenes, as K2 does) and an
// (F, V, H, W, 3) cotangent, at one seed, and returns (F, P).
//
// Design. One thread per (frame or row, view, y, x) pixel; the packed
// parameters of its frame or row sit in shared memory. Each thread holds
// its P cotangents in a local array; the block reduces them in a fixed
// order into one column of partials (reduce.cuh), and sum_parts_kernel sums
// each row in a fixed order in double and applies the scale. No float
// atomics: two launches give bitwise equal results. Padded lanes
// (lin >= V*H*W) compute nothing and contribute zeros.
//
// What bounds them: arithmetic, as in K1, plus the pixel sweep (a second
// trace with its reverse sweep) and the per-thread cotangent array, which
// lives in local memory (L1-cached) because it is indexed by the hit
// primitive. The block reduction costs 5 shuffles per parameter per thread.
//
// Still to do for speed (later work): register-resident bounce records, a
// sparse per-primitive accumulation instead of the dense array, occupancy
// tuning, and the static hints.

#include <cstddef>

#include "reduce.cuh"

namespace {

// Grid (blocks, frames). Block (x, f) writes column f * gridDim.x + x of
// grad_parts (P rows of n_cols) and of loss_parts.
__global__ void __launch_bounds__(kBlock)
loss_grad_kernel(const float* __restrict__ params, const uint32_t* __restrict__ seeds, Layout L,
                 int width, int height, int samples, int reflections, float small_indent,
                 float light_coefficient, const float* __restrict__ target,
                 float* __restrict__ grad_parts, double* __restrict__ loss_parts, int n_cols) {
  extern __shared__ float P[];
  for (int i = threadIdx.x; i < L.size; i += blockDim.x) P[i] = params[i];
  __syncthreads();

  const long long total = static_cast<long long>(L.n_views) * height * width;
  const long long lin = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float g[kMaxParams];
  for (int k = 0; k < L.size; ++k) g[k] = 0.0f;
  float loss = 0.0f;
  if (lin < total) {  // no early return: every lane joins the reduction
    const int hw = height * width;
    const int view = static_cast<int>(lin / hw);
    const int rem = static_cast<int>(lin - static_cast<long long>(view) * hw);
    const int py = rem / width;
    const int px = rem - py * width;
    loss = pixel_loss_grad(P, L, view, px, py, width, height, samples, reflections,
                           small_indent, light_coefficient, seeds[blockIdx.y], target + lin * 3,
                           g);
  }
  reduce_block(g, L.size, loss, grad_parts, loss_parts, n_cols,
               static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x);
}

// Grid (blocks, rows). Block (x, f) reads params row f (at f * row_stride)
// and cotangent row f, and writes column x of rows f*P .. f*P + P-1 of
// grad_parts (F*P rows of n_cols = blocks).
__global__ void __launch_bounds__(kBlock)
light_vjp_kernel(const float* __restrict__ params, long long row_stride, uint32_t seed, Layout L,
                 int width, int height, int samples, int reflections, float small_indent,
                 const float* __restrict__ cot, float* __restrict__ grad_parts, int n_cols) {
  extern __shared__ float P[];
  const int row = blockIdx.y;
  for (int i = threadIdx.x; i < L.size; i += blockDim.x) P[i] = params[row * row_stride + i];
  __syncthreads();

  const long long total = static_cast<long long>(L.n_views) * height * width;
  const long long lin = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float g[kMaxParams];
  for (int k = 0; k < L.size; ++k) g[k] = 0.0f;
  if (lin < total) {  // no early return: every lane joins the reduction
    const int hw = height * width;
    const int view = static_cast<int>(lin / hw);
    const int rem = static_cast<int>(lin - static_cast<long long>(view) * hw);
    const int py = rem / width;
    const int px = rem - py * width;
    pixel_light_vjp(P, L, view, px, py, width, height, samples, reflections, small_indent, seed,
                    cot + (static_cast<long long>(row) * total + lin) * 3, g);
  }
  reduce_block(g, L.size, 0.0f,
               grad_parts + static_cast<long long>(row) * L.size * n_cols, nullptr, n_cols,
               blockIdx.x);
}

}  // namespace

// Columns of a gradient launch's scratch (F * blocks, blocks = ceil(V*H*W
// / kBlock)), or -1 for a shape the launch refuses. K5 and K6 take it with
// n_frames = 1: their scratch has one column per block of a row.
extern "C" int fourd_grad_scratch_cols(const int* layout, int width, int height, int n_frames) {
  const long long blocks = pixel_blocks(layout_from(layout), width, height);
  const long long cols = blocks * n_frames;
  if (blocks <= 0 || n_frames <= 0 || n_frames > 65535 || cols > 0x7FFFFFFFLL) return -1;
  return static_cast<int>(cols);
}

// K4 on ``stream``: loss (1,) and grad (P,) float32, both scaled by
// ``scale``, from params (P,) float32, seeds (F,) uint32 and target
// (V, H, W, 3) float32. grad_parts (P, n_cols) float32 and loss_parts
// (n_cols,) float64 are scratch of the caller's, n_cols as
// fourd_grad_scratch_cols gives it. Returns cudaGetLastError() after each
// launch.
extern "C" int fourd_loss_grad_launch(const float* params, const uint32_t* seeds, int n_frames,
                                      const int* layout, int width, int height, int samples,
                                      int reflections, float small_indent,
                                      float light_coefficient, const float* target, float scale,
                                      float* grad_parts, double* loss_parts, float* grad_out,
                                      float* loss_out, void* stream) {
  const Layout L = layout_from(layout);
  const int n_cols = fourd_grad_scratch_cols(layout, width, height, n_frames);
  const size_t smem = static_cast<size_t>(L.size) * sizeof(float);
  if (n_cols < 0 || samples <= 0 || reflections < 0 || reflections > kMaxBounces ||
      L.size <= 0 || L.size > kMaxParams) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = n_cols / n_frames;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_frames));
  loss_grad_kernel<<<grid, kBlock, smem, s>>>(params, seeds, L, width, height, samples,
                                              reflections, small_indent, light_coefficient,
                                              target, grad_parts, loss_parts, n_cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_parts_kernel<<<L.size + 1, kSumThreads, 0, s>>>(grad_parts, loss_parts, L.size, n_cols,
                                                      scale, grad_out, loss_out);
  return static_cast<int>(cudaGetLastError());
}

// K5 on ``stream``: grad_out (F, P) float32, the unscaled parameter
// cotangents of each row's mean light, from params (F rows of P floats,
// ``row_stride`` apart: 0 for one shared row), one seed and cot
// (F, V, H, W, 3) float32. grad_parts (F*P, n_cols) float32 is scratch of
// the caller's, n_cols as fourd_grad_scratch_cols(layout, width, height, 1)
// gives it. Returns cudaGetLastError() after each launch.
extern "C" int fourd_light_vjp_launch(const float* params, long long row_stride, int n_rows,
                                      uint32_t seed, const int* layout, int width, int height,
                                      int samples, int reflections, float small_indent,
                                      const float* cot, float* grad_parts, float* grad_out,
                                      void* stream) {
  const Layout L = layout_from(layout);
  const int n_cols = fourd_grad_scratch_cols(layout, width, height, 1);
  const size_t smem = static_cast<size_t>(L.size) * sizeof(float);
  if (n_cols < 0 || n_rows <= 0 || n_rows > 65535 || row_stride < 0 || samples <= 0 ||
      reflections < 0 || reflections > kMaxBounces || L.size <= 0 || L.size > kMaxParams) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(static_cast<unsigned>(n_cols), static_cast<unsigned>(n_rows));
  light_vjp_kernel<<<grid, kBlock, smem, s>>>(params, row_stride, seed, L, width, height,
                                              samples, reflections, small_indent, cot,
                                              grad_parts, n_cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_parts_kernel<<<n_rows * L.size, kSumThreads, 0, s>>>(grad_parts, nullptr, n_rows * L.size,
                                                           n_cols, 1.0f, grad_out, nullptr);
  return static_cast<int>(cudaGetLastError());
}
