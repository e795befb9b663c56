// Fused soft-silhouette value-and-grad kernel (K6) for Hopper (sm_90a):
// both rows of the soft loss (the scene, and the same scene with one object
// zeroed into a guaranteed miss), their blend by the per-pixel coverage
// alpha, the MSE against a target, every packed parameter's cotangent and
// the cotangent of alpha, in one launch.
//
// Replaces fourd_ray_tracing_tpu/ops/pallas/gradkernel.py::
// _soft_loss_grad_kernel (launched by _soft_launch). Like it, alpha is an
// input here and its cotangent an output: the coverage that makes alpha is
// plain torch outside the kernel (diff.object_coverage), and autograd
// carries the alpha cotangent back through it (diff.SoftImageLoss).
//
// Design. One thread per (view, y, x) pixel; each block holds two copies
// of the packed parameters in shared memory: row a, the params, and row b,
// the params with the zero map applied (the static (slot, value) pairs of
// models/params.py soft_zero_map). Per pixel (adjoint.cuh
// pixel_soft_loss_grad): pass 1 traces both rows at the same seed, the
// blend gives the loss, the cotangents of both rows' lights and of alpha;
// the pixel sweep runs on row a and on row b into the same P-float
// cotangent array, keeping row b off the zero-map slots. The TPU kernel's
// two-pass form (grad_sample_chunk < samples) existed to bound Mosaic's
// memory; this kernel is two-pass by design, so one form serves both. The
// block reduction and the fixed-order sum are K4's (reduce.cuh); the alpha
// cotangent is written per thread, with no reduction. All outputs are
// scaled by 1 / (V*H*W*3) (gradkernel.py:1448-1452).
//
// With a row offset it is K3's sharded launch of K6
// (sharded_soft_loss_and_grad_pallas): image rows [row0, row0 + n_rows)
// only, with that block of the target, alpha and alpha cotangent; the
// pixel math keeps global coordinates, the reads and writes index the block.
//
// What bounds it: arithmetic, as K4, twice over: two pass-1 traces and two
// pixel sweeps per pixel, with the same local-memory cotangent array.

#include "reduce.cuh"

namespace {

__global__ void __launch_bounds__(kBlock)
soft_loss_grad_kernel(const float* __restrict__ params, uint32_t seed, Layout L, ZeroMap zm,
                      int width, int height, int row0, int n_rows, int samples, int reflections,
                      float small_indent, float light_coefficient,
                      const float* __restrict__ target, const float* __restrict__ alpha,
                      float scale,
                      float* __restrict__ grad_parts, double* __restrict__ loss_parts,
                      float* __restrict__ alpha_cot, int n_cols) {
  extern __shared__ float smem[];
  float* Pa = smem;
  float* Pb = smem + L.size;
  for (int i = threadIdx.x; i < L.size; i += blockDim.x) {
    const float v = params[i];
    Pa[i] = v;
    Pb[i] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < zm.n; ++i) Pb[zm.idx[i]] = zm.val[i];
  }
  __syncthreads();

  const long long total = static_cast<long long>(L.n_views) * n_rows * width;
  const long long lin = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float g[kMaxParams];
  for (int k = 0; k < L.size; ++k) g[k] = 0.0f;
  float loss = 0.0f;
  if (lin < total) {  // no early return: every lane joins the reduction
    const int hw = n_rows * width;
    const int view = static_cast<int>(lin / hw);
    const int rem = static_cast<int>(lin - static_cast<long long>(view) * hw);
    const int ly = rem / width;
    const int px = rem - ly * width;
    const int py = row0 + ly;
    float g_alpha = 0.0f;
    loss = pixel_soft_loss_grad(Pa, Pb, L, zm, view, px, py, width, height, samples, reflections,
                                small_indent, light_coefficient, seed, target + lin * 3,
                                alpha[lin], g, &g_alpha);
    alpha_cot[lin] = g_alpha * scale;
  }
  reduce_block(g, L.size, loss, grad_parts, loss_parts, n_cols, blockIdx.x);
}

}  // namespace

// K6 on ``stream``: loss (1,), grad (P,) and alpha_cot (V, n_rows, W)
// float32, all scaled by ``scale``, of image rows [row0, row0 + n_rows) of
// H, from params (P,) float32, one seed, the zero map (n_zero slots and
// values, host arrays), and those rows of the target (V, n_rows, W, 3) and
// of alpha (V, n_rows, W) float32. grad_parts (P, n_cols) float32 and
// loss_parts (n_cols,) float64 are scratch of the caller's, n_cols as
// fourd_grad_scratch_cols(layout, width, n_rows, 1) gives it. Returns
// cudaGetLastError() after each launch.
extern "C" int fourd_soft_loss_grad_launch(const float* params, uint32_t seed, const int* layout,
                                           int n_zero, const int* zero_idx,
                                           const float* zero_val, int width, int height,
                                           int row0, int n_rows, int samples, int reflections,
                                           float small_indent,
                                           float light_coefficient, const float* target,
                                           const float* alpha, float scale, float* grad_parts,
                                           double* loss_parts, float* grad_out, float* loss_out,
                                           float* alpha_cot, void* stream) {
  const Layout L = layout_from(layout);
  const long long blocks = pixel_blocks(L, width, n_rows);
  const size_t smem = 2 * static_cast<size_t>(L.size) * sizeof(float);
  if (blocks <= 0 || blocks > 0x7FFFFFFFLL || row0 < 0 || row0 + n_rows > height ||
      samples <= 0 || reflections < 0 ||
      reflections > kMaxBounces || L.size <= 0 || L.size > kMaxParams || n_zero <= 0 ||
      n_zero > kMaxZeroSlots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ZeroMap zm;
  zm.n = n_zero;
  for (int i = 0; i < kMaxZeroSlots; ++i) {
    zm.idx[i] = i < n_zero ? zero_idx[i] : 0;
    zm.val[i] = i < n_zero ? zero_val[i] : 0.0f;
    if (zm.idx[i] < 0 || zm.idx[i] >= L.size) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_cols = static_cast<int>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  soft_loss_grad_kernel<<<n_cols, kBlock, smem, s>>>(params, seed, L, zm, width, height, row0,
                                                     n_rows, samples, reflections, small_indent,
                                                     light_coefficient, target, alpha, scale,
                                                     grad_parts, loss_parts, alpha_cot, n_cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_parts_kernel<<<L.size + 1, kSumThreads, 0, s>>>(grad_parts, loss_parts, L.size, n_cols,
                                                      scale, grad_out, loss_out);
  return static_cast<int>(cudaGetLastError());
}
