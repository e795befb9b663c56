// The kernel of the value-and-grad kernel's pass-budget variants K8 and its
// launch over one fold: ablate.cu launches it over the production folds,
// ablatemodes.cu over K1's other configurations (a Modes fold), each
// source in its own nvcc process. The design is ablate.cu's.
#pragma once

#include "reduce.cuh"

namespace {

constexpr int kModeAcc = 0;
constexpr int kModeLoss = 1;
constexpr int kModeVjp = 2;

template <int kMode, class Fold>
__global__ void __launch_bounds__(kGradBlock)
ablate_kernel(const float* __restrict__ params, uint32_t seed, Layout L, int width, int height,
              int samples, int reflections, float small_indent, float light_coefficient,
              const float* __restrict__ target, double* __restrict__ loss_parts, int n_cols,
              Hints H) {
  extern __shared__ float P[];
  for (int i = threadIdx.x; i < L.size; i += blockDim.x) P[i] = params[i];
  __syncthreads();
  build_table_for<Fold>(P, L, H);

  const long long total = static_cast<long long>(L.n_views) * height * width;
  const long long lin = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float value = 0.0f;
  if (lin < total) {  // no early return: every lane joins the reduction
    const int hw = height * width;
    const int view = static_cast<int>(lin / hw);
    const int rem = static_cast<int>(lin - static_cast<long long>(view) * hw);
    const int py = rem / width;
    const int px = rem - py * width;
    const Pixel p = setup_pixel<Fold>(P, L, view, px, py, width, height, small_indent);
    const V3 acc = pixel_light_sum<Fold>(P, L, p, samples, reflections, small_indent, seed);
    if constexpr (kMode == kModeAcc) {
      value = acc.x + acc.y + acc.z;
    } else {
      // K4's pass 1 (gradkernel.cu loss_cot_kernel): adjoint.cuh loss_cot.
      const LossCot lc = loss_cot(acc, target + lin * 3, light_coefficient, samples);
      value = lc.loss;
      if constexpr (kMode == kModeVjp) {
        value = value + 0.0f * (lc.g_mean.x + lc.g_mean.y + lc.g_mean.z);
      }
    }
  }
  reduce_block(nullptr, 0, value, nullptr, loss_parts, n_cols, blockIdx.x);
}

template <int kMode, class Fold>
void launch_fold(const float* params, uint32_t seed, const Layout& L, const Hints& H, int width,
                 int height, int samples, int reflections, float small_indent,
                 float light_coefficient, const float* target, double* loss_parts, int n_cols,
                 cudaStream_t s) {
  const size_t smem = params_table_bytes(L.size, table_recs_for<Fold>(L, H));
  ablate_kernel<kMode, Fold><<<n_cols, kGradBlock, smem, s>>>(
      params, seed, L, width, height, samples, reflections, small_indent, light_coefficient,
      target, loss_parts, n_cols, H);
}

// K8's launches on ``s`` under the fold Fold: the variant ``mode``'s kernel
// over the n_cols blocks of the image, then sum_parts_kernel (the
// arguments are fourd_ablate_launch's). Returns cudaGetLastError() after
// each launch.
template <class Fold>
int k8_launch(int mode, const float* params, uint32_t seed, const Layout& L, const Hints& H,
              int width, int height, int samples, int reflections, float small_indent,
              float light_coefficient, const float* target, double* loss_parts, float* value_out,
              int n_cols, cudaStream_t s) {
  switch (mode) {
    case kModeAcc:
      launch_fold<kModeAcc, Fold>(params, seed, L, H, width, height, samples, reflections,
                                  small_indent, light_coefficient, target, loss_parts, n_cols, s);
      break;
    case kModeLoss:
      launch_fold<kModeLoss, Fold>(params, seed, L, H, width, height, samples, reflections,
                                   small_indent, light_coefficient, target, loss_parts, n_cols,
                                   s);
      break;
    default:
      launch_fold<kModeVjp, Fold>(params, seed, L, H, width, height, samples, reflections,
                                  small_indent, light_coefficient, target, loss_parts, n_cols, s);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_parts_kernel<<<1, kSumThreads, 0, s>>>(nullptr, loss_parts, 0, n_cols, n_cols, 1.0f,
                                             nullptr, value_out, nullptr, 1);
  return static_cast<int>(cudaGetLastError());
}

// The pixel blocks of a K8 launch, one column each, or -1 for a shape no
// launch takes.
inline int k8_cols(const Layout& L, int width, int height) {
  const long long blocks = pixel_blocks(L, width, height);
  return blocks <= 0 || blocks > 0x7FFFFFFFLL ? -1 : static_cast<int>(blocks);
}

}  // namespace
