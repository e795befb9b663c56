// The fixed-order reductions of the gradient kernels (K4, K5 in
// gradkernel.cu, K6 in softkernel.cu). No float atomics: a block reduces
// its threads' per-thread cotangent arrays in a fixed order (a warp-shuffle
// tree, then the warps in order) into one column of a (rows, n_cols)
// partials array, and sum_parts_kernel sums each row in a fixed order in
// double. Two launches give bitwise equal results.
#pragma once

#include "adjoint.cuh"

namespace {

constexpr int kWarps = kBlock / 32;
constexpr int kSumThreads = 256;

// Every thread of the block calls this with its n cotangents g and its
// loss; writes column col of grad_parts (n rows of n_cols) and, when
// loss_parts is not null, loss_parts[col].
__device__ __forceinline__ void reduce_block(const float* g, int n, float loss,
                                             float* __restrict__ grad_parts,
                                             double* __restrict__ loss_parts, int n_cols,
                                             long long col) {
  __shared__ float red[kWarps][kMaxParams];
  __shared__ double red_loss[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k = 0; k < n; ++k) {
    float v = g[k];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][k] = v;
  }
  if (loss_parts != nullptr) {
    double lv = loss;
    for (int off = 16; off > 0; off >>= 1) lv += __shfl_down_sync(0xffffffffu, lv, off);
    if (lane == 0) red_loss[warp] = lv;
  }
  __syncthreads();

  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    float s = red[0][k];
    for (int w = 1; w < kWarps; ++w) s += red[w][k];
    grad_parts[static_cast<long long>(k) * n_cols + col] = s;
  }
  if (loss_parts != nullptr && threadIdx.x == 0) {
    double s = red_loss[0];
    for (int w = 1; w < kWarps; ++w) s += red_loss[w];
    loss_parts[col] = s;
  }
}

// Block k < n_rows sums row k of grad_parts, block n_rows (launched only
// when loss_parts is not null) sums loss_parts; each in a fixed order
// (strided per thread, then a tree), in double, then scaled in float32.
__global__ void __launch_bounds__(kSumThreads)
sum_parts_kernel(const float* __restrict__ grad_parts, const double* __restrict__ loss_parts,
                 int n_rows, int n_cols, float scale, float* __restrict__ grad_out,
                 float* __restrict__ loss_out) {
  __shared__ double buf[kSumThreads];
  const int k = blockIdx.x;
  double s = 0.0;
  if (k < n_rows) {
    const float* row = grad_parts + static_cast<long long>(k) * n_cols;
    for (int i = threadIdx.x; i < n_cols; i += blockDim.x) s += row[i];
  } else {
    for (int i = threadIdx.x; i < n_cols; i += blockDim.x) s += loss_parts[i];
  }
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int stride = kSumThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) buf[threadIdx.x] += buf[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float total = static_cast<float>(buf[0]) * scale;
    if (k < n_rows) {
      grad_out[k] = total;
    } else {
      loss_out[0] = total;
    }
  }
}

// The layout table a launch function receives, as the kernels take it.
inline Layout layout_from(const int* table) {
  Layout L;
  int* dst = reinterpret_cast<int*>(&L);
  for (int i = 0; i < kLayoutInts; ++i) dst[i] = table[i];
  return L;
}

// Blocks per frame or row of a launch over V * H * W pixels, or -1 for a
// shape the launch refuses.
inline long long pixel_blocks(const Layout& L, int width, int height) {
  const long long total = static_cast<long long>(L.n_views) * height * width;
  if (total <= 0) return -1;
  return (total + kBlock - 1) / kBlock;
}

}  // namespace
