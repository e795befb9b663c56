// The value-and-grad launch (K4), the light-VJP launch (K5) and the soft
// value-and-grad launch (K6) over any fold: their kernels (K4's pass 1,
// the sweep shared by K4 and K5, K6's pass 1 and row sweeps) and their
// launches. gradkernel.cu launches them over the folds of hyperplanes and
// spheres, gradcomposite.cu (K4, K5) and softcomposite.cu (K6) over the
// composite folds, each source in its own nvcc process (ops/cuda/build.py),
// so that the composite instances compile beside the others, and over K1's
// other configurations (a Modes fold) in gradmodes.cu and softmodes.cu. The
// kernels' design
// is gradkernel.cu's.
#pragma once

#include <cstddef>
#include <type_traits>

#include "reduce.cuh"

namespace {

// K4's pass 1. Grid (blocks, frames): block (x, f) writes the cotangent of
// its pixels' mean light of frame f (g_mean, (F, V, n_rows, W, 3)) and
// column f * gridDim.x + x of loss_parts.
template <class Fold>
__global__ void __launch_bounds__(kGradBlock)
loss_cot_kernel(const float* __restrict__ params, const uint32_t* __restrict__ seeds, Layout L,
                int width, int height, int row0, int n_rows, int samples, int reflections,
                float small_indent, float light_coefficient, const float* __restrict__ target,
                float* __restrict__ g_mean, double* __restrict__ loss_parts, Hints H) {
  extern __shared__ float P[];
  for (int i = threadIdx.x; i < L.size; i += blockDim.x) P[i] = params[i];
  __syncthreads();
  build_table_for<Fold>(P, L, H);

  const long long total = static_cast<long long>(L.n_views) * n_rows * width;
  const long long lin = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float loss = 0.0f;
  if (lin < total) {  // no early return: every thread joins the reduction
    const PixelIndex px = pixel_index(lin, width, row0, n_rows);
    const Pixel p = setup_pixel<Fold>(P, L, px.view, px.px, px.py, width, height, small_indent);
    const V3 sum =
        pixel_light_sum<Fold>(P, L, p, samples, reflections, small_indent, seeds[blockIdx.y]);
    const LossCot lc = loss_cot(sum, target + lin * 3, light_coefficient, samples);
    loss = lc.loss;
    float* out = g_mean + (static_cast<long long>(blockIdx.y) * total + lin) * 3;
    out[0] = lc.g_mean.x;
    out[1] = lc.g_mean.y;
    out[2] = lc.g_mean.z;
  }
  reduce_block(nullptr, 0, loss, nullptr, loss_parts,
               0, static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x);
}

// The sweep of K4 and K5. Grid (blocks, rows): block (x, f) takes params
// row f (at f * row_stride), the seed seeds[f] (or ``seed`` when seeds is
// null) and row f of the cotangent of the mean light, and writes column
// f * col_offset + x of the (P, n_cols) partials at grad_parts +
// f * row_offset.
template <int kB, class Fold>
__global__ void __launch_bounds__(kGradBlock, kGradMinBlocks)
sweep_kernel(const float* __restrict__ params, long long row_stride,
             const uint32_t* __restrict__ seeds, uint32_t seed, Layout L, int width, int height,
             int row0, int n_rows, int samples, int reflections, float small_indent,
             const float* __restrict__ g_mean, float* __restrict__ grad_parts,
             long long row_offset, int col_offset, int n_cols, Hints H) {
  extern __shared__ float smem[];
  const GradSmem sm = grad_smem(smem, L.size, table_recs_for<Fold>(L, H));
  const int row = blockIdx.y;
  for (int i = threadIdx.x; i < L.size; i += blockDim.x) sm.params[i] = params[row * row_stride + i];
  __syncthreads();
  build_table_for<Fold>(sm.params, L, H);

  const long long total = static_cast<long long>(L.n_views) * n_rows * width;
  const long long lin = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lin < total) {  // no early return: every thread joins the reduction
    const PixelIndex px = pixel_index(lin, width, row0, n_rows);
    const Pixel p =
        setup_pixel<Fold>(sm.params, L, px.view, px.px, px.py, width, height, small_indent);
    const V3 g = ld3(g_mean + (static_cast<long long>(row) * total + lin) * 3);
    ColumnAcc acc = ColumnAcc::of(sm, nullptr);
    pixel_sweep<kB, Fold>(sm.params, L, p, px.view, samples, reflections, small_indent,
                          seeds != nullptr ? seeds[row] : seed,
                          mul3s(g, 1.0f / static_cast<float>(samples)), acc);
  }
  reduce_block(sm.cols, L.size, 0.0f, grad_parts + row * row_offset, nullptr, n_cols,
               static_cast<long long>(row) * col_offset + blockIdx.x);
}

// Whether Fold runs at the main bounce count only (the launch takes the
// generic instance of its kind at any other count): the room's and the
// library composite scenes'.
template <class Fold>
constexpr bool kMainOnly = std::is_same_v<Fold, RoomFold> || std::is_same_v<Fold, UnionFold> ||
                           std::is_same_v<Fold, TigerFold> || std::is_same_v<Fold, CubeFold>;

// The sweeps' instances for ``reflections`` bounces: the unrolled one at
// kMainBounces, the generic one otherwise (kMainOnly folds: the unrolled
// one alone; a Modes fold: the generic one alone).
template <class Fold>
auto sweep_for(int reflections) {
  if constexpr (kModes<Fold>) {
    return sweep_kernel<kMaxBounces, Fold>;
  } else if constexpr (kMainOnly<Fold>) {
    return sweep_kernel<kMainBounces, Fold>;
  } else {
    return reflections == kMainBounces ? sweep_kernel<kMainBounces, Fold>
                                       : sweep_kernel<kMaxBounces, Fold>;
  }
}

// Columns of a gradient launch's partials over n_rows image rows: n_frames
// (K4's frames, K5's 1, K6's 2 rows) times the blocks of a row,
// ceil(V * n_rows * W / kGradBlock); or -1 for a shape the launch refuses
// (fourd_grad_scratch_cols).
inline int grad_scratch_cols(const Layout& L, int width, int n_rows, int n_frames) {
  const long long blocks = pixel_blocks(L, width, n_rows);
  const long long cols = blocks * n_frames;
  if (blocks <= 0 || n_frames <= 0 || n_frames > 65535 || cols > 0x7FFFFFFFLL) return -1;
  return static_cast<int>(cols);
}

// The launch arguments every gradient launch checks.
bool bad_shape(const Layout& L, int height, int row0, int n_rows, int samples,
               int reflections) {
  return row0 < 0 || n_rows <= 0 || row0 + n_rows > height || samples <= 0 || reflections < 0 ||
         reflections > kMaxBounces || L.size <= 0 || L.size > kMaxParams;
}

// Launches the sweep over ``n_param_rows`` rows (see sweep_kernel); returns
// cudaGetLastError() after it.
template <class Fold>
int launch_sweep(const float* params, long long row_stride, int n_param_rows,
                 const uint32_t* seeds, uint32_t seed, const Layout& L, const Hints& H,
                 int width, int height, int row0, int n_rows, int samples, int reflections,
                 float small_indent, const float* g_mean, float* grad_parts, long long row_offset,
                 int col_offset, int n_cols, cudaStream_t s) {
  const auto kernel = sweep_for<Fold>(reflections);
  const size_t smem = grad_smem_bytes(L.size, false, table_recs_for<Fold>(L, H));
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>(pixel_blocks(L, width, n_rows)),
            static_cast<unsigned>(n_param_rows));
  kernel<<<grid, kGradBlock, smem, s>>>(params, row_stride, seeds, seed, L, width, height, row0,
                                        n_rows, samples, reflections, small_indent, g_mean,
                                        grad_parts, row_offset, col_offset, n_cols, H);
  return static_cast<int>(cudaGetLastError());
}

// The occupancy of the sweep instance that launch_sweep runs under Fold at
// ``reflections`` bounces: out[0] its resident blocks a SM at its dynamic
// shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the
// current device), out[1] those bytes. Returns the query's error.
template <class Fold>
int sweep_occupancy(const Layout& L, const Hints& H, int reflections, int* out) {
  const auto kernel = sweep_for<Fold>(reflections);
  const size_t smem = grad_smem_bytes(L.size, false, table_recs_for<Fold>(L, H));
  out[1] = static_cast<int>(smem);
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t err = allow_smem(fn, smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn, kGradBlock, smem);
  }
  return static_cast<int>(err);
}

// K4's kernels on ``s`` under the fold Fold: pass 1, the sweep of every
// frame and sum_parts_kernel (fourd_loss_grad_launch, whose arguments
// these are; ``blocks`` of a frame, n_cols of the partials).
template <class Fold>
int k4_launch(const float* params, const uint32_t* seeds, int n_frames, const Layout& L,
              const Hints& H, int width, int height, int row0, int n_rows, int samples,
              int reflections, float small_indent, float light_coefficient, const float* target,
              float scale, float* g_mean, float* grad_parts, double* loss_parts, float* grad_out,
              float* loss_out, const float* keep, int blocks, int n_cols, cudaStream_t s) {
  const size_t smem = params_table_bytes(L.size, table_recs_for<Fold>(L, H));
  loss_cot_kernel<Fold><<<dim3(blocks, n_frames), kGradBlock, smem, s>>>(
      params, seeds, L, width, height, row0, n_rows, samples, reflections, small_indent,
      light_coefficient, target, g_mean, loss_parts, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = launch_sweep<Fold>(params, 0, n_frames, seeds, 0u, L, H, width, height, row0,
                                    n_rows, samples, reflections, small_indent, g_mean,
                                    grad_parts, 0, blocks, n_cols, s);
  if (rc != 0) return rc;
  sum_parts_kernel<<<L.size + 1, kSumThreads, 0, s>>>(grad_parts, loss_parts, L.size, n_cols,
                                                      scale, grad_out, loss_out, keep, L.size);
  return static_cast<int>(cudaGetLastError());
}

// K5's kernels on ``s`` under the fold Fold: the sweep of every params row
// and sum_parts_kernel (fourd_light_vjp_launch, whose arguments these are).
template <class Fold>
int k5_launch(const float* params, long long row_stride, int n_params_rows, uint32_t seed,
              const Layout& L, const Hints& H, int width, int height, int row0, int n_rows,
              int samples, int reflections, float small_indent, const float* cot,
              float* grad_parts, float* grad_out, const float* keep, int n_cols, cudaStream_t s) {
  const int rc = launch_sweep<Fold>(params, row_stride, n_params_rows, nullptr, seed, L, H, width,
                                    height, row0, n_rows, samples, reflections, small_indent, cot,
                                    grad_parts, static_cast<long long>(L.size) * n_cols, 0,
                                    n_cols, s);
  if (rc != 0) return rc;
  const int n_sums = n_params_rows * L.size;
  sum_parts_kernel<<<n_sums, kSumThreads, 0, s>>>(grad_parts, nullptr, n_sums, n_cols, 1.0f,
                                                  grad_out, nullptr, keep, L.size);
  return static_cast<int>(cudaGetLastError());
}

// K6's pass 1. Grid (blocks, 2): row r of blockIdx.y (0: params, 1: params
// with the zero map applied) writes its pixels' light summed over samples
// to sums, (2, V, n_rows, W, 3).
template <class Fold>
__global__ void __launch_bounds__(kGradBlock)
soft_sum_kernel(const float* __restrict__ params, uint32_t seed, Layout L, ZeroMap zm, int width,
                int height, int row0, int n_rows, int samples, int reflections,
                float small_indent, float* __restrict__ sums, Hints H) {
  extern __shared__ float P[];
  for (int i = threadIdx.x; i < L.size; i += blockDim.x) P[i] = params[i];
  __syncthreads();
  if (blockIdx.y == 1 && threadIdx.x == 0) {
    for (int i = 0; i < zm.n; ++i) P[zm.idx[i]] = zm.val[i];
  }
  __syncthreads();
  build_table_for<Fold>(P, L, H);  // row b's table from row b's params

  const long long total = static_cast<long long>(L.n_views) * n_rows * width;
  const long long lin = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lin >= total) return;
  const PixelIndex px = pixel_index(lin, width, row0, n_rows);
  const Pixel p = setup_pixel<Fold>(P, L, px.view, px.px, px.py, width, height, small_indent);
  const V3 sum = pixel_light_sum<Fold>(P, L, p, samples, reflections, small_indent, seed);
  float* out = sums + (blockIdx.y * total + lin) * 3;
  out[0] = sum.x;
  out[1] = sum.y;
  out[2] = sum.z;
}

// K6's row-b work of a pixel, as its row-a sweep leaves it in row_b: the
// samples row b sweeps alone, or kRowBWhole for all of them with bounce 0.
constexpr uint32_t kRowBWhole = 1u << 31;

// The blend of K6's pixel lin from pass 1's sums (2, V, n_rows, W, 3).
__device__ __forceinline__ SoftBlend blend_of(const float* __restrict__ sums, long long total,
                                              long long lin, const float* __restrict__ alpha,
                                              const float* __restrict__ target,
                                              float light_coefficient, int samples) {
  return soft_blend(ld3(sums + lin * 3), ld3(sums + (total + lin) * 3), alpha[lin],
                    target + lin * 3, light_coefficient, samples);
}

// K6's sweep of row a (params), one thread per pixel: the blend, the loss
// (column x of loss_parts) and alpha's cotangent, then row a's sweep
// (adjoint.cuh pixel_sweep), which carries row b's cotangent where the
// rows trace alike: where bounce 0 misses the zero map's sphere obj. Writes
// row_b[lin], row b's work, and column x of the (P, n_cols) partials.
template <int kB, class Fold>
__global__ void __launch_bounds__(kGradBlock, kGradMinBlocks)
soft_row_a_kernel(const float* __restrict__ params, uint32_t seed, Layout L, int obj, int width,
                  int height, int row0, int n_rows, int samples, int reflections,
                  float small_indent, float light_coefficient, const float* __restrict__ target,
                  const float* __restrict__ alpha, float scale, const float* __restrict__ sums,
                  float* __restrict__ alpha_cot, uint32_t* __restrict__ row_b,
                  float* __restrict__ grad_parts, double* __restrict__ loss_parts, int n_cols,
                  Hints H) {
  extern __shared__ float smem[];
  const GradSmem sm = grad_smem(smem, L.size, table_recs_for<Fold>(L, H));
  for (int i = threadIdx.x; i < L.size; i += blockDim.x) sm.params[i] = params[i];
  __syncthreads();
  build_table_for<Fold>(sm.params, L, H);

  const long long total = static_cast<long long>(L.n_views) * n_rows * width;
  const long long lin = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float loss = 0.0f;
  if (lin < total) {  // no early return: every thread joins the reduction
    const PixelIndex px = pixel_index(lin, width, row0, n_rows);
    const SoftBlend b = blend_of(sums, total, lin, alpha, target, light_coefficient, samples);
    loss = b.loss;
    alpha_cot[lin] = b.g_alpha * scale;
    const float inv = 1.0f / static_cast<float>(samples);
    const V3 g_a = mul3s(b.g_a, inv);
    const V3 g_b = mul3s(b.g_b, inv);
    const Pixel p =
        setup_pixel<Fold>(sm.params, L, px.view, px.px, px.py, width, height, small_indent);
    const bool whole = obj < 0 || (p.h0.hit && p.h0.idx == obj);
    const V3 g_shared = whole ? V3{0.0f, 0.0f, 0.0f} : g_b;
    ColumnAcc acc = ColumnAcc::of(sm, nullptr);
    const unsigned alone = pixel_sweep<kB, Fold>(sm.params, L, p, px.view, samples, reflections,
                                                 small_indent, seed, g_a, acc, 0u,
                                                 whole ? -1 : obj, g_shared);
    row_b[lin] = whole ? kRowBWhole : alone;
  }
  reduce_block(sm.cols, L.size, loss, grad_parts, loss_parts, n_cols, blockIdx.x);
}

// K6's sweep of row b (params with the zero map applied, its slots'
// cotangents dropped), one thread per pixel with row-b work (row_b): the
// samples row a's sweep left to it, with none of bounce 0's light, or all
// of them and bounce 0. Writes column col0 + x of the partials and of
// loss_parts (a zero: the loss is row a's).
template <int kB, class Fold>
__global__ void __launch_bounds__(kGradBlock, kGradMinBlocks)
soft_row_b_kernel(const float* __restrict__ params, uint32_t seed, Layout L, ZeroMap zm, int width,
                  int height, int row0, int n_rows, int samples, int reflections,
                  float small_indent, float light_coefficient, const float* __restrict__ target,
                  const float* __restrict__ alpha, const float* __restrict__ sums,
                  const uint32_t* __restrict__ row_b, float* __restrict__ grad_parts,
                  double* __restrict__ loss_parts, int n_cols, int col0, Hints H) {
  extern __shared__ float smem[];
  const GradSmem sm = grad_smem(smem, L.size, table_recs_for<Fold>(L, H));
  for (int i = threadIdx.x; i < L.size; i += blockDim.x) {
    sm.params[i] = params[i];
    sm.skip[i] = 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < zm.n; ++i) {
      sm.params[zm.idx[i]] = zm.val[i];
      sm.skip[zm.idx[i]] = 1;
    }
  }
  __syncthreads();
  build_table_for<Fold>(sm.params, L, H);  // row b's table from row b's params

  const long long total = static_cast<long long>(L.n_views) * n_rows * width;
  const long long lin = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint32_t work = lin < total ? row_b[lin] : 0u;
  if (work != 0) {  // no early return: every thread joins the reduction
    const PixelIndex px = pixel_index(lin, width, row0, n_rows);
    const SoftBlend b = blend_of(sums, total, lin, alpha, target, light_coefficient, samples);
    const V3 g_b = mul3s(b.g_b, 1.0f / static_cast<float>(samples));
    const Pixel p =
        setup_pixel<Fold>(sm.params, L, px.view, px.px, px.py, width, height, small_indent);
    ColumnAcc acc = ColumnAcc::of(sm, sm.skip);
    pixel_sweep<kB, Fold>(sm.params, L, p, px.view, samples, reflections, small_indent, seed,
                          g_b, acc, work == kRowBWhole ? 0u : work);
  }
  reduce_block(sm.cols, L.size, 0.0f, grad_parts, loss_parts, n_cols, col0 + blockIdx.x);
}

// K6's row sweeps for ``reflections`` bounces, as sweep_for picks them.
template <class Fold>
auto soft_row_a_for(int reflections) {
  if constexpr (kModes<Fold>) {
    return soft_row_a_kernel<kMaxBounces, Fold>;
  } else if constexpr (kMainOnly<Fold>) {
    return soft_row_a_kernel<kMainBounces, Fold>;
  } else {
    return reflections == kMainBounces ? soft_row_a_kernel<kMainBounces, Fold>
                                       : soft_row_a_kernel<kMaxBounces, Fold>;
  }
}
template <class Fold>
auto soft_row_b_for(int reflections) {
  if constexpr (kModes<Fold>) {
    return soft_row_b_kernel<kMaxBounces, Fold>;
  } else if constexpr (kMainOnly<Fold>) {
    return soft_row_b_kernel<kMainBounces, Fold>;
  } else {
    return reflections == kMainBounces ? soft_row_b_kernel<kMainBounces, Fold>
                                       : soft_row_b_kernel<kMaxBounces, Fold>;
  }
}

// The zero map of a K6 launch from its host arrays, and the object whose
// miss lets row a's sweep carry row b (zero_map_object; -1: the rows are
// swept apart). False for a map the launch refuses.
inline bool zero_map_from(const Layout& L, int n_zero, const int* zero_idx,
                          const float* zero_val, int samples, ZeroMap& zm, int& obj) {
  if (n_zero <= 0 || n_zero > kMaxZeroSlots) return false;
  zm.n = n_zero;
  for (int i = 0; i < kMaxZeroSlots; ++i) {
    zm.idx[i] = i < n_zero ? zero_idx[i] : 0;
    zm.val[i] = i < n_zero ? zero_val[i] : 0.0f;
    if (zm.idx[i] < 0 || zm.idx[i] >= L.size) return false;
  }
  // Row b's samples fit 31 bits of row_b beside kRowBWhole.
  obj = samples < 32 ? zero_map_object(L, zm) : -1;
  return true;
}

// K6's kernels on ``s`` under the fold Fold: pass 1 on both rows, row a's
// sweep, row b's and sum_parts_kernel (fourd_soft_loss_grad_launch, whose
// arguments these are; ``blocks`` of a row, n_cols of the partials).
template <class Fold>
int k6_launch(const float* params, uint32_t seed, const Layout& L, const Hints& H,
              const ZeroMap& zm, int obj, int width, int height, int row0, int n_rows,
              int samples, int reflections, float small_indent, float light_coefficient,
              const float* target, const float* alpha, float scale, float* sums,
              uint32_t* row_b, float* grad_parts, double* loss_parts, float* grad_out,
              float* loss_out, float* alpha_cot, const float* keep, int blocks, int n_cols,
              cudaStream_t s) {
  const int recs = table_recs_for<Fold>(L, H);
  const size_t smem_sum = params_table_bytes(L.size, recs);
  soft_sum_kernel<Fold><<<dim3(blocks, 2), kGradBlock, smem_sum, s>>>(
      params, seed, L, zm, width, height, row0, n_rows, samples, reflections, small_indent,
      sums, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto row_a = soft_row_a_for<Fold>(reflections);
  const size_t smem_a = grad_smem_bytes(L.size, false, recs);
  err = allow_smem(reinterpret_cast<const void*>(row_a), smem_a);
  if (err != cudaSuccess) return static_cast<int>(err);
  row_a<<<blocks, kGradBlock, smem_a, s>>>(params, seed, L, obj, width, height, row0, n_rows,
                                           samples, reflections, small_indent, light_coefficient,
                                           target, alpha, scale, sums, alpha_cot, row_b,
                                           grad_parts, loss_parts, n_cols, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto row_b_sweep = soft_row_b_for<Fold>(reflections);
  const size_t smem_b = grad_smem_bytes(L.size, true, recs);
  err = allow_smem(reinterpret_cast<const void*>(row_b_sweep), smem_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  row_b_sweep<<<blocks, kGradBlock, smem_b, s>>>(params, seed, L, zm, width, height, row0, n_rows,
                                                 samples, reflections, small_indent,
                                                 light_coefficient, target, alpha, sums, row_b,
                                                 grad_parts, loss_parts, n_cols, blocks, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_parts_kernel<<<L.size + 1, kSumThreads, 0, s>>>(grad_parts, loss_parts, L.size, n_cols,
                                                      scale, grad_out, loss_out, keep, L.size);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Columns of a gradient launch's partials (gradkernel.cu).
extern "C" int fourd_grad_scratch_cols(const int* layout, int width, int n_rows, int n_frames);

// K4, K5 (gradcomposite.cu) and K6 (softcomposite.cu) over the composite
// folds: the arguments
// of fourd_loss_grad_launch, fourd_light_vjp_launch and
// fourd_soft_loss_grad_launch, which check them and call these for a
// descriptor with composites.
extern "C" int fourd_loss_grad_composite(const float* params, const uint32_t* seeds, int n_frames,
                                         const int* layout, int width, int height, int row0,
                                         int n_rows, int samples, int reflections,
                                         float small_indent, float light_coefficient,
                                         const float* target, float scale, float* g_mean,
                                         float* grad_parts, double* loss_parts, float* grad_out,
                                         float* loss_out, const int* hints, const float* keep,
                                         void* stream);
extern "C" int fourd_light_vjp_composite(const float* params, long long row_stride,
                                         int n_params_rows, uint32_t seed, const int* layout,
                                         int width, int height, int row0, int n_rows, int samples,
                                         int reflections, float small_indent, const float* cot,
                                         float* grad_parts, float* grad_out, const int* hints,
                                         const float* keep, void* stream);
extern "C" int fourd_loss_grad_composite_occupancy(const int* layout, int reflections,
                                                   const int* hints, int* out);
extern "C" int fourd_soft_loss_grad_composite(
    const float* params, uint32_t seed, const int* layout, int n_zero, const int* zero_idx,
    const float* zero_val, int width, int height, int row0, int n_rows, int samples,
    int reflections, float small_indent, float light_coefficient, const float* target,
    const float* alpha, float scale, float* sums, uint32_t* row_b, float* grad_parts,
    double* loss_parts, float* grad_out, float* loss_out, float* alpha_cot, const int* hints,
    const float* keep, void* stream);
