// The forward kernel K1 (with its row stride K2 and row offset K3) and its
// launch, shared by the production launches (megakernel.cu) and the
// launches of K1's other configurations (forwardmodes.cu): every instance
// is forward_kernel over one fold, one sampler and one RNG mode. See
// megakernel.cu for the design.
#pragma once

#include "trace.cuh"

namespace {

constexpr int kK1Block = 128;
// kStub selects a measurement variant's stubs (trace.cuh); the production
// kernel is kStubNone. Fold is the fold's instance, kSampler the S^3
// sampler; kRng kRngPerSample renders per-sample streams, kRngArg the
// stream ``sequential`` picks (a sequential stream's counter rides across
// the sample loop). ``sampler_iters``: kepler's Halley steps. The
// production instances (per-sample, poly) read neither of the last two
// arguments.
template <int kStub, class Fold, int kSampler = kSamplerPoly, int kRng = kRngPerSample>
__global__ void __launch_bounds__(kK1Block)
forward_kernel(const float* __restrict__ params, long long row_stride,
               const uint32_t* __restrict__ seeds, Layout L, Hints H, int width, int height,
               int row0, int n_rows, int samples, int reflections, float small_indent,
               float* __restrict__ out, int sequential, int sampler_iters) {
  extern __shared__ float P[];
  const float* row = params + blockIdx.y * row_stride;
  for (int i = threadIdx.x; i < L.size; i += blockDim.x) P[i] = row[i];
  __syncthreads();
  build_fold_table<kTableCells<Fold>>(P, L, H, threadIdx.x, blockDim.x);
  __syncthreads();

  const long long total = static_cast<long long>(L.n_views) * n_rows * width;
  const long long lin = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lin >= total) return;
  const int frame = blockIdx.y;
  const int hw = n_rows * width;
  const int view = static_cast<int>(lin / hw);
  const int rem = static_cast<int>(lin - static_cast<long long>(view) * hw);
  const int ly = rem / width;
  const int px = rem - ly * width;
  const int py = row0 + ly;
  const uint32_t seed = seeds[frame];

  const Pixel p = setup_pixel<Fold>(P, L, view, px, py, width, height, small_indent);
  V3 acc = {0.0f, 0.0f, 0.0f};
  uint32_t counter = seed;  // a sequential stream's, carried across the samples
  for (int s = 0; s < samples; ++s) {
    acc = add3(acc, trace_sample<kStub, Fold, kSampler, kRng>(P, L, p, s, seed, reflections,
                                                              small_indent, sequential != 0,
                                                              sampler_iters, counter));
  }
  const float inv = 1.0f / static_cast<float>(samples);
  float* px_out = out + (static_cast<long long>(frame) * total + lin) * 3;
  px_out[0] = acc.x * inv;
  px_out[1] = acc.y * inv;
  px_out[2] = acc.z * inv;
}

// The launch's dynamic shared memory: the params, padded to 16 bytes, and
// the fold table.
size_t shared_bytes(const Layout& L, const Hints& H) {
  const int singles = H.n_singles < 0 ? L.n_spaces : H.n_singles;
  const size_t recs = 1 + H.n_pairs + 2 * singles + 2 * L.n_spheres +
                      kCylinderRecs * (H.n_cylinders > 0 ? H.n_cylinders : 0) +
                      (H.cylinders_union >= 0 ? kUnionRecs : 0) +
                      (H.hypercube >= 0 ? kHypercubeRecs : 0) + (H.tiger >= 0 ? kTigerRecs : 0);
  return static_cast<size_t>((L.size + 3) / 4) * sizeof(Rec) + recs * sizeof(Rec);
}

// Validates the arguments and launches forward_kernel<kStub, Fold,
// kSampler, kRng>; returns cudaGetLastError() after the launch.
template <int kStub, class Fold, int kSampler = kSamplerPoly, int kRng = kRngPerSample>
int launch_forward(const float* params, long long row_stride, const uint32_t* seeds, int n_frames,
                   const Layout& L, const Hints& H, int width, int height, int row0, int n_rows,
                   int samples, int reflections, float small_indent, float* out, void* stream,
                   int sequential = 0, int sampler_iters = 0) {
  const long long total = static_cast<long long>(L.n_views) * n_rows * width;
  const size_t smem = shared_bytes(L, H);
  if (total <= 0 || row0 < 0 || n_rows <= 0 || row0 + n_rows > height || n_frames <= 0 ||
      samples <= 0 || row_stride < 0 || smem > 48 * 1024 ||
      !hints_valid(L, H, kTableCells<Fold>) ||
      (total + kK1Block - 1) / kK1Block > 0x7FFFFFFFLL || n_frames > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(static_cast<unsigned>((total + kK1Block - 1) / kK1Block),
            static_cast<unsigned>(n_frames));
  forward_kernel<kStub, Fold, kSampler, kRng>
      <<<grid, kK1Block, smem, static_cast<cudaStream_t>(stream)>>>(
          params, row_stride, seeds, L, H, width, height, row0, n_rows, samples, reflections,
          small_indent, out, sequential, sampler_iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
