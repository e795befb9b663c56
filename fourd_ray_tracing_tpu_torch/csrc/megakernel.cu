// Forward path-tracing megakernel for Hopper (sm_90a).
//
// Replaces fourd_ray_tracing_tpu/ops/pallas/megakernel.py::_kernel (with
// _trace_rays_kernel, _tile_pixels and _tile_camera): per frame seed and
// per pixel, the primary ray of the pixel's view, bounce 0 computed once
// per pixel, then `samples` per-sample traces of `reflections_amount`
// bounces (closest hit over hyperplanes and hyperspheres, emission and
// environment light, Bernoulli mirror vs uniform-S^3 diffuse with masked
// counter RNG, shade-only last bounce), and the mean light.
//
// With a row stride it is also K2, ops/pallas/megakernel.py::_kernel with
// frame_params=True (render_light_pallas_multi, _RowView): the frame axis
// carries F same-structure scenes instead of F seeds, each block reading
// its own params row. A row is bitwise the single-scene launch.
//
// With a row offset it is K3, the launch of K1/K2 under shard_map
// (sharded_render_light_pallas[_multi], tile0 = device x tiles_local): a
// launch renders the image rows [row0, row0 + n_rows) only. A thread's
// pixel keeps its global coordinates (py = row0 + local row), which feed
// the primary ray and the RNG, so a row block is bitwise those rows of
// the whole image for any split; the output holds the block alone.
//
// Design. One thread per (frame, view, y, x) pixel: the trace is a long
// per-pixel control-flow program (runtime primitive loops, per-lane RNG
// counters, uint32 hashing, float bit tricks), which one thread states
// directly. A lane that died (its ray left the scene) stops tracing; that
// is exact, since every update of a dead lane is masked out in the plain
// version. The packed scene + camera (models/params.py, a few hundred
// bytes) is copied into shared memory once per block and read uniformly
// by every thread. The light goes straight to its (F, V, H, W, 3) place,
// written once, so there is no tile transpose after the launch.
//
// What bounds it: arithmetic and issue. Per pixel and sample the kernel
// runs reflections_amount fold-and-shade passes over every primitive and
// reads no memory but shared memory; the output is 12 bytes per pixel.
//
// The device math (vectors, RNG, fastmath, sampler, sky, the closest-hit
// fold, the per-pixel primary ray, bounce 0 and one sample's trace) lives
// in trace.cuh, shared with the value-and-grad kernel (gradkernel.cu).
//
// Numerics: every operation keeps the order of the plain torch pipeline
// (models/renderer.py) and of the JAX package, and the build passes
// -fmad=false so nvcc does not contract a*b+c into an FMA. Torch's eager
// ops do not contract either, so on the card the kernel is bitwise equal
// to its plain version (XLA on the CPU does contract, so the JAX package
// is matched within image tolerances). Float constants are hex literals
// of the JAX package's float32 values.
//
// Still to do for speed (later work): static hints and wall-pair folding
// (models/scene.py:plane_norm_hints / plane_pair_hints in the JAX
// package), FMA contraction once its effect on the image is measured,
// register and occupancy tuning, and a persistent-block schedule.

#include "trace.cuh"

namespace {

__global__ void __launch_bounds__(kBlock)
forward_kernel(const float* __restrict__ params, long long row_stride,
               const uint32_t* __restrict__ seeds, Layout L, int width, int height, int row0,
               int n_rows, int samples, int reflections, float small_indent,
               float* __restrict__ out) {
  extern __shared__ float P[];
  const float* row = params + blockIdx.y * row_stride;
  for (int i = threadIdx.x; i < L.size; i += blockDim.x) P[i] = row[i];
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

  const Pixel p = setup_pixel(P, L, view, px, py, width, height, small_indent);
  V3 acc = {0.0f, 0.0f, 0.0f};
  for (int s = 0; s < samples; ++s) {
    acc = add3(acc, trace_sample<false>(P, L, p, s, seed, reflections, small_indent, nullptr,
                                        nullptr, nullptr, nullptr));
  }
  const float inv = 1.0f / static_cast<float>(samples);
  float* px_out = out + (static_cast<long long>(frame) * total + lin) * 3;
  px_out[0] = acc.x * inv;
  px_out[1] = acc.y * inv;
  px_out[2] = acc.z * inv;
}

}  // namespace

// Launch on ``stream``: out (F, V, n_rows, W, 3) float32, image rows
// [row0, row0 + n_rows) of H, <- params and seeds (F,) uint32 (row0 0 and
// n_rows H: the whole image). Frame f reads the P = layout[13] floats at
// params + f * row_stride: row_stride 0 renders one scene at F seeds (K1),
// row_stride P renders F same-structure scenes, one params row per frame
// (K2; the wrapper then gives every frame the same seed). Returns
// cudaGetLastError() after the launch.
extern "C" int fourd_forward_launch(const float* params, long long row_stride,
                                    const uint32_t* seeds, int n_frames, const int* layout,
                                    int width, int height, int row0, int n_rows, int samples,
                                    int reflections, float small_indent, float* out,
                                    void* stream) {
  Layout L;
  int* dst = reinterpret_cast<int*>(&L);
  for (int i = 0; i < kLayoutInts; ++i) dst[i] = layout[i];
  const long long total = static_cast<long long>(L.n_views) * n_rows * width;
  const size_t smem = static_cast<size_t>(L.size) * sizeof(float);
  if (total <= 0 || row0 < 0 || n_rows <= 0 || row0 + n_rows > height || n_frames <= 0 ||
      samples <= 0 || row_stride < 0 || smem > 48 * 1024 ||
      (total + kBlock - 1) / kBlock > 0x7FFFFFFFLL || n_frames > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(static_cast<unsigned>((total + kBlock - 1) / kBlock), static_cast<unsigned>(n_frames));
  forward_kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      params, row_stride, seeds, L, width, height, row0, n_rows, samples, reflections,
      small_indent, out);
  return static_cast<int>(cudaGetLastError());
}
