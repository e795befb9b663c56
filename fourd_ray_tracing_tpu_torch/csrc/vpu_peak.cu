// The sustained fp32 FMA peak of the card (K7), for Hopper (sm_90a).
//
// Replaces tools/vpu_peak.py::_peak_kernel of the JAX package: chains of
// y <- y*y + b held in registers, whose rate is the card's fp32 rate outside
// the tensor cores, the roofline the path-tracing kernels are read against
// (tools/vpu_peak.py:20-28 of the JAX package). Each thread holds kAcc
// independent accumulators; accumulator k of a thread whose global index is
// t starts at (t % 128) * (0.5 / 128) + 0.001 * (k + 1), as lane t % 128 of
// a JAX program does (vpu_peak.py:57-64), and steps `16 * trips` times.
// The thread's accumulators sum in order (y[0] + y[1] + ...), the block
// reduces its threads' sums in a fixed order (a warp-shuffle tree, then
// the warps in order) into one float per block; the host sums those.
//
// The FMA trap: the build compiles every source with -fmad=false (so K1
// rounds like its plain torch version), under which y*y + b is an FMUL and
// an FADD, two instructions for two flops, and the kernel would read half
// the peak. Each step is therefore __fmaf_rn(y, y, b), one FFMA, and
// chip_smoke.py counts the FFMAs of the loop in the SASS. The plain version
// (ops/cuda/vpu_peak.py::peak_plain) rounds twice per step, which over a
// short run (64 steps) stays within a few ulps of the kernel;
// block_sum_plain rounds once per step and sums in this kernel's order, so
// it agrees with every block at the measurement's own step counts.
//
// nvcc cannot fold or hoist the chain: b is a kernel argument, the start
// values depend on the thread, and the output depends on every
// accumulator. The loop over trips is kept rolled (#pragma unroll 1) and
// its 16 steps unrolled, so one trip is 16 * kAcc FFMAs and a counter.
//
// Grid and occupancy: 256-thread blocks, as many as the tool asks for
// (tools/vpu_peak.py launches 32 per SM, 4224 on an H100 SXM's 132 SMs:
// four or more waves). kAcc = 8 needs about 16 registers, so 8 blocks (2048
// threads) fit an SM; kAcc = 48 about 56, so 4 blocks (1024 threads).
// Either way each of an SM's four schedulers holds 8 or more warps of
// kAcc >= 8 independent FFMAs against a 4-cycle latency: the FMA pipes, not
// latency or memory, bound the kernel. An SM retires 128 FFMAs (256 flops)
// per clock.

#include <cuda_runtime.h>

namespace {

constexpr int kPeakBlock = 256;
constexpr int kUnroll = 16;
constexpr int kLanes = 128;

}  // namespace

template <int kAcc>
__global__ void __launch_bounds__(kPeakBlock)
fourd_peak_kernel(float b, int trips, float* __restrict__ block_sums) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  const float lane = static_cast<float>(t % kLanes);
  float y[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    y[k] = lane * (0.5f / kLanes) + static_cast<float>(0.001 * (k + 1));
  }
#pragma unroll 1
  for (int i = 0; i < trips; ++i) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < kAcc; ++k) y[k] = __fmaf_rn(y[k], y[k], b);
    }
  }
  float s = y[0];
#pragma unroll
  for (int k = 1; k < kAcc; ++k) s += y[k];
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  __shared__ float warp_sums[kPeakBlock / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = warp_sums[0];
    for (int w = 1; w < kPeakBlock / 32; ++w) total += warp_sums[w];
    block_sums[blockIdx.x] = total;
  }
}

// K7 on ``stream``: block_sums (blocks,) float32, each block's sum of its
// 256 threads' accumulators after rounds = 16 * trips steps of
// y <- fma(y, y, b), for n_acc accumulators per thread (8, 16, 32 or 48).
// Returns cudaErrorInvalidValue for another n_acc or a bad size, else
// cudaGetLastError() after the launch.
extern "C" int fourd_peak_launch(int n_acc, float b, int trips, int blocks, float* block_sums,
                                 void* stream) {
  if (trips < 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_acc) {
    case 8: fourd_peak_kernel<8><<<blocks, kPeakBlock, 0, s>>>(b, trips, block_sums); break;
    case 16: fourd_peak_kernel<16><<<blocks, kPeakBlock, 0, s>>>(b, trips, block_sums); break;
    case 32: fourd_peak_kernel<32><<<blocks, kPeakBlock, 0, s>>>(b, trips, block_sums); break;
    case 48: fourd_peak_kernel<48><<<blocks, kPeakBlock, 0, s>>>(b, trips, block_sums); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
