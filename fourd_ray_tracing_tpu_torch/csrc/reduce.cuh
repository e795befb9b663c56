// The accumulation and fixed-order reductions of the gradient kernels (K4,
// K5 and K6 in gradkernel.cu; K8 in ablate.cu takes the loss reduction
// alone). No atomics, shared memory included: two launches give
// bitwise equal results.
//
// Each thread of a gradient block owns one column of P floats in shared
// memory, laid out [P][kGradBlock + 1] so that the threads of a warp,
// adding to the slots of any primitives, hit different banks. A sweep
// step's Slots (adjoint.cuh) go to the thread's own column (ColumnAcc): no
// two threads write one address, and each column's sums run in the
// thread's own order. At the end the block sums each slot's row over its
// threads in a fixed order into one column of a (rows, n_cols) partials
// array, and sum_parts_kernel sums each row in a fixed order in double.
//
// What bounds it: per step and thread, n shared-memory read-add-writes;
// and the room of the columns, P x (kGradBlock + 1) floats a block (40 KB
// at the room's P = 154), which with the registers sets the resident
// blocks, and caps P. A warp-row alternative (one row of P sums per warp,
// the lanes of a primitive summed in lane order through
// __match_any_sync) needs little shared memory but measured slower on
// every gradient kernel (PERF.md): its per-group loops cost more
// instructions than the trace.
#pragma once

#include "adjoint.cuh"

namespace {

// Threads a block of the gradient kernels (and of K8, whose loss reduction
// is K4's): small blocks, so that the per-thread columns of several fit an
// SM at once. The launch bounds ask ptxas for room for kGradMinBlocks of
// them: at most 65536 / (kGradBlock x kGradMinBlocks) registers a thread.
constexpr int kGradBlock = 64;
constexpr int kGradMinBlocks = 4;
constexpr int kWarps = kGradBlock / 32;
constexpr int kGradPitch = kGradBlock + 1;
constexpr int kSumThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

// A sweep block's dynamic shared memory: the packed params row (padded to
// 16 bytes and followed by the fold table when the fold reads one, ``recs``
// records: trace.cuh params_table_bytes), the threads' columns and, with
// skip, one byte per slot (K6's row b: the zero map's).
inline size_t grad_smem_bytes(int P, bool skip, int recs = 0) {
  return params_table_bytes(P, recs) + sizeof(float) * static_cast<size_t>(kGradPitch) * P +
         (skip ? static_cast<size_t>(P) : 0);
}
struct GradSmem {
  float* params;  // P (then the fold table)
  float* cols;    // P x kGradPitch, zeroed
  unsigned char* skip;
};
__device__ __forceinline__ GradSmem grad_smem(float* base, int P, int recs = 0) {
  GradSmem s;
  s.params = base;
  s.cols = base + params_table_bytes(P, recs) / sizeof(float);
  s.skip = reinterpret_cast<unsigned char*>(s.cols + P * kGradPitch);
  for (int i = threadIdx.x; i < P * kGradPitch; i += blockDim.x) s.cols[i] = 0.0f;
  return s;
}

// A gradient kernel's block builds its fold's table from the params in
// shared memory P, if the fold reads one, and synchronises; under a Modes
// fold it also copies the launch's sampler from the descriptor. Every
// thread calls it before its first trace.
template <class Fold>
__device__ __forceinline__ void build_table_for(const float* P, const Layout& L, const Hints& H) {
  static_assert(!kModes<Fold> || kGradTable<Fold>, "a Modes fold reads its sampler here");
  if constexpr (kGradTable<Fold>) {
    if constexpr (kModes<Fold>) {
      if (threadIdx.x == 0) modes_sampler(Fold{}) = sampler_slot(H);
    }
    build_fold_table(P, L, H, threadIdx.x, blockDim.x);
    __syncthreads();
  }
}

// The card's accumulator of adjoint.cuh: this thread's column; with skip,
// the thread drops its values for the slots skip marks.
struct ColumnAcc {
  float* col;
  const unsigned char* skip;

  __device__ static ColumnAcc of(const GradSmem& s, const unsigned char* skip) {
    return {s.cols + threadIdx.x, skip};
  }

  __device__ void add(const Slots& c) {
    if (c.key < 0) return;
#pragma unroll
    for (int k = 0; k < kSlotsMax; ++k) {
      if (k >= c.n) break;
      const int slot = c.key + k * c.stride;
      if (skip == nullptr || skip[slot] == 0) col[slot * kGradPitch] += c.v[k];
    }
  }
};

// Every thread of the block calls this after its last add, with its loss;
// writes column col of grad_parts (n rows of n_cols: each slot's row of
// the threads' columns, summed as four interleaved partial sums added in
// order) and, when loss_parts is not null, loss_parts[col] (the threads'
// losses in double: a shuffle tree per warp, then the warps in order).
__device__ __forceinline__ void reduce_block(const float* cols, int n, float loss,
                                             float* __restrict__ grad_parts,
                                             double* __restrict__ loss_parts, int n_cols,
                                             long long col) {
  __shared__ double red_loss[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (loss_parts != nullptr) {
    double lv = loss;
    for (int off = 16; off > 0; off >>= 1) lv += __shfl_down_sync(kFullMask, lv, off);
    if (lane == 0) red_loss[warp] = lv;
  }
  __syncthreads();

  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float* row = cols + k * kGradPitch;
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int t = 0; t < kGradBlock; t += 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j) part[j] += row[t + j];
    }
    const float s = (part[0] + part[1]) + (part[2] + part[3]);
    grad_parts[static_cast<long long>(k) * n_cols + col] = s;
  }
  if (loss_parts != nullptr && threadIdx.x == 0) {
    double s = red_loss[0];
    for (int w = 1; w < kWarps; ++w) s += red_loss[w];
    loss_parts[col] = s;
  }
}

// Block k < n_rows sums row k of grad_parts (n_cols columns), block n_rows
// (launched only when loss_parts is not null) sums loss_parts (loss_cols
// columns: fewer than n_cols where K4 splits its sweep's samples and not
// its pass 1); each in a fixed order (strided per thread, then a tree), in
// double, then scaled in float32.
// With ``keep`` (the freeze_hints contract's packed 0/1 mask of
// ``keep_n`` slots: models/params.py freeze_mask, the camera's slots 1),
// row k's sum is written as 0 where keep[k % keep_n] is 0: the frozen
// slots are exactly zero, whatever their partials held.
__global__ void __launch_bounds__(kSumThreads)
sum_parts_kernel(const float* __restrict__ grad_parts, const double* __restrict__ loss_parts,
                 int n_rows, int n_cols, int loss_cols, float scale,
                 float* __restrict__ grad_out, float* __restrict__ loss_out,
                 const float* __restrict__ keep, int keep_n) {
  __shared__ double buf[kSumThreads];
  const int k = blockIdx.x;
  double s = 0.0;
  if (k < n_rows) {
    const float* row = grad_parts + static_cast<long long>(k) * n_cols;
    for (int i = threadIdx.x; i < n_cols; i += blockDim.x) s += row[i];
  } else {
    for (int i = threadIdx.x; i < loss_cols; i += blockDim.x) s += loss_parts[i];
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
      grad_out[k] = keep == nullptr || keep[k % keep_n] != 0.0f ? total : 0.0f;
    } else {
      loss_out[0] = total;
    }
  }
}

// The hinted folds of the gradient kernels (gradkernel.cu, ablate.cu)
// under the freeze_hints contract: the room's 4 wall pairs on axes x, y,
// z, w, and any other pattern. On the room the room's instance takes
// 8-18% less time than the generic one in K4, K5 and K6 (PERF.md,
// tools/compare_trees.py).
using RoomFold = GradTableFold<4, 0>;
using AnyFold = GradTableFold<-1, -1>;
// The composite folds of K4, K5 (gradcomposite.cu), K6 (softcomposite.cu)
// and K8, hinted or not:
// the generic one (kinds and hints read from the table), and one for each
// library composite scene under the contract, its kind and axis hints
// fixed, as K1's instances (megakernel.cu launch_composites).
using CompFold = GradCompositeFold<-1, -1, -1, -1, -1>;
using UnionFold = GradCompositeFold<-1, -1, kCompUnion, kLibraryFams, -1>;
using TigerFold = GradCompositeFold<-1, -1, kCompTiger, kLibraryFams, -1>;
using CubeFold = GradCompositeFold<-1, -1, kCompHypercube, -1, kLibraryCube>;

// The fold of a gradient launch: ParamsFold without hints (``hints``
// null: a scene of hyperplanes and spheres), RoomFold for the room's
// pattern (4 wall pairs on the axes in order, no single plane) at the main
// bounce count, AnyFold for any other valid descriptor of hyperplanes and
// spheres; for a descriptor with composites (n_singles -1 and axis hints
// -1 without the contract) a library scene's instance under its hints at
// the main bounce count, else CompFold; kBadFold for a descriptor the
// table cannot hold and a plane descriptor without hints.
enum FoldKind { kParamsFold, kRoomFold, kAnyFold, kCompFold, kUnionFold, kTigerFold, kCubeFold,
                kBadFold };
inline FoldKind fold_kind(const Layout& L, const int* hints, int reflections, Hints& H) {
  H = {};
  if (hints == nullptr) return kParamsFold;
  H = hints_from(hints);
  if (!hints_valid(L, H)) return kBadFold;
  if (composite_kinds(H) != 0) {
    switch (reflections == kMainBounces ? library_composite(H) : 0) {
      case kCompUnion:
        return kUnionFold;
      case kCompTiger:
        return kTigerFold;
      case kCompHypercube:
        return kCubeFold;
      default:
        return kCompFold;
    }
  }
  if (H.n_singles < 0) return kBadFold;
  const bool room = H.n_pairs == 4 && H.n_singles == 0 && pairs_in_axis_order(H);
  return room && reflections == kMainBounces ? kRoomFold : kAnyFold;
}
inline bool composite_fold(FoldKind kind) { return kind >= kCompFold && kind < kBadFold; }

// Returns ``launch(Fold{})`` for the launch's fold of hyperplanes and
// spheres (fold_kind), or cudaErrorInvalidValue for any other kind.
template <class F>
int with_fold(FoldKind kind, F&& launch) {
  switch (kind) {
    case kParamsFold:
      return launch(ParamsFold{});
    case kRoomFold:
      return launch(RoomFold{});
    case kAnyFold:
      return launch(AnyFold{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Returns ``launch(Fold{})`` for a composite fold, or
// cudaErrorInvalidValue for any other kind.
template <class F>
int with_composite_fold(FoldKind kind, F&& launch) {
  switch (kind) {
    case kCompFold:
      return launch(CompFold{});
    case kUnionFold:
      return launch(UnionFold{});
    case kTigerFold:
      return launch(TigerFold{});
    case kCubeFold:
      return launch(CubeFold{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The layout table a launch function receives, as the kernels take it.
inline Layout layout_from(const int* table) {
  Layout L;
  int* dst = reinterpret_cast<int*>(&L);
  for (int i = 0; i < kLayoutInts; ++i) dst[i] = table[i];
  return L;
}

// The (view, x, global row) pixel of linear index lin of a launch over
// n_rows image rows from row0.
struct PixelIndex {
  int view, px, py;
};
__device__ __forceinline__ PixelIndex pixel_index(long long lin, int width, int row0, int n_rows) {
  const int hw = n_rows * width;
  const int view = static_cast<int>(lin / hw);
  const int rem = static_cast<int>(lin - static_cast<long long>(view) * hw);
  const int ly = rem / width;
  return {view, rem - ly * width, row0 + ly};
}

// Blocks of kGradBlock threads per frame or params row of a launch over
// V * n_rows * W pixels (a block of n_rows image rows), or -1 for a shape
// the launch refuses.
inline long long pixel_blocks(const Layout& L, int width, int n_rows) {
  const long long total = static_cast<long long>(L.n_views) * n_rows * width;
  if (total <= 0) return -1;
  return (total + kGradBlock - 1) / kGradBlock;
}

// The launch's dynamic shared memory: above the 48 KB a launch gets by
// default, the kernel is opted in to it first (the cap on P keeps it under
// the SM's 227 KB). Returns the error of the opt-in.
inline cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace
