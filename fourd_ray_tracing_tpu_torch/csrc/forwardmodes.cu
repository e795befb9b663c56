// K1 in its configurations besides the production one: the sequential RNG
// stream, the "kepler" and "newton" samplers, the literal "spec" and
// "trig" folds, and the fast fold over a hypercube without generators.
//
// Replaces the rest of fourd_ray_tracing_tpu/ops/pallas/megakernel.py::
// _kernel with _trace_rays_kernel: the configurations it reads from cfg
// (rng_mode, sampler_method, intersect; megakernel.py:162-222, 366-379).
// The production launch (megakernel.cu: per-sample streams, the poly
// sampler, the fast fold) keeps its own instances; a launch here runs
// forward_kernel (forward.cuh) with
//
// * the RNG mode a launch argument (kRngArg): a grid-uniform branch. In
//   sequential mode every sample draws from the pixel's bits with the
//   counter the sample before left, and pays the reference's dead draws of
//   its final iteration (trace.cuh trace_sample, dead_draws);
// * the sampler a template argument: newton's per-lane do-while (at most
//   64 steps, every warp paying for its slowest lane) and kepler's Halley
//   steps (their count a launch argument) each have their own code;
// * the fold a template argument: the fast fold's generic instances (the
//   table's, and the composites' reading kinds and hints from the table:
//   a hinted configuration runs hinted, as the production launch does),
//   the composites' instance whose hypercube folds cell by cell
//   (kCubeCells), and the literal folds SpecFold<false> ("spec") and
//   SpecFold<true> ("trig"), which read the params primitive by primitive
//   and carry no hints.
//
// 5 folds x 3 samplers: 15 instances, in a source of their own so that
// nvcc builds them beside the production ones. Numerics: the samplers and
// the trig fold call the CUDA math library's expf, logf, sinf, cosf, acosf
// and asinf (never their intrinsics), as torch's CUDA ops do.

#include "forward.cuh"

namespace {

// The fold codes of the launch (ops/cuda/megakernel.py FOLD_CODES).
constexpr int kFoldFast = 0, kFoldSpec = 1, kFoldTrig = 2;

template <class Fold>
int launch_sampler(int sampler, int sequential, int sampler_iters, const float* params,
                   long long row_stride, const uint32_t* seeds, int n_frames, const Layout& L,
                   const Hints& H, int width, int height, int row0, int n_rows, int samples,
                   int reflections, float small_indent, float* out, void* stream) {
#define FOURD_LAUNCH(S)                                                                         \
  return launch_forward<kStubNone, Fold, S, kRngArg>(params, row_stride, seeds, n_frames, L, H, \
                                                     width, height, row0, n_rows, samples,      \
                                                     reflections, small_indent, out, stream,     \
                                                     sequential, sampler_iters)
  switch (sampler) {
    case kSamplerPoly:
      FOURD_LAUNCH(kSamplerPoly);
    case kSamplerKepler:
      FOURD_LAUNCH(kSamplerKepler);
    case kSamplerNewton:
      FOURD_LAUNCH(kSamplerNewton);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FOURD_LAUNCH
}

}  // namespace

// Launch on ``stream``, as fourd_forward_launch (megakernel.cu) with the
// same arguments after the first four: ``fold`` 0 fast, 1 spec, 2 trig;
// ``sampler`` 0 poly, 1 kepler, 2 newton; ``sequential`` 1 for the
// sequential RNG stream, 0 for per-sample streams; ``sampler_iters``
// kepler's Halley steps (0-16). A spec or trig launch takes a descriptor
// without hints (n_singles -1, every axis hint -1 but a hypercube without
// generators, kCubeCells). Returns cudaGetLastError() after the launch,
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int fourd_forward_modes_launch(int fold, int sampler, int sequential,
                                          int sampler_iters, const float* params,
                                          long long row_stride, const uint32_t* seeds,
                                          int n_frames, const int* layout, const int* hints,
                                          int width, int height, int row0, int n_rows,
                                          int samples, int reflections, float small_indent,
                                          float* out, void* stream) {
  Layout L;
  int* dst = reinterpret_cast<int*>(&L);
  for (int i = 0; i < kLayoutInts; ++i) dst[i] = layout[i];
  const Hints H = hints_from(hints);
  if ((sequential != 0 && sequential != 1) || sampler_iters < 0 || sampler_iters > 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool cells = H.hypercube_axes == kCubeCells;
  const auto launch = [&](auto fold_tag) {
    return launch_sampler<decltype(fold_tag)>(sampler, sequential, sampler_iters, params,
                                              row_stride, seeds, n_frames, L, H, width, height,
                                              row0, n_rows, samples, reflections, small_indent,
                                              out, stream);
  };
  switch (fold) {
    case kFoldFast:
      if (composite_kinds(H) == 0) return launch(TableFold<-1, -1>{});
      return cells ? launch(CompositeFold<-1, -1, -1, -1, kCubeCells>{})
                   : launch(CompositeFold<-1, -1, -1, -1, -1>{});
    case kFoldSpec:
    case kFoldTrig:
      if (H.n_singles != -1) return static_cast<int>(cudaErrorInvalidValue);
      return fold == kFoldSpec ? launch(SpecFold<false>{}) : launch(SpecFold<true>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
