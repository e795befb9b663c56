// Forward path-tracing megakernel for Hopper (sm_90a).
//
// Replaces fourd_ray_tracing_tpu/ops/pallas/megakernel.py::_kernel (with
// _trace_rays_kernel, _tile_pixels and _tile_camera): per frame seed and
// per pixel, the primary ray of the pixel's view, bounce 0 computed once
// per pixel, then `samples` per-sample traces of `reflections_amount`
// bounces (closest hit over hyperplanes, hyperspheres, cylinders, the
// duocylinder, the hypercube and the tiger with the static hints,
// emission and environment light, Bernoulli mirror vs uniform-S^3
// diffuse with masked counter RNG, shade-only last bounce), and the mean
// light.
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
// The fold is the JAX production forward's (megakernel.py:162-165,
// 207-210): the wrapper derives the static hyperplane hints from the
// scene (models/scene.py plane_norm_hints, plane_pair_hints) and passes
// them as a descriptor (trace.cuh Hints); each block turns the params into
// a fold table in shared memory once (trace.cuh build_fold_table: the
// wall pairs' axis offsets, the single planes' dot(point, n), the
// spheres' r^2 and 1 / r), and every bounce folds over the table
// (intersect_table): the room's 8 walls as 4 pairs of two compares and one
// division each, a record of 16 bytes a pair, where the unhinted fold read
// 8 floats of every wall and did three 4-term dots and a division. The
// fold's counts are template arguments where a hint pattern has its own
// instance (the room's 4 pairs, each on its axis: x, y, z, w, so each
// pair reads its ray components without a select), runtime values read
// from the table otherwise (the generic instance; sphere_plane_light's
// single plane takes it). A launch without hints runs the same table fold
// with every plane a single of four live components (an instance of its
// own, the masks fixed): the unhinted fold, bitwise.
//
// The composite primitives fold after the spheres, in the JAX order
// (scene.py:495-653): each cylinder, the duocylinder's two faces, the
// hypercube's four opposite-cell candidates, the tiger's four merged
// candidates. Their per-scene values go into the same table (trace.cuh
// build_fold_table): each cylinder family's point and axes with its axis
// hint and live masks, each face's r^2, 1 / max(r, 1e-30) and material,
// the hypercube's center, axes, half-width, hinted signs and cell
// materials; a bounce computes a family's projections once for all its
// faces and reads nothing else. A scene with composites takes an instance
// of its own (CompositeFold): the three library composite scenes with
// their axis hints each one whose kind and families' aligned components
// are template arguments (the projections then pick components with no
// select), any other composite scene, hinted or not, the generic one,
// which reads kinds and hints from the table. The walls' instances and the
// gradient kernels compile as before.
//
// What bounds it: arithmetic and issue. Per pixel and sample the kernel
// runs reflections_amount fold-and-shade passes over every candidate and
// reads no memory but shared memory; the output is 12 bytes per pixel.
// 128 threads a block, no minimum of resident blocks: 256 threads and
// minimums of 4-8 blocks timed alike on the H100 (PERF.md).
//
// The device math (vectors, RNG, fastmath, sampler, sky, both folds, the
// per-pixel primary ray, bounce 0 and one sample's trace) lives in
// trace.cuh, shared with the gradient kernels (gradkernel.cu, ablate.cu),
// which run the unhinted fold over the packed params (trace.cuh
// ParamsFold, the template default): their code is as before the table.
//
// Numerics: every operation keeps the order of the plain torch pipeline
// (models/renderer.py, models/scene.py) and of the JAX package, and the
// build passes -fmad=false so nvcc does not contract a*b+c into an FMA.
// Torch's eager ops do not contract either, so on the card the kernel is
// bitwise equal to its plain version, hinted or not (XLA on the CPU does
// contract, so the JAX package is matched within image tolerances). Float
// constants are hex literals of the JAX package's float32 values.
//
// The same kernel with stubs compiled in (trace.cuh kStub*) is the
// measurement variant launch of tools/fwd_ablate.py
// (fourd_forward_variant_launch), which can also force the generic
// instance of the fold (kGenericFold); the production launch instantiates
// no stub, so its code is the trace alone.
//
// The kernel and its launch are forward.cuh's; this source instantiates
// them in the production configuration (per-sample RNG streams, the poly
// sampler, the fast fold) and for the measurement variants. Every other
// configuration the JAX kernel reads from cfg (the sequential stream, the
// kepler and newton samplers, the spec and trig folds, a hypercube without
// generators) launches through forwardmodes.cu, whose instances build in
// their own nvcc process; the production instances compile as before.
//
// Still to do for speed (later work): FMA contraction once its effect on
// the image is measured, and a persistent-block schedule.

#include "forward.cuh"

namespace {

// The variant launch's flag that forces the generic instance of the fold.
constexpr int kGenericFold = 4;

// The composite instance of the fold: one for each library composite
// scene with its hints (its single kind, its families' hints fixed; its
// floor plane by the table) in the production kernel, the generic one
// (kinds and hints read from the table) for any other composite scene and
// for the measurement variants. On the H100 the generic instance, reading
// the same hints from the table, takes 23-33% longer on the library's
// three composite scenes (PERF.md, tools/fwd_ablate.py generic_fold).
template <int kStub>
int launch_composites(bool generic, const float* params, long long row_stride,
                      const uint32_t* seeds, int n_frames, const Layout& L, const Hints& H,
                      int width, int height, int row0, int n_rows, int samples, int reflections,
                      float small_indent, float* out, void* stream) {
#define FOURD_LAUNCH(...)                                                                    \
  return launch_forward<kStub, __VA_ARGS__>(params, row_stride, seeds, n_frames, L, H, width, \
                                            height, row0, n_rows, samples, reflections,       \
                                            small_indent, out, stream)
  if constexpr (kStub == kStubNone) {
    switch (generic ? 0 : library_composite(H)) {
      case kCompUnion:
        FOURD_LAUNCH(CompositeFold<-1, -1, kCompUnion, kLibraryFams, -1>);
      case kCompTiger:
        FOURD_LAUNCH(CompositeFold<-1, -1, kCompTiger, kLibraryFams, -1>);
      case kCompHypercube:
        FOURD_LAUNCH(CompositeFold<-1, -1, kCompHypercube, -1, kLibraryCube>);
      default:
        break;
    }
  }
  FOURD_LAUNCH(CompositeFold<-1, -1, -1, -1, -1>);
#undef FOURD_LAUNCH
}

// Picks the fold's instance: a scene with composites has its own
// (launch_composites); otherwise the room's 4 pairs on the axes in order
// have their own, a launch without hints its own (every single all live),
// any other hint pattern the generic one.
template <int kStub>
int launch_fold(bool generic, const float* params, long long row_stride, const uint32_t* seeds,
                int n_frames, const int* layout, const int* hints, int width, int height,
                int row0, int n_rows, int samples, int reflections, float small_indent,
                float* out, void* stream) {
  Layout L;
  int* dst = reinterpret_cast<int*>(&L);
  for (int i = 0; i < kLayoutInts; ++i) dst[i] = layout[i];
  const Hints H = hints_from(hints);
  if (composite_kinds(H) != 0) {
    return launch_composites<kStub>(generic, params, row_stride, seeds, n_frames, L, H, width,
                                    height, row0, n_rows, samples, reflections, small_indent, out,
                                    stream);
  }
  if (!generic && H.n_pairs == 4 && H.n_singles == 0 && pairs_in_axis_order(H)) {
    return launch_forward<kStub, TableFold<4, 0>>(params, row_stride, seeds, n_frames, L, H,
                                                  width, height, row0, n_rows, samples,
                                                  reflections, small_indent, out, stream);
  }
  if (!generic && H.n_singles < 0) {
    return launch_forward<kStub, TableFold<0, kAllLive>>(params, row_stride, seeds, n_frames, L,
                                                         H, width, height, row0, n_rows, samples,
                                                         reflections, small_indent, out, stream);
  }
  return launch_forward<kStub, TableFold<-1, -1>>(params, row_stride, seeds, n_frames, L, H,
                                                  width, height, row0, n_rows, samples,
                                                  reflections, small_indent, out, stream);
}

}  // namespace

// Launch on ``stream``: out (F, V, n_rows, W, 3) float32, image rows
// [row0, row0 + n_rows) of H, <- params and seeds (F,) uint32 (row0 0 and
// n_rows H: the whole image). Frame f reads the P = layout[13] floats at
// params + f * row_stride: row_stride 0 renders one scene at F seeds (K1),
// row_stride P renders F same-structure scenes, one params row per frame
// (K2; the wrapper then gives every frame the same seed). ``hints`` is the
// host int[kHintInts] descriptor of the static hints (trace.cuh Hints;
// n_singles -1: none), which every row shares. Returns cudaGetLastError()
// after the launch.
extern "C" int fourd_forward_launch(const float* params, long long row_stride,
                                    const uint32_t* seeds, int n_frames, const int* layout,
                                    const int* hints, int width, int height, int row0, int n_rows,
                                    int samples, int reflections, float small_indent, float* out,
                                    void* stream) {
  return launch_fold<kStubNone>(false, params, row_stride, seeds, n_frames, layout, hints, width,
                                height, row0, n_rows, samples, reflections, small_indent, out,
                                stream);
}

// The measurement variants of the forward kernel (tools/fwd_ablate.py):
// fourd_forward_launch with the stubs of ``variant & 3`` compiled in (1 =
// kStubSampler, 2 = kStubRng, 3 = both, 0 = none) and, with
// kGenericFold set, the generic instance of the fold whatever the hints.
// Any other variant returns cudaErrorInvalidValue.
extern "C" int fourd_forward_variant_launch(int variant, const float* params,
                                            long long row_stride, const uint32_t* seeds,
                                            int n_frames, const int* layout, const int* hints,
                                            int width, int height, int row0, int n_rows,
                                            int samples, int reflections, float small_indent,
                                            float* out, void* stream) {
  const bool generic = (variant & kGenericFold) != 0;
  switch (variant & ~kGenericFold) {
    case kStubNone:
      return launch_fold<kStubNone>(generic, params, row_stride, seeds, n_frames, layout, hints,
                                    width, height, row0, n_rows, samples, reflections,
                                    small_indent, out, stream);
    case kStubSampler:
      return launch_fold<kStubSampler>(generic, params, row_stride, seeds, n_frames, layout,
                                       hints, width, height, row0, n_rows, samples, reflections,
                                       small_indent, out, stream);
    case kStubRng:
      return launch_fold<kStubRng>(generic, params, row_stride, seeds, n_frames, layout, hints,
                                   width, height, row0, n_rows, samples, reflections,
                                   small_indent, out, stream);
    case kStubSampler | kStubRng:
      return launch_fold<kStubSampler | kStubRng>(generic, params, row_stride, seeds, n_frames,
                                                  layout, hints, width, height, row0, n_rows,
                                                  samples, reflections, small_indent, out,
                                                  stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
