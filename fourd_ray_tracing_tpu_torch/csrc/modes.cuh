// The launches of K4, K5 and K6 over K1's other configurations, for Hopper
// (sm_90a): gradmodes.cu (K4, K5) and softmodes.cu (K6), each source in its
// own nvcc process. The value-and-grad, light-VJP and soft value-and-grad
// launches of gradkernel.cu with the "kepler" and "newton" samplers, the
// literal "spec" and "trig" folds, and the fast fold over a hypercube
// without generators, each with per-sample RNG streams (the sequential
// stream stays refused, as the JAX package's _check_cfg refuses it).
//
// Replaces the rest of fourd_ray_tracing_tpu/ops/pallas/gradkernel.py::
// _loss_grad_kernel, ::_light_vjp_kernel and ::_soft_loss_grad_kernel:
// their jax.vjp runs over _trace_rays_kernel (megakernel.py:128-263), which
// dispatches on cfg.intersect (intersect_scene, :162-166 and :207-211) and
// on cfg.sampler_method (direction_from_uniforms, :186-189).
//
// Design: gradlaunch.cuh's kernels over Modes<Fold> (trace.cuh), with
//
// * the sampler a launch argument (trace.cuh kSamplerArg, the sampler's
//   code | kepler's Halley steps << 2): the launch writes it into the
//   descriptor that every kernel takes by value, in a slot the descriptor
//   leaves empty (sampler_slot), and each block copies it to shared memory
//   (build_table_for), so the production kernels' code and parameters
//   serve unchanged and no state outlives a launch: launches in several
//   streams at once each read their own. Pass 1 and the sweep's re-trace draw their
//   directions by the sampler's own code, so pass 1's light is K1's
//   (forwardmodes.cu) bitwise and the re-trace finds pass 1's hits. The
//   sampler needs no adjoint: a direction depends on the hashed uniforms
//   alone (JAX's newton is a while_loop that the vjp never
//   differentiates);
// * the fold a template argument: the literal folds SpecFold<false>
//   ("spec") and SpecFold<true> ("trig"), whose winners the sweep
//   resolves by re-running their own literal test and differentiates
//   through it (adjoint.cuh lit_adj); the fast fold's generic instances
//   (AnyFold over the hyperplanes and spheres, hinted or not; CompFold over
//   the composites) and CellsFold, the composite fold whose hypercube,
//   built from its cells alone, folds cell by cell, a cell's hit
//   differentiated as the literal folds' are.
//
// Every instance is the generic bounce count's (kMaxBounces, loops rolled):
// 5 folds x 5 kernels, off the production path, in sources of their own
// so that nvcc builds them beside the production instances, which stay as
// they were, SASS and all. Under the literal folds K6 sweeps both rows whole (the
// zeroed sphere's guaranteed miss, which lets row a's sweep carry row b,
// is the fast fold's: zero_map_object). Numerics: the samplers and the
// trig fold call the CUDA math library's expf, logf, sinf, cosf, acosf and
// asinf, as torch's CUDA ops and K1 do.
//
// What bounds them: as gradkernel.cu's, the trace's and the adjoint's
// arithmetic at the occupancy the sweeps' registers allow; newton's
// per-lane do-while (every warp paying for its slowest lane) and the trig
// fold's transcendentals add to both passes.

#pragma once

#include "gradlaunch.cuh"

namespace {

// The fold codes of the launches (ops/cuda/megakernel.py FOLD_CODES).
constexpr int kFoldFast = 0, kFoldSpec = 1, kFoldTrig = 2;

// The fast fold over a hypercube without generators.
using CellsFold = GradCompositeFold<-1, -1, -1, -1, kCubeCells>;

// The block's copy of its launch's sampler (kSamplerArg), which its traces
// read.
__shared__ int s_sampler;

template <class Fold>
__device__ int& modes_sampler(Modes<Fold>) {
  return s_sampler;
}

// The sampler argument of the modes kernels from the launch's sampler code
// (ops/cuda/megakernel.py SAMPLER_CODES) and kepler's Halley steps; -1 for
// values the launch refuses.
int mode_of(int sampler, int sampler_iters) {
  if (sampler < kSamplerPoly || sampler > kSamplerNewton || sampler_iters < 0 ||
      sampler_iters > 16) {
    return -1;
  }
  return sampler | sampler_iters << 2;
}

// Returns ``launch(Modes<Fold>{})`` for the fold code and the descriptor
// (which every launch here takes: megakernel.hint_table; a literal fold's
// carries no hints), after writing the sampler ``mode`` into ``H``, or
// cudaErrorInvalidValue for what the launches refuse.
template <class F>
int with_modes_fold(int fold, int mode, const Layout& L, const int* hints, Hints& H,
                    F&& launch) {
  if (hints == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  H = hints_from(hints);
  const bool literal = fold == kFoldSpec || fold == kFoldTrig;
  if (!hints_valid(L, H, true) || (fold != kFoldFast && !literal) ||
      (literal && H.n_singles != -1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  sampler_slot(H) = mode;
  if (fold == kFoldSpec) return launch(Modes<SpecFold<false>>{});
  if (fold == kFoldTrig) return launch(Modes<SpecFold<true>>{});
  if (composite_kinds(H) == 0) return launch(Modes<AnyFold>{});
  return H.hypercube_axes == kCubeCells ? launch(Modes<CellsFold>{}) : launch(Modes<CompFold>{});
}

}  // namespace

// The modes launches (fourd_loss_grad_modes, fourd_light_vjp_modes,
// fourd_soft_loss_grad_modes) take the arguments of fourd_loss_grad_launch,
// fourd_light_vjp_launch and fourd_soft_loss_grad_launch (gradkernel.cu)
// after three more: ``fold`` 0 fast, 1 spec, 2 trig; ``sampler`` 0 poly, 1
// kepler, 2 newton; ``sampler_iters`` kepler's Halley steps (0-16). Their
// ``hints`` is never null (a literal fold's descriptor holds the
// composites' offsets alone; a hypercube without generators has the axis
// hint kCubeCells). Each returns cudaGetLastError() after its launches,
// cudaErrorInvalidValue for arguments it does not take.
