// K8, the value-and-grad kernel's pass-budget variants, over K1's other
// configurations (the kepler and newton samplers, the literal spec and
// trig folds, a hypercube without generators), for Hopper (sm_90a):
// measurement only. Replaces the rest of
// tools/grad_ablate.py::_variant_kernel of the JAX package, whose pass 1
// runs precompute_bounce0 and _trace_rays_kernel (megakernel.py:128-263)
// under its cfg, which dispatch on cfg.intersect and cfg.sampler_method.
//
// Design: ablate.cu's kernel (ablate.cuh) over modes.cuh's Modes<Fold>:
// the sampler a launch argument, which with_modes_fold writes into the
// descriptor's sampler_slot and each block copies to shared memory
// (build_table_for), the fold a template argument (SpecFold<false>,
// SpecFold<true>, AnyFold, CompFold, CellsFold). 3 variants x 5 folds, each
// the generic bounce count's, in a source of their own so that nvcc builds
// them beside the production instances of ablate.cu, which stay as they
// were. Pass 1 is K4's over the same fold (gradmodes.cu), so ``acc`` is
// K1's pixel_light_sum in the same configuration (forwardmodes.cu) bitwise,
// and ``loss`` K4's loss before its scale. Like the JAX kernel, K8 draws
// per-sample streams whatever the configuration's stream (the wrapper
// launches a sequential configuration as its per-sample one).
//
// What bounds them: pass 1's arithmetic, as K1's in the same
// configuration (newton's per-lane loop, the trig fold's transcendentals).

#include "modes.cuh"
#include "ablate.cuh"

// K8 over K1's other configurations: fourd_ablate_launch's arguments after
// modes.cuh's three (``fold`` 0 fast, 1 spec, 2 trig; ``sampler`` 0 poly,
// 1 kepler, 2 newton; kepler's ``sampler_iters``), with a descriptor
// ``hints`` that is never null (gradkernel.launch_words). Returns
// cudaGetLastError() after each launch, cudaErrorInvalidValue for
// arguments it does not take.
extern "C" int fourd_ablate_modes(int fold, int sampler, int sampler_iters, int mode,
                                  const float* params, uint32_t seed, const int* layout,
                                  int width, int height, int samples, int reflections,
                                  float small_indent, float light_coefficient,
                                  const float* target, double* loss_parts, float* value_out,
                                  const int* hints, void* stream) {
  const Layout L = layout_from(layout);
  const int n_cols = k8_cols(L, width, height);
  const int sampler_arg = mode_of(sampler, sampler_iters);
  if (n_cols < 0 || sampler_arg < 0 || mode < kModeAcc || mode > kModeVjp ||
      bad_shape(L, height, 0, height, samples, reflections)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Hints H;
  return with_modes_fold(fold, sampler_arg, L, hints, H, [&](auto fold_tag) {
    return k8_launch<decltype(fold_tag)>(mode, params, seed, L, H, width, height, samples,
                                         reflections, small_indent, light_coefficient, target,
                                         loss_parts, value_out, n_cols,
                                         static_cast<cudaStream_t>(stream));
  });
}
