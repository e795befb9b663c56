// The value-and-grad kernel's pass-budget variants (K8), for Hopper
// (sm_90a): measurement only.
//
// Replaces tools/grad_ablate.py::_variant_kernel of the JAX package: K4's
// per-pixel math (gradkernel.cu, adjoint.cuh pixel_loss_grad) stopped at
// ``mode``, so that timing the variants beside K4 splits K4's time between
// its stages instead of guessing it:
//   kAcc  (0): pass 1 only, the sample loop (pixel_light_sum, bitwise K1's);
//              a pixel's value is the sum of the three channels of its light
//              summed over samples;
//   kLoss (1): + the tone map and the pixel's masked MSE, exactly as K4
//              computes its loss;
//   kVjp  (2): + the loss's cotangent with respect to the light (K4's
//              g_light), folded into the value as 0 * (g.x + g.y + g.z), so
//              that it is not dead code and the value stays the loss.
// K4 minus vjp is then the pixel sweep plus the parameter reduction, vjp
// minus loss the cotangent, loss minus acc the tone map and the MSE, and acc
// pass 1 (tools/grad_ablate.py prints the split).
//
// Design: K4's, without the sweep. One thread per (view, y, x) pixel of the
// whole image, the packed parameters in shared memory. There is no
// cotangent array: the P-float array and its reduction are what the
// variants leave out. The block reduces its threads' values in double with
// K4's loss reduction (reduce.cuh reduce_block with no parameters) into one
// partial per block, and sum_parts_kernel sums the partials in K4's fixed
// order, in double, unscaled. So the loss variant's output times K4's scale
// is K4's loss bitwise. Padded lanes contribute 0.
//
// What bounds them: pass 1's arithmetic, as K1's (acc is one K1 frame plus
// a reduction of 4 bytes per pixel).
//
// With a hints descriptor the variants run K4's pass 1 under the
// freeze_hints contract, as the JAX tool times them (with_frozen_hints,
// grad_ablate.py:153-163): K4's pass-1 fold (reduce.cuh fold_kind: RoomFold
// or AnyFold over K1's table, built by each block after the params). A
// scene with composite primitives takes K4's composite folds, hinted or
// not (CompFold, or a library scene's instance under its hints).

#include "ablate.cuh"

// K8 on ``stream``: value_out () float32, the unscaled sum over the image's
// pixels of the variant's per-pixel value (mode 0 acc, 1 loss, 2 vjp), from
// params (P,) float32, one seed and the target (V, H, W, 3) float32 (not
// read by mode 0), with the static hints of the host int[kHintInts]
// descriptor ``hints`` (null: none; a scene with composites always has
// one; reduce.cuh fold_kind picks the fold and refuses a descriptor as K4's
// launch does).
// The arguments keep fourd_loss_grad_launch's order, less what the
// variants do not take (frames, row offset, scale, gradients, the mask).
// loss_parts (n_cols,) float64 is scratch of the caller's, n_cols as
// fourd_grad_scratch_cols(layout, width, height, 1) gives it (one column
// per block). Returns cudaGetLastError() after each launch.
extern "C" int fourd_ablate_launch(int mode, const float* params, uint32_t seed, const int* layout,
                                   int width, int height, int samples, int reflections,
                                   float small_indent, float light_coefficient,
                                   const float* target, double* loss_parts, float* value_out,
                                   const int* hints, void* stream) {
  const Layout L = layout_from(layout);
  const int n_cols = k8_cols(L, width, height);
  if (n_cols < 0 || samples <= 0 || reflections < 0 || L.size <= 0 || L.size > kMaxParams ||
      mode < kModeAcc || mode > kModeVjp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Hints H;
  const FoldKind kind = fold_kind(L, hints, reflections, H);
  const auto run = [&](auto fold) {
    return k8_launch<decltype(fold)>(mode, params, seed, L, H, width, height, samples,
                                     reflections, small_indent, light_coefficient, target,
                                     loss_parts, value_out, n_cols,
                                     static_cast<cudaStream_t>(stream));
  };
  return composite_fold(kind) ? with_composite_fold(kind, run) : with_fold(kind, run);
}
