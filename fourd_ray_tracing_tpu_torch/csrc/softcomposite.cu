// K6, the fused soft value-and-grad launch, over the composite primitives'
// folds, for Hopper (sm_90a): gradkernel.cu's soft launch on a scene with
// cylinders, the duocylinder, the hypercube or the tiger, hinted (the
// freeze_hints contract) or not, the soft object a sphere or a composite.
// Replaces the composite part of fourd_ray_tracing_tpu/ops/pallas/
// gradkernel.py::_soft_loss_grad_kernel (launched by _soft_launch), whose
// two jax.vjp sweeps run over the whole scene fold (gradkernel.py
// :1268-1290).
//
// Design: gradkernel.cu's K6 kernels (gradlaunch.cuh: pass 1 on both rows,
// the row-a and row-b sweeps, sum_parts_kernel) over the composite folds
// of K4 and K5 (gradcomposite.cu: the generic CompFold and the library
// scenes' UnionFold, TigerFold and CubeFold). Row b is the row with the
// zero map applied (diff.zero_object: every radius of the object 0, the
// hypercube's generator and cell radii -1): each of its blocks builds K1's
// table from that row, which folds the object to a guaranteed miss (no
// circle family's discriminant is positive at r = 0, the 1 / r of its
// records guarded by max(r, 1e-30); no cell's extent test passes at
// r = -1), so its light is the light without the object and its sweep
// never reaches the object's partials; the map's slots are dropped from
// row b's columns all the same (sm.skip). A composite's map names no
// sphere (zero_map_object -1), so both rows are swept whole. This source
// compiles in its own nvcc process, beside gradkernel.cu and
// gradcomposite.cu, so that the build's longest compile does not grow.

#include "gradlaunch.cuh"

extern "C" int fourd_soft_loss_grad_composite(
    const float* params, uint32_t seed, const int* layout, int n_zero, const int* zero_idx,
    const float* zero_val, int width, int height, int row0, int n_rows, int samples,
    int reflections, float small_indent, float light_coefficient, const float* target,
    const float* alpha, float scale, float* sums, uint32_t* row_b, float* grad_parts,
    double* loss_parts, float* grad_out, float* loss_out, float* alpha_cot, const int* hints,
    const float* keep, void* stream) {
  const Layout L = layout_from(layout);
  const int n_cols = fourd_grad_scratch_cols(layout, width, n_rows, 2);
  ZeroMap zm;
  int obj = -1;
  if (n_cols < 0 || bad_shape(L, height, row0, n_rows, samples, reflections) ||
      !zero_map_from(L, n_zero, zero_idx, zero_val, samples, zm, obj)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Hints H;
  const FoldKind kind = fold_kind(L, hints, reflections, H);
  return with_composite_fold(kind, [&](auto fold) {
    return k6_launch<decltype(fold)>(params, seed, L, H, zm, obj, width, height, row0, n_rows,
                                     samples, reflections, small_indent, light_coefficient,
                                     target, alpha, scale, sums, row_b, grad_parts, loss_parts,
                                     grad_out, loss_out, alpha_cot, keep, n_cols / 2, n_cols,
                                     static_cast<cudaStream_t>(stream));
  });
}
