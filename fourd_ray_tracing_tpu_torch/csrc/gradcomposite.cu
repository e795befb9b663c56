// K4 and K5 over the composite primitives' folds, for Hopper (sm_90a):
// gradkernel.cu's value-and-grad and light-VJP launches on a scene with
// cylinders, the duocylinder, the hypercube or the tiger, hinted (the
// freeze_hints contract) or not. Replaces the composite part of
// fourd_ray_tracing_tpu/ops/pallas/gradkernel.py::_loss_grad_kernel and
// ::_light_vjp_kernel, whose jax.vjp runs over the whole scene fold
// (gradkernel.py:216-231, 256-257). K6 over the same folds is
// softcomposite.cu.
//
// Design: gradkernel.cu's kernels (gradlaunch.cuh) with a GradCompositeFold
// (trace.cuh): each block builds K1's fold table after its params, the
// composites' records included, so pass 1's light is K1's and the sweep's
// re-trace finds pass 1's hits and distances bitwise; the winner is
// numbered as the adjoint reads the params, a composite candidate with its
// branch (near or far root, +cell or -cell), and the reverse
// differentiates the packed params through the plain pipeline's full
// projections (adjoint.cuh composite_adj), whatever the hints. Under the
// contract sum_parts_kernel writes the frozen slots (the hyperplane
// normals, the hinted axes) as 0 after the fixed-order sums, so the loss
// and every kept slot are the unhinted launch's. The instances: the
// generic one (CompFold: any composite scene, any bounce count, the kinds
// and hints read from the table), and one for each library composite
// scene under its hints at the main bounce count (UnionFold, TigerFold,
// CubeFold), as K1 has. This source compiles in its own nvcc process,
// beside gradkernel.cu.

#include "gradlaunch.cuh"

extern "C" int fourd_loss_grad_composite(const float* params, const uint32_t* seeds, int n_frames,
                                         int split, const int* layout, int width, int height,
                                         int row0, int n_rows, int samples, int reflections,
                                         float small_indent, float light_coefficient,
                                         const float* target, float scale, float* g_mean,
                                         float* grad_parts, double* loss_parts, float* grad_out,
                                         float* loss_out, const int* hints, const float* keep,
                                         void* stream) {
  const Layout L = layout_from(layout);
  const int n_cols = fourd_grad_scratch_cols(layout, width, n_rows, n_frames);
  if (n_cols < 0 || bad_split(L, width, n_rows, n_frames, split) ||
      bad_shape(L, height, row0, n_rows, samples, reflections)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Hints H;
  const FoldKind kind = fold_kind(L, hints, reflections, H);
  return with_composite_fold(kind, [&](auto fold) {
    return k4_launch<decltype(fold)>(params, seeds, n_frames, split, L, H, width, height, row0,
                                     n_rows, samples, reflections, small_indent,
                                     light_coefficient, target, scale, g_mean, grad_parts,
                                     loss_parts, grad_out, loss_out, keep, n_cols / n_frames,
                                     n_cols, static_cast<cudaStream_t>(stream));
  });
}

extern "C" int fourd_loss_grad_composite_occupancy(const int* layout, int reflections,
                                                   const int* hints, int* out) {
  const Layout L = layout_from(layout);
  Hints H;
  const FoldKind kind = fold_kind(L, hints, reflections, H);
  return with_composite_fold(kind, [&](auto fold) {
    return sweep_occupancy<decltype(fold)>(L, H, reflections, out);
  });
}

extern "C" int fourd_light_vjp_composite(const float* params, long long row_stride,
                                         int n_params_rows, uint32_t seed, const int* layout,
                                         int width, int height, int row0, int n_rows, int samples,
                                         int reflections, float small_indent, const float* cot,
                                         float* grad_parts, float* grad_out, const int* hints,
                                         const float* keep, void* stream) {
  const Layout L = layout_from(layout);
  const int n_cols = fourd_grad_scratch_cols(layout, width, n_rows, 1);
  if (n_cols < 0 || bad_shape(L, height, row0, n_rows, samples, reflections) ||
      n_params_rows <= 0 || n_params_rows > 65535 || row_stride < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Hints H;
  const FoldKind kind = fold_kind(L, hints, reflections, H);
  return with_composite_fold(kind, [&](auto fold) {
    return k5_launch<decltype(fold)>(params, row_stride, n_params_rows, seed, L, H, width, height,
                                     row0, n_rows, samples, reflections, small_indent, cot,
                                     grad_parts, grad_out, keep, n_cols,
                                     static_cast<cudaStream_t>(stream));
  });
}
