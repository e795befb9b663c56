// K4 and K5 over K1's other configurations (the kepler and newton
// samplers, the literal spec and trig folds, a hypercube without
// generators), for Hopper (sm_90a). Replaces the rest of
// fourd_ray_tracing_tpu/ops/pallas/gradkernel.py::_loss_grad_kernel and
// ::_light_vjp_kernel. The design is modes.cuh's; K6 over the same folds
// is softmodes.cu.

#include "modes.cuh"

extern "C" int fourd_loss_grad_modes(int fold, int sampler, int sampler_iters,
                                     const float* params, const uint32_t* seeds, int n_frames,
                                     int split, const int* layout, int width, int height,
                                     int row0, int n_rows, int samples, int reflections,
                                     float small_indent, float light_coefficient,
                                     const float* target, float scale, float* g_mean,
                                     float* grad_parts, double* loss_parts, float* grad_out,
                                     float* loss_out, const int* hints, const float* keep,
                                     void* stream) {
  const Layout L = layout_from(layout);
  const int n_cols = grad_scratch_cols(L, width, n_rows, n_frames);
  const int mode = mode_of(sampler, sampler_iters);
  if (n_cols < 0 || mode < 0 || bad_split(L, width, n_rows, n_frames, split) ||
      bad_shape(L, height, row0, n_rows, samples, reflections)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Hints H;
  const auto s = static_cast<cudaStream_t>(stream);
  return with_modes_fold(fold, mode, L, hints, H, [&](auto fold_tag) {
    return k4_launch<decltype(fold_tag)>(params, seeds, n_frames, split, L, H, width, height,
                                         row0, n_rows, samples, reflections, small_indent,
                                         light_coefficient, target, scale, g_mean, grad_parts,
                                         loss_parts, grad_out, loss_out, keep, n_cols / n_frames,
                                         n_cols, s);
  });
}

// The occupancy of the sweep that fourd_loss_grad_modes runs (gradkernel.cu
// fourd_loss_grad_occupancy). Launches nothing.
extern "C" int fourd_loss_grad_modes_occupancy(int fold, int sampler, int sampler_iters,
                                               const int* layout, int reflections,
                                               const int* hints, int* out) {
  const Layout L = layout_from(layout);
  const int mode = mode_of(sampler, sampler_iters);
  if (mode < 0 || L.size <= 0 || L.size > kMaxParams || reflections < 0 ||
      reflections > kMaxBounces) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Hints H;
  return with_modes_fold(fold, mode, L, hints, H, [&](auto fold_tag) {
    return sweep_occupancy<decltype(fold_tag)>(L, H, reflections, out);
  });
}

extern "C" int fourd_light_vjp_modes(int fold, int sampler, int sampler_iters,
                                     const float* params, long long row_stride,
                                     int n_params_rows, uint32_t seed, const int* layout,
                                     int width, int height, int row0, int n_rows, int samples,
                                     int reflections, float small_indent, const float* cot,
                                     float* grad_parts, float* grad_out, const int* hints,
                                     const float* keep, void* stream) {
  const Layout L = layout_from(layout);
  const int n_cols = grad_scratch_cols(L, width, n_rows, 1);
  const int mode = mode_of(sampler, sampler_iters);
  if (n_cols < 0 || mode < 0 || bad_shape(L, height, row0, n_rows, samples, reflections) ||
      n_params_rows <= 0 || n_params_rows > 65535 || row_stride < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Hints H;
  const auto s = static_cast<cudaStream_t>(stream);
  return with_modes_fold(fold, mode, L, hints, H, [&](auto fold_tag) {
    return k5_launch<decltype(fold_tag)>(params, row_stride, n_params_rows, seed, L, H, width,
                                         height, row0, n_rows, samples, reflections,
                                         small_indent, cot, grad_parts, grad_out, keep, n_cols,
                                         s);
  });
}
