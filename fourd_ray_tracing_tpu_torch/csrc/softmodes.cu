// K6, the soft value-and-grad launch, over K1's other configurations (the
// kepler and newton samplers, the literal spec and trig folds, a hypercube
// without generators), for Hopper (sm_90a). Replaces the rest of
// fourd_ray_tracing_tpu/ops/pallas/gradkernel.py::_soft_loss_grad_kernel.
// The design is modes.cuh's; under the literal folds both rows are swept
// whole.

#include "modes.cuh"

extern "C" int fourd_soft_loss_grad_modes(
    int fold, int sampler, int sampler_iters, const float* params, uint32_t seed,
    const int* layout, int n_zero, const int* zero_idx, const float* zero_val, int width,
    int height, int row0, int n_rows, int samples, int reflections, float small_indent,
    float light_coefficient, const float* target, const float* alpha, float scale, float* sums,
    uint32_t* row_b, float* grad_parts, double* loss_parts, float* grad_out, float* loss_out,
    float* alpha_cot, const int* hints, const float* keep, void* stream) {
  const Layout L = layout_from(layout);
  const int n_cols = grad_scratch_cols(L, width, n_rows, 2);
  const int mode = mode_of(sampler, sampler_iters);
  ZeroMap zm;
  int obj = -1;
  if (n_cols < 0 || mode < 0 || bad_shape(L, height, row0, n_rows, samples, reflections) ||
      !zero_map_from(L, n_zero, zero_idx, zero_val, samples, zm, obj)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Under the literal folds both rows are swept whole.
  if (fold != kFoldFast) obj = -1;
  Hints H;
  const auto s = static_cast<cudaStream_t>(stream);
  return with_modes_fold(fold, mode, L, hints, H, [&](auto fold_tag) {
    return k6_launch<decltype(fold_tag)>(params, seed, L, H, zm, obj, width, height, row0,
                                         n_rows, samples, reflections, small_indent,
                                         light_coefficient, target, alpha, scale, sums, row_b,
                                         grad_parts, loss_parts, grad_out, loss_out, alpha_cot,
                                         keep, n_cols / 2, n_cols, s);
  });
}
