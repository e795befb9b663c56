// Gradient kernels for Hopper (sm_90a) over the hand-written adjoint of
// adjoint.cuh:
//
// K4, the value-and-grad launch: the masked tone-mapped MSE of a render
// against a target, and its cotangent for every packed scene, environment
// and camera parameter. Replaces fourd_ray_tracing_tpu/ops/pallas/
// gradkernel.py::_loss_grad_kernel (launched by _launch).
//
// K5, the light-VJP launch: the VJP of the mean light for a given
// per-pixel light cotangent, so that any torch loss over rendered light
// trains on the kernels (diff.RenderLight, diff.render_light_pair).
// Replaces gradkernel.py::_light_vjp_kernel (launched by
// _render_light_vjp_jit and, with frame_params, by
// _render_light_vjp_multi_jit). A launch takes F parameter rows (row stride
// 0 for one scene, P for F same-structure scenes, as K2 does) and an
// (F, V, H, W, 3) cotangent, at one seed, and returns (F, P).
//
// K6, the fused soft-silhouette value-and-grad launch: both rows of the
// soft loss (the scene, and the same scene with one object zeroed into a
// guaranteed miss), their blend by the per-pixel coverage alpha, the MSE
// against a target, every packed parameter's cotangent and the cotangent
// of alpha. Replaces gradkernel.py::_soft_loss_grad_kernel (launched by
// _soft_launch). Like it, alpha is an input and its cotangent an output:
// the coverage that makes alpha is plain torch outside the kernel
// (diff.object_coverage), and autograd carries the alpha cotangent back
// through it (diff.SoftImageLoss). All its outputs are scaled by
// 1 / (V*H*W*3) (gradkernel.py:1448-1452).
//
// With a row offset all three are K3's sharded launches
// (sharded_loss_and_grad_pallas, sharded_render_light_vjp_pallas_multi,
// sharded_soft_loss_and_grad_pallas): a launch covers image rows
// [row0, row0 + n_rows) only, its target, cotangent, alpha and alpha
// cotangent are that block of rows, and its sums are that block's part of
// the whole image's (the scale stays the global one). A thread's pixel
// keeps its global coordinates for the math; only its reads and writes
// index the block.
//
// Design. Each launch runs a pass-1 kernel, a sweep and sum_parts_kernel,
// one thread per pixel (and frame or row), the packed parameters in shared
// memory:
//   pass 1: loss_cot_kernel (K4: every frame's pass 1, the loss and the
//           cotangent of the mean light) or soft_sum_kernel (K6: each row's
//           light summed over samples, the two rows in row blocks, as K2
//           runs them). Pass 1 is K1's trace (bitwise its light) at K1's
//           occupancy. K5's cotangent is its input.
//   sweep:  sweep_kernel (K4, K5): per (row, pixel) the re-trace of every
//           sample (K4 on a grid too small to fill the card: of a chunk
//           of the pixel's samples a block, gradlaunch.cuh sweep_kernel)
//           with its bounce records in registers (the kMainBounces
//           instance, loops unrolled; any other count runs the generic
//           kMaxBounces instance, records in local memory) and the reverse
//           sweep, each step's cotangents (one primitive's, the
//           environment's or a camera vector's slots) added to the
//           thread's own column of P floats in shared memory (reduce.cuh
//           ColumnAcc). K6 sweeps its rows in two kernels: soft_row_a_kernel
//           blends the rows' sums into the loss, alpha's cotangent and each
//           row's light cotangent and sweeps row a; where a pixel's bounce 0
//           misses the zeroed sphere, row b traces as row a does but for the
//           samples whose path hits it, so row a's sweep carries row b's
//           cotangent on the others and leaves those samples in scratch.
//           soft_row_b_kernel then sweeps only them, or row b whole where
//           bounce 0 hits the sphere: about half a row instead of one.
// The blocks sum their columns, and their losses in double, in a fixed
// order into one column of partials each, and sum_parts_kernel sums each
// row in a fixed order in double and applies the scale: no atomics, two
// launches give bitwise equal results. Padded threads compute nothing and
// contribute zeros.
//
// What bounds them: the trace's and the adjoint's arithmetic, at the
// occupancy the sweeps' registers allow. ptxas keeps the records and the
// adjoint in registers with no spill at 200-240 registers a thread, four
// blocks of two warps a SM (asking for five blocks caps it at 168
// registers, spills and measured slower). The columns, (P + 1) x 65 floats
// a block (40 KB at the room's P = 154), cap P (FOURD_K4_MAX_PARAMS; above
// 48 KB a launch opts in to more shared memory). Pass 1 runs apart: fused
// into the sweep it ran at the sweep's occupancy and cost 1.5-2.2 ms more
// than its own kernel's 1.0 at the bench shape (PERF.md).
//
// Under the freeze_hints contract (diff.with_frozen_hints) a launch takes
// the forward's static hints (a trace.cuh Hints descriptor): every kernel
// of it folds over K1's fold table, which each block builds from its own
// params row after them in shared memory (K6's row b from the row with the
// zero map applied), so pass 1's light is K1's hinted light and the
// sweep's re-trace finds pass 1's hits and distances bitwise
// (trace.cuh GradTableFold: intersect_table, the winner numbered as
// intersect numbers it). The reverse partials stay those of the unhinted
// fold over the packed params: the hinted fold finds the same hits, and
// the contract defines the hyperplane normals' gradients zero, which
// sum_parts_kernel writes from the packed mask (keep) after the fixed-order
// sums. The instances: the room's 4 wall pairs on axes x, y, z, w
// (RoomFold, at the main bounce count), any other hint pattern (AnyFold,
// e.g. sphere_plane_light's single plane, or a room whose dropped wall
// turned its pairs off), and without hints the unhinted ParamsFold ones.
//
// A scene with composite primitives (cylinders, the duocylinder, the
// hypercube, the tiger) folds over K1's composite table in K4, K5 and K6,
// hinted or not (GradCompositeFold: the winner numbered with its branch,
// which the adjoint's composite partials read, adjoint.cuh composite_adj);
// those instances live in gradcomposite.cu (K4, K5) and softcomposite.cu
// (K6), the kernels of all three in gradlaunch.cuh. K6's row b zeroes a
// composite by its radii (0 for the circle families, -1 for the
// hypercube: diff.zero_object), so row b's table, built from row b's
// params, folds it to a guaranteed miss; its zero map names no sphere
// (zero_map_object -1), so both rows are swept whole.
//
// K1's other configurations (the kepler and newton samplers, the literal
// spec and trig folds, a hypercube without generators) launch the same
// kernels' modes instances from gradmodes.cu and softmodes.cu (modes.cuh);
// these production instances
// run per-sample streams, the poly sampler and the fast fold.

#include "gradlaunch.cuh"

// Columns of a gradient launch's partials over n_rows image rows
// (gradlaunch.cuh grad_scratch_cols).
extern "C" int fourd_grad_scratch_cols(const int* layout, int width, int n_rows, int n_frames) {
  return grad_scratch_cols(layout_from(layout), width, n_rows, n_frames);
}

// The sweeps' blocks a SM that their launch bounds ask for (reduce.cuh
// kGradMinBlocks), which K4's sample split aims its waves at
// (ops/cuda/gradkernel.py sweep_split).
extern "C" int fourd_grad_min_blocks() { return kGradMinBlocks; }

// The gradient launches below take ``hints``, the host int[kHintInts]
// descriptor of the static hints (ops/cuda/megakernel.py hint_table), or
// null for none, and ``keep``, the device's packed 0/1 mask of P floats of
// the freeze_hints contract (models/params.py freeze_mask; sum_parts_kernel
// writes the slots it zeroes as 0), or null. K4, K5 and K6 hand a
// descriptor with composites (hinted, or n_singles -1 and axis hints -1
// without the contract) to their composite folds (gradcomposite.cu,
// softcomposite.cu), and every launch refuses one the table cannot hold
// (cudaErrorInvalidValue).

// K4 on ``stream``: loss (1,) and grad (P,) float32, both scaled by
// ``scale``, of image rows [row0, row0 + n_rows) of H, from params (P,)
// float32, seeds (F,) uint32 and that block of the target (V, n_rows, W, 3)
// float32, its sweep in ``split`` sample chunks a pixel (gradlaunch.cuh
// sweep_kernel; the sum's order of additions alone depends on it).
// g_mean (F, V, n_rows, W, 3) float32, grad_parts (P, n_cols x split)
// float32 and loss_parts (n_cols,) float64 are scratch of the caller's,
// n_cols as fourd_grad_scratch_cols(layout, width, n_rows, n_frames) gives
// it. Returns cudaGetLastError() after each launch.
extern "C" int fourd_loss_grad_launch(const float* params, const uint32_t* seeds, int n_frames,
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
  if (composite_fold(kind)) {
    return fourd_loss_grad_composite(params, seeds, n_frames, split, layout, width, height, row0,
                                     n_rows, samples, reflections, small_indent,
                                     light_coefficient, target, scale, g_mean, grad_parts,
                                     loss_parts, grad_out, loss_out, hints, keep, stream);
  }
  return with_fold(kind, [&](auto fold) {
    return k4_launch<decltype(fold)>(params, seeds, n_frames, split, L, H, width, height, row0,
                                     n_rows, samples, reflections, small_indent,
                                     light_coefficient, target, scale, g_mean, grad_parts,
                                     loss_parts, grad_out, loss_out, keep, n_cols / n_frames,
                                     n_cols, static_cast<cudaStream_t>(stream));
  });
}

// The occupancy of the sweep that fourd_loss_grad_launch runs for this
// layout, bounce count and descriptor (gradlaunch.cuh sweep_occupancy):
// out[0] its resident blocks a SM, out[1] its dynamic shared-memory bytes.
// Launches nothing.
extern "C" int fourd_loss_grad_occupancy(const int* layout, int reflections, const int* hints,
                                         int* out) {
  const Layout L = layout_from(layout);
  if (L.size <= 0 || L.size > kMaxParams || reflections < 0 || reflections > kMaxBounces) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Hints H;
  const FoldKind kind = fold_kind(L, hints, reflections, H);
  if (composite_fold(kind)) {
    return fourd_loss_grad_composite_occupancy(layout, reflections, hints, out);
  }
  return with_fold(kind, [&](auto fold) {
    return sweep_occupancy<decltype(fold)>(L, H, reflections, out);
  });
}

// K5 on ``stream``: grad_out (F, P) float32, the unscaled parameter
// cotangents of each params row's mean light over image rows
// [row0, row0 + n_rows) of H, from params (F rows of P floats,
// ``row_stride`` apart: 0 for one shared row), one seed and that block of
// the cotangent (F, V, n_rows, W, 3) float32. grad_parts (F*P, n_cols)
// float32 is scratch of the caller's, n_cols as
// fourd_grad_scratch_cols(layout, width, n_rows, 1) gives it. Every row
// shares the hints and the mask. Returns cudaGetLastError() after each
// launch.
extern "C" int fourd_light_vjp_launch(const float* params, long long row_stride, int n_params_rows,
                                      uint32_t seed, const int* layout, int width, int height,
                                      int row0, int n_rows, int samples, int reflections,
                                      float small_indent, const float* cot, float* grad_parts,
                                      float* grad_out, const int* hints, const float* keep,
                                      void* stream) {
  const Layout L = layout_from(layout);
  const int n_cols = fourd_grad_scratch_cols(layout, width, n_rows, 1);
  if (n_cols < 0 || bad_shape(L, height, row0, n_rows, samples, reflections) ||
      n_params_rows <= 0 || n_params_rows > 65535 || row_stride < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Hints H;
  const FoldKind kind = fold_kind(L, hints, reflections, H);
  if (composite_fold(kind)) {
    return fourd_light_vjp_composite(params, row_stride, n_params_rows, seed, layout, width,
                                     height, row0, n_rows, samples, reflections, small_indent,
                                     cot, grad_parts, grad_out, hints, keep, stream);
  }
  return with_fold(kind, [&](auto fold) {
    return k5_launch<decltype(fold)>(params, row_stride, n_params_rows, seed, L, H, width, height,
                                     row0, n_rows, samples, reflections, small_indent, cot,
                                     grad_parts, grad_out, keep, n_cols,
                                     static_cast<cudaStream_t>(stream));
  });
}

// K6 on ``stream``: loss (1,), grad (P,) and alpha_cot (V, n_rows, W)
// float32, all scaled by ``scale``, of image rows [row0, row0 + n_rows) of
// H, from params (P,) float32, one seed, the zero map (n_zero slots and
// values, host arrays), and those rows of the target (V, n_rows, W, 3) and
// of alpha (V, n_rows, W) float32. sums (2, V, n_rows, W, 3) float32,
// row_b (V, n_rows, W) uint32, grad_parts (P, n_cols) float32 and
// loss_parts (n_cols,) float64 are scratch of the caller's, n_cols as
// fourd_grad_scratch_cols(layout, width, n_rows, 2) gives it. Both rows
// share the hints (zero_object keeps every wall). Returns
// cudaGetLastError() after each launch.
extern "C" int fourd_soft_loss_grad_launch(const float* params, uint32_t seed, const int* layout,
                                           int n_zero, const int* zero_idx,
                                           const float* zero_val, int width, int height,
                                           int row0, int n_rows, int samples, int reflections,
                                           float small_indent, float light_coefficient,
                                           const float* target, const float* alpha, float scale,
                                           float* sums, uint32_t* row_b, float* grad_parts,
                                           double* loss_parts, float* grad_out, float* loss_out,
                                           float* alpha_cot, const int* hints, const float* keep,
                                           void* stream) {
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
  if (composite_fold(kind)) {
    return fourd_soft_loss_grad_composite(params, seed, layout, n_zero, zero_idx, zero_val, width,
                                          height, row0, n_rows, samples, reflections,
                                          small_indent, light_coefficient, target, alpha, scale,
                                          sums, row_b, grad_parts, loss_parts, grad_out, loss_out,
                                          alpha_cot, hints, keep, stream);
  }
  return with_fold(kind, [&](auto fold) {
    return k6_launch<decltype(fold)>(params, seed, L, H, zm, obj, width, height, row0, n_rows,
                                     samples, reflections, small_indent, light_coefficient,
                                     target, alpha, scale, sums, row_b, grad_parts, loss_parts,
                                     grad_out, loss_out, alpha_cot, keep, n_cols / 2, n_cols,
                                     static_cast<cudaStream_t>(stream));
  });
}
