// Hand-written adjoint of the path tracer, and the per-pixel bodies of the
// gradient kernels built on it: the value-and-grad kernel (gradkernel.cu,
// K4), the light-VJP kernel (gradkernel.cu, K5) and the fused soft
// value-and-grad kernel (softkernel.cu, K6).
//
// Like the JAX package's kernels, they differentiate the estimator at fixed
// RNG (the JAX package's diff.py:8-24): uniforms are constants, hit/miss
// and mirror/diffuse decisions stay at their sampled outcomes, and the
// cotangents flow through the continuous geometry and shading. Neither
// CUDA nor the card has autodiff, so the adjoint is written by hand: each
// partial below is derived from the line of the plain torch pipeline
// (models/renderer.py, models/scene.py, ops/sky.py, ops/fastmath.py,
// ops/vec4.py) that it differentiates, and names it.
//
// Per pixel the work is two passes:
//   pass 1: trace every sample (trace.cuh, the forward kernel's own code,
//           so the light is bitwise K1's); the kernel's loss turns the
//           light into the cotangent of every sample's light (g_light).
//   pass 2, the pixel sweep: per sample, re-trace while recording each
//           bounce (ray, hit, throughput, scatter outcome), then sweep the
//           records in reverse, accumulating parameter cotangents. Bounce 0
//           is shared by all samples, so the cotangents of its outputs sum
//           over the samples and go through bounce 0, the primary ray and
//           the camera once per pixel.
// K4 runs both passes, K5 only the sweep (its g_light is an input), K6
// pass 1 on two parameter rows and the sweep on each.
//
// This header uses no CUDA API beyond what trace.cuh does, so the tests
// compile it for the host behind a shim header and hold it against torch
// autograd (tests/test_torch_adjoint_host.py).
#pragma once

#include "trace.cuh"

namespace {

// The sizes of the per-thread arrays come from ops/cuda/build.py (its
// DEFINES), which the Python wrappers read too.
#if !defined(FOURD_K4_MAX_PARAMS) || !defined(FOURD_K4_MAX_BOUNCES) || \
    !defined(FOURD_K6_MAX_ZERO_SLOTS)
#error "build with ops/cuda/build.py, which defines FOURD_K4_MAX_* and FOURD_K6_MAX_ZERO_SLOTS"
#endif
constexpr int kMaxParams = FOURD_K4_MAX_PARAMS;  // per-thread cotangent array
constexpr int kMaxBounces = FOURD_K4_MAX_BOUNCES;  // per-sample bounce records
// Packed slots K6's second row may overwrite (zero_object of a sphere
// rewrites one radius; a composite rewrites a few).
constexpr int kMaxZeroSlots = FOURD_K6_MAX_ZERO_SLOTS;

__device__ __forceinline__ V3 sub3(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ void acc4(float* g, V4 v) {
  g[0] += v.x;
  g[1] += v.y;
  g[2] += v.z;
  g[3] += v.w;
}
__device__ __forceinline__ void acc3(float* g, V3 v) {
  g[0] += v.x;
  g[1] += v.y;
  g[2] += v.z;
}

// d/dx of the polynomial arccos of ops/fastmath.py:94-98 for |x| < 1:
// arccos(x) = arctan2(s, x), s = sqrt(clamp_min((1 - x)(1 + x), 0)).
__device__ float arccos_grad(float x) {
  if (x == 0.0f) return 0.0f;  // arctan2 at x == 0 is a constant (fastmath.py:89)
  float s = sqrtf(fmaxf((1.0f - x) * (1.0f + x), 0.0f));
  float t = s / x;  // fastmath.py:82, base = arctan(y / safe_x)
  // arctan(t) (fastmath.py:70-77): out = sgn(t) * (big ? pi/2 - core : core),
  // core = atan_unit(big ? 1/|t| : |t|); atan_unit(q) = p(q^2) q (:65-67).
  float ax = fabsf(t);
  bool big = ax > 1.0f;
  float inv = 1.0f / (big ? ax : 1.0f);
  float q = big ? inv : ax;
  float u = q * q;
  float p = kAtan[9];
  float dp = 9.0f * kAtan[9];
  for (int i = 8; i >= 0; --i) p = p * u + kAtan[i];
  for (int i = 8; i >= 1; --i) dp = dp * u + static_cast<float>(i) * kAtan[i];
  float dcore = p + 2.0f * u * dp;                  // d(p(q^2) q)/dq
  float dq = big ? -dcore * inv * inv : dcore;      // q = 1/|t| or |t|
  float datan = big ? -dq : dq;                     // pi/2 - core
  datan = datan * sign_of(t) * (t < 0.0f ? -1.0f : 1.0f);  // |t| and the final sign
  // t = s / x: dt/ds = 1/x, dt/dx = -t/x; s = sqrt(w), w = (1-x)(1+x).
  float g_s = datan / x;
  float g_x = -datan * t / x;
  float g_w = g_s * 0.5f / s;
  return g_x + g_w * (1.0f - x) - g_w * (1.0f + x);
}

// Adjoint of final_light (ops/sky.py:35-54) for a ray d with light
// cotangent g_out: adds to the environment's slots of g and to g_d.
__device__ void final_light_adj(const float* P, const Layout& L, V4 d, V3 g_out, float* g,
                                V4& g_d) {
  const float* env = P + L.env;
  float* g_env = g + L.env;
  V4 drct = ld4(env);
  float angular_size = env[4];
  V3 light = ld3(env + 5);
  float sharpness = env[8];
  V3 sky = ld3(env + 9);
  float len_d = sqrtf(dot4(d, d));
  float len_s = sqrtf(dot4(drct, drct));
  float den = len_d * len_s;
  float cos_raw = dot4(d, drct) / den;                   // sky.py:39
  float cos_dev = fminf(fmaxf(cos_raw, -1.0f), 1.0f);    // sky.py:40
  bool interior = fabsf(cos_dev) < 1.0f;
  float deviation = interior ? arccos(cos_dev) : (cos_dev > 0.0f ? 0.0f : kPi);
  if (!(deviation < angular_size)) {  // sky.py:53-54: the sky alone
    acc3(g_env + 9, g_out);
    return;
  }
  float k = deviation / angular_size;                    // sky.py:48
  float denom = 1.0f - sharpness * k;                    // sky.py:50
  bool guarded = fabsf(denom) < kTiny12;                 // sky.py:51's where: no gradient
  float q = guarded ? kTiny12 : denom;
  float num = sharpness * sharpness * k;
  float m = num / q + 1.0f;
  float rest_k = 1.0f - k;
  float k2 = m * rest_k;
  // blended = light * k2 + sky * (1 - k2)                  sky.py:52
  acc3(g_env + 5, mul3s(g_out, k2));
  acc3(g_env + 9, mul3s(g_out, 1.0f - k2));
  float g_k2 = dot3(g_out, light) - dot3(g_out, sky);
  // k2 = (s*s*k / q + 1) * (1 - k)                         sky.py:51
  float g_m = g_k2 * rest_k;
  float g_k = -g_k2 * m;
  float g_num = g_m / q;
  float g_denom = guarded ? 0.0f : -g_m * num / (q * q);
  float g_sharp = 2.0f * sharpness * k * g_num - k * g_denom;
  g_k += sharpness * sharpness * g_num - sharpness * g_denom;
  g_env[8] += g_sharp;
  // k = deviation / angular_size                           sky.py:48
  g_env[4] += -g_k * k / angular_size;
  float g_dev = g_k / angular_size;
  // deviation = where(interior, arccos(cos), const); clamp passes [-1, 1].
  float g_cos = interior ? g_dev * arccos_grad(cos_dev) : 0.0f;
  if (!(cos_raw >= -1.0f && cos_raw <= 1.0f)) g_cos = 0.0f;
  // cos = dot(d, drct) / (|d| |drct|)                      sky.py:39
  float g_dot = g_cos / den;
  float g_den = -g_cos * cos_raw / den;
  float g_len_d = g_den * len_s;
  float g_len_s = g_den * len_d;
  g_d = add4(g_d, add4(mul4s(drct, g_dot), mul4s(d, g_len_d / len_d)));
  acc4(g_env, add4(mul4s(d, g_dot), mul4s(drct, g_len_s / len_s)));
}

// Adjoint of a hit's normal and distance (models/scene.py:63-142) and of
// its material: only the winner receives the cotangents of the fold's
// best distance and of the resolved normal, glow and color; refl_prob only
// enters a comparison and gets none. A zero-radius sphere never wins (its
// discriminant is never positive), so it never receives any.
__device__ void hit_adj(const float* P, const Layout& L, V4 o, V4 d, const Hit& h, float g_dist,
                        V4 g_norm, float g_glow, V3 g_color, float* g, V4& g_o, V4& g_d) {
  if (h.idx < L.n_spaces) {
    const int base = L.spaces + kSpaceFloats * h.idx;
    const float* sp = P + base;
    V4 p = ld4(sp);
    V4 n = ld4(sp + 4);
    float dot_vn = dot4(p, n) - dot4(o, n);                // scene.py:78-81
    float dn = dot4(d, n);                                 // scene.py:80
    float flip = -sign_of(dot_vn);                         // scene.py:88, no gradient
    // norm = flip * n                                      scene.py:89
    V4 g_n = mul4s(g_norm, flip);
    // dist = dot_vn / dn on a hit                          scene.py:84
    float g_dot_vn = g_dist / dn;
    float g_dn = -g_dist * h.dist / dn;
    g_n = add4(g_n, add4(mul4s(sub4(p, o), g_dot_vn), mul4s(d, g_dn)));
    g_o = sub4(g_o, mul4s(n, g_dot_vn));
    g_d = add4(g_d, mul4s(n, g_dn));
    acc4(g + base, mul4s(n, g_dot_vn));
    acc4(g + base + 4, g_n);
    g[base + 8] += g_glow;
    acc3(g + base + 10, g_color);
    return;
  }
  const int base = L.spheres + kSphereFloats * (h.idx - L.n_spaces);
  const float* s = P + base;
  V4 c = ld4(s);
  float r = s[4];
  float r2 = r * r;                                        // scene.py:95
  V4 po = sub4(c, o);                                      // scene.py:96
  float b_raw = dot4(po, d);                               // scene.py:97
  float l2 = dot4(po, po) + kTiny37;                       // scene.py:98
  bool degenerate = l2 < kSmall2;
  float b = degenerate ? 0.0f : b_raw;                     // scene.py:100
  bool near = l2 > r2;                                     // scene.py:106
  float disc = r2 - (l2 - b * b);                          // scene.py:102
  float sq = sqrtf(disc);                                  // a hit is never tangent
  float inv_r = 1.0f / fmaxf(r, kTiny30);                  // scene.py:112
  float scale = near ? -inv_r : inv_r;
  V4 hit_p = add4(o, mul4s(d, h.dist));                    // scene.py:131, masked dist
  // norm = (c - hit_p) * scale                             scene.py:114
  V4 g_c = mul4s(g_norm, scale);
  V4 g_hit_p = mul4s(g_norm, -scale);
  float g_scale = dot4(g_norm, sub4(c, hit_p));
  g_o = add4(g_o, g_hit_p);
  g_d = add4(g_d, mul4s(g_hit_p, h.dist));
  g_dist += dot4(g_hit_p, d);
  float g_inv_r = near ? -g_scale : g_scale;
  float g_r = r >= kTiny30 ? -g_inv_r * inv_r * inv_r : 0.0f;  // clamp_min passes r >= 1e-30
  // dist = near ? b - sq : b + sq                          scene.py:107
  float g_b = g_dist;
  float g_sq = near ? -g_dist : g_dist;
  float g_disc = g_sq * 0.5f / sq;                         // scene.py:104-105
  g_r += 2.0f * r * g_disc;                                // disc = r2 - (l2 - b*b)
  float g_l2 = -g_disc;
  g_b += 2.0f * b * g_disc;
  float g_b_raw = degenerate ? 0.0f : g_b;
  V4 g_po = add4(mul4s(d, g_b_raw), mul4s(po, 2.0f * g_l2));
  g_d = add4(g_d, mul4s(po, g_b_raw));
  g_c = add4(g_c, g_po);
  g_o = sub4(g_o, g_po);
  acc4(g + base, g_c);
  g[base + 4] += g_r;
  g[base + 5] += g_glow;
  acc3(g + base + 7, g_color);
}

// Adjoint of reflect(d, n) = d - n * (2 dot(d, n))          ops/vec4.py:109-111
__device__ __forceinline__ void reflect_adj(V4 d, V4 n, V4 g_out, V4& g_d, V4& g_n) {
  float dn = dot4(d, n);
  float ng = dot4(n, g_out);
  g_d = add4(g_d, sub4(g_out, mul4s(n, 2.0f * ng)));
  g_n = sub4(g_n, add4(mul4s(g_out, 2.0f * dn), mul4s(d, 2.0f * ng)));
}

// Adjoint of redirect(v, n) w.r.t. n; v, a sampled direction, is a
// constant                                                 ops/vec4.py:114-118
__device__ __forceinline__ void redirect_adj(V4 v, V4 n, V4 g_out, V4& g_n) {
  float vn = dot4(v, n);
  if (vn >= 0.0f) return;
  float ng = dot4(n, g_out);
  g_n = sub4(g_n, add4(mul4s(g_out, 2.0f * vn), mul4s(v, 2.0f * ng)));
}

// The reverse sweep of one sample's recorded bounces 1..n (renderer.py
// trace_rays / _shade, :194-211). g_light is the sample's light cotangent.
// Returns the cotangents of the bounce-1 ray origin and direction and of
// the throughput entering bounce 1.
__device__ void sample_adj(const float* P, const Layout& L, const Bounce* rec, int n_rec,
                           int reflections, float small_indent, V3 g_light, float* g, V4& g_o,
                           V4& g_d, V3& g_thr) {
  g_o = {0.0f, 0.0f, 0.0f, 0.0f};
  g_d = {0.0f, 0.0f, 0.0f, 0.0f};
  g_thr = {0.0f, 0.0f, 0.0f};
  for (int i = n_rec - 1; i >= 0; --i) {
    const Bounce& r = rec[i];
    const bool last = i == reflections - 1;  // the last bounce only shades
    V4 g_o_in = {0.0f, 0.0f, 0.0f, 0.0f};
    V4 g_d_in = {0.0f, 0.0f, 0.0f, 0.0f};
    if (!r.h.hit) {
      // result += throughput * final_light(d); the lane ends    renderer.py:186-188
      V3 g_thr_in = {0.0f, 0.0f, 0.0f};
      if (L.env_enabled) {
        g_thr_in = mul3(g_light, final_light(P + L.env, r.d));
        final_light_adj(P, L, r.d, mul3(g_light, r.throughput), g, g_d_in);
      }
      g_o = g_o_in;
      g_d = g_d_in;
      g_thr = g_thr_in;
      continue;
    }
    // result += color * glow * throughput                   renderer.py:190
    const V3 color = r.h.color;
    const float glow = r.h.glow;
    V3 g_thr_in = mul3(g_light, mul3s(color, glow));
    V3 g_color = mul3s(mul3(g_light, r.throughput), glow);
    float g_glow = dot3(mul3(g_light, r.throughput), color);
    float g_dist = 0.0f;
    V4 g_norm = {0.0f, 0.0f, 0.0f, 0.0f};
    if (!last) {
      // throughput' = throughput * color                    renderer.py:204
      g_thr_in = add3(g_thr_in, mul3(g_thr, color));
      g_color = add3(g_color, mul3(g_thr, r.throughput));
      // o' = o + d * dist + norm * small_indent             renderer.py:205
      g_o_in = g_o;
      g_d_in = mul4s(g_o, r.h.dist);
      g_dist = dot4(g_o, r.d);
      g_norm = mul4s(g_o, small_indent);
      // d' = mirror ? reflect(d, norm) : redirect(v, norm)  renderer.py:160-171
      if (r.mirror) {
        reflect_adj(r.d, r.h.norm, g_d, g_d_in, g_norm);
      } else {
        redirect_adj(r.v, r.h.norm, g_d, g_norm);
      }
    }
    hit_adj(P, L, r.o, r.d, r.h, g_dist, g_norm, g_glow, g_color, g, g_o_in, g_d_in);
    g_o = g_o_in;
    g_d = g_d_in;
    g_thr = g_thr_in;
  }
}

// Pass 1: the pixel's light summed over its samples, bitwise the forward
// kernel's sum.
__device__ V3 pixel_light_sum(const float* P, const Layout& L, const Pixel& p, int samples,
                              int reflections, float small_indent, uint32_t seed) {
  V3 acc = {0.0f, 0.0f, 0.0f};
  for (int s = 0; s < samples; ++s) {
    acc = add3(acc, trace_sample<false>(P, L, p, s, seed, reflections, small_indent, nullptr,
                                        nullptr, nullptr, nullptr));
  }
  return acc;
}

// Pass 2, the pixel sweep: adds to g the parameter cotangents of the
// pixel's sample lights, each with cotangent g_light (the cotangent of
// the light summed over samples).
__device__ void pixel_sweep(const float* P, const Layout& L, const Pixel& p, int view,
                            int samples, int reflections, float small_indent, uint32_t seed,
                            V3 g_light, float* g) {
  // Each sample's reverse sweep; bounce 0's output cotangents sum over the
  // samples. Every sample's light starts from result0.
  const V3 g_result0 = mul3s(g_light, static_cast<float>(samples));
  V3 g_thr0 = {0.0f, 0.0f, 0.0f};
  V4 g_o0 = {0.0f, 0.0f, 0.0f, 0.0f};
  V4 g_mirrored0 = {0.0f, 0.0f, 0.0f, 0.0f};
  V4 g_norm0 = {0.0f, 0.0f, 0.0f, 0.0f};
  if (reflections > 0 && p.h0.hit) {
    Bounce rec[kMaxBounces];
    for (int s = 0; s < samples; ++s) {
      int n_rec = 0;
      bool mirror0 = false;
      V4 v0 = {0.0f, 0.0f, 0.0f, 0.0f};
      trace_sample<true>(P, L, p, s, seed, reflections, small_indent, rec, &n_rec, &mirror0, &v0);
      V4 g_o, g_d;
      V3 g_thr;
      sample_adj(P, L, rec, n_rec, reflections, small_indent, g_light, g, g_o, g_d, g_thr);
      g_o0 = add4(g_o0, g_o);
      g_thr0 = add3(g_thr0, g_thr);
      // bounce 0's direction update                         renderer.py:174-177
      if (mirror0) {
        g_mirrored0 = add4(g_mirrored0, g_d);
      } else {
        redirect_adj(v0, p.h0.norm, g_d, g_norm0);
      }
    }
  }

  // bounce 0 (renderer.py:143-157), then the primary ray.
  V4 g_d0 = {0.0f, 0.0f, 0.0f, 0.0f};
  V4 g_focus = {0.0f, 0.0f, 0.0f, 0.0f};
  if (!p.h0.hit) {
    if (L.env_enabled) final_light_adj(P, L, p.d0, g_result0, g, g_d0);
    g_focus = g_o0;
  } else {
    const Hit& h = p.h0;
    // result0 = color * glow; throughput0 = color           renderer.py:152-153
    V3 g_color = add3(mul3s(g_result0, h.glow), g_thr0);
    float g_glow = dot3(g_result0, h.color);
    // o0 = focus + d0 * dist + norm * small_indent          renderer.py:154
    g_focus = g_o0;
    g_d0 = mul4s(g_o0, h.dist);
    float g_dist = dot4(g_o0, p.d0);
    g_norm0 = add4(g_norm0, mul4s(g_o0, small_indent));
    // mirrored0 = reflect(d0, norm0)                        renderer.py:156
    reflect_adj(p.d0, h.norm, g_mirrored0, g_d0, g_norm0);
    hit_adj(P, L, p.focus, p.d0, h, g_dist, g_norm0, g_glow, g_color, g, g_focus, g_d0);
  }
  acc4(g + L.focus, g_focus);

  // d0 = a / |a|, a = vec_to_mtr + top * my + right * mx   renderer.py:119-127, vec4.py:105
  const V4 a = p.a;
  const float len = sqrtf(dot4(a, a));
  const float inv_len = 1.0f / len;
  const float g_inv = dot4(g_d0, a);
  const float g_len = -g_inv * inv_len * inv_len;
  const V4 g_a = add4(mul4s(g_d0, inv_len), mul4s(a, g_len / len));
  acc4(g + L.vec_to_mtr, g_a);
  const int V = L.n_views;
  const V4 top = {P[L.top + view], P[L.top + V + view], P[L.top + 2 * V + view],
                  P[L.top + 3 * V + view]};
  const V4 right = {P[L.right + view], P[L.right + V + view], P[L.right + 2 * V + view],
                    P[L.right + 3 * V + view]};
  g[L.top + view] += g_a.x * p.my;
  g[L.top + V + view] += g_a.y * p.my;
  g[L.top + 2 * V + view] += g_a.z * p.my;
  g[L.top + 3 * V + view] += g_a.w * p.my;
  g[L.right + view] += g_a.x * p.mx;
  g[L.right + V + view] += g_a.y * p.mx;
  g[L.right + 2 * V + view] += g_a.z * p.mx;
  g[L.right + 3 * V + view] += g_a.w * p.mx;
  // mx = (scr_x - 0.5) * mtr_width; my = (0.5 - scr_y) * mtr_height
  g[L.mtr_width] += dot4(g_a, right) * (p.scr_x - 0.5f);
  g[L.mtr_height] += dot4(g_a, top) * (0.5f - p.scr_y);
}

// color = 1 - 1 / u, u = c * light + 1                     ops/sky.py:57-60
__device__ __forceinline__ V3 tone_denominator(V3 light, float light_coefficient) {
  return {light_coefficient * light.x + 1.0f, light_coefficient * light.y + 1.0f,
          light_coefficient * light.z + 1.0f};
}
__device__ __forceinline__ V3 tone_color(V3 u) {
  return {1.0f - 1.0f / u.x, 1.0f - 1.0f / u.y, 1.0f - 1.0f / u.z};
}

// K4: loss and parameter cotangents of one pixel; adds to g and returns
// the pixel's unscaled loss, sum over channels of (color - target)^2.
__device__ float pixel_loss_grad(const float* P, const Layout& L, int view, int px, int py,
                                 int width, int height, int samples, int reflections,
                                 float small_indent, float light_coefficient, uint32_t seed,
                                 const float* target, float* g) {
  const Pixel p = setup_pixel(P, L, view, px, py, width, height, small_indent);
  const V3 acc = pixel_light_sum(P, L, p, samples, reflections, small_indent, seed);
  const float inv = 1.0f / static_cast<float>(samples);
  const V3 light = mul3s(acc, inv);
  const V3 u = tone_denominator(light, light_coefficient);
  const V3 color = tone_color(u);
  const V3 diff = sub3(color, ld3(target));
  const float loss = diff.x * diff.x + diff.y * diff.y + diff.z * diff.z;
  // d loss / d acc = 2 (color - t) * c / u^2 * (1 / samples): the cotangent
  // of every sample's light.
  const V3 g_light = {2.0f * diff.x * light_coefficient / (u.x * u.x) * inv,
                      2.0f * diff.y * light_coefficient / (u.y * u.y) * inv,
                      2.0f * diff.z * light_coefficient / (u.z * u.z) * inv};
  pixel_sweep(P, L, p, view, samples, reflections, small_indent, seed, g_light, g);
  return loss;
}

// K5: adds to g the parameter cotangents of the pixel's MEAN light for the
// given light cotangent cot (3 floats); light = sum / samples, so every
// sample's light carries cot / samples (gradkernel.py:419-424).
__device__ void pixel_light_vjp(const float* P, const Layout& L, int view, int px, int py,
                                int width, int height, int samples, int reflections,
                                float small_indent, uint32_t seed, const float* cot, float* g) {
  const Pixel p = setup_pixel(P, L, view, px, py, width, height, small_indent);
  const float inv = 1.0f / static_cast<float>(samples);
  const V3 g_light = mul3s(ld3(cot), inv);
  pixel_sweep(P, L, p, view, samples, reflections, small_indent, seed, g_light, g);
}

// The static (packed slot, value) pairs that turn the params row into the
// soft kernel's second row (models/params.py soft_zero_map).
struct ZeroMap {
  int n;
  int idx[kMaxZeroSlots];
  float val[kMaxZeroSlots];
};

// K6: one pixel of the soft-silhouette loss. Row a is the scene (Pa), row
// b the same scene with its object zeroed (Pb, Pa with zm applied); both
// are traced at the same seed and blended with the pixel's coverage alpha,
// img = alpha * color_a + (1 - alpha) * color_b (gradkernel.py:1250-1261).
// Adds the parameter cotangents of both rows to g (row b's cotangents of
// the zm slots are dropped: those slots are constants of row b,
// gradkernel.py:1268-1271), sets *g_alpha to d loss / d alpha, and returns
// the pixel's unscaled loss, sum over channels of (img - target)^2.
__device__ float pixel_soft_loss_grad(const float* Pa, const float* Pb, const Layout& L,
                                      const ZeroMap& zm, int view, int px, int py, int width,
                                      int height, int samples, int reflections,
                                      float small_indent, float light_coefficient,
                                      uint32_t seed, const float* target, float alpha, float* g,
                                      float* g_alpha) {
  const Pixel pa = setup_pixel(Pa, L, view, px, py, width, height, small_indent);
  const Pixel pb = setup_pixel(Pb, L, view, px, py, width, height, small_indent);
  const V3 acc_a = pixel_light_sum(Pa, L, pa, samples, reflections, small_indent, seed);
  const V3 acc_b = pixel_light_sum(Pb, L, pb, samples, reflections, small_indent, seed);
  const float inv = 1.0f / static_cast<float>(samples);
  const V3 u_a = tone_denominator(mul3s(acc_a, inv), light_coefficient);
  const V3 u_b = tone_denominator(mul3s(acc_b, inv), light_coefficient);
  const V3 ca = tone_color(u_a);
  const V3 cb = tone_color(u_b);
  const V3 t = ld3(target);
  const float beta = 1.0f - alpha;
  // img = alpha * ca + (1 - alpha) * cb                    diff.py:401
  const V3 diff = {alpha * ca.x + beta * cb.x - t.x, alpha * ca.y + beta * cb.y - t.y,
                   alpha * ca.z + beta * cb.z - t.z};
  const float loss = diff.x * diff.x + diff.y * diff.y + diff.z * diff.z;
  // d loss / d alpha = sum_ch 2 (img - t) (ca - cb)
  *g_alpha = 2.0f * diff.x * (ca.x - cb.x) + 2.0f * diff.y * (ca.y - cb.y) +
             2.0f * diff.z * (ca.z - cb.z);
  // d loss / d acc_a = 2 (img - t) alpha c / u_a^2 / samples; row b with 1 - alpha.
  const V3 g_a = {2.0f * diff.x * alpha * light_coefficient / (u_a.x * u_a.x) * inv,
                  2.0f * diff.y * alpha * light_coefficient / (u_a.y * u_a.y) * inv,
                  2.0f * diff.z * alpha * light_coefficient / (u_a.z * u_a.z) * inv};
  const V3 g_b = {2.0f * diff.x * beta * light_coefficient / (u_b.x * u_b.x) * inv,
                  2.0f * diff.y * beta * light_coefficient / (u_b.y * u_b.y) * inv,
                  2.0f * diff.z * beta * light_coefficient / (u_b.z * u_b.z) * inv};
  pixel_sweep(Pa, L, pa, view, samples, reflections, small_indent, seed, g_a, g);
  float kept[kMaxZeroSlots];
  for (int i = 0; i < zm.n; ++i) kept[i] = g[zm.idx[i]];
  pixel_sweep(Pb, L, pb, view, samples, reflections, small_indent, seed, g_b, g);
  for (int i = 0; i < zm.n; ++i) g[zm.idx[i]] = kept[i];
  return loss;
}

}  // namespace
