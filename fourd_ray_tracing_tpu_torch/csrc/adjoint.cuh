// Hand-written adjoint of the path tracer, and the per-pixel bodies of the
// gradient kernels built on it (gradkernel.cu): the value-and-grad kernel
// (K4), the light-VJP kernel (K5) and the fused soft value-and-grad kernel
// (K6).
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
//           bounce (ray, hit primitive and distance, scatter outcome),
//           then sweep the records in reverse. Bounce 0 is shared by all
//           samples, so the cotangents of its outputs sum over the samples
//           and go through bounce 0, the primary ray and the camera once
//           per pixel.
// The gradient kernels run them as two kernels: pass 1 (K4 with its loss,
// loss_cot, which writes each pixel's cotangent of its mean light; K6 each
// row's light sum, which its sweep blends, soft_blend), then the sweep:
// pixel_sweep (K5's cotangent is its input; K6 sweeps each of its rows).
//
// The sweep's parameter cotangents leave it as Slots: one step of one
// thread touches the slots of one primitive (or of the environment, or a
// camera vector) and nothing else; a composite hit's slots, which lie in
// several runs, go as several Slots (composite_adj). The sweep hands each
// step's Slots to an accumulator, a template parameter with one member,
// add(const Slots&), which adds the slots' values to the thread's
// parameter cotangents: on
// the card a per-thread column in shared memory (reduce.cuh ColumnAcc), on
// the host a dense array. The bounce records are a template on the bounce
// count kB: the main paths' count (kMainBounces) is unrolled, so every
// record index is a compile-time constant and the records stay in
// registers; kB == kMaxBounces is the generic instance for any count up to
// it, with the loops rolled.
//
// The literal folds' winners (SpecFold, and a hypercube's cells in
// the fast fold without generators) are resolved and differentiated
// through their own literal test (lit_test, lit_adj); the re-trace runs
// the fold's sampler (trace.cuh kFoldSampler: a Modes fold's the launch's),
// which needs no adjoint.
//
// This header uses no CUDA API beyond what trace.cuh does, so the tests
// compile it for the host behind a shim header, with a dense accumulator,
// and hold it against torch autograd (tests/test_torch_adjoint_host.py).
#pragma once

#include "trace.cuh"

namespace {

// The cap on packed parameters, the bounce counts of the unrolled and the
// generic instance and K6's zero-map slots come from ops/cuda/build.py (its
// DEFINES), which the Python wrappers read too.
#if !defined(FOURD_K4_MAX_PARAMS) || !defined(FOURD_K4_MAX_BOUNCES) || \
    !defined(FOURD_K4_MAIN_BOUNCES) || !defined(FOURD_K6_MAX_ZERO_SLOTS)
#error "build with ops/cuda/build.py, which defines FOURD_K4_* and FOURD_K6_MAX_ZERO_SLOTS"
#endif
constexpr int kMaxParams = FOURD_K4_MAX_PARAMS;  // packed parameters a launch takes
constexpr int kMaxBounces = FOURD_K4_MAX_BOUNCES;  // the generic instance's records per sample
// Packed slots K6's second row may overwrite (zero_object of a sphere
// rewrites one radius; a composite rewrites a few).
constexpr int kMaxZeroSlots = FOURD_K6_MAX_ZERO_SLOTS;
// RenderConfig.reflections_amount of every main-path configuration: the
// bounce count with its own unrolled instance.
constexpr int kMainBounces = FOURD_K4_MAIN_BOUNCES;

__device__ __forceinline__ V3 sub3(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }

// The cotangents of one sweep step: values v[0..n) for the packed slots
// key, key + stride, ..., or nothing when key is -1. At most a hyperplane's
// 13 slots.
constexpr int kSlotsMax = kSpaceFloats;
struct Slots {
  int key, n, stride;
  float v[kSlotsMax];
};
__device__ __forceinline__ Slots no_slots() {
  Slots c;
  c.key = -1;
  c.n = 0;
  c.stride = 1;
  return c;
}
__device__ __forceinline__ void put4(float* v, V4 x) {
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void put3(float* v, V3 x) {
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
}
__device__ __forceinline__ Slots slots4(int key, int stride, V4 x) {
  Slots c;
  c.key = key;
  c.n = 4;
  c.stride = stride;
  put4(c.v, x);
  return c;
}
__device__ __forceinline__ Slots slot1(int key, float x) {
  Slots c;
  c.key = key;
  c.n = 1;
  c.stride = 1;
  c.v[0] = x;
  return c;
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
// cotangent g_out: the environment's 12 slots go to c, the ray's cotangent
// is added to g_d.
__device__ void final_light_adj(const float* P, const Layout& L, V4 d, V3 g_out, Slots& c,
                                V4& g_d) {
  const float* env = P + L.env;
  c.key = L.env;
  c.n = 12;
  c.stride = 1;
  for (int k = 0; k < 12; ++k) c.v[k] = 0.0f;
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
    put3(c.v + 9, g_out);
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
  put3(c.v + 5, mul3s(g_out, k2));
  put3(c.v + 9, mul3s(g_out, 1.0f - k2));
  float g_k2 = dot3(g_out, light) - dot3(g_out, sky);
  // k2 = (s*s*k / q + 1) * (1 - k)                         sky.py:51
  float g_m = g_k2 * rest_k;
  float g_k = -g_k2 * m;
  float g_num = g_m / q;
  float g_denom = guarded ? 0.0f : -g_m * num / (q * q);
  float g_sharp = 2.0f * sharpness * k * g_num - k * g_denom;
  g_k += sharpness * sharpness * g_num - sharpness * g_denom;
  c.v[8] = g_sharp;
  // k = deviation / angular_size                           sky.py:48
  c.v[4] = -g_k * k / angular_size;
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
  put4(c.v, add4(mul4s(d, g_dot), mul4s(drct, g_len_s / len_s)));
}

// Adjoint of a hit's normal and distance (models/scene.py:63-142) and of
// its material: only the winner receives the cotangents of the fold's
// best distance and of the resolved normal, glow and color, in c; refl_prob
// only enters a comparison and gets 0. A zero-radius sphere never wins (its
// discriminant is never positive), so it never receives any.
__device__ void hit_adj(const float* P, const Layout& L, V4 o, V4 d, const Hit& h, float g_dist,
                        V4 g_norm, float g_glow, V3 g_color, Slots& c, V4& g_o, V4& g_d) {
  c.stride = 1;
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
    c.key = base;
    c.n = kSpaceFloats;
    put4(c.v, mul4s(n, g_dot_vn));
    put4(c.v + 4, g_n);
    c.v[8] = g_glow;
    c.v[9] = 0.0f;
    put3(c.v + 10, g_color);
    return;
  }
  const int base = L.spheres + kSphereFloats * (h.idx - L.n_spaces);
  const float* s = P + base;
  V4 ctr = ld4(s);
  float r = s[4];
  float r2 = r * r;                                        // scene.py:95
  V4 po = sub4(ctr, o);                                    // scene.py:96
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
  float g_scale = dot4(g_norm, sub4(ctr, hit_p));
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
  c.key = base;
  c.n = kSphereFloats;
  put4(c.v, g_c);
  c.v[4] = g_r;
  c.v[5] = g_glow;
  c.v[6] = 0.0f;
  put3(c.v + 7, g_color);
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

// One bounce after bounce 0, as the reverse sweep reads it: the ray, the
// hit's primitive and distance, and the scatter outcome. The hit's normal
// and material are rebuilt from the packed row (resolve_hit), the
// throughput before the bounce from the colors of the bounces before it.
struct Bounce {
  V4 o, d, v;
  float dist;
  int idx;
  bool hit, mirror;
};

// Re-trace sample ``s`` (trace.cuh trace_sample's rays and draws, without
// the light, with the fold Fold) while recording bounces 1..R into
// rec[0..n); returns n, and bounce 0's scatter outcome in mirror0 / v0.
// R = reflections.
// The sampler is the fold's (trace.cuh kFoldSampler: a Modes fold's the
// launch's, sampler_arg); it needs no adjoint: its direction depends on the
// hashed uniforms alone.
template <int kB, class Fold = ParamsFold>
__device__ int record_sample(const float* P, const Layout& L, const Pixel& p, int s, uint32_t seed,
                             int R, float small_indent, Bounce (&rec)[kB], bool& mirror0,
                             V4& v0) {
  const uint32_t bits = p.bits ^ hash_u32((static_cast<uint32_t>(s) + 1u) * kSampleFold);
  uint32_t counter = seed;
  bool mirror;
  V4 v = {0.0f, 0.0f, 0.0f, 0.0f};
  const int iters = sampler_arg<Fold>();
  V4 d = scatter<kStubNone, kFoldSampler<Fold>>(p.h0.norm, p.mirrored0, p.h0.refl, bits, seed,
                                                counter, mirror, v, iters);
  mirror0 = mirror;
  v0 = v;
  V4 o = p.o0;
  int n = 0;
  bool alive = true;
#pragma unroll (kB == kMaxBounces ? 1 : kB)  // rolled: the generic instance
  for (int i = 0; i < kB; ++i) {
    if (i >= R || !alive) break;
    const Hit h = fold(Fold{}, P, L, o, d);
    Bounce& r = rec[i];
    r.o = o;
    r.d = d;
    r.dist = h.dist;
    r.idx = h.idx;
    r.hit = h.hit;
    r.mirror = false;
    r.v = {0.0f, 0.0f, 0.0f, 0.0f};
    n = i + 1;
    alive = h.hit;
    if (alive && i < R - 1) {  // the last bounce only shades
      o = add4(add4(o, mul4s(d, h.dist)), mul4s(h.norm, small_indent));
      d = scatter<kStubNone, kFoldSampler<Fold>>(h.norm, reflect(d, h.norm), h.refl, bits, seed,
                                                 counter, mirror, v, iters);
      r.mirror = mirror;
      r.v = v;
    }
  }
  return n;
}

// --- the composites (models/scene.py intersect_scene_fast :453-546) -----
//
// The reverse reads the packed params alone, never the fold table's values
// (only its material offsets, composite_ref): a family face is
// differentiated through geometry._cyl_family's full projections, which
// compute every value the aligned family of the hints does (the dropped
// terms are exact zeros), so the partials do not depend on the hints; the
// contract then writes the hinted axes' slots 0 (sum_parts_kernel).

// Whether Hit.idx numbers a composite candidate (GradCompositeFold), and
// which: composite_ref's candidate c and branch aux.
__device__ __forceinline__ bool is_composite(const Layout& L, int idx) {
  return idx >= L.n_spaces + L.n_spheres;
}
__device__ __forceinline__ bool composite_aux(const Layout& L, int idx) {
  return ((idx - L.n_spaces - L.n_spheres) & 1) != 0;
}
__device__ __forceinline__ CompRef composite_of(const float* P, const Layout& L, int idx) {
  const int q = idx - L.n_spaces - L.n_spheres;
  return composite_ref(P, L, q >> 1, (q & 1) != 0);
}

// A family face's forward at a hit (geometry._cyl_family, _family_circle),
// in the plain pipeline's operation order over the packed params: the
// family at spec, the face's radius at slot r. A hit has proj_ok and a
// positive discriminant.
struct FaceFwd {
  V4 co, a1, a2, po, d1, d12;
  float a1c, a2c, da1, da2, len12, inv_len, l2, b_raw, b, r, sq;
  bool degenerate;
};
__device__ __forceinline__ FaceFwd face_forward(const float* P, const CompRef& ref, V4 o, V4 d) {
  FaceFwd f;
  const float* c = P + ref.spec;
  f.a1 = ld4(c + 4);
  f.a2 = ld4(c + 8);
  f.co = sub4(ld4(c), o);                                  // geometry.py:166
  f.a1c = dot4(f.co, f.a1);
  f.a2c = dot4(f.co, f.a2);
  f.po = sub4(sub4(f.co, mul4s(f.a1, f.a1c)), mul4s(f.a2, f.a2c));  // :169
  f.da1 = dot4(d, f.a1);
  f.d1 = sub4(d, mul4s(f.a1, f.da1));                      // :171
  f.da2 = dot4(f.d1, f.a2);
  f.d12 = sub4(f.d1, mul4s(f.a2, f.da2));                  // :174
  f.len12 = sqrtf(dot4(f.d12, f.d12));
  f.inv_len = 1.0f / f.len12;                              // :177, rsqrt
  f.l2 = dot4(f.po, f.po) + kTiny37;                       // :178
  f.b_raw = dot4(f.po, f.d12);
  f.degenerate = f.l2 < kSmall2;
  f.b = f.degenerate ? 0.0f : f.b_raw * f.inv_len;         // :181
  f.r = P[ref.r];
  f.sq = sqrtf(f.r * f.r - (f.l2 - f.b * f.b));            // :190-194
  return f;
}

// A composite hit's normal and material: geometry._family_norm at the
// folded distance with the face's flip (its branch), or the hypercube
// pair's sgn * axis (scene.py:511-516); the trace's values.
__device__ __forceinline__ const float* composite_resolve(const float* P, const Layout& L, V4 o,
                                                          V4 d, int idx, float dist, V4& norm) {
  const CompRef ref = composite_of(P, L, idx);
  const bool aux = composite_aux(L, idx);
  if (ref.cube) {
    const V4 a = ld4(P + ref.spec + 4 + 4 * ref.r);
    const float sgn = aux ? 1.0f : -1.0f;
    norm = {sgn * a.x, sgn * a.y, sgn * a.z, sgn * a.w};
  } else {
    const FaceFwd f = face_forward(P, ref, o, d);
    const float inv_r = 1.0f / fmaxf(f.r, kTiny30);
    const float scale = aux ? -inv_r : inv_r;
    norm = mul4s(sub4(f.po, mul4s(f.d12, dist)), scale);
  }
  return P + ref.mat;
}

// Adjoint of a composite hit: the cotangents of the fold's distance and of
// the resolved normal, glow and color reach the winning candidate's slots
// alone, handed to acc in runs (a family's point and axes, the face's
// radius, the material; the hypercube's point, the pair's axis, r, the
// cell's material); refl_prob gets 0, and the clips and inside tests,
// comparisons, give none.
template <class Acc>
__device__ void composite_adj(const float* P, const Layout& L, V4 o, V4 d, const Hit& h,
                              float g_dist, V4 g_norm, float g_glow, V3 g_color, V4& g_o,
                              V4& g_d, Acc& acc) {
  const CompRef ref = composite_of(P, L, h.idx);
  const bool aux = composite_aux(L, h.idx);
  Slots m;
  m.key = ref.mat;
  m.n = 5;
  m.stride = 1;
  m.v[0] = g_glow;
  m.v[1] = 0.0f;
  put3(m.v + 2, g_color);
  acc.add(m);
  if (ref.cube) {
    // The opposite-cell pair of axis i (scene.py:493-516): co_i = dot(c -
    // o, a_i), dd_i = dot(d, a_i), h = pos ? -(co_i + r) : co_i - r,
    // dist = h / where(|dd_i| == 0, 1e-30, |dd_i|), norm = sgn * a_i.
    const int i = ref.r;
    const V4 cmo = sub4(ld4(P + ref.spec), o);
    const V4 a = ld4(P + ref.spec + 4 + 4 * i);
    const float dd = dot4(d, a);
    const float cos_dn = fabsf(dd);
    const float q = cos_dn == 0.0f ? kTiny30 : cos_dn;
    const float g_h = g_dist / q;
    const float g_q = -g_dist * h.dist / q;
    const float g_dd = cos_dn == 0.0f ? 0.0f : g_q * sign_of(dd);  // |x|' = sign(x)
    const float g_co = aux ? -g_h : g_h;
    const V4 g_a = add4(mul4s(g_norm, aux ? 1.0f : -1.0f), add4(mul4s(cmo, g_co), mul4s(d, g_dd)));
    const V4 g_c = mul4s(a, g_co);
    g_d = add4(g_d, mul4s(a, g_dd));
    g_o = sub4(g_o, g_c);
    acc.add(slots4(ref.spec, 1, g_c));
    acc.add(slots4(ref.spec + 4 + 4 * i, 1, g_a));
    acc.add(slot1(ref.spec + 20, -g_h));
    return;
  }
  // A family face (scene.py:453-546): dist = aux ? near : far, the roots
  // (b -+ sq) * inv_len (geometry._family_circle); norm = (po - d12 dist)
  // * (aux ? -1/r : 1/r) (geometry._family_norm).
  const FaceFwd f = face_forward(P, ref, o, d);
  const float inv_r = 1.0f / fmaxf(f.r, kTiny30);
  const float scale = aux ? -inv_r : inv_r;
  const V4 g_u = mul4s(g_norm, scale);                     // u = po - d12 dist
  V4 g_po = g_u;
  V4 g_d12 = mul4s(g_u, -h.dist);
  const float g_root = g_dist - dot4(g_u, f.d12);
  const float g_scale = dot4(g_norm, sub4(f.po, mul4s(f.d12, h.dist)));
  const float g_inv_r = aux ? -g_scale : g_scale;
  float g_r = f.r >= kTiny30 ? -g_inv_r * inv_r * inv_r : 0.0f;  // clamp_min passes r >= 1e-30
  // root = (b -+ sq) * inv_len                              geometry.py:196-197
  const float g_bs = g_root * f.inv_len;
  float g_inv_len = g_root * (aux ? f.b - f.sq : f.b + f.sq);
  float g_b = g_bs;
  // sq = sqrt(disc), disc = r^2 - (l2 - b^2)               geometry.py:190-194
  const float g_disc = (aux ? -g_bs : g_bs) * 0.5f / f.sq;
  g_r += 2.0f * f.r * g_disc;
  const float g_l2 = -g_disc;
  g_b += 2.0f * f.b * g_disc;
  // b = degenerate ? 0 : b_raw * inv_len                    geometry.py:181
  const float g_b_raw = f.degenerate ? 0.0f : g_b * f.inv_len;
  if (!f.degenerate) g_inv_len += g_b * f.b_raw;
  // inv_len = 1 / sqrt(len12_sq)                            geometry.py:140-145, :177
  const float g_len12_sq = -g_inv_len * f.inv_len * f.inv_len * 0.5f / f.len12;
  // l2 = dot(po, po) + 1e-37, b_raw = dot(po, d12), len12_sq = dot(d12, d12)
  g_po = add4(g_po, add4(mul4s(f.d12, g_b_raw), mul4s(f.po, 2.0f * g_l2)));
  g_d12 = add4(g_d12, add4(mul4s(f.po, g_b_raw), mul4s(f.d12, 2.0f * g_len12_sq)));
  // d12 = d1 - a2 da2, da2 = dot(d1, a2)                    geometry.py:173-174
  const float g_da2 = -dot4(g_d12, f.a2);
  const V4 g_d1 = add4(g_d12, mul4s(f.a2, g_da2));
  V4 g_a2 = add4(mul4s(g_d12, -f.da2), mul4s(f.d1, g_da2));
  // d1 = d - a1 da1, da1 = dot(d, a1)                       geometry.py:170-171
  const float g_da1 = -dot4(g_d1, f.a1);
  V4 g_a1 = add4(mul4s(g_d1, -f.da1), mul4s(d, g_da1));
  g_d = add4(g_d, add4(g_d1, mul4s(f.a1, g_da1)));
  // po = co - a1 a1c - a2 a2c, aN c = dot(co, aN)           geometry.py:166-169
  const float g_a1c = -dot4(g_po, f.a1);
  const float g_a2c = -dot4(g_po, f.a2);
  g_a1 = add4(g_a1, add4(mul4s(g_po, -f.a1c), mul4s(f.co, g_a1c)));
  g_a2 = add4(g_a2, add4(mul4s(g_po, -f.a2c), mul4s(f.co, g_a2c)));
  const V4 g_co = add4(g_po, add4(mul4s(f.a1, g_a1c), mul4s(f.a2, g_a2c)));
  g_o = sub4(g_o, g_co);                                   // co = point - o
  Slots fam;
  fam.key = ref.spec;
  fam.n = 12;
  fam.stride = 1;
  put4(fam.v, g_co);
  put4(fam.v + 4, g_a1);
  put4(fam.v + 8, g_a2);
  acc.add(fam);
  acc.add(slot1(ref.r, g_r));
}

// --- the literal folds (models/scene.py intersect_scene_spec, ops/geometry.py)
//
// A winner numbered by lit_code (trace.cuh: every winner of the spec and
// trig folds, a cell of a hypercube without generators in the fast fold)
// is resolved by re-running its own literal test on the recorded ray, so
// its normal and material are the fold's bitwise (a cylinder's normal is
// formed in its projected space from the unscaled distance: no rebuild
// from the recorded distance could be), and differentiated through that
// test alone: the clips of the duocylinder's and the tiger's faces and the
// cells' extents are masks. Each partial below names the line of
// ops/geometry.py it differentiates, and where the derivative is singular
// (acos' at +-1, asin' at 1, sqrt' at 0) it takes the value the plain
// version's autograd takes there (geometry._zero_safe): the formula's, inf
// or nan included, but 0 for a cotangent of 0; acos' at +-1 is 0
// (geometry._acos), and the trigonometric sphere's l = |po| takes the
// norm's subgradient 0 at po = 0 (geometry._Norm).

__device__ __forceinline__ bool is_lit(int idx) { return idx >= kLitBase; }

// g * deriv, and 0 where g is 0 whatever deriv is (geometry._zero_safe).
__device__ __forceinline__ float zero_safe(float g, float deriv) {
  return g == 0.0f ? 0.0f : g * deriv;
}

// The spec offset, kind and root of a lit_code winner.
struct LitRef {
  int off, kind;
  bool outer;
};
__device__ __forceinline__ LitRef lit_ref(int idx) {
  return {(idx - kLitBase) >> 3, (idx >> 1) & 3, (idx & 1) != 0};
}

// The material's offset of a lit_code winner's primitive: a hyperplane's at
// its spec + 8, a sphere's + 5, a cylinder's + 13, a cell's + 21.
__device__ __forceinline__ int lit_mat(const LitRef& r) {
  return r.off + (r.kind == kLitPlane ? 8 : r.kind == kLitSphere ? 5 : r.kind == kLitCylinder ? 13
                                                                                              : 21);
}

// The literal test of a lit_code winner, as the fold ran it.
template <bool kTrig>
__device__ __forceinline__ Lit lit_test(const float* P, const LitRef& r, V4 o, V4 d) {
  const float* c = P + r.off;
  switch (r.kind) {
    case kLitPlane:
      return space_lit(c, o, d);
    case kLitSphere:
      return sphere_lit<kTrig>(ld4(c), c[4], c + 5, o, d, true);
    case kLitCylinder:
      return cylinder_lit<kTrig>(c, o, d, r.outer);
    default:
      return cube_lit(c, o, d);
  }
}

// Adjoint of sphere_lit<kTrig> (geometry.sphere_intersection :120-139,
// sphere_intersection_trig :142-164) at a hit, for the cotangents of its
// distance and normal: adds those of the center, r and the ray to the g_*.
// Returns the distance, as sphere_lit computes it.
template <bool kTrig>
__device__ float sphere_lit_adj(V4 center, float r, V4 o, V4 d, bool outer, float g_dist,
                                V4 g_norm, V4& g_center, float& g_r, V4& g_o, V4& g_d) {
  const V4 po = sub4(center, o);
  const float l2 = dot4(po, po);
  V4 g_po = {0.0f, 0.0f, 0.0f, 0.0f};
  float dist, l, g_l = 0.0f;
  bool use_near;
  // The forward, as sphere_lit computes it.
  float b = 0.0f, sq = 0.0f, lm = 0.0f, q = 0.0f, cos_opa = 0.0f, A = 0.0f, S = 0.0f;
  float sin_oap = 0.0f, c2 = 0.0f, C = 0.0f, K = 0.0f, inner = 0.0f;
  bool degenerate;
  if constexpr (kTrig) {
    l = sqrtf(l2);                                         // length(po)
    degenerate = l < kSmallFloat;
    b = dot4(po, d);                                       // dot_pord
    lm = fmaxf(l, kTiny30);
    q = b / lm;
    cos_opa = degenerate ? 0.0f : fminf(fmaxf(q, -1.0f), 1.0f);
    A = acosf(cos_opa);                                    // angle_opa
    S = sinf(A);
    sin_oap = l * S / r;
    c2 = fminf(fmaxf(sin_oap, -1.0f), 1.0f);
    float B = asinf(c2);                                   // angle_oap
    use_near = outer && l > r;
    B = use_near ? kPi - B : B;
    C = kPi - A - B;                                       // angle_aop
    K = cosf(C);
    inner = r * r + l * l - 2.0f * r * l * K;
    dist = sqrtf(fmaxf(inner, 0.0f));
  } else {
    l = sqrtf(l2 + kTiny37);                               // _safe_length(po): masks only
    degenerate = l < kSmallFloat;
    b = degenerate ? 0.0f : dot4(po, d);
    sq = sqrtf(r * r - (l2 - b * b));                      // a hit: disc > 0
    use_near = outer && l > r;
    dist = use_near ? b - sq : b + sq;
  }
  // norm = (center - (o + d dist)) * (1 / r), negated on the near root
  const float inv_r = 1.0f / r;
  const V4 u = sub4(center, add4(o, mul4s(d, dist)));
  const V4 g_n = use_near ? neg4(g_norm) : g_norm;
  const V4 g_u = mul4s(g_n, inv_r);
  g_r += -dot4(g_n, u) * inv_r * inv_r;                    // d(1/r)/dr = -1/r^2
  g_center = add4(g_center, g_u);
  g_o = sub4(g_o, g_u);
  g_d = sub4(g_d, mul4s(g_u, dist));
  g_dist -= dot4(g_u, d);
  if constexpr (kTrig) {
    // dist = sqrt(clamp_min(inner, 0)): clamp_min passes at inner >= 0
    const float g_inner = inner >= 0.0f ? zero_safe(g_dist, 1.0f / (2.0f * dist)) : 0.0f;
    // inner = r r + l l - 2 r l cos(angle_aop)
    g_r += g_inner * (2.0f * r) - g_inner * (2.0f * l * K);
    g_l += g_inner * (2.0f * l) - g_inner * (2.0f * r * K);
    const float g_K = -g_inner * (2.0f * r * l);
    const float g_C = -g_K * sinf(C);                      // cos' = -sin
    // angle_aop = pi - angle_opa - angle_oap; angle_oap = pi - B on the near root
    float g_A = -g_C;
    const float g_B = use_near ? g_C : -g_C;
    // angle_oap = asin(clamp(sin_oap, -1, 1)): asin' = 1 / sqrt(1 - x^2); clamp passes in [-1, 1]
    const float g_c2 = zero_safe(g_B, 1.0f / sqrtf(1.0f - c2 * c2));
    const float g_sin = (sin_oap >= -1.0f && sin_oap <= 1.0f) ? g_c2 : 0.0f;
    // sin_oap = l sin(angle_opa) / r
    g_r -= g_sin * sin_oap / r;
    const float g_lS = g_sin / r;
    g_l += g_lS * S;
    g_A += g_lS * l * cosf(A);
    // angle_opa = acos(cos_opa): acos' = -1 / sqrt(1 - x^2)
    // (0 at cos_opa = +-1, a ray aimed at the center: geometry._acos)
    const float g_cos = fabsf(cos_opa) == 1.0f
                            ? 0.0f
                            : zero_safe(g_A, -1.0f / sqrtf(1.0f - cos_opa * cos_opa));
    // cos_opa = where(degenerate, 0, clamp(dot_pord / clamp_min(l, 1e-30), -1, 1))
    const float g_q = (!degenerate && q >= -1.0f && q <= 1.0f) ? g_cos : 0.0f;
    const float g_b = g_q / lm;
    if (l >= kTiny30) g_l -= g_q * q / lm;
    g_po = add4(g_po, mul4s(d, g_b));
    g_d = add4(g_d, mul4s(po, g_b));
    // l = |po|: po * (g_l / l), 0 at po = 0 (the norm's subgradient, geometry._Norm)
    if (l > 0.0f) g_po = add4(g_po, mul4s(po, g_l / l));
  } else {
    // dist = b -+ sq, sq = sqrt(disc), disc = r r - (l2 - b b)
    const float g_disc = (use_near ? -g_dist : g_dist) / (2.0f * sq);
    g_r += 2.0f * r * g_disc;
    const float g_b = g_dist + 2.0f * b * g_disc;
    g_po = add4(g_po, mul4s(po, -2.0f * g_disc));          // l2 = dot(po, po)
    if (!degenerate) {                                     // b = where(degenerate, 0, dot(po, d))
      g_po = add4(g_po, mul4s(d, g_b));
      g_d = add4(g_d, mul4s(po, g_b));
    }
  }
  g_center = add4(g_center, g_po);                         // po = center - o
  g_o = sub4(g_o, g_po);
  return dist;
}

// Adjoint of space_lit (geometry.space_intersection :167-176): the plane's
// point and normal to g_p, g_n; the ray's to g_o, g_d.
__device__ void space_lit_adj(const float* sp, V4 o, V4 d, float g_dist, V4 g_norm, V4& g_p,
                              V4& g_n, V4& g_o, V4& g_d) {
  const V4 p = ld4(sp), n = ld4(sp + 4);
  const V4 pmo = sub4(p, o);
  const float dot_vn = dot4(pmo, n);
  const float s = sign_of(dot_vn);                         // sign: no gradient
  const V4 drct_h = mul4s(n, s);
  const float cos_dh = dot4(drct_h, d);
  // dist = |dot_vn| / cos_dh on a hit; abs' = sign
  const float g_abs = g_dist / cos_dh;
  const float g_cos = -g_abs * (fabsf(dot_vn) / cos_dh);
  const float g_dot_vn = g_abs * s;
  // norm = -drct_h, cos_dh = dot(drct_h, d), drct_h = n sign(dot_vn)
  const V4 g_drct = sub4(mul4s(d, g_cos), g_norm);
  g_d = add4(g_d, mul4s(drct_h, g_cos));
  g_n = add4(mul4s(g_drct, s), mul4s(pmo, g_dot_vn));
  g_p = mul4s(n, g_dot_vn);                                // dot_vn = dot(p - o, n)
  g_o = sub4(g_o, g_p);
}

// Adjoint of cylinder_lit (geometry.cylinder_intersection :179-195) of the
// spec at ``c``: its point, axes and r to g_c[0..13); the ray's to g_o, g_d.
template <bool kTrig>
__device__ void cylinder_lit_adj(const float* c, V4 o, V4 d, bool outer, float g_dist, V4 g_norm,
                                 float* g_c, V4& g_o, V4& g_d) {
  const V4 point = ld4(c), a1 = ld4(c + 4), a2 = ld4(c + 8);
  // o1 = o + a1 dot(point - o, a1), d1 = d - a1 dot(d, a1)  vec4.point_in_space, vec_in_space
  const V4 w1 = sub4(point, o);
  const float t1 = dot4(w1, a1);
  const V4 o1 = add4(o, mul4s(a1, t1));
  const float u1 = dot4(d, a1);
  const V4 d1 = sub4(d, mul4s(a1, u1));
  const V4 w2 = sub4(point, o1);
  const float t2 = dot4(w2, a2);
  const V4 o12 = add4(o1, mul4s(a2, t2));
  const float u2 = dot4(d1, a2);
  const V4 d12 = sub4(d1, mul4s(a2, u2));
  const float len = safe_length(d12);
  const float inv_len = 1.0f / len;                        // a hit: not miss2
  const V4 dn = mul4s(d12, inv_len);
  // dist = the sphere's distance * inv_len
  V4 g_point = {0.0f, 0.0f, 0.0f, 0.0f}, g_o12 = g_point, g_dn = g_point;
  float g_r = 0.0f;
  const float s_dist = sphere_lit_adj<kTrig>(point, c[12], o12, dn, outer, g_dist * inv_len,
                                             g_norm, g_point, g_r, g_o12, g_dn);
  // dn = d12 * inv_len, inv_len = 1 / len, len = sqrt(dot(d12, d12) + 1e-37)
  const float g_inv_len = g_dist * s_dist + dot4(g_dn, d12);
  const float g_len = -g_inv_len * inv_len * inv_len;
  V4 g_d12 = add4(mul4s(g_dn, inv_len), mul4s(d12, g_len / len));
  // d12 = d1 - a2 u2, u2 = dot(d1, a2)
  const float g_u2 = -dot4(g_d12, a2);
  V4 g_d1 = add4(g_d12, mul4s(a2, g_u2));
  V4 g_a2 = add4(mul4s(g_d12, -u2), mul4s(d1, g_u2));
  // o12 = o1 + a2 t2, t2 = dot(point - o1, a2)
  const float g_t2 = dot4(g_o12, a2);
  g_a2 = add4(g_a2, add4(mul4s(g_o12, t2), mul4s(w2, g_t2)));
  g_point = add4(g_point, mul4s(a2, g_t2));
  const V4 g_o1 = sub4(g_o12, mul4s(a2, g_t2));
  // d1 = d - a1 u1, u1 = dot(d, a1)
  const float g_u1 = -dot4(g_d1, a1);
  g_d = add4(g_d, add4(g_d1, mul4s(a1, g_u1)));
  V4 g_a1 = add4(mul4s(g_d1, -u1), mul4s(d, g_u1));
  // o1 = o + a1 t1, t1 = dot(point - o, a1)
  const float g_t1 = dot4(g_o1, a1);
  g_a1 = add4(g_a1, add4(mul4s(g_o1, t1), mul4s(w1, g_t1)));
  g_point = add4(g_point, mul4s(a1, g_t1));
  g_o = add4(g_o, sub4(g_o1, mul4s(a1, g_t1)));
  put4(g_c, g_point);
  put4(g_c + 4, g_a1);
  put4(g_c + 8, g_a2);
  g_c[12] = g_r;
}

// Adjoint of cube_lit (geometry.cube_intersection :241-253) of the cell at
// ``c``: its space point and normal (the unflipped normal's cotangent goes
// to the latter as it is) to g_c[0..8); x, y, z and r only mask.
__device__ void cube_lit_adj(const float* c, V4 o, V4 d, float g_dist, V4 g_norm, float* g_c,
                             V4& g_o, V4& g_d) {
  const V4 sp = ld4(c);
  const V4 vec_n = neg4(ld4(c + 4));
  const V4 spo = sub4(sp, o);
  const float h = dot4(spo, vec_n);
  const float cos_dn = dot4(d, vec_n);
  // dist = h / where(cos_dn == 0, 1e-30, cos_dn)
  const float q = cos_dn == 0.0f ? kTiny30 : cos_dn;
  const float g_h = g_dist / q;
  const float g_q = cos_dn == 0.0f ? 0.0f : -g_h * (h / q);
  const V4 g_vn = add4(mul4s(spo, g_h), mul4s(d, g_q));    // h, cos_dn = dot(., vec_n)
  g_d = add4(g_d, mul4s(vec_n, g_q));
  g_o = sub4(g_o, mul4s(vec_n, g_h));
  put4(g_c, mul4s(vec_n, g_h));
  put4(g_c + 4, sub4(g_norm, g_vn));                       // vec_n = -space_norm
}

// Adjoint of a lit_code winner's hit: the cotangents of its distance and
// normal reach its spec's slots, its glow's and color's its material's
// (refl_prob gets 0), handed to acc; the ray's are added to g_o, g_d.
template <bool kTrig, class Acc>
__device__ void lit_adj(const float* P, V4 o, V4 d, int idx, float g_dist, V4 g_norm,
                        float g_glow, V3 g_color, V4& g_o, V4& g_d, Acc& acc) {
  const LitRef r = lit_ref(idx);
  const float* c = P + r.off;
  Slots m;
  m.key = lit_mat(r);
  m.n = 5;
  m.stride = 1;
  m.v[0] = g_glow;
  m.v[1] = 0.0f;
  put3(m.v + 2, g_color);
  acc.add(m);
  Slots g;
  g.key = r.off;
  g.stride = 1;
  if (r.kind == kLitPlane) {
    V4 g_p, g_n;
    space_lit_adj(c, o, d, g_dist, g_norm, g_p, g_n, g_o, g_d);
    g.n = 8;
    put4(g.v, g_p);
    put4(g.v + 4, g_n);
  } else if (r.kind == kLitSphere) {
    V4 g_c = {0.0f, 0.0f, 0.0f, 0.0f};
    float g_r = 0.0f;
    sphere_lit_adj<kTrig>(ld4(c), c[4], o, d, true, g_dist, g_norm, g_c, g_r, g_o, g_d);
    g.n = 5;
    put4(g.v, g_c);
    g.v[4] = g_r;
  } else if (r.kind == kLitCylinder) {
    g.n = 13;
    cylinder_lit_adj<kTrig>(c, o, d, r.outer, g_dist, g_norm, g.v, g_o, g_d);
  } else {
    g.n = 8;
    cube_lit_adj(c, o, d, g_dist, g_norm, g.v, g_o, g_d);
  }
  acc.add(g);
}

// A recorded hit's normal and material: the resolver at the end of
// trace.cuh intersect, operation for operation, so the rebuilt normal is
// bitwise the trace's; kC (a composite fold's sweep): a composite's too,
// composite_resolve, equal to the trace's (a zero's sign aside under the
// hints). (intersect keeps its own copy: factoring it out changes the
// forward kernel's code.)
// kLit (a literal fold's sweep: trace.cuh kLitFold): a lit_code winner's
// too, by its own literal test (lit_test).
template <bool kC = false, int kLit = kLitNone>
__device__ __forceinline__ void resolve_hit(const float* P, const Layout& L, V4 o, V4 d, Hit& h) {
  if constexpr (kLit != kLitNone) {
    if (is_lit(h.idx)) {
      const Lit l = lit_test<kLit == kLitTrig>(P, lit_ref(h.idx), o, d);
      h.norm = l.norm;
      h.glow = l.mat[0];
      h.refl = l.mat[1];
      h.color = ld3(l.mat + 2);
      return;
    }
  }
  const float* mat;
  if (kC && is_composite(L, h.idx)) {
    mat = composite_resolve(P, L, o, d, h.idx, h.dist, h.norm);
  } else if (h.idx < L.n_spaces) {
    const float* sp = P + L.spaces + kSpaceFloats * h.idx;
    float flip = -sign_of(plane_dot_vn(sp, o));
    h.norm = {flip * sp[4], flip * sp[5], flip * sp[6], flip * sp[7]};
    mat = sp + 8;
  } else {
    const float* s = P + L.spheres + kSphereFloats * (h.idx - L.n_spaces);
    V4 c = ld4(s);
    float r = s[4];
    float r2 = r * r;
    V4 po = sub4(c, o);
    float l2 = dot4(po, po) + kTiny37;
    float inv_r = 1.0f / fmaxf(r, kTiny30);
    float scale = l2 > r2 ? -inv_r : inv_r;
    V4 hit_p = add4(o, mul4s(d, h.dist));
    h.norm = mul4s(sub4(c, hit_p), scale);
    mat = s + 5;
  }
  h.glow = mat[0];
  h.refl = mat[1];
  h.color = ld3(mat + 2);
}

// The color of primitive idx (its resolver's ld3(mat + 2)).
template <bool kC = false, int kLit = kLitNone>
__device__ __forceinline__ V3 color_of(const float* P, const Layout& L, int idx) {
  if constexpr (kLit != kLitNone) {
    if (is_lit(idx)) return ld3(P + lit_mat(lit_ref(idx)) + 2);
  }
  if (kC && is_composite(L, idx)) return ld3(P + composite_of(P, L, idx).mat + 2);
  return ld3(idx < L.n_spaces ? P + L.spaces + kSpaceFloats * idx + 10
                              : P + L.spheres + kSphereFloats * (idx - L.n_spaces) + 7);
}

// Adjoint of recorded bounce i (renderer.py trace_rays / _shade,
// :186-211): (g_o, g_d, g_thr) are the cotangents of the ray and the
// throughput leaving it (zeros after the last) and become those entering
// it; its parameter cotangents go to c (kC, a composite fold's sweep: a
// composite hit's to acc, composite_adj; kLit, a literal fold's: a
// lit_code winner's to acc, lit_adj). g_light is the sample's light
// cotangent.
template <int kB, bool kC, int kLit, class Acc>
__device__ void bounce_adj(const float* P, const Layout& L, const Pixel& p,
                           const Bounce (&rec)[kB], int i, bool last, float small_indent,
                           V3 g_light, V4& g_o, V4& g_d, V3& g_thr, Slots& c, Acc& acc) {
  const Bounce& r = rec[i];
  V3 throughput = p.throughput0;  // throughput' = throughput * color, bounce by bounce
  for (int j = 0; j < i; ++j) throughput = mul3(throughput, color_of<kC, kLit>(P, L, rec[j].idx));
  V4 g_o_in = {0.0f, 0.0f, 0.0f, 0.0f};
  V4 g_d_in = {0.0f, 0.0f, 0.0f, 0.0f};
  if (!r.hit) {
    // result += throughput * final_light(d); the lane ends    renderer.py:186-188
    V3 g_thr_in = {0.0f, 0.0f, 0.0f};
    if (L.env_enabled) {
      g_thr_in = mul3(g_light, final_light(P + L.env, r.d));
      final_light_adj(P, L, r.d, mul3(g_light, throughput), c, g_d_in);
    }
    g_o = g_o_in;
    g_d = g_d_in;
    g_thr = g_thr_in;
    return;
  }
  Hit h;
  h.hit = true;
  h.idx = r.idx;
  h.dist = r.dist;
  resolve_hit<kC, kLit>(P, L, r.o, r.d, h);
  // result += color * glow * throughput                   renderer.py:190
  V3 g_thr_in = mul3(g_light, mul3s(h.color, h.glow));
  V3 g_color = mul3s(mul3(g_light, throughput), h.glow);
  float g_glow = dot3(mul3(g_light, throughput), h.color);
  float g_dist = 0.0f;
  V4 g_norm = {0.0f, 0.0f, 0.0f, 0.0f};
  if (!last) {
    // throughput' = throughput * color                    renderer.py:204
    g_thr_in = add3(g_thr_in, mul3(g_thr, h.color));
    g_color = add3(g_color, mul3(g_thr, throughput));
    // o' = o + d * dist + norm * small_indent             renderer.py:205
    g_o_in = g_o;
    g_d_in = mul4s(g_o, h.dist);
    g_dist = dot4(g_o, r.d);
    g_norm = mul4s(g_o, small_indent);
    // d' = mirror ? reflect(d, norm) : redirect(v, norm)  renderer.py:160-171
    if (r.mirror) {
      reflect_adj(r.d, h.norm, g_d, g_d_in, g_norm);
    } else {
      redirect_adj(r.v, h.norm, g_d, g_norm);
    }
  }
  if constexpr (kLit != kLitNone) {
    if (is_lit(h.idx)) {
      lit_adj<kLit == kLitTrig>(P, r.o, r.d, h.idx, g_dist, g_norm, g_glow, g_color, g_o_in,
                                g_d_in, acc);
    } else if (kC && is_composite(L, h.idx)) {
      composite_adj(P, L, r.o, r.d, h, g_dist, g_norm, g_glow, g_color, g_o_in, g_d_in, acc);
    } else {
      hit_adj(P, L, r.o, r.d, h, g_dist, g_norm, g_glow, g_color, c, g_o_in, g_d_in);
    }
  } else if (kC && is_composite(L, h.idx)) {
    composite_adj(P, L, r.o, r.d, h, g_dist, g_norm, g_glow, g_color, g_o_in, g_d_in, acc);
  } else {
    hit_adj(P, L, r.o, r.d, h, g_dist, g_norm, g_glow, g_color, c, g_o_in, g_d_in);
  }
  g_o = g_o_in;
  g_d = g_d_in;
  g_thr = g_thr_in;
}

// Pass 1: the pixel's light summed over its samples, bitwise the forward
// kernel's sum.
// The sampler is the fold's, as record_sample's.
template <class Fold = ParamsFold>
__device__ V3 pixel_light_sum(const float* P, const Layout& L, const Pixel& p, int samples,
                              int reflections, float small_indent, uint32_t seed) {
  V3 acc = {0.0f, 0.0f, 0.0f};
  for (int s = 0; s < samples; ++s) {
    if constexpr (kFoldSampler<Fold> == kSamplerPoly) {
      acc = add3(acc, trace_sample<kStubNone, Fold>(P, L, p, s, seed, reflections, small_indent));
    } else {
      uint32_t unused = seed;
      acc = add3(acc, trace_sample<kStubNone, Fold, kFoldSampler<Fold>, kRngPerSample>(
                          P, L, p, s, seed, reflections, small_indent, false, sampler_arg<Fold>(),
                          unused));
    }
  }
  return acc;
}

// The cotangents of bounce 0's outputs (renderer.py:143-177) that the
// samples' sweeps hand back: the throughput and origin leaving bounce 0,
// its mirrored direction and its normal.
struct Bounce0Cot {
  V3 g_thr0;
  V4 g_o0, g_mirrored0, g_norm0;
};

// Re-trace sample ``s`` on P (record_sample, R = reflections bounces) and
// sweep its records in reverse with light cotangent g_light: the parameter
// cotangents go to acc, those of bounce 0's outputs are added to b0.
// Returns whether the recorded path hit primitive ``obj`` (never, for -1).
template <int kB, class Fold, class Acc>
__device__ bool sample_sweep(const float* P, const Layout& L, const Pixel& p, int s,
                             uint32_t seed, int R, float small_indent, int obj, V3 g_light,
                             V3 g_shared, Acc& acc, Bounce0Cot& b0) {
  Bounce rec[kB];
  bool mirror0 = false;
  V4 v0 = {0.0f, 0.0f, 0.0f, 0.0f};
  const int n_rec =
      record_sample<kB, Fold>(P, L, p, s, seed, R, small_indent, rec, mirror0, v0);
  bool hits = false;
#pragma unroll (kB == kMaxBounces ? 1 : kB)
  for (int i = 0; i < kB; ++i) hits = hits || (i < n_rec && rec[i].hit && rec[i].idx == obj);
  // A path that misses obj carries g_shared too (pixel_sweep).
  if (!hits) g_light = add3(g_light, g_shared);
  V4 g_o = {0.0f, 0.0f, 0.0f, 0.0f};
  V4 g_d = {0.0f, 0.0f, 0.0f, 0.0f};
  V3 g_thr = {0.0f, 0.0f, 0.0f};
#pragma unroll (kB == kMaxBounces ? 1 : kB)  // rolled: the generic instance
  for (int i = kB - 1; i >= 0; --i) {
    if (i >= n_rec) continue;
    Slots c = no_slots();
    bounce_adj<kB, kGradComposite<Fold>, kLitFold<Fold>>(P, L, p, rec, i, i == R - 1,
                                                         small_indent, g_light, g_o, g_d, g_thr,
                                                         c, acc);
    acc.add(c);
  }
  b0.g_o0 = add4(b0.g_o0, g_o);
  b0.g_thr0 = add3(b0.g_thr0, g_thr);
  // bounce 0's direction update                             renderer.py:174-177
  if (mirror0) {
    b0.g_mirrored0 = add4(b0.g_mirrored0, g_d);
  } else {
    redirect_adj(v0, p.h0.norm, g_d, b0.g_norm0);
  }
  return hits;
}

// Bounce 0 (renderer.py:143-157), the primary ray and the camera, for the
// cotangent g_result0 of bounce 0's light (every sample's light starts from
// it) and the samples' b0. Linear in (g_result0, b0).
template <bool kC, int kLit, class Acc>
__device__ void bounce0_sweep(const float* P, const Layout& L, const Pixel& p, int view,
                              V3 g_result0, const Bounce0Cot& b0, float small_indent, Acc& acc) {
  V4 g_d0 = {0.0f, 0.0f, 0.0f, 0.0f};
  V4 g_focus = b0.g_o0;
  Slots c = no_slots();
  if (!p.h0.hit) {
    if (L.env_enabled) final_light_adj(P, L, p.d0, g_result0, c, g_d0);
  } else {
    const Hit& h = p.h0;
    // result0 = color * glow; throughput0 = color           renderer.py:152-153
    V3 g_color = add3(mul3s(g_result0, h.glow), b0.g_thr0);
    float g_glow = dot3(g_result0, h.color);
    // o0 = focus + d0 * dist + norm * small_indent          renderer.py:154
    g_d0 = mul4s(b0.g_o0, h.dist);
    float g_dist = dot4(b0.g_o0, p.d0);
    V4 g_norm0 = add4(b0.g_norm0, mul4s(b0.g_o0, small_indent));
    // mirrored0 = reflect(d0, norm0)                        renderer.py:156
    reflect_adj(p.d0, h.norm, b0.g_mirrored0, g_d0, g_norm0);
    if constexpr (kLit != kLitNone) {
      if (is_lit(h.idx)) {
        lit_adj<kLit == kLitTrig>(P, p.focus, p.d0, h.idx, g_dist, g_norm0, g_glow, g_color,
                                  g_focus, g_d0, acc);
      } else if (kC && is_composite(L, h.idx)) {
        composite_adj(P, L, p.focus, p.d0, h, g_dist, g_norm0, g_glow, g_color, g_focus, g_d0,
                      acc);
      } else {
        hit_adj(P, L, p.focus, p.d0, h, g_dist, g_norm0, g_glow, g_color, c, g_focus, g_d0);
      }
    } else if (kC && is_composite(L, h.idx)) {
      composite_adj(P, L, p.focus, p.d0, h, g_dist, g_norm0, g_glow, g_color, g_focus, g_d0, acc);
    } else {
      hit_adj(P, L, p.focus, p.d0, h, g_dist, g_norm0, g_glow, g_color, c, g_focus, g_d0);
    }
  }
  acc.add(c);

  // d0 = a / |a|, a = vec_to_mtr + top * my + right * mx   renderer.py:119-127, vec4.py:105
  const V4 a = p.a;
  const float len = sqrtf(dot4(a, a));
  const float inv_len = 1.0f / len;
  const float g_inv = dot4(g_d0, a);
  const float g_len = -g_inv * inv_len * inv_len;
  const V4 g_a = add4(mul4s(g_d0, inv_len), mul4s(a, g_len / len));
  const int V = L.n_views;
  const V4 top = {P[L.top + view], P[L.top + V + view], P[L.top + 2 * V + view],
                  P[L.top + 3 * V + view]};
  const V4 right = {P[L.right + view], P[L.right + V + view], P[L.right + 2 * V + view],
                    P[L.right + 3 * V + view]};
  acc.add(slots4(L.focus, 1, g_focus));
  acc.add(slots4(L.vec_to_mtr, 1, g_a));
  acc.add(slots4(L.top + view, V, mul4s(g_a, p.my)));
  acc.add(slots4(L.right + view, V, mul4s(g_a, p.mx)));
  // mx = (scr_x - 0.5) * mtr_width; my = (0.5 - scr_y) * mtr_height
  acc.add(slot1(L.mtr_width, dot4(g_a, right) * (p.scr_x - 0.5f)));
  acc.add(slot1(L.mtr_height, dot4(g_a, top) * (0.5f - p.scr_y)));
}

// Pass 2, the pixel sweep: hands to acc the parameter cotangents of the
// lights of the pixel's samples [s0, s1), each with cotangent g_light (the
// cotangent of the light summed over samples), and of bounce 0's light,
// which each of those samples' light starts from. The sweep is linear in
// its cotangents, so the sweeps of a partition of the samples sum to the
// sweep of all of them (K4's sample split, gradlaunch.cuh sweep_kernel).
// kB is kMainBounces, with reflections equal to it, or
// kMaxBounces for any count up to it. Fold is the fold of the re-trace,
// pass 1's (the Pixel's bounce 0 comes from setup_pixel<Fold>), so the
// recorded hits and distances are bitwise pass 1's; the reverse reads the
// packed params alone (hit_adj, resolve_hit), whichever fold found the hit.
//
// K6 sweeps its two rows with it. The rows of a pixel whose bounce 0
// misses primitive obj, which row b never hits (zero_map_object), trace
// alike but for the samples whose path hits obj. So row a's sweep (P = Pa,
// obj) sweeps a sample that misses obj with g_light + g_shared (row b's
// cotangent: the sweep is linear in it) and one that hits it with g_light
// alone, bounce 0 with both, and returns the mask of the samples that hit
// obj. Row b (Pb, obj -1) then sweeps those samples ``only``, and not
// bounce 0's light, which row a carried; or, where bounce 0 hits obj or
// obj is -1, all of its samples and bounce 0. A mask names samples of the
// whole pixel and the range is not applied to it: a caller that passes
// ``only`` != 0 passes s0 = 0, s1 = samples, as K6 does for every row.
template <int kB, class Fold = ParamsFold, class Acc>
__device__ unsigned pixel_sweep(const float* P, const Layout& L, const Pixel& p, int view, int s0,
                                int s1, int reflections, float small_indent, uint32_t seed,
                                V3 g_light, Acc& acc, unsigned only = 0u, int obj = -1,
                                V3 g_shared = {0.0f, 0.0f, 0.0f}) {
  const int R = kB == kMaxBounces ? reflections : kB;
  unsigned hit_obj = 0;
  Bounce0Cot b0 = {};
  if (R > 0 && p.h0.hit) {
    unsigned left = only;
    for (int k = s0; k < s1; ++k) {
      int s = k;
      if (only != 0) {  // the mask's next sample: as many rounds as it has bits
        if (left == 0) break;
        s = __ffs(static_cast<int>(left)) - 1;
        left &= left - 1;
      }
      if (sample_sweep<kB, Fold>(P, L, p, s, seed, R, small_indent, obj, g_light, g_shared, acc,
                                 b0)) {
        hit_obj |= 1u << s;
      }
    }
  }
  const V3 g_result0 = only != 0 ? V3{0.0f, 0.0f, 0.0f}
                                 : mul3s(add3(g_light, g_shared), static_cast<float>(s1 - s0));
  bounce0_sweep<kGradComposite<Fold>, kLitFold<Fold>>(P, L, p, view, g_result0, b0, small_indent,
                                                       acc);
  return hit_obj;
}

// color = 1 - 1 / u, u = c * light + 1                     ops/sky.py:57-60
__device__ __forceinline__ V3 tone_denominator(V3 light, float light_coefficient) {
  return {light_coefficient * light.x + 1.0f, light_coefficient * light.y + 1.0f,
          light_coefficient * light.z + 1.0f};
}
__device__ __forceinline__ V3 tone_color(V3 u) {
  return {1.0f - 1.0f / u.x, 1.0f - 1.0f / u.y, 1.0f - 1.0f / u.z};
}

// K4's loss of one pixel from its light summed over samples: the unscaled
// loss, sum over channels of (color - target)^2, and its cotangent of the
// mean light, 2 (color - t) c / u^2; every sample's light carries that
// times 1 / samples.
struct LossCot {
  float loss;
  V3 g_mean;
};
__device__ LossCot loss_cot(V3 sum, const float* target, float light_coefficient, int samples) {
  const float inv = 1.0f / static_cast<float>(samples);
  const V3 light = mul3s(sum, inv);
  const V3 u = tone_denominator(light, light_coefficient);
  const V3 color = tone_color(u);
  const V3 diff = sub3(color, ld3(target));
  LossCot out;
  out.loss = diff.x * diff.x + diff.y * diff.y + diff.z * diff.z;
  out.g_mean = {2.0f * diff.x * light_coefficient / (u.x * u.x),
                2.0f * diff.y * light_coefficient / (u.y * u.y),
                2.0f * diff.z * light_coefficient / (u.z * u.z)};
  return out;
}

// The static (packed slot, value) pairs that turn the params row into the
// soft kernel's second row (models/params.py soft_zero_map).
struct ZeroMap {
  int n;
  int idx[kMaxZeroSlots];
  float val[kMaxZeroSlots];
};

// The sphere (as Hit.idx) that the zero map makes a guaranteed miss and
// whose slots hold every slot of the map: it writes the sphere's radius to
// 0 (diff.zero_object), so row b never hits it and traces as row a does
// wherever row a misses it (pixel_sweep). -1 for any other map, whose rows
// are swept apart. Host code: the launch computes it once.
inline int zero_map_object(const Layout& L, const ZeroMap& zm) {
  const int j = (zm.idx[0] - L.spheres) / kSphereFloats;
  if (zm.idx[0] < L.spheres || j >= L.n_spheres) return -1;
  const int base = L.spheres + kSphereFloats * j;
  bool radius_zero = false;
  for (int i = 0; i < zm.n; ++i) {
    if (zm.idx[i] < base || zm.idx[i] >= base + kSphereFloats) return -1;
    if (zm.idx[i] == base + 4) radius_zero = zm.val[i] == 0.0f;  // the last write holds
  }
  return radius_zero ? L.n_spaces + j : -1;
}

// K6's blend of one pixel. Row a is the scene, row b the same scene with
// its object zeroed (the zero map applied); both are traced at the same
// seed (pass 1 sums acc_a, acc_b) and blended with the pixel's coverage
// alpha, img = alpha * color_a + (1 - alpha) * color_b
// (gradkernel.py:1250-1261). Gives the pixel's unscaled loss, sum over
// channels of (img - target)^2, d loss / d alpha, and each row's
// cotangent of its mean light. Row b's sweep must drop its cotangents of
// the zero map's slots: they are constants of row b
// (gradkernel.py:1268-1271).
struct SoftBlend {
  float loss, g_alpha;
  V3 g_a, g_b;
};
__device__ SoftBlend soft_blend(V3 acc_a, V3 acc_b, float alpha, const float* target,
                                float light_coefficient, int samples) {
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
  SoftBlend out;
  out.loss = diff.x * diff.x + diff.y * diff.y + diff.z * diff.z;
  // d loss / d alpha = sum_ch 2 (img - t) (ca - cb)
  out.g_alpha = 2.0f * diff.x * (ca.x - cb.x) + 2.0f * diff.y * (ca.y - cb.y) +
                2.0f * diff.z * (ca.z - cb.z);
  // d loss / d light_a = 2 (img - t) alpha c / u_a^2; row b with 1 - alpha.
  out.g_a = {2.0f * diff.x * alpha * light_coefficient / (u_a.x * u_a.x),
             2.0f * diff.y * alpha * light_coefficient / (u_a.y * u_a.y),
             2.0f * diff.z * alpha * light_coefficient / (u_a.z * u_a.z)};
  out.g_b = {2.0f * diff.x * beta * light_coefficient / (u_b.x * u_b.x),
             2.0f * diff.y * beta * light_coefficient / (u_b.y * u_b.y),
             2.0f * diff.z * beta * light_coefficient / (u_b.z * u_b.z)};
  return out;
}

}  // namespace
