// Device math of the path tracer, shared by the forward kernel
// (megakernel.cu, K1) and the gradient kernels (gradkernel.cu, ablate.cu).
//
// Counterpart of the JAX package's ops/{vec4,rng,fastmath,sampler,sky}.py,
// models/scene.py:intersect_scene_fast (hyperplanes and spheres unhinted
// over the packed params, ``intersect``, which the gradient kernels run
// without hints; every primitive, composites included, with the static
// hints over a per-block table, ``intersect_table``, which K1 runs, and
// the gradient kernels under the freeze_hints contract, ``GradTableFold``,
// and on a scene with composites, hinted or not, ``GradCompositeFold``;
// the literal folds of intersect_scene_spec, ``SpecFold``, in K1 and in
// the gradient kernels) and the per-pixel body of
// ops/pallas/megakernel.py::_kernel with _trace_rays_kernel. Every
// operation keeps the order of the plain torch
// pipeline (models/renderer.py); the build passes -fmad=false, so on the
// card a kernel built from this header rounds like its plain version.
// Float constants are hex literals of the JAX package's float32 values.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Offsets into the packed parameter vector (models/params.py:Layout, in
// the same order).
struct Layout {
  int n_spaces, n_spheres, n_views, env_enabled;
  int spaces, spheres, env, focus, vec_to_mtr, top, right, mtr_width, mtr_height, size;
};
constexpr int kLayoutInts = 14;
constexpr int kSpaceFloats = 13;   // point(4) norm(4) glow refl color(3)
constexpr int kSphereFloats = 10;  // center(4) r glow refl color(3)

constexpr float kFar = 0x1.93e594p+99f;          // float32(1e30)
constexpr float kHalfFar = 0x1.93e594p+98f;      // float32(1e30) * 0.5
constexpr float kSmallFloat = 0x1.3a92a4p-12f;   // float32(0.0003)
constexpr float kSmall2 = 0x1.828c0ep-24f;       // float32(0.0003^2)
constexpr float kTiny37 = 0x1.1039d4p-123f;      // float32(1e-37)
constexpr float kTiny30 = 0x1.4484c0p-100f;      // float32(1e-30)
constexpr float kTiny12 = 0x1.197998p-40f;       // float32(1e-12)
constexpr float kPi = 0x1.921fb6p+1f;            // float32(pi) == float32(3.14159265)
constexpr float kHalfPi = 0x1.921fb6p+0f;        // float32(pi / 2)
constexpr float kTwoPi = 0x1.921fb6p+2f;         // float32(2) * float32(3.14159265)
constexpr float kThird = 0x1.555556p-2f;         // float32(1 / 3)
constexpr uint32_t kCallDelta = 0x79A010A9u;
constexpr uint32_t kSampleFold = 0x9E3779B9u;
constexpr uint32_t kCbrtMagic = 0x548FE000u;

// atan(t)/t in u = t^2, lowest degree first (fastmath.py _ATAN_COEFFS).
__constant__ float kAtan[10] = {
    0x1.000000p+0f, -0x1.55553ap-2f, 0x1.9991e8p-3f, -0x1.24251ep-3f, 0x1.c0dac6p-4f,
    -0x1.593228p-4f, 0x1.dee324p-5f, -0x1.0419e8p-5f, 0x1.70e44cp-7f, -0x1.ec31d6p-10f};
// sin(2 pi x)/x and cos(2 pi x) in u = x^2 (fastmath.py).
__constant__ float kSin2Pi[5] = {
    0x1.921fb6p+2f, -0x1.4abbcep+5f, 0x1.466bbap+6f, -0x1.32ca7cp+6f, 0x1.4bc86cp+5f};
__constant__ float kCos2Pi[5] = {
    0x1.000000p+0f, -0x1.3bd3ccp+4f, 0x1.03c1dap+6f, -0x1.55c540p+6f, 0x1.d9c304p+5f};
// w(u) of the S^3 sampler's inverse CDF (sampler.py _W_POLY).
__constant__ float kWPoly[9] = {
    0x1.fffff6p-1f, -0x1.fffd22p-4f, -0x1.9b5f96p-10f, -0x1.c403f6p-15f, -0x1.fe5930p-18f,
    0x1.5bacc6p-20f, -0x1.42d4fep-22f, 0x1.ff41f8p-26f, -0x1.987168p-30f};

struct V3 { float x, y, z; };
struct V4 { float x, y, z, w; };

__device__ __forceinline__ V3 add3(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 mul3(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 mul3s(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V4 add4(V4 a, V4 b) { return {a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w}; }
__device__ __forceinline__ V4 sub4(V4 a, V4 b) { return {a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w}; }
__device__ __forceinline__ V4 mul4s(V4 a, float s) { return {a.x * s, a.y * s, a.z * s, a.w * s}; }
__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ float dot4(V4 a, V4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ V3 ld3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ V4 ld4(const float* p) { return {p[0], p[1], p[2], p[3]}; }
__device__ __forceinline__ float sign_of(float x) {
  return static_cast<float>((x > 0.0f) - (x < 0.0f));
}

// --- ops/vec4.py ------------------------------------------------------
__device__ __forceinline__ V4 reflect(V4 d, V4 n) { return sub4(d, mul4s(n, 2.0f * dot4(d, n))); }
__device__ __forceinline__ V4 redirect(V4 v, V4 n) {
  float d = dot4(v, n);
  V4 flipped = sub4(v, mul4s(n, 2.0f * d));
  return d >= 0.0f ? v : flipped;
}

// --- ops/rng.py -------------------------------------------------------
__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x = x + (x << 10);
  x = x ^ (x >> 6);
  x = x + (x << 3);
  x = x ^ (x >> 11);
  x = x + (x << 15);
  x = x ^ (x >> 9);
  return x;
}

// Stubs of the forward kernel's measurement variants (tools/fwd_ablate.py,
// the counterparts of the JAX tool's patches, fwd_ablate.py:113-118). They
// change the image and serve only to time a stage by its absence. The
// default, kStubNone, is the production trace, which every kernel but the
// variant launch instantiates.
constexpr int kStubNone = 0;
constexpr int kStubSampler = 1;  // the S^3 sampler returns (0.5, 0.5, 0.5, 0.5); draws kept
constexpr int kStubRng = 2;      // every uniform is 0.5, no hash, the counter unchanged

// uniform01 with the counter advanced (masked_uniform01 on an active lane).
template <int kStub = kStubNone>
__device__ __forceinline__ float draw(uint32_t bits, uint32_t seed, uint32_t& counter) {
  if constexpr ((kStub & kStubRng) != 0) return 0.5f;
  counter = counter + kCallDelta;
  uint32_t h = hash_u32(bits ^ counter ^ seed);
  return __uint_as_float((h & 0x007FFFFFu) | 0x3F800000u) - 1.0f;
}

// --- ops/fastmath.py --------------------------------------------------
__device__ __forceinline__ float atan_unit(float t) {
  float u = t * t;
  float acc = kAtan[9];
  for (int i = 8; i >= 0; --i) acc = acc * u + kAtan[i];
  return acc * t;
}

__device__ __forceinline__ float arctan(float x) {
  float ax = fabsf(x);
  bool big = ax > 1.0f;
  float inv = 1.0f / (big ? ax : 1.0f);
  float core = atan_unit(big ? inv : ax);
  float res = big ? kHalfPi - core : core;
  return x < 0.0f ? -res : res;
}

__device__ __forceinline__ float arctan2(float y, float x) {
  float base = arctan(y / (x == 0.0f ? 1.0f : x));
  if (x > 0.0f) return base;
  if (x < 0.0f) return y < 0.0f ? base - kPi : base + kPi;
  return y < 0.0f ? -kHalfPi : kHalfPi;
}

__device__ __forceinline__ float arccos(float x) {
  x = fminf(fmaxf(x, -1.0f), 1.0f);
  float s = sqrtf(fmaxf((1.0f - x) * (1.0f + x), 0.0f));
  return arctan2(s, x);
}

__device__ __forceinline__ void sincos_2pi(float u, float& sin_out, float& cos_out) {
  float n = rintf(u * 4.0f);  // round half to even, like jnp.round
  float x = u - n * 0.25f;
  float u2 = x * x;
  float sp = kSin2Pi[4];
  for (int i = 3; i >= 0; --i) sp = sp * u2 + kSin2Pi[i];
  float c0 = kCos2Pi[4];
  for (int i = 3; i >= 0; --i) c0 = c0 * u2 + kCos2Pi[i];
  float s0 = x * sp;
  float q = n - 4.0f * floorf(n * 0.25f);
  bool odd = (q == 1.0f) || (q == 3.0f);
  float sin_base = odd ? c0 : s0;
  float cos_base = odd ? s0 : c0;
  sin_out = q >= 2.0f ? -sin_base : sin_base;
  cos_out = (q == 1.0f || q == 2.0f) ? -cos_base : cos_base;
}

// --- ops/sampler.py ("poly") -------------------------------------------
__device__ __forceinline__ uint32_t div3_u32(uint32_t i) {
  uint32_t acc = i >> 2;
  uint32_t t = acc;
  for (int k = 0; k < 7; ++k) {
    t = t >> 2;
    acc = acc + t;
  }
  return acc;
}

__device__ __forceinline__ float cbrt_sq_bits(float a) {
  a = fmaxf(a, kTiny30);
  float z = __uint_as_float(kCbrtMagic - div3_u32(__float_as_uint(a)));
  for (int k = 0; k < 3; ++k) z = z * (4.0f - a * z * z * z) * kThird;
  return a * z * z;
}

__device__ __forceinline__ float w_by_volume_poly(float v) {
  float c = kTwoPi * (1.0f - v);
  bool mirrored = c > kPi;
  float c_half = mirrored ? kTwoPi - c : c;
  float u = cbrt_sq_bits(36.0f * c_half * c_half);
  float acc = kWPoly[8];
  for (int i = 7; i >= 0; --i) acc = acc * u + kWPoly[i];
  return mirrored ? -acc : acc;
}

// --- ops/sampler.py ("kepler", "newton") ------------------------------
// The sampler of a trace, a template argument: "poly" (the production
// mode), "kepler" (Halley steps on Kepler's equation, their count a launch
// argument) and "newton" (the reference's finite-difference do-while, the
// oracle's mode). The last two call the CUDA math library's expf, logf,
// sinf, cosf and acosf, as torch's CUDA ops do; never their fast
// intrinsics.
constexpr int kSamplerPoly = 0, kSamplerKepler = 1, kSamplerNewton = 2;
// The sampler a launch argument (the gradient kernels over a Modes fold):
// ``iters`` carries the sampler's code | kepler's Halley steps << 2, and
// each sampler's own code runs, so the direction is the template
// instance's bitwise.
constexpr int kSamplerArg = -1;
// Newton's cap on a lane's steps (sampler.py w_by_volume_newton).
constexpr int kNewtonMaxIters = 64;

// The CDF of the w-marginal of the uniform S^3 distribution.
__device__ __forceinline__ float volume_by_w(float w) {
  return (w * sqrtf(1.0f - w * w) - acosf(w)) / kPi + 1.0f;
}

// Newton from w = 0 with the one-sided difference of step SMALL_FLOAT,
// until the lane's first |dw| < SMALL_FLOAT (that step taken) or after
// kNewtonMaxIters steps: the JAX while_loop's per-lane semantics.
__device__ __forceinline__ float w_by_volume_newton(float v) {
  float w = 0.0f;
  for (int it = 0; it < kNewtonMaxIters; ++it) {
    const float old_v = volume_by_w(w);
    const float df = w > 0.0f ? old_v - volume_by_w(w - kSmallFloat)
                              : volume_by_w(w + kSmallFloat) - old_v;
    const float new_w = w - kSmallFloat / df * (old_v - v);
    const bool keep_going = fabsf(new_w - w) >= kSmallFloat;
    w = new_w;
    if (!keep_going) break;
  }
  return w;
}

// x - sin(x) = c on [0, pi] from the cube-root seed exp(log(6c) / 3) by
// ``iters`` Halley steps, mirrored for c > pi; w = cos(x / 2).
__device__ __forceinline__ float w_by_volume_kepler(float v, int iters) {
  const float c = kTwoPi * (1.0f - v);
  const bool mirrored = c > kPi;
  const float c_half = mirrored ? kTwoPi - c : c;
  const float c6 = 6.0f * c_half;
  float x = c6 > 0.0f ? expf(logf(c6) * kThird) : 0.0f;
  for (int i = 0; i < iters; ++i) {
    const float s = sinf(x);
    const float co = cosf(x);
    const float f = x - s - c_half;
    const float fp = 1.0f - co;
    const float denom = 2.0f * fp * fp - f * s;
    x = x - 2.0f * f * fp / (fabsf(denom) < kTiny30 ? kTiny30 : denom);
  }
  x = mirrored ? kTwoPi - x : x;
  return cosf(0.5f * x);
}

template <int kStub = kStubNone, int kSampler = kSamplerPoly>
__device__ __forceinline__ V4 direction_from_uniforms(float u_w, float u_z, float u_fi,
                                                      int iters = 0) {
  if constexpr ((kStub & kStubSampler) != 0) {
    // 0 * (u_w + u_z + u_fi) keeps the three draws live; the uniforms are
    // finite, so the value is 0.5 exactly.
    const float half = 0.0f * (u_w + u_z + u_fi) + 0.5f;
    return {half, half, half, half};
  }
  if constexpr (kSampler == kSamplerArg) {
    const int code = iters & 3;
    if (code == kSamplerNewton) {
      return direction_from_uniforms<kStub, kSamplerNewton>(u_w, u_z, u_fi);
    }
    if (code == kSamplerKepler) {
      return direction_from_uniforms<kStub, kSamplerKepler>(u_w, u_z, u_fi, iters >> 2);
    }
    return direction_from_uniforms<kStub, kSamplerPoly>(u_w, u_z, u_fi);
  }
  float w;
  if constexpr (kSampler == kSamplerNewton) {
    w = w_by_volume_newton(u_w);
  } else if constexpr (kSampler == kSamplerKepler) {
    w = w_by_volume_kepler(u_w, iters);
  } else {
    w = w_by_volume_poly(u_w);
  }
  float r = sqrtf(fmaxf(1.0f - w * w, 0.0f));
  float z = (u_z * 2.0f - 1.0f) * r;
  float rho = sqrtf(fmaxf(r * r - z * z, 0.0f));
  float sin_fi, cos_fi;
  if constexpr (kSampler == kSamplerNewton) {
    // The exact circular functions of fi = u_fi * 2 pi (the oracle's).
    const float fi = u_fi * kTwoPi;
    sin_fi = sinf(fi);
    cos_fi = cosf(fi);
  } else {
    sincos_2pi(u_fi, sin_fi, cos_fi);
  }
  return {rho * cos_fi, rho * sin_fi, z, w};
}

// --- ops/sky.py -------------------------------------------------------
__device__ V3 final_light(const float* env, V4 d) {
  V4 drct = ld4(env);
  float angular_size = env[4];
  V3 light = ld3(env + 5);
  float sharpness = env[8];
  V3 sky = ld3(env + 9);
  float cos_dev = dot4(d, drct) / (sqrtf(dot4(d, d)) * sqrtf(dot4(drct, drct)));
  cos_dev = fminf(fmaxf(cos_dev, -1.0f), 1.0f);
  bool interior = fabsf(cos_dev) < 1.0f;
  float dev_safe = arccos(interior ? cos_dev : 0.0f);
  float deviation = interior ? dev_safe : (cos_dev > 0.0f ? 0.0f : kPi);
  if (!(deviation < angular_size)) return sky;
  float k = deviation / angular_size;
  float denom = 1.0f - sharpness * k;
  float k2 = (sharpness * sharpness * k / (fabsf(denom) < kTiny12 ? kTiny12 : denom) + 1.0f) *
             (1.0f - k);
  float rest = 1.0f - k2;
  return add3(mul3s(light, k2), mul3s(sky, rest));
}

// --- models/scene.py:intersect_scene_fast, no hints --------------------
struct Hit {
  bool hit;
  int idx;  // winner: plane idx, or sphere idx - n_spaces (intersect_table: its candidate)
  float dist;
  V4 norm;
  float glow, refl;
  V3 color;
};

__device__ __forceinline__ float plane_dot_vn(const float* sp, V4 o) {
  V4 n = ld4(sp + 4);
  return dot4(ld4(sp), n) - dot4(o, n);
}

__device__ Hit intersect(const float* P, const Layout& L, V4 o, V4 d) {
  float best = kFar;
  int idx = 0;
  int k = 0;
  for (int i = 0; i < L.n_spaces; ++i, ++k) {
    const float* sp = P + L.spaces + kSpaceFloats * i;
    float dot_vn = plane_dot_vn(sp, o);
    float dn = dot4(d, ld4(sp + 4));
    bool hit = sign_of(dot_vn) * dn >= kSmallFloat;
    float dist = dot_vn / (hit ? dn : 1.0f);
    float cand = hit ? dist : kFar;
    if (k == 0 || cand < best) { best = cand; idx = k; }
  }
  for (int j = 0; j < L.n_spheres; ++j, ++k) {
    const float* s = P + L.spheres + kSphereFloats * j;
    float r = s[4];
    float r2 = r * r;
    V4 po = sub4(ld4(s), o);
    float b = dot4(po, d);
    float l2 = dot4(po, po) + kTiny37;
    bool degenerate = l2 < kSmall2;
    b = degenerate ? 0.0f : b;
    bool receding = !degenerate && (l2 >= r2 && b < 0.0f);
    float disc = r2 - (l2 - b * b);
    bool tangent = disc <= 0.0f;
    float sq = sqrtf(tangent ? 1.0f : disc);
    sq = tangent ? 0.0f : sq;
    float dist = l2 > r2 ? b - sq : b + sq;
    bool hit = !(receding || tangent);
    float cand = hit ? dist : kFar;
    if (k == 0 || cand < best) { best = cand; idx = k; }
  }

  Hit h;
  h.hit = best < kHalfFar;
  h.idx = idx;
  h.dist = h.hit ? best : 0.0f;
  if (!h.hit) {
    h.norm = {0.0f, 0.0f, 0.0f, 0.0f};
    h.glow = h.refl = 0.0f;
    h.color = {0.0f, 0.0f, 0.0f};
    return h;
  }
  // Resolve the winner's normal and material (same ops as its resolver).
  const float* mat;
  if (idx < L.n_spaces) {
    const float* sp = P + L.spaces + kSpaceFloats * idx;
    float flip = -sign_of(plane_dot_vn(sp, o));
    h.norm = {flip * sp[4], flip * sp[5], flip * sp[6], flip * sp[7]};
    mat = sp + 8;
  } else {
    const float* s = P + L.spheres + kSphereFloats * (idx - L.n_spaces);
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
  return h;
}

// --- models/scene.py:intersect_scene_fast with the static hints ---------
//
// The hinted fold of the JAX production forward (scene.py:373-455):
// opposite unit walls on one axis fold as one candidate (a pair: the nearer
// wall in the travel direction by two compares, one division), a single
// plane's dots keep only its live normal components, and the candidates
// come in the JAX order: pairs, singles, spheres. Every per-scene value
// (each pair's axis offsets, each single's dot(point, n), each sphere's r^2
// and 1 / max(r, 1e-30)) is computed once per block into a table in
// shared memory after the params, in the plain version's operation order,
// so a bounce reads a record of 16 bytes per pair and two per single or
// sphere (the room: 8 loads) where the unhinted fold reads 8 floats of
// every plane and recomputes dot(point, n). Without hints (n_singles < 0)
// every plane is a single with four live components: the unhinted fold,
// with its per-scene dots hoisted.

// A 16-byte record of the fold table (one shared-memory vector load).
struct alignas(16) Rec { float x, y, z, w; };

// The wrapper's descriptor of the hints (ops/cuda/megakernel.py
// hint_table): the wall pairs, then the single planes, in fold order; then
// the composite primitives: where their specs lie in the params
// (models/params.py Layout) and their axis hints (models/scene.py
// AxisHints).
constexpr int kMaxHintPlanes = 64;
constexpr int kMaxCylinders = 16;
struct Hints {
  int n_pairs;
  int n_singles;                   // -1: no hints (every plane, all live)
  int pair[kMaxHintPlanes / 2];    // i | j << 8 | axis << 16, offset_i < offset_j
  int single[kMaxHintPlanes];      // plane | live components << 8 (bit c: component c)
  int n_cylinders;
  int cylinders, cylinders_union, hypercube, tiger;  // offsets of the specs; -1: none
  int cylinder_axes[kMaxCylinders];  // a family: k1 | k2 << 2; -1: not aligned
  int union_axes[2];
  int hypercube_axes;              // k_i << 2i | (s_i < 0) << (8 + i); -1: not aligned
  int tiger_axes[2];
};
constexpr int kHintComposites = 2 + kMaxHintPlanes / 2 + kMaxHintPlanes;
constexpr int kHintInts = kHintComposites + 5 + kMaxCylinders + 2 + 1 + 2;

// Floats of the composites' specs in the params (models/params.py).
constexpr int kCylinderFloats = 18;  // point(4) axis1(4) axis2(4) r glow refl color(3)
constexpr int kCubeFloats = 26;      // space_point(4) space_norm(4) x y z (4 each) r material(5)
constexpr int kHypercubeFloats = 8 * kCubeFloats + 4 + 16 + 1;  // cells, point, axes, r
constexpr int kTigerFloats = 4 * kCylinderFloats;
// The composite kinds, as bits of a fold instance's kComp and of the
// table header.
constexpr int kCompCylinders = 1, kCompUnion = 2, kCompHypercube = 4, kCompTiger = 8;
// The composites' records in the table.
constexpr int kCylinderRecs = 5, kUnionRecs = 10, kHypercubeRecs = 8, kTigerRecs = 12;
// The library's composite scenes' axis hints (models/library.py): the
// duocylinder's and the tiger's families on axes (x, w) and (z, y), as an
// instance's kFams, and the hypercube's axes x, y, z, w, all +, as kCube
// (K1's instances and the gradient kernels').
constexpr int kLibraryFams = (0 | 3 << 2) | (2 | 1 << 2) << 4;
constexpr int kLibraryCube = 0 | 1 << 2 | 2 << 4 | 3 << 6;

// The table's records (1 + pairs + 2 singles + 2 spheres + the
// composites'): [0] the header (pairs, singles, cylinders, composite
// kinds); per pair {ca, cb, axis, a's offset | b's offset << 16}; per
// single {n} and {dot(point, n), live mask, offset, 0}; per sphere
// {center} and {r^2, 1 / max(r, 1e-30), r, offset}; then the composites
// in fold order (offsets into the params, integers as float bits): a
// cylinder family is {point}, {axis1}, {axis2}, {axis hint, live mask,
// first projection's live mask, 0} and a face {r^2, 1 / max(r, 1e-30), r,
// material offset}; a cylinder is its family and face; the duocylinder its
// two families and two faces; the hypercube {center}, its 4 axes, {r, axis
// hint, 0, 0}, the hinted axes' signs and per axis the +cell's | the
// -cell's material offset << 16; the tiger its families A and B and the
// faces A r_in, A r_out, B r_in, B r_out.

// The table starts at the first 16-byte boundary after the params (the
// dynamic shared memory starts 16-byte aligned).
__device__ __forceinline__ const Rec* fold_table(const float* P, const Layout& L) {
  return reinterpret_cast<const Rec*>(P + 4 * ((L.size + 3) / 4));
}

__device__ __forceinline__ float bits(uint32_t u) { return __uint_as_float(u); }

// A cylinder family's records from its spec ``c`` in the params and its
// axis hint ``code`` (k1 | k2 << 2, -1: not aligned).
__device__ __forceinline__ void write_family(Rec* r, const float* c, int code) {
  uint32_t live = 0u, l1 = 0u;
  if (code >= 0) {
    live = 0xFu & ~((1u << (code & 3)) | (1u << (code >> 2)));
    l1 = 0xFu & ~(1u << (code & 3));
  }
  r[0] = {c[0], c[1], c[2], c[3]};
  r[1] = {c[4], c[5], c[6], c[7]};
  r[2] = {c[8], c[9], c[10], c[11]};
  r[3] = {bits(static_cast<uint32_t>(code)), bits(live), bits(l1), 0.0f};
}

// A face's record: the radius of the spec at ``c`` and the material at
// ``mat`` (both in the params P). A face whose r^2 is 0 (diff.zero_object)
// stores r2 = -kFar, a guaranteed miss (geometry._family_circle's r^2 > 0):
// on a ray through the axis plane perp2 rounds below 0, where r2 = 0 would
// give disc = -perp2 > 0.
__device__ __forceinline__ Rec face_rec(const float* P, const float* c, const float* mat) {
  const float r = c[12];
  const float r2 = r * r;
  return {r2 > 0.0f ? r2 : -kFar, 1.0f / fmaxf(r, kTiny30), r,
          bits(static_cast<uint32_t>(mat - P))};
}

// The hypercube's axis hint for one built from its cells alone (no
// generators), which only the folds that read its cells take: the fast
// fold's instance with kCube == kCubeCells and the spec fold (kTableCells).
constexpr int kCubeCells = -2;

// Per axis i, the +cell's material offset | the -cell's << 16, of the
// hypercube at ``hc`` in the params.
__device__ __forceinline__ uint32_t cell_mats(int hc, int i) {
  const uint32_t pos = static_cast<uint32_t>(kCubeFloats * i + 21 + hc);
  return pos | (pos + 4u * kCubeFloats) << 16;
}

// Writes the records of the composite kind ``kind`` (one cylinder, index
// ``j``) at ``T`` from the descriptor. kCells: a hypercube may come
// without generators (its axis hint kCubeCells), whose records are its
// hint and its cells' materials only.
template <bool kCells = false>
__device__ void write_composite(Rec* T, const float* P, const Hints& H, int kind, int j) {
  if (kind == kCompCylinders) {
    const float* c = P + H.cylinders + kCylinderFloats * j;
    write_family(T, c, H.cylinder_axes[j]);
    T[4] = face_rec(P, c, c + 13);
  } else if (kind == kCompUnion) {
    const float* c1 = P + H.cylinders_union;
    const float* c2 = c1 + kCylinderFloats;
    write_family(T, c1, H.union_axes[0]);
    write_family(T + 4, c2, H.union_axes[1]);
    T[8] = face_rec(P, c1, c1 + 13);
    T[9] = face_rec(P, c2, c2 + 13);
  } else if (kind == kCompHypercube) {
    const float* hc = P + H.hypercube;
    const float* g = hc + 8 * kCubeFloats;  // the generators: point, axes, r
    const int code = H.hypercube_axes;
    if constexpr (kCells) {
      if (code == kCubeCells) {
        T[5] = {0.0f, bits(static_cast<uint32_t>(code)), 0.0f, 0.0f};
        T[7] = {bits(cell_mats(H.hypercube, 0)), bits(cell_mats(H.hypercube, 1)),
                bits(cell_mats(H.hypercube, 2)), bits(cell_mats(H.hypercube, 3))};
        return;
      }
    }
    for (int i = 0; i < 5; ++i) T[i] = {g[4 * i], g[4 * i + 1], g[4 * i + 2], g[4 * i + 3]};
    T[5] = {g[20], bits(static_cast<uint32_t>(code)), 0.0f, 0.0f};
    float sg[4];
    uint32_t mats[4];
    for (int i = 0; i < 4; ++i) {
      sg[i] = code >= 0 && ((code >> (8 + i)) & 1) ? -1.0f : 1.0f;
      mats[i] = cell_mats(H.hypercube, i);
    }
    T[6] = {sg[0], sg[1], sg[2], sg[3]};
    T[7] = {bits(mats[0]), bits(mats[1]), bits(mats[2]), bits(mats[3])};
  } else {  // the tiger: inner_cyl1, outer_cyl1, inner_cyl2, outer_cyl2
    const float* t = P + H.tiger;
    const float* a_in = t;
    const float* a_out = t + kCylinderFloats;
    const float* b_in = t + 2 * kCylinderFloats;
    const float* b_out = t + 3 * kCylinderFloats;
    write_family(T, a_in, H.tiger_axes[0]);
    write_family(T + 4, b_in, H.tiger_axes[1]);
    T[8] = face_rec(P, a_in, a_in + 13);
    T[9] = face_rec(P, a_out, a_in + 13);
    T[10] = face_rec(P, b_in, b_in + 13);
    T[11] = face_rec(P, b_out, b_in + 13);
  }
}

// The composite kinds of the descriptor, as kComp* bits (on the card for
// the table, on the host for the launch's choice of instance).
__host__ __device__ __forceinline__ int composite_kinds(const Hints& H) {
  return (H.n_cylinders > 0 ? kCompCylinders : 0) | (H.cylinders_union >= 0 ? kCompUnion : 0) |
         (H.hypercube >= 0 ? kCompHypercube : 0) | (H.tiger >= 0 ? kCompTiger : 0);
}

// Writes the fold table from the params P (both in shared memory); thread
// ``t`` of ``n_threads`` writes every n_threads-th record. The caller
// synchronises after it. kCells: as write_composite's.
template <bool kCells = false>
__device__ void build_fold_table(const float* P, const Layout& L, const Hints& H, int t,
                                 int n_threads) {
  Rec* T = const_cast<Rec*>(fold_table(P, L));
  const int np = H.n_pairs;
  const int ns = H.n_singles < 0 ? L.n_spaces : H.n_singles;
  const int kinds = composite_kinds(H);
  const int n_cyl = (kinds & kCompCylinders) ? H.n_cylinders : 0;
  const int n = 1 + np + ns + L.n_spheres + n_cyl + ((kinds & kCompUnion) ? 1 : 0) +
                ((kinds & kCompHypercube) ? 1 : 0) + ((kinds & kCompTiger) ? 1 : 0);
  for (int e = t; e < n; e += n_threads) {
    if (e == 0) {
      T[0] = {bits(np), bits(ns), bits(n_cyl), bits(kinds)};
      continue;
    }
    int k = e - 1;
    if (k < np) {
      const int i = H.pair[k] & 0xFF, j = (H.pair[k] >> 8) & 0xFF, axis = H.pair[k] >> 16;
      const float* a = P + L.spaces + kSpaceFloats * i;
      const float* b = P + L.spaces + kSpaceFloats * j;
      const float ca = dot4(ld4(a), ld4(a + 4)) / a[4 + axis];
      const float cb = dot4(ld4(b), ld4(b + 4)) / b[4 + axis];
      const uint32_t off_a = static_cast<uint32_t>(a - P), off_b = static_cast<uint32_t>(b - P);
      T[1 + k] = {ca, cb, bits(axis), bits(off_a | off_b << 16)};
      continue;
    }
    k -= np;
    if (k < ns) {
      const int plane = H.n_singles < 0 ? k : H.single[k] & 0xFF;
      const uint32_t mask = H.n_singles < 0 ? 0xFu : static_cast<uint32_t>(H.single[k] >> 8);
      const float* sp = P + L.spaces + kSpaceFloats * plane;
      Rec* r = T + 1 + np + 2 * k;
      r[0] = {sp[4], sp[5], sp[6], sp[7]};
      r[1] = {dot4(ld4(sp), ld4(sp + 4)), bits(mask), bits(static_cast<uint32_t>(sp - P)), 0.0f};
      continue;
    }
    k -= ns;
    if (k < L.n_spheres) {
      const float* s = P + L.spheres + kSphereFloats * k;
      const float r = s[4];
      Rec* rec = T + 1 + np + 2 * ns + 2 * k;
      rec[0] = {s[0], s[1], s[2], s[3]};
      rec[1] = {r * r, 1.0f / fmaxf(r, kTiny30), r, bits(static_cast<uint32_t>(s - P))};
      continue;
    }
    // The composites, in fold order: the cylinders, then one job a kind.
    k -= L.n_spheres;
    Rec* rec = T + 1 + np + 2 * ns + 2 * L.n_spheres;
    if (k < n_cyl) {
      write_composite<kCells>(rec + kCylinderRecs * k, P, H, kCompCylinders, k);
      continue;
    }
    k -= n_cyl;
    rec += kCylinderRecs * n_cyl;
    const int order[3] = {kCompUnion, kCompHypercube, kCompTiger};
    for (int q = 0; q < 3; ++q) {
      const int kind = order[q];
      if (!(kinds & kind)) continue;
      if (k-- == 0) {
        write_composite<kCells>(rec, P, H, kind, 0);
        break;
      }
      rec += kind == kCompUnion ? kUnionRecs : kind == kCompHypercube ? kHypercubeRecs : kTigerRecs;
    }
  }
}

__device__ __forceinline__ float axis_of(V4 v, int axis) {
  return axis == 0 ? v.x : axis == 1 ? v.y : axis == 2 ? v.z : v.w;
}

// Whether a pair's nearer wall in the travel direction is wall a (below
// both walls going up, or not above both going down).
__device__ __forceinline__ bool pair_takes_a(float ca, float cb, float o_k, float d_k) {
  return d_k > 0.0f ? o_k < ca : !(o_k > cb);
}

// dot(o, n) and dot(d, n) over a single plane's live components, summed x,
// y, z, w left to right; with none live, over x (scene.py:379-385).
__device__ __forceinline__ void live_dots(V4 o, V4 d, const Rec& n, uint32_t mask, float& on,
                                          float& dn) {
  const float oc[4] = {o.x, o.y, o.z, o.w}, dc[4] = {d.x, d.y, d.z, d.w};
  const float nc[4] = {n.x, n.y, n.z, n.w};
  if (mask == 0u) mask = 1u;
  on = dn = 0.0f;
  bool first = true;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if ((mask >> c) & 1u) {
      const float t = oc[c] * nc[c], u = dc[c] * nc[c];
      on = first ? t : on + t;
      dn = first ? u : dn + u;
      first = false;
    }
  }
}

// kSingles of a table without hints: the count read from the table, every
// single plane's four components live.
constexpr int kAllLive = -2;

// --- ops/geometry.py: the literal per-primitive intersections -----------
//
// The records of the literal fold (geometry.Intersection): the hit, its
// distance and normal, and the material's place in the params; every
// operation in the plain version's order. kTrig takes the reference's
// trigonometric solution of the sphere, and of a cylinder's circle
// (acosf, sinf, asinf, cosf).
struct Lit {
  bool hit;
  float dist;
  V4 norm;
  const float* mat;
};

// A literal fold's winner as the gradient kernels number it (Hit.idx of
// intersect_spec, and of the fast fold's cells-only hypercube): the
// primitive whose own literal test found the hit, by its spec's offset in
// the params, its kind and (a cylinder) the root its face takes, so that
// the sweep re-runs that test alone on the recorded ray (adjoint.cuh
// lit_test) and differentiates it (lit_adj).
constexpr int kLitBase = 1 << 28;
constexpr int kLitPlane = 0, kLitSphere = 1, kLitCylinder = 2, kLitCell = 3;
__host__ __device__ __forceinline__ int lit_code(long long offset, int kind, bool outer = false) {
  return kLitBase | static_cast<int>(offset) << 3 | kind << 1 | (outer ? 1 : 0);
}

__device__ __forceinline__ V4 neg4(V4 a) { return {-a.x, -a.y, -a.z, -a.w}; }

// geometry.closest(c, acc): a strictly nearer hit replaces the record;
// with ``code``, the winner's number follows it into ``win``.
__device__ __forceinline__ bool closest(const Lit& c, Lit& acc) {
  const bool take = c.hit && (!acc.hit || c.dist < acc.dist);
  if (take) acc = c;
  return take;
}
__device__ __forceinline__ void closest(const Lit& c, int code, Lit& acc, int& win) {
  if (closest(c, acc)) win = code;
}

__device__ __forceinline__ float safe_length(V4 v) { return sqrtf(dot4(v, v) + kTiny37); }

// vec4.point_in_space and vec4.vec_in_space.
__device__ __forceinline__ V4 point_in_space(V4 p, V4 sp, V4 sn) {
  return add4(p, mul4s(sn, dot4(sub4(sp, p), sn)));
}
__device__ __forceinline__ V4 vec_in_space(V4 v, V4 n) { return sub4(v, mul4s(n, dot4(v, n))); }

// geometry.sphere_intersection (quadratic) or sphere_intersection_trig. A
// circle of radius 0 (diff.zero_object) never hits (geometry._radius_guard:
// on a ray through its center the quadratic's disc rounds above 0, the
// trigonometric sin_oap is nan).
template <bool kTrig>
__device__ __forceinline__ Lit sphere_lit(V4 center, float r, const float* mat, V4 o, V4 d,
                                          bool outer) {
  const V4 po = sub4(center, o);
  bool use_near, hit;
  float dist;
  if constexpr (kTrig) {
    const float l = sqrtf(dot4(po, po));
    const bool degenerate = l < kSmallFloat;
    const float dot_pord = dot4(po, d);
    const bool miss_receding = !degenerate && (l >= r && dot_pord < 0.0f);
    const float cos_opa =
        degenerate ? 0.0f : fminf(fmaxf(dot_pord / fmaxf(l, kTiny30), -1.0f), 1.0f);
    const float angle_opa = acosf(cos_opa);
    const float sin_oap = l * sinf(angle_opa) / r;
    const bool miss_tangent = sin_oap >= 1.0f;
    float angle_oap = asinf(fminf(fmaxf(sin_oap, -1.0f), 1.0f));
    use_near = outer && l > r;
    angle_oap = use_near ? kPi - angle_oap : angle_oap;
    const float angle_aop = kPi - angle_opa - angle_oap;
    dist = sqrtf(fmaxf(r * r + l * l - 2.0f * r * l * cosf(angle_aop), 0.0f));
    hit = !(miss_receding || miss_tangent);
  } else {
    const float l2 = dot4(po, po);
    const float l = sqrtf(l2 + kTiny37);
    const bool degenerate = l < kSmallFloat;
    const float b = degenerate ? 0.0f : dot4(po, d);
    const bool miss_receding = !degenerate && (l >= r && b < 0.0f);
    const float disc = r * r - (l2 - b * b);
    const bool miss_tangent = disc <= 0.0f;
    const float sq = miss_tangent ? 0.0f : sqrtf(disc);
    use_near = outer && l > r;
    dist = use_near ? b - sq : b + sq;
    hit = !(miss_receding || miss_tangent);
  }
  const V4 n = mul4s(sub4(center, add4(o, mul4s(d, dist))), 1.0f / r);
  return {hit && r != 0.0f, dist, use_near ? neg4(n) : n, mat};
}

// geometry.space_intersection of the plane at ``sp`` in the params.
__device__ __forceinline__ Lit space_lit(const float* sp, V4 o, V4 d) {
  const V4 n = ld4(sp + 4);
  const float dot_vn = dot4(sub4(ld4(sp), o), n);
  const V4 drct_h = mul4s(n, sign_of(dot_vn));
  const float cos_dh = dot4(drct_h, d);
  const bool hit = cos_dh >= kSmallFloat;
  return {hit, fabsf(dot_vn) / (hit ? cos_dh : 1.0f), neg4(drct_h), sp + 8};
}

// geometry.cylinder_intersection of the cylinder spec at ``c`` (point,
// axis1, axis2, r, material).
template <bool kTrig>
__device__ __forceinline__ Lit cylinder_lit(const float* c, V4 o, V4 d, bool outer) {
  const V4 point = ld4(c), a1 = ld4(c + 4), a2 = ld4(c + 8);
  const V4 o1 = point_in_space(o, point, a1);
  const V4 d1 = vec_in_space(d, a1);
  const bool miss1 = safe_length(d1) < kSmallFloat;
  const V4 o12 = point_in_space(o1, point, a2);
  const V4 d12 = vec_in_space(d1, a2);
  const float d12_len = safe_length(d12);
  const bool miss2 = d12_len < kSmallFloat;
  const float inv_len = 1.0f / (miss2 ? 1.0f : d12_len);
  Lit s = sphere_lit<kTrig>(point, c[12], c + 13, o12, mul4s(d12, inv_len), outer);
  s.hit = s.hit && !(miss1 || miss2);
  s.dist = s.dist * inv_len;
  return s;
}

// geometry.dist_to_axes_plane: from the ray's point at ``dist`` to the
// axis plane of the cylinder spec at ``c``.
__device__ __forceinline__ float dist_to_axes_plane(float dist, V4 o, V4 d, const float* c) {
  const V4 point = ld4(c);
  const V4 p = add4(o, mul4s(d, dist));
  return safe_length(
      sub4(point, point_in_space(point_in_space(p, point, ld4(c + 4)), point, ld4(c + 8))));
}

// geometry.cylinders_union_intersection: both arms clipped at cylinder 2's
// radius (the reference's quirk).
// ``arm``: the winning cylinder's spec.
template <bool kTrig>
__device__ __forceinline__ Lit union_lit(const float* c1, const float* c2, V4 o, V4 d,
                                         const float*& arm) {
  Lit a = cylinder_lit<kTrig>(c1, o, d, true);
  a.hit = a.hit && dist_to_axes_plane(a.dist, o, d, c2) <= c2[12];
  Lit b = cylinder_lit<kTrig>(c2, o, d, true);
  b.hit = b.hit && dist_to_axes_plane(b.dist, o, d, c1) <= c2[12];
  arm = closest(a, b) ? c1 : c2;
  return b;
}

// geometry.tiger_intersection of the tiger at ``t`` (inner_cyl1,
// outer_cyl1, inner_cyl2, outer_cyl2): the closest of its 8 faces, each
// cylinder's hit clipped to the other family's annulus.
// ``win``: the winning face's cylinder | its root (1: the outer face's) << 2,
// as (q, f) index the loops.
template <bool kTrig>
__device__ __forceinline__ Lit tiger_lit(const float* t, V4 o, V4 d, int& win) {
  Lit acc;
  acc.hit = false;
  win = 0;
#pragma unroll 1
  for (int q = 0; q < 4; ++q) {
    const float* cyl = t + kCylinderFloats * q;
    const float* other = t + (q < 2 ? 2 : 0) * kCylinderFloats;  // the other inner cylinder
    const float* other_out = other + kCylinderFloats;
#pragma unroll 1
    for (int f = 0; f < 2; ++f) {
      Lit face = cylinder_lit<kTrig>(cyl, o, d, f == 0);
      const float d_out = dist_to_axes_plane(face.dist, o, d, other_out);
      const float d_in = dist_to_axes_plane(face.dist, o, d, other);
      face.hit = face.hit && (d_out <= other_out[12] && d_in >= other[12]);
      closest(face, q | (f == 0 ? 4 : 0), acc, win);
    }
  }
  return acc;
}

// geometry.cube_intersection of the cell at ``c`` (space_point,
// space_norm, x, y, z, r, material): the front-facing hit within its
// extents, its normal the cell's, unflipped.
__device__ __forceinline__ Lit cube_lit(const float* c, V4 o, V4 d) {
  const V4 sp = ld4(c), sn = ld4(c + 4);
  const V4 vec_n = neg4(sn);
  const float h = dot4(sub4(sp, o), vec_n);
  const float cos_dn = dot4(d, vec_n);
  const bool facing = h >= 0.0f && cos_dn >= 0.0f;
  const float dist = h / (cos_dn == 0.0f ? kTiny30 : cos_dn);
  const V4 vec_cp = sub4(add4(o, mul4s(d, dist)), sp);
  const float r = c[20];
  const bool inside = fabsf(dot4(vec_cp, ld4(c + 8))) <= r &&
                      fabsf(dot4(vec_cp, ld4(c + 12))) <= r &&
                      fabsf(dot4(vec_cp, ld4(c + 16))) <= r;
  return {facing && inside, dist, sn, c + 21};
}

// geometry.hypercube_intersection of the 8 cells at ``hc``: the first cell
// hit in their order, not the closest.
// ``cell``: the cell hit (8: none).
__device__ __forceinline__ Lit hypercube_lit(const float* hc, V4 o, V4 d, int& cell) {
  Lit acc;
  acc.hit = false;
  int i = 0;
#pragma unroll 1
  for (; i < 8 && !acc.hit; ++i) acc = cube_lit(hc + kCubeFloats * i, o, d);
  cell = acc.hit ? i - 1 : 8;
  return acc;
}
__device__ __forceinline__ Lit hypercube_lit(const float* hc, V4 o, V4 d) {
  int cell;
  return hypercube_lit(hc, o, d, cell);
}

// The cells of the hypercube whose records are ``rec``, in the params P.
__device__ __forceinline__ const float* hypercube_cells(const float* P, const Rec* rec) {
  return P + (__float_as_uint(rec[7].x) & 0xFFFFu) - 21;
}

// --- The composites' fold (scene.py:495-653, geometry.py:419-524) -------
//
// A cylinder family's projected-ray quantities (geometry._CylFamily), from
// its table records: with an axis hint (k1 | k2 << 2) the projections zero
// components k1 and k2 and the dots sum the live components alone, in
// ascending order from the first (scene._cyl_family_aligned); without, the
// full projections and dots of geometry._cyl_family. 1 / sqrt is two
// correctly rounded operations, as the plain version's rsqrt.
struct Fam {
  V4 po, d12;
  float l2, b_raw, len12_sq, inv_len, b, perp2;
  bool proj_ok, degenerate;
};

// The sum of t's components on the set bits of ``mask``, in ascending
// order, starting at the first.
__device__ __forceinline__ float masked_sum(V4 t, uint32_t mask) {
  const float c[4] = {t.x, t.y, t.z, t.w};
  float acc = 0.0f;
  bool first = true;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if ((mask >> i) & 1u) {
      acc = first ? c[i] : acc + c[i];
      first = false;
    }
  }
  return acc;
}

__device__ __forceinline__ V4 masked(V4 v, uint32_t mask) {
  return {(mask & 1u) ? v.x : 0.0f, (mask & 2u) ? v.y : 0.0f, (mask & 4u) ? v.z : 0.0f,
          (mask & 8u) ? v.w : 0.0f};
}

__device__ __forceinline__ V4 v4(Rec r) { return {r.x, r.y, r.z, r.w}; }

// kCode >= 0: the family's axis hint, fixed for the instance; -1: read from
// its records.
template <int kCode>
__device__ __forceinline__ Fam family(const Rec* f, V4 o, V4 d) {
  const V4 co = sub4(v4(f[0]), o);
  int code;
  uint32_t live, l1;
  if constexpr (kCode >= 0) {
    code = kCode;
    live = 0xFu & ~((1u << (kCode & 3)) | (1u << (kCode >> 2)));
    l1 = 0xFu & ~(1u << (kCode & 3));
  } else {
    const Rec m = f[3];
    code = static_cast<int>(__float_as_uint(m.x));
    live = __float_as_uint(m.y);
    l1 = __float_as_uint(m.z);
  }
  Fam F;
  float len1_sq;
  if (code >= 0) {
    const V4 dd = {d.x * d.x, d.y * d.y, d.z * d.z, d.w * d.w};
    F.po = masked(co, live);
    F.d12 = masked(d, live);
    F.l2 = masked_sum({co.x * co.x, co.y * co.y, co.z * co.z, co.w * co.w}, live) + kTiny37;
    F.b_raw = masked_sum({co.x * d.x, co.y * d.y, co.z * d.z, co.w * d.w}, live);
    len1_sq = masked_sum(dd, l1);
    F.len12_sq = masked_sum(dd, live);
  } else {
    const V4 a1 = v4(f[1]), a2 = v4(f[2]);
    const float a1c = dot4(co, a1), a2c = dot4(co, a2);
    F.po = sub4(sub4(co, mul4s(a1, a1c)), mul4s(a2, a2c));
    const V4 d1 = sub4(d, mul4s(a1, dot4(d, a1)));
    len1_sq = dot4(d1, d1);
    F.d12 = sub4(d1, mul4s(a2, dot4(d1, a2)));
    F.len12_sq = dot4(F.d12, F.d12);
    F.l2 = dot4(F.po, F.po) + kTiny37;
    F.b_raw = dot4(F.po, F.d12);
  }
  F.proj_ok = len1_sq >= kSmall2 && F.len12_sq >= kSmall2;
  F.inv_len = 1.0f / sqrtf(F.proj_ok ? F.len12_sq : 1.0f);
  F.degenerate = F.l2 < kSmall2;
  F.b = F.degenerate ? 0.0f : F.b_raw * F.inv_len;
  F.perp2 = F.l2 - F.b * F.b;
  return F;
}

// The family's circle test at radius^2 r2 (geometry._family_circle): the
// two roots as ray parameters, the hit mask and the outer face's near-root
// select. A face of radius 0 never hits: its record holds r2 = -kFar
// (face_rec), so disc < 0 and every clip against it fails.
__device__ __forceinline__ void circle(const Fam& F, float r2, float& near, float& far,
                                       bool& hit, bool& use_near) {
  const bool receding = !F.degenerate && (F.l2 >= r2 && F.b < 0.0f);
  const float disc = r2 - F.perp2;
  const bool tangent = disc <= 0.0f;
  float sq = sqrtf(tangent ? 1.0f : disc);
  sq = tangent ? 0.0f : sq;
  near = (F.b - sq) * F.inv_len;
  far = (F.b + sq) * F.inv_len;
  hit = F.proj_ok && !(receding || tangent);
  use_near = F.l2 > r2;
}

// Squared distance to the family's axis plane at ray parameter t
// (geometry._family_clip_sq).
__device__ __forceinline__ float clip_sq(const Fam& F, float t) {
  return (F.l2 - (2.0f * t) * F.b_raw) + (t * t) * F.len12_sq;
}

// A family's hint of an instance's kFams (family i: bits 4i..4i+3; -1:
// read from the records).
template <int kFams, int kI>
constexpr int kFamCode = kFams < 0 ? -1 : (kFams >> (4 * kI)) & 15;

// The closest-fold step: a strictly nearer candidate wins, ties keep the
// earlier; ``aux`` is the winner's flip (a family face) or +cell (the
// hypercube).
__device__ __forceinline__ void take(float cand, int k, bool a, float& best, int& idx, bool& aux) {
  if (k == 0 || cand < best) {
    best = cand;
    idx = k;
    aux = a;
  }
}

// The composites' candidates, from the table's composite records ``C``,
// numbered from k on: each cylinder, the duocylinder's two faces (each
// clipped against the other family, both against cylinder 2's radius),
// the hypercube's four opposite-cell pairs and the tiger's four merged
// candidates. kComp (kComp* bits; -1: the header's) fixes the kinds
// present, kFams the duocylinder's or tiger's family hints and kCube the
// hypercube's (-1: read from the records).
template <int kComp, int kFams, int kCube>
__device__ __forceinline__ void fold_composites(const float* P, const Rec* C, Rec head, V4 o,
                                                V4 d, int& k, float& best, int& idx, bool& aux) {
  const int kinds = kComp >= 0 ? kComp : static_cast<int>(__float_as_uint(head.w));
  const Rec* rec = C;
  if (kinds & kCompCylinders) {
    const int n_cyl = static_cast<int>(__float_as_uint(head.z));
    for (int c = 0; c < n_cyl; ++c, ++k, rec += kCylinderRecs) {
      const Fam F = family<-1>(rec, o, d);
      float near, far;
      bool hit, use_near;
      circle(F, rec[4].x, near, far, hit, use_near);
      take(hit ? (use_near ? near : far) : kFar, k, use_near, best, idx, aux);
    }
  }
  if (kinds & kCompUnion) {
    const Fam F1 = family<kFamCode<kFams, 0>>(rec, o, d);
    const Fam F2 = family<kFamCode<kFams, 1>>(rec + 4, o, d);
    const float r2sq = rec[9].x;  // cylinder 2's radius clips both faces
    float near, far;
    bool hit, use_near;
    circle(F1, rec[8].x, near, far, hit, use_near);
    float dist = use_near ? near : far;
    take(hit && clip_sq(F2, dist) <= r2sq ? dist : kFar, k++, use_near, best, idx, aux);
    circle(F2, r2sq, near, far, hit, use_near);
    dist = use_near ? near : far;
    take(hit && clip_sq(F1, dist) <= r2sq ? dist : kFar, k++, use_near, best, idx, aux);
    rec += kUnionRecs;
  }
  if constexpr (kCube == kCubeCells) {
    // Without generators: the literal cell-by-cell test as one candidate
    // (scene.py:543-545).
    if (kinds & kCompHypercube) {
      const Lit c = hypercube_lit(hypercube_cells(P, rec), o, d);
      take(c.hit ? c.dist : kFar, k++, false, best, idx, aux);
      rec += kHypercubeRecs;
    }
  } else if (kinds & kCompHypercube) {
    const Rec meta = rec[5];
    const float r = meta.x;
    const int code = kCube >= 0 ? kCube : static_cast<int>(__float_as_uint(meta.y));
    float co[4], dd[4];
    if (code >= 0) {  // aligned: co_i = s_i (c_k - o_k), dd_i = s_i d_k
      const Rec sg = rec[6];
      const float sgn[4] = {sg.x, sg.y, sg.z, sg.w};
      const V4 c = v4(rec[0]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = (code >> (2 * i)) & 3;
        const float s = kCube >= 0 ? (((kCube >> (8 + i)) & 1) ? -1.0f : 1.0f) : sgn[i];
        co[i] = s * (axis_of(c, kk) - axis_of(o, kk));
        dd[i] = s * axis_of(d, kk);
      }
    } else {
      const V4 cmo = sub4(v4(rec[0]), o);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const V4 a = v4(rec[1 + i]);
        co[i] = dot4(cmo, a);
        dd[i] = dot4(d, a);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool pos = dd[i] <= 0.0f;  // the +cell faces the ray
      const float h = pos ? -(co[i] + r) : co[i] - r;
      const float cos_dn = fabsf(dd[i]);
      bool inside = h >= 0.0f;
      const float dist = h / (cos_dn == 0.0f ? kTiny30 : cos_dn);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j != i) inside = inside && fabsf(dist * dd[j] - co[j]) <= r;
      }
      take(inside ? dist : kFar, k++, pos, best, idx, aux);
    }
    rec += kHypercubeRecs;
  }
  if (kinds & kCompTiger) {
    const Fam FA = family<kFamCode<kFams, 0>>(rec, o, d);
    const Fam FB = family<kFamCode<kFams, 1>>(rec + 4, o, d);
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const Fam& F = f == 0 ? FA : FB;
      const Fam& G = f == 0 ? FB : FA;
      const float o_in2 = rec[f == 0 ? 10 : 8].x, o_out2 = rec[f == 0 ? 11 : 9].x;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float near, far;
        bool hit, use_near;
        circle(F, rec[8 + 2 * f + q].x, near, far, hit, use_near);
        const float clip_near = clip_sq(G, near), clip_far = clip_sq(G, far);
        const bool keep_near = clip_near <= o_out2 && clip_near >= o_in2;
        const bool keep_far = clip_far <= o_out2 && clip_far >= o_in2;
        const bool take_near = use_near && keep_near;
        const float dist = take_near ? near : far;
        take(hit && (take_near || keep_far) ? dist : kFar, k++, take_near, best, idx, aux);
      }
    }
  }
}

// A family face's normal at the folded distance, (po - d12 dist) * (flip ?
// -1/r : 1/r) (geometry._family_norm); returns the face's material.
template <int kCode>
__device__ __forceinline__ const float* face_norm(const float* P, const Rec* fam, Rec face, V4 o,
                                                  V4 d, bool flip, float dist, V4& norm) {
  const Fam F = family<kCode>(fam, o, d);
  const float scale = flip ? -face.y : face.y;
  norm = {(F.po.x - F.d12.x * dist) * scale, (F.po.y - F.d12.y * dist) * scale,
          (F.po.z - F.d12.z * dist) * scale, (F.po.w - F.d12.w * dist) * scale};
  return P + __float_as_uint(face.w);
}

// The normal and material of composite candidate ``c`` (numbered as
// fold_composites numbers them from 0), the fold's winner.
template <int kComp, int kFams, int kCube>
__device__ __forceinline__ const float* resolve_composite(const float* P, const Rec* C, Rec head,
                                                          int c, V4 o, V4 d, bool aux, float dist,
                                                          V4& norm) {
  const int kinds = kComp >= 0 ? kComp : static_cast<int>(__float_as_uint(head.w));
  const Rec* rec = C;
  if (kinds & kCompCylinders) {
    const int n_cyl = static_cast<int>(__float_as_uint(head.z));
    if (c < n_cyl) {
      rec += kCylinderRecs * c;
      return face_norm<-1>(P, rec, rec[4], o, d, aux, dist, norm);
    }
    c -= n_cyl;
    rec += kCylinderRecs * n_cyl;
  }
  if (kinds & kCompUnion) {
    if (c < 2) {
      return c == 0 ? face_norm<kFamCode<kFams, 0>>(P, rec, rec[8], o, d, aux, dist, norm)
                    : face_norm<kFamCode<kFams, 1>>(P, rec + 4, rec[9], o, d, aux, dist, norm);
    }
    c -= 2;
    rec += kUnionRecs;
  }
  if constexpr (kCube == kCubeCells) {
    if (kinds & kCompHypercube) {
      if (c < 1) {
        const Lit l = hypercube_lit(hypercube_cells(P, rec), o, d);
        norm = l.norm;
        return l.mat;
      }
      c -= 1;
      rec += kHypercubeRecs;
    }
  } else if (kinds & kCompHypercube) {
    if (c < 4) {
      const V4 a = v4(rec[1 + c]);
      const float sgn = aux ? 1.0f : -1.0f;
      norm = {sgn * a.x, sgn * a.y, sgn * a.z, sgn * a.w};
      const Rec m = rec[7];
      const uint32_t mats = __float_as_uint(c == 0 ? m.x : c == 1 ? m.y : c == 2 ? m.z : m.w);
      return P + (aux ? mats & 0xFFFFu : mats >> 16);
    }
    c -= 4;
    rec += kHypercubeRecs;
  }
  // The tiger: candidates 0-1 on family A, 2-3 on family B.
  return c < 2 ? face_norm<kFamCode<kFams, 0>>(P, rec, rec[8 + c], o, d, aux, dist, norm)
               : face_norm<kFamCode<kFams, 1>>(P, rec + 4, rec[8 + c], o, d, aux, dist, norm);
}

// The closest hit over the fold table (scene.py:373-653). kPairs and
// kSingles, when not negative, are the table's counts, fixed for an
// instance, whose pair i then lies on axis i (the room's x, y, z and w
// walls; the launch checks it); kSingles kAllLive fixes every live mask to
// 0xF. kComp (0: none; -1: the header's), kFams and kCube fix the
// composites' kinds and hints (fold_composites). Inlined at each of its
// three sites: a call kept its live values on the stack.
// ``aux_out`` is the winning composite candidate's flip or +cell (take).
template <int kPairs, int kSingles, int kComp = 0, int kFams = -1, int kCube = -1>
__device__ __forceinline__ Hit intersect_table(const float* P, const Layout& L, V4 o, V4 d,
                                               bool& aux_out) {
  const Rec* T = fold_table(P, L);
  const Rec head = T[0];
  const int np = kPairs >= 0 ? kPairs : static_cast<int>(__float_as_uint(head.x));
  const int ns = kSingles >= 0 ? kSingles : static_cast<int>(__float_as_uint(head.y));
  const Rec* singles = T + 1 + np;
  const Rec* spheres = singles + 2 * ns;
  float best = kFar;
  int idx = 0;
  int k = 0;
  for (int i = 0; i < np; ++i, ++k) {
    const Rec r = T[1 + i];
    const int axis = kPairs > 0 ? i : static_cast<int>(__float_as_uint(r.z));
    const float o_k = axis_of(o, axis), d_k = axis_of(d, axis);
    const float dot_vn = (pair_takes_a(r.x, r.y, o_k, d_k) ? r.x : r.y) - o_k;
    const bool hit = sign_of(dot_vn) * d_k >= kSmallFloat;
    const float dist = dot_vn / (hit ? d_k : 1.0f);
    const float cand = hit ? dist : kFar;
    if (k == 0 || cand < best) { best = cand; idx = k; }
  }
  for (int i = 0; i < ns; ++i, ++k) {
    const Rec n = singles[2 * i], c = singles[2 * i + 1];
    float on, dn;
    live_dots(o, d, n, kSingles == kAllLive ? 0xFu : __float_as_uint(c.y), on, dn);
    const float dot_vn = c.x - on;
    const bool hit = sign_of(dot_vn) * dn >= kSmallFloat;
    const float dist = dot_vn / (hit ? dn : 1.0f);
    const float cand = hit ? dist : kFar;
    if (k == 0 || cand < best) { best = cand; idx = k; }
  }
  for (int j = 0; j < L.n_spheres; ++j, ++k) {
    const Rec c = spheres[2 * j];
    const float r2 = spheres[2 * j + 1].x;
    V4 po = {c.x - o.x, c.y - o.y, c.z - o.z, c.w - o.w};
    float b = dot4(po, d);
    float l2 = dot4(po, po) + kTiny37;
    bool degenerate = l2 < kSmall2;
    b = degenerate ? 0.0f : b;
    bool receding = !degenerate && (l2 >= r2 && b < 0.0f);
    float disc = r2 - (l2 - b * b);
    bool tangent = disc <= 0.0f;
    float sq = sqrtf(tangent ? 1.0f : disc);
    sq = tangent ? 0.0f : sq;
    float dist = l2 > r2 ? b - sq : b + sq;
    bool hit = !(receding || tangent);
    float cand = hit ? dist : kFar;
    if (k == 0 || cand < best) { best = cand; idx = k; }
  }
  bool aux = false;
  if constexpr (kComp != 0) {
    fold_composites<kComp, kFams, kCube>(P, spheres + 2 * L.n_spheres, head, o, d, k, best,
                                         idx, aux);
  }
  aux_out = aux;

  Hit h;
  h.hit = best < kHalfFar;
  h.idx = idx;
  h.dist = h.hit ? best : 0.0f;
  if (!h.hit) {
    h.norm = {0.0f, 0.0f, 0.0f, 0.0f};
    h.glow = h.refl = 0.0f;
    h.color = {0.0f, 0.0f, 0.0f};
    return h;
  }
  // Resolve the winner's normal and material (the resolvers' ops).
  const float* mat;
  if (idx < np) {
    // The ray-facing normal of an axis wall: -sign(offset - o_k) along the
    // axis, +0 elsewhere.
    const Rec r = T[1 + idx];
    const int axis = kPairs > 0 ? idx : static_cast<int>(__float_as_uint(r.z));
    const uint32_t walls = __float_as_uint(r.w);
    const float o_k = axis_of(o, axis), d_k = axis_of(d, axis);
    const bool take_a = pair_takes_a(r.x, r.y, o_k, d_k);
    const float nk = -sign_of((take_a ? r.x : r.y) - o_k);
    h.norm = {axis == 0 ? nk : 0.0f, axis == 1 ? nk : 0.0f, axis == 2 ? nk : 0.0f,
              axis == 3 ? nk : 0.0f};
    mat = P + (take_a ? walls & 0xFFFFu : walls >> 16) + 8;
  } else if (idx < np + ns) {
    // flip * n on the live components, +0 on the hinted ones.
    const Rec n = singles[2 * (idx - np)], c = singles[2 * (idx - np) + 1];
    const uint32_t mask = kSingles == kAllLive ? 0xFu : __float_as_uint(c.y);
    float on, dn;
    live_dots(o, d, n, mask, on, dn);
    const float flip = -sign_of(c.x - on);
    h.norm = {(mask & 1u) ? flip * n.x : 0.0f, (mask & 2u) ? flip * n.y : 0.0f,
              (mask & 4u) ? flip * n.z : 0.0f, (mask & 8u) ? flip * n.w : 0.0f};
    mat = P + __float_as_uint(c.z) + 8;
  } else if (kComp == 0 || idx < np + ns + L.n_spheres) {
    const Rec c4 = spheres[2 * (idx - np - ns)], e = spheres[2 * (idx - np - ns) + 1];
    V4 c = {c4.x, c4.y, c4.z, c4.w};
    V4 po = sub4(c, o);
    float l2 = dot4(po, po) + kTiny37;
    float scale = l2 > e.x ? -e.y : e.y;
    V4 hit_p = add4(o, mul4s(d, h.dist));
    h.norm = mul4s(sub4(c, hit_p), scale);
    mat = P + __float_as_uint(e.w) + 5;
  } else {
    mat = resolve_composite<kComp, kFams, kCube>(P, spheres + 2 * L.n_spheres, head,
                                                 idx - np - ns - L.n_spheres, o, d, aux, h.dist,
                                                 h.norm);
  }
  h.glow = mat[0];
  h.refl = mat[1];
  h.color = ld3(mat + 2);
  return h;
}
template <int kPairs, int kSingles, int kComp = 0, int kFams = -1, int kCube = -1>
__device__ __forceinline__ Hit intersect_table(const float* P, const Layout& L, V4 o, V4 d) {
  bool aux;
  return intersect_table<kPairs, kSingles, kComp, kFams, kCube>(P, L, o, d, aux);
}

// The primitive of intersect_table's winning candidate ``k`` (its ``aux``
// for a composite), numbered as intersect numbers it: plane i, sphere j as
// n_spaces + j; then composite candidate c (numbered as fold_composites
// numbers them) as n_spaces + n_spheres + 2c + aux, which the adjoint
// reads the params by (composite_ref; kC: a table with composites). A
// pair's primitive is the wall its fold took.
template <int kPairs, int kSingles, bool kC = false>
__device__ __forceinline__ int table_primitive(const float* P, const Layout& L, int k, V4 o,
                                               V4 d, bool aux = false) {
  const Rec* T = fold_table(P, L);
  const Rec head = T[0];
  const int np = kPairs >= 0 ? kPairs : static_cast<int>(__float_as_uint(head.x));
  const int ns = kSingles >= 0 ? kSingles : static_cast<int>(__float_as_uint(head.y));
  uint32_t off;
  if (k < np) {
    const Rec r = T[1 + k];
    const int axis = kPairs > 0 ? k : static_cast<int>(__float_as_uint(r.z));
    const uint32_t walls = __float_as_uint(r.w);
    off = pair_takes_a(r.x, r.y, axis_of(o, axis), axis_of(d, axis)) ? walls & 0xFFFFu
                                                                       : walls >> 16;
  } else if (k < np + ns) {
    off = __float_as_uint(T[1 + np + 2 * (k - np) + 1].z);
  } else if (kC && k >= np + ns + L.n_spheres) {
    return L.n_spaces + L.n_spheres + 2 * (k - np - ns - L.n_spheres) + (aux ? 1 : 0);
  } else {
    return L.n_spaces + (k - np - ns);
  }
  return (static_cast<int>(off) - L.spaces) / kSpaceFloats;
}

// The fold a trace runs, as a template argument of setup_pixel and
// trace_sample: ParamsFold is intersect over the packed params, no hints
// (the gradient kernels without hints); TableFold<kPairs, kSingles> is
// intersect_table without composites (K1; negative: the counts read from
// the table); CompositeFold<kPairs, kSingles, kComp, kFams, kCube>
// intersect_table with them; GradTableFold<kPairs, kSingles> is TableFold
// with the winner numbered as intersect numbers it (table_primitive), which
// the adjoint reads the params by (the gradient kernels under the
// freeze_hints contract); GradCompositeFold<...> is CompositeFold with the
// winner numbered so, a composite candidate with its branch (the gradient
// kernels on a scene with composites, hinted or not). The table folds find
// every hit, distance and material of intersect, bitwise, and every normal
// component equal (the hinted resolvers write +0 where intersect writes
// flip * 0.0).
struct ParamsFold {};
template <int kPairs, int kSingles> struct TableFold {};
template <int kPairs, int kSingles, int kComp, int kFams, int kCube> struct CompositeFold {};
template <int kPairs, int kSingles> struct GradTableFold {};
template <int kPairs, int kSingles, int kComp, int kFams, int kCube> struct GradCompositeFold {};

__device__ __forceinline__ Hit fold(ParamsFold, const float* P, const Layout& L, V4 o, V4 d) {
  return intersect(P, L, o, d);
}
template <int kPairs, int kSingles>
__device__ __forceinline__ Hit fold(TableFold<kPairs, kSingles>, const float* P, const Layout& L,
                                    V4 o, V4 d) {
  return intersect_table<kPairs, kSingles>(P, L, o, d);
}
template <int kPairs, int kSingles, int kComp, int kFams, int kCube>
__device__ __forceinline__ Hit fold(CompositeFold<kPairs, kSingles, kComp, kFams, kCube>,
                                    const float* P, const Layout& L, V4 o, V4 d) {
  return intersect_table<kPairs, kSingles, kComp, kFams, kCube>(P, L, o, d);
}
template <int kPairs, int kSingles>
__device__ __forceinline__ Hit fold(GradTableFold<kPairs, kSingles>, const float* P,
                                    const Layout& L, V4 o, V4 d) {
  Hit h = intersect_table<kPairs, kSingles>(P, L, o, d);
  h.idx = h.hit ? table_primitive<kPairs, kSingles>(P, L, h.idx, o, d) : 0;
  return h;
}
template <int kPairs, int kSingles, int kComp, int kFams, int kCube>
__device__ __forceinline__ Hit fold(GradCompositeFold<kPairs, kSingles, kComp, kFams, kCube>,
                                    const float* P, const Layout& L, V4 o, V4 d) {
  bool aux;
  Hit h = intersect_table<kPairs, kSingles, kComp, kFams, kCube>(P, L, o, d, aux);
  h.idx = h.hit ? table_primitive<kPairs, kSingles, true>(P, L, h.idx, o, d, aux) : 0;
  return h;
}

// --- models/scene.py:intersect_scene_spec, the literal fold ---------------
//
// The closest hit over every primitive, each by its literal intersection,
// folded by ``closest`` in the JAX order: the planes, the spheres, the
// cylinders, the duocylinder, the hypercube (its first cell hit), the
// tiger. The planes and spheres come from the params by the layout; the
// composites' specs by the offsets that the fold table's records hold (a
// launch of this fold carries no hints, so the table's planes are all
// singles). kTrig: the reference's trigonometric sphere solution, in the
// spheres and in the cylinders. The winner is numbered by lit_code (the
// gradient kernels' sweep re-runs its test; K1 reads no number).
template <bool kTrig>
__device__ Hit intersect_spec(const float* P, const Layout& L, V4 o, V4 d) {
  Lit acc;
  acc.hit = false;
  int win = 0;
  // Folds c, numbered ``code``, into the closest hit (geometry.closest).
  const auto take = [&](const Lit& c, int code) { closest(c, code, acc, win); };
  for (int i = 0; i < L.n_spaces; ++i) {
    const int off = L.spaces + kSpaceFloats * i;
    take(space_lit(P + off, o, d), lit_code(off, kLitPlane));
  }
  for (int j = 0; j < L.n_spheres; ++j) {
    const int off = L.spheres + kSphereFloats * j;
    const float* s = P + off;
    take(sphere_lit<kTrig>(ld4(s), s[4], s + 5, o, d, true), lit_code(off, kLitSphere, true));
  }
  const Rec* T = fold_table(P, L);
  const Rec head = T[0];
  const int kinds = static_cast<int>(__float_as_uint(head.w));
  const int np = static_cast<int>(__float_as_uint(head.x));
  const int ns = static_cast<int>(__float_as_uint(head.y));
  const Rec* rec = T + 1 + np + 2 * ns + 2 * L.n_spheres;
  // A face record's material lies at its cylinder's spec + 13.
  const auto spec_of = [P](Rec face) { return P + __float_as_uint(face.w) - 13; };
  if (kinds & kCompCylinders) {
    const int n_cyl = static_cast<int>(__float_as_uint(head.z));
    for (int c = 0; c < n_cyl; ++c, rec += kCylinderRecs) {
      const float* spec = spec_of(rec[4]);
      take(cylinder_lit<kTrig>(spec, o, d, true), lit_code(spec - P, kLitCylinder, true));
    }
  }
  if (kinds & kCompUnion) {
    const float* arm;
    const Lit u = union_lit<kTrig>(spec_of(rec[8]), spec_of(rec[9]), o, d, arm);
    take(u, lit_code(arm - P, kLitCylinder, true));
    rec += kUnionRecs;
  }
  if (kinds & kCompHypercube) {
    const float* cells = hypercube_cells(P, rec);
    int cell;
    const Lit c = hypercube_lit(cells, o, d, cell);
    take(c, lit_code(cells + kCubeFloats * cell - P, kLitCell));
    rec += kHypercubeRecs;
  }
  if (kinds & kCompTiger) {
    const float* t = spec_of(rec[8]);
    int face;
    const Lit f = tiger_lit<kTrig>(t, o, d, face);
    take(f, lit_code(t + kCylinderFloats * (face & 3) - P, kLitCylinder, (face & 4) != 0));
  }

  Hit h;
  h.hit = acc.hit;
  h.idx = acc.hit ? win : 0;
  if (!acc.hit) {
    h.dist = 0.0f;
    h.norm = {0.0f, 0.0f, 0.0f, 0.0f};
    h.glow = h.refl = 0.0f;
    h.color = {0.0f, 0.0f, 0.0f};
    return h;
  }
  h.dist = acc.dist;
  h.norm = acc.norm;
  h.glow = acc.mat[0];
  h.refl = acc.mat[1];
  h.color = ld3(acc.mat + 2);
  return h;
}

// SpecFold<kTrig>: intersect_spec (K1's spec and trig launches, and the
// gradient kernels', whose blocks build its table, build_table_for, and
// whose sweep reads its winners' numbers, lit_code).
template <bool kTrig> struct SpecFold {};
template <bool kTrig>
__device__ __forceinline__ Hit fold(SpecFold<kTrig>, const float* P, const Layout& L, V4 o, V4 d) {
  return intersect_spec<kTrig>(P, L, o, d);
}

// The gradient kernels' fast fold over a hypercube without generators: the
// composite fold numbered as GradCompositeFold numbers it, but for the
// hypercube's candidate (the literal cell-by-cell test), whose winner is
// the cell that test hits, numbered by lit_code.
template <int kPairs, int kSingles, int kComp, int kFams>
__device__ __forceinline__ Hit fold(GradCompositeFold<kPairs, kSingles, kComp, kFams, kCubeCells>,
                                    const float* P, const Layout& L, V4 o, V4 d) {
  bool aux;
  Hit h = intersect_table<kPairs, kSingles, kComp, kFams, kCubeCells>(P, L, o, d, aux);
  if (!h.hit) {
    h.idx = 0;
    return h;
  }
  const Rec* T = fold_table(P, L);
  const Rec head = T[0];
  const int np = kPairs >= 0 ? kPairs : static_cast<int>(__float_as_uint(head.x));
  const int ns = kSingles >= 0 ? kSingles : static_cast<int>(__float_as_uint(head.y));
  const int kinds = static_cast<int>(__float_as_uint(head.w));
  const int n_cyl = (kinds & kCompCylinders) ? static_cast<int>(__float_as_uint(head.z)) : 0;
  const bool duo = (kinds & kCompUnion) != 0;
  // The hypercube's candidate and records follow the cylinders' and the
  // duocylinder's.
  if ((kinds & kCompHypercube) && h.idx == np + ns + L.n_spheres + n_cyl + (duo ? 2 : 0)) {
    const Rec* rec = T + 1 + np + 2 * ns + 2 * L.n_spheres + kCylinderRecs * n_cyl +
                     (duo ? kUnionRecs : 0);
    const float* cells = hypercube_cells(P, rec);
    int cell;
    hypercube_lit(cells, o, d, cell);
    h.idx = lit_code(cells + kCubeFloats * cell - P, kLitCell);
  } else {
    h.idx = table_primitive<kPairs, kSingles, true>(P, L, h.idx, o, d, aux);
  }
  return h;
}

// Whether a fold reads a hypercube's cells from its table (build_fold_table
// then writes a hypercube without generators): the fast fold's cells
// instances and the spec folds.
template <class Fold> constexpr bool kTableCells = false;
template <int kPairs, int kSingles, int kComp, int kFams>
constexpr bool kTableCells<CompositeFold<kPairs, kSingles, kComp, kFams, kCubeCells>> = true;
template <int kPairs, int kSingles, int kComp, int kFams>
constexpr bool kTableCells<GradCompositeFold<kPairs, kSingles, kComp, kFams, kCubeCells>> = true;
template <bool kTrig> constexpr bool kTableCells<SpecFold<kTrig>> = true;

// How a gradient fold numbers its winners, for the sweep: kLitNone, as
// intersect numbers them (and a composite candidate with its branch);
// kLitCells, so but for the cells of a hypercube without generators
// (lit_code); kLitSpec and kLitTrig, every winner by lit_code, its test the
// literal fold's (the trigonometric sphere solution under kLitTrig).
constexpr int kLitNone = 0, kLitCells = 1, kLitSpec = 2, kLitTrig = 3;
template <class Fold> constexpr int kLitFold = kLitNone;
template <int kPairs, int kSingles, int kComp, int kFams>
constexpr int kLitFold<GradCompositeFold<kPairs, kSingles, kComp, kFams, kCubeCells>> = kLitCells;
template <> constexpr int kLitFold<SpecFold<false>> = kLitSpec;
template <> constexpr int kLitFold<SpecFold<true>> = kLitTrig;

// Whether a gradient kernel's fold reads a table (GradTableFold,
// GradCompositeFold), which its blocks build after the params
// (build_table_for), and whether it folds composites.
template <class Fold> constexpr bool kGradTable = false;
template <int kPairs, int kSingles>
constexpr bool kGradTable<GradTableFold<kPairs, kSingles>> = true;
template <int kPairs, int kSingles, int kComp, int kFams, int kCube>
constexpr bool kGradTable<GradCompositeFold<kPairs, kSingles, kComp, kFams, kCube>> = true;
template <bool kTrig> constexpr bool kGradTable<SpecFold<kTrig>> = true;
template <class Fold> constexpr bool kGradComposite = false;
template <int kPairs, int kSingles, int kComp, int kFams, int kCube>
constexpr bool kGradComposite<GradCompositeFold<kPairs, kSingles, kComp, kFams, kCube>> = true;

// Modes<Fold>: Fold in the gradient kernels over K1's other configurations
// (modes.cuh), whose sampler is the launch's (kSamplerArg: the sampler's
// code | kepler's Halley steps << 2, read by sampler_arg), and every trait
// Fold's. The production kernels' folds run the poly sampler; the sampler
// needs no adjoint (its direction depends on the hashed uniforms alone).
// The launch's sampler rides in its descriptor (sampler_slot), which each
// kernel takes by value, and each block copies it to shared memory
// (build_table_for, modes_sampler): no state outlives a launch, so
// launches in several streams at once never read each other's sampler.
template <class Fold> struct Modes {};
template <class Fold>
__device__ __forceinline__ Hit fold(Modes<Fold>, const float* P, const Layout& L, V4 o, V4 d) {
  return fold(Fold{}, P, L, o, d);
}
template <class Fold> constexpr bool kModes = false;
template <class Fold> constexpr bool kModes<Modes<Fold>> = true;
template <class Fold> constexpr bool kTableCells<Modes<Fold>> = kTableCells<Fold>;
template <class Fold> constexpr bool kGradTable<Modes<Fold>> = kGradTable<Fold>;
template <class Fold> constexpr bool kGradComposite<Modes<Fold>> = kGradComposite<Fold>;
template <class Fold> constexpr int kLitFold<Modes<Fold>> = kLitFold<Fold>;
template <class Fold> constexpr int kFoldSampler = kSamplerPoly;
template <class Fold> constexpr int kFoldSampler<Modes<Fold>> = kSamplerArg;
// The block's copy of the launch's sampler argument under a Modes fold
// (modes.cuh defines it).
template <class Fold> __device__ int& modes_sampler(Modes<Fold>);
template <class Fold>
__device__ __forceinline__ int sampler_arg() {
  if constexpr (kModes<Fold>) {
    return modes_sampler(Fold{});
  } else {
    return 0;
  }
}

// The descriptor's word that carries a Modes launch's sampler argument: a
// slot the descriptor leaves empty, the last single plane's (2 n_pairs +
// n_singles planes are at most kMaxHintPlanes) or, with kMaxHintPlanes
// single planes and so no pair, the last pair's. Production launches
// never read it.
template <class HintsT>
__host__ __device__ __forceinline__ auto& sampler_slot(HintsT& H) {
  return H.n_singles < kMaxHintPlanes ? H.single[kMaxHintPlanes - 1]
                                      : H.pair[kMaxHintPlanes / 2 - 1];
}

// Records of a fold table without composites (build_fold_table): the
// header, one a pair, two a single plane and two a sphere.
__host__ __device__ __forceinline__ int plane_table_recs(const Layout& L, const Hints& H) {
  return 1 + H.n_pairs + 2 * (H.n_singles < 0 ? L.n_spaces : H.n_singles) + 2 * L.n_spheres;
}

// Records of a fold table with the descriptor's composites too.
__host__ __device__ __forceinline__ int composite_table_recs(const Layout& L, const Hints& H) {
  return plane_table_recs(L, H) + kCylinderRecs * (H.n_cylinders > 0 ? H.n_cylinders : 0) +
         (H.cylinders_union >= 0 ? kUnionRecs : 0) + (H.hypercube >= 0 ? kHypercubeRecs : 0) +
         (H.tiger >= 0 ? kTigerRecs : 0);
}

// The records of Fold's table over L and H (0: the fold reads no table).
template <class Fold>
__host__ __device__ __forceinline__ int table_recs_for(const Layout& L, const Hints& H) {
  if constexpr (kGradComposite<Fold> || kLitFold<Fold> >= kLitSpec) {
    return composite_table_recs(L, H);
  }
  return kGradTable<Fold> ? plane_table_recs(L, H) : 0;
}

// Where composite candidate ``c`` of the table's composite records (numbered
// as fold_composites numbers them) reads the params, for the adjoint: a
// family face's family spec (point, axis1, axis2 at spec..spec+11), its
// radius slot and its material; a hypercube pair's generators (point at
// spec, axes at spec+4, r at spec+20), its axis (in r) and the material of
// the cell its branch ``aux`` took. Read from the records' material
// offsets: a face's material lies at its family spec + 13 (the tiger's
// outer faces take their inner cylinder's), a cell's at hypercube + 26i + 21.
struct CompRef {
  bool cube;
  int spec, r, mat;
};
__device__ __forceinline__ CompRef composite_ref(const float* P, const Layout& L, int c,
                                                 bool aux) {
  const Rec* T = fold_table(P, L);
  const Rec head = T[0];
  const int np = static_cast<int>(__float_as_uint(head.x));
  const int ns = static_cast<int>(__float_as_uint(head.y));
  const int kinds = static_cast<int>(__float_as_uint(head.w));
  const Rec* rec = T + 1 + np + 2 * ns + 2 * L.n_spheres;
  CompRef out;
  out.cube = false;
  Rec face;
  bool outer = false;
  if (kinds & kCompCylinders) {
    const int n_cyl = static_cast<int>(__float_as_uint(head.z));
    if (c < n_cyl) {
      face = rec[kCylinderRecs * c + 4];
      c = -1;
    } else {
      c -= n_cyl;
      rec += kCylinderRecs * n_cyl;
    }
  }
  if (c >= 0 && (kinds & kCompUnion)) {
    if (c < 2) {
      face = rec[8 + c];
      c = -1;
    } else {
      c -= 2;
      rec += kUnionRecs;
    }
  }
  if (c >= 0 && (kinds & kCompHypercube)) {
    if (c < 4) {
      const Rec m = rec[7];
      const uint32_t mats = __float_as_uint(c == 0 ? m.x : c == 1 ? m.y : c == 2 ? m.z : m.w);
      const int hc = static_cast<int>(__float_as_uint(m.x) & 0xFFFFu) - 21;
      out.cube = true;
      out.spec = hc + 8 * kCubeFloats;
      out.r = c;
      out.mat = static_cast<int>(aux ? mats & 0xFFFFu : mats >> 16);
      return out;
    }
    c -= 4;
    rec += kHypercubeRecs;
  }
  if (c >= 0) {  // the tiger: candidates 0-1 on family A, 2-3 on family B; odd: r_out
    face = rec[8 + c];
    outer = (c & 1) != 0;
  }
  out.mat = static_cast<int>(__float_as_uint(face.w));
  out.spec = out.mat - 13;
  out.r = out.spec + (outer ? kCylinderFloats : 0) + 12;
  return out;
}

// Bytes of the params, padded to 16 when a table of ``recs`` records
// follows them (fold_table), and of the table.
__host__ __device__ __forceinline__ size_t params_table_bytes(int P, int recs) {
  return recs > 0 ? static_cast<size_t>((P + 3) / 4 + recs) * sizeof(Rec)
                  : static_cast<size_t>(P) * sizeof(float);
}

// Direction update of one bounce on a live lane: Bernoulli mirror vs
// diffuse; a diffuse lane draws three more uniforms for the sampler.
// ``mirror`` and ``v`` (the diffuse sample before redirect) report the
// outcome, for the adjoint.
template <int kStub = kStubNone, int kSampler = kSamplerPoly>
__device__ __forceinline__ V4 scatter(V4 norm, V4 mirrored, float refl_prob, uint32_t bits,
                                      uint32_t seed, uint32_t& counter, bool& mirror, V4& v,
                                      int iters = 0) {
  float u_refl = draw<kStub>(bits, seed, counter);
  mirror = u_refl <= refl_prob;
  if (mirror) return mirrored;
  float u_w = draw<kStub>(bits, seed, counter);
  float u_z = draw<kStub>(bits, seed, counter);
  float u_fi = draw<kStub>(bits, seed, counter);
  v = direction_from_uniforms<kStub, kSampler>(u_w, u_z, u_fi, iters);
  return redirect(v, norm);
}

// The reference's draws on a trace's final iteration, whose direction is
// never used (renderer.py:365-375): one Bernoulli on a live lane, three
// more on a diffuse one. Only a sequential stream pays them, so that the
// next sample's stream is the reference's.
template <int kStub = kStubNone>
__device__ __forceinline__ void dead_draws(float refl_prob, uint32_t bits, uint32_t seed,
                                           uint32_t& counter) {
  if (draw<kStub>(bits, seed, counter) > refl_prob) {
    for (int k = 0; k < 3; ++k) draw<kStub>(bits, seed, counter);
  }
}

// --- one pixel: primary ray and bounce 0 (renderer.precompute_bounce0) --
struct Pixel {
  float scr_x, scr_y, mx, my;
  V4 a;       // unnormalized primary direction
  V4 d0;      // primary direction
  V4 focus;
  uint32_t bits;
  Hit h0;
  V3 result0, throughput0;
  V4 o0, mirrored0;
};

template <class Fold = ParamsFold>
__device__ Pixel setup_pixel(const float* P, const Layout& L, int view, int px, int py,
                             int width, int height, float small_indent) {
  Pixel p;
  // Primary ray of this pixel's view (row 0 at the top).
  p.scr_x = (static_cast<float>(px) + 0.5f) / static_cast<float>(width);
  p.scr_y = (static_cast<float>(py) + 0.5f) / static_cast<float>(height);
  const int V = L.n_views;
  V4 top = {P[L.top + view], P[L.top + V + view], P[L.top + 2 * V + view],
            P[L.top + 3 * V + view]};
  V4 right = {P[L.right + view], P[L.right + V + view], P[L.right + 2 * V + view],
              P[L.right + 3 * V + view]};
  p.mx = (p.scr_x - 0.5f) * P[L.mtr_width];
  p.my = (0.5f - p.scr_y) * P[L.mtr_height];
  p.a = add4(add4(ld4(P + L.vec_to_mtr), mul4s(top, p.my)), mul4s(right, p.mx));
  p.d0 = mul4s(p.a, 1.0f / sqrtf(dot4(p.a, p.a)));
  p.focus = ld4(P + L.focus);
  p.bits = __float_as_uint(p.scr_x) ^ (__float_as_uint(p.scr_y) << 9);

  // Bounce 0, shared by every sample (renderer.precompute_bounce0).
  p.h0 = fold(Fold{}, P, L, p.focus, p.d0);
  p.result0 = {0.0f, 0.0f, 0.0f};
  if (L.env_enabled && !p.h0.hit) p.result0 = add3(p.result0, final_light(P + L.env, p.d0));
  p.throughput0 = {1.0f, 1.0f, 1.0f};
  p.o0 = p.focus;
  if (p.h0.hit) {
    p.result0 = add3(p.result0, mul3s(p.h0.color, p.h0.glow));
    p.throughput0 = p.h0.color;
    p.o0 = add4(add4(p.focus, mul4s(p.d0, p.h0.dist)), mul4s(p.h0.norm, small_indent));
  }
  p.mirrored0 = reflect(p.d0, p.h0.norm);
  return p;
}

// The RNG stream of a trace, a template argument: kRngPerSample, sample
// s's own stream from the seed (the production kernels); kRngArg, a launch
// argument picks that or the sequential stream.
constexpr int kRngPerSample = 0, kRngArg = -1;

// The trace of sample ``s`` from the hoisted bounce 0 (renderer.trace_rays);
// returns its light. kStub selects a measurement variant's stubs
// (kStubNone: the production trace), Fold the fold, kSampler the sampler
// (``iters``: kepler's Halley steps). With kRngArg and ``sequential`` the
// sample draws from the pixel's bits and ``carried``'s counter, pays the
// dead draws of its final iteration and leaves its counter in ``carried``
// for the next sample; otherwise from its own stream.
template <int kStub, class Fold, int kSampler, int kRng>
__device__ V3 trace_sample(const float* P, const Layout& L, const Pixel& p, int s, uint32_t seed,
                           int reflections, float small_indent, bool sequential, int iters,
                           uint32_t& carried) {
  const bool seq = kRng != kRngPerSample && sequential;
  V3 result = p.result0;
  if (reflections <= 0 || !p.h0.hit) {
    if constexpr (kRng != kRngPerSample) {
      if (seq && p.h0.hit) dead_draws<kStub>(p.h0.refl, p.bits, seed, carried);
    }
    return result;
  }
  const bool env_on = L.env_enabled != 0;
  const float* env = P + L.env;
  const uint32_t bits =
      seq ? p.bits : p.bits ^ hash_u32((static_cast<uint32_t>(s) + 1u) * kSampleFold);
  uint32_t counter = seq ? carried : seed;
  bool mirror;
  V4 v = {0.0f, 0.0f, 0.0f, 0.0f};
  V4 d = scatter<kStub, kSampler>(p.h0.norm, p.mirrored0, p.h0.refl, bits, seed, counter, mirror,
                                  v, iters);
  V4 o = p.o0;
  V3 throughput = p.throughput0;
  bool alive = true;
  for (int b = 1; b < reflections && alive; ++b) {
    Hit h = fold(Fold{}, P, L, o, d);
    if (env_on && !h.hit) result = add3(result, mul3(throughput, final_light(env, d)));
    alive = h.hit;
    if (alive) {
      result = add3(result, mul3(mul3s(h.color, h.glow), throughput));
      throughput = mul3(throughput, h.color);
      o = add4(add4(o, mul4s(d, h.dist)), mul4s(h.norm, small_indent));
      d = scatter<kStub, kSampler>(h.norm, reflect(d, h.norm), h.refl, bits, seed, counter,
                                   mirror, v, iters);
    }
  }
  if (alive) {  // the last bounce only shades
    Hit h = fold(Fold{}, P, L, o, d);
    if (env_on && !h.hit) result = add3(result, mul3(throughput, final_light(env, d)));
    if (h.hit) {
      result = add3(result, mul3(mul3s(h.color, h.glow), throughput));
      if constexpr (kRng != kRngPerSample) {
        if (seq) dead_draws<kStub>(h.refl, bits, seed, counter);
      }
    }
  }
  if constexpr (kRng != kRngPerSample) {
    if (seq) carried = counter;
  }
  return result;
}

// The production trace: sample s's own stream, the poly sampler.
template <int kStub = kStubNone, class Fold = ParamsFold>
__device__ __forceinline__ V3 trace_sample(const float* P, const Layout& L, const Pixel& p, int s,
                                           uint32_t seed, int reflections, float small_indent) {
  uint32_t unused = seed;
  return trace_sample<kStub, Fold, kSamplerPoly, kRngPerSample>(P, L, p, s, seed, reflections,
                                                               small_indent, false, 0, unused);
}

// --- the host's checks of a hints descriptor (K1's launch and the
// gradient kernels') -------------------------------------------------

// Whether a composite's offset is none (-1) or holds ``floats`` floats
// inside the params.
inline bool offset_valid(const Layout& L, int offset, int floats) {
  return offset == -1 || (offset >= 0 && offset + floats <= L.size);
}

// Whether a family's axis hint is none (-1) or two different components.
inline bool family_hint_valid(int code) {
  return code == -1 || (code >= 0 && code < 16 && (code & 3) != (code >> 2));
}

// Whether the descriptor's composites are ones the table can hold: counts
// in range, every spec inside the params, every axis hint well formed; a
// hypercube without generators (kCubeCells) only where ``cells`` allows it
// (a launch of a fold that reads cells: kTableCells).
inline bool composites_valid(const Layout& L, const Hints& H, bool cells = false) {
  const bool bare = cells && H.hypercube_axes == kCubeCells;
  if (H.n_cylinders < 0 || H.n_cylinders > kMaxCylinders ||
      (H.n_cylinders > 0) != (H.cylinders >= 0) ||
      !offset_valid(L, H.cylinders, kCylinderFloats * H.n_cylinders) ||
      !offset_valid(L, H.cylinders_union, 2 * kCylinderFloats) ||
      !offset_valid(L, H.hypercube, bare ? 8 * kCubeFloats : kHypercubeFloats) ||
      !offset_valid(L, H.tiger, kTigerFloats) || (H.hypercube_axes < -1 && !bare) ||
      H.hypercube_axes > 0xFFF) {
    return false;
  }
  for (int i = 0; i < H.n_cylinders; ++i) {
    if (!family_hint_valid(H.cylinder_axes[i])) return false;
  }
  return family_hint_valid(H.union_axes[0]) && family_hint_valid(H.union_axes[1]) &&
         family_hint_valid(H.tiger_axes[0]) && family_hint_valid(H.tiger_axes[1]);
}

// Whether the descriptor is one the table can hold and fold: the
// composites valid, counts in range, pairs' axes 0-3, live masks 0-15, and
// the pairs' and singles' plane indices cover each of the layout's planes
// exactly once (a pair's two planes differ). Without hints (n_singles -1)
// the fold covers every plane itself. ``cells``: as composites_valid's.
inline bool hints_valid(const Layout& L, const Hints& H, bool cells = false) {
  if (!composites_valid(L, H, cells)) return false;
  if (H.n_singles < 0) return H.n_singles == -1 && H.n_pairs == 0;
  if (H.n_pairs < 0 || H.n_pairs > kMaxHintPlanes / 2 || H.n_singles > kMaxHintPlanes ||
      L.n_spaces > kMaxHintPlanes || 2 * H.n_pairs + H.n_singles != L.n_spaces) {
    return false;
  }
  uint64_t seen = 0;
  const auto cover = [&](int plane) {
    const uint64_t bit = uint64_t{1} << plane;
    const bool fresh = plane < L.n_spaces && (seen & bit) == 0;
    seen |= bit;
    return fresh;
  };
  for (int k = 0; k < H.n_pairs; ++k) {
    const int i = H.pair[k] & 0xFF, j = (H.pair[k] >> 8) & 0xFF, axis = H.pair[k] >> 16;
    if (!cover(i) || !cover(j) || axis < 0 || axis > 3) return false;
  }
  for (int k = 0; k < H.n_singles; ++k) {
    const int live = H.single[k] >> 8;
    if (!cover(H.single[k] & 0xFF) || live < 0 || live > 15) return false;
  }
  // 2 * n_pairs + n_singles planes, none repeated, all below n_spaces: all.
  return true;
}

// The descriptor from the host's int[kHintInts] (ops/cuda/megakernel.py
// hint_table).
inline Hints hints_from(const int* words) {
  Hints H;
  int* dst = reinterpret_cast<int*>(&H);
  for (int i = 0; i < kHintInts; ++i) dst[i] = words[i];
  return H;
}

// The library composite scene whose own fold instance a descriptor takes
// (K1's and the gradient kernels'): its one composite kind when the
// descriptor is hinted (n_singles >= 0) and that kind's axis hints are the
// library's (kLibraryFams, kLibraryCube); 0 otherwise (the generic
// instance).
inline int library_composite(const Hints& H) {
  const int kinds = composite_kinds(H);
  if (H.n_singles < 0) return 0;
  const bool fams =
      kinds == kCompUnion
          ? H.union_axes[0] == (kLibraryFams & 15) && H.union_axes[1] == kLibraryFams >> 4
          : H.tiger_axes[0] == (kLibraryFams & 15) && H.tiger_axes[1] == kLibraryFams >> 4;
  if ((kinds == kCompUnion || kinds == kCompTiger) && fams) return kinds;
  return kinds == kCompHypercube && H.hypercube_axes == kLibraryCube ? kinds : 0;
}

// Whether pair k of the descriptor lies on axis k, for every pair.
inline bool pairs_in_axis_order(const Hints& H) {
  for (int k = 0; k < H.n_pairs; ++k) {
    if ((H.pair[k] >> 16) != k) return false;
  }
  return true;
}

}  // namespace
