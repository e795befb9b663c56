// Native 4D camera/input state machine of the interactive viewer.
//
// The port's own copy of the JAX package's native/controls.cc, the same
// code: spherical angles fi/te/psi (fi wraps to (-pi, pi], te clamps to
// [-pi/2, pi/2], psi wraps or clamps to a configured range), the basis
// built by three Givens rotations, and 8-key movement along the partially
// rotated bases.
//
// It runs on the host between device launches and holds the camera state
// when the viewer drives the renderer (engine.py, use_native_controls).
// camera.py holds the same math in torch for the Python controls; tests
// hold the two against each other and this state against the JAX
// package's, bitwise.

#include <cmath>
#include <cstdint>

namespace {

constexpr float kPi = 3.14159265f;

struct Vec4 {
  float x, y, z, w;
};

Vec4 scale(const Vec4& v, float s) { return {v.x * s, v.y * s, v.z * s, v.w * s}; }
Vec4 add(const Vec4& a, const Vec4& b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w};
}
Vec4 sub(const Vec4& a, const Vec4& b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w};
}
float norm(const Vec4& v) {
  return std::sqrt(v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w);
}

// Rotate two basis vectors in their shared plane (controls.cpp:64-69).
void rotate_pair(float angle, Vec4* a, Vec4* b) {
  float s = std::sin(angle), c = std::cos(angle);
  Vec4 na = add(scale(*a, c), scale(*b, s));
  Vec4 nb = add(scale(*a, -s), scale(*b, c));
  *a = na;
  *b = nb;
}

float normalize_angle(float a) {
  // Wrap to (-pi, pi] (src/util/math.cpp:24-28).
  float two_pi = 2.0f * kPi;
  float wrapped = std::fmod(a + kPi, two_pi);
  if (wrapped < 0) wrapped += two_pi;
  wrapped -= kPi;
  if (wrapped <= -kPi) wrapped += two_pi;
  return wrapped;
}

float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace

extern "C" {

// Mirror of the state the reference keeps in controls.cpp globals.
// Field order is the ctypes contract (native/binding.py FourdCameraState).
struct FourdCameraState {
  // spherical angles (radians)
  float fi, te, psi;
  // psi constraint: if constrain_psi != 0, psi clamps to
  // [psi_center - psi_radius, psi_center + psi_radius], else wraps.
  int32_t constrain_psi;
  float psi_center, psi_radius;
  // position
  float focus[4];
  // derived bases (outputs of fourd_camera_update)
  float forward[4], top[4], right[4], w_drct[4];
  float h_forward[4], h_right[4], v_top[4];
};

// Movement key bitmask (controls.cpp:95-100 moveState).
enum {
  kKeyForward = 1 << 0,
  kKeyBack = 1 << 1,
  kKeyRight = 1 << 2,
  kKeyLeft = 1 << 3,
  kKeyTop = 1 << 4,
  kKeyDown = 1 << 5,
  kKeyWPos = 1 << 6,
  kKeyWNeg = 1 << 7,
};

static void store(float* dst, const Vec4& v) {
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// Basis from angles (controls.cpp:72-86): psi rotates (top, w), fi
// rotates (forward, right), te rotates (forward, top); the partially
// rotated bases are saved for movement.
void fourd_camera_update(FourdCameraState* s) {
  Vec4 forward = {0, 1, 0, 0};
  Vec4 top = {0, 0, 1, 0};
  Vec4 right = {1, 0, 0, 0};
  Vec4 w = {0, 0, 0, 1};

  rotate_pair(s->psi, &top, &w);
  Vec4 vertical_top = top;

  rotate_pair(s->fi, &forward, &right);
  Vec4 horizontal_forward = forward;
  Vec4 horizontal_right = right;

  rotate_pair(s->te, &forward, &top);

  store(s->forward, forward);
  store(s->top, top);
  store(s->right, right);
  store(s->w_drct, w);
  store(s->h_forward, horizontal_forward);
  store(s->h_right, horizontal_right);
  store(s->v_top, vertical_top);
}

// Mouse-look / wheel rotation with normalization (controls.cpp:173-191);
// returns 1 (accumulation must reset) — mirrors frameNumber=1 there.
int32_t fourd_camera_rotate(FourdCameraState* s, float d_fi, float d_te,
                            float d_psi) {
  s->fi = normalize_angle(s->fi + d_fi);
  s->te = clampf(s->te + d_te, -kPi / 2, kPi / 2);
  float psi = s->psi + d_psi;
  if (s->constrain_psi) {
    psi = clampf(psi, s->psi_center - s->psi_radius,
                 s->psi_center + s->psi_radius);
  } else {
    psi = normalize_angle(psi);
  }
  s->psi = psi;
  fourd_camera_update(s);
  return 1;
}

// 8-key movement along the partially-rotated bases (controls.cpp:118-134).
// Returns 1 if the focus moved (accumulation must reset), else 0.
int32_t fourd_camera_move(FourdCameraState* s, uint32_t keys, float seconds,
                          float speed) {
  Vec4 drct = {0, 0, 0, 0};
  Vec4 hf = {s->h_forward[0], s->h_forward[1], s->h_forward[2], s->h_forward[3]};
  Vec4 hr = {s->h_right[0], s->h_right[1], s->h_right[2], s->h_right[3]};
  Vec4 vt = {s->v_top[0], s->v_top[1], s->v_top[2], s->v_top[3]};
  Vec4 w = {s->w_drct[0], s->w_drct[1], s->w_drct[2], s->w_drct[3]};

  if (keys & kKeyForward) drct = add(drct, hf);
  if (keys & kKeyBack) drct = sub(drct, hf);
  if (keys & kKeyTop) drct = add(drct, vt);
  if (keys & kKeyDown) drct = sub(drct, vt);
  if (keys & kKeyRight) drct = add(drct, hr);
  if (keys & kKeyLeft) drct = sub(drct, hr);
  if (keys & kKeyWPos) drct = add(drct, w);
  if (keys & kKeyWNeg) drct = sub(drct, w);

  float n = norm(drct);
  if (n <= 0.0f) return 0;
  Vec4 step = scale(drct, seconds * speed / n);
  s->focus[0] += step.x;
  s->focus[1] += step.y;
  s->focus[2] += step.z;
  s->focus[3] += step.w;
  return 1;
}

}  // extern "C"
