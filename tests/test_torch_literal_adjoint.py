"""The literal folds' reverse partials (csrc/adjoint.cuh lit_adj over the
literal intersections of csrc/trace.cuh), compiled for the host, against
torch autograd over the port's plain literal intersections
(ops/geometry.py).

The gradient kernels differentiate a literal fold's winner through its own
literal test: the hyperplane (space_intersection), the hypersphere by the
quadratic and by the reference's trigonometric solution
(sphere_intersection, sphere_intersection_trig), the cylinder on either
root and either solution (cylinder_intersection, the duocylinder's arms
and the tiger's faces), and the hypercube's cell (cube_intersection). Each
case here draws rays from a numpy seed: rays at random, rays whose line
passes the circle within 1e-3 to 1e-6 of its radius (near-tangent), and
rays from within 1e-4 of the sphere's center or the cylinder's axis plane
(degenerate origins, where the fold zeroes b or cos_opa), four from the
center itself (l = 0, where the trigonometric solution takes the norm's
subgradient 0: geometry._Norm) and four aimed at it (cos_opa = 1, where it
takes acos' as 0: geometry._acos). On every ray the host's literal test
must give torch's hit, its distance (rtol 1e-5; 1e-4 under the
trigonometric solution, whose law of cosines near a tangent amplifies the
ulp by which the host's libm and torch's cos and asin differ) and its
normal; on every hit, with seeded random cotangents of the distance and of
the normal, the host's partials of the primitive's slots and of the ray's
origin and direction must match torch's per ray within the mixed-scale
relative error 1e-3 of the gradient tests (|a - b| / max(|b|, 1e-3 max|b|
+ 1e-8) over the ray's partials). Under the trigonometric solution a ray's
bound adds the conditioning of asin' at sin_oap = s: an ulp of s (the
host's libm and torch round acos and sin apart) moves 1 / sqrt(1 - s^2) by
s^2 / (1 - s^2) ulps, so the bound is 1e-3 + 8 ulps * s^2 / (1 - s^2)
(1.3e-2 at the seed's nearest tangent, s = 0.99998945, where the two sides
part by 1.0e-2; 1e-3 elsewhere). The radius-0 guard
(geometry._radius_guard) holds on the host too: a circle of radius 0 never
hits.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fourd_ray_tracing_tpu_torch.ops import geometry
from fourd_ray_tracing_tpu_torch.ops.cuda import build
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec3, Vec4

from test_torch_adjoint_host import SHIM, ptr

HARNESS = r"""
#include "adjoint.cuh"

struct DenseAcc {
  float* g;
  void add(const Slots& c) {
    if (c.key < 0) return;
    for (int k = 0; k < c.n; ++k) g[c.key + k * c.stride] += c.v[k];
  }
};

// The literal test of the primitive whose spec is ``spec`` (its kind
// kLit*, and a cylinder's root) on n rays, and on each hit the reverse
// partials of g_dist * dist + dot(g_norm, norm): the spec's (kSpecFloats
// a ray), the origin's and the direction's.
constexpr int kSpecFloats = 32;
extern "C" void lit_host(int kind, int trig, int outer, const float* spec, int n, const float* o,
                         const float* d, const float* g_dist, const float* g_norm, int* hit,
                         float* dist, float* norm, float* g_spec, float* g_o, float* g_d) {
  const LitRef ref{0, kind, outer != 0};
  const int idx = lit_code(0, kind, outer != 0);
  for (int i = 0; i < n; ++i) {
    const V4 oi = ld4(o + 4 * i), di = ld4(d + 4 * i);
    const Lit l = trig ? lit_test<true>(spec, ref, oi, di) : lit_test<false>(spec, ref, oi, di);
    hit[i] = l.hit;
    dist[i] = l.dist;
    put4(norm + 4 * i, l.norm);
    if (!l.hit) continue;
    DenseAcc acc{g_spec + kSpecFloats * i};
    V4 go = {0.0f, 0.0f, 0.0f, 0.0f}, gd = go;
    const V4 gn = ld4(g_norm + 4 * i);
    if (trig) {
      lit_adj<true>(spec, oi, di, idx, g_dist[i], gn, 0.0f, V3{0.0f, 0.0f, 0.0f}, go, gd, acc);
    } else {
      lit_adj<false>(spec, oi, di, idx, g_dist[i], gn, 0.0f, V3{0.0f, 0.0f, 0.0f}, go, gd, acc);
    }
    put4(g_o + 4 * i, go);
    put4(g_d + 4 * i, gd);
  }
}
"""

SPEC_FLOATS = 32
# trace.cuh's kLit* kinds.
PLANE, SPHERE, CYLINDER, CELL = 0, 1, 2, 3


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the kernel's device math for the host")
    work = tmp_path_factory.mktemp("literal_adjoint")
    (work / "cuda_runtime.h").write_text(SHIM)
    (work / "harness.cpp").write_text(HARNESS)
    so = work / "liblit.so"
    proc = subprocess.run(
        [cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC", *build.DEFINES,
         f"-I{work}", f"-I{build.CSRC_DIR}", "-o", str(so), str(work / "harness.cpp")],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(so))


def unit(rng, n=None):
    v = rng.normal(size=4 if n is None else (n, 4))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def frame(rng):
    """Four orthonormal float32 vectors."""
    q, _ = np.linalg.qr(rng.normal(size=(4, 4)))
    return q.T.astype(np.float32)


def sphere_rays(rng, center, r, n):
    """Rays at random, near-tangent and from a degenerate origin, for a
    circle of radius r at ``center`` in the space its rays live in (a
    cylinder's rays are drawn in its projected 2-plane and lifted)."""
    o = center + rng.uniform(-3, 3, (n, 4)).astype(np.float32)
    d = unit(rng, n)
    k = n // 4
    # Aimed at the center with an offset: about half hit.
    aim = center + rng.normal(0, r, (k, 4)).astype(np.float32) - o[:k]
    d[:k] = aim / np.linalg.norm(aim, axis=1, keepdims=True)
    # Near-tangent: the line passes the center at (1 - eps) r.
    for i in range(k, 2 * k):
        u = unit(rng)
        w = unit(rng)
        w = w - u * np.dot(w, u)
        w /= np.linalg.norm(w)
        eps = 10.0 ** rng.uniform(-6, -3)
        o[i] = center - 3.0 * r * u + (1 - eps) * r * w
        d[i] = u
    # Degenerate origins: within 1e-4 of the center.
    o[2 * k:3 * k] = center + rng.uniform(-1e-4, 1e-4, (k, 4)).astype(np.float32)
    return o.astype(np.float32), d.astype(np.float32)


def host(lib, kind, trig, outer, spec, o, d, g_dist, g_norm):
    n = len(o)
    spec = np.ascontiguousarray(spec, np.float32)
    out = dict(hit=np.zeros(n, np.int32), dist=np.zeros(n, np.float32),
               norm=np.zeros((n, 4), np.float32), g_spec=np.zeros((n, SPEC_FLOATS), np.float32),
               g_o=np.zeros((n, 4), np.float32), g_d=np.zeros((n, 4), np.float32))
    lib.lit_host(ctypes.c_int(kind), ctypes.c_int(int(trig)), ctypes.c_int(int(outer)), ptr(spec),
                 ctypes.c_int(n), ptr(o), ptr(d), ptr(g_dist), ptr(g_norm), ptr(out["hit"]),
                 ptr(out["dist"]), ptr(out["norm"]), ptr(out["g_spec"]), ptr(out["g_o"]),
                 ptr(out["g_d"]))
    out["hit"] = out["hit"].astype(bool)
    return out


def lanes(values, n):
    """Per-ray leaves (n,) of the float32 values, requiring grad."""
    return [torch.full((n,), float(v), dtype=torch.float32, requires_grad=True) for v in values]


def vec(ts):
    return Vec4(*ts)


def material(n):
    z = torch.zeros(n)
    return geometry.Material(z, z, Vec3(z, z, z))


def plain(kind, trig, outer, spec, o, d, g_dist, g_norm):
    """torch's hit, dist, norm and per-ray partials of sum over hits of
    g_dist * dist + dot(g_norm, norm): spec slots (n, SPEC_FLOATS), o, d."""
    n = len(o)
    leaves = lanes(spec[:{PLANE: 8, SPHERE: 5, CYLINDER: 13, CELL: 21}[kind]], n)
    to = [torch.tensor(o[:, k], requires_grad=True) for k in range(4)]
    td = [torch.tensor(d[:, k], requires_grad=True) for k in range(4)]
    mat = material(n)
    if kind == PLANE:
        inter = geometry.space_intersection(vec(leaves[:4]), vec(leaves[4:8]), mat, vec(to),
                                            vec(td))
    elif kind == SPHERE:
        fn = geometry.sphere_intersection_trig if trig else geometry.sphere_intersection
        inter = fn(vec(leaves[:4]), leaves[4], mat, vec(to), vec(td), True)
    elif kind == CYLINDER:
        inter = geometry.cylinder_intersection(vec(leaves[:4]), vec(leaves[4:8]),
                                               vec(leaves[8:12]), leaves[12], mat, vec(to),
                                               vec(td), outer, trig)
    else:
        cube = geometry.CubeSpec(vec(leaves[:4]), vec(leaves[4:8]), vec(leaves[8:12]),
                                 vec(leaves[12:16]), vec(leaves[16:20]), leaves[20], mat)
        inter = geometry.cube_intersection(cube, vec(to), vec(td))
    gd = torch.from_numpy(g_dist)
    gn = torch.from_numpy(g_norm)
    value = gd * inter.dist + sum(gn[:, k] * c for k, c in enumerate(inter.norm))
    total = torch.where(inter.hit, value, torch.zeros(())).sum()
    grads = torch.autograd.grad(total, leaves + to + td, allow_unused=True)
    grads = [torch.zeros(n) if g is None else g for g in grads]
    g_spec = np.zeros((n, SPEC_FLOATS), np.float32)
    m = len(leaves)
    g_spec[:, :m] = torch.stack(grads[:m], 1).numpy()
    return dict(hit=inter.hit.numpy(), dist=inter.dist.detach().numpy(),
                norm=torch.stack(list(inter.norm), 1).detach().numpy(), g_spec=g_spec,
                g_o=torch.stack(grads[m:m + 4], 1).numpy(),
                g_d=torch.stack(grads[m + 4:], 1).numpy())


def asin_condition(spec, o, d):
    """s^2 / (1 - s^2) per ray, s the trigonometric sphere's sin_oap in
    float64 (0 on a degenerate origin)."""
    po = spec[:4].astype(np.float64) - o
    l = np.linalg.norm(po, axis=1)
    q = np.clip(np.einsum("ij,ij->i", po, d) / np.maximum(l, 1e-30), -1.0, 1.0)
    s = np.minimum(l * np.sqrt(1.0 - q * q) / spec[4], 1.0 - 1e-12)
    return s * s / (1.0 - s * s)


def check(lib, kind, trig, outer, spec, o, d, seed):
    rng = np.random.default_rng(seed)
    g_dist = rng.normal(size=len(o)).astype(np.float32)
    g_norm = rng.normal(size=(len(o), 4)).astype(np.float32)
    got = host(lib, kind, trig, outer, spec, o, d, g_dist, g_norm)
    ref = plain(kind, trig, outer, spec, o, d, g_dist, g_norm)
    np.testing.assert_array_equal(got["hit"], ref["hit"])
    hit = ref["hit"]
    assert 4 < hit.sum() < len(o), hit.sum()
    np.testing.assert_allclose(got["dist"][hit], ref["dist"][hit], rtol=1e-4 if trig else 1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["norm"][hit], ref["norm"][hit], rtol=1e-4, atol=1e-5)
    a = np.concatenate([got["g_spec"], got["g_o"], got["g_d"]], 1)[hit]
    b = np.concatenate([ref["g_spec"], ref["g_o"], ref["g_d"]], 1)[hit]
    assert np.isfinite(a).all() and np.isfinite(b).all()
    scale = np.maximum(np.abs(b), 1e-3 * np.abs(b).max(1, keepdims=True) + 1e-8)
    rel = (np.abs(a - b) / scale).max(1)
    bound = np.full(len(rel), 1e-3)
    if trig and kind == SPHERE:
        bound += 8 * 2.0 ** -24 * asin_condition(spec, o, d)[hit]
    assert (rel < bound).all(), (rel.max(), np.argmax(rel / bound))
    return hit


@pytest.mark.parametrize("trig", [False, True], ids=["spec", "trig"])
def test_sphere_adjoint_matches_autograd(lib, trig):
    rng = np.random.default_rng(11)
    center = rng.uniform(-1, 1, 4).astype(np.float32)
    r = np.float32(0.9)
    o, d = sphere_rays(rng, center, r, 256)
    o[192:196] = center  # from the center itself: l = 0, the norm's subgradient
    # Aimed at the center from a distance: cos_opa rounds to 1, acos' is taken as 0.
    d[196:200] = center - o[196:200]
    d[196:200] /= np.linalg.norm(d[196:200], axis=1, keepdims=True)
    spec = np.concatenate([center, [r, 0, 0, 0, 0, 0]])
    hit = check(lib, SPHERE, trig, True, spec, o, d, 1)
    assert hit[128:192].any() and hit[:64].any() and hit[192:200].all()


@pytest.mark.parametrize("trig", [False, True], ids=["spec", "trig"])
@pytest.mark.parametrize("outer", [True, False], ids=["outer", "inner"])
def test_cylinder_adjoint_matches_autograd(lib, trig, outer):
    """A turned cylinder; rays drawn about its axis plane's point (so that
    their projections pass the circle near-tangent or start on the axis
    plane), with a random component along the axes."""
    rng = np.random.default_rng(12)
    f = frame(rng)
    point = rng.uniform(-1, 1, 4).astype(np.float32)
    r = np.float32(0.7)
    o, d = sphere_rays(rng, point, r, 256)
    along = rng.normal(size=(256, 2)).astype(np.float32)
    o = (o + along[:, :1] * f[0] + along[:, 1:] * f[1]).astype(np.float32)
    d = (d + 0.3 * (along[:, 1:] * f[0] - along[:, :1] * f[1])).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    spec = np.concatenate([point, f[0], f[1], [r], np.zeros(5)])
    check(lib, CYLINDER, trig, outer, spec, o, d, 2)


def test_plane_adjoint_matches_autograd(lib):
    rng = np.random.default_rng(13)
    point = rng.uniform(-1, 1, 4).astype(np.float32)
    n = unit(rng)
    o = rng.uniform(-3, 3, (256, 4)).astype(np.float32)
    d = unit(rng, 256)
    spec = np.concatenate([point, n, np.zeros(5)])
    check(lib, PLANE, False, True, spec, o, d, 3)


def test_cell_adjoint_matches_autograd(lib):
    """A cell of a turned hypercube: rays toward its face from the front,
    most within its extents."""
    rng = np.random.default_rng(14)
    f = frame(rng)
    c = rng.uniform(-1, 1, 4).astype(np.float32)
    r = np.float32(0.5)
    sp = (c - r * f[3]).astype(np.float32)
    target = sp + (rng.uniform(-0.7, 0.7, (256, 3)) @ f[:3]).astype(np.float32)
    o = (sp - 3.0 * f[3] + rng.normal(0, 0.5, (256, 4))).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    spec = np.concatenate([sp, -f[3], f[0], f[1], f[2], [r], np.zeros(5)])
    check(lib, CELL, False, True, spec, o, d, 4)


@pytest.mark.parametrize("trig", [False, True], ids=["spec", "trig"])
def test_zero_radius_never_hits(lib, trig):
    """Radius 0 (diff.zero_object): rays through the center and through
    the cylinder's axis plane, where l2 - b^2 rounds below 0 or the
    trigonometric sin_oap is nan, miss on the host and in the plain
    version; the plain version's partials stay finite."""
    rng = np.random.default_rng(15)
    center = rng.uniform(-1, 1, 4).astype(np.float32)
    o = (center - 2.0 * unit(rng, 64)).astype(np.float32)
    d = center - o + rng.normal(0, 1e-7, (64, 4)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    f = frame(rng)
    for kind, spec in ((SPHERE, np.concatenate([center, np.zeros(6)])),
                       (CYLINDER, np.concatenate([center, f[0], f[1], [0.0], np.zeros(5)]))):
        g = np.ones(64, np.float32)
        gn = np.ones((64, 4), np.float32)
        got = host(lib, kind, trig, True, spec, o, d, g, gn)
        ref = plain(kind, trig, True, spec, o, d, g, gn)
        assert not got["hit"].any() and not ref["hit"].any()
        assert all(np.isfinite(ref[k]).all() for k in ("g_spec", "g_o", "g_d"))


@pytest.mark.parametrize("intersect", ["spec", "trig"])
@pytest.mark.parametrize("idx", [0, 1])
def test_zeroed_cylinder_through_its_axis_plane_is_a_miss(intersect, idx):
    """The two-cylinder scene seen level (axis_plane_scene) at 64x36, 1 spp,
    2 bounces, seed 5, under a literal fold: zero_object's light is bitwise
    drop_object's, and K6's plain version over the zeroed row (autograd
    through it) is finite. Without the radius guard the turned cylinder
    (idx 1) was hit through its axis plane: 703 pixels under spec and 339
    under trig differed from the dropped light, by up to 5.58 (ROADMAP
    queue 3)."""
    from fourd_ray_tracing_tpu_torch import diff
    from fourd_ray_tracing_tpu_torch.models import params
    from fourd_ray_tracing_tpu_torch.models import renderer as trenderer
    from fourd_ray_tracing_tpu_torch.ops.cuda import gradkernel

    from test_torch_adjoint_host import axis_plane_scene

    scene, camera = axis_plane_scene()
    cfg = trenderer.RenderConfig(width=64, height=36, samples=1, reflections_amount=2,
                                 rng_mode="per_sample", intersect=intersect)
    ref = ("cylinders", idx)
    zeroed = trenderer.render_light(diff.zero_object(scene, ref), camera, cfg, 5)
    assert torch.equal(zeroed, trenderer.render_light(diff.drop_object(scene, ref), camera, cfg,
                                                      5))
    alpha = diff.object_coverage(scene, ref, camera, cfg, 0.05).detach()
    loss, grad, g_alpha = gradkernel.render_soft_loss_and_grad_plain(
        params.pack(scene, camera), scene, camera, cfg, 5, torch.zeros(36, 64, 3), alpha,
        params.soft_zero_map(scene, camera, ref))
    assert torch.isfinite(loss) and torch.isfinite(grad).all() and torch.isfinite(g_alpha).all()
