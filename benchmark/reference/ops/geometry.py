"""Materials, the SoA hit record, the per-primitive intersections, the
composite primitives' specs and their shared-projection helpers.

Counterpart of fourd_ray_tracing_tpu/ops/geometry.py: Material,
Intersection and miss_like (:62-118), the literal per-primitive
intersections of the spec fold (closest, the hypersphere with the
quadratic and with the reference's trigonometric solution, the
hyperplane, the cylinder, the duocylinder, the tiger's faces, the cube
cell and the hypercube, :43-420 and :626-709), the specs and constructors
of the cylinder, duocylinder, tiger and hypercube (CylinderSpec :290,
TigerSpec and make_tiger :324-351, CubeSpec :626, HypercubeSpec and
make_hypercube :661-696), and the cylinder family's projected-ray
quantities that the production fold shares between a family's faces
(_CylFamily and the _family_* helpers, :419-524), in the JAX order of
operations. The folds themselves live in models/scene.py.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from benchmark.reference.ops.sampler import SMALL_FLOAT
from benchmark.reference.ops.vec4 import (Vec3, Vec4, dot, f32, point_in_space,
                                                  sqrt, vec_in_space)


class Material(NamedTuple):
    """Emissive-diffuse-mirror material."""

    glow: torch.Tensor       # emissive strength
    refl_prob: torch.Tensor  # probability of mirror reflection
    color: Vec3              # albedo / emission tint

    @staticmethod
    def of(glow: float, refl_prob: float, color: tuple, device) -> "Material":
        return Material(f32(glow, device), f32(refl_prob, device), Vec3.of(*color, device=device))


class Intersection(NamedTuple):
    """SoA hit record with the hit material inlined."""

    hit: torch.Tensor
    dist: torch.Tensor
    norm: Vec4
    glow: torch.Tensor
    refl_prob: torch.Tensor
    color: Vec3


def miss_like(ref: torch.Tensor) -> Intersection:
    """No hit anywhere, broadcast to the ray batch shape."""
    zero = torch.zeros_like(ref)
    return Intersection(
        torch.zeros_like(ref, dtype=torch.bool),
        zero,
        Vec4(zero, zero, zero, zero),
        zero,
        zero,
        Vec3(zero, zero, zero),
    )


def select(mask: torch.Tensor, a: Intersection, b: Intersection) -> Intersection:
    """Fieldwise mask ? a : b (Intersection.where, geometry.py:80-90)."""
    return Intersection(torch.where(mask, a.hit, b.hit), torch.where(mask, a.dist, b.dist),
                        a.norm.where(mask, b.norm), torch.where(mask, a.glow, b.glow),
                        torch.where(mask, a.refl_prob, b.refl_prob),
                        a.color.where(mask, b.color))


# --- The literal per-primitive intersections (geometry.py:43-420) --------

_PI = float(np.float32(np.pi))


def _safe_length(v: Vec4) -> torch.Tensor:
    """|v| with a 1e-37 floor inside the square root."""
    return sqrt(dot(v, v) + 1e-37)


def _safe_sqrt_pos(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """sqrt(x) where valid, exactly 0 elsewhere."""
    return torch.where(valid, sqrt(torch.where(valid, x, 1.0)), 0.0)


def _masked(hit: torch.Tensor, dist, norm: Vec4, material: Material) -> Intersection:
    """A record with every field broadcast to the ray batch's shape."""
    def bc(t):
        return torch.broadcast_to(torch.as_tensor(t), hit.shape)

    return Intersection(hit, bc(dist), Vec4(*map(bc, norm)), bc(material.glow),
                        bc(material.refl_prob), Vec3(*map(bc, material.color)))


def closest(a: Intersection, b: Intersection) -> Intersection:
    """The nearer valid hit; ties keep ``b``."""
    return select(a.hit & (~b.hit | (a.dist < b.dist)), a, b)


def _zero_safe(fn, deriv):
    """``fn`` whose backward is the formula torch's own takes, grad *
    deriv(x, fn(x)), but exactly 0 where the cotangent is 0: a lane the
    fold masks out gets no gradient even where ``deriv`` is infinite (acos'
    and asin' at +-1, sqrt' at 0), where torch's 0 * inf is nan and reaches
    the winning lanes' leaves. A lane whose cotangent is not 0 gets torch's
    value, inf or nan included (the gradient kernels' literal adjoint
    computes the same, csrc/adjoint.cuh sphere_lit_adj)."""
    class ZeroSafe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            y = fn(x)
            ctx.save_for_backward(x, y)
            return y

        @staticmethod
        def backward(ctx, g):
            x, y = ctx.saved_tensors
            return torch.where(g == 0.0, torch.zeros((), dtype=g.dtype), g * deriv(x, y))

    return ZeroSafe.apply


# torch's derivatives of acos, asin (tools/autograd/derivatives.yaml) and
# sqrt. acos' at +-1, where the formula is infinite, is taken as 0: the
# trigonometric sphere's cos_opa is exactly 1 on a ray aimed within float32
# rounding (3.4e-4 rad) of the center, a hit, where the distance's
# derivative is finite (its sin(angle_aop) is 0 there) but the chain's is
# 0 * inf; with 0 that path adds nothing and the others carry the
# gradient (JAX's is nan there: ROADMAP queue 3).
_acos = _zero_safe(torch.acos, lambda x, _: torch.where(
    x.abs() == 1.0, torch.zeros((), dtype=x.dtype), -((-x * x + 1.0).rsqrt())))
_asin = _zero_safe(torch.asin, lambda x, _: (-x * x + 1.0).rsqrt())
_sqrt = _zero_safe(sqrt, lambda _, y: 1.0 / (2.0 * y))


class _Norm(torch.autograd.Function):
    """|v| = sqrt(dot(v, v)) (vec4.length's value), whose backward is that of
    torch.linalg.vector_norm: v * (g / |v|), and 0 at v = 0 (the norm's
    subgradient; sqrt' at 0 would give 0 * inf = nan). The trigonometric
    sphere's l is 0 on a ray from its center, or from a cylinder's axis
    plane: a camera on a tiger's or a duocylinder's axis plane."""

    @staticmethod
    def forward(ctx, x, y, z, w):
        n = sqrt(x * x + y * y + z * z + w * w)
        ctx.save_for_backward(x, y, z, w, n)
        return n

    @staticmethod
    def backward(ctx, g):
        *v, n = ctx.saved_tensors
        k = torch.where(n == 0.0, torch.zeros((), dtype=g.dtype), g / torch.where(n == 0.0, 1.0, n))
        return tuple(c * k for c in v)


def _radius_guard(r):
    """(r is not 0, r where it is not 0 and 1 where it is) of a sphere's or
    a cylinder's circle. A circle of radius 0 (diff.zero_object) never
    hits: on a ray through its center (a cylinder's: through its axis
    plane) l2 - b^2 rounds below 0, where the quadratic's disc = -(l2 -
    b^2) > 0, and the trigonometric l sin(opa) / 0 is nan, which
    ``sin_oap >= 1`` does not count as a miss. The second divides in its
    place, so that no gradient through the masked lanes is 0 * inf; every
    other radius computes as before. The JAX package's literal
    intersections have no such guard (ROADMAP queue 3)."""
    live = torch.as_tensor(r) != 0.0
    return live, torch.where(live, r, 1.0)


def sphere_intersection(center: Vec4, r, material: Material, ray_o: Vec4, ray_d: Vec4,
                        outer: bool = True) -> Intersection:
    """Ray / 3-sphere by the quadratic (geometry.py:136-181): the near root
    from outside an outer sphere, else the far root; a receding ray from
    outside and a tangent or missing line miss; the normal points to the
    ray's side. Radius 0 misses (``_radius_guard``)."""
    live, r_div = _radius_guard(r)
    po = center - ray_o
    l2 = dot(po, po)
    l = _safe_length(po)
    degenerate = l < SMALL_FLOAT
    b = torch.where(degenerate, 0.0, dot(po, ray_d))
    miss_receding = ~degenerate & (l >= r) & (b < 0.0)
    disc = r * r - (l2 - b * b)
    miss_tangent = disc <= 0.0
    s = _safe_sqrt_pos(disc, ~miss_tangent)
    use_near = (l > r) if outer else torch.zeros_like(miss_tangent)
    dist = torch.where(use_near, b - s, b + s)
    hit = ~(miss_receding | miss_tangent) & live
    norm = (center - (ray_o + ray_d * dist)) * (1.0 / r_div)
    return _masked(hit, dist, (-norm).where(use_near, norm), material)


def sphere_intersection_trig(center: Vec4, r, material: Material, ray_o: Vec4, ray_d: Vec4,
                             outer: bool = True) -> Intersection:
    """The reference's trigonometric solution, literally (geometry.py:
    184-215): the angles at the origin and at the hit by arccos and
    arcsin, the distance by the law of cosines. Radius 0 misses
    (``_radius_guard``)."""
    live, r_div = _radius_guard(r)
    po = center - ray_o
    l = _Norm.apply(*po)
    degenerate = l < SMALL_FLOAT
    dot_pord = dot(po, ray_d)
    miss_receding = ~degenerate & (l >= r) & (dot_pord < 0.0)
    cos_opa = torch.where(degenerate, 0.0,
                          torch.clamp(dot_pord / torch.clamp_min(l, 1e-30), -1.0, 1.0))
    angle_opa = _acos(cos_opa)
    sin_oap = l * torch.sin(angle_opa) / r_div
    miss_tangent = sin_oap >= 1.0
    angle_oap = _asin(torch.clamp(sin_oap, -1.0, 1.0))
    use_near = (l > r) if outer else torch.zeros_like(miss_tangent)
    angle_oap = torch.where(use_near, _PI - angle_oap, angle_oap)
    angle_aop = _PI - angle_opa - angle_oap
    dist = _sqrt(torch.clamp_min(r * r + l * l - 2.0 * r * l * torch.cos(angle_aop), 0.0))
    hit = ~(miss_receding | miss_tangent) & live
    norm = (center - (ray_o + ray_d * dist)) * (1.0 / r_div)
    return _masked(hit, dist, (-norm).where(use_near, norm), material)


def space_intersection(point: Vec4, norm: Vec4, material: Material, ray_o: Vec4,
                       ray_d: Vec4) -> Intersection:
    """Double-sided hyperplane, its normal turned toward the ray's origin
    (geometry.py:220-231)."""
    dot_vn = dot(point - ray_o, norm)
    drct_h = norm * torch.sign(dot_vn)
    cos_dh = dot(drct_h, ray_d)
    hit = cos_dh >= SMALL_FLOAT
    dist = torch.abs(dot_vn) / torch.where(hit, cos_dh, 1.0)
    return _masked(hit, dist, -drct_h, material)


def cylinder_intersection(point: Vec4, axis1: Vec4, axis2: Vec4, r, material: Material,
                          ray_o: Vec4, ray_d: Vec4, outer: bool = True,
                          trig: bool = False) -> Intersection:
    """A cylinder infinite along two axes: the ray projected into the
    2-plane orthogonal to both, a circle test there, the distance unscaled
    by the projected direction's length (geometry.py:236-271)."""
    o1 = point_in_space(ray_o, point, axis1)
    d1 = vec_in_space(ray_d, axis1)
    miss1 = _safe_length(d1) < SMALL_FLOAT
    o12 = point_in_space(o1, point, axis2)
    d12 = vec_in_space(d1, axis2)
    d12_len = _safe_length(d12)
    miss2 = d12_len < SMALL_FLOAT
    inv_len = 1.0 / torch.where(miss2, 1.0, d12_len)
    sphere_fn = sphere_intersection_trig if trig else sphere_intersection
    inter = sphere_fn(point, r, material, o12, d12 * inv_len, outer)
    return inter._replace(hit=inter.hit & ~(miss1 | miss2), dist=inter.dist * inv_len)


def dist_to_axes_plane(dist, ray_o: Vec4, ray_d: Vec4, point: Vec4, axis1: Vec4,
                       axis2: Vec4) -> torch.Tensor:
    """Distance from the ray's point at ``dist`` to a cylinder's axis
    2-plane (geometry.py:274-282)."""
    p = ray_o + ray_d * dist
    p12 = point_in_space(point_in_space(p, point, axis1), point, axis2)
    return _safe_length(point - p12)


def cylinders_union_intersection(cyl1: "CylinderSpec", cyl2: "CylinderSpec", ray_o: Vec4,
                                 ray_d: Vec4, trig: bool = False) -> Intersection:
    """The duocylinder: each cylinder's hit kept within the other's axis
    plane at cylinder 2's radius, both arms (the reference's quirk,
    geometry.py:293-316)."""
    inter1 = cylinder_intersection(cyl1.point, cyl1.axis1, cyl1.axis2, cyl1.r, cyl1.material,
                                   ray_o, ray_d, True, trig)
    d1 = dist_to_axes_plane(inter1.dist, ray_o, ray_d, cyl2.point, cyl2.axis1, cyl2.axis2)
    inter1 = inter1._replace(hit=inter1.hit & (d1 <= cyl2.r))
    inter2 = cylinder_intersection(cyl2.point, cyl2.axis1, cyl2.axis2, cyl2.r, cyl2.material,
                                   ray_o, ray_d, True, trig)
    d2 = dist_to_axes_plane(inter2.dist, ray_o, ray_d, cyl1.point, cyl1.axis1, cyl1.axis2)
    inter2 = inter2._replace(hit=inter2.hit & (d2 <= cyl2.r))
    return closest(inter1, inter2)


def _tiger_face(cyl: "CylinderSpec", outer_cyl: "CylinderSpec", inner_cyl: "CylinderSpec",
                ray_o: Vec4, ray_d: Vec4, outer: bool, trig: bool = False) -> Intersection:
    """One face: the cylinder's hit clipped to the annulus between the
    other family's inner and outer radii (geometry.py:354-376)."""
    inter = cylinder_intersection(cyl.point, cyl.axis1, cyl.axis2, cyl.r, cyl.material, ray_o,
                                  ray_d, outer, trig)
    d_out = dist_to_axes_plane(inter.dist, ray_o, ray_d, outer_cyl.point, outer_cyl.axis1,
                               outer_cyl.axis2)
    d_in = dist_to_axes_plane(inter.dist, ray_o, ray_d, inner_cyl.point, inner_cyl.axis1,
                              inner_cyl.axis2)
    return inter._replace(hit=inter.hit & (d_out <= outer_cyl.r) & (d_in >= inner_cyl.r))


def tiger_intersection(tiger: "TigerSpec", ray_o: Vec4, ray_d: Vec4,
                       trig: bool = False) -> Intersection:
    """The closest of the 8 faces, 4 cylinders x outer in (True, False), in
    the reference's order (geometry.py:379-395)."""
    inter = None
    for cyl, ocyl, icyl in ((tiger.inner_cyl1, tiger.outer_cyl2, tiger.inner_cyl2),
                            (tiger.outer_cyl1, tiger.outer_cyl2, tiger.inner_cyl2),
                            (tiger.inner_cyl2, tiger.outer_cyl1, tiger.inner_cyl1),
                            (tiger.outer_cyl2, tiger.outer_cyl1, tiger.inner_cyl1)):
        for outer in (True, False):
            face = _tiger_face(cyl, ocyl, icyl, ray_o, ray_d, outer, trig)
            inter = face if inter is None else closest(face, inter)
    return inter


def cube_intersection(cube: "CubeSpec", ray_o: Vec4, ray_d: Vec4) -> Intersection:
    """A cell: the front-facing hit of its hyperplane within the three
    axis extents; the normal is the cell's hyperplane normal, unflipped
    (geometry.py:637-658)."""
    vec_n = -cube.space_norm
    h = dot(cube.space_point - ray_o, vec_n)
    cos_dn = dot(ray_d, vec_n)
    facing = (h >= 0.0) & (cos_dn >= 0.0)
    dist = h / torch.where(cos_dn == 0.0, 1e-30, cos_dn)
    vec_cp = ray_o + ray_d * dist - cube.space_point
    inside = ((torch.abs(dot(vec_cp, cube.x)) <= cube.r)
              & ((torch.abs(dot(vec_cp, cube.y)) <= cube.r)
                 & (torch.abs(dot(vec_cp, cube.z)) <= cube.r)))
    return _masked(facing & inside, dist, cube.space_norm, cube.material)


def hypercube_intersection(hypercube: "HypercubeSpec", ray_o: Vec4, ray_d: Vec4) -> Intersection:
    """The first cell hit in the cells' order, not the closest
    (geometry.py:697-708)."""
    inter = cube_intersection(hypercube.cubes[0], ray_o, ray_d)
    for cell in hypercube.cubes[1:]:
        cand = cube_intersection(cell, ray_o, ray_d)
        inter = select(~inter.hit & cand.hit, cand, inter)
    return inter


# --- Composite primitives (geometry.py:282-351, :622-696) -----------------

class CylinderSpec(NamedTuple):
    """A cylinder infinite along two orthogonal axes."""

    point: Vec4
    axis1: Vec4
    axis2: Vec4
    r: torch.Tensor
    material: Material


class TigerSpec(NamedTuple):
    """The tiger's four cylinders: two radii on each of two axis pairs."""

    inner_cyl1: CylinderSpec
    outer_cyl1: CylinderSpec
    inner_cyl2: CylinderSpec
    outer_cyl2: CylinderSpec


def make_tiger(point: Vec4, axis1: Vec4, axis2: Vec4, axis3: Vec4, axis4: Vec4, inner_r: float,
               outer_r: float, material1: Material, material2: Material) -> TigerSpec:
    device = point.x.device
    inner, outer = f32(inner_r, device), f32(outer_r, device)
    return TigerSpec(
        CylinderSpec(point, axis1, axis2, inner, material1),
        CylinderSpec(point, axis1, axis2, outer, material1),
        CylinderSpec(point, axis3, axis4, inner, material2),
        CylinderSpec(point, axis3, axis4, outer, material2),
    )


class CubeSpec(NamedTuple):
    """A 3D cube living in a hyperplane: one cell of the hypercube."""

    space_point: Vec4
    space_norm: Vec4
    x: Vec4
    y: Vec4
    z: Vec4
    r: torch.Tensor
    material: Material


class HypercubeSpec(NamedTuple):
    """The 8 cells, and the generator parameters (center, 4 axes,
    half-width) that the production fold reads."""

    cubes: tuple
    point: Optional[Vec4] = None
    axes: Optional[tuple] = None
    r: Optional[torch.Tensor] = None


def make_hypercube(point: Vec4, x: Vec4, y: Vec4, z: Vec4, w: Vec4, r: float,
                   materials: tuple) -> HypercubeSpec:
    """8 cells from center, 4 axes, half-width and 8 materials, in the
    reference's cell order (+x +y +z +w -x -y -z -w)."""
    r = f32(r, point.x.device)
    mxp, myp, mzp, mwp, mxn, myn, mzn, mwn = materials
    cells = (
        CubeSpec(point + x * r, x, y, z, w, r, mxp),
        CubeSpec(point + y * r, y, x, z, w, r, myp),
        CubeSpec(point + z * r, z, x, y, w, r, mzp),
        CubeSpec(point + w * r, w, x, y, z, r, mwp),
        CubeSpec(point - x * r, -x, y, z, w, r, mxn),
        CubeSpec(point - y * r, -y, x, z, w, r, myn),
        CubeSpec(point - z * r, -z, x, y, w, r, mzn),
        CubeSpec(point - w * r, -w, x, y, z, r, mwn),
    )
    return HypercubeSpec(cells, point, (x, y, z, w), r)


# --- Shared-projection helpers of the production fold (geometry.py:419-524)

# The fold's degenerate-length threshold, squared (float32).
SMALL2 = float(np.float32(SMALL_FLOAT * SMALL_FLOAT))


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(x), each step correctly rounded: the port's one reciprocal
    square root, which the kernel computes as 1.0f / sqrtf(x). (The JAX
    package's jax.lax.rsqrt is not correctly rounded, nor is CUDA's
    rsqrtf; this form keeps the kernel bitwise its plain version.)"""
    return 1.0 / sqrt(x)


class _CylFamily(NamedTuple):
    """A (point, axis1, axis2) family's projected-ray quantities, shared by
    every radius test of the family."""

    po: Vec4                 # center - projected origin (in the 2-plane)
    d12: Vec4                # projected (non-unit) direction
    l2: torch.Tensor         # |po|^2 + 1e-37
    b_raw: torch.Tensor      # dot(po, d12)
    len1_sq: torch.Tensor    # |d - a1 dot(d, a1)|^2 (first projection)
    len12_sq: torch.Tensor   # |d12|^2
    inv_len: torch.Tensor    # 1/|d12| (guarded)
    proj_ok: torch.Tensor    # both projection lengths^2 >= SMALL^2
    b: torch.Tensor          # unit-direction b (0 where degenerate)
    degenerate: torch.Tensor  # |po|^2 < SMALL^2
    perp2: torch.Tensor      # l2 - b^2


def _cyl_family(point: Vec4, axis1: Vec4, axis2: Vec4, ray_o: Vec4, ray_d: Vec4) -> _CylFamily:
    co = point - ray_o
    a1c = dot(co, axis1)
    a2c = dot(co, axis2)
    po = co - axis1 * a1c - axis2 * a2c
    da1 = dot(ray_d, axis1)
    d1 = ray_d - axis1 * da1
    len1_sq = dot(d1, d1)
    da2 = dot(d1, axis2)
    d12 = d1 - axis2 * da2
    len12_sq = dot(d12, d12)
    proj_ok = (len1_sq >= SMALL2) & (len12_sq >= SMALL2)
    inv_len = rsqrt(torch.where(proj_ok, len12_sq, 1.0))
    l2 = dot(po, po) + 1e-37
    b_raw = dot(po, d12)
    degenerate = l2 < SMALL2
    b = torch.where(degenerate, 0.0, b_raw * inv_len)
    return _CylFamily(po, d12, l2, b_raw, len1_sq, len12_sq, inv_len, proj_ok, b, degenerate,
                      l2 - b * b)


def _family_circle(fam: _CylFamily, r):
    """The radius-dependent part of a family's circle test: (near, far,
    hit, use_near_outer), the two unscaled roots as ray parameters, the
    circle-hit mask and the outer face's near-root select (l2 > r^2).

    A face of radius 0 never hits, so that diff.zero_object's zeroed
    composite is a guaranteed miss (its light drop_object's): on a ray
    through the axis plane perp2 = l2 - b^2 rounds below 0, where the JAX
    package's test (geometry.py:474-486, disc = r^2 - perp2 > 0) hits it."""
    r2 = r * r
    receding = ~fam.degenerate & ((fam.l2 >= r2) & (fam.b < 0.0))
    disc = r2 - fam.perp2
    tangent = disc <= 0.0
    sq = sqrt(torch.where(tangent, 1.0, disc))
    sq = torch.where(tangent, 0.0, sq)
    near = (fam.b - sq) * fam.inv_len
    far = (fam.b + sq) * fam.inv_len
    hit = fam.proj_ok & ~(receding | tangent) & (r2 > 0.0)
    return near, far, hit, fam.l2 > r2


def _family_circle_dist(fam: _CylFamily, r, outer: bool = True):
    """(dist, hit, use_near) of the family's circle test at radius r."""
    near, far, hit, use_near_outer = _family_circle(fam, r)
    use_near = use_near_outer if outer else torch.zeros_like(hit)
    return torch.where(use_near, near, far), hit, use_near


def _family_clip_sq(fam: _CylFamily, t: torch.Tensor) -> torch.Tensor:
    """Squared distance to the family's axis 2-plane at ray parameter t:
    l2 - 2t*b_raw + t^2*|d12|^2."""
    return fam.l2 - 2.0 * t * fam.b_raw + t * t * fam.len12_sq


def _family_norm(fam: _CylFamily, dist, r, flip) -> Vec4:
    """(po - d12*dist)/r, negated where ``flip`` (None: no flip);
    max(r, 1e-30) keeps a zeroed family's values finite."""
    inv_r = 1.0 / torch.clamp_min(r, 1e-30)
    scale = inv_r if flip is None else torch.where(flip, -inv_r, inv_r)
    return Vec4(*((pc - dc * dist) * scale for pc, dc in zip(fam.po, fam.d12)))
