"""Materials, the SoA hit record, the composite primitives' specs and
their shared-projection helpers.

Counterpart of fourd_ray_tracing_tpu/ops/geometry.py: Material,
Intersection and miss_like (:62-118), the specs and constructors of the
cylinder, duocylinder, tiger and hypercube (CylinderSpec :290, TigerSpec
and make_tiger :324-351, CubeSpec :626, HypercubeSpec and make_hypercube
:661-696), and the cylinder family's projected-ray quantities that the
production fold shares between a family's faces (_CylFamily and the
_family_* helpers, :419-524), in the JAX order of operations. The fold
itself lives in models/scene.py:intersect_scene_fast.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from fourd_ray_tracing_tpu_torch.ops.sampler import SMALL_FLOAT
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec3, Vec4, dot, f32, sqrt


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
