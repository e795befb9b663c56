"""Scenes as NamedTuples of tensors, and the fused closest-hit fold.

Counterpart of fourd_ray_tracing_tpu/models/scene.py for the primitives
of this slice: hyperplanes and hyperspheres. `Scene` keeps the JAX
package's field layout (the composite fields stay, empty), so a scene
packs to the same flat vector (models/params.py). A scene that holds a
cylinder, duocylinder, hypercube or tiger raises: those folds are still
to be ported (ROADMAP queue 1, item 4).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from fourd_ray_tracing_tpu_torch.ops.geometry import Intersection, Material, miss_like
from fourd_ray_tracing_tpu_torch.ops.sampler import SMALL_FLOAT
from fourd_ray_tracing_tpu_torch.ops.sky import Environment, Sun
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec3, Vec4, dot, f32


class SpaceSpec(NamedTuple):
    point: Vec4
    norm: Vec4
    material: Material


class SphereSpec(NamedTuple):
    center: Vec4
    r: torch.Tensor
    material: Material


class Scene(NamedTuple):
    """Primitive tuples (static length) plus the environment."""

    spaces: Tuple[SpaceSpec, ...] = ()
    spheres: Tuple[SphereSpec, ...] = ()
    cylinders: tuple = ()
    cylinders_union: Optional[tuple] = None
    hypercube: Optional[object] = None
    tiger: Optional[object] = None
    environment: Optional[Environment] = None


# Miss sentinel of the fold, and the degenerate-origin threshold squared.
FAR = float(np.float32(1e30))
SMALL2 = float(np.float32(SMALL_FLOAT * SMALL_FLOAT))


def check_supported(scene: Scene) -> None:
    """Raise for the primitives whose fold is not ported yet."""
    composite = [name for name in ("cylinders", "cylinders_union", "hypercube", "tiger")
                 if getattr(scene, name)]
    if composite:
        raise NotImplementedError(
            f"scene primitives {composite} are not ported yet (ROADMAP queue 1, "
            "item 4): this port renders hyperplanes and hyperspheres only"
        )


def intersect_scene_fast(scene: Scene, ray_o: Vec4, ray_d: Vec4) -> Intersection:
    """Closest hit over all primitives, no hints (scene.py:315-720).

    Each candidate folds only a masked distance (FAR on a miss), planes
    first and then spheres in scene order; a strictly nearer candidate
    wins, so ties keep the earlier one. The winner's normal and material
    resolve once, after the fold, through a serial masked chain.
    """
    check_supported(scene)
    o, d = ray_o, ray_d
    zero = torch.zeros_like(d.x)
    dists, resolvers = [], []

    for sp in scene.spaces:
        n = sp.norm
        cn = dot(sp.point, n)
        on = dot(o, n)
        dn = dot(d, n)
        dot_vn = cn - on
        sgn = torch.sign(dot_vn)
        hit = sgn * dn >= SMALL_FLOAT
        dist = dot_vn / torch.where(hit, dn, 1.0)
        dists.append(torch.where(hit, dist, FAR))

        def resolve(dist, hit_p, n=n, sgn=sgn, mat=sp.material):
            flip = -sgn
            return Vec4(*(flip * c for c in n)), mat.glow, mat.refl_prob, mat.color

        resolvers.append(resolve)

    for s in scene.spheres:
        c, r = s.center, s.r
        r2 = r * r
        po = c - o
        b = dot(po, d)
        l2 = dot(po, po) + 1e-37
        degenerate = l2 < SMALL2
        b = torch.where(degenerate, 0.0, b)
        receding = ~degenerate & (l2 >= r2) & (b < 0.0)
        disc = r2 - (l2 - b * b)
        tangent = disc <= 0.0
        sq = torch.sqrt(torch.where(tangent, 1.0, disc))
        sq = torch.where(tangent, 0.0, sq)
        use_near = l2 > r2
        dist = torch.where(use_near, b - sq, b + sq)
        hit = ~(receding | tangent)
        dists.append(torch.where(hit, dist, FAR))

        def resolve(dist, hit_p, c=c, r=r, use_near=use_near, mat=s.material):
            inv_r = 1.0 / torch.clamp_min(r, 1e-30)
            scale = torch.where(use_near, -inv_r, inv_r)
            nrm = Vec4(*((cc - hc) * scale for cc, hc in zip(c, hit_p)))
            return nrm, mat.glow, mat.refl_prob, mat.color

        resolvers.append(resolve)

    if not dists:
        return miss_like(d.x)

    best = dists[0]
    idx = torch.zeros_like(zero, dtype=torch.int32)
    for k, dk in enumerate(dists[1:], start=1):
        take = dk < best
        best = torch.where(take, dk, best)
        idx = torch.where(take, k, idx)

    hit = best < FAR * 0.5
    dist = torch.where(hit, best, 0.0)
    hit_p = o + d * dist
    norm = Vec4(zero, zero, zero, zero)
    glow, refl = zero, zero
    color = Vec3(zero, zero, zero)
    for k, resolve in enumerate(resolvers):
        nk, gk, rk, ck = resolve(dist, hit_p)
        mask = hit & (idx == k)
        norm = nk.where(mask, norm)
        glow = torch.where(mask, gk, glow)
        refl = torch.where(mask, rk, refl)
        color = ck.where(mask, color)
    return Intersection(hit, dist, norm, glow, refl, color)


# --- constructors (Python floats -> 0-d float32 tensors on ``device``) ---

def material(glow: float, refl_prob: float, color: tuple, device) -> Material:
    return Material.of(glow, refl_prob, color, device)


def space(point: tuple, norm: tuple, mat: Material, device) -> SpaceSpec:
    return SpaceSpec(Vec4.of(*point, device=device), Vec4.of(*norm, device=device), mat)


def sphere(center: tuple, r: float, mat: Material, device) -> SphereSpec:
    return SphereSpec(Vec4.of(*center, device=device), f32(r, device), mat)


def sun(drct: tuple, angular_size: float, light: tuple, sharpness: float, device) -> Sun:
    return Sun(
        Vec4.of(*drct, device=device),
        f32(angular_size, device),
        Vec3.of(*light, device=device),
        f32(sharpness, device),
    )


def environment(sun_: Sun, sky_light: tuple, enabled: bool = True, *, device) -> Environment:
    return Environment(sun_, Vec3.of(*sky_light, device=device), enabled)
