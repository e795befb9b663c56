"""Scenes as NamedTuples of tensors, and the fused closest-hit fold.

Counterpart of fourd_ray_tracing_tpu/models/scene.py for the primitives
of this slice: hyperplanes and hyperspheres, with the static hyperplane
hints of the production fold (``plane_norm_hints``, ``plane_pair_hints``). `Scene` keeps the JAX
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


def _host_values(tensors) -> np.ndarray:
    """The float32 values of 0-d tensors, in one copy to the host."""
    return torch.stack([t.detach().reshape(()).to(torch.float32) for t in tensors]).cpu().numpy()


def plane_norm_hints(scene: Scene):
    """Static zero-component hints of the hyperplane normals, or None
    (the JAX package's plane_norm_hints, scene.py:64-89).

    A tuple per hyperplane of four bools, True where that normal component
    is exactly 0.0: the fold then drops its multiply-adds, which leaves the
    forward value as it is (x + 0*y == x in float32 for finite x). None
    when the scene has no hyperplane, or when any normal component requires
    grad: hinted components would get no gradient, so the hints stay off
    every autograd path (the JAX function returns None for tracers). Reads
    the normals' values, one copy to the host.
    """
    comps = [c for sp in scene.spaces for c in sp.norm]
    if not comps or any(c.requires_grad for c in comps):
        return None
    vals = _host_values(comps).reshape(-1, 4)
    return tuple(tuple(bool(np.asarray(c) == 0.0) for c in row) for row in vals)


def plane_pair_hints(scene: Scene, hints):
    """Static opposite-wall pairs of the fold, or None (the JAX package's
    plane_pair_hints, scene.py:92-141).

    Two unit single-axis hyperplanes on one axis fold as one candidate:
    for any ray at most one of them is the nearer hit, so the nearer wall
    in the travel direction is picked with two compares and one division.
    Returns (pairs, singles): pairs = tuple of (i, j, axis) with offset_i <
    offset_j along ``axis``, singles = the unpaired planes' indices; None
    when nothing pairs. Derived as the JAX function does, offsets in Python
    doubles from numpy float32 products, sorted per axis, coincident planes
    left unpaired.
    """
    if hints is None or len(scene.spaces) < 2:
        return None
    vals = _host_values([c for sp in scene.spaces for c in (*sp.norm, *sp.point)]).reshape(-1, 8)
    by_axis = {}
    for i, (sp, hint) in enumerate(zip(scene.spaces, hints)):
        if hint.count(True) != 3:
            continue
        axis = hint.index(False)
        if any(c.requires_grad for c in (*sp.norm, *sp.point)):
            return None
        comps, pts = vals[i, :4], vals[i, 4:]
        nk = float(np.asarray(comps[axis]))
        if abs(nk) != 1.0:
            continue
        # effective axis offset: the plane is {x_axis == c}
        c = float(sum(np.asarray(p) * np.asarray(n) for p, n in zip(pts, comps))) / nk
        by_axis.setdefault(axis, []).append((c, i))
    pairs = []
    paired = set()
    for axis, entries in by_axis.items():
        entries.sort()
        while len(entries) >= 2:
            (ca, i), (cb, j) = entries[0], entries[1]
            entries = entries[2:]
            if ca == cb:
                continue  # coincident planes: keep literal semantics
            pairs.append((i, j, axis))
            paired.update((i, j))
    if not pairs:
        return None
    singles = tuple(i for i in range(len(scene.spaces)) if i not in paired)
    return tuple(pairs), singles


def check_plane_hints(scene: Scene, plane_hints) -> None:
    """Raise ValueError unless ``plane_hints`` has one entry per hyperplane
    and every component it hints is exactly 0.0 (scene.py:351-371): a wrong
    hint would drop a live term and render a wrong image."""
    if len(plane_hints) != len(scene.spaces):
        raise ValueError(f"plane_hints has {len(plane_hints)} entries for "
                         f"{len(scene.spaces)} hyperplanes")
    if not scene.spaces:
        return
    vals = _host_values([c for sp in scene.spaces for c in sp.norm]).reshape(-1, 4)
    for k_sp, (row, hint) in enumerate(zip(vals, plane_hints)):
        for comp_name, c, z in zip("xyzw", row, hint):
            if z and c != 0.0:
                raise ValueError(f"plane_hints[{k_sp}].{comp_name} claims a zero normal "
                                 f"component but its value is {c!r}; hints must come from "
                                 "plane_norm_hints")


def intersect_scene_fast(scene: Scene, ray_o: Vec4, ray_d: Vec4, plane_hints=None,
                         plane_pairs=None) -> Intersection:
    """Closest hit over all primitives (scene.py:315-720), with the static
    hints of the JAX production fold when they are given.

    Each candidate folds only a masked distance (FAR on a miss); a strictly
    nearer candidate wins, so ties keep the earlier one. The winner's
    normal and material resolve once, after the fold, through a serial
    masked chain. The candidates come in the JAX order: with
    ``plane_pairs`` (and ``plane_hints``) the wall pairs, then the single
    planes, then the spheres; without, the planes in scene order, then the
    spheres. ``plane_hints`` drops the hinted normal components from a
    single plane's dots, and its resolver writes +0 there, where the
    unhinted one writes flip * 0.0; the pair fold picks the nearer wall with
    two compares and divides once. Both leave every hit, distance, glow,
    reflectivity and color as the unhinted fold computes them, and every
    normal component equal (a zero's sign aside).
    """
    check_supported(scene)
    if plane_hints is not None:
        check_plane_hints(scene, plane_hints)
    o, d = ray_o, ray_d
    zero = torch.zeros_like(d.x)
    dists, resolvers = [], []

    def add_single_plane(k_sp, sp):
        n = sp.norm
        # True = that normal component is exactly 0.0, so its multiply-adds
        # drop out of the per-ray dots.
        hint = plane_hints[k_sp] if plane_hints is not None else (False,) * 4
        cn = dot(sp.point, n)  # per scene
        live = [(oc, dc, nc) for oc, dc, nc, z in zip(o, d, n, hint) if not z] or [(o.x, d.x, n.x)]
        on, dn = live[0][0] * live[0][2], live[0][1] * live[0][2]
        for oc, dc, nc in live[1:]:
            on, dn = on + oc * nc, dn + dc * nc
        dot_vn = cn - on
        sgn = torch.sign(dot_vn)
        hit = sgn * dn >= SMALL_FLOAT
        dist = dot_vn / torch.where(hit, dn, 1.0)
        dists.append(torch.where(hit, dist, FAR))

        def resolve(dist, hit_p, n=n, sgn=sgn, hint=hint, mat=sp.material):
            flip = -sgn
            comps = [zero if z else flip * nc for nc, z in zip(n, hint)]
            return Vec4(*comps), mat.glow, mat.refl_prob, mat.color

        resolvers.append(resolve)

    def add_plane_pair(i, j, axis):
        # Opposite walls on one axis as one candidate: needs |n_axis| == 1
        # and offset_i < offset_j (plane_pair_hints), which keep the
        # SMALL_FLOAT threshold and the distances those of the two planes.
        sp_a, sp_b = scene.spaces[i], scene.spaces[j]
        ca = dot(sp_a.point, sp_a.norm) / sp_a.norm[axis]  # per scene: the axis offsets
        cb = dot(sp_b.point, sp_b.norm) / sp_b.norm[axis]
        o_k, d_k = o[axis], d[axis]
        going_up = d_k > 0.0
        up_a = o_k < ca  # below both walls: the nearest going up is a
        down_b = o_k > cb  # above both walls: the nearest going down is b
        take_a = (going_up & up_a) | (~going_up & ~down_b)
        dot_vn = torch.where(take_a, ca, cb) - o_k
        sgn = torch.sign(dot_vn)
        hit = sgn * d_k >= SMALL_FLOAT
        dist = dot_vn / torch.where(hit, d_k, 1.0)
        dists.append(torch.where(hit, dist, FAR))

        def resolve(dist, hit_p, sgn=sgn, take_a=take_a, axis=axis, mat_a=sp_a.material,
                    mat_b=sp_b.material):
            # The ray-facing normal of an axis wall is -sign(offset - o_k)
            # along the axis, whatever the stored normal's sign.
            comps = [zero, zero, zero, zero]
            comps[axis] = -sgn
            glow = torch.where(take_a, mat_a.glow, mat_b.glow)
            refl = torch.where(take_a, mat_a.refl_prob, mat_b.refl_prob)
            color = mat_a.color.where(take_a, mat_b.color)
            return Vec4(*comps), glow, refl, color

        resolvers.append(resolve)

    if plane_pairs is not None and plane_hints is not None:
        pairs, singles = plane_pairs
        for i, j, axis in pairs:
            add_plane_pair(i, j, axis)
        for i in singles:
            add_single_plane(i, scene.spaces[i])
    else:
        for k_sp, sp in enumerate(scene.spaces):
            add_single_plane(k_sp, sp)

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
