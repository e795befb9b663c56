"""Scenes as NamedTuples of tensors, and the fused closest-hit fold.

Counterpart of fourd_ray_tracing_tpu/models/scene.py: hyperplanes,
hyperspheres, cylinders, the duocylinder, the hypercube and the tiger,
with the static hints of the production fold (``plane_norm_hints``,
``plane_pair_hints``, ``axis_alignment_hints``) and the gradient
contract under them (``freeze_hint_grads``), and the literal
per-primitive fold (``intersect_scene_spec``, with the reference's
trigonometric sphere solution or not) that ``intersect_scene`` picks by
the config's ``intersect``. `Scene` keeps the JAX package's field layout,
so a scene packs to the same flat vector (models/params.py). The
forward, the hard-loss and the soft gradient paths take every primitive.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from benchmark.reference.ops import geometry as geo
from benchmark.reference.ops.geometry import (
    CylinderSpec,
    HypercubeSpec,
    Intersection,
    Material,
    TigerSpec,
    miss_like,
)
from benchmark.reference.ops.sampler import SMALL_FLOAT
from benchmark.reference.ops.sky import Environment, Sun
from benchmark.reference.ops.vec4 import Vec3, Vec4, dot, f32, sqrt


class SpaceSpec(NamedTuple):
    point: Vec4
    norm: Vec4
    material: Material


class SphereSpec(NamedTuple):
    center: Vec4
    r: torch.Tensor
    material: Material


# The composite primitives' fields of a Scene, in fold order.
COMPOSITE_KINDS = ("cylinders", "cylinders_union", "hypercube", "tiger")


class Scene(NamedTuple):
    """Primitive tuples (static length) plus the environment."""

    spaces: Tuple[SpaceSpec, ...] = ()
    spheres: Tuple[SphereSpec, ...] = ()
    cylinders: Tuple[CylinderSpec, ...] = ()
    cylinders_union: Optional[Tuple[CylinderSpec, CylinderSpec]] = None
    hypercube: Optional[HypercubeSpec] = None
    tiger: Optional[TigerSpec] = None
    environment: Optional[Environment] = None

    def composite_kinds(self) -> tuple:
        """The composite primitives' fields this scene holds."""
        return tuple(name for name in COMPOSITE_KINDS if getattr(self, name))


# Miss sentinel of the fold, and the degenerate-origin threshold squared.
FAR = float(np.float32(1e30))
SMALL2 = geo.SMALL2


def has_generators(hc: Optional[HypercubeSpec]) -> bool:
    """Whether a hypercube carries its generator parameters (center, axes,
    half-width), which the production fold's shared dots read; one built
    from its cells alone folds cell by cell (scene.py:543-545)."""
    return hc is not None and hc.point is not None and hc.axes is not None and hc.r is not None


def cells_only(scene: "Scene") -> bool:
    """Whether ``scene`` has a hypercube built from its cells alone."""
    return scene.hypercube is not None and not has_generators(scene.hypercube)


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


class AxisHints(NamedTuple):
    """Static axis-alignment hints of the composite primitives (the JAX
    package's AxisHints, scene.py:144-163). An axis entry is
    (component_index, sign) when the axis is exactly a signed unit basis
    vector: the family's projections then become component picks with the
    zero terms dropped, which leaves every value as the full dots compute
    it. A family entry is (axis1_entry, axis2_entry) or None."""

    cylinders: tuple = ()                 # per cylinder: ((k1, s1), (k2, s2)) or None
    cylinders_union: Optional[tuple] = None  # (family 1, family 2) or None
    hypercube: Optional[tuple] = None     # ((k, s),) * 4 or None
    tiger: Optional[tuple] = None         # (family A, family B) or None


def _unit_axes(vecs) -> list:
    """(component_index, sign) per Vec4 of ``vecs`` that is exactly a
    signed unit basis vector, else None (scene.py:166-178); None for all
    when a component requires grad. One copy to the host."""
    if not vecs:
        return []
    comps = [c for v in vecs for c in v]
    if any(c.requires_grad for c in comps):
        return [None] * len(vecs)
    out = []
    for row in _host_values(comps).reshape(-1, 4):
        nonzero = [(k, float(c)) for k, c in enumerate(row) if c != 0.0]
        ok = len(nonzero) == 1 and abs(nonzero[0][1]) == 1.0
        out.append(nonzero[0] if ok else None)
    return out


def _axis_pair(h1, h2):
    if h1 is None or h2 is None or h1[0] == h2[0]:
        return None
    return (h1, h2)


def axis_alignment_hints(scene: Scene):
    """AxisHints of the scene's composite primitives, or None when nothing
    is axis-aligned (scene.py:188-216). Reads the axes' values, one copy to
    the host; a component that requires grad makes its axis unaligned."""
    cyl_axes = [a for c in scene.cylinders for a in (c.axis1, c.axis2)]
    union = scene.cylinders_union
    union_axes = [a for c in union for a in (c.axis1, c.axis2)] if union is not None else []
    hc = scene.hypercube
    hc_axes = list(hc.axes) if hc is not None and hc.axes is not None else []
    tg = scene.tiger
    tiger_axes = ([tg.inner_cyl1.axis1, tg.inner_cyl1.axis2, tg.inner_cyl2.axis1,
                   tg.inner_cyl2.axis2] if tg is not None else [])
    units = iter(_unit_axes(cyl_axes + union_axes + hc_axes + tiger_axes))
    cyl_hints = tuple(_axis_pair(next(units), next(units)) for _ in scene.cylinders)
    union_hints = None
    if union_axes:
        p1, p2 = _axis_pair(next(units), next(units)), _axis_pair(next(units), next(units))
        if p1 is not None and p2 is not None:
            union_hints = (p1, p2)
    hc_hints = None
    if hc_axes:
        hs = tuple(next(units) for _ in hc_axes)
        if all(h is not None for h in hs):
            hc_hints = hs
    tiger_hints = None
    if tiger_axes:
        pa, pb = _axis_pair(next(units), next(units)), _axis_pair(next(units), next(units))
        if pa is not None and pb is not None:
            tiger_hints = (pa, pb)
    if (all(h is None for h in cyl_hints) and union_hints is None and hc_hints is None
            and tiger_hints is None):
        return None
    return AxisHints(cyl_hints, union_hints, hc_hints, tiger_hints)


def freeze_hint_grads(grads: Scene, plane_hints, axis_hints) -> Scene:
    """``grads`` (a Scene of gradients) with the leaves the freeze_hints
    contract freezes made zero (scene.py:219-259): every hyperplane normal
    when there are plane hints, and the axis vectors of each hinted
    composite primitive (a hinted cylinder's, both duocylinder families',
    the hypercube's, the tiger's four cylinders'). Under the static hints
    the gradient kernels' gradients are exact for every other leaf: the
    pair fold rewrites the walls' math, so the normals' cotangents are not
    the unhinted fold's, and a hinted axis's dropped projection terms
    would get none."""

    def zvec(v: Vec4) -> Vec4:
        return Vec4(*(torch.zeros_like(c) for c in v))

    def zcyl(c: CylinderSpec) -> CylinderSpec:
        return c._replace(axis1=zvec(c.axis1), axis2=zvec(c.axis2))

    if plane_hints is not None and grads.spaces:
        grads = grads._replace(spaces=tuple(sp._replace(norm=zvec(sp.norm))
                                            for sp in grads.spaces))
    ah = axis_hints
    if ah is None:
        return grads
    if grads.cylinders and any(h is not None for h in ah.cylinders):
        grads = grads._replace(cylinders=tuple(
            zcyl(c) if k < len(ah.cylinders) and ah.cylinders[k] is not None else c
            for k, c in enumerate(grads.cylinders)))
    if grads.cylinders_union is not None and ah.cylinders_union is not None:
        grads = grads._replace(cylinders_union=tuple(zcyl(c) for c in grads.cylinders_union))
    if grads.hypercube is not None and ah.hypercube is not None:
        hc = grads.hypercube
        grads = grads._replace(hypercube=hc._replace(axes=tuple(zvec(a) for a in hc.axes)))
    if grads.tiger is not None and ah.tiger is not None:
        tg = grads.tiger
        grads = grads._replace(tiger=tg._replace(
            inner_cyl1=zcyl(tg.inner_cyl1), outer_cyl1=zcyl(tg.outer_cyl1),
            inner_cyl2=zcyl(tg.inner_cyl2), outer_cyl2=zcyl(tg.outer_cyl2)))
    return grads


def _cyl_family_aligned(point: Vec4, pair, ray_o: Vec4, ray_d: Vec4) -> geo._CylFamily:
    """geo._cyl_family for a family whose axes are signed unit basis
    vectors ((k1, s1), (k2, s2)) (scene.py:274-306): the projections zero
    components k1 and k2, and the dots sum the live components alone, in
    ascending order from the first live one; equal to the full dots (the
    dropped terms are exact zeros there), a zero's sign aside."""
    (k1, _s1), (k2, _s2) = pair
    live = [j for j in range(4) if j not in (k1, k2)]
    zero = torch.zeros_like(ray_d.x)
    co = [pc - oc for pc, oc in zip(point, ray_o)]
    po_c = [zero if j in (k1, k2) else co[j] for j in range(4)]
    d_c = list(ray_d)
    d12_c = [zero if j in (k1, k2) else d_c[j] for j in range(4)]
    a, b = live
    l2 = co[a] * co[a] + co[b] * co[b] + 1e-37
    b_raw = co[a] * d_c[a] + co[b] * d_c[b]
    # len1_sq drops only k1 (the first projection).
    l1_live = [j for j in range(4) if j != k1]
    len1_sq = d_c[l1_live[0]] * d_c[l1_live[0]]
    for j in l1_live[1:]:
        len1_sq = len1_sq + d_c[j] * d_c[j]
    len12_sq = d_c[a] * d_c[a] + d_c[b] * d_c[b]
    proj_ok = (len1_sq >= SMALL2) & (len12_sq >= SMALL2)
    inv_len = geo.rsqrt(torch.where(proj_ok, len12_sq, 1.0))
    degenerate = l2 < SMALL2
    b_unit = torch.where(degenerate, 0.0, b_raw * inv_len)
    return geo._CylFamily(Vec4(*po_c), Vec4(*d12_c), l2, b_raw, len1_sq, len12_sq, inv_len,
                          proj_ok, b_unit, degenerate, l2 - b_unit * b_unit)


def _make_family(point, axis1, axis2, pair, o, d) -> geo._CylFamily:
    if pair is None:
        return geo._cyl_family(point, axis1, axis2, o, d)
    return _cyl_family_aligned(point, pair, o, d)


def intersect_scene_fast(scene: Scene, ray_o: Vec4, ray_d: Vec4, plane_hints=None,
                         plane_pairs=None, axis_hints=None) -> Intersection:
    """Closest hit over all primitives (scene.py:315-720), with the static
    hints of the JAX production fold when they are given.

    Each candidate folds only a masked distance (FAR on a miss); a strictly
    nearer candidate wins, so ties keep the earlier one. The winner's
    normal and material resolve once, after the fold, through a serial
    masked chain. The candidates come in the JAX order: with
    ``plane_pairs`` (and ``plane_hints``) the wall pairs, then the single
    planes; without, the planes in scene order; then the spheres, the
    cylinders, the duocylinder's two faces, the hypercube's four
    opposite-cell candidates (one, the literal cell-by-cell test, for a
    hypercube without generators) and the tiger's four merged candidates.
    ``plane_hints`` drops the hinted normal components from a single
    plane's dots, and its resolver writes +0 there, where the unhinted one
    writes flip * 0.0; the pair fold picks the nearer wall with two
    compares and divides once; ``axis_hints`` (AxisHints) turns an aligned
    family's or the hypercube's projections into component picks. All
    leave every hit, distance, glow, reflectivity and color as the
    unhinted fold computes them, and every normal component equal (a
    zero's sign aside).
    """
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
        sq = sqrt(torch.where(tangent, 1.0, disc))
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

    # Cylinder-family faces fold a masked distance each; the resolver
    # computes the family's normal at the folded distance.
    def add_family_face(fam, dist_c, hit_c, flip, r, mat):
        dists.append(torch.where(hit_c, dist_c, FAR))

        def resolve(dist, hit_p, fam=fam, r=r, flip=flip, mat=mat):
            return geo._family_norm(fam, dist, r, flip), mat.glow, mat.refl_prob, mat.color

        resolvers.append(resolve)

    ah = axis_hints if axis_hints is not None else AxisHints()

    for k_cyl, cyl in enumerate(scene.cylinders):
        pair = ah.cylinders[k_cyl] if k_cyl < len(ah.cylinders) else None
        fam = _make_family(cyl.point, cyl.axis1, cyl.axis2, pair, o, d)
        dist_c, hit_c, use_near = geo._family_circle_dist(fam, cyl.r)
        add_family_face(fam, dist_c, hit_c, use_near, cyl.r, cyl.material)

    if scene.cylinders_union is not None:
        # The duocylinder: two faces, each clipped against the other
        # family, both against cylinder 2's radius (the reference's quirk,
        # geometry.py:18-20).
        c1, c2 = scene.cylinders_union
        u1, u2 = ah.cylinders_union or (None, None)
        fam1 = _make_family(c1.point, c1.axis1, c1.axis2, u1, o, d)
        fam2 = _make_family(c2.point, c2.axis1, c2.axis2, u2, o, d)
        r2sq = c2.r * c2.r
        for fam, other, r, mat in ((fam1, fam2, c1.r, c1.material),
                                   (fam2, fam1, c2.r, c2.material)):
            dist_c, hit_c, use_near = geo._family_circle_dist(fam, r)
            hit_c = hit_c & (geo._family_clip_sq(other, dist_c) <= r2sq)
            add_family_face(fam, dist_c, hit_c, use_near, r, mat)

    if cells_only(scene):
        # Built from its cells alone: the literal cell-by-cell test as one
        # candidate, its record resolving itself.
        rec = geo.hypercube_intersection(scene.hypercube, o, d)
        dists.append(torch.where(rec.hit, rec.dist, FAR))
        resolvers.append(lambda dist, hit_p, rec=rec: (rec.norm, rec.glow, rec.refl_prob,
                                                       rec.color))
    elif scene.hypercube is not None:
        # Opposite cells paired per axis: the +cell faces the ray iff
        # dd_i <= 0, the -cell iff dd_i >= 0, so each axis folds one
        # candidate with its h and material picked by that sign; at most
        # one cell hits (entry hits of a convex boundary), so the closest
        # fold is the reference's first hit in cell order.
        hc = scene.hypercube
        c, axes, r = hc.point, hc.axes, hc.r
        if ah.hypercube is not None:
            co = [s * (c[k] - o[k]) for k, s in ah.hypercube]
            dd = [s * d[k] for k, s in ah.hypercube]
        else:
            co = [dot(c - o, a) for a in axes]
            dd = [dot(d, a) for a in axes]
        for i in range(4):
            pos = dd[i] <= 0.0  # the +cell is the facing one
            h = torch.where(pos, -(co[i] + r), co[i] - r)
            cos_dn = torch.abs(dd[i])
            inside = h >= 0.0  # facing; cos_dn >= 0 by construction
            dist_c = h / torch.where(cos_dn == 0.0, 1e-30, cos_dn)
            for j in range(4):
                if j != i:
                    inside = inside & (torch.abs(dist_c * dd[j] - co[j]) <= r)
            dists.append(torch.where(inside, dist_c, FAR))

            def resolve(dist, hit_p, a=axes[i], pos=pos, mat_p=hc.cubes[i].material,
                        mat_n=hc.cubes[4 + i].material):
                sgn = torch.where(pos, 1.0, -1.0)
                glow = torch.where(pos, mat_p.glow, mat_n.glow)
                refl = torch.where(pos, mat_p.refl_prob, mat_n.refl_prob)
                return Vec4(*(sgn * ac for ac in a)), glow, refl, mat_p.color.where(pos, mat_n.color)

            resolvers.append(resolve)

    if scene.tiger is not None:
        # Four merged candidates, (A, r_in), (A, r_out), (B, r_in), (B,
        # r_out): each (family, radius)'s outer and inner face fold as one,
        # the near root where the origin is outside the circle and the near
        # clip keeps it, else the far root (scene.py:600-653).
        tg = scene.tiger
        ta, tb = ah.tiger or (None, None)
        fam_a = _make_family(tg.inner_cyl1.point, tg.inner_cyl1.axis1, tg.inner_cyl1.axis2, ta,
                             o, d)
        fam_b = _make_family(tg.inner_cyl2.point, tg.inner_cyl2.axis1, tg.inner_cyl2.axis2, tb,
                             o, d)
        for fam, other, r_in, r_out, o_in, o_out, mat in (
            (fam_a, fam_b, tg.inner_cyl1.r, tg.outer_cyl1.r, tg.inner_cyl2.r, tg.outer_cyl2.r,
             tg.inner_cyl1.material),
            (fam_b, fam_a, tg.inner_cyl2.r, tg.outer_cyl2.r, tg.inner_cyl1.r, tg.outer_cyl1.r,
             tg.inner_cyl2.material),
        ):
            o_in2, o_out2 = o_in * o_in, o_out * o_out
            for r in (r_in, r_out):
                near, far, hit_c, use_near_outer = geo._family_circle(fam, r)
                clip_near = geo._family_clip_sq(other, near)
                clip_far = geo._family_clip_sq(other, far)
                keep_near = (clip_near <= o_out2) & (clip_near >= o_in2)
                keep_far = (clip_far <= o_out2) & (clip_far >= o_in2)
                take_near = use_near_outer & keep_near
                dist_c = torch.where(take_near, near, far)
                add_family_face(fam, dist_c, hit_c & (take_near | keep_far), take_near, r, mat)

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


def intersect_scene_spec(scene: Scene, ray_o: Vec4, ray_d: Vec4, trig: bool = False) -> Intersection:
    """The closest hit over every primitive, each by its literal
    intersection, folded by ``geometry.closest`` in scene order
    (scene.py:753-794); ``trig`` takes the reference's trigonometric
    sphere solution for the spheres and inside the cylinders."""
    sphere_fn = geo.sphere_intersection_trig if trig else geo.sphere_intersection
    inter = miss_like(ray_o.x)
    for sp in scene.spaces:
        inter = geo.closest(geo.space_intersection(sp.point, sp.norm, sp.material, ray_o, ray_d),
                            inter)
    for s in scene.spheres:
        inter = geo.closest(sphere_fn(s.center, s.r, s.material, ray_o, ray_d, True), inter)
    for c in scene.cylinders:
        inter = geo.closest(geo.cylinder_intersection(c.point, c.axis1, c.axis2, c.r, c.material,
                                                      ray_o, ray_d, True, trig), inter)
    if scene.cylinders_union is not None:
        c1, c2 = scene.cylinders_union
        inter = geo.closest(geo.cylinders_union_intersection(c1, c2, ray_o, ray_d, trig), inter)
    if scene.hypercube is not None:
        inter = geo.closest(geo.hypercube_intersection(scene.hypercube, ray_o, ray_d), inter)
    if scene.tiger is not None:
        inter = geo.closest(geo.tiger_intersection(scene.tiger, ray_o, ray_d, trig), inter)
    return inter


INTERSECT_MODES = ("fast", "spec", "trig")


def intersect_scene(scene: Scene, ray_o: Vec4, ray_d: Vec4, mode: str = "fast", plane_hints=None,
                    plane_pairs=None, axis_hints=None) -> Intersection:
    """The fold ``mode`` names (scene.py:797-816): "fast", the production
    fold with the static hints it is given; "spec", the literal
    per-primitive fold; "trig", the literal fold with the reference's
    trigonometric sphere solution (the oracle's configuration). The
    literal folds take no hints."""
    if mode == "spec":
        return intersect_scene_spec(scene, ray_o, ray_d)
    if mode == "trig":
        return intersect_scene_spec(scene, ray_o, ray_d, trig=True)
    if mode != "fast":
        raise ValueError(f"intersect must be one of {INTERSECT_MODES}, got {mode!r}")
    return intersect_scene_fast(scene, ray_o, ray_d, plane_hints, plane_pairs, axis_hints)


# --- constructors (Python floats -> 0-d float32 tensors on ``device``) ---

def material(glow: float, refl_prob: float, color: tuple, device) -> Material:
    return Material.of(glow, refl_prob, color, device)


def space(point: tuple, norm: tuple, mat: Material, device) -> SpaceSpec:
    return SpaceSpec(Vec4.of(*point, device=device), Vec4.of(*norm, device=device), mat)


def sphere(center: tuple, r: float, mat: Material, device) -> SphereSpec:
    return SphereSpec(Vec4.of(*center, device=device), f32(r, device), mat)


def cylinder(point: tuple, axis1: tuple, axis2: tuple, r: float, mat: Material,
             device) -> CylinderSpec:
    return CylinderSpec(Vec4.of(*point, device=device), Vec4.of(*axis1, device=device),
                        Vec4.of(*axis2, device=device), f32(r, device), mat)


def sun(drct: tuple, angular_size: float, light: tuple, sharpness: float, device) -> Sun:
    return Sun(
        Vec4.of(*drct, device=device),
        f32(angular_size, device),
        Vec3.of(*light, device=device),
        f32(sharpness, device),
    )


def environment(sun_: Sun, sky_light: tuple, enabled: bool = True, *, device) -> Environment:
    return Environment(sun_, Vec3.of(*sky_light, device=device), enabled)
