"""Differentiable rendering: losses, gradients, training steps.

Counterpart of fourd_ray_tracing_tpu/diff.py:67-402, 457-484, 542-627,
690-726 and 829-1080. Gradients are those of the estimator at a fixed seed
(the JAX package's diff.py:8-24): uniforms are constants, hit/miss and
mirror/diffuse decisions stay at their sampled outcomes, and cotangents
flow through the continuous geometry and shading. So an object whose only
effect on the image is its outline gets no position gradient from
``image_loss``; ``soft_image_loss`` gives it one, by blending the render
with and without the object through a differentiable primary-ray
coverage.

Two routes compute the gradients. The plain one is torch autograd over
the plain pipeline (models/renderer.py), the counterpart of
``impl="xla"``. The kernel one is the counterpart of ``impl="pallas"``:

* ``ImageLoss`` (hard loss) launches the value-and-grad kernel K4 once in
  its forward and scales the saved gradient in its backward;
* ``SoftImageLoss`` (soft loss of a sphere or a composite) launches the
  fused soft kernel K6 once; the coverage alpha is plain torch outside
  it, and the kernel returns alpha's cotangent for autograd to carry
  back;
* ``RenderLight`` renders the mean light with K1 (K2 for params rows) and
  differentiates it with the light-VJP kernel K5, so any torch loss over
  rendered light trains on the kernels: the soft loss of a hyperplane,
  which cannot be zeroed into a miss, and ``render_light_pair``.

On CPU tensors the kernel route runs the plain expression instead, as
every kernel wrapper of the port does.

With a ``mesh`` (parallel/mesh.py) of any (rays, samples) shape every
rank takes the same Adam step:

* the plain route: rank (r, s) renders samples block s of rows block r
  (``mesh.rows``) and takes their part of the global mean loss;
  ``make_train_step`` all-reduces the loss and the parameter gradients
  after the local backward in one packed collective. A term that every
  rank of a samples group computes alike (the coverage of a rows block)
  is differentiated by one rank of the group only, so the all-reduce
  counts it once;
* the kernel route: a launch takes every sample, so each rank holds its
  block of the rows split over every rank of the mesh
  (``mesh.kernel_rows``, possibly empty), and the sharded wrappers run
  inside the autograd Functions: one K4 or K6 launch per rank on its
  block, whose [loss, grad] the wrapper all-reduces, so the Function
  returns the whole image's loss and scales the whole image's gradient.
  The soft loss's coverage is differentiated through each rank's block
  and summed over the ranks in its backward (``pmesh.SumGrad``).

Every gradient path takes the static hints under the freeze_hints
contract (``with_frozen_hints``, diff.py:415-455: the production
configuration of every JAX bench training line), and refuses them without
it (renderer.check_trainable). The plain route takes every configuration
the plain pipeline renders; the kernel route every one with per-sample
streams (gradkernel.check_kernel_config refuses the sequential stream, as
the JAX package does), on either device: every sampler, the fast and the
literal spec and trig folds, a hypercube with or without generators. Under
a literal fold ``with_frozen_hints`` derives no hints, so nothing is
frozen. Under the contract the
kernel route launches K1/K2,
K4, K5 and K6 with the forward's hinted fold, and the kernels write the
frozen slots (every hyperplane normal; the hinted composite axes) as 0,
every other gradient and the loss being the unhinted launch's; the plain
route folds the plain pipeline with the same hints and stops the frozen
leaves (``stop_frozen``, the JAX package's _stop_frozen_for_coverage,
diff.py:774-792), where the JAX package's jnp route refuses hints. The
coverage of the soft loss stops them too; a hyperplane's soft fallback
renders the scene without the wall with the wall's hint row dropped and
the pairs off (``hints_for_dropped``, diff.py:795-827).

Every gradient path, hard and soft, takes every primitive, the composite
ones (cylinders, the duocylinder, the hypercube, the tiger) included,
hinted or not; the soft loss takes each of them as its object
(``object_coverage``, ``drop_object``, ``zero_object``): a composite runs
one K6 launch a step, as a sphere does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from fourd_ray_tracing_tpu_torch.camera import Camera
from fourd_ray_tracing_tpu_torch.models import params, renderer
from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig
from fourd_ray_tracing_tpu_torch.models.scene import COMPOSITE_KINDS, Scene
from fourd_ray_tracing_tpu_torch.ops import geometry as geo
from fourd_ray_tracing_tpu_torch.ops.cuda import gradkernel, megakernel
from fourd_ray_tracing_tpu_torch.ops.sky import light_to_color
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4, dot
from fourd_ray_tracing_tpu_torch.parallel import mesh as pmesh
from fourd_ray_tracing_tpu_torch.utils import profiling

IMPLS = ("plain", "kernel")


def with_frozen_hints(cfg: RenderConfig, scene: Scene) -> RenderConfig:
    """``cfg`` with the freeze_hints contract on and the forward's static
    hints of ``scene`` derived where it has none (diff.py:415-455): the
    production training configuration. The gradient kernels then fold
    with the forward's hints (loss and every other gradient bitwise the
    unhinted launch's) and write the hyperplane normals' and the hinted
    axes' gradients as 0. ``grad_sample_chunk`` becomes the largest divisor
    of ``samples`` up to 8, as in the JAX package; the port's sweep has no
    chunks, so nothing depends on it. The hints come from the scene's
    values (its leaves may require grad); call it once, before building the
    train step."""
    cfg = dataclasses.replace(cfg, freeze_hints=True)
    if cfg.grad_sample_chunk == 1:
        g = max(g for g in range(1, min(cfg.samples, 8) + 1) if cfg.samples % g == 0)
        cfg = dataclasses.replace(cfg, grad_sample_chunk=g)
    if cfg.intersect != "fast":
        return cfg
    return megakernel.with_hints(params.map_leaves(torch.Tensor.detach, scene), cfg)


def stop_frozen(scene: Scene, cfg: RenderConfig) -> Scene:
    """``scene`` with the leaves the freeze_hints contract freezes detached
    (the JAX package's _stop_frozen_for_coverage, diff.py:774-792): values
    bitwise the same, no gradient through them. The plain route and the
    soft loss's coverage differentiate through it, so that no gradient path
    reaches a frozen leaf. ``scene`` as it is when ``cfg`` freezes
    nothing."""
    frozen = params.frozen_leaves(cfg, scene)
    if frozen is None:
        return scene
    it = iter(frozen)
    return params.map_leaves(lambda t: t.detach() if next(it) else t, scene)


def hints_for_dropped(cfg: RenderConfig, object_ref) -> RenderConfig:
    """``cfg``'s static hints remapped for ``drop_object(scene,
    object_ref)`` (diff.py:795-827): a dropped hyperplane loses its
    plane_hints row and the wall pairs go off (their indices shift); a
    dropped cylinder its axis-hint entry; a dropped duocylinder, hypercube
    or tiger its field. A dropped sphere changes nothing."""
    kind, idx = object_ref
    if kind == "spaces" and cfg.plane_hints is not None:
        hints = tuple(h for k, h in enumerate(cfg.plane_hints) if k != idx)
        cfg = dataclasses.replace(cfg, plane_hints=hints or None, plane_pairs=None)
    ah = cfg.axis_hints
    if ah is not None:
        if kind == "cylinders" and ah.cylinders:
            ah = ah._replace(cylinders=tuple(h for k, h in enumerate(ah.cylinders) if k != idx))
        elif kind in ("cylinders_union", "hypercube", "tiger"):
            ah = ah._replace(**{kind: None})
        if (not any(ah.cylinders) and ah.cylinders_union is None and ah.hypercube is None
                and ah.tiger is None):
            ah = None
        cfg = dataclasses.replace(cfg, axis_hints=ah)
    return cfg


def _rows_part(image_rows: torch.Tensor, target, rows, height: int) -> torch.Tensor:
    """The part of mean((image - target)^2) over the whole image that image
    rows [row0, row0 + n_rows) make: ``image_rows`` those rows of the
    image, ``target`` the whole target."""
    row0, n_rows = rows
    target = torch.as_tensor(target, dtype=torch.float32, device=image_rows.device)
    count = image_rows.numel() // n_rows * height
    return torch.sum((image_rows - target[..., row0:row0 + n_rows, :, :]) ** 2) / count


def image_loss(scene: Scene, camera: Camera, cfg: RenderConfig, seed, target,
               mesh=None) -> torch.Tensor:
    """MSE between the rendered (tone-mapped) image and a target,
    differentiable by torch autograd. With a mesh, this rank's part of it:
    its rows of the image, rendered over the mesh (the rows' parts sum to
    the MSE over the rays group). Under the freeze_hints contract the
    pipeline folds with the hints and the frozen leaves get no gradient."""
    renderer.check_trainable(cfg)
    scene = stop_frozen(scene, cfg)
    if mesh is None:
        return renderer.image_loss(scene, camera, cfg, seed, target)
    image = pmesh.sharded_render_image(scene, camera, cfg, seed, mesh, gather=False)
    return _rows_part(image, target, mesh.rows(cfg.height), cfg.height)


def _reduce(loss: torch.Tensor, grads, mesh):
    """(loss, grads) of the whole image on every rank from each rank's
    part on the plain route: one all-reduce over the world. The loss of a
    rows block counts once: every rank of a samples group holds the same
    part, and only the group's first rank adds it."""
    own = loss.detach() if mesh.sample_index == 0 else torch.zeros_like(loss)
    out = pmesh.all_reduce_sum([own, *grads], mesh)
    return out[0], out[1:]


def render_grad(scene: Scene, camera: Camera, cfg: RenderConfig, seed, target, mesh=None):
    """(loss, (grad_scene, grad_camera)) at a fixed seed, by autograd over
    the plain pipeline; with a mesh, the whole image's on every rank."""
    if mesh is None:
        loss, grad = gradkernel.loss_and_grad_plain(params.pack(scene, camera), scene, camera,
                                                    cfg, seed, target)
        return loss, params.unpack(grad, scene, camera)
    vec = params.pack(scene, camera).detach().requires_grad_(True)
    loss = image_loss(*params.unpack(vec, scene, camera), cfg, seed, target, mesh)
    (grad,) = torch.autograd.grad(loss, vec)
    loss, (grad,) = _reduce(loss, [grad], mesh)
    return loss, params.unpack(grad, scene, camera)


# --- Soft-silhouette boundary gradients --------------------------------------

# The object kinds of an object_ref: the tuples indexed by i, then the
# composites that a scene holds at most once (index None).
OBJECT_KINDS = ("spheres", "spaces") + COMPOSITE_KINDS


def _check_kind(kind) -> None:
    if kind not in OBJECT_KINDS:
        raise ValueError(f"unknown object kind: {kind!r}")


def _inv_width(edge_width: float) -> float:
    """1 / edge_width in float32, as jnp computes it."""
    return float(np.float32(1.0) / np.float32(edge_width))


def _primary_rays(camera: Camera, cfg: RenderConfig):
    """Every pixel's primary ray: (origin, direction), (H, W) or (V, H, W)
    components."""
    scr_x, scr_y = renderer.screen_coords(cfg, camera.focus.x.device)
    d = renderer.primary_directions(camera, scr_x, scr_y)
    o = renderer._expand_cam_vec(camera.focus, d.x.dim())
    return Vec4(*(c.expand(d.x.shape) for c in o)), d


def _max0(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) as jnp.maximum(x, 0.0) differentiates it: at x == 0 the
    gradient is halved between the two sides (torch.clamp_min passes it
    whole), which decides a pixel whose primary ray meets an axis plane
    exactly (perp2 == 0, where sqrt(perp2 + 1e-20) is steepest)."""
    return torch.maximum(x, torch.zeros_like(x))


def _sphere_coverage(center: Vec4, r, o: Vec4, d: Vec4, inv_w: float) -> torch.Tensor:
    """sigmoid((r - d_perp) / w), d_perp the distance of the center from
    the ray line, gated by the approach margin; 1 inside the sphere."""
    po = center - o
    b = dot(po, d)
    l2 = dot(po, po)
    perp = torch.sqrt(_max0(l2 - b * b) + 1e-20)
    alpha = torch.sigmoid((r - perp) * inv_w)
    # Receding rays cannot see the sphere: gate on the approach margin.
    approaching = torch.sigmoid((b + r) * inv_w)
    inside = l2 < r * r  # camera inside the sphere: fully covered
    return torch.where(inside, torch.ones_like(alpha), alpha * approaching)


def _plane_coverage(sp, o: Vec4, d: Vec4, inv_w: float) -> torch.Tensor:
    """A double-sided hyperplane is hit iff the ray heads toward it; the
    product s * cos relaxes that test."""
    s = dot(sp.point - o, sp.norm)
    cos_n = dot(d, sp.norm)
    return torch.sigmoid(s * cos_n * inv_w * 4.0)


def _circle_coverage(fam: geo._CylFamily, r, inv_w: float) -> torch.Tensor:
    """sigmoid((r - d_perp) / w) of a cylinder family's circle, d_perp the
    distance of the projected ray line from the axis plane; 1 where the
    projected origin lies inside the circle."""
    perp = torch.sqrt(_max0(fam.perp2) + 1e-20)
    alpha = torch.sigmoid((r - perp) * inv_w)
    return torch.where(fam.l2 < r * r, torch.ones_like(alpha), alpha)


def _cylinder_coverage(spec, o: Vec4, d: Vec4, inv_w: float) -> torch.Tensor:
    """The circle coverage in the plane orthogonal to both axes, gated by
    the approach margin (diff.py:162-173)."""
    fam = geo._cyl_family(spec.point, spec.axis1, spec.axis2, o, d)
    perp = torch.sqrt(_max0(fam.perp2) + 1e-20)
    alpha = torch.sigmoid((spec.r - perp) * inv_w)
    approaching = torch.sigmoid((fam.b + spec.r) * inv_w)
    inside = fam.l2 < spec.r * spec.r
    return torch.where(inside, torch.ones_like(alpha), alpha * approaching)


def _clipped_face(fam: geo._CylFamily, other: geo._CylFamily, r, clip_in, clip_out,
                  inv_w: float) -> torch.Tensor:
    """A family's outer face: its circle coverage times a soft clip of the
    hit point's squared distance to the other family's axis plane below
    clip_out^2 (and, with ``clip_in``, above clip_in^2), the squared-space
    band scaled by 2 clip_out so that it is about edge_width wide."""
    circ = _circle_coverage(fam, r, inv_w)
    dist, _, _ = geo._family_circle_dist(fam, r, True)
    clip_sq = geo._family_clip_sq(other, dist)
    inv_w_sq = inv_w / (2.0 * clip_out + 1e-20)
    soft = torch.sigmoid((clip_out * clip_out - clip_sq) * inv_w_sq)
    if clip_in is not None:
        soft = soft * torch.sigmoid((clip_sq - clip_in * clip_in) * inv_w_sq)
    return circ * soft


def _duocylinder_coverage(cyl1, cyl2, o: Vec4, d: Vec4, inv_w: float) -> torch.Tensor:
    """Each face's circle coverage soft-clipped by the other cylinder, the
    faces' soft union (diff.py:176-196). Face 2 is clipped by cyl2.r, as
    in the JAX package (its C6i quirk)."""
    fam1 = geo._cyl_family(cyl1.point, cyl1.axis1, cyl1.axis2, o, d)
    fam2 = geo._cyl_family(cyl2.point, cyl2.axis1, cyl2.axis2, o, d)
    a1 = _clipped_face(fam1, fam2, cyl1.r, None, cyl2.r, inv_w)
    a2 = _clipped_face(fam2, fam1, cyl2.r, None, cyl2.r, inv_w)
    return a1 + a2 - a1 * a2


def _hypercube_coverage(hc, o: Vec4, d: Vec4, inv_w: float) -> torch.Tensor:
    """The soft union of the 8 cells: each cell's facing and its three
    extent tests relaxed to sigmoids (diff.py:199-221)."""
    c, axes, r = hc.point, hc.axes, hc.r
    co = [dot(c - o, a) for a in axes]
    dd = [dot(d, a) for a in axes]
    alpha = None
    for sign in (1.0, -1.0):
        for i in range(4):
            h = -(co[i] + r) if sign > 0 else co[i] - r
            cos_dn = -dd[i] if sign > 0 else dd[i]
            denom = torch.where(torch.abs(cos_dn) < 1e-6, 1e-6, cos_dn)
            dist = _max0(h) / torch.abs(denom)
            a_cell = torch.sigmoid(h * inv_w) * torch.where(cos_dn > 0.0, 1.0, 0.0)
            for j in range(4):
                if j != i:
                    e = dist * dd[j] - co[j]
                    a_cell = a_cell * torch.sigmoid((r - torch.abs(e)) * inv_w)
            alpha = a_cell if alpha is None else alpha + a_cell - alpha * a_cell
    return alpha


def _tiger_coverage(tg, o: Vec4, d: Vec4, inv_w: float) -> torch.Tensor:
    """The outer faces of both cylinder families, each soft-clipped to the
    other family's annulus, and their soft union (diff.py:224-249)."""
    fam_a = geo._cyl_family(tg.outer_cyl1.point, tg.outer_cyl1.axis1, tg.outer_cyl1.axis2, o, d)
    fam_b = geo._cyl_family(tg.outer_cyl2.point, tg.outer_cyl2.axis1, tg.outer_cyl2.axis2, o, d)
    a1 = _clipped_face(fam_a, fam_b, tg.outer_cyl1.r, tg.inner_cyl2.r, tg.outer_cyl2.r, inv_w)
    a2 = _clipped_face(fam_b, fam_a, tg.outer_cyl2.r, tg.inner_cyl1.r, tg.outer_cyl1.r, inv_w)
    return a1 + a2 - a1 * a2


def primary_coverage(center: Vec4, r, camera: Camera, cfg: RenderConfig,
                     edge_width: float) -> torch.Tensor:
    """Differentiable per-pixel coverage of a sphere by the primary rays,
    (H, W) or (V, H, W), values in (0, 1]."""
    o, d = _primary_rays(camera, cfg)
    return _sphere_coverage(center, r, o, d, _inv_width(edge_width))


def object_coverage(scene: Scene, object_ref, camera: Camera, cfg: RenderConfig,
                    edge_width: float) -> torch.Tensor:
    """Differentiable primary-ray coverage of one scene object (diff.py
    :261-287), ``object_ref`` = ("spheres", i), ("spaces", i),
    ("cylinders", i), ("cylinders_union", None), ("hypercube", None) or
    ("tiger", None); (H, W) or (V, H, W)."""
    kind, idx = object_ref
    _check_kind(kind)
    o, d = _primary_rays(camera, cfg)
    inv_w = _inv_width(edge_width)
    if kind == "spheres":
        sp = scene.spheres[idx]
        return _sphere_coverage(sp.center, sp.r, o, d, inv_w)
    if kind == "spaces":
        return _plane_coverage(scene.spaces[idx], o, d, inv_w)
    if kind == "cylinders":
        return _cylinder_coverage(scene.cylinders[idx], o, d, inv_w)
    if kind == "cylinders_union":
        return _duocylinder_coverage(*scene.cylinders_union, o, d, inv_w)
    if kind == "hypercube":
        return _hypercube_coverage(scene.hypercube, o, d, inv_w)
    return _tiger_coverage(scene.tiger, o, d, inv_w)


def drop_sphere(scene: Scene, sphere_index: int) -> Scene:
    """The scene without sphere ``sphere_index``."""
    return scene._replace(spheres=tuple(s for k, s in enumerate(scene.spheres)
                                        if k != sphere_index))


def drop_object(scene: Scene, object_ref) -> Scene:
    """The scene without the referenced object (a change of structure,
    diff.py:290-300): the entry of a tuple kind, or the composite's field
    set to None."""
    kind, idx = object_ref
    _check_kind(kind)
    if kind in ("spheres", "spaces", "cylinders"):
        items = getattr(scene, kind)
        return scene._replace(**{kind: tuple(x for k, x in enumerate(items) if k != idx)})
    return scene._replace(**{kind: None})


def _with_r(spec, r: float):
    return spec._replace(r=torch.zeros_like(spec.r) + r)


def zero_object(scene: Scene, object_ref) -> Scene:
    """The scene with the referenced object made a guaranteed miss, keeping
    its structure (diff.py:303-364): radius 0 for a sphere, a cylinder,
    both duocylinder cylinders and all four tiger cylinders (the
    discriminant is never positive, every ray tangent); -1 for the
    hypercube's generator r and every cell's r (no extent test |e| <= r
    passes). The light is bitwise that of ``drop_object``. A hyperplane
    has no miss radius: ("spaces", i) raises ValueError, and the soft loss
    falls back to drop_object for it."""
    kind, idx = object_ref
    _check_kind(kind)
    if kind in ("spheres", "cylinders"):
        items = getattr(scene, kind)
        return scene._replace(**{kind: tuple(_with_r(x, 0.0) if k == idx else x
                                             for k, x in enumerate(items))})
    if kind == "cylinders_union":
        return scene._replace(cylinders_union=tuple(_with_r(c, 0.0)
                                                    for c in scene.cylinders_union))
    if kind == "tiger":
        return scene._replace(tiger=scene.tiger._make(_with_r(c, 0.0) for c in scene.tiger))
    if kind == "hypercube":  # the generators' r (if it has them) and each cell's own copy
        hc = scene.hypercube
        hc = hc if hc.r is None else _with_r(hc, -1.0)
        return scene._replace(hypercube=hc._replace(
            cubes=tuple(_with_r(c, -1.0) for c in hc.cubes)))
    raise ValueError("zero_object does not support kind 'spaces' (hyperplanes fall back "
                     "to drop_object)")


def _blend(alpha, img_with, img_without) -> torch.Tensor:
    alpha = alpha[..., None]
    return alpha * img_with + (1.0 - alpha) * img_without


def _blend_loss(alpha, img_with, img_without, target) -> torch.Tensor:
    return torch.mean((_blend(alpha, img_with, img_without) - target) ** 2)


def soft_image_loss(scene: Scene, camera: Camera, cfg: RenderConfig, seed, target,
                    sphere_index: int = 0, edge_width: float = 0.05, mesh=None,
                    object_ref=None) -> torch.Tensor:
    """MSE with soft-silhouette gradients for one designated object: the
    scene and the scene without the object render at the same seed and
    blend by ``object_coverage``. ``object_ref`` defaults to ("spheres",
    sphere_index). The plain reference of the soft training slice. With a
    mesh, this rank's part: its rows, rendered over the mesh."""
    renderer.check_trainable(cfg)
    if object_ref is None:
        object_ref = ("spheres", sphere_index)
    scene = stop_frozen(scene, cfg)
    without = drop_object(scene, object_ref)
    cfg_without = hints_for_dropped(cfg, object_ref)
    alpha = object_coverage(scene, object_ref, camera, cfg, edge_width)
    if mesh is None:
        img_with = renderer.render_image(scene, camera, cfg, seed)
        img_without = renderer.render_image(without, camera, cfg_without, seed)
        return _blend_loss(alpha, img_with, img_without, target)
    img_with = pmesh.sharded_render_image(scene, camera, cfg, seed, mesh, gather=False)
    img_without = pmesh.sharded_render_image(without, camera, cfg_without, seed, mesh,
                                             gather=False)
    rows = mesh.rows(cfg.height)
    alpha = alpha[..., rows[0]:rows[0] + rows[1], :]
    if mesh.sample_index:  # the rows' coverage is differentiated once per samples group
        alpha = alpha.detach()
    return _rows_part(_blend(alpha, img_with, img_without), target, rows, cfg.height)


class ImageLoss(torch.autograd.Function):
    """``image_loss`` of the packed vector through K4: the forward launches
    the kernel once and keeps its gradient, the backward scales it by the
    incoming cotangent (the counterpart of the pallas_image_loss
    custom_vjp, diff.py:457-484). With a ``mesh``, K4 row-sharded
    (``gradkernel.sharded_loss_and_grad``: the whole image's loss and
    gradient on every rank; pallas_image_loss_sharded, diff.py:488-527)."""

    @staticmethod
    def forward(ctx, vec, like_scene, like_camera, cfg, seed, target, mesh=None):
        if mesh is None:
            loss, grad = gradkernel.loss_and_grad_cuda(vec, like_scene, like_camera, cfg, seed,
                                                       target)
        else:
            loss, grad = gradkernel.sharded_loss_and_grad(vec, like_scene, like_camera, cfg, seed,
                                                          target, mesh)
        ctx.save_for_backward(grad)
        return loss

    @staticmethod
    def backward(ctx, ct):
        (grad,) = ctx.saved_tensors
        return grad * ct, None, None, None, None, None, None


def image_loss_kernel(vec: torch.Tensor, like_scene: Scene, like_camera: Camera,
                      cfg: RenderConfig, seed, target, mesh=None) -> torch.Tensor:
    """``image_loss`` of the scene and camera packed in ``vec`` (P,),
    differentiable w.r.t. ``vec``: K4 for a CUDA vector, the plain
    expression for a CPU one. With a mesh of any shape, the whole image's
    loss and gradient on every rank from one K4 launch per rank on its
    block of rows (``mesh.kernel_rows``; on the CPU, K4's plain version on
    them). Either device takes what K4 takes
    (gradkernel.check_kernel_config)."""
    gradkernel.check_kernel_config(cfg)
    if mesh is not None:
        return ImageLoss.apply(vec, like_scene, like_camera, cfg, seed, target, mesh)
    if vec.device.type == "cpu":
        scene, camera = params.unpack(vec, like_scene, like_camera)
        cfg = gradkernel._auto_hints(like_scene, cfg)
        return renderer.image_loss(stop_frozen(scene, cfg), camera, cfg, seed, target)
    if vec.device.type != "cuda":
        raise ValueError(f"image_loss_kernel takes CPU or CUDA tensors, got {vec.device}")
    return ImageLoss.apply(vec, like_scene, like_camera, cfg, seed, target)


class RenderLight(torch.autograd.Function):
    """The mean light of the scene(s) packed in ``vec`` at one seed, through
    the kernels: a (P,) vector renders with K1 and differentiates with K5
    (the counterpart of the pallas_render_light custom_vjp,
    diff.py:542-576); (F, P) params rows render with K2 and differentiate
    with K5's multi-row launch (pallas_render_light_pair, diff.py:589-627).
    CUDA only, but with a ``mesh`` (F, P) rows run row-sharded on either
    device: the rank's block of the light (``mesh.kernel_rows``,
    ``megakernel.sharded_render_light_cuda_multi``), and the whole image's
    gradient from the rank's block of the cotangent
    (``gradkernel.sharded_render_light_vjp_multi``;
    pallas_render_light_pair_sharded, diff.py:631-673)."""

    @staticmethod
    def forward(ctx, vec, like_scene, like_camera, cfg, seed, mesh=None):
        cfg = gradkernel._auto_hints(like_scene, cfg)
        gradkernel.check_kernel_config(cfg)
        words, batched = renderer.seed_words(seed)
        if batched:
            raise ValueError("the light-VJP path takes one scalar seed")
        ctx.save_for_backward(vec)
        ctx.meta = (like_scene, like_camera, cfg, seed, mesh)
        if mesh is not None:
            unpacked = [params.unpack(v, like_scene, like_camera) for v in vec.detach()]
            return megakernel.sharded_render_light_cuda_multi(
                [s for s, _ in unpacked], unpacked[0][1], cfg, seed, mesh, gather=False)
        multi = vec.dim() == 2
        seeds = megakernel.seed_tensor(words * (vec.shape[0] if multi else 1), vec.device)
        light = megakernel.launch_forward(vec.detach().contiguous(),
                                          params.layout(like_scene, like_camera), cfg, seeds)
        if like_camera.top.x.dim() == 0:
            light = light[:, 0]
        return light if multi else light[0]

    @staticmethod
    def backward(ctx, cot):
        (vec,) = ctx.saved_tensors
        like_scene, like_camera, cfg, seed, mesh = ctx.meta
        if mesh is None:
            grad = gradkernel.render_light_vjp_cuda(vec, like_scene, like_camera, cfg, seed, cot)
        else:
            grad = gradkernel.sharded_render_light_vjp_multi(vec, like_scene, like_camera, cfg,
                                                             seed, cot.contiguous(), mesh)
        return grad, None, None, None, None, None


def render_light_kernel(vec: torch.Tensor, like_scene: Scene, like_camera: Camera,
                        cfg: RenderConfig, seed) -> torch.Tensor:
    """Mean light (H, W, 3) or (V, H, W, 3) of the scene and camera packed
    in ``vec`` (P,), differentiable w.r.t. ``vec``: K1 forward and K5
    backward for a CUDA vector, the plain pipeline for a CPU one. Under the
    freeze_hints contract both fold with the hints and the frozen slots
    get no gradient. Either device takes what K5 takes
    (gradkernel.check_kernel_config)."""
    cfg = gradkernel._auto_hints(like_scene, cfg)
    gradkernel.check_kernel_config(cfg)
    if vec.device.type == "cpu":
        scene, camera = params.unpack(vec, like_scene, like_camera)
        return renderer.render_light(stop_frozen(scene, cfg), camera, cfg, seed)
    if vec.device.type != "cuda":
        raise ValueError(f"render_light_kernel takes CPU or CUDA tensors, got {vec.device}")
    return RenderLight.apply(vec, like_scene, like_camera, cfg, seed)


def render_light_pair(scene_a: Scene, scene_b: Scene, camera: Camera, cfg: RenderConfig,
                      seed, mesh=None) -> torch.Tensor:
    """Mean-light renders of two same-structure scenes (e.g. a scene and its
    ``zero_object`` copy) at one seed, stacked (2, ...): one K2 launch
    forward and one two-row K5 launch backward on the card. Row i equals
    ``render_light_kernel`` of scene i; differentiable w.r.t. both scenes
    and the camera, whose gradient sums over the rows. With a mesh of any
    shape, the rank's block of rows (``mesh.kernel_rows``, possibly empty),
    one launch each way per rank (none on an empty block; their
    plain versions on the CPU), whose backward all-reduces the gradient:
    a loss over each rank's block gives every rank the whole image's
    gradient (the counterpart of pallas_render_light_pair_sharded,
    diff.py:631-673)."""
    renderer.check_trainable(cfg)
    vecs = params.stack_rows((scene_a, scene_b), camera)
    if mesh is not None:
        return RenderLight.apply(vecs, scene_a, camera, cfg, seed, mesh)
    if vecs.device.type == "cpu":
        cfg = gradkernel._auto_hints(scene_a, cfg)
        rows = [params.unpack(v, scene_a, camera) for v in vecs]
        return torch.stack([renderer.render_light(stop_frozen(s, cfg), c, cfg, seed)
                            for s, c in rows])
    if vecs.device.type != "cuda":
        raise ValueError(f"render_light_pair takes CPU or CUDA tensors, got {vecs.device}")
    return RenderLight.apply(vecs, scene_a, camera, cfg, seed)


class SoftImageLoss(torch.autograd.Function):
    """The soft loss of the scene packed in ``vec`` blended with its
    zero-map copy by ``alpha``, through K6: the forward launches it once
    and keeps the parameter and alpha gradients, the backward scales them
    by the incoming cotangent (the counterpart of the _soft_kernel_loss
    custom_vjp, diff.py:690-726). CUDA only, but with a ``mesh`` K6
    row-sharded on either device (``gradkernel.sharded_soft_loss_and_grad``:
    the whole image's loss and parameter gradient on every rank, alpha's
    cotangent on the rank's block of rows (``mesh.kernel_rows``) and 0
    elsewhere; _soft_kernel_loss_sharded,
    diff.py:730-770)."""

    @staticmethod
    def forward(ctx, vec, alpha, like_scene, like_camera, cfg, seed, target, zero_map,
                mesh=None):
        if mesh is None:
            loss, grad, g_alpha = gradkernel.render_soft_loss_and_grad_cuda(
                vec, like_scene, like_camera, cfg, seed, target, alpha, zero_map)
        else:
            loss, grad, block = gradkernel.sharded_soft_loss_and_grad(
                vec, like_scene, like_camera, cfg, seed, target, alpha, zero_map, mesh)
            row0, n_rows = mesh.kernel_rows(cfg.height, vec.device)
            g_alpha = torch.zeros_like(alpha)
            g_alpha[..., row0:row0 + n_rows, :] = block
        ctx.save_for_backward(grad, g_alpha)
        return loss

    @staticmethod
    def backward(ctx, ct):
        grad, g_alpha = ctx.saved_tensors
        return grad * ct, g_alpha * ct, None, None, None, None, None, None, None


def soft_image_loss_kernel(vec: torch.Tensor, like_scene: Scene, like_camera: Camera,
                           cfg: RenderConfig, seed, target, object_ref,
                           edge_width: float = 0.05, mesh=None) -> torch.Tensor:
    """``soft_image_loss`` of the scene and camera packed in ``vec`` (P,),
    differentiable w.r.t. ``vec`` (the counterpart of soft_image_loss_pallas,
    diff.py:829-892). On the card, a sphere or a composite runs one K6
    launch, its coverage alpha plain torch; a hyperplane, which cannot be
    zeroed into a miss, renders with and without itself through two
    ``render_light_kernel`` nodes (two K1 and two K5 launches) and blends
    in torch. A CPU vector
    takes the plain expression. With a mesh, the whole image's loss and
    gradient on every rank from one K6 launch per rank on its block of rows
    (``mesh.kernel_rows``; on the CPU, K6's plain version on them), the
    coverage differentiated through the rank's block and summed over the
    ranks; a hyperplane with a mesh
    raises ValueError, as in the JAX package. Either device takes what K6
    takes (gradkernel.check_kernel_config)."""
    cfg = gradkernel._auto_hints(like_scene, cfg)
    gradkernel.check_kernel_config(cfg)
    if mesh is not None:
        if object_ref[0] == "spaces":
            raise ValueError("mesh-sharded soft training supports zero-emulatable object "
                             "kinds only (hyperplanes have no miss radius)")
        scene, camera = params.unpack(pmesh.SumGrad.apply(vec, mesh), like_scene, like_camera)
        alpha = object_coverage(stop_frozen(scene, cfg), object_ref, camera, cfg, edge_width)
        zero_map = params.soft_zero_map(like_scene, like_camera, object_ref)
        return SoftImageLoss.apply(vec, alpha, like_scene, like_camera, cfg, seed, target,
                                   zero_map, mesh)
    scene, camera = params.unpack(vec, like_scene, like_camera)
    if vec.device.type == "cpu":
        return soft_image_loss(scene, camera, cfg, seed, target, edge_width=edge_width,
                               object_ref=object_ref)
    if vec.device.type != "cuda":
        raise ValueError(f"soft_image_loss_kernel takes CPU or CUDA tensors, got {vec.device}")
    alpha = object_coverage(stop_frozen(scene, cfg), object_ref, camera, cfg, edge_width)
    if object_ref[0] == "spaces":
        without = drop_object(scene, object_ref)
        light_with = render_light_kernel(vec, like_scene, like_camera, cfg, seed)
        light_without = render_light_kernel(params.pack(without, camera),
                                            drop_object(like_scene, object_ref), like_camera,
                                            hints_for_dropped(cfg, object_ref), seed)
        return _blend_loss(alpha, light_to_color(light_with, cfg.light_coefficient),
                           light_to_color(light_without, cfg.light_coefficient),
                           torch.as_tensor(target, dtype=torch.float32, device=vec.device))
    zero_map = params.soft_zero_map(like_scene, like_camera, object_ref)
    return SoftImageLoss.apply(vec, alpha, like_scene, like_camera, cfg, seed, target, zero_map)


def frame_seeds(seed, frames_per_step: int):
    """The step's seed, or for a minibatch step its frames' seeds
    seed * F + arange(F) as uint32 words (diff.py:1055-1057)."""
    if frames_per_step <= 1:
        return seed
    words, batched = renderer.seed_words(seed)
    if batched:
        raise ValueError("a minibatch step takes one scalar seed")
    return [(words[0] * frames_per_step + k) & 0xFFFFFFFF for k in range(frames_per_step)]


def _check_impl(impl: str, frames_per_step: int, soft: bool = False) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if frames_per_step > 1 and (impl != "kernel" or soft):
        raise ValueError("frames_per_step > 1 is the value-and-grad kernel's minibatch "
                         "(impl='kernel', hard loss only)")


def make_train_step(cfg: RenderConfig, lr: float, camera: Camera,
                    param_filter: Optional[Callable] = None, impl: str = "plain",
                    frames_per_step: int = 1, mesh=None, soft_sphere_index=None,
                    soft_object_ref=None, edge_width: float = 0.05):
    """Inverse-rendering step over the scene's leaves with
    ``torch.optim.Adam(lr)``. Returns ``(step, init)``:

    * ``init(scene) -> (scene, optimizer)``: a copy of the scene whose
      leaves are the optimized tensors, and the optimizer over them;
    * ``step(scene, optimizer, seed, target) -> (scene, optimizer, loss,
      metrics)`` updates the leaves in place; ``metrics`` holds the loss
      and the global gradient norm.

    ``param_filter(grads) -> grads`` maps a Scene of gradients to the
    gradients to apply (zeroing frozen parameters). ``impl="kernel"``
    trains through K4 (``image_loss_kernel``); ``frames_per_step`` > 1,
    kernel only, averages that many estimator samples per step in one
    launch. ``soft_sphere_index`` or ``soft_object_ref`` switches to the
    soft-silhouette loss of that object, with coverage band ``edge_width``
    (``soft_image_loss``; with ``impl="kernel"`` ``soft_image_loss_kernel``,
    one K6 launch per step for a sphere or a composite), which gives
    silhouette-driven position and radius gradients; it takes one frame
    per step.

    ``mesh`` (parallel/mesh.py) shards the step over the mesh's ranks, each
    with its rows (the module's docstring): ``impl="plain"`` takes the
    rows' part of the loss and all-reduces the packed loss and gradients
    after the local backward; ``impl="kernel"`` (any mesh shape, as
    make_train_step(impl="pallas", mesh=...), diff.py:895) makes one K4 or
    K6 launch per rank on its block of the rows split over every rank,
    whose wrapper all-reduces them. Every rank takes the same step; the loss and ``grad_norm`` are
    the whole image's.
    """
    soft = soft_sphere_index is not None or soft_object_ref is not None
    _check_impl(impl, frames_per_step, soft)
    if impl == "kernel":
        gradkernel.check_kernel_config(cfg)
    else:
        renderer.check_trainable(cfg)
    ref = soft_object_ref or ("spheres", soft_sphere_index or 0)

    def init(scene: Scene):
        scene = params.map_leaves(
            lambda t: t.detach().to(torch.float32).clone().requires_grad_(True), scene)
        return scene, torch.optim.Adam(list(params.tree_leaves(scene)), lr=lr)

    def loss_fn(scene, seed, target):
        if impl == "kernel":
            vec = params.pack(scene, camera)
            if soft:
                return soft_image_loss_kernel(vec, scene, camera, cfg, seed, target, ref,
                                              edge_width, mesh)
            return image_loss_kernel(vec, scene, camera, cfg, seed, target, mesh)
        if soft:
            return soft_image_loss(scene, camera, cfg, seed, target, edge_width=edge_width,
                                   mesh=mesh, object_ref=ref)
        return image_loss(scene, camera, cfg, seed, target, mesh)

    def step(scene, optimizer, seed, target):
        optimizer.zero_grad(set_to_none=False)
        loss = loss_fn(scene, frame_seeds(seed, frames_per_step), target)
        loss.backward()
        leaves = list(params.tree_leaves(scene))
        for leaf in leaves:  # a leaf that only enters comparisons (refl_prob) has grad 0
            if leaf.grad is None:
                leaf.grad = torch.zeros_like(leaf)
        if mesh is not None and impl == "plain":
            loss, grads = _reduce(loss, [leaf.grad for leaf in leaves], mesh)
            for leaf, g in zip(leaves, grads):
                leaf.grad.copy_(g)
        if param_filter is not None:
            filtered = param_filter(params.map_leaves(lambda t: t.grad, scene))
            for leaf, g in zip(leaves, params.tree_leaves(filtered)):
                leaf.grad.copy_(g)
        grad_norm = torch.sqrt(sum(torch.sum(t.grad * t.grad) for t in leaves))
        optimizer.step()
        loss = loss.detach()
        return scene, optimizer, loss, {"loss": loss, "grad_norm": grad_norm}

    return step, init


class PackedScene(nn.Module):
    """The training state of the packed loop: the scene's slice of the
    packed vector as one parameter, the camera's as a buffer."""

    def __init__(self, scene_vec: torch.Tensor, cam_vec: torch.Tensor):
        super().__init__()
        self.scene_vec = nn.Parameter(scene_vec)
        self.register_buffer("cam_vec", cam_vec)

    def packed(self) -> torch.Tensor:
        return torch.cat([self.scene_vec, self.cam_vec])


def make_packed_train_step(cfg: RenderConfig, lr: float, camera: Camera, scene_template: Scene,
                           param_filter: Optional[Callable] = None, frames_per_step: int = 1):
    """The packed-space train loop (diff.py:988-1065): ``torch.optim.Adam``
    on the scene's packed vector, the loss through ``image_loss_kernel``
    (one K4 launch per step on the card). Returns ``(step, init, unpack)``:

    * ``init(scene) -> (model, optimizer)``: a ``PackedScene`` and Adam
      over its one parameter;
    * ``step(model, optimizer, seed, target) -> loss`` updates the model in
      place; a scalar seed, from which a minibatch step derives its
      ``frames_per_step`` frame seeds. Under a profiler it records the span
      ``train.step`` and inside it ``train.adam`` (the gradient's zeroing,
      then the mask and the update), ``k4.pack``, the launch's
      (gradkernel.loss_and_grad_cuda) and ``train.backward``
      (utils/profiling.py);
    * ``unpack(model or scene_vec) -> Scene``.

    ``param_filter`` (the make_train_step contract) becomes a packed 0/1
    vector that multiplies the gradient before the optimizer; so does the
    freeze_hints contract's mask (params.freeze_mask, gradkernel.py:1011-1017),
    which keeps the frozen slots bitwise constant under Adam. ``cfg``
    should come from ``with_frozen_hints``, the production configuration;
    its hints are derived here when it asks for the contract and has none.
    """
    cfg = gradkernel._auto_hints(scene_template, cfg)
    gradkernel.check_kernel_config(cfg)
    n = params.n_scene(scene_template)
    cam_vec = params.pack(scene_template, camera).detach()[n:]
    masks = [m for m in (None if param_filter is None else
                         params.leaf_mask(param_filter, scene_template),
                         params.freeze_mask(cfg, scene_template)) if m is not None]
    # On the template's device once: a copy a step would wait for the step's kernels.
    mask = None if not masks else torch.stack(masks).prod(0).to(cam_vec.device)

    def init(scene: Scene):
        vec = params.pack(scene, camera).detach()
        model = PackedScene(vec[:n].clone(), cam_vec.to(vec.device))
        return model, torch.optim.Adam(model.parameters(), lr=lr)

    def step(model: PackedScene, optimizer, seed, target):
        with profiling.span("train.step"):
            with profiling.span("train.adam"):
                optimizer.zero_grad(set_to_none=False)
            with profiling.span("k4.pack"):
                vec = model.packed()
            loss = image_loss_kernel(vec, scene_template, camera, cfg,
                                     frame_seeds(seed, frames_per_step), target)
            with profiling.span("train.backward"):
                loss.backward()
            with profiling.span("train.adam"):
                if mask is not None:
                    model.scene_vec.grad.mul_(mask.to(model.scene_vec.device))
                optimizer.step()
            return loss.detach()

    def unpack(state) -> Scene:
        vec = state.scene_vec if isinstance(state, PackedScene) else state
        full = torch.cat([vec.detach(), cam_vec.to(vec.device)])
        return params.unpack(full, scene_template, camera)[0]

    return step, init, unpack


def finite_difference_grad(f: Callable[[torch.Tensor], torch.Tensor], x0,
                           eps: float = 1e-3) -> torch.Tensor:
    """Central finite differences of a scalar ``f`` at ``x0``, element by
    element, in float32 (the JAX package's diff.py:1068-1080), for
    gradient tests."""
    x0 = torch.as_tensor(x0, dtype=torch.float32)
    flat = x0.reshape(-1)
    grads = []
    for i in range(flat.numel()):
        dx = torch.zeros_like(flat)
        dx[i] = eps
        fp = f((flat + dx).reshape(x0.shape))
        fm = f((flat - dx).reshape(x0.shape))
        grads.append((fp - fm) / (2 * eps))
    return torch.stack(grads).reshape(x0.shape)
