"""The flat parameter vector the forward kernel reads.

Counterpart of megakernel._pack_pytree (ops/pallas/megakernel.py:84-109):
the leaves of (scene, camera) concatenate in jax ``tree_flatten`` order
(NamedTuple fields in order, None and empty tuples contribute nothing,
the static ``Environment.enabled`` flag is not a leaf), so the vector is
bitwise the JAX package's. ``Layout`` is the static offset table of that
vector that the kernels are launched with. ``unpack`` is the differentiable
way back (the counterpart of _pack_pytree's ``rebuild`` and of
gradkernel.make_packed_loss_and_grad's ``unpack``): training keeps its state
in the packed vector and autograd flows from the rebuilt scene into it.
"""
from __future__ import annotations

from typing import Iterator, List, NamedTuple

import numpy as np
import torch

from benchmark.reference.camera import Camera
from benchmark.reference.models.scene import (COMPOSITE_KINDS, Scene, cells_only,
                                                       freeze_hint_grads)
from benchmark.reference.ops.sky import Environment

# Floats per packed primitive: point(4) norm(4) glow refl color(3), and
# center(4) r glow refl color(3); a cylinder point(4) axis1(4) axis2(4) r
# glow refl color(3); the duocylinder two cylinders, the tiger four; the
# hypercube 8 cells of space_point(4) space_norm(4) x(4) y(4) z(4) r glow
# refl color(3), then its point(4), axes(16) and r (a hypercube built from
# its cells alone packs the cells only, as the JAX package's _pack_pytree
# packs the leaves that exist). The environment is sun drct(4),
# angular_size, light(3), sharpness, sky_light(3).
SPACE_FLOATS = 13
SPHERE_FLOATS = 10
CYLINDER_FLOATS = 18
CUBE_FLOATS = 26
HYPERCUBE_FLOATS = 8 * CUBE_FLOATS + 4 + 16 + 1
TIGER_FLOATS = 4 * CYLINDER_FLOATS
ENV_FLOATS = 12


def tree_leaves(tree) -> Iterator[torch.Tensor]:
    """The tensor leaves of a parameter tree, in jax tree_flatten order."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield tree
        return
    if isinstance(tree, Environment):
        yield from tree_leaves(tree.sun)
        yield from tree_leaves(tree.sky_light)
        return
    if isinstance(tree, tuple):
        for child in tree:
            yield from tree_leaves(child)
        return
    raise TypeError(f"unexpected parameter node {type(tree).__name__}")


def leaves(scene: Scene, camera: Camera) -> List[torch.Tensor]:
    """The tensors of (scene, camera) in jax tree_flatten order."""
    return list(tree_leaves((scene, camera)))


def pack(scene: Scene, camera: Camera) -> torch.Tensor:
    """(P,) float32: every leaf flattened, in tree_flatten order."""
    return torch.cat([t.to(torch.float32).reshape(-1) for t in leaves(scene, camera)])


def map_leaves(fn, tree):
    """``tree`` with every tensor leaf replaced by ``fn(leaf)``, in
    tree_flatten order (the counterpart of jax.tree_util.tree_map)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, Environment):
        return Environment(map_leaves(fn, tree.sun), map_leaves(fn, tree.sky_light), tree.enabled)
    if isinstance(tree, tuple):
        children = [map_leaves(fn, c) for c in tree]
        return type(tree)(*children) if hasattr(tree, "_fields") else tuple(children)
    raise TypeError(f"unexpected parameter node {type(tree).__name__}")


def from_numpy_leaves(np_leaves, like_scene: Scene, like_camera: Camera, device=None):
    """(Scene, Camera) shaped like the given ones, holding ``np_leaves``
    (tree_flatten order, e.g. the JAX package's parameters as numpy
    arrays). ``device`` defaults to the device of ``like_scene``."""
    if device is None:
        device = leaves(like_scene, like_camera)[0].device
    it = iter(np_leaves)

    def take(_like):
        arr = np.asarray(next(it), np.float32)
        return torch.tensor(arr, dtype=torch.float32, device=device)

    scene = map_leaves(take, like_scene)
    camera = map_leaves(take, like_camera)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return scene, camera


def unpack(vec: torch.Tensor, like_scene: Scene, like_camera: Camera):
    """(Scene, Camera) shaped like the given ones whose leaves are views of
    the (P,) vector ``vec``, so autograd flows from them back into it;
    ``pack(*unpack(v, ...))`` equals ``v`` bitwise."""
    size = sum(t.numel() for t in leaves(like_scene, like_camera))
    if vec.dim() != 1 or vec.numel() != size:
        raise ValueError(f"expected a ({size},) vector of floats, got {tuple(vec.shape)}")
    offset = 0

    def take(like):
        nonlocal offset
        n = like.numel()
        part = vec[offset:offset + n].reshape(like.shape)
        offset += n
        return part

    return map_leaves(take, like_scene), map_leaves(take, like_camera)


def n_scene(scene: Scene) -> int:
    """Floats of the scene's leaves: the scene/camera split point of the
    packed vector (gradkernel.py:1006-1008)."""
    return sum(t.numel() for t in tree_leaves(scene))


def leaf_mask(filter_fn, like_scene: Scene) -> torch.Tensor:
    """The (n_scene,) float32 0/1 vector that a gradient filter becomes in
    packed space: ``filter_fn`` (a Scene -> Scene map that zeroes the
    gradients of frozen parameters) applied to an all-ones scene, packed
    (diff.py:1035-1044)."""
    ones = map_leaves(lambda t: torch.ones_like(t, dtype=torch.float32, device="cpu"),
                      like_scene)
    return torch.cat([t.to(torch.float32).reshape(-1) for t in tree_leaves(filter_fn(ones))])


def freezes(cfg) -> bool:
    """Whether ``cfg`` (a RenderConfig) freezes any gradient: the
    freeze_hints contract with static hints to freeze by."""
    return cfg.freeze_hints and (cfg.plane_hints is not None or cfg.axis_hints is not None)


# The freeze_hints contract's masks, made on first use: one entry per scene
# structure, hints and form (freeze_mask's vectors, frozen_leaves' flags).
_FREEZE_MASKS = {}


def _frozen_memo(cfg, like_scene: Scene, form, make):
    hc = like_scene.hypercube
    structure = (len(like_scene.spaces), len(like_scene.spheres), len(like_scene.cylinders),
                 like_scene.cylinders_union is not None,
                 None if hc is None else hc.point is not None, like_scene.tiger is not None,
                 like_scene.environment is not None)
    key = (structure, cfg.plane_hints, cfg.axis_hints, form)
    if key not in _FREEZE_MASKS:
        _FREEZE_MASKS[key] = make()
    return _FREEZE_MASKS[key]


def freeze_mask(cfg, like_scene: Scene, size: int | None = None, device="cpu"):
    """The float32 0/1 vector of the freeze_hints contract on ``device``:
    0 on the slots ``scene.freeze_hint_grads`` zeroes under ``cfg``'s
    hints, the packed all-ones scene it leaves (gradkernel.py:1011-1017);
    (n_scene,), or padded with 1s to ``size`` slots (the camera's, for a
    launch over the packed (P,) vector). None when ``cfg`` freezes
    nothing. Made once per scene structure, hints, size and device, so a
    training loop builds and copies it once (callers must not write to
    it)."""
    if not freezes(cfg):
        return None
    if size is None and str(device) == "cpu":
        return _frozen_memo(cfg, like_scene, None, lambda: leaf_mask(
            lambda g: freeze_hint_grads(g, cfg.plane_hints, cfg.axis_hints), like_scene))

    def make():
        base = freeze_mask(cfg, like_scene)
        pad = torch.ones((base.numel() if size is None else size) - base.numel())
        return torch.cat([base, pad]).to(device)

    return _frozen_memo(cfg, like_scene, (size, str(device)), make)


def frozen_leaves(cfg, like_scene: Scene):
    """Per leaf of ``like_scene`` (tree_leaves order), whether the
    freeze_hints contract freezes a slot of it (each frozen leaf freezes
    whole); None when ``cfg`` freezes nothing. Made once per scene
    structure and hints, beside freeze_mask."""
    if not freezes(cfg):
        return None

    def make():
        mask = freeze_mask(cfg, like_scene).numpy()
        sizes = [t.numel() for t in tree_leaves(like_scene)]
        return tuple(bool(f) for f in np.minimum.reduceat(mask, np.cumsum([0] + sizes[:-1])) == 0)

    return _frozen_memo(cfg, like_scene, "leaves", make)


# The fields of Layout that the kernels' struct Layout holds (csrc/trace.cuh
# kLayoutInts); the composite primitives' fields follow them.
KERNEL_LAYOUT_INTS = 14


class Layout(NamedTuple):
    """Offsets into the packed vector, as the kernels read them. A camera
    ``top``/``right`` component c of view v sits at top + c*n_views + v.
    The first KERNEL_LAYOUT_INTS fields are the kernels' Layout; the
    composite primitives' count and offsets follow (-1 when the scene has
    none), which the forward kernel takes in its hints descriptor, and
    whether the hypercube is one without generators (its 8 cells only)."""

    n_spaces: int
    n_spheres: int
    n_views: int
    env_enabled: int
    spaces: int
    spheres: int
    env: int
    focus: int
    vec_to_mtr: int
    top: int
    right: int
    mtr_width: int
    mtr_height: int
    size: int
    n_cylinders: int = 0
    cylinders: int = -1
    cylinders_union: int = -1
    hypercube: int = -1
    tiger: int = -1
    hypercube_cells: int = 0

    def composite_kinds(self) -> tuple:
        """The composite primitives' fields the scene holds (as
        Scene.composite_kinds)."""
        present = (self.n_cylinders > 0, self.cylinders_union >= 0, self.hypercube >= 0,
                   self.tiger >= 0)
        return tuple(k for k, p in zip(COMPOSITE_KINDS, present) if p)


def layout(scene: Scene, camera: Camera) -> Layout:
    """The static offset table of pack(scene, camera)."""
    n_views = camera.top.x.numel()
    if camera.top.x.dim() > 1 or camera.right.x.numel() != n_views:
        raise ValueError("camera top/right must be scalars or share one (V,) view axis")
    env = scene.environment
    spheres = SPACE_FLOATS * len(scene.spaces)
    offset = spheres + SPHERE_FLOATS * len(scene.spheres)
    composite = {}
    for name, floats, present in (
            ("cylinders", CYLINDER_FLOATS * len(scene.cylinders), bool(scene.cylinders)),
            ("cylinders_union", 2 * CYLINDER_FLOATS, scene.cylinders_union is not None),
            ("hypercube", 8 * CUBE_FLOATS if cells_only(scene) else HYPERCUBE_FLOATS,
             scene.hypercube is not None),
            ("tiger", TIGER_FLOATS, scene.tiger is not None)):
        composite[name] = offset if present else -1
        offset += floats if present else 0
    env_off = offset
    focus = env_off + (ENV_FLOATS if env is not None else 0)
    top = focus + 8
    right = top + 4 * n_views
    mtr_width = right + 4 * n_views
    out = Layout(
        n_spaces=len(scene.spaces), n_spheres=len(scene.spheres), n_views=n_views,
        env_enabled=int(env is not None and env.enabled),
        spaces=0, spheres=spheres, env=env_off, focus=focus, vec_to_mtr=focus + 4,
        top=top, right=right, mtr_width=mtr_width, mtr_height=mtr_width + 1,
        size=mtr_width + 2, n_cylinders=len(scene.cylinders), **composite,
        hypercube_cells=int(cells_only(scene)),
    )
    sizes = [t.numel() for t in leaves(scene, camera)]
    if sum(sizes) != out.size:
        raise ValueError(f"scene/camera leaves hold {sum(sizes)} floats, layout expects {out.size}")
    return out
