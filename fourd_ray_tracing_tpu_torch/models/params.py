"""The flat parameter vector the forward kernel reads.

Counterpart of megakernel._pack_pytree (ops/pallas/megakernel.py:84-109):
the leaves of (scene, camera) concatenate in jax ``tree_flatten`` order
(NamedTuple fields in order, None and empty tuples contribute nothing,
the static ``Environment.enabled`` flag is not a leaf), so the vector is
bitwise the JAX package's. ``Layout`` is the static offset table of that
vector that the kernel is launched with.
"""
from __future__ import annotations

from typing import Iterator, List, NamedTuple

import numpy as np
import torch

from fourd_ray_tracing_tpu_torch.camera import Camera
from fourd_ray_tracing_tpu_torch.models.scene import Scene, check_supported
from fourd_ray_tracing_tpu_torch.ops.sky import Environment

# Floats per packed primitive: point(4) norm(4) glow refl color(3), and
# center(4) r glow refl color(3). The environment is sun drct(4),
# angular_size, light(3), sharpness, sky_light(3).
SPACE_FLOATS = 13
SPHERE_FLOATS = 10
ENV_FLOATS = 12


def _leaves(tree) -> Iterator[torch.Tensor]:
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield tree
        return
    if isinstance(tree, Environment):
        yield from _leaves(tree.sun)
        yield from _leaves(tree.sky_light)
        return
    if isinstance(tree, tuple):
        for child in tree:
            yield from _leaves(child)
        return
    raise TypeError(f"unexpected parameter node {type(tree).__name__}")


def leaves(scene: Scene, camera: Camera) -> List[torch.Tensor]:
    """The tensors of (scene, camera) in jax tree_flatten order."""
    return list(_leaves((scene, camera)))


def pack(scene: Scene, camera: Camera) -> torch.Tensor:
    """(P,) float32: every leaf flattened, in tree_flatten order."""
    return torch.cat([t.to(torch.float32).reshape(-1) for t in leaves(scene, camera)])


def _rebuild(like, it, device):
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        arr = np.asarray(next(it), np.float32)
        return torch.tensor(arr, dtype=torch.float32, device=device)
    if isinstance(like, Environment):
        return Environment(_rebuild(like.sun, it, device),
                           _rebuild(like.sky_light, it, device), like.enabled)
    if isinstance(like, tuple):
        children = [_rebuild(c, it, device) for c in like]
        return type(like)(*children) if hasattr(like, "_fields") else tuple(children)
    raise TypeError(f"unexpected parameter node {type(like).__name__}")


def from_numpy_leaves(np_leaves, like_scene: Scene, like_camera: Camera, device=None):
    """(Scene, Camera) shaped like the given ones, holding ``np_leaves``
    (tree_flatten order, e.g. the JAX package's parameters as numpy
    arrays). ``device`` defaults to the device of ``like_scene``."""
    if device is None:
        device = leaves(like_scene, like_camera)[0].device
    it = iter(np_leaves)
    scene = _rebuild(like_scene, it, device)
    camera = _rebuild(like_camera, it, device)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return scene, camera


class Layout(NamedTuple):
    """Offsets into the packed vector, as the kernel reads them. A camera
    ``top``/``right`` component c of view v sits at top + c*n_views + v."""

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


def layout(scene: Scene, camera: Camera) -> Layout:
    """The static offset table of pack(scene, camera)."""
    check_supported(scene)
    n_views = camera.top.x.numel()
    if camera.top.x.dim() > 1 or camera.right.x.numel() != n_views:
        raise ValueError("camera top/right must be scalars or share one (V,) view axis")
    env = scene.environment
    spheres = SPACE_FLOATS * len(scene.spaces)
    env_off = spheres + SPHERE_FLOATS * len(scene.spheres)
    focus = env_off + (ENV_FLOATS if env is not None else 0)
    top = focus + 8
    right = top + 4 * n_views
    mtr_width = right + 4 * n_views
    out = Layout(
        n_spaces=len(scene.spaces), n_spheres=len(scene.spheres), n_views=n_views,
        env_enabled=int(env is not None and env.enabled),
        spaces=0, spheres=spheres, env=env_off, focus=focus, vec_to_mtr=focus + 4,
        top=top, right=right, mtr_width=mtr_width, mtr_height=mtr_width + 1,
        size=mtr_width + 2,
    )
    sizes = [t.numel() for t in leaves(scene, camera)]
    if sum(sizes) != out.size:
        raise ValueError(f"scene/camera leaves hold {sum(sizes)} floats, layout expects {out.size}")
    return out
