"""The canonical scenes of this slice, with the JAX package's numbers.

Counterpart of fourd_ray_tracing_tpu/models/library.py:26-69. The other
three scenes (hypercube, duocylinder, tiger) need the composite folds,
which are still to be ported (ROADMAP queue 1, item 4).
"""
from __future__ import annotations

import numpy as np

from fourd_ray_tracing_tpu_torch.models.scene import (
    Scene,
    environment,
    material,
    space,
    sphere,
    sun,
)

PI = float(np.pi)
NOT_PORTED = ("hypercube", "duocylinder", "tiger")


def sphere_plane_light(device) -> Scene:
    """Floor plane, mirror-ish sphere, glowing lamp sphere, soft sun."""
    return Scene(
        spaces=(
            space((0, 0, -1.5, 0), (0, 0, 1, 0), material(0, 0, (0.6, 0.4, 0.2), device), device),
        ),
        spheres=(
            sphere((-1, 1, 0, 0), 1.0, material(0, 0.7, (0.2, 1.0, 0.2), device), device),
            sphere((1, 1, 0, 0), 0.5, material(90, 0.0, (1, 1, 1), device), device),
        ),
        environment=environment(
            sun((0, 1, 1, 0), PI * 0.09, (10, 10, 0.95), 0.8, device),
            (0.02, 0.06, 0.12),
            device=device,
        ),
    )


def room_with_sphere(device) -> Scene:
    """Closed 4D box of 8 hyperplanes, a matte sphere and a glow-200 lamp
    sphere; the environment is disabled."""
    size = 3.5

    def wall(point, norm, color):
        return space(point, norm, material(0, 0, color, device), device)

    return Scene(
        spaces=(
            wall((size, 0, 0, 0), (1, 0, 0, 0), (0.44, 0.04, 0.67)),
            wall((-size, 0, 0, 0), (1, 0, 0, 0), (1.0, 1.0, 0.0)),
            wall((0, size, 0, 0), (0, 1, 0, 0), (1.0, 0.0, 0.0)),
            wall((0, -size, 0, 0), (0, 1, 0, 0), (0.0, 0.8, 0.0)),
            wall((0, 0, size, 0), (0, 0, 1, 0), (1.0, 1.0, 1.0)),
            wall((0, 0, -size, 0), (0, 0, 1, 0), (1.0, 1.0, 1.0)),
            wall((0, 0, 0, size), (0, 0, 0, 1), (1.0, 0.67, 0.0)),
            wall((0, 0, 0, -size), (0, 0, 0, 1), (0.07, 0.25, 0.67)),
        ),
        spheres=(
            sphere((0, 0, -size / 5, 0), 0.35 * size, material(0, 0, (1, 1, 1), device), device),
            sphere((0, 0, size, 0), 0.25 * size, material(200, 0, (1, 1, 1), device), device),
        ),
        environment=environment(
            sun((0, 1, 1, 0), PI * 0.09, (0, 0, 0), 0.0, device),
            (0, 0, 0),
            enabled=False,
            device=device,
        ),
    )


SCENES = {
    "sphere_plane_light": sphere_plane_light,
    "room_with_sphere": room_with_sphere,
}


def scene_by_name(name: str, device) -> Scene:
    """Build a library scene on ``device``; names still to be ported raise."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"scene {name!r} needs the composite primitives, which are not "
            f"ported yet (ROADMAP queue 1, item 4); ported scenes: {sorted(SCENES)}"
        )
    if name not in SCENES:
        raise KeyError(f"unknown scene {name!r}; ported scenes: {sorted(SCENES)}")
    return SCENES[name](device)
