"""The five canonical scenes, with the JAX package's numbers.

Counterpart of fourd_ray_tracing_tpu/models/library.py. The forward and
every gradient path, hard and soft, take all five.
"""
from __future__ import annotations

import numpy as np

from benchmark.reference.models.scene import (
    Scene,
    cylinder,
    environment,
    material,
    space,
    sphere,
    sun,
)
from benchmark.reference.ops.geometry import make_hypercube, make_tiger
from benchmark.reference.ops.vec4 import Vec4

PI = float(np.pi)


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


def hypercube(device) -> Scene:
    """White floor and the 8-cell hypercube, one material a cell, bright
    sun."""
    colors = ((0.72, 0.07, 0.20), (0.00, 0.61, 0.28), (1.00, 0.84, 0.00), (0.40, 0.00, 0.80),
              (1.00, 0.35, 0.00), (0.00, 0.27, 0.68), (1.00, 1.00, 1.00), (0.01, 0.01, 0.01))
    mats = tuple(material(0, 0, c, device) for c in colors)
    return Scene(
        spaces=(
            space((0, 0, -1.5, 0), (0, 0, 1, 0), material(0, 0, (1, 1, 1), device), device),
        ),
        hypercube=make_hypercube(
            Vec4.of(0, 2, 0, 0, device=device),
            Vec4.of(1, 0, 0, 0, device=device),
            Vec4.of(0, 1, 0, 0, device=device),
            Vec4.of(0, 0, 1, 0, device=device),
            Vec4.of(0, 0, 0, 1, device=device),
            1.0,
            mats,
        ),
        environment=environment(
            sun((0, 1, 1, 0), PI * 0.09, (2100, 1000, 20), 0.0, device),
            (0.4, 0.6, 1.53),
            device=device,
        ),
    )


def duocylinder(device) -> Scene:
    """Floor and the duocylinder (two axis-swapped infinite cylinders)."""
    return Scene(
        spaces=(
            space((0, 0, -1.5, 0), (0, 0, 1, 0), material(0, 0, (0.4, 0.25, 0.07), device),
                  device),
        ),
        cylinders_union=(
            cylinder((0, 2, 0, 0), (1, 0, 0, 0), (0, 0, 0, 1), 1.0,
                     material(0, 0, (1.0, 0.0, 0.0), device), device),
            cylinder((0, 2, 0, 0), (0, 0, 1, 0), (0, 1, 0, 0), 1.0,
                     material(0, 0, (0.07, 0.67, 0.25), device), device),
        ),
        environment=environment(
            sun((0, 1, 1, 0), PI * 0.09, (500, 500, 10), 0.0, device),
            (0.2, 0.6, 1.2),
            device=device,
        ),
    )


def tiger(device) -> Scene:
    """Floor and the 4D tiger (the annulus of two cylinder families); the
    reference shader's built-in default scene."""
    return Scene(
        spaces=(
            space((0, 0, -1.5, 0), (0, 0, 1, 0), material(0, 0, (0.4, 0.25, 0.07), device),
                  device),
        ),
        tiger=make_tiger(
            Vec4.of(0, 2, 0, 0, device=device),
            Vec4.of(1, 0, 0, 0, device=device),
            Vec4.of(0, 0, 0, 1, device=device),
            Vec4.of(0, 0, 1, 0, device=device),
            Vec4.of(0, 1, 0, 0, device=device),
            0.9,
            1.4,
            material(0, 0, (1.0, 0.0, 0.0), device),
            material(0, 0, (0.07, 0.67, 0.25), device),
        ),
        environment=environment(
            sun((0, 1, 1, 0), PI * 0.09, (500, 500, 10), 0.0, device),
            (0.2, 0.6, 1.2),
            device=device,
        ),
    )


SCENES = {
    "sphere_plane_light": sphere_plane_light,
    "room_with_sphere": room_with_sphere,
    "hypercube": hypercube,
    "duocylinder": duocylinder,
    "tiger": tiger,
}


def scene_by_name(name: str, device) -> Scene:
    """Build a library scene on ``device``."""
    if name not in SCENES:
        raise KeyError(f"unknown scene {name!r}; scenes: {sorted(SCENES)}")
    return SCENES[name](device)
