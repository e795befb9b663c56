"""Sky / sun environment light and tone mapping.

Counterpart of fourd_ray_tracing_tpu/ops/sky.py:21-86: a sun disk with a
nonlinear edge profile over a constant sky, and the Reinhard-style
light -> color map. ``Environment.enabled`` is a static Python bool, as
in the JAX package: a disabled environment (the room) contributes
nothing and is skipped, not multiplied by zero.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.ops.fastmath import arccos
from benchmark.reference.ops.vec4 import Vec3, Vec4, dot, length

_PI = float(np.float32(np.pi))


class Sun(NamedTuple):
    drct: Vec4                # direction toward the sun (not necessarily unit)
    angular_size: torch.Tensor
    light: Vec3               # emitted light
    sharpness: torch.Tensor   # 1 = hard disk, -> 0 = blurred


class Environment(NamedTuple):
    sun: Sun
    sky_light: Vec3
    enabled: bool = True      # static: never a tensor, never packed


def final_light(env: Environment | None, ray_d: Vec4) -> Vec3:
    """Light for a ray escaping to infinity."""
    if env is None or not env.enabled:
        return Vec3.full(0.0, like=ray_d.x)
    cos_dev = dot(ray_d, env.sun.drct) / (length(ray_d) * length(env.sun.drct))
    cos_dev = torch.clamp(cos_dev, -1.0, 1.0)
    interior = torch.abs(cos_dev) < 1.0
    dev_safe = arccos(torch.where(interior, cos_dev, 0.0))
    deviation = torch.where(
        interior, dev_safe,
        torch.where(cos_dev > 0.0, 0.0, _PI).to(torch.float32),
    )
    in_sun = deviation < env.sun.angular_size
    k = deviation / env.sun.angular_size
    s = env.sun.sharpness
    denom = 1.0 - s * k
    k = (s * s * k / torch.where(torch.abs(denom) < 1e-12, 1e-12, denom) + 1.0) * (1.0 - k)
    blended = env.sun.light * k + env.sky_light * (1.0 - k)
    sky = Vec3(*(c.expand_as(ray_d.x) for c in env.sky_light))
    return blended.where(in_sun, sky)


def light_to_color(light: torch.Tensor, coefficient: float) -> torch.Tensor:
    """Tone map 1 - 1/(c*l + 1), elementwise on a (..., 3) light tensor."""
    c = float(np.float32(coefficient))
    return 1.0 - 1.0 / (c * light + 1.0)
