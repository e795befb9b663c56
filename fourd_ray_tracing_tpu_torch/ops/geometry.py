"""Materials and the SoA hit record.

Counterpart of Material, Intersection and miss_like in
fourd_ray_tracing_tpu/ops/geometry.py:62-118. The per-primitive
intersection math of the slice (hyperplanes and spheres) lives in the
fused fold, models/scene.py:intersect_scene_fast.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec3, Vec4, f32


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
