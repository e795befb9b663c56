"""Uniform direction sampling on the unit 3-sphere S^3 in R^4.

Counterpart of fourd_ray_tracing_tpu/ops/sampler.py, "poly" method only
(sampler.py:139-244): w comes from a fixed-op polynomial inverse of the
w-marginal CDF, seeded by an exponent bit trick for a^(2/3); the 3D rest
is placed on its 2-sphere by the hat-box trick. The "kepler" and
"newton" methods are still to be ported (ROADMAP queue 1, item 2) and
raise.
"""
from __future__ import annotations

import numpy as np
import torch

from fourd_ray_tracing_tpu_torch.ops import rng
from fourd_ray_tracing_tpu_torch.ops.fastmath import sincos_2pi
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4, sqrt

PI = float(np.float32(3.14159265))
TWO_PI = float(np.float32(2.0) * np.float32(PI))
# "Small value, about 2^-12" (the reference shader's SMALL_FLOAT).
SMALL_FLOAT = float(np.float32(0.0003))

_W_POLY = tuple(
    float(np.float32(c))
    for c in (
        9.99999681e-01,
        -1.24997268e-01,
        -1.56926491e-03,
        -5.38844444e-05,
        -7.60478346e-06,
        1.29518987e-06,
        -3.00660743e-07,
        2.97591143e-08,
        -1.48590700e-09,
    )
)
_CBRT_MAGIC = 0x548FE000
_THIRD = float(np.float32(1.0 / 3.0))


def _div3_u32(i: torch.Tensor) -> torch.Tensor:
    """Approximate unsigned i/3 with logical shifts and adds:
    i/4 * sum_k 4^-k over 8 terms."""
    acc = i >> 2
    t = acc
    for _ in range(7):
        t = t >> 2
        acc = acc + t
    return acc


def _cbrt_sq_bits(a: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """a^(2/3) for a >= 0: bit-trick seed for a^(-1/3), then
    division-free Newton z' = z*(4 - a*z^3)/3, then a*z*z."""
    a = torch.clamp_min(a, 1e-30)
    z = rng.bits_to_float((_CBRT_MAGIC - _div3_u32(rng.float_bits(a))) & rng.MASK32)
    for _ in range(iters):
        z = z * (4.0 - a * z * z * z) * _THIRD
    return a * z * z


def w_by_volume_poly(v: torch.Tensor, cbrt_iters: int = 3) -> torch.Tensor:
    """Fixed-op polynomial inverse of the w-marginal CDF."""
    c = TWO_PI * (1.0 - v)
    mirrored = c > PI
    c_half = torch.where(mirrored, TWO_PI - c, c)
    u = _cbrt_sq_bits(36.0 * c_half * c_half, iters=cbrt_iters)
    acc = torch.full_like(u, _W_POLY[-1])
    for coef in _W_POLY[-2::-1]:
        acc = acc * u + coef
    return torch.where(mirrored, -acc, acc)


def direction_from_uniforms(u_w, u_z, u_fi, *, method: str = "poly") -> Vec4:
    """Three uniforms in [0, 1) -> a uniform direction on S^3."""
    if method in ("kepler", "newton"):
        raise NotImplementedError(
            f"sampler method {method!r} is not ported yet (ROADMAP queue 1, "
            "item 2); use 'poly'"
        )
    if method != "poly":
        raise ValueError(f"unknown method {method!r}")
    w = w_by_volume_poly(u_w)
    r = sqrt(torch.clamp_min(1.0 - w * w, 0.0))
    z = (u_z * 2.0 - 1.0) * r
    rho = sqrt(torch.clamp_min(r * r - z * z, 0.0))
    sin_fi, cos_fi = sincos_2pi(u_fi)
    return Vec4(rho * cos_fi, rho * sin_fi, z, w)
