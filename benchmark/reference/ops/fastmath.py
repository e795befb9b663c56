"""Polynomial inverse trigonometry and turn-fraction sin/cos.

Counterpart of fourd_ray_tracing_tpu/ops/fastmath.py:79-157 with the
same float32 coefficients and the same Horner order, so the sun profile
(ops/sky.py) and the S^3 sampler's azimuth (ops/sampler.py) agree with
the JAX package to float rounding instead of to two libm's differences.
The CUDA kernel (csrc/megakernel.cu) carries the same constants.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.ops.vec4 import sqrt

_HALF_PI = float(np.float32(np.pi / 2))
_PI = float(np.float32(np.pi))

# atan(t)/t as a polynomial in u = t^2, u in [0, 1].
_ATAN_COEFFS = tuple(
    float(np.float32(c))
    for c in (
        0.9999999981420136,
        -0.3333329279633544,
        0.19998532570283645,
        -0.1426489237473346,
        0.10958363839007743,
        -0.08427634966170072,
        0.05845791831595609,
        -0.0317506334697238,
        0.011257683716639311,
        -0.0018775736582807062,
    )
)

# sin(2*pi*x)/x and cos(2*pi*x) as polynomials in u = x^2, x in [-1/8, 1/8].
_SIN2PI_COEFFS = tuple(
    float(np.float32(c))
    for c in (
        6.2831853071e00,
        -4.1341702134e01,
        8.1605201758e01,
        -7.6697740910e01,
        4.1472862296e01,
    )
)
_COS2PI_COEFFS = tuple(
    float(np.float32(c))
    for c in (
        9.9999999990e-01,
        -1.9739208617e01,
        6.4939310978e01,
        -8.5442625666e01,
        5.9220223797e01,
    )
)


def _horner(u: torch.Tensor, coeffs) -> torch.Tensor:
    """Polynomial in u, highest coefficient first."""
    acc = torch.full_like(u, coeffs[-1])
    for c in coeffs[-2::-1]:
        acc = acc * u + c
    return acc


def _atan_unit(t: torch.Tensor) -> torch.Tensor:
    """atan(t) for t in [0, 1]."""
    return _horner(t * t, _ATAN_COEFFS) * t


def arctan(x: torch.Tensor) -> torch.Tensor:
    ax = torch.abs(x)
    big = ax > 1.0
    inv = 1.0 / torch.where(big, ax, 1.0)
    t = torch.where(big, inv, ax)
    core = _atan_unit(t)
    res = torch.where(big, _HALF_PI - core, core)
    return torch.where(x < 0.0, -res, res)


def arctan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    safe_x = torch.where(x == 0.0, 1.0, x)
    base = arctan(y / safe_x)
    return torch.where(
        x > 0.0,
        base,
        torch.where(
            x < 0.0,
            torch.where(y < 0.0, base - _PI, base + _PI),
            torch.where(y < 0.0, -_HALF_PI, _HALF_PI),
        ),
    )


def arccos(x: torch.Tensor) -> torch.Tensor:
    """acos(x) via atan2(sqrt((1-x)(1+x)), x); inputs clamp to [-1, 1]."""
    x = torch.clamp(x, -1.0, 1.0)
    s = sqrt(torch.clamp_min((1.0 - x) * (1.0 + x), 0.0))
    return arctan2(s, x)


def arcsin(x: torch.Tensor) -> torch.Tensor:
    """asin(x) = pi/2 - acos(x); inputs clamp to [-1, 1]."""
    return _HALF_PI - arccos(x)


def sincos_2pi(u: torch.Tensor):
    """(sin(2*pi*u), cos(2*pi*u)) for u in turns: one quadrant reduction
    (round half to even, like jnp.round) and two small polynomials."""
    n = torch.round(u * 4.0)
    x = u - n * 0.25
    u2 = x * x
    s0 = x * _horner(u2, _SIN2PI_COEFFS)
    c0 = _horner(u2, _COS2PI_COEFFS)
    q = n - 4.0 * torch.floor(n * 0.25)
    odd = (q == 1.0) | (q == 3.0)
    sin_base = torch.where(odd, c0, s0)
    cos_base = torch.where(odd, s0, c0)
    sin = torch.where(q >= 2.0, -sin_base, sin_base)
    cos = torch.where((q == 1.0) | (q == 2.0), -cos_base, cos_base)
    return sin, cos
