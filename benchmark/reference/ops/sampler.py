"""Uniform direction sampling on the unit 3-sphere S^3 in R^4.

Counterpart of fourd_ray_tracing_tpu/ops/sampler.py: w comes from an
inverse of the w-marginal CDF ``volume_by_w``, by one of three methods:
"poly", a fixed-op polynomial seeded by an exponent bit trick for a^(2/3)
(the production mode); "kepler", Halley iterations on Kepler's equation
x - sin(x) = 2 pi (1 - v) with w = cos(x/2); "newton", the reference
shader's finite-difference Newton do-while, per lane (the oracle's mode).
The 3D rest is placed on its 2-sphere by the hat-box trick.

Divisions by a constant divide by a 0-d tensor on the operand's device
(``_div``, ``_rdiv``): torch turns ``x / c`` on CUDA into a multiply by
the reciprocal, and ``c / x`` everywhere into ``reciprocal(x) * c``, which
round differently from the kernels' and the JAX package's division.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.ops import rng
from benchmark.reference.ops.fastmath import sincos_2pi
from benchmark.reference.ops.vec4 import Vec4, sqrt

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


def _const(c: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(c, dtype=torch.float32, device=like.device)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c, a true float32 division on every device."""
    return x / _const(c, x)


def _rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """c / x, a true float32 division on every device."""
    return _const(c, x) / x


def volume_by_w(w: torch.Tensor) -> torch.Tensor:
    """CDF of the w-marginal of the uniform S^3 distribution
    (sampler.py:46-49)."""
    return _div(w * sqrt(1.0 - w * w) - torch.acos(w), PI) + 1.0


def w_by_volume_newton(v: torch.Tensor, max_iters: int = 64) -> torch.Tensor:
    """The reference's inverse of volume_by_w (sampler.py:52-86): Newton
    from w = 0 with the one-sided finite difference of step SMALL_FLOAT,
    per lane a do-while that stops at that lane's first |dw| < SMALL_FLOAT
    (the step that gets there is taken) and after ``max_iters`` steps at
    most. Each step computes the lanes still going alone, so a count of
    its operations (utils/flops.py) is the work this data needs, lane by
    lane, as the kernel's per-lane loop does it."""
    flat = v.reshape(-1)
    w = torch.zeros_like(flat)
    going = torch.arange(flat.numel(), device=v.device)
    for _ in range(max_iters):
        if going.numel() == 0:
            break
        wa, va = w[going], flat[going]
        old_v = volume_by_w(wa)
        df = torch.where(wa > 0.0, old_v - volume_by_w(wa - SMALL_FLOAT),
                         volume_by_w(wa + SMALL_FLOAT) - old_v)
        new_w = wa - _rdiv(SMALL_FLOAT, df) * (old_v - va)
        w[going] = new_w
        going = going[torch.abs(new_w - wa) >= SMALL_FLOAT]
    return w.reshape(v.shape)


def _cbrt_nonneg(x: torch.Tensor) -> torch.Tensor:
    """cbrt for x >= 0 as exp(log(x) / 3), 0 at x = 0 (sampler.py:89-94)."""
    pos = x > 0.0
    safe = torch.exp(torch.log(torch.where(pos, x, 1.0)) * _THIRD)
    return torch.where(pos, safe, 0.0)


def _solve_kepler_half(c: torch.Tensor, iters: int) -> torch.Tensor:
    """x - sin(x) = c for c in [0, pi]: the cube-root seed, then ``iters``
    Halley steps (sampler.py:97-110)."""
    x = _cbrt_nonneg(6.0 * c)
    for _ in range(iters):
        s = torch.sin(x)
        co = torch.cos(x)
        f = x - s - c
        fp = 1.0 - co
        denom = 2.0 * fp * fp - f * s
        x = x - 2.0 * f * fp / torch.where(torch.abs(denom) < 1e-30, 1e-30, denom)
    return x


def w_by_volume_kepler(v: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """The inverse of volume_by_w through Kepler's equation, solved on the
    half range [0, pi] and mirrored (sampler.py:182-203)."""
    c = TWO_PI * (1.0 - v)
    mirrored = c > PI
    c_half = torch.where(mirrored, TWO_PI - c, c)
    x = _solve_kepler_half(c_half, iters)
    x = torch.where(mirrored, TWO_PI - x, x)
    return torch.cos(0.5 * x)


SAMPLER_METHODS = ("poly", "kepler", "newton")


def direction_from_uniforms(u_w, u_z, u_fi, *, method: str = "poly", kepler_iters: int = 2) -> Vec4:
    """Three uniforms in [0, 1) -> a uniform direction on S^3
    (sampler.py:206-244). Newton, the oracle's mode, takes the exact sin
    and cos of fi = u_fi * 2 pi; the others sincos_2pi of the turn."""
    if method == "newton":
        w = w_by_volume_newton(u_w)
    elif method == "kepler":
        w = w_by_volume_kepler(u_w, iters=kepler_iters)
    elif method == "poly":
        w = w_by_volume_poly(u_w)
    else:
        raise ValueError(f"unknown method {method!r}")
    r = sqrt(torch.clamp_min(1.0 - w * w, 0.0))
    z = (u_z * 2.0 - 1.0) * r
    rho = sqrt(torch.clamp_min(r * r - z * z, 0.0))
    if method == "newton":
        fi = u_fi * TWO_PI
        sin_fi, cos_fi = torch.sin(fi), torch.cos(fi)
    else:
        sin_fi, cos_fi = sincos_2pi(u_fi)
    return Vec4(rho * cos_fi, rho * sin_fi, z, w)
