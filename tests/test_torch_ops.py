"""The PyTorch port's ops against the JAX package's, on the CPU.

Inputs come from numpy with a fixed seed and go through both. Integer
words (RNG) must match bitwise; float functions are held to float32
rounding (tolerances stated per test). XLA on the CPU contracts a*b+c
into fused multiply-adds and torch's eager ops do not, so where an
expression cancels or an inverse function is ill-conditioned, a one-ulp
difference of the reference grows; those tests say how far.
"""
import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourd_ray_tracing_tpu.ops import fastmath as jfast
from fourd_ray_tracing_tpu.ops import rng as jrng
from fourd_ray_tracing_tpu.ops import sampler as jsampler
from fourd_ray_tracing_tpu.ops import sky as jsky
from fourd_ray_tracing_tpu.models import library as jlib
from fourd_ray_tracing_tpu.ops.vec4 import Vec3 as JVec3, Vec4 as JVec4

from fourd_ray_tracing_tpu_torch.models import library as tlib
from fourd_ray_tracing_tpu_torch.ops import fastmath as tfast
from fourd_ray_tracing_tpu_torch.ops import rng as trng
from fourd_ray_tracing_tpu_torch.ops import sampler as tsampler
from fourd_ray_tracing_tpu_torch.ops import sky as tsky
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4 as TVec4

N = 100_000
CPU = torch.device("cpu")


def u32_words(rng, n=N):
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def t64(words):
    return torch.from_numpy(np.asarray(words, np.uint32).astype(np.int64))


def as_u32(t):
    return t.numpy().astype(np.uint32)


def test_hash_u32_bitwise(rng_np):
    x = u32_words(rng_np)
    np.testing.assert_array_equal(as_u32(trng.hash_u32(t64(x))), np.asarray(jrng.hash_u32(jnp.asarray(x))))


def test_pixel_stream_bits_bitwise(rng_np):
    sx = rng_np.random(N, dtype=np.float32)
    sy = rng_np.random(N, dtype=np.float32)
    ref = np.asarray(jrng.pixel_stream_bits(jnp.asarray(sx), jnp.asarray(sy)))
    out = trng.pixel_stream_bits(torch.from_numpy(sx), torch.from_numpy(sy))
    np.testing.assert_array_equal(as_u32(out), ref)


def test_uniform01_bitwise(rng_np):
    bits, seed, ctr = u32_words(rng_np), 0xDEADBEEF, u32_words(rng_np)
    v_ref, c_ref = jrng.uniform01(jnp.asarray(bits), jnp.uint32(seed), jnp.asarray(ctr))
    v, c = trng.uniform01(t64(bits), seed, t64(ctr))
    np.testing.assert_array_equal(v.numpy().view(np.uint32), np.asarray(v_ref).view(np.uint32))
    np.testing.assert_array_equal(as_u32(c), np.asarray(c_ref))


def test_masked_uniform01_sequences_bitwise(rng_np):
    """64 draws with random masks: values and per-lane counters bitwise."""
    n = 4096
    bits = u32_words(rng_np, n)
    seed = int(u32_words(rng_np, 1)[0])
    c_ref = jrng.init_counter(jnp.uint32(seed), (n,))
    c = trng.init_counter(seed, torch.zeros(n))
    for _ in range(64):
        mask = rng_np.random(n) < 0.6
        v_ref, c_ref = jrng.masked_uniform01(jnp.asarray(bits), jnp.uint32(seed), c_ref, jnp.asarray(mask))
        v, c = trng.masked_uniform01(t64(bits), seed, c, torch.from_numpy(mask))
        np.testing.assert_array_equal(v.numpy().view(np.uint32), np.asarray(v_ref).view(np.uint32))
        np.testing.assert_array_equal(as_u32(c), np.asarray(c_ref))


def test_cbrt_bit_trick_bitwise(rng_np):
    """The exponent-trick seed is integer work on the float's bits, and
    the Newton steps are plain float32 ops: bitwise on both sides."""
    a = (rng_np.random(N, dtype=np.float32) * 356.0).astype(np.float32)
    bits = np.asarray(jnp.asarray(a).view(jnp.uint32))
    np.testing.assert_array_equal(
        as_u32(tsampler._div3_u32(t64(bits))), np.asarray(jsampler._div3_u32(jnp.asarray(bits))))
    np.testing.assert_array_equal(
        tsampler._cbrt_sq_bits(torch.from_numpy(a)).numpy(), np.asarray(jsampler._cbrt_sq_bits(jnp.asarray(a))))


# float32 rounding floor: the outputs are O(1), one ulp is <= 1.2e-7 below
# 1 and 2.4e-7 up to 2, so 2e-7 allows a one-ulp difference in [0, 1].
ATOL_F32 = 2e-7


def test_w_by_volume_poly(rng_np):
    v = rng_np.random(N, dtype=np.float32)
    np.testing.assert_allclose(tsampler.w_by_volume_poly(torch.from_numpy(v)).numpy(),
                               np.asarray(jsampler.w_by_volume_poly(jnp.asarray(v))), rtol=0, atol=ATOL_F32)


def test_sincos_2pi(rng_np):
    u = rng_np.random(N, dtype=np.float32)
    s_ref, c_ref = jfast.sincos_2pi(jnp.asarray(u))
    s, c = tfast.sincos_2pi(torch.from_numpy(u))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=0, atol=ATOL_F32)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=0, atol=ATOL_F32)


def test_arccos(rng_np):
    """Held to 2 ulps: the reference's Horner steps are fused
    multiply-adds, the port's round twice."""
    x = (rng_np.random(N, dtype=np.float32) * 2.0 - 1.0).astype(np.float32)
    x[:4] = (-1.0, 1.0, 0.0, -0.0)
    np.testing.assert_array_max_ulp(tfast.arccos(torch.from_numpy(x)).numpy(),
                                    np.asarray(jfast.arccos(jnp.asarray(x))), maxulp=2)


def test_arcsin(rng_np):
    """pi/2 - arccos on both sides: within 2 ulps of pi (absolute; near
    0 the subtraction cancels, so the arccos ulps show unscaled), and
    within 1e-6 of float64 arcsin, as the JAX package's test holds its own."""
    x = (rng_np.random(N, dtype=np.float32) * 2.0 - 1.0).astype(np.float32)
    x[:5] = (-1.0, 1.0, 0.0, -0.0, 1.5)
    got = tfast.arcsin(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jfast.arcsin(jnp.asarray(x))), rtol=0,
                               atol=2 * np.spacing(np.float32(np.pi)))
    assert np.abs(got - np.arcsin(np.clip(x, -1.0, 1.0).astype(np.float64))).max() < 1e-6


def test_direction_from_uniforms_poly(rng_np):
    """99.9% of components within ATOL_F32 and all within 2e-6: rho =
    sqrt(r*r - z*z) cancels when |z| is close to r, where the reference's
    fused r*r - z*z differs from the port's by an ulp of r*r before the
    square root."""
    u = [rng_np.random(N, dtype=np.float32) for _ in range(3)]
    ref = jsampler.direction_from_uniforms(*map(jnp.asarray, u), method="poly")
    out = tsampler.direction_from_uniforms(*map(torch.from_numpy, u), method="poly")
    for a, b in zip(out, ref):
        diff = np.abs(a.numpy() - np.asarray(b))
        assert (diff <= ATOL_F32).mean() >= 0.999
        assert diff.max() <= 2e-6


@pytest.mark.parametrize("method", ["kepler", "newton"])
def test_unported_sampler_methods_raise(method):
    """The kepler and newton samplers render (tests/test_torch_sampler.py
    holds them against the JAX package), and the gradient kernels take them
    with per-sample streams (csrc/gradmodes.cu); the sequential stream they
    still refuse, with a ValueError as the JAX package does. K8 takes them
    too (csrc/ablatemodes.cu, with the modes launches' codes), and its
    plain version runs them."""
    from fourd_ray_tracing_tpu_torch import camera as tcam
    from fourd_ray_tracing_tpu_torch.models import library, params
    from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig
    from fourd_ray_tracing_tpu_torch.ops.cuda import ablate, gradkernel
    from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4

    u = torch.full((4,), 0.25)
    d = tsampler.direction_from_uniforms(u, u, u, method=method)
    norm = torch.sqrt(sum(c * c for c in d))
    assert torch.allclose(norm, torch.ones(4), atol=1e-5)
    cfg = RenderConfig(rng_mode="per_sample", sampler_method=method)
    gradkernel.check_kernel_config(cfg)
    with pytest.raises(ValueError, match="per-sample"):
        gradkernel.check_kernel_config(RenderConfig(rng_mode="sequential", sampler_method=method))
    cpu = torch.device("cpu")
    orient = tcam.orientation_from_angles(*tcam.CameraAngles.of(0.0, 0.0, 0.0, device=cpu), cpu)
    camera = tcam.make_camera(Vec4.of(0.0, -2.0, 0.0, 0.0, device=cpu), orient, 1.5, 2.0,
                              ("yxz",), cpu)
    scene = library.room_with_sphere(cpu)
    lay = params.layout(scene, camera)
    assert gradkernel._modes(cfg, lay) == (0, 1 if method == "kepler" else 2, cfg.sampler_iters)
    small = dataclasses.replace(cfg, width=8, height=4)
    assert torch.isfinite(ablate.variant_plain("acc", scene, camera, small, 1))
    with pytest.raises(ValueError):
        tsampler.direction_from_uniforms(u, u, u, method="bisection")


def _directions(rng_np, n=8192):
    """Random directions plus a cone of rays around the sun direction, so
    the disk's edge profile is sampled, not only the plain sky."""
    d = rng_np.normal(size=(4, n)).astype(np.float32)
    sun = np.array([0, 1, 1, 0], np.float32)[:, None]
    d[:, : n // 2] = sun + 0.3 * d[:, : n // 2]
    return d


def test_final_light_sphere_plane_light(rng_np):
    """99% of rays within 1e-6, all within 1e-4 relative: the angle to the
    sun is arccos of a dot product, and near the disk's center arccos
    multiplies the reference's fused-dot ulp by 1/sqrt(1 - cos^2)."""
    d = _directions(rng_np)
    env_ref = jlib.sphere_plane_light().environment
    env = tlib.sphere_plane_light(CPU).environment
    ref = jsky.final_light(env_ref, JVec4(*map(jnp.asarray, d)))
    out = tsky.final_light(env, TVec4(*map(torch.from_numpy, d)))
    for a, b in zip(out, ref):
        a, b = a.numpy(), np.asarray(b)
        assert (np.abs(a - b) <= 1e-6).mean() >= 0.99
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    # The cone hits the sun disk: the comparison covers the blended branch.
    assert (np.asarray(ref.x) > 0.02 + 1e-3).any()


def test_final_light_disabled_is_black():
    env = tlib.room_with_sphere(CPU).environment
    d = TVec4(*(torch.ones(5) for _ in range(4)))
    assert all((c == 0).all() for c in tsky.final_light(env, d))


def test_light_to_color(rng_np):
    light = (rng_np.random((64, 3), dtype=np.float32) * 20.0).astype(np.float32)
    ref = jsky.light_to_color(JVec3(*(jnp.asarray(light[:, k]) for k in range(3))), jnp.float32(0.7))
    out = tsky.light_to_color(torch.from_numpy(light), 0.7)
    np.testing.assert_allclose(out.numpy(), np.stack([np.asarray(c) for c in ref], -1), rtol=0, atol=1e-6)


def _cu_constants(name):
    src = (Path(tfast.__file__).resolve().parents[1] / "csrc" / "trace.cuh").read_text()
    body = re.search(rf"{name}\[\d+\] = \{{(.*?)\}};", src, re.S).group(1)
    return [float.fromhex(tok.strip().rstrip("f")) for tok in body.split(",")]


@pytest.mark.parametrize("name,ref", [
    ("kAtan", tfast._ATAN_COEFFS),
    ("kSin2Pi", tfast._SIN2PI_COEFFS),
    ("kCos2Pi", tfast._COS2PI_COEFFS),
    ("kWPoly", tsampler._W_POLY),
])
def test_kernel_coefficients_match_plain(name, ref):
    """The CUDA kernels' hex float tables (csrc/trace.cuh, shared by both
    kernels) equal the plain version's float32 coefficients (and hence the
    JAX package's) exactly."""
    assert _cu_constants(name) == list(ref)
