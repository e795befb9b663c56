"""The port's flop counter (utils/flops.py) against its convention and
against the JAX package's counts of the same work on the CPU.

The counter runs over the plain versions, which are dense, so it counts
the lanes of rays that left the scene too. The JAX counts walk the jaxpr
(gradkernel._count_jaxpr_flops; kernel_flops_per_ray for K4's fused
form). Both take XLA's useful-flops convention, so they agree within 1%
(the port's plain pipeline and the JAX package's differ in a few
operations, such as where bounce 0's constants are computed).

    python tests/test_torch_flops.py   # prints both counts per ray
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from fourd_ray_tracing_tpu import camera as jcam
from fourd_ray_tracing_tpu.models import library as jlib
from fourd_ray_tracing_tpu.models import renderer as jrenderer
from fourd_ray_tracing_tpu.ops.pallas import gradkernel as jgrad
from fourd_ray_tracing_tpu.ops.vec4 import Vec4 as JVec4

from fourd_ray_tracing_tpu_torch import camera as tcam
from fourd_ray_tracing_tpu_torch.models import library as tlib
from fourd_ray_tracing_tpu_torch.models import params
from fourd_ray_tracing_tpu_torch.models import renderer as trenderer
from fourd_ray_tracing_tpu_torch.ops.cuda import gradkernel
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4 as TVec4
from fourd_ray_tracing_tpu_torch.utils.flops import FlopCounter, count_flops

CPU = torch.device("cpu")
# The training cell's shape (chip_smoke.py TRAIN); the port counts 2 rows.
SHAPE = dict(width=1280, height=720, samples=8, reflections_amount=4, rng_mode="per_sample",
             light_coefficient=0.12)
ROWS = 2


def test_counter_convention():
    a, b = torch.rand(10), torch.rand(10)
    assert count_flops(lambda: a * b + a)[1] == 20
    assert count_flops(lambda: torch.where(a > b, a, b))[1] == 0
    assert count_flops(lambda: a.sum())[1] == 10
    assert count_flops(lambda: torch.maximum(a, b).clamp_min(0.5).sqrt())[1] == 30
    ints = torch.arange(10)
    assert count_flops(lambda: (ints * 3 + 1) ^ 7)[1] == 0
    assert count_flops(lambda: a.clone().add_(1.0))[1] == 10  # in place
    x = torch.rand(10, requires_grad=True)
    with FlopCounter() as fc:
        torch.autograd.grad(torch.sum(torch.sigmoid(x) * x), x)
    # forward: sigmoid 10, mul 10, sum 10; backward: 2 muls, sigmoid_backward, add
    assert fc.flops == 70


def _port_inputs(samples):
    cfg = trenderer.RenderConfig(**{**SHAPE, "samples": samples})
    camera = tcam.camera_from_state(TVec4.of(0.0, -2.0, 0.0, 0.0, device=CPU),
                                    tcam.CameraAngles.of(0.0, 0.0, 0.0, device=CPU), 1.5, 2.0,
                                    device=CPU)
    return tlib.room_with_sphere(CPU), camera, cfg


def _jax_camera():
    zero = jnp.float32(0)
    return jcam.camera_from_state(JVec4.of(0.0, -2.0, 0.0, 0.0),
                                  jcam.CameraAngles(zero, zero, zero), 1.5, 2.0)


def port_k1_per_pixel(samples: int) -> float:
    scene, camera, cfg = _port_inputs(samples)
    flops = count_flops(trenderer.render_light, scene, camera, cfg, 1, slice(0, ROWS))[1]
    return flops / (ROWS * cfg.width)


def port_k4_per_ray() -> float:
    scene, camera, cfg = _port_inputs(SHAPE["samples"])
    target = torch.zeros(ROWS, cfg.width, 3)
    flops = count_flops(gradkernel.loss_and_grad_plain, params.pack(scene, camera), scene, camera,
                        cfg, 1, target, rows=(0, ROWS))[1]
    return flops / (ROWS * cfg.width * cfg.samples)


def jax_k1_per_pixel_one_sample() -> float:
    """The jnp renderer's jaxpr at 1 spp with the bounces unrolled (its
    sample loop is a while loop, which the jaxpr walk counts once)."""
    cfg = jrenderer.RenderConfig(**{**SHAPE, "samples": 1, "width": 32, "height": 8},
                                 bounce_loop="unroll")
    jaxpr = jax.make_jaxpr(lambda s: jrenderer.render_light(s, _jax_camera(), cfg,
                                                            jnp.uint32(1)))(jlib.room_with_sphere())
    return jgrad._count_jaxpr_flops(jaxpr.jaxpr) / (32 * 8)


def jax_k4_per_ray() -> float:
    """gradkernel.kernel_flops_per_ray of the fused K4 (grad_sample_chunk
    = samples)."""
    cfg = jrenderer.RenderConfig(**SHAPE, grad_sample_chunk=SHAPE["samples"])
    return jgrad.kernel_flops_per_ray(jlib.room_with_sphere(), _jax_camera(), cfg)


def test_k1_count_matches_jax_at_one_sample():
    port, ref = port_k1_per_pixel(1), jax_k1_per_pixel_one_sample()
    assert port == pytest.approx(ref, rel=0.01), (port, ref)


def test_k4_count_matches_jax_kernel_flops_per_ray():
    port, ref = port_k4_per_ray(), jax_k4_per_ray()
    assert port == pytest.approx(ref, rel=0.01), (port, ref)
    assert port > port_k1_per_pixel(SHAPE["samples"]) / SHAPE["samples"]


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    print(f"room {SHAPE['width']}x{SHAPE['height']}, {SHAPE['reflections_amount']} bounces")
    print(f"K1 per pixel at 1 spp: port {port_k1_per_pixel(1):.2f}, "
          f"JAX jaxpr {jax_k1_per_pixel_one_sample():.2f}")
    print(f"K1 per ray at {SHAPE['samples']} spp: port "
          f"{port_k1_per_pixel(SHAPE['samples']) / SHAPE['samples']:.2f}")
    print(f"K4 per ray at {SHAPE['samples']} spp: port {port_k4_per_ray():.2f}, "
          f"JAX kernel_flops_per_ray {jax_k4_per_ray():.2f}")
