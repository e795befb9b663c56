"""The port's plain forward pipeline against the JAX renderer and the
Pallas forward kernel (interpret mode), and the kernel wrapper's CPU path.

Same shape as tests/test_pallas.py's CFG: 32x16, 2 spp, 2 bounces,
per-sample RNG. Images are held to test_pallas.py's bounds: a path
tracer's pixel is a discontinuous function of ulp-level arithmetic (XLA
on the CPU fuses multiply-adds, torch does not), so a few silhouette
pixels may flip; all others agree to 1e-5.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import assert_images_close

from fourd_ray_tracing_tpu import camera as jcam
from fourd_ray_tracing_tpu.models import library as jlib
from fourd_ray_tracing_tpu.models import renderer as jrenderer
from fourd_ray_tracing_tpu.ops.pallas.megakernel import render_light_pallas
from fourd_ray_tracing_tpu.ops.vec4 import Vec4 as JVec4

from fourd_ray_tracing_tpu_torch import camera as tcam
from fourd_ray_tracing_tpu_torch.models import library as tlib
from fourd_ray_tracing_tpu_torch.models import params
from fourd_ray_tracing_tpu_torch.models import renderer as trenderer
from fourd_ray_tracing_tpu_torch.ops.cuda import megakernel as tkernel
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4 as TVec4

CPU = torch.device("cpu")
SCENES = ["room_with_sphere", "sphere_plane_light"]
SHAPE = dict(width=32, height=16, samples=2, reflections_amount=2, rng_mode="per_sample")
J_CFG = jrenderer.RenderConfig(**SHAPE)
T_CFG = trenderer.RenderConfig(**SHAPE)
BOUNDS = dict(atol=1e-5, boundary_frac=0.02, mean_atol=0.05)


def cameras(views):
    o = jcam.orientation_from_angles(jnp.float32(0.0), jnp.float32(0.0), jnp.float32(0.0))
    jtop, jright = (jcam.view_basis(o, views[0]) if len(views) == 1
                    else jcam.batched_view_bases(o, views))
    mtr_h = jnp.float32(2.0)
    jc = jcam.Camera(JVec4.of(0.0, -2.0, 0.0, 0.0), o.forward * jnp.float32(1.5),
                     jtop, jright, mtr_h * jcam.GOLDEN, mtr_h)
    to = tcam.orientation_from_angles(*tcam.CameraAngles.of(0.0, 0.0, 0.0, device=CPU), CPU)
    tc = tcam.make_camera(TVec4.of(0.0, -2.0, 0.0, 0.0, device=CPU), to, 1.5, 2.0, views, CPU)
    return jc, tc


JAX_RENDERERS = {"jnp": jrenderer.render_light, "pallas": render_light_pallas}


@pytest.mark.parametrize("reference", sorted(JAX_RENDERERS))
@pytest.mark.parametrize("views", [("yxz",), tcam.VIEWS_ALL], ids=["1view", "3view"])
@pytest.mark.parametrize("name", SCENES)
def test_render_light_matches_jax(name, views, reference):
    jc, tc = cameras(views)
    ref = np.asarray(JAX_RENDERERS[reference](jlib.SCENES[name](), jc, J_CFG, 7))
    out = trenderer.render_light(tlib.SCENES[name](CPU), tc, T_CFG, 7).numpy()
    assert out.shape == ref.shape == ((16, 32, 3) if len(views) == 1 else (3, 16, 32, 3))
    assert_images_close(out, ref, **BOUNDS)


@pytest.mark.parametrize("name", SCENES)
def test_zero_reflections_matches_jax(name):
    """reflections_amount=0: only the hoisted bounce 0 shades."""
    jc, tc = cameras(("yxz",))
    ref = np.asarray(jrenderer.render_light(
        jlib.SCENES[name](), jc, dataclasses.replace(J_CFG, reflections_amount=0), 3))
    out = trenderer.render_light(
        tlib.SCENES[name](CPU), tc, dataclasses.replace(T_CFG, reflections_amount=0), 3).numpy()
    assert_images_close(out, ref, **BOUNDS)


def test_render_image_matches_jax():
    jc, tc = cameras(("yxz",))
    cfg_j = dataclasses.replace(J_CFG, light_coefficient=0.5)
    cfg_t = dataclasses.replace(T_CFG, light_coefficient=0.5)
    ref = np.asarray(jrenderer.render_image(jlib.sphere_plane_light(), jc, cfg_j, 5))
    out = trenderer.render_image(tlib.sphere_plane_light(CPU), tc, cfg_t, 5).numpy()
    assert_images_close(out, ref, **BOUNDS)


@pytest.mark.parametrize("name", SCENES)
def test_seed_vector_is_bitwise_per_frame(name):
    """A (4,) seed vector renders each frame bitwise as its scalar seed."""
    _, tc = cameras(tcam.VIEWS_ALL)
    scene = tlib.SCENES[name](CPU)
    seeds = np.array([1, 7, 0xFFFFFFFF, 123456789], np.uint32)
    batch = tkernel.render_light_cuda(scene, tc, T_CFG, seeds)
    assert batch.shape == (4, 3, 16, 32, 3)
    for k, s in enumerate(seeds):
        single = tkernel.render_light_cuda(scene, tc, T_CFG, int(s))
        assert torch.equal(batch[k], single)
    assert not torch.equal(batch[0], batch[1])


def test_render_image_cuda_on_cpu_is_the_plain_pipeline():
    """CPU tensors take the plain version, and no kernel launch is counted."""
    _, tc = cameras(("yxz",))
    scene = tlib.room_with_sphere(CPU)
    before = tkernel.LAUNCHES
    out = tkernel.render_image_cuda(scene, tc, T_CFG, torch.tensor([3, 4]))
    ref = torch.stack([trenderer.render_image(scene, tc, T_CFG, s) for s in (3, 4)])
    assert torch.equal(out, ref)
    assert tkernel.LAUNCHES == before


def test_launch_forward_refuses_cpu_tensors():
    """The kernel path has no CPU fallback."""
    _, tc = cameras(("yxz",))
    scene = tlib.room_with_sphere(CPU)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.launch_forward(params.pack(scene, tc), params.layout(scene, tc), T_CFG,
                               torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("change", [
    dict(rng_mode="sequential"),
    dict(axis_hints=((0, 1.0),)),
    dict(sampler_method="kepler"),
    dict(intersect="spec"),
])
def test_unported_configs_raise(change):
    """Configurations still to be ported raise, naming their ROADMAP item;
    axis_hints, which the forward takes, are refused by the gradient paths
    outside the freeze_hints contract; under it every gradient path, the
    soft ones included, takes a composite scene: the tiger's soft loss
    under its frozen hints is finite."""
    _, tc = cameras(("yxz",))
    cfg = dataclasses.replace(T_CFG, **change)
    if "axis_hints" in change:
        with pytest.raises(ValueError, match="freeze_hints contract"):
            trenderer.check_trainable(cfg)
        frozen = dataclasses.replace(cfg, freeze_hints=True)
        trenderer.check_trainable(frozen)
        from fourd_ray_tracing_tpu_torch import diff

        tiger = tlib.tiger(CPU)
        small = diff.with_frozen_hints(dataclasses.replace(T_CFG, width=8, height=4), tiger)
        loss = diff.soft_image_loss(tiger, tc, small, 1, torch.zeros((4, 8, 3)),
                                    object_ref=("tiger", None))
        assert small.axis_hints is not None and torch.isfinite(loss)
        return
    for render in (trenderer.render_light, tkernel.render_light_cuda):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            render(tlib.sphere_plane_light(CPU), tc, cfg, 1)
