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
    """The forward renders every configuration, on the CPU through the
    plain pipeline (the kernel wrapper's CPU route). The gradient kernels
    refuse the sequential stream alone (ValueError, as in the JAX package,
    on either device) and take the kepler sampler and the spec fold
    (csrc/gradmodes.cu): on the CPU the kernel route is the plain version,
    bitwise, and so do K8's launches (csrc/ablatemodes.cu, the modes
    launches' codes), whose plain loss variant is K4's loss unscaled; K8
    takes the sequential stream as its per-sample one, as the JAX tool
    does. axis_hints,
    which the forward takes, are refused by the gradient paths outside the
    freeze_hints contract; under it every gradient path, the soft ones
    included, takes a composite scene: the tiger's soft loss under its
    frozen hints is finite."""
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
    from fourd_ray_tracing_tpu_torch import diff
    from fourd_ray_tracing_tpu_torch.ops.cuda import ablate, gradkernel

    scene = tlib.sphere_plane_light(CPU)
    small = dataclasses.replace(cfg, width=8, height=4)
    ref = trenderer.render_light(scene, tc, small, 1)
    assert ref.shape == (4, 8, 3) and bool(torch.isfinite(ref).all())
    assert torch.equal(tkernel.render_light_cuda(scene, tc, small, 1), ref)
    vec, target = params.pack(scene, tc), torch.zeros((4, 8, 3))
    if "rng_mode" in change:
        with pytest.raises(ValueError, match="per-sample"):
            diff.image_loss_kernel(vec, scene, tc, small, 1, target)
        with pytest.raises(ValueError, match="per-sample"):
            gradkernel.check_kernel_config(small)
        per_sample = dataclasses.replace(small, rng_mode="per_sample")
        assert torch.equal(ablate.variant_plain("acc", scene, tc, small, 1),
                           ablate.variant_plain("acc", scene, tc, per_sample, 1))
        return
    gradkernel.check_kernel_config(small)
    loss = diff.image_loss_kernel(vec.clone().requires_grad_(True), scene, tc, small, 1, target)
    ref_loss, _ = gradkernel.loss_and_grad_plain(vec, scene, tc, small, 1, target)
    assert torch.equal(loss.detach(), ref_loss)
    assert gradkernel._modes(small, params.layout(scene, tc)) == (
        tkernel.FOLD_CODES[small.intersect], tkernel.SAMPLER_CODES[small.sampler_method],
        small.sampler_iters)
    value = ablate.variant_plain("loss", scene, tc, small, 1, target)
    np.testing.assert_allclose(float(value) / target.numel(), float(ref_loss), rtol=1e-6)


# --- The sequential stream (rng_mode="sequential", RenderConfig()'s) ----------

ALL_SCENES = sorted(tlib.SCENES)
SEQ_SHAPE = dict(width=32, height=16, samples=3, rng_mode="sequential")


@pytest.mark.parametrize("bounces", [2, 0])
@pytest.mark.parametrize("name", ALL_SCENES)
def test_default_config_renders_match_jax(name, bounces):
    """RenderConfig()'s modes (the sequential stream, the poly sampler, the
    fast fold) at 32x16, 3 spp, against JAX's jnp render_light; at 0
    bounces bounce 0 is the final iteration, whose dead draws the stream
    pays (their counters: test_sequential_counters_are_bitwise_jax)."""
    assert trenderer.RenderConfig().rng_mode == "sequential"
    shape = dict(SEQ_SHAPE, reflections_amount=bounces)
    jc, tc = cameras(("yxz",))
    ref = np.asarray(jrenderer.render_light(jlib.SCENES[name](), jc,
                                            jrenderer.RenderConfig(**shape), 7))
    out = trenderer.render_light(tlib.SCENES[name](CPU), tc, trenderer.RenderConfig(**shape),
                                 7).numpy()
    assert float(np.abs(out).max()) > 0.0 or (name, bounces) == ("room_with_sphere", 0)
    assert_images_close(out, ref, **BOUNDS)


def _counters(rng, renderer, renderer_name, scene, camera, cfg, seed):
    """The pixel bits and each sample's counter of a sequential stream,
    through ``renderer``'s own trace_rays (JAX or the port)."""
    if renderer_name == "jax":
        scr_x, scr_y = renderer.screen_coords(cfg)
        d = renderer.primary_directions(camera, scr_x, scr_y)
        bits = jnp.broadcast_to(rng.pixel_stream_bits(scr_x, scr_y), d.x.shape)
        o = JVec4(*(jnp.broadcast_to(c, d.x.shape) for c in camera.focus))
        counter = rng.init_counter(jnp.uint32(seed), bits.shape)
        pre0 = renderer.precompute_bounce0(scene, o, d, cfg)
        trace = lambda c: renderer.trace_rays(scene, o, d, bits, jnp.uint32(seed), c, cfg,  # noqa
                                              pre0)
    else:
        scr_x, scr_y = renderer.screen_coords(cfg, CPU)
        d = renderer.primary_directions(camera, scr_x, scr_y)
        bits = rng.pixel_stream_bits(scr_x, scr_y).expand(d.x.shape)
        o = TVec4(*(c.expand(d.x.shape) for c in camera.focus))
        counter = rng.init_counter(seed, d.x)
        pre0 = renderer.precompute_bounce0(scene, o, d, cfg)
        trace = lambda c: renderer.trace_rays(scene, d, bits, seed, c, cfg, pre0)  # noqa
    out = [np.asarray(bits).astype(np.int64)]
    for _ in range(cfg.samples):
        _, counter = trace(counter)
        out.append(np.asarray(counter).astype(np.int64))
    return out


@pytest.mark.parametrize("config", [dict(reflections_amount=0),
                                    dict(reflections_amount=2, sampler_method="newton",
                                         intersect="trig")], ids=["0b-poly-fast", "2b-newton-trig"])
@pytest.mark.parametrize("name", ALL_SCENES)
def test_sequential_counters_are_bitwise_jax(name, config):
    """The sequential stream's RNG words: the pixel bits and the counter
    after each of 3 samples, bitwise the JAX renderer's, the dead draws of
    the final iteration included (0 bounces: bounce 0's)."""
    from fourd_ray_tracing_tpu.ops import rng as jrng

    from fourd_ray_tracing_tpu_torch.ops import rng as trng

    shape = dict(SEQ_SHAPE, **config)
    jc, tc = cameras(("yxz",))
    ref = _counters(jrng, jrenderer, "jax", jlib.SCENES[name](), jc,
                    jrenderer.RenderConfig(**shape), 7)
    out = _counters(trng, trenderer, "port", tlib.SCENES[name](CPU), tc,
                    trenderer.RenderConfig(**shape), 7)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    assert (out[1] != 7).any() and (out[2] != out[1]).any()


def test_sequential_refuses_a_mid_stream_start():
    """A sequential stream carries its counter across the samples, so a
    tile cannot start at sample 1 (renderer.py:480-486)."""
    _, tc = cameras(("yxz",))
    cfg = trenderer.RenderConfig(width=8, height=4, samples=2)
    with pytest.raises(ValueError, match="mid-stream"):
        trenderer.render_light_tile(tlib.room_with_sphere(CPU), tc, cfg, 1, sample0=1,
                                    n_samples=1)


@pytest.mark.parametrize("name", ["sphere_plane_light"])
def test_oracle_config_matches_the_pallas_kernel(name):
    """The oracle's configuration (the sequential stream, the newton
    sampler, the trig fold) against the JAX forward kernel K1 in interpret
    mode, as tests/test_pallas.py runs it."""
    shape = dict(width=16, height=8, samples=2, reflections_amount=2, rng_mode="sequential",
                 sampler_method="newton", intersect="trig")
    jc, tc = cameras(("yxz",))
    ref = np.asarray(render_light_pallas(jlib.SCENES[name](), jc,
                                         jrenderer.RenderConfig(**shape), 3, interpret=True))
    out = trenderer.render_light(tlib.SCENES[name](CPU), tc, trenderer.RenderConfig(**shape),
                                 3).numpy()
    assert_images_close(out, ref, **BOUNDS)
