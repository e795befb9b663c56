"""The measurement path's plain versions and tools against the JAX
package's: K8 (ops/cuda/ablate.py) against tools/grad_ablate.py's
``build`` in interpret mode, the forward stub variants against the JAX
renderer under tools/fwd_ablate.py's own patches, and each attribution
tool's CPU route.

K8 runs on the room at tests/test_torch_gradkernel.py's shape (32x16, 2
spp, 2 bounces, light_coefficient 0.7, seed 5, a seeded uniform target)
with a hint-free config; tile_sublanes 4 makes the 512 pixels one JAX tile,
so no padded lane enters the JAX ``acc`` sum (it is unmasked). The JAX
values are computed once per module. Tolerances: ``loss`` and ``vjp``
rtol 1e-5, as for K4's loss; ``acc`` rtol 1e-6: this room's light comes in
whole quanta at this shape and the sums agree exactly (measured), so XLA's
FMA contraction forces nothing here, while one flipped visibility outcome
would move the sum by a quantum (5e-4 of it) and fail.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import assert_images_close
from tools import grad_ablate as jax_grad_ablate

from fourd_ray_tracing_tpu import camera as jcam
from fourd_ray_tracing_tpu.models import library as jlib
from fourd_ray_tracing_tpu.models import renderer as jrenderer
from fourd_ray_tracing_tpu.ops import rng as jrng
from fourd_ray_tracing_tpu.ops.vec4 import Vec4 as JVec4

from fourd_ray_tracing_tpu_torch import camera as tcam
from fourd_ray_tracing_tpu_torch import diff
from fourd_ray_tracing_tpu_torch.models import library as tlib
from fourd_ray_tracing_tpu_torch.models import params
from fourd_ray_tracing_tpu_torch.models import renderer as trenderer
from fourd_ray_tracing_tpu_torch.ops.cuda import ablate, gradkernel, megakernel
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4 as TVec4
from fourd_ray_tracing_tpu_torch.tools import (common, fwd_ablate, grad_ablate, soft_ablate,
                                               train_ablate)

CPU = torch.device("cpu")
SHAPE = dict(width=32, height=16, samples=2, reflections_amount=2, rng_mode="per_sample")
K8_SHAPE = dict(SHAPE, light_coefficient=0.7)
SEED = 5
RTOL = {"acc": 1e-6, "loss": 1e-5, "vjp": 1e-5}
TINY = ["32", "16", "2", "2"]


def jax_camera():
    zero = jnp.float32(0)
    return jcam.camera_from_state(JVec4.of(0.0, -2.0, 0.0, 0.0),
                                  jcam.CameraAngles(zero, zero, zero), 1.5, 2.0)


def torch_camera():
    o = tcam.orientation_from_angles(*tcam.CameraAngles.of(0.0, 0.0, 0.0, device=CPU), CPU)
    return tcam.make_camera(TVec4.of(0.0, -2.0, 0.0, 0.0, device=CPU), o, 1.5, 2.0, ("yxz",), CPU)


def target_image():
    return np.random.default_rng(1).uniform(0, 1, (16, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_variants():
    cfg = jrenderer.RenderConfig(**K8_SHAPE, tile_sublanes=4)
    scene, camera, target = jlib.room_with_sphere(), jax_camera(), jnp.asarray(target_image())
    return {mode: float(jax_grad_ablate.build(scene, camera, cfg, target, mode)(np.uint32(SEED)))
            for mode in ablate.MODES}


@pytest.mark.parametrize("mode", ablate.MODES)
def test_plain_variant_matches_jax_kernel(mode, jax_variants):
    cfg = trenderer.RenderConfig(**K8_SHAPE)
    value = ablate.variant_plain(mode, tlib.room_with_sphere(CPU), torch_camera(), cfg, SEED,
                                 torch.from_numpy(target_image()))
    assert value.dtype == torch.float64 and value.dim() == 0
    np.testing.assert_allclose(float(value), jax_variants[mode], rtol=RTOL[mode])


def test_loss_variant_is_k4s_unscaled_loss():
    cfg = trenderer.RenderConfig(**K8_SHAPE)
    scene, camera = tlib.room_with_sphere(CPU), torch_camera()
    target = torch.from_numpy(target_image())
    loss, _ = gradkernel.loss_and_grad_plain(params.pack(scene, camera), scene, camera, cfg, SEED,
                                             target)
    value = ablate.variant_plain("loss", scene, camera, cfg, SEED, target)
    np.testing.assert_allclose(float(value) / target.numel(), float(loss), rtol=1e-6)
    assert float(ablate.variant_plain("vjp", scene, camera, cfg, SEED, target)) == float(value)


def test_plain_variant_rows_sum_to_the_image():
    cfg = trenderer.RenderConfig(**K8_SHAPE)
    scene, camera = tlib.room_with_sphere(CPU), torch_camera()
    target = torch.from_numpy(target_image())
    for mode in ("acc", "loss"):
        whole = float(ablate.variant_plain(mode, scene, camera, cfg, SEED, target))
        parts = sum(float(ablate.variant_plain(mode, scene, camera, cfg, SEED, target[r0:r0 + n],
                                               (r0, n))) for r0, n in ((0, 6), (6, 10)))
        np.testing.assert_allclose(parts, whole, rtol=1e-12)


def test_grad_ablate_build_on_cpu_runs_the_plain_versions():
    cfg = trenderer.RenderConfig(**K8_SHAPE)
    scene, camera = tlib.room_with_sphere(CPU), torch_camera()
    target = torch.from_numpy(target_image())
    before = (ablate.LAUNCHES, gradkernel.LAUNCHES)
    for mode in ablate.MODES:
        assert torch.equal(grad_ablate.build(scene, camera, cfg, target, mode)(SEED),
                           ablate.variant_plain(mode, scene, camera, cfg, SEED, target))
    k4 = grad_ablate.build(scene, camera, cfg, target, "k4")(SEED)
    plain, _ = gradkernel.loss_and_grad_plain(params.pack(scene, camera), scene, camera, cfg, SEED,
                                              target)
    assert torch.equal(k4, plain)
    assert (ablate.LAUNCHES, gradkernel.LAUNCHES) == before
    with pytest.raises(ValueError, match="mode"):
        grad_ablate.build(scene, camera, cfg, target, "sweep")


def test_launch_wrappers_refuse_cpu_tensors():
    cfg = trenderer.RenderConfig(**K8_SHAPE)
    scene, camera = tlib.room_with_sphere(CPU), torch_camera()
    packed, lay = params.pack(scene, camera), params.layout(scene, camera)
    target = torch.from_numpy(target_image())
    with pytest.raises(ValueError, match="CUDA"):
        ablate.launch_variant("acc", packed, lay, cfg, SEED, target)
    with pytest.raises(ValueError, match="mode"):
        ablate.launch_variant("sweep", packed, lay, cfg, SEED, target)
    with pytest.raises(ValueError, match="CUDA"):
        megakernel.launch_forward_variant("rng_const", packed, lay, cfg,
                                          megakernel.seed_tensor([SEED], CPU))


def const_dir(u_w, u_z, u_fi, *, method="poly", kepler_iters=2):
    """tools/fwd_ablate.py's sampler stub (a closure there)."""
    half = u_w * 0.0 + np.float32(0.5)
    return JVec4(half, half, half, half)


def const_mu(pixel_bits, seed, counter, active):
    """tools/fwd_ablate.py's RNG stub."""
    return jnp.full(jnp.shape(pixel_bits), np.float32(0.5)), counter


@pytest.mark.parametrize("variant", sorted(megakernel.VARIANTS))
def test_stub_variants_match_jax_patches(variant, monkeypatch):
    code = megakernel.VARIANTS[variant]
    if code & 1:
        monkeypatch.setattr(jrenderer, "direction_from_uniforms", const_dir)
    if code & 2:
        monkeypatch.setattr(jrng, "masked_uniform01", const_mu)
    # JAX caches what it traced: clear it on both sides of the stubbed run,
    # so the reference traces the stubs and later renders trace the real
    # functions again.
    jax.clear_caches()
    try:
        ref = np.asarray(jrenderer.render_light(jlib.room_with_sphere(), jax_camera(),
                                                jrenderer.RenderConfig(**SHAPE), 7))
    finally:
        monkeypatch.undo()
        jax.clear_caches()
    cfg = trenderer.RenderConfig(**SHAPE)
    scene, camera = tlib.room_with_sphere(CPU), torch_camera()
    real = (trenderer.direction_from_uniforms, megakernel.rng.masked_uniform01)
    with megakernel.stubs(variant):
        out = trenderer.render_light(scene, camera, cfg, 7)
    assert (trenderer.direction_from_uniforms, megakernel.rng.masked_uniform01) == real
    assert_images_close(out.numpy(), ref, atol=1e-5, boundary_frac=0.02, mean_atol=0.05)
    assert not torch.equal(out, trenderer.render_light(scene, camera, cfg, 7))


def test_stubs_restore_the_renderer_after_an_error():
    real = (trenderer.direction_from_uniforms, megakernel.rng.masked_uniform01)
    with pytest.raises(RuntimeError, match="inside"):
        with megakernel.stubs("both_const"):
            assert trenderer.direction_from_uniforms is megakernel.const_direction
            raise RuntimeError("inside")
    assert (trenderer.direction_from_uniforms, megakernel.rng.masked_uniform01) == real


def lines_of(capsys) -> list:
    return [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]


def test_grad_ablate_cpu_route(capsys):
    assert grad_ablate.main([*TINY, "--device", "cpu", "--rounds", "1", "--calls", "1"]) == 0
    lines = lines_of(capsys)
    by_mode = {line["mode"]: line for line in lines[:-1]}
    assert list(by_mode) == ["acc", "loss", "vjp", "k4"]
    assert all(line["device"] == "cpu" and line["ms"] > 0 for line in by_mode.values())
    assert by_mode["vjp"]["value"] == by_mode["loss"]["value"]
    np.testing.assert_allclose(by_mode["loss"]["value"] / (16 * 32 * 3), by_mode["k4"]["value"],
                               rtol=1e-6)
    assert set(lines[-1]["k4_split_ms"]) == {"pass1", "tone_map_loss", "cotangent",
                                             "sweep_reduction"}


def test_train_ablate_cpu_route(capsys):
    assert train_ablate.main([*TINY, "--device", "cpu", "--rounds", "1", "--calls", "1"]) == 0
    lines = lines_of(capsys)
    assert [line["stage"] for line in lines[:-1]] == list(train_ablate.STAGES)
    assert lines[0]["x_vs_prev"] is None and all(line["x_vs_prev"] > 0 for line in lines[1:-1])
    assert set(lines[-1]["delta_ms_vs_fwd"]) == set(train_ablate.STAGES)


def test_soft_ablate_cpu_route(capsys):
    assert soft_ablate.main([*TINY, "--device", "cpu", "--rounds", "2", "--calls", "1"]) == 0
    lines = lines_of(capsys)
    assert [line["variant"] for line in lines] == [*soft_ablate.VARIANTS, "fusion_win_ms"]
    assert len(lines[-1]["ms_rounds"]) == 2 and len(lines[-1]["quartiles_ms"]) == 3
    cfg = trenderer.RenderConfig(**SHAPE, light_coefficient=0.12)
    scene, camera = tlib.room_with_sphere(CPU), common.default_camera(CPU)
    loss = diff.soft_image_loss_kernel(params.pack(scene, camera), scene, camera, cfg,
                                       soft_ablate.SEED, torch.zeros((16, 32, 3)), soft_ablate.REF,
                                       soft_ablate.EDGE)
    assert lines[4]["loss"] == float(loss)
    assert lines[3]["loss"] == float(loss)  # the pair step is the same loss


def test_fwd_ablate_cpu_route(capsys, monkeypatch):
    monkeypatch.setenv("ABLATE_FPL", "2")
    assert fwd_ablate.main([*TINY, "--device", "cpu", "--rounds", "1", "--calls", "1"]) == 0
    lines = lines_of(capsys)
    names = ["baseline", "sampler_const", "rng_const", "both_const", "generic_fold", "unhinted",
             "drop_spaces", "drop_spheres", "bounces_0", "bounces_1", "bounces_2",
             "baseline_recheck"]
    assert [line["variant"] for line in lines[:-2]] == names
    assert [line["hints"].split(": ")[-1] for line in lines[4:7]] == [
        "4 wall pairs, 0 single planes", "none", "none"]
    assert all(line["frames_per_launch"] == 2 and line["gray_per_s"] > 0 for line in lines[:-2])
    assert "drift_check" in lines[-2]
    assert set(lines[-1]["time_delta_pct_vs_baseline"]) == set(names[1:])


def test_fwd_ablate_composite_views_and_variant_filter(capsys, monkeypatch):
    """ABLATE_SCENE takes a composite scene, ABLATE_VIEWS=3 the 3-view batch
    (its rays counted), ABLATE_VARIANTS keeps the named variants beside the
    baseline and its recheck, and an unknown name is refused."""
    for key, value in (("ABLATE_FPL", "2"), ("ABLATE_SCENE", "tiger"), ("ABLATE_VIEWS", "3"),
                       ("ABLATE_VARIANTS", "generic_fold,unhinted")):
        monkeypatch.setenv(key, value)
    assert fwd_ablate.main(["8", "4", "1", "1", "--device", "cpu", "--rounds", "1",
                            "--calls", "1"]) == 0
    lines = lines_of(capsys)
    assert [line["variant"] for line in lines[:-2]] == ["baseline", "generic_fold", "unhinted",
                                                        "baseline_recheck"]
    assert all(line["views"] == 3 and line["scene"] == "tiger" for line in lines[:-2])
    assert lines[0]["ms"] == pytest.approx(8 * 4 * 1 * 2 * 3 / lines[0]["gray_per_s"] / 1e6)
    assert lines[0]["hints"].endswith("the composites' axis hints")
    monkeypatch.setenv("ABLATE_VARIANTS", "generic_fold,nothing")
    with pytest.raises(ValueError, match="nothing"):
        fwd_ablate.variants(tlib.tiger(CPU), trenderer.RenderConfig(**SHAPE))
    monkeypatch.setenv("ABLATE_VIEWS", "2")
    with pytest.raises(ValueError, match="ABLATE_VIEWS"):
        fwd_ablate.views()


def test_fwd_ablate_plain_fn_is_the_cpu_route(monkeypatch):
    """build_fn on CPU tensors is plain_fn: fpl() frames at seeds seed * fpl
    + arange(fpl), under the variant's stubs, without a launch."""
    monkeypatch.setenv("ABLATE_FPL", "2")
    cfg = trenderer.RenderConfig(**SHAPE)
    scene, camera = tlib.room_with_sphere(CPU), torch_camera()
    before = (megakernel.LAUNCHES, megakernel.VARIANT_LAUNCHES)
    out = fwd_ablate.build_fn(scene, camera, cfg, "sampler_const")(3)
    with megakernel.stubs("sampler_const"):
        want = trenderer.render_light(scene, camera, cfg, np.arange(6, 8, dtype=np.uint32))
    assert torch.equal(out, want) and out.shape == (2, 16, 32, 3)
    assert torch.equal(fwd_ablate.build_fn(scene, camera, cfg)(3),
                       trenderer.render_light(scene, camera, cfg, np.arange(6, 8, dtype=np.uint32)))
    assert (megakernel.LAUNCHES, megakernel.VARIANT_LAUNCHES) == before


def test_tools_share_one_command_line():
    args = common.parse_tool_args("doc", [], calls=4, rounds=3)
    assert args.shape == common.SHAPE and (args.calls, args.rounds, args.device) == (4, 3, "cuda")
    args = common.parse_tool_args("doc", [*TINY, "--device", "cpu", "--calls", "2"], 4, 3)
    assert args.shape == (32, 16, 2, 2) and args.calls == 2 and args.device == "cpu"
    with pytest.raises(SystemExit):
        common.parse_tool_args("doc", ["32", "16"], 4, 3)


def test_fwd_ablate_variants_keep_a_primitive():
    cfg = trenderer.RenderConfig(**SHAPE)
    for name in ("room_with_sphere", "sphere_plane_light"):
        for label, scene, _, _ in fwd_ablate.variants(tlib.SCENES[name](CPU), cfg):
            assert scene.spaces or scene.spheres, (name, label)
