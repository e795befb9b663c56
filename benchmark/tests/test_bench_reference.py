"""The frozen copy agrees with the port's plain pipeline at a tiny size
on the CPU: the images, the static hints and freeze masks, and the loss
and gradient of the image loss."""
import numpy as np
import pytest
import torch

from benchmark.harness import common
from benchmark.reference import grad, hints, progressive
from benchmark.reference.models import params as ref_params
from benchmark.reference.models.renderer import RenderConfig as RefConfig
from benchmark.tests.helpers import tiny_cell

SCENES = ("room", "tiger")


def port_side(config, views):
    from fourd_ray_tracing_tpu_torch import camera as cam
    from fourd_ray_tracing_tpu_torch.models import library
    from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig
    from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4

    c = config["camera"]
    orient = cam.orientation_from_angles(*cam.CameraAngles.of(*c["angles"], device="cpu"), "cpu")
    camera = cam.make_camera(Vec4.of(*c["focus"], device="cpu"), orient,
                             c["focus_to_matrix_distance"], c["matrix_height"], tuple(views),
                             "cpu")
    return (library.SCENES[config["scene"]]("cpu"), camera,
            common.render_config(RenderConfig, config))


def ref_side(config, views):
    return (common.reference_scene(config, "cpu"),
            common.reference_camera(config, views, "cpu"), common.render_config(RefConfig, config))


@pytest.mark.parametrize("name", SCENES)
def test_copy_renders_the_port_s_image(name):
    from fourd_ray_tracing_tpu_torch.models import renderer

    config = tiny_cell(f"{name}.train4").config
    views = config["windows"][0]["views"] + config["windows"][1]["views"]
    scene, camera, cfg = port_side(config, views)
    r_scene, r_camera, r_cfg = ref_side(config, views)
    seeds = [7, 2**32 - 3]
    want = renderer.render_image(scene, camera, cfg, seeds)
    got = grad.render_banded(r_scene, r_camera, r_cfg, seeds, 3)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", SCENES)
def test_copy_derives_the_port_s_hints_and_mask(name):
    from fourd_ray_tracing_tpu_torch import diff
    from fourd_ray_tracing_tpu_torch.models import params

    config = tiny_cell(f"{name}.train4").config
    scene, _, cfg = port_side(config, ("yxz",))
    r_scene, _, r_cfg = ref_side(config, ("yxz",))
    port_cfg = diff.with_frozen_hints(cfg, scene)
    ref_cfg = hints.with_frozen_hints(r_cfg, r_scene)
    for key in ("plane_hints", "plane_pairs", "axis_hints"):
        assert repr(getattr(port_cfg, key)) == repr(getattr(ref_cfg, key))
    assert torch.equal(params.freeze_mask(port_cfg, scene),
                       ref_params.freeze_mask(ref_cfg, r_scene))


@pytest.mark.parametrize("name", SCENES)
def test_copy_s_loss_and_gradient_match_the_port_s(name):
    from fourd_ray_tracing_tpu_torch import diff
    from fourd_ray_tracing_tpu_torch.models import params
    from fourd_ray_tracing_tpu_torch.ops.cuda import gradkernel

    config = tiny_cell(f"{name}.train4").config
    scene, camera, cfg = port_side(config, ("yxz",))
    r_scene, r_camera, r_cfg = ref_side(config, ("yxz",))
    target = torch.rand((cfg.height, cfg.width, 3), generator=torch.Generator().manual_seed(1))
    seeds = grad.frame_seeds(5, 2)
    hcfg = diff.with_frozen_hints(cfg, scene)
    loss, g = gradkernel.loss_and_grad_plain(params.pack(scene, camera), scene, camera, hcfg,
                                             seeds, target, band_rows=4)
    r_cfg = hints.with_frozen_hints(r_cfg, r_scene)
    mask = ref_params.freeze_mask(r_cfg, r_scene)
    r_loss, r_g = grad.loss_and_grad(ref_params.pack(r_scene, r_camera), r_scene, r_camera,
                                     hints.unhinted(r_cfg), seeds, target, 3)
    n = mask.numel()
    assert float(r_loss) == pytest.approx(float(loss), rel=1e-6)
    np.testing.assert_allclose((r_g[:n] * mask).numpy(), g[:n].numpy(), rtol=1e-4, atol=1e-7)


def test_engine_seed_sequence_and_blend():
    from fourd_ray_tracing_tpu_torch.engine import RenderEngine
    from fourd_ray_tracing_tpu_torch.models.renderer import accumulate

    class Probe(RenderEngine):
        def __init__(self):  # the seed state alone
            import numpy as np_

            self.seed, self.frame_number, self._rng_draws = 2**32 - 5, 1, 0
            self._deterministic, self._np_rng = True, np_.random.default_rng(0)

    engine = Probe()
    seeds = [engine._next_seed()[0] for _ in range(9)]
    assert seeds == progressive.frame_seeds(2**32 - 5, 9)
    acc = torch.rand(4, 3, 3)
    frames = torch.rand(3, 4, 3, 3)
    want = acc.clone()
    for k in range(3):
        accumulate(want, frames[k], 1.0 / float(5 + k))
    assert torch.equal(progressive.blend(acc, frames, 5), want)
