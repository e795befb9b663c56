"""The gradient launches K4, K5, K6 and K8 under the freeze_hints contract
(diff.with_frozen_hints: the static hints' fold tables, the frozen slots
written 0), compiled for the host and run by the CPU stand-in for the card
(tests/test_torch_emulated_runtime.py, EMU), against the unhinted launches
and torch autograd over the plain pipeline. The card's own runs are
chip_smoke.py's phases 8, 11, 12 and 17.
"""
import ctypes

import numpy as np
import pytest
import torch

from fourd_ray_tracing_tpu_torch.models import params
from fourd_ray_tracing_tpu_torch.ops.cuda import ablate, build, gradkernel

from test_torch_adjoint_host import (assert_grad_close, camera_of, grad_scene, image_shape,
                                     pattern_floor, second_row)
from test_torch_emulated_runtime import (COMPOSITE_HINTED, COMPOSITE_HINTED_IDS, GRAD_ENTRIES,
                                         GRAD_SOURCES, HINTED, HINTED_IDS, SOFT_REFS,
                                         ablate_launch, assert_contract, config_for,
                                         emulated_library, frozen_hints, launch_args,
                                         light_vjp_launch, loss_grad_launch, soft_launch)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build.bind(ctypes.CDLL(str(emulated_library(
        tmp_path_factory.mktemp("hinted_launch_emulated"), GRAD_SOURCES))), GRAD_ENTRIES)


@pytest.mark.parametrize("name,views,bounces", HINTED + COMPOSITE_HINTED,
                         ids=HINTED_IDS + COMPOSITE_HINTED_IDS)
def test_hinted_loss_grad_launch_keeps_the_unhinted_values(lib, name, views, bounces):
    """K4 under the contract: the loss bitwise the unhinted launch's, every
    kept slot equal, the frozen ones (the hyperplane normals) 0; bitwise
    across launches; within the mixed-scale bound of autograd over the
    unhinted plain pipeline with the slots frozen."""
    cfg = config_for(name, reflections_amount=bounces)
    scene, camera = grad_scene(name), camera_of(views)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    target = np.random.default_rng(4).uniform(
        0, 1, (*image_shape(views, cfg), 3)).astype(np.float32)
    seeds = np.array([0x12345678, 9], np.uint32)
    hcfg, hints, frozen = frozen_hints(scene, camera, cfg)
    loss, grad = loss_grad_launch(lib, packed, lay, hcfg, seeds, target, hints)
    again = loss_grad_launch(lib, packed, lay, hcfg, seeds, target, hints)
    loss_u, grad_u = loss_grad_launch(lib, packed, lay, cfg, seeds, target,
                                      launch_args(scene, camera, cfg))
    assert loss == loss_u and loss == again[0] and np.array_equal(grad, again[1])
    assert_contract(grad, grad_u, frozen)
    # The mask alone decides which slots come out 0: freeze a live slot too.
    live = int(np.flatnonzero(grad)[0])
    words, keep = hints
    keep = keep.copy()
    keep[live] = 0.0
    _, masked = loss_grad_launch(lib, packed, lay, hcfg, seeds, target, (words, keep))
    assert masked[live] == 0.0 and np.array_equal(np.delete(masked, live), np.delete(grad, live))
    _, ref = gradkernel.loss_and_grad_plain(torch.from_numpy(packed), scene, camera, cfg, seeds,
                                            torch.from_numpy(target))
    assert_grad_close(grad, np.where(frozen, 0.0, ref.numpy()).astype(np.float32),
                      pattern_floor(scene))


@pytest.mark.parametrize("name,views,bounces", [HINTED[0], COMPOSITE_HINTED[1]],
                         ids=[HINTED_IDS[0], COMPOSITE_HINTED_IDS[1]])
def test_hinted_split_launch_keeps_the_unhinted_values(lib, name, views, bounces):
    """K4 under the contract with its sweep split into 4 sample chunks a
    pixel: the loss bitwise the unhinted split launch's, every kept slot
    equal, the frozen ones 0, bitwise across launches. The hinted and the
    unhinted instance take one split (gradkernel.sweep_split reads no
    instance), so they sum in one order."""
    cfg = config_for(name, reflections_amount=bounces, samples=4, width=32, height=16)
    scene, camera = grad_scene(name), camera_of(views)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    target = np.random.default_rng(4).uniform(
        0, 1, (*image_shape(views, cfg), 3)).astype(np.float32)
    seeds = np.array([0x12345678, 9], np.uint32)
    hcfg, hints, frozen = frozen_hints(scene, camera, cfg)
    loss, grad = loss_grad_launch(lib, packed, lay, hcfg, seeds, target, hints, split=4)
    again = loss_grad_launch(lib, packed, lay, hcfg, seeds, target, hints, split=4)
    loss_u, grad_u = loss_grad_launch(lib, packed, lay, cfg, seeds, target,
                                      launch_args(scene, camera, cfg), split=4)
    assert loss == loss_u and loss == again[0] and np.array_equal(grad, again[1])
    assert_contract(grad, grad_u, frozen)


@pytest.mark.parametrize("name,views,bounces", HINTED + COMPOSITE_HINTED,
                         ids=HINTED_IDS + COMPOSITE_HINTED_IDS)
def test_hinted_light_vjp_launch_keeps_the_unhinted_values(lib, name, views, bounces):
    """K5 under the contract over the scene and its zero_object copy (a
    scene with composites: a copy with its floor moved; each row builds its
    own table): every kept slot of both rows equal to the unhinted
    launch's, the frozen ones 0."""
    cfg = config_for(name, reflections_amount=bounces)
    scene, camera = grad_scene(name), camera_of(views)
    lay = params.layout(scene, camera)
    rows = params.stack_rows([scene, second_row(scene)], camera).numpy()
    cot = np.random.default_rng(7).normal(
        0, 1, (2, *image_shape(views, cfg), 3)).astype(np.float32)
    hcfg, hints, frozen = frozen_hints(scene, camera, cfg)
    grad = light_vjp_launch(lib, rows, lay, hcfg, cot, hints)
    assert_contract(grad, light_vjp_launch(lib, rows, lay, cfg, cot,
                                           launch_args(scene, camera, cfg)), frozen)
    assert np.array_equal(grad, light_vjp_launch(lib, rows, lay, hcfg, cot, hints))


@pytest.mark.parametrize("name,views,bounces", HINTED + COMPOSITE_HINTED,
                         ids=HINTED_IDS + COMPOSITE_HINTED_IDS)
def test_hinted_soft_launch_keeps_the_unhinted_values(lib, name, views, bounces):
    """K6 under the contract (both rows fold over their own tables, row b's
    with the zero map applied; a composite's: the zeroed object's library
    instance or the generic composite fold): the loss and the alpha
    cotangent bitwise the unhinted launch's, every kept slot equal, the
    frozen ones 0."""
    cfg = config_for(name, reflections_amount=bounces)
    scene, camera = grad_scene(name), camera_of(views)
    ref = SOFT_REFS[name]
    rng = np.random.default_rng(5)
    target = rng.uniform(0, 1, (*image_shape(views, cfg), 3)).astype(np.float32)
    alpha = rng.uniform(0, 1, image_shape(views, cfg)).astype(np.float32)
    lay = params.layout(scene, camera)
    zero_map = params.soft_zero_map(scene, camera, ref)
    packed = params.pack(scene, camera).numpy()
    rows = (0, cfg.height)
    hcfg, hints, frozen = frozen_hints(scene, camera, cfg)
    out = soft_launch(lib, packed, lay, hcfg, 3, target, alpha, zero_map, rows, hints)
    plain = soft_launch(lib, packed, lay, cfg, 3, target, alpha, zero_map, rows,
                        launch_args(scene, camera, cfg))
    assert out[0] == plain[0] and np.array_equal(out[2], plain[2])
    assert_contract(out[1], plain[1], frozen)


@pytest.mark.parametrize("name,views,bounces", HINTED + COMPOSITE_HINTED,
                         ids=HINTED_IDS + COMPOSITE_HINTED_IDS)
def test_hinted_ablate_launch_keeps_the_unhinted_values(lib, name, views, bounces):
    """K8 under the contract, every mode: bitwise the unhinted launch (the
    hinted fold's light is the unhinted fold's; a scene with composites
    unhinted folds over its descriptor without hints), and the loss mode
    within the plain version's rounding of its double sum (a scene with
    composites)."""
    cfg = config_for(name, reflections_amount=bounces)
    scene, camera = grad_scene(name), camera_of(views)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    target = np.random.default_rng(4).uniform(
        0, 1, (*image_shape(views, cfg), 3)).astype(np.float32)
    hcfg, (words, _), _ = frozen_hints(scene, camera, cfg)
    unhinted = gradkernel.launch_words(lay, cfg)
    for mode in range(3):
        assert (ablate_launch(lib, mode, packed, lay, hcfg, target, words)
                == ablate_launch(lib, mode, packed, lay, cfg, target, unhinted)), mode
    if lay.composite_kinds():
        ref = ablate.variant_plain("loss", scene, camera, cfg, 3, torch.from_numpy(target))
        np.testing.assert_allclose(ablate_launch(lib, 1, packed, lay, cfg, target, unhinted),
                                   float(ref), rtol=1e-6)
