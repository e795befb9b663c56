"""K6, the soft value-and-grad launch (csrc/gradkernel.cu, and over the
composite folds softcomposite.cu), compiled for the host and run by the
CPU stand-in for the card (tests/test_torch_emulated_runtime.py, EMU),
against torch autograd over the plain blend: its pass 1 on both rows, its
split of the rows over its kernels (row a's sweep leaves each pixel's
row-b work in scratch, row b's sweep takes it), the sweeps' job rounds,
the reduction and sum_parts, and the zero map's cap. The card's own runs
are chip_smoke.py's phases 12 and 13b.
"""
import ctypes

import numpy as np
import pytest
import torch

from fourd_ray_tracing_tpu_torch import camera as tcam
from fourd_ray_tracing_tpu_torch.models import library, params
from fourd_ray_tracing_tpu_torch.ops.cuda import build, gradkernel

from test_torch_adjoint_host import (assert_grad_close, camera_of, grad_scene, image_shape,
                                     pattern_floor)
from test_torch_emulated_runtime import (CPU, GRAD_ENTRIES, GRAD_SOURCES, SOFT_REFS, VIEWS_1,
                                         config, config_for, emulated_library, frozen_hints,
                                         launch_args, rows_of, soft_launch)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build.bind(ctypes.CDLL(str(emulated_library(
        tmp_path_factory.mktemp("soft_launch_emulated"), GRAD_SOURCES))), GRAD_ENTRIES)


@pytest.mark.parametrize("name,ref,views,bounces,rows,wider", [
    ("room_with_sphere", ("spheres", 0), VIEWS_1, 4, None, False),
    ("room_with_sphere", ("spheres", 0), VIEWS_1, 3, None, False),
    ("room_with_sphere", ("spheres", 0), VIEWS_1, 4, (5, 13), False),
    ("room_with_sphere", ("spheres", 0), VIEWS_1, 4, None, True),
    ("sphere_plane_light", ("spheres", 1), tcam.VIEWS_ALL, 4, None, False),
], ids=["room_main", "room_generic", "room_row_block", "room_wider_zero_map", "lamp_3view"])
def test_soft_launch_matches_autograd(lib, name, ref, views, bounces, rows, wider):
    """K6's launch: pass 1 on both rows, then the sweep's job rounds, its
    reduction and sum_parts, against the plain blend by autograd (loss rtol
    1e-6, gradient and alpha cotangent the mixed-scale 1e-3 of the host
    tests); bitwise across two launches. ``wider``: a zero map that also
    rewrites wall 0's color, whose rows are swept apart on every pixel."""
    cfg = config(reflections_amount=bounces)
    scene, camera = library.SCENES[name](CPU), camera_of(views)
    rows = rows or (0, cfg.height)
    rng = np.random.default_rng(5)
    target = rng.uniform(0, 1, (*image_shape(views, cfg), 3)).astype(np.float32)
    alpha = rng.uniform(0, 1, image_shape(views, cfg)).astype(np.float32)
    lay = params.layout(scene, camera)
    zero_map = params.soft_zero_map(scene, camera, ref)
    if wider:
        zero_map = [*zero_map, *((lay.spaces + 10 + k, 0.25) for k in range(3))]
    packed = params.pack(scene, camera).numpy()
    block_t, block_a = rows_of(target, rows, True), rows_of(alpha, rows, False)
    out = soft_launch(lib, packed, lay, cfg, 3, block_t, block_a, zero_map, rows)
    again = soft_launch(lib, packed, lay, cfg, 3, block_t, block_a, zero_map, rows)
    assert all(np.array_equal(a, b) for a, b in zip(out, again))
    ref_loss, ref_grad, ref_acot = gradkernel.render_soft_loss_and_grad_plain(
        torch.from_numpy(packed), scene, camera, cfg, 3, torch.from_numpy(block_t),
        torch.from_numpy(block_a), zero_map, rows=rows)
    np.testing.assert_allclose(out[0], float(ref_loss), rtol=1e-6)
    assert_grad_close(out[1], ref_grad.numpy())
    assert_grad_close(out[2], ref_acot.numpy())


@pytest.mark.parametrize("name,views,bounces,rows,frozen", [
    ("tiger", VIEWS_1, 4, None, True),
    ("hypercube", VIEWS_1, 4, (3, 9), False),
    ("duocylinder", tcam.VIEWS_ALL, 4, None, False),
    ("cylinders", VIEWS_1, 3, None, False),
    ("sphere_composites", VIEWS_1, 4, None, False),
    ("sphere_composites", VIEWS_1, 4, None, True),
], ids=["tiger_library", "hypercube_row_block", "duocylinder_3view", "cylinders_generic",
        "sphere_beside_composites", "sphere_beside_composites_frozen"])
def test_composite_soft_launch_matches_autograd(lib, name, views, bounces, rows, frozen):
    """K6's launch over the composite folds, its row b the scene with the
    object zeroed by its radii (0, the hypercube's -1), swept whole: the
    tiger under its frozen hints at the main bounce count (its library
    instance), the hypercube on a row block and the duocylinder on 3 views
    unhinted (the generic composite fold), the two cylinders at 3 bounces
    (the generic fold's rolled instance), the turned one zeroed. A sphere
    in front of a hypercube and a tiger, the soft object, unhinted and
    under the frozen hints: the composite fold with a sample-level split,
    row a's sweep carrying row b's cotangent where the sphere is not the
    primary hit (zero_map_object). Against
    autograd over the plain blend (loss rtol 1e-6, gradient and alpha
    cotangent the mixed-scale 1e-3 with the composites' pattern floor),
    every output finite, bitwise across two launches."""
    cfg = config_for(name, reflections_amount=bounces)
    scene, camera = grad_scene(name), camera_of(views)
    hints = launch_args(scene, camera, cfg)
    if frozen:
        cfg, hints, _ = frozen_hints(scene, camera, cfg)
    rows = rows or (0, cfg.height)
    rng = np.random.default_rng(5)
    target = rng.uniform(0, 1, (*image_shape(views, cfg), 3)).astype(np.float32)
    alpha = rng.uniform(0, 1, image_shape(views, cfg)).astype(np.float32)
    lay = params.layout(scene, camera)
    zero_map = params.soft_zero_map(scene, camera, SOFT_REFS[name])
    packed = params.pack(scene, camera).numpy()
    block_t, block_a = rows_of(target, rows, True), rows_of(alpha, rows, False)
    out = soft_launch(lib, packed, lay, cfg, 3, block_t, block_a, zero_map, rows, hints)
    again = soft_launch(lib, packed, lay, cfg, 3, block_t, block_a, zero_map, rows, hints)
    assert all(np.array_equal(a, b) for a, b in zip(out, again))
    assert all(np.isfinite(x).all() for x in out)
    ref_loss, ref_grad, ref_acot = gradkernel.render_soft_loss_and_grad_plain(
        torch.from_numpy(packed), scene, camera, cfg, 3, torch.from_numpy(block_t),
        torch.from_numpy(block_a), zero_map, rows=rows)
    np.testing.assert_allclose(out[0], float(ref_loss), rtol=1e-6)
    assert_grad_close(out[1], ref_grad.numpy(), pattern_floor(scene))
    assert_grad_close(out[2], ref_acot.numpy())


def test_soft_launch_refuses_a_long_zero_map(lib):
    """K6 holds at most FOURD_K6_MAX_ZERO_SLOTS zero-map slots: a map of
    one more is refused (cudaErrorInvalidValue), never cut, and the
    wrapper raises before it launches; the hypercube's 9 slots fit."""
    cfg = config(reflections_amount=2, width=8, height=4)
    scene, camera = library.hypercube(CPU), camera_of(VIEWS_1)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    zero_map = list(params.soft_zero_map(scene, camera, ("hypercube", None)))
    longer = zero_map + [(lay.spaces + k, 0.5)
                         for k in range(gradkernel.MAX_ZERO_SLOTS + 1 - len(zero_map))]
    assert len(zero_map) == 9 and len(longer) == gradkernel.MAX_ZERO_SLOTS + 1
    target = np.zeros((cfg.height, cfg.width, 3), np.float32)
    alpha = np.full((cfg.height, cfg.width), 0.5, np.float32)
    args = (lib, packed, lay, cfg, 3, target, alpha)
    hints = launch_args(scene, camera, cfg)
    loss, grad, _ = soft_launch(*args, longer[:-1], (0, cfg.height), hints)
    assert np.isfinite(loss) and np.isfinite(grad).all()
    with pytest.raises(AssertionError, match="assert 1 == 0"):  # cudaErrorInvalidValue
        soft_launch(*args, longer, (0, cfg.height), hints)
    with pytest.raises(ValueError, match="zero map"):
        gradkernel.check_zero_map(longer, lay)
