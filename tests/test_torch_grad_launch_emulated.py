"""The gradient launches themselves (csrc/gradkernel.cu: K4 and K5 with
their pass-1 kernel, sweeps, warp schedules and fixed-order reductions, and
their composite folds, gradcomposite.cu), compiled for the host and run by
the CPU stand-in for the card (tests/test_torch_emulated_runtime.py, EMU),
against torch autograd over the plain pipeline.

tests/test_torch_adjoint_host.py holds the per-pixel math; this file
holds what only the kernels do: the blocks' shared memory, the per-thread
columns and their reduction, sum_parts_kernel; and what every launch
refuses. K6's launches are tests/test_torch_soft_launch_emulated.py's, the
launches under the freeze_hints contract
tests/test_torch_hinted_launch_emulated.py's. The card's own runs are
chip_smoke.py's phases 8, 11, 12 and 14.
"""
import ctypes

import numpy as np
import pytest
import torch

from fourd_ray_tracing_tpu_torch import diff
from fourd_ray_tracing_tpu_torch.models import library, params
from fourd_ray_tracing_tpu_torch.models import scene as tscene
from fourd_ray_tracing_tpu_torch.ops.cuda import build, gradkernel

from test_torch_adjoint_host import (assert_grad_close, camera_of, grad_scene, pattern_floor,
                                     ptr, second_row)
from test_torch_emulated_runtime import (CPU, GRAD_ENTRIES, GRAD_SOURCES, VIEWS_1, assert_contract,
                                         config, config_for, emulated_library, f32, frozen_hints,
                                         launch_args, layout_table, light_vjp_launch,
                                         loss_grad_launch, rows_of, scratch_cols, soft_launch)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build.bind(ctypes.CDLL(str(emulated_library(
        tmp_path_factory.mktemp("grad_launch_emulated"), GRAD_SOURCES))), GRAD_ENTRIES)


@pytest.mark.parametrize("name,bounces,rows", [
    ("room_with_sphere", 4, None), ("duocylinder", 4, None), ("tiger", 4, None),
    ("hypercube", 3, None), ("cylinders", 4, None), ("tiger", 4, (3, 9))],
    ids=["room", "duocylinder", "tiger", "hypercube_generic", "cylinders", "tiger_row_block"])
def test_loss_grad_launch_matches_autograd(lib, name, bounces, rows):
    """K4's launch over two frames (its pass-1 kernel with the loss
    reduction, the sweep over frame rows, sum_parts) against
    loss_and_grad_plain; a scene with composites unhinted, through the
    generic composite fold (its descriptor: n_singles -1, no axis hint);
    ``rows`` a row block (K3's sharded launch) against its plain rows."""
    cfg = config_for(name, reflections_amount=bounces)
    scene, camera = grad_scene(name), camera_of(VIEWS_1)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    target = np.random.default_rng(4).uniform(0, 1, (cfg.height, cfg.width, 3)).astype(np.float32)
    if rows is not None:
        target = rows_of(target, rows, True)
    seeds = np.array([0x12345678, 9], np.uint32)
    loss, grad = loss_grad_launch(lib, packed, lay, cfg, seeds, target,
                                  launch_args(scene, camera, cfg), rows)
    ref_loss, ref_grad = gradkernel.loss_and_grad_plain(
        torch.from_numpy(packed), scene, camera, cfg, seeds, torch.from_numpy(target), rows=rows)
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-6)
    assert_grad_close(grad, ref_grad.numpy(), pattern_floor(scene))


@pytest.mark.parametrize("name,bounces,split", [
    ("room_with_sphere", 4, 4), ("room_with_sphere", 3, 3), ("tiger", 4, 4), ("hypercube", 4, 2)],
    ids=["room", "room_generic_uneven", "tiger", "hypercube"])
def test_split_loss_grad_launch_matches_autograd(lib, name, bounces, split):
    """K4's launch with its sweep split into ``split`` sample chunks a pixel
    (3: chunks of 1, 1 and 2 of 4 samples) over two frames: every chunk's
    blocks write their own columns of the partials (frame-major, then
    chunk, then block); within the file's bound of autograd and bitwise
    across two launches; its loss bitwise the whole-pixel launch's (pass 1
    and the loss sum are not split), its gradient within float
    re-association of that launch's."""
    cfg = config_for(name, reflections_amount=bounces, samples=4, width=32, height=16)
    scene, camera = grad_scene(name), camera_of(VIEWS_1)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    target = np.random.default_rng(4).uniform(0, 1, (cfg.height, cfg.width, 3)).astype(np.float32)
    seeds = np.array([0x12345678, 9], np.uint32)
    args = (lib, packed, lay, cfg, seeds, target, launch_args(scene, camera, cfg))
    loss, grad, parts = loss_grad_launch(*args, split=split, scratch=True)
    again = loss_grad_launch(*args, split=split)
    whole_loss, whole = loss_grad_launch(*args)
    chunks = parts.reshape(lay.size, len(seeds), split, -1)
    assert chunks.shape[-1] == scratch_cols(lib, layout_table(lay), cfg, cfg.height, 1)
    assert all((chunks[:, f, c] != 0).any() for f in range(len(seeds)) for c in range(split))
    assert loss == again[0] and np.array_equal(grad, again[1])
    assert loss == whole_loss
    scale = np.maximum(np.abs(whole), 1e-3 * np.abs(whole).max())
    assert (np.abs(grad - whole) / scale).max() < 1e-5
    ref_loss, ref_grad = gradkernel.loss_and_grad_plain(
        torch.from_numpy(packed), scene, camera, cfg, seeds, torch.from_numpy(target))
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-6)
    assert_grad_close(grad, ref_grad.numpy(), pattern_floor(scene))


def test_sweep_split_reads_the_launch_bound_of_the_build(lib):
    """fourd_grad_min_blocks returns the blocks a SM that the sweeps'
    launch bounds ask for (reduce.cuh kGradMinBlocks), and at the train
    cells' 568 blocks on an H100's 132 SMs the split it gives is 4."""
    build.bind(lib, ("fourd_grad_min_blocks",))
    min_blocks = lib.fourd_grad_min_blocks()
    assert min_blocks == 4
    assert gradkernel.sweep_split(568, 132, 100, min_blocks) == 4


def test_launch_refuses_a_split_the_grid_cannot_hold(lib):
    """A split below 1, or one whose frames x split rows pass a grid's
    65535, is refused (cudaErrorInvalidValue) before any kernel runs."""
    cfg = config(width=8, height=4)
    scene, camera = grad_scene("room_with_sphere"), camera_of(VIEWS_1)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    target = np.zeros((cfg.height, cfg.width, 3), np.float32)
    seeds = np.array([1, 2], np.uint32)
    for split in (0, 32768):
        with pytest.raises(AssertionError, match="assert 1 == 0"):
            loss_grad_launch(lib, packed, lay, cfg, seeds, target, split=split)
    assert loss_grad_launch(lib, packed, lay, cfg, seeds, target, split=5)[0] > 0.0


@pytest.mark.parametrize("name", ["room_with_sphere", "duocylinder", "tiger", "cylinders"])
def test_light_vjp_launch_matches_autograd(lib, name):
    """K5's launch over two params rows (the scene and its zero_object
    copy, as the soft pair sends them; a scene with composites and a copy
    with its floor moved, unhinted) against render_light_vjp_plain."""
    cfg = config_for(name)
    scene, camera = grad_scene(name), camera_of(VIEWS_1)
    lay = params.layout(scene, camera)
    rows = params.stack_rows([scene, second_row(scene)], camera).numpy()
    cot = np.random.default_rng(7).normal(0, 1, (2, cfg.height, cfg.width, 3)).astype(np.float32)
    grad = light_vjp_launch(lib, rows, lay, cfg, cot, launch_args(scene, camera, cfg))
    ref = gradkernel.render_light_vjp_plain(torch.from_numpy(rows), scene, camera, cfg, 9,
                                            torch.from_numpy(cot)).numpy()
    assert_grad_close(grad, ref, pattern_floor(scene))


def test_launches_refuse_composite_hints(lib):
    """Once refused by K6, now taken by every gradient launch: the tiger's
    descriptor under the contract goes to K4's, K5's, K6's and K8's
    composite folds. K6 takes it with the tiger's own zero map and with a
    map that names no radius (wall 0's color: both rows keep the tiger),
    each with a finite loss and gradient, the frozen slots 0."""
    cfg = config(reflections_amount=2, width=8, height=4)
    scene, camera = library.tiger(CPU), camera_of(VIEWS_1)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    hcfg, (words, keep), _ = frozen_hints(scene, camera, cfg)
    target = np.zeros((cfg.height, cfg.width, 3), np.float32)
    table = layout_table(lay)
    loss_parts = np.zeros(scratch_cols(lib, table, cfg, cfg.height), np.float64)
    value = np.zeros(1, np.float32)
    err = lib.fourd_ablate_launch(
        0, ptr(packed), 3, ctypes.addressof(table), cfg.width, cfg.height, cfg.samples,
        cfg.reflections_amount, f32(cfg.small_indent), f32(cfg.light_coefficient), ptr(target),
        ptr(loss_parts), ptr(value), ctypes.addressof(words), None)
    assert err == 0 and value[0] > 0.0
    cot = np.ones((1, cfg.height, cfg.width, 3), np.float32)
    grad_parts = np.zeros((lay.size, scratch_cols(lib, table, cfg, cfg.height)), np.float32)
    grad = np.zeros((1, lay.size), np.float32)
    err = lib.fourd_light_vjp_launch(
        ptr(packed), 0, 1, 9, ctypes.addressof(table), cfg.width, cfg.height, 0, cfg.height,
        cfg.samples, cfg.reflections_amount, f32(cfg.small_indent), ptr(cot), ptr(grad_parts),
        ptr(grad), ctypes.addressof(words), ptr(keep), None)
    assert err == 0 and np.abs(grad).max() > 0.0
    loss, grad = loss_grad_launch(lib, packed, lay, hcfg, np.array([3], np.uint32), target,
                                  (words, keep))
    assert loss > 0.0 and np.abs(grad).max() > 0.0
    alpha = np.full((cfg.height, cfg.width), 0.5, np.float32)
    for zero_map in (params.soft_zero_map(scene, camera, ("tiger", None)),
                     [(lay.spaces + 10, 0.25)]):
        loss, grad, alpha_cot = soft_launch(lib, packed, lay, hcfg, 3, target, alpha, zero_map,
                                            (0, cfg.height), (words, keep))
        assert loss > 0.0 and np.abs(grad).max() > 0.0 and np.isfinite(alpha_cot).all()
        assert np.all(grad[keep == 0] == 0.0)


def test_many_planes_launch_writes_the_frozen_slots(lib):
    """The hint cap: room_with_sphere with 57 more floor planes (65
    hyperplanes, more than the table holds hints for) under the contract.
    The wrapper's rule of the plane count gives it no descriptor (the
    unhinted fold) and the mask of all 260 normal slots. Its 895 packed
    floats are more than the gradient kernels hold (build.K4_MAX_PARAMS):
    the launch refuses it (cudaErrorInvalidValue) and the wrapper raises
    first. K4's plain version under the contract: the loss and every kept
    slot the unhinted plain gradient's, the frozen slots 0."""
    from test_torch_freeze_hints import many_planes

    cfg = config(width=16, height=8)
    scene, camera = many_planes(tscene, CPU), camera_of(VIEWS_1)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    hcfg, hints, frozen = frozen_hints(scene, camera, cfg)
    assert hcfg.plane_hints is not None and hints[0] is None and frozen.sum() == 4 * 65
    assert lay.size > gradkernel.MAX_PARAMS
    target = np.random.default_rng(4).uniform(0, 1, (cfg.height, cfg.width, 3)).astype(np.float32)
    seeds = np.array([0x12345678, 9], np.uint32)
    with pytest.raises(AssertionError, match="assert 1 == 0"):  # cudaErrorInvalidValue
        loss_grad_launch(lib, packed, lay, hcfg, seeds, target, hints)
    with pytest.raises(ValueError, match="packed parameters"):
        gradkernel.check_shape(lay, hcfg)
    args = (torch.from_numpy(packed), scene, camera)
    loss, grad = gradkernel.loss_and_grad_plain(*args, hcfg, seeds, torch.from_numpy(target))
    loss_u, grad_u = gradkernel.loss_and_grad_plain(*args, cfg, seeds, torch.from_numpy(target))
    assert torch.equal(loss, loss_u)
    assert_contract(grad.numpy(), grad_u.numpy(), frozen)


@pytest.mark.parametrize("name", ["room_with_sphere", "tiger", "hypercube", "sphere_plane_light"])
@pytest.mark.parametrize("hinted", [True, False], ids=["frozen", "unhinted"])
def test_occupancy_query_takes_the_launch_s_sweep(lib, name, hinted):
    """fourd_loss_grad_occupancy answers for the sweep that
    fourd_loss_grad_launch runs at that layout, bounce count and descriptor:
    at its dynamic shared memory, launch_shapes' sweep bytes (the stand-in's
    query gives 1 block a SM); a descriptor the launch refuses, it refuses."""
    build.bind(lib, ("fourd_loss_grad_occupancy",))
    cfg = config_for(name, reflections_amount=4)
    scene, camera = grad_scene(name), camera_of(VIEWS_1)
    cfg = diff.with_frozen_hints(cfg, scene) if hinted else cfg
    lay = params.layout(scene, camera)
    words = gradkernel.launch_words(lay, cfg)
    out = (ctypes.c_int * 2)()
    assert lib.fourd_loss_grad_occupancy(layout_table(lay), 4, words, out) == 0
    assert list(out) == [1, gradkernel.launch_shapes(lay, cfg)["sweep_kernel"][1]]
    assert lib.fourd_loss_grad_occupancy(layout_table(lay), gradkernel.MAX_BOUNCES + 1, words,
                                         out) != 0
