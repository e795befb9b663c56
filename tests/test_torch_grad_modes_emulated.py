"""The gradient launches over K1's other configurations (csrc/gradmodes.cu,
softmodes.cu: K4, K5 and K6 with the kepler and newton samplers, the
literal spec and trig folds, and the fast fold over a hypercube without
generators), compiled for the host and run by the CPU stand-in for the
card of tests/test_torch_emulated_runtime.py (EMU), against torch
autograd over the plain pipeline.

g++ builds gradmodes.cu and softmodes.cu alone behind EMU (their launches
size their partials themselves; the wrappers ask gradkernel.cu's
fourd_grad_scratch_cols, here ``scratch_cols``). Every library scene and
the hypercube built from its cells alone runs K4, K5 and K6 in one
configuration each, in turn, so that each kernel runs each configuration
on one or two scenes (a launch costs the stand-in a summing block of 256
threads per packed float, 63 to 272 of them; the card runs every
configuration on every scene, phase 8c), with the tolerances of the
production launches' emulated tests: the loss within rtol 1e-6 of
loss_and_grad_plain's, every gradient and K6's alpha cotangent within the
mixed-scale relative error 1e-3 with the same non-zero pattern (the
composites' pattern floor); the launches are bitwise across two calls
(test_row_block_is_its_rows_part, the contract test). The kepler and
newton samplers and the trig fold call glibc's expf, logf, sinf, cosf,
acosf and asinf here and torch's own vectorized versions in the plain
version: the light is piecewise constant in the geometry, so an ulp apart
moves no hit at these shapes, and the loss stays within its bound. The
card's own runs are chip_smoke.py's phase 8c.
"""
import ctypes

import numpy as np
import pytest
import torch

from fourd_ray_tracing_tpu_torch import diff
from fourd_ray_tracing_tpu_torch.models import library, params, renderer
from fourd_ray_tracing_tpu_torch.ops.cuda import build, gradkernel, megakernel

from test_torch_adjoint_host import assert_grad_close, camera_of, pattern_floor, ptr
from test_torch_forward_launch_emulated import bare
from test_torch_emulated_runtime import SOFT_REFS, emulated_library

CPU = torch.device("cpu")
VIEWS_1 = ("yxz",)
SHAPE = dict(width=32, height=16, samples=2, reflections_amount=3, rng_mode="per_sample",
             light_coefficient=0.7)
SEEDS = np.array([0x12345678, 9], np.uint32)
# The configurations off the production one: (sampler_method, intersect).
CONFIGS = [("kepler", "fast"), ("newton", "fast"), ("poly", "spec"), ("poly", "trig")]
CONFIG_IDS = ["kepler", "newton", "spec", "trig"]
SCENES = sorted(library.SCENES) + ["hypercube_cells"]
ENTRIES = ("fourd_loss_grad_modes", "fourd_light_vjp_modes", "fourd_soft_loss_grad_modes")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    so = emulated_library(tmp_path_factory.mktemp("grad_modes_emulated"),
                          ("gradmodes.cu", "softmodes.cu"))
    return build.bind(ctypes.CDLL(str(so)), ENTRIES)


def scene_of(name):
    return bare(library.hypercube(CPU)) if name == "hypercube_cells" else library.SCENES[name](CPU)


def config(sampler="poly", intersect="fast", **kw):
    return renderer.RenderConfig(**dict(SHAPE, sampler_method=sampler, intersect=intersect,
                                        **dict(dict(sampler_iters=3), **kw)))


def f32(x):
    return float(np.float32(x))


def scratch_cols(lay, cfg, n_rows, n_frames=1):
    """fourd_grad_scratch_cols: the pixel blocks of 64 threads, per frame."""
    return -(-lay.n_views * n_rows * cfg.width // 64) * n_frames


def codes(cfg):
    fold, sampler, _, iters = megakernel.mode_codes(cfg)
    return fold, sampler, iters


def descriptor(lay, cfg):
    """The launch's descriptor (gradkernel.launch_words: never None off the
    production configuration), kept alive by the caller."""
    return gradkernel.launch_words(lay, cfg)


def loss_grad(lib, packed, lay, cfg, seeds, target, rows=None, keep=None):
    row0, n_rows = rows or (0, cfg.height)
    table = (ctypes.c_int * len(lay))(*lay)
    n_cols = scratch_cols(lay, cfg, n_rows, len(seeds))
    g_mean = np.zeros((len(seeds), *target.shape), np.float32)
    grad_parts = np.zeros((lay.size, n_cols), np.float32)
    loss_parts = np.zeros(n_cols, np.float64)
    grad, loss = np.zeros(lay.size, np.float32), np.zeros(1, np.float32)
    words = descriptor(lay, cfg)
    err = lib.fourd_loss_grad_modes(
        *codes(cfg), ptr(packed), ptr(seeds), len(seeds), 1, ctypes.addressof(table), cfg.width,
        cfg.height, row0, n_rows, cfg.samples, cfg.reflections_amount, f32(cfg.small_indent),
        f32(cfg.light_coefficient), ptr(target),
        f32(1.0 / (len(seeds) * target.size // n_rows * cfg.height)), ptr(g_mean),
        ptr(grad_parts), ptr(loss_parts), ptr(grad), ptr(loss), ctypes.addressof(words),
        None if keep is None else ptr(keep), None)
    assert err == 0
    return loss[0], grad


def light_vjp(lib, rows, lay, cfg, cot):
    table = (ctypes.c_int * len(lay))(*lay)
    n_cols = scratch_cols(lay, cfg, cfg.height)
    grad_parts = np.zeros((len(rows) * lay.size, n_cols), np.float32)
    grad = np.zeros((len(rows), lay.size), np.float32)
    words = descriptor(lay, cfg)
    err = lib.fourd_light_vjp_modes(
        *codes(cfg), ptr(rows), lay.size, len(rows), 9, ctypes.addressof(table), cfg.width,
        cfg.height, 0, cfg.height, cfg.samples, cfg.reflections_amount, f32(cfg.small_indent),
        ptr(cot), ptr(grad_parts), ptr(grad), ctypes.addressof(words), None, None)
    assert err == 0
    return grad


def soft(lib, packed, lay, cfg, target, alpha, zero_map):
    table = (ctypes.c_int * len(lay))(*lay)
    n_cols = scratch_cols(lay, cfg, cfg.height, 2)
    slots = (ctypes.c_int * len(zero_map))(*(i for i, _ in zero_map))
    values = (ctypes.c_float * len(zero_map))(*(v for _, v in zero_map))
    sums = np.zeros((2, *target.shape), np.float32)
    row_b = np.zeros(alpha.shape, np.uint32)
    grad_parts = np.zeros((lay.size, n_cols), np.float32)
    loss_parts = np.zeros(n_cols, np.float64)
    grad, loss = np.zeros(lay.size, np.float32), np.zeros(1, np.float32)
    alpha_cot = np.zeros(alpha.shape, np.float32)
    words = descriptor(lay, cfg)
    err = lib.fourd_soft_loss_grad_modes(
        *codes(cfg), ptr(packed), 3, ctypes.addressof(table), len(zero_map),
        ctypes.addressof(slots), ctypes.addressof(values), cfg.width, cfg.height, 0, cfg.height,
        cfg.samples, cfg.reflections_amount, f32(cfg.small_indent), f32(cfg.light_coefficient),
        ptr(target), ptr(alpha), f32(1.0 / target.size), ptr(sums), ptr(row_b), ptr(grad_parts),
        ptr(loss_parts), ptr(grad), ptr(loss), ptr(alpha_cot), ctypes.addressof(words), None,
        None)
    assert err == 0
    return loss[0], grad, alpha_cot


def target_of(cfg, seed=4):
    return np.random.default_rng(seed).uniform(0, 1, (cfg.height, cfg.width, 3)).astype(np.float32)


# Scene k takes configuration k (mod 4) in K4, k + 1 in K5 and k + 2 in K6,
# so that each kernel runs each configuration on one or two scenes.
def config_of(name, kernel):
    """(sampler, intersect) of scene ``name`` in ``kernel`` (0 K4, 1 K5, 2 K6)."""
    return CONFIGS[(SCENES.index(name) + kernel) % 4]


K4_CASES = [(name, *config_of(name, 0)) for name in SCENES]


@pytest.mark.parametrize("name,sampler,intersect", K4_CASES,
                         ids=[f"{n}-{s if s != 'poly' else f}" for n, s, f in K4_CASES])
def test_loss_grad_modes_match_autograd(lib, name, sampler, intersect):
    """K4 over two frames against loss_and_grad_plain."""
    cfg = config(sampler, intersect)
    scene, camera = scene_of(name), camera_of(VIEWS_1)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    target = target_of(cfg)
    loss, grad = loss_grad(lib, packed, lay, cfg, SEEDS, target)
    ref_loss, ref_grad = gradkernel.loss_and_grad_plain(
        torch.from_numpy(packed), scene, camera, cfg, SEEDS, torch.from_numpy(target))
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-6)
    assert_grad_close(grad, ref_grad.numpy(), pattern_floor(scene))


def test_cells_only_hypercube_in_the_production_modes(lib):
    """The fast fold with the poly sampler over a hypercube without
    generators (CellsFold): its cells' slots take the gradient, each cell hit
    differentiated through its literal test."""
    cfg = config()
    scene, camera = scene_of("hypercube_cells"), camera_of(VIEWS_1)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    assert not megakernel.production(cfg, lay) and lay.hypercube_cells
    target = target_of(cfg)
    loss, grad = loss_grad(lib, packed, lay, cfg, SEEDS, target)
    ref_loss, ref_grad = gradkernel.loss_and_grad_plain(
        torch.from_numpy(packed), scene, camera, cfg, SEEDS, torch.from_numpy(target))
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-6)
    assert_grad_close(grad, ref_grad.numpy(), pattern_floor(scene))
    cells = slice(lay.hypercube, lay.hypercube + 8 * 26)
    assert np.abs(grad[cells]).max() > 0


@pytest.mark.parametrize("name", SCENES)
def test_light_vjp_modes_match_autograd(lib, name):
    """K5 against render_light_vjp_plain: over two params rows (the scene
    and a copy with its floor moved) on the scenes of at most 100 packed
    floats, over one row on the others (K5's summing blocks are rows x P
    on the stand-in)."""
    scene, camera = scene_of(name), camera_of(VIEWS_1)
    lay = params.layout(scene, camera)
    floor = scene.spaces[0]
    moved = scene._replace(spaces=(floor._replace(point=floor.point._replace(
        z=floor.point.z - 0.25)), *scene.spaces[1:]))
    scenes = [scene, moved] if lay.size <= 100 else [scene]
    rows = params.stack_rows(scenes, camera).numpy()
    cfg = config(*config_of(name, 1))
    cot = np.random.default_rng(7).normal(0, 1, (len(scenes), cfg.height, cfg.width, 3))
    cot = cot.astype(np.float32)
    grad = light_vjp(lib, rows, lay, cfg, cot)
    ref = gradkernel.render_light_vjp_plain(torch.from_numpy(rows), scene, camera, cfg, 9,
                                            torch.from_numpy(cot)).numpy()
    assert_grad_close(grad, ref, pattern_floor(scene))


@pytest.mark.parametrize("name", SCENES)
def test_soft_modes_match_autograd(lib, name):
    """K6 with the scene's soft object zeroed in row b (a sphere's radius
    0; a composite's radii 0, the hypercube's -1): under the fast fold with
    a sphere object row a's sweep carries row b where bounce 0 misses it,
    under the literal folds both rows are swept whole. Against
    render_soft_loss_and_grad_plain, every output finite."""
    scene, camera = scene_of(name), camera_of(VIEWS_1)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    ref_obj = SOFT_REFS["hypercube" if name == "hypercube_cells" else name]
    zero_map = params.soft_zero_map(scene, camera, ref_obj)
    cfg = config(*config_of(name, 2))
    rng = np.random.default_rng(5)
    target = rng.uniform(0, 1, (cfg.height, cfg.width, 3)).astype(np.float32)
    alpha = rng.uniform(0, 1, (cfg.height, cfg.width)).astype(np.float32)
    out = soft(lib, packed, lay, cfg, target, alpha, zero_map)
    assert all(np.isfinite(x).all() for x in out)
    ref_loss, ref_grad, ref_acot = gradkernel.render_soft_loss_and_grad_plain(
        torch.from_numpy(packed), scene, camera, cfg, 3, torch.from_numpy(target),
        torch.from_numpy(alpha), zero_map)
    np.testing.assert_allclose(out[0], float(ref_loss), rtol=1e-6)
    assert_grad_close(out[1], ref_grad.numpy(), pattern_floor(scene))
    assert_grad_close(out[2], ref_acot.numpy())


@pytest.mark.parametrize("name", ["room_with_sphere", "tiger"])
def test_kepler_under_the_contract_keeps_the_unhinted_values(lib, name):
    """The fast fold's kepler launch under with_frozen_hints (the hinted
    AnyFold and CompFold): the loss bitwise the unhinted launch's, every
    kept slot equal, the frozen ones 0; a trig launch under
    with_frozen_hints carries no hints, and is the unhinted launch."""
    scene, camera = scene_of(name), camera_of(VIEWS_1)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    target = target_of(config())
    cfg = config("kepler")
    hcfg = diff.with_frozen_hints(cfg, scene)
    keep = params.freeze_mask(hcfg, scene, lay.size).numpy()
    loss_h, grad_h = loss_grad(lib, packed, lay, hcfg, SEEDS, target, keep=keep)
    loss_u, grad_u = loss_grad(lib, packed, lay, cfg, SEEDS, target)
    frozen = keep == 0
    assert loss_h == loss_u and frozen.any()
    assert np.array_equal(grad_h[~frozen], grad_u[~frozen]) and np.all(grad_h[frozen] == 0.0)
    trig = config("newton", "trig")
    htrig = diff.with_frozen_hints(trig, scene)
    assert params.freeze_mask(htrig, scene, lay.size) is None
    assert not megakernel.hinted(htrig)
    a = loss_grad(lib, packed, lay, htrig, SEEDS, target)
    b = loss_grad(lib, packed, lay, trig, SEEDS, target)
    assert a[0] == b[0] and np.array_equal(a[1], b[1])


def test_row_block_is_its_rows_part(lib):
    """K4 in trig on the tiger over a block of rows (K3's sharded launch)
    against its plain rows; bitwise across two launches."""
    cfg = config("newton", "trig")
    scene, camera = scene_of("tiger"), camera_of(VIEWS_1)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    rows = (3, 9)
    target = np.ascontiguousarray(target_of(cfg)[3:12])
    loss, grad = loss_grad(lib, packed, lay, cfg, SEEDS, target, rows)
    again = loss_grad(lib, packed, lay, cfg, SEEDS, target, rows)
    assert loss == again[0] and np.array_equal(grad, again[1])
    ref_loss, ref_grad = gradkernel.loss_and_grad_plain(
        torch.from_numpy(packed), scene, camera, cfg, SEEDS, torch.from_numpy(target), rows=rows)
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-6)
    assert_grad_close(grad, ref_grad.numpy(), pattern_floor(scene))


def test_modes_launches_refuse_what_they_do_not_take(lib):
    """cudaErrorInvalidValue (1) for a fold or sampler code out of range,
    more than 16 Halley steps, no descriptor, and a literal fold handed a
    hinted descriptor."""
    cfg = config("kepler")
    scene, camera = scene_of("room_with_sphere"), camera_of(VIEWS_1)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    target = target_of(cfg)
    table = (ctypes.c_int * len(lay))(*lay)
    n_cols = scratch_cols(lay, cfg, cfg.height, 1)
    scratch = [np.zeros((1, *target.shape), np.float32), np.zeros((lay.size, n_cols), np.float32),
               np.zeros(n_cols, np.float64), np.zeros(lay.size, np.float32),
               np.zeros(1, np.float32)]
    seeds = SEEDS[:1]
    hinted = megakernel.hint_table(diff.with_frozen_hints(cfg, scene), lay)
    unhinted = megakernel.hint_table(cfg, lay)

    def call(fold, sampler, iters, words):
        return lib.fourd_loss_grad_modes(
            fold, sampler, iters, ptr(packed), ptr(seeds), 1, 1, ctypes.addressof(table),
            cfg.width,
            cfg.height, 0, cfg.height, cfg.samples, cfg.reflections_amount,
            f32(cfg.small_indent), f32(cfg.light_coefficient), ptr(target), 1.0,
            *map(ptr, scratch), None if words is None else ctypes.addressof(words), None, None)

    assert call(0, 1, 3, unhinted) == 0 and call(0, 1, 3, hinted) == 0
    assert call(1, 0, 0, unhinted) == 0
    for args in ((3, 0, 0, unhinted), (0, 3, 0, unhinted), (0, 1, 17, unhinted),
                 (0, 1, 3, None), (1, 0, 0, hinted), (2, 2, 0, hinted)):
        assert call(*args) == 1, args


def test_launch_words_and_shapes_of_the_modes():
    """Off the production configuration every launch takes a descriptor
    (gradkernel.launch_words): a literal fold's holds no hints (n_singles
    -1) but the composites' offsets, a cells-only hypercube the axis hint
    CUBE_CELLS; launch_shapes sizes the fold table after the params from
    it, as the modes kernels read it."""
    scene, camera = scene_of("tiger"), camera_of(VIEWS_1)
    lay = params.layout(scene, camera)
    for cfg in (config("poly", "trig"), diff.with_frozen_hints(config("poly", "spec"), scene)):
        words = gradkernel.launch_words(lay, cfg)
        assert words[1] == -1 and words[build.HINT_COMPOSITES + 4] == lay.tiger
        sweep = gradkernel.launch_shapes(lay, cfg)["sweep_kernel"][1]
        assert sweep == megakernel.shared_bytes(lay, words) + 4 * gradkernel.GRAD_PITCH * lay.size
    cells = scene_of("hypercube_cells")
    c_lay = params.layout(cells, camera)
    words = gradkernel.launch_words(c_lay, config("kepler"))
    assert words[build.HINT_COMPOSITES + 5 + build.MAX_CYLINDERS + 2] == megakernel.CUBE_CELLS
    room = scene_of("room_with_sphere")
    r_lay = params.layout(room, camera)
    assert gradkernel.launch_words(r_lay, config()) is None
    assert gradkernel.launch_words(r_lay, config("newton"))[1] == -1


def test_each_launch_reads_its_own_sampler(lib):
    """The sampler travels in each launch's descriptor (trace.cuh
    sampler_slot): on the tiger, launches in kepler with 0 and with 3
    Halley steps and in newton, in turns, each match their own plain
    version and are bitwise across the turns; kepler's cube-root seed alone
    (0 steps) moves the loss far beyond the bound, so a launch that read
    another's sampler would fail."""
    scene, camera = scene_of("tiger"), camera_of(VIEWS_1)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    cfgs = [config("kepler", sampler_iters=0), config("kepler"), config("newton")]
    target = target_of(cfgs[0])
    first = [loss_grad(lib, packed, lay, c, SEEDS, target) for c in cfgs]
    again = [loss_grad(lib, packed, lay, c, SEEDS, target) for c in reversed(cfgs)][::-1]
    plain = []
    for c, (loss, grad), (loss2, grad2) in zip(cfgs, first, again):
        assert loss == loss2 and np.array_equal(grad, grad2)
        ref_loss, ref_grad = gradkernel.loss_and_grad_plain(
            torch.from_numpy(packed), scene, camera, c, SEEDS, torch.from_numpy(target))
        np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-6)
        assert_grad_close(grad, ref_grad.numpy(), pattern_floor(scene))
        plain.append(float(ref_loss))
    assert abs(plain[0] - plain[1]) > 1e-4 * abs(plain[1])


@pytest.mark.parametrize("name", ["room_with_sphere", "hypercube", "hypercube_cells"])
@pytest.mark.parametrize("sampler,intersect", CONFIGS, ids=CONFIG_IDS)
def test_modes_occupancy_query_takes_the_launch_s_sweep(lib, name, sampler, intersect):
    """fourd_loss_grad_modes_occupancy answers for the sweep that
    fourd_loss_grad_modes runs: at launch_shapes' sweep bytes (the
    stand-in's query gives 1 block a SM)."""
    build.bind(lib, ("fourd_loss_grad_modes_occupancy",))
    cfg = config(sampler, intersect, reflections_amount=4)
    scene, camera = scene_of(name), camera_of(VIEWS_1)
    lay = params.layout(scene, camera)
    out = (ctypes.c_int * 2)()
    err = lib.fourd_loss_grad_modes_occupancy(*codes(cfg), (ctypes.c_int * len(lay))(*lay), 4,
                                              descriptor(lay, cfg), out)
    assert err == 0
    assert list(out) == [1, gradkernel.launch_shapes(lay, cfg)["sweep_kernel"][1]]
