"""The forward kernel's launch itself (csrc/megakernel.cu: K1, its row
stride K2 and its row offset K3, with and without the static hints),
compiled for the host and run by the CPU stand-in for the card of
tests/test_torch_emulated_runtime.py, against the plain pipeline.

g++ builds megakernel.cu and forwardmodes.cu, with -ffp-contract=off,
behind EMU: a launch runs its blocks one after another, each block as its
threads, so the per-block fold table (built by the block's threads, then
a __syncthreads) and the kernel's pixel indexing run as on the card. Built
so, the kernel rounds like torch's CPU pipeline: every launch of the
production configuration is held bitwise against models/renderer.py with
the same config, hinted or not, and so is every other configuration whose
arithmetic has no transcendental: the sequential stream and the spec fold
with the poly sampler. The kepler and newton samplers and the trig fold
call glibc's expf, logf, sinf, cosf, acosf and asinf here, where torch's
CPU ops take their own vectorized versions (they differ in the last bit
on about 3% of arguments): those launches are held to test_pallas.py's
image bounds (tests/test_torch_render.py BOUNDS). On the card both sides
call CUDA's math library. The card's own runs are chip_smoke.py's phases
3, 6, 7, 7c and 14.
"""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from fourd_ray_tracing_tpu_torch import camera as tcam
from fourd_ray_tracing_tpu_torch import diff
from fourd_ray_tracing_tpu_torch.models import library, params, renderer
from fourd_ray_tracing_tpu_torch.ops.cuda import build, megakernel

from helpers import assert_images_close
from test_torch_adjoint_host import axis_plane_scene, camera_of, ptr
from test_torch_render import BOUNDS
from test_torch_emulated_runtime import emulated_library

CPU = torch.device("cpu")
SHAPE = dict(width=48, height=24, samples=3, reflections_amount=4, rng_mode="per_sample")
SEEDS = np.array([0x12345678, 9], np.uint32)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    so = emulated_library(tmp_path_factory.mktemp("forward_launch_emulated"),
                          ("megakernel.cu", "forwardmodes.cu"))
    return build.bind(ctypes.CDLL(str(so)), ("fourd_forward_launch",
                                             "fourd_forward_variant_launch",
                                             "fourd_forward_modes_launch"))


def launch(lib, packed, lay, cfg, seeds, rows=None, variant=None):
    """fourd_forward_launch (or the variant launch) on host arrays, as
    megakernel.launch_forward makes it on the card: (F, V, n_rows, W, 3)."""
    row0, n_rows = megakernel.launch_rows(cfg, rows)
    table = (ctypes.c_int * len(lay))(*lay)
    hints = megakernel.hint_table(cfg, lay)
    out = np.zeros((len(seeds), lay.n_views, n_rows, cfg.width, 3), np.float32)
    args = (ptr(packed), lay.size if packed.ndim == 2 else 0, ptr(seeds), len(seeds),
            ctypes.addressof(table), ctypes.addressof(hints), cfg.width, cfg.height, row0,
            n_rows, cfg.samples, cfg.reflections_amount, float(np.float32(cfg.small_indent)),
            ptr(out), None)
    if variant is None and not megakernel.production(cfg, lay):
        err = lib.fourd_forward_modes_launch(*megakernel.mode_codes(cfg), *args)
    elif variant is None:
        err = lib.fourd_forward_launch(*args)
    else:
        err = lib.fourd_forward_variant_launch(4 if variant == "generic_fold" else 0, *args)
    assert err == 0
    return out


def configs(scene):
    cfg = renderer.RenderConfig(**SHAPE)
    return {"unhinted": cfg, "hinted": megakernel.with_hints(scene, cfg)}


COMPOSITE = ["hypercube", "duocylinder", "tiger"]


@pytest.mark.parametrize("hints", ["hinted", "unhinted"])
@pytest.mark.parametrize("views", [("yxz",), tcam.VIEWS_ALL], ids=["1view", "3view"])
@pytest.mark.parametrize("name", ["room_with_sphere", "sphere_plane_light"])
def test_forward_launch_is_bitwise_the_plain_pipeline(lib, name, views, hints):
    """K1 over a (2,) seed vector, each frame bitwise the plain render."""
    scene, camera = library.SCENES[name](CPU), camera_of(views)
    cfg = configs(scene)[hints]
    assert (cfg.plane_hints is not None) == (hints == "hinted")
    packed, lay = params.pack(scene, camera).numpy(), params.layout(scene, camera)
    out = launch(lib, packed, lay, cfg, SEEDS)
    ref = renderer.render_light(scene, camera, cfg, SEEDS).numpy()
    np.testing.assert_array_equal(out if len(views) > 1 else out[:, 0], ref)


def test_forward_launch_folds_alike(lib):
    """The room's hinted launch through its pattern instance (4 pairs), the
    generic instance and the unhinted table: bitwise one image."""
    scene, camera = library.room_with_sphere(CPU), camera_of(("yxz",))
    cfgs = configs(scene)
    packed, lay = params.pack(scene, camera).numpy(), params.layout(scene, camera)
    base = launch(lib, packed, lay, cfgs["hinted"], SEEDS)
    np.testing.assert_array_equal(launch(lib, packed, lay, cfgs["hinted"], SEEDS,
                                         variant="generic_fold"), base)
    np.testing.assert_array_equal(launch(lib, packed, lay, cfgs["unhinted"], SEEDS), base)
    assert float(np.abs(base).max()) > 0.0


def test_forward_launch_pairs_off_axis_order(lib):
    """The room with its walls listed y, x, z, w: its 4 pairs do not lie on
    the axes in their order, so the launch takes the generic instance of
    the fold; bitwise the plain pipeline, hinted and not."""
    room, camera = library.room_with_sphere(CPU), camera_of(("yxz",))
    walls = room.spaces
    scene = room._replace(spaces=(*walls[2:4], *walls[:2], *walls[4:]))
    cfgs = configs(scene)
    assert [axis for _, _, axis in cfgs["hinted"].plane_pairs[0]] == [1, 0, 2, 3]
    packed, lay = params.pack(scene, camera).numpy(), params.layout(scene, camera)
    for cfg in cfgs.values():
        out = launch(lib, packed, lay, cfg, SEEDS)
        np.testing.assert_array_equal(out[:, 0], renderer.render_light(scene, camera, cfg,
                                                                       SEEDS).numpy())


@pytest.mark.parametrize("hints", ["hinted", "unhinted"])
def test_row_stride_and_row_block_launches(lib, hints):
    """K2: the room and its zero_object copy as two params rows at one
    seed, each row bitwise its own render; K3: a block of rows (5, 13) of
    that launch, bitwise those rows of the plain render."""
    room, camera = library.room_with_sphere(CPU), camera_of(("yxz",))
    scenes = (room, diff.zero_object(room, ("spheres", 0)))
    cfg = configs(room)[hints]
    if hints == "hinted":
        assert megakernel.with_hints(scenes, renderer.RenderConfig(**SHAPE)) == cfg
    rows_p = params.stack_rows(scenes, camera).numpy()
    lay = params.layout(room, camera)
    seeds = SEEDS[:1].repeat(2)
    whole = launch(lib, rows_p, lay, cfg, seeds)
    block = launch(lib, rows_p, lay, cfg, seeds, rows=(5, 13))
    for k, scene in enumerate(scenes):
        ref = renderer.render_light(scene, camera, cfg, int(SEEDS[0])).numpy()
        np.testing.assert_array_equal(whole[k, 0], ref)
        np.testing.assert_array_equal(block[k, 0], ref[5:18])
    assert not np.array_equal(whole[0], whole[1])


def test_launch_refuses_a_bad_descriptor(lib):
    """A descriptor that does not cover each of the layout's planes exactly
    once is refused (cudaErrorInvalidValue), not traced: too few planes, a
    pair of one plane twice, a plane in two pairs (another left out), a
    single that repeats a pair's plane."""
    scene, camera = library.room_with_sphere(CPU), camera_of(("yxz",))
    packed, lay = params.pack(scene, camera).numpy(), params.layout(scene, camera)
    cfg = configs(scene)["hinted"]
    pairs = cfg.plane_pairs[0]
    (i0, j0, a0), (i1, _, a1) = pairs[:2]
    bad = {"too_few": (pairs[:3], ()),
           "pair_of_one_plane": (((i0, i0, a0), *pairs[1:]), ()),
           "plane_in_two_pairs": ((pairs[0], (i1, j0, a1), *pairs[2:]), ()),
           "single_repeats_a_pair": (pairs[:3], (i0, j0))}
    for plane_pairs in bad.values():
        with pytest.raises(AssertionError):
            launch(lib, packed, lay, dataclasses.replace(cfg, plane_pairs=plane_pairs), SEEDS)
    launch(lib, packed, lay, cfg, SEEDS)


def custom_scenes():
    """test_torch_composites.py's custom scenes: the rotated (unaligned)
    tiger and two cylinders, one aligned (the generic instance), and the
    library's axes with unequal radii (the library's instances)."""
    from test_torch_composites import scenes

    return {name: scenes(name)[1]
            for name in ("tiger_rotated", "cylinders", "duocylinder_radii", "tiger_radii")}


@pytest.mark.parametrize("hints", ["hinted", "unhinted"])
@pytest.mark.parametrize("views", [("yxz",), tcam.VIEWS_ALL], ids=["1view", "3view"])
@pytest.mark.parametrize("name", COMPOSITE + ["tiger_rotated", "cylinders", "duocylinder_radii",
                                               "tiger_radii"])
def test_composite_launches_are_bitwise_the_plain_pipeline(lib, name, views, hints):
    """K1 over a (2,) seed vector, K2 over two params rows (the scene and
    a copy with its floor moved) at one seed, and K3 row blocks of both:
    each bitwise the plain render, with the hints (plane and axis) the
    entry point derives and without."""
    scene = library.SCENES[name](CPU) if name in library.SCENES else custom_scenes()[name]
    camera = camera_of(views)
    cfg = configs(scene)[hints]
    assert (cfg.axis_hints is not None) == (hints == "hinted" and name != "tiger_rotated")
    packed, lay = params.pack(scene, camera).numpy(), params.layout(scene, camera)
    out = launch(lib, packed, lay, cfg, SEEDS)
    ref = renderer.render_light(scene, camera, cfg, SEEDS).numpy()
    one = (lambda x: x) if len(views) > 1 else (lambda x: x[:, 0])
    np.testing.assert_array_equal(one(out), ref)
    assert float(np.abs(ref).max()) > 0.0
    np.testing.assert_array_equal(one(launch(lib, packed, lay, cfg, SEEDS, rows=(5, 13))),
                                  ref[..., 5:18, :, :])
    floor = scene.spaces[0]
    moved = scene._replace(spaces=(floor._replace(point=floor.point._replace(
        z=floor.point.z - 0.25)),))
    rows_p = params.stack_rows((scene, moved), camera).numpy()
    seeds = SEEDS[:1].repeat(2)
    whole = launch(lib, rows_p, lay, cfg, seeds)
    block = launch(lib, rows_p, lay, cfg, seeds, rows=(3, 9))
    for k, sc in enumerate((scene, moved)):
        ref_k = renderer.render_light(sc, camera, cfg, int(SEEDS[0])).numpy()
        np.testing.assert_array_equal(one(whole)[k], ref_k)
        np.testing.assert_array_equal(one(block)[k], ref_k[..., 3:12, :, :])
    assert not np.array_equal(whole[0], whole[1])


@pytest.mark.parametrize("name", COMPOSITE)
def test_composite_generic_instance_folds_alike(lib, name):
    """The library scene's hinted launch through its own instance, the
    generic instance (the variant launch's flag) and the unhinted launch:
    bitwise one image."""
    scene, camera = library.SCENES[name](CPU), camera_of(("yxz",))
    cfgs = configs(scene)
    packed, lay = params.pack(scene, camera).numpy(), params.layout(scene, camera)
    base = launch(lib, packed, lay, cfgs["hinted"], SEEDS)
    np.testing.assert_array_equal(launch(lib, packed, lay, cfgs["hinted"], SEEDS,
                                         variant="generic_fold"), base)
    np.testing.assert_array_equal(launch(lib, packed, lay, cfgs["unhinted"], SEEDS), base)


def test_launch_refuses_a_bad_composite_descriptor(lib):
    """A descriptor whose composite lies outside the params, or whose axis
    hint names one component twice, is refused, not traced."""
    scene, camera = library.tiger(CPU), camera_of(("yxz",))
    packed, lay = params.pack(scene, camera).numpy(), params.layout(scene, camera)
    cfg = configs(scene)["hinted"]
    launch(lib, packed, lay, cfg, SEEDS)
    with pytest.raises(AssertionError):
        launch(lib, packed, lay._replace(tiger=lay.size - 10), cfg, SEEDS)
    bad = cfg.axis_hints._replace(tiger=(((0, 1.0), (0, 1.0)), cfg.axis_hints.tiger[1]))
    with pytest.raises(AssertionError):
        launch(lib, packed, lay, dataclasses.replace(cfg, axis_hints=bad), SEEDS)


def test_many_planes_render_unhinted_through_the_hints(lib):
    """The forward past the hint cap: room_with_sphere with 57 more floor
    planes (65 hyperplanes) gets its plane hints (with_hints derives them
    for any number of planes); the descriptor holds at most
    build.MAX_HINT_PLANES planes' hints, so hint_table folds the planes
    unhinted (n_singles -1) instead of raising, and the launch is bitwise
    the plain render under the same config (which folds with the hints)."""
    from test_torch_freeze_hints import many_planes

    from fourd_ray_tracing_tpu_torch.models import scene as tscene

    scene, camera = many_planes(tscene, CPU), camera_of(("yxz",))
    cfg = configs(scene)["hinted"]
    lay = params.layout(scene, camera)
    assert cfg.plane_hints is not None and len(cfg.plane_hints) == 65 > build.MAX_HINT_PLANES
    assert megakernel.hint_table(cfg, lay)[1] == -1
    out = launch(lib, params.pack(scene, camera).numpy(), lay, cfg, SEEDS)
    ref = renderer.render_light(scene, camera, cfg, SEEDS).numpy()
    np.testing.assert_array_equal(out[:, 0], ref)
    assert float(np.abs(ref).max()) > 0.0


# The soft kernel's row b of each composite: the scene with its composite
# zeroed (diff.zero_object), and the two-cylinder scene whose sampled rays
# pass through a cylinder's axis plane (axis_plane_scene).
ZEROED = {"hypercube": ("hypercube", None), "duocylinder": ("cylinders_union", None),
          "tiger": ("tiger", None), "axis_plane": ("cylinders", 1)}


@pytest.mark.parametrize("hints", ["hinted", "unhinted"])
@pytest.mark.parametrize("name", list(ZEROED))
def test_zeroed_composite_renders_as_dropped(lib, name, hints):
    """K2 over the scene and its zero_object copy in one launch (the rows
    K6's pass 1 traces): row 0 bitwise the plain render of the scene, row 1
    bitwise the plain render of the drop_object scene under
    hints_for_dropped: the zeroed composite, whose table is built from the
    zeroed row (radii 0, the hypercube's -1), is a guaranteed miss, hinted
    (the library scene's own instance) or not."""
    ref = ZEROED[name]
    if name == "axis_plane":
        scene, camera = axis_plane_scene()
        cfg = renderer.RenderConfig(width=64, height=36, samples=1, reflections_amount=2,
                                    rng_mode="per_sample")
        cfg = {"unhinted": cfg, "hinted": megakernel.with_hints(scene, cfg)}[hints]
        seed = 5
    else:
        scene, camera = library.SCENES[name](CPU), camera_of(("yxz",))
        cfg, seed = configs(scene)[hints], int(SEEDS[0])
    assert (cfg.axis_hints is not None) == (hints == "hinted")
    zeroed = diff.zero_object(scene, ref)
    rows = params.stack_rows((scene, zeroed), camera).numpy()
    out = launch(lib, rows, params.layout(scene, camera), cfg, np.array([seed, seed], np.uint32))
    dropped = renderer.render_light(diff.drop_object(scene, ref), camera,
                                    diff.hints_for_dropped(cfg, ref), seed).numpy()
    np.testing.assert_array_equal(out[0, 0], renderer.render_light(scene, camera, cfg, seed))
    np.testing.assert_array_equal(out[1, 0], dropped)
    assert not np.array_equal(out[0, 0], out[1, 0])


# --- K1's other configurations (csrc/forwardmodes.cu) ------------------------------

RNG_MODES, SAMPLERS, FOLDS = ("per_sample", "sequential"), ("poly", "kepler", "newton"), (
    "fast", "spec", "trig")
MODES_SHAPE = dict(width=32, height=16, samples=3, reflections_amount=3)


def transcendental(cfg) -> bool:
    """Whether a configuration calls the math library's transcendentals."""
    return cfg.sampler_method != "poly" or cfg.intersect == "trig"


def assert_launch_matches(out, ref, cfg):
    """Bitwise where the arithmetic is the plain pipeline's; within the
    image bounds where glibc's transcendentals stand in for torch's."""
    if transcendental(cfg):
        assert_images_close(out, ref, **BOUNDS)
    else:
        np.testing.assert_array_equal(out, ref)


def bare(scene):
    """``scene`` with its hypercube built from its cells alone."""
    return scene._replace(hypercube=type(scene.hypercube)(scene.hypercube.cubes))


@pytest.mark.parametrize("intersect", FOLDS)
@pytest.mark.parametrize("sampler", SAMPLERS)
@pytest.mark.parametrize("rng_mode", RNG_MODES)
@pytest.mark.parametrize("name", sorted(library.SCENES) + ["hypercube_cells"])
def test_every_configuration_launch_matches_the_plain_pipeline(lib, name, rng_mode, sampler,
                                                               intersect):
    """K1 in every configuration the JAX K1 renders, rng x sampler x fold,
    on every library scene and a hypercube without generators, with the
    hints the entry point derives (the fast fold's; the literal folds
    carry none): through the production instances for per_sample, poly,
    fast, else through forwardmodes.cu's, over a (2,) seed vector."""
    scene = (bare(library.hypercube(CPU)) if name == "hypercube_cells"
             else library.SCENES[name](CPU))
    camera = camera_of(("yxz",))
    cfg = megakernel.with_hints(scene, renderer.RenderConfig(
        **MODES_SHAPE, rng_mode=rng_mode, sampler_method=sampler, intersect=intersect))
    assert megakernel.hinted(cfg) == (intersect == "fast")
    packed, lay = params.pack(scene, camera).numpy(), params.layout(scene, camera)
    out = launch(lib, packed, lay, cfg, SEEDS)[:, 0]
    ref = renderer.render_light(scene, camera, cfg, SEEDS).numpy()
    assert float(np.abs(ref).max()) > 0.0
    assert_launch_matches(out, ref, cfg)


@pytest.mark.parametrize("sampler,intersect", [("poly", "fast"), ("poly", "spec"),
                                               ("newton", "trig")])
@pytest.mark.parametrize("name", ["room_with_sphere", "tiger", "hypercube_cells"])
def test_sequential_rows_and_blocks_are_the_launch(lib, name, sampler, intersect):
    """The sequential stream's K2 rows (the scene and a copy with a wall or
    the floor moved, at one seed) and K3 blocks of rows: each bitwise the
    rows of its single launch, which holds its plain render."""
    scene = (bare(library.hypercube(CPU)) if name == "hypercube_cells"
             else library.SCENES[name](CPU))
    camera = camera_of(("yxz",))
    cfg = megakernel.with_hints(scene, renderer.RenderConfig(
        **MODES_SHAPE, rng_mode="sequential", sampler_method=sampler, intersect=intersect))
    wall = scene.spaces[0]
    moved = scene._replace(spaces=(wall._replace(point=wall.point - wall.norm * 0.25),
                                   *scene.spaces[1:]))
    lay = params.layout(scene, camera)
    seed = SEEDS[:1]
    singles = [launch(lib, params.pack(sc, camera).numpy(), lay, cfg, seed)[0, 0]
               for sc in (scene, moved)]
    rows_p = params.stack_rows((scene, moved), camera).numpy()
    whole = launch(lib, rows_p, lay, cfg, seed.repeat(2))[:, 0]
    block = launch(lib, rows_p, lay, cfg, seed.repeat(2), rows=(5, 7))[:, 0]
    for k in range(2):
        np.testing.assert_array_equal(whole[k], singles[k])
        np.testing.assert_array_equal(block[k], singles[k][5:12])
    assert not np.array_equal(singles[0], singles[1])
    assert_launch_matches(singles[0], renderer.render_light(scene, camera, cfg,
                                                            int(seed[0])).numpy(), cfg)


def test_launch_refuses_what_its_instances_do_not_take(lib):
    """A hypercube without generators (kCubeCells) through the production
    launch, hints with a literal fold, an unknown fold, sampler or RNG
    code, and a Halley count past 16 are refused, not traced."""
    scene, camera = bare(library.hypercube(CPU)), camera_of(("yxz",))
    packed, lay = params.pack(scene, camera).numpy(), params.layout(scene, camera)
    cfg = renderer.RenderConfig(**MODES_SHAPE, rng_mode="per_sample")
    table = (ctypes.c_int * len(lay))(*lay)
    out = np.zeros((1, 1, cfg.height, cfg.width, 3), np.float32)

    def call(entry, *codes, hints=None):
        hints = megakernel.hint_table(cfg, lay) if hints is None else hints
        return getattr(lib, entry)(*codes, ptr(packed), 0, ptr(SEEDS[:1]), 1,
                                   ctypes.addressof(table), ctypes.addressof(hints), cfg.width,
                                   cfg.height, 0, cfg.height, cfg.samples,
                                   cfg.reflections_amount, 0.005, ptr(out), None)

    assert call("fourd_forward_modes_launch", 0, 0, 0, 2) == 0
    assert call("fourd_forward_launch") != 0
    hinted_words = megakernel.hint_table(megakernel.with_hints(scene, cfg), lay)
    assert hinted_words[1] >= 0
    assert call("fourd_forward_modes_launch", 1, 0, 0, 2, hints=hinted_words) != 0
    for codes in ((3, 0, 0, 2), (0, 3, 0, 2), (0, 0, 2, 2), (0, 1, 0, 17)):
        assert call("fourd_forward_modes_launch", *codes) != 0
