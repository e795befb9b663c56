"""The composite primitives of the port's plain pipeline (cylinders, the
duocylinder, the hypercube and the tiger) against the JAX package's, on
the CPU: packing, the parameters carried across, the axis-alignment
hints, the closest-hit fold and the render.

The fold is held to tests/test_torch_scene.py's bounds against the JAX
package's (hit masks equal on >= 99.9% of rays; where both hit, materials
equal, distances and normals within 1e-5 on all but a few near-tangent
hits), and bitwise to the JAX package's fold run op by op with a
correctly rounded rsqrt: XLA's compiled fold contracts multiply-adds and
its rsqrt is not correctly rounded, and those two are the whole
difference. The axis-hinted fold and render must be bitwise the unhinted
ones; renders are held to tests/test_pallas.py's image bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import assert_images_close

from fourd_ray_tracing_tpu import camera as jcam
from fourd_ray_tracing_tpu.models import library as jlib
from fourd_ray_tracing_tpu.models import renderer as jrenderer
from fourd_ray_tracing_tpu.models import scene as jscene
from fourd_ray_tracing_tpu.models.scene import axis_alignment_hints as j_axis_hints
from fourd_ray_tracing_tpu.ops import geometry as jgeo
from fourd_ray_tracing_tpu.ops.pallas.megakernel import _pack_pytree, render_light_pallas
from fourd_ray_tracing_tpu.ops.vec4 import Vec4 as JVec4

from fourd_ray_tracing_tpu_torch import camera as tcam
from fourd_ray_tracing_tpu_torch.models import library as tlib
from fourd_ray_tracing_tpu_torch.models import params
from fourd_ray_tracing_tpu_torch.models import renderer as trenderer
from fourd_ray_tracing_tpu_torch.models import scene as tscene
from fourd_ray_tracing_tpu_torch.ops import geometry as tgeo
from fourd_ray_tracing_tpu_torch.ops.cuda import megakernel
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4 as TVec4

CPU = torch.device("cpu")
LIBRARY = ["sphere_plane_light", "room_with_sphere", "hypercube", "duocylinder", "tiger"]
COMPOSITE = ["hypercube", "duocylinder", "tiger"]
# P of pack(scene, camera) at 1 and 3 views.
SIZES = {"sphere_plane_light": (63, 79), "room_with_sphere": (154, 170), "hypercube": (272, 288),
         "duocylinder": (79, 95), "tiger": (115, 131)}
# The fold against JAX's compiled one: distances and normals within ATOL
# on all but NEAR_TANGENT_FRAC of the rays both hit (a near-tangent circle
# hit cancels in b - sqrt(disc), where one contracted multiply-add or an
# ulp of rsqrt moves the float32 root by more).
ATOL = 1e-5
NEAR_TANGENT_FRAC = 0.005
RENDER = dict(width=48, height=24, samples=3, reflections_amount=4, rng_mode="per_sample")
BOUNDS = dict(atol=1e-5, boundary_frac=0.02, mean_atol=0.05)

# A rotation by 0.3 rad in the x-y plane, in float32: it turns the
# library's unit axes into unaligned ones.
_C, _S = float(np.float32(np.cos(0.3))), float(np.float32(np.sin(0.3)))


def _rot(v):
    x, y, z, w = v
    return (float(np.float32(_C * x - _S * y)), float(np.float32(_S * x + _C * y)), z, w)


FLOOR = ((0, 0, -1.5, 0), (0, 0, 1, 0), (0, 0, (0.4, 0.25, 0.07)))
SKY = (((0, 1, 1, 0), float(np.pi) * 0.09, (500, 500, 10), 0.0), (0.2, 0.6, 1.2))
TIGER_AXES = ((1, 0, 0, 0), (0, 0, 0, 1), (0, 0, 1, 0), (0, 1, 0, 0))
DUO = (((1, 0, 0, 0), (0, 0, 0, 1), (1.0, 0.0, 0.0)), ((0, 0, 1, 0), (0, 1, 0, 0), (0.07, 0.67, 0.25)))
HC_AXES = ((1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 0), (0, 0, 0, 1))
HC_COLORS = tuple((0.1 * k, 0.5, 1.0 - 0.1 * k) for k in range(8))
# Two cylinders: one on unit axes, one rotated.
CYLINDERS = (((0, 2, 0, 0), (1, 0, 0, 0), (0, 0, 0, 1), 0.8, (1.0, 0.2, 0.2)),
             ((0.5, 2, 0, 0), _rot((0, 0, 1, 0)), _rot((0, 1, 0, 0)), 0.6, (0.2, 0.9, 0.3)))


def _build(mod, geo, vec, device):
    """The custom scenes, built by one package's constructors."""
    kw = {} if device is None else {"device": device}
    extra = () if device is None else (device,)

    def mat(color):
        return mod.material(0, 0, color, *extra)

    def v(t):
        return vec.of(*t, **kw)

    def env():
        (drct, ang, light, sharp), sky = SKY
        return mod.environment(mod.sun(drct, ang, light, sharp, *extra), sky, **kw)

    floor = (mod.space(FLOOR[0], FLOOR[1], mat(FLOOR[2][2]), *extra),)
    rot_axes = [_rot(a) for a in TIGER_AXES]
    return {
        "tiger_rotated": mod.Scene(spaces=floor, environment=env(), tiger=geo.make_tiger(
            v((0, 2, 0, 0)), *map(v, rot_axes), 0.9, 1.4, mat((1.0, 0.0, 0.0)),
            mat((0.07, 0.67, 0.25)))),
        "duocylinder_rotated": mod.Scene(spaces=floor, environment=env(), cylinders_union=tuple(
            mod.cylinder((0, 2, 0, 0), _rot(a1), _rot(a2), 1.0, mat(c), *extra)
            for a1, a2, c in DUO)),
        "hypercube_rotated": mod.Scene(spaces=floor, environment=env(), hypercube=geo.make_hypercube(
            v((0, 2, 0, 0)), *(v(_rot(a)) for a in HC_AXES), 1.0,
            tuple(mat(c) for c in HC_COLORS))),
        "cylinders": mod.Scene(spaces=floor, environment=env(), cylinders=tuple(
            mod.cylinder(p, a1, a2, r, mat(c), *extra) for p, a1, a2, r, c in CYLINDERS)),
        # The library's axes with radii that differ between the cylinders
        # (the duocylinder's clip takes cylinder 2's) and between the
        # tiger's families (each clips against the other's annulus).
        "duocylinder_radii": mod.Scene(spaces=floor, environment=env(), cylinders_union=tuple(
            mod.cylinder((0, 2, 0, 0), a1, a2, r, mat(c), *extra)
            for (a1, a2, c), r in zip(DUO, (1.0, 0.7)))),
        "tiger_radii": mod.Scene(spaces=floor, environment=env(), tiger=geo.TigerSpec(*(
            mod.cylinder((0, 2, 0, 0), a1, a2, r, mat(c), *extra)
            for a1, a2, r, c in ((TIGER_AXES[0], TIGER_AXES[1], 0.9, (1.0, 0.0, 0.0)),
                                 (TIGER_AXES[0], TIGER_AXES[1], 1.4, (1.0, 0.0, 0.0)),
                                 (TIGER_AXES[2], TIGER_AXES[3], 0.7, (0.07, 0.67, 0.25)),
                                 (TIGER_AXES[2], TIGER_AXES[3], 1.2, (0.07, 0.67, 0.25)))))),
    }


def scenes(name):
    """(JAX scene, port scene) of a library or a custom scene."""
    if name in tlib.SCENES:
        return jlib.SCENES[name](), tlib.SCENES[name](CPU)
    return _build(jscene, jgeo, JVec4, None)[name], _build(tscene, tgeo, TVec4, CPU)[name]


FOLD_SCENES = COMPOSITE + ["tiger_rotated", "duocylinder_rotated", "hypercube_rotated", "cylinders",
                            "duocylinder_radii", "tiger_radii"]


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


def aimed_rays(rng, n=4096):
    """Origins in [-4, 4]^4; three quarters of the directions aimed at the
    composites' center (0, 2, 0, 0) within +-1.5 a component, the rest
    uniform on S^3."""
    o = rng.uniform(-4.0, 4.0, size=(4, n))
    target = np.array([0.0, 2.0, 0.0, 0.0])[:, None] + rng.uniform(-1.5, 1.5, size=(4, n))
    d = target - o
    d[:, 3 * n // 4:] = rng.normal(size=(4, n - 3 * n // 4))
    d = d / np.linalg.norm(d, axis=0)
    return o.astype(np.float32), d.astype(np.float32)


def bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def j_hints(jsc):
    hints = jscene.plane_norm_hints(jsc)
    return dict(plane_hints=hints, plane_pairs=jscene.plane_pair_hints(jsc, hints),
                axis_hints=j_axis_hints(jsc))


def t_hints(tsc):
    hints = tscene.plane_norm_hints(tsc)
    return dict(plane_hints=hints, plane_pairs=tscene.plane_pair_hints(tsc, hints),
                axis_hints=tscene.axis_alignment_hints(tsc))


@pytest.mark.parametrize("views", [("yxz",), tcam.VIEWS_ALL], ids=["1view", "3view"])
@pytest.mark.parametrize("name", LIBRARY)
def test_pack_bitwise_all_scenes(name, views):
    """pack is bitwise megakernel._pack_pytree, at the P of each scene."""
    jc, tc = cameras(views)
    jsc, tsc = scenes(name)
    ref = np.asarray(_pack_pytree((jsc, jc))[0])
    out = params.pack(tsc, tc).numpy()
    np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))
    assert out.shape == (SIZES[name][len(views) > 1],)
    assert params.layout(tsc, tc).size == out.shape[0]


@pytest.mark.parametrize("name", FOLD_SCENES)
def test_layout_points_at_the_composites(name):
    """Every composite offset of the layout reads the leaf it names, and
    the environment follows them."""
    _, tc = cameras(("yxz",))
    _, tsc = scenes(name)
    packed, lay = params.pack(tsc, tc), params.layout(tsc, tc)
    cyl = params.CYLINDER_FLOATS
    for k, c in enumerate(tsc.cylinders):
        base = lay.cylinders + cyl * k
        assert packed[base + 4:base + 8].tolist() == [float(x) for x in c.axis1]
        assert packed[base + 12].item() == c.r.item()
    if tsc.cylinders_union is not None:
        for k, c in enumerate(tsc.cylinders_union):
            assert packed[lay.cylinders_union + cyl * k + 12].item() == c.r.item()
            assert packed[lay.cylinders_union + cyl * k + 15].item() == c.material.color.x.item()
    if tsc.hypercube is not None:
        hc, base = tsc.hypercube, lay.hypercube
        for i, cube in enumerate(hc.cubes):
            assert packed[base + params.CUBE_FLOATS * i + 23].item() == cube.material.color.x.item()
        assert packed[base + 208:base + 212].tolist() == [float(x) for x in hc.point]
        assert packed[base + 212 + 4:base + 220].tolist() == [float(x) for x in hc.axes[1]]
        assert packed[base + 228].item() == hc.r.item()
    if tsc.tiger is not None:
        for k, c in enumerate(tsc.tiger):
            assert packed[lay.tiger + cyl * k + 12].item() == c.r.item()
    assert packed[lay.env + 4].item() == tsc.environment.sun.angular_size.item()
    assert set(lay.composite_kinds()) == set(tsc.composite_kinds()) != set()


@pytest.mark.parametrize("name", COMPOSITE)
def test_from_numpy_leaves_carries_the_composites(name):
    """The JAX scene's leaves in the port's structure: the same packed
    vector, and the same render as the port's own library scene."""
    jc, tc = cameras(("yxz",))
    jsc, tsc = scenes(name)
    np_leaves = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves((jsc, jc))]
    scene, camera = params.from_numpy_leaves(np_leaves, tsc, tc)
    np.testing.assert_array_equal(params.pack(scene, camera).numpy(),
                                  np.asarray(_pack_pytree((jsc, jc))[0]))
    cfg = trenderer.RenderConfig(width=16, height=8, samples=2, reflections_amount=3,
                                 rng_mode="per_sample")
    assert torch.equal(trenderer.render_light(scene, camera, cfg, 5),
                       trenderer.render_light(tsc, tc, cfg, 5))


@pytest.mark.parametrize("name", LIBRARY + FOLD_SCENES[3:])
def test_axis_hints_match_jax(name):
    """axis_alignment_hints, on every library scene and the custom ones."""
    jsc, tsc = scenes(name)
    ours, ref = tscene.axis_alignment_hints(tsc), j_axis_hints(jsc)
    assert ours == ref and (ours is None) == (ref is None)
    expected_none = name in ("sphere_plane_light", "room_with_sphere", "tiger_rotated",
                             "duocylinder_rotated", "hypercube_rotated")
    assert (ours is None) == expected_none
    if name == "cylinders":
        assert ours.cylinders == (((0, 1.0), (3, 1.0)), None)


def test_axis_hints_derivation_cases():
    """test_intersect_fast.py::test_axis_hints_derivation_cases on the
    port's side, beside the JAX package's answers: an aligned cylinder, a
    rotated one, two axes on one component, and an axis that requires
    grad."""
    r2 = 0.7071067811865476
    cases = [((0, 0, -1, 0), (0, 0, 0, 1)), ((0, 0, r2, r2), (0, 0, -r2, r2)),
             ((0, 0, 1, 0), (0, 0, 1, 0)), ((0, 0, 2, 0), (1, 0, 0, 0))]
    for a1, a2 in cases:
        js = jscene.Scene(cylinders=(jscene.cylinder((0, 0, 0, 0), a1, a2, 1.0,
                                                     jscene.material(0, 0, (1, 1, 1))),))
        ts = tscene.Scene(cylinders=(tscene.cylinder((0, 0, 0, 0), a1, a2, 1.0,
                                                     tscene.material(0, 0, (1, 1, 1), CPU), CPU),))
        assert tscene.axis_alignment_hints(ts) == j_axis_hints(js)
    aligned = tscene.Scene(cylinders=(tscene.cylinder((0, 0, 0, 0), *cases[0], 1.0,
                                                      tscene.material(0, 0, (1, 1, 1), CPU), CPU),))
    assert tscene.axis_alignment_hints(aligned).cylinders == (((2, -1.0), (3, 1.0)),)
    grad = params.map_leaves(lambda t: t.clone().requires_grad_(True), aligned)
    assert tscene.axis_alignment_hints(grad) is None


@pytest.mark.parametrize("hinted", [True, False], ids=["hinted", "unhinted"])
@pytest.mark.parametrize("name", FOLD_SCENES)
def test_fold_matches_jax(name, hinted, rng_np, monkeypatch):
    """The port's intersect_scene_fast against the JAX package's on seeded
    rays aimed at the composite, with every hint each side derives or
    with none: within the bounds above of the compiled fold, and bitwise
    the fold run op by op (jax.disable_jit: no multiply-add is contracted)
    with jax.lax.rsqrt taken as 1 / sqrt, the port's rsqrt."""
    jsc, tsc = scenes(name)
    o, d = aimed_rays(rng_np)
    jo, jd = JVec4(*map(jnp.asarray, o)), JVec4(*map(jnp.asarray, d))
    ref = jscene.intersect_scene_fast(jsc, jo, jd, **(j_hints(jsc) if hinted else {}))
    out = tscene.intersect_scene_fast(tsc, TVec4(*map(torch.from_numpy, o)),
                                      TVec4(*map(torch.from_numpy, d)),
                                      **(t_hints(tsc) if hinted else {}))
    monkeypatch.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))
    with jax.disable_jit():
        exact = jscene.intersect_scene_fast(jsc, jo, jd, **(j_hints(jsc) if hinted else {}))
    monkeypatch.undo()
    np.testing.assert_array_equal(out.hit.numpy(), np.asarray(exact.hit))
    for a, b in [(out.dist, exact.dist), (out.glow, exact.glow), (out.refl_prob, exact.refl_prob),
                 *zip(out.color, exact.color), *zip(out.norm, exact.norm)]:
        np.testing.assert_array_equal(bits(a + 0.0), np.asarray(b + 0.0).view(np.uint32))
    hit_ref, hit = np.asarray(ref.hit), out.hit.numpy()
    assert (hit == hit_ref).mean() >= 0.999
    both = hit & hit_ref
    alone = tscene.intersect_scene_fast(tsc._replace(spaces=()), TVec4(*map(torch.from_numpy, o)),
                                        TVec4(*map(torch.from_numpy, d)))
    assert both.mean() > 0.25 and float(alone.hit.float().mean()) > 0.1  # the composite takes part
    for a, b in [(out.dist, ref.dist), *zip(out.norm, ref.norm)]:
        a, b = a.numpy()[both], np.asarray(b)[both]
        assert (np.abs(a - b) > ATOL).mean() <= NEAR_TANGENT_FRAC
    for a, b in [(out.glow, ref.glow), (out.refl_prob, ref.refl_prob), *zip(out.color, ref.color)]:
        np.testing.assert_array_equal(a.numpy()[both], np.asarray(b)[both])


@pytest.mark.parametrize("name", COMPOSITE + ["cylinders"])
def test_axis_hinted_fold_is_bitwise_the_unhinted(name, rng_np):
    """The axis-hinted fold leaves every hit, distance, glow, reflectivity
    and color bitwise, and every normal component equal (a zero's sign
    aside: an aligned family writes 0 - 0 * dist where the full dots
    subtract equal values)."""
    _, tsc = scenes(name)
    hints = tscene.axis_alignment_hints(tsc)
    assert hints is not None
    o, d = aimed_rays(rng_np)
    o, d = TVec4(*map(torch.from_numpy, o)), TVec4(*map(torch.from_numpy, d))
    ref = tscene.intersect_scene_fast(tsc, o, d)
    out = tscene.intersect_scene_fast(tsc, o, d, axis_hints=hints)
    assert torch.equal(out.hit, ref.hit) and float(ref.hit.float().mean()) > 0.25
    for a, b in [(out.dist, ref.dist), (out.glow, ref.glow), (out.refl_prob, ref.refl_prob),
                 *zip(out.color, ref.color)]:
        np.testing.assert_array_equal(bits(a), bits(b))
    for a, b in zip(out.norm, ref.norm):
        np.testing.assert_array_equal(bits(a + 0.0), bits(b + 0.0))


@pytest.mark.parametrize("name", COMPOSITE + ["cylinders", "tiger_rotated"])
def test_hinted_render_is_bitwise_the_unhinted(name):
    """The render with the hints the entry points derive (plane and axis)
    is bitwise the render with none."""
    _, tc = cameras(tcam.VIEWS_ALL)
    _, tsc = scenes(name)
    cfg = trenderer.RenderConfig(**RENDER)
    hinted = megakernel.with_hints(tsc, cfg)
    assert (hinted.axis_hints is None) == (name == "tiger_rotated")
    assert hinted.plane_hints is not None
    out = trenderer.render_light(tsc, tc, hinted, 11)
    assert torch.equal(out, trenderer.render_light(tsc, tc, cfg, 11))
    assert float(out.std()) > 0.0


def test_with_hints_derives_axis_hints():
    """with_hints adds the axis hints beside the plane hints, one set over
    rows of the same structure, and keeps a config that has them."""
    tiger = tlib.tiger(CPU)
    cfg = trenderer.RenderConfig(**RENDER)
    one = megakernel.with_hints(tiger, cfg)
    assert one.axis_hints == tscene.axis_alignment_hints(tiger) and one.plane_hints is not None
    assert megakernel.with_hints([tiger, tiger], cfg) == one
    assert megakernel.with_hints(tiger, one) is one
    rotated = scenes("tiger_rotated")[1]
    assert megakernel.with_hints([tiger, rotated], cfg).axis_hints is None
    room = megakernel.with_hints(tlib.room_with_sphere(CPU), cfg)
    assert room.axis_hints is None and room.plane_pairs is not None


def test_table_records_are_the_kernels():
    """The record counts shared_bytes sizes the launch by are
    csrc/trace.cuh's, which build_fold_table writes."""
    from pathlib import Path

    from fourd_ray_tracing_tpu_torch.ops.cuda import build

    src = (Path(build.CSRC_DIR) / "trace.cuh").read_text()
    assert (f"kCylinderRecs = {megakernel._CYLINDER_RECS}, kUnionRecs = {megakernel._UNION_RECS}, "
            f"kHypercubeRecs = {megakernel._HYPERCUBE_RECS}, "
            f"kTigerRecs = {megakernel._TIGER_RECS};") in src


def test_hypercube_without_generators_raises():
    """The generator-less hypercube folds cell by cell in the fast fold and
    packs its cells alone (tests/test_torch_spec_fold.py holds both against
    the JAX package); the gradient kernels take it (csrc/gradmodes.cu's
    cells fold: a cell's hit differentiated through its literal test), so
    the kernel route on the CPU is the plain version, bitwise, with the
    gradient on the cells; K8 takes it (csrc/ablatemodes.cu's cells fold,
    the modes launches' codes), and the sequential stream stays refused."""
    from fourd_ray_tracing_tpu_torch import diff
    from fourd_ray_tracing_tpu_torch.ops.cuda import ablate, gradkernel

    scene = tlib.hypercube(CPU)
    bare = scene._replace(hypercube=tgeo.HypercubeSpec(scene.hypercube.cubes))
    d = TVec4(*(torch.ones(3) for _ in range(4)))
    assert tscene.intersect_scene_fast(bare, d, d).hit.shape == (3,)
    tc = cameras(("yxz",))[1]
    lay = params.layout(bare, tc)
    assert lay.hypercube_cells == 1 and lay.size == params.layout(scene, tc).size - 21
    cfg = trenderer.RenderConfig(width=8, height=4, rng_mode="per_sample")
    vec = params.pack(bare, tc)
    gradkernel.check_shape(lay, cfg)
    target = torch.zeros((4, 8, 3))
    loss = diff.image_loss_kernel(vec, bare, tc, cfg, 1, target)
    ref_loss, ref_grad = gradkernel.loss_and_grad_plain(vec, bare, tc, cfg, 1, target)
    assert torch.equal(loss, ref_loss)
    assert ref_grad[lay.hypercube:lay.hypercube + 8 * 26].abs().max() > 0
    assert gradkernel._modes(cfg, lay) == (0, 0, cfg.sampler_iters)
    value = ablate.variant_plain("loss", bare, tc, cfg, 1, target)
    np.testing.assert_allclose(float(value) / target.numel(), float(ref_loss), rtol=1e-6)
    with pytest.raises(ValueError, match="per-sample"):
        gradkernel.check_shape(lay, trenderer.RenderConfig(width=8, height=4))


@pytest.mark.parametrize("views", [("yxz",), tcam.VIEWS_ALL], ids=["1view", "3view"])
@pytest.mark.parametrize("name", COMPOSITE)
def test_render_matches_jax(name, views):
    """render_light (with the hints the entry point derives) against the
    JAX jnp renderer at 48x24x3spp x4 bounces."""
    jc, tc = cameras(views)
    jsc, tsc = scenes(name)
    cfg = trenderer.RenderConfig(**RENDER)
    ref = np.asarray(jrenderer.render_light(jsc, jc, jrenderer.RenderConfig(**RENDER), 7))
    out = megakernel.render_light_cuda(tsc, tc, cfg, 7).numpy()
    assert_images_close(out, ref, **BOUNDS)
    assert float(np.abs(out).max()) > 0.0


def test_tiger_render_matches_the_pallas_kernel():
    """The tiger at 16x8 against render_light_pallas in interpret mode,
    which derives its hints as the port's entry point does."""
    jc, tc = cameras(("yxz",))
    jsc, tsc = scenes("tiger")
    shape = dict(RENDER, width=16, height=8)
    ref = np.asarray(render_light_pallas(jsc, jc, jrenderer.RenderConfig(**shape), 3,
                                         interpret=True))
    out = megakernel.render_light_cuda(tsc, tc, trenderer.RenderConfig(**shape), 3).numpy()
    assert_images_close(out, ref, **BOUNDS)


def test_sharded_forward_takes_the_composites():
    """The row-sharded forward (parallel/mesh.py) renders a composite scene
    as it is: render_light_tile's row blocks are bitwise the render's rows,
    and a 1-rank mesh, on the plain route and through the K3 wrapper (the
    plain version by rows here), is bitwise the call without a mesh."""
    from fourd_ray_tracing_tpu_torch.parallel import mesh as pmesh

    _, tc = cameras(tcam.VIEWS_ALL)
    _, tsc = scenes("tiger")
    cfg = megakernel.with_hints(tsc, trenderer.RenderConfig(**dict(RENDER, width=16, height=12)))
    full = trenderer.render_light(tsc, tc, cfg, 9)
    blocks = [trenderer.render_light_tile(tsc, tc, cfg, 9, *pmesh.row_block(12, 3, i))
              * trenderer.inv_samples(cfg) for i in range(3)]
    assert torch.equal(torch.cat(blocks, dim=-3), full)
    mesh = pmesh.make_mesh()
    ref = trenderer.render_image(tsc, tc, cfg, 9)
    assert torch.equal(pmesh.sharded_render_image(tsc, tc, cfg, 9, mesh), ref)
    assert torch.equal(megakernel.sharded_render_image_cuda(tsc, tc, cfg, 9, mesh), ref)
