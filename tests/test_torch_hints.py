"""The static hyperplane hints of the port's plain pipeline (the plain
version of the forward kernel K1) against the JAX package's, on the CPU.

The hints (plane_norm_hints, plane_pair_hints) must be the JAX package's
on its scenes; the hinted fold must leave every hit, distance, glow,
reflectivity and color bitwise what the unhinted fold computes, and every
normal component equal (the hinted resolver writes +0 where the unhinted
one writes flip * 0.0, so only a zero's sign may differ); the hinted
render must be bitwise the unhinted one and within the image bounds of
tests/test_torch_render.py of the JAX Pallas forward run with the same
hints (XLA on the CPU contracts multiply-adds, torch does not). The
forward entry points and the engine derive the hints; the gradient paths
refuse them.
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
from fourd_ray_tracing_tpu.models import scene as jscene
from fourd_ray_tracing_tpu.ops.pallas.megakernel import render_light_pallas
from fourd_ray_tracing_tpu.ops.vec4 import Vec4 as JVec4

from fourd_ray_tracing_tpu_torch import camera as tcam
from fourd_ray_tracing_tpu_torch import diff
from fourd_ray_tracing_tpu_torch import engine as tengine
from fourd_ray_tracing_tpu_torch.models import library as tlib
from fourd_ray_tracing_tpu_torch.models import params
from fourd_ray_tracing_tpu_torch.models import renderer as trenderer
from fourd_ray_tracing_tpu_torch.models import scene as tscene
from fourd_ray_tracing_tpu_torch.ops.cuda import build, gradkernel, megakernel
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4 as TVec4

CPU = torch.device("cpu")
SHAPE = dict(width=32, height=16, samples=2, reflections_amount=2, rng_mode="per_sample")
BOUNDS = dict(atol=1e-5, boundary_frac=0.02, mean_atol=0.05)

# test_intersect_fast.py::test_plane_pair_fold_mixed_scene's scene: a pair
# of negative and positive unit normals, an unpaired wall, a non-unit
# normal (which must not pair) and the wall that then has no partner.
MIXED = (
    ((2, 0, 0, 0), (-1, 0, 0, 0), (0, 0, (1, 0, 0))),
    ((0, 5, 0, 0), (0, 1, 0, 0), (0, 0, (0, 1, 0))),
    ((-2, 0, 0, 0), (1, 0, 0, 0), (0, 0, (0, 0, 1))),
    ((0, 0, 3, 0), (0, 0, 2, 0), (0, 0, (1, 1, 0))),
    ((0, 0, -3, 0), (0, 0, 1, 0), (0, 0, (1, 0, 1))),
)


def mixed_scenes():
    """The mixed scene on both sides, with the room's two spheres."""
    jspaces = tuple(jscene.space(p, n, jscene.material(*m)) for p, n, m in MIXED)
    tspaces = tuple(tscene.space(p, n, tscene.material(*m, CPU), CPU) for p, n, m in MIXED)
    room_j, room_t = jlib.room_with_sphere(), tlib.room_with_sphere(CPU)
    return (jscene.Scene(spaces=jspaces, spheres=room_j.spheres),
            tscene.Scene(spaces=tspaces, spheres=room_t.spheres))


def scenes(name):
    if name == "mixed":
        return mixed_scenes()
    return jlib.SCENES[name](), tlib.SCENES[name](CPU)


NAMES = ["room_with_sphere", "sphere_plane_light", "mixed"]


def cameras():
    o = jcam.orientation_from_angles(jnp.float32(0.1), jnp.float32(-0.2), jnp.float32(0.3))
    jtop, jright = jcam.view_basis(o, "yxz")
    mtr_h = jnp.float32(2.0)
    jc = jcam.Camera(JVec4.of(0.0, -2.0, 0.0, 0.0), o.forward * jnp.float32(1.5),
                     jtop, jright, mtr_h * jcam.GOLDEN, mtr_h)
    to = tcam.orientation_from_angles(*tcam.CameraAngles.of(0.1, -0.2, 0.3, device=CPU), CPU)
    tc = tcam.make_camera(TVec4.of(0.0, -2.0, 0.0, 0.0, device=CPU), to, 1.5, 2.0, ("yxz",), CPU)
    return jc, tc


def random_rays(rng, n=4096):
    """Origins in [-4, 4]^4, directions uniform on S^3."""
    o = rng.uniform(-4.0, 4.0, size=(4, n)).astype(np.float32)
    d = rng.normal(size=(4, n))
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    return o, d


def bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("name", NAMES)
def test_hints_match_jax(name):
    jsc, tsc = scenes(name)
    jh = jscene.plane_norm_hints(jsc)
    assert tscene.plane_norm_hints(tsc) == jh
    assert tscene.plane_pair_hints(tsc, jh) == jscene.plane_pair_hints(jsc, jh)
    expected = {"room_with_sphere": ((1, 0, 0), (3, 2, 1), (5, 4, 2), (7, 6, 3)),
                "sphere_plane_light": None, "mixed": ((2, 0, 0),)}[name]
    pairs = tscene.plane_pair_hints(tsc, jh)
    assert (pairs and pairs[0]) == expected


def test_hints_are_none_on_autograd_paths():
    """A hyperplane normal or a pair candidate's point that requires grad
    gives no hints, as a tracer does in the JAX package."""
    scene = tlib.room_with_sphere(CPU)
    hints = tscene.plane_norm_hints(scene)
    grad_norm = params.map_leaves(lambda t: t.clone().requires_grad_(True), scene)
    assert tscene.plane_norm_hints(grad_norm) is None
    point = scene.spaces[0].point._replace(x=scene.spaces[0].point.x.clone().requires_grad_(True))
    moved = scene._replace(spaces=(scene.spaces[0]._replace(point=point), *scene.spaces[1:]))
    assert tscene.plane_norm_hints(moved) == hints
    assert tscene.plane_pair_hints(moved, hints) is None
    assert tscene.plane_norm_hints(tlib.room_with_sphere(CPU)._replace(spaces=())) is None
    cfg = trenderer.RenderConfig(**SHAPE)
    assert megakernel.with_hints(grad_norm, cfg) == cfg


def test_hint_validation_raises():
    scene = tlib.sphere_plane_light(CPU)
    o = TVec4(*(torch.zeros(4) for _ in range(4)))
    d = TVec4(*(torch.ones(4) * 0.5 for _ in range(4)))
    with pytest.raises(ValueError, match=r"plane_hints\[0\].z claims a zero"):
        tscene.intersect_scene_fast(scene, o, d, plane_hints=((True, True, True, True),))
    with pytest.raises(ValueError, match="1 hyperplanes"):
        tscene.intersect_scene_fast(scene, o, d, plane_hints=((True, True, False, True),) * 2)
    cfg = trenderer.RenderConfig(**SHAPE, plane_hints=((False, True, True, True),))
    _, tc = cameras()
    with pytest.raises(ValueError, match="claims a zero"):
        trenderer.render_light(scene, tc, cfg, 1)


@pytest.mark.parametrize("pairs", [True, False], ids=["pairs", "hints_only"])
@pytest.mark.parametrize("name", NAMES)
def test_hinted_fold_is_bitwise_the_unhinted(name, pairs, rng_np):
    _, scene = scenes(name)
    hints = tscene.plane_norm_hints(scene)
    pair_hints = tscene.plane_pair_hints(scene, hints) if pairs else None
    o, d = random_rays(rng_np)
    o, d = TVec4(*map(torch.from_numpy, o)), TVec4(*map(torch.from_numpy, d))
    ref = tscene.intersect_scene_fast(scene, o, d)
    out = tscene.intersect_scene_fast(scene, o, d, hints, pair_hints)
    assert 0.25 < float(ref.hit.float().mean())
    assert torch.equal(out.hit, ref.hit)
    for a, b in [(out.dist, ref.dist), (out.glow, ref.glow), (out.refl_prob, ref.refl_prob),
                 *zip(out.color, ref.color)]:
        np.testing.assert_array_equal(bits(a), bits(b))
    for a, b in zip(out.norm, ref.norm):
        assert torch.equal(a, b)  # equal values; a zero's sign may differ
        np.testing.assert_array_equal(bits(a + 0.0), bits(b + 0.0))


@pytest.mark.parametrize("name", NAMES)
def test_hinted_fold_matches_jax(name, rng_np):
    """test_torch_scene.py's bounds: hit equal on >= 99.9% of rays; where
    both hit, every field within 1e-5."""
    jsc, tsc = scenes(name)
    hints = jscene.plane_norm_hints(jsc)
    pairs = jscene.plane_pair_hints(jsc, hints)
    o, d = random_rays(rng_np)
    ref = jscene.intersect_scene_fast(jsc, JVec4(*map(jnp.asarray, o)),
                                      JVec4(*map(jnp.asarray, d)), hints, pairs)
    out = tscene.intersect_scene_fast(tsc, TVec4(*map(torch.from_numpy, o)),
                                      TVec4(*map(torch.from_numpy, d)), hints, pairs)
    hit_ref, hit = np.asarray(ref.hit), out.hit.numpy()
    assert (hit == hit_ref).mean() >= 0.999
    both = hit & hit_ref
    assert both.mean() > 0.25
    for a, b in [(out.dist, ref.dist), (out.glow, ref.glow), (out.refl_prob, ref.refl_prob),
                 *zip(out.norm, ref.norm), *zip(out.color, ref.color)]:
        np.testing.assert_allclose(a.numpy()[both], np.asarray(b)[both], rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["room_with_sphere", "sphere_plane_light"])
def test_hinted_render_matches_jax_and_the_unhinted_render(name):
    """The plain render with the derived hints: within the image bounds of
    the JAX Pallas forward (interpret mode) run with the same hints, and
    bitwise the port's unhinted render."""
    jsc, tsc = scenes(name)
    jc, tc = cameras()
    hints = jscene.plane_norm_hints(jsc)
    pairs = jscene.plane_pair_hints(jsc, hints)
    j_cfg = jrenderer.RenderConfig(**SHAPE, plane_hints=hints, plane_pairs=pairs)
    ref = np.asarray(render_light_pallas(jsc, jc, j_cfg, 7))
    cfg = trenderer.RenderConfig(**SHAPE)
    hinted = megakernel.with_hints(tsc, cfg)
    assert (hinted.plane_hints, hinted.plane_pairs) == (hints, pairs)
    out = trenderer.render_light(tsc, tc, hinted, 7)
    assert_images_close(out.numpy(), ref, **BOUNDS)
    assert torch.equal(out, trenderer.render_light(tsc, tc, cfg, 7))


def test_with_hints_over_rows():
    """K2's rows share one hint set: a scene and its zero_object copy give
    it; rows whose walls differ give none, and the config stays as it is."""
    cfg = trenderer.RenderConfig(**SHAPE)
    room = tlib.room_with_sphere(CPU)
    one = megakernel.with_hints(room, cfg)
    assert megakernel.with_hints([room, diff.zero_object(room, ("spheres", 0))], cfg) == one
    tilted = room._replace(spaces=(room.spaces[0]._replace(norm=TVec4.of(1, 0.5, 0, 0, device=CPU)),
                                   *room.spaces[1:]))
    assert megakernel.with_hints([room, tilted], cfg) == cfg
    assert megakernel.with_hints(room, one) is one  # a config with hints keeps them
    spec = dataclasses.replace(cfg, intersect="spec")
    assert megakernel.with_hints(room, spec) == spec


def test_hint_table_is_the_kernels_descriptor():
    """The descriptor's layout is csrc/trace.cuh's Hints: the pairs as i |
    j << 8 | axis << 16, then the singles as plane | live mask << 8; -1
    singles without hints; then the composites' count, offsets and axis
    hints (a family k1 | k2 << 2, the hypercube's axes k_i << 2i)."""
    from pathlib import Path

    src = (Path(build.CSRC_DIR) / "trace.cuh").read_text()
    assert f"kMaxHintPlanes = {build.MAX_HINT_PLANES};" in src
    assert f"kMaxCylinders = {build.MAX_CYLINDERS};" in src
    assert "kHintComposites = 2 + kMaxHintPlanes / 2 + kMaxHintPlanes;" in src
    assert "kHintInts = kHintComposites + 5 + kMaxCylinders + 2 + 1 + 2;" in src
    cfg = trenderer.RenderConfig(**SHAPE)
    _, tc = cameras()

    def table(scene, c):
        return list(megakernel.hint_table(c, params.layout(scene, tc)))

    room = tlib.room_with_sphere(CPU)
    words = table(room, megakernel.with_hints(room, cfg))
    assert len(words) == build.HINT_INTS
    assert words[:6] == [4, 0, 1 | 0 << 8 | 0 << 16, 3 | 2 << 8 | 1 << 16,
                         5 | 4 << 8 | 2 << 16, 7 | 6 << 8 | 3 << 16]
    comp = build.HINT_COMPOSITES
    assert words[comp:comp + 5] == [0, -1, -1, -1, -1] and set(words[comp + 5:]) == {-1}
    lamp_scene = tlib.sphere_plane_light(CPU)
    lamp = table(lamp_scene, megakernel.with_hints(lamp_scene, cfg))
    assert lamp[:2] == [0, 1] and lamp[2 + build.MAX_HINT_PLANES // 2] == 0 | 0b0100 << 8
    assert table(room, cfg)[:2] == [0, -1]
    _, tsc = mixed_scenes()
    mixed = megakernel.with_hints(tsc, cfg)
    words = table(tsc, mixed)
    singles = words[2 + build.MAX_HINT_PLANES // 2:][:3]
    assert words[:3] == [1, 3, 2 | 0 << 8 | 0 << 16]
    assert singles == [1 | 0b0010 << 8, 3 | 0b0100 << 8, 4 | 0b0100 << 8]
    with pytest.raises(ValueError, match="entries for 8"):
        megakernel.hint_table(dataclasses.replace(cfg, plane_hints=((True,) * 4,)),
                              params.layout(room, tc))
    tiger, cube = tlib.tiger(CPU), tlib.hypercube(CPU)
    lay = params.layout(tiger, tc)
    words = table(tiger, megakernel.with_hints(tiger, cfg))
    axes = comp + 5 + build.MAX_CYLINDERS
    assert words[comp:comp + 5] == [0, -1, -1, -1, lay.tiger] and lay.tiger == 13
    assert words[axes:axes + 5] == [-1, -1, -1, 0 | 3 << 2, 2 | 1 << 2]
    assert table(tiger, cfg)[axes:axes + 5] == [-1] * 5
    words = table(cube, megakernel.with_hints(cube, cfg))
    assert words[comp + 3] == 13 and words[axes + 2] == 0 | 1 << 2 | 2 << 4 | 3 << 6


def test_engine_derives_the_hints_once(monkeypatch):
    """At construction, into every group's config; a step derives none."""
    calls = []
    real = tscene.plane_norm_hints

    def counting(scene):
        calls.append(1)
        return real(scene)

    monkeypatch.setattr(megakernel, "plane_norm_hints", counting)
    cfg = trenderer.RenderConfig(**SHAPE)
    add_cfg = dataclasses.replace(cfg, width=16, height=8)
    eng = tengine.RenderEngine(
        tlib.room_with_sphere(CPU), cfg, TVec4.of(0.0, -2.0, 0.0, 0.0, device=CPU),
        tcam.CameraAngles.of(0.0, 0.0, 0.0, device=CPU), device=CPU, deterministic=True,
        additional=(add_cfg, ("ywz", "yxw")))
    assert len(calls) == 1
    assert all(len(g.cfg.plane_pairs[0]) == 4 for g in eng.groups)
    eng.step_frames(2)
    eng.step_frame()
    assert len(calls) == 1
    plain = tengine.RenderEngine(
        tlib.room_with_sphere(CPU), cfg, TVec4.of(0.0, -2.0, 0.0, 0.0, device=CPU),
        tcam.CameraAngles.of(0.0, 0.0, 0.0, device=CPU), device=CPU, deterministic=True,
        impl="torch")
    plain.step_frames(2)
    eng2 = tengine.RenderEngine(
        tlib.room_with_sphere(CPU), cfg, TVec4.of(0.0, -2.0, 0.0, 0.0, device=CPU),
        tcam.CameraAngles.of(0.0, 0.0, 0.0, device=CPU), device=CPU, deterministic=True)
    eng2.step_frames(2)
    assert plain.cfg.plane_hints is None and len(calls) == 2
    assert torch.equal(plain.accum, eng2.accum)  # the hinted steps, bitwise the unhinted


def test_config_checks():
    """The forward takes axis hints and the freeze_hints contract; the
    gradient paths refuse the forward's hints without the contract (as the
    JAX gradient kernel does) and take them under it."""
    cfg = trenderer.RenderConfig(**SHAPE)
    hinted = megakernel.with_hints(tlib.room_with_sphere(CPU), cfg)
    trenderer.check_supported(hinted)
    tiger = megakernel.with_hints(tlib.tiger(CPU), cfg)
    assert tiger.axis_hints is not None
    trenderer.check_supported(tiger)
    _, tc = cameras()
    assert torch.equal(trenderer.render_light(tlib.tiger(CPU), tc, tiger, 3),
                       trenderer.render_light(tlib.tiger(CPU), tc, cfg, 3))
    trenderer.check_supported(dataclasses.replace(cfg, freeze_hints=True))
    scene = tlib.room_with_sphere(CPU)
    _, tc = cameras()
    target = torch.zeros((16, 32, 3))
    for fn in (lambda c: diff.image_loss(scene, tc, c, 1, target),
               lambda c: gradkernel.loss_and_grad_plain(params.pack(scene, tc), scene, tc, c,
                                                        1, target),
               lambda c: diff.make_train_step(c, 1e-3, tc)):
        with pytest.raises(ValueError, match="freeze_hints contract"):
            fn(hinted)
        fn(dataclasses.replace(hinted, freeze_hints=True))