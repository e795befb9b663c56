"""The port's scenes, packed parameters and closest-hit fold against the
JAX package's, on the CPU."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourd_ray_tracing_tpu import camera as jcam
from fourd_ray_tracing_tpu.models import library as jlib
from fourd_ray_tracing_tpu.models import renderer as jrenderer
from fourd_ray_tracing_tpu.models.scene import intersect_scene_fast as j_intersect
from fourd_ray_tracing_tpu.ops.pallas.megakernel import _pack_pytree
from fourd_ray_tracing_tpu.ops.vec4 import Vec4 as JVec4

from fourd_ray_tracing_tpu_torch import camera as tcam
from fourd_ray_tracing_tpu_torch.models import library as tlib
from fourd_ray_tracing_tpu_torch.models import params
from fourd_ray_tracing_tpu_torch.models import renderer as trenderer
from fourd_ray_tracing_tpu_torch.models import scene as tscene
from fourd_ray_tracing_tpu_torch.models.scene import Scene, intersect_scene_fast as t_intersect
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4 as TVec4

CPU = torch.device("cpu")
SCENES = ["room_with_sphere", "sphere_plane_light"]
ANGLES = (0.1, -0.2, 0.3)


def cameras(views):
    """The same camera on both sides: focus, angles and film from floats."""
    o = jcam.orientation_from_angles(*(jnp.float32(a) for a in ANGLES))
    jtop, jright = (jcam.view_basis(o, views[0]) if len(views) == 1
                    else jcam.batched_view_bases(o, views))
    mtr_h = jnp.float32(2.0)
    jc = jcam.Camera(JVec4.of(0.0, -2.0, 0.0, 0.0), o.forward * jnp.float32(1.5),
                     jtop, jright, mtr_h * jcam.GOLDEN, mtr_h)
    to = tcam.orientation_from_angles(*tcam.CameraAngles.of(*ANGLES, device=CPU), CPU)
    tc = tcam.make_camera(TVec4.of(0.0, -2.0, 0.0, 0.0, device=CPU), to, 1.5, 2.0, views, CPU)
    return jc, tc


@pytest.mark.parametrize("views", [("yxz",), tcam.VIEWS_ALL], ids=["1view", "3view"])
@pytest.mark.parametrize("name", SCENES)
def test_pack_bitwise(name, views):
    jc, tc = cameras(views)
    ref = np.asarray(_pack_pytree((jlib.SCENES[name](), jc))[0])
    out = params.pack(tlib.SCENES[name](CPU), tc).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))
    expected_p = {("room_with_sphere", 1): 154, ("sphere_plane_light", 1): 63}
    if len(views) == 1:
        assert out.shape == (expected_p[(name, 1)],)


@pytest.mark.parametrize("name", SCENES)
def test_layout_points_at_the_leaves(name):
    """Every offset of the kernel's table reads the leaf it names."""
    _, tc = cameras(tcam.VIEWS_ALL)
    scene = tlib.SCENES[name](CPU)
    packed = params.pack(scene, tc)
    lay = params.layout(scene, tc)
    assert lay.size == packed.numel() and lay.n_views == 3
    for i, sp in enumerate(scene.spaces):
        base = lay.spaces + params.SPACE_FLOATS * i
        assert packed[base + 4:base + 8].tolist() == [float(c) for c in sp.norm]
        assert packed[base + 10:base + 13].tolist() == [float(c) for c in sp.material.color]
    for j, s in enumerate(scene.spheres):
        base = lay.spheres + params.SPHERE_FLOATS * j
        assert packed[base + 4].item() == s.r.item()
        assert packed[base + 5].item() == s.material.glow.item()
    assert packed[lay.env + 4].item() == scene.environment.sun.angular_size.item()
    for c, comp in enumerate("xyzw"):
        for v in range(3):
            assert packed[lay.top + 3 * c + v].item() == getattr(tc.top, comp)[v].item()
            assert packed[lay.right + 3 * c + v].item() == getattr(tc.right, comp)[v].item()
    assert packed[lay.focus + 1].item() == -2.0
    assert packed[lay.mtr_height].item() == 2.0
    assert lay.env_enabled == int(name == "sphere_plane_light")


def megakernel_cells() -> int:
    from fourd_ray_tracing_tpu_torch.ops.cuda import megakernel

    return megakernel.CUBE_CELLS


def test_layout_matches_the_kernel_struct():
    """The offset table crosses to CUDA as an int array in Layout's field
    order: its first kLayoutInts fields must be the field order of the
    kernels' struct Layout (csrc/trace.cuh); the composite offsets after
    them go to the forward kernel in its hints descriptor, and so does
    whether the hypercube has generators (its axis hint kCubeCells)."""
    import re
    from pathlib import Path

    src = (Path(params.__file__).resolve().parents[1] / "csrc" / "trace.cuh").read_text()
    body = re.search(r"struct Layout \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"\b([a-z_]+)\s*[,;]", body.replace("int ", ""))
    assert tuple(fields) == params.Layout._fields[:params.KERNEL_LAYOUT_INTS]
    assert f"kLayoutInts = {params.KERNEL_LAYOUT_INTS};" in src
    assert params.Layout._fields[params.KERNEL_LAYOUT_INTS:] == (
        "n_cylinders", "cylinders", "cylinders_union", "hypercube", "tiger", "hypercube_cells")
    assert f"kCubeCells = {megakernel_cells()};" in src
    assert f"kSpaceFloats = {params.SPACE_FLOATS};" in src
    assert f"kSphereFloats = {params.SPHERE_FLOATS};" in src


@pytest.mark.parametrize("name", SCENES)
def test_from_numpy_leaves_round_trips(name):
    import jax

    jc, tc = cameras(tcam.VIEWS_ALL)
    jscene = jlib.SCENES[name]()
    np_leaves = [np.asarray(l) for l in jax.tree_util.tree_leaves((jscene, jc))]
    scene, camera = params.from_numpy_leaves(np_leaves, tlib.SCENES[name](CPU), tc)
    ref = np.asarray(_pack_pytree((jscene, jc))[0])
    np.testing.assert_array_equal(params.pack(scene, camera).numpy(), ref)
    assert scene.environment.enabled == jscene.environment.enabled
    back = [t.numpy() for t in params.leaves(scene, camera)]
    assert len(back) == len(np_leaves)
    for a, b in zip(back, np_leaves):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        params.from_numpy_leaves(np_leaves + [np.float32(0)], scene, camera)


def random_rays(rng, n=4096):
    """Origins inside the room's box, directions uniform on S^3."""
    o = rng.uniform(-3.0, 3.0, size=(4, n)).astype(np.float32)
    d = rng.normal(size=(4, n))
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("name", SCENES)
def test_intersect_scene_fast_matches_jax(name, rng_np):
    """hit equal on >= 99.9% of rays; where both hit, every field within
    1e-5 (distances and normals are O(1) in these scenes)."""
    o, d = random_rays(rng_np)
    ref = j_intersect(jlib.SCENES[name](), JVec4(*map(jnp.asarray, o)), JVec4(*map(jnp.asarray, d)))
    out = t_intersect(tlib.SCENES[name](CPU), TVec4(*map(torch.from_numpy, o)),
                      TVec4(*map(torch.from_numpy, d)))
    hit_ref, hit = np.asarray(ref.hit), out.hit.numpy()
    assert (hit == hit_ref).mean() >= 0.999
    both = hit & hit_ref
    assert both.mean() > 0.25  # the open scene lets about half escape
    for a, b in [(out.dist, ref.dist), (out.glow, ref.glow), (out.refl_prob, ref.refl_prob),
                 *zip(out.norm, ref.norm), *zip(out.color, ref.color)]:
        np.testing.assert_allclose(a.numpy()[both], np.asarray(b)[both], rtol=0, atol=1e-5)


def composite_scene(field):
    """A scene holding one composite primitive of ``field``: a library
    scene, or for the cylinders sphere_plane_light with one."""
    if field == "cylinders":
        mat = tscene.material(0, 0, (1, 1, 1), CPU)
        return tlib.sphere_plane_light(CPU)._replace(cylinders=(
            tscene.cylinder((0, 2, 0, 0), (1, 0, 0, 0), (0, 0, 0, 1), 0.8, mat, CPU),))
    name = {"cylinders_union": "duocylinder", "hypercube": "hypercube", "tiger": "tiger"}[field]
    return tlib.SCENES[name](CPU)


@pytest.mark.parametrize("field", ["cylinders", "cylinders_union", "hypercube", "tiger"])
def test_composite_primitives_train_on_the_hard_paths(field):
    """The forward renders each composite primitive, and every hard-loss
    gradient path takes it, unhinted and under the frozen hints: plain
    autograd, K4, K5 and K8 on the CPU (their plain versions), the kernels'
    shape check, the packed and the pytree hard train steps. Each gives a
    finite gradient that reaches the primitive's slots."""
    from fourd_ray_tracing_tpu_torch import diff
    from fourd_ray_tracing_tpu_torch.ops.cuda import ablate, gradkernel

    scene = composite_scene(field)
    _, tc = cameras(("yxz",))
    base = trenderer.RenderConfig(width=8, height=4, samples=1, reflections_amount=2,
                                  rng_mode="per_sample")
    packed, lay = params.pack(scene, tc), params.layout(scene, tc)
    assert lay.composite_kinds() == (field,) == scene.composite_kinds()
    first = getattr(lay, field)
    target, cot = torch.full((4, 8, 3), 0.5), torch.ones((4, 8, 3))
    for cfg in (base, diff.with_frozen_hints(base, scene)):
        assert torch.isfinite(trenderer.render_light(scene, tc, cfg, 1)).all()
        gradkernel.check_shape(lay, cfg)
        loss, grad = gradkernel.loss_and_grad_packed(packed, scene, tc, cfg, 1, target)
        vjp = gradkernel.render_light_vjp_plain(packed, scene, tc, cfg, 1, cot)
        for g in (grad, vjp):
            assert torch.isfinite(g).all() and g[first:].abs().max() > 0.0
        assert torch.isfinite(diff.image_loss(scene, tc, cfg, 1, target))
        assert float(ablate.variant_plain("loss", scene, tc, cfg, 1, target)) > 0.0
        step, init, _ = diff.make_packed_train_step(cfg, 1e-3, tc, scene)
        model, opt = init(scene)
        assert torch.isfinite(step(model, opt, 1, target))
        step, init = diff.make_train_step(cfg, 1e-3, tc)
        state, opt = init(scene)
        assert torch.isfinite(step(state, opt, 1, target)[2])


@pytest.mark.parametrize("field", ["cylinders", "cylinders_union", "hypercube", "tiger"])
def test_composite_primitives_raise(field):
    """Once refused, now taken: the soft paths (the soft loss, its kernel
    route, K6's plain version and launch check, the soft zero map, the soft
    train step) take a scene with a composite primitive as their object,
    unhinted and under the frozen hints, each with a finite loss and a
    gradient that reaches the primitive's slots."""
    from fourd_ray_tracing_tpu_torch import diff
    from fourd_ray_tracing_tpu_torch.ops.cuda import gradkernel

    scene = composite_scene(field)
    _, tc = cameras(("yxz",))
    base = trenderer.RenderConfig(width=8, height=4, samples=1, reflections_amount=1,
                                  rng_mode="per_sample")
    packed, lay = params.pack(scene, tc), params.layout(scene, tc)
    first = getattr(lay, field)
    target = torch.zeros((4, 8, 3))
    ref = (field, 0 if field == "cylinders" else None)
    zero_map = params.soft_zero_map(scene, tc, ref)
    gradkernel.check_zero_map(zero_map, lay)
    for cfg in (base, diff.with_frozen_hints(base, scene)):
        trenderer.check_trainable(cfg)
        vec = packed.clone().requires_grad_(True)
        losses = {
            "soft_loss": diff.soft_image_loss(*params.unpack(vec, scene, tc), cfg, 1, target,
                                              object_ref=ref),
            "soft_kernel": diff.soft_image_loss_kernel(vec, scene, tc, cfg, 1, target, ref),
        }
        for name, loss in losses.items():
            (grad,) = torch.autograd.grad(loss, vec)
            assert torch.isfinite(loss) and torch.isfinite(grad).all(), name
            assert grad[first:lay.env].abs().max() > 0, name
        alpha = diff.object_coverage(scene, ref, tc, cfg, 0.05)
        loss, grad, g_alpha = gradkernel.render_soft_loss_and_grad_plain(
            packed, scene, tc, cfg, 1, target, alpha, zero_map)
        assert torch.isfinite(grad).all() and torch.isfinite(g_alpha).all()
        np.testing.assert_allclose(float(loss), float(losses["soft_loss"].detach()), rtol=1e-5)
        step, init = diff.make_train_step(cfg, 1e-3, tc, soft_object_ref=ref)
        state, opt = init(scene)
        assert torch.isfinite(step(state, opt, 1, target)[2])


@pytest.mark.parametrize("name", ["hypercube", "duocylinder", "tiger"])
def test_unported_library_scenes_raise(name):
    """Once raising, now in the library: each composite scene's leaves
    equal the JAX library scene's, in tree_flatten order."""
    import jax

    ref = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(jlib.SCENES[name]())]
    ours = [t.numpy() for t in params.tree_leaves(tlib.scene_by_name(name, CPU))]
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    assert tlib.scene_by_name(name, CPU).composite_kinds() != ()


def test_library_has_the_slice_scenes():
    assert sorted(tlib.SCENES) == sorted(jlib.SCENES)
    assert isinstance(tlib.scene_by_name("room_with_sphere", CPU), Scene)
    with pytest.raises(KeyError):
        tlib.scene_by_name("no_such_scene", CPU)


def test_render_config_mirrors_jax():
    """Field for field, with the same defaults."""
    jf = [(f.name, f.default) for f in dataclasses.fields(jrenderer.RenderConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(trenderer.RenderConfig)]
    assert tf == jf


@pytest.mark.parametrize("views", [("yxz",), ("ywz",), ("yxw",), tcam.VIEWS_ALL])
def test_camera_bases_match_jax(views):
    """The Givens basis: equal to float32 rounding (the two libraries'
    sin/cos may differ by an ulp)."""
    jc, tc = cameras(views)
    for a, b in [*zip(tc.top, jc.top), *zip(tc.right, jc.right), *zip(tc.vec_to_mtr, jc.vec_to_mtr)]:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-7)


@pytest.mark.parametrize("view", ["yxz", "ywz", "yxw"])
def test_camera_from_state_packs_like_jax(view):
    jc = jcam.camera_from_state(JVec4.of(0.5, -2.0, 0.25, 0.0),
                                jcam.CameraAngles(*(jnp.float32(a) for a in ANGLES)), 1.5, 2.0, view)
    tc = tcam.camera_from_state(TVec4.of(0.5, -2.0, 0.25, 0.0, device=CPU),
                                tcam.CameraAngles.of(*ANGLES, device=CPU), 1.5, 2.0, view, device=CPU)
    scene = tlib.room_with_sphere(CPU)
    ref = np.asarray(_pack_pytree((jlib.room_with_sphere(), jc))[0])
    np.testing.assert_allclose(params.pack(scene, tc).numpy(), ref, rtol=0, atol=1e-7)


def test_angles_normalize_like_jax():
    ja = jcam.CameraAngles(jnp.float32(4.0), jnp.float32(2.0), jnp.float32(-1.0)).normalized(0.0, 0.5)
    ta = tcam.CameraAngles.of(4.0, 2.0, -1.0, device=CPU).normalized(0.0, 0.5)
    for a, b in zip(ta, ja):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
