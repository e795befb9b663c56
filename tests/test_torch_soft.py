"""The port's soft-silhouette slice (diff.py coverage, object surgery and
soft losses, params.soft_zero_map/stack_rows, make_train_step's soft
options, inverse_render --param position) against the JAX package's
diff.py and gradkernel.soft_zero_map on the CPU.

Same shape as test_torch_diff.py: 32x16, 2 spp, 2 bounces,
light_coefficient 0.7, per-sample RNG. Each JAX gradient runs once (a
module-scoped fixture): one takes 10-30 s here. Tolerances: coverage
within rtol 1e-5 (elementwise jnp against torch, no sums) above the
smallest normal float; packed
vectors and zero maps bitwise; the soft loss within rtol 1e-5 and every
gradient within the mixed-scale relative error 1e-3 of
test_torch_diff.py with the same non-zero pattern (XLA on the CPU fuses
multiply-adds, torch does not).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourd_ray_tracing_tpu import camera as jcam
from fourd_ray_tracing_tpu import diff as jdiff
from fourd_ray_tracing_tpu.models import library as jlib
from fourd_ray_tracing_tpu.models import renderer as jrenderer
from fourd_ray_tracing_tpu.ops.pallas.gradkernel import soft_zero_map as jsoft_zero_map
from fourd_ray_tracing_tpu.ops.pallas.megakernel import _pack_pytree
from fourd_ray_tracing_tpu.ops.vec4 import Vec4 as JVec4

from fourd_ray_tracing_tpu_torch import camera as tcam
from fourd_ray_tracing_tpu_torch import diff, inverse_render
from fourd_ray_tracing_tpu_torch.models import library as tlib
from fourd_ray_tracing_tpu_torch.models import params
from fourd_ray_tracing_tpu_torch.models import renderer as trenderer
from fourd_ray_tracing_tpu_torch.ops.cuda import gradkernel as tgrad
from fourd_ray_tracing_tpu_torch.ops.cuda import megakernel as tkernel
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4 as TVec4

CPU = torch.device("cpu")
SHAPE = dict(width=32, height=16, samples=2, reflections_amount=2, rng_mode="per_sample",
             light_coefficient=0.7)
J_CFG = jrenderer.RenderConfig(**SHAPE)
T_CFG = trenderer.RenderConfig(**SHAPE)
SEED = 5
EDGE = 0.08
LR = 1e-2  # make_train_step's learning rate
# XLA on the CPU flushes subnormal floats to zero, torch does not: far
# outside the edge band a coverage can be subnormal on one side only.
TINY = float(np.finfo(np.float32).tiny)
VIEWS = [("yxz",), tcam.VIEWS_ALL]
# (scene, object) of the soft-loss checks: a sphere and a wall of the
# room, and the lamp of the scene inverse_render --param position fits.
SOFT_CASES = [("room_with_sphere", ("spheres", 0)), ("room_with_sphere", ("spaces", 0)),
              ("sphere_plane_light", ("spheres", 1))]
COVERAGE_CASES = SOFT_CASES + [("room_with_sphere", ("spheres", 1)),
                               ("room_with_sphere", ("spaces", 5)),
                               ("sphere_plane_light", ("spaces", 0))]
SPHERE_CASES = [("room_with_sphere", ("spheres", 0)), ("room_with_sphere", ("spheres", 1)),
                ("sphere_plane_light", ("spheres", 0)), ("sphere_plane_light", ("spheres", 1))]


def crossed(name, views=("yxz",)):
    """(JAX scene, JAX camera, port scene, port camera): a tilted camera,
    the port's leaves crossed over from the JAX pair as numpy."""
    o = jcam.orientation_from_angles(jnp.float32(0.1), jnp.float32(-0.2), jnp.float32(0.3))
    jtop, jright = (jcam.view_basis(o, views[0]) if len(views) == 1
                    else jcam.batched_view_bases(o, views))
    mtr_h = jnp.float32(2.0)
    jc = jcam.Camera(JVec4.of(0.0, -2.0, 0.3, 0.1), o.forward * jnp.float32(1.5), jtop, jright,
                     mtr_h * jcam.GOLDEN, mtr_h)
    to = tcam.orientation_from_angles(*tcam.CameraAngles.of(0.1, -0.2, 0.3, device=CPU), CPU)
    tc_like = tcam.make_camera(TVec4.of(0.0, -2.0, 0.3, 0.1, device=CPU), to, 1.5, 2.0, views,
                               CPU)
    js = jlib.SCENES[name]()
    np_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves((js, jc))]
    ts, tc = params.from_numpy_leaves(np_leaves, tlib.SCENES[name](CPU), tc_like)
    return js, jc, ts, tc


def target_image(seed=1, shape=(16, 32, 3)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def flat(tree):
    return np.concatenate([np.asarray(x, np.float32).reshape(-1)
                           for x in jax.tree_util.tree_leaves(tree)])


def mixed_rel(a, b):
    scale = np.maximum(np.abs(b), 1e-3 * np.abs(b).max() + 1e-8)
    return float((np.abs(a - b) / scale).max())


def assert_grad_close(grad, ref):
    assert grad.shape == ref.shape and np.isfinite(grad).all()
    assert mixed_rel(grad, ref) < 1e-3
    np.testing.assert_array_equal(grad != 0, ref != 0)
    assert np.abs(ref).max() > 1e-6


def case_id(case):
    name, (kind, idx) = case
    return f"{name}-{kind}{idx}"


@pytest.fixture(scope="module")
def jax_soft_value_and_grad():
    """jax.value_and_grad(diff.soft_image_loss, argnums=(0, 1)) per soft
    case, as (loss, packed gradient)."""
    out = {}
    for name, ref in SOFT_CASES:
        js, jc, _, _ = crossed(name)
        loss, (gs, gc) = jax.value_and_grad(jdiff.soft_image_loss, argnums=(0, 1))(
            js, jc, J_CFG, SEED, jnp.asarray(target_image()), edge_width=EDGE, object_ref=ref)
        out[(name, ref)] = (float(loss), np.concatenate([flat(gs), flat(gc)]))
    return out


@pytest.mark.parametrize("views", VIEWS, ids=["1view", "3view"])
@pytest.mark.parametrize("case", COVERAGE_CASES, ids=case_id)
def test_object_coverage_matches_jax(case, views):
    name, ref = case
    js, jc, ts, tc = crossed(name, views)
    got = diff.object_coverage(ts, ref, tc, T_CFG, EDGE).numpy()
    want = np.asarray(jdiff.object_coverage(js, ref, jc, J_CFG, EDGE))
    assert got.shape == want.shape == ((16, 32) if len(views) == 1 else (3, 16, 32))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=TINY)
    assert 0.0 < got.max() <= 1.0 and got.min() >= 0.0


def test_primary_coverage_matches_jax():
    js, jc, ts, tc = crossed("room_with_sphere")
    sj, st = js.spheres[0], ts.spheres[0]
    got = diff.primary_coverage(st.center, st.r, tc, T_CFG, 0.05).numpy()
    want = np.asarray(jdiff.primary_coverage(sj.center, sj.r, jc, J_CFG, 0.05))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=TINY)
    assert got.max() > 0.5 > got.min()


@pytest.mark.parametrize("views", VIEWS, ids=["1view", "3view"])
@pytest.mark.parametrize("case", SPHERE_CASES, ids=case_id)
def test_soft_zero_map_matches_jax(case, views):
    name, ref = case
    js, jc, ts, tc = crossed(name, views)
    zero_map = params.soft_zero_map(ts, tc, ref)
    assert zero_map == jsoft_zero_map(js, jc, ref)
    lay = params.layout(ts, tc)
    assert zero_map == ((lay.spheres + params.SPHERE_FLOATS * ref[1] + 4, 0.0),)


@pytest.mark.parametrize("case", SOFT_CASES + SPHERE_CASES[1:3], ids=case_id)
def test_object_surgery_packs_as_jax(case):
    """drop_object (and, for a sphere, zero_object) packs bitwise as the
    JAX package's, and the zero map turns the packed scene into the
    packed zero_object scene."""
    name, ref = case
    js, jc, ts, tc = crossed(name)
    dropped = params.pack(diff.drop_object(ts, ref), tc).numpy()
    np.testing.assert_array_equal(dropped, np.asarray(_pack_pytree((jdiff.drop_object(js, ref),
                                                                     jc))[0]))
    if ref[0] == "spheres":
        zeroed = params.pack(diff.zero_object(ts, ref), tc)
        np.testing.assert_array_equal(
            zeroed.numpy(), np.asarray(_pack_pytree((jdiff.zero_object(js, ref), jc))[0]))
        row = tgrad.zero_row(params.pack(ts, tc), params.soft_zero_map(ts, tc, ref))
        assert torch.equal(row, zeroed)
        assert len(diff.drop_sphere(ts, ref[1]).spheres) == len(ts.spheres) - 1
    else:
        with pytest.raises(ValueError, match="spaces"):
            diff.zero_object(ts, ref)


@pytest.mark.parametrize("views", VIEWS, ids=["1view", "3view"])
@pytest.mark.parametrize("case", SPHERE_CASES, ids=case_id)
def test_zero_object_light_is_drop_object_light(case, views):
    """A zero-radius sphere is a guaranteed miss: the light of zero_object
    is bitwise that of drop_object, and the two-row render's rows are the
    single renders."""
    name, ref = case
    _, _, ts, tc = crossed(name, views)
    zeroed = trenderer.render_light(diff.zero_object(ts, ref), tc, T_CFG, SEED)
    dropped = trenderer.render_light(diff.drop_object(ts, ref), tc, T_CFG, SEED)
    assert torch.equal(zeroed, dropped)
    pair = diff.render_light_pair(ts, diff.zero_object(ts, ref), tc, T_CFG, SEED)
    multi = tkernel.render_light_cuda_multi((ts, diff.zero_object(ts, ref)), tc, T_CFG, SEED)
    assert torch.equal(pair, multi) and torch.equal(pair[1], zeroed)
    assert torch.equal(pair[0], trenderer.render_light(ts, tc, T_CFG, SEED))


def test_stack_rows_needs_same_structure():
    _, _, ts, tc = crossed("room_with_sphere")
    rows = params.stack_rows((ts, diff.zero_object(ts, ("spheres", 0))), tc)
    assert rows.shape == (2, params.layout(ts, tc).size)
    with pytest.raises(ValueError, match="same-structure"):
        params.stack_rows((ts, diff.drop_object(ts, ("spheres", 0))), tc)


@pytest.mark.parametrize("kind", diff.COMPOSITE_KINDS)
def test_composite_kinds_raise(kind):
    _, _, ts, tc = crossed("room_with_sphere")
    for fn in (lambda: diff.object_coverage(ts, (kind, 0), tc, T_CFG, EDGE),
               lambda: diff.drop_object(ts, (kind, 0)),
               lambda: diff.zero_object(ts, (kind, 0)),
               lambda: diff.soft_image_loss(ts, tc, T_CFG, SEED, torch.zeros(16, 32, 3),
                                            object_ref=(kind, 0))):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 4"):
            fn()
    with pytest.raises(ValueError, match="unknown object kind"):
        diff.object_coverage(ts, ("cones", 0), tc, T_CFG, EDGE)


@pytest.mark.parametrize("case", SOFT_CASES, ids=case_id)
def test_soft_loss_matches_jax_value_and_grad(case, jax_soft_value_and_grad):
    name, ref = case
    _, _, ts, tc = crossed(name)
    vec = params.pack(ts, tc).clone().requires_grad_(True)
    scene, camera = params.unpack(vec, ts, tc)
    loss = diff.soft_image_loss(scene, camera, T_CFG, SEED, torch.from_numpy(target_image()),
                                edge_width=EDGE, object_ref=ref)
    loss.backward()
    ref_loss, ref_grad = jax_soft_value_and_grad[case]
    np.testing.assert_allclose(float(loss.detach()), ref_loss, rtol=1e-5)
    assert_grad_close(vec.grad.numpy(), ref_grad)
    if ref[0] == "spheres":  # the coverage carries the sphere's center gradient
        base = params.layout(ts, tc).spheres + params.SPHERE_FLOATS * ref[1]
        assert np.abs(vec.grad.numpy()[base:base + 4]).max() > 0


@pytest.mark.parametrize("ref", [("spheres", 0), ("spaces", 0)], ids=["spheres0", "spaces0"])
def test_soft_loss_kernel_cpu_route_is_the_plain_loss(ref):
    """On the CPU soft_image_loss_kernel is soft_image_loss over the
    unpacked vector, and launches nothing."""
    _, _, ts, tc = crossed("room_with_sphere")
    target = torch.from_numpy(target_image())
    before = (tgrad.SOFT_LAUNCHES, tgrad.VJP_LAUNCHES, tkernel.LAUNCHES)
    vec = params.pack(ts, tc).clone().requires_grad_(True)
    loss = diff.soft_image_loss_kernel(vec, ts, tc, T_CFG, SEED, target, ref, EDGE)
    (grad,) = torch.autograd.grad(loss, vec)
    vec2 = params.pack(ts, tc).clone().requires_grad_(True)
    scene, camera = params.unpack(vec2, ts, tc)
    loss2 = diff.soft_image_loss(scene, camera, T_CFG, SEED, target, edge_width=EDGE,
                                 object_ref=ref)
    (grad2,) = torch.autograd.grad(loss2, vec2)
    assert torch.equal(loss, loss2) and torch.equal(grad, grad2)
    assert (tgrad.SOFT_LAUNCHES, tgrad.VJP_LAUNCHES, tkernel.LAUNCHES) == before


def test_render_light_kernel_cpu_route_differentiates_as_the_plain_vjp():
    _, _, ts, tc = crossed("sphere_plane_light", tcam.VIEWS_ALL)
    cot = torch.from_numpy(np.random.default_rng(2).normal(0, 1, (3, 16, 32, 3)).astype(np.float32))
    packed = params.pack(ts, tc)
    vec = packed.clone().requires_grad_(True)
    light = diff.render_light_kernel(vec, ts, tc, T_CFG, SEED)
    (grad,) = torch.autograd.grad(light, vec, cot)
    assert torch.equal(grad, tgrad.render_light_vjp_plain(packed, ts, tc, T_CFG, SEED, cot))
    with pytest.raises(ValueError, match="scalar seed"):
        tgrad.render_light_vjp_plain(packed, ts, tc, T_CFG, [1, 2], cot)


@pytest.mark.parametrize("options", [dict(soft_sphere_index=1),
                                     dict(soft_object_ref=("spaces", 0))],
                         ids=["sphere_index", "object_ref"])
def test_soft_kernel_step_on_cpu_is_the_plain_step(options):
    """make_train_step(impl="kernel") with a soft loss takes bitwise the
    plain step on CPU tensors (its CPU route is the plain expression)."""
    _, _, ts, tc = crossed("sphere_plane_light")
    target = torch.from_numpy(target_image(6))
    results = []
    for impl in ("plain", "kernel"):
        step, init = diff.make_train_step(T_CFG, LR, tc, impl=impl, edge_width=EDGE, **options)
        scene, opt = init(ts)
        for k in range(2):
            scene, opt, loss, _ = step(scene, opt, 11 + k, target)
        results.append((loss, params.pack(scene, tc).detach()))
    assert torch.equal(results[0][0], results[1][0])
    assert torch.equal(results[0][1], results[1][1])


def test_soft_minibatch_raises():
    _, _, _, tc = crossed("room_with_sphere")
    with pytest.raises(ValueError, match="hard loss only"):
        diff.make_train_step(T_CFG, LR, tc, impl="kernel", frames_per_step=4,
                             soft_object_ref=("spheres", 0))


@pytest.mark.parametrize("impl", diff.IMPLS)
def test_inverse_render_recovers_position_on_cpu(impl, capsys):
    rc = inverse_render.main(["--param", "position", "--device", "cpu", "--impl", impl,
                              "--width", "32", "--height", "20", "--steps", "40"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0, out[-1]
    metrics = [json.loads(line) for line in out if line.startswith("{")]
    assert [m["step"] for m in metrics] == [0, 10, 20, 30, 39]
    assert metrics[-1]["loss"] < metrics[0]["loss"]
    assert abs(metrics[-1]["value"] - inverse_render.TRUE_X) < 0.1
    assert abs(metrics[0]["value"] - inverse_render.INIT_X) < 0.05
    assert out[-1].startswith("recovered position=")


def test_inverse_render_position_refuses_packed():
    with pytest.raises(SystemExit, match="--param glow"):
        inverse_render.main(["--param", "position", "--device", "cpu", "--impl", "kernel",
                             "--packed"])


def test_inverse_render_position_setup():
    """The position task's target is the lamp at x = 1.4, its start the
    lamp at x = 1.0 with the true glow, and its filter keeps the lamp's
    center x alone (tools/inverse_render.py:134-145)."""
    args = inverse_render.parse_args(["--param", "position", "--width", "16", "--height", "10"])
    cfg, camera, target, scene0 = inverse_render.setup(args, CPU)
    assert target.shape == (10, 16, 3)
    assert inverse_render.read_center_x(scene0) == pytest.approx(inverse_render.INIT_X)
    assert inverse_render.read_glow(scene0) == pytest.approx(inverse_render.TRUE_GLOW)
    ones = params.map_leaves(torch.ones_like, scene0)
    kept = params.pack(inverse_render.only_lamp_center_x(ones), camera)[:params.n_scene(scene0)]
    lay = params.layout(scene0, camera)
    assert kept.sum() == 1 and kept[lay.spheres + params.SPHERE_FLOATS].item() == 1
    assert dataclasses.asdict(cfg)["width"] == 16
