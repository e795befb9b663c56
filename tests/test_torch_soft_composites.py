"""The soft-silhouette slice over the composite primitives (diff.py's
coverages, drop_object/zero_object, hints_for_dropped, the soft losses and
train step, params.soft_zero_map) against the JAX package on the CPU.

The scenes are the JAX library's duocylinder, hypercube and tiger, and a
floor with two standalone cylinders, the first on unit axes (hinted), the
second turned (test_torch_soft.scene_pair), at test_torch_soft.py's shape
and tilted camera, every leaf crossed over from the JAX pair as numpy. Each
JAX gradient runs once (a module-scoped fixture, 13-25 s each here).
Tolerances: coverage rtol 1e-5 above the smallest normal float, the JAX
reference's reciprocal square root rounded as the port's (see
``port_rsqrt``); zero maps,
packed vectors and hints equal; the soft loss rtol 1e-5 and its gradient
within the mixed-scale 1e-3 with the same non-zero pattern above 1e-7 of
the largest slot (test_torch_diff.assert_matches_jax: a composite's
cancelling cotangents leave float32 residues); the plain pipeline's
zero_object light bitwise its drop_object light.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourd_ray_tracing_tpu import diff as jdiff
from fourd_ray_tracing_tpu.models import scene as jscene
from fourd_ray_tracing_tpu.ops.pallas.gradkernel import soft_zero_map as jsoft_zero_map
from fourd_ray_tracing_tpu.ops.pallas.megakernel import _pack_pytree

from fourd_ray_tracing_tpu_torch import camera as tcam
from fourd_ray_tracing_tpu_torch import diff
from fourd_ray_tracing_tpu_torch.models import params
from fourd_ray_tracing_tpu_torch.models import renderer as trenderer
from fourd_ray_tracing_tpu_torch.ops.cuda import gradkernel as tgrad
from fourd_ray_tracing_tpu_torch.ops.cuda import megakernel as tkernel

from test_torch_adjoint_host import axis_plane_scene
from test_torch_diff import assert_matches_jax
from test_torch_freeze_hints import axis_hints_tuple
from test_torch_soft import (EDGE, J_CFG, SEED, T_CFG, TINY, crossed, flat, target_image)

VIEWS = [("yxz",), tcam.VIEWS_ALL]
# (scene, object) of every composite kind; both cylinders of the
# two-cylinder scene (the hinted one and the turned one).
CASES = [("duocylinder", ("cylinders_union", None)), ("hypercube", ("hypercube", None)),
         ("tiger", ("tiger", None)), ("cylinders", ("cylinders", 0)),
         ("cylinders", ("cylinders", 1))]
# The soft-loss gradient cases (one JAX gradient each).
SOFT_CASES = CASES[:4]
# The zero map's slots of each kind: the radii it writes, and their value.
SLOTS = {"cylinders": (1, 0.0), "cylinders_union": (2, 0.0), "tiger": (4, 0.0),
         "hypercube": (9, -1.0)}


@pytest.fixture
def port_rsqrt(monkeypatch):
    """jax.lax.rsqrt as 1 / sqrt(x), each step correctly rounded, as the
    port's geometry.rsqrt (and the kernels' 1.0f / sqrtf) computes it. A
    family's 1 / |d12| enters every composite coverage; XLA's CPU rsqrt
    rounds about 1 in 5 values an ulp away from it, and the coverage's
    cancellations (perp2 = l2 - b^2, the clip's squared distance) amplify
    that ulp to 1e-5-4e-4 of a coverage value in the edge band. With the
    same rounding the JAX formulas give the port's coverage within 2e-6."""
    monkeypatch.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))


def case_id(case):
    name, (kind, idx) = case
    return f"{name}-{kind}" + ("" if idx is None else str(idx))


@pytest.fixture(scope="module")
def jax_soft_value_and_grad():
    """jax.value_and_grad(diff.soft_image_loss, argnums=(0, 1)) per soft
    case, as (loss, packed gradient, the scene's gradient pytree)."""
    out = {}
    for name, ref in SOFT_CASES:
        js, jc, _, _ = crossed(name)
        loss, (gs, gc) = jax.value_and_grad(jdiff.soft_image_loss, argnums=(0, 1))(
            js, jc, J_CFG, SEED, jnp.asarray(target_image()), edge_width=EDGE, object_ref=ref)
        out[(name, ref)] = (float(loss), np.concatenate([flat(gs), flat(gc)]), gs, gc)
    return out


@pytest.mark.parametrize("views", VIEWS, ids=["1view", "3view"])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_composite_coverage_matches_jax(case, views, port_rsqrt):
    name, ref = case
    js, jc, ts, tc = crossed(name, views)
    got = diff.object_coverage(ts, ref, tc, T_CFG, EDGE).numpy()
    want = np.asarray(jdiff.object_coverage(js, ref, jc, J_CFG, EDGE))
    assert got.shape == want.shape == ((16, 32) if len(views) == 1 else (3, 16, 32))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=TINY)
    assert got.max() > 0.5 and got.min() >= 0.0 and got.max() <= 1.0


@pytest.mark.parametrize("views", VIEWS, ids=["1view", "3view"])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_composite_zero_map_matches_jax(case, views):
    """soft_zero_map equals the JAX package's: the cylinder 1 slot, the
    duocylinder 2, the tiger 4 (radius 0), the hypercube 9 (its r and the 8
    cells' r, -1); every map fits K6's cap."""
    name, ref = case
    js, jc, ts, tc = crossed(name, views)
    zero_map = params.soft_zero_map(ts, tc, ref)
    assert zero_map == jsoft_zero_map(js, jc, ref)
    n, value = SLOTS[ref[0]]
    assert len(zero_map) == n <= tgrad.MAX_ZERO_SLOTS
    assert all(v == value for _, v in zero_map)
    tgrad.check_zero_map(zero_map, params.layout(ts, tc))


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_composite_surgery_packs_as_jax(case):
    """drop_object and zero_object pack bitwise as the JAX package's, and
    the zero map turns the packed scene into the packed zero_object
    scene."""
    name, ref = case
    js, jc, ts, tc = crossed(name)
    for port, jax_fn in ((diff.drop_object, jdiff.drop_object),
                         (diff.zero_object, jdiff.zero_object)):
        np.testing.assert_array_equal(params.pack(port(ts, ref), tc).numpy(),
                                      np.asarray(_pack_pytree((jax_fn(js, ref), jc))[0]))
    zeroed = params.pack(diff.zero_object(ts, ref), tc)
    assert torch.equal(tgrad.zero_row(params.pack(ts, tc), params.soft_zero_map(ts, tc, ref)),
                       zeroed)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_hints_for_dropped_matches_jax(case):
    """hints_for_dropped under with_frozen_hints equals the JAX package's
    _hints_for_dropped: the dropped composite's axis hints gone (a dropped
    cylinder its entry), the plane hints kept."""
    name, ref = case
    js, _, ts, _ = crossed(name)
    j = jdiff._hints_for_dropped(jdiff.with_frozen_hints(J_CFG, js), ref)
    t = diff.hints_for_dropped(diff.with_frozen_hints(T_CFG, ts), ref)
    assert (t.plane_hints, t.plane_pairs) == (j.plane_hints, j.plane_pairs)
    assert axis_hints_tuple(t.axis_hints) == axis_hints_tuple(j.axis_hints)
    assert t.freeze_hints and j.freeze_hints


@pytest.mark.parametrize("frozen", [False, True], ids=["unhinted", "frozen_hints"])
@pytest.mark.parametrize("views", VIEWS, ids=["1view", "3view"])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_composite_zero_object_light_is_drop_object_light(case, views, frozen):
    """A zeroed composite (radii 0, the hypercube's -1) is a guaranteed
    miss in the plain pipeline, hinted or not: its light is bitwise
    drop_object's (rendered under hints_for_dropped), and the two-row
    render's rows are the single renders."""
    name, ref = case
    _, _, ts, tc = crossed(name, views)
    cfg = diff.with_frozen_hints(T_CFG, ts) if frozen else T_CFG
    zeroed = diff.zero_object(ts, ref)
    light = trenderer.render_light(zeroed, tc, cfg, SEED)
    assert torch.equal(light, trenderer.render_light(diff.drop_object(ts, ref), tc,
                                                     diff.hints_for_dropped(cfg, ref), SEED))
    pair = tkernel.render_light_cuda_multi((ts, zeroed), tc, cfg, SEED)
    assert torch.equal(pair[1], light)
    assert torch.equal(pair[0], trenderer.render_light(ts, tc, cfg, SEED))


@pytest.mark.parametrize("case", SOFT_CASES, ids=case_id)
def test_composite_soft_loss_matches_jax(case, jax_soft_value_and_grad):
    """soft_image_loss and its packed gradient against
    jax.value_and_grad(diff.soft_image_loss)."""
    name, ref = case
    _, _, ts, tc = crossed(name)
    vec = params.pack(ts, tc).clone().requires_grad_(True)
    loss = diff.soft_image_loss(*params.unpack(vec, ts, tc), T_CFG, SEED,
                                torch.from_numpy(target_image()), edge_width=EDGE, object_ref=ref)
    loss.backward()
    ref_loss, ref_grad, _, _ = jax_soft_value_and_grad[case]
    assert_matches_jax(loss.detach(), vec.grad.numpy(), ref_loss, ref_grad, True)


@pytest.mark.parametrize("case", SOFT_CASES, ids=case_id)
def test_frozen_composite_soft_loss_matches_jax(case, jax_soft_value_and_grad):
    """Under with_frozen_hints the soft loss folds the hinted pipeline and
    stops the frozen leaves, the coverage's too: the frozen slots exactly
    0, every other slot and the loss within the tolerances of the JAX
    package's unhinted gradient with its freeze_hint_grads applied (its jnp
    route refuses hints)."""
    name, ref = case
    js, _, ts, tc = crossed(name)
    cfg = diff.with_frozen_hints(T_CFG, ts)
    j_cfg = jdiff.with_frozen_hints(J_CFG, js)
    vec = params.pack(ts, tc).clone().requires_grad_(True)
    loss = diff.soft_image_loss(*params.unpack(vec, ts, tc), cfg, SEED,
                                torch.from_numpy(target_image()), edge_width=EDGE, object_ref=ref)
    loss.backward()
    ref_loss, _, gs, gc = jax_soft_value_and_grad[case]
    frozen_gs = jscene.freeze_hint_grads(gs, j_cfg.plane_hints, j_cfg.axis_hints)
    ref_grad = np.concatenate([flat(frozen_gs), flat(gc)])
    grad = vec.grad.numpy()
    mask = params.freeze_mask(cfg, ts, grad.size).numpy()
    assert (mask == 0).any() and np.all(grad[mask == 0] == 0.0)
    np.testing.assert_array_equal(ref_grad[mask == 0], 0.0)
    assert_matches_jax(loss.detach(), grad, ref_loss, ref_grad, True)


@pytest.mark.parametrize("frozen", [False, True], ids=["unhinted", "frozen_hints"])
def test_tiger_soft_kernel_route_on_cpu_is_the_plain_loss(frozen):
    """On the CPU soft_image_loss_kernel of the tiger is soft_image_loss
    over the unpacked vector, bitwise, and launches nothing; K6's plain
    version gives the same loss within float64-summed rounding."""
    _, _, ts, tc = crossed("tiger")
    cfg = diff.with_frozen_hints(T_CFG, ts) if frozen else T_CFG
    ref = ("tiger", None)
    target = torch.from_numpy(target_image())
    before = (tgrad.SOFT_LAUNCHES, tgrad.VJP_LAUNCHES, tkernel.LAUNCHES)
    vec = params.pack(ts, tc).clone().requires_grad_(True)
    loss = diff.soft_image_loss_kernel(vec, ts, tc, cfg, SEED, target, ref, EDGE)
    (grad,) = torch.autograd.grad(loss, vec)
    vec2 = params.pack(ts, tc).clone().requires_grad_(True)
    loss2 = diff.soft_image_loss(*params.unpack(vec2, ts, tc), cfg, SEED, target,
                                 edge_width=EDGE, object_ref=ref)
    (grad2,) = torch.autograd.grad(loss2, vec2)
    assert torch.equal(loss, loss2) and torch.equal(grad, grad2)
    assert (tgrad.SOFT_LAUNCHES, tgrad.VJP_LAUNCHES, tkernel.LAUNCHES) == before
    alpha = diff.object_coverage(ts, ref, tc, cfg, EDGE)
    plain_loss, plain_grad, _ = tgrad.render_soft_loss_and_grad_plain(
        params.pack(ts, tc), ts, tc, cfg, SEED, target, alpha, params.soft_zero_map(ts, tc, ref))
    np.testing.assert_allclose(float(plain_loss), float(loss.detach()), rtol=1e-6)
    assert torch.isfinite(plain_grad).all() and plain_grad.abs().max() > 0


def test_tiger_soft_kernel_step_on_cpu_is_the_plain_step():
    """make_train_step(impl="kernel", soft_object_ref=("tiger", None))
    under with_frozen_hints takes bitwise the plain step on CPU tensors,
    and the frozen leaves stay bitwise constant."""
    _, _, ts, tc = crossed("tiger")
    cfg = diff.with_frozen_hints(T_CFG, ts)
    target = torch.from_numpy(target_image(6))
    start = params.pack(ts, tc)
    results = []
    for impl in diff.IMPLS:
        step, init = diff.make_train_step(cfg, 1e-2, tc, impl=impl, edge_width=EDGE,
                                          soft_object_ref=("tiger", None))
        scene, opt = init(ts)
        for k in range(2):
            scene, opt, loss, metrics = step(scene, opt, 11 + k, target)
        results.append((loss, params.pack(scene, tc).detach()))
        assert torch.isfinite(metrics["grad_norm"]) and metrics["grad_norm"] > 0
    assert torch.equal(results[0][0], results[1][0])
    assert torch.equal(results[0][1], results[1][1])
    mask = params.freeze_mask(cfg, ts, start.numel())
    assert torch.equal(results[0][1][mask == 0], start[mask == 0])
    assert not torch.equal(results[0][1], start)


def test_soft_zero_map_cap_is_enforced():
    """K6 holds at most MAX_ZERO_SLOTS zero-map slots: a longer map is
    refused, never cut (the hypercube's 9 fit)."""
    _, _, ts, tc = crossed("hypercube")
    lay = params.layout(ts, tc)
    zero_map = params.soft_zero_map(ts, tc, ("hypercube", None))
    longer = zero_map + tuple((lay.spaces + k, 0.5) for k in range(tgrad.MAX_ZERO_SLOTS + 1
                                                                     - len(zero_map)))
    assert len(longer) == tgrad.MAX_ZERO_SLOTS + 1
    with pytest.raises(ValueError, match="zero map"):
        tgrad.check_zero_map(longer, lay)
    tgrad.check_zero_map(longer[:-1], lay)


def test_tiger_soft_step_on_a_one_rank_mesh():
    """The mesh route of the soft step (the sharded K6 wrapper: on the CPU
    its plain version on the rank's rows, the coverage summed over the
    ranks) takes the tiger under its frozen hints: on a 1-rank mesh the
    loss and the stepped scene are the step's without a mesh."""
    from fourd_ray_tracing_tpu_torch.parallel import mesh as pmesh

    _, _, ts, tc = crossed("tiger")
    cfg = diff.with_frozen_hints(T_CFG, ts)
    target = torch.from_numpy(target_image(6))
    out = []
    for mesh in (None, pmesh.make_mesh()):
        step, init = diff.make_train_step(cfg, 1e-2, tc, impl="kernel", mesh=mesh,
                                          edge_width=EDGE, soft_object_ref=("tiger", None))
        scene, opt, loss, _ = step(*init(ts), 11, target)
        out.append((loss, params.pack(scene, tc).detach()))
    np.testing.assert_allclose(float(out[1][0]), float(out[0][0]), rtol=1e-6)
    np.testing.assert_allclose(out[1][1].numpy(), out[0][1].numpy(), rtol=1e-5, atol=1e-7)


def test_zero_radius_face_never_hits():
    """A family face of radius 0 is a miss even where perp2 rounds below 0
    (disc = -perp2 > 0, which the JAX package's circle test takes for a
    hit); a positive radius keeps the JAX test's mask."""
    from fourd_ray_tracing_tpu_torch.ops import geometry as tgeo

    _, _, ts, tc = crossed("cylinders")
    o, d = diff._primary_rays(tc, T_CFG)
    cyl = ts.cylinders[1]
    fam = tgeo._cyl_family(cyl.point, cyl.axis1, cyl.axis2, o, d)
    fam = fam._replace(perp2=torch.full_like(fam.perp2, -1e-7))
    zero = torch.zeros(())
    assert not tgeo._family_circle(fam, zero)[2].any()
    _, _, hit, _ = tgeo._family_circle(fam, zero + 0.5)
    receding = ~fam.degenerate & (fam.l2 >= 0.25) & (fam.b < 0.0)
    assert torch.equal(hit, fam.proj_ok & ~receding) and hit.any()


@pytest.mark.parametrize("idx", [0, 1])
def test_zeroed_cylinder_through_its_axis_plane_is_a_miss(idx):
    """On the two-cylinder scene seen level (axis_plane_scene) at 64x36,
    1 spp, 2 bounces, seed 5, some sampled rays pass through the turned
    cylinder's axis plane: its zero_object light is still bitwise its drop_object light,
    and K6's plain version over it (autograd through the zeroed row) is
    finite."""
    scene, camera = axis_plane_scene()
    cfg = trenderer.RenderConfig(width=64, height=36, samples=1, reflections_amount=2,
                                 rng_mode="per_sample")
    ref = ("cylinders", idx)
    zeroed = trenderer.render_light(diff.zero_object(scene, ref), camera, cfg, 5)
    assert torch.equal(zeroed, trenderer.render_light(diff.drop_object(scene, ref), camera, cfg,
                                                      5))
    alpha = diff.object_coverage(scene, ref, camera, cfg, EDGE).detach()
    loss, grad, g_alpha = tgrad.render_soft_loss_and_grad_plain(
        params.pack(scene, camera), scene, camera, cfg, 5, torch.zeros(36, 64, 3), alpha,
        params.soft_zero_map(scene, camera, ref))
    assert torch.isfinite(loss) and torch.isfinite(grad).all() and torch.isfinite(g_alpha).all()
