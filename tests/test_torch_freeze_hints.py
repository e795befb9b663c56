"""The freeze_hints contract of the port's gradient paths against the JAX
package's, on the CPU.

Under the contract (diff.with_frozen_hints) the gradient kernels fold with
the forward's static hints; the hyperplane normals' and the hinted axes'
gradients are defined zero (models/scene.py freeze_hint_grads), every other
gradient and the loss stay the unhinted ones. This file holds the pieces
against the JAX package (freeze_hint_grads on every branch, the packed
mask, with_frozen_hints on all five library scenes), the kernel route's CPU
route (its plain version) against the interpret-mode JAX kernel under the
contract on the two scenes the gradient paths take, and the contract
itself on the port: the hinted plain pipeline's gradient equals the
unhinted one's slot by slot outside the frozen slots, which are 0.

Same shape as tests/test_gradkernel.py's CFG: 32x16, 2 spp, 2 bounces,
light_coefficient 0.7. Each JAX kernel reference runs once per scene (a
module-scoped fixture). Tolerances as tests/test_torch_gradkernel.py: loss
rtol 1e-5, gradients within a mixed-scale relative error of 1e-3 (XLA on
the CPU fuses multiply-adds, torch does not); frozen slots exactly 0.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourd_ray_tracing_tpu import camera as jcam
from fourd_ray_tracing_tpu import diff as jdiff
from fourd_ray_tracing_tpu.models import library as jlib
from fourd_ray_tracing_tpu.models import renderer as jrenderer
from fourd_ray_tracing_tpu.models import scene as jscene
from fourd_ray_tracing_tpu.ops import geometry as jgeo
from fourd_ray_tracing_tpu.ops.pallas import gradkernel as jgrad
from fourd_ray_tracing_tpu.ops.vec4 import Vec4 as JVec4

from fourd_ray_tracing_tpu_torch import camera as tcam
from fourd_ray_tracing_tpu_torch import diff
from fourd_ray_tracing_tpu_torch.models import library as tlib
from fourd_ray_tracing_tpu_torch.models import params
from fourd_ray_tracing_tpu_torch.models import renderer as trenderer
from fourd_ray_tracing_tpu_torch.models import scene as tscene
from fourd_ray_tracing_tpu_torch.ops import geometry as tgeo
from fourd_ray_tracing_tpu_torch.ops.cuda import gradkernel as tgrad
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4 as TVec4

CPU = torch.device("cpu")
ALL_SCENES = ["room_with_sphere", "sphere_plane_light", "duocylinder", "tiger", "hypercube"]
SCENES = ["room_with_sphere", "sphere_plane_light"]  # the gradient paths'
SHAPE = dict(width=32, height=16, samples=2, reflections_amount=2, rng_mode="per_sample",
             light_coefficient=0.7)
J_CFG = jrenderer.RenderConfig(**SHAPE)
T_CFG = trenderer.RenderConfig(**SHAPE)
SEED = 5


def jax_camera():
    zero = jnp.float32(0)
    return jcam.camera_from_state(JVec4.of(0.0, -2.0, 0.0, 0.0),
                                  jcam.CameraAngles(zero, zero, zero), 1.5, 2.0)


def torch_camera():
    return tcam.camera_from_state(TVec4.of(0.0, -2.0, 0.0, 0.0, device=CPU),
                                  tcam.CameraAngles.of(0.0, 0.0, 0.0, device=CPU), 1.5, 2.0,
                                  device=CPU)


def crossed(name):
    """(JAX scene, JAX camera, port scene, port camera): the port's pair
    holds the JAX pair's leaves, crossed over as numpy."""
    js, jc = jlib.SCENES[name](), jax_camera()
    np_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves((js, jc))]
    ts, tc = params.from_numpy_leaves(np_leaves, tlib.SCENES[name](CPU), torch_camera())
    return js, jc, ts, tc


def target_image(seed=3):
    return np.random.default_rng(seed).uniform(0, 1, (16, 32, 3)).astype(np.float32)


def flat(tree):
    return np.concatenate([np.asarray(x, np.float32).reshape(-1)
                           for x in jax.tree_util.tree_leaves(tree)])


def tflat(tree):
    return torch.cat([t.detach().reshape(-1) for t in params.tree_leaves(tree)]).numpy()


def mixed_rel(a, b):
    scale = np.maximum(np.abs(b), 1e-3 * np.abs(b).max() + 1e-8)
    return float((np.abs(a - b) / scale).max())


def axis_hints_tuple(ah):
    """AxisHints of either package as plain tuples."""
    return None if ah is None else tuple(ah)


@pytest.mark.parametrize("name", ALL_SCENES)
def test_freeze_hint_grads_matches_jax(name):
    """models.scene.freeze_hint_grads zeroes what the JAX function zeroes,
    on every branch (test_gradkernel.py:377): an all-ones scene frozen under
    each scene's own plane and axis hints, packed."""
    js, _, ts, _ = crossed(name)
    j_hints, j_ah = jscene.plane_norm_hints(js), jscene.axis_alignment_hints(js)
    t_hints, t_ah = tscene.plane_norm_hints(ts), tscene.axis_alignment_hints(ts)
    assert t_hints == j_hints and axis_hints_tuple(t_ah) == axis_hints_tuple(j_ah)
    j_out = flat(jscene.freeze_hint_grads(jax.tree_util.tree_map(jnp.ones_like, js), j_hints,
                                          j_ah))
    t_out = tflat(tscene.freeze_hint_grads(params.map_leaves(torch.ones_like, ts), t_hints,
                                           t_ah))
    np.testing.assert_array_equal(t_out, j_out)
    assert (t_out == 0).any() == (j_hints is not None or j_ah is not None)


@pytest.mark.parametrize("name", ALL_SCENES)
def test_with_frozen_hints_matches_jax(name):
    """diff.with_frozen_hints derives the JAX package's cfg: the contract
    on, the same plane hints, pairs, axis hints and grad_sample_chunk (the
    largest divisor of samples up to 8), at 2, 6, 8 and 12 spp."""
    js, _, ts, _ = crossed(name)
    for samples in (2, 6, 8, 12):
        j = jdiff.with_frozen_hints(dataclasses.replace(J_CFG, samples=samples), js)
        t = diff.with_frozen_hints(dataclasses.replace(T_CFG, samples=samples), ts)
        assert t.freeze_hints and j.freeze_hints
        assert (t.plane_hints, t.plane_pairs, t.grad_sample_chunk) == \
            (j.plane_hints, j.plane_pairs, j.grad_sample_chunk), (name, samples)
        assert axis_hints_tuple(t.axis_hints) == axis_hints_tuple(j.axis_hints)
    # A scene whose leaves require grad (a training scene) gives the same.
    leaves = params.map_leaves(lambda x: x.clone().requires_grad_(True), ts)
    assert diff.with_frozen_hints(T_CFG, leaves) == diff.with_frozen_hints(T_CFG, ts)


@pytest.mark.parametrize("name", ALL_SCENES)
def test_freeze_mask_matches_jax_packed_mask(name):
    """params.freeze_mask is the packed 0/1 vector JAX
    make_packed_loss_and_grad builds under the contract
    (gradkernel.py:1011-1017), read from its closure."""
    js, jc, ts, _ = crossed(name)
    fn, _, _ = jgrad.make_packed_loss_and_grad(js, jc, jdiff.with_frozen_hints(J_CFG, js))
    cells = dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))
    mask = params.freeze_mask(diff.with_frozen_hints(T_CFG, ts), ts)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(cells["mask_vec"]))
    assert params.freeze_mask(T_CFG, ts) is None


# Unit axes, and the same turned by 0.3 rad in the x-y plane (in float32).
UNIT = ((1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 0), (0, 0, 0, 1))
_C, _S = float(np.float32(np.cos(0.3))), float(np.float32(np.sin(0.3)))


def _turned(v):
    x, y, z, w = v
    return (float(np.float32(_C * x - _S * y)), float(np.float32(_S * x + _C * y)), z, w)


def custom_scene(name, mod, geo, vec, device=None):
    """Scenes whose branches of freeze_hint_grads no library scene reaches,
    built by one package's constructors: "cylinders", a floor and two
    standalone cylinders, the first on unit axes (hinted), the second
    turned (not); "hypercube_tiger", a floor and a wall with a hypercube
    and a tiger on unit axes (plane hints beside both composites' axis
    hints)."""
    kw = {} if device is None else {"device": device}
    extra = () if device is None else (device,)

    def mat(color):
        return mod.material(0, 0, color, *extra)

    def wall(point, norm):
        return mod.space(point, norm, mat((0.4, 0.25, 0.07)), *extra)

    floor = wall((0, 0, -1.5, 0), (0, 0, 1, 0))
    if name == "cylinders":
        cyls = (mod.cylinder((0, 2, 0, 0), UNIT[0], UNIT[3], 0.8, mat((1.0, 0.2, 0.2)), *extra),
                mod.cylinder((0.5, 2, 0, 0), _turned(UNIT[2]), _turned(UNIT[1]), 0.6,
                             mat((0.2, 0.9, 0.3)), *extra))
        return mod.Scene(spaces=(floor,), cylinders=cyls)
    center = vec.of(0.0, 2.0, 0.0, 0.0, **kw)
    return mod.Scene(
        spaces=(floor, wall((0, 4, 0, 0), (0, -1, 0, 0))),
        hypercube=geo.make_hypercube(center, *(vec.of(*a, **kw) for a in UNIT), 1.0,
                                     tuple(mat((0.1 * k, 0.5, 0.9)) for k in range(8))),
        tiger=geo.make_tiger(center, *(vec.of(*UNIT[k], **kw) for k in (0, 3, 2, 1)), 0.9, 1.4,
                             mat((1.0, 0.0, 0.0)), mat((0.07, 0.67, 0.25))))


CUSTOM = ["cylinders", "hypercube_tiger"]


def many_planes(mod, device=None):
    """room_with_sphere with 57 more floor planes below the room, 65
    hyperplanes: more than the kernels' fold table holds hints for
    (build.MAX_HINT_PLANES), built by one package's constructors."""
    extra = () if device is None else (device,)
    room = (tlib.room_with_sphere(device) if device is not None else jlib.room_with_sphere())
    floors = tuple(mod.space((0, 0, -3.625 - 0.125 * k, 0), (0, 0, 1, 0),
                             mod.material(0, 0, (0.5, 0.5, 0.5), *extra), *extra)
                   for k in range(57))
    return room._replace(spaces=room.spaces + floors)


@pytest.mark.parametrize("name", CUSTOM)
def test_freeze_hint_grads_matches_jax_on_custom_scenes(name):
    """freeze_hint_grads against the JAX function on the branches the
    library leaves out: a hinted and an unhinted standalone cylinder (the
    scene's own hints, then per-cylinder hints shorter than the cylinders,
    which leave the second one free), and plane hints beside the
    hypercube's and the tiger's axis hints; then the packed mask against
    JAX make_packed_loss_and_grad's under with_frozen_hints."""
    js = custom_scene(name, jscene, jgeo, JVec4)
    ts = custom_scene(name, tscene, tgeo, TVec4, CPU)
    j_hints, j_ah = jscene.plane_norm_hints(js), jscene.axis_alignment_hints(js)
    t_hints, t_ah = tscene.plane_norm_hints(ts), tscene.axis_alignment_hints(ts)
    assert t_hints == j_hints is not None and axis_hints_tuple(t_ah) == axis_hints_tuple(j_ah)
    if name == "cylinders":
        assert j_ah.cylinders[0] is not None and j_ah.cylinders[1] is None
        cases = [(j_ah, t_ah), (j_ah._replace(cylinders=j_ah.cylinders[:1]),
                                t_ah._replace(cylinders=t_ah.cylinders[:1]))]
    else:
        assert j_ah.hypercube is not None and j_ah.tiger is not None
        cases = [(j_ah, t_ah)]
    for j_case, t_case in cases + [(None, None)]:
        j_out = flat(jscene.freeze_hint_grads(jax.tree_util.tree_map(jnp.ones_like, js),
                                              j_hints, j_case))
        t_out = tflat(tscene.freeze_hint_grads(params.map_leaves(torch.ones_like, ts),
                                               t_hints, t_case))
        np.testing.assert_array_equal(t_out, j_out)
    # Each hinted composite axis is frozen, the turned cylinder's are not.
    frozen = int((t_out == 0).sum())
    t_all = tflat(tscene.freeze_hint_grads(params.map_leaves(torch.ones_like, ts), t_hints, t_ah))
    axes = 8 if name == "cylinders" else 4 * 4 + 8 * 4  # the hypercube's 4, the tiger's 4 pairs
    assert int((t_all == 0).sum()) == frozen + axes
    jc, tc = jax_camera(), torch_camera()
    fn, _, _ = jgrad.make_packed_loss_and_grad(js, jc, jdiff.with_frozen_hints(J_CFG, js))
    cells = dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))
    mask = params.freeze_mask(diff.with_frozen_hints(T_CFG, ts), ts)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(cells["mask_vec"]))
    np.testing.assert_array_equal(mask.numpy(), t_all)
    lay = params.layout(ts, tc)
    padded = params.freeze_mask(diff.with_frozen_hints(T_CFG, ts), ts, lay.size)
    assert padded.shape == (lay.size,) and torch.equal(padded[:mask.numel()], mask)
    assert torch.all(padded[mask.numel():] == 1)


@pytest.fixture(scope="module")
def pallas_frozen_reference():
    """The interpret-mode JAX kernel's (loss, scene gradient, camera
    gradient) under with_frozen_hints, per gradient scene."""
    out = {}
    for name in SCENES:
        js, jc, _, _ = crossed(name)
        cfg = jdiff.with_frozen_hints(J_CFG, js)
        loss, (gs, gc) = jgrad.render_loss_and_grad_pallas(js, jc, cfg, SEED,
                                                           jnp.asarray(target_image()),
                                                           interpret=True)
        out[name] = (float(loss), flat(gs), flat(gc))
    return out


@pytest.mark.parametrize("name", SCENES)
def test_kernel_route_matches_pallas_under_the_contract(name, pallas_frozen_reference):
    """The kernel route's CPU route under with_frozen_hints (the hinted
    plain pipeline, the frozen slots zeroed) against the interpret-mode JAX
    kernel under it: loss rtol 1e-5, gradients mixed-scale 1e-3, every
    hyperplane normal's slot exactly 0 on both sides."""
    _, _, ts, tc = crossed(name)
    cfg = diff.with_frozen_hints(T_CFG, ts)
    loss, grad = tgrad.loss_and_grad_packed(params.pack(ts, tc), ts, tc, cfg, SEED,
                                            torch.from_numpy(target_image()))
    ref_loss, ref_scene, ref_cam = pallas_frozen_reference[name]
    grad = grad.numpy()
    n = params.n_scene(ts)
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    assert mixed_rel(grad, np.concatenate([ref_scene, ref_cam])) < 1e-3
    frozen = params.freeze_mask(cfg, ts).numpy() == 0
    assert frozen.sum() == 4 * len(ts.spaces)
    assert np.all(grad[:n][frozen] == 0.0) and np.all(ref_scene[frozen] == 0.0)
    assert np.abs(ref_scene).max() > 1e-6


@pytest.mark.parametrize("name", SCENES)
def test_hinted_plain_gradient_is_the_unhinted_one_outside_the_frozen_slots(name):
    """The contract on the port: autograd of the hinted plain pipeline with
    the frozen slots zeroed equals autograd of the unhinted pipeline with
    them zeroed, slot by slot (== takes -0 for +0), and the losses are
    bitwise one."""
    _, _, ts, tc = crossed(name)
    cfg = diff.with_frozen_hints(T_CFG, ts)
    packed, target = params.pack(ts, tc), torch.from_numpy(target_image())
    loss_h, grad_h = tgrad.loss_and_grad_plain(packed, ts, tc, cfg, SEED, target)
    loss_u, grad_u = tgrad.loss_and_grad_plain(packed, ts, tc, T_CFG, SEED, target)
    assert torch.equal(loss_h, loss_u)
    assert torch.equal(grad_h, tgrad.freeze(grad_u, ts, cfg))
    assert grad_h.abs().max() > 0.0


def test_grad_sample_chunk_changes_nothing():
    """The port's sweep has no envelope chunks: grad_sample_chunk 1, 2 and
    8 (with_frozen_hints picks 8 at 8 spp) give bitwise one result."""
    _, _, ts, tc = crossed("room_with_sphere")
    base = dataclasses.replace(T_CFG, width=16, height=8, samples=8)
    cfg = diff.with_frozen_hints(base, ts)
    assert cfg.grad_sample_chunk == 8
    target = torch.from_numpy(target_image()[:8, :16])
    outs = [tgrad.loss_and_grad_packed(params.pack(ts, tc), ts, tc,
                                       dataclasses.replace(cfg, grad_sample_chunk=g), SEED,
                                       target) for g in (1, 2, 8)]
    for loss, grad in outs[1:]:
        assert torch.equal(loss, outs[0][0]) and torch.equal(grad, outs[0][1])


@pytest.mark.parametrize("ref", [("spheres", 0), ("spaces", 0)], ids=["sphere", "wall"])
def test_soft_loss_with_frozen_hints_and_dropped_objects(ref):
    """soft_image_loss_kernel under with_frozen_hints, as
    tests/test_soft.py:435-475 holds soft_image_loss_pallas: dropping the
    sphere keeps the wall hints, dropping a wall drops its hint row and
    turns the pairs off (hints_for_dropped); the loss is the unhinted
    loss bitwise, the gradients flow, every wall normal's gradient is
    exactly 0 and every other slot is the unhinted gradient's."""
    _, _, ts, tc = crossed("room_with_sphere")
    cfg = dataclasses.replace(T_CFG, height=20, light_coefficient=0.3)
    hcfg = diff.with_frozen_hints(cfg, ts)
    assert hcfg.plane_hints is not None and hcfg.plane_pairs is not None
    dropped = diff.hints_for_dropped(hcfg, ref)
    if ref[0] == "spaces":
        assert dropped.plane_pairs is None and len(dropped.plane_hints) == len(ts.spaces) - 1
    else:
        assert dropped == hcfg
    target = torch.zeros((20, 32, 3))

    def value_and_grad(c):
        vec = params.pack(ts, tc).detach().requires_grad_(True)
        loss = diff.soft_image_loss_kernel(vec, ts, tc, c, SEED, target, ref, 0.08)
        (grad,) = torch.autograd.grad(loss, vec)
        return loss.detach(), grad

    loss, grad = value_and_grad(hcfg)
    loss_u, grad_u = value_and_grad(cfg)
    assert float(loss) > 0.0 and torch.equal(loss, loss_u)
    assert torch.isfinite(grad).all() and grad.abs().max() > 1e-8
    frozen = torch.cat([params.freeze_mask(hcfg, ts) == 0,
                        torch.zeros(grad.numel() - params.n_scene(ts), dtype=torch.bool)])
    assert torch.all(grad[frozen] == 0.0)
    assert torch.equal(grad[~frozen], grad_u[~frozen])


def test_packed_adam_step_keeps_frozen_slots_bitwise():
    """make_packed_train_step under with_frozen_hints: over 3 Adam steps the
    frozen slots of the packed vector stay bitwise what they were, the
    others move, and the step matches make_train_step(impl="kernel")."""
    _, _, ts, tc = crossed("room_with_sphere")
    cfg = diff.with_frozen_hints(T_CFG, ts)
    target = torch.from_numpy(target_image())
    step, init, unpack = diff.make_packed_train_step(cfg, 1e-2, tc, ts)
    model, opt = init(ts)
    tstep, tinit = diff.make_train_step(cfg, 1e-2, tc, impl="kernel")
    scene, topt = tinit(ts)
    before = model.scene_vec.detach().clone()
    frozen = params.freeze_mask(cfg, ts) == 0
    for k in range(3):
        loss = step(model, opt, 11 + k, target)
        scene, topt, loss_t, _ = tstep(scene, topt, 11 + k, target)
        assert torch.equal(loss, loss_t)
    after = model.scene_vec.detach()
    assert torch.equal(after[frozen], before[frozen])
    assert not torch.equal(after[~frozen], before[~frozen])
    np.testing.assert_allclose(after.numpy(),
                               params.pack(scene, tc).detach().numpy()[:after.numel()],
                               rtol=1e-6, atol=1e-7)
    assert torch.equal(params.pack(unpack(model), tc)[:after.numel()], after)


def test_many_planes_freeze_like_jax():
    """The hint cap: a scene with more hyperplanes than the kernels' table
    holds hints for (room_with_sphere and 57 more floor planes, 65) gets
    the plane hints under the contract as the JAX package does: the port's
    with_frozen_hints (and the kernel route's _auto_hints) equal JAX's, and
    params.freeze_mask equals the JAX packed mask (gradkernel.py:1011-1017),
    all 260 normal components frozen. The launch rule of the plane count
    then hands the gradient kernels no descriptor (the unhinted fold) and
    the mask; the forward's descriptor folds the planes unhinted."""
    from fourd_ray_tracing_tpu_torch.ops.cuda import build, megakernel

    js, ts = many_planes(jscene), many_planes(tscene, CPU)
    assert len(ts.spaces) == 65 > build.MAX_HINT_PLANES
    j_cfg = jdiff.with_frozen_hints(J_CFG, js)
    t_cfg = diff.with_frozen_hints(T_CFG, ts)
    assert (t_cfg.plane_hints, t_cfg.plane_pairs) == (j_cfg.plane_hints, j_cfg.plane_pairs)
    assert t_cfg.plane_hints is not None
    auto = tgrad._auto_hints(ts, dataclasses.replace(T_CFG, freeze_hints=True))
    assert (auto.plane_hints, auto.plane_pairs) == (t_cfg.plane_hints, t_cfg.plane_pairs)
    fn, _, _ = jgrad.make_packed_loss_and_grad(js, jax_camera(), j_cfg)
    cells = dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))
    mask = params.freeze_mask(t_cfg, ts).numpy()
    np.testing.assert_array_equal(mask, np.asarray(cells["mask_vec"]))
    assert (mask == 0).sum() == 4 * 65
    lay = params.layout(ts, torch_camera())
    assert tgrad.launch_words(lay, t_cfg) is None
    assert megakernel.hint_table(t_cfg, lay)[1] == -1
