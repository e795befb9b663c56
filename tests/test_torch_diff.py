"""The port's training path (diff.py, inverse_render.py) against the JAX
package's diff.py on the CPU.

Same shape as tests/test_gradkernel.py's CFG: 32x16, 2 spp, 2 bounces,
light_coefficient 0.7, per-sample RNG. Each JAX reference runs once (a
module-scoped fixture): a JAX gradient evaluation at this shape takes
15-30 s on a CPU. Gradient tolerances are test_torch_gradkernel.py's: loss
rtol 1e-5, every gradient within a mixed-scale relative error of 1e-3
with the same non-zero pattern (float re-association and XLA's fused
multiply-adds on the CPU; torch does not fuse).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fourd_ray_tracing_tpu import diff as jdiff
from fourd_ray_tracing_tpu import camera as jcam
from fourd_ray_tracing_tpu.models import library as jlib
from fourd_ray_tracing_tpu.models import renderer as jrenderer
from fourd_ray_tracing_tpu.ops.vec4 import Vec4 as JVec4

from fourd_ray_tracing_tpu_torch import camera as tcam
from fourd_ray_tracing_tpu_torch import diff, inverse_render
from fourd_ray_tracing_tpu_torch.models import library as tlib
from fourd_ray_tracing_tpu_torch.models import params
from fourd_ray_tracing_tpu_torch.models import renderer as trenderer
from fourd_ray_tracing_tpu_torch.ops.cuda import gradkernel as tgrad
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4 as TVec4
from fourd_ray_tracing_tpu_torch.utils.logging import log_metrics

CPU = torch.device("cpu")
SCENES = ["room_with_sphere", "sphere_plane_light"]
SHAPE = dict(width=32, height=16, samples=2, reflections_amount=2, rng_mode="per_sample",
             light_coefficient=0.7)
J_CFG = jrenderer.RenderConfig(**SHAPE)
T_CFG = trenderer.RenderConfig(**SHAPE)
SEED = 5
LR = 1e-2


def crossed(name):
    """(JAX scene, JAX camera, port scene, port camera) with the port's
    leaves crossed over from the JAX pair as numpy."""
    zero = jnp.float32(0)
    js = jlib.SCENES[name]()
    jc = jcam.camera_from_state(JVec4.of(0.0, -2.0, 0.0, 0.0),
                                jcam.CameraAngles(zero, zero, zero), 1.5, 2.0)
    tc_like = tcam.camera_from_state(TVec4.of(0.0, -2.0, 0.0, 0.0, device=CPU),
                                     tcam.CameraAngles.of(0.0, 0.0, 0.0, device=CPU), 1.5, 2.0,
                                     device=CPU)
    np_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves((js, jc))]
    ts, tc = params.from_numpy_leaves(np_leaves, tlib.SCENES[name](CPU), tc_like)
    return js, jc, ts, tc


def target_image(seed=1):
    return np.random.default_rng(seed).uniform(0, 1, (16, 32, 3)).astype(np.float32)


def flat(tree):
    return np.concatenate([np.asarray(x, np.float32).reshape(-1)
                           for x in jax.tree_util.tree_leaves(tree)])


def mixed_rel(a, b):
    scale = np.maximum(np.abs(b), 1e-3 * np.abs(b).max() + 1e-8)
    return float((np.abs(a - b) / scale).max())


@pytest.fixture(scope="module")
def jax_value_and_grad():
    """jax.value_and_grad(diff.image_loss, argnums=(0, 1)) per scene, as
    (loss, packed gradient)."""
    out = {}
    for name in SCENES:
        js, jc, _, _ = crossed(name)
        loss, (gs, gc) = jax.value_and_grad(jdiff.image_loss, argnums=(0, 1))(
            js, jc, J_CFG, SEED, jnp.asarray(target_image()))
        out[name] = (float(loss), np.concatenate([flat(gs), flat(gc)]))
    return out


@pytest.fixture(scope="module")
def jax_packed_step():
    """One step of the JAX package's make_packed_train_step on the room:
    (loss, scene vector after the step)."""
    js, jc, _, _ = crossed("room_with_sphere")
    opt = optax.adam(LR)
    step, init, _ = jdiff.make_packed_train_step(J_CFG, opt, jc, js)
    vec, state = init(js)
    vec, state, loss = step(vec, state, np.uint32(11), jnp.asarray(target_image(6)))
    return float(loss), np.asarray(vec)


@pytest.mark.parametrize("name", SCENES)
def test_render_grad_matches_jax_value_and_grad(name, jax_value_and_grad):
    _, _, ts, tc = crossed(name)
    loss, (gs, gc) = diff.render_grad(ts, tc, T_CFG, SEED, torch.from_numpy(target_image()))
    grad = params.pack(gs, gc).numpy()
    ref_loss, ref_grad = jax_value_and_grad[name]
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    assert grad.shape == ref_grad.shape and np.isfinite(grad).all()
    assert mixed_rel(grad, ref_grad) < 1e-3
    np.testing.assert_array_equal(grad != 0, ref_grad != 0)
    assert np.abs(ref_grad).max() > 1e-6


def test_image_loss_kernel_on_cpu_is_differentiable_plain_loss():
    """The CPU route of image_loss_kernel is the plain expression: its
    autograd gradient w.r.t. the packed vector is loss_and_grad_plain's."""
    _, _, ts, tc = crossed("sphere_plane_light")
    target = torch.from_numpy(target_image())
    vec = params.pack(ts, tc).clone().requires_grad_(True)
    loss = diff.image_loss_kernel(vec, ts, tc, T_CFG, SEED, target)
    loss.backward()
    ref_loss, ref_grad = tgrad.loss_and_grad_plain(params.pack(ts, tc), ts, tc, T_CFG, SEED,
                                                   target)
    assert torch.equal(loss.detach(), ref_loss) and torch.equal(vec.grad, ref_grad)
    assert torch.equal(diff.image_loss(ts, tc, T_CFG, SEED, target), ref_loss)


def test_torch_adam_matches_optax():
    """torch.optim.Adam against optax.adam on one gradient sequence over 5
    steps, within rtol 1e-6. The two differ in rounding only: optax divides
    by sqrt(nu / (1 - b2^t)) + eps, torch by sqrt(nu) / sqrt(1 - b2^t) + eps,
    and torch scales the step by lr / (1 - b1^t) where optax scales mu."""
    rng = np.random.default_rng(3)
    x0 = (rng.uniform(0.5, 2.0, 64) * rng.choice([-1.0, 1.0], 64)).astype(np.float32)
    grads = [(rng.normal(0, 1, 64) * 10.0 ** rng.uniform(-6, 0, 64)).astype(np.float32)
             for _ in range(5)]
    opt = optax.adam(LR)
    xj = jnp.asarray(x0)
    state = opt.init(xj)
    p = torch.nn.Parameter(torch.from_numpy(x0.copy()))
    topt = torch.optim.Adam([p], lr=LR)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, xj)
        xj = optax.apply_updates(xj, updates)
        p.grad = torch.from_numpy(g)
        topt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(xj), rtol=1e-6)


def test_packed_step_matches_jax_packed_step(jax_packed_step):
    """One packed Adam step from the same room, on the port (plain route,
    CPU) and on the JAX package (interpret-mode kernel). The first Adam
    step moves each parameter by about lr * g / (|g| + eps), so gradients
    that agree to 1e-3 relative move it alike to about lr * 1e-3."""
    js, jc, ts, tc = crossed("room_with_sphere")
    step, init, unpack = diff.make_packed_train_step(T_CFG, LR, tc, ts)
    model, opt = init(ts)
    loss = step(model, opt, 11, torch.from_numpy(target_image(6)))
    ref_loss, ref_vec = jax_packed_step
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    vec = model.scene_vec.detach().numpy()
    assert vec.shape == ref_vec.shape == (params.n_scene(ts),)
    np.testing.assert_allclose(vec, ref_vec, rtol=1e-6, atol=LR * 1e-3)
    assert not np.array_equal(vec, params.pack(ts, tc).numpy()[:vec.size])
    assert torch.equal(params.pack(unpack(model), tc)[:vec.size], model.scene_vec.detach())


def test_packed_step_is_bitwise_the_pytree_step():
    """make_packed_train_step and make_train_step(impl="kernel") take
    bitwise the same steps: same gradients, and Adam is elementwise (the
    counterpart of test_gradkernel.py::test_packed_train_step_matches_pytree)."""
    _, _, ts, tc = crossed("room_with_sphere")
    target = torch.from_numpy(target_image(6))
    pstep, pinit, _ = diff.make_packed_train_step(T_CFG, LR, tc, ts)
    tstep, tinit = diff.make_train_step(T_CFG, LR, tc, impl="kernel")
    model, popt = pinit(ts)
    scene, topt = tinit(ts)
    for k in range(3):
        loss_p = pstep(model, popt, 11 + k, target)
        scene, topt, loss_t, metrics = tstep(scene, topt, 11 + k, target)
        assert torch.equal(loss_p, loss_t) and torch.equal(metrics["loss"], loss_t), k
        assert float(metrics["grad_norm"]) > 0
    assert torch.equal(model.scene_vec.detach(), params.pack(scene, tc).detach()[:params.n_scene(ts)])


def test_minibatch_fit_reduces_loss():
    """frames_per_step=4: the packed and pytree minibatch steps agree, and
    a short fit reduces the loss (the counterpart of
    test_gradkernel.py:453-490)."""
    _, _, ts, tc = crossed("room_with_sphere")
    target = torch.zeros(16, 32, 3)
    pstep, pinit, _ = diff.make_packed_train_step(T_CFG, LR, tc, ts, frames_per_step=4)
    tstep, tinit = diff.make_train_step(T_CFG, LR, tc, impl="kernel", frames_per_step=4)
    model, popt = pinit(ts)
    scene, topt = tinit(ts)
    loss_p = pstep(model, popt, 3, target)
    _, _, loss_t, _ = tstep(scene, topt, 3, target)
    np.testing.assert_allclose(float(loss_p), float(loss_t), rtol=1e-6)
    np.testing.assert_allclose(model.scene_vec.detach().numpy(),
                               params.pack(scene, tc).detach().numpy()[:params.n_scene(ts)],
                               rtol=1e-6, atol=1e-7)
    losses = [float(loss_p)] + [float(pstep(model, popt, k, target)) for k in range(4, 8)]
    assert losses[-1] < losses[0], losses


def test_frame_seeds_follow_the_jax_minibatch():
    """seed * F + arange(F) in uint32 words (diff.py:1055-1057)."""
    for seed in (3, 0xFFFFFFF0):
        ref = jnp.asarray(seed, jnp.uint32) * np.uint32(4) + jnp.arange(4, dtype=jnp.uint32)
        assert diff.frame_seeds(seed, 4) == [int(x) for x in ref]
    assert diff.frame_seeds(7, 1) == 7


@pytest.mark.parametrize("make", [
    lambda c, cam, s: diff.make_train_step(dataclasses.replace(c, freeze_hints=True), LR, cam),
    lambda c, cam, s: diff.make_packed_train_step(dataclasses.replace(c, freeze_hints=True), LR,
                                                  cam, s),
    lambda c, cam, s: diff.render_grad(s, cam, dataclasses.replace(c, freeze_hints=True), 1,
                                       torch.zeros(16, 32, 3)),
], ids=["freeze_hints", "packed_freeze_hints", "grad_freeze_hints"])
def test_unported_options_raise(make):
    _, _, ts, tc = crossed("sphere_plane_light")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item"):
        make(T_CFG, tc, ts)


@pytest.mark.parametrize("kwargs", [
    dict(impl="xla"),
    dict(impl="plain", frames_per_step=4),
    dict(cfg=dataclasses.replace(T_CFG, grad_sample_chunk=3)),
    dict(impl="kernel", frames_per_step=4, soft_sphere_index=0),
])
def test_bad_training_arguments_raise(kwargs):
    _, _, _, tc = crossed("sphere_plane_light")
    cfg = kwargs.pop("cfg", T_CFG)
    with pytest.raises(ValueError):
        diff.make_train_step(cfg, LR, tc, **kwargs)


@pytest.mark.parametrize("flags", [["--freeze-hints"], ["--ckpt", "ckpt"]])
def test_inverse_render_unported_flags_raise(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item"):
        inverse_render.main(["--device", "cpu", *flags])


@pytest.mark.parametrize("flags", [["--impl", "plain"], ["--impl", "kernel"],
                                   ["--impl", "kernel", "--packed"]],
                         ids=["plain", "kernel", "packed"])
def test_inverse_render_recovers_glow_on_cpu(flags, capsys):
    rc = inverse_render.main(["--device", "cpu", "--width", "32", "--height", "20",
                              "--steps", "40", *flags])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0, out[-1]
    metrics = [json.loads(line) for line in out if line.startswith("{")]
    assert [m["step"] for m in metrics] == [0, 10, 20, 30, 39]
    assert metrics[-1]["loss"] < metrics[0]["loss"]
    assert abs(metrics[-1]["value"] - inverse_render.TRUE_GLOW) < 2.0
    assert out[-1].startswith("recovered glow=")


def test_log_metrics_is_one_json_line(capsys):
    log_metrics(3, {"loss": torch.tensor(0.5), "note": object}, prefix="train/")
    line = json.loads(capsys.readouterr().out)
    assert line["step"] == 3 and line["train/loss"] == 0.5 and "train/note" in line
