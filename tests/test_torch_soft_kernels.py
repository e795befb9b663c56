"""The plain versions of the soft slice's kernels (ops/cuda/gradkernel.py:
render_light_vjp_plain for K5, render_soft_loss_and_grad_plain for K6)
against the JAX package's kernels in interpret mode, the soft train step
against the JAX make_train_step, and the CUDA-only routes.

Shape 32x16, 1 spp, 2 bounces, light_coefficient 0.7, per-sample RNG: an
interpret-mode kernel call takes 15-40 s here, so each JAX reference runs
once (module-scoped fixtures) and at one sample. Tolerances as
test_torch_gradkernel.py: loss rtol 1e-5, every gradient within the
mixed-scale relative error 1e-3 with the same non-zero pattern. The alpha
cotangent is held to the same bound but not to the pattern: a pixel whose
two rows differ by an ulp may round to 0 on one side only (XLA on the CPU
fuses multiply-adds, torch does not).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fourd_ray_tracing_tpu import camera as jcam
from fourd_ray_tracing_tpu import diff as jdiff
from fourd_ray_tracing_tpu.models import library as jlib
from fourd_ray_tracing_tpu.models import renderer as jrenderer
from fourd_ray_tracing_tpu.ops.pallas.gradkernel import (
    render_light_vjp_pallas,
    render_light_vjp_pallas_multi,
    render_soft_loss_and_grad_pallas,
)
from fourd_ray_tracing_tpu.ops.vec4 import Vec4 as JVec4

from fourd_ray_tracing_tpu_torch import camera as tcam
from fourd_ray_tracing_tpu_torch import diff
from fourd_ray_tracing_tpu_torch.models import library as tlib
from fourd_ray_tracing_tpu_torch.models import params
from fourd_ray_tracing_tpu_torch.models import renderer as trenderer
from fourd_ray_tracing_tpu_torch.ops.cuda import gradkernel as tgrad
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4 as TVec4

CPU = torch.device("cpu")
SHAPE = dict(width=32, height=16, samples=1, reflections_amount=2, rng_mode="per_sample",
             light_coefficient=0.7)
J_CFG = jrenderer.RenderConfig(**SHAPE)
T_CFG = trenderer.RenderConfig(**SHAPE)
SEED = 5
EDGE = 0.05
LR = 1e-2
REF = ("spheres", 0)


def crossed(name):
    """(JAX scene, JAX camera, port scene, port camera), the port's leaves
    crossed over from the JAX pair as numpy."""
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


def uniform(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def normal(seed, shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def flat(tree):
    return np.concatenate([np.asarray(x, np.float32).reshape(-1)
                           for x in jax.tree_util.tree_leaves(tree)])


def mixed_rel(a, b):
    scale = np.maximum(np.abs(b), 1e-3 * np.abs(b).max() + 1e-8)
    return float((np.abs(a - b) / scale).max())


def assert_grad_close(grad, ref, same_pattern=True):
    assert grad.shape == ref.shape and np.isfinite(grad).all()
    assert mixed_rel(grad, ref) < 1e-3
    if same_pattern:
        np.testing.assert_array_equal(grad != 0, ref != 0)
    assert np.abs(ref).max() > 1e-6


def soft_inputs(name):
    """(JAX pair, port pair, coverage alpha as numpy, target): alpha from
    the JAX coverage of sphere 0, the port's plain version takes the same
    values."""
    js, jc, ts, tc = crossed(name)
    alpha = np.array(jdiff.object_coverage(js, REF, jc, J_CFG, EDGE))
    return js, jc, ts, tc, alpha, uniform(1, (16, 32, 3))


@pytest.fixture(scope="module")
def pallas_soft():
    """The interpret-mode K6 on the room: (loss, packed grad, alpha cot)."""
    js, jc, _, _, alpha, target = soft_inputs("room_with_sphere")
    loss, (gs, gc), g_alpha = render_soft_loss_and_grad_pallas(
        js, jc, J_CFG, SEED, jnp.asarray(target), jnp.asarray(alpha), REF)
    return float(loss), np.concatenate([flat(gs), flat(gc)]), np.asarray(g_alpha)


@pytest.fixture(scope="module")
def pallas_vjp():
    """The interpret-mode K5 on the lamp scene: the single launch's packed
    gradient, and the two-row launch's (scene grads of each row, camera
    grad summed over the rows) for the scene and its zero_object copy."""
    js, jc, _, _ = crossed("sphere_plane_light")
    cot = jnp.asarray(normal(2, (16, 32, 3)))
    gs, gc = render_light_vjp_pallas(js, jc, J_CFG, SEED, cot)
    single = np.concatenate([flat(gs), flat(gc)])
    cots = jnp.asarray(normal(3, (2, 16, 32, 3)))
    (g_a, g_b), g_cam = render_light_vjp_pallas_multi(
        (js, jdiff.zero_object(js, ("spheres", 1))), jc, J_CFG, SEED, cots)
    return single, (flat(g_a), flat(g_b), flat(g_cam))


@pytest.fixture(scope="module")
def jax_soft_step():
    """One step of the JAX make_train_step(impl="xla", soft_object_ref=
    ("spheres", 0)) with optax Adam on the room: (loss, packed scene
    after the step)."""
    js, jc, _, _ = crossed("room_with_sphere")
    opt = optax.adam(LR)
    step = jdiff.make_train_step(J_CFG, opt, jc, soft_object_ref=REF, edge_width=EDGE,
                                 impl="xla")
    scene, _, loss, _ = step(js, opt.init(js), np.uint32(11), jnp.asarray(uniform(6, (16, 32, 3))))
    return float(loss), flat(scene)


def test_soft_plain_version_matches_pallas_kernel(pallas_soft):
    _, _, ts, tc, alpha, target = soft_inputs("room_with_sphere")
    loss, grad, g_alpha = tgrad.render_soft_loss_and_grad_plain(
        params.pack(ts, tc), ts, tc, T_CFG, SEED, torch.from_numpy(target),
        torch.from_numpy(alpha), params.soft_zero_map(ts, tc, REF))
    ref_loss, ref_grad, ref_alpha = pallas_soft
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    assert_grad_close(grad.numpy(), ref_grad)
    assert_grad_close(g_alpha.numpy(), ref_alpha, same_pattern=False)
    assert (g_alpha != 0).sum() > 0


def test_soft_plain_version_in_bands_is_the_whole_graph():
    """render_soft_loss_and_grad_plain in row bands (5 rows, the last band
    short) sums to the whole graph's loss and gradient up to the order of
    the sums; the alpha cotangent is per pixel, so bitwise."""
    _, _, ts, tc, alpha, target = soft_inputs("room_with_sphere")
    args = (params.pack(ts, tc), ts, tc, T_CFG, SEED, torch.from_numpy(target),
            torch.from_numpy(alpha), params.soft_zero_map(ts, tc, REF))
    loss, grad, g_alpha = tgrad.render_soft_loss_and_grad_plain(*args)
    loss_b, grad_b, g_alpha_b = tgrad.render_soft_loss_and_grad_plain(*args, band_rows=5)
    assert loss_b.dtype == grad_b.dtype == torch.float32
    np.testing.assert_allclose(float(loss_b), float(loss), rtol=1e-6)
    assert mixed_rel(grad_b.numpy(), grad.numpy()) < 1e-5
    np.testing.assert_array_equal(grad_b.numpy() != 0, grad.numpy() != 0)
    assert torch.equal(g_alpha_b, g_alpha)


def test_soft_plain_version_is_the_soft_loss_at_fixed_alpha():
    """The plain K6 is autograd of the soft loss with the coverage held
    fixed: its loss is soft_image_loss's, and its alpha cotangent carried
    back through object_coverage plus its packed gradient is the soft
    loss's whole gradient."""
    _, _, ts, tc = crossed("sphere_plane_light")
    ref = ("spheres", 1)
    target = torch.from_numpy(uniform(4, (16, 32, 3)))
    vec = params.pack(ts, tc).clone().requires_grad_(True)
    scene, camera = params.unpack(vec, ts, tc)
    alpha = diff.object_coverage(scene, ref, camera, T_CFG, EDGE)
    loss, grad, g_alpha = tgrad.render_soft_loss_and_grad_plain(
        vec.detach(), ts, tc, T_CFG, SEED, target, alpha.detach(),
        params.soft_zero_map(ts, tc, ref))
    (g_cov,) = torch.autograd.grad(alpha, vec, g_alpha)
    vec2 = params.pack(ts, tc).clone().requires_grad_(True)
    scene2, camera2 = params.unpack(vec2, ts, tc)
    loss2 = diff.soft_image_loss(scene2, camera2, T_CFG, SEED, target, edge_width=EDGE,
                                 object_ref=ref)
    (grad2,) = torch.autograd.grad(loss2, vec2)
    np.testing.assert_allclose(float(loss), float(loss2.detach()), rtol=1e-6)
    assert mixed_rel((grad + g_cov).numpy(), grad2.numpy()) < 1e-5


def test_light_vjp_plain_version_matches_pallas_kernel(pallas_vjp):
    _, _, ts, tc = crossed("sphere_plane_light")
    grad = tgrad.render_light_vjp_plain(params.pack(ts, tc), ts, tc, T_CFG, SEED,
                                        torch.from_numpy(normal(2, (16, 32, 3))))
    assert_grad_close(grad.numpy(), pallas_vjp[0])


def test_light_vjp_plain_version_matches_pallas_multi(pallas_vjp):
    """Two rows (the scene and its zero_object copy): each row's scene
    gradient against the JAX row's, and the camera gradient summed over
    the rows against the JAX camera gradient."""
    _, _, ts, tc = crossed("sphere_plane_light")
    rows = params.stack_rows((ts, diff.zero_object(ts, ("spheres", 1))), tc)
    grad = tgrad.render_light_vjp_plain(rows, ts, tc, T_CFG, SEED,
                                        torch.from_numpy(normal(3, (2, 16, 32, 3)))).numpy()
    assert grad.shape == rows.shape
    n = params.n_scene(ts)
    g_a, g_b, g_cam = pallas_vjp[1]
    assert_grad_close(grad[0, :n], g_a)
    assert_grad_close(grad[:, n:].sum(0), g_cam)
    # The JAX kernel's second row is NaN at the zeroed radius, a constant
    # of zero_object wherever the pair is used; the port's is 0 there.
    slot = params.layout(ts, tc).spheres + params.SPHERE_FLOATS + 4
    assert np.isnan(g_b[slot]) and grad[1, slot] == 0
    keep = np.arange(n) != slot
    assert_grad_close(grad[1, :n][keep], g_b[keep])


def test_render_light_pair_sums_the_camera_gradient_over_rows():
    """render_light_pair is differentiable w.r.t. both scenes and the
    shared camera, whose gradient is the sum of the rows'."""
    _, _, ts, tc = crossed("room_with_sphere")
    zs = diff.zero_object(ts, REF)
    cots = torch.from_numpy(normal(5, (2, 16, 32, 3)))
    rows = params.stack_rows((ts, zs), tc)
    ref = tgrad.render_light_vjp_plain(rows, ts, tc, T_CFG, SEED, cots)
    vec = params.pack(ts, tc).clone().requires_grad_(True)
    zvec = params.pack(zs, tc)[:params.n_scene(ts)].clone().requires_grad_(True)
    scene, camera = params.unpack(vec, ts, tc)
    zscene = params.unpack(torch.cat([zvec, vec[params.n_scene(ts):]]), ts, tc)[0]
    light = diff.render_light_pair(scene, zscene, camera, T_CFG, SEED)
    g, gz = torch.autograd.grad(light, (vec, zvec), cots)
    n = params.n_scene(ts)
    assert torch.equal(gz, ref[1, :n]) and torch.equal(g[:n], ref[0, :n])
    np.testing.assert_allclose(g[n:].numpy(), ref[:, n:].sum(0).numpy(), rtol=1e-6, atol=1e-9)


def test_soft_step_matches_jax_train_step(jax_soft_step):
    """One soft make_train_step(impl="plain") Adam step from the room
    against the JAX make_train_step(impl="xla") with optax Adam: the first
    step moves each parameter by about lr * g / (|g| + eps), so gradients
    that agree to 1e-3 relative move it alike to about lr * 1e-3."""
    _, _, ts, tc = crossed("room_with_sphere")
    step, init = diff.make_train_step(T_CFG, LR, tc, soft_object_ref=REF, edge_width=EDGE)
    scene, opt = init(ts)
    scene, opt, loss, metrics = step(scene, opt, 11, torch.from_numpy(uniform(6, (16, 32, 3))))
    ref_loss, ref_vec = jax_soft_step
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    assert float(metrics["grad_norm"]) > 0
    vec = params.pack(scene, tc).detach().numpy()[:params.n_scene(ts)]
    assert vec.shape == ref_vec.shape
    np.testing.assert_allclose(vec, ref_vec, rtol=1e-6, atol=LR * 1e-3)
    assert not np.array_equal(vec, params.pack(ts, tc).numpy()[:vec.size])


@pytest.mark.parametrize("call", [
    lambda ts, tc, vec: tgrad.render_light_vjp_cuda(vec, ts, tc, T_CFG, SEED,
                                                    torch.zeros(16, 32, 3)),
    lambda ts, tc, vec: tgrad.render_soft_loss_and_grad_cuda(
        vec, ts, tc, T_CFG, SEED, torch.zeros(16, 32, 3), torch.zeros(16, 32),
        params.soft_zero_map(ts, tc, REF)),
    lambda ts, tc, vec: diff.SoftImageLoss.apply(vec, torch.zeros(16, 32), ts, tc, T_CFG, SEED,
                                                 torch.zeros(16, 32, 3),
                                                 params.soft_zero_map(ts, tc, REF)),
    lambda ts, tc, vec: diff.RenderLight.apply(vec, ts, tc, T_CFG, SEED),
], ids=["k5_cuda", "k6_cuda", "soft_function", "render_light_function"])
def test_kernel_routes_have_no_cpu_fallback(call):
    """The K5/K6 wrappers and autograd Functions are the kernels' routes
    only: a CPU vector raises instead of falling back to the plain
    version (the *_kernel entry points route CPU vectors before them)."""
    _, _, ts, tc = crossed("room_with_sphere")
    vec = params.pack(ts, tc).clone().requires_grad_(True)
    with pytest.raises(ValueError, match="CUDA"):
        call(ts, tc, vec)
