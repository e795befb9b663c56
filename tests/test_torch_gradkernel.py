"""The port's value-and-grad path (ops/cuda/gradkernel.py, models/params.py
unpack) against the JAX package's value-and-grad kernel in interpret mode,
and the wrapper's CPU route.

Same shape as tests/test_gradkernel.py's CFG: 32x16, 2 spp, 2 bounces,
light_coefficient 0.7, seed 5, a uniform random target. Each JAX
reference runs once per scene (a module-scoped fixture): an interpret-mode
kernel call takes 15-30 s on a CPU. Tolerances: loss rtol 1e-5; every
gradient within a mixed-scale relative error of 1e-3
(|a - b| / max(|b|, 1e-3 max|b| + 1e-8), as test_gradkernel.py:74-76),
with the same non-zero pattern. The two sides sum in different orders and
XLA on the CPU fuses multiply-adds (torch does not), so they agree to
float re-association, not bitwise (measured: 1.1e-4 on
sphere_plane_light, 9.3e-8 on the room).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourd_ray_tracing_tpu import camera as jcam
from fourd_ray_tracing_tpu.models import library as jlib
from fourd_ray_tracing_tpu.models import renderer as jrenderer
from fourd_ray_tracing_tpu.ops.pallas.gradkernel import render_loss_and_grad_pallas
from fourd_ray_tracing_tpu.ops.pallas.megakernel import _pack_pytree
from fourd_ray_tracing_tpu.ops.vec4 import Vec4 as JVec4

from fourd_ray_tracing_tpu_torch import camera as tcam
from fourd_ray_tracing_tpu_torch import diff
from fourd_ray_tracing_tpu_torch.inverse_render import make_scene, only_lamp_glow
from fourd_ray_tracing_tpu_torch.models import library as tlib
from fourd_ray_tracing_tpu_torch.models import params
from fourd_ray_tracing_tpu_torch.models import renderer as trenderer
from fourd_ray_tracing_tpu_torch.ops.cuda import build
from fourd_ray_tracing_tpu_torch.ops.cuda import gradkernel as tgrad
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4 as TVec4

CPU = torch.device("cpu")
SCENES = ["room_with_sphere", "sphere_plane_light"]
SHAPE = dict(width=32, height=16, samples=2, reflections_amount=2, rng_mode="per_sample",
             light_coefficient=0.7)
J_CFG = jrenderer.RenderConfig(**SHAPE)
T_CFG = trenderer.RenderConfig(**SHAPE)
SEED = 5


def jax_camera():
    zero = jnp.float32(0)
    return jcam.camera_from_state(JVec4.of(0.0, -2.0, 0.0, 0.0),
                                  jcam.CameraAngles(zero, zero, zero), 1.5, 2.0)


def torch_camera(views=("yxz",)):
    o = tcam.orientation_from_angles(*tcam.CameraAngles.of(0.0, 0.0, 0.0, device=CPU), CPU)
    return tcam.make_camera(TVec4.of(0.0, -2.0, 0.0, 0.0, device=CPU), o, 1.5, 2.0, views, CPU)


def crossed(name):
    """(JAX scene, JAX camera, port scene, port camera): the port's pair
    holds the JAX pair's leaves, crossed over as numpy."""
    js, jc = jlib.SCENES[name](), jax_camera()
    np_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves((js, jc))]
    ts, tc = params.from_numpy_leaves(np_leaves, tlib.SCENES[name](CPU), torch_camera())
    return js, jc, ts, tc


def target_image(seed=1, shape=(16, 32, 3)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def flat(tree):
    return np.concatenate([np.asarray(x, np.float32).reshape(-1)
                           for x in jax.tree_util.tree_leaves(tree)])


def mixed_rel(a, b):
    scale = np.maximum(np.abs(b), 1e-3 * np.abs(b).max() + 1e-8)
    return float((np.abs(a - b) / scale).max())


@pytest.fixture(scope="module")
def pallas_reference():
    """The interpret-mode JAX kernel's (loss, packed gradient) per scene."""
    out = {}
    for name in SCENES:
        js, jc, _, _ = crossed(name)
        loss, (gs, gc) = render_loss_and_grad_pallas(js, jc, J_CFG, SEED,
                                                     jnp.asarray(target_image()))
        out[name] = (float(loss), np.concatenate([flat(gs), flat(gc)]))
    return out


@pytest.mark.parametrize("name", SCENES)
def test_plain_grad_matches_pallas_kernel(name, pallas_reference):
    _, _, ts, tc = crossed(name)
    loss, grad = tgrad.loss_and_grad_plain(params.pack(ts, tc), ts, tc, T_CFG, SEED,
                                           torch.from_numpy(target_image()))
    ref_loss, ref_grad = pallas_reference[name]
    grad = grad.numpy()
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    assert grad.shape == ref_grad.shape and np.isfinite(grad).all()
    assert mixed_rel(grad, ref_grad) < 1e-3
    np.testing.assert_array_equal(grad != 0, ref_grad != 0)
    assert np.abs(ref_grad).max() > 1e-6


def test_kernel_route_on_cpu_is_the_plain_version():
    """CPU tensors take autograd over the plain pipeline, bitwise
    diff.render_grad's, and launch nothing."""
    _, _, ts, tc = crossed("room_with_sphere")
    target = torch.from_numpy(target_image())
    before = tgrad.LAUNCHES
    loss_k, (gs_k, gc_k) = tgrad.render_loss_and_grad_kernel(ts, tc, T_CFG, SEED, target)
    loss_p, (gs_p, gc_p) = diff.render_grad(ts, tc, T_CFG, SEED, target)
    assert tgrad.LAUNCHES == before
    assert torch.equal(loss_k, loss_p)
    assert torch.equal(params.pack(gs_k, gc_k), params.pack(gs_p, gc_p))
    assert type(gs_k) is type(ts) and type(gc_k) is type(tc)


@pytest.mark.parametrize("name", SCENES)
def test_seed_vector_is_the_mean_of_singles(name):
    """A (F,) seed vector takes F estimator samples of the same loss: loss
    and gradients are the mean of the scalar-seed calls (the counterpart
    of test_gradkernel.py:423-450)."""
    _, _, ts, tc = crossed(name)
    target = torch.from_numpy(target_image(2))
    packed = params.pack(ts, tc)
    seeds = np.array([5, 6, 7], np.uint32)
    singles = [tgrad.loss_and_grad_packed(packed, ts, tc, T_CFG, int(s), target) for s in seeds]
    loss, grad = tgrad.loss_and_grad_packed(packed, ts, tc, T_CFG, seeds, target)
    mean_loss = sum(float(sl) for sl, _ in singles) / len(seeds)
    mean_grad = sum(sg.numpy() for _, sg in singles) / len(seeds)
    np.testing.assert_allclose(float(loss), mean_loss, rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), mean_grad, rtol=1e-5,
                               atol=1e-7 * max(1.0, float(np.abs(mean_grad).max())))


@pytest.mark.parametrize("views", [("yxz",), tcam.VIEWS_ALL], ids=["1view", "3view"])
@pytest.mark.parametrize("name", SCENES)
def test_unpack_round_trips_and_carries_gradients(name, views):
    scene, camera = tlib.SCENES[name](CPU), torch_camera(views)
    vec = params.pack(scene, camera).clone().requires_grad_(True)
    s2, c2 = params.unpack(vec, scene, camera)
    assert torch.equal(params.pack(s2, c2), vec.detach())
    assert [t.shape for t in params.leaves(s2, c2)] == [t.shape for t in params.leaves(scene, camera)]
    assert s2.environment.enabled == scene.environment.enabled
    weights = torch.arange(vec.numel(), dtype=torch.float32)
    (params.pack(s2, c2) * weights).sum().backward()
    assert torch.equal(vec.grad, weights)
    with pytest.raises(ValueError, match="floats"):
        params.unpack(vec[:-1], scene, camera)


@pytest.mark.parametrize("name", SCENES)
def test_jax_packed_vector_crosses_over(name):
    """The JAX package's packed vector, as numpy, unpacks to the scene
    that from_numpy_leaves builds from its leaves; n_scene is the JAX
    split point."""
    js, jc, ts, tc = crossed(name)
    jpacked, _ = _pack_pytree((js, jc))
    s2, c2 = params.unpack(torch.from_numpy(np.array(jpacked)), ts, tc)
    for a, b in zip(params.leaves(s2, c2), params.leaves(ts, tc)):
        assert torch.equal(a, b)
    n_jax = sum(int(np.prod(np.shape(x))) or 1 for x in jax.tree_util.tree_leaves(js))
    assert params.n_scene(ts) == n_jax


def test_leaf_mask_is_the_packed_filter():
    scene = make_scene(1.0, 8.0, CPU)
    mask = params.leaf_mask(only_lamp_glow, scene)
    assert mask.shape == (params.n_scene(scene),) and mask.dtype == torch.float32
    lay = params.layout(scene, torch_camera())
    glow_slot = lay.spheres + params.SPHERE_FLOATS + 5  # sphere 1: center(4) r glow
    assert mask.nonzero().flatten().tolist() == [glow_slot]


def test_make_packed_loss_and_grad_on_cpu():
    _, _, ts, tc = crossed("sphere_plane_light")
    target = torch.from_numpy(target_image())
    fn, vec0, unpack = tgrad.make_packed_loss_and_grad(ts, tc, T_CFG)
    n = params.n_scene(ts)
    assert vec0.shape == (n,)
    loss, grad = fn(vec0, SEED, target)
    loss_p, grad_p = tgrad.loss_and_grad_plain(params.pack(ts, tc), ts, tc, T_CFG, SEED, target)
    assert torch.equal(loss, loss_p) and torch.equal(grad, grad_p[:n])
    assert torch.equal(params.pack(unpack(vec0), tc), params.pack(ts, tc))


def test_launch_loss_grad_refuses_cpu_tensors():
    """The kernel path has no CPU fallback."""
    scene, camera = tlib.room_with_sphere(CPU), torch_camera()
    with pytest.raises(ValueError, match="CUDA"):
        tgrad.launch_loss_grad(params.pack(scene, camera), params.layout(scene, camera), T_CFG,
                               torch.zeros(1, dtype=torch.int32), torch.zeros(16, 32, 3))


@pytest.mark.parametrize("change, match", [
    (dict(size=tgrad.MAX_PARAMS + 1), "packed parameters"),
    (dict(reflections_amount=tgrad.MAX_BOUNCES + 1), "bounces"),
])
def test_kernel_refuses_what_its_arrays_cannot_hold(change, match):
    lay = params.layout(tlib.room_with_sphere(CPU), torch_camera())
    cfg = T_CFG
    if "size" in change:
        lay = lay._replace(size=change["size"])
    else:
        cfg = dataclasses.replace(T_CFG, **change)
    with pytest.raises(ValueError, match=match):
        tgrad.check_shape(lay, cfg)


@pytest.mark.parametrize("views", [("yxz",), tcam.VIEWS_ALL], ids=["1view", "3view"])
def test_row_band_renders_the_full_images_rows(views):
    """render_light(rows=...) gives those rows of the full image bitwise:
    every pixel is computed on its own."""
    scene, camera = tlib.room_with_sphere(CPU), torch_camera(views)
    full = trenderer.render_light(scene, camera, T_CFG, [5, 6])
    band = trenderer.render_light(scene, camera, T_CFG, [5, 6], slice(5, 11))
    assert torch.equal(band, full[..., 5:11, :, :])


@pytest.mark.parametrize("views, seeds", [(("yxz",), SEED), (tcam.VIEWS_ALL, [5, 6])],
                         ids=["1view_scalar_seed", "3view_seed_vector"])
def test_banded_plain_version_is_the_whole_graph(views, seeds):
    """loss_and_grad_plain in row bands (5 rows, the last band short) sums
    to the whole-graph loss and gradient up to the order of the sums."""
    scene, camera = tlib.sphere_plane_light(CPU), torch_camera(views)
    shape = (len(views), 16, 32, 3) if len(views) > 1 else (16, 32, 3)
    target = torch.from_numpy(target_image(3, shape))
    packed = params.pack(scene, camera)
    loss, grad = tgrad.loss_and_grad_plain(packed, scene, camera, T_CFG, seeds, target)
    loss_b, grad_b = tgrad.loss_and_grad_plain(packed, scene, camera, T_CFG, seeds, target,
                                               band_rows=5)
    assert loss_b.dtype == grad_b.dtype == torch.float32 and grad_b.shape == grad.shape
    np.testing.assert_allclose(float(loss_b), float(loss), rtol=1e-6)
    assert mixed_rel(grad_b.numpy(), grad.numpy()) < 1e-5
    np.testing.assert_array_equal(grad_b.numpy() != 0, grad.numpy() != 0)


def test_image_loss_function_has_no_cpu_route():
    """diff.ImageLoss is the kernel's autograd route only: a CPU vector
    raises instead of falling back (image_loss_kernel routes CPU vectors
    to the plain expression before it)."""
    scene, camera = tlib.room_with_sphere(CPU), torch_camera()
    vec = params.pack(scene, camera).clone().requires_grad_(True)
    with pytest.raises(ValueError, match="CUDA"):
        diff.ImageLoss.apply(vec, scene, camera, T_CFG, SEED, torch.zeros(16, 32, 3))


def test_kernel_array_sizes_have_one_source():
    """The gradient kernels' caps (packed parameters in shared memory, the
    generic instance's bounce records, K6's zero-map slots) come from the
    build's defines, which the wrappers read; the shared adjoint header,
    where the kernels take them, holds no number of its own."""
    assert (tgrad.MAX_PARAMS, tgrad.MAX_BOUNCES, tgrad.MAX_ZERO_SLOTS) == (768, 16, 16)
    assert all(flag in build.NVCC_FLAGS for flag in build.DEFINES)
    source = (build.CSRC_DIR / "adjoint.cuh").read_text()
    assert "kMaxParams = FOURD_K4_MAX_PARAMS" in source
    assert "kMaxBounces = FOURD_K4_MAX_BOUNCES" in source
    assert "kMainBounces = FOURD_K4_MAIN_BOUNCES" in source
    assert tgrad.MAIN_BOUNCES == 4
    assert "kMaxZeroSlots = FOURD_K6_MAX_ZERO_SLOTS" in source


@pytest.mark.parametrize("size", [288, tgrad.MAX_PARAMS])
def test_kernel_takes_the_hypercube_layouts(size):
    """The cap holds the hypercube's packed vector with 3 views (288
    floats) and everything up to itself; one more float is refused
    (test_kernel_refuses_what_its_arrays_cannot_hold)."""
    lay = params.layout(tlib.room_with_sphere(CPU), torch_camera())._replace(size=size)
    tgrad.check_shape(lay, T_CFG)


PTXAS_LOG = """== nvcc gradkernel.cu (exit 0)
ptxas info    : Compiling entry function '_ZN1_16loss_grad_kernelILi4EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN1_16loss_grad_kernelILi4EEEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 32 bytes smem
ptxas info    : Compiling entry function '_ZN1_16loss_grad_kernelILi16EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN1_16loss_grad_kernelILi16EEEvPKf
    960 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 154 registers, used 1 barriers, 960 bytes cumulative stack size
"""


def test_kernel_resources_reads_the_ptxas_report():
    """chip_smoke reports each gradient kernel's registers, stack and
    spill from the build log through build.kernel_resources."""
    res = build.kernel_resources(PTXAS_LOG)
    assert res == {
        "_ZN1_16loss_grad_kernelILi4EEEvPKf": dict(registers=168, stack_bytes=0, spill_bytes=0),
        "_ZN1_16loss_grad_kernelILi16EEEvPKf": dict(registers=154, stack_bytes=960,
                                                     spill_bytes=12),
    }
