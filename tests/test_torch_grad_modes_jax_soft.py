"""The port's plain light-VJP and soft value-and-grad routes
(ops/cuda/gradkernel.py render_light_vjp_plain, K5's, and
render_soft_loss_and_grad_plain, K6's) against the JAX package's K5 and
K6 in interpret mode, in K1's other configurations: per-sample streams
with the kepler or newton sampler, or the literal spec or trig fold.

Each kernel runs every configuration once, two on sphere_plane_light and
two on the duocylinder, so that each configuration meets both scenes
across the two kernels (test_torch_grad_modes_jax.py runs K4 on both in
each). K6's object is the lamp (sphere 1) or the duocylinder, its
coverage alpha JAX's, the port's plain version fed the same values. Shape,
seed and tolerances as test_torch_grad_modes_jax.py: loss rtol 1e-5,
every gradient slot and alpha cotangent within the mixed-scale relative
error 1e-3, the gradient with the same non-zero pattern (the alpha
cotangent's may differ where the two rows differ by an ulp,
test_torch_soft_kernels.py). Under the trig fold JAX's gradient is nan on
the slots a masked lane's singular derivative reaches (ROADMAP queue 3;
test_torch_grad_modes_jax.py), and so is K6's under either literal fold,
whose zeroed row divides the masked lanes' normals by r = 0 (JAX
geometry.py:184, :218; 28 of 63 slots finite): those cases run the JAX
reference under test_torch_grad_modes_jax.py's ``nan_safe_jax`` (finite
derivatives wherever the port's are, and the port's radius guard) and
compare every slot.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourd_ray_tracing_tpu import diff as jdiff
from fourd_ray_tracing_tpu.ops.pallas.gradkernel import (render_light_vjp_pallas,
                                                         render_soft_loss_and_grad_pallas)

from fourd_ray_tracing_tpu_torch.models import params
from fourd_ray_tracing_tpu_torch.ops.cuda import gradkernel as tgrad

from test_torch_grad_modes_jax import CONFIGS, SEED, configs, nan_safe_jax  # noqa: F401
from test_torch_soft_kernels import assert_grad_close, crossed, flat, mixed_rel, normal, uniform


# (kernel, configuration) -> scene: each configuration on both scenes across
# the two kernels, each kernel on both scenes.
K5_CASES = {"kepler": "sphere_plane_light", "newton": "sphere_plane_light",
            "spec": "duocylinder", "trig": "duocylinder"}
K6_CASES = {"kepler": "duocylinder", "newton": "duocylinder",
            "spec": "sphere_plane_light", "trig": "sphere_plane_light"}
SOFT_REFS = {"sphere_plane_light": ("spheres", 1), "duocylinder": ("cylinders_union", None)}
EDGE = 0.05


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_light_vjp_plain_matches_pallas_kernel(config, request):
    if config == "trig":
        request.getfixturevalue("nan_safe_jax")
    name = K5_CASES[config]
    js, jc, ts, tc = crossed(name)
    j_cfg, t_cfg = configs(CONFIGS[config])
    cot = normal(2, (16, 32, 3))
    gs, gc = render_light_vjp_pallas(js, jc, j_cfg, SEED, jnp.asarray(cot))
    ref = np.concatenate([flat(gs), flat(gc)])
    grad = tgrad.render_light_vjp_plain(params.pack(ts, tc), ts, tc, t_cfg, SEED,
                                        torch.from_numpy(cot)).numpy()
    print(f"K5 {name} {config}: grad mixed rel {mixed_rel(grad, ref):.3g} over {ref.size} slots")
    assert np.isfinite(ref).all()
    assert_grad_close(grad, ref)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_soft_plain_matches_pallas_kernel(config, request):
    if config in ("spec", "trig"):
        request.getfixturevalue("nan_safe_jax")
    name = K6_CASES[config]
    ref_obj = SOFT_REFS[name]
    js, jc, ts, tc = crossed(name)
    j_cfg, t_cfg = configs(CONFIGS[config])
    alpha = np.array(jdiff.object_coverage(js, ref_obj, jc, j_cfg, EDGE))
    target = uniform(1, (16, 32, 3))
    ref_loss, (gs, gc), ref_acot = render_soft_loss_and_grad_pallas(
        js, jc, j_cfg, SEED, jnp.asarray(target), jnp.asarray(alpha), ref_obj)
    ref_grad = np.concatenate([flat(gs), flat(gc)])
    loss, grad, acot = tgrad.render_soft_loss_and_grad_plain(
        params.pack(ts, tc), ts, tc, t_cfg, SEED, torch.from_numpy(target),
        torch.from_numpy(alpha), params.soft_zero_map(ts, tc, ref_obj))
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    print(f"K6 {name} {config}: loss {float(loss)} vs {float(ref_loss)}, grad mixed rel "
          f"{mixed_rel(grad.numpy(), ref_grad):.3g} over {ref_grad.size} slots")
    assert np.isfinite(ref_grad).all()
    assert_grad_close(grad.numpy(), ref_grad)
    assert_grad_close(acot.numpy(), np.asarray(ref_acot), same_pattern=False)
