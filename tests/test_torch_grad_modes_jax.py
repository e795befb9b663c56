"""The port's plain value-and-grad route (ops/cuda/gradkernel.py
loss_and_grad_plain: autograd over the plain pipeline, what the kernel
route runs on the CPU and what the gradient kernels are held to on the
card) against the JAX package's value-and-grad kernel K4 in interpret
mode, in K1's other configurations: per-sample streams with the kepler or
newton sampler, the literal spec or trig fold, and the fast fold over a
hypercube without generators; and the packed frozen-slot mask under a
literal fold against JAX's.

Each configuration takes one axis off the production one, on
sphere_plane_light and on the duocylinder (the composite whose
interpret-mode gradient the CPU computes in about 30 s; the tiger's trig
takes about 200 s), at 32x16, 1 spp, 2 bounces, light_coefficient 0.7,
seed 5, a uniform random target, one JAX call per case (15-40 s each).
Tolerances as test_torch_gradkernel.py: loss rtol 1e-5, every gradient
slot within the mixed-scale relative error 1e-3 (|a - b| / max(|b|, 1e-3
max|b| + 1e-8)) with the same non-zero pattern. chip_smoke.py's
GRAD_BOUNDS take 1e-4 between the kernel and the port's plain version,
which round alike; XLA on the CPU contracts multiply-adds into FMAs and
torch does not, and the samplers' and the trig fold's transcendentals are
XLA's on one side and torch's on the other, so the two packages are held
to 1e-3 here (each case prints the error it reads).

Under the trig fold JAX's own gradient is nan on most slots (27 of 63 on
sphere_plane_light, 63 of 79 on the duocylinder finite): a lane the fold
masks out meets a singular derivative (acos' and asin' at +-1, sqrt' at
0, the trig sphere's l / max(l, 1e-30) at l = 0) and its zero cotangent
becomes 0 * inf. Those cases run the JAX reference under ``nan_safe_jax``,
whose derivatives are finite wherever the port's are, and compare every
slot.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourd_ray_tracing_tpu import diff as jdiff
from fourd_ray_tracing_tpu.models import renderer as jrenderer
from fourd_ray_tracing_tpu.ops import geometry as jgeometry
from fourd_ray_tracing_tpu.ops import vec4 as jvec4
from fourd_ray_tracing_tpu.ops.pallas import gradkernel as jgrad
from fourd_ray_tracing_tpu.ops.pallas.gradkernel import render_loss_and_grad_pallas

from fourd_ray_tracing_tpu_torch import diff
from fourd_ray_tracing_tpu_torch.models import params
from fourd_ray_tracing_tpu_torch.models import renderer as trenderer
from fourd_ray_tracing_tpu_torch.ops.cuda import gradkernel as tgrad

from test_torch_soft_kernels import crossed, flat, mixed_rel, uniform

SHAPE = dict(width=32, height=16, samples=1, reflections_amount=2, rng_mode="per_sample",
             light_coefficient=0.7)
SEED = 5
# One axis off the production configuration at a time.
CONFIGS = {"kepler": dict(sampler_method="kepler"), "newton": dict(sampler_method="newton"),
           "spec": dict(intersect="spec"), "trig": dict(intersect="trig")}
SCENES = ["sphere_plane_light", "duocylinder"]


def _finite_factor(fn, deriv):
    """``fn`` whose JVP is t * deriv(x), the factor taken as 0 where it is
    not finite: a lane the fold masks out passes its zero cotangent on as
    0, not 0 * inf = nan (the port's geometry._zero_safe; a lane whose
    cotangent is not 0 meets such a factor only where the port's gradient
    is not finite either, and every port gradient here is finite)."""
    f = jax.custom_jvp(fn)
    f.defjvp(lambda x, t: (fn(x[0]), t[0] * jnp.where(jnp.isfinite(deriv(x[0])),
                                                       deriv(x[0]), 0.0)))
    return f


@jax.custom_jvp
def _maximum(x, y):
    return jnp.maximum(x, y)


@_maximum.defjvp
def _maximum_jvp(primals, tangents):
    """jnp.maximum's tangent (the tie halved, as JAX's) chosen by where, not
    by a product with the comparison's mask, so that the transpose drops
    the unchosen operand's cotangent: the trig sphere's l / max(l, 1e-30)
    at l = 0 (a camera on a cylinder's axis plane) sends -dot / 1e-60 =
    -inf times a zero cotangent into the max, as torch's clamp_min does
    not."""
    (x, y), (tx, ty) = primals, tangents
    x, y = jnp.broadcast_arrays(x, y)
    tx, ty = jnp.broadcast_to(tx, x.shape), jnp.broadcast_to(ty, x.shape)
    return jnp.maximum(x, y), jnp.where(x > y, tx, jnp.where(x < y, ty, 0.5 * (tx + ty)))


class _NanSafeJnp:
    """jax.numpy with the derivatives above."""

    OVERRIDES = {"sqrt": _finite_factor(jnp.sqrt, lambda x: 0.5 / jnp.sqrt(x)),
                 "arccos": _finite_factor(jnp.arccos, lambda x: -1.0 / jnp.sqrt(1.0 - x * x)),
                 "arcsin": _finite_factor(jnp.arcsin, lambda x: 1.0 / jnp.sqrt(1.0 - x * x)),
                 "maximum": _maximum}

    def __getattr__(self, name):
        return self.OVERRIDES.get(name) or getattr(jnp, name)


def _radius_guarded(fn):
    """A JAX sphere intersection with the port's radius guard
    (geometry._radius_guard): radius 0 misses, and divides by 1 in its
    place. JAX's literal spheres divide a zeroed sphere's normal by r = 0
    (geometry.py:184, :218), whose cotangent on every masked lane is
    0 * inf = nan; the guard changes the value only on a ray through the
    zeroed sphere's exact center (ROADMAP queue 3)."""
    def guarded(center, r, material, ray_o, ray_d, outer=True):
        live = r != 0.0
        out = fn(center, jnp.where(live, r, 1.0), material, ray_o, ray_d, outer)
        return out._replace(hit=jnp.logical_and(out.hit, live))
    return guarded


@pytest.fixture
def nan_safe_jax(monkeypatch):
    """The JAX reference with derivatives that are finite wherever the
    port's are: sqrt, arccos and arcsin whose infinite factors count 0, a
    maximum whose tangent is chosen by where (jax.numpy as geometry.py and
    vec4.py see it), and the literal spheres' radius guard. JAX's own
    gradient is nan on the slots a masked lane's singular derivative
    reaches (ROADMAP queue 3); under these patches every slot has a JAX
    value to hold the port to. JAX's caches are cleared on both sides, so
    no patched trace outlives the test."""
    monkeypatch.setattr(jgeometry, "jnp", _NanSafeJnp())
    monkeypatch.setattr(jvec4, "jnp", _NanSafeJnp())
    for name in ("sphere_intersection", "sphere_intersection_trig"):
        monkeypatch.setattr(jgeometry, name, _radius_guarded(getattr(jgeometry, name)))
    jax.clear_caches()
    yield
    monkeypatch.undo()
    jax.clear_caches()


def configs(mode):
    return (jrenderer.RenderConfig(**SHAPE, **mode), trenderer.RenderConfig(**SHAPE, **mode))


def bare(scene):
    """``scene`` with its hypercube built from its cells alone."""
    return scene._replace(hypercube=type(scene.hypercube)(scene.hypercube.cubes))


def crossed_bare():
    """The hypercube without generators, JAX's and the port's, the port's
    leaves crossed over from JAX's (test_torch_spec_fold.py holds both
    packings equal)."""
    js, jc, ts, tc = crossed("hypercube")
    js, ts_like = bare(js), bare(ts)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves((js, jc))]
    ts, tc = params.from_numpy_leaves(leaves, ts_like, tc)
    return js, jc, ts, tc


def assert_matches(label, loss, grad, ref_loss, ref_grad):
    """The port's (loss, grad) against JAX's, every slot."""
    grad = grad.numpy()
    rel = mixed_rel(grad, ref_grad)
    print(f"{label}: loss {float(loss)} vs {ref_loss}, grad mixed rel {rel:.3g} over "
          f"{ref_grad.size} slots")
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    assert grad.shape == ref_grad.shape
    assert np.isfinite(grad).all() and np.isfinite(ref_grad).all()
    assert rel < 1e-3
    np.testing.assert_array_equal(grad != 0, ref_grad != 0)
    assert np.abs(ref_grad).max() > 1e-6


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("name", SCENES)
def test_plain_grad_matches_pallas_kernel(name, config, request):
    """K4: loss and packed gradient, index by index (under trig against
    the nan-safe JAX reference)."""
    if config == "trig":
        request.getfixturevalue("nan_safe_jax")
    js, jc, ts, tc = crossed(name)
    j_cfg, t_cfg = configs(CONFIGS[config])
    target = uniform(1, (16, 32, 3))
    ref_loss, (gs, gc) = render_loss_and_grad_pallas(js, jc, j_cfg, SEED, jnp.asarray(target))
    loss, grad = tgrad.loss_and_grad_plain(params.pack(ts, tc), ts, tc, t_cfg, SEED,
                                           torch.from_numpy(target))
    assert_matches(f"K4 {name} {config}", loss, grad, float(ref_loss),
                   np.concatenate([flat(gs), flat(gc)]))


def test_cells_only_hypercube_matches_pallas_kernel():
    """K4 on a hypercube without generators in the production modes: JAX's
    fast fold falls back to the literal cells (geometry.py:722-723), and so
    does the port's; the gradient lands on the cells."""
    js, jc, ts, tc = crossed_bare()
    j_cfg, t_cfg = configs({})
    target = uniform(1, (16, 32, 3))
    ref_loss, (gs, gc) = render_loss_and_grad_pallas(js, jc, j_cfg, SEED, jnp.asarray(target))
    loss, grad = tgrad.loss_and_grad_plain(params.pack(ts, tc), ts, tc, t_cfg, SEED,
                                           torch.from_numpy(target))
    assert_matches("K4 hypercube_cells", loss, grad, float(ref_loss),
                   np.concatenate([flat(gs), flat(gc)]))
    lay = params.layout(ts, tc)
    assert np.abs(grad.numpy()[lay.hypercube:lay.hypercube + 8 * 26]).max() > 0


@pytest.mark.parametrize("intersect", ["spec", "trig"])
@pytest.mark.parametrize("name", ["room_with_sphere", "tiger"])
def test_frozen_mask_under_a_literal_fold_matches_jax(name, intersect):
    """with_frozen_hints under a literal fold derives no hints in either
    package: JAX's make_packed_loss_and_grad builds its mask of all ones
    (gradkernel.py:1011-1017), and the port's freeze_mask is None, which
    the launches read as nothing frozen; the same configuration's fast fold
    freezes slots in both."""
    js, jc, ts, _ = crossed(name)
    j_cfg, t_cfg = configs(dict(intersect=intersect))
    fn, _, _ = jgrad.make_packed_loss_and_grad(js, jc, jdiff.with_frozen_hints(j_cfg, js))
    cells = dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))
    j_mask = np.asarray(cells["mask_vec"])
    t_cfg_frozen = diff.with_frozen_hints(t_cfg, ts)
    assert t_cfg_frozen.freeze_hints and t_cfg_frozen.plane_hints is None
    assert t_cfg_frozen.axis_hints is None
    assert params.freeze_mask(t_cfg_frozen, ts) is None
    np.testing.assert_array_equal(j_mask, np.ones(params.n_scene(ts), np.float32))
    fast = diff.with_frozen_hints(dataclasses.replace(t_cfg, intersect="fast"), ts)
    assert (params.freeze_mask(fast, ts).numpy() == 0).any()
