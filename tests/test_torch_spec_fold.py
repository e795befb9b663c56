"""The port's literal fold (models/scene.py intersect_scene_spec, "spec"
and "trig"; ops/geometry.py's per-primitive intersections) and the fast
fold's hypercube without generators, against the JAX package's, on the
CPU.

Intersections: 256 random rays a library scene (test_oracle.py's batch),
spec and trig each held to JAX's with the same hit pattern, distances
within 1e-5 relative, the same material and normals within 1e-5, except
on rays that carry test_oracle.py's boundary certificate (an ulp-scale
perturbation flips the oracle's own answer: XLA on the CPU contracts
multiply-adds, torch does not). Renders: test_pallas.py's bounds
(tests/test_torch_render.py BOUNDS).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import assert_images_close
from test_oracle import _near_decision_boundary, _random_rays
from test_torch_render import BOUNDS, cameras

from oracle import scenes as oscenes

from fourd_ray_tracing_tpu.models import library as jlib
from fourd_ray_tracing_tpu.models import renderer as jrenderer
from fourd_ray_tracing_tpu.models.scene import intersect_scene as j_intersect
from fourd_ray_tracing_tpu.ops.pallas.megakernel import _pack_pytree
from fourd_ray_tracing_tpu.ops.vec4 import Vec4 as JVec4

from fourd_ray_tracing_tpu_torch.models import library as tlib
from fourd_ray_tracing_tpu_torch.models import params
from fourd_ray_tracing_tpu_torch.models import renderer as trenderer
from fourd_ray_tracing_tpu_torch.models import scene as tscene
from fourd_ray_tracing_tpu_torch.ops import geometry as tgeo
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4 as TVec4

CPU = torch.device("cpu")
SCENES = sorted(tlib.SCENES)
# Rendered configurations of the literal folds (the sequential stream and
# the fast fold's are tests/test_torch_render.py's).
LITERAL_CONFIGS = {
    "sequential-kepler-spec": dict(rng_mode="sequential", sampler_method="kepler",
                                   intersect="spec"),
    "per_sample-newton-trig": dict(rng_mode="per_sample", sampler_method="newton",
                                   intersect="trig"),
}
SHAPE = dict(width=32, height=16, samples=3, reflections_amount=2)


def fields(inter) -> dict:
    """An Intersection's fields as numpy, the vectors stacked last."""
    a = lambda t: np.asarray(t)  # noqa: E731
    return {"hit": a(inter.hit), "dist": a(inter.dist),
            "norm": np.stack([a(c) for c in inter.norm], -1), "glow": a(inter.glow),
            "refl": a(inter.refl_prob), "color": np.stack([a(c) for c in inter.color], -1)}


def port_rays(o_np, d_np):
    return (TVec4(*torch.from_numpy(np.ascontiguousarray(o_np.T))),
            TVec4(*torch.from_numpy(np.ascontiguousarray(d_np.T))))


def jax_rays(o_np, d_np):
    return JVec4(*jnp.asarray(o_np.T)), JVec4(*jnp.asarray(d_np.T))


def bare(scene):
    """``scene`` with its hypercube built from its cells alone."""
    return scene._replace(hypercube=type(scene.hypercube)(scene.hypercube.cubes))


@pytest.mark.parametrize("mode", ["spec", "trig"])
@pytest.mark.parametrize("name", SCENES)
def test_literal_fold_matches_jax(name, mode, rng_np):
    o_np, d_np = _random_rays(256, rng_np)
    out = fields(tscene.intersect_scene(tlib.SCENES[name](CPU), *port_rays(o_np, d_np), mode))
    with jax.disable_jit():
        ref = fields(j_intersect(jlib.SCENES[name](), *jax_rays(o_np, d_np), mode))
    both = out["hit"] & ref["hit"]
    rel = np.abs(out["dist"] - ref["dist"]) / np.maximum(np.abs(ref["dist"]), 1.0)
    disagree = (out["hit"] != ref["hit"]) | (both & (
        (rel > 1e-5) | (np.abs(out["norm"] - ref["norm"]).max(-1) > 1e-5)
        | (out["glow"] != ref["glow"]) | (out["refl"] != ref["refl"])
        | (out["color"] != ref["color"]).any(-1)))
    assert ref["hit"].sum() >= 16
    assert disagree.mean() <= 0.05, f"{disagree.sum()} disagreements of 256"
    oracle_scene = oscenes.SCENES[name]()
    for k in np.nonzero(disagree)[0]:
        assert _near_decision_boundary(oracle_scene, o_np[k], d_np[k]), (
            f"ray {k}: hit {out['hit'][k]} dist {out['dist'][k]} vs JAX hit {ref['hit'][k]} "
            f"dist {ref['dist'][k]}, off every decision boundary")
    miss = ~out["hit"]
    assert (out["dist"][miss] == 0).all() and (out["norm"][miss] == 0).all()


def random_rays(rng, n, spread=4.0):
    """test_intersect_fast.py's batch: origins in a cube, directions unit."""
    o = rng.uniform(-spread, spread, size=(n, 4)).astype(np.float32)
    d = rng.normal(size=(n, 4)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return port_rays(o, d)


@pytest.mark.parametrize("name", SCENES)
def test_fast_matches_spec(name, rng_np):
    """test_intersect_fast.py's bounds on the port's two folds."""
    scene = tlib.SCENES[name](CPU)
    o, d = random_rays(rng_np, 4096)
    fast = fields(tscene.intersect_scene_fast(scene, o, d))
    spec = fields(tscene.intersect_scene_spec(scene, o, d))
    assert (fast["hit"] != spec["hit"]).mean() < 0.005
    both = fast["hit"] & spec["hit"]
    same_obj = np.abs(fast["dist"] - spec["dist"])[both] < 1e-3
    assert same_obj.mean() > 0.995
    pick = lambda f, k: f[k][both][same_obj]  # noqa: E731
    np.testing.assert_allclose(pick(fast, "dist"), pick(spec, "dist"), atol=5e-5, rtol=1e-4)
    assert np.quantile(np.abs(pick(fast, "norm") - pick(spec, "norm")), 0.999) < 1e-3
    for k in ("glow", "refl", "color"):
        np.testing.assert_allclose(pick(fast, k), pick(spec, k), atol=1e-6)


def test_hypercube_fast_matches_literal(rng_np):
    """The fast fold's opposite-cell candidates against the literal 8 cells
    (first hit in order): the same hits and materials, distances to ulp
    re-association, the same normals."""
    hc = tlib.hypercube(CPU).hypercube
    o, d = random_rays(rng_np, 4096)
    a = fields(tgeo.hypercube_intersection(hc, o, d))
    b = fields(tscene.intersect_scene_fast(tscene.Scene(hypercube=hc), o, d))
    assert (a["hit"] != b["hit"]).mean() <= 0.001
    both = a["hit"] & b["hit"]
    rel = np.abs(a["dist"][both] - b["dist"][both]) / np.maximum(a["dist"][both], 1.0)
    assert rel.max() < 1e-5
    np.testing.assert_array_equal(a["norm"][both], b["norm"][both])
    np.testing.assert_array_equal(a["glow"][both], b["glow"][both])


def test_hypercube_fast_without_generator_params(rng_np):
    """A hypercube built from its cells alone: the fast fold takes the
    literal cell-by-cell test as its candidate, bitwise the literal fold's
    record, and as the JAX fast fold does (its fallback, scene.py:543-545)."""
    scene = bare(tlib.hypercube(CPU))
    assert not tscene.has_generators(scene.hypercube)
    o_np = rng_np.uniform(-4, 4, size=(2048, 4)).astype(np.float32)
    d_np = rng_np.normal(size=(2048, 4)).astype(np.float32)
    d_np = (d_np / np.linalg.norm(d_np, axis=1, keepdims=True)).astype(np.float32)
    o, d = port_rays(o_np, d_np)
    out = fields(tscene.intersect_scene_fast(scene._replace(spaces=()), o, d))
    lit = fields(tgeo.hypercube_intersection(scene.hypercube, o, d))
    for k in out:
        np.testing.assert_array_equal(np.where(out["hit"][..., None] if out[k].ndim > 1
                                               else out["hit"], out[k], 0),
                                      np.where(lit["hit"][..., None] if lit[k].ndim > 1
                                               else lit["hit"], lit[k], 0))
    jscene = bare(jlib.hypercube())
    with jax.disable_jit():
        ref = fields(j_intersect(jscene, *jax_rays(o_np, d_np), "fast"))
    full = fields(tscene.intersect_scene_fast(scene, o, d))
    np.testing.assert_array_equal(full["hit"], ref["hit"])
    np.testing.assert_allclose(full["dist"], ref["dist"], rtol=1e-5)
    assert out["hit"].sum() >= 16


def test_generator_less_hypercube_weights_carry_across():
    """A JAX hypercube scene without generators packs to the port's P and
    values (its cells only: 21 floats fewer), and its JAX leaves carried
    into the port's structure pack to the same vector."""
    jc, tc = cameras(("yxz",))
    jscene, tscene_ = bare(jlib.hypercube()), bare(tlib.hypercube(CPU))
    ref = np.asarray(_pack_pytree((jscene, jc))[0])
    out = params.pack(tscene_, tc).numpy()
    assert out.shape == ref.shape == (params.layout(tlib.hypercube(CPU), tc).size - 21,)
    np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))
    lay = params.layout(tscene_, tc)
    assert lay.size == out.size and lay.hypercube_cells == 1
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves((jscene, jc))]
    scene2, camera2 = params.from_numpy_leaves(leaves, tscene_, tc)
    np.testing.assert_array_equal(params.pack(scene2, camera2).numpy(), out)


@pytest.mark.parametrize("config", sorted(LITERAL_CONFIGS))
@pytest.mark.parametrize("name", SCENES)
def test_literal_renders_match_jax(name, config):
    """render_light through the literal folds, with the kepler and the
    newton sampler, against JAX's jnp render_light."""
    shape = dict(SHAPE, **LITERAL_CONFIGS[config])
    jc, tc = cameras(("yxz",))
    ref = np.asarray(jrenderer.render_light(jlib.SCENES[name](), jc,
                                            jrenderer.RenderConfig(**shape), 7))
    out = trenderer.render_light(tlib.SCENES[name](CPU), tc, trenderer.RenderConfig(**shape),
                                 7).numpy()
    assert float(np.abs(out).max()) > 0.0
    assert_images_close(out, ref, **BOUNDS)


@pytest.mark.parametrize("intersect", ["fast", "spec"])
def test_generator_less_hypercube_renders_match_jax(intersect):
    shape = dict(SHAPE, rng_mode="per_sample", intersect=intersect)
    jc, tc = cameras(("yxz",))
    ref = np.asarray(jrenderer.render_light(bare(jlib.hypercube()), jc,
                                            jrenderer.RenderConfig(**shape), 5))
    cfg = trenderer.RenderConfig(**shape)
    out = trenderer.render_light(bare(tlib.hypercube(CPU)), tc, cfg, 5).numpy()
    assert_images_close(out, ref, **BOUNDS)
    with_gen = trenderer.render_light(tlib.hypercube(CPU), tc, cfg, 5).numpy()
    assert_images_close(out, with_gen, **BOUNDS)
    if intersect == "spec":
        np.testing.assert_array_equal(out, with_gen)  # the spec fold reads the cells either way
