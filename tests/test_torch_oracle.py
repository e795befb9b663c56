"""The port's plain pipeline against the INDEPENDENT oracle (oracle/, a
scalar NumPy transcription of the reference shader that imports nothing of
either package) and its checked-in golden images (tests/goldens/*.npz).

Mirrors tests/test_oracle.py, at its shapes and within its bounds, on the
port: the RNG bit-exact, the per-sample stream key, the intersections of
every fold (each disagreement carrying test_oracle.py's boundary
certificate), the geometry goldens (0 bounces: at most 2% of pixels over
1e-4 after the tone map) on the 5 scenes and the ywz view, and the path
trace goldens (at most 10% of pixels over 1e-3, mean at most 0.01) per
sample on the 5 scenes and for the sequential stream. Every check here
is against a source that shares no math with the port; the goldens
stay as tools/gen_goldens.py wrote them.
"""
import numpy as np
import pytest
import torch

from test_oracle import (A_H, A_W, B_BOUNCES, B_H, B_SPP, B_W, SCENE_NAMES, SEED,
                         _near_decision_boundary, _random_rays, golden, image_stats, tonemap)

from oracle import frag as ofrag
from oracle import scenes as oscenes

from fourd_ray_tracing_tpu_torch import camera as tcam
from fourd_ray_tracing_tpu_torch.models import library
from fourd_ray_tracing_tpu_torch.models import renderer as trenderer
from fourd_ray_tracing_tpu_torch.models.scene import intersect_scene
from fourd_ray_tracing_tpu_torch.ops import rng as trng
from fourd_ray_tracing_tpu_torch.ops.sampler import w_by_volume_newton
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4

CPU = torch.device("cpu")
F = np.float32


def production_camera(view="yxz"):
    return tcam.camera_from_state(Vec4.of(0.0, -2.0, 0.0, 0.0, device=CPU),
                                  tcam.CameraAngles.of(0.0, 0.0, 0.0, device=CPU), 1.5, 2.0,
                                  view, device=CPU)


def render(scene_name, cfg, view="yxz"):
    return trenderer.render_light(library.SCENES[scene_name](CPU), production_camera(view), cfg,
                                  SEED).numpy()


def test_rng_bitexact_vs_oracle():
    """ops/rng.py's integer stream, exactly the oracle's."""
    seed = 0xDEADBEEF
    for sx, sy in [(F(0.3), F(0.7)), (F(0.015625), F(0.975)), (F(0.5), F(0.5))]:
        orng = ofrag.Rng(seed, sx, sy)
        bits = trng.pixel_stream_bits(torch.tensor(sx), torch.tensor(sy))
        assert int(bits) == orng.pixel_bits
        counter = trng.init_counter(seed, torch.tensor(0.0))
        for _ in range(16):
            u_o = orng.rand()
            u_p, counter = trng.uniform01(bits, seed, counter)
            assert ofrag.float_bits(u_o) == ofrag.float_bits(F(u_p.item()))
            assert int(counter) == orng.rand_iter_seed


def test_per_sample_stream_key_matches_oracle():
    pixel_bits = torch.tensor(0x12345678, dtype=torch.int64)
    for s in (0, 1, 2, 7, 255):
        assert int(trenderer.sample_stream_bits(pixel_bits, s)) == ofrag._per_sample_bits(
            0x12345678, s)


def test_newton_sampler_vs_float64_inverse():
    """Within its own tolerance of the true float64 inverse CDF."""

    def cdf64(w):
        return (w * np.sqrt(1 - w * w) - np.arccos(w)) / np.pi + 1

    def inv64(v):
        lo, hi = -1.0, 1.0
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            lo, hi = (mid, hi) if cdf64(mid) < v else (lo, mid)
        return 0.5 * (lo + hi)

    v = np.linspace(0.01, 0.99, 51, dtype=np.float32)
    got = w_by_volume_newton(torch.from_numpy(v)).numpy()
    assert np.abs(got - np.array([inv64(float(x)) for x in v])).max() < 6e-4


@pytest.fixture(scope="module")
def oracle_hits():
    """Per scene: the rays (test_oracle.py's batch) and the oracle's hit,
    distance, normal and glow at each."""
    out = {}
    for name in SCENE_NAMES:
        o_np, d_np = _random_rays(256, np.random.default_rng(0))
        scene = oscenes.SCENES[name]()
        inters = [scene.find_intersection(o_np[k], d_np[k]) for k in range(len(o_np))]
        out[name] = (o_np, d_np, np.array([i.did_intersect for i in inters]),
                     np.array([i.dist for i in inters], np.float32),
                     np.array([i.norm for i in inters], np.float32),
                     np.array([i.material.glow for i in inters], np.float32))
    return out


@pytest.mark.parametrize("mode", ["trig", "spec", "fast"])
@pytest.mark.parametrize("scene_name", SCENE_NAMES)
def test_intersect_vs_oracle(scene_name, mode, oracle_hits):
    """intersect_scene in every mode against the oracle's find_intersection
    ray by ray; every disagreement (a hit flip, a distance off by more
    than 1e-4 relative, a normal by 1e-2, another material) must carry the
    boundary certificate."""
    o_np, d_np, want_hit, want_dist, want_norm, want_glow = oracle_hits[scene_name]
    o = Vec4(*torch.from_numpy(np.ascontiguousarray(o_np.T)))
    d = Vec4(*torch.from_numpy(np.ascontiguousarray(d_np.T)))
    got = intersect_scene(library.SCENES[scene_name](CPU), o, d, mode)
    got_hit, got_dist = got.hit.numpy(), got.dist.numpy()
    got_norm = torch.stack(list(got.norm), -1).numpy()
    got_glow = got.glow.numpy()
    both = got_hit & want_hit
    rel = np.where(both, np.abs(got_dist - want_dist) / np.maximum(np.abs(want_dist), 1.0), 0.0)
    disagree = ((got_hit != want_hit) | (both & (rel > 1e-4))
                | (both & (np.abs(got_norm - want_norm).max(axis=-1) > 1e-2))
                | (both & (got_glow != want_glow)))
    assert disagree.mean() <= 0.05, f"{disagree.sum()} disagreements of 256"
    oracle_scene = oscenes.SCENES[scene_name]()
    for k in np.nonzero(disagree)[0]:
        assert _near_decision_boundary(oracle_scene, o_np[k], d_np[k]), (
            f"ray {k} disagrees with the oracle off every decision boundary: got "
            f"hit={got_hit[k]} dist={got_dist[k]:.6g} vs hit={want_hit[k]} dist={want_dist[k]:.6g}")
    assert np.quantile(rel[both], 0.98) < 1e-4


def geometry_cfg():
    return trenderer.RenderConfig(width=A_W, height=A_H, samples=1, reflections_amount=0,
                                  sampler_method="newton", rng_mode="sequential",
                                  intersect="spec")


@pytest.mark.parametrize("scene_name", SCENE_NAMES)
def test_golden_geometry(scene_name):
    got = render(scene_name, geometry_cfg())
    per_pixel = np.abs(tonemap(got) - tonemap(golden(scene_name, "a_light"))).reshape(
        -1, 3).max(axis=-1)
    frac = (per_pixel > 1e-4).mean()
    assert frac <= 0.02, f"{frac:.2%} of pixels differ (max {per_pixel.max():.3g})"


def test_golden_geometry_additional_view():
    """The ywz section (top, w_drct basis)."""
    got = render("sphere_plane_light", geometry_cfg(), view="ywz")
    per_pixel = np.abs(tonemap(got) - tonemap(golden("sphere_plane_light", "a_light_ywz"))
                       ).reshape(-1, 3).max(axis=-1)
    assert (per_pixel > 1e-4).mean() <= 0.02


def path_cfg(rng_mode):
    return trenderer.RenderConfig(width=B_W, height=B_H, samples=B_SPP,
                                  reflections_amount=B_BOUNCES, sampler_method="newton",
                                  rng_mode=rng_mode, intersect="spec")


@pytest.mark.parametrize("scene_name", SCENE_NAMES)
def test_golden_pathtrace(scene_name):
    frac, mean = image_stats(render(scene_name, path_cfg("per_sample")),
                             golden(scene_name, "b_per"))
    assert frac <= 0.10 and mean <= 0.01, f"frac={frac:.2%} mean={mean:.4f}"


def test_golden_pathtrace_sequential_stream():
    """The sequential stream carries across the sample loop, the final
    iteration's dead draws included: with 2 samples this fails if the
    stream is cut short."""
    frac, mean = image_stats(render("sphere_plane_light", path_cfg("sequential")),
                             golden("sphere_plane_light", "b_seq"))
    assert frac <= 0.10 and mean <= 0.01, f"frac={frac:.2%} mean={mean:.4f}"


@pytest.mark.parametrize("bounces", [0, 1])
@pytest.mark.parametrize("scene_name", ["room_with_sphere", "sphere_plane_light"])
def test_sequential_counters_match_oracle(scene_name, bounces):
    """The sequential stream's counter after each of 3 samples, pixel by
    pixel, is the oracle's rand_iter_seed after its trace() of the same
    pixel, which draws on every iteration, the last included: the port's
    dead draws stand for those. Pixels whose trace the oracle and the port
    decide apart (a hit flip on a silhouette) are at most 2%."""
    from oracle.scenes import SCENES as ORACLE_SCENES
    from tools.gen_goldens import oracle_camera

    cfg = trenderer.RenderConfig(width=A_W, height=A_H, samples=3, reflections_amount=bounces,
                                 sampler_method="newton", rng_mode="sequential",
                                 intersect="spec")
    scene, camera = library.SCENES[scene_name](CPU), production_camera()
    scr_x, scr_y = trenderer.screen_coords(cfg, CPU)
    d = trenderer.primary_directions(camera, scr_x, scr_y)
    bits = trng.pixel_stream_bits(scr_x, scr_y)
    o = Vec4(*(c.expand(d.x.shape) for c in camera.focus))
    counter = trng.init_counter(SEED, d.x)
    pre0 = trenderer.precompute_bounce0(scene, o, d, cfg)
    port = []
    for _ in range(cfg.samples):
        _, counter = trenderer.trace_rays(scene, d, bits, SEED, counter, cfg, pre0)
        port.append(counter.numpy())
    oscene, ocam = ORACLE_SCENES[scene_name](), oracle_camera()
    agree = []
    for i in range(A_H):
        for j in range(A_W):
            sx, sy = F(scr_x[i, j].item()), F(scr_y[i, j].item())
            rng = ofrag.Rng(SEED, sx, sy)
            want = []
            for _ in range(cfg.samples):
                ofrag.trace(oscene, ocam.focus, ofrag.ray_drct(ocam, sx, sy), rng, bounces,
                            F(cfg.small_indent))
                want.append(rng.rand_iter_seed)
            agree.append(want == [int(c[i, j]) for c in port])
    assert np.mean(agree) >= 0.98
    assert (port[0] != SEED).any()
