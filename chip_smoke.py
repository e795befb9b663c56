#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
card and the CUDA toolkit's nvcc, and exits non-zero (printing no result)
on any failure, or when no CUDA device is available. Phases:

1. device: the card's name and power limit;
2. build: the kernels from fourd_ray_tracing_tpu_torch/csrc;
3. kernel vs plain torch pipeline on the card, 256x144, 4 spp, 4 bounces,
   both scenes, 1 and 3 views, a (2,) seed vector; bitwise self-consistency;
4. main path: RenderEngine on room_with_sphere at 1280x720, 8 spp,
   4 bounces, per-sample RNG, step_frames(4) = one 4-frame launch, timed
   with CUDA events;
5. the batch app on configs/properties.txt (121x75 + 2x60x37, 100 spp);
   the kernel launches of phases 4-5 are counted;
6. the kernel alone and the plain pipeline timed at phase 4's shape, and
   their 4 frames held against each other;
7. the kernel against the plain pipeline on each of the app's view groups
   (1 view at 121x75, 2 views at 60x37), with the app's own cameras;
8. the value-and-grad kernel K4 against its plain version (torch autograd
   over the plain pipeline) on the card: both scenes, 1 and 3 views,
   256x144, 4 spp, 4 bounces, a (2,) seed vector, a seeded random target;
   bitwise across two launches; the (2,) launch against the mean of the
   two scalar-seed launches; K4 and its plain version timed at
   256x144x8spp x4 bounces; at phase 9's shape (1280x720x8spp x4, 1 and 4
   frames) K4 held against the plain version taken in row bands, both
   timed; at phase 10's shape the forward kernel's target render and K4
   held against their plain versions;
9. the training main path: make_packed_train_step (Adam on the packed
   vector, one K4 launch per step) on room_with_sphere at 1280x720, 8 spp,
   4 bounces, a zero target, lr 1e-3, timed with CUDA events, for 1 and 4
   frames per step;
10. the entry point: ``inverse_render --param glow --impl kernel`` with
   and without ``--packed`` recovers the lamp's glow;
11. the light-VJP kernel K5 against its plain version (torch autograd of
   sum(render_light * cot)) on the card: both scenes, 1 and 3 views,
   256x144, 4 spp, 4 bounces, a seeded random cotangent; bitwise across
   launches; K2 (the forward kernel over (F, P) params rows: a scene and
   its zero_object copy) row by row bitwise single K1 renders, and K5's
   two-row launch row by row bitwise single K5 launches and held against
   the plain version; then K5 at the soft main path's 1280x720x8spp x4
   against the plain version, both timed;
12. the fused soft value-and-grad kernel K6 against its plain version
   (autograd over the plain blend, alpha an independent leaf): the room's
   sphere 0 and the lamp scene's sphere 1, 1 and 3 views, 256x144, 4 spp,
   4 bounces, the coverage alpha and a seeded random target; bitwise
   across launches; the zeroed row's light bitwise the drop_object light;
   then at 1280x720x8spp x4 against the plain version in row bands, both
   timed, and at ``inverse_render --param position``'s shape;
13. the soft training main path: make_train_step(impl="kernel",
   soft_object_ref=("spheres", 0)) on room_with_sphere at 1280x720, 8 spp,
   4 bounces, a zero target, edge width 0.05, lr 1e-3, one K6 launch per
   step, timed with CUDA events beside K6 alone, the coverage's forward
   and backward alone and Adam alone; the hyperplane fallback
   (("spaces", 0): two K1 and two K5 launches per step), timed; then
   ``inverse_render --param position --impl kernel`` recovers the lamp's
   x;
14. the row-sharded launches (K3) in one process: K1 and K2 cut into 2
   and 4 row blocks (``parallel.mesh.row_block``) are bitwise the single
   launch at 1280x720x8spp x4 (4 frames) and at 256x144 with 3 views; the
   blocks of K4 (1 and 4 frames), K5 (two rows) and K6 at 1280x720x8spp x4,
   added in rank order, within ``GRAD_BOUNDS`` of the single launch, K6's
   alpha cotangent blocks bitwise its rows; each of the ``PLAIN_SPLIT``
   blocks of K1, K2 (both shapes), K4 (1 frame), K5 and K6 held against its
   plain version on the same rows (CHECK_BOUNDS, GRAD_BOUNDS); each
   block's launch and the single launch timed with CUDA events;
15. the distributed main path: ``multihost_run`` with 2 ranks (gloo, both
   on this card; NCCL, one card each, when there are two): the sharded
   image bitwise the single-process K1 render, 3 steps of
   ``make_train_step(impl="kernel", mesh=...)`` at 1280x720x8spp x4 for the
   hard loss and the soft loss (sphere 0) within loss and parameter rtol
   1e-5 of the single process with one K4 (K6) launch per rank and step,
   the soft pair's gradient (K2 + two-row K5 on each rank's rows), and
   ``inverse_render --mesh --impl kernel`` recovering the glow. Both ranks
   share one card, so its step times are no scaling figure.

Every kernel's entry in the summary carries its bound: the larger of its
plain version's flops (utils/flops.py, counted on the card over
``BOUND_ROWS`` rows of the timed shape and scaled to the whole image) over
the card's fp32 peak and the bytes it must move (each input read once,
each output written once) over its memory rate (``PEAKS``).

Every forward kernel-vs-plain check holds the two within the image bounds
of ``CHECK_BOUNDS`` and reports whether they are bitwise equal; the
gradient kernels' checks use ``GRAD_BOUNDS``. The kernel launch counts are
set to 0 before each main path (phases 4-5: rendering; phases 9-10:
training; phase 13: soft training; phase 15: the ranks, fresh processes,
count their own) and read after it.

The line before the last is the kernels' JSON summary, the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from fourd_ray_tracing_tpu_torch import app  # noqa: E402
from fourd_ray_tracing_tpu_torch import camera as cam  # noqa: E402
from fourd_ray_tracing_tpu_torch import diff, inverse_render, multihost_run  # noqa: E402
from fourd_ray_tracing_tpu_torch.engine import RenderEngine  # noqa: E402
from fourd_ray_tracing_tpu_torch.models import library, params, renderer  # noqa: E402
from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig  # noqa: E402
from fourd_ray_tracing_tpu_torch.ops.cuda import build  # noqa: E402
from fourd_ray_tracing_tpu_torch.ops.cuda import gradkernel, megakernel  # noqa: E402
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4  # noqa: E402
from fourd_ray_tracing_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from fourd_ray_tracing_tpu_torch.utils.config import AppConfig  # noqa: E402
from fourd_ray_tracing_tpu_torch.utils.flops import count_flops  # noqa: E402

# All but boundary_frac of pixels within atol, image-wide mean |diff|
# under mean_atol: visibility-boundary pixels may flip on ulp noise.
CHECK_BOUNDS = dict(atol=1e-5, boundary_frac=0.01, mean_atol=0.005)
APP_CONFIG, APP_SCENE = ROOT / "configs" / "properties.txt", "room_with_sphere"
HEADLINE = dict(width=1280, height=720, samples=8, reflections_amount=4, rng_mode="per_sample")
FRAMES_PER_LAUNCH = 4
CALLS, REPEATS = 5, 5  # timed: REPEATS runs of CALLS back-to-back calls
# K4 against its plain version: loss within rtol, every gradient within a
# mixed-scale relative error (|a - b| / max(|b|, 1e-3 max|b| + 1e-8), as
# tests/test_gradkernel.py:74-76) with the same non-zero pattern; the
# (F,) launch against the mean of the scalar-seed launches within rtol.
# Both sides round alike (no FMA contraction) and differ only in the order
# of their sums, so the gradient bound is 1e-4 here (the largest error read
# on the card was 4.38e-6); the CPU tests against XLA, which contracts
# FMAs, keep 1e-3.
GRAD_BOUNDS = dict(loss_rtol=1e-6, grad_mixed_rel=1e-4, minibatch_rtol=1e-5)
GRAD_CHECK = dict(width=256, height=144, samples=4, reflections_amount=4, rng_mode="per_sample",
                  light_coefficient=0.12)
# Training shapes of the JAX package's bench (bench.py train_scan4 and
# train_minibatch4): room 1280x720x8spp x4 bounces, light_coefficient
# 0.12. At that shape the plain version runs one frame and BAND_ROWS rows
# at a time (gradkernel.loss_and_grad_plain's band_rows); at 256x144 it
# runs whole.
TRAIN = dict(HEADLINE, light_coefficient=0.12)
TRAIN_SMALL = dict(TRAIN, width=256, height=144)
BAND_ROWS = 144
TRAIN_FRAMES = (1, 4)
TRAIN_CALLS, TRAIN_REPEATS = 3, 3
# The soft-silhouette slice: the object each scene's soft checks take
# (the JAX bench's soft_step takes the room's sphere 0; inverse_render
# --param position the lamp, sphere 1), and the main path's edge width.
SOFT_REFS = {"room_with_sphere": ("spheres", 0), "sphere_plane_light": ("spheres", 1)}
SOFT_EDGE = 0.05
FALLBACK_REF = ("spaces", 0)
# Phase 14: the row shards (K3), and the split whose blocks are each held
# against their plain version on the same rows (phase 15's, one block per
# rank); phase 15: the ranks of the distributed run.
SHARDS = (2, 4)
RANKS = 2
PLAIN_SPLIT = RANKS
# Published H100 SXM peaks at 700 W (NVIDIA's data sheet): fp32 outside the
# tensor cores, and HBM3. The bounds count flops over BOUND_ROWS rows.
PEAKS = dict(fp32_flops_per_s=67e12, bytes_per_s=3.35e12)
BOUND_ROWS = 8


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def cuda_ms(fn, calls: int = CALLS, repeats: int = REPEATS) -> list:
    """Milliseconds per call of ``fn`` by CUDA events around ``calls``
    back-to-back calls, once per repeat."""
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return times


def check_close(label: str, kernel: torch.Tensor, plain: torch.Tensor) -> float:
    """Hold a kernel result against the plain pipeline's within
    CHECK_BOUNDS; prints the comparison and returns max |kernel - plain|."""
    assert kernel.shape == plain.shape, f"{label}: {tuple(kernel.shape)} vs {tuple(plain.shape)}"
    bitwise = bool(torch.equal(kernel, plain))
    a, b = kernel.cpu().numpy(), plain.cpu().numpy()
    assert np.isfinite(a).all() and np.isfinite(b).all(), f"{label}: non-finite values"
    diff = np.abs(a - b)
    err, mean = float(diff.max()), float(diff.mean())
    frac = float((diff.reshape(-1, a.shape[-1]).max(-1) > CHECK_BOUNDS["atol"]).mean())
    print(f"{label} shape={tuple(a.shape)} max_abs_err={err} mean_abs_err={mean} "
          f"frac_over_atol={frac} bitwise={bitwise}", flush=True)
    assert frac <= CHECK_BOUNDS["boundary_frac"], f"{label}: {frac:.2%} of pixels over atol"
    assert mean <= CHECK_BOUNDS["mean_atol"], f"{label}: mean abs diff {mean}"
    return err


def camera_for(views, device):
    orient = cam.orientation_from_angles(*cam.CameraAngles.of(0.0, 0.0, 0.0, device=device), device)
    return cam.make_camera(Vec4.of(0.0, -2.0, 0.0, 0.0, device=device), orient, 1.5, 2.0, views, device)


def check_kernel_against_plain(device) -> float:
    """Phase 3; returns the largest |kernel - plain| light difference."""
    cfg = RenderConfig(width=256, height=144, samples=4, reflections_amount=4, rng_mode="per_sample")
    seeds = np.array([0x12345678, 0x9ABCDEF0], np.uint32)
    worst = 0.0
    for name in sorted(library.SCENES):
        scene = library.SCENES[name](device)
        for views in (("yxz",), cam.VIEWS_ALL):
            camera = camera_for(views, device)
            out = megakernel.render_light_cuda(scene, camera, cfg, seeds)
            again = megakernel.render_light_cuda(scene, camera, cfg, seeds)
            plain = renderer.render_light(scene, camera, cfg, seeds)
            torch.cuda.synchronize()
            assert torch.equal(out, again), f"{name} {views}: two launches differ"
            for k, s in enumerate(seeds):
                single = megakernel.render_light_cuda(scene, camera, cfg, int(s))
                assert torch.equal(out[k], single), f"{name} {views}: frame {k} != scalar-seed launch"
            worst = max(worst, check_close(f"{name} views={len(views)}", out, plain))
    return worst


def main_path(device):
    """Phase 4: the engine at the headline shape, step_frames(4) timed.
    Returns (engine, per-launch milliseconds)."""
    scene = library.room_with_sphere(device)
    engine = RenderEngine(
        scene, RenderConfig(**HEADLINE), Vec4.of(0.0, -2.0, 0.0, 0.0, device=device),
        cam.CameraAngles.of(0.0, 0.0, 0.0, device=device), device=device, deterministic=True,
    )
    before = megakernel.LAUNCHES
    engine.step_frames(FRAMES_PER_LAUNCH)  # warm-up launch
    torch.cuda.synchronize()
    assert megakernel.LAUNCHES == before + 1, "step_frames(4) must be one kernel launch"
    engine_ms = cuda_ms(lambda: engine.step_frames(FRAMES_PER_LAUNCH))
    assert megakernel.LAUNCHES == before + 1 + CALLS * REPEATS
    img = engine.accum
    assert img.shape == (720, 1280, 3) and bool(torch.isfinite(img).all())
    assert float(img.std()) > 0.0, "the headline image is constant"
    return engine, engine_ms


def time_kernel_and_plain(engine):
    """Phase 6: the kernel alone on prepacked inputs, and the plain
    pipeline once, on the same 4 frames of the headline shape; the two
    results are held against each other. Returns (kernel ms, plain ms,
    max |kernel - plain|)."""
    scene, cfg = engine.scene, engine.cfg
    camera = engine.groups[0].camera(engine)
    packed, lay = params.pack(scene, camera), params.layout(scene, camera)
    seed_words = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device=engine.device)
    out = megakernel.launch_forward(packed, lay, cfg, seed_words)[:, 0]
    kernel_ms = cuda_ms(lambda: megakernel.launch_forward(packed, lay, cfg, seed_words))
    renderer.render_light(scene, camera, cfg, 1)  # warms the allocator at this shape
    plain = []
    plain_ms = cuda_ms(lambda: plain.append(renderer.render_light(
        scene, camera, cfg, np.arange(1, 5, dtype=np.uint32))), calls=1, repeats=1)[0]
    err = check_close("room headline 4 frames", out, plain[0])
    return kernel_ms, plain_ms, err


def check_app_groups(device) -> float:
    """Phase 7: the kernel against the plain pipeline on each view group
    of the app's engine, with its cameras, configs and a (2,) seed vector.
    Returns the largest |kernel - plain|."""
    engine = app.build_engine(replace(AppConfig.load(APP_CONFIG), scene=APP_SCENE), device)
    seeds = np.array([0x0BADF00D, 0xC0FFEE11], np.uint32)
    worst = 0.0
    for g in engine.groups:
        camera = g.camera(engine)
        out = megakernel.render_light_cuda(engine.scene, camera, g.cfg, seeds)
        plain = renderer.render_light(engine.scene, camera, g.cfg, seeds)
        label = f"app group {g.cfg.width}x{g.cfg.height} views={','.join(g.views)}"
        worst = max(worst, check_close(label, out, plain))
    return worst


def mixed_rel(a: np.ndarray, b: np.ndarray) -> float:
    scale = np.maximum(np.abs(b), 1e-3 * np.abs(b).max() + 1e-8)
    return float((np.abs(a - b) / scale).max())


def compare_grad(label: str, kernel, plain):
    """Hold K4's (loss, grad) against the plain version's within
    GRAD_BOUNDS; prints the comparison and returns (max |K4 - plain| over
    loss and gradient, mixed-scale relative gradient error)."""
    k_l, p_l = float(kernel[0]), float(plain[0])
    k_g, p_g = kernel[1].cpu().numpy(), plain[1].cpu().numpy()
    assert k_g.shape == p_g.shape, f"{label}: {k_g.shape} vs {p_g.shape}"
    assert np.isfinite(k_g).all() and np.isfinite(k_l), f"{label}: non-finite K4 output"
    rel = mixed_rel(k_g, p_g)
    err = max(abs(k_l - p_l), float(np.abs(k_g - p_g).max()))
    same_nz = bool(((k_g != 0) == (p_g != 0)).all())
    print(f"K4 {label} P={k_g.size} loss={k_l} plain={p_l} loss_rel={abs(k_l - p_l) / abs(p_l):.3g} "
          f"grad_mixed_rel={rel:.3g} max_abs_err={err:.3g} "
          f"nonzero={int((k_g != 0).sum())}/{int((p_g != 0).sum())} same_pattern={same_nz}",
          flush=True)
    assert abs(k_l - p_l) <= GRAD_BOUNDS["loss_rtol"] * abs(p_l), f"{label}: loss"
    assert rel <= GRAD_BOUNDS["grad_mixed_rel"], f"{label}: gradient error {rel}"
    assert same_nz, f"{label}: non-zero patterns differ"
    return err, rel


def check_grad_kernel(device):
    """Phase 8 checks; returns (max |K4 - plain| over loss and gradients,
    max mixed-scale relative gradient error)."""
    cfg = RenderConfig(**GRAD_CHECK)
    seeds = np.array([0x12345678, 0x9ABCDEF0], np.uint32)
    worst_abs = worst_rel = 0.0
    for name in sorted(library.SCENES):
        scene = library.SCENES[name](device)
        for views in (("yxz",), cam.VIEWS_ALL):
            label = f"{name} views={len(views)}"
            camera = camera_for(views, device)
            packed, lay = params.pack(scene, camera), params.layout(scene, camera)
            shape = (cfg.height, cfg.width, 3) if len(views) == 1 else (len(views), cfg.height,
                                                                          cfg.width, 3)
            target = torch.from_numpy(
                np.random.default_rng(1).uniform(0, 1, shape).astype(np.float32)).to(device)
            words = megakernel.seed_tensor(seeds, device)
            loss, grad = gradkernel.launch_loss_grad(packed, lay, cfg, words, target)
            loss2, grad2 = gradkernel.launch_loss_grad(packed, lay, cfg, words, target)
            plain = gradkernel.loss_and_grad_plain(packed, scene, camera, cfg, seeds, target)
            torch.cuda.synchronize()
            assert torch.equal(loss, loss2) and torch.equal(grad, grad2), f"{label}: launches differ"
            err, rel = compare_grad(label, (loss, grad), plain)
            singles = [gradkernel.launch_loss_grad(packed, lay, cfg,
                                                   megakernel.seed_tensor([s], device), target)
                       for s in seeds]
            mean_l = sum(float(sl) for sl, _ in singles) / len(seeds)
            mean_g = sum(sg.cpu().numpy() for _, sg in singles) / len(seeds)
            k_l = float(loss)
            print(f"K4 {label} minibatch_vs_mean_loss_rel={abs(k_l - mean_l) / abs(mean_l):.3g}",
                  flush=True)
            np.testing.assert_allclose(k_l, mean_l, rtol=GRAD_BOUNDS["minibatch_rtol"])
            np.testing.assert_allclose(
                grad.cpu().numpy(), mean_g, rtol=GRAD_BOUNDS["minibatch_rtol"],
                atol=1e-7 * max(1.0, float(np.abs(mean_g).max())))
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
    return worst_abs, worst_rel


def peak_gb(fn):
    """(fn(), peak bytes the CUDA allocator held during it, in GB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 1e9


def time_grad_kernel(device):
    """Phase 8 at the training shapes: K4 and its plain version on the same
    inputs at TRAIN_SMALL (plain whole) and at TRAIN for each frame count
    of phase 9 (plain in row bands), held against each other and timed.
    Returns a dict of the timings, errors and the plain version's peak
    memory."""
    scene, camera = library.room_with_sphere(device), camera_for(("yxz",), device)
    packed, lay = params.pack(scene, camera), params.layout(scene, camera)
    small = RenderConfig(**TRAIN_SMALL)
    target = torch.zeros((small.height, small.width, 3), device=device)
    words = megakernel.seed_tensor([1], device)
    out = []
    res = {"k4_small_ms": cuda_ms(lambda: out.append(
        gradkernel.launch_loss_grad(packed, lay, small, words, target)))}
    plain = []
    gradkernel.loss_and_grad_plain(packed, scene, camera, small, 1, target)  # warm-up
    res["plain_small_ms"], res["plain_small_peak_gb"] = peak_gb(lambda: cuda_ms(
        lambda: plain.append(gradkernel.loss_and_grad_plain(packed, scene, camera, small, 1,
                                                            target)),
        calls=1, repeats=3))
    errs = [compare_grad(f"room {small.width}x{small.height}x{small.samples}spp "
                         f"x{small.reflections_amount} F=1", out[-1], plain[-1])]
    full = RenderConfig(**TRAIN)
    target = torch.zeros((full.height, full.width, 3), device=device)
    for key in ("k4_full_ms", "plain_full_ms", "plain_band_peak_gb"):
        res[key] = {}
    for frames in TRAIN_FRAMES:
        seeds = list(range(1, frames + 1))
        words = megakernel.seed_tensor(seeds, device)
        kernel = gradkernel.launch_loss_grad(packed, lay, full, words, target)  # and warm-up
        plain = []
        ms, res["plain_band_peak_gb"][frames] = peak_gb(lambda: cuda_ms(
            lambda: plain.append(gradkernel.loss_and_grad_plain(
                packed, scene, camera, full, seeds, target, band_rows=BAND_ROWS)),
            calls=1, repeats=1))
        res["plain_full_ms"][frames] = ms[0]
        errs.append(compare_grad(f"room 1280x720x8spp x4 F={frames} (plain in {BAND_ROWS}-row "
                                 "bands)", kernel, plain[0]))
        res["k4_full_ms"][frames] = cuda_ms(
            lambda: gradkernel.launch_loss_grad(packed, lay, full, words, target),
            calls=TRAIN_CALLS, repeats=TRAIN_REPEATS)
    res["err"], res["rel"] = max(e for e, _ in errs), max(r for _, r in errs)
    print(f"plain version peak memory: {res['plain_small_peak_gb']:.3f} GB whole at 256x144, "
          f"{res['plain_band_peak_gb'][1]:.3f} GB per {BAND_ROWS}-row band at 1280x720", flush=True)
    return res


def check_inverse_render_shapes(device):
    """Phase 8 at phase 10's shape: the forward kernel's target render and
    K4 at the starting scene, each against its plain version. Returns
    (max |K1 - plain| light, max |K4 - plain|, K4 mixed relative error)."""
    args = inverse_render.parse_args([])
    cfg, camera, target, scene0 = inverse_render.setup(args, device)
    truth = inverse_render.make_scene(1.0, inverse_render.TRUE_GLOW, device)
    label = f"inverse_render {cfg.width}x{cfg.height}x{cfg.samples}spp x{cfg.reflections_amount}"
    light_err = check_close(f"{label} target", megakernel.render_light_cuda(
        truth, camera, cfg, args.seed), renderer.render_light(truth, camera, cfg, args.seed))
    packed = params.pack(scene0, camera)
    err, rel = compare_grad(label, gradkernel.loss_and_grad_cuda(
        packed, scene0, camera, cfg, args.seed, target), gradkernel.loss_and_grad_plain(
        packed, scene0, camera, cfg, args.seed, target))
    return light_err, err, rel


def train_main_path(device, frames: int) -> list:
    """Phase 9: the packed train step at TRAIN, ``frames`` frames per step;
    one warm-up step, then timed steps. Returns ms per step."""
    cfg = RenderConfig(**TRAIN)
    scene, camera = library.room_with_sphere(device), camera_for(("yxz",), device)
    target = torch.zeros((cfg.height, cfg.width, 3), device=device)
    step, init, unpack = diff.make_packed_train_step(cfg, 1e-3, camera, scene,
                                                     frames_per_step=frames)
    model, opt = init(scene)
    vec0 = model.scene_vec.detach().clone()
    before = gradkernel.LAUNCHES
    losses = []
    losses.append(step(model, opt, 1, target))  # warm-up
    ms = cuda_ms(lambda: losses.append(step(model, opt, len(losses) + 1, target)),
                 calls=TRAIN_CALLS, repeats=TRAIN_REPEATS)
    assert gradkernel.LAUNCHES - before == len(losses), "one K4 launch per step"
    losses = torch.stack(losses).cpu().numpy()
    assert np.isfinite(losses).all(), losses
    assert not torch.equal(model.scene_vec.detach(), vec0), "the step did not move the scene"
    assert np.isfinite(params.pack(unpack(model), camera).cpu().numpy()).all()
    rays = cfg.width * cfg.height * cfg.samples * frames
    med = statistics.median(ms)
    print(f"train step F={frames}: ms={ms} median={med} grad_mrays_per_s={rays / med / 1e3} "
          f"losses {losses[0]} -> {losses[-1]}", flush=True)
    return ms


def run_inverse_render() -> None:
    """Phase 10: the entry point on the card, with and without --packed."""
    for extra in ([], ["--packed"]):
        before = gradkernel.LAUNCHES
        rc = inverse_render.main(["--param", "glow", "--impl", "kernel", "--device", "cuda",
                                  *extra])
        assert rc == 0, f"inverse_render {extra}: glow not recovered"
        assert gradkernel.LAUNCHES - before == 60, "one K4 launch per step"


def run_app() -> None:
    """Phase 5: the batch app at the config's own settings; its PNGs go
    to out/chip_smoke_app/."""
    before = megakernel.LAUNCHES
    out = ROOT / "out" / "chip_smoke_app"
    rc = app.main(["--config", str(APP_CONFIG), "--scene", APP_SCENE,
                   "--frames", "8", "--out", str(out)])
    assert rc == 0
    for view in ("yxz", "ywz", "yxw"):
        assert (out / f"{view}.png").stat().st_size > 0, view
    assert (out / "layout.json").exists()
    assert megakernel.LAUNCHES == before + 2, "one 8-frame launch per view group"


def reset_counts() -> None:
    megakernel.LAUNCHES = megakernel.ROW_LAUNCHES = megakernel.SHARD_LAUNCHES = 0
    gradkernel.LAUNCHES = gradkernel.VJP_LAUNCHES = gradkernel.SOFT_LAUNCHES = 0
    gradkernel.SHARD_LAUNCHES = gradkernel.SHARD_VJP_LAUNCHES = gradkernel.SHARD_SOFT_LAUNCHES = 0


def counts() -> dict:
    """Launches since the last reset_counts, per kernel (K2 = the forward
    kernel's launches over params rows, counted among K1's too)."""
    return {"k1": megakernel.LAUNCHES, "k2_rows": megakernel.ROW_LAUNCHES,
            "k4": gradkernel.LAUNCHES, "k5": gradkernel.VJP_LAUNCHES,
            "k6": gradkernel.SOFT_LAUNCHES}


def image_shape(views, cfg) -> tuple:
    return (cfg.height, cfg.width) if len(views) == 1 else (len(views), cfg.height, cfg.width)


def compare_vec(label: str, kernel, plain, same_pattern: bool = True, nonzero: bool = True):
    """Hold a gradient kernel's output array against its plain version's
    within GRAD_BOUNDS' mixed-scale relative error and, if
    ``same_pattern``, with the same non-zero pattern; unless ``nonzero``
    is False, the plain version must not be all zeros (a block of rows
    the object does not reach may be). Prints the comparison and returns
    (max |kernel - plain|, mixed-scale relative error)."""
    k, p = kernel.detach().cpu().numpy(), plain.detach().cpu().numpy()
    assert k.shape == p.shape, f"{label}: {k.shape} vs {p.shape}"
    assert np.isfinite(k).all() and np.isfinite(p).all(), f"{label}: non-finite values"
    assert not nonzero or np.abs(p).max() > 0, f"{label}: the plain version is all zeros"
    rel, err = mixed_rel(k, p), float(np.abs(k - p).max())
    mismatch = int(((k != 0) != (p != 0)).sum())
    print(f"{label} size={k.size} mixed_rel={rel:.3g} max_abs_err={err:.3g} "
          f"nonzero={int((k != 0).sum())}/{int((p != 0).sum())} pattern_mismatches={mismatch}",
          flush=True)
    assert rel <= GRAD_BOUNDS["grad_mixed_rel"], f"{label}: error {rel}"
    assert not same_pattern or mismatch == 0, f"{label}: non-zero patterns differ"
    return err, rel


def compare_soft(label: str, kernel, plain, block: bool = False):
    """Hold K6's (loss, grad, alpha cotangent) against the plain version's
    within GRAD_BOUNDS. The alpha cotangent's pattern is not required to
    match: it is sum_ch 2 (img - t)(c_with - c_without), which the plain
    version's autograd takes as a difference of two channel sums, so a
    pixel whose two rows differ by an ulp may round to 0 on one side only;
    the mixed-scale bound still holds every pixel. A ``block`` of rows may
    have an alpha cotangent of zeros. Returns (max abs error, max
    mixed-scale relative error)."""
    k_l, p_l = float(kernel[0]), float(plain[0])
    assert np.isfinite(k_l), f"{label}: non-finite loss"
    loss_rel = abs(k_l - p_l) / abs(p_l)
    print(f"K6 {label} loss={k_l} plain={p_l} loss_rel={loss_rel:.3g}", flush=True)
    assert loss_rel <= GRAD_BOUNDS["loss_rtol"], f"{label}: loss"
    e_g, r_g = compare_vec(f"K6 {label} grad", kernel[1], plain[1])
    e_a, r_a = compare_vec(f"K6 {label} alpha_cot", kernel[2], plain[2], same_pattern=False,
                           nonzero=not block)
    return max(abs(k_l - p_l), e_g, e_a), max(r_g, r_a)


def check_light_vjp(device):
    """Phase 11 at 256x144: K5 against its plain version, single and two
    rows, and K2. Returns (max abs error, max mixed-scale relative error)."""
    cfg = RenderConfig(**GRAD_CHECK)
    seed = 0x2468ACE1
    errs = []
    for name in sorted(library.SCENES):
        scene = library.SCENES[name](device)
        pair = (scene, diff.zero_object(scene, SOFT_REFS[name]))
        for views in (("yxz",), cam.VIEWS_ALL):
            label = f"{name} views={len(views)}"
            camera = camera_for(views, device)
            packed, lay = params.pack(scene, camera), params.layout(scene, camera)
            rng = np.random.default_rng(2)
            shape = (*image_shape(views, cfg), 3)
            cot = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(device)
            grad = gradkernel.launch_light_vjp(packed, lay, cfg, seed, cot)
            again = gradkernel.launch_light_vjp(packed, lay, cfg, seed, cot)
            plain = gradkernel.render_light_vjp_plain(packed, scene, camera, cfg, seed, cot)
            torch.cuda.synchronize()
            assert torch.equal(grad, again), f"K5 {label}: launches differ"
            errs.append(compare_vec(f"K5 {label}", grad, plain))
            # K2: the pair's params rows in one launch, row f bitwise K1 of scene f.
            light = megakernel.render_light_cuda_multi(pair, camera, cfg, seed)
            for f, s in enumerate(pair):
                single = megakernel.render_light_cuda(s, camera, cfg, seed)
                assert torch.equal(light[f], single), f"K2 {label}: row {f} != its K1 render"
            rows = params.stack_rows(pair, camera)
            cots = torch.from_numpy(rng.normal(0, 1, (2, *shape)).astype(np.float32)).to(device)
            multi = gradkernel.launch_light_vjp(rows, lay, cfg, seed, cots)
            plain = gradkernel.render_light_vjp_plain(rows, scene, camera, cfg, seed, cots)
            for f in range(len(pair)):
                single = gradkernel.launch_light_vjp(rows[f].contiguous(), lay, cfg, seed,
                                                     cots[f].contiguous())
                assert torch.equal(multi[f], single), f"K5 {label}: row {f} != its single launch"
                errs.append(compare_vec(f"K5 {label} row {f} of 2", multi[f], plain[f]))
            print(f"K2 {label}: rows bitwise single K1 renders; K5 two-row launch bitwise "
                  "single launches", flush=True)
    return max(e for e, _ in errs), max(r for _, r in errs)


def time_light_vjp(device):
    """Phase 11 at the soft fallback's shape (TRAIN): K5 and its plain
    version (whole) on a seeded random cotangent, held against each other
    and timed. Returns a dict of timings, errors and the plain version's
    peak memory."""
    cfg = RenderConfig(**TRAIN)
    scene, camera = library.room_with_sphere(device), camera_for(("yxz",), device)
    packed, lay = params.pack(scene, camera), params.layout(scene, camera)
    cot = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (cfg.height, cfg.width, 3)).astype(np.float32)).to(device)
    kernel = gradkernel.launch_light_vjp(packed, lay, cfg, 1, cot)  # and warm-up
    plain = []
    ms, peak = peak_gb(lambda: cuda_ms(lambda: plain.append(gradkernel.render_light_vjp_plain(
        packed, scene, camera, cfg, 1, cot)), calls=1, repeats=1))
    err, rel = compare_vec("K5 room 1280x720x8spp x4 (plain whole)", kernel, plain[0])
    k5_ms = cuda_ms(lambda: gradkernel.launch_light_vjp(packed, lay, cfg, 1, cot),
                    calls=TRAIN_CALLS, repeats=TRAIN_REPEATS)
    print(f"K5 1280x720: ms={k5_ms} plain_ms={ms[0]} plain_peak_gb={peak:.3f}", flush=True)
    return {"ms": k5_ms, "plain_ms": ms[0], "plain_peak_gb": peak, "err": err, "rel": rel}


def soft_inputs(scene, camera, cfg, ref, edge, target):
    """(packed, layout, zero map, coverage alpha, target) of a K6 launch."""
    alpha = diff.object_coverage(scene, ref, camera, cfg, edge).detach().contiguous()
    return (params.pack(scene, camera), params.layout(scene, camera),
            params.soft_zero_map(scene, camera, ref), alpha, target.contiguous())


def check_soft_kernel(device):
    """Phase 12 at 256x144: K6 against its plain version, and the zeroed
    row's light against the drop_object light. Returns (max abs error, max
    mixed-scale relative error)."""
    cfg = RenderConfig(**GRAD_CHECK)
    seed = 0x13579BDF
    errs = []
    for name, ref in SOFT_REFS.items():
        scene = library.SCENES[name](device)
        for views in (("yxz",), cam.VIEWS_ALL):
            label = f"{name} {ref} views={len(views)}"
            camera = camera_for(views, device)
            target = torch.from_numpy(np.random.default_rng(3).uniform(
                0, 1, (*image_shape(views, cfg), 3)).astype(np.float32)).to(device)
            packed, lay, zero_map, alpha, target = soft_inputs(scene, camera, cfg, ref,
                                                               SOFT_EDGE, target)
            out = gradkernel.launch_soft_loss_grad(packed, lay, cfg, seed, target, alpha, zero_map)
            again = gradkernel.launch_soft_loss_grad(packed, lay, cfg, seed, target, alpha,
                                                     zero_map)
            plain = gradkernel.render_soft_loss_and_grad_plain(packed, scene, camera, cfg, seed,
                                                               target, alpha, zero_map)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(out, again)), f"K6 {label}: launches differ"
            errs.append(compare_soft(label, out, plain))
            zeroed = megakernel.render_light_cuda(diff.zero_object(scene, ref), camera, cfg, seed)
            dropped = megakernel.render_light_cuda(diff.drop_object(scene, ref), camera, cfg, seed)
            assert torch.equal(zeroed, dropped), f"{label}: zeroed light != drop_object light"
    print("zero_object light bitwise drop_object light on every K6 check", flush=True)
    return max(e for e, _ in errs), max(r for _, r in errs)


def time_soft_kernel(device):
    """Phase 12 at the soft main path's shape (TRAIN, the room's sphere 0,
    a zero target): K6 and its plain version in row bands, held against
    each other and timed; then K6 at inverse_render --param position's
    shape against its plain version, with K1's target render. Returns a
    dict of timings, errors and the banded plain version's peak memory."""
    cfg = RenderConfig(**TRAIN)
    scene, camera = library.room_with_sphere(device), camera_for(("yxz",), device)
    ref = SOFT_REFS["room_with_sphere"]
    packed, lay, zero_map, alpha, target = soft_inputs(
        scene, camera, cfg, ref, SOFT_EDGE, torch.zeros((cfg.height, cfg.width, 3), device=device))
    kernel = gradkernel.launch_soft_loss_grad(packed, lay, cfg, 1, target, alpha, zero_map)
    plain = []
    ms, peak = peak_gb(lambda: cuda_ms(lambda: plain.append(
        gradkernel.render_soft_loss_and_grad_plain(packed, scene, camera, cfg, 1, target, alpha,
                                                   zero_map, band_rows=BAND_ROWS)),
        calls=1, repeats=1))
    errs = [compare_soft(f"room 1280x720x8spp x4 (plain in {BAND_ROWS}-row bands)", kernel,
                         plain[0])]
    k6_ms = cuda_ms(lambda: gradkernel.launch_soft_loss_grad(packed, lay, cfg, 1, target, alpha,
                                                             zero_map),
                    calls=TRAIN_CALLS, repeats=TRAIN_REPEATS)
    print(f"K6 1280x720: ms={k6_ms} plain_banded_ms={ms[0]} plain_band_peak_gb={peak:.3f}",
          flush=True)
    args = inverse_render.parse_args(["--param", "position"])
    ir_cfg, ir_camera, ir_target, scene0 = inverse_render.setup(args, device)
    truth = inverse_render.make_scene(inverse_render.TRUE_X, inverse_render.TRUE_GLOW, device)
    label = f"inverse_render position {ir_cfg.width}x{ir_cfg.height}x{ir_cfg.samples}spp"
    light_err = check_close(f"{label} target", megakernel.render_light_cuda(
        truth, ir_camera, ir_cfg, args.seed), renderer.render_light(truth, ir_camera, ir_cfg,
                                                                     args.seed))
    ir_ref = ("spheres", inverse_render.SOFT_SPHERE)
    packed, _, zero_map, alpha, target = soft_inputs(scene0, ir_camera, ir_cfg, ir_ref,
                                                     inverse_render.EDGE_WIDTH, ir_target)
    errs.append(compare_soft(label, gradkernel.render_soft_loss_and_grad_cuda(
        packed, scene0, ir_camera, ir_cfg, args.seed, target, alpha, zero_map),
        gradkernel.render_soft_loss_and_grad_plain(packed, scene0, ir_camera, ir_cfg, args.seed,
                                                   target, alpha, zero_map)))
    return {"ms": k6_ms, "plain_ms": ms[0], "plain_band_peak_gb": peak, "light_err": light_err,
            "err": max(e for e, _ in errs), "rel": max(r for _, r in errs)}


def soft_train(device, ref, calls: int, repeats: int):
    """Phase 13: make_train_step(impl="kernel", soft_object_ref=ref) at
    TRAIN; one warm-up step, then timed steps. Returns (ms per step, the
    trained scene, its optimizer, the target)."""
    cfg = RenderConfig(**TRAIN)
    scene, camera = library.room_with_sphere(device), camera_for(("yxz",), device)
    target = torch.zeros((cfg.height, cfg.width, 3), device=device)
    step, init = diff.make_train_step(cfg, 1e-3, camera, impl="kernel", soft_object_ref=ref,
                                      edge_width=SOFT_EDGE)
    state = list(init(scene))
    start = params.pack(state[0], camera).detach().clone()
    losses = []

    def one():
        state[0], state[1], loss, _ = step(state[0], state[1], len(losses) + 1, target)
        losses.append(loss)

    one()  # warm-up
    ms = cuda_ms(one, calls=calls, repeats=repeats)
    out = torch.stack(losses).cpu().numpy()
    assert np.isfinite(out).all(), out
    vec = params.pack(state[0], camera).detach()
    assert np.isfinite(vec.cpu().numpy()).all() and not torch.equal(vec, start), \
        f"{ref}: the step did not move the scene"
    rays = cfg.width * cfg.height * cfg.samples
    med = statistics.median(ms)
    print(f"soft train step {ref}: ms={ms} median={med} grad_mrays_per_s={rays / med / 1e3} "
          f"losses {out[0]} -> {out[-1]}", flush=True)
    return ms, len(losses), state, target


def soft_step_split(device, state, target):
    """Phase 13: the parts of the sphere soft step alone, at its state:
    K6, the coverage's forward and backward, and Adam. It runs after the
    main path's counts are read: its launches are timing runs. Returns a
    dict of ms lists."""
    cfg = RenderConfig(**TRAIN)
    camera = camera_for(("yxz",), device)
    scene, opt = state
    ref = SOFT_REFS["room_with_sphere"]
    packed, lay, zero_map, alpha, target = soft_inputs(scene, camera, cfg, ref, SOFT_EDGE, target)

    def coverage():
        vec = packed.clone().requires_grad_(True)
        a = diff.object_coverage(params.unpack(vec, scene, camera)[0], ref, camera, cfg,
                                 SOFT_EDGE)
        a.backward(alpha)

    return {
        "k6": cuda_ms(lambda: gradkernel.launch_soft_loss_grad(packed, lay, cfg, 1, target, alpha,
                                                               zero_map),
                      calls=TRAIN_CALLS, repeats=TRAIN_REPEATS),
        "coverage_fwd_bwd": cuda_ms(coverage, calls=TRAIN_CALLS, repeats=TRAIN_REPEATS),
        "adam": cuda_ms(opt.step, calls=TRAIN_CALLS, repeats=TRAIN_REPEATS),
    }


def run_inverse_render_position() -> int:
    """Phase 13: the entry point of the soft path on the card. Returns its
    steps."""
    args = inverse_render.parse_args(["--param", "position"])
    before = gradkernel.SOFT_LAUNCHES
    rc = inverse_render.main(["--param", "position", "--impl", "kernel", "--device", "cuda"])
    assert rc == 0, "inverse_render --param position: x not recovered"
    assert gradkernel.SOFT_LAUNCHES - before == args.steps, "one K6 launch per step"
    return args.steps


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of flops over the
    fp32 peak and bytes over the memory rate, and which of the two."""
    by_ops = flops / PEAKS["fp32_flops_per_s"] * 1e3
    by_bytes = nbytes / PEAKS["bytes_per_s"] * 1e3
    return {"bound_ms": max(by_ops, by_bytes),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def kernel_bounds(device) -> dict:
    """Each kernel's bound at the shape its summary time was taken: K1 at
    the headline 4-frame launch, K4, K5 (one row) and K6 at TRAIN. The
    flops are its plain version's over the first BOUND_ROWS rows (K4, K5
    and K6: forward and autograd backward), counted here and scaled to the
    image's rows; the plain versions are dense, so masked lanes count."""
    scene, camera = library.room_with_sphere(device), camera_for(("yxz",), device)
    packed, lay = params.pack(scene, camera), params.layout(scene, camera)
    p = lay.size
    head, cfg = RenderConfig(**HEADLINE), RenderConfig(**TRAIN)
    rows, scale = (0, BOUND_ROWS), cfg.height / BOUND_ROWS
    pixels = cfg.height * cfg.width
    frames = np.arange(1, FRAMES_PER_LAUNCH + 1, dtype=np.uint32)
    rng = np.random.default_rng(8)
    block = torch.from_numpy(rng.uniform(0, 1, (BOUND_ROWS, cfg.width, 3)).astype(np.float32)
                             ).to(device)
    ref = SOFT_REFS["room_with_sphere"]
    alpha = diff.object_coverage(scene, ref, camera, cfg, SOFT_EDGE).detach()[:BOUND_ROWS]
    zero_map = params.soft_zero_map(scene, camera, ref)
    f1 = count_flops(renderer.render_light, scene, camera, head, frames,
                     slice(0, BOUND_ROWS))[1]
    f4 = count_flops(gradkernel.loss_and_grad_plain, packed, scene, camera, cfg, [1], block,
                     rows=rows)[1]
    f5 = count_flops(gradkernel.render_light_vjp_plain, packed, scene, camera, cfg, 1, block,
                     rows=rows)[1]
    f6 = count_flops(gradkernel.render_soft_loss_and_grad_plain, packed, scene, camera, cfg, 1,
                     block, alpha, zero_map, rows=rows)[1]
    rays = pixels * cfg.samples
    out = {
        "k1": bound(f1 * scale, 4 * (p + FRAMES_PER_LAUNCH + FRAMES_PER_LAUNCH * pixels * 3)),
        "k4": bound(f4 * scale, 4 * (p + 1 + pixels * 3 + p + 1)),
        "k5": bound(f5 * scale, 4 * (p + pixels * 3 + p)),
        "k6": bound(f6 * scale, 4 * (p + pixels * 3 + pixels + p + 1 + pixels)),
    }
    out["k1"]["flops_per_ray"] = f1 * scale / (rays * FRAMES_PER_LAUNCH)
    for k in ("k4", "k5", "k6"):
        out[k]["flops_per_ray"] = out[k]["flops"] / rays
    print(json.dumps({"bounds": out, "peaks": PEAKS}), flush=True)
    return out


def shard_blocks(height: int, n: int) -> list:
    return [pmesh.row_block(height, n, i) for i in range(n)]


def time_shards(label: str, whole_fn, block_fn, height: int) -> dict:
    """CUDA-event milliseconds of the single launch and of each block's
    launch for every split of SHARDS; prints them."""
    res = {"whole_ms": statistics.median(cuda_ms(whole_fn, calls=TRAIN_CALLS,
                                                  repeats=TRAIN_REPEATS))}
    for n in SHARDS:
        res[n] = [statistics.median(cuda_ms(lambda r=r: block_fn(r), calls=TRAIN_CALLS,
                                            repeats=TRAIN_REPEATS))
                  for r in shard_blocks(height, n)]
    print(f"{label} launch ms: whole {res['whole_ms']}, "
          + ", ".join(f"{n} blocks {res[n]} (sum {sum(res[n])})" for n in SHARDS), flush=True)
    return res


def rows_of(x: torch.Tensor, block) -> torch.Tensor:
    """Rows block (row0, n_rows) of an (..., H, W, C) array, contiguous."""
    return x[..., block[0]:block[0] + block[1], :, :].contiguous()


def check_row_shards(device) -> dict:
    """Phase 14: every kernel's row blocks against its single launch, each
    block of PLAIN_SPLIT against its plain version on the same rows, and
    their times. Returns the largest errors of the block sums against the
    single launch (``sum_errs``) and of the blocks against their plain
    versions (``block_errs``), and the times."""
    room = library.room_with_sphere(device)
    ref = SOFT_REFS["room_with_sphere"]
    sum_errs = {"k1": 0.0, "k4": 0.0, "k5": 0.0, "k6": 0.0}
    block_errs = dict(sum_errs)
    ms = {}
    for cfg, views, seeds in ((RenderConfig(**HEADLINE), ("yxz",), [1, 2, 3, 4]),
                              (RenderConfig(**GRAD_CHECK), cam.VIEWS_ALL, [5, 6])):
        camera = camera_for(views, device)
        packed, lay = params.pack(room, camera), params.layout(room, camera)
        words = megakernel.seed_tensor(seeds, device)
        scenes = (room, diff.zero_object(room, ref))
        pair = params.stack_rows(scenes, camera)
        pair_words = megakernel.seed_tensor(seeds[:1] * 2, device)
        whole = megakernel.launch_forward(packed, lay, cfg, words)
        whole2 = megakernel.launch_forward(pair, lay, cfg, pair_words)
        for n in SHARDS:
            blocks = shard_blocks(cfg.height, n)
            cut = [megakernel.launch_forward(packed, lay, cfg, words, b) for b in blocks]
            cut2 = [megakernel.launch_forward(pair, lay, cfg, pair_words, b) for b in blocks]
            torch.cuda.synchronize()
            assert torch.equal(torch.cat(cut, dim=2), whole), f"K1 {n} row blocks != one launch"
            assert torch.equal(torch.cat(cut2, dim=2), whole2), f"K2 {n} row blocks != one launch"
            if n != PLAIN_SPLIT:
                continue
            for b, k1, k2 in zip(blocks, cut, cut2):
                band = slice(b[0], b[0] + b[1])
                label = f"{cfg.width}x{cfg.height} views={len(views)} rows {b}"
                plain = renderer.render_light(room, camera, cfg, np.asarray(seeds, np.uint32), band)
                plain2 = torch.stack([renderer.render_light(s, camera, cfg, seeds[0], band)
                                      for s in scenes])
                block_errs["k1"] = max(block_errs["k1"], check_close(
                    f"K1 block {label}", k1[:, 0] if len(views) == 1 else k1, plain),
                    check_close(f"K2 block {label}", k2[:, 0] if len(views) == 1 else k2, plain2))
        print(f"K1 and K2 {cfg.width}x{cfg.height} views={len(views)} frames={len(seeds)}: "
              f"{' and '.join(map(str, SHARDS))} row blocks bitwise the single launch",
              flush=True)
        if cfg.height == HEADLINE["height"]:
            ms["k1"] = time_shards("K1 4 frames 1280x720", lambda: megakernel.launch_forward(
                packed, lay, cfg, words), lambda b: megakernel.launch_forward(
                packed, lay, cfg, words, b), cfg.height)

    cfg, camera = RenderConfig(**TRAIN), camera_for(("yxz",), device)
    packed, lay = params.pack(room, camera), params.layout(room, camera)
    rng = np.random.default_rng(9)
    target = torch.from_numpy(rng.uniform(0, 1, (cfg.height, cfg.width, 3)).astype(np.float32)
                              ).to(device)
    for frames in TRAIN_FRAMES:
        seeds = list(range(1, frames + 1))
        words = megakernel.seed_tensor(seeds, device)
        whole = gradkernel.launch_loss_grad(packed, lay, cfg, words, target)
        for n in SHARDS:
            blocks = shard_blocks(cfg.height, n)
            parts = [gradkernel.launch_loss_grad(packed, lay, cfg, words, rows_of(target, b), b)
                     for b in blocks]
            summed = (sum(p[0] for p in parts), sum(p[1] for p in parts))
            sum_errs["k4"] = max(sum_errs["k4"], compare_grad(
                f"{n} row blocks summed, 1280x720x8spp x4 F={frames}", summed, whole)[0])
            if n != PLAIN_SPLIT or frames != 1:
                continue
            for b, part in zip(blocks, parts):
                block_errs["k4"] = max(block_errs["k4"], compare_grad(
                    f"block rows {b} of 1280x720x8spp x4 F=1 vs plain (in {BAND_ROWS}-row bands)",
                    part, gradkernel.loss_and_grad_plain(packed, room, camera, cfg, seeds,
                                                         rows_of(target, b), BAND_ROWS, b))[0])
        if frames == 1:
            ms["k4"] = time_shards("K4 1 frame 1280x720", lambda: gradkernel.launch_loss_grad(
                packed, lay, cfg, words, target), lambda b: gradkernel.launch_loss_grad(
                packed, lay, cfg, words, rows_of(target, b), b), cfg.height)

    pair = params.stack_rows((room, diff.zero_object(room, ref)), camera)
    cot = torch.from_numpy(rng.normal(0, 1, (2, cfg.height, cfg.width, 3)).astype(np.float32)
                           ).to(device)
    whole = gradkernel.launch_light_vjp(pair, lay, cfg, 1, cot)
    for n in SHARDS:
        blocks = shard_blocks(cfg.height, n)
        parts = [gradkernel.launch_light_vjp(pair, lay, cfg, 1, rows_of(cot, b), b)
                 for b in blocks]
        sum_errs["k5"] = max(sum_errs["k5"], compare_vec(
            f"K5 two rows, {n} row blocks summed, 1280x720x8spp x4", sum(parts), whole)[0])
        if n == PLAIN_SPLIT:
            for b, part in zip(blocks, parts):
                block_errs["k5"] = max(block_errs["k5"], compare_vec(
                    f"K5 two rows, block rows {b} of 1280x720x8spp x4 vs plain", part,
                    gradkernel.render_light_vjp_plain(pair, room, camera, cfg, 1,
                                                      rows_of(cot, b), b))[0])
    ms["k5"] = time_shards("K5 two rows 1280x720", lambda: gradkernel.launch_light_vjp(
        pair, lay, cfg, 1, cot), lambda b: gradkernel.launch_light_vjp(
        pair, lay, cfg, 1, rows_of(cot, b), b), cfg.height)

    packed, lay, zero_map, alpha, target = soft_inputs(room, camera, cfg, ref, SOFT_EDGE, target)

    def alpha_of(b):
        return alpha[b[0]:b[0] + b[1]].contiguous()

    def k6_block(b):
        return gradkernel.launch_soft_loss_grad(packed, lay, cfg, 1, rows_of(target, b),
                                                alpha_of(b), zero_map, b)

    whole = gradkernel.launch_soft_loss_grad(packed, lay, cfg, 1, target, alpha, zero_map)
    for n in SHARDS:
        blocks = shard_blocks(cfg.height, n)
        parts = [k6_block(b) for b in blocks]
        alpha_cot = torch.cat([p[2] for p in parts])
        assert torch.equal(alpha_cot, whole[2]), f"K6 {n} blocks: alpha cotangent not bitwise"
        summed = (sum(p[0] for p in parts), sum(p[1] for p in parts), alpha_cot)
        sum_errs["k6"] = max(sum_errs["k6"], compare_soft(
            f"{n} row blocks summed, 1280x720x8spp x4 (alpha cotangent bitwise)", summed,
            whole)[0])
        if n == PLAIN_SPLIT:
            for b, part in zip(blocks, parts):
                block_errs["k6"] = max(block_errs["k6"], compare_soft(
                    f"block rows {b} of 1280x720x8spp x4 vs plain (in {BAND_ROWS}-row bands)",
                    part, gradkernel.render_soft_loss_and_grad_plain(
                        packed, room, camera, cfg, 1, rows_of(target, b), alpha_of(b), zero_map,
                        BAND_ROWS, b), block=True)[0])
    ms["k6"] = time_shards("K6 1280x720", lambda: gradkernel.launch_soft_loss_grad(
        packed, lay, cfg, 1, target, alpha, zero_map), k6_block, cfg.height)
    return {"sum_errs": sum_errs, "block_errs": block_errs, "ms": ms}


def run_distributed(card: str) -> dict:
    """Phase 15: multihost_run on RANKS ranks at TRAIN, 3 steps, against
    the single process; checks the launches of every rank. Returns the
    runner's summary."""
    backend = "nccl" if torch.cuda.device_count() >= RANKS else "gloo"
    work = multihost_run.Work(width=TRAIN["width"], height=TRAIN["height"],
                              samples=TRAIN["samples"], bounces=TRAIN["reflections_amount"],
                              light_coefficient=TRAIN["light_coefficient"], steps=3,
                              soft_ref=SOFT_REFS["room_with_sphere"], edge_width=SOFT_EDGE)
    items = (*multihost_run.DEFAULT_ITEMS, "inverse_render")
    t0 = time.perf_counter()
    summary = multihost_run.run(RANKS, backend, "cuda", work, items, timeout=600)
    print(json.dumps({"phase": 15, "card": card, "wall_s": time.perf_counter() - t0,
                      "note": ("both ranks share one card: no scaling figure"
                               if backend == "gloo" else "one card per rank"),
                      **{k: v for k, v in summary.items() if k != "work"}}), flush=True)
    assert summary["ok"], summary["items"]
    steps = work.steps
    for rank, launches in enumerate(summary["launches_per_rank"]):
        expect = {"image": {"k1": 1, "k1_shard": 1},
                  "kernel_hard": {"k4": steps, "k4_shard": steps},
                  "kernel_soft": {"k6": steps, "k6_shard": steps},
                  "pair": {"k1": 1, "k1_shard": 1, "k2": 1, "k5": 1, "k5_shard": 1}}
        for item, want in expect.items():
            assert launches[item] == want, (rank, item, launches[item], want)
        ir = launches["inverse_render"]
        assert ir.get("k4") == ir.get("k4_shard") == 60 and ir.get("k1") == 1, (rank, ir)
    print(f"phase 15 backend={backend}: every rank made one K4 (K6) launch per step on its "
          f"rows; step ms per rank {summary['step_ms_per_rank']}, single process "
          f"{summary['single_step_ms']}", flush=True)
    return summary


def main() -> int:
    phase("1 device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = smi_line()
    print(f"device={name} count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda} nvidia-smi: {card}", flush=True)

    phase("2 build")
    t0 = time.perf_counter()
    lib_path = build.build()
    build_s = time.perf_counter() - t0
    build.load()
    print(f"built {lib_path.relative_to(ROOT)} in {build_s:.2f} s", flush=True)
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print("  " + line.strip(), flush=True)

    phase("3 kernel vs plain on the card")
    max_err = check_kernel_against_plain(device)

    phase("4 main path: RenderEngine -> kernel, headline shape")
    reset_counts()
    engine, engine_ms = main_path(device)
    phase("5 app")
    run_app()
    launches = {"render": (megakernel.LAUNCHES, gradkernel.LAUNCHES)}
    assert launches["render"] == (1 + CALLS * REPEATS + 2, 0), launches
    assert counts()["k2_rows"] == counts()["k5"] == counts()["k6"] == 0, counts()

    phase("6 kernel alone and plain pipeline, headline shape")
    kernel_ms, plain_ms, headline_err = time_kernel_and_plain(engine)
    phase("7 app view groups: kernel vs plain on the card")
    max_err = max(max_err, headline_err, check_app_groups(device))
    rays = HEADLINE["width"] * HEADLINE["height"] * HEADLINE["samples"] * FRAMES_PER_LAUNCH
    med_engine, med_kernel = statistics.median(engine_ms), statistics.median(kernel_ms)
    print(json.dumps({
        "cell": "room_with_sphere 1280x720 8spp 4 bounces per_sample, 4 frames per launch",
        "card": card, "rays_per_launch": rays,
        "engine_step_frames_ms": engine_ms, "engine_ms_median": med_engine,
        "engine_mrays_per_s": rays / med_engine / 1e3,
        "kernel_ms": kernel_ms, "kernel_ms_median": med_kernel,
        "kernel_mrays_per_s": rays / med_kernel / 1e3,
        "plain_ms": plain_ms, "plain_mrays_per_s": rays / plain_ms / 1e3,
    }), flush=True)

    phase("8 value-and-grad kernel vs plain on the card")
    grad_err, grad_rel = check_grad_kernel(device)
    k4 = time_grad_kernel(device)
    light_err, ir_err, ir_rel = check_inverse_render_shapes(device)
    max_err = max(max_err, light_err)
    grad_err, grad_rel = max(grad_err, k4["err"], ir_err), max(grad_rel, k4["rel"], ir_rel)

    phase("9 training main path: packed Adam step -> K4, 1280x720")
    reset_counts()
    train_ms = {f: train_main_path(device, f) for f in TRAIN_FRAMES}
    phase("10 inverse_render --impl kernel")
    run_inverse_render()
    launches["train"] = (megakernel.LAUNCHES, gradkernel.LAUNCHES)
    n_steps = (1 + TRAIN_CALLS * TRAIN_REPEATS) * len(TRAIN_FRAMES)
    assert launches["train"] == (2, n_steps + 2 * 60), launches
    assert counts()["k2_rows"] == counts()["k5"] == counts()["k6"] == 0, counts()
    train_rays = TRAIN["width"] * TRAIN["height"] * TRAIN["samples"]
    small_rays = TRAIN_SMALL["width"] * TRAIN_SMALL["height"] * TRAIN_SMALL["samples"]
    med_small, med_plain = statistics.median(k4["k4_small_ms"]), statistics.median(k4["plain_small_ms"])
    k4_full_med = {f: statistics.median(k4["k4_full_ms"][f]) for f in TRAIN_FRAMES}
    print(json.dumps({
        "cell": "room_with_sphere 1280x720 8spp 4 bounces, packed Adam train step",
        "card": card,
        "train_step_ms": {str(f): train_ms[f] for f in TRAIN_FRAMES},
        "train_step_ms_median": {str(f): statistics.median(train_ms[f]) for f in TRAIN_FRAMES},
        "train_grad_mrays_per_s": {str(f): train_rays * f / statistics.median(train_ms[f]) / 1e3
                                   for f in TRAIN_FRAMES},
        "k4_ms_1280x720": {str(f): k4["k4_full_ms"][f] for f in TRAIN_FRAMES},
        "k4_ms_1280x720_median": {str(f): k4_full_med[f] for f in TRAIN_FRAMES},
        "plain_banded_ms_1280x720": {str(f): k4["plain_full_ms"][f] for f in TRAIN_FRAMES},
        "plain_band_peak_gb_1280x720": k4["plain_band_peak_gb"][1],
        "k4_ms_256x144": k4["k4_small_ms"], "k4_ms_256x144_median": med_small,
        "k4_grad_mrays_per_s_256x144": small_rays / med_small / 1e3,
        "plain_autograd_ms_256x144": k4["plain_small_ms"],
        "plain_autograd_ms_256x144_median": med_plain,
        "plain_grad_mrays_per_s_256x144": small_rays / med_plain / 1e3,
        "plain_peak_gb_256x144": k4["plain_small_peak_gb"],
    }), flush=True)

    phase("11 light-VJP kernel K5 and rows kernel K2 vs plain on the card")
    vjp_err, vjp_rel = check_light_vjp(device)
    k5 = time_light_vjp(device)
    vjp_err, vjp_rel = max(vjp_err, k5["err"]), max(vjp_rel, k5["rel"])
    phase("12 soft value-and-grad kernel K6 vs plain on the card")
    soft_err, soft_rel = check_soft_kernel(device)
    k6 = time_soft_kernel(device)
    max_err = max(max_err, k6["light_err"])
    soft_err, soft_rel = max(soft_err, k6["err"]), max(soft_rel, k6["rel"])

    phase("13 soft training main path: make_train_step(soft) -> K6, 1280x720")
    reset_counts()
    soft_ms, n_soft, soft_state, soft_target = soft_train(
        device, SOFT_REFS["room_with_sphere"], TRAIN_CALLS, TRAIN_REPEATS)
    fallback_ms, n_fallback, _, _ = soft_train(device, FALLBACK_REF, TRAIN_CALLS, 1)
    n_ir = run_inverse_render_position()
    launches["soft"] = counts()
    expect = {"k1": 2 * n_fallback + 1, "k2_rows": 0, "k4": 0, "k5": 2 * n_fallback,
              "k6": n_soft + n_ir}
    assert launches["soft"] == expect, (launches["soft"], expect)
    split = soft_step_split(device, soft_state, soft_target)
    soft_med = statistics.median(soft_ms)
    split_med = {k: statistics.median(v) for k, v in split.items()}
    print(json.dumps({
        "cell": "room_with_sphere 1280x720 8spp 4 bounces, soft train step, sphere 0, zero "
                "target, edge width 0.05, lr 1e-3, no hints",
        "card": card,
        "soft_step_ms": soft_ms, "soft_step_ms_median": soft_med,
        "soft_grad_mrays_per_s": train_rays / soft_med / 1e3,
        "split_ms": split, "split_ms_median": split_med,
        "split_rest_ms": soft_med - sum(split_med.values()),
        "fallback_spaces0_step_ms": fallback_ms,
        "fallback_step_ms_median": statistics.median(fallback_ms),
        "k6_ms_1280x720": k6["ms"], "k6_ms_1280x720_median": statistics.median(k6["ms"]),
        "k6_plain_banded_ms_1280x720": k6["plain_ms"],
        "k6_plain_band_peak_gb": k6["plain_band_peak_gb"],
        "k5_ms_1280x720": k5["ms"], "k5_ms_1280x720_median": statistics.median(k5["ms"]),
        "k5_plain_ms_1280x720": k5["plain_ms"], "k5_plain_peak_gb": k5["plain_peak_gb"],
        "launches": launches["soft"],
    }), flush=True)

    phase("14 row-sharded launches (K3) on one card")
    shards = check_row_shards(device)
    bounds = kernel_bounds(device)

    phase("15 distributed main path: multihost_run, 2 ranks")
    reset_counts()
    dist_summary = run_distributed(card)
    ranks = dist_summary["launches_per_rank"]
    launches["sharded"] = {key: sum(item.get(key, 0) for rank in ranks for item in rank.values())
                           for key in ("k1", "k1_shard", "k2", "k4", "k4_shard", "k5", "k5_shard",
                                       "k6", "k6_shard")}
    print(json.dumps({"sharded_path_launches_all_ranks": launches["sharded"]}), flush=True)
    sharded = launches["sharded"]
    no_library = {"library_ms": None,
                  "library_note": "no single PyTorch call computes a path trace or its adjoint"}

    summary = {"kernels": [{
        "name": "forward_megakernel",
        "route": "cuda",
        "source": "fourd_ray_tracing_tpu_torch/csrc/megakernel.cu",
        "replaces": "fourd_ray_tracing_tpu/ops/pallas/megakernel.py:316",
        "launches": (launches["render"][0] + launches["train"][0] + launches["soft"]["k1"]
                     + sharded["k1"]),
        "launches_by_path": {"render": launches["render"][0], "train": launches["train"][0],
                             "soft": launches["soft"]["k1"], "sharded": sharded["k1"]},
        # K2 is this kernel over (F, P) params rows (render_light_pair): the
        # sharded path's soft pair renders rows; phases 11 and 14 hold them
        # bitwise single renders. K3 is this kernel on a block of rows.
        "rows_launches": launches["soft"]["k2_rows"] + sharded["k2"],
        "sharded_launches": sharded["k1_shard"],
        "shard_max_abs_err": shards["block_errs"]["k1"],
        "shard_sum_max_abs_err": shards["sum_errs"]["k1"],
        "shard_ms": shards["ms"]["k1"],
        "max_abs_err": max_err,
        "tolerance": CHECK_BOUNDS,
        "ms": med_kernel,
        "plain_ms": plain_ms,
        **bounds["k1"], **no_library,
        "shape": "room_with_sphere 1280x720 8spp 4 bounces, 4 frames per launch",
        "build_s": build_s,
    }, {
        "name": "loss_grad_kernel",
        "route": "cuda",
        "source": "fourd_ray_tracing_tpu_torch/csrc/gradkernel.cu",
        "replaces": "fourd_ray_tracing_tpu/ops/pallas/gradkernel.py:117",
        "launches": launches["train"][1] + sharded["k4"],
        "launches_by_path": {"render": launches["render"][1], "train": launches["train"][1],
                             "sharded": sharded["k4"]},
        "sharded_launches": sharded["k4_shard"],
        "shard_max_abs_err": shards["block_errs"]["k4"],
        "shard_sum_max_abs_err": shards["sum_errs"]["k4"],
        "shard_ms": shards["ms"]["k4"],
        "max_abs_err": grad_err,
        "max_grad_mixed_rel_err": grad_rel,
        "tolerance": GRAD_BOUNDS,
        "ms": k4_full_med[1],
        "plain_ms": k4["plain_full_ms"][1],
        **bounds["k4"], **no_library,
        "shape": "room_with_sphere 1280x720 8spp 4 bounces, 1 frame, zero target "
                 f"(plain version in {BAND_ROWS}-row bands)",
        "ms_4_frames": k4_full_med[4],
        "plain_ms_4_frames": k4["plain_full_ms"][4],
        "ms_256x144": med_small,
        "plain_ms_256x144": med_plain,
        "build_s": build_s,
    }, {
        "name": "light_vjp_kernel",
        "route": "cuda",
        "source": "fourd_ray_tracing_tpu_torch/csrc/gradkernel.cu",
        "replaces": "fourd_ray_tracing_tpu/ops/pallas/gradkernel.py:294",
        "launches": launches["soft"]["k5"] + sharded["k5"],
        "launches_by_path": {"soft": launches["soft"]["k5"], "sharded": sharded["k5"]},
        "sharded_launches": sharded["k5_shard"],
        "shard_max_abs_err": shards["block_errs"]["k5"],
        "shard_sum_max_abs_err": shards["sum_errs"]["k5"],
        "shard_ms": shards["ms"]["k5"],
        "max_abs_err": vjp_err,
        "max_grad_mixed_rel_err": vjp_rel,
        "tolerance": GRAD_BOUNDS,
        "ms": statistics.median(k5["ms"]),
        "plain_ms": k5["plain_ms"],
        **bounds["k5"], **no_library,
        "shape": "room_with_sphere 1280x720 8spp 4 bounces, 1 row, seeded random cotangent "
                 "(plain version whole)",
        "build_s": build_s,
    }, {
        "name": "soft_loss_grad_kernel",
        "route": "cuda",
        "source": "fourd_ray_tracing_tpu_torch/csrc/softkernel.cu",
        "replaces": "fourd_ray_tracing_tpu/ops/pallas/gradkernel.py:1207",
        "launches": launches["soft"]["k6"] + sharded["k6"],
        "launches_by_path": {"soft": launches["soft"]["k6"], "sharded": sharded["k6"]},
        "sharded_launches": sharded["k6_shard"],
        "shard_max_abs_err": shards["block_errs"]["k6"],
        "shard_sum_max_abs_err": shards["sum_errs"]["k6"],
        "shard_ms": shards["ms"]["k6"],
        "max_abs_err": soft_err,
        "max_grad_mixed_rel_err": soft_rel,
        "tolerance": GRAD_BOUNDS,
        "ms": statistics.median(k6["ms"]),
        "plain_ms": k6["plain_ms"],
        **bounds["k6"], **no_library,
        "shape": "room_with_sphere 1280x720 8spp 4 bounces, sphere 0, zero target, edge "
                 f"width 0.05 (plain version in {BAND_ROWS}-row bands)",
        "build_s": build_s,
    }]}
    print(json.dumps(summary), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
