#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
card and the CUDA toolkit's nvcc, and exits non-zero (printing no result)
on any failure, or when no CUDA device is available. Phases:

1. device: the card's name and power limit;
2. build: the forward kernel from fourd_ray_tracing_tpu_torch/csrc;
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
   (1 view at 121x75, 2 views at 60x37), with the app's own cameras.

Every kernel-vs-plain check holds the two within the image bounds of
``CHECK_BOUNDS`` and reports whether they are bitwise equal.

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
from fourd_ray_tracing_tpu_torch.engine import RenderEngine  # noqa: E402
from fourd_ray_tracing_tpu_torch.models import library, params, renderer  # noqa: E402
from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig  # noqa: E402
from fourd_ray_tracing_tpu_torch.ops.cuda import build  # noqa: E402
from fourd_ray_tracing_tpu_torch.ops.cuda import megakernel  # noqa: E402
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4  # noqa: E402
from fourd_ray_tracing_tpu_torch.utils.config import AppConfig  # noqa: E402

# All but boundary_frac of pixels within atol, image-wide mean |diff|
# under mean_atol: visibility-boundary pixels may flip on ulp noise.
CHECK_BOUNDS = dict(atol=1e-5, boundary_frac=0.01, mean_atol=0.005)
APP_CONFIG, APP_SCENE = ROOT / "configs" / "properties.txt", "room_with_sphere"
HEADLINE = dict(width=1280, height=720, samples=8, reflections_amount=4, rng_mode="per_sample")
FRAMES_PER_LAUNCH = 4
CALLS, REPEATS = 5, 5  # timed: REPEATS runs of CALLS back-to-back calls


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
    megakernel.LAUNCHES = 0
    engine, engine_ms = main_path(device)
    phase("5 app")
    run_app()
    launches = megakernel.LAUNCHES
    assert launches == 1 + CALLS * REPEATS + 2, launches

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

    summary = {"kernels": [{
        "name": "forward_megakernel",
        "route": "cuda",
        "source": "fourd_ray_tracing_tpu_torch/csrc/megakernel.cu",
        "replaces": "fourd_ray_tracing_tpu/ops/pallas/megakernel.py:316",
        "launches": launches,
        "max_abs_err": max_err,
        "tolerance": CHECK_BOUNDS,
        "ms": med_kernel,
        "plain_ms": plain_ms,
        "shape": "room_with_sphere 1280x720 8spp 4 bounces, 4 frames per launch",
        "build_s": build_s,
    }]}
    print(json.dumps(summary), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
