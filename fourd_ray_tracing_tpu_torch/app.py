"""Batch renderer: properties file -> engine -> frames -> one PNG per window.

Counterpart of the batch mode of fourd_ray_tracing_tpu/app.py (build_engine,
window_layout, save_windows, main). The main window renders at
window.main cells and, with show_additional_windows, the YWZ/YXW sections
at window.additional cells as a second view group. ``--frames`` frames
render in one launch per view group (RenderEngine.step_frames), then each
window is written as a PNG next to ``layout.json``.

The interactive session, the live preview server, precompilation and
checkpoints are not ported yet (ROADMAP queue 1, items 7 and 13); their
flags are rejected.
"""
from __future__ import annotations

import argparse
import json
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from fourd_ray_tracing_tpu_torch import camera as cam
from fourd_ray_tracing_tpu_torch.engine import RenderEngine
from fourd_ray_tracing_tpu_torch.models.library import scene_by_name
from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4
from fourd_ray_tracing_tpu_torch.utils.config import AppConfig
from fourd_ray_tracing_tpu_torch.utils.image import write_png
from fourd_ray_tracing_tpu_torch.utils.profiling import Meter

NOT_PORTED_FLAGS = ("--interactive", "--serve", "--serve-fps", "--precompile",
                    "--no-precompile", "--load-state", "--save-state", "--fps-overlay")


def build_engine(app: AppConfig, device, deterministic: bool = False,
                 impl: str = "cuda") -> RenderEngine:
    """Engine from an AppConfig, rendering per-sample RNG streams."""
    scene = scene_by_name(app.scene, device)

    def window_cfg(w):
        return RenderConfig(
            width=w.cells_width,
            height=w.cells_height,
            samples=app.samples,
            reflections_amount=app.reflections_amount,
            small_indent=app.small_indent,
            light_coefficient=app.light_to_color_conversion_coefficient,
            rng_mode="per_sample",
        )

    additional = None
    if app.show_additional_windows:
        additional = (window_cfg(app.additional_window), ("ywz", "yxw"))
    c = app.camera
    psi_constraint = None
    if app.controls.constrain_psi_range:
        psi_constraint = (float(np.radians(c.psi_deg)),
                          float(np.radians(app.controls.psi_range_radius_deg)))
    return RenderEngine(
        scene,
        window_cfg(app.main_window),
        focus=Vec4.of(c.x, c.y, c.z, c.w, device=device),
        angles=cam.CameraAngles.of(
            np.float32(np.radians(c.fi_deg)), np.float32(np.radians(c.te_deg)),
            np.float32(np.radians(c.psi_deg)), device=device,
        ),
        device=device,
        focus_to_matrix_distance=c.focus_to_matrix_distance,
        matrix_height=c.matrix_height,
        views=("yxz",),
        psi_constraint=psi_constraint,
        deterministic=deterministic,
        impl=impl,
        additional=additional,
    )


def window_layout(app: AppConfig) -> dict:
    """Window placement on the (virtual) desktop; scaling moves windows,
    never the render resolution (fourd_ray_tracing_tpu/app.py:125-160)."""
    scr = app.screen
    sw, sh = scr.width, scr.usable_height
    main = app.main_window
    if not app.show_additional_windows:
        mult = min(1.0, sh / main.height, sw / main.width)
        w, h = int(main.width * mult), int(main.height * mult)
        return {"multiplier": mult, "yxz": {"pos": [(sw - w) // 2, (sh - h) // 2], "size": [w, h]}}
    add = app.additional_window
    mult = min(1.0, sh / (main.height + add.height), sw / 2 / add.width, sw / main.width)
    mw, mh = int(main.width * mult), int(main.height * mult)
    aw, ah = int(add.width * mult), int(add.height * mult)
    indent_x = (sw - aw * 2) // 3
    indent_y = (sh - mh - ah) // 3
    add_y = mh + scr.window_title_height + indent_y * 2
    return {
        "multiplier": mult,
        "yxz": {"pos": [(sw - mw) // 2, indent_y], "size": [mw, mh]},
        "ywz": {"pos": [indent_x, add_y], "size": [aw, ah]},
        "yxw": {"pos": [aw + indent_x * 2, add_y], "size": [aw, ah]},
    }


def save_windows(engine: RenderEngine, out_dir: Path, upscale: dict | None = None) -> list:
    """One PNG per view window; ``upscale`` {view: cell_size} replicates
    each pixel like the reference's sprite blit."""
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for view, img in engine.windows():
        s = (upscale or {}).get(view, 1)
        if s > 1:
            img = np.repeat(np.repeat(img, s, axis=0), s, axis=1)
        p = out_dir / f"{view}.png"
        write_png(p, img)
        paths.append(p)
    return paths


def resolve_device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (use --device cpu "
                           "for the plain torch pipeline)")
    return torch.device(name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="configs/properties.txt")
    ap.add_argument("--scene", default=None, help="override the config's scene key")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--out", default="out")
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--upscale", action="store_true",
                    help="scale PNGs by each window's cell_size")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    argv = sys.argv[1:] if argv is None else list(argv)
    for flag in NOT_PORTED_FLAGS:
        if any(a == flag or a.startswith(flag + "=") for a in argv):
            ap.error(f"{flag} is not ported yet (ROADMAP queue 1, items 7 and 13); "
                     "this port renders in batch mode only")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    app = AppConfig.load(args.config)
    if args.scene:
        app = replace(app, scene=args.scene)
    engine = build_engine(app, device, deterministic=args.deterministic)
    res = [f"{g.cfg.width}x{g.cfg.height}:{','.join(g.views)}" for g in engine.groups]
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"scene={app.scene} windows={res} spp={engine.cfg.samples} "
          f"bounces={engine.cfg.reflections_amount} device={name}", flush=True)

    meter = Meter()
    with meter.measure(engine.rays_per_frame() * args.frames, frames=args.frames) as h:
        h["result"] = engine.step_frames(args.frames)
    stats = meter.stats
    print(json.dumps({"frames": stats.frames, "seconds": stats.seconds,
                      "rays_per_s": stats.rays_per_s if stats.seconds > 0 else None}), flush=True)

    out_dir = Path(args.out)
    upscale = None
    if args.upscale:
        upscale = {"yxz": app.main_window.cell_size,
                   "ywz": app.additional_window.cell_size,
                   "yxw": app.additional_window.cell_size}
    for p in save_windows(engine, out_dir, upscale=upscale):
        print(f"wrote {p}", flush=True)
    (out_dir / "layout.json").write_text(json.dumps(window_layout(app), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
