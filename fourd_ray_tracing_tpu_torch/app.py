"""Application driver: config -> engine -> frames -> PNG windows, or a live session.

Counterpart of fourd_ray_tracing_tpu/app.py. It loads a properties file,
builds the scene, the camera and its controls, steps the progressive
accumulation and presents the frames as PNG files, one per window: the
main YXZ section and, with show_additional_windows, the YWZ/YXW sections.
The main window renders at window.main cells (850/7 -> 121x75 by
default), the additional windows at window.additional cells (600/10 ->
60x37), batched into one launch. ``--upscale`` scales each PNG by its
window's cell_size.

Batch mode renders ``--frames`` frames in one launch per view group and
writes the windows next to ``layout.json``. ``--interactive`` reads
commands from stdin (the headless stand-in for mouse capture and WASD),
and with ``--serve PORT`` also from the preview page (utils/viewer.py):

    capture / escape                capture or release the cursor; frames,
                                    moves and mouse-look run only captured
    w/s/a/d/space/c/e/q [seconds]   move (default 0.25 s)
    mouse <dx> <dy>                 mouse-look, PIXEL deltas (dy = up);
                                    scaled by mouse_sensitivity, offsets
                                    beyond the border only recenter
    wheel <delta>                   wheel clicks -> psi x wheel_sensitivity
    look <dfi> <dte> [dpsi]         rotate (raw radians)
    frames <n>                      render n frames (accumulating)
    save [path]                     write current windows to PNG
    stats                           print rays/s + fps counters
    quit

``--precompile`` (on by default in a live session) builds and launches
every kernel instance before the first frame; ``--save-state`` and
``--load-state`` checkpoint the engine (utils/checkpoint.py);
``--fps-overlay`` burns the FPS counter into the main window. Under
torch.distributed only rank 0 serves and writes files.
"""
from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time
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
from fourd_ray_tracing_tpu_torch.utils.image import to_uint8, write_png
from fourd_ray_tracing_tpu_torch.utils.logging import is_rank0, log0
from fourd_ray_tracing_tpu_torch.utils.overlay import draw_fps
from fourd_ray_tracing_tpu_torch.utils.profiling import Meter
from fourd_ray_tracing_tpu_torch.utils.viewer import PreviewServer

KEYMAP = {
    "w": cam.MoveKeys(forward=True),
    "s": cam.MoveKeys(back=True),
    "a": cam.MoveKeys(left=True),
    "d": cam.MoveKeys(right=True),
    "space": cam.MoveKeys(top=True),
    "c": cam.MoveKeys(down=True),
    "e": cam.MoveKeys(w_pos=True),
    "q": cam.MoveKeys(w_neg=True),
}


def build_engine(app: AppConfig, device, deterministic: bool = False,
                 impl: str = "cuda") -> RenderEngine:
    """Engine from an AppConfig, rendering per-sample RNG streams, with
    the config's controls: movement speed, mouse and wheel sensitivity,
    and max_mouse_offset = max(min(half width, half height) -
    mouse_border_width, 50) over the main window's pixel size."""
    scene = scene_by_name(app.scene, device)
    win = app.main_window

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
    half_w = win.cells_width * win.cell_size // 2
    half_h = win.cells_height * win.cell_size // 2
    max_mouse_offset = max(min(half_w, half_h) - app.controls.mouse_border_width, 50)
    return RenderEngine(
        scene,
        window_cfg(win),
        focus=Vec4.of(c.x, c.y, c.z, c.w, device=device),
        angles=cam.CameraAngles.of(
            np.float32(np.radians(c.fi_deg)), np.float32(np.radians(c.te_deg)),
            np.float32(np.radians(c.psi_deg)), device=device,
        ),
        device=device,
        focus_to_matrix_distance=c.focus_to_matrix_distance,
        matrix_height=c.matrix_height,
        views=("yxz",),
        movement_speed=app.controls.movement_speed,
        psi_constraint=psi_constraint,
        deterministic=deterministic,
        impl=impl,
        additional=additional,
        mouse_sensitivity=app.controls.mouse_sensitivity,
        wheel_sensitivity=app.controls.wheel_sensitivity,
        max_mouse_offset=max_mouse_offset,
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


def present(img: np.ndarray, view: str, upscale: dict | None, fps: float | None,
            text_size: int) -> np.ndarray:
    """A window's image as shown: the FPS overlay burned in when ``fps``
    is given, then each pixel replicated by the view's cell size in
    ``upscale`` (the reference's sprite blit)."""
    if fps is not None:
        img = draw_fps(img, fps, text_size)
    s = (upscale or {}).get(view, 1)
    if s > 1:
        img = np.repeat(np.repeat(img, s, axis=0), s, axis=1)
    return img


def save_windows(engine: RenderEngine, out_dir: Path, tag: str = "", upscale: dict | None = None,
                 fps: float | None = None, text_size: int = 24) -> list:
    """One PNG per view window, ``<view><tag>.png``; ``fps`` burns the
    FPS overlay into the main window only. Rank 0 only: ranks writing the
    same files would race."""
    if not is_rank0():
        return []
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for k, (view, img) in enumerate(engine.windows()):
        p = out_dir / f"{view}{tag}.png"
        write_png(p, present(img, view, upscale, fps if k == 0 else None, text_size))
        paths.append(p)
    return paths


def run_frames(engine: RenderEngine, meter: Meter, n: int, quiet: bool = False,
               min_frame_seconds: float = 0.0, after_step=None) -> None:
    """Step n frames. ``min_frame_seconds`` paces the loop frame by frame
    like the reference's framerate cap (max_fps); unpaced, all n frames
    render in one launch per view group (engine.step_frames, bitwise n
    single steps). ``after_step()`` runs after each step (the preview's
    snapshot)."""
    if n > 1 and min_frame_seconds <= 0.0:
        with meter.measure(engine.rays_per_frame() * n, frames=n) as h:
            h["result"] = engine.step_frames(n)
        if after_step is not None:
            after_step()
    else:
        for _ in range(n):
            t0 = time.perf_counter()
            with meter.measure(engine.rays_per_frame()) as h:
                h["result"] = engine.step_frame()
            if after_step is not None:
                after_step()
            leftover = min_frame_seconds - (time.perf_counter() - t0)
            if leftover > 0:
                time.sleep(leftover)
    if not quiet:
        log0(meter.stats.as_json(), flush=True)


class CaptureState:
    """Mouse-capture state machine, headless:

    * the app starts uncaptured; rendering, movement and mouse-look run
      only while the cursor is captured, as the reference's frame loop;
    * ``capture`` captures and arms ``fps_suppress``, so the FPS overlay
      skips the first rendered frame after capture (its frame timer just
      restarted);
    * ``escape`` releases;
    * the wheel rotates psi and resets the accumulation even uncaptured,
      but nothing renders until capture.
    """

    def __init__(self):
        self.captured = False
        self.fps_suppress = False

    def capture(self):
        if not self.captured:
            self.fps_suppress = True
        self.captured = True

    def release(self):
        self.captured = False

    def frame_rendered(self):
        """The first rendered frame after capture ends the suppression."""
        self.fps_suppress = False


class Snapshot:
    """What the preview serves: a copy of each view group's accumulation,
    which the render loop publishes after each step under a lock. A group
    step blends its frames into the buffer one by one, in place, so a
    server thread reading the live buffer could catch it between two
    blends; it reads the last published copy instead."""

    def __init__(self, engine: RenderEngine):
        self._engine = engine
        self._lock = threading.Lock()
        self.publish()

    def publish(self) -> None:
        frames = [g.accum.detach().clone() for g in self._engine.groups]
        with self._lock:
            self._frames = frames

    def group(self, k: int) -> np.ndarray:
        """Group k's last published accumulation, on the host."""
        with self._lock:
            frame = self._frames[k]
        return frame.cpu().numpy()


def make_preview(engine: RenderEngine, upscale: dict | None = None,
                 cap: CaptureState | None = None, meter: Meter | None = None,
                 port: int = 0, fps: float = 10.0, text_size: int = 24, on_command=None,
                 snapshot: Snapshot | None = None):
    """Live HTTP preview of every window (utils/viewer.PreviewServer) at
    127.0.0.1:``port`` (0: any free port), or None off rank 0. Each
    request reads ``snapshot`` (one taken now when none is given; the
    render loop publishes it) and presents it as the PNG path does: the
    capture-gated FPS overlay on the main window, then the upscale."""
    if not is_rank0():
        return None
    snapshot = snapshot or Snapshot(engine)
    views = [v for g in engine.groups for v in g.views]

    def get_frame(view: str) -> np.ndarray:
        k = next(k for k, g in enumerate(engine.groups) if view in g.views)
        acc = snapshot.group(k)
        g = engine.groups[k]
        img = acc if acc.ndim == 3 else acc[g.views.index(view)]
        shown = None
        if (view == views[0] and cap is not None and meter is not None and cap.captured
                and not cap.fps_suppress and meter.stats.seconds > 0):
            shown = meter.stats.frames / meter.stats.seconds
        return to_uint8(present(img, view, upscale, shown, text_size))

    return PreviewServer(get_frame, views=views, port=port, fps=fps, on_command=on_command)


def serve(engine: RenderEngine, port: int | None, fps: float, upscale: dict | None = None,
          cap: CaptureState | None = None, meter: Meter | None = None, text_size: int = 24,
          on_command=None):
    """(preview, publish) of a session: with a ``port``, make_preview over
    a Snapshot, and its ``publish``, which the render loop calls after
    each step; the URL is logged. (None, None) without a port or off rank
    0. The caller closes the preview."""
    if port is None:
        return None, None
    snapshot = Snapshot(engine)
    preview = make_preview(engine, upscale, cap, meter, port=port, fps=fps, text_size=text_size,
                           on_command=on_command, snapshot=snapshot)
    if preview is None:
        return None, None
    log0(f"live preview at {preview.url}", flush=True)
    return preview, snapshot.publish


def interactive_loop(engine: RenderEngine, out_dir: Path, upscale: dict | None = None,
                     min_frame_seconds: float = 0.0, serve_port: int | None = None,
                     serve_fps: float = 10.0) -> None:
    """Interactive session. Commands arrive on one queue from stdin (a
    reader thread) and, with ``serve_port``, from the preview page (POST
    /cmd); every engine step runs in this thread. While the preview is
    live and the cursor captured, the loop renders between commands, one
    frame a step (one launch per view group; the JAX package batches 8
    there against its dispatch cost) paced by ``min_frame_seconds``, and
    publishes each to the preview; without a preview it waits for the
    next command. stdin's end ends the session unless a preview is
    serving."""
    meter = Meter()
    cap = CaptureState()
    cmds: queue.Queue = queue.Queue()
    eof = object()

    def stdin_reader():
        for line in sys.stdin:
            cmds.put(line)
        cmds.put(eof)

    threading.Thread(target=stdin_reader, daemon=True).start()
    preview, publish = serve(engine, serve_port, serve_fps, upscale, cap, meter,
                             on_command=cmds.put)

    def frames(n, quiet=False):
        run_frames(engine, meter, n, quiet=quiet, min_frame_seconds=min_frame_seconds,
                   after_step=publish)
        if n > 0:
            cap.frame_rendered()

    def gated(what: str) -> bool:
        """True when rendering may proceed: only while captured."""
        if not cap.captured:
            log0(f"{what} ignored: cursor not captured (use 'capture')", flush=True)
            return False
        return True

    log0("interactive; commands: capture, escape, w/s/a/d/space/c/e/q, "
         "mouse, wheel, look, frames, save, stats, quit", flush=True)
    try:
        while True:
            if preview is not None and cap.captured:
                try:
                    line = cmds.get_nowait()
                except queue.Empty:
                    frames(1, quiet=True)
                    continue
            else:
                line = cmds.get()
            if line is eof:
                if preview is None:
                    break
                continue  # the page can still drive the session
            parts = line.strip().split()
            if not parts:
                continue
            cmd, *args = parts
            if cmd == "quit":
                break
            elif cmd == "capture":
                cap.capture()
                log0("cursor captured (hidden)", flush=True)
            elif cmd == "escape":
                cap.release()
                log0("cursor released", flush=True)
            elif cmd in KEYMAP:
                if not gated("move"):
                    continue
                engine.move(KEYMAP[cmd], float(args[0]) if args else 0.25)
                frames(1)
            elif cmd == "mouse":
                if not gated("mouse"):
                    continue
                dx = int(args[0]) if len(args) > 0 else 0
                dy = int(args[1]) if len(args) > 1 else 0
                if engine.mouse_moved(dx, dy):
                    frames(1)
                else:
                    log0("cursor recentered", flush=True)
            elif cmd == "wheel":
                # psi rotates and the accumulation resets even uncaptured,
                # but nothing renders until capture.
                engine.wheel_scrolled(float(args[0]) if args else 1.0)
                if cap.captured:
                    frames(1)
            elif cmd == "look":
                if not gated("look"):
                    continue
                d_fi = float(args[0]) if len(args) > 0 else 0.0
                d_te = float(args[1]) if len(args) > 1 else 0.0
                d_psi = float(args[2]) if len(args) > 2 else 0.0
                engine.rotate(d_fi=d_fi, d_te=d_te, d_psi=d_psi)
                frames(1)
            elif cmd == "frames":
                if not gated("frames"):
                    continue
                frames(int(args[0]) if args else 1)
            elif cmd == "save":
                target = Path(args[0]) if args else out_dir
                fps = None
                if cap.captured and not cap.fps_suppress and meter.stats.seconds > 0:
                    fps = meter.stats.frames / meter.stats.seconds
                for p in save_windows(engine, target, upscale=upscale, fps=fps):
                    log0(f"wrote {p}", flush=True)
            elif cmd == "stats":
                log0(meter.stats.as_json(), flush=True)
            else:
                log0(f"unknown command: {cmd}", flush=True)
    finally:
        if preview is not None:
            preview.close()


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
    ap.add_argument("--interactive", action="store_true",
                    help="read commands from stdin (the module's docstring)")
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--load-state", default=None,
                    help="resume the accumulation and camera from a checkpoint directory")
    ap.add_argument("--save-state", default=None,
                    help="write the engine's state to a checkpoint directory at exit")
    ap.add_argument("--fps-overlay", action="store_true",
                    help="burn the FPS counter into the main window's PNG")
    ap.add_argument("--upscale", action="store_true",
                    help="scale PNGs by each window's cell_size")
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="serve a live HTTP preview of every window at 127.0.0.1:PORT "
                    "(0: any free port)")
    ap.add_argument("--serve-fps", type=float, default=10.0,
                    help="preview stream parts per second, at most")
    ap.add_argument("--precompile", action=argparse.BooleanOptionalAction, default=None,
                    help="build and launch every kernel instance before the first frame "
                    "(default: on in an interactive or serving session)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    app = AppConfig.load(args.config)
    if args.scene:
        app = replace(app, scene=args.scene)
    engine = build_engine(app, device, deterministic=args.deterministic)
    if args.load_state:
        engine.load_checkpoint(args.load_state)
        log0(f"resumed from {args.load_state} at frame {engine.frame_number}", flush=True)
    res = [f"{g.cfg.width}x{g.cfg.height}:{','.join(g.views)}" for g in engine.groups]
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    log0(f"scene={app.scene} windows={res} spp={engine.cfg.samples} "
         f"bounces={engine.cfg.reflections_amount} device={name} controls={engine.controls}",
         flush=True)
    out_dir = Path(args.out)
    upscale = None
    if args.upscale:
        upscale = {"yxz": app.main_window.cell_size,
                   "ywz": app.additional_window.cell_size,
                   "yxw": app.additional_window.cell_size}

    precompile = args.precompile
    if precompile is None:
        precompile = args.interactive or args.serve is not None
    if precompile:
        log0(f"precompiling: one launch per view group ({len(engine.groups)})...", flush=True)
        log0(f"precompile done in {engine.precompile():.3f}s", flush=True)

    if args.interactive:
        pace = 1.0 / app.max_fps if app.max_fps > 0 else 0.0
        interactive_loop(engine, out_dir, upscale=upscale, min_frame_seconds=pace,
                         serve_port=args.serve, serve_fps=args.serve_fps)
    else:
        meter = Meter()
        preview, publish = serve(engine, args.serve, args.serve_fps, upscale,
                                 text_size=app.text.size)
        try:
            run_frames(engine, meter, args.frames, quiet=True, after_step=publish)
        finally:
            if preview is not None:
                preview.close()
        stats = meter.stats
        log0(json.dumps({"frames": stats.frames, "seconds": stats.seconds,
                         "rays_per_s": stats.rays_per_s if stats.seconds > 0 else None}),
             flush=True)
        fps = stats.frames / stats.seconds if args.fps_overlay and stats.seconds > 0 else None
        for p in save_windows(engine, out_dir, upscale=upscale, fps=fps,
                              text_size=app.text.size):
            log0(f"wrote {p}", flush=True)
        if is_rank0():
            (out_dir / "layout.json").write_text(json.dumps(window_layout(app), indent=1))
    if args.save_state and is_rank0():
        engine.save_checkpoint(args.save_state)
        log0(f"saved state to {args.save_state}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
