"""Frame-loop engine: seeds, progressive accumulation, camera state.

Counterpart of fourd_ray_tracing_tpu/engine.py:

* per-frame seed: ``seed ^= generate_seed()``, from an explicit
  numpy Generator (seeded 0 when ``deterministic``), so a deterministic
  engine reproduces the JAX engine's seed sequence, and a checkpoint
  resumes it by replaying its draws (``_rng_draws``);
* ``part = 1/frame_number`` progressive blend while the camera is still;
  a rotation or a move resets frame_number to 1;
* view groups: the main window and the additional windows render at
  their own resolutions; the additional views batch into one launch;
* camera state: the native C++ state machine (native/controls.cc) when
  it builds (``use_native_controls``: "auto" falls back to the Python
  camera of camera.py when g++ is missing, "native" raises then,
  "python" never builds it; ``controls`` says which is live). Input
  mapping: mouse pixel deltas x mouse_sensitivity, wheel clicks x
  wheel_sensitivity, offsets beyond max_mouse_offset only recenter the
  cursor;
* ``state_dict``/``load_state_dict`` and the checkpoints over them
  (utils/checkpoint.py); a state dict of the JAX engine (numpy arrays)
  loads as is.

``impl="cuda"`` renders through the forward kernel's wrapper
(ops/cuda/megakernel.py), which takes the plain pipeline for tensors on
the CPU; ``impl="torch"`` always takes the plain pipeline. With
``impl="cuda"`` the engine derives the static hints (the hyperplanes' and
the composite primitives' axes) from the scene once, at construction,
into every group's config (the JAX engine, engine.py:196-228), so a step
reads nothing back from the card to derive them. Accumulation buffers live on the engine's device and update in
place.
"""
from __future__ import annotations

import time
from dataclasses import replace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fourd_ray_tracing_tpu_torch import camera as cam
from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig, accumulate, render_light
from fourd_ray_tracing_tpu_torch.models.scene import Scene
from fourd_ray_tracing_tpu_torch.ops.cuda import build
from fourd_ray_tracing_tpu_torch.ops.cuda.megakernel import hinted, render_light_cuda, with_hints
from fourd_ray_tracing_tpu_torch.ops.sky import light_to_color
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4, f32
from fourd_ray_tracing_tpu_torch.utils import profiling

# The light renderers; a group tone-maps their light itself, as
# render_image_cuda and render_image do.
RENDERERS = {"cuda": render_light_cuda, "torch": render_light}


def generate_seed(rng: np.random.Generator, wall_clock: bool = True) -> int:
    """Per-frame 32-bit seed: an RNG draw, xor the wall clock in us."""
    s = int(rng.integers(0, 2**32))
    if wall_clock:
        s ^= time.monotonic_ns() // 1000 & 0xFFFFFFFF
    return s & 0xFFFFFFFF


class _ViewGroup:
    """Views sharing one render resolution and one accumulation buffer."""

    def __init__(self, cfg: RenderConfig, views: Tuple[str, ...], render, device):
        self.cfg = cfg
        self.views = views
        shape = (cfg.height, cfg.width, 3)
        if len(views) > 1:
            shape = (len(views),) + shape
        self.accum = torch.zeros(shape, dtype=torch.float32, device=device)
        self._render = render

    def camera(self, engine: "RenderEngine") -> cam.Camera:
        return cam.make_camera(
            engine.focus, engine.orientation(), engine.focus_to_matrix_distance,
            engine.matrix_height, self.views, engine.device,
        )

    def render(self, scene: Scene, camera: cam.Camera, seeds) -> torch.Tensor:
        """The tone-mapped frames of ``seeds`` (one kernel launch)."""
        light = self._render(scene, camera, self.cfg, seeds)
        with profiling.span("engine.tonemap"):
            return light_to_color(light, self.cfg.light_coefficient)

    def step_n(self, scene: Scene, camera: cam.Camera, seeds: np.ndarray, parts) -> None:
        """K frames rendered in one call (one kernel launch), then blended
        in order: bitwise K single steps."""
        frames = self.render(scene, camera, seeds)
        with profiling.span("engine.blend"):
            for frame, part in zip(frames, parts):
                accumulate(self.accum, frame, part)


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class RenderEngine:
    """Owns camera state and per-group accumulation; steps frames."""

    # step_frames renders up to this many frames per launch (the JAX
    # engine's largest STEP_CHUNKS entry). Its smaller chunks bound the
    # number of XLA compiles; a CUDA launch takes any frame count, so
    # here any n up to the cap is ONE launch per group.
    MAX_FRAMES_PER_LAUNCH = 128

    def __init__(
        self,
        scene: Scene,
        cfg: RenderConfig,
        focus: Vec4,
        angles: cam.CameraAngles,
        *,
        device,
        focus_to_matrix_distance: float = 1.5,
        matrix_height: float = 2.0,
        views: Sequence[str] = ("yxz",),
        movement_speed: float = 3.0,
        psi_constraint: Optional[tuple] = None,  # (center, radius) or None
        deterministic: bool = False,
        impl: str = "cuda",
        additional: Optional[Tuple[RenderConfig, Sequence[str]]] = None,
        mouse_sensitivity: float = 0.005,
        wheel_sensitivity: float = 0.1,
        max_mouse_offset: Optional[int] = None,
        use_native_controls: str = "auto",  # "auto" | "native" | "python"
    ):
        if impl not in RENDERERS:
            raise ValueError(f"impl must be one of {sorted(RENDERERS)}, got {impl!r}")
        if use_native_controls not in ("auto", "native", "python"):
            raise ValueError("use_native_controls must be 'auto', 'native' or 'python', got "
                             f"{use_native_controls!r}")
        self.device = torch.device(device)
        self.scene = scene
        self.cfg = cfg
        self.views = tuple(views)
        self.impl = impl
        self.focus_to_matrix_distance = float(focus_to_matrix_distance)
        self.matrix_height = float(matrix_height)
        self.movement_speed = float(movement_speed)
        self.psi_constraint = psi_constraint
        self.mouse_sensitivity = float(mouse_sensitivity)
        self.wheel_sensitivity = float(wheel_sensitivity)
        self.max_mouse_offset = max_mouse_offset
        self.frame_number = 1
        self.seed = 0
        self._deterministic = deterministic
        self._np_rng = np.random.default_rng(0 if deterministic else None)
        self._rng_draws = 0  # replayed by load_state_dict

        self._native = None
        norm_angles = angles.normalized(*(psi_constraint or (None, None)))
        if use_native_controls != "python":
            from fourd_ray_tracing_tpu_torch.native import binding

            try:
                self._native = binding.new_camera_state(
                    fi=float(norm_angles.fi), te=float(norm_angles.te),
                    psi=float(norm_angles.psi), focus=tuple(float(c) for c in focus),
                    psi_constraint=psi_constraint,
                )
            except (RuntimeError, OSError):
                if use_native_controls == "native":
                    raise
            self._binding = binding
        if self._native is None:
            self._angles = norm_angles
            self._focus = focus

        render = RENDERERS[impl]
        if impl == "cuda":
            cfg = self.cfg = with_hints(scene, cfg)
            if additional is not None and not hinted(additional[0]):
                additional = (replace(additional[0], plane_hints=cfg.plane_hints,
                                      plane_pairs=cfg.plane_pairs, axis_hints=cfg.axis_hints),
                              additional[1])
        self.groups: List[_ViewGroup] = [_ViewGroup(cfg, self.views, render, self.device)]
        if additional is not None:
            add_cfg, add_views = additional
            self.groups.append(_ViewGroup(add_cfg, tuple(add_views), render, self.device))

    # --- camera state ---------------------------------------------------

    @property
    def controls(self) -> str:
        """The live camera controls: "native" (controls.cc) or "python"."""
        return "python" if self._native is None else "native"

    def _floats(self, values) -> List[torch.Tensor]:
        """Host floats as 0-d float32 tensors on the engine's device, in
        one copy."""
        values = list(values)
        with profiling.sync("camera", self.device):
            return list(torch.tensor(values, dtype=torch.float32, device=self.device).unbind())

    @property
    def focus(self) -> Vec4:
        if self._native is not None:
            return Vec4(*self._floats(self._native.focus))
        return self._focus

    @focus.setter
    def focus(self, v: Vec4):
        if self._native is not None:
            for i, c in enumerate(v):
                self._native.focus[i] = float(c)
        else:
            self._focus = v

    @property
    def angles(self) -> cam.CameraAngles:
        if self._native is not None:
            s = self._native
            return cam.CameraAngles(*self._floats((s.fi, s.te, s.psi)))
        return self._angles

    @angles.setter
    def angles(self, a: cam.CameraAngles):
        if self._native is not None:
            s = self._native
            s.fi, s.te, s.psi = float(a.fi), float(a.te), float(a.psi)
            self._binding.update(s)
        else:
            self._angles = a

    def orientation(self) -> cam.Orientation:
        """The camera's bases: from the native state when it drives the
        viewer (one host-to-device copy), else derived from the angles."""
        if self._native is not None:
            s = self._native
            flat = self._floats(c for name in ("forward", "top", "right", "w_drct", "h_forward",
                                               "h_right", "v_top") for c in getattr(s, name))
            return cam.Orientation(*(Vec4(*flat[i:i + 4]) for i in range(0, 28, 4)))
        a = self._angles
        return cam.orientation_from_angles(a.fi, a.te, a.psi, self.device)

    def reset_accumulation(self):
        self.frame_number = 1

    def rotate(self, d_fi: float = 0.0, d_te: float = 0.0, d_psi: float = 0.0):
        """Mouse-look / wheel analogue, in radians; resets accumulation."""
        if self._native is not None:
            self._binding.rotate(self._native, d_fi, d_te, d_psi)
        else:
            a = cam.CameraAngles(
                self._angles.fi + f32(d_fi, self.device),
                self._angles.te + f32(d_te, self.device),
                self._angles.psi + f32(d_psi, self.device),
            )
            self._angles = a.normalized(*(self.psi_constraint or (None, None)))
        self.reset_accumulation()

    def mouse_moved(self, dx: int, dy: int) -> bool:
        """Pixel-delta mouse look: dx right, dy up. Offsets beyond
        max_mouse_offset only recenter the cursor. Returns True iff the
        camera rotated."""
        if self.max_mouse_offset is not None and (
            abs(dx) > self.max_mouse_offset or abs(dy) > self.max_mouse_offset
        ):
            return False
        if dx == 0 and dy == 0:
            return False
        self.rotate(d_fi=dx * self.mouse_sensitivity, d_te=dy * self.mouse_sensitivity)
        return True

    def wheel_scrolled(self, delta: float) -> None:
        """Vertical wheel -> psi."""
        self.rotate(d_psi=delta * self.wheel_sensitivity)

    def move(self, keys: cam.MoveKeys, seconds: float):
        """Keyboard movement for ``seconds`` at movement_speed; resets
        accumulation when the focus moved (read on the host once)."""
        if self._native is not None:
            b = self._binding
            mask = 0
            for flag, bit in (
                (keys.forward, b.KEY_FORWARD), (keys.back, b.KEY_BACK),
                (keys.right, b.KEY_RIGHT), (keys.left, b.KEY_LEFT),
                (keys.top, b.KEY_TOP), (keys.down, b.KEY_DOWN),
                (keys.w_pos, b.KEY_W_POS), (keys.w_neg, b.KEY_W_NEG),
            ):
                if flag:
                    mask |= bit
            if b.move(self._native, mask, float(seconds), self.movement_speed):
                self.reset_accumulation()
            return
        new_focus, moved = cam.move_focus(self._focus, self.orientation(), keys,
                                          float(seconds), self.movement_speed)
        if bool(moved):
            self._focus = new_focus
            self.reset_accumulation()

    # --- frame step ----------------------------------------------------

    @property
    def accum(self) -> torch.Tensor:
        """The main group's accumulation buffer."""
        return self.groups[0].accum

    def _next_seed(self) -> Tuple[int, float]:
        self.seed ^= generate_seed(self._np_rng, wall_clock=not self._deterministic)
        self._rng_draws += 1
        part = 1.0 / float(self.frame_number)
        self.frame_number += 1
        return self.seed, part

    def step_frame(self) -> torch.Tensor:
        """Render one frame into every group's buffer; returns the main one."""
        return self.step_frames(1)

    def step_frames(self, n: int) -> torch.Tensor:
        """Render ``n`` frames in one launch per group (per
        MAX_FRAMES_PER_LAUNCH frames); bitwise equal to ``n`` step_frame
        calls. Under a profiler it records the span ``engine.step`` and
        inside it ``engine.seeds``, and per group ``engine.camera``, the
        launch's (megakernel.render_light_cuda), ``engine.tonemap`` and
        ``engine.blend`` (utils/profiling.py)."""
        with profiling.span("engine.step"):
            while n > 0:
                chunk = min(n, self.MAX_FRAMES_PER_LAUNCH)
                with profiling.span("engine.seeds"):
                    seeds, parts = zip(*(self._next_seed() for _ in range(chunk)))
                    seeds = np.asarray(seeds, np.uint32)
                for g in self.groups:
                    with profiling.span("engine.camera"):
                        camera = g.camera(self)
                    g.step_n(self.scene, camera, seeds, parts)
                n -= chunk
        return self.accum

    def precompile(self) -> float:
        """Everything the first frame would wait for, done ahead of it: on
        the card, the kernels' build and load (ops/cuda/build.load), then
        one launch per view group on a scratch output, which covers every
        kernel instance the engine dispatches (the instance follows the
        scene and the group's config and hints, not the frame count; a
        CUDA launch takes any frame count, so there are no step sizes to
        warm). The seed sequence, frame counter and accumulation are left
        bitwise as they were. Returns the seconds spent (the time to the
        first frame that the app logs)."""
        t0 = time.monotonic()
        cuda = self.device.type == "cuda"
        if cuda and self.impl == "cuda":
            build.load()
        for g in self.groups:
            g.render(self.scene, g.camera(self), np.ones(1, np.uint32))
        if cuda:
            torch.cuda.synchronize(self.device)
        return time.monotonic() - t0

    def run(self, n_frames: int) -> torch.Tensor:
        for _ in range(n_frames):
            self.step_frame()
        return self.accum

    def windows(self) -> List[Tuple[str, np.ndarray]]:
        """(view name, HxWx3 float image) per window across all groups."""
        out = []
        for g in self.groups:
            acc = g.accum.cpu().numpy()
            if acc.ndim == 3:
                acc = acc[None]
            out.extend(zip(g.views, acc))
        return out

    def rays_per_frame(self) -> int:
        return sum(len(g.views) * g.cfg.width * g.cfg.height * g.cfg.samples for g in self.groups)

    # --- checkpoint / resume ---------------------------------------------

    def state_dict(self) -> dict:
        """The resumable state: a copy of each group's accumulation, the
        frame counter, the seed, the seed generator's draws and the camera
        pose (tensors on the engine's device, and plain ints)."""
        a, f = self.angles, self.focus
        return {
            "accums": [g.accum.detach().clone() for g in self.groups],
            "frame_number": int(self.frame_number),
            "seed": int(self.seed),
            "rng_draws": int(self._rng_draws),
            "angles": torch.stack([a.fi, a.te, a.psi]).to(torch.float32),
            "focus": torch.stack(list(f)).to(torch.float32),
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore a ``state_dict``, of this engine or the JAX engine's
        (numpy arrays): the buffers are copied to the engine's device, and
        a deterministic engine replays the seed generator's draws."""
        accums = state["accums"]
        if len(accums) != len(self.groups):
            raise ValueError(f"checkpoint has {len(accums)} view groups, engine has "
                             f"{len(self.groups)}")
        loaded = []
        for g, acc in zip(self.groups, accums):
            acc = acc if isinstance(acc, torch.Tensor) else torch.from_numpy(np.array(acc))
            if tuple(acc.shape) != tuple(g.accum.shape):
                raise ValueError(f"checkpoint accum shape {tuple(acc.shape)} != "
                                 f"{tuple(g.accum.shape)}")
            loaded.append(acc.to(device=self.device, dtype=torch.float32, copy=True).contiguous())
        for g, acc in zip(self.groups, loaded):
            g.accum = acc
        self.frame_number = int(state["frame_number"])
        self.seed = int(state["seed"])
        self._rng_draws = int(state.get("rng_draws", 0))
        self._np_rng = np.random.default_rng(0 if self._deterministic else None)
        for _ in range(self._rng_draws if self._deterministic else 0):
            self._np_rng.integers(0, 2**32)
        ang = _host(state["angles"]).astype(np.float32)
        self.angles = cam.CameraAngles(*self._floats(ang))
        self.focus = Vec4(*self._floats(_host(state["focus"]).astype(np.float32)))

    def save_checkpoint(self, path) -> None:
        from fourd_ray_tracing_tpu_torch.utils import checkpoint

        checkpoint.save(path, self.state_dict())

    def load_checkpoint(self, path) -> None:
        from fourd_ray_tracing_tpu_torch.utils import checkpoint

        self.load_state_dict(checkpoint.restore(path, self.state_dict()))
