"""Frame-loop engine: seeds, progressive accumulation, camera state.

Counterpart of fourd_ray_tracing_tpu/engine.py with the pure-Python
camera state (the JAX engine's use_native_controls="python"):

* per-frame seed: ``seed ^= generate_seed()``, from an explicit
  numpy Generator (seeded 0 when ``deterministic``), so a deterministic
  engine reproduces the JAX engine's seed sequence;
* ``part = 1/frame_number`` progressive blend while the camera is still;
  a rotation resets frame_number to 1;
* view groups: the main window and the additional windows render at
  their own resolutions; the additional views batch into one launch.

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
from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig, accumulate, render_image
from fourd_ray_tracing_tpu_torch.models.scene import Scene
from fourd_ray_tracing_tpu_torch.ops.cuda.megakernel import hinted, render_image_cuda, with_hints
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4, f32

RENDERERS = {"cuda": render_image_cuda, "torch": render_image}


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

    def step_n(self, scene: Scene, camera: cam.Camera, seeds: np.ndarray, parts) -> None:
        """K frames rendered in one call (one kernel launch), then blended
        in order: bitwise K single steps."""
        frames = self._render(scene, camera, self.cfg, seeds)
        for frame, part in zip(frames, parts):
            accumulate(self.accum, frame, part)


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
        psi_constraint: Optional[tuple] = None,  # (center, radius) or None
        deterministic: bool = False,
        impl: str = "cuda",
        additional: Optional[Tuple[RenderConfig, Sequence[str]]] = None,
    ):
        if impl not in RENDERERS:
            raise ValueError(f"impl must be one of {sorted(RENDERERS)}, got {impl!r}")
        self.device = torch.device(device)
        self.scene = scene
        self.cfg = cfg
        self.views = tuple(views)
        self.focus_to_matrix_distance = float(focus_to_matrix_distance)
        self.matrix_height = float(matrix_height)
        self.psi_constraint = psi_constraint
        self.frame_number = 1
        self.seed = 0
        self._deterministic = deterministic
        self._np_rng = np.random.default_rng(0 if deterministic else None)
        self.focus = focus
        self.angles = angles.normalized(*(psi_constraint or (None, None)))

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

    def orientation(self) -> cam.Orientation:
        a = self.angles
        return cam.orientation_from_angles(a.fi, a.te, a.psi, self.device)

    def reset_accumulation(self):
        self.frame_number = 1

    def rotate(self, d_fi: float = 0.0, d_te: float = 0.0, d_psi: float = 0.0):
        """Mouse-look / wheel analogue, in radians; resets accumulation."""
        a = cam.CameraAngles(
            self.angles.fi + f32(d_fi, self.device),
            self.angles.te + f32(d_te, self.device),
            self.angles.psi + f32(d_psi, self.device),
        )
        self.angles = a.normalized(*(self.psi_constraint or (None, None)))
        self.reset_accumulation()

    @property
    def accum(self) -> torch.Tensor:
        """The main group's accumulation buffer."""
        return self.groups[0].accum

    def _next_seed(self) -> Tuple[int, float]:
        self.seed ^= generate_seed(self._np_rng, wall_clock=not self._deterministic)
        part = 1.0 / float(self.frame_number)
        self.frame_number += 1
        return self.seed, part

    def step_frame(self) -> torch.Tensor:
        """Render one frame into every group's buffer; returns the main one."""
        return self.step_frames(1)

    def step_frames(self, n: int) -> torch.Tensor:
        """Render ``n`` frames in one launch per group (per
        MAX_FRAMES_PER_LAUNCH frames); bitwise equal to ``n`` step_frame
        calls."""
        while n > 0:
            chunk = min(n, self.MAX_FRAMES_PER_LAUNCH)
            seeds, parts = zip(*(self._next_seed() for _ in range(chunk)))
            seeds = np.asarray(seeds, np.uint32)
            for g in self.groups:
                g.step_n(self.scene, g.camera(self), seeds, parts)
            n -= chunk
        return self.accum

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
