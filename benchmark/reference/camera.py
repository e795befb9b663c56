"""4D camera: spherical angles -> orthonormal basis, and per-window views.

Counterpart of fourd_ray_tracing_tpu/camera.py. The basis starts from
identity (forward=y, top=z, right=x, w=w) and takes three Givens
rotations: psi in the (top, w) plane, fi in (forward, right), te in
(forward, top). A camera's ``top``/``right`` may carry a leading view
axis (batched_view_bases), so one launch renders several 3D sections.
Movement (``move_focus``) goes along the partially rotated bases, so W/S
stay in the horizontal plane whatever the pitch.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from benchmark.reference.ops.vec4 import Vec4, f32, length

PI = float(np.float32(np.pi))
# width/height ratio of windows and camera film.
GOLDEN = float(np.float32(1.61803399))


class Orientation(NamedTuple):
    """Full and partially rotated camera bases."""

    forward: Vec4
    top: Vec4
    right: Vec4
    w_drct: Vec4
    horizontal_forward: Vec4
    horizontal_right: Vec4
    vertical_top: Vec4


def rotate_pair(angle: torch.Tensor, x: Vec4, y: Vec4):
    """Rotate two basis vectors in their shared plane."""
    sin_a = torch.sin(angle)
    cos_a = torch.cos(angle)
    return x * cos_a + y * sin_a, x * (-sin_a) + y * cos_a


def orientation_from_angles(fi, te, psi, device) -> Orientation:
    """Basis from yaw fi, pitch te and 4D roll psi (0-d tensors on ``device``)."""
    forward = Vec4.of(0.0, 1.0, 0.0, 0.0, device=device)
    top = Vec4.of(0.0, 0.0, 1.0, 0.0, device=device)
    right = Vec4.of(1.0, 0.0, 0.0, 0.0, device=device)
    w_drct = Vec4.of(0.0, 0.0, 0.0, 1.0, device=device)

    top, w_drct = rotate_pair(psi, top, w_drct)
    vertical_top = top
    forward, right = rotate_pair(fi, forward, right)
    horizontal_forward, horizontal_right = forward, right
    forward, top = rotate_pair(te, forward, top)
    return Orientation(
        forward, top, right, w_drct,
        horizontal_forward, horizontal_right, vertical_top,
    )


def normalize_angle(angle: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi]."""
    wrapped = torch.remainder(angle + PI, float(np.float32(2.0) * np.float32(PI))) - PI
    return torch.where(wrapped <= -PI, wrapped + float(np.float32(2.0) * np.float32(PI)), wrapped)


def pull_into_range(value, center, radius):
    """Clamp to [center - radius, center + radius]."""
    return torch.clamp(value, center - radius, center + radius)


class CameraAngles(NamedTuple):
    """fi / te / psi as 0-d float32 tensors."""

    fi: torch.Tensor
    te: torch.Tensor
    psi: torch.Tensor

    @staticmethod
    def of(fi: float, te: float, psi: float, device) -> "CameraAngles":
        return CameraAngles(f32(fi, device), f32(te, device), f32(psi, device))

    def normalized(self, psi_center=None, psi_radius=None) -> "CameraAngles":
        """fi wraps, te clamps to [-pi/2, pi/2], psi wraps or clamps to
        [center - radius, center + radius]."""
        fi = normalize_angle(self.fi)
        te = pull_into_range(self.te, 0.0, PI / 2)
        if psi_center is not None:
            psi = pull_into_range(self.psi, psi_center, psi_radius)
        else:
            psi = normalize_angle(self.psi)
        return CameraAngles(fi, te, psi)


class Camera(NamedTuple):
    """Camera state handed to the renderer each frame."""

    focus: Vec4
    vec_to_mtr: Vec4     # forward * focus_to_matrix_distance
    top: Vec4            # per view; may carry a leading view axis
    right: Vec4
    mtr_width: torch.Tensor
    mtr_height: torch.Tensor


def view_basis(orient: Orientation, view: str):
    """(top, right) for one of the three orthogonal 3D sections."""
    if view == "yxz":       # main window
        return orient.top, orient.right
    if view == "ywz":       # w replaces x
        return orient.top, orient.w_drct
    if view == "yxw":       # w replaces z
        return orient.w_drct, orient.right
    raise ValueError(f"unknown view {view!r}")


VIEWS_ALL: Sequence[str] = ("yxz", "ywz", "yxw")


def batched_view_bases(orient: Orientation, views: Sequence[str] = VIEWS_ALL):
    """View bases stacked along a leading axis: one launch renders all."""
    tops, rights = zip(*(view_basis(orient, v) for v in views))

    def stack(vs):
        return Vec4(*(torch.stack([getattr(v, c) for v in vs]) for c in "xyzw"))

    return stack(tops), stack(rights)


def make_camera(focus: Vec4, orient: Orientation, focus_to_matrix_distance: float,
                matrix_height: float, views: Sequence[str], device) -> Camera:
    """Camera for one view (a single name) or a view batch (several)."""
    if len(views) == 1:
        top, right = view_basis(orient, views[0])
    else:
        top, right = batched_view_bases(orient, views)
    mtr_h = f32(matrix_height, device)
    return Camera(
        focus=focus,
        vec_to_mtr=orient.forward * f32(focus_to_matrix_distance, device),
        top=top,
        right=right,
        mtr_width=mtr_h * GOLDEN,
        mtr_height=mtr_h,
    )


def camera_from_state(focus: Vec4, angles: CameraAngles, focus_to_matrix_distance: float,
                      matrix_height: float, view: str = "yxz", *, device) -> Camera:
    orient = orientation_from_angles(angles.fi, angles.te, angles.psi, device)
    return make_camera(focus, orient, focus_to_matrix_distance, matrix_height, (view,), device)


class MoveKeys(NamedTuple):
    """Held-key state for 8-direction movement."""

    forward: bool = False
    back: bool = False
    right: bool = False
    left: bool = False
    top: bool = False
    down: bool = False
    w_pos: bool = False
    w_neg: bool = False


def move_focus(focus: Vec4, orient: Orientation, keys: MoveKeys, seconds,
               speed) -> tuple:
    """(new focus, moved): the focus translated by ``seconds * speed``
    along the sum of the held keys' bases (the horizontal forward and
    right, the vertical top, w). ``moved`` is a 0-d bool tensor on the
    focus's device, true exactly when the keys' directions do not cancel
    (the accumulation must reset then)."""
    device = focus.x.device
    drct = Vec4.of(0.0, 0.0, 0.0, 0.0, device=device)
    pairs = (
        (keys.forward, keys.back, orient.horizontal_forward),
        (keys.top, keys.down, orient.vertical_top),
        (keys.right, keys.left, orient.horizontal_right),
        (keys.w_pos, keys.w_neg, orient.w_drct),
    )
    for pos, neg, basis in pairs:
        if pos:
            drct = drct + basis
        if neg:
            drct = drct - basis
    norm = length(drct)
    step = torch.as_tensor(seconds, dtype=torch.float32, device=device) * torch.as_tensor(
        speed, dtype=torch.float32, device=device)
    moved = norm > 0.0
    scale = torch.where(moved, step / torch.clamp_min(norm, 1e-30), 0.0)
    return focus + drct * scale, moved
