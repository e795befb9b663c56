"""The image loss and its gradient by autograd over this copy, in bands
of rows: the plain version of a training step's loss and gradient."""
from __future__ import annotations

import torch

from benchmark.reference.models import params, renderer
from benchmark.reference.models.renderer import RenderConfig
from benchmark.reference.hints import stop_frozen

MASK32 = 0xFFFFFFFF


def frame_seeds(seed: int, frames: int) -> list:
    """A minibatch step's frame seeds: seed * F + k as uint32 words."""
    return [((seed & MASK32) * frames + k) & MASK32 for k in range(frames)]


@torch.enable_grad()
def loss_and_grad(packed: torch.Tensor, like_scene, like_camera, cfg: RenderConfig, seeds,
                  target: torch.Tensor, band_rows: int, rows=None) -> tuple:
    """(loss, (P,) gradient) of mean((image - target)^2) over the frames
    ``seeds`` and the image's rows (or ``rows`` = (row0, n_rows) of them,
    ``target`` their block), one frame and one band of ``band_rows`` rows
    at a time, the parts summed in float64. Under the freeze_hints
    contract the pipeline folds with ``cfg``'s hints and the frozen leaves
    get no gradient."""
    row0, n_rows = (0, cfg.height) if rows is None else rows
    count = float(len(seeds) * target.numel() // n_rows * cfg.height)
    loss = torch.zeros((), dtype=torch.float64, device=packed.device)
    grad = torch.zeros(packed.shape, dtype=torch.float64, device=packed.device)
    for seed in seeds:
        for top in range(0, n_rows, band_rows):
            stop = min(top + band_rows, n_rows)
            vec = packed.detach().clone().requires_grad_(True)
            scene, camera = params.unpack(vec, like_scene, like_camera)
            image = renderer.render_image(stop_frozen(scene, cfg), camera, cfg, seed,
                                          slice(row0 + top, row0 + stop))
            part = torch.sum(((image - target[..., top:stop, :, :]) ** 2).double()) / count
            (g,) = torch.autograd.grad(part, vec)
            loss, grad = loss + part.detach(), grad + g.double()
    return loss.float(), grad.float()


def render_banded(scene, camera, cfg: RenderConfig, seeds, band_rows: int) -> torch.Tensor:
    """render_image of the whole image, ``band_rows`` rows at a time."""
    with torch.no_grad():
        bands = [renderer.render_image(scene, camera, cfg, seeds, slice(r, r + band_rows))
                 for r in range(0, cfg.height, band_rows)]
    return torch.cat(bands, dim=-3)


class Adam:
    """torch.optim.Adam's update with its defaults (betas 0.9, 0.999, eps
    1e-8, no weight decay), written out in float32."""

    def __init__(self, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.betas, self.eps = lr, betas, eps
        self.m = self.v = None
        self.t = 0

    def step(self, p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        b1, b2 = self.betas
        if self.m is None:
            self.m, self.v = torch.zeros_like(p), torch.zeros_like(p)
        self.t += 1
        self.m = self.m * b1 + g * (1 - b1)
        self.v = self.v * b2 + g * g * (1 - b2)
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        denom = torch.sqrt(self.v) / bc2 ** 0.5 + self.eps
        return p - (self.lr / bc1) * self.m / denom


def leaf_groups(scene) -> list:
    """(start, stop) of each parameter group of the scene's packed slice:
    a Vec4 or Vec3 field is one group, a scalar field another."""
    from benchmark.reference.ops.vec4 import Vec3, Vec4

    groups, offset = [], 0

    def walk(node):
        nonlocal offset
        if node is None:
            return
        if isinstance(node, (Vec3, Vec4)) or isinstance(node, torch.Tensor):
            n = sum(t.numel() for t in params.tree_leaves(node))
            groups.append((offset, offset + n))
            offset += n
            return
        if isinstance(node, tuple):
            fields = (node.sun, node.sky_light) if hasattr(node, "enabled") else node
            for child in fields:
                walk(child)
            return
        raise TypeError(f"unexpected parameter node {type(node).__name__}")

    walk(scene)
    if offset != params.n_scene(scene):
        raise ValueError("leaf groups do not cover the scene")
    return groups
