"""Differentiable rendering, hard loss: losses, gradients, training steps.

Counterpart of fourd_ray_tracing_tpu/diff.py:67-87, 457-484 and 895-1065.
Gradients are those of the estimator at a fixed seed (the JAX package's
diff.py:8-24): uniforms are constants, hit/miss and mirror/diffuse
decisions stay at their sampled outcomes, and cotangents flow through the
continuous geometry and shading.

Two routes compute them. The plain one is torch autograd over the plain
pipeline (models/renderer.py), the counterpart of ``impl="xla"``. The
kernel one is the value-and-grad kernel K4 (ops/cuda/gradkernel.py), the
counterpart of ``impl="pallas"``: ``ImageLoss`` launches it once in its
forward and scales the saved gradient in its backward. On CPU tensors the
kernel route runs the plain expression instead, as every kernel wrapper of
the port does.

Not ported yet, and raising: mesh sharding (ROADMAP queue 1, item 12),
the soft-silhouette loss (item 11) and the frozen static hints (item 4).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from fourd_ray_tracing_tpu_torch.camera import Camera
from fourd_ray_tracing_tpu_torch.models import params, renderer
from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig
from fourd_ray_tracing_tpu_torch.models.scene import Scene
from fourd_ray_tracing_tpu_torch.ops.cuda import gradkernel

IMPLS = ("plain", "kernel")


def _check_unported(mesh=None, soft_sphere_index=None, soft_object_ref=None) -> None:
    if mesh is not None:
        raise NotImplementedError("mesh sharding is not ported yet (ROADMAP queue 1, item 12)")
    if soft_sphere_index is not None or soft_object_ref is not None:
        raise NotImplementedError(
            "the soft-silhouette loss is not ported yet (ROADMAP queue 1, item 11)")


def image_loss(scene: Scene, camera: Camera, cfg: RenderConfig, seed, target,
               mesh=None) -> torch.Tensor:
    """MSE between the rendered (tone-mapped) image and a target,
    differentiable by torch autograd."""
    _check_unported(mesh=mesh)
    return renderer.image_loss(scene, camera, cfg, seed, target)


def render_grad(scene: Scene, camera: Camera, cfg: RenderConfig, seed, target, mesh=None):
    """(loss, (grad_scene, grad_camera)) at a fixed seed, by autograd over
    the plain pipeline."""
    _check_unported(mesh=mesh)
    loss, grad = gradkernel.loss_and_grad_plain(params.pack(scene, camera), scene, camera, cfg,
                                                seed, target)
    return loss, params.unpack(grad, scene, camera)


class ImageLoss(torch.autograd.Function):
    """``image_loss`` of the packed vector through K4: the forward launches
    the kernel once and keeps its gradient, the backward scales it by the
    incoming cotangent (the counterpart of the pallas_image_loss
    custom_vjp, diff.py:457-484)."""

    @staticmethod
    def forward(ctx, vec, like_scene, like_camera, cfg, seed, target):
        loss, grad = gradkernel.loss_and_grad_cuda(vec, like_scene, like_camera, cfg, seed, target)
        ctx.save_for_backward(grad)
        return loss

    @staticmethod
    def backward(ctx, ct):
        (grad,) = ctx.saved_tensors
        return grad * ct, None, None, None, None, None


def image_loss_kernel(vec: torch.Tensor, like_scene: Scene, like_camera: Camera,
                      cfg: RenderConfig, seed, target) -> torch.Tensor:
    """``image_loss`` of the scene and camera packed in ``vec`` (P,),
    differentiable w.r.t. ``vec``: K4 for a CUDA vector, the plain
    expression for a CPU one."""
    if vec.device.type == "cpu":
        scene, camera = params.unpack(vec, like_scene, like_camera)
        return renderer.image_loss(scene, camera, cfg, seed, target)
    if vec.device.type != "cuda":
        raise ValueError(f"image_loss_kernel takes CPU or CUDA tensors, got {vec.device}")
    return ImageLoss.apply(vec, like_scene, like_camera, cfg, seed, target)


def frame_seeds(seed, frames_per_step: int):
    """The step's seed, or for a minibatch step its frames' seeds
    seed * F + arange(F) as uint32 words (diff.py:1055-1057)."""
    if frames_per_step <= 1:
        return seed
    words, batched = renderer.seed_words(seed)
    if batched:
        raise ValueError("a minibatch step takes one scalar seed")
    return [(words[0] * frames_per_step + k) & 0xFFFFFFFF for k in range(frames_per_step)]


def _check_impl(impl: str, frames_per_step: int) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if frames_per_step > 1 and impl != "kernel":
        raise ValueError("frames_per_step > 1 is the value-and-grad kernel's minibatch "
                         "(impl='kernel', hard loss only)")


def make_train_step(cfg: RenderConfig, lr: float, camera: Camera,
                    param_filter: Optional[Callable] = None, impl: str = "plain",
                    frames_per_step: int = 1, mesh=None, soft_sphere_index=None,
                    soft_object_ref=None):
    """Inverse-rendering step over the scene's leaves with
    ``torch.optim.Adam(lr)``. Returns ``(step, init)``:

    * ``init(scene) -> (scene, optimizer)``: a copy of the scene whose
      leaves are the optimized tensors, and the optimizer over them;
    * ``step(scene, optimizer, seed, target) -> (scene, optimizer, loss,
      metrics)`` updates the leaves in place; ``metrics`` holds the loss
      and the global gradient norm.

    ``param_filter(grads) -> grads`` maps a Scene of gradients to the
    gradients to apply (zeroing frozen parameters). ``impl="kernel"``
    trains through K4 (``image_loss_kernel``); ``frames_per_step`` > 1,
    kernel only, averages that many estimator samples per step in one
    launch.
    """
    _check_unported(mesh, soft_sphere_index, soft_object_ref)
    _check_impl(impl, frames_per_step)
    renderer.check_supported(cfg)

    def init(scene: Scene):
        scene = params.map_leaves(
            lambda t: t.detach().to(torch.float32).clone().requires_grad_(True), scene)
        return scene, torch.optim.Adam(list(params.tree_leaves(scene)), lr=lr)

    def loss_fn(scene, seed, target):
        if impl == "kernel":
            vec = params.pack(scene, camera)
            return image_loss_kernel(vec, scene, camera, cfg, seed, target)
        return renderer.image_loss(scene, camera, cfg, seed, target)

    def step(scene, optimizer, seed, target):
        optimizer.zero_grad(set_to_none=False)
        loss = loss_fn(scene, frame_seeds(seed, frames_per_step), target)
        loss.backward()
        leaves = list(params.tree_leaves(scene))
        for leaf in leaves:  # a leaf that only enters comparisons (refl_prob) has grad 0
            if leaf.grad is None:
                leaf.grad = torch.zeros_like(leaf)
        if param_filter is not None:
            filtered = param_filter(params.map_leaves(lambda t: t.grad, scene))
            for leaf, g in zip(leaves, params.tree_leaves(filtered)):
                leaf.grad.copy_(g)
        grad_norm = torch.sqrt(sum(torch.sum(t.grad * t.grad) for t in leaves))
        optimizer.step()
        loss = loss.detach()
        return scene, optimizer, loss, {"loss": loss, "grad_norm": grad_norm}

    return step, init


class PackedScene(nn.Module):
    """The training state of the packed loop: the scene's slice of the
    packed vector as one parameter, the camera's as a buffer."""

    def __init__(self, scene_vec: torch.Tensor, cam_vec: torch.Tensor):
        super().__init__()
        self.scene_vec = nn.Parameter(scene_vec)
        self.register_buffer("cam_vec", cam_vec)

    def packed(self) -> torch.Tensor:
        return torch.cat([self.scene_vec, self.cam_vec])


def make_packed_train_step(cfg: RenderConfig, lr: float, camera: Camera, scene_template: Scene,
                           param_filter: Optional[Callable] = None, frames_per_step: int = 1):
    """The packed-space train loop (diff.py:988-1065): ``torch.optim.Adam``
    on the scene's packed vector, the loss through ``image_loss_kernel``
    (one K4 launch per step on the card). Returns ``(step, init, unpack)``:

    * ``init(scene) -> (model, optimizer)``: a ``PackedScene`` and Adam
      over its one parameter;
    * ``step(model, optimizer, seed, target) -> loss`` updates the model in
      place; a scalar seed, from which a minibatch step derives its
      ``frames_per_step`` frame seeds;
    * ``unpack(model or scene_vec) -> Scene``.

    ``param_filter`` (the make_train_step contract) becomes a packed 0/1
    vector that multiplies the gradient before the optimizer.
    """
    renderer.check_supported(cfg)
    n = params.n_scene(scene_template)
    cam_vec = params.pack(scene_template, camera).detach()[n:]
    mask = None if param_filter is None else params.leaf_mask(param_filter, scene_template)

    def init(scene: Scene):
        vec = params.pack(scene, camera).detach()
        model = PackedScene(vec[:n].clone(), cam_vec.to(vec.device))
        return model, torch.optim.Adam(model.parameters(), lr=lr)

    def step(model: PackedScene, optimizer, seed, target):
        optimizer.zero_grad(set_to_none=False)
        loss = image_loss_kernel(model.packed(), scene_template, camera, cfg,
                                 frame_seeds(seed, frames_per_step), target)
        loss.backward()
        if mask is not None:
            model.scene_vec.grad.mul_(mask.to(model.scene_vec.device))
        optimizer.step()
        return loss.detach()

    def unpack(state) -> Scene:
        vec = state.scene_vec if isinstance(state, PackedScene) else state
        full = torch.cat([vec.detach(), cam_vec.to(vec.device)])
        return params.unpack(full, scene_template, camera)[0]

    return step, init, unpack
