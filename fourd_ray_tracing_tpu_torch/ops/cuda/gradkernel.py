"""Wrapper of the value-and-grad kernel (csrc/gradkernel.cu), and its plain version.

Counterpart of fourd_ray_tracing_tpu/ops/pallas/gradkernel.py's
render_loss_and_grad_pallas and make_packed_loss_and_grad: the MSE of the
tone-mapped render against a target, and the gradient of every packed
scene and camera parameter, at a fixed seed. A (F,) seed vector takes F
estimator samples of the same loss in one launch (the minibatch): loss
and gradients are the mean of the F scalar-seed calls.

The plain version is torch autograd over the plain pipeline
(models/renderer.py). Tensors on the CPU go through it; tensors on a CUDA
device go through the kernel, or the call raises. ``LAUNCHES`` counts
kernel launches (one per call of ``launch_loss_grad``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from fourd_ray_tracing_tpu_torch.camera import Camera
from fourd_ray_tracing_tpu_torch.models import params, renderer
from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig
from fourd_ray_tracing_tpu_torch.models.scene import Scene
from fourd_ray_tracing_tpu_torch.ops.cuda import build
from fourd_ray_tracing_tpu_torch.ops.cuda.megakernel import seed_tensor

LAUNCHES = 0
# Sizes of the kernel's per-thread arrays, which the build passes to it.
MAX_PARAMS, MAX_BOUNCES = build.K4_MAX_PARAMS, build.K4_MAX_BOUNCES


def loss_and_grad_plain(packed: torch.Tensor, like_scene: Scene, like_camera: Camera,
                        cfg: RenderConfig, seed, target, band_rows: int | None = None):
    """The plain version of the kernel: (loss, (P,) gradient of the packed
    vector) by autograd over the plain pipeline (renderer.image_loss).

    ``band_rows`` takes the loss, a sum over pixels, one frame and one band
    of that many rows at a time, and sums the bands' losses and gradients
    in float64: the same values (up to the order of the sums) with the
    autograd graph of one band in memory, for shapes whose whole graph
    would not fit."""
    if band_rows is None:
        vec = packed.detach().clone().requires_grad_(True)
        scene, camera = params.unpack(vec, like_scene, like_camera)
        loss = renderer.image_loss(scene, camera, cfg, seed, target)
        (grad,) = torch.autograd.grad(loss, vec)
        return loss.detach(), grad
    words, _ = renderer.seed_words(seed)
    count = torch.tensor(float(len(words) * target.numel()), dtype=torch.float64,
                         device=packed.device)
    loss, grad = torch.zeros((), dtype=torch.float64, device=packed.device), 0.0
    for word in words:
        for top in range(0, cfg.height, band_rows):
            rows = slice(top, top + band_rows)
            vec = packed.detach().clone().requires_grad_(True)
            scene, camera = params.unpack(vec, like_scene, like_camera)
            image = renderer.render_image(scene, camera, cfg, word, rows)
            part = torch.sum(((image - target[..., rows, :, :]) ** 2).double()) / count
            (g,) = torch.autograd.grad(part, vec)
            loss, grad = loss + part.detach(), grad + g.double()
    return loss.float(), grad.float()


def check_shape(lay: params.Layout, cfg: RenderConfig) -> None:
    """Raise for what the kernel's per-thread arrays cannot hold."""
    if lay.size > MAX_PARAMS:
        raise ValueError(f"the value-and-grad kernel holds at most {MAX_PARAMS} packed "
                         f"parameters per thread; this scene and camera have {lay.size}")
    if not 0 <= cfg.reflections_amount <= MAX_BOUNCES:
        raise ValueError(f"the value-and-grad kernel records at most {MAX_BOUNCES} bounces "
                         f"per sample; reflections_amount is {cfg.reflections_amount}")


def launch_loss_grad(packed: torch.Tensor, lay: params.Layout, cfg: RenderConfig,
                     seeds: torch.Tensor, target: torch.Tensor):
    """One kernel launch: (loss (), grad (P,)) float32, both scaled to the
    mean over F frames, views, pixels and channels, from the packed (P,)
    params, (F,) int32 seed words and the (V, H, W, 3) or (H, W, 3) float32
    target, on their CUDA device."""
    global LAUNCHES
    device = packed.device
    if device.type != "cuda" or seeds.device != device or target.device != device:
        raise ValueError(f"kernel inputs must share one CUDA device, got {device}, "
                         f"{seeds.device}, {target.device}")
    if packed.dtype != torch.float32 or packed.dim() != 1 or not packed.is_contiguous():
        raise ValueError("packed params must be a contiguous (P,) float32 tensor")
    if packed.numel() != lay.size:
        raise ValueError(f"packed params hold {packed.numel()} floats, layout expects {lay.size}")
    if seeds.dtype != torch.int32 or seeds.dim() != 1 or not seeds.is_contiguous():
        raise ValueError("seeds must be a contiguous (F,) int32 tensor of uint32 words")
    total = lay.n_views * cfg.height * cfg.width
    if (target.dtype != torch.float32 or not target.is_contiguous()
            or target.numel() != total * 3 or target.shape[-1] != 3):
        raise ValueError(f"target must be a contiguous float32 tensor of {lay.n_views} x "
                         f"{cfg.height} x {cfg.width} x 3 values, got {tuple(target.shape)} "
                         f"{target.dtype}")
    check_shape(lay, cfg)
    lib = build.load()
    n_frames = seeds.numel()
    table = (ctypes.c_int * len(lay))(*lay)
    n_cols = lib.fourd_loss_grad_scratch_cols(ctypes.addressof(table), cfg.width, cfg.height,
                                              n_frames)
    if n_cols < 0:
        raise ValueError(f"the value-and-grad kernel cannot launch {n_frames} frames of "
                         f"{lay.n_views} x {cfg.height} x {cfg.width} pixels")
    grad_parts = torch.empty((lay.size, n_cols), dtype=torch.float32, device=device)
    loss_parts = torch.empty((n_cols,), dtype=torch.float64, device=device)
    grad = torch.empty((lay.size,), dtype=torch.float32, device=device)
    loss = torch.empty((), dtype=torch.float32, device=device)
    scale = float(np.float32(1.0 / (n_frames * total * 3)))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fourd_loss_grad_launch(
            packed.data_ptr(), seeds.data_ptr(), n_frames, ctypes.addressof(table),
            cfg.width, cfg.height, cfg.samples, cfg.reflections_amount,
            float(np.float32(cfg.small_indent)), float(np.float32(cfg.light_coefficient)),
            target.data_ptr(), scale, grad_parts.data_ptr(), loss_parts.data_ptr(),
            grad.data_ptr(), loss.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"value-and-grad kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return loss, grad


def loss_and_grad_cuda(packed: torch.Tensor, like_scene: Scene, like_camera: Camera,
                       cfg: RenderConfig, seed, target):
    """(loss, (P,) gradient) of the packed CUDA vector by one kernel
    launch; a vector on another device raises."""
    renderer.check_supported(cfg)
    lay = params.layout(like_scene, like_camera)
    target = torch.as_tensor(target, dtype=torch.float32, device=packed.device).contiguous()
    words, _ = renderer.seed_words(seed)
    return launch_loss_grad(packed.detach().contiguous(), lay, cfg,
                            seed_tensor(words, packed.device), target)


def loss_and_grad_packed(packed: torch.Tensor, like_scene: Scene, like_camera: Camera,
                         cfg: RenderConfig, seed, target):
    """(loss, (P,) gradient) of the packed vector: the plain version for a
    CPU vector, the kernel for a CUDA one."""
    if packed.device.type == "cpu":
        return loss_and_grad_plain(packed, like_scene, like_camera, cfg, seed, target)
    if packed.device.type != "cuda":
        raise ValueError(f"the value-and-grad path takes CPU or CUDA tensors, got {packed.device}")
    return loss_and_grad_cuda(packed, like_scene, like_camera, cfg, seed, target)


def render_loss_and_grad_kernel(scene: Scene, camera: Camera, cfg: RenderConfig, seed, target):
    """(loss, (grad_scene, grad_camera)) of ``image_loss`` at a fixed
    seed, the gradients shaped like the scene and the camera."""
    packed = params.pack(scene, camera)
    loss, grad = loss_and_grad_packed(packed, scene, camera, cfg, seed, target)
    return loss, params.unpack(grad, scene, camera)


def make_packed_loss_and_grad(scene: Scene, camera: Camera, cfg: RenderConfig):
    """Packed-space loss and gradient for a training loop over the scene:
    returns ``(fn, scene_vec0, unpack)`` with

    * ``fn(scene_vec, seed, target) -> (loss, grad_scene_vec)``; the
      camera rides along as a constant;
    * ``scene_vec0`` the scene's slice of the packed vector;
    * ``unpack(scene_vec) -> Scene``.
    """
    renderer.check_supported(cfg)
    packed = params.pack(scene, camera).detach()
    n = params.n_scene(scene)
    cam_vec = packed[n:]

    def fn(scene_vec, seed, target):
        full = torch.cat([scene_vec.detach(), cam_vec])
        loss, grad = loss_and_grad_packed(full, scene, camera, cfg, seed, target)
        return loss, grad[:n]

    def unpack(scene_vec):
        return params.unpack(torch.cat([scene_vec, cam_vec]), scene, camera)[0]

    return fn, packed[:n].clone(), unpack
