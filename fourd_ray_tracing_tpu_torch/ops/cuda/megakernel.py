"""Wrapper of the forward megakernel (csrc/megakernel.cu).

Counterpart of fourd_ray_tracing_tpu/ops/pallas/megakernel.py's
render_light_pallas / render_image_pallas (K1) and
render_light_pallas_multi (K2: F same-structure scenes at one seed, one
params row per frame). Tensors on the CPU go through the plain torch
pipeline (models/renderer.py); tensors on a CUDA device go through the
kernel, or the call raises. ``LAUNCHES`` counts kernel launches, so a run
can show that its main path went through the kernel; ``ROW_LAUNCHES``
counts those of them that read per-frame params rows (K2).
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
from fourd_ray_tracing_tpu_torch.ops.sky import light_to_color

LAUNCHES = 0
ROW_LAUNCHES = 0


def _device_of(scene: Scene, camera: Camera) -> torch.device:
    devices = {t.device for t in params.leaves(scene, camera)}
    if len(devices) != 1:
        raise ValueError(f"scene and camera tensors lie on several devices: {devices}")
    return devices.pop()


def seed_tensor(words, device) -> torch.Tensor:
    """uint32 seed words as the kernels' (F,) int32 tensor on ``device``."""
    return torch.from_numpy(np.asarray(words, np.uint32).view(np.int32)).to(device)


def launch_forward(packed: torch.Tensor, lay: params.Layout, cfg: RenderConfig,
                   seeds: torch.Tensor) -> torch.Tensor:
    """One kernel launch: (F, V, H, W, 3) float32 light from the packed
    params and (F,) int32 seed words, on their CUDA device. ``packed`` is
    (P,), one scene rendered at every seed (K1), or (F, P), frame f
    rendering row f at seeds[f] (K2)."""
    global LAUNCHES, ROW_LAUNCHES
    if packed.device.type != "cuda" or seeds.device != packed.device:
        raise ValueError(f"kernel inputs must share one CUDA device, got {packed.device}, {seeds.device}")
    if (packed.dtype != torch.float32 or packed.dim() not in (1, 2)
            or not packed.is_contiguous()):
        raise ValueError("packed params must be a contiguous (P,) or (F, P) float32 tensor")
    if packed.shape[-1] != lay.size:
        raise ValueError(f"packed params hold {packed.shape[-1]} floats, layout expects {lay.size}")
    if seeds.dtype != torch.int32 or seeds.dim() != 1 or not seeds.is_contiguous():
        raise ValueError("seeds must be a contiguous (F,) int32 tensor of uint32 words")
    rows = packed.dim() == 2
    if rows and packed.shape[0] != seeds.numel():
        raise ValueError(f"{packed.shape[0]} params rows for {seeds.numel()} seeds")
    lib = build.load()
    n_frames = seeds.numel()
    out = torch.empty((n_frames, lay.n_views, cfg.height, cfg.width, 3),
                      dtype=torch.float32, device=packed.device)
    table = (ctypes.c_int * len(lay))(*lay)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fourd_forward_launch(
            packed.data_ptr(), lay.size if rows else 0, seeds.data_ptr(), n_frames,
            ctypes.addressof(table),
            cfg.width, cfg.height, cfg.samples, cfg.reflections_amount,
            float(np.float32(cfg.small_indent)), out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"forward kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    ROW_LAUNCHES += int(rows)
    return out


def render_light_cuda(scene: Scene, camera: Camera, cfg: RenderConfig, seeds) -> torch.Tensor:
    """Sample-averaged light: (H, W, 3), (V, H, W, 3), or with a (K,)
    seed vector (K, H, W, 3) / (K, V, H, W, 3) from ONE launch; frame k
    is bitwise the launch with the scalar seed seeds[k]."""
    device = _device_of(scene, camera)
    if device.type == "cpu":
        return renderer.render_light(scene, camera, cfg, seeds)
    if device.type != "cuda":
        raise ValueError(f"render_light_cuda takes CPU or CUDA tensors, got {device}")
    renderer.check_supported(cfg)
    lay = params.layout(scene, camera)
    words, batched = renderer.seed_words(seeds)
    out = launch_forward(params.pack(scene, camera), lay, cfg, seed_tensor(words, device))
    if camera.top.x.dim() == 0:
        out = out[:, 0]
    return out if batched else out[0]


def render_image_cuda(scene: Scene, camera: Camera, cfg: RenderConfig, seeds) -> torch.Tensor:
    """Tone-mapped image through the kernel; the tone map is plain torch."""
    return light_to_color(render_light_cuda(scene, camera, cfg, seeds), cfg.light_coefficient)


def render_light_cuda_multi(scenes, camera: Camera, cfg: RenderConfig, seed) -> torch.Tensor:
    """Mean light of F same-structure scenes at one scalar seed, stacked on
    a leading scene axis: (F, H, W, 3) or (F, V, H, W, 3) from ONE launch
    (K2); row f is bitwise ``render_light_cuda(scenes[f], ...)``."""
    device = _device_of(scenes[0], camera)
    if device.type == "cpu":
        return torch.stack([renderer.render_light(s, camera, cfg, seed) for s in scenes])
    if device.type != "cuda":
        raise ValueError(f"render_light_cuda_multi takes CPU or CUDA tensors, got {device}")
    renderer.check_supported(cfg)
    words, batched = renderer.seed_words(seed)
    if batched:
        raise ValueError("the multi-scene render takes one scalar seed")
    rows = params.stack_rows(scenes, camera)
    out = launch_forward(rows, params.layout(scenes[0], camera), cfg,
                         seed_tensor(words * len(scenes), device))
    return out[:, 0] if camera.top.x.dim() == 0 else out
