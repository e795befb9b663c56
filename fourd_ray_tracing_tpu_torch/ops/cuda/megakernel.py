"""Wrapper of the forward megakernel (csrc/megakernel.cu).

Counterpart of fourd_ray_tracing_tpu/ops/pallas/megakernel.py's
render_light_pallas / render_image_pallas (K1),
render_light_pallas_multi (K2: F same-structure scenes at one seed, one
params row per frame) and their sharded forms
sharded_render_light_pallas[_multi] / sharded_render_image_pallas (K3:
here one launch per rank on its block of image rows, parallel/mesh.py).
Tensors on the CPU go through the plain torch pipeline
(models/renderer.py); tensors on a CUDA device go through the kernel, or
the call raises. ``LAUNCHES`` counts kernel launches, so a run can show
that its main path went through the kernel; ``ROW_LAUNCHES`` counts those
of them that read per-frame params rows (K2), ``SHARD_LAUNCHES`` those
that render a block of rows smaller than the image (K3).
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
from fourd_ray_tracing_tpu_torch.parallel import mesh as pmesh

LAUNCHES = 0
ROW_LAUNCHES = 0
SHARD_LAUNCHES = 0


def _device_of(scene: Scene, camera: Camera) -> torch.device:
    devices = {t.device for t in params.leaves(scene, camera)}
    if len(devices) != 1:
        raise ValueError(f"scene and camera tensors lie on several devices: {devices}")
    return devices.pop()


def seed_tensor(words, device) -> torch.Tensor:
    """uint32 seed words as the kernels' (F,) int32 tensor on ``device``."""
    return torch.from_numpy(np.asarray(words, np.uint32).view(np.int32)).to(device)


def launch_rows(cfg: RenderConfig, rows) -> tuple:
    """(row0, n_rows) of a launch over ``rows`` = (row0, n_rows), or over
    the whole image for None; raises for rows outside the image."""
    row0, n_rows = rows if rows is not None else (0, cfg.height)
    if not (0 <= row0 and 0 < n_rows and row0 + n_rows <= cfg.height):
        raise ValueError(f"rows [{row0}, {row0 + n_rows}) are not a block of {cfg.height} rows")
    return row0, n_rows


def launch_forward(packed: torch.Tensor, lay: params.Layout, cfg: RenderConfig,
                   seeds: torch.Tensor, rows=None) -> torch.Tensor:
    """One kernel launch: (F, V, n_rows, W, 3) float32 light of image rows
    ``rows`` = (row0, n_rows) (all H by default) from the packed params
    and (F,) int32 seed words, on their CUDA device. ``packed`` is (P,),
    one scene rendered at every seed (K1), or (F, P), frame f rendering
    row f at seeds[f] (K2). A block of rows is bitwise those rows of the
    whole image (K3)."""
    global LAUNCHES, ROW_LAUNCHES, SHARD_LAUNCHES
    row0, n_rows = launch_rows(cfg, rows)
    if packed.device.type != "cuda" or seeds.device != packed.device:
        raise ValueError(f"kernel inputs must share one CUDA device, got {packed.device}, {seeds.device}")
    if (packed.dtype != torch.float32 or packed.dim() not in (1, 2)
            or not packed.is_contiguous()):
        raise ValueError("packed params must be a contiguous (P,) or (F, P) float32 tensor")
    if packed.shape[-1] != lay.size:
        raise ValueError(f"packed params hold {packed.shape[-1]} floats, layout expects {lay.size}")
    if seeds.dtype != torch.int32 or seeds.dim() != 1 or not seeds.is_contiguous():
        raise ValueError("seeds must be a contiguous (F,) int32 tensor of uint32 words")
    multi = packed.dim() == 2
    if multi and packed.shape[0] != seeds.numel():
        raise ValueError(f"{packed.shape[0]} params rows for {seeds.numel()} seeds")
    lib = build.load()
    n_frames = seeds.numel()
    out = torch.empty((n_frames, lay.n_views, n_rows, cfg.width, 3),
                      dtype=torch.float32, device=packed.device)
    table = (ctypes.c_int * len(lay))(*lay)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fourd_forward_launch(
            packed.data_ptr(), lay.size if multi else 0, seeds.data_ptr(), n_frames,
            ctypes.addressof(table),
            cfg.width, cfg.height, row0, n_rows, cfg.samples, cfg.reflections_amount,
            float(np.float32(cfg.small_indent)), out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"forward kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    ROW_LAUNCHES += int(multi)
    SHARD_LAUNCHES += int(n_rows < cfg.height)
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


# --- K3: the row-sharded launches ----------------------------------------------

def sharded_render_light_cuda(scene: Scene, camera: Camera, cfg: RenderConfig, seeds,
                              mesh: pmesh.Mesh, gather: bool = True) -> torch.Tensor:
    """``render_light_cuda`` row-sharded over the mesh's ranks (K3): each
    rank makes one launch on its block of rows (``mesh.kernel_rows``: a
    mesh with no samples axis), bitwise those rows of the single launch.
    ``gather`` (the default) returns the whole light on every rank,
    ``gather=False`` the rank's block. Tensors on the CPU run the plain pipeline on the rank's rows;
    tensors off the mesh's device raise."""
    device = _device_of(scene, camera)
    row0, n_rows = mesh.kernel_rows(cfg.height, device)
    if device.type == "cpu":
        out = renderer.render_light(scene, camera, cfg, seeds, slice(row0, row0 + n_rows))
    else:
        renderer.check_supported(cfg)
        words, batched = renderer.seed_words(seeds)
        out = launch_forward(params.pack(scene, camera), params.layout(scene, camera), cfg,
                             seed_tensor(words, device), (row0, n_rows))
        if camera.top.x.dim() == 0:
            out = out[:, 0]
        out = out if batched else out[0]
    return pmesh.gather_rows(out, mesh, cfg.height) if gather else out


def sharded_render_image_cuda(scene: Scene, camera: Camera, cfg: RenderConfig, seeds,
                              mesh: pmesh.Mesh, gather: bool = True) -> torch.Tensor:
    """``sharded_render_light_cuda`` tone-mapped (plain torch)."""
    image = light_to_color(sharded_render_light_cuda(scene, camera, cfg, seeds, mesh, gather=False),
                           cfg.light_coefficient)
    return pmesh.gather_rows(image, mesh, cfg.height) if gather else image


def sharded_render_light_cuda_multi(scenes, camera: Camera, cfg: RenderConfig, seed,
                                    mesh: pmesh.Mesh, gather: bool = True) -> torch.Tensor:
    """``render_light_cuda_multi`` (K2) row-sharded over the mesh's ranks:
    one launch per rank on its block of rows, (F, [V,] rows, W, 3) (the
    forward of ``diff.render_light_pair`` with a mesh)."""
    device = _device_of(scenes[0], camera)
    row0, n_rows = mesh.kernel_rows(cfg.height, device)
    if device.type == "cpu":
        out = torch.stack([renderer.render_light(s, camera, cfg, seed, slice(row0, row0 + n_rows))
                           for s in scenes])
    else:
        renderer.check_supported(cfg)
        words, batched = renderer.seed_words(seed)
        if batched:
            raise ValueError("the multi-scene render takes one scalar seed")
        out = launch_forward(params.stack_rows(scenes, camera), params.layout(scenes[0], camera),
                             cfg, seed_tensor(words * len(scenes), device), (row0, n_rows))
        out = out[:, 0] if camera.top.x.dim() == 0 else out
    return pmesh.gather_rows(out, mesh, cfg.height) if gather else out
