"""Wrapper of the value-and-grad kernel's pass-budget variants K8
(csrc/ablate.cu, ablatemodes.cu), with their plain version.

Counterpart of the JAX package's tools/grad_ablate.py ``_variant_kernel``
and ``build``: K4's pass-1 math stopped at ``mode`` (``MODES``), summed
over the image's pixels, unscaled:

* ``acc``: the light summed over samples, its three channels, per pixel;
* ``loss``: the squared difference of the tone-mapped image and the target,
  K4's loss before its scale (1 / (V H W 3));
* ``vjp``: the same loss, with the loss's light cotangent computed and
  folded in as 0 * (sum of it), so that the kernel pays for it.

``launch_variant`` is one kernel launch on CUDA tensors; ``variant_plain``
the same sums over the plain pipeline (models/renderer.py), in double
(tools/grad_ablate.py's ``build`` routes by device). Under the
freeze_hints contract (diff.with_frozen_hints, as the JAX tool runs them,
grad_ablate.py:153-163) the variants fold with the static hints, as K4's
pass 1 does, and so does their plain version; a scene with composite
primitives folds as K4's pass 1 folds it, hinted or not.

Like the JAX ``_variant_kernel``, which draws per-sample streams whatever
``cfg.rng_mode`` says (grad_ablate.py:80-87), K8 renders per-sample streams
in every configuration: a sequential one runs as its per-sample
configuration (``per_sample``). The production configuration
(megakernel.production) launches fourd_ablate_launch (csrc/ablate.cu); any
other, the kepler and newton samplers, the literal spec and trig folds and
a hypercube without generators, fourd_ablate_modes (csrc/ablatemodes.cu),
with the descriptor of gradkernel.launch_words. ``LAUNCHES`` counts kernel
launches, ``HINTED_LAUNCHES`` those with static hints, and
``CONFIG_LAUNCHES`` every launch by the configuration that ran
(megakernel.launch_config of ``per_sample(cfg)``).
"""
from __future__ import annotations

import ctypes
from dataclasses import replace

import numpy as np
import torch

from fourd_ray_tracing_tpu_torch.camera import Camera
from fourd_ray_tracing_tpu_torch.models import params, renderer
from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig
from fourd_ray_tracing_tpu_torch.models.scene import Scene
from fourd_ray_tracing_tpu_torch.ops.cuda import build, gradkernel
from fourd_ray_tracing_tpu_torch.ops.cuda.megakernel import hinted, launch_config, launch_rows
from fourd_ray_tracing_tpu_torch.ops.sky import light_to_color

LAUNCHES = HINTED_LAUNCHES = 0
CONFIG_LAUNCHES: dict = {}  # by megakernel.launch_config of what ran
MODES = ("acc", "loss", "vjp")


def per_sample(cfg: RenderConfig) -> RenderConfig:
    """The configuration K8 renders for ``cfg``: its per-sample streams."""
    return replace(cfg, rng_mode="per_sample")


def variant_plain(mode: str, scene: Scene, camera: Camera, cfg: RenderConfig, seed: int,
                  target=None, rows=None) -> torch.Tensor:
    """The plain version of the K8 ``mode`` in ``per_sample(cfg)``: ()
    float64. ``acc`` sums the
    per-pixel channel sums of the light summed over samples
    (renderer.render_light_tile); ``loss`` and ``vjp`` sum
    (render_image - target)^2 over the image, in double, as
    gradkernel.loss_and_grad_plain does before its division by the count
    (the vjp variant's extra term is zero). ``rows`` = (row0, n_rows) sums
    over those image rows only, ``target`` their block."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    cfg = per_sample(cfg)
    renderer.check_trainable(cfg)
    seed = gradkernel._scalar_seed(seed)
    light_sum = renderer.render_light_tile(scene, camera, cfg, seed, *launch_rows(cfg, rows))
    if mode == "acc":
        return (light_sum[..., 0] + light_sum[..., 1] + light_sum[..., 2]).double().sum()
    image = light_to_color(light_sum * renderer.inv_samples(cfg), cfg.light_coefficient)
    target = torch.as_tensor(target, dtype=torch.float32, device=image.device)
    return torch.sum(((image - target.reshape(image.shape)) ** 2).double())


def launch_variant(mode: str, packed: torch.Tensor, lay: params.Layout, cfg: RenderConfig,
                   seed: int, target: torch.Tensor) -> torch.Tensor:
    """One K8 launch over the whole image: () float32, the unscaled sum of
    ``mode``'s per-pixel values, from the packed (P,) params, one uint32
    seed and the (V, H, W, 3) or (H, W, 3) float32 target, on their CUDA
    device (``acc`` does not read the target); ``cfg``'s per-sample
    configuration, through the production instances or the modes ones."""
    global LAUNCHES, HINTED_LAUNCHES
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    cfg = per_sample(cfg)
    gradkernel._check_launch(packed, lay, cfg, target)
    if packed.dim() != 1:
        raise ValueError("the variant kernel takes one (P,) params vector")
    if target.numel() != lay.n_views * cfg.height * cfg.width * 3 or target.shape[-1] != 3:
        raise ValueError(f"target must hold {lay.n_views} x {cfg.height} x {cfg.width} x 3 "
                         f"values, got {tuple(target.shape)}")
    hints = gradkernel.launch_words(lay, cfg)
    modes = gradkernel._modes(cfg, lay)
    lib = build.load()
    table = (ctypes.c_int * len(lay))(*lay)
    n_cols = gradkernel._scratch_cols(lib, table, cfg, cfg.height)
    device = packed.device
    loss_parts = torch.empty((n_cols,), dtype=torch.float64, device=device)
    value = torch.empty((), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (MODES.index(mode), packed.data_ptr(), seed & 0xFFFFFFFF, ctypes.addressof(table),
                cfg.width, cfg.height, cfg.samples, cfg.reflections_amount,
                float(np.float32(cfg.small_indent)), float(np.float32(cfg.light_coefficient)),
                target.data_ptr(), loss_parts.data_ptr(), value.data_ptr(),
                None if hints is None else ctypes.addressof(hints), stream)
        if modes is None:
            err = lib.fourd_ablate_launch(*args)
        else:
            err = lib.fourd_ablate_modes(*modes, *args)
    if err != 0:
        raise RuntimeError(f"variant kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    HINTED_LAUNCHES += int(hinted(cfg))
    key = launch_config(cfg, lay)
    CONFIG_LAUNCHES[key] = CONFIG_LAUNCHES.get(key, 0) + 1
    return value
