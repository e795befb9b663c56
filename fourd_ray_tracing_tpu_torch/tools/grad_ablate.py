"""Attribute the value-and-grad kernel K4's time between its stages with the
pass-budget variants K8 (csrc/ablate.cu).

Counterpart of the JAX package's tools/grad_ablate.py (``build``,
``main``). K4 runs, per pixel, pass 1 (the sample loop), the tone map and
the masked MSE, the loss's light cotangent, then the pixel sweep and the
fixed-order parameter reduction (csrc/adjoint.cuh). K8 runs K4's own code
and stops after pass 1 (``acc``), after the loss (``loss``) or after the
cotangent (``vjp``). Timing the three beside K4 splits K4's time:

    pass1 = acc, tone_map_loss = loss - acc, cotangent = vjp - loss,
    sweep_reduction = K4 - vjp

One JSON line per variant (mode, ms, grays_per_s, value at seed 1), then
the split. Defaults: room_with_sphere, the bench camera, 1280x720, 8 spp,
4 bounces, light_coefficient 0.12, a zero target; CUDA events around
``--calls`` launches (4) per round, ``--rounds`` rounds (3), the median
round. Like the JAX tool (grad_ablate.py:153-163) it runs them under
the frozen static hints (diff.with_frozen_hints), the production
configuration.

    python -m fourd_ray_tracing_tpu_torch.tools.grad_ablate [width height samples bounces]
    python -m fourd_ray_tracing_tpu_torch.tools.grad_ablate 32 16 2 2 --device cpu --rounds 1 --calls 1
"""
from __future__ import annotations

import statistics
import sys

import numpy as np
import torch

from fourd_ray_tracing_tpu_torch import diff
from fourd_ray_tracing_tpu_torch.app import resolve_device
from fourd_ray_tracing_tpu_torch.models import library, params, renderer
from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig
from fourd_ray_tracing_tpu_torch.ops.cuda import ablate, gradkernel
from fourd_ray_tracing_tpu_torch.ops.cuda.megakernel import seed_tensor
from fourd_ray_tracing_tpu_torch.tools import common

TIMED = (*ablate.MODES, "k4")
MAX_SEED = 1024  # the timed seeds, premade on the card for K4's (1,) seed words


def build(scene, camera, cfg: RenderConfig, target, mode: str):
    """``fn(seed) -> value`` of one variant of the scene on its device:
    K8 ``mode`` (acc, loss, vjp: the unscaled sum), or ``"k4"``, the
    production K4 launch's scaled loss (its gradient computed and dropped).
    CPU tensors run the plain versions."""
    packed = params.pack(scene, camera).detach().contiguous()
    device = packed.device
    target = torch.as_tensor(target, dtype=torch.float32, device=device).contiguous()
    if mode not in TIMED:
        raise ValueError(f"mode must be one of {TIMED}, got {mode!r}")
    if device.type == "cpu":
        if mode == "k4":
            return lambda seed: gradkernel.loss_and_grad_plain(packed, scene, camera, cfg, seed,
                                                               target)[0]
        return lambda seed: ablate.variant_plain(mode, scene, camera, cfg, seed, target)
    renderer.check_supported(cfg)
    lay = params.layout(scene, camera)
    if mode == "k4":
        words = seed_tensor(np.arange(MAX_SEED), device)
        keep = params.freeze_mask(cfg, scene, lay.size, device)
        return lambda seed: gradkernel.launch_loss_grad(packed, lay, cfg, words[seed:seed + 1],
                                                        target, keep=keep)[0]
    return lambda seed: ablate.launch_variant(mode, packed, lay, cfg, seed, target)


def workload(device, width=1280, height=720, samples=8, bounces=4) -> tuple:
    """(scene, camera, cfg, target) the tool times: the room, the bench
    camera, light_coefficient 0.12, a zero target, the frozen static
    hints."""
    cfg = RenderConfig(width=width, height=height, samples=samples, reflections_amount=bounces,
                       light_coefficient=0.12, rng_mode="per_sample")
    target = torch.zeros((height, width, 3), dtype=torch.float32, device=device)
    scene = library.room_with_sphere(device)
    return scene, common.default_camera(device), diff.with_frozen_hints(cfg, scene), target


def run(device, width=1280, height=720, samples=8, bounces=4, calls=4, rounds=3) -> dict:
    """Times every variant and prints their lines and the split; returns
    {variant: ms}, {variant: value at seed 1} and the split."""
    scene, camera, cfg, target = workload(device, width, height, samples, bounces)
    rays = width * height * samples
    card = common.card(device)
    shape = f"room_with_sphere {width}x{height} {samples}spp {bounces} bounces, zero target"
    ms, values = {}, {}
    for mode in TIMED:
        value, times = common.time_seeded(build(scene, camera, cfg, target, mode), device, calls,
                                          rounds)
        values[mode] = float(value)
        ms[mode] = statistics.median(times)
        common.emit({"tool": "grad_ablate", "mode": mode, "ms": ms[mode], "ms_rounds": times,
                     "grays_per_s": rays / ms[mode] / 1e6, "value": values[mode], "shape": shape,
                     "device": str(device), "card": card,
                     "hints": common.HINTS_NOTE["grad_ablate"]})
    split = {"pass1": ms["acc"], "tone_map_loss": ms["loss"] - ms["acc"],
             "cotangent": ms["vjp"] - ms["loss"], "sweep_reduction": ms["k4"] - ms["vjp"]}
    common.emit({"tool": "grad_ablate", "k4_split_ms": split, "k4_ms": ms["k4"], "shape": shape,
                 "device": str(device), "card": card})
    return {"ms": ms, "values": values, "split_ms": split}


def main(argv=None) -> int:
    args = common.parse_tool_args(__doc__, argv, calls=4, rounds=3)
    run(resolve_device(args.device), *args.shape, calls=args.calls, rounds=args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
