"""Attribute the training step's time between its stages: a ladder of
variants that each add one stage.

Counterpart of the JAX package's tools/train_ablate.py, on the port's own
functions, at the grad workload (room_with_sphere, 1280x720, 8 spp, 4
bounces, light_coefficient 0.12, a zero target):

  fwd        one one-frame K1 launch on the packed params (the floor)
  pass1      K8 ``vjp``: K4's pass 1, loss and cotangent, no sweep (the
             counterpart of the JAX DEBUG_SKIP_PASS2)
  kernel     gradkernel.launch_loss_grad: K4 + its parameter sums
  loss_grad  gradkernel.render_loss_and_grad_kernel: + packing, the seed's
             copy to the card, and unpacking the gradient
  vg         diff.image_loss_kernel forward and backward (ImageLoss)
  step       one diff.make_train_step(impl="kernel") step (torch Adam over
             the scene's leaves)
  scan4      four make_packed_train_step steps issued back to back, one
             sync (the port has no scan; per-step figures)

Every stage runs the frozen static hints (diff.with_frozen_hints), as the
JAX tool does. Each stage prints one JSON line: ms per step (median of ``--rounds``
rounds of ``--calls`` steps, CUDA events), grays/s, and its factor
against the previous stage; then the deltas against ``fwd``.

    python -m fourd_ray_tracing_tpu_torch.tools.train_ablate [width height samples bounces]
    python -m fourd_ray_tracing_tpu_torch.tools.train_ablate 32 16 2 2 --device cpu --rounds 1 --calls 1
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
from fourd_ray_tracing_tpu_torch.ops.cuda import ablate, gradkernel, megakernel
from fourd_ray_tracing_tpu_torch.tools import common

STAGES = ("fwd", "pass1", "kernel", "loss_grad", "vg", "step", "scan4")
SCAN = 4
MAX_SEED = 1024


def stage_fns(scene, camera, cfg: RenderConfig, target) -> dict:
    """{stage: fn(seed)} on the scene's device (the plain versions on the
    CPU); scan4's fn runs SCAN steps."""
    device = target.device
    packed = params.pack(scene, camera).detach().contiguous()
    lay = params.layout(scene, camera)
    cuda = device.type == "cuda"
    words = megakernel.seed_tensor(np.arange(MAX_SEED), device) if cuda else None
    keep = params.freeze_mask(cfg, scene, lay.size, device)

    def fwd(seed):
        if cuda:
            return megakernel.launch_forward(packed, lay, cfg, words[seed:seed + 1])
        return renderer.render_light(scene, camera, cfg, seed)

    def pass1(seed):
        if cuda:
            return ablate.launch_variant("vjp", packed, lay, cfg, seed, target)
        return ablate.variant_plain("vjp", scene, camera, cfg, seed, target)

    def kernel(seed):
        if cuda:
            return gradkernel.launch_loss_grad(packed, lay, cfg, words[seed:seed + 1], target,
                                               keep=keep)
        return gradkernel.loss_and_grad_plain(packed, scene, camera, cfg, seed, target)

    def loss_grad(seed):
        return gradkernel.render_loss_and_grad_kernel(scene, camera, cfg, seed, target)

    def vg(seed):
        vec = packed.clone().requires_grad_(True)
        loss = diff.image_loss_kernel(vec, scene, camera, cfg, seed, target)
        loss.backward()
        return loss.detach(), vec.grad

    step, init = diff.make_train_step(cfg, 1e-3, camera, impl="kernel")
    state = list(init(scene))

    def one_step(seed):
        state[0], state[1], loss, _ = step(state[0], state[1], seed, target)
        return loss

    pstep, pinit, _ = diff.make_packed_train_step(cfg, 1e-3, camera, scene)
    model, opt = pinit(scene)

    def scan4(seed):
        return [pstep(model, opt, seed * SCAN + k, target) for k in range(SCAN)][-1]

    return {"fwd": fwd, "pass1": pass1, "kernel": kernel, "loss_grad": loss_grad, "vg": vg,
            "step": one_step, "scan4": scan4}


def run(device, width=1280, height=720, samples=8, bounces=4, calls=8, rounds=5) -> dict:
    """Times the ladder; prints one line per stage and the deltas; returns
    {stage: ms per step}."""
    cfg = RenderConfig(width=width, height=height, samples=samples, reflections_amount=bounces,
                       light_coefficient=0.12, rng_mode="per_sample")
    scene, camera = library.room_with_sphere(device), common.default_camera(device)
    cfg = diff.with_frozen_hints(cfg, scene)
    target = torch.zeros((height, width, 3), dtype=torch.float32, device=device)
    rays = width * height * samples
    card = common.card(device)
    fns = stage_fns(scene, camera, cfg, target)
    ms, prev = {}, None
    for name in STAGES:
        per_call = SCAN if name == "scan4" else 1
        _, times = common.time_seeded(fns[name], device, max(1, calls // per_call), rounds)
        ms[name] = statistics.median(times) / per_call
        line = {"tool": "train_ablate", "stage": name, "ms": ms[name],
                "ms_rounds": [t / per_call for t in times], "grays_per_s": rays / ms[name] / 1e6,
                "x_vs_prev": None if prev is None else ms[name] / ms[prev],
                "device": str(device), "card": card, "hints": common.HINTS_NOTE["train_ablate"]}
        if name == "scan4":
            line["note"] = (f"no scan in the port: {SCAN} packed steps issued back to back, one "
                            "sync; ms per step")
        common.emit(line)
        prev = name
    common.emit({"tool": "train_ablate", "delta_ms_vs_fwd": {k: v - ms["fwd"] for k, v in ms.items()},
                 "shape": f"room_with_sphere {width}x{height} {samples}spp {bounces} bounces",
                 "device": str(device), "card": card})
    return ms


def main(argv=None) -> int:
    args = common.parse_tool_args(__doc__, argv, calls=8, rounds=5)
    run(resolve_device(args.device), *args.shape, calls=args.calls, rounds=args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
