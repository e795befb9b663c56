"""Attribute the soft-silhouette step's cost: its pieces timed alone.

Counterpart of the JAX package's tools/soft_ablate.py, at the soft bench
shape (room_with_sphere, sphere 0, 1280x720, 8 spp, 4 bounces,
light_coefficient 0.12, edge width 0.05, a zero target):

  fwd_pair   diff.render_light_pair's forward: one two-row K2 launch
  pair_vg    value and gradient of sum(pair): K2 + the two-row K5
  glue_only  tone map, coverage, blend and MSE forward and backward on
             premade light rows, in torch (no kernels)
  pair_soft  the two-dispatch pair step (K2 + two-row K5 + the glue)
  soft_full  value and gradient of diff.soft_image_loss_kernel: one K6
             launch (the fused step)

Every variant runs the frozen static hints (diff.with_frozen_hints), as
the JAX tool does. Each prints one JSON line (ms per call: median of ``--rounds`` rounds of
``--calls`` back-to-back calls, CUDA events; grays/s; the loss), and the
tool ends with ``fusion_win_ms`` = pair_soft - soft_full, with its
spread: the win of each round (the variants' rounds paired in order) and
their quartiles.

    python -m fourd_ray_tracing_tpu_torch.tools.soft_ablate [width height samples bounces]
    python -m fourd_ray_tracing_tpu_torch.tools.soft_ablate 32 16 2 2 --device cpu --rounds 1 --calls 1
"""
from __future__ import annotations

import statistics
import sys

import torch

from fourd_ray_tracing_tpu_torch import diff
from fourd_ray_tracing_tpu_torch.app import resolve_device
from fourd_ray_tracing_tpu_torch.models import library, params
from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig
from fourd_ray_tracing_tpu_torch.ops.sky import light_to_color
from fourd_ray_tracing_tpu_torch.tools import common

VARIANTS = ("fwd_pair", "pair_vg", "glue_only", "pair_soft", "soft_full")
REF, EDGE = ("spheres", 0), 0.05
SEED = 1


def leaf_copy(scene):
    """The scene with fresh leaves that require grad."""
    return params.map_leaves(lambda t: t.detach().clone().requires_grad_(True), scene)


def value_and_grad(loss: torch.Tensor, inputs) -> tuple:
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    return loss.detach(), grads


def variant_fns(scene, camera, cfg: RenderConfig, target) -> dict:
    """{variant: fn() -> (loss or light, gradients or None)}."""
    without = diff.zero_object(scene, REF)

    def glue(s, pair):
        img_w = light_to_color(pair[0], cfg.light_coefficient)
        img_wo = light_to_color(pair[1], cfg.light_coefficient)
        alpha = diff.object_coverage(diff.stop_frozen(s, cfg), REF, camera, cfg, EDGE)
        return diff._blend_loss(alpha, img_w, img_wo, target)

    def fwd_pair():
        with torch.no_grad():
            return diff.render_light_pair(scene, without, camera, cfg, SEED), None

    def pair_vg():
        s, w = leaf_copy(scene), leaf_copy(without)
        loss = torch.sum(diff.render_light_pair(s, w, camera, cfg, SEED))
        return value_and_grad(loss, [*params.tree_leaves(s), *params.tree_leaves(w)])

    pair0 = fwd_pair()[0].detach()

    def glue_only():
        s, pair = leaf_copy(scene), pair0.clone().requires_grad_(True)
        return value_and_grad(glue(s, pair), [*params.tree_leaves(s), pair])

    def pair_soft():
        s = leaf_copy(scene)
        pair = diff.render_light_pair(s, diff.zero_object(s, REF), camera, cfg, SEED)
        return value_and_grad(glue(s, pair), list(params.tree_leaves(s)))

    packed = params.pack(scene, camera).detach()

    def soft_full():
        vec = packed.clone().requires_grad_(True)
        loss = diff.soft_image_loss_kernel(vec, scene, camera, cfg, SEED, target, REF, EDGE)
        return value_and_grad(loss, [vec])

    return {"fwd_pair": fwd_pair, "pair_vg": pair_vg, "glue_only": glue_only,
            "pair_soft": pair_soft, "soft_full": soft_full}


def run(device, width=1280, height=720, samples=8, bounces=4, calls=8, rounds=30) -> dict:
    """Times the variants; prints their lines and fusion_win_ms; returns
    {variant: ms} and soft_full's loss."""
    cfg = RenderConfig(width=width, height=height, samples=samples, reflections_amount=bounces,
                       light_coefficient=0.12, rng_mode="per_sample")
    scene, camera = library.room_with_sphere(device), common.default_camera(device)
    cfg = diff.with_frozen_hints(cfg, scene)
    target = torch.zeros((height, width, 3), dtype=torch.float32, device=device)
    rays = width * height * samples
    card = common.card(device)
    fns = variant_fns(scene, camera, cfg, target)
    ms, losses, rounds_ms = {}, {}, {}
    for name in VARIANTS:
        (out, _), times = common.time_seeded(lambda _seed, fn=fns[name]: fn(), device, calls,
                                             rounds)
        value = float(out) if out.dim() == 0 else None
        ms[name], losses[name], rounds_ms[name] = statistics.median(times), value, times
        common.emit({"tool": "soft_ablate", "variant": name, "ms": ms[name], "ms_rounds": times,
                     "grays_per_s": rays / ms[name] / 1e6, "loss": value, "device": str(device),
                     "card": card, "hints": common.HINTS_NOTE["soft_ablate"]})
    win = ms["pair_soft"] - ms["soft_full"]
    by_round = [p - f for p, f in zip(rounds_ms["pair_soft"], rounds_ms["soft_full"])]
    quartiles = statistics.quantiles(by_round, n=4) if len(by_round) > 1 else by_round * 3
    common.emit({"tool": "soft_ablate", "variant": "fusion_win_ms", "ms": win,
                 "ms_rounds": by_round, "quartiles_ms": quartiles,
                 "shape": f"room_with_sphere {width}x{height} {samples}spp {bounces} bounces, "
                          f"sphere 0, edge width {EDGE}, zero target",
                 "device": str(device), "card": card})
    return {"ms": ms, "fusion_win_ms": win, "soft_full_loss": losses["soft_full"]}


def main(argv=None) -> int:
    args = common.parse_tool_args(__doc__, argv, calls=8, rounds=30)
    run(resolve_device(args.device), *args.shape, calls=args.calls, rounds=args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
