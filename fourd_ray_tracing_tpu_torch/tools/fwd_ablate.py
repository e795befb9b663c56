"""Per-stage cost attribution for the forward kernel K1: variants with one
stage stubbed out or one part of the scene removed (they change the image
and serve only to time a stage by its absence).

Counterpart of the JAX package's tools/fwd_ablate.py:

  baseline          the production K1 with the static hints derived from the
                    scene (megakernel.with_hints, as the JAX tool's
                    render_light_pallas derives them), ABLATE_FPL (default
                    8) frames a launch
  sampler_const     the S^3 sampler returns (0.5, 0.5, 0.5, 0.5); the RNG
                    draws are kept
  rng_const         every uniform is 0.5 without hashing, the counter
                    unchanged (the sampler then sees constants)
  both_const        both stubs
  generic_fold      the baseline through the fold's generic instance (its
                    counts read from the table), whatever the hint pattern;
                    the same image
  unhinted          the baseline without hints: every plane a single of
                    four live components; the same image
  drop_<group>      the scene with one primitive group emptied (the port's
                    groups: spaces, spheres), unless nothing would be left;
                    its own hints
  bounces_0/1/2     reflections_amount 0, 1, 2
  baseline_recheck  the baseline again, to bound drift over the run

The stub variants launch K1 with the stubs compiled in
(megakernel.launch_forward_variant, csrc/trace.cuh kStub*); their plain
version (``plain_fn``, the CPU route) is the plain pipeline under
megakernel.stubs, which patches the renderer as the JAX tool patches its
own. Every variant times the light of ABLATE_FPL frames per launch (the
tone map, a separate elementwise pass in the port, is left out). One JSON
line per variant (grays/s: min, median, max of ``--rounds`` rounds of
``--calls`` launches, CUDA events; the hints it ran), then
``drift_check`` and ``time_delta_pct_vs_baseline``. ABLATE_SCENE picks the scene:
room_with_sphere (default) or any other of models/library.py's;
ABLATE_VIEWS the views, 1 (default, yxz) or 3 (the 3-view batch);
ABLATE_VARIANTS, a comma-separated list of names, keeps only those
variants (with baseline and baseline_recheck).

    [ABLATE_SCENE=tiger ABLATE_VIEWS=3] python -m fourd_ray_tracing_tpu_torch.tools.fwd_ablate [width height samples bounces]
    ABLATE_FPL=4 ABLATE_VARIANTS=generic_fold,unhinted python -m fourd_ray_tracing_tpu_torch.tools.fwd_ablate --rounds 8
    ABLATE_FPL=2 python -m fourd_ray_tracing_tpu_torch.tools.fwd_ablate 32 16 2 2 --device cpu --rounds 1 --calls 1
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import sys

import numpy as np

from fourd_ray_tracing_tpu_torch import camera as cam
from fourd_ray_tracing_tpu_torch.app import resolve_device
from fourd_ray_tracing_tpu_torch.models import library, params, renderer
from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig
from fourd_ray_tracing_tpu_torch.ops.cuda import megakernel
from fourd_ray_tracing_tpu_torch.tools import common

GROUPS = ("spaces", "spheres")  # the primitive groups the port renders
MAX_SEED = 1024


def fpl() -> int:
    return int(os.environ.get("ABLATE_FPL", 8))


def views() -> tuple:
    """The views ABLATE_VIEWS asks for: 1 (yxz) or 3 (camera.VIEWS_ALL)."""
    n = int(os.environ.get("ABLATE_VIEWS", 1))
    if n not in (1, 3):
        raise ValueError(f"ABLATE_VIEWS must be 1 or 3, not {n}")
    return ("yxz",) if n == 1 else tuple(cam.VIEWS_ALL)


def plain_fn(scene, camera, cfg: RenderConfig, variant: str | None = None):
    """``fn(seed)``: the plain pipeline's light of ``fpl()`` frames at seeds
    seed * fpl + arange(fpl), (F, [V,] H, W, 3), under ``variant``'s stubs
    (None: none), on the scene's device."""
    k = fpl()

    def plain(seed):
        with megakernel.stubs(variant):
            return renderer.render_light(scene, camera, cfg,
                                         np.arange(seed * k, seed * k + k, dtype=np.uint32))
    return plain


def build_fn(scene, camera, cfg: RenderConfig, variant: str | None = None):
    """``fn(seed)``: what ``plain_fn`` computes, in one K1 launch with
    ``variant``'s stubs compiled in (None: the production kernel) on the
    card; ``plain_fn`` itself on the CPU."""
    k = fpl()
    device = camera.focus.x.device
    if device.type == "cpu":
        return plain_fn(scene, camera, cfg, variant)
    renderer.check_supported(cfg)
    packed, lay = params.pack(scene, camera).detach().contiguous(), params.layout(scene, camera)
    words = megakernel.seed_tensor(np.arange(MAX_SEED * k), device)
    one_view = camera.top.x.dim() == 0

    def launch(seed):
        seeds = words[seed * k:seed * k + k]
        if variant is None:
            out = megakernel.launch_forward(packed, lay, cfg, seeds)
        else:
            out = megakernel.launch_forward_variant(variant, packed, lay, cfg, seeds)
        return out[:, 0] if one_view else out
    return launch


def variants(scene, cfg: RenderConfig) -> list:
    """(name, scene, cfg, kernel variant) of every variant, in order; each
    cfg with the static hints of its scene but ``unhinted``'s."""
    hinted = megakernel.with_hints(scene, cfg)
    out = [("baseline", scene, hinted, None)]
    out += [(name, scene, hinted, name) for name in (*megakernel.VARIANTS, megakernel.GENERIC_FOLD)]
    out.append(("unhinted", scene, cfg, None))
    for field in GROUPS:
        if not getattr(scene, field):
            continue
        emptied = scene._replace(**{field: ()})
        if any(getattr(emptied, f) for f in GROUPS):  # keep at least one primitive
            out.append((f"drop_{field}", emptied, megakernel.with_hints(emptied, cfg), None))
    out += [(f"bounces_{k}", scene, dataclasses.replace(hinted, reflections_amount=k), None)
            for k in (0, 1, 2)]
    out.append(("baseline_recheck", scene, hinted, None))
    keep = os.environ.get("ABLATE_VARIANTS")
    if keep:
        names = {"baseline", "baseline_recheck", *keep.split(",")}
        unknown = names - {v[0] for v in out}
        if unknown:
            raise ValueError(f"ABLATE_VARIANTS: no variant {sorted(unknown)}")
        out = [v for v in out if v[0] in names]
    return out


def hints_of(cfg: RenderConfig) -> str:
    """The static hints a variant ran, in words."""
    words = []
    if cfg.plane_hints is not None:
        pairs, singles = cfg.plane_pairs or ((), range(len(cfg.plane_hints)))
        words.append(f"{len(pairs)} wall pairs, {len(singles)} single planes")
    if cfg.axis_hints is not None:
        words.append("the composites' axis hints")
    return ", ".join(words) or "none"


def run(device, width=1280, height=720, samples=8, bounces=4, calls=4, rounds=4) -> dict:
    """Times every variant; prints their lines, the drift check and the
    time deltas; returns {variant: median grays/s}."""
    cfg = RenderConfig(width=width, height=height, samples=samples, reflections_amount=bounces,
                       light_coefficient=0.12, rng_mode="per_sample")
    scene_name = os.environ.get("ABLATE_SCENE", "room_with_sphere")
    scene = library.scene_by_name(scene_name, device)
    camera = common.default_camera(device, views())
    rays = width * height * samples * fpl() * len(views())
    card = common.card(device)
    rates = {}
    for name, sc, c, variant in variants(scene, cfg):
        _, times = common.time_seeded(build_fn(sc, camera, c, variant), device, calls, rounds)
        rate = [rays / t / 1e6 for t in times]  # Gray/s
        rates[name] = statistics.median(rate)
        common.emit({"tool": "fwd_ablate", "variant": name, "gray_per_s": rates[name],
                     "min": min(rate), "max": max(rate), "ms": rays / rates[name] / 1e6,
                     "scene": scene_name, "views": len(views()),
                     "frames_per_launch": fpl(), "device": str(device),
                     "card": card, "hints": f"{common.HINTS_NOTE['fwd_ablate']}: {hints_of(c)}"})
    base = rates["baseline"]
    common.emit({"tool": "fwd_ablate", "drift_check": rates["baseline_recheck"] / base - 1.0})
    common.emit({"tool": "fwd_ablate", "time_delta_pct_vs_baseline": {
        name: (base / r - 1.0) * 100.0 for name, r in rates.items() if name != "baseline"}})
    return rates


def main(argv=None) -> int:
    args = common.parse_tool_args(__doc__, argv, calls=4, rounds=4)
    run(resolve_device(args.device), *args.shape, calls=args.calls, rounds=args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
