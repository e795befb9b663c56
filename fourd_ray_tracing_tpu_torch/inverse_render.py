"""End-to-end inverse rendering: recover a scene parameter from a target.

Counterpart of the JAX package's tools/inverse_render.py, with the same
flags and defaults: render a target image of the lamp scene, start from a
perturbed lamp, and optimize it back with Adam, logging one JSON metrics
line every ``--log-every`` steps. ``--param glow`` recovers the lamp's
glow with the plain MSE; ``--param position`` recovers the lamp's center x
through its silhouette, with the soft-silhouette loss of the lamp
(sphere 1, edge width 0.08). ``--impl kernel`` trains through the kernels
(one K4 launch per step for glow, one K6 launch per step for position),
``--impl plain`` through torch autograd over the plain pipeline;
``--packed`` runs the packed-space loop (diff.make_packed_train_step,
hard loss only). Exits 0 when the recovered value is within ``--tol`` of
the truth.

``--mesh`` shards the steps over the ranks of a torch.distributed process
group (parallel/mesh.py: rows over every rank, one all-reduce of the loss
and gradients per step). Under torchrun it joins the group the
environment names (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``), with NCCL when every rank has a card of its own and gloo
otherwise; in a process that already joined one, that group; with
neither, a 1-rank mesh. Only rank 0 prints.

    python -m fourd_ray_tracing_tpu_torch.inverse_render --param glow --impl kernel
    python -m fourd_ray_tracing_tpu_torch.inverse_render --param position --impl kernel
    torchrun --nproc-per-node 2 -m fourd_ray_tracing_tpu_torch.inverse_render --mesh

Not ported yet, and raising: ``--freeze-hints`` (ROADMAP queue 1, item 4)
and ``--ckpt`` (item 13).
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from fourd_ray_tracing_tpu_torch import camera as cam
from fourd_ray_tracing_tpu_torch import diff
from fourd_ray_tracing_tpu_torch.app import resolve_device
from fourd_ray_tracing_tpu_torch.models import library, params
from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig
from fourd_ray_tracing_tpu_torch.models.scene import Scene, material, sphere
from fourd_ray_tracing_tpu_torch.ops.cuda.megakernel import render_image_cuda
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4
from fourd_ray_tracing_tpu_torch.parallel import mesh as pmesh
from fourd_ray_tracing_tpu_torch.utils.logging import log0, log_metrics

TRUE_GLOW, INIT_GLOW = 20.0, 8.0
TRUE_X, INIT_X = 1.4, 1.0
SOFT_SPHERE, EDGE_WIDTH = 1, 0.08  # the lamp, and the soft loss's coverage band


def make_scene(cx: float, glow: float, device) -> Scene:
    """Floor + mirror-ish sphere + optimizable lamp sphere (the
    sphere-plane-light family)."""
    base = library.sphere_plane_light(device)
    lamp = sphere((cx, 1, 0, 0), 0.5, material(glow, 0.0, (1, 1, 1), device), device)
    return base._replace(spheres=(base.spheres[0], lamp))


def only_lamp_glow(g: Scene) -> Scene:
    """The gradient filter of --param glow: every gradient but the lamp's
    glow zeroed."""
    z = params.map_leaves(torch.zeros_like, g)
    mat = z.spheres[1].material._replace(glow=g.spheres[1].material.glow)
    return z._replace(spheres=(z.spheres[0], z.spheres[1]._replace(material=mat)))


def read_glow(scene: Scene) -> float:
    return float(scene.spheres[1].material.glow.detach())


def only_lamp_center_x(g: Scene) -> Scene:
    """The gradient filter of --param position: every gradient but the
    lamp's center x zeroed."""
    z = params.map_leaves(torch.zeros_like, g)
    center = z.spheres[1].center._replace(x=g.spheres[1].center.x)
    return z._replace(spheres=(z.spheres[0], z.spheres[1]._replace(center=center)))


def read_center_x(scene: Scene) -> float:
    return float(scene.spheres[1].center.x.detach())


class Task(NamedTuple):
    """What --param recovers: its true and starting values, the default
    learning rate and tolerance, the gradient filter, the reader, and the
    lamp scene at a value of it."""

    true: float
    init: float
    lr: float
    tol: float
    param_filter: Callable
    read: Callable
    scene: Callable


def task(param: str) -> Task:
    if param == "glow":
        return Task(TRUE_GLOW, INIT_GLOW, 0.5, 2.0, only_lamp_glow, read_glow,
                    lambda glow, device: make_scene(1.0, glow, device))
    return Task(TRUE_X, INIT_X, 0.03, 0.1, only_lamp_center_x, read_center_x,
                lambda x, device: make_scene(x, TRUE_GLOW, device))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--param", choices=("glow", "position"), default="glow")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=40)
    ap.add_argument("--samples", type=int, default=2)
    ap.add_argument("--bounces", type=int, default=2)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--mesh", action="store_true",
                    help="shard the steps' rows over the ranks of the process group (torchrun's, "
                    "or one rank)")
    ap.add_argument("--impl", choices=diff.IMPLS, default="plain",
                    help="kernel = the gradient kernels (one K4 launch per step for glow, one "
                    "K6 launch per step for position, on the card); plain = torch autograd "
                    "over the plain pipeline")
    ap.add_argument("--freeze-hints", action="store_true",
                    help="not ported yet (ROADMAP queue 1, item 4)")
    ap.add_argument("--packed", action="store_true",
                    help="with --impl kernel: the packed-space loop "
                    "(diff.make_packed_train_step, Adam on the kernel's flat parameter "
                    "vector). Unlike the JAX tool's --packed, which forces the frozen "
                    "static hints, this trains without hints, with exact gradients for "
                    "every parameter; for --param glow that changes nothing, since the "
                    "gradient filter zeroes every other gradient")
    ap.add_argument("--ckpt", default=None, help="not ported yet (ROADMAP queue 1, item 13)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--tol", type=float, default=None,
                    help="success threshold on |recovered - true| (default 2.0 glow, 0.1 "
                    "position)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace, device):
    """(cfg, camera, target image, starting scene) of the run: the target
    renders the lamp at the parameter's true value through the forward
    kernel."""
    cfg = RenderConfig(width=args.width, height=args.height, samples=args.samples,
                       reflections_amount=args.bounces, rng_mode="per_sample")
    camera = cam.camera_from_state(Vec4.of(0.0, -2.0, 0.0, 0.0, device=device),
                                   cam.CameraAngles.of(0.0, 0.0, 0.0, device=device),
                                   1.5, 2.0, device=device)
    t = task(args.param)
    target = render_image_cuda(t.scene(t.true, device), camera, cfg, args.seed)
    return cfg, camera, target, t.scene(t.init, device)


def join_mesh(args: argparse.Namespace, device: torch.device):
    """(mesh, device, whether this call joined the process group) of
    ``--mesh``: the group of the environment or of the caller, or one
    rank. Under torchrun a CUDA rank takes card LOCAL_RANK (modulo the
    cards there are)."""
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    world = int(os.environ.get("WORLD_SIZE", "1"))
    backend = "nccl" if device.type == "cuda" and torch.cuda.device_count() >= world else "gloo"
    joined = not dist.is_initialized() and pmesh.initialize_distributed(backend, device)
    mesh = pmesh.make_mesh(samples=1, device=device)
    if args.height % mesh.world:
        raise SystemExit(f"--height must divide by {mesh.world} ranks")
    log0(f"mesh {mesh.rays}x{mesh.samples} backend={mesh.backend or 'none (one process)'}",
         flush=True)
    return mesh, mesh.device, joined


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.freeze_hints:
        raise NotImplementedError("--freeze-hints needs the static hints, which are not "
                                  "ported yet (ROADMAP queue 1, item 4)")
    if args.ckpt:
        raise NotImplementedError("--ckpt is not ported yet (ROADMAP queue 1, item 13)")
    if args.packed and (args.impl != "kernel" or args.param != "glow" or args.mesh):
        raise SystemExit("--packed is the kernel's hard-loss packed-space loop on one device "
                         "(use --impl kernel, --param glow, no --mesh)")

    device = resolve_device(args.device)
    mesh, joined = None, False
    if args.mesh:
        mesh, device, joined = join_mesh(args, device)
    cfg, camera, target, scene0 = setup(args, device)
    t = task(args.param)
    lr = args.lr or t.lr
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    log0(f"inverse_render param={args.param} impl={args.impl} packed={args.packed} "
         f"{cfg.width}x{cfg.height}x{cfg.samples}spp x{cfg.reflections_amount} device={name}",
         flush=True)

    if args.packed:
        step, init, unpack = diff.make_packed_train_step(cfg, lr, camera, scene0,
                                                         param_filter=t.param_filter)
        model, opt = init(scene0)
        for k in range(args.steps):
            loss = step(model, opt, args.seed, target)
            if k % args.log_every == 0 or k == args.steps - 1:
                log_metrics(k, {"loss": loss, "value": t.read(unpack(model))})
        scene = unpack(model)
    else:
        soft = SOFT_SPHERE if args.param == "position" else None
        step, init = diff.make_train_step(cfg, lr, camera, param_filter=t.param_filter,
                                          impl=args.impl, soft_sphere_index=soft,
                                          edge_width=EDGE_WIDTH, mesh=mesh)
        scene, opt = init(scene0)
        for k in range(args.steps):
            scene, opt, loss, metrics = step(scene, opt, args.seed, target)
            if k % args.log_every == 0 or k == args.steps - 1:
                log_metrics(k, {**metrics, "value": t.read(scene)})
    err = abs(t.read(scene) - t.true)
    log0(f"recovered {args.param}={t.read(scene):.4f} (true {t.true}, err {err:.4f})", flush=True)
    tol = args.tol if args.tol is not None else t.tol
    if joined:
        dist.destroy_process_group()
    return 0 if err < tol else 1


if __name__ == "__main__":
    sys.exit(main())
