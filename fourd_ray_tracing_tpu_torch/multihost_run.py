"""Multi-process runner of the row-sharded path, on one machine.

Counterpart of the JAX package's tools/multihost_run.py. ``--nprocs``
worker processes (torch.multiprocessing, start method "spawn") join one
process group through a ``file://`` rendezvous in a temporary directory
(no fixed port), build a mesh of every rank (parallel/mesh.py), and run:

* ``image``: the sharded image through the kernel route
  (``pmesh.sharded_renderer(impl="kernel")``: one K1 launch per rank on
  its rows; the plain pipeline on those rows for CPU tensors);
* ``kernel_hard``, ``kernel_soft``: ``--steps`` steps of
  ``diff.make_train_step(impl="kernel", mesh=...)``, the hard loss (one K4
  launch per rank and step) and the soft loss of the room's sphere 0 (one
  K6 launch per rank and step);
* ``pair``: the gradient of a seeded random cotangent against the soft
  pair (``diff.render_light_pair`` with the mesh: one K2 launch forward and
  one two-row K5 launch backward per rank, whose wrapper all-reduces the
  gradient).

Every item runs the production configuration, the frozen static hints
(diff.with_frozen_hints). The kernel route takes any (rays, samples) mesh:
its launches split the rows over every rank (``Mesh.kernel_rows``).

The parent runs the same work in one process without a mesh, compares
(the image bitwise; losses and parameters within ``TOL``), and prints one
JSON line; it exits non-zero when a rank fails or a result disagrees.

``--frames N`` runs the JAX tool's measurement instead (``measure``, one
rank per device): sphere_plane_light at 32x16x4spp x2 bounces (the shape
flags change it), seed 7, on
a mesh whose samples axis of 2 straddles the ranks (``mesh_shape``), rank
0's line holding the plain route's ``mean_light`` and ``grad_norm``, K3's
``kernel_mean_light``, the sharded K4's ``kernel_loss`` and
``kernel_grad_norm``, and the rays/s of both forwards over N timed rounds
(CUDA events on the card). ``--scaling`` runs it at 1 rank, then 2, and
prints their ratio (``scaling``): the harness of the >= 90% scaling
target. Ranks that share one card make the ratio a plumbing check.

    python -m fourd_ray_tracing_tpu_torch.multihost_run --nprocs 2 --backend gloo
    python -m fourd_ray_tracing_tpu_torch.multihost_run --nprocs 2 --device cpu
    python -m fourd_ray_tracing_tpu_torch.multihost_run --nprocs 2 --frames 4
    python -m fourd_ray_tracing_tpu_torch.multihost_run --scaling --device cpu

The workers run on the card (``--device cuda``, the default: several
ranks share it under gloo, NCCL takes one card per rank) unless
``--device cpu`` asks for the CPU.

The workers live in this module, so a spawned child imports torch and
this package alone. ``spawn`` and ``run_items`` also run other work: a
list of (rays, samples, Work, items) tasks, each on its own mesh, and the
items of ``ITEMS`` (``dryrun``: the training stages of dryrun.py). Every
process group times out after 60 s (parallel/mesh.py TIMEOUT), and
``spawn`` kills every worker and raises when one fails or the run
outlasts ``timeout``.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import tempfile
import time
from dataclasses import asdict, dataclass, replace
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from fourd_ray_tracing_tpu_torch import camera as cam
from fourd_ray_tracing_tpu_torch import diff, inverse_render
from fourd_ray_tracing_tpu_torch.models import library, params, renderer
from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig
from fourd_ray_tracing_tpu_torch.ops.cuda import build, gradkernel, megakernel
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4
from fourd_ray_tracing_tpu_torch.parallel import mesh as pmesh

# Losses and parameters after the steps within rtol of the single process
# (the sums over ranks reassociate), a parameter's relative to the larger
# of it and one Adam step (lr): a parameter that Adam moves across zero
# has no scale of its own; gradients within a mixed-scale relative error
# (|a - b| / max(|b|, 1e-3 max|b| + 1e-8)).
TOL = dict(loss_rtol=1e-5, params_rtol=1e-5, grad_mixed_rel=1e-4)
DEFAULT_ITEMS = ("image", "kernel_hard", "kernel_soft", "pair")


@dataclass(frozen=True)
class Work:
    """What the items render and train: a library scene, a camera at the
    origin looking down y with ``views``, the render shape, the seeds (one,
    or a frame vector for the images), a zero target, Adam's learning
    rate, the soft loss's object and edge width, and the measurement's
    timed rounds."""

    scene: str = "room_with_sphere"
    width: int = 32
    height: int = 16
    samples: int = 4
    bounces: int = 2
    light_coefficient: float = 0.7
    views: tuple = ("yxz",)
    seeds: tuple = (7,)
    steps: int = 1
    lr: float = 1e-3
    soft_ref: tuple = ("spheres", 0)
    edge_width: float = 0.05
    frames: int = 2

    def cfg(self) -> RenderConfig:
        return RenderConfig(width=self.width, height=self.height, samples=self.samples,
                            reflections_amount=self.bounces, rng_mode="per_sample",
                            light_coefficient=self.light_coefficient)

    def seed(self):
        return self.seeds[0] if len(self.seeds) == 1 else np.asarray(self.seeds, np.uint32)


# The measurement's work, the JAX tool's (tools/multihost_run.py:41, :65-74):
# sphere_plane_light at 32x16x4spp x2 bounces, seed 7, no hints, the light
# untouched by the tone map.
MEASURE = Work(scene="sphere_plane_light", width=32, height=16, samples=4, bounces=2,
               light_coefficient=1.0)


def mesh_shape(nprocs: int) -> tuple:
    """(rays, samples) of ``nprocs`` ranks with a samples axis of 2, which
    straddles the ranks, when the count is even; (nprocs, 1) otherwise (the
    JAX package's rule, __graft_entry__.py:56-61)."""
    return (nprocs // 2, 2) if nprocs % 2 == 0 else (nprocs, 1)


def backend_for(device: str, nprocs: int) -> str:
    """NCCL when every rank has a card of its own, gloo otherwise (the CPU,
    or ranks sharing a card)."""
    return "nccl" if device == "cuda" and torch.cuda.device_count() >= nprocs else "gloo"


def _setup(w: Work, device):
    """(scene, camera, cfg, zero target) of the work; the cfg in the
    production configuration, the frozen static hints."""
    scene = library.SCENES[w.scene](device)
    orient = cam.orientation_from_angles(*cam.CameraAngles.of(0.0, 0.0, 0.0, device=device),
                                         device)
    camera = cam.make_camera(Vec4.of(0.0, -2.0, 0.0, 0.0, device=device), orient, 1.5, 2.0,
                             w.views, device)
    shape = (w.height, w.width, 3) if len(w.views) == 1 else (len(w.views), w.height, w.width, 3)
    return scene, camera, diff.with_frozen_hints(w.cfg(), scene), torch.zeros(shape, device=device)


def _counts() -> dict:
    return {"k1": megakernel.LAUNCHES, "k1_shard": megakernel.SHARD_LAUNCHES,
            "k2": megakernel.ROW_LAUNCHES, "k4": gradkernel.LAUNCHES,
            "k4_shard": gradkernel.SHARD_LAUNCHES, "k5": gradkernel.VJP_LAUNCHES,
            "k5_shard": gradkernel.SHARD_VJP_LAUNCHES, "k6": gradkernel.SOFT_LAUNCHES,
            "k6_shard": gradkernel.SHARD_SOFT_LAUNCHES, "k4_hinted": gradkernel.HINTED_LAUNCHES,
            "k5_hinted": gradkernel.HINTED_VJP_LAUNCHES,
            "k6_hinted": gradkernel.HINTED_SOFT_LAUNCHES}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _image(mesh, w: Work, device, impl: str) -> dict:
    scene, camera, cfg, _ = _setup(w, device)
    if mesh is not None:
        img = pmesh.sharded_renderer(cfg, mesh, impl=impl)(scene, camera, w.seed())
    elif impl == "kernel":
        img = megakernel.render_image_cuda(scene, camera, cfg, w.seed())
    else:
        img = renderer.render_image(scene, camera, cfg, w.seed())
    return {"image": img.cpu().numpy()}


def _train(mesh, w: Work, device, impl: str, soft: bool) -> dict:
    """``w.steps`` steps of make_train_step: the losses, the last step's
    (all-reduced) gradient and the parameters after it, flat, and the
    milliseconds of each step (host clock, synchronized)."""
    scene, camera, cfg, target = _setup(w, device)
    step, init = diff.make_train_step(cfg, w.lr, camera, impl=impl, mesh=mesh,
                                      soft_object_ref=w.soft_ref if soft else None,
                                      edge_width=w.edge_width)
    scene, opt = init(scene)
    losses, ms = [], []
    for k in range(w.steps):
        _sync(device)
        t0 = time.perf_counter()
        scene, opt, loss, _ = step(scene, opt, w.seeds[0] + k, target)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    leaves = list(params.tree_leaves(scene))
    return {"losses": np.asarray(losses), "grad": _flat(t.grad for t in leaves),
            "params": _flat(leaves), "ms": ms}


def _flat(tensors) -> np.ndarray:
    return torch.cat([t.detach().reshape(-1) for t in tensors]).cpu().numpy()


def _pair(mesh, w: Work, device) -> dict:
    """The gradient of sum(render_light_pair(scene, zero_object(scene)) *
    cot) w.r.t. the packed vector, cot seeded normal noise over the whole
    image; with a mesh, each rank's rows, the whole image's gradient."""
    scene, camera, cfg, target = _setup(w, device)
    cot = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (2, *target.shape)).astype(np.float32)).to(device)
    vec = params.pack(scene, camera).detach().requires_grad_(True)
    s, c = params.unpack(vec, scene, camera)
    light = diff.render_light_pair(s, diff.zero_object(s, w.soft_ref), c, cfg, w.seeds[0], mesh)
    if mesh is not None:
        row0, n_rows = mesh.kernel_rows(cfg.height, device)
        cot = cot[..., row0:row0 + n_rows, :, :]
    (grad,) = torch.autograd.grad(torch.sum(light * cot), vec)
    return {"grad": grad.cpu().numpy()}


def _dryrun(mesh, w: Work, device) -> dict:
    """The training stages of the JAX package's multi-device dry run
    (__graft_entry__.py:80-113), the cfg without hints as there: one plain
    make_train_step step at seed 7, then from its scene two kernel-route
    hard steps (K4) at seeds 11 and 12 and one kernel-route soft step (K6)
    on ``w.soft_ref`` at seed 13, each with a fresh Adam. Returns the four
    losses, and each stage's last gradient and parameters, flat."""
    scene, camera, _, target = _setup(w, device)
    cfg = w.cfg()
    losses, grads, values = [], [], []

    def stage(start, seeds, **kw):
        step, init = diff.make_train_step(cfg, w.lr, camera, mesh=mesh,
                                          edge_width=w.edge_width, **kw)
        state, opt = init(start)
        for seed in seeds:
            state, opt, loss, _ = step(state, opt, seed, target)
            losses.append(float(loss))
        leaves = list(params.tree_leaves(state))
        grads.append(_flat(t.grad for t in leaves))
        values.append(_flat(leaves))
        return params.map_leaves(torch.Tensor.detach, state)

    base = stage(scene, [7])
    stage(base, [11, 12], impl="kernel")
    stage(base, [13], impl="kernel", soft_object_ref=w.soft_ref)
    return {"losses": np.asarray(losses), "grad": np.concatenate(grads),
            "params": np.concatenate(values)}


def _rate(fn, w: Work, device) -> float:
    """Rays per second of ``fn(seed)`` over ``w.frames`` rounds at seeds 2..
    after a warm-up at seed 1 (tools/multihost_run.py:139-147): CUDA
    events on the card, the host clock on the CPU."""
    fn(1)
    _sync(device)
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for k in range(w.frames):
            fn(k + 2)
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) * 1e-3
    else:
        t0 = time.perf_counter()
        for k in range(w.frames):
            fn(k + 2)
        seconds = time.perf_counter() - t0
    return w.width * w.height * w.samples * len(w.views) * w.frames / seconds


def _measure(mesh, w: Work, device) -> dict:
    """The JAX tool's worker figures (tools/multihost_run.py:93-161) on the
    mesh, the cfg without hints: the mean light and the norm of the scene's
    gradient of it through the plain route; the mean light through K3 and
    K4's loss and scene gradient norm against a zero target, sharded; and
    the rays per second of both forwards."""
    scene, camera, _, target = _setup(w, device)
    cfg = w.cfg()
    seed = w.seeds[0]

    def mean_light(s):
        return torch.mean(pmesh.sharded_render_light(scene, camera, cfg, s, mesh))

    def kernel_mean_light(s):
        return torch.mean(megakernel.sharded_render_light_cuda(scene, camera, cfg, s, mesh))

    leaves = params.map_leaves(
        lambda t: t.detach().to(torch.float32).clone().requires_grad_(True), scene)
    block = pmesh.sharded_render_light(leaves, camera, cfg, seed, mesh, gather=False)
    (torch.sum(block) / target.numel()).backward()
    grads = [t.grad if t.grad is not None else torch.zeros_like(t)
             for t in params.tree_leaves(leaves)]
    grads = pmesh.all_reduce_sum(grads, mesh)
    packed = params.pack(scene, camera)
    k_loss, k_grad = gradkernel.sharded_loss_and_grad(packed, scene, camera, cfg, seed, target,
                                                      mesh)
    k_scene = k_grad[:params.n_scene(scene)]
    return {"figures": {
        "mean_light": float(mean_light(seed)),
        "grad_norm": float(torch.sqrt(sum(torch.sum(g * g) for g in grads))),
        "kernel_mean_light": float(kernel_mean_light(seed)),
        "kernel_loss": float(k_loss),
        "kernel_grad_norm": float(torch.sqrt(torch.sum(k_scene * k_scene))),
        "rays_per_s": _rate(mean_light, w, device),
        "kernel_rays_per_s": _rate(kernel_mean_light, w, device)}}


def _inverse_render(mesh, w: Work, device, impl: str) -> dict:
    """inverse_render --param glow --freeze-hints at its defaults (--mesh
    with a mesh): its exit code."""
    argv = ["--impl", impl, "--device", device.type, "--freeze-hints",
            *(["--mesh"] if mesh is not None else [])]
    return {"rc": inverse_render.main(argv)}


ITEMS = {
    "image": lambda mesh, w, d: _image(mesh, w, d, "kernel"),
    "plain_image": lambda mesh, w, d: _image(mesh, w, d, "plain"),
    "kernel_hard": lambda mesh, w, d: _train(mesh, w, d, "kernel", soft=False),
    "kernel_soft": lambda mesh, w, d: _train(mesh, w, d, "kernel", soft=True),
    "plain_hard": lambda mesh, w, d: _train(mesh, w, d, "plain", soft=False),
    "plain_soft": lambda mesh, w, d: _train(mesh, w, d, "plain", soft=True),
    "pair": lambda mesh, w, d: _pair(mesh, w, d),
    "inverse_render": lambda mesh, w, d: _inverse_render(mesh, w, d, "kernel"),
    "dryrun": _dryrun,
    "measure": _measure,
}


def run_items(mesh, w: Work, items, device) -> dict:
    """Each item of ``ITEMS`` on the mesh (None: one process, no mesh),
    with the kernel launches it made."""
    device = torch.device(device)
    out = {}
    for name in items:
        before = _counts()
        out[name] = ITEMS[name](mesh, w, device)
        out[name]["launches"] = {k: v - before[k] for k, v in _counts().items() if v > before[k]}
    return out


def _rank_device(device: str, backend: str, rank: int) -> torch.device:
    """A rank's device: the CPU, its own card under NCCL, or under gloo
    the card of its rank modulo the cards there are (several ranks on
    one card)."""
    if device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank if backend == "nccl" else rank % torch.cuda.device_count())


def _child(rank: int, nprocs: int, backend: str, device: str, init_method: str, out_dir: str,
           tasks) -> None:
    if device == "cpu":
        torch.set_num_threads(1)
    dev = _rank_device(device, backend, rank)
    pmesh.initialize_distributed(backend, dev, init_method=init_method, rank=rank,
                                 world_size=nprocs)
    results = []
    for rays, samples, work, items in tasks:
        mesh = pmesh.make_mesh(rays, samples, dev)
        results.append(run_items(mesh, work, items, dev))
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


def spawn(tasks, nprocs: int, backend: str = "gloo", device: str = "cpu",
          timeout: float = 600.0) -> list:
    """Run ``tasks`` (a list of (rays, samples, Work, items)) on
    ``nprocs`` worker processes; returns each rank's list of
    ``run_items`` results. A worker that exits non-zero, or a run longer
    than ``timeout`` seconds, kills every worker and raises."""
    if device == "cuda":
        build.build()  # once, before the workers: they load it
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="fourd_mesh_") as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = [ctx.Process(target=_child, args=(r, nprocs, backend, device, init, tmp, tasks))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    raise RuntimeError(f"sharded run failed: worker exit codes "
                                       f"{[p.exitcode for p in procs]} after "
                                       f"{timeout - deadline + time.monotonic():.0f} s")
                time.sleep(0.05)
            codes = [p.exitcode for p in procs]
            if any(codes):
                raise RuntimeError(f"sharded run failed: worker exit codes {codes}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        results = []
        for r in range(nprocs):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
    return results


def mixed_rel(a: np.ndarray, b: np.ndarray) -> float:
    scale = np.maximum(np.abs(b), 1e-3 * np.abs(b).max() + 1e-8)
    return float((np.abs(a - b) / scale).max())


def compare(sharded: dict, single: dict, lr: float) -> dict:
    """Each item's largest errors against the single process, and whether
    it is within ``TOL`` (images: bitwise); ``lr`` is the steps' learning
    rate."""
    out = {}
    for name, res in sharded.items():
        ref = single[name]
        if "image" in res:
            ok = bool(np.array_equal(res["image"], ref["image"]))
            err = float(np.abs(res["image"] - ref["image"]).max())
            out[name] = {"bitwise": ok, "max_abs_err": err, "ok": ok}
        elif "losses" in res:
            loss_rel = float(np.max(np.abs(res["losses"] - ref["losses"]) / np.abs(ref["losses"])))
            p_err = np.abs(res["params"] - ref["params"])
            params_rel = float(np.max(p_err / np.maximum(np.abs(ref["params"]), lr)))
            grad_rel = mixed_rel(res["grad"], ref["grad"])
            out[name] = {"loss_rel": loss_rel, "params_rel": params_rel, "grad_mixed_rel": grad_rel,
                         "max_abs_err": float(p_err.max()),
                         "ok": (loss_rel <= TOL["loss_rtol"]
                                and params_rel <= TOL["params_rtol"]
                                and grad_rel <= TOL["grad_mixed_rel"])}
        elif "grad" in res:
            rel = mixed_rel(res["grad"], ref["grad"])
            err = float(np.abs(res["grad"] - ref["grad"]).max())
            out[name] = {"grad_mixed_rel": rel, "max_abs_err": err,
                         "ok": rel <= TOL["grad_mixed_rel"]}
        else:
            out[name] = {"rc": res["rc"], "ok": res["rc"] == 0}
    return out


def run(nprocs: int, backend: str, device: str, work: Work, items=DEFAULT_ITEMS,
        timeout: float = 600.0, mesh=None) -> dict:
    """The runner: ``items`` on ``nprocs`` ranks on a (rays, samples)
    ``mesh`` ((nprocs, 1) by default), the same in this process without a
    mesh, and their comparison. Returns the summary (one JSON object)."""
    rays, samples = mesh or (nprocs, 1)
    ranks = spawn([(rays, samples, work, items)], nprocs, backend, device, timeout)
    sharded = [r[0] for r in ranks]
    single = run_items(None, work, items, "cpu" if device == "cpu" else "cuda")
    per_rank = [compare(s, single, work.lr) for s in sharded]
    summary = {
        "mode": "sharded_vs_single", "nprocs": nprocs, "mesh": [rays, samples],
        "backend": backend, "device": device,
        "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
        "work": asdict(work), "items": per_rank[0],
        "ok": all(all(v["ok"] for v in c.values()) for c in per_rank),
        "launches_per_rank": [{n: s[n]["launches"] for n in items} for s in sharded],
        "single_launches": {n: single[n]["launches"] for n in items},
        "step_ms_per_rank": [{n: s[n]["ms"] for n in items if "ms" in s[n]} for s in sharded],
        "single_step_ms": {n: single[n]["ms"] for n in items if "ms" in single[n]},
    }
    return summary


def measure(nprocs: int, backend: str, device: str, work: Work = MEASURE,
            timeout: float = 600.0) -> dict:
    """The JAX tool's measurement (tools/multihost_run.py:164-195) with one
    rank per device: ``work``'s figures on ``nprocs`` ranks on the mesh of
    ``mesh_shape(nprocs)``, rank 0's as one JSON object, with every rank's
    kernel launches."""
    rays, samples = mesh_shape(nprocs)
    ranks = spawn([(rays, samples, work, ["measure"])], nprocs, backend, device, timeout)
    return {"mode": "worker0", "nprocs": nprocs, "mesh": [rays, samples], "backend": backend,
            "device": device, "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
            "frames": work.frames, **ranks[0][0]["measure"]["figures"],
            "launches_per_rank": [r[0]["measure"]["launches"] for r in ranks]}


def scaling(backend: str, device: str, work: Work = MEASURE, timeout: float = 600.0) -> list:
    """The measurement at 1 rank, then 2 (tools/multihost_run.py:198-234):
    both runs' lines and the scaling line, the 2-rank rays/s over the
    1-rank's. Ranks that share one card (or the CPU's cores) make the ratio
    a plumbing check, and the line says so."""
    runs = {n: measure(n, backend, device, work, timeout) for n in (1, 2)}

    def ratio(key):
        return runs[2][key] / runs[1][key] if runs[1][key] else None

    shared = device == "cpu" or torch.cuda.device_count() < 2
    note = ("one card per rank" if not shared else
            f"both ranks share {'the CPU' if device == 'cpu' else 'one card'}: a plumbing "
            "check, not a scaling figure")
    return [runs[1], runs[2], {
        "mode": "scaling", "rays_per_s_1proc": runs[1]["rays_per_s"],
        "rays_per_s_2proc": runs[2]["rays_per_s"], "scaling_efficiency": ratio("rays_per_s"),
        "kernel_rays_per_s_1proc": runs[1]["kernel_rays_per_s"],
        "kernel_rays_per_s_2proc": runs[2]["kernel_rays_per_s"],
        "kernel_scaling_efficiency": ratio("kernel_rays_per_s"),
        "backend": backend, "device": device, "kind": runs[1]["kind"], "note": note}]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--backend", choices=pmesh.BACKENDS, default="gloo")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--width", type=int, default=Work.width)
    ap.add_argument("--height", type=int, default=Work.height)
    ap.add_argument("--samples", type=int, default=Work.samples)
    ap.add_argument("--bounces", type=int, default=Work.bounces)
    ap.add_argument("--steps", type=int, default=Work.steps)
    ap.add_argument("--frames", type=int, default=None,
                    help="run the measurement instead of the comparison: the JAX tool's "
                         "figures on sphere_plane_light, rays/s over this many timed rounds")
    ap.add_argument("--scaling", action="store_true",
                    help="the measurement at 1 and 2 ranks (2 timed rounds unless --frames)")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    shape = dict(width=args.width, height=args.height, samples=args.samples, bounces=args.bounces)
    if args.scaling or args.frames is not None:
        work = replace(MEASURE, frames=args.frames or MEASURE.frames, **shape)
        lines = (scaling(args.backend, args.device, work, args.timeout) if args.scaling else
                 [measure(args.nprocs, args.backend, args.device, work, args.timeout)])
        for line in lines:
            print(json.dumps(line), flush=True)
        return 0
    summary = run(args.nprocs, args.backend, args.device, Work(steps=args.steps, **shape),
                  timeout=args.timeout)
    print(json.dumps(summary), flush=True)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
