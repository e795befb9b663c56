"""The compile check and the multi-device dry run of the port.

* ``entry`` gives the flagship forward, the room with a sphere at 128x64,
  2 samples and 4 bounces, and its arguments: on the card one K1 launch
  with the static hints (``megakernel.render_image_cuda``), on the CPU,
  when the caller asks for it, the plain pipeline.
* ``dryrun_multichip`` runs one inverse-rendering training session on a
  mesh of ranks, fresh processes through ``multihost_run.spawn``: one
  plain ``make_train_step`` step, two hard kernel-route steps (K4 sharded),
  one soft kernel-route step on sphere 0 (K6 sharded) and the kernel
  route's image (K3), each held against one process without a mesh, with
  every rank's kernel launches checked.
* ``dryrun_multihost`` runs the measurement of ``multihost_run`` in a
  subprocess of its own and checks its figures.

The counterparts of the repo's root entry file (``entry`` :14,
``dryrun_multichip`` :41, ``dryrun_multihost`` :129, ``__main__`` :160).
Ranks share one card under gloo; NCCL, taken when there is a card for
every rank, gives each its own.

    python -m fourd_ray_tracing_tpu_torch.dryrun              # the card, 4 ranks
    python -m fourd_ray_tracing_tpu_torch.dryrun --device cpu --ranks 4
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from fourd_ray_tracing_tpu_torch import camera as cam
from fourd_ray_tracing_tpu_torch import multihost_run
from fourd_ray_tracing_tpu_torch.models import library
from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig
from fourd_ray_tracing_tpu_torch.ops.cuda import megakernel
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4

ROOT = Path(__file__).resolve().parents[1]


def _device(device) -> torch.device:
    """The card unless the caller asks for the CPU; no card raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' for the CPU")
    return device


# The flagship forward's configuration (the JAX package's, BASELINE.md's
# room with a sphere at full bounce depth); the RNG stream is the default's.
ENTRY = RenderConfig(width=128, height=64, samples=2, reflections_amount=4,
                     light_coefficient=0.12)


def entry(device=None):
    """``(forward, (scene, camera, seed))``: the flagship forward
    ``forward(scene, camera, seed) -> (64, 128, 3)`` image of the room with
    a sphere under ``ENTRY``, seed 12345. On the card (the default) one K1
    launch with the static hints; the plain pipeline when ``device`` is the
    CPU."""
    device = _device(device)
    camera = cam.camera_from_state(Vec4.of(0.0, -2.0, 0.0, 0.0, device=device),
                                   cam.CameraAngles.of(0.0, 0.0, 0.0, device=device), 1.5, 2.0,
                                   device=device)

    def forward(scene, camera, seed):
        return megakernel.render_image_cuda(scene, camera, ENTRY, seed)

    return forward, (library.room_with_sphere(device), camera, np.uint32(12345))


def multichip_work(n_ranks: int) -> tuple:
    """The dry run's mesh and work (__graft_entry__.py:56-77): a samples
    axis of 2 when the count is even, 4 rows and 2 samples per rank of
    each axis, 16 columns, 2 bounces, per-sample streams, sphere_plane_light,
    Adam at 1e-2, a zero target, the soft loss on sphere 0."""
    rays, samples = multihost_run.mesh_shape(n_ranks)
    work = multihost_run.Work(scene="sphere_plane_light", width=16, height=4 * rays,
                              samples=2 * samples, bounces=2, light_coefficient=1.0, lr=1e-2)
    return (rays, samples), work


def _expected_launches(world: int, cuda: bool) -> dict:
    """Each item's kernel launches on one rank of ``world`` (1: the process
    without a mesh): K4 twice and K6 once for the stages, K1 once for the
    image, each on a block of rows when there are several ranks. None on
    the CPU."""
    if not cuda:
        return {"dryrun": {}, "image": {}}
    shard = world > 1
    return {"dryrun": {"k4": 2, "k6": 1, **({"k4_shard": 2, "k6_shard": 1} if shard else {})},
            "image": {"k1": 1, **({"k1_shard": 1} if shard else {})}}


def dryrun_multichip(n_ranks: int, device="cuda") -> dict:
    """The multi-device dry run on ``n_ranks`` fresh processes: the stages
    of ``multihost_run``'s ``dryrun`` item and the kernel route's image on
    the mesh of ``multichip_work``, against the same in this process
    without a mesh (the image bitwise, losses and parameters within
    ``multihost_run.TOL``), every rank's launches checked. Returns the
    runner's summary; raises RuntimeError when a check fails."""
    dev = _device(device).type
    shape, work = multichip_work(n_ranks)
    summary = multihost_run.run(n_ranks, multihost_run.backend_for(dev, n_ranks), dev, work,
                                ("dryrun", "image"), mesh=shape)
    if not summary["ok"]:
        raise RuntimeError(f"the dry run disagrees with one process: {summary['items']}")
    launches = {"ranks": summary["launches_per_rank"], "single": summary["single_launches"]}
    want = {"ranks": [_expected_launches(n_ranks, dev == "cuda")] * n_ranks,
            "single": _expected_launches(1, dev == "cuda")}
    if launches != want:
        raise RuntimeError(f"the dry run's launches {launches}, expected {want}")
    return summary


def dryrun_multihost(n_processes: int = 2, device="cuda") -> dict:
    """``multihost_run --nprocs n_processes --frames 1`` in a subprocess:
    its line must hold ``nprocs`` and a finite ``mean_light`` and
    ``grad_norm`` (__graft_entry__.py:129-157). Returns the line; raises
    RuntimeError when the run fails or a figure is wrong."""
    dev = _device(device).type
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p)}
    cmd = [sys.executable, "-m", "fourd_ray_tracing_tpu_torch.multihost_run",
           "--nprocs", str(n_processes), "--frames", "1", "--device", dev,
           "--backend", multihost_run.backend_for(dev, n_processes)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=ROOT, env=env)
    if proc.returncode != 0:
        raise RuntimeError(f"multihost_run exited {proc.returncode}: {proc.stderr[-4000:]}")
    result = json.loads([line for line in proc.stdout.splitlines() if line.startswith("{")][-1])
    if result["nprocs"] != n_processes or not (math.isfinite(result["mean_light"])
                                               and math.isfinite(result["grad_norm"])):
        raise RuntimeError(f"multihost_run's figures are wrong: {result}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args(argv)
    forward, example = entry(args.device)
    image = forward(*example)
    if not bool(torch.isfinite(image).all()):
        raise SystemExit("entry: non-finite image")
    print(json.dumps({"entry": "ok", "shape": list(image.shape), "device": args.device}),
          flush=True)
    summary = dryrun_multichip(args.ranks, args.device)
    print(json.dumps({"dryrun_multichip": "ok", "nprocs": args.ranks, "mesh": summary["mesh"],
                      "backend": summary["backend"], "items": summary["items"],
                      "launches_per_rank": summary["launches_per_rank"]}), flush=True)
    result = dryrun_multihost(2, args.device)
    print(json.dumps({"dryrun_multihost": "ok", **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
