"""What the measurement tools share: their command line, the bench
camera, the card's description, and the timer.

On the card a tool times with CUDA events around back-to-back calls; on
the CPU (``--device cpu``, the plain versions) with the host clock, and
its lines then name the device "cpu": they are no measurement of the card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from fourd_ray_tracing_tpu_torch import camera as cam
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4

# What each tool runs of the static hints: the forward tool times K1 with
# the hints its entry points derive (each line names them); the training
# tools time the gradient paths in the production configuration of the JAX
# tools, the frozen static hints (diff.with_frozen_hints: K1/K2, K4-K6 and
# K8 fold with the forward's hints, the hyperplane normals' gradients
# defined zero). The JAX tools time the room, which stays every training
# tool's default.
_FROZEN = "the frozen static hints (diff.with_frozen_hints), as the JAX tool runs them"
HINTS_NOTE = {"fwd_ablate": "the static hints derived from each variant's scene",
              "grad_ablate": _FROZEN, "train_ablate": _FROZEN, "soft_ablate": _FROZEN}


SHAPE = (1280, 720, 8, 4)  # the JAX tools' width, height, samples, bounces


def add_device_flag(ap) -> None:
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default): the kernels on the card; cpu: their plain versions")


def parse_tool_args(doc: str, argv, calls: int, rounds: int) -> argparse.Namespace:
    """The attribution tools' command line: ``[W H S B] [--device]
    [--calls N] [--rounds N]``; ``shape`` is (width, height, samples,
    bounces), SHAPE by default."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("shape", nargs="*", type=int, metavar="W H S B",
                    help="width height samples bounces (default %s)" % " ".join(map(str, SHAPE)))
    add_device_flag(ap)
    ap.add_argument("--calls", type=int, default=calls, help="calls per timed round")
    ap.add_argument("--rounds", type=int, default=rounds, help="timed rounds")
    args = ap.parse_args(argv)
    if args.shape and len(args.shape) != 4:
        ap.error("give all four of width height samples bounces, or none")
    args.shape = tuple(args.shape) or SHAPE
    return args


def default_camera(device, views=("yxz",)):
    """The JAX bench's camera (bench.default_camera): focus (0, -2, 0, 0),
    angles 0, focus-to-matrix 1.5, matrix height 2."""
    orient = cam.orientation_from_angles(*cam.CameraAngles.of(0.0, 0.0, 0.0, device=device), device)
    return cam.make_camera(Vec4.of(0.0, -2.0, 0.0, 0.0, device=device), orient, 1.5, 2.0, views,
                           device)


def smi(query: str) -> str:
    """One ``nvidia-smi --query-gpu`` reading of the first card."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or "cpu"."""
    return smi("name,power.limit") if device.type == "cuda" else "cpu"


def time_ms(fn, device: torch.device, calls: int, rounds: int) -> list:
    """Milliseconds per call of ``fn``, one value per round of ``calls``
    back-to-back calls: CUDA events on the card, the host clock on the
    CPU. The caller warms up."""
    out = []
    for _ in range(rounds):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / calls)
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            out.append((time.perf_counter() - t0) * 1e3 / calls)
    return out


def time_seeded(fn, device: torch.device, calls: int, rounds: int) -> tuple:
    """(fn(1), ms per call of each round): one warm-up call at seed 1, then
    ``rounds`` rounds of ``calls`` calls at seeds 2, 3, ..., the same
    seeds for every variant a tool times."""
    first = fn(1)
    sync(device)
    seeds = iter(range(2, 2 + calls * rounds))
    return first, time_ms(lambda: fn(next(seeds)), device, calls, rounds)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def emit(obj: dict) -> dict:
    print(json.dumps(obj), flush=True)
    return obj
