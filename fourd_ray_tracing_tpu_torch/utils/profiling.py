"""Profiling: rays/s counters and torch.profiler trace capture.

Counterpart of fourd_ray_tracing_tpu/utils/profiling.py: ``FrameStats``
(frames, seconds, rays and the rates over them), ``Meter`` (a wall-clock
meter of render steps that waits for the device before it reads the
clock) and ``trace_capture`` (a Chrome trace of the block it wraps, the
counterpart of jax.profiler's capture; viewable in Perfetto or
chrome://tracing).
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class FrameStats:
    frames: int = 0
    seconds: float = 0.0
    rays: int = 0
    traces: int = 0  # rays * samples-weighted bounce segments upper bound

    @property
    def fps(self) -> float:
        return self.frames / self.seconds if self.seconds else 0.0

    @property
    def rays_per_s(self) -> float:
        return self.rays / self.seconds if self.seconds else 0.0

    def as_json(self) -> str:
        return json.dumps(
            {
                "frames": self.frames,
                "seconds": round(self.seconds, 6),
                "fps": round(self.fps, 3),
                "rays_per_s": round(self.rays_per_s, 1),
            }
        )


def _cuda_devices(result) -> set:
    """The CUDA devices of the tensors in ``result`` (a tensor or a
    nested tuple, list or dict of them)."""
    if isinstance(result, torch.Tensor):
        return {result.device} if result.device.type == "cuda" else set()
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (tuple, list)):
        return set().union(*(_cuda_devices(r) for r in result)) if result else set()
    return set()


class Meter:
    """Wall-clock meter for render steps; call inside a `measure` block.

    Waits for the devices of the block's result (``holder["result"]``)
    with ``torch.cuda.synchronize`` before it reads the clock, so timings
    are device time, not enqueue time; a result on the CPU is ready when
    the block ends.
    """

    def __init__(self):
        self.stats = FrameStats()

    @contextlib.contextmanager
    def measure(self, rays: int, frames: int = 1):
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            for device in _cuda_devices(holder.get("result")):
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            self.stats.frames += frames
            self.stats.seconds += dt
            self.stats.rays += rays


@contextlib.contextmanager
def trace_capture(log_dir: Optional[str]):
    """torch.profiler capture of the block: CPU ops, and the card's kernels
    when there is one, written as a Chrome trace ``trace_<pid>_<ns>.json``
    into ``log_dir``. Does nothing for an empty ``log_dir``."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
