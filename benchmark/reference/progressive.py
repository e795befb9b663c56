"""The engine's progressive accumulation, worked out again: the seed
sequence of a deterministic engine (``seed ^= draw`` from a numpy
Generator seeded 0) and the blend ``old + (new - old) * (1 / n)``."""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def frame_seeds(start_seed: int, n_frames: int) -> list:
    """The first ``n_frames`` frame seeds of a deterministic engine whose
    seed starts at ``start_seed``."""
    rng = np.random.default_rng(0)
    seed, out = start_seed & MASK32, []
    for _ in range(n_frames):
        seed = (seed ^ int(rng.integers(0, 2**32))) & MASK32
        out.append(seed)
    return out


def blend(acc: torch.Tensor, frames: torch.Tensor, first_frame_number: int) -> torch.Tensor:
    """``acc`` after blending ``frames`` (F, ...) in order, the first with
    frame number ``first_frame_number``: a new tensor."""
    acc = acc.clone()
    for k in range(frames.shape[0]):
        part = float(np.float32(1.0 / float(first_frame_number + k)))
        acc = acc + (frames[k] - acc) * part
    return acc
