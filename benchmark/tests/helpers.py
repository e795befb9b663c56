"""What the benchmark's tests share: a cell cut to a size the CPU holds,
and the card fixture's check."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import spec  # noqa: E402

TINY_SIZES = ((16, 8), (8, 6))  # (width, height) of the main and the additional windows
CELLS = ("room.render3", "room.train4", "tiger.render3", "tiger.train4")


def tiny(config: dict, **over) -> dict:
    """``config`` at a size the CPU holds: 2 samples, small windows."""
    windows = [dict(w, width=width, height=height)
               for w, (width, height) in zip(config["windows"], TINY_SIZES)]
    return dict(config, samples=2, windows=windows, **over)


def tiny_cell(name: str, root=ROOT, **over):
    cell = spec.load_cell(name, root)
    cell.config = tiny(cell.config, **over)
    return cell


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
