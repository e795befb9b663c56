"""Structured per-step logging (counterpart of the JAX package's
utils/logging.py:22-39): ``log0`` is print() on process 0 (rank 0 of the
torch.distributed process group, or the only process),
``log_metrics`` one JSON line per step from it.
"""
from __future__ import annotations

import json
import sys
from typing import Any, Mapping

import torch.distributed as dist


def is_rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def log0(*args, file=None, **kwargs) -> None:
    """print() on process 0."""
    if is_rank0():
        print(*args, file=file or sys.stdout, **kwargs)


def log_metrics(step: int, metrics: Mapping[str, Any], prefix: str = "") -> None:
    """One JSON line per step from process 0: loss / grad_norm / anything
    tensor-valued (converted to float)."""
    if not is_rank0():
        return
    payload = {"step": int(step)}
    for k, v in metrics.items():
        try:
            payload[prefix + k] = float(v)
        except (TypeError, ValueError):
            payload[prefix + k] = str(v)
    print(json.dumps(payload), flush=True)
