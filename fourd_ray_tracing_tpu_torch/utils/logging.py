"""Structured per-step logging (counterpart of the JAX package's
utils/logging.py:22-39).

The port runs as one process, so process 0 is the only one and prints:
``log0`` is print(), ``log_metrics`` one JSON line per step.
"""
from __future__ import annotations

import json
import sys
from typing import Any, Mapping


def log0(*args, file=None, **kwargs) -> None:
    """print() on process 0 (the only process of the port)."""
    print(*args, file=file or sys.stdout, **kwargs)


def log_metrics(step: int, metrics: Mapping[str, Any], prefix: str = "") -> None:
    """One JSON line per step: loss / grad_norm / anything tensor-valued
    (converted to float)."""
    payload = {"step": int(step)}
    for k, v in metrics.items():
        try:
            payload[prefix + k] = float(v)
        except (TypeError, ValueError):
            payload[prefix + k] = str(v)
    print(json.dumps(payload), flush=True)
