"""Checkpoint / resume of accumulation buffers and training state.

Counterpart of the JAX package's utils/checkpoint.py, without orbax: a
checkpoint is a directory holding ``state.pt``, written by ``torch.save``
(a nested dict or list of tensors and plain Python values; numpy arrays
and scalars are converted to tensors), read back by ``torch.load`` with
``weights_only=True`` onto the CPU, and the versioned sidecar
``fourd_ckpt_meta.json``. The sidecar turns the two ways a restore can go
wrong into actionable errors:

* **structure drift**: it records a fingerprint of the state's keys,
  shapes and dtypes, and ``restore`` compares it with the target's before
  it reads anything (the scene or the optimizer changed since the save);
* **format drift**: a checkpoint of a newer format version is refused by
  name instead of misread.

``save_train_state``/``restore_train_state`` hold the packed training
loop (diff.make_packed_train_step): ``PackedScene.scene_vec``, the
``torch.optim.Adam`` state dict and the step counter. Adam makes its
state at its first step, so a fresh optimizer's state dict lacks it;
``adam_state_like`` gives it a stepped one's structure to restore
against.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Any, Iterator, Tuple

import numpy as np
import torch

FORMAT_VERSION = 1
STATE = "state.pt"
_META = "fourd_ckpt_meta.json"


def _saveable(state: Any) -> Any:
    """``state`` with numpy arrays and scalars as tensors (``weights_only``
    loading refuses numpy) and tensors detached."""
    if isinstance(state, dict):
        return {k: _saveable(v) for k, v in state.items()}
    if isinstance(state, list):
        return [_saveable(v) for v in state]
    if isinstance(state, tuple):
        return tuple(_saveable(v) for v in state)
    if isinstance(state, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(state))
    if isinstance(state, torch.Tensor):
        return state.detach()
    return state


def _leaves(state: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(state, dict):
        for key in sorted(state, key=str):
            yield from _leaves(state[key], f"{prefix}/{key}")
    elif isinstance(state, (list, tuple)):
        for i, value in enumerate(state):
            yield from _leaves(value, f"{prefix}[{i}]")
    else:
        yield prefix, state


def _describe(leaf: Any) -> str:
    if isinstance(leaf, torch.Tensor):
        return f"{tuple(leaf.shape)}:{str(leaf.dtype).removeprefix('torch.')}"
    return type(leaf).__name__


def _fingerprint(state: Any) -> Tuple[str, int]:
    """(fingerprint, leaf count) of the state's keys, shapes and dtypes."""
    leaves = list(_leaves(_saveable(state)))
    desc = "|".join(f"{path}:{_describe(leaf)}" for path, leaf in leaves)
    return hashlib.sha256(desc.encode()).hexdigest()[:16], len(leaves)


def save(path: str | Path, state: Any) -> None:
    """Save a state (accumulation buffers, frame counter, optimizer
    state...) and its versioned structure sidecar into directory ``path``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / (STATE + ".tmp")
    torch.save(_saveable(state), tmp)
    os.replace(tmp, path / STATE)
    fingerprint, n_leaves = _fingerprint(state)
    (path / _META).write_text(json.dumps({
        "format_version": FORMAT_VERSION,
        "structure": fingerprint,
        "n_leaves": n_leaves,
    }))


def restore(path: str | Path, like: Any) -> Any:
    """The state saved by ``save`` at ``path``, its tensors on the CPU.
    ``like`` has the structure expected; a checkpoint of another structure
    or of a newer format raises ValueError saying which."""
    path = Path(path)
    meta_path = path / _META
    if meta_path.exists():
        meta = json.loads(meta_path.read_text())
        if meta.get("format_version", 1) > FORMAT_VERSION:
            raise ValueError(
                f"checkpoint at {path} has format_version {meta['format_version']}, newer than "
                f"this build's {FORMAT_VERSION}: upgrade the package to restore it")
        want, n_like = _fingerprint(like)
        if meta.get("structure") not in (None, want):
            raise ValueError(
                f"checkpoint structure mismatch at {path}: saved fingerprint "
                f"{meta['structure']} ({meta.get('n_leaves')} leaves) != restore target {want} "
                f"({n_like} leaves). The scene/optimizer shape changed since the save: rebuild "
                "the matching state (same scene structure, same optimizer) or start fresh.")
    return torch.load(path / STATE, map_location="cpu", weights_only=True)


def save_train_state(path: str | Path, scene_vec: torch.Tensor, opt_state: dict,
                     step: int) -> None:
    """Checkpoint the packed training loop (diff.make_packed_train_step):
    the scene's packed vector, the optimizer's ``state_dict()`` and the
    step counter."""
    save(path, {"scene_vec": scene_vec, "opt_state": opt_state, "step": int(step)})


def adam_state_like(opt_state: dict, parameters) -> dict:
    """The structure of a stepped ``torch.optim.Adam``'s ``state_dict()``,
    for ``restore``'s ``like``: ``opt_state`` (a fresh optimizer's, whose
    state is still empty: Adam makes it at its first step) with each
    parameter's step count (a float32 scalar) and moments (zeros shaped
    like the parameter)."""
    state = {i: {"step": torch.tensor(0.0, dtype=torch.float32),
                 "exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
             for i, p in enumerate(parameters)}
    return {**opt_state, "state": state}


def restore_train_state(path: str | Path, like_vec: torch.Tensor, like_opt_state: dict):
    """-> (scene_vec on like_vec's device, optimizer state dict, step).
    ``like_*`` come from make_packed_train_step's ``init`` on the template
    scene (``model.scene_vec``, ``optimizer.state_dict()``, fresh or
    stepped); ``torch.optim.Adam.load_state_dict`` takes the returned state
    into a fresh optimizer."""
    like = {"scene_vec": like_vec, "opt_state": adam_state_like(like_opt_state, [like_vec]),
            "step": 0}
    out = restore(path, like)
    return out["scene_vec"].to(like_vec.device), out["opt_state"], int(out["step"])
