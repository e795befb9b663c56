"""The static hints and the freeze_hints contract, derived again from a
scene (the port's megakernel.with_hints and diff.with_frozen_hints /
stop_frozen, over this copy)."""
from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.models import params
from benchmark.reference.models.renderer import RenderConfig
from benchmark.reference.models.scene import (Scene, axis_alignment_hints, plane_norm_hints,
                                              plane_pair_hints)


def with_hints(scene: Scene, cfg: RenderConfig) -> RenderConfig:
    """``cfg`` with the hyperplanes' and the composite axes' static hints
    of ``scene`` where the fast fold can take them and ``cfg`` has none."""
    if cfg.intersect != "fast":
        return cfg
    scene = params.map_leaves(torch.Tensor.detach, scene)
    updates = {}
    if cfg.plane_hints is None:
        hints = plane_norm_hints(scene)
        if hints is not None:
            updates.update(plane_hints=hints, plane_pairs=plane_pair_hints(scene, hints))
    if cfg.axis_hints is None:
        axes = axis_alignment_hints(scene)
        if axes is not None:
            updates["axis_hints"] = axes
    return dataclasses.replace(cfg, **updates) if updates else cfg


def with_frozen_hints(cfg: RenderConfig, scene: Scene) -> RenderConfig:
    """``cfg`` under the freeze_hints contract, with the scene's hints."""
    return with_hints(scene, dataclasses.replace(cfg, freeze_hints=True))


def unhinted(cfg: RenderConfig) -> RenderConfig:
    return dataclasses.replace(cfg, plane_hints=None, plane_pairs=None, axis_hints=None,
                               freeze_hints=False)


def stop_frozen(scene: Scene, cfg: RenderConfig) -> Scene:
    """``scene`` with the leaves the contract freezes detached."""
    frozen = params.frozen_leaves(cfg, scene)
    if frozen is None:
        return scene
    it = iter(frozen)
    return params.map_leaves(lambda t: t.detach() if next(it) else t, scene)
