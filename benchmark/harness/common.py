"""What the two loop kinds share: the configuration as a RenderConfig of
either side, the camera, the reference's scene, timing."""
from __future__ import annotations

import time

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
BAND_ROWS = 720    # rows a reference band takes at once: every window of the configurations in one band
COUNT_ROWS = 8     # rows whose flops the roofline counts, scaled to the image
RENDER_KEYS = ("samples", "reflections_amount", "small_indent", "light_coefficient",
               "sampler_method", "rng_mode", "intersect")


def render_config(cls, config: dict, window: int = 0):
    """``cls`` (either side's RenderConfig) with the configuration's render
    settings at the size of its window ``window`` (0: the main window)."""
    w = config["windows"][window]
    return cls(width=w["width"], height=w["height"], **{k: config[k] for k in RENDER_KEYS})


def reference_camera(config: dict, views, device):
    """The configuration's camera, built by the reference's copy."""
    from benchmark.reference import camera as cam
    from benchmark.reference.ops.vec4 import Vec4

    c = config["camera"]
    orient = cam.orientation_from_angles(*cam.CameraAngles.of(*c["angles"], device=device),
                                         device)
    return cam.make_camera(Vec4.of(*c["focus"], device=device), orient,
                           c["focus_to_matrix_distance"], c["matrix_height"], tuple(views),
                           device)


def reference_scene(config: dict, device):
    from benchmark.reference.models import library

    return library.SCENES[config["scene"]](device)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def now() -> float:
    return time.perf_counter()


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy Generator of the run's seed (any integer), one per use."""
    s = seed % 2**64
    return np.random.default_rng([s & MASK32, s >> 32, stream])


def free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
