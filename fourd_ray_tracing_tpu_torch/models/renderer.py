"""The forward path tracer in plain torch: camera rays -> bounces -> light.

Counterpart of fourd_ray_tracing_tpu/models/renderer.py with
rng_mode="per_sample", the mode the production engine runs. This
pipeline is the plain version of the hand-written forward kernel
(ops/cuda/megakernel.py, csrc/megakernel.cu): the kernel's wrapper runs
it for tensors on the CPU, the tests hold it against the JAX package,
and the chip smoke test holds the kernel against it on the card.

Behavior contract (shared with the kernel):

* all samples of a pixel share one primary ray, so bounce 0 is computed
  once per pixel (precompute_bounce0) and each sample only redraws its
  direction (bounce0_direction_update);
* a miss adds throughput * final_light and ends the lane; emission adds
  color*glow*throughput before throughput absorbs color; the next origin
  steps dist along the ray plus small_indent along the hit normal;
* per bounce one Bernoulli draw picks mirror (u <= refl_prob) or diffuse;
  diffuse draws three more uniforms for the S^3 sampler; lanes that do
  not draw do not advance their counters; the last bounce only shades;
* sample s of a pixel draws from its own stream, keyed by the pixel's
  bits xor hash((s+1) * 0x9E3779B9).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from fourd_ray_tracing_tpu_torch.camera import Camera
from fourd_ray_tracing_tpu_torch.models.scene import Scene, intersect_scene_fast
from fourd_ray_tracing_tpu_torch.ops import rng
from fourd_ray_tracing_tpu_torch.ops.sampler import direction_from_uniforms
from fourd_ray_tracing_tpu_torch.ops.sky import final_light, light_to_color
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec3, Vec4, normalize, redirect, reflect


@dataclass(frozen=True)
class RenderConfig:
    """Static render parameters, field for field the JAX package's
    RenderConfig (renderer.py:48-147) with the same defaults. This port
    renders rng_mode="per_sample", sampler_method="poly", intersect="fast"
    and no hints; other values raise (check_supported). The Mosaic-only
    knobs (bounce_loop, tile_sublanes, tiles_per_program) and ``remat``
    are carried and ignored. Of the training knobs, ``freeze_hints`` raises
    (the hints are not ported), and ``grad_sample_chunk`` must divide
    ``samples`` as in the JAX package, but changes nothing here: on the TPU
    it only chunked the grad kernel's VMEM residuals, which re-associates
    its sums."""

    width: int = 256
    height: int = 256
    samples: int = 1
    reflections_amount: int = 4
    small_indent: float = 0.005
    light_coefficient: float = 1.0
    sampler_method: str = "poly"
    sampler_iters: int = 2
    rng_mode: str = "sequential"
    bounce_loop: str = "fori"
    intersect: str = "fast"
    remat: bool = True
    tile_sublanes: int = 32
    tiles_per_program: int = 1
    plane_hints: tuple | None = None
    plane_pairs: tuple | None = None
    axis_hints: tuple | None = None
    freeze_hints: bool = False
    grad_sample_chunk: int = 1


def check_supported(cfg: RenderConfig) -> None:
    """Raise for the configurations this port does not render yet."""
    if cfg.rng_mode != "per_sample":
        raise NotImplementedError(
            f"rng_mode={cfg.rng_mode!r} is not ported yet (ROADMAP queue 1, "
            "items 5-6); use 'per_sample'"
        )
    if cfg.plane_hints is not None or cfg.plane_pairs is not None or cfg.axis_hints is not None:
        raise NotImplementedError(
            "plane_hints/plane_pairs/axis_hints are not ported yet (ROADMAP "
            "queue 1, item 4)"
        )
    if cfg.sampler_method != "poly":
        raise NotImplementedError(
            f"sampler_method={cfg.sampler_method!r} is not ported yet (ROADMAP "
            "queue 1, item 2); use 'poly'"
        )
    if cfg.intersect != "fast":
        raise NotImplementedError(
            f"intersect={cfg.intersect!r} is not ported yet (ROADMAP queue 1, "
            "item 4); use 'fast'"
        )
    if cfg.freeze_hints:
        raise NotImplementedError(
            "freeze_hints needs the static hints, which are not ported yet "
            "(ROADMAP queue 1, item 4); train without it: every gradient is exact"
        )
    if cfg.samples % max(1, cfg.grad_sample_chunk):
        raise ValueError(
            f"samples ({cfg.samples}) must be divisible by grad_sample_chunk "
            f"({cfg.grad_sample_chunk})"
        )


def screen_coords(cfg: RenderConfig, device, row0: int = 0, n_rows: int | None = None):
    """Normalized pixel-center coordinates (n_rows, W) of image rows
    [row0, row0 + n_rows) (all H by default), row 0 at the top. They
    normalize by the global resolution, so a pixel's coordinates, and
    with them its RNG stream, do not depend on how the image was cut."""
    n_rows = cfg.height if n_rows is None else n_rows
    j = torch.arange(cfg.width, dtype=torch.float32, device=device)
    i = torch.arange(row0, row0 + n_rows, dtype=torch.float32, device=device)
    # Divide by tensors: on CUDA, torch turns division by a Python scalar
    # into a multiply by its reciprocal, which moves some coordinates by
    # an ulp and so reseeds those pixels' RNG streams.
    scr_x = (j[None, :] + 0.5) / torch.tensor(float(cfg.width), device=device)
    scr_y = (i[:, None] + 0.5) / torch.tensor(float(cfg.height), device=device)
    shape = (n_rows, cfg.width)
    return scr_x.expand(shape), scr_y.expand(shape)


def _expand_cam_vec(v: Vec4, target_ndim: int) -> Vec4:
    """Right-pad components with singleton axes so a (V,) view-batched
    basis broadcasts against (V, H, W) pixel grids."""

    def expand(c):
        while c.dim() < target_ndim:
            c = c[..., None]
        return c

    return Vec4(*(expand(c) for c in v))


def primary_directions(camera: Camera, scr_x, scr_y) -> Vec4:
    """normalize(vec_to_mtr + top*my + right*mx)."""
    target = scr_x.dim() + (1 if camera.top.x.dim() > 0 else 0)
    top = _expand_cam_vec(camera.top, target)
    right = _expand_cam_vec(camera.right, target)
    vec_to_mtr = _expand_cam_vec(camera.vec_to_mtr, target)
    mx = (scr_x - 0.5) * camera.mtr_width
    my = (0.5 - scr_y) * camera.mtr_height
    return normalize(vec_to_mtr + top * my + right * mx)


class Bounce0(NamedTuple):
    """Sample-invariant state after bounce 0 (all samples share the
    primary ray)."""

    result: Vec3
    throughput: Vec3
    o: Vec4
    alive: torch.Tensor
    mirrored: Vec4
    refl_prob: torch.Tensor
    norm: Vec4


def precompute_bounce0(scene: Scene, ray_o: Vec4, ray_d: Vec4, cfg: RenderConfig) -> Bounce0:
    o, d = ray_o, ray_d
    inter = intersect_scene_fast(scene, o, d)
    zero3 = Vec3.full(0.0, like=d.x)
    result = zero3
    env = scene.environment
    if env is not None and env.enabled:
        result = result + final_light(env, d).where(~inter.hit, zero3)
    alive = inter.hit
    result = result + (inter.color * inter.glow).where(alive, zero3)
    throughput = inter.color.where(alive, Vec3.full(1.0, like=d.x))
    new_o = o + d * inter.dist + inter.norm * float(np.float32(cfg.small_indent))
    o = new_o.where(alive, o)
    return Bounce0(result, throughput, o, alive, reflect(d, inter.norm),
                   inter.refl_prob, inter.norm)


def _scatter(d, norm, mirrored, alive, refl_prob, pixel_bits, seed, counter):
    """The direction update of one bounce: Bernoulli mirror vs uniform
    S^3 diffuse, with masked counters. Returns (new_d, counter)."""
    u_refl, counter = rng.masked_uniform01(pixel_bits, seed, counter, alive)
    mirror = u_refl <= refl_prob
    diffuse = alive & ~mirror
    u_w, counter = rng.masked_uniform01(pixel_bits, seed, counter, diffuse)
    u_z, counter = rng.masked_uniform01(pixel_bits, seed, counter, diffuse)
    u_fi, counter = rng.masked_uniform01(pixel_bits, seed, counter, diffuse)
    rand_dir = direction_from_uniforms(u_w, u_z, u_fi)
    scattered = redirect(rand_dir, norm)
    return mirrored.where(mirror, scattered).where(alive, d), counter


def bounce0_direction_update(pre0: Bounce0, ray_d: Vec4, pixel_bits, seed, counter):
    """Bounce 0's per-sample direction update. Returns (new_d, counter)."""
    return _scatter(ray_d, pre0.norm, pre0.mirrored, pre0.alive, pre0.refl_prob,
                    pixel_bits, seed, counter)


def _shade(scene: Scene, o, d, result, throughput, alive):
    """Intersect; add escaped environment light, then emission.
    Returns (intersection, result, alive)."""
    inter = intersect_scene_fast(scene, o, d)
    zero3 = Vec3.full(0.0, like=result.x)
    env = scene.environment
    if env is not None and env.enabled:
        escaped = alive & ~inter.hit
        result = result + (throughput * final_light(env, d)).where(escaped, zero3)
    alive = alive & inter.hit
    result = result + (inter.color * inter.glow * throughput).where(alive, zero3)
    return inter, result, alive


def trace_rays(scene: Scene, ray_d: Vec4, pixel_bits, seed, counter, cfg: RenderConfig,
               pre0: Bounce0):
    """One per-sample trace from the hoisted bounce 0. Returns the light."""
    if cfg.reflections_amount == 0:
        return pre0.result
    d, counter = bounce0_direction_update(pre0, ray_d, pixel_bits, seed, counter)
    o, result, throughput, alive = pre0.o, pre0.result, pre0.throughput, pre0.alive
    small_indent = float(np.float32(cfg.small_indent))
    for _ in range(1, cfg.reflections_amount):
        inter, result, alive = _shade(scene, o, d, result, throughput, alive)
        throughput = (throughput * inter.color).where(alive, throughput)
        new_o = o + d * inter.dist + inter.norm * small_indent
        o = new_o.where(alive, o)
        d, counter = _scatter(d, inter.norm, reflect(d, inter.norm), alive,
                              inter.refl_prob, pixel_bits, seed, counter)
    # Final bounce: shade only; its direction draws would be dead.
    _, result, _ = _shade(scene, o, d, result, throughput, alive)
    return result


def sample_stream_bits(pixel_bits: torch.Tensor, sample_index: int) -> torch.Tensor:
    """Independent per-(pixel, sample) stream key."""
    word = ((sample_index + 1) * 0x9E3779B9) & rng.MASK32
    fold = rng.hash_u32(torch.tensor(word, dtype=torch.int64, device=pixel_bits.device))
    return pixel_bits ^ fold


def render_light_tile(scene: Scene, camera: Camera, cfg: RenderConfig, seed: int, row0: int = 0,
                      n_rows: int | None = None, sample0: int = 0,
                      n_samples: int | None = None) -> torch.Tensor:
    """Light of image rows [row0, row0 + n_rows) SUMMED over samples
    [sample0, sample0 + n_samples), (n_rows, W, 3) or (V, n_rows, W, 3),
    at one scalar seed; the caller divides by the global sample count
    (the counterpart of the JAX renderer's render_light_tile,
    renderer.py:409-496). Row and sample offsets are absolute, so any
    partition of rows x samples reassembles into the same image: the unit
    of the row-sharded path (parallel/mesh.py)."""
    n_rows = cfg.height if n_rows is None else n_rows
    n_samples = cfg.samples if n_samples is None else n_samples
    scr_x, scr_y = screen_coords(cfg, camera.focus.x.device, row0, n_rows)
    d = primary_directions(camera, scr_x, scr_y)
    pixel_bits = rng.pixel_stream_bits(scr_x, scr_y).expand(d.x.shape)
    o = _expand_cam_vec(camera.focus, d.x.dim())
    o = Vec4(*(c.expand(d.x.shape) for c in o))
    counter0 = rng.init_counter(seed, d.x)
    pre0 = precompute_bounce0(scene, o, d, cfg)
    acc = Vec3.full(0.0, like=d.x)
    for s in range(sample0, sample0 + n_samples):
        bits = sample_stream_bits(pixel_bits, s)
        acc = acc + trace_rays(scene, d, bits, seed, counter0, cfg, pre0)
    return acc.stack(-1)


def inv_samples(cfg: RenderConfig) -> float:
    """1 / samples in float32, the mean's factor."""
    return float(np.float32(1.0) / np.float32(cfg.samples))


def _render_light_one(scene: Scene, camera: Camera, cfg: RenderConfig, seed: int, rows: slice):
    row0, stop, step = rows.indices(cfg.height)
    if step != 1:
        raise ValueError(f"rows must be a contiguous band, got {rows}")
    return render_light_tile(scene, camera, cfg, seed, row0, max(0, stop - row0)) * inv_samples(cfg)


def seed_words(seed) -> tuple[list, bool]:
    """Seeds (an int, a sequence, a numpy array or an integer tensor) as
    (list of uint32 values, whether it was a (K,) vector)."""
    if isinstance(seed, torch.Tensor):
        seed = seed.cpu().numpy()
    arr = np.asarray(seed)
    if arr.dtype.kind not in "iu" or arr.ndim > 1:
        raise TypeError(f"seeds must be an integer or a 1-d integer vector, got {arr!r}")
    return [int(s) & rng.MASK32 for s in arr.reshape(-1)], arr.ndim == 1


def render_light(scene: Scene, camera: Camera, cfg: RenderConfig, seed,
                 rows: slice = slice(None)) -> torch.Tensor:
    """Sample-averaged light, float32 (H, W, 3) or (V, H, W, 3).

    ``seed`` may be a (K,) vector: K frames, with a leading frame axis on
    the result; frame k equals the call with seed[k]. ``rows`` renders
    only those pixel rows of the image (every pixel is computed on its
    own, so a row band is the full image's rows).
    """
    check_supported(cfg)
    words, batched = seed_words(seed)
    frames = [_render_light_one(scene, camera, cfg, s, rows) for s in words]
    return torch.stack(frames) if batched else frames[0]


def render_image(scene: Scene, camera: Camera, cfg: RenderConfig, seed,
                 rows: slice = slice(None)) -> torch.Tensor:
    """Tone-mapped color image in [0, 1), shape (..., H, W, 3)."""
    return light_to_color(render_light(scene, camera, cfg, seed, rows), cfg.light_coefficient)


def image_loss(scene: Scene, camera: Camera, cfg: RenderConfig, seed, target) -> torch.Tensor:
    """MSE between the rendered (tone-mapped) image and ``target``; with a
    (F,) seed vector the mean runs over the F frames too. The plain
    version of the value-and-grad kernel differentiates it by autograd."""
    return torch.mean((render_image(scene, camera, cfg, seed) - target) ** 2)


def accumulate(old_frame: torch.Tensor, new_frame: torch.Tensor, part: float) -> torch.Tensor:
    """Progressive blend old + (new - old) * part, updated in place: the
    same float ops as the JAX package's accumulate."""
    return old_frame.add_((new_frame - old_frame) * float(np.float32(part)))
