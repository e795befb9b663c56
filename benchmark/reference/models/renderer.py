"""The forward path tracer in plain torch: camera rays -> bounces -> light.

Counterpart of fourd_ray_tracing_tpu/models/renderer.py, in both RNG
modes, with the three samplers and the three folds. This pipeline is the
plain version of the hand-written forward kernel
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
* rng_mode="per_sample": sample s of a pixel draws from its own stream,
  keyed by the pixel's bits xor hash((s+1) * 0x9E3779B9), its counter
  starting at the seed;
* rng_mode="sequential" (the reference's stream): every sample draws from
  the pixel's bits, its counter carried on from the sample before, and
  the last bounce pays the reference's dead draws (one Bernoulli on live
  lanes, three more on diffuse ones), bounce 0 too when it is the last.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.camera import Camera
from benchmark.reference.models.scene import INTERSECT_MODES, Scene, intersect_scene
from benchmark.reference.ops import rng
from benchmark.reference.ops.sampler import SAMPLER_METHODS, direction_from_uniforms
from benchmark.reference.ops.sky import final_light, light_to_color
from benchmark.reference.ops.vec4 import Vec3, Vec4, normalize, redirect, reflect


@dataclass(frozen=True)
class RenderConfig:
    """Static render parameters, field for field the JAX package's
    RenderConfig (renderer.py:48-147) with the same defaults. Every value
    of ``rng_mode`` ("sequential", "per_sample"), ``sampler_method``
    ("poly", "kepler" with ``sampler_iters`` Halley steps, "newton") and
    ``intersect`` ("fast", "spec", "trig") renders; the fast fold takes the
    static hints (``plane_hints``, ``plane_pairs``, ``axis_hints``:
    models/scene.py), the literal folds ignore them, as the JAX package's
    do. The gradient kernels take every configuration with per_sample
    streams (gradkernel.check_kernel_config); the plain gradient route takes
    everything. The gradient paths take the hints only under
    ``freeze_hints``, the
    contract that defines the hyperplane normals' and the hinted axes'
    gradients zero (check_trainable, diff.with_frozen_hints). The
    Mosaic-only knobs (bounce_loop, tile_sublanes, tiles_per_program) and
    ``remat`` are carried and ignored. ``grad_sample_chunk`` must divide
    ``samples`` as in the JAX package, but changes nothing here: on the TPU
    it only chunked the grad kernel's VMEM residuals, which re-associates
    its sums; the port's sweep has no chunks."""

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


RNG_MODES = ("sequential", "per_sample")


def check_supported(cfg: RenderConfig) -> None:
    """Raise ValueError for a configuration no renderer takes."""
    for name, value, allowed in (("rng_mode", cfg.rng_mode, RNG_MODES),
                                 ("sampler_method", cfg.sampler_method, SAMPLER_METHODS),
                                 ("intersect", cfg.intersect, INTERSECT_MODES)):
        if value not in allowed:
            raise ValueError(f"{name} must be one of {allowed}, got {value!r}")
    if cfg.samples % max(1, cfg.grad_sample_chunk):
        raise ValueError(
            f"samples ({cfg.samples}) must be divisible by grad_sample_chunk "
            f"({cfg.grad_sample_chunk})"
        )


def check_trainable(cfg: RenderConfig) -> None:
    """The gradient paths' check (the plain autograd route, K4, K5, K6, K8,
    the hard and soft losses and train steps), which take every primitive:
    check_supported; ValueError when ``cfg`` carries static hints without
    ``freeze_hints`` (hinted normal and axis components would get no
    gradient and the pair fold rewrites the walls' math: the JAX gradient
    kernel refuses them outside that contract too, gradkernel.py:653-671)."""
    check_supported(cfg)
    if (cfg.plane_hints is not None or cfg.plane_pairs is not None
            or cfg.axis_hints is not None) and not cfg.freeze_hints:
        raise ValueError(
            "static scene hints distort the hinted components' gradients; the gradient "
            "paths run them only under the freeze_hints contract (hyperplane normals and "
            "hinted axes get zero gradients, every other gradient stays exact): see "
            "diff.with_frozen_hints"
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


def _intersect(scene: Scene, o: Vec4, d: Vec4, cfg: RenderConfig):
    return intersect_scene(scene, o, d, cfg.intersect, cfg.plane_hints, cfg.plane_pairs,
                           cfg.axis_hints)


def precompute_bounce0(scene: Scene, ray_o: Vec4, ray_d: Vec4, cfg: RenderConfig) -> Bounce0:
    o, d = ray_o, ray_d
    inter = _intersect(scene, o, d, cfg)
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


def _scatter(d, norm, mirrored, alive, refl_prob, pixel_bits, seed, counter, cfg: RenderConfig):
    """The direction update of one bounce: Bernoulli mirror vs uniform
    S^3 diffuse, with masked counters. Returns (new_d, counter)."""
    u_refl, counter = rng.masked_uniform01(pixel_bits, seed, counter, alive)
    mirror = u_refl <= refl_prob
    diffuse = alive & ~mirror
    u_w, counter = rng.masked_uniform01(pixel_bits, seed, counter, diffuse)
    u_z, counter = rng.masked_uniform01(pixel_bits, seed, counter, diffuse)
    u_fi, counter = rng.masked_uniform01(pixel_bits, seed, counter, diffuse)
    rand_dir = direction_from_uniforms(u_w, u_z, u_fi, method=cfg.sampler_method,
                                       kepler_iters=cfg.sampler_iters)
    scattered = redirect(rand_dir, norm)
    return mirrored.where(mirror, scattered).where(alive, d), counter


def _dead_draws(alive, refl_prob, pixel_bits, seed, counter):
    """The reference's draws on the final iteration, whose direction is
    never used: one Bernoulli on live lanes, three more on diffuse ones.
    Only a sequential stream pays them (renderer.py:365-375)."""
    u_refl, counter = rng.masked_uniform01(pixel_bits, seed, counter, alive)
    diffuse = alive & (u_refl > refl_prob)
    for _ in range(3):
        _, counter = rng.masked_uniform01(pixel_bits, seed, counter, diffuse)
    return counter


def bounce0_direction_update(pre0: Bounce0, ray_d: Vec4, pixel_bits, seed, counter,
                             cfg: RenderConfig):
    """Bounce 0's per-sample direction update. Returns (new_d, counter)."""
    return _scatter(ray_d, pre0.norm, pre0.mirrored, pre0.alive, pre0.refl_prob,
                    pixel_bits, seed, counter, cfg)


def _shade(scene: Scene, o, d, result, throughput, alive, cfg: RenderConfig):
    """Intersect; add escaped environment light, then emission.
    Returns (intersection, result, alive)."""
    inter = _intersect(scene, o, d, cfg)
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
    """One sample's trace from the hoisted bounce 0. Returns (light,
    counter): a sequential stream's counter goes on to the next sample."""
    sequential = cfg.rng_mode == "sequential"
    if cfg.reflections_amount == 0:
        if sequential:
            counter = _dead_draws(pre0.alive, pre0.refl_prob, pixel_bits, seed, counter)
        return pre0.result, counter
    d, counter = bounce0_direction_update(pre0, ray_d, pixel_bits, seed, counter, cfg)
    o, result, throughput, alive = pre0.o, pre0.result, pre0.throughput, pre0.alive
    small_indent = float(np.float32(cfg.small_indent))
    for _ in range(1, cfg.reflections_amount):
        inter, result, alive = _shade(scene, o, d, result, throughput, alive, cfg)
        throughput = (throughput * inter.color).where(alive, throughput)
        new_o = o + d * inter.dist + inter.norm * small_indent
        o = new_o.where(alive, o)
        d, counter = _scatter(d, inter.norm, reflect(d, inter.norm), alive,
                              inter.refl_prob, pixel_bits, seed, counter, cfg)
    # Final bounce: shade only; its direction draws are dead.
    inter, result, alive = _shade(scene, o, d, result, throughput, alive, cfg)
    if sequential:
        counter = _dead_draws(alive, inter.refl_prob, pixel_bits, seed, counter)
    return result, counter


def sample_stream_bits(pixel_bits: torch.Tensor, sample_index: int) -> torch.Tensor:
    """Independent per-(pixel, sample) stream key."""
    word = ((sample_index + 1) * 0x9E3779B9) & rng.MASK32
    fold = rng.hash_u32(torch.tensor(word, dtype=torch.int64, device=pixel_bits.device))
    return pixel_bits ^ fold


def sample_stream_bits_batch(pixel_bits: torch.Tensor, sample0: int, n: int) -> torch.Tensor:
    """``sample_stream_bits`` of samples [sample0, sample0 + n) stacked on a
    leading axis: the same words, hashed at once."""
    words = [((s + 1) * 0x9E3779B9) & rng.MASK32 for s in range(sample0, sample0 + n)]
    fold = rng.hash_u32(torch.tensor(words, dtype=torch.int64, device=pixel_bits.device))
    return pixel_bits.unsqueeze(0) ^ fold.view((n,) + (1,) * pixel_bits.dim())


def render_light_tile(scene: Scene, camera: Camera, cfg: RenderConfig, seed: int, row0: int = 0,
                      n_rows: int | None = None, sample0: int = 0,
                      n_samples: int | None = None) -> torch.Tensor:
    """Light of image rows [row0, row0 + n_rows) SUMMED over samples
    [sample0, sample0 + n_samples), (n_rows, W, 3) or (V, n_rows, W, 3),
    at one scalar seed; the caller divides by the global sample count
    (the counterpart of the JAX renderer's render_light_tile,
    renderer.py:409-496). Row and sample offsets are absolute, so any
    partition of rows x samples reassembles into the same image: the unit
    of the row-sharded path (parallel/mesh.py). A sequential stream
    carries its counter across the samples and cannot start mid-stream
    (``sample0`` must be 0)."""
    n_rows = cfg.height if n_rows is None else n_rows
    n_samples = cfg.samples if n_samples is None else n_samples
    sequential = cfg.rng_mode == "sequential"
    if sequential and sample0 != 0:
        raise ValueError('rng_mode="sequential" carries RNG state across samples and cannot '
                         'start mid-stream; use rng_mode="per_sample" to split the sample axis')
    scr_x, scr_y = screen_coords(cfg, camera.focus.x.device, row0, n_rows)
    d = primary_directions(camera, scr_x, scr_y)
    pixel_bits = rng.pixel_stream_bits(scr_x, scr_y).expand(d.x.shape)
    o = _expand_cam_vec(camera.focus, d.x.dim())
    o = Vec4(*(c.expand(d.x.shape) for c in o))
    counter0 = counter = rng.init_counter(seed, d.x)
    pre0 = precompute_bounce0(scene, o, d, cfg)
    acc = Vec3.full(0.0, like=d.x)
    if not sequential:
        # Every sample's lanes in one trace, a leading sample axis; summed
        # in sample order, as the loop below does.
        light, _ = trace_rays(scene, _lift(d, n_samples, d.x.shape),
                              sample_stream_bits_batch(pixel_bits, sample0, n_samples), seed,
                              _lift(counter0, n_samples, d.x.shape), cfg,
                              _lift(pre0, n_samples, d.x.shape))
        for k in range(n_samples):
            acc = acc + Vec3(*(c[k] for c in light))
        return acc.stack(-1)
    for s in range(sample0, sample0 + n_samples):
        light, counter = trace_rays(scene, d, pixel_bits, seed, counter, cfg, pre0)
        acc = acc + light
    return acc.stack(-1)


def _lift(node, n: int, lane_shape):
    """``node`` (a tensor or a tuple of them) with every lane tensor given a
    leading axis of ``n`` copies (a broadcast view, nothing copied); tensors
    of another shape are left to broadcast."""
    if isinstance(node, torch.Tensor):
        if tuple(node.shape) == tuple(lane_shape):
            return node.unsqueeze(0).expand((n,) + tuple(lane_shape))
        return node
    if isinstance(node, tuple):
        children = [_lift(c, n, lane_shape) for c in node]
        return type(node)(*children) if hasattr(node, "_fields") else tuple(children)
    return node


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
