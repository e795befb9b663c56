"""Wrappers of the gradient kernels (csrc/gradkernel.cu, gradcomposite.cu,
softcomposite.cu and, over K1's other configurations, gradmodes.cu and
softmodes.cu), each with its plain version.

Counterpart of fourd_ray_tracing_tpu/ops/pallas/gradkernel.py:

* K4, the value-and-grad kernel (render_loss_and_grad_pallas,
  make_packed_loss_and_grad): the MSE of the tone-mapped render against a
  target, and the gradient of every packed scene and camera parameter, at
  a fixed seed. A (F,) seed vector takes F estimator samples of the same
  loss in one launch (the minibatch): loss and gradients are the mean of
  the F scalar-seed calls.
* K5, the light-VJP kernel (render_light_vjp_pallas[_multi]): the VJP of
  the mean-light render for a given per-pixel light cotangent, for one
  packed vector (P,) or for (F, P) rows of same-structure scenes.
* K6, the fused soft value-and-grad kernel
  (render_soft_loss_and_grad_pallas): the soft-silhouette MSE of the
  scene blended by a coverage alpha with its zero-map copy, the gradient
  of every packed parameter and the cotangent of alpha.

Under the freeze_hints contract (``cfg.freeze_hints`` with the static
hints, diff.with_frozen_hints) every launch folds with the forward's hints
(K1's fold table, one per block) and its gradient is exact for every slot
but the frozen ones, which it writes as 0 (the packed mask of
models/params.py ``freeze_mask``); its loss and every other slot
are the unhinted launch's. K4, K5 and K6 take every primitive, the
composite ones (cylinders, the duocylinder, the hypercube, the tiger)
folded over K1's table whether hinted or not (``launch_words``); K6's row
b zeroes a composite by its radii (``params.soft_zero_map``: up to the
hypercube's 9 slots of build.K6_MAX_ZERO_SLOTS). The entry points that
take a scene derive the hints from it when the config asks for the
contract and has none (``_auto_hints``, gradkernel.py:674-700); a launch
is handed them and the mask. The plain versions run the hinted plain pipeline and zero the same
slots.

The kernels render per-sample RNG streams (``check_kernel_config``: the
sequential stream raises ValueError, as in the JAX package,
gradkernel.py:653-671) in every configuration K1 renders them: the poly,
kepler and newton samplers, the fast fold and the literal spec and trig
folds, and a hypercube with or without generators. The production
configuration (megakernel.production: poly, fast, generators) launches the
production instances; any other the modes entry points (``*_modes``,
gradmodes.cu and softmodes.cu: their sampler a launch argument), with the
descriptor of
``launch_words`` (a literal fold's holds no hints, so nothing is frozen:
diff.with_frozen_hints derives none there). No entry point falls back to
another route.

Each takes ``rows`` = (row0, n_rows): image rows [row0, row0 + n_rows)
only, with the target, cotangent, alpha and alpha cotangent the blocks of
those rows, and the loss and gradient those rows' part of the whole
image's (the scale stays the whole image's). The sharded wrappers
(``sharded_loss_and_grad``, ``sharded_render_light_vjp_multi``,
``sharded_soft_loss_and_grad``: K3's launches of K4, K5 and K6, the
counterparts of gradkernel.py:1060, :535 and :1456) launch once per rank
on its block of the rows split over every rank of the mesh, whatever its
shape (parallel/mesh.py ``Mesh.kernel_rows``; no launch on an empty
block), and all-reduce one packed [loss, grad] vector over the ranks.

Each plain version is torch autograd over the plain pipeline
(models/renderer.py), with grad mode on so that it runs inside an autograd
Function's forward or backward too; ``band_rows`` runs it a band of rows at a time for
shapes whose whole graph would not fit. ``LAUNCHES``,
``VJP_LAUNCHES`` and ``SOFT_LAUNCHES`` count the launches of K4, K5 and
K6, each raised once per ``launch_*`` call, so a run can show that its
main path went through them; ``SHARD_LAUNCHES``, ``SHARD_VJP_LAUNCHES``
and ``SHARD_SOFT_LAUNCHES`` count those of them over fewer rows than the
image, ``HINTED_LAUNCHES``, ``HINTED_VJP_LAUNCHES`` and
``HINTED_SOFT_LAUNCHES`` those that ran the static hints, and
``CONFIG_LAUNCHES``, ``CONFIG_VJP_LAUNCHES`` and ``CONFIG_SOFT_LAUNCHES``
every launch by its configuration (megakernel.launch_config:
rng_mode/sampler_method/intersect, "/cells" for a hypercube without
generators).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from fourd_ray_tracing_tpu_torch.camera import Camera
from fourd_ray_tracing_tpu_torch.models import params, renderer
from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig
from fourd_ray_tracing_tpu_torch.models.scene import Scene
from fourd_ray_tracing_tpu_torch.ops.cuda import build, megakernel
from fourd_ray_tracing_tpu_torch.ops.cuda.megakernel import (hint_table, hinted, launch_config,
                                                             launch_rows, mode_codes, production,
                                                             seed_tensor, with_hints)
from fourd_ray_tracing_tpu_torch.parallel import mesh as pmesh
from fourd_ray_tracing_tpu_torch.utils import profiling

LAUNCHES = 0  # K4
VJP_LAUNCHES = 0  # K5
SOFT_LAUNCHES = 0  # K6
SHARD_LAUNCHES = SHARD_VJP_LAUNCHES = SHARD_SOFT_LAUNCHES = 0  # of them, on a block of rows
HINTED_LAUNCHES = HINTED_VJP_LAUNCHES = HINTED_SOFT_LAUNCHES = 0  # of them, with static hints
CONFIG_LAUNCHES: dict = {}  # K4's, by launch_config
CONFIG_VJP_LAUNCHES: dict = {}  # K5's
CONFIG_SOFT_LAUNCHES: dict = {}  # K6's
# The kernels' caps on packed parameters and bounces and K6's zero-map
# slots, which the build passes to them.
MAX_PARAMS, MAX_BOUNCES = build.K4_MAX_PARAMS, build.K4_MAX_BOUNCES
MAIN_BOUNCES = build.K4_MAIN_BOUNCES  # the bounce count with an unrolled instance
MAX_ZERO_SLOTS = build.K6_MAX_ZERO_SLOTS


def _auto_hints(scene: Scene, cfg: RenderConfig) -> RenderConfig:
    """``cfg`` with the static hints of ``scene`` derived where it asks for
    the freeze_hints contract and has none (gradkernel.py:674-700, as
    megakernel.with_hints derives them); as it is otherwise. A scene whose
    leaves require grad gives none, as a traced scene gives none in the JAX
    package: a training step takes its hints from diff.with_frozen_hints."""
    return with_hints(scene, cfg) if cfg.freeze_hints else cfg


def freeze(grad: torch.Tensor, like_scene: Scene, cfg: RenderConfig) -> torch.Tensor:
    """The packed gradient (P,) or (F, P) with the slots the freeze_hints
    contract freezes set to 0 (gradkernel.py:703-710 on the packed vector);
    as it is when ``cfg`` freezes nothing."""
    mask = params.freeze_mask(cfg, like_scene, grad.shape[-1], grad.device)
    if mask is None:
        return grad
    return torch.where(mask != 0, grad, torch.zeros((), dtype=grad.dtype, device=grad.device))


def launch_words(lay: params.Layout, cfg: RenderConfig):
    """The hints descriptor of a gradient launch (hint_table), or None for
    the unhinted fold over the params. A launch over K1's other
    configurations (not megakernel.production) always takes one: a literal
    fold's holds the composites' offsets and no hints, a hypercube without
    generators the axis hint CUBE_CELLS. A production launch over a scene
    with composite primitives always takes one, its fold being K1's table
    (their hints when ``cfg`` carries them, none otherwise); a scene of
    hyperplanes and spheres takes one when ``cfg`` carries hints (it then
    carries the contract: check_trainable), unless it has more than
    build.MAX_HINT_PLANES hyperplanes, whose hints the table cannot hold
    (the rule of the plane count: it launches with the unhinted fold, which
    finds the hinted fold's hits, and its frozen slots are written 0 all
    the same)."""
    if (not production(cfg, lay) or lay.composite_kinds()
            or (hinted(cfg) and lay.n_spaces <= build.MAX_HINT_PLANES)):
        return hint_table(cfg, lay)
    return None


def _modes(cfg: RenderConfig, lay: params.Layout):
    """(fold, sampler, sampler_iters) codes of a modes launch (gradmodes.cu,
    softmodes.cu), or
    None for the production instances (megakernel.production)."""
    if production(cfg, lay):
        return None
    fold, sampler, _, iters = mode_codes(cfg)
    return fold, sampler, iters


def _count(counts: dict, cfg: RenderConfig, lay: params.Layout) -> None:
    key = launch_config(cfg, lay)
    counts[key] = counts.get(key, 0) + 1


def _launch_hints(lay: params.Layout, cfg: RenderConfig, keep, device):
    """(hints descriptor or None, keep pointer or None) of a gradient
    launch: ``launch_words``, and the mask ``keep``, which is required
    when ``cfg`` freezes a slot and must be a (P,) float32 tensor on the
    launch's device (params.freeze_mask(cfg, scene, P, device))."""
    words = launch_words(lay, cfg)
    if not hinted(cfg):
        return words, None
    if keep is None:
        raise ValueError("a launch under the freeze_hints contract takes the packed mask of its "
                         "frozen slots (params.freeze_mask)")
    if keep.device != device or keep.dtype != torch.float32 or keep.shape != (lay.size,):
        raise ValueError(f"keep must be a ({lay.size},) float32 tensor on {device}")
    return words, keep.data_ptr()


def _addr(words):
    return None if words is None else ctypes.addressof(words)


@torch.enable_grad()
def loss_and_grad_plain(packed: torch.Tensor, like_scene: Scene, like_camera: Camera,
                        cfg: RenderConfig, seed, target, band_rows: int | None = None,
                        rows=None):
    """The plain version of the kernel: (loss, (P,) gradient of the packed
    vector) by autograd over the plain pipeline (renderer.image_loss).

    ``band_rows`` takes the loss, a sum over pixels, one frame and one band
    of that many rows at a time, and sums the bands' losses and gradients
    in float64: the same values (up to the order of the sums) with the
    autograd graph of one band in memory, for shapes whose whole graph
    would not fit. ``rows`` (the module's docstring) sums over those rows
    alone, ``target`` their block. Under the freeze_hints contract the
    pipeline folds with the hints and the frozen slots come out 0."""
    cfg = _auto_hints(like_scene, cfg)
    renderer.check_trainable(cfg)
    if band_rows is None and rows is None:
        vec = packed.detach().clone().requires_grad_(True)
        scene, camera = params.unpack(vec, like_scene, like_camera)
        loss = renderer.image_loss(scene, camera, cfg, seed, target)
        (grad,) = torch.autograd.grad(loss, vec)
        return loss.detach(), freeze(grad, like_scene, cfg)
    row0, n_rows = launch_rows(cfg, rows)
    band_rows = band_rows or n_rows
    words, _ = renderer.seed_words(seed)
    count = torch.tensor(float(len(words) * target.numel() // n_rows * cfg.height),
                         dtype=torch.float64, device=packed.device)
    loss, grad = torch.zeros((), dtype=torch.float64, device=packed.device), 0.0
    for word in words:
        for top in range(0, n_rows, band_rows):
            band = slice(top, min(top + band_rows, n_rows))
            vec = packed.detach().clone().requires_grad_(True)
            scene, camera = params.unpack(vec, like_scene, like_camera)
            image = renderer.render_image(scene, camera, cfg, word,
                                          slice(row0 + band.start, row0 + band.stop))
            part = torch.sum(((image - target[..., band, :, :]) ** 2).double()) / count
            (g,) = torch.autograd.grad(part, vec)
            loss, grad = loss + part.detach(), grad + g.double()
    return loss.float(), freeze(grad.float(), like_scene, cfg)


def check_kernel_config(cfg: RenderConfig) -> None:
    """Raise for a configuration the gradient kernels do not take
    (renderer.check_trainable's, and the sequential stream, ValueError as
    the JAX package's _check_cfg raises it, gradkernel.py:653-671). Every
    sampler and fold, and a hypercube without generators, they take."""
    renderer.check_trainable(cfg)
    if cfg.rng_mode != "per_sample":
        raise ValueError('the gradient kernels render per-sample RNG streams (rng_mode='
                         '"per_sample"), as the JAX value-and-grad kernel does')


def check_shape(lay: params.Layout, cfg: RenderConfig) -> None:
    """Raise for what the gradient kernels cannot hold or do not take
    (check_kernel_config), and for static hints outside the freeze_hints
    contract (renderer.check_trainable)."""
    check_kernel_config(cfg)
    if lay.size > MAX_PARAMS:
        raise ValueError(f"the gradient kernels hold at most {MAX_PARAMS} packed "
                         f"parameters in shared memory; this scene and camera have {lay.size}")
    if not 0 <= cfg.reflections_amount <= MAX_BOUNCES:
        raise ValueError(f"the gradient kernels record at most {MAX_BOUNCES} bounces "
                         f"per sample; reflections_amount is {cfg.reflections_amount}")


def _check_launch(packed: torch.Tensor, lay: params.Layout, cfg: RenderConfig, *tensors) -> None:
    """The checks every gradient launch makes of its packed params (P,) or
    (F, P) and its other float32 tensors."""
    device = packed.device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(f"kernel inputs must share one CUDA device, got {device}, "
                         f"{[str(t.device) for t in tensors]}")
    if packed.dtype != torch.float32 or packed.dim() not in (1, 2) or not packed.is_contiguous():
        raise ValueError("packed params must be a contiguous (P,) or (F, P) float32 tensor")
    if packed.shape[-1] != lay.size:
        raise ValueError(f"packed params hold {packed.shape[-1]} floats, layout expects {lay.size}")
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in tensors):
        raise ValueError("kernel inputs must be contiguous float32 tensors")
    check_shape(lay, cfg)


# The gradient kernels' threads a block and a sweep thread's shared-memory
# column pitch in floats (csrc/reduce.cuh kGradBlock, kGradPitch).
GRAD_BLOCK, GRAD_PITCH = 64, 65


def launch_shapes(lay: params.Layout, cfg: RenderConfig | None = None) -> dict:
    """(threads a block, dynamic shared-memory bytes) of each kernel of the
    gradient launches over ``lay`` under ``cfg`` (RenderConfig() by
    default: the production fold, no hints) (csrc/gradkernel.cu,
    reduce.cuh grad_smem_bytes): the sweeps (K4's and K5's, K6's rows a and
    b) hold the params row, with a fold table (``launch_words``: hints, a
    scene's composites, or any other configuration's descriptor) padded to
    16 bytes and followed by the table, and their threads' columns, row b
    one byte a slot more; the pass-1 kernels (K4's loss_cot, K6's soft_sum)
    the params row and the table. The modes sources' instances (the same
    kernels over a Modes fold) take these shapes too."""
    words = launch_words(lay, cfg or RenderConfig())
    if words is not None:
        head = megakernel.shared_bytes(lay, words)
    else:
        head = 4 * lay.size
    sweep = head + 4 * GRAD_PITCH * lay.size
    return {"sweep_kernel": (GRAD_BLOCK, sweep), "soft_row_a_kernel": (GRAD_BLOCK, sweep),
            "soft_row_b_kernel": (GRAD_BLOCK, sweep + lay.size),
            "loss_cot_kernel": (GRAD_BLOCK, head), "soft_sum_kernel": (GRAD_BLOCK, head)}


def _scratch_cols(lib, table, cfg: RenderConfig, n_rows: int, n_frames: int = 1) -> int:
    """Columns of a launch's (rows, n_cols) partials over ``n_rows`` image
    rows, as the library sizes them: blocks per frame or params row, times
    ``n_frames`` (K6: its 2 rows)."""
    n_cols = lib.fourd_grad_scratch_cols(ctypes.addressof(table), cfg.width, n_rows, n_frames)
    if n_cols < 0:
        raise ValueError(f"the gradient kernels cannot launch {n_frames} frames of "
                         f"{n_rows} x {cfg.width} pixels")
    return n_cols


# The occupancy of K4's sweep by launch (layout, descriptor, bounce count,
# modes codes, device): (resident blocks a SM, the card's SMs), queried at
# the first such launch; OCCUPANCY_QUERIES counts the queries.
_SWEEP_OCCUPANCY: dict = {}
OCCUPANCY_QUERIES = 0


def sweep_waves(blocks: int, resident_blocks: int, sms: int) -> float:
    """The waves a launch of ``blocks`` blocks takes on ``sms`` SMs that
    hold ``resident_blocks`` of them each at once."""
    return blocks / (resident_blocks * sms)


def _sweep_occupancy(lib, table, lay: params.Layout, cfg: RenderConfig, hints, modes,
                     device) -> tuple:
    """(resident blocks a SM, SMs) of the sweep instance that a K4 launch
    runs, at its dynamic shared memory (launch_shapes' sweep bytes), by the
    runtime's occupancy query on the current device (fourd_loss_grad_occupancy);
    queried once per launch key and kept, so a warm launch makes no CUDA
    runtime call for it."""
    global OCCUPANCY_QUERIES
    key = (lay, None if hints is None else bytes(hints), cfg.reflections_amount, modes,
           device.index)
    got = _SWEEP_OCCUPANCY.get(key)
    if got is None:
        out = (ctypes.c_int * 2)()
        if modes is None:
            err = lib.fourd_loss_grad_occupancy(table, cfg.reflections_amount, _addr(hints), out)
        else:
            err = lib.fourd_loss_grad_modes_occupancy(*modes, table, cfg.reflections_amount,
                                                      _addr(hints), out)
        if err != 0:
            raise RuntimeError(f"the sweep's occupancy query failed: cudaError {err}")
        OCCUPANCY_QUERIES += 1
        got = _SWEEP_OCCUPANCY[key] = (
            out[0], torch.cuda.get_device_properties(device).multi_processor_count)
    return got


def launch_loss_grad(packed: torch.Tensor, lay: params.Layout, cfg: RenderConfig,
                     seeds: torch.Tensor, target: torch.Tensor, rows=None, keep=None):
    """One kernel launch: (loss (), grad (P,)) float32, both scaled to the
    mean over F frames, views, pixels and channels, from the packed (P,)
    params, (F,) int32 seed words and the (V, H, W, 3) or (H, W, 3) float32
    target, on their CUDA device; with ``rows``, those rows' part, the
    target their (V, n_rows, W, 3) block. Under the freeze_hints contract
    ``keep`` is the packed mask (params.freeze_mask). While a profiler
    records, the span ``k4.launch`` holds the counters ``k4.resident_warps``
    (the sweep's resident warps a SM) and ``k4.sweep_waves`` (its blocks
    over the blocks the card holds at once)."""
    global LAUNCHES, SHARD_LAUNCHES, HINTED_LAUNCHES
    _check_launch(packed, lay, cfg, target)
    hints, keep_ptr = _launch_hints(lay, cfg, keep, packed.device)
    row0, n_rows = launch_rows(cfg, rows)
    device = packed.device
    if packed.dim() != 1:
        raise ValueError("the value-and-grad kernel takes one (P,) params vector")
    if (seeds.device != device or seeds.dtype != torch.int32 or seeds.dim() != 1
            or not seeds.is_contiguous()):
        raise ValueError("seeds must be a contiguous (F,) int32 tensor of uint32 words on the "
                         "params' CUDA device")
    total = lay.n_views * cfg.height * cfg.width
    if target.numel() != lay.n_views * n_rows * cfg.width * 3 or target.shape[-1] != 3:
        raise ValueError(f"target must hold {lay.n_views} x {n_rows} x {cfg.width} x 3 "
                         f"values, got {tuple(target.shape)}")
    with profiling.span("k4.launch"):
        lib = build.load()
        n_frames = seeds.numel()
        table = (ctypes.c_int * len(lay))(*lay)
        n_cols = _scratch_cols(lib, table, cfg, n_rows, n_frames)
        g_mean = torch.empty((n_frames, *target.shape), dtype=torch.float32, device=device)
        grad_parts = torch.empty((lay.size, n_cols), dtype=torch.float32, device=device)
        loss_parts = torch.empty((n_cols,), dtype=torch.float64, device=device)
        grad = torch.empty((lay.size,), dtype=torch.float32, device=device)
        loss = torch.empty((), dtype=torch.float32, device=device)
        scale = float(np.float32(1.0 / (n_frames * total * 3)))
        modes = _modes(cfg, lay)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream().cuda_stream
            args = (packed.data_ptr(), seeds.data_ptr(), n_frames, ctypes.addressof(table),
                    cfg.width, cfg.height, row0, n_rows, cfg.samples, cfg.reflections_amount,
                    float(np.float32(cfg.small_indent)), float(np.float32(cfg.light_coefficient)),
                    target.data_ptr(), scale, g_mean.data_ptr(), grad_parts.data_ptr(),
                    loss_parts.data_ptr(), grad.data_ptr(), loss.data_ptr(), _addr(hints),
                    keep_ptr, stream)
            resident, sms = _sweep_occupancy(lib, table, lay, cfg, hints, modes, device)
            if modes is None:
                err = lib.fourd_loss_grad_launch(*args)
            else:
                err = lib.fourd_loss_grad_modes(*modes, *args)
        if err == 0:
            profiling.count("k4.resident_warps", resident * GRAD_BLOCK // 32)
            profiling.count("k4.sweep_waves", sweep_waves(n_cols, resident, sms))
    if err != 0:
        raise RuntimeError(f"value-and-grad kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    SHARD_LAUNCHES += int(n_rows < cfg.height)
    HINTED_LAUNCHES += int(hinted(cfg))
    _count(CONFIG_LAUNCHES, cfg, lay)
    return loss, grad


def loss_and_grad_cuda(packed: torch.Tensor, like_scene: Scene, like_camera: Camera,
                       cfg: RenderConfig, seed, target, rows=None):
    """(loss, (P,) gradient) of the packed CUDA vector by one kernel
    launch (with ``rows``, those rows' part, ``target`` their block); a
    vector on another device raises. The launch's inputs are the span
    ``k4.pack``, the seeds' upload ``k4.upload``, the launch ``k4.launch``."""
    with profiling.span("k4.pack"):
        cfg = _auto_hints(like_scene, cfg)
        check_kernel_config(cfg)
        lay = params.layout(like_scene, like_camera)
        target = torch.as_tensor(target, dtype=torch.float32, device=packed.device).contiguous()
        packed = packed.detach().contiguous()
        keep = params.freeze_mask(cfg, like_scene, lay.size, packed.device)
    with profiling.span("k4.upload"):
        words, _ = renderer.seed_words(seed)
        seeds = seed_tensor(words, packed.device)
    return launch_loss_grad(packed, lay, cfg, seeds, target, rows, keep)


def loss_and_grad_packed(packed: torch.Tensor, like_scene: Scene, like_camera: Camera,
                         cfg: RenderConfig, seed, target, rows=None):
    """(loss, (P,) gradient) of the packed vector: the plain version for a
    CPU vector, the kernel for a CUDA one; both take what the kernel takes
    (check_kernel_config)."""
    check_kernel_config(cfg)
    if packed.device.type == "cpu":
        return loss_and_grad_plain(packed, like_scene, like_camera, cfg, seed, target, rows=rows)
    if packed.device.type != "cuda":
        raise ValueError(f"the value-and-grad path takes CPU or CUDA tensors, got {packed.device}")
    return loss_and_grad_cuda(packed, like_scene, like_camera, cfg, seed, target, rows)


def render_loss_and_grad_kernel(scene: Scene, camera: Camera, cfg: RenderConfig, seed, target):
    """(loss, (grad_scene, grad_camera)) of ``image_loss`` at a fixed
    seed, the gradients shaped like the scene and the camera."""
    packed = params.pack(scene, camera)
    loss, grad = loss_and_grad_packed(packed, scene, camera, cfg, seed, target)
    return loss, params.unpack(grad, scene, camera)


def make_packed_loss_and_grad(scene: Scene, camera: Camera, cfg: RenderConfig):
    """Packed-space loss and gradient for a training loop over the scene:
    returns ``(fn, scene_vec0, unpack)`` with

    * ``fn(scene_vec, seed, target) -> (loss, grad_scene_vec)``; the
      camera rides along as a constant;
    * ``scene_vec0`` the scene's slice of the packed vector;
    * ``unpack(scene_vec) -> Scene``.

    Under the freeze_hints contract the hints are derived here, once, and
    the frozen slots of the gradient are 0 (gradkernel.py:990-1017).
    """
    cfg = _auto_hints(scene, cfg)
    check_kernel_config(cfg)
    packed = params.pack(scene, camera).detach()
    n = params.n_scene(scene)
    cam_vec = packed[n:]

    def fn(scene_vec, seed, target):
        full = torch.cat([scene_vec.detach(), cam_vec])
        loss, grad = loss_and_grad_packed(full, scene, camera, cfg, seed, target)
        return loss, grad[:n]

    def unpack(scene_vec):
        return params.unpack(torch.cat([scene_vec, cam_vec]), scene, camera)[0]

    return fn, packed[:n].clone(), unpack


def _scalar_seed(seed) -> int:
    words, batched = renderer.seed_words(seed)
    if batched:
        raise ValueError("the light-VJP and soft kernels take one scalar seed")
    return words[0]


# --- K5: the light-VJP kernel ------------------------------------------------

@torch.enable_grad()
def render_light_vjp_plain(packed: torch.Tensor, like_scene: Scene, like_camera: Camera,
                           cfg: RenderConfig, seed, cot_light, rows=None) -> torch.Tensor:
    """The plain version of K5: the gradient of sum(render_light * cot_light)
    w.r.t. the packed vector, by autograd over the plain pipeline. A (P,)
    vector takes an (H, W, 3) or (V, H, W, 3) cotangent and gives (P,);
    (F, P) rows of same-structure scenes take (F, ...) cotangents and give
    (F, P). With ``rows``, over those image rows, the cotangent their
    block. Under the freeze_hints contract the pipeline folds with the
    hints and the frozen slots come out 0."""
    cfg = _auto_hints(like_scene, cfg)
    renderer.check_trainable(cfg)
    seed = _scalar_seed(seed)
    row0, n_rows = launch_rows(cfg, rows)
    band = slice(row0, row0 + n_rows)
    vec = packed.detach().clone().requires_grad_(True)
    vecs = vec if vec.dim() == 2 else vec[None]
    light = torch.stack([renderer.render_light(*params.unpack(v, like_scene, like_camera), cfg,
                                               seed, band) for v in vecs])
    cot = torch.as_tensor(cot_light, dtype=torch.float32, device=vec.device).reshape(light.shape)
    (grad,) = torch.autograd.grad(light, vec, cot)
    return freeze(grad, like_scene, cfg)


def launch_light_vjp(packed: torch.Tensor, lay: params.Layout, cfg: RenderConfig, seed: int,
                     cot: torch.Tensor, rows=None, keep=None) -> torch.Tensor:
    """One K5 launch: the unscaled packed gradient, (P,) or (F, P) like
    ``packed``, from the light cotangent ``cot`` ((F,) V, H, W, 3 float32;
    with ``rows``, the block of those rows) at one uint32 seed, on their
    CUDA device. Under the freeze_hints contract ``keep`` is the packed
    mask (params.freeze_mask), which every params row shares."""
    global VJP_LAUNCHES, SHARD_VJP_LAUNCHES, HINTED_VJP_LAUNCHES
    _check_launch(packed, lay, cfg, cot)
    hints, keep_ptr = _launch_hints(lay, cfg, keep, packed.device)
    row0, n_rows = launch_rows(cfg, rows)
    multi = packed.dim() == 2
    n_vecs = packed.shape[0] if multi else 1
    if cot.numel() != n_vecs * lay.n_views * n_rows * cfg.width * 3 or cot.shape[-1] != 3:
        raise ValueError(f"the light cotangent must hold {n_vecs} x {lay.n_views} x {n_rows} "
                         f"x {cfg.width} x 3 values, got {tuple(cot.shape)}")
    lib = build.load()
    table = (ctypes.c_int * len(lay))(*lay)
    n_cols = _scratch_cols(lib, table, cfg, n_rows)
    grad_parts = torch.empty((n_vecs * lay.size, n_cols), dtype=torch.float32, device=packed.device)
    grad = torch.empty(packed.shape, dtype=torch.float32, device=packed.device)
    modes = _modes(cfg, lay)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (packed.data_ptr(), lay.size if multi else 0, n_vecs, seed, ctypes.addressof(table),
                cfg.width, cfg.height, row0, n_rows, cfg.samples, cfg.reflections_amount,
                float(np.float32(cfg.small_indent)), cot.data_ptr(), grad_parts.data_ptr(),
                grad.data_ptr(), _addr(hints), keep_ptr, stream)
        if modes is None:
            err = lib.fourd_light_vjp_launch(*args)
        else:
            err = lib.fourd_light_vjp_modes(*modes, *args)
    if err != 0:
        raise RuntimeError(f"light-VJP kernel launch failed: cudaError {err}")
    VJP_LAUNCHES += 1
    SHARD_VJP_LAUNCHES += int(n_rows < cfg.height)
    HINTED_VJP_LAUNCHES += int(hinted(cfg))
    _count(CONFIG_VJP_LAUNCHES, cfg, lay)
    return grad


def render_light_vjp_cuda(packed: torch.Tensor, like_scene: Scene, like_camera: Camera,
                          cfg: RenderConfig, seed, cot_light, rows=None) -> torch.Tensor:
    """K5 on a CUDA vector, as ``render_light_vjp_plain`` computes it: one
    launch for (P,) or for (F, P) rows; another device raises."""
    cfg = _auto_hints(like_scene, cfg)
    check_kernel_config(cfg)
    cot = torch.as_tensor(cot_light, dtype=torch.float32, device=packed.device).contiguous()
    lay = params.layout(like_scene, like_camera)
    return launch_light_vjp(packed.detach().contiguous(), lay, cfg, _scalar_seed(seed), cot, rows,
                            params.freeze_mask(cfg, like_scene, lay.size, packed.device))


# --- K6: the fused soft value-and-grad kernel --------------------------------

def zero_row(vec: torch.Tensor, zero_map) -> torch.Tensor:
    """``vec`` with the zero map's (slot, value) pairs written in: the packed
    row of the zeroed scene, whose zero-map slots are constants (no
    gradient flows to them from this row)."""
    idx = torch.tensor([i for i, _ in zero_map], device=vec.device)
    vals = torch.tensor([v for _, v in zero_map], dtype=torch.float32, device=vec.device)
    return vec.index_put((idx,), vals)


@torch.enable_grad()
def render_soft_loss_and_grad_plain(packed: torch.Tensor, like_scene: Scene,
                                    like_camera: Camera, cfg: RenderConfig, seed, target, alpha,
                                    zero_map, band_rows: int | None = None, rows=None):
    """The plain version of K6: (loss, (P,) gradient, alpha cotangent) of
    mean((alpha * img_a + (1 - alpha) * img_b - target)^2), img_a the
    render of the packed scene and img_b of its zero-map row at the same
    seed, by autograd over the plain pipeline with ``alpha`` ((V,) H, W)
    an independent leaf. The loss sums in float64 over row bands of
    ``band_rows`` rows (the whole image by default), as
    ``loss_and_grad_plain`` does; with ``rows``, over those image rows,
    target, alpha and the alpha cotangent their blocks. Under the
    freeze_hints contract the pipeline folds with the hints and the frozen
    slots come out 0."""
    cfg = _auto_hints(like_scene, cfg)
    renderer.check_trainable(cfg)
    seed = _scalar_seed(seed)
    device = packed.device
    row0, n_rows = launch_rows(cfg, rows)
    target = torch.as_tensor(target, dtype=torch.float32, device=device)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=device).detach()
    count = torch.tensor(float(target.numel() // n_rows * cfg.height), dtype=torch.float64,
                         device=device)
    loss, grad = torch.zeros((), dtype=torch.float64, device=device), 0.0
    g_alpha = torch.zeros_like(alpha)
    step = band_rows or n_rows
    for top in range(0, n_rows, step):
        band = slice(top, min(top + step, n_rows))
        image_rows = slice(row0 + band.start, row0 + band.stop)
        vec = packed.detach().clone().requires_grad_(True)
        a = alpha[..., band, :].clone().requires_grad_(True)
        scene_a, camera = params.unpack(vec, like_scene, like_camera)
        scene_b, _ = params.unpack(zero_row(vec, zero_map), like_scene, like_camera)
        img_a = renderer.render_image(scene_a, camera, cfg, seed, image_rows)
        img_b = renderer.render_image(scene_b, camera, cfg, seed, image_rows)
        img = a[..., None] * img_a + (1.0 - a[..., None]) * img_b
        part = torch.sum(((img - target[..., band, :, :]) ** 2).double()) / count
        g, ga = torch.autograd.grad(part, (vec, a))
        loss, grad = loss + part.detach(), grad + g.double()
        g_alpha[..., band, :] = ga
    return loss.float(), freeze(grad.float(), like_scene, cfg), g_alpha


def check_zero_map(zero_map, lay: params.Layout) -> None:
    """Raise for a zero map K6 cannot take: 1 to MAX_ZERO_SLOTS slots of
    the packed vector (the launch holds them in a fixed array; a longer
    map is refused, never cut)."""
    if not 0 < len(zero_map) <= MAX_ZERO_SLOTS or any(not 0 <= i < lay.size for i, _ in zero_map):
        raise ValueError(f"the zero map needs 1 to {MAX_ZERO_SLOTS} slots of the packed vector, "
                         f"got {zero_map!r}")


def launch_soft_loss_grad(packed: torch.Tensor, lay: params.Layout, cfg: RenderConfig, seed: int,
                          target: torch.Tensor, alpha: torch.Tensor, zero_map, rows=None,
                          keep=None):
    """One K6 launch: (loss (), grad (P,), alpha cotangent shaped like
    ``alpha``) float32, all scaled to the mean over views, pixels and
    channels, from the packed (P,) params, one uint32 seed, the
    (V,) H, W, 3 target, the (V,) H, W coverage alpha and the zero map's
    static (slot, value) pairs, on their CUDA device; with ``rows``, those
    rows' part, target, alpha and alpha cotangent their blocks. Under the
    freeze_hints contract ``keep`` is the packed mask (params.freeze_mask); both rows
    fold with the hints (zero_object keeps every wall), each over a table of
    its own params, so row b's folds a zeroed composite to a miss. A scene
    with composites takes the composite folds (softcomposite.cu)."""
    global SOFT_LAUNCHES, SHARD_SOFT_LAUNCHES, HINTED_SOFT_LAUNCHES
    check_zero_map(zero_map, lay)
    _check_launch(packed, lay, cfg, target, alpha)
    hints, keep_ptr = _launch_hints(lay, cfg, keep, packed.device)
    row0, n_rows = launch_rows(cfg, rows)
    total = lay.n_views * cfg.height * cfg.width
    block = lay.n_views * n_rows * cfg.width
    if packed.dim() != 1:
        raise ValueError("the soft kernel takes one (P,) params vector")
    if target.numel() != block * 3 or target.shape[-1] != 3 or alpha.numel() != block:
        raise ValueError(f"target and alpha must hold {lay.n_views} x {n_rows} x {cfg.width} "
                         f"(x 3) values, got {tuple(target.shape)} and {tuple(alpha.shape)}")
    lib = build.load()
    table = (ctypes.c_int * len(lay))(*lay)
    n_cols = _scratch_cols(lib, table, cfg, n_rows, n_frames=2)
    n = len(zero_map)
    slots = (ctypes.c_int * n)(*(i for i, _ in zero_map))
    values = (ctypes.c_float * n)(*(v for _, v in zero_map))
    device = packed.device
    sums = torch.empty((2, *target.shape), dtype=torch.float32, device=device)
    row_b = torch.empty(alpha.shape, dtype=torch.int32, device=device)
    grad_parts = torch.empty((lay.size, n_cols), dtype=torch.float32, device=device)
    loss_parts = torch.empty((n_cols,), dtype=torch.float64, device=device)
    grad = torch.empty((lay.size,), dtype=torch.float32, device=device)
    loss = torch.empty((), dtype=torch.float32, device=device)
    alpha_cot = torch.empty_like(alpha)
    scale = float(np.float32(1.0 / (total * 3)))
    modes = _modes(cfg, lay)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (packed.data_ptr(), seed, ctypes.addressof(table), n, ctypes.addressof(slots),
                ctypes.addressof(values), cfg.width, cfg.height, row0, n_rows, cfg.samples,
                cfg.reflections_amount, float(np.float32(cfg.small_indent)),
                float(np.float32(cfg.light_coefficient)), target.data_ptr(), alpha.data_ptr(),
                scale, sums.data_ptr(), row_b.data_ptr(), grad_parts.data_ptr(),
                loss_parts.data_ptr(), grad.data_ptr(), loss.data_ptr(), alpha_cot.data_ptr(),
                _addr(hints), keep_ptr, stream)
        if modes is None:
            err = lib.fourd_soft_loss_grad_launch(*args)
        else:
            err = lib.fourd_soft_loss_grad_modes(*modes, *args)
    if err != 0:
        raise RuntimeError(f"soft value-and-grad kernel launch failed: cudaError {err}")
    SOFT_LAUNCHES += 1
    SHARD_SOFT_LAUNCHES += int(n_rows < cfg.height)
    HINTED_SOFT_LAUNCHES += int(hinted(cfg))
    _count(CONFIG_SOFT_LAUNCHES, cfg, lay)
    return loss, grad, alpha_cot


def render_soft_loss_and_grad_cuda(packed: torch.Tensor, like_scene: Scene, like_camera: Camera,
                                   cfg: RenderConfig, seed, target, alpha, zero_map, rows=None):
    """K6 on a CUDA vector, as ``render_soft_loss_and_grad_plain``
    computes it, in one launch; another device raises."""
    cfg = _auto_hints(like_scene, cfg)
    check_kernel_config(cfg)
    device = packed.device
    target = torch.as_tensor(target, dtype=torch.float32, device=device).contiguous()
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=device).detach().contiguous()
    lay = params.layout(like_scene, like_camera)
    return launch_soft_loss_grad(packed.detach().contiguous(), lay, cfg, _scalar_seed(seed),
                                 target, alpha, zero_map, rows,
                                 params.freeze_mask(cfg, like_scene, lay.size, device))


# --- K3: the row-sharded launches of K4, K5 and K6 -------------------------------

def _shard(packed: torch.Tensor, cfg: RenderConfig, mesh: pmesh.Mesh) -> tuple:
    """The rank's (row0, n_rows), its block of the rows split over every
    rank of the mesh (``megakernel.kernel_block``: ``cfg`` validated by
    check_kernel_config on every rank first; n_rows 0 launches nothing),
    and the slice of them; raises for a vector off the mesh's device."""
    row0, n_rows = megakernel.kernel_block(mesh, cfg, packed.device, check_kernel_config)
    return (row0, n_rows), slice(row0, row0 + n_rows)


def _as_block(x, band: slice, device, channels: bool) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    return (x[..., band, :, :] if channels else x[..., band, :]).contiguous()


def _zeros_like_grad(packed: torch.Tensor) -> tuple:
    """(loss, gradient) of an empty block of rows: exact zeros, the
    all-reduce's share of a rank that makes no launch."""
    return (torch.zeros((), dtype=torch.float32, device=packed.device),
            torch.zeros(packed.shape, dtype=torch.float32, device=packed.device))


def sharded_loss_and_grad(packed: torch.Tensor, like_scene: Scene, like_camera: Camera,
                          cfg: RenderConfig, seed, target, mesh: pmesh.Mesh):
    """K4 row-sharded over every rank of the mesh, whatever its shape
    (sharded_loss_and_grad_pallas, gradkernel.py:1060-1137): each rank
    launches once on its block of the rows of the whole-image ``target``
    (none on an empty block), then one all-reduce of the packed [loss,
    grad] gives every rank the whole image's (loss, (P,) gradient), equal
    to the single launch up to the order of the sums (the forward of
    ``diff.image_loss_kernel`` with a mesh). CPU vectors run the plain
    version on the rank's rows."""
    rows, band = _shard(packed, cfg, mesh)
    if rows[1] == 0:
        loss, grad = _zeros_like_grad(packed)
    else:
        target = _as_block(target, band, packed.device, channels=True)
        loss, grad = loss_and_grad_packed(packed, like_scene, like_camera, cfg, seed, target, rows)
    loss, grad = pmesh.all_reduce_sum([loss, grad], mesh)
    return loss, grad


def sharded_render_light_vjp_multi(packed: torch.Tensor, like_scene: Scene, like_camera: Camera,
                                   cfg: RenderConfig, seed, cot_block, mesh: pmesh.Mesh):
    """K5 row-sharded over every rank of the mesh
    (sharded_render_light_vjp_pallas_multi, gradkernel.py:535-622): each
    rank launches once on its block of rows with ``cot_block``, its rows'
    block (F, ..., n_rows, W, 3) of the light cotangent of (F, P) params
    rows (or (P,)), none on an empty block, and one all-reduce gives every
    rank the whole image's gradient (the backward of
    ``diff.render_light_pair`` with a mesh)."""
    rows, _ = _shard(packed, cfg, mesh)
    if rows[1] == 0:
        grad = _zeros_like_grad(packed)[1]
    elif packed.device.type == "cpu":
        grad = render_light_vjp_plain(packed, like_scene, like_camera, cfg, seed, cot_block, rows)
    else:
        grad = render_light_vjp_cuda(packed, like_scene, like_camera, cfg, seed, cot_block, rows)
    (grad,) = pmesh.all_reduce_sum([grad], mesh)
    return grad


def sharded_soft_loss_and_grad(packed: torch.Tensor, like_scene: Scene, like_camera: Camera,
                               cfg: RenderConfig, seed, target, alpha, zero_map,
                               mesh: pmesh.Mesh):
    """K6 row-sharded over every rank of the mesh
    (sharded_soft_loss_and_grad_pallas, gradkernel.py:1456-1515): each rank
    launches once on its block of the rows of the whole-image ``target``
    and ``alpha`` (none on an empty block), and one all-reduce of the
    packed [loss, grad] gives every rank the whole image's (the forward of
    ``diff.soft_image_loss_kernel`` with a mesh). The alpha cotangent stays
    the rank's block of rows (``mesh.kernel_rows``)."""
    rows, band = _shard(packed, cfg, mesh)
    target = _as_block(target, band, packed.device, channels=True)
    alpha = _as_block(alpha, band, packed.device, channels=False)
    if rows[1] == 0:
        loss, grad = _zeros_like_grad(packed)
        g_alpha = torch.zeros_like(alpha)
    elif packed.device.type == "cpu":
        loss, grad, g_alpha = render_soft_loss_and_grad_plain(
            packed, like_scene, like_camera, cfg, seed, target, alpha, zero_map, rows=rows)
    else:
        loss, grad, g_alpha = render_soft_loss_and_grad_cuda(
            packed, like_scene, like_camera, cfg, seed, target, alpha, zero_map, rows)
    loss, grad = pmesh.all_reduce_sum([loss, grad], mesh)
    return loss, grad, g_alpha
