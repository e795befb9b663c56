"""Wrapper of the forward megakernel (csrc/megakernel.cu).

Counterpart of fourd_ray_tracing_tpu/ops/pallas/megakernel.py's
render_light_pallas / render_image_pallas (K1),
render_light_pallas_multi (K2: F same-structure scenes at one seed, one
params row per frame) and their sharded forms
sharded_render_light_pallas[_multi] / sharded_render_image_pallas (K3:
here one launch per rank on its block of image rows, parallel/mesh.py).
Tensors on the CPU go through the plain torch pipeline
(models/renderer.py); tensors on a CUDA device go through the kernel, or
the call raises. ``LAUNCHES`` counts kernel launches, so a run can show
that its main path went through the kernel; ``HINTED_LAUNCHES`` counts
those of them that ran static hints, ``ROW_LAUNCHES`` those that read
per-frame params rows (K2), ``SHARD_LAUNCHES`` those that render a block
of rows smaller than the image (K3), and ``CONFIG_LAUNCHES`` every launch
by its configuration (``launch_config``: rng_mode/sampler_method/intersect,
"/cells" for a hypercube without generators).

The production configuration (per-sample streams, the poly sampler, the
fast fold) launches fourd_forward_launch (csrc/megakernel.cu); every other
one fourd_forward_modes_launch (csrc/forwardmodes.cu), whose instances
take the sequential stream, the kepler and newton samplers, the literal
spec and trig folds, and the fast fold over a hypercube without
generators.

The static hints (``cfg.plane_hints``, ``cfg.plane_pairs``: the
hyperplanes'; ``cfg.axis_hints``: the composite primitives' axes) select
the kernel's fold; the render entry points derive them from a concrete
scene when the config has none (``with_hints``, as megakernel.py:426-436
does) and hand them to the plain pipeline too on the CPU. A scene whose
normals or axes require grad gets none there. ``launch_forward`` renders
what its config says: the gradient paths' launches (diff.RenderLight)
carry no hints.

The forward kernel's measurement variants (tools/fwd_ablate.py) launch the
same kernel with stubs compiled in, or with the generic instance of its
fold (``launch_forward_variant``, counted in ``VARIANT_LAUNCHES``); their
plain version is the plain pipeline under ``stubs``, which patches the
renderer as the JAX tool patches its own.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from fourd_ray_tracing_tpu_torch.camera import Camera
from fourd_ray_tracing_tpu_torch.models import params, renderer
from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig
from fourd_ray_tracing_tpu_torch.models.scene import (Scene, axis_alignment_hints, plane_norm_hints,
                                                       plane_pair_hints)
from fourd_ray_tracing_tpu_torch.ops import rng
from fourd_ray_tracing_tpu_torch.ops.cuda import build
from fourd_ray_tracing_tpu_torch.ops.sky import light_to_color
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4
from fourd_ray_tracing_tpu_torch.parallel import mesh as pmesh
from fourd_ray_tracing_tpu_torch.utils import profiling

LAUNCHES = 0
HINTED_LAUNCHES = 0
ROW_LAUNCHES = 0
SHARD_LAUNCHES = 0
VARIANT_LAUNCHES = 0
CONFIG_LAUNCHES: dict = {}
# The launch's codes of the folds and samplers (csrc/forwardmodes.cu).
FOLD_CODES = {"fast": 0, "spec": 1, "trig": 2}
SAMPLER_CODES = {"poly": 0, "kepler": 1, "newton": 2}
# The hypercube's axis hint for one without generators (csrc/trace.cuh
# kCubeCells).
CUBE_CELLS = -2
# The stub variants and their kStub codes (csrc/trace.cuh); with
# GENERIC_FOLD, the variant launch's code for the fold's generic instance
# (megakernel.cu kGenericFold), which computes what the production kernel
# does.
VARIANTS = {"sampler_const": 1, "rng_const": 2, "both_const": 3}
GENERIC_FOLD = "generic_fold"
_VARIANT_CODES = {**VARIANTS, GENERIC_FOLD: 4}
# The kernel's threads a block (csrc/megakernel.cu kK1Block).
K1_BLOCK = 128


def _device_of(scene: Scene, camera: Camera) -> torch.device:
    devices = {t.device for t in params.leaves(scene, camera)}
    if len(devices) != 1:
        raise ValueError(f"scene and camera tensors lie on several devices: {devices}")
    return devices.pop()


def with_hints(scenes, cfg: RenderConfig) -> RenderConfig:
    """``cfg`` with the static hints of ``scenes`` (a Scene, or
    same-structure scenes that one launch renders as rows) where it has
    none and they can be derived: the hyperplanes' (plane_hints and
    plane_pairs: one set that every scene gives, a soft pair's zero_object
    row keeps the walls; no normal that requires grad; any number of
    hyperplanes, hint_table decides what a launch folds) and, apart from
    them, the composite
    primitives' axes (axis_hints, one set that every scene gives), as
    megakernel.py:426-436 derives both. Otherwise ``cfg`` as it is. Reads
    the scenes' hyperplanes and axes, a copy to the host each."""
    if cfg.intersect != "fast":
        return cfg
    scenes = [scenes] if isinstance(scenes, Scene) else list(scenes)
    updates = {}
    if cfg.plane_hints is None:
        found = set()
        for scene in scenes:
            hints = plane_norm_hints(scene)
            found.add((hints, plane_pair_hints(scene, hints)))
        if len(found) == 1:
            hints, pairs = found.pop()
            if hints is not None:
                updates.update(plane_hints=hints, plane_pairs=pairs)
    if cfg.axis_hints is None:
        found = {axis_alignment_hints(scene) for scene in scenes}
        if len(found) == 1 and None not in found:
            updates["axis_hints"] = found.pop()
    return dataclasses.replace(cfg, **updates) if updates else cfg


def hinted(cfg: RenderConfig) -> bool:
    """Whether ``cfg`` carries any static hint that its fold reads (the
    literal folds read none)."""
    return cfg.intersect == "fast" and (cfg.plane_hints is not None
                                        or cfg.axis_hints is not None)


def production(cfg: RenderConfig, lay: params.Layout) -> bool:
    """Whether a launch of ``cfg`` over ``lay`` takes the production
    instances (fourd_forward_launch): per-sample streams, the poly sampler,
    the fast fold, no hypercube without generators."""
    return (cfg.rng_mode == "per_sample" and cfg.sampler_method == "poly"
            and cfg.intersect == "fast" and not lay.hypercube_cells)


def launch_config(cfg: RenderConfig, lay: params.Layout) -> str:
    """The key of a launch in CONFIG_LAUNCHES."""
    key = f"{cfg.rng_mode}/{cfg.sampler_method}/{cfg.intersect}"
    return key + "/cells" if lay.hypercube_cells else key


def _family_code(pair) -> int:
    """A cylinder family's axis hint as the kernel reads it: k1 | k2 << 2,
    -1 when it is not aligned."""
    return -1 if pair is None else pair[0][0] | pair[1][0] << 2


def hint_table(cfg: RenderConfig, lay: params.Layout):
    """The kernel's int[HINT_INTS] descriptor of ``cfg``'s static hints
    and of the scene's composite primitives (csrc/trace.cuh Hints): the
    pairs (i | j << 8 | axis << 16), then the single planes (index | live
    components << 8), in the fold's order, n_singles -1 without plane
    hints; then the cylinder count, the composites' offsets in the params
    (``lay``; -1: none) and their axis hints (a family k1 | k2 << 2, the
    hypercube k_i << 2i | (s_i < 0) << (8 + i); -1: not aligned;
    CUBE_CELLS: a hypercube without generators). A literal fold (``cfg``'s
    intersect "spec" or "trig") takes no hints: its descriptor holds the
    composites' offsets alone.

    The table holds the hints of at most build.MAX_HINT_PLANES hyperplanes:
    a scene with more folds its hyperplanes unhinted (n_singles -1), which
    gives every hit, distance and material the hinted fold gives (the
    freeze_hints contract's frozen slots stay frozen: the gradient launches
    take the mask whatever the descriptor holds)."""
    words = (ctypes.c_int * build.HINT_INTS)()
    if cfg.intersect != "fast":
        cfg = dataclasses.replace(cfg, plane_hints=None, plane_pairs=None, axis_hints=None)
    n_spaces = lay.n_spaces
    if cfg.plane_hints is not None and len(cfg.plane_hints) != n_spaces:
        raise ValueError(f"plane_hints has {len(cfg.plane_hints)} entries for {n_spaces} "
                         "hyperplanes")
    if cfg.plane_hints is None or n_spaces > build.MAX_HINT_PLANES:
        words[1] = -1
    else:
        pairs, singles = cfg.plane_pairs or ((), range(n_spaces))
        words[0], words[1] = len(pairs), len(singles)
        for k, (i, j, axis) in enumerate(pairs):
            words[2 + k] = i | j << 8 | axis << 16
        for k, i in enumerate(singles):
            live = sum(1 << c for c, zero in enumerate(cfg.plane_hints[i]) if not zero)
            words[2 + build.MAX_HINT_PLANES // 2 + k] = i | live << 8
    if lay.n_cylinders > build.MAX_CYLINDERS:
        raise ValueError(f"the forward kernel takes at most {build.MAX_CYLINDERS} cylinders, "
                         f"got {lay.n_cylinders}")
    ah = cfg.axis_hints
    cyl_axes = list(ah.cylinders) if ah is not None else []
    if len(cyl_axes) not in (0, lay.n_cylinders):
        raise ValueError(f"axis_hints has {len(cyl_axes)} cylinders for {lay.n_cylinders}")
    union = (ah.cylinders_union if ah is not None else None) or (None, None)
    tiger = (ah.tiger if ah is not None else None) or (None, None)
    cube = -1
    if lay.hypercube_cells:
        cube = CUBE_CELLS
    elif ah is not None and ah.hypercube is not None:
        cube = sum(k << 2 * i | int(s < 0) << 8 + i for i, (k, s) in enumerate(ah.hypercube))
    c = build.HINT_COMPOSITES
    words[c:c + 5] = [lay.n_cylinders, lay.cylinders, lay.cylinders_union, lay.hypercube, lay.tiger]
    c += 5
    for k in range(build.MAX_CYLINDERS):
        words[c + k] = _family_code(cyl_axes[k] if k < len(cyl_axes) else None)
    c += build.MAX_CYLINDERS
    words[c:c + 5] = [_family_code(union[0]), _family_code(union[1]), cube,
                      _family_code(tiger[0]), _family_code(tiger[1])]
    return words


# Fold-table records (16 bytes each) of a cylinder (its family's 4 and its
# face's), the duocylinder, the hypercube and the tiger (csrc/trace.cuh
# build_fold_table).
_CYLINDER_RECS, _UNION_RECS, _HYPERCUBE_RECS, _TIGER_RECS = 5, 10, 8, 12


def shared_bytes(lay: params.Layout, table) -> int:
    """The launch's dynamic shared memory (csrc/megakernel.cu
    shared_bytes): the params padded to 16 bytes, and the fold table."""
    singles = lay.n_spaces if table[1] < 0 else table[1]
    recs = (1 + table[0] + 2 * singles + 2 * lay.n_spheres + _CYLINDER_RECS * lay.n_cylinders
            + _UNION_RECS * (lay.cylinders_union >= 0) + _HYPERCUBE_RECS * (lay.hypercube >= 0)
            + _TIGER_RECS * (lay.tiger >= 0))
    return 16 * ((lay.size + 3) // 4) + 16 * recs


def launch_shape(scene: Scene, lay: params.Layout) -> tuple:
    """(threads a block, dynamic shared-memory bytes) of the launch that
    renders ``scene`` (its hints derived) with layout ``lay``."""
    cfg = with_hints(scene, RenderConfig())
    return K1_BLOCK, shared_bytes(lay, hint_table(cfg, lay))


def seed_tensor(words, device) -> torch.Tensor:
    """uint32 seed words as the kernels' (F,) int32 tensor on ``device``:
    a copy from pageable memory, which waits for the device's stream
    (the span ``sync.seeds``)."""
    host = torch.from_numpy(np.asarray(words, np.uint32).view(np.int32))
    with profiling.sync("seeds", device):
        return host.to(device)


def launch_rows(cfg: RenderConfig, rows) -> tuple:
    """(row0, n_rows) of a launch over ``rows`` = (row0, n_rows), or over
    the whole image for None; raises for rows outside the image."""
    row0, n_rows = rows if rows is not None else (0, cfg.height)
    if not (0 <= row0 and 0 < n_rows and row0 + n_rows <= cfg.height):
        raise ValueError(f"rows [{row0}, {row0 + n_rows}) are not a block of {cfg.height} rows")
    return row0, n_rows


def layout_table(lay: params.Layout):
    """The kernels' int[] offset table of ``lay`` (csrc/trace.cuh Layout,
    then the composites' fields)."""
    return (ctypes.c_int * len(lay))(*lay)


def launch_forward(packed: torch.Tensor, lay: params.Layout, cfg: RenderConfig,
                   seeds: torch.Tensor, rows=None, tables=None) -> torch.Tensor:
    """One kernel launch: (F, V, n_rows, W, 3) float32 light of image rows
    ``rows`` = (row0, n_rows) (all H by default) from the packed params
    and (F,) int32 seed words, on their CUDA device. ``packed`` is (P,),
    one scene rendered at every seed (K1), or (F, P), frame f rendering
    row f at seeds[f] (K2). A block of rows is bitwise those rows of the
    whole image (K3). The fold takes ``cfg``'s static hints, if any, which
    every row shares. The production configuration (``production``) runs
    the production instances, any other forwardmodes.cu's. ``tables`` is
    (``hint_table(cfg, lay)``, ``layout_table(lay)``) made ahead, or None
    to make them here. The launch's host work is the span ``k1.launch``."""
    global LAUNCHES, HINTED_LAUNCHES, ROW_LAUNCHES, SHARD_LAUNCHES
    renderer.check_supported(cfg)
    row0, n_rows = launch_rows(cfg, rows)
    if packed.device.type != "cuda" or seeds.device != packed.device:
        raise ValueError(f"kernel inputs must share one CUDA device, got {packed.device}, {seeds.device}")
    if (packed.dtype != torch.float32 or packed.dim() not in (1, 2)
            or not packed.is_contiguous()):
        raise ValueError("packed params must be a contiguous (P,) or (F, P) float32 tensor")
    if packed.shape[-1] != lay.size:
        raise ValueError(f"packed params hold {packed.shape[-1]} floats, layout expects {lay.size}")
    if seeds.dtype != torch.int32 or seeds.dim() != 1 or not seeds.is_contiguous():
        raise ValueError("seeds must be a contiguous (F,) int32 tensor of uint32 words")
    multi = packed.dim() == 2
    if multi and packed.shape[0] != seeds.numel():
        raise ValueError(f"{packed.shape[0]} params rows for {seeds.numel()} seeds")
    with profiling.span("k1.launch"):
        hints, table = tables if tables is not None else (hint_table(cfg, lay), layout_table(lay))
        lib = build.load()
        n_frames = seeds.numel()
        out = torch.empty((n_frames, lay.n_views, n_rows, cfg.width, 3),
                          dtype=torch.float32, device=packed.device)
        with torch.cuda.device(packed.device):
            stream = torch.cuda.current_stream().cuda_stream
            args = (packed.data_ptr(), lay.size if multi else 0, seeds.data_ptr(), n_frames,
                    ctypes.addressof(table), ctypes.addressof(hints),
                    cfg.width, cfg.height, row0, n_rows, cfg.samples, cfg.reflections_amount,
                    float(np.float32(cfg.small_indent)), out.data_ptr(), stream)
            if production(cfg, lay):
                err = lib.fourd_forward_launch(*args)
            else:
                err = lib.fourd_forward_modes_launch(*mode_codes(cfg), *args)
    if err != 0:
        raise RuntimeError(f"forward kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    HINTED_LAUNCHES += int(hinted(cfg))
    ROW_LAUNCHES += int(multi)
    SHARD_LAUNCHES += int(n_rows < cfg.height)
    key = launch_config(cfg, lay)
    CONFIG_LAUNCHES[key] = CONFIG_LAUNCHES.get(key, 0) + 1
    return out


def mode_codes(cfg: RenderConfig) -> tuple:
    """(fold, sampler, sequential, sampler_iters) of fourd_forward_modes_launch."""
    return (FOLD_CODES[cfg.intersect], SAMPLER_CODES[cfg.sampler_method],
            int(cfg.rng_mode == "sequential"), cfg.sampler_iters)


class K1Inputs(NamedTuple):
    """What a K1 launch reads besides its seeds, made by ``pack_inputs``:
    the hinted config, the (P,) packed params and their layout, the hint
    and offset tables (``launch_forward``'s ``tables``) and whether the
    camera carries a view axis. A launch leaves them as they are, so they
    serve any number of launches of one scene and camera."""

    cfg: RenderConfig
    packed: torch.Tensor
    lay: params.Layout
    hints: ctypes.Array
    table: ctypes.Array
    view_axis: bool


def pack_inputs(scene: Scene, camera: Camera, cfg: RenderConfig) -> K1Inputs:
    """The packing half of ``render_light_cuda``: the launch inputs of
    ``scene`` seen by ``camera`` on their CUDA device, the static hints
    derived when ``cfg`` has none (``with_hints``); raises for tensors on
    any other device."""
    return _pack(scene, camera, with_hints(scene, cfg), _device_of(scene, camera))


def _pack(scene: Scene, camera: Camera, cfg: RenderConfig, device) -> K1Inputs:
    if device.type != "cuda":
        raise ValueError(f"the forward kernel takes CUDA tensors, got {device}")
    renderer.check_supported(cfg)
    with profiling.span("k1.pack"):
        lay = params.layout(scene, camera)
        return K1Inputs(cfg, params.pack(scene, camera), lay, hint_table(cfg, lay),
                        layout_table(lay), camera.top.x.dim() > 0)


def render_packed(inputs: K1Inputs, seeds) -> torch.Tensor:
    """The launch half of ``render_light_cuda``: the seeds' upload (the span
    ``k1.upload``) and one launch of ``inputs``, the light shaped as
    ``render_light_cuda`` shapes it."""
    with profiling.span("k1.upload"):
        words, batched = renderer.seed_words(seeds)
        seeds_on_card = seed_tensor(words, inputs.packed.device)
    out = launch_forward(inputs.packed, inputs.lay, inputs.cfg, seeds_on_card,
                         tables=(inputs.hints, inputs.table))
    if not inputs.view_axis:
        out = out[:, 0]
    return out if batched else out[0]


def render_light_cuda(scene: Scene, camera: Camera, cfg: RenderConfig, seeds) -> torch.Tensor:
    """Sample-averaged light: (H, W, 3), (V, H, W, 3), or with a (K,)
    seed vector (K, H, W, 3) / (K, V, H, W, 3) from ONE launch; frame k
    is bitwise the launch with the scalar seed seeds[k]. The static hints
    are derived when ``cfg`` has none (``with_hints``). On the card it is
    ``pack_inputs`` (the span ``k1.pack``), then ``render_packed``."""
    device = _device_of(scene, camera)
    cfg = with_hints(scene, cfg)
    if device.type == "cpu":
        return renderer.render_light(scene, camera, cfg, seeds)
    return render_packed(_pack(scene, camera, cfg, device), seeds)


def render_image_cuda(scene: Scene, camera: Camera, cfg: RenderConfig, seeds) -> torch.Tensor:
    """Tone-mapped image through the kernel; the tone map is plain torch."""
    return light_to_color(render_light_cuda(scene, camera, cfg, seeds), cfg.light_coefficient)


def render_light_cuda_multi(scenes, camera: Camera, cfg: RenderConfig, seed) -> torch.Tensor:
    """Mean light of F same-structure scenes at one scalar seed, stacked on
    a leading scene axis: (F, H, W, 3) or (F, V, H, W, 3) from ONE launch
    (K2); row f is bitwise ``render_light_cuda(scenes[f], ...)``."""
    device = _device_of(scenes[0], camera)
    cfg = with_hints(scenes, cfg)
    if device.type == "cpu":
        return torch.stack([renderer.render_light(s, camera, cfg, seed) for s in scenes])
    if device.type != "cuda":
        raise ValueError(f"render_light_cuda_multi takes CPU or CUDA tensors, got {device}")
    renderer.check_supported(cfg)
    words, batched = renderer.seed_words(seed)
    if batched:
        raise ValueError("the multi-scene render takes one scalar seed")
    rows = params.stack_rows(scenes, camera)
    out = launch_forward(rows, params.layout(scenes[0], camera), cfg,
                         seed_tensor(words * len(scenes), device))
    return out[:, 0] if camera.top.x.dim() == 0 else out


# --- K3: the row-sharded launches ----------------------------------------------

def kernel_block(mesh: pmesh.Mesh, cfg: RenderConfig, device,
                 check=renderer.check_supported) -> tuple:
    """(row0, n_rows) of this rank's sharded launch (``mesh.kernel_rows``),
    ``cfg`` validated by ``check`` first. Every sharded wrapper takes its
    block here and launches nothing when ``n_rows`` is 0 (fewer rows than
    ranks), so every rank validates alike and none raises alone while the
    others wait for it in a collective."""
    check(cfg)
    return mesh.kernel_rows(cfg.height, device)


def _empty_rows(cfg: RenderConfig, camera: Camera, n_frames: int, device) -> torch.Tensor:
    """The light of an empty block of rows: (n_frames, [V,] 0, W, 3)."""
    views = () if camera.top.x.dim() == 0 else (camera.top.x.numel(),)
    return torch.zeros((n_frames, *views, 0, cfg.width, 3), dtype=torch.float32, device=device)


def sharded_render_light_cuda(scene: Scene, camera: Camera, cfg: RenderConfig, seeds,
                              mesh: pmesh.Mesh, gather: bool = True) -> torch.Tensor:
    """``render_light_cuda`` row-sharded over every rank of the mesh, whatever
    its shape (K3, sharded_render_light_pallas, megakernel.py:619): each
    rank makes one launch on its block of rows (``mesh.kernel_rows``; none
    on an empty block), bitwise those rows of the single launch. ``gather``
    (the default) returns the whole light on every rank, ``gather=False``
    the rank's block. Tensors on the CPU run the plain pipeline on the
    rank's rows; tensors off the mesh's device raise."""
    device = _device_of(scene, camera)
    cfg = with_hints(scene, cfg)
    row0, n_rows = kernel_block(mesh, cfg, device)
    words, batched = renderer.seed_words(seeds)
    if n_rows == 0:
        out = _empty_rows(cfg, camera, len(words), device)
        out = out if batched else out[0]
    elif device.type == "cpu":
        out = renderer.render_light(scene, camera, cfg, seeds, slice(row0, row0 + n_rows))
    else:
        out = launch_forward(params.pack(scene, camera), params.layout(scene, camera), cfg,
                             seed_tensor(words, device), (row0, n_rows))
        if camera.top.x.dim() == 0:
            out = out[:, 0]
        out = out if batched else out[0]
    return pmesh.gather_kernel_rows(out, mesh, cfg.height) if gather else out


def sharded_render_image_cuda(scene: Scene, camera: Camera, cfg: RenderConfig, seeds,
                              mesh: pmesh.Mesh, gather: bool = True) -> torch.Tensor:
    """``sharded_render_light_cuda`` tone-mapped (plain torch)."""
    image = light_to_color(sharded_render_light_cuda(scene, camera, cfg, seeds, mesh, gather=False),
                           cfg.light_coefficient)
    return pmesh.gather_kernel_rows(image, mesh, cfg.height) if gather else image


def sharded_render_light_cuda_multi(scenes, camera: Camera, cfg: RenderConfig, seed,
                                    mesh: pmesh.Mesh, gather: bool = True) -> torch.Tensor:
    """``render_light_cuda_multi`` (K2) row-sharded over every rank of the
    mesh (megakernel.py:725): one launch per rank on its block of rows
    (none on an empty block), (F, [V,] rows, W, 3) (the forward of
    ``diff.render_light_pair`` with a mesh)."""
    device = _device_of(scenes[0], camera)
    cfg = with_hints(scenes, cfg)
    row0, n_rows = kernel_block(mesh, cfg, device)
    words, batched = renderer.seed_words(seed)
    if batched:
        raise ValueError("the multi-scene render takes one scalar seed")
    if n_rows == 0:
        out = _empty_rows(cfg, camera, len(scenes), device)
    elif device.type == "cpu":
        out = torch.stack([renderer.render_light(s, camera, cfg, seed, slice(row0, row0 + n_rows))
                           for s in scenes])
    else:
        out = launch_forward(params.stack_rows(scenes, camera), params.layout(scenes[0], camera),
                             cfg, seed_tensor(words * len(scenes), device), (row0, n_rows))
        out = out[:, 0] if camera.top.x.dim() == 0 else out
    return pmesh.gather_kernel_rows(out, mesh, cfg.height) if gather else out


# --- the measurement variants (tools/fwd_ablate.py) ---------------------------

def const_direction(u_w, u_z, u_fi, **_):
    """The stubbed S^3 sampler: (0.5, 0.5, 0.5, 0.5), a unit vector
    (the JAX tool's const_dir, fwd_ablate.py:113-115)."""
    half = torch.full_like(u_w, 0.5)
    return Vec4(half, half, half, half)


def const_uniform(pixel_bits, seed, counter, active):
    """The stubbed RNG: every uniform 0.5, no hash, the counter unchanged
    (the JAX tool's const_mu, fwd_ablate.py:117-118)."""
    return torch.full(pixel_bits.shape, 0.5, dtype=torch.float32, device=pixel_bits.device), counter


@contextlib.contextmanager
def stubs(variant: str | None):
    """The plain pipeline with ``variant``'s stubs (None and GENERIC_FOLD:
    none): patches ``renderer.direction_from_uniforms`` and
    ``rng.masked_uniform01``, the names the renderer calls them by, and
    restores them on exit."""
    code = 0 if variant is None else _VARIANT_CODES[variant]
    saved = renderer.direction_from_uniforms, rng.masked_uniform01
    try:
        if code & 1:
            renderer.direction_from_uniforms = const_direction
        if code & 2:
            rng.masked_uniform01 = const_uniform
        yield
    finally:
        renderer.direction_from_uniforms, rng.masked_uniform01 = saved


def launch_forward_variant(variant: str, packed: torch.Tensor, lay: params.Layout,
                           cfg: RenderConfig, seeds: torch.Tensor) -> torch.Tensor:
    """``launch_forward`` (one scene, the whole image) with ``variant``'s
    stubs compiled into the kernel, or the fold's generic instance:
    (F, V, H, W, 3) float32 light."""
    global VARIANT_LAUNCHES
    if packed.device.type != "cuda" or seeds.device != packed.device:
        raise ValueError(f"kernel inputs must share one CUDA device, got {packed.device}, {seeds.device}")
    if (packed.dtype != torch.float32 or packed.dim() != 1 or not packed.is_contiguous()
            or packed.shape[0] != lay.size):
        raise ValueError(f"packed params must be a contiguous ({lay.size},) float32 tensor")
    if seeds.dtype != torch.int32 or seeds.dim() != 1 or not seeds.is_contiguous():
        raise ValueError("seeds must be a contiguous (F,) int32 tensor of uint32 words")
    hints = hint_table(cfg, lay)
    lib = build.load()
    n_frames = seeds.numel()
    out = torch.empty((n_frames, lay.n_views, cfg.height, cfg.width, 3),
                      dtype=torch.float32, device=packed.device)
    table = layout_table(lay)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fourd_forward_variant_launch(
            _VARIANT_CODES[variant], packed.data_ptr(), 0, seeds.data_ptr(), n_frames,
            ctypes.addressof(table), ctypes.addressof(hints), cfg.width, cfg.height, 0, cfg.height,
            cfg.samples, cfg.reflections_amount, float(np.float32(cfg.small_indent)),
            out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"forward variant kernel launch failed: cudaError {err}")
    VARIANT_LAUNCHES += 1
    return out

