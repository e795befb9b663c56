"""Row- and sample-sharded rendering over torch.distributed ranks.

Counterpart of fourd_ray_tracing_tpu/parallel/mesh.py. A path tracer has
two parallel axes:

* ``rays``: image rows split across ranks, with no communication in the
  forward pass;
* ``samples``: samples per pixel split across ranks; the per-pixel sum is
  an all-reduce over the samples group (the one forward collective).

One rank is one device. Rank ``r * samples + s`` holds row block ``r`` and
sample block ``s``, as the JAX package lays devices out in a (rays,
samples) grid. Scene and camera are replicated: every rank holds them
whole. The RNG streams are keyed by a pixel's global coordinates and a
sample's global index, so any split renders the same image, bitwise when
the samples axis is 1 (a split samples axis reassociates the per-pixel
sum).

Two routes shard, each with its own split of the rows:

* the plain route (``sharded_render_light``/``sharded_render_image``):
  rank (r, s) renders rows block r (``Mesh.rows``: the rows split as
  evenly as the rays axis allows, so no block needs padding) with samples
  block s through ``renderer.render_light_tile``, and gathers the image
  over its rays group (``gather_rows``);
* the kernel route (the ``sharded_*`` wrappers of ops/cuda/megakernel.py
  and ops/cuda/gradkernel.py): a launch takes every sample, so the rows
  split over every rank of the mesh, whatever its shape. The block of rank
  ``ray_index * samples + sample_index`` (the rank itself, as the JAX
  package's linear device index over the mesh axes) is block ``rank`` of
  ``world`` (``Mesh.kernel_rows``), each rank launches once on it, and the
  image gathers over the world (``gather_kernel_rows``). A rank whose
  block is empty (fewer rows than ranks) makes no launch, adds zeros to
  the all-reduce and an empty block to the gather, and joins every
  collective.

Training (diff.py): on the plain route every rank takes its rows' part of
the global loss and all-reduces the parameter gradients after the local
backward, in one packed collective (``all_reduce_sum``); on the kernel
route the wrappers all-reduce the packed [loss, grad] of their launch.

Single process: without a process group, ``make_mesh`` gives a 1-rank
mesh whose collectives are the identity.

With the gloo backend a CUDA tensor goes through the host around each
collective (gloo's transport is the host); with NCCL it stays on the
card. NCCL takes one card per rank; several ranks on one card take gloo.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Optional

import torch
import torch.distributed as dist

from fourd_ray_tracing_tpu_torch.camera import Camera
from fourd_ray_tracing_tpu_torch.models import renderer
from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig
from fourd_ray_tracing_tpu_torch.models.scene import Scene
from fourd_ray_tracing_tpu_torch.ops.sky import light_to_color

RAYS_AXIS = "rays"
SAMPLES_AXIS = "samples"
BACKENDS = ("gloo", "nccl")
# Every process group waits at most this long for a peer.
TIMEOUT = timedelta(seconds=60)


def initialize_distributed(backend: str, device=None, init_method: Optional[str] = None,
                           rank: Optional[int] = None, world_size: Optional[int] = None,
                           timeout: timedelta = TIMEOUT) -> bool:
    """Join the process group (torch.distributed.init_process_group) and
    return True, or return False when there is nothing to join: no
    ``init_method`` and no ``WORLD_SIZE`` in the environment (one
    process). Under torchrun the environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) names the group; otherwise pass
    ``init_method`` (e.g. a ``file://`` path), ``rank`` and
    ``world_size``. ``backend`` is "nccl" for one card per rank, "gloo"
    for the CPU or for several ranks on one card. A CUDA ``device``
    becomes the rank's current device."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if dist.is_initialized():
        return True
    if init_method is None:
        if "WORLD_SIZE" not in os.environ:
            return False
        init_method = "env://"
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    kwargs = {} if rank is None else {"rank": rank, "world_size": world_size}
    dist.init_process_group(backend=backend, init_method=init_method, timeout=timeout, **kwargs)
    return True


@dataclass(frozen=True)
class Mesh:
    """A (rays, samples) grid of ranks: this rank's place in it, its
    device, and the process groups of its row of the grid (``samples_group``:
    the ranks of its rows block) and of its column (``rays_group``: the
    ranks of its samples block). ``backend`` is None for one process."""

    rays: int
    samples: int
    rank: int
    device: torch.device
    backend: Optional[str] = None
    rays_group: Any = None
    samples_group: Any = None

    @property
    def world(self) -> int:
        return self.rays * self.samples

    @property
    def ray_index(self) -> int:
        return self.rank // self.samples

    @property
    def sample_index(self) -> int:
        return self.rank % self.samples

    def rows(self, height: int) -> tuple:
        """(row0, n_rows) of this rank: rows block ``ray_index`` of ``rays``."""
        return row_block(height, self.rays, self.ray_index)

    def kernel_rows(self, height: int, device) -> tuple:
        """(row0, n_rows) of this rank's kernel launch: block ``rank`` of
        the rows split over every rank of the mesh, ``device`` the device of
        the tensors to render. Raises unless it is the mesh's (a sharded
        call never moves them). ``n_rows`` is 0 when there are fewer rows
        than ranks."""
        if torch.device(device) != self.device:
            raise ValueError(f"the sharded kernel route runs on the mesh's device {self.device}; "
                             f"the tensors lie on {device}")
        return row_block(height, self.world, self.rank)


def make_mesh(rays: Optional[int] = None, samples: int = 1, device=None) -> Mesh:
    """The (rays, samples) mesh over every rank of the process group (one
    rank without one), ``rays`` defaulting to world // samples. Every rank
    must call it, with the same arguments: it creates the subgroups."""
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    grouped = dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    rank = dist.get_rank() if grouped else 0
    if rays is None:
        rays = world // samples
    if rays * samples != world:
        raise ValueError(f"mesh {rays}x{samples} != {world} ranks")
    if not grouped:
        return Mesh(rays, samples, rank, device)
    rays_groups = [dist.new_group([r * samples + s for r in range(rays)]) for s in range(samples)]
    samples_groups = [dist.new_group([r * samples + s for s in range(samples)])
                      for r in range(rays)]
    return Mesh(rays, samples, rank, device, dist.get_backend(), rays_groups[rank % samples],
                samples_groups[rank // samples])


def row_block(height: int, n: int, i: int) -> tuple:
    """(row0, n_rows) of block i of ``height`` rows split into n blocks as
    evenly as possible: rows i*H//n .. (i+1)*H//n."""
    row0 = i * height // n
    return row0, (i + 1) * height // n - row0


def _validate(cfg: RenderConfig, n_rays: int, n_samples: int) -> None:
    if cfg.height % n_rays != 0:
        raise ValueError(f"height {cfg.height} not divisible by rays axis {n_rays}")
    if cfg.samples % n_samples != 0:
        raise ValueError(f"samples {cfg.samples} not divisible by samples axis {n_samples}")
    if n_samples > 1 and cfg.rng_mode != "per_sample":
        raise ValueError('sharding the sample axis requires rng_mode="per_sample" '
                         "(sequential streams cannot start mid-stream)")


# --- Collectives ---------------------------------------------------------------

def _group_size(mesh: Mesh, group) -> int:
    if mesh.backend is None:
        return 1
    return dist.get_world_size(group) if group is not None else mesh.world


def all_reduce(t: torch.Tensor, mesh: Mesh, group=None) -> torch.Tensor:
    """The SUM of ``t`` over ``group`` (the whole world by default), as a
    new tensor on ``t``'s device; ``t`` itself with one rank."""
    if _group_size(mesh, group) == 1:
        return t
    staged = mesh.backend == "gloo" and t.device.type == "cuda"
    buf = t.detach().to("cpu" if staged else t.device, copy=True).contiguous()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device)


def all_reduce_sum(parts, mesh: Mesh) -> list:
    """One SUM all-reduce over the world of several float tensors packed
    into one float32 vector; returns the summed tensors, shaped like
    ``parts``."""
    flat = torch.cat([p.detach().reshape(-1).to(torch.float32) for p in parts])
    flat = all_reduce(flat, mesh)
    out, k = [], 0
    for p in parts:
        out.append(flat[k:k + p.numel()].reshape(p.shape))
        k += p.numel()
    return out


def _gather(block: torch.Tensor, mesh: Mesh, height: int, group, n: int) -> torch.Tensor:
    """The whole image (..., height, W, C) from the rows blocks
    (..., n_rows, W, C) of the n ranks of ``group``, its k-th rank holding
    ``row_block(height, n, k)``."""
    if _group_size(mesh, group) == 1:
        return block
    staged = mesh.backend == "gloo" and block.device.type == "cuda"
    pad = list(block.shape)
    pad[-3] = -(-height // n)
    buf = block.new_zeros(pad, device="cpu" if staged else block.device)
    buf[..., :block.shape[-3], :, :] = block.detach()
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=group)
    rows = [p[..., :row_block(height, n, i)[1], :, :] for i, p in enumerate(parts)]
    return torch.cat(rows, dim=-3).to(block.device)


def gather_rows(block: torch.Tensor, mesh: Mesh, height: int) -> torch.Tensor:
    """The whole image (..., height, W, C) on every rank from each rank's
    plain-route rows block (``Mesh.rows``), gathered over its rays group.
    Not differentiable."""
    return _gather(block, mesh, height, mesh.rays_group, mesh.rays)


def gather_kernel_rows(block: torch.Tensor, mesh: Mesh, height: int) -> torch.Tensor:
    """The whole image (..., height, W, C) on every rank from each rank's
    kernel-route block (``Mesh.kernel_rows``, possibly empty), gathered over
    the world. Not differentiable."""
    return _gather(block, mesh, height, None, mesh.world)


class SampleSum(torch.autograd.Function):
    """All-reduce (SUM) of a rank's sample-block light over its samples
    group, with the identity as its backward (the "reduce" of tensor
    parallelism). Every rank of the group holds the summed light of the
    same rows, and each differentiates its own samples: an all-reduce in
    the backward as well would count each rank's cotangent once per rank
    of the group."""

    @staticmethod
    def forward(ctx, acc, mesh):
        return all_reduce(acc, mesh, mesh.samples_group).clone()

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class SumGrad(torch.autograd.Function):
    """The identity, whose backward sums the cotangent over the world: an
    input that every rank holds whole (the packed parameters) and
    differentiates through its own rows only."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.clone()

    @staticmethod
    def backward(ctx, ct):
        return all_reduce(ct, ctx.mesh), None


# --- The plain route -----------------------------------------------------------

def sharded_render_light(scene: Scene, camera: Camera, cfg: RenderConfig, seed, mesh: Mesh,
                         gather: bool = True) -> torch.Tensor:
    """Sample-averaged light over the mesh: rank (r, s) renders rows block
    r with samples block s, and the samples group sums them. ``gather``
    (the default) returns the whole image (..., H, W, 3) on every rank,
    not differentiable; ``gather=False`` the rank's rows block
    (..., H / rays, W, 3), differentiable w.r.t. the scene and camera. A
    (K,) seed vector adds a leading frame axis, as render_light does."""
    renderer.check_supported(cfg)
    _validate(cfg, mesh.rays, mesh.samples)
    row0, n_rows = mesh.rows(cfg.height)
    n_local = cfg.samples // mesh.samples
    sample0 = mesh.sample_index * n_local
    words, batched = renderer.seed_words(seed)
    frames = [renderer.render_light_tile(scene, camera, cfg, w, row0, n_rows, sample0, n_local)
              for w in words]
    acc = torch.stack(frames) if batched else frames[0]
    light = SampleSum.apply(acc, mesh) * renderer.inv_samples(cfg)
    if not gather:
        return light
    return gather_rows(light, mesh, cfg.height)


def sharded_render_image(scene: Scene, camera: Camera, cfg: RenderConfig, seed, mesh: Mesh,
                         gather: bool = True) -> torch.Tensor:
    """``sharded_render_light`` tone-mapped."""
    light = sharded_render_light(scene, camera, cfg, seed, mesh, gather=False)
    image = light_to_color(light, cfg.light_coefficient)
    if not gather:
        return image
    return gather_rows(image, mesh, cfg.height)


def sharded_renderer(cfg: RenderConfig, mesh: Mesh, tonemap: bool = True, impl: str = "plain"):
    """(scene, camera, seed) -> the whole image (or light) on every rank:
    the plain route, or with ``impl="kernel"`` the row-sharded forward
    kernel, at most one launch per rank on its block of the world's split
    (megakernel.sharded_render_*_cuda). The
    counterpart of jit_sharded_renderer (mesh.py:145-175)."""
    if impl == "kernel":
        # Imported here: the kernel wrappers import this module.
        from fourd_ray_tracing_tpu_torch.ops.cuda import megakernel

        fn = (megakernel.sharded_render_image_cuda if tonemap else
              megakernel.sharded_render_light_cuda)
    elif impl == "plain":
        fn = sharded_render_image if tonemap else sharded_render_light
    else:
        raise ValueError(f"impl must be 'plain' or 'kernel', got {impl!r}")

    def run(scene, camera, seed):
        return fn(scene, camera, cfg, seed, mesh)

    return run
