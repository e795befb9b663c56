"""fourd_ray_tracing_tpu_torch: the 4D path tracer in PyTorch and CUDA.

The port of fourd_ray_tracing_tpu (JAX/Pallas, kept beside it as the
reference) to one NVIDIA H100. Plain tensor code is torch; every Pallas
kernel becomes a kernel written by hand for Hopper in ``csrc/``, built
with nvcc at first use (ops/cuda/build.py) and bound through ctypes.
Module names mirror the JAX package's:

* ``ops/`` — vec4, rng, fastmath, sampler, sky, geometry (torch);
* ``camera.py``, ``models/scene.py``, ``models/library.py``;
* ``models/renderer.py`` — the plain forward pipeline, the plain version
  of the forward kernel; ``models/params.py`` — its packed parameters;
* ``ops/cuda/megakernel.py`` — the forward kernel's wrapper;
* ``ops/cuda/gradkernel.py`` — the gradient kernels' wrappers;
* ``diff.py``, ``inverse_render.py`` — losses, train steps, inverse
  rendering;
* ``parallel/mesh.py``, ``multihost_run.py`` — the row-sharded path over
  torch.distributed ranks and its multi-process runner;
* ``engine.py``, ``app.py`` — progressive accumulation and batch PNGs;
* ``utils/`` — the properties/AppConfig parser, the PNG writer, the
  JSON-line logger and the flop counter.

This package never imports jax, nor anything of the JAX package: its
properties parser and PNG writer (``utils/``) are its own copies.
"""
