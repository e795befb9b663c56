#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
card and the CUDA toolkit's nvcc, and exits non-zero (printing no result)
on any failure, or when no CUDA device is available. Phases:

1. device: the card's name and power limit;
2. build: the kernels from fourd_ray_tracing_tpu_torch/csrc; every
   kernel's registers, stack frame and spill stores from the build log, the
   resident warps per SM that the gradient kernels K4, K5 and K6 reach at
   the training shape (their unhinted instances, and those of the
   freeze_hints contract at the room's fold table: the room's RoomFold, the
   generic AnyFold), and those of every instance of the forward kernel K1
   at the headline launch (the composite instances at the tiger's 3-view
   launch); the composite folds of K4, K5, K6 and K8 (the generic one and
   each library scene's): registers, stack, spill and resident warps at
   each scene's training launch (the hypercube's 3-view one too);
3. kernel vs plain torch pipeline on the card, 256x144, 4 spp, 4 bounces,
   all five library scenes, 1 and 3 views, a (2,) seed vector: K1 with the
   static hints its entry point derives (plane and axis hints) against K1
   without them and against the plain pipeline with and without them;
   bitwise self-consistency;
4. main path: RenderEngine on room_with_sphere at 1280x720, 8 spp,
   4 bounces, per-sample RNG, step_frames(4) = one 4-frame launch with the
   hints the engine derived (every launch counted hinted), timed with CUDA
   events;
5. the batch app on configs/properties.txt (121x75 + 2x60x37, 100 spp,
   its own scene: the tiger); the kernel launches of phases 4-5 are
   counted;
5b. the live session: app.main --interactive --deterministic --serve 0
   --save-state on the same config, max_fps 60, a stdin script (a look
   before capture, which is ignored; capture, a move, two mouse deltas, one
   of them beyond the border, a wheel click, frames 16; then save, stats,
   quit) while a second thread fetches /frame.png?view=yxz at 127.0.0.1
   and posts one /cmd line (frames 1): K1 launched once per view group by
   the precompile and once per rendered frame per view group, all hinted,
   the controls native, the windows and the state written (the state
   loads into a fresh engine); precompile's seconds in the session (warm:
   phase 5 loaded the tiger's K1) and the session's frames per second are
   printed beside the card, and so is the time to the first frame of a
   fresh process (its imports, the engine's build, precompile and the
   first frame of every view group on the host). Then the resumes at the
   headline shape: an engine on the room renders 4 frames, checkpoints,
   and a fresh engine loads it and renders 4 more, bitwise an
   uninterrupted 8; inverse_render --packed --ckpt writes its train state
   at step 20, and one K4 step from it restored is bitwise the
   uninterrupted step 21. After the counts are read, that run's K1 target
   render and its first K4 step (the first step's loss bitwise) are held
   against their plain versions at that shape, under the frozen hints;
6. the kernel alone, hinted and unhinted, and the plain pipeline timed at
   phase 4's shape, and their 4 frames held against each other as in
   phase 3;
7. the kernel against the unhinted kernel and the plain pipelines on each
   of the app's view groups (1 view at 121x75, 2 views at 60x37), with the
   app's own cameras and hints;
7b. the JAX bench's composite forward lines (bench.py:602-614) at
   1280x720, 8 spp, 4 bounces, 4 frames a launch: hypercube with 1 view,
   duocylinder and tiger with 3; each through RenderEngine.step_frames(4)
   (its main path, its launches counted from zeroed counts) and K1 alone
   with the hints the engine derived and without, timed with CUDA events
   and held against each other; the hinted plain pipeline in 144-row
   bands, timed once and held against K1; each scene's bound;
7c. K1's other configurations (csrc/forwardmodes.cu): RenderEngine on
   room_with_sphere at 1280x720, 8 spp, 4 bounces, 4 frames a launch in
   RenderConfig()'s modes (the sequential stream, the poly sampler, the
   fast fold, the engine's hints: every launch hinted) and in the
   oracle's (sequential, newton, trig: no hints), from zeroed counts, each
   launch counted by its configuration (megakernel.CONFIG_LAUNCHES),
   timed; K1 alone at that shape on the room and on the tiger with 3 views
   in the production configuration and in each of the sequential stream,
   the kepler and the newton sampler and the spec and the trig fold
   (``MODE_TIMED``), timed with CUDA events beside its plain version over
   the whole image (timed once, and held against K1), its bound from the
   plain version's flops (the live lanes; newton's steps per lane as its
   data needs them); at 256x144, 4 spp, 4 bounces every
   configuration rng x sampler x fold on the five library scenes and a
   hypercube without generators against its plain version (CHECK_BOUNDS;
   bitwise where no transcendental runs), and the sequential stream's K2
   rows (a scene and a copy with a wall moved) and K3 blocks (2 and 4)
   bitwise its single launches;
8. the value-and-grad kernel K4 against its plain version (torch autograd
   over the plain pipeline) on the card: room_with_sphere and
   sphere_plane_light, 1 and 3 views,
   256x144, 4 spp, 4 bounces, a (2,) seed vector, a seeded random target;
   bitwise across two launches; the (2,) launch against the mean of the
   two scalar-seed launches; K4 and its plain version timed at
   256x144x8spp x4 bounces; at phase 9's shape (1280x720x8spp x4, 1 and 4
   frames) K4 bitwise across two launches and held against the plain
   version taken in row bands, both timed; at phase 10's shape the forward
   kernel's target render and K4 held against their plain versions. Each
   check runs K4 under the freeze_hints contract too (diff.with_frozen_hints:
   the forward's hints, the hyperplane normals' gradients frozen): the loss
   bitwise the unhinted launch's, every kept slot bitwise, every frozen slot
   0, bitwise across launches, within GRAD_BOUNDS of the unhinted plain
   version with the slots frozen; at 1280x720 the hinted and the unhinted
   launch timed in turns. The composites (``COMPOSITE_GRAD``: the
   duocylinder, the hypercube, the tiger and a floor with two standalone
   cylinders, one hinted, one not) at 256x144, 1 and 3 views, unhinted
   against the plain version and under the contract the same way; then
   bench.py's ``inverse_step_tiger`` (1280x720x8spp x4, 1 view, 1 frame,
   the frozen hints) and the hypercube and duocylinder at its shape: K4
   bitwise across launches, under the contract, hinted and unhinted timed
   in turns, each one's bound; the tiger's also against its plain version
   in row bands; at the benchmark's train cells' shape (``SPLIT_CHECK``,
   121x75x100spp x4, 4 frames a launch), where the sweep splits each
   pixel's samples over several blocks (gradkernel.sweep_split), K4 on
   ``SPLIT_SCENES`` hinted and unhinted and on the tiger in one modes
   configuration: the split read from its ``k4.sweep_split`` counter at
   least 4 and one split for the hinted and the unhinted launch, bitwise
   across launches, the contract, within GRAD_BOUNDS of the plain version
   in row bands;
8c. K4, K5 and K6 over K1's other configurations (csrc/modes.cuh):
   each GRAD_MODES configuration (per-sample streams; kepler, newton,
   spec, trig) on the five library scenes and a hypercube without
   generators (there also the production modes) at 256x144x4spp x4
   against their plain versions (GRAD_BOUNDS, the non-zero patterns,
   bitwise across launches), K4's loss against the loss over K1's image,
   with_frozen_hints (the contract, or under a literal fold bitwise the
   unhinted launch), and the tiger's K4 and K6 in trig in 2 row blocks;
   then the main path at 1280x720x8spp x4 from zeroed counts: the packed
   step under with_frozen_hints on the room and the tiger in the oracle's
   sampler and fold (newton, trig), the soft step on the room's sphere 0
   in trig and its hyperplane fallback, each launch counted by
   configuration; then at that shape the kernels of those steps against
   their plain versions (K4 and K6 in row bands, K5 whole; GRAD_BOUNDS,
   the non-zero patterns, bitwise across launches) and timed beside them:
   K4 on the room in each configuration and on the tiger in newton +
   trig, K6 on the room's sphere 0 in trig and K5 in trig, with their
   bounds (the tiger's over its live lanes) (the summary's
   ``configurations`` of K4, K5 and K6, and the modes instances'
   resources from phase 2);
9. the training main path in the production configuration:
   make_packed_train_step under the frozen hints (Adam on the packed
   vector, one hinted K4 launch per step, the frozen slots bitwise
   constant) on room_with_sphere at 1280x720, 8 spp, 4 bounces, a zero
   target, lr 1e-3, timed with CUDA events, for 1 and 4 frames per step;
   the unhinted step timed beside it; 9b: the same step on the tiger at 1
   frame, from zeroed counts (one hinted K4 launch a step);
10. the entry point: ``inverse_render --param glow --impl kernel`` plain,
   with ``--packed`` (the frozen hints forced) and with ``--freeze-hints``
   recovers the lamp's glow, the hinted launches counted;
11. the light-VJP kernel K5 against its plain version (torch autograd of
   sum(render_light * cot)) on the card: the gradient scenes, 1 and 3 views,
   256x144, 4 spp, 4 bounces, a seeded random cotangent; bitwise across
   launches; K2 (the forward kernel over (F, P) params rows: a scene and
   its zero_object copy) row by row bitwise single K1 renders, and K5's
   two-row launch row by row bitwise single K5 launches and held against
   the plain version; then K5 at the soft main path's 1280x720x8spp x4,
   bitwise across two launches, against the plain version, both timed; K5
   (one row and two) under the contract as K4 in phase 8, hinted and
   unhinted timed at 1280x720; K5 on ``COMPOSITE_GRAD`` at 256x144 (one
   row in 1 and 3 views, two rows, the scene and a copy with its floor
   moved, in 1), unhinted against the plain version and under the
   contract;
12. the fused soft value-and-grad kernel K6 against its plain version
   (autograd over the plain blend, alpha an independent leaf): the room's
   sphere 0 and the lamp scene's sphere 1, 1 and 3 views, 256x144, 4 spp,
   4 bounces, the coverage alpha and a seeded random target; bitwise
   across launches; the zeroed row's light bitwise the drop_object light;
   with one view, K6 again with wall 0's color added to the zero map (slots
   that row b reaches and must drop; its rows are swept apart); then at
   1280x720x8spp x4,
   bitwise across two launches, against the plain version in row bands,
   both timed beside the pair K6 fused (K2 over both rows and the two-row
   K5), and at ``inverse_render --param position``'s shape; K6 under the
   contract as K4 in phase 8 (its loss and alpha cotangent bitwise the
   unhinted launch's), hinted and unhinted timed at 1280x720. K6 on
   ``COMPOSITE_GRAD`` at 256x144, 1 and 3 views, each scene's composite
   the object (``COMPOSITE_SOFT_REFS``: row b zeroes its radii), unhinted
   against the plain version, bitwise across launches, and under the
   contract the same way; the zeroed row's light bitwise the drop_object
   light (unhinted and hinted, the dropped scene under hints_for_dropped),
   and K2 over the scene and its zero_object copy row by row bitwise the
   single renders;
13. the soft training main path in the production configuration:
   make_train_step(impl="kernel", soft_object_ref=("spheres", 0)) under
   the frozen hints on room_with_sphere at 1280x720, 8 spp, 4 bounces, a
   zero target, edge width 0.05, lr 1e-3, one hinted K6 launch per step,
   timed with CUDA events beside K6 alone, the coverage's forward and
   backward alone and Adam alone; the production and the unhinted step
   in turns, each step's host part (the host clock when the call returns,
   the card idle at its start) and its wall time, and the host work the
   contract adds to a step, timed alone; the
   hyperplane fallback (("spaces", 0): two hinted K1 and two hinted K5
   launches per step, the wall's hint row dropped for the row without it),
   timed; then ``inverse_render --param position --impl kernel
   --freeze-hints`` recovers the lamp's x;
13b. the slice's soft main path on the composites: bench.py's soft_step
   with the room's sphere replaced by the tiger, make_train_step(impl=
   "kernel", soft_object_ref=("tiger", None)) under the frozen hints at
   1280x720x8spp x4 from zeroed counts, one hinted K6 launch per step on
   the tiger's composite fold, its hyperplane fallback (("spaces", 0): two
   hinted K1 and two hinted K5 launches per step on the composite folds),
   and the same soft step on the hypercube and the duocylinder, each
   timed; the tiger step's parts alone (K6, the coverage's forward and
   backward, Adam) and its host part; K6 on the tiger, the hypercube and
   the duocylinder at that shape, hinted and unhinted timed in turns, each
   under the contract and against its plain version in row bands, the
   tiger's bound (the live share of both rows); the fallback's kernels on
   the tiger at that shape: K5 on the tiger and on the tiger without wall
   0 under hints_for_dropped, each against its plain version in row bands
   and timed, and K1 of the scene without the wall against the plain
   pipeline;
14. the row-sharded launches (K3) in one process: K1 and K2 with the
   room's hints (K2's two rows share them) against their unhinted launches;
   cut into 2 and 4 row blocks (``parallel.mesh.row_block``) bitwise the
   single launch at 1280x720x8spp x4 (4 frames) and at 256x144 with 3
   views; the tiger's hinted 3-view launch at 1280x720x8spp x4 (4 frames)
   in 2 and 4 row blocks bitwise its single launch; the
   blocks of K4 (1 and 4 frames), K5 (two rows) and K6 at 1280x720x8spp x4
   under the frozen hints,
   added in rank order, within ``GRAD_BOUNDS`` of the single launch, K6's
   alpha cotangent blocks bitwise its rows; each of the ``PLAIN_SPLIT``
   blocks of K1, K2 (both shapes; against both plain pipelines), K4 (1
   frame), K5 and K6 held against its plain version on the same rows
   (CHECK_BOUNDS, GRAD_BOUNDS); each
   block's launch and the single launch timed with CUDA events; the
   tiger's K4 under the frozen hints at 256x144 in ``PLAIN_SPLIT`` row
   blocks, each bitwise across launches and against its plain version,
   their sum within ``GRAD_BOUNDS`` of the single launch; the tiger's K6
   under the frozen hints at 256x144 in ``PLAIN_SPLIT`` row blocks, each
   bitwise across launches and against its plain version, and at
   1280x720x8spp x4 in 2 and 4 row blocks, timed, their sums within
   ``GRAD_BOUNDS`` of the single launch, their alpha cotangents bitwise
   its rows;
15. the distributed main path: ``multihost_run`` with 2 ranks (gloo, both
   on this card; NCCL, one card each, when there are two): the sharded
   image bitwise the single-process K1 render, 3 steps of
   ``make_train_step(impl="kernel", mesh=...)`` at 1280x720x8spp x4 for the
   hard loss and the soft loss (sphere 0) within loss and parameter rtol
   1e-5 of the single process with one K4 (K6) launch per rank and step,
   the soft pair's gradient (K2 + two-row K5 on each rank's rows), and
   ``inverse_render --mesh --impl kernel --freeze-hints`` recovering the
   glow, every item in the production configuration, the frozen hints
   (each gradient launch counted hinted). Both ranks
   share one card, so its step times are no scaling figure;
15b. the multi-device dry run: ``dryrun.entry``'s flagship forward (one
   K1 launch, bitwise its plain version), ``dryrun.dryrun_multichip(4)``
   (a plain step, two hard and one soft kernel-route step and the K3
   image on a (2, 2) mesh of 4 ranks against one process, every rank's
   launches checked), phase 15's items on a (2, 2) mesh of 4 ranks at
   1280x720x8spp x4 (the kernel route's rows split over every rank of a
   mesh with a samples axis; 3 steps, the frozen hints) against one
   process with each rank's launches checked (one K1 shard, one hinted K4
   (K6) shard a step, the pair's K2 and K5 shards), and ``multihost_run
   --scaling`` (the measurement at 1 and 2 ranks: the ranks share the
   card, so its ratio is a plumbing check); the phase's seconds and the
   rays/s printed beside the card's name and power limit; then, after
   the phase's counts are read, K1, K4 and K6 against their plain
   versions at the dry run's inputs and K1 and K4 at the measurement's,
   and each scaling line's kernel_loss, kernel_grad_norm and mean lights
   against the plain version's (``check_dryrun_kernels``);
16. the fp32 FMA-peak kernel K7: its main loop in the built library's SASS
   (cuobjdump) is FFMAs with no FMUL/FADD, for each n_acc; its block sums
   against its plain version at 64 steps on the sweep's grid; then the
   measurement path, ``tools.vpu_peak.run``: the n_acc sweep, the 2x-rounds
   linearity check, no rate above the card's peak at its max SM clock, the
   SM clock read during a burst of launches, and the measured peak; then
   each n_acc's block sums at the sweep's own steps against the plain
   version that rounds once a step and sums in the kernel's order, and the
   peak's n_acc against the same at half its steps;
17. the value-and-grad pass-budget kernel K8 against its plain version
   (acc, loss, vjp) and loss and vjp against K4's loss, at 256x144x4spp x4
   bounces, the gradient scenes and ``COMPOSITE_GRAD``, 1 and 3 views, and
   each mode under the frozen hints bitwise the unhinted launch; K8 over
   K1's other configurations (csrc/ablatemodes.cu) from zeroed counts: each
   GRAD_MODES configuration on the five library scenes and a hypercube
   without generators (there also the production modes), and the
   sequential stream (production and the oracle's sampler and fold) on the
   room, at 256x144x4spp x4, each mode against its plain version, bitwise
   across launches and under the frozen hints bitwise the unhinted launch,
   acc against the float64 sum of K1's light in the same configuration, a
   sequential configuration bitwise its per-sample launch, every
   configuration counted (ablate.CONFIG_LAUNCHES); K1's stub variants with the
   hints (tools/fwd_ablate.py's own functions, 8 frames a launch) against
   the plain pipeline under the same patches at 256x144 (all five scenes)
   and at
   fwd_ablate's 1280x720x8spp x4 (the room), the fold's generic instance and
   the unhinted launch bitwise the hinted K1; then the attribution tools
   grad_ablate, train_ablate, soft_ablate and fwd_ablate at 1280x720x8spp
   x4 bounces (rounds cut, ``TOOL_ROUNDS``), each from zeroed counts, with
   every kernel launch each tool's variants must make checked (the
   training tools run the frozen hints, as the JAX tools do: every
   gradient launch hinted); then the K8 values grad_ablate printed against
   the plain version on the same inputs, and its loss x scale against
   K4's, and each K8 mode timed unhinted beside the tool's hinted times;
   then, from zeroed counts, through grad_ablate.build at 1280x720x8spp x4
   under the frozen hints on the room, K8's three modes and K4 in the
   production configuration and each GRAD_MODES one, timed as the tool
   times, each mode against its plain version (timed once) with its bound,
   K4 with its bound, and K4 - vjp, the sweep's share; the launches
   counted by configuration.

Every kernel's entry in the summary carries its bound: the larger of its
plain version's flops (utils/flops.py, counted on the card over
``BOUND_ROWS`` rows of the timed shape and scaled to the whole image) over
NVIDIA's published fp32 peak and the bytes it must move (each input read
once, each output written once) over the published memory rate
(``PEAKS``); K4-K6's and K8's plain versions run the frozen hints, the
production work. The entries of K4, K5 and K6 also name the kernels each
launch runs (a pass-1 kernel, then a sweep) and carry the registers, stack
frame and spill stores of the sweep's production instance (the room under
the frozen hints), the resident warps per SM it reaches, and the same of
its other instances and of the pass-1 kernel. The entries of K4-K6 and K8
give the production (hinted) time as ``ms`` and the unhinted launch's
beside it, the hinted launches, and the count of contract checks that
held. Beside it stand the shares of two peaks that the kernel's
achieved fp32 rate reaches: the published 67 TFLOP/s (data sheet, H100
SXM at 700 W) and the rate K7 sustained on this card in this run (phase
16), which is what the card really offers a kernel of plain FMAs.

Every forward kernel-vs-plain check holds the two within the image bounds
of ``CHECK_BOUNDS`` and reports whether they are bitwise equal (K1's
summary entry lists any that was not); the gradient kernels' checks use
``GRAD_BOUNDS``. K1's bounds (the room's and each composite cell's)
count the flops of the plain pipeline with the static hints, the
production forward's work, on the lanes still alive (``live_lane_flops``:
K1 stops a lane that left the scene; in the closed room every lane
counts); the dense and the unhinted counts stand beside them. The kernel
launch counts are
set to 0 before each main path (phases 4-5: rendering; phase 5b: the
live session and the resumes; phase 7b: each
composite cell's engine; phase 7c: the engine in each of its two
configurations; phase 8c: the steps by configuration; phases 9-10:
training; phase 13: soft training; phase 13b: soft training on the
composites; phase 15: the ranks, fresh processes,
count their own; phase 15b: the entry's launch and each run's ranks and
single-process references; phase 16: the peak sweep; phase 17: K8's configurations
checked, each tool, K8 and K4 timed by configuration) and read after it.

The line before the last is the kernels' JSON summary, the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import io
import json
import re
import shutil
import statistics
import struct
import subprocess
import sys
import threading
import time
import urllib.request
import zlib
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from fourd_ray_tracing_tpu_torch import app  # noqa: E402
from fourd_ray_tracing_tpu_torch import camera as cam  # noqa: E402
from fourd_ray_tracing_tpu_torch import diff, dryrun, inverse_render, multihost_run  # noqa: E402
from fourd_ray_tracing_tpu_torch.engine import RenderEngine  # noqa: E402
from fourd_ray_tracing_tpu_torch.models import library, params, renderer  # noqa: E402
from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig  # noqa: E402
from fourd_ray_tracing_tpu_torch.ops.cuda import build  # noqa: E402
from fourd_ray_tracing_tpu_torch.ops.cuda import ablate, gradkernel, megakernel  # noqa: E402
from fourd_ray_tracing_tpu_torch.ops.cuda import vpu_peak as k7  # noqa: E402
from fourd_ray_tracing_tpu_torch.ops.sky import light_to_color  # noqa: E402
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4  # noqa: E402
from fourd_ray_tracing_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from fourd_ray_tracing_tpu_torch.tools import (  # noqa: E402
    fwd_ablate, grad_ablate, soft_ablate, train_ablate, vpu_peak)
from fourd_ray_tracing_tpu_torch.tools import common as tool_common  # noqa: E402
from fourd_ray_tracing_tpu_torch.utils import checkpoint, profiling  # noqa: E402
from fourd_ray_tracing_tpu_torch.utils.config import AppConfig  # noqa: E402
from fourd_ray_tracing_tpu_torch.utils.flops import FlopCounter, count_flops  # noqa: E402

# All but boundary_frac of pixels within atol, image-wide mean |diff|
# under mean_atol: visibility-boundary pixels may flip on ulp noise.
CHECK_BOUNDS = dict(atol=1e-5, boundary_frac=0.01, mean_atol=0.005)
APP_CONFIG = ROOT / "configs" / "properties.txt"
HEADLINE = dict(width=1280, height=720, samples=8, reflections_amount=4, rng_mode="per_sample")
FRAMES_PER_LAUNCH = 4
# The scenes of hyperplanes and spheres.
GRAD_SCENES = ("room_with_sphere", "sphere_plane_light")
# The composite primitives on the gradient paths (K4, K5, K6, K8):
# the library's three composite scenes and "cylinders", a floor and two
# standalone cylinders (one on unit axes, hinted; one turned, not) under
# sphere_plane_light's sun and sky. Their gradients' non-zero patterns are
# compared above COMPOSITE_PATTERN_FLOOR of the largest slot (as the CPU
# tests: a face radius's and an aligned family's cancelling cotangents
# leave float32 residues, 0 in one order of sums and not in the other).
COMPOSITE_GRAD = ("duocylinder", "hypercube", "tiger", "cylinders")
COMPOSITE_PATTERN_FLOOR = 1e-7
# bench.py's inverse_step_tiger (:621-625, run_grad_workload :258-291): K4
# on the tiger at TRAIN, one view, a zero target, the frozen hints, one
# frame; the hypercube and the duocylinder at the same shape beside it.
INVERSE_STEP_SCENES = ("tiger", "hypercube", "duocylinder")
# Phase 7b: the JAX bench's composite forward lines (bench.py:602-614), at
# the headline shape, 4 frames a launch, with their views; the plain
# pipeline renders them in BAND_ROWS-row bands.
COMPOSITE_CELLS = (("hypercube", ("yxz",)), ("duocylinder", cam.VIEWS_ALL),
                   ("tiger", cam.VIEWS_ALL))
# Phase 7c: K1's other configurations. The engine drives RenderConfig()'s
# modes (the sequential stream, poly, fast) and the oracle's; K1 is timed at
# the headline shape in each MODE_TIMED configuration (each one axis off
# the production configuration) on MODE_CELLS, and held against its plain
# version at MODES_CHECK in every configuration, on every library scene
# and a hypercube without generators ("hypercube_cells").
ORACLE_MODES = dict(rng_mode="sequential", sampler_method="newton", intersect="trig")
MODE_TIMED = {"per_sample/poly/fast": {}, "sequential/poly/fast": dict(rng_mode="sequential"),
              "per_sample/kepler/fast": dict(sampler_method="kepler"),
              "per_sample/newton/fast": dict(sampler_method="newton"),
              "per_sample/poly/spec": dict(intersect="spec"),
              "per_sample/poly/trig": dict(intersect="trig")}
MODE_CELLS = (("room_with_sphere", ("yxz",)), ("tiger", cam.VIEWS_ALL))
MODES_CHECK = dict(width=256, height=144, samples=4, reflections_amount=4)
MODE_CALLS, MODE_REPEATS = 3, 3
# Phase 8c: K4, K5 and K6 over K1's other configurations (csrc/modes.cuh),
# per-sample streams with one axis off the production configuration at a
# time (GRAD_MODES), held against their plain versions at GRAD_CHECK on
# every library scene and a hypercube without generators (there also the
# fast fold with the poly sampler); the main path at TRAIN: the packed step
# on the room and on the tiger in the oracle's sampler and fold
# (GRAD_ORACLE, per-sample streams), the soft step on the room's sphere 0
# and its hyperplane fallback in trig; K4 on the room in each GRAD_MODES
# configuration and on the tiger in GRAD_ORACLE, K6 on the room's sphere 0
# and K5 one row in trig, each against its plain version and timed.
GRAD_MODES = {"per_sample/kepler/fast": dict(sampler_method="kepler"),
              "per_sample/newton/fast": dict(sampler_method="newton"),
              "per_sample/poly/spec": dict(intersect="spec"),
              "per_sample/poly/trig": dict(intersect="trig")}
GRAD_ORACLE = dict(sampler_method="newton", intersect="trig")
GRAD_TRIG = dict(intersect="trig")
GRAD_MODE_SCENES = tuple(sorted(library.SCENES)) + ("hypercube_cells",)
CALLS, REPEATS = 5, 5  # timed: REPEATS runs of CALLS back-to-back calls
# K4 against its plain version: loss within rtol, every gradient within a
# mixed-scale relative error (|a - b| / max(|b|, 1e-3 max|b| + 1e-8), as
# tests/test_gradkernel.py:74-76) with the same non-zero pattern; the
# (F,) launch against the mean of the scalar-seed launches within rtol.
# Both sides round alike (no FMA contraction) and differ only in the order
# of their sums, so the gradient bound is 1e-4 here (the largest error read
# on the card was 4.38e-6); the CPU tests against XLA, which contracts
# FMAs, keep 1e-3.
GRAD_BOUNDS = dict(loss_rtol=1e-6, grad_mixed_rel=1e-4, minibatch_rtol=1e-5)
# The gradient launches' kernels, by their names in the build log: the
# sweeps (each an unrolled instance at the main paths' bounce count and a
# generic one) of K4 and K5 and of K6's row a and row b, and K4's and K6's
# pass 1; the kernels each launch runs, in order; and each launch's main
# sweep, whose resources its summary carries.
# K1's production instance on the main path: the room's hint pattern (4
# wall pairs, no single plane), no stub.
K1_MAIN = r"forward_kernelILi0E\w*?TableFoldILi4ELi0EE"
GRAD_KERNELS = {"sweep": "sweep_kernel", "loss_cot": "loss_cot_kernel",
                "soft_sum": "soft_sum_kernel", "soft_row_a": "soft_row_a_kernel",
                "soft_row_b": "soft_row_b_kernel"}
GRAD_LAUNCHES = {"k4": ("loss_cot", "sweep"), "k5": ("sweep",),
                 "k6": ("soft_sum", "soft_row_a", "soft_row_b")}
MAIN_SWEEP = {"k4": "sweep", "k5": "sweep", "k6": "soft_row_a"}
SWEEPS = ("sweep", "soft_row_a", "soft_row_b")
GRAD_CHECK = dict(width=256, height=144, samples=4, reflections_amount=4, rng_mode="per_sample",
                  light_coefficient=0.12)
# Training shapes of the JAX package's bench (bench.py train_scan4 and
# train_minibatch4): room 1280x720x8spp x4 bounces, light_coefficient
# 0.12. At that shape the plain version runs one frame and BAND_ROWS rows
# at a time (gradkernel.loss_and_grad_plain's band_rows); at 256x144 it
# runs whole.
TRAIN = dict(HEADLINE, light_coefficient=0.12)
# The benchmark's train cells' shape (the upstream's main window, 4 frames
# a launch): 568 sweep blocks, which K4 splits into at least 4 sample
# chunks a pixel on an H100; the scenes checked there hinted and unhinted
# (the room's, the composites' own and the generic composite fold), and
# the modes instance checked there unhinted.
SPLIT_CHECK = dict(width=121, height=75, samples=100, reflections_amount=4, rng_mode="per_sample")
SPLIT_FRAMES = 4
SPLIT_SCENES = ("room_with_sphere", "tiger", "hypercube", "duocylinder")
SPLIT_MODE = ("tiger", dict(sampler_method="kepler"))
TRAIN_SMALL = dict(TRAIN, width=256, height=144)
BAND_ROWS = 144
TRAIN_FRAMES = (1, 4)
TRAIN_CALLS, TRAIN_REPEATS = 3, 3
# The soft-silhouette slice: the object each scene's soft checks take
# (the JAX bench's soft_step takes the room's sphere 0; inverse_render
# --param position the lamp, sphere 1), and the main path's edge width.
SOFT_REFS = {"room_with_sphere": ("spheres", 0), "sphere_plane_light": ("spheres", 1)}
SOFT_EDGE = 0.05
FALLBACK_REF = ("spaces", 0)
# The soft object of each COMPOSITE_GRAD scene (phase 12): the composite
# itself (zero_object: its radii 0, the hypercube's -1); of "cylinders",
# the one on unit axes, hinted. Phase 13b: the slice's main path, bench.py's
# soft_step (:468-516) with the room's sphere replaced by the tiger, and
# the hypercube's and the duocylinder's soft steps at its shape beside it.
COMPOSITE_SOFT_REFS = {"duocylinder": ("cylinders_union", None),
                       "hypercube": ("hypercube", None), "tiger": ("tiger", None),
                       "cylinders": ("cylinders", 0)}
SOFT_STEP_SCENES = ("tiger", "hypercube", "duocylinder")
# Phase 14: the row shards (K3), and the split whose blocks are each held
# against their plain version on the same rows (phase 15's, one block per
# rank); phase 15: the ranks of the distributed run.
SHARDS = (2, 4)
RANKS = 2
PLAIN_SPLIT = RANKS
# Phase 15b: the kernel route on a mesh with a samples axis, 4 ranks.
MESH_RANKS, MESH_SHAPE = 4, (2, 2)
# Two fp32 peaks: NVIDIA's published H100 SXM rate at 700 W (data sheet;
# fp32 outside the tensor cores), on which every bound_ms is computed, and
# the rate K7 sustains on this card in this run (phase 16,
# tools/vpu_peak.py), added as measured_fp32_flops_per_s; every kernel's
# entry gives its share of both. bytes_per_s is the published HBM3 rate.
# The bounds count flops over BOUND_ROWS rows.
PEAKS = dict(fp32_flops_per_s=67e12, bytes_per_s=3.35e12)
BOUND_ROWS = 8
# Phase 16: K7 against its plain version at PEAK_CHECK_ROUNDS steps, block
# sums within PEAK_RTOL (the kernel rounds once a step, the plain version
# twice: a few ulps apart after 64 steps); then at each n_acc's sweep steps
# against k7.block_sum_plain (one rounding a step, the kernel's order of
# sums: bitwise so far) within PEAK_RTOL, where the block sum at half the
# steps must lie more than PEAK_RESOLVE x PEAK_RTOL away for the n_acc that
# gives the peak, so that a kernel running half its trips would fail.
PEAK_CHECK_ROUNDS, PEAK_RTOL, PEAK_RESOLVE = 64, 1e-5, 10
# Phase 17: K8's acc against its plain version within ACC_RTOL (the pixel
# values are bitwise K1's; only the order of the double sums differs), loss
# and vjp within GRAD_BOUNDS["loss_rtol"]; the attribution tools at full
# width with their rounds cut (rounds, calls per round) to keep the
# script's time.
ACC_RTOL = 1e-6
# K8 over K1's other configurations (csrc/ablatemodes.cu): checked at
# GRAD_CHECK in each GRAD_MODES configuration on GRAD_MODE_SCENES and, on
# the room, in the sequential stream's configurations below (launched as
# their per-sample ones); acc equal to the float64 sum of K1's light in the
# same configuration rounded to float32 (the same float32 pixel values,
# summed in double in another order; K8 returns its double sum as a
# float32); timed at TRAIN as grad_ablate times (ABLATE_ROUNDS rounds of
# ABLATE_CALLS calls after a warm-up).
ABLATE_SEQUENTIAL = (dict(rng_mode="sequential"), dict(rng_mode="sequential", **GRAD_ORACLE))
ABLATE_CALLS, ABLATE_ROUNDS = 4, 3
# K1's stub variants against the plain pipeline: all five scenes at this
# shape, and the room at fwd_ablate's own (TRAIN: 1280x720x8spp x4).
VARIANT_CHECK = dict(width=256, height=144, samples=4, reflections_amount=4, rng_mode="per_sample")
TOOL_ROUNDS = {"train_ablate": (3, 8), "soft_ablate": (3, 4), "fwd_ablate": (3, 4)}


START = time.perf_counter()


def phase(name: str) -> None:
    """Announces a phase, with the seconds since the script started."""
    print(f"== {name} (at {time.perf_counter() - START:.1f} s)", flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def cuda_ms(fn, calls: int = CALLS, repeats: int = REPEATS) -> list:
    """Milliseconds per call of ``fn`` by CUDA events around ``calls``
    back-to-back calls, once per repeat."""
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return times


# Whether each forward comparison of check_close was bitwise, by label.
BITWISE = {}


def check_close(label: str, kernel: torch.Tensor, plain: torch.Tensor) -> float:
    """Hold a kernel result against the plain pipeline's (or another
    kernel's) within CHECK_BOUNDS; prints the comparison, records in
    BITWISE whether it was bitwise and returns max |kernel - plain|."""
    assert kernel.shape == plain.shape, f"{label}: {tuple(kernel.shape)} vs {tuple(plain.shape)}"
    bitwise = BITWISE[label] = bool(torch.equal(kernel, plain))
    a, b = kernel.cpu().numpy(), plain.cpu().numpy()
    assert np.isfinite(a).all() and np.isfinite(b).all(), f"{label}: non-finite values"
    diff = np.abs(a - b)
    err, mean = float(diff.max()), float(diff.mean())
    frac = float((diff.reshape(-1, a.shape[-1]).max(-1) > CHECK_BOUNDS["atol"]).mean())
    print(f"{label} shape={tuple(a.shape)} max_abs_err={err} mean_abs_err={mean} "
          f"frac_over_atol={frac} bitwise={bitwise}", flush=True)
    assert frac <= CHECK_BOUNDS["boundary_frac"], f"{label}: {frac:.2%} of pixels over atol"
    assert mean <= CHECK_BOUNDS["mean_atol"], f"{label}: mean abs diff {mean}"
    return err


def camera_for(views, device):
    orient = cam.orientation_from_angles(*cam.CameraAngles.of(0.0, 0.0, 0.0, device=device), device)
    return cam.make_camera(Vec4.of(0.0, -2.0, 0.0, 0.0, device=device), orient, 1.5, 2.0, views, device)


def unhinted(cfg: RenderConfig) -> RenderConfig:
    return replace(cfg, plane_hints=None, plane_pairs=None, axis_hints=None)


def unhinted_k1(scene, camera, cfg: RenderConfig, seeds) -> torch.Tensor:
    """K1 without the static hints, shaped as render_light_cuda shapes its
    light (which derives them)."""
    words, batched = renderer.seed_words(seeds)
    out = megakernel.launch_forward(params.pack(scene, camera), params.layout(scene, camera),
                                    unhinted(cfg),
                                    megakernel.seed_tensor(words, camera.top.x.device))
    out = out[:, 0] if camera.top.x.dim() == 0 else out
    return out if batched else out[0]


def check_hinted(label: str, scene, camera, hinted: torch.Tensor, cfg: RenderConfig, seeds,
                 rows=slice(None), unhinted_kernel=None) -> float:
    """The hinted K1's light against the unhinted K1's (``unhinted_kernel``,
    launched here by default) and both plain pipelines, hinted (``cfg``'s
    hints) and not, each within CHECK_BOUNDS (bitwise so far). Returns the
    largest difference."""
    assert cfg.plane_hints is not None, f"{label}: no hints to hold"
    if unhinted_kernel is None:
        unhinted_kernel = unhinted_k1(scene, camera, cfg, seeds)
    plain_h = renderer.render_light(scene, camera, cfg, seeds, rows)
    plain_u = renderer.render_light(scene, camera, unhinted(cfg), seeds, rows)
    return max(check_close(f"{label} hinted K1 vs unhinted K1", hinted, unhinted_kernel),
               check_close(f"{label} hinted K1 vs hinted plain", hinted, plain_h),
               check_close(f"{label} hinted K1 vs unhinted plain", hinted, plain_u))


def check_kernel_against_plain(device) -> float:
    """Phase 3; returns the largest |kernel - plain| light difference."""
    cfg = RenderConfig(width=256, height=144, samples=4, reflections_amount=4, rng_mode="per_sample")
    seeds = np.array([0x12345678, 0x9ABCDEF0], np.uint32)
    worst = 0.0
    for name in sorted(library.SCENES):
        scene = library.SCENES[name](device)
        hinted = megakernel.with_hints(scene, cfg)
        for views in (("yxz",), cam.VIEWS_ALL):
            camera = camera_for(views, device)
            before = megakernel.HINTED_LAUNCHES
            out = megakernel.render_light_cuda(scene, camera, cfg, seeds)
            assert megakernel.HINTED_LAUNCHES == before + 1, f"{name}: the launch ran no hints"
            again = megakernel.render_light_cuda(scene, camera, cfg, seeds)
            torch.cuda.synchronize()
            assert torch.equal(out, again), f"{name} {views}: two launches differ"
            for k, s in enumerate(seeds):
                single = megakernel.render_light_cuda(scene, camera, cfg, int(s))
                assert torch.equal(out[k], single), f"{name} {views}: frame {k} != scalar-seed launch"
            worst = max(worst, check_hinted(f"{name} views={len(views)}", scene, camera, out,
                                            hinted, seeds))
    return worst


def short_k1(name: str) -> str:
    """A K1 instance's mangled name as ``stub S fold (pairs, singles)`` (-1:
    read from the table; -2: every single plane all live), ``stub S
    composite fold (pairs, singles, kinds, families, hypercube)`` (trace.cuh
    CompositeFold; hypercube -2: its cells) or ``stub S spec fold (trig)``,
    followed for the instances of forwardmodes.cu by ``sampler K rng R``
    (0 poly, 1 kepler, 2 newton; R -1: the launch's argument)."""
    m = re.search(r"forward_kernelILi(\d+)E\w*?(TableFold|CompositeFold|SpecFold)I"
                  r"((?:L[ib]n?\d+E)+)EE(?:Li(n?\d+)ELi(n?\d+)E)?", name)
    if m is None:
        return name
    args = [int(a.replace("n", "-")) for a in re.findall(r"L[ib](n?\d+)E", m.group(3))]
    kind = {"TableFold": "fold", "CompositeFold": "composite fold",
            "SpecFold": "spec fold"}[m.group(2)]
    out = f"stub {m.group(1)} {kind} ({', '.join(map(str, args))})"
    if m.group(4) is not None:
        out += f" sampler {m.group(4)} rng {m.group(5).replace('n', '-')}"
    return out


def k1_resources(device, lib_path: Path) -> dict:
    """Phase 2: the registers, stack frame and spill stores of every K1
    instance (the build log) and the resident warps per SM of each at the
    headline launch (the room's hints) or, for the composite instances, at
    the tiger's 3-view launch (build.resident_warps). Returns them by
    instance, and the room's production instance's as "main"."""
    res = {n: r for n, r in build.kernel_resources(build.build_log()).items()
           if "forward_kernel" in n and r}
    scene, camera = library.room_with_sphere(device), camera_for(("yxz",), device)
    threads, smem = megakernel.launch_shape(scene, params.layout(scene, camera))
    tiger, views3 = library.tiger(device), camera_for(cam.VIEWS_ALL, device)
    comp_shape = megakernel.launch_shape(tiger, params.layout(tiger, views3))
    warps = build.resident_warps(lib_path, {"CompositeFold": comp_shape,
                                            "forward_kernel": (threads, smem)})
    out = {n: {**r, "resident_warps_per_sm": warps.get(n)} for n, r in res.items()}
    main = [r for n, r in out.items() if re.search(K1_MAIN, n)]
    assert len(main) == 1 and main[0]["resident_warps_per_sm"], (K1_MAIN, list(out))
    assert all(r["resident_warps_per_sm"] for r in out.values()), out
    print(json.dumps({"k1_instances": {short_k1(n): r for n, r in out.items()},
                      "block_threads": threads, "smem_bytes": smem,
                      "composite_smem_bytes_tiger_3view": comp_shape[1]}), flush=True)
    return {"main": main[0], "instances": out, "block_threads": threads, "smem_bytes": smem}


def main_path(device):
    """Phase 4: the engine at the headline shape, step_frames(4) timed.
    Returns (engine, per-launch milliseconds)."""
    scene = library.room_with_sphere(device)
    engine = RenderEngine(
        scene, RenderConfig(**HEADLINE), Vec4.of(0.0, -2.0, 0.0, 0.0, device=device),
        cam.CameraAngles.of(0.0, 0.0, 0.0, device=device), device=device, deterministic=True,
    )
    assert engine.cfg.plane_pairs is not None, "the engine derived no wall pairs"
    before = megakernel.LAUNCHES, megakernel.HINTED_LAUNCHES
    engine.step_frames(FRAMES_PER_LAUNCH)  # warm-up launch
    torch.cuda.synchronize()
    assert megakernel.LAUNCHES == before[0] + 1, "step_frames(4) must be one kernel launch"
    engine_ms = cuda_ms(lambda: engine.step_frames(FRAMES_PER_LAUNCH))
    assert megakernel.LAUNCHES == before[0] + 1 + CALLS * REPEATS
    assert megakernel.HINTED_LAUNCHES - before[1] == megakernel.LAUNCHES - before[0], \
        "an engine step ran no hints"
    img = engine.accum
    assert img.shape == (720, 1280, 3) and bool(torch.isfinite(img).all())
    assert float(img.std()) > 0.0, "the headline image is constant"
    return engine, engine_ms


def time_kernel_and_plain(engine):
    """Phase 6: the kernel alone on prepacked inputs, with the engine's
    hints and without, and the plain pipeline once, on the same 4 frames
    of the headline shape; the hinted kernel is held against the unhinted
    one and both plain pipelines. Returns (hinted kernel ms, unhinted
    kernel ms, hinted plain ms, max |kernel - plain|)."""
    scene, cfg = engine.scene, engine.cfg
    camera = engine.groups[0].camera(engine)
    packed, lay = params.pack(scene, camera), params.layout(scene, camera)
    seed_words = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device=engine.device)
    out = megakernel.launch_forward(packed, lay, cfg, seed_words)[:, 0]
    out_u = megakernel.launch_forward(packed, lay, unhinted(cfg), seed_words)[:, 0]
    kernel_ms = cuda_ms(lambda: megakernel.launch_forward(packed, lay, cfg, seed_words))
    unhinted_ms = cuda_ms(lambda: megakernel.launch_forward(packed, lay, unhinted(cfg), seed_words))
    renderer.render_light(scene, camera, cfg, 1)  # warms the allocator at this shape
    plain = []
    plain_ms = cuda_ms(lambda: plain.append(renderer.render_light(
        scene, camera, cfg, np.arange(1, 5, dtype=np.uint32))), calls=1, repeats=1)[0]
    del plain
    err = check_hinted("room headline 4 frames", scene, camera, out, cfg,
                       np.arange(1, 5, dtype=np.uint32), unhinted_kernel=out_u)
    return kernel_ms, unhinted_ms, plain_ms, err


def check_app_groups(device) -> float:
    """Phase 7: the kernel against the plain pipeline on each view group
    of the app's engine, with its cameras, configs and a (2,) seed vector.
    Returns the largest |kernel - plain|."""
    engine = app.build_engine(AppConfig.load(APP_CONFIG), device)
    seeds = np.array([0x0BADF00D, 0xC0FFEE11], np.uint32)
    worst = 0.0
    for g in engine.groups:
        camera = g.camera(engine)
        out = megakernel.render_light_cuda(engine.scene, camera, g.cfg, seeds)
        label = f"app group {g.cfg.width}x{g.cfg.height} views={','.join(g.views)}"
        worst = max(worst, check_hinted(label, engine.scene, camera, out, g.cfg, seeds))
    return worst


def plain_in_bands(scene, camera, cfg: RenderConfig, seeds) -> tuple:
    """(light, calls): the plain pipeline's light of the whole image,
    rendered BAND_ROWS rows at a time (every pixel is computed on its own,
    so the bands are the whole image's rows), and each band's lane_calls
    (lanes alive as device counts: nothing waits on them)."""
    bands, calls = [], []
    for r in range(0, cfg.height, BAND_ROWS):
        light, band_calls, _ = lane_calls(scene, camera, cfg, seeds, slice(r, r + BAND_ROWS))
        bands.append(light)
        calls.append(band_calls)
    return torch.cat(bands, dim=-3), calls


def lane_calls(scene, camera, cfg: RenderConfig, seeds, rows, counter=None) -> tuple:
    """(light, calls, flops) of the plain pipeline on ``rows``: its light;
    each shade and scatter call in order as (lanes alive, lanes), the
    first a device count; and, with a FlopCounter running as ``counter``,
    the flops each of those calls stands for (a shade its own; a scatter
    its own with the updates since the shade before it), else None."""
    calls, flops, mark = [], [], [None]
    real = renderer.trace_rays, renderer._shade, renderer._scatter

    def now() -> float:
        return 0.0 if counter is None else counter.flops

    def trace_rays(*args, **kwargs):
        mark[0] = None
        return real[0](*args, **kwargs)

    def shade(scene_, o, d, result, throughput, alive, cfg_):
        before = now()
        out = real[1](scene_, o, d, result, throughput, alive, cfg_)
        calls.append((alive.sum(), alive.numel()))
        flops.append(now() - before)
        mark[0] = now()
        return out

    def scatter(d, norm, mirrored, alive, *rest):
        before = now()
        out = real[2](d, norm, mirrored, alive, *rest)
        calls.append((alive.sum(), alive.numel()))
        flops.append(now() - (before if mark[0] is None else mark[0]))
        mark[0] = None
        return out

    renderer.trace_rays, renderer._shade, renderer._scatter = trace_rays, shade, scatter
    try:
        light = renderer.render_light(scene, camera, cfg, seeds, rows)
    finally:
        renderer.trace_rays, renderer._shade, renderer._scatter = real
    return light, calls, (flops if counter is not None else None)


def live_of(dense: float, calls, flops) -> float:
    """The flops of a run of ``dense`` flops that K1's live lanes need:
    each call's flops count for the share of its lanes alive."""
    return dense - sum((1.0 - int(alive) / lanes) * f for (alive, lanes), f in zip(calls, flops))


def live_lane_flops(scene, camera, cfg: RenderConfig, seeds, rows) -> tuple:
    """(dense, live) flops of the plain pipeline on ``rows``: ``dense``
    counts every lane of every bounce (utils/flops.py), ``live`` what this
    run's data needs of K1, which stops a lane that left the scene where
    the plain version computes on: each bounce's shade counts for the share
    of lanes alive entering it, and each scatter, with the updates before
    it, for the share alive after that bounce's shade (bounce 0's: the
    pixels whose primary ray hit). Both count final_light on every such
    lane, where K1 runs it on a lane that misses only. (A call's flops
    depend on the shapes alone, not on the data, but for the newton
    sampler's, whose plain version steps the lanes still going: so
    composite_cells, in the production configuration, counts one band and
    takes every band's shares.)"""
    with FlopCounter() as counter:
        _, calls, flops = lane_calls(scene, camera, cfg, seeds, rows, counter)
    return counter.flops, live_of(counter.flops, calls, flops)


def composite_cells(device) -> dict:
    """Phase 7b: each of COMPOSITE_CELLS at the headline shape through
    RenderEngine.step_frames(4) (its main path: the engine derives the
    plane and axis hints once; the launches counted from zeroed counts),
    timed; K1 alone on the same 4 frames with those hints and without,
    timed and held against each other; the hinted plain pipeline in
    BAND_ROWS-row bands, timed once and held against K1; the bound from the
    hinted plain version's flops (one band counted, each band's live
    shares from the timed pass). Returns the cells by scene."""
    cells = {}
    for name, views in COMPOSITE_CELLS:
        scene = library.SCENES[name](device)
        reset_counts()
        engine = RenderEngine(
            scene, RenderConfig(**HEADLINE), Vec4.of(0.0, -2.0, 0.0, 0.0, device=device),
            cam.CameraAngles.of(0.0, 0.0, 0.0, device=device), device=device,
            deterministic=True, views=views)
        cfg = engine.cfg
        assert cfg.axis_hints is not None and cfg.plane_hints is not None, f"{name}: no hints"
        engine.step_frames(FRAMES_PER_LAUNCH)  # warm-up launch
        torch.cuda.synchronize()
        engine_ms = cuda_ms(lambda: engine.step_frames(FRAMES_PER_LAUNCH))
        launches = counts()
        assert launches["k1"] == 1 + CALLS * REPEATS == megakernel.HINTED_LAUNCHES, launches
        img = engine.accum
        assert img.shape == image_shape(views, cfg) + (3,) and bool(torch.isfinite(img).all())
        assert float(img.std()) > 0.0, f"{name}: the image is constant"
        camera = engine.groups[0].camera(engine)
        packed, lay = params.pack(scene, camera), params.layout(scene, camera)
        frames = np.arange(1, FRAMES_PER_LAUNCH + 1, dtype=np.uint32)
        words = megakernel.seed_tensor(frames, device)
        one = (lambda x: x[:, 0]) if len(views) == 1 else (lambda x: x)
        out = one(megakernel.launch_forward(packed, lay, cfg, words))
        out_u = one(megakernel.launch_forward(packed, lay, unhinted(cfg), words))
        kernel_ms = cuda_ms(lambda: megakernel.launch_forward(packed, lay, cfg, words))
        unhinted_ms = cuda_ms(lambda: megakernel.launch_forward(packed, lay, unhinted(cfg), words))
        label = f"{name} {cfg.width}x{cfg.height} views={len(views)} 4 frames"
        err = check_close(f"{label} hinted K1 vs unhinted K1", out, out_u)
        plain = []
        plain_ms = cuda_ms(lambda: plain.append(plain_in_bands(scene, camera, cfg, frames)),
                           calls=1, repeats=1)[0]
        light, band_calls = plain.pop()
        err = max(err, check_close(f"{label} hinted K1 vs hinted plain ({BAND_ROWS}-row bands)",
                                   out, light))
        # The flops of one band's calls, counted, stand for every band's.
        assert cfg.height % BAND_ROWS == 0
        with FlopCounter() as counter:
            _, _, flops = lane_calls(scene, camera, cfg, frames, slice(0, BAND_ROWS), counter)
        assert all(len(c) == len(flops) for c in band_calls)
        dense = counter.flops * len(band_calls)
        live = sum(live_of(counter.flops, c, flops) for c in band_calls)
        pixels = len(views) * cfg.height * cfg.width
        rays = pixels * cfg.samples * FRAMES_PER_LAUNCH
        med = statistics.median(kernel_ms)
        cells[name] = {
            "views": len(views), "rays_per_launch": rays, "engine_launches": launches["k1"],
            "engine_step_frames_ms": engine_ms, "engine_ms_median": statistics.median(engine_ms),
            "kernel_ms": kernel_ms, "ms": med, "kernel_mrays_per_s": rays / med / 1e3,
            "unhinted_ms": statistics.median(unhinted_ms), "plain_ms": plain_ms,
            "max_abs_err": err, "bitwise": BITWISE[f"{label} hinted K1 vs hinted plain "
                                                   f"({BAND_ROWS}-row bands)"],
            **bound(live, 4 * (lay.size + FRAMES_PER_LAUNCH + FRAMES_PER_LAUNCH * pixels * 3)),
            "dense": bound(dense, 4 * (lay.size + FRAMES_PER_LAUNCH + FRAMES_PER_LAUNCH * pixels * 3)),
        }
        cells[name]["flops_per_ray"] = live / rays
        print(json.dumps({"cell": f"{name} {label} per_sample, hints derived by the engine",
                          **cells[name]}), flush=True)
    return cells


def modes_engine(device) -> dict:
    """Phase 7c's main path: RenderEngine on the room at the headline shape
    in RenderConfig()'s modes and in the oracle's, step_frames(4) timed,
    from zeroed counts: one K1 launch a step, every launch counted by its
    configuration, the default's all hinted. Returns each drive's times
    and counts."""
    out = {}
    for label, modes in (("default", {}), ("oracle", ORACLE_MODES)):
        cfg = RenderConfig(width=HEADLINE["width"], height=HEADLINE["height"],
                           samples=HEADLINE["samples"],
                           reflections_amount=HEADLINE["reflections_amount"], **modes)
        assert cfg.rng_mode == "sequential"
        reset_counts()
        engine = RenderEngine(
            library.room_with_sphere(device), cfg, Vec4.of(0.0, -2.0, 0.0, 0.0, device=device),
            cam.CameraAngles.of(0.0, 0.0, 0.0, device=device), device=device,
            deterministic=True)
        engine.step_frames(FRAMES_PER_LAUNCH)  # warm-up launch
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: engine.step_frames(FRAMES_PER_LAUNCH), MODE_CALLS, MODE_REPEATS)
        n = 1 + MODE_CALLS * MODE_REPEATS
        key = megakernel.launch_config(engine.cfg, params.layout(engine.scene, engine.groups[0]
                                                                 .camera(engine)))
        assert megakernel.LAUNCHES == n and megakernel.CONFIG_LAUNCHES == {key: n}, \
            (label, megakernel.LAUNCHES, megakernel.CONFIG_LAUNCHES)
        hinted = megakernel.HINTED_LAUNCHES
        assert hinted == (n if label == "default" else 0), (label, hinted)
        img = engine.accum
        assert img.shape == (720, 1280, 3) and bool(torch.isfinite(img).all())
        assert float(img.std()) > 0.0, f"{label}: the image is constant"
        out[label] = {"config": key, "launches": n, "hinted_launches": hinted,
                      "engine_step_frames_ms": ms, "engine_ms_median": statistics.median(ms)}
        print(json.dumps({"cell": f"room_with_sphere 1280x720 8spp 4 bounces {key}, 4 frames a "
                                  "launch, RenderEngine", **out[label]}), flush=True)
    return out


def modes_timed(device) -> dict:
    """Phase 7c: K1 at the headline shape, 4 frames a launch, on MODE_CELLS
    in each MODE_TIMED configuration (the fast fold with the hints the
    entry point derives), timed with CUDA events; the plain version of the
    whole image timed once and held against K1; each one's bound from the
    plain version's flops over the whole image (live_lane_flops: the live
    lanes; the plain newton steps the lanes still going alone, so its
    count is the work this data needs). Returns them by scene and
    configuration."""
    cells = {}
    frames = np.arange(1, FRAMES_PER_LAUNCH + 1, dtype=np.uint32)
    words = megakernel.seed_tensor(frames, device)
    for name, views in MODE_CELLS:
        scene, camera = library.SCENES[name](device), camera_for(views, device)
        packed, lay = params.pack(scene, camera), params.layout(scene, camera)
        pixels = len(views) * HEADLINE["height"] * HEADLINE["width"]
        rays = pixels * HEADLINE["samples"] * FRAMES_PER_LAUNCH
        one = (lambda x: x[:, 0]) if len(views) == 1 else (lambda x: x)
        for key, modes in MODE_TIMED.items():
            cfg = megakernel.with_hints(scene, RenderConfig(**dict(HEADLINE, **modes)))
            before = dict(megakernel.CONFIG_LAUNCHES)
            out = one(megakernel.launch_forward(packed, lay, cfg, words))
            assert megakernel.CONFIG_LAUNCHES.get(key, 0) == before.get(key, 0) + 1, key
            ms = cuda_ms(lambda: megakernel.launch_forward(packed, lay, cfg, words),
                         MODE_CALLS, MODE_REPEATS)
            plain = []
            plain_ms = cuda_ms(lambda: plain.append(renderer.render_light(scene, camera, cfg,
                                                                          frames)),
                               calls=1, repeats=1)[0]
            label = f"{name} views={len(views)} {key} 1280x720 4 frames"
            err = check_close(f"{label} K1 vs plain", out, plain.pop())
            dense, live = live_lane_flops(scene, camera, cfg, frames, slice(None))
            med = statistics.median(ms)
            cell = {"views": len(views), "hinted": megakernel.hinted(cfg), "kernel_ms": ms,
                    "ms": med, "kernel_mrays_per_s": rays / med / 1e3, "plain_ms": plain_ms,
                    "max_abs_err": err, "bitwise": BITWISE[f"{label} K1 vs plain"],
                    **bound(live, 4 * (lay.size + FRAMES_PER_LAUNCH
                                       + FRAMES_PER_LAUNCH * pixels * 3)),
                    "dense_flops": dense, "flops_per_ray": live / rays}
            cell["share_of_published_peak"] = live / (med * 1e-3) / PEAKS["fp32_flops_per_s"]
            cells.setdefault(name, {})[key] = cell
            print(json.dumps({"cell": label, **cell}), flush=True)
    return cells


def moved_wall(scene):
    """``scene`` with hyperplane 0 moved 0.25 against its normal: a second
    params row of the same structure."""
    wall = scene.spaces[0]
    return scene._replace(spaces=(wall._replace(point=wall.point - wall.norm * 0.25),
                                  *scene.spaces[1:]))


def modes_scene(name: str, device):
    """A library scene, or "hypercube_cells": the hypercube built from its
    cells alone (no generators)."""
    if name == "hypercube_cells":
        scene = library.hypercube(device)
        return scene._replace(hypercube=type(scene.hypercube)(scene.hypercube.cubes))
    return library.SCENES[name](device)


def check_modes(device) -> dict:
    """Phase 7c: at MODES_CHECK, every configuration rng x sampler x fold
    on every library scene and a hypercube without generators, K1 over a
    (2,) seed vector against its plain version (CHECK_BOUNDS; bitwise where
    no transcendental runs: the poly sampler off the trig fold); then the
    sequential stream's K2 rows (the scene and moved_wall's copy) and K3
    blocks (2 and 4 of mesh.row_block) bitwise its single launches, on the
    room, the tiger and the cells-only hypercube. Returns the worst
    difference, the configurations checked with their launches, and
    whether every check without a transcendental was bitwise."""
    seeds = np.array([0x2468ACE0, 0x13579BDF], np.uint32)
    words = megakernel.seed_tensor(seeds, device)
    camera = camera_for(("yxz",), device)
    worst, checked, exact = 0.0, {}, True
    for name in sorted(library.SCENES) + ["hypercube_cells"]:
        scene = modes_scene(name, device)
        packed, lay = params.pack(scene, camera), params.layout(scene, camera)
        for rng_mode in renderer.RNG_MODES:
            for sampler in megakernel.SAMPLER_CODES:
                for fold in megakernel.FOLD_CODES:
                    cfg = megakernel.with_hints(scene, RenderConfig(
                        **MODES_CHECK, rng_mode=rng_mode, sampler_method=sampler,
                        intersect=fold))
                    key = megakernel.launch_config(cfg, lay)
                    out = megakernel.launch_forward(packed, lay, cfg, words)[:, 0]
                    label = f"7c {name} {key} 256x144"
                    worst = max(worst, check_close(f"{label} K1 vs plain", out,
                                                   renderer.render_light(scene, camera, cfg,
                                                                         seeds)))
                    if sampler == "poly" and fold != "trig":
                        exact = exact and BITWISE[f"{label} K1 vs plain"]
                    checked[key] = checked.get(key, 0) + 1
        if name not in ("room_with_sphere", "tiger", "hypercube_cells"):
            continue
        for sampler, fold in (("poly", "fast"), ("newton", "trig")):
            cfg = megakernel.with_hints(scene, RenderConfig(
                **MODES_CHECK, rng_mode="sequential", sampler_method=sampler, intersect=fold))
            one = words[:1]
            singles = [megakernel.launch_forward(params.pack(sc, camera), lay, cfg, one)[0]
                       for sc in (scene, moved_wall(scene))]
            rows = params.stack_rows((scene, moved_wall(scene)), camera)
            both = megakernel.launch_forward(rows, lay, cfg, one.repeat(2))
            for k in range(2):
                assert torch.equal(both[k], singles[k]), f"{name} {sampler}/{fold}: K2 row {k}"
            assert not torch.equal(singles[0], singles[1])
            for n in SHARDS:
                for i in range(n):
                    row0, n_rows = pmesh.row_block(cfg.height, n, i)
                    block = megakernel.launch_forward(rows, lay, cfg, one.repeat(2),
                                                      (row0, n_rows))
                    assert torch.equal(block, both[..., row0:row0 + n_rows, :, :]), \
                        f"{name} {sampler}/{fold}: K3 block {i} of {n}"
            print(f"7c {name} sequential/{sampler}/{fold}: K2 rows and K3 blocks (2, 4) "
                  "bitwise the single launches", flush=True)
    assert exact, "a launch without a transcendental differed from its plain version"
    return {"max_abs_err": worst, "checked": checked, "exact_without_transcendentals": exact}


def mixed_rel(a: np.ndarray, b: np.ndarray) -> float:
    scale = np.maximum(np.abs(b), 1e-3 * np.abs(b).max() + 1e-8)
    return float((np.abs(a - b) / scale).max())


def compare_grad(label: str, kernel, plain, floor: float = 0.0):
    """Hold K4's (loss, grad) against the plain version's within
    GRAD_BOUNDS, the non-zero patterns on the slots above ``floor`` of the
    largest; prints the comparison and returns (max |K4 - plain| over loss
    and gradient, mixed-scale relative gradient error)."""
    k_l, p_l = float(kernel[0]), float(plain[0])
    k_g, p_g = kernel[1].cpu().numpy(), plain[1].cpu().numpy()
    assert k_g.shape == p_g.shape, f"{label}: {k_g.shape} vs {p_g.shape}"
    assert np.isfinite(k_g).all() and np.isfinite(k_l), f"{label}: non-finite K4 output"
    rel = mixed_rel(k_g, p_g)
    err = max(abs(k_l - p_l), float(np.abs(k_g - p_g).max()))
    big = np.maximum(np.abs(k_g), np.abs(p_g)) > floor * np.abs(p_g).max()
    same_nz = bool(((k_g != 0) == (p_g != 0))[big].all())
    print(f"K4 {label} P={k_g.size} loss={k_l} plain={p_l} loss_rel={abs(k_l - p_l) / abs(p_l):.3g} "
          f"grad_mixed_rel={rel:.3g} max_abs_err={err:.3g} "
          f"nonzero={int((k_g != 0).sum())}/{int((p_g != 0).sum())} same_pattern={same_nz}",
          flush=True)
    assert abs(k_l - p_l) <= GRAD_BOUNDS["loss_rtol"] * abs(p_l), f"{label}: loss"
    assert rel <= GRAD_BOUNDS["grad_mixed_rel"], f"{label}: gradient error {rel}"
    assert same_nz, f"{label}: non-zero patterns differ"
    return err, rel


def frozen_setup(scene, camera, cfg: RenderConfig):
    """(cfg under the freeze_hints contract, the launch's keep mask, the
    frozen slots) of the scene: the production configuration
    (diff.with_frozen_hints) with the packed mask the wrappers hand the
    kernels."""
    hcfg = diff.with_frozen_hints(cfg, scene)
    assert hcfg.plane_hints is not None, "no hints to freeze by"
    keep = params.freeze_mask(hcfg, scene, params.layout(scene, camera).size,
                              camera.focus.x.device)
    return hcfg, keep, keep == 0


# Every check of the freeze_hints contract: the hinted launch against the
# unhinted one (loss and other outputs bitwise, every kept slot bitwise,
# every frozen slot 0), by label.
CONTRACT = {}


def check_contract(label: str, hinted, unhinted, frozen: torch.Tensor) -> None:
    """The freeze_hints contract of a gradient launch: ``hinted`` and
    ``unhinted`` are its outputs (a gradient, or a tuple whose gradient is
    the element of the packed width, the rest compared whole), the hinted
    launch's bitwise the unhinted's but for the frozen slots, which are
    exactly 0 (== takes -0 for +0)."""
    hinted = hinted if isinstance(hinted, tuple) else (hinted,)
    unhinted = unhinted if isinstance(unhinted, tuple) else (unhinted,)
    n = frozen.numel()
    ok = True
    for h, u in zip(hinted, unhinted):
        if h.dim() >= 1 and h.shape[-1] == n:
            kept = torch.equal(h[..., ~frozen], u[..., ~frozen])
            zero = bool((h[..., frozen] == 0).all())
            moved = int((u[..., frozen] != 0).sum())
            print(f"contract {label}: kept slots bitwise={kept} frozen slots 0={zero} "
                  f"(the unhinted launch has {moved} of them non-zero)", flush=True)
            ok = ok and kept and zero
        else:
            same = torch.equal(h, u)
            print(f"contract {label}: {tuple(h.shape) or 'loss'} bitwise={same}", flush=True)
            ok = ok and same
    CONTRACT[label] = ok
    assert ok, f"{label}: the freeze_hints contract does not hold"


def check_grad_kernel(device):
    """Phase 8 checks; returns (max |K4 - plain| over loss and gradients,
    max mixed-scale relative gradient error)."""
    cfg = RenderConfig(**GRAD_CHECK)
    seeds = np.array([0x12345678, 0x9ABCDEF0], np.uint32)
    worst_abs = worst_rel = 0.0
    for name in GRAD_SCENES:
        scene = library.SCENES[name](device)
        for views in (("yxz",), cam.VIEWS_ALL):
            label = f"{name} views={len(views)}"
            camera = camera_for(views, device)
            packed, lay = params.pack(scene, camera), params.layout(scene, camera)
            shape = (cfg.height, cfg.width, 3) if len(views) == 1 else (len(views), cfg.height,
                                                                          cfg.width, 3)
            target = torch.from_numpy(
                np.random.default_rng(1).uniform(0, 1, shape).astype(np.float32)).to(device)
            words = megakernel.seed_tensor(seeds, device)
            loss, grad = gradkernel.launch_loss_grad(packed, lay, cfg, words, target)
            loss2, grad2 = gradkernel.launch_loss_grad(packed, lay, cfg, words, target)
            plain = gradkernel.loss_and_grad_plain(packed, scene, camera, cfg, seeds, target)
            torch.cuda.synchronize()
            assert torch.equal(loss, loss2) and torch.equal(grad, grad2), f"{label}: launches differ"
            err, rel = compare_grad(label, (loss, grad), plain)
            singles = [gradkernel.launch_loss_grad(packed, lay, cfg,
                                                   megakernel.seed_tensor([s], device), target)
                       for s in seeds]
            mean_l = sum(float(sl) for sl, _ in singles) / len(seeds)
            mean_g = sum(sg.cpu().numpy() for _, sg in singles) / len(seeds)
            k_l = float(loss)
            print(f"K4 {label} minibatch_vs_mean_loss_rel={abs(k_l - mean_l) / abs(mean_l):.3g}",
                  flush=True)
            np.testing.assert_allclose(k_l, mean_l, rtol=GRAD_BOUNDS["minibatch_rtol"])
            np.testing.assert_allclose(
                grad.cpu().numpy(), mean_g, rtol=GRAD_BOUNDS["minibatch_rtol"],
                atol=1e-7 * max(1.0, float(np.abs(mean_g).max())))
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
            # Under the freeze_hints contract: bitwise the unhinted launch
            # but for the frozen slots, bitwise across launches, and within
            # GRAD_BOUNDS of the unhinted plain version with them frozen.
            hcfg, keep, frozen = frozen_setup(scene, camera, cfg)
            hinted = gradkernel.launch_loss_grad(packed, lay, hcfg, words, target, keep=keep)
            again = gradkernel.launch_loss_grad(packed, lay, hcfg, words, target, keep=keep)
            assert all(torch.equal(a, b) for a, b in zip(hinted, again)), \
                f"{label} frozen hints: launches differ"
            check_contract(f"K4 {label}", hinted, (loss, grad), frozen)
            err, rel = compare_grad(f"{label} frozen hints", hinted,
                                    (plain[0], gradkernel.freeze(plain[1], scene, hcfg)))
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
    return worst_abs, worst_rel


def peak_gb(fn):
    """(fn(), peak bytes the CUDA allocator held during it, in GB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 1e9


def time_grad_kernel(device):
    """Phase 8 at the training shapes: K4 and its plain version on the same
    inputs at TRAIN_SMALL (plain whole) and at TRAIN for each frame count
    of phase 9 (plain in row bands), held against each other and timed.
    Returns a dict of the timings, errors and the plain version's peak
    memory."""
    scene, camera = library.room_with_sphere(device), camera_for(("yxz",), device)
    packed, lay = params.pack(scene, camera), params.layout(scene, camera)
    small = RenderConfig(**TRAIN_SMALL)
    target = torch.zeros((small.height, small.width, 3), device=device)
    words = megakernel.seed_tensor([1], device)
    out = []
    res = {"k4_small_ms": cuda_ms(lambda: out.append(
        gradkernel.launch_loss_grad(packed, lay, small, words, target)))}
    plain = []
    gradkernel.loss_and_grad_plain(packed, scene, camera, small, 1, target)  # warm-up
    res["plain_small_ms"], res["plain_small_peak_gb"] = peak_gb(lambda: cuda_ms(
        lambda: plain.append(gradkernel.loss_and_grad_plain(packed, scene, camera, small, 1,
                                                            target)),
        calls=1, repeats=3))
    errs = [compare_grad(f"room {small.width}x{small.height}x{small.samples}spp "
                         f"x{small.reflections_amount} F=1", out[-1], plain[-1])]
    full = RenderConfig(**TRAIN)
    target = torch.zeros((full.height, full.width, 3), device=device)
    hcfg, keep, frozen = frozen_setup(scene, camera, full)
    for key in ("k4_full_ms", "k4_hinted_full_ms", "plain_full_ms", "plain_band_peak_gb"):
        res[key] = {}
    for frames in TRAIN_FRAMES:
        seeds = list(range(1, frames + 1))
        words = megakernel.seed_tensor(seeds, device)
        kernel = gradkernel.launch_loss_grad(packed, lay, full, words, target)  # and warm-up
        again = gradkernel.launch_loss_grad(packed, lay, full, words, target)
        assert all(torch.equal(a, b) for a, b in zip(kernel, again)), \
            f"K4 1280x720 F={frames}: two launches differ"
        hinted = gradkernel.launch_loss_grad(packed, lay, hcfg, words, target, keep=keep)
        assert all(torch.equal(a, b) for a, b in zip(hinted, gradkernel.launch_loss_grad(
            packed, lay, hcfg, words, target, keep=keep))), \
            f"K4 1280x720 F={frames} frozen hints: two launches differ"
        check_contract(f"K4 room 1280x720x8spp x4 F={frames}", hinted, kernel, frozen)
        plain = []
        ms, res["plain_band_peak_gb"][frames] = peak_gb(lambda: cuda_ms(
            lambda: plain.append(gradkernel.loss_and_grad_plain(
                packed, scene, camera, full, seeds, target, band_rows=BAND_ROWS)),
            calls=1, repeats=1))
        res["plain_full_ms"][frames] = ms[0]
        errs.append(compare_grad(f"room 1280x720x8spp x4 F={frames} (plain in {BAND_ROWS}-row "
                                 "bands)", kernel, plain[0]))
        errs.append(compare_grad(f"room 1280x720x8spp x4 F={frames} frozen hints (plain in "
                                 f"{BAND_ROWS}-row bands, frozen)", hinted,
                                 (plain[0][0], gradkernel.freeze(plain[0][1], scene, hcfg))))
        # The production (hinted) launch and the unhinted one, in turns.
        for key, c, k in (("k4_hinted_full_ms", hcfg, keep), ("k4_full_ms", full, None)):
            res[key][frames] = cuda_ms(
                lambda c=c, k=k: gradkernel.launch_loss_grad(packed, lay, c, words, target,
                                                             keep=k),
                calls=TRAIN_CALLS, repeats=TRAIN_REPEATS)
    res["err"], res["rel"] = max(e for e, _ in errs), max(r for _, r in errs)
    print(f"plain version peak memory: {res['plain_small_peak_gb']:.3f} GB whole at 256x144, "
          f"{res['plain_band_peak_gb'][1]:.3f} GB per {BAND_ROWS}-row band at 1280x720", flush=True)
    return res


def check_inverse_render_shapes(device):
    """Phase 8 at phase 10's shape: the forward kernel's target render and
    K4 at the starting scene, each against its plain version. Returns
    (max |K1 - plain| light, max |K4 - plain|, K4 mixed relative error)."""
    args = inverse_render.parse_args([])
    cfg, camera, target, scene0 = inverse_render.setup(args, device)
    truth = inverse_render.make_scene(1.0, inverse_render.TRUE_GLOW, device)
    label = f"inverse_render {cfg.width}x{cfg.height}x{cfg.samples}spp x{cfg.reflections_amount}"
    light_err = check_close(f"{label} target", megakernel.render_light_cuda(
        truth, camera, cfg, args.seed), renderer.render_light(truth, camera, cfg, args.seed))
    packed = params.pack(scene0, camera)
    err, rel = compare_grad(label, gradkernel.loss_and_grad_cuda(
        packed, scene0, camera, cfg, args.seed, target), gradkernel.loss_and_grad_plain(
        packed, scene0, camera, cfg, args.seed, target))
    return light_err, err, rel


def composite_scene(name: str, device):
    """A scene of COMPOSITE_GRAD: a library scene, or "cylinders" (a floor,
    a cylinder on the x and w axes and one on w and x turned 0.3 rad toward
    z, sphere_plane_light's environment). The turned cylinder's axis plane
    is kept off the camera's view direction (+y): a family whose plane
    holds it is met by rays nearly parallel to the plane, hit far away,
    whose partials, orders of magnitude above a slot's total, round apart
    in the kernel and in autograd by more than GRAD_BOUNDS of that total
    (tests/test_torch_freeze_hints.py's turn in the x-y plane did so in K5
    at 256x144; PERF.md section 6)."""
    if name != "cylinders":
        return library.SCENES[name](device)
    from fourd_ray_tracing_tpu_torch.models import scene as sc

    c, s = float(np.float32(np.cos(0.3))), float(np.float32(np.sin(0.3)))

    def mat(color):
        return sc.material(0, 0, color, device)

    return sc.Scene(
        spaces=(sc.space((0, 0, -1.5, 0), (0, 0, 1, 0), mat((0.4, 0.25, 0.07)), device),),
        cylinders=(sc.cylinder((0, 2, 0, 0), (1, 0, 0, 0), (0, 0, 0, 1), 0.8,
                               mat((1.0, 0.2, 0.2)), device),
                   sc.cylinder((0.5, 2, 0, 0), (0, 0, 0, 1), (c, 0, s, 0), 0.6,
                               mat((0.2, 0.9, 0.3)), device)),
        environment=library.sphere_plane_light(device).environment)


def reordered(name: str, scene):
    """The library composite scene ``name`` listed in another order that
    leaves the object alone: the tiger's two families swapped, the
    duocylinder's two cylinders swapped (equal radii), the hypercube's
    x and y axes swapped with their cells. Its hints then match no
    library instance, so the gradient launches take the generic composite
    fold for the same work (as tools/compare_trees.py times RoomFold on the
    room with its walls reordered)."""
    if name == "tiger":
        t = scene.tiger
        return scene._replace(tiger=t._replace(inner_cyl1=t.inner_cyl2, outer_cyl1=t.outer_cyl2,
                                               inner_cyl2=t.inner_cyl1, outer_cyl2=t.outer_cyl1))
    if name == "duocylinder":
        c1, c2 = scene.cylinders_union
        assert float(c1.r) == float(c2.r)
        return scene._replace(cylinders_union=(c2, c1))
    hc = scene.hypercube
    order = (1, 0, 2, 3, 5, 4, 6, 7)
    return scene._replace(hypercube=hc._replace(
        cubes=tuple(hc.cubes[i] for i in order), axes=(hc.axes[1], hc.axes[0], *hc.axes[2:])))


def moved_floor(scene):
    """``scene`` with its floor (hyperplane 0) 0.25 lower: K5's second
    params row on a composite scene (same structure; the composites' soft
    half, zero_object, is not ported)."""
    floor = scene.spaces[0]
    return scene._replace(spaces=(floor._replace(point=floor.point._replace(
        z=floor.point.z - 0.25)), *scene.spaces[1:]))


def check_composite_k4(device):
    """Phase 8 on COMPOSITE_GRAD at GRAD_CHECK, 1 and 3 views, one seed
    (the room and the lamp scene hold the (F,) seed vector): K4 unhinted (the composite descriptor without hints) against
    its plain version, bitwise across two launches; under the frozen hints
    (each library scene's own instance) the contract against the unhinted
    launch, bitwise across launches, and within GRAD_BOUNDS of the
    unhinted plain version with the slots frozen. Returns (max abs error,
    max mixed-scale relative error)."""
    cfg = RenderConfig(**GRAD_CHECK)
    seeds = np.array([0x12345678], np.uint32)
    words = megakernel.seed_tensor(seeds, device)
    errs = []
    for name in COMPOSITE_GRAD:
        scene = composite_scene(name, device)
        for views in (("yxz",), cam.VIEWS_ALL):
            label = f"{name} views={len(views)}"
            camera = camera_for(views, device)
            packed, lay = params.pack(scene, camera), params.layout(scene, camera)
            target = torch.from_numpy(np.random.default_rng(1).uniform(
                0, 1, (*image_shape(views, cfg), 3)).astype(np.float32)).to(device)
            out = gradkernel.launch_loss_grad(packed, lay, cfg, words, target)
            again = gradkernel.launch_loss_grad(packed, lay, cfg, words, target)
            assert all(torch.equal(a, b) for a, b in zip(out, again)), f"{label}: launches differ"
            plain = gradkernel.loss_and_grad_plain(packed, scene, camera, cfg, seeds, target)
            errs.append(compare_grad(label, out, plain, COMPOSITE_PATTERN_FLOOR))
            hcfg, keep, frozen = frozen_setup(scene, camera, cfg)
            hinted = gradkernel.launch_loss_grad(packed, lay, hcfg, words, target, keep=keep)
            again = gradkernel.launch_loss_grad(packed, lay, hcfg, words, target, keep=keep)
            assert all(torch.equal(a, b) for a, b in zip(hinted, again)), \
                f"{label} frozen hints: launches differ"
            check_contract(f"K4 {label}", hinted, out, frozen)
            errs.append(compare_grad(f"{label} frozen hints", hinted,
                                     (plain[0], gradkernel.freeze(plain[1], scene, hcfg)),
                                     COMPOSITE_PATTERN_FLOOR))
    return max(e for e, _ in errs), max(r for _, r in errs)


def split_launch(packed, lay, cfg: RenderConfig, words, target, keep=None) -> tuple:
    """((loss, grad) of one K4 launch, the sample split its sweep took, as
    its ``k4.sweep_split`` counter recorded it under a CPU profiler)."""
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = gradkernel.launch_loss_grad(packed, lay, cfg, words, target, keep=keep)
    (split,) = [c.value for c in profiling.counters() if c.name == "k4.sweep_split"]
    profiling.clear()
    return out, split


def check_split_k4(device) -> tuple:
    """Phase 8 at SPLIT_CHECK, one view, SPLIT_FRAMES frames a launch, where
    the sweep splits each pixel's samples: on SPLIT_SCENES K4 unhinted and
    under the frozen hints (each library scene's own instance), and on the
    SPLIT_MODE scene in its modes instance unhinted; each launch's split at
    least 4, the hinted launch's the unhinted one's, bitwise across two
    launches, the contract against the unhinted launch, within GRAD_BOUNDS
    of the plain version in BAND_ROWS-row bands (frozen with the hints).
    Returns (max abs error, max mixed-scale relative error, the splits by
    label)."""
    seeds = np.arange(11, 11 + SPLIT_FRAMES, dtype=np.uint32)
    words = megakernel.seed_tensor(seeds, device)
    camera = camera_for(("yxz",), device)
    target = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (SPLIT_CHECK["height"], SPLIT_CHECK["width"], 3)).astype(np.float32)).to(device)
    errs, splits = [], {}
    for name, mode in [(name, {}) for name in SPLIT_SCENES] + [SPLIT_MODE]:
        scene = composite_scene(name, device)
        packed, lay = params.pack(scene, camera), params.layout(scene, camera)
        floor = COMPOSITE_PATTERN_FLOOR if lay.composite_kinds() else 0.0
        cfg = RenderConfig(**SPLIT_CHECK, **mode)
        label = (f"{name} {megakernel.launch_config(cfg, lay)} {cfg.width}x{cfg.height}x"
                 f"{cfg.samples}spp x{cfg.reflections_amount} F={SPLIT_FRAMES}")
        out, split = split_launch(packed, lay, cfg, words, target)
        again = gradkernel.launch_loss_grad(packed, lay, cfg, words, target)
        assert all(torch.equal(a, b) for a, b in zip(out, again)), f"{label}: launches differ"
        assert split >= 4, f"{label}: the sweep split its samples {split} ways"
        splits[label] = split
        plain = gradkernel.loss_and_grad_plain(packed, scene, camera, cfg, seeds, target,
                                               band_rows=BAND_ROWS)
        errs.append(compare_grad(f"{label} split={split}", out, plain, floor))
        if mode:
            continue
        hcfg, keep, frozen = frozen_setup(scene, camera, cfg)
        hinted, h_split = split_launch(packed, lay, hcfg, words, target, keep)
        again = gradkernel.launch_loss_grad(packed, lay, hcfg, words, target, keep=keep)
        assert all(torch.equal(a, b) for a, b in zip(hinted, again)), \
            f"{label} frozen hints: launches differ"
        assert h_split == split, f"{label}: the hinted launch split {h_split} ways, not {split}"
        check_contract(f"K4 {label} split={split}", hinted, out, frozen)
        errs.append(compare_grad(f"{label} frozen hints split={split}", hinted,
                                 (plain[0], gradkernel.freeze(plain[1], scene, hcfg)), floor))
    return max(e for e, _ in errs), max(r for _, r in errs), splits


def k4_bound(scene, camera, cfg: RenderConfig, packed, lay) -> dict:
    """K4's bound at ``cfg`` (one frame, one view) under the frozen hints:
    the hinted plain version's flops (forward and autograd backward) over
    BOUND_ROWS rows, scaled to the image, times the share of the dense
    work that the hinted forward's live lanes need over the whole image
    (live_lane_flops in BAND_ROWS-row bands, one band counted, as
    composite_cells: the sweep re-traces and reverses a live lane's
    bounces only); the dense count and the live share beside it."""
    hcfg = diff.with_frozen_hints(cfg, scene)
    rows, scale = (0, BOUND_ROWS), cfg.height / BOUND_ROWS
    block = torch.zeros((BOUND_ROWS, cfg.width, 3), device=packed.device)
    dense = count_flops(gradkernel.loss_and_grad_plain, packed, scene, camera, hcfg, [1], block,
                        rows=rows)[1] * scale
    with FlopCounter() as counter:
        _, _, flops = lane_calls(scene, camera, hcfg, [1], slice(0, BAND_ROWS), counter)
    bands = [lane_calls(scene, camera, hcfg, [1], slice(r, r + BAND_ROWS))[1]
             for r in range(0, cfg.height, BAND_ROWS)]
    share = sum(live_of(counter.flops, c, flops) for c in bands) / (counter.flops * len(bands))
    pixels = cfg.height * cfg.width
    nbytes = 4 * (2 * lay.size + 2 + pixels * 3)
    out = bound(dense * share, nbytes)
    out["live_share"] = share
    out["dense"] = bound(dense, nbytes)
    return out


def inverse_step_cells(device) -> dict:
    """Phase 8 at bench.py's inverse_step_tiger shape (TRAIN, 1 view, a
    zero target, one frame) on INVERSE_STEP_SCENES: K4 under the frozen
    hints bitwise across two launches and under the contract against the
    unhinted launch, the tiger's also against its plain version in
    BAND_ROWS-row bands (timed once); the hinted launch (the scene's own
    instance), the unhinted one and the hinted one on the scene listed in
    another order (``reordered``: the generic composite fold) timed in
    turns; the tiger's bound. Returns the cells by scene."""
    cfg = RenderConfig(**TRAIN)
    camera = camera_for(("yxz",), device)
    words = megakernel.seed_tensor([1], device)
    target = torch.zeros((cfg.height, cfg.width, 3), device=device)
    cells = {}
    for name in INVERSE_STEP_SCENES:
        scene = library.SCENES[name](device)
        packed, lay = params.pack(scene, camera), params.layout(scene, camera)
        hcfg, keep, frozen = frozen_setup(scene, camera, cfg)
        label = f"{name} 1280x720x8spp x4 F=1"
        hinted = gradkernel.launch_loss_grad(packed, lay, hcfg, words, target, keep=keep)
        again = gradkernel.launch_loss_grad(packed, lay, hcfg, words, target, keep=keep)
        assert all(torch.equal(a, b) for a, b in zip(hinted, again)), f"K4 {label}: launches differ"
        check_contract(f"K4 {label}", hinted,
                       gradkernel.launch_loss_grad(packed, lay, cfg, words, target), frozen)
        cell = {"P": lay.size}
        if name == "tiger":
            plain = []
            cell["plain_ms"] = cuda_ms(lambda: plain.append(gradkernel.loss_and_grad_plain(
                packed, scene, camera, hcfg, [1], target, band_rows=BAND_ROWS)),
                calls=1, repeats=1)[0]
            cell["max_abs_err"], cell["grad_mixed_rel"] = compare_grad(
                f"{label} frozen hints (plain in {BAND_ROWS}-row bands)", hinted, plain[0],
                COMPOSITE_PATTERN_FLOOR)
        other = reordered(name, scene)
        o_cfg, o_keep, _ = frozen_setup(other, camera, cfg)
        assert o_cfg.axis_hints != hcfg.axis_hints
        runs = (("ms", packed, hcfg, keep), ("unhinted_ms", packed, cfg, None),
                ("generic_ms", params.pack(other, camera), o_cfg, o_keep))
        for key, vec, c, k in runs:
            cell[key + "_all"] = cuda_ms(
                lambda vec=vec, c=c, k=k: gradkernel.launch_loss_grad(vec, lay, c, words, target,
                                                                      keep=k),
                calls=TRAIN_CALLS, repeats=TRAIN_REPEATS)
            cell[key] = statistics.median(cell[key + "_all"])
        # K4's pass 1 alone: K8's vjp mode on the same inputs (hinted).
        cell["pass1_ms"] = statistics.median(cuda_ms(
            lambda: ablate.launch_variant("vjp", packed, lay, hcfg, 1, target),
            calls=TRAIN_CALLS, repeats=TRAIN_REPEATS))
        if name == "tiger":
            cell.update(k4_bound(scene, camera, cfg, packed, lay))
        rays = cfg.width * cfg.height * cfg.samples
        cell["grad_mrays_per_s"] = rays / cell["ms"] / 1e3
        cells[name] = cell
        print(json.dumps({"cell": f"inverse_step {label}, zero target, the frozen hints",
                          **cell}), flush=True)
    return cells


def check_composite_k5(device):
    """Phase 11 on COMPOSITE_GRAD at GRAD_CHECK: K5 (one row, 1 and 3
    views; two rows, the scene and its moved_floor copy, 1 view) unhinted
    against its plain version, bitwise across launches, a row of the
    two-row launch bitwise its single launch; under the frozen hints the
    contract against the unhinted launch and the frozen plain version.
    Returns (max abs error, max mixed-scale relative error)."""
    cfg = RenderConfig(**GRAD_CHECK)
    seed = 0x2468ACE1
    errs = []
    for name in COMPOSITE_GRAD:
        scene = composite_scene(name, device)
        for views in (("yxz",), cam.VIEWS_ALL):
            camera = camera_for(views, device)
            lay = params.layout(scene, camera)
            rng = np.random.default_rng(2)
            shape = (*image_shape(views, cfg), 3)
            cases = [("", params.pack(scene, camera), rng.normal(0, 1, shape))]
            if len(views) == 1:
                cases.append((" two rows", params.stack_rows((scene, moved_floor(scene)), camera),
                              rng.normal(0, 1, (2, *shape))))
            hcfg, keep, frozen = frozen_setup(scene, camera, cfg)
            for tag, vec, cot in cases:
                label = f"K5 {name} views={len(views)}{tag}"
                cot = torch.from_numpy(cot.astype(np.float32)).to(device)
                grad = gradkernel.launch_light_vjp(vec, lay, cfg, seed, cot)
                assert torch.equal(grad, gradkernel.launch_light_vjp(vec, lay, cfg, seed, cot)), \
                    f"{label}: launches differ"
                plain = gradkernel.render_light_vjp_plain(vec, scene, camera, cfg, seed, cot)
                errs.append(compare_vec(label, grad, plain, floor=COMPOSITE_PATTERN_FLOOR))
                if vec.dim() == 2:
                    for f in range(vec.shape[0]):
                        single = gradkernel.launch_light_vjp(vec[f].contiguous(), lay, cfg, seed,
                                                             cot[f].contiguous())
                        assert torch.equal(grad[f], single), f"{label}: row {f} != its launch"
                hinted = gradkernel.launch_light_vjp(vec, lay, hcfg, seed, cot, keep=keep)
                assert torch.equal(hinted, gradkernel.launch_light_vjp(vec, lay, hcfg, seed, cot,
                                                                       keep=keep)), \
                    f"{label} frozen hints: launches differ"
                check_contract(label, hinted, grad, frozen)
                errs.append(compare_vec(f"{label} frozen hints", hinted,
                                        gradkernel.freeze(plain, scene, hcfg),
                                        floor=COMPOSITE_PATTERN_FLOOR))
    return max(e for e, _ in errs), max(r for _, r in errs)


def check_composite_k8(device) -> dict:
    """Phase 17 on COMPOSITE_GRAD at GRAD_CHECK, 1 and 3 views: each K8
    mode unhinted against its plain version (acc within ACC_RTOL, loss and
    vjp within the loss bound), and under the frozen hints bitwise the
    unhinted launch. Returns the largest absolute and relative errors by
    mode."""
    cfg = RenderConfig(**GRAD_CHECK)
    seed = 0x2468ACE1
    errs = {m: [0.0, 0.0] for m in ablate.MODES}
    for name in COMPOSITE_GRAD:
        scene = composite_scene(name, device)
        for views in (("yxz",), cam.VIEWS_ALL):
            label = f"K8 {name} views={len(views)}"
            camera = camera_for(views, device)
            packed, lay = params.pack(scene, camera), params.layout(scene, camera)
            target = torch.from_numpy(np.random.default_rng(6).uniform(
                0, 1, (*image_shape(views, cfg), 3)).astype(np.float32)).to(device)
            hcfg, _, _ = frozen_setup(scene, camera, cfg)
            plain = {}
            for mode in ablate.MODES:
                k = ablate.launch_variant(mode, packed, lay, cfg, seed, target)
                # vjp's plain value is loss's (its extra term is zero).
                if mode != "vjp":
                    plain[mode] = float(ablate.variant_plain(mode, scene, camera, cfg, seed,
                                                             target))
                p = plain["loss" if mode == "vjp" else mode]
                rel = abs(float(k) - p) / abs(p)
                print(f"{label} {mode}: kernel={float(k)} plain={p} rel={rel:.3g}", flush=True)
                assert rel <= (ACC_RTOL if mode == "acc" else GRAD_BOUNDS["loss_rtol"]), label
                errs[mode] = [max(errs[mode][0], abs(float(k) - p)), max(errs[mode][1], rel)]
                check_contract(f"{label} {mode}",
                               ablate.launch_variant(mode, packed, lay, hcfg, seed,
                                                     target).reshape(1), k.reshape(1),
                               torch.zeros(0, dtype=torch.bool, device=device))
    return errs


def tiger_row_shards(device) -> dict:
    """Phase 14 on the tiger: K4 at GRAD_CHECK, 1 view, under the frozen
    hints, cut into PLAIN_SPLIT row blocks: each block bitwise across two
    launches and within GRAD_BOUNDS of its plain version on the same rows
    (frozen), their sum (in rank order) within GRAD_BOUNDS of the single
    launch (the blocks' sums run in another order, so not bitwise).
    Returns the errors and each block's and the single launch's times."""
    cfg = RenderConfig(**GRAD_CHECK)
    scene, camera = library.tiger(device), camera_for(("yxz",), device)
    packed, lay = params.pack(scene, camera), params.layout(scene, camera)
    words = megakernel.seed_tensor([5, 6], device)
    target = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (cfg.height, cfg.width, 3)).astype(np.float32)).to(device)
    hcfg, keep, _ = frozen_setup(scene, camera, cfg)
    whole = gradkernel.launch_loss_grad(packed, lay, hcfg, words, target, keep=keep)
    out = {"block_err": 0.0, "ms": {"whole": cuda_ms(lambda: gradkernel.launch_loss_grad(
        packed, lay, hcfg, words, target, keep=keep))}}
    loss, grad = 0.0, 0.0
    for b in shard_blocks(cfg.height, PLAIN_SPLIT):
        block = rows_of(target, b).contiguous()
        part = gradkernel.launch_loss_grad(packed, lay, hcfg, words, block, rows=b, keep=keep)
        again = gradkernel.launch_loss_grad(packed, lay, hcfg, words, block, rows=b, keep=keep)
        assert all(torch.equal(x, y) for x, y in zip(part, again)), f"K4 tiger rows {b} differ"
        plain = gradkernel.loss_and_grad_plain(packed, scene, camera, hcfg, [5, 6], block,
                                               rows=b)
        err, _ = compare_grad(f"tiger rows {b} frozen hints", part, plain,
                              COMPOSITE_PATTERN_FLOOR)
        out["block_err"] = max(out["block_err"], err)
        out["ms"][str(b)] = cuda_ms(lambda b=b, block=block: gradkernel.launch_loss_grad(
            packed, lay, hcfg, words, block, rows=b, keep=keep))
        loss, grad = loss + part[0], grad + part[1]
    out["sum_err"], out["sum_rel"] = compare_grad(
        f"tiger {PLAIN_SPLIT} row blocks summed", (loss, grad), whole, COMPOSITE_PATTERN_FLOOR)
    return out


def tiger_soft_row_shards(device) -> dict:
    """Phase 14 on the tiger's soft step: K6 under the frozen hints, the
    tiger the object, at GRAD_CHECK (1 view) cut into PLAIN_SPLIT row
    blocks, each bitwise across two launches and within GRAD_BOUNDS of its
    plain version on the same rows; then at TRAIN in 2 and 4 row blocks,
    their sums (in rank order) within GRAD_BOUNDS of the single launch and
    their alpha cotangents bitwise its rows, every block timed. Returns
    the errors and the times."""
    ref = COMPOSITE_SOFT_REFS["tiger"]
    scene, camera = library.tiger(device), camera_for(("yxz",), device)
    out = {"block_err": 0.0, "sum_err": 0.0, "sum_rel": 0.0}
    for base, splits in ((RenderConfig(**GRAD_CHECK), (PLAIN_SPLIT,)),
                         (RenderConfig(**TRAIN), SHARDS)):
        target = torch.from_numpy(np.random.default_rng(3).uniform(
            0, 1, (base.height, base.width, 3)).astype(np.float32)).to(device)
        packed, lay, zero_map, alpha, target = soft_inputs(scene, camera, base, ref, SOFT_EDGE,
                                                           target)
        hcfg, keep, _ = frozen_setup(scene, camera, base)
        whole = gradkernel.launch_soft_loss_grad(packed, lay, hcfg, 5, target, alpha, zero_map,
                                                 keep=keep)
        shape = f"{base.width}x{base.height}"
        for n in splits:
            loss, grad = 0.0, 0.0
            for b in shard_blocks(base.height, n):
                t_block = rows_of(target, b)
                a_block = alpha[b[0]:b[0] + b[1]].contiguous()
                part = gradkernel.launch_soft_loss_grad(packed, lay, hcfg, 5, t_block, a_block,
                                                        zero_map, rows=b, keep=keep)
                again = gradkernel.launch_soft_loss_grad(packed, lay, hcfg, 5, t_block, a_block,
                                                         zero_map, rows=b, keep=keep)
                assert all(torch.equal(x, y) for x, y in zip(part, again)), \
                    f"K6 tiger {shape} rows {b} differ"
                assert torch.equal(part[2], whole[2][b[0]:b[0] + b[1]]), \
                    f"K6 tiger {shape} rows {b}: alpha cotangent"
                if base.width == GRAD_CHECK["width"]:
                    plain = gradkernel.render_soft_loss_and_grad_plain(
                        packed, scene, camera, hcfg, 5, t_block, a_block, zero_map, rows=b)
                    err, _ = compare_soft(f"tiger {shape} rows {b} frozen hints", part, plain,
                                          block=True, floor=COMPOSITE_PATTERN_FLOOR)
                    out["block_err"] = max(out["block_err"], err)
                else:
                    out.setdefault("ms", {})[f"{n} blocks {b}"] = statistics.median(cuda_ms(
                        lambda b=b, t_block=t_block, a_block=a_block:
                        gradkernel.launch_soft_loss_grad(packed, lay, hcfg, 5, t_block, a_block,
                                                         zero_map, rows=b, keep=keep),
                        calls=TRAIN_CALLS, repeats=TRAIN_REPEATS))
                loss, grad = loss + part[0], grad + part[1]
            err, rel = compare_grad(f"K6 tiger {shape} {n} row blocks summed", (loss, grad),
                                    whole[:2], COMPOSITE_PATTERN_FLOOR)
            out["sum_err"], out["sum_rel"] = max(out["sum_err"], err), max(out["sum_rel"], rel)
        if base.width == TRAIN["width"]:
            out.setdefault("ms", {})["whole"] = statistics.median(cuda_ms(
                lambda: gradkernel.launch_soft_loss_grad(packed, lay, hcfg, 5, target, alpha,
                                                         zero_map, keep=keep),
                calls=TRAIN_CALLS, repeats=TRAIN_REPEATS))
    print(json.dumps({"k6_tiger_row_shards": out}), flush=True)
    return out


def train_main_path(device, frames: int, frozen: bool = True,
                    name: str = "room_with_sphere", modes: dict | None = None) -> list:
    """Phase 9: the packed train step at TRAIN on scene ``name``, ``frames``
    frames per step, in the production configuration (the frozen static
    hints: one hinted K4 launch per step, the frozen slots of the packed
    vector bitwise constant), or unhinted (``frozen`` False); one warm-up
    step, then timed steps. ``modes`` (phase 8c): the sampler and fold off
    the production ones, under with_frozen_hints (a literal fold's carries
    no hints: its launches are unhinted, nothing frozen). Returns ms per
    step."""
    cfg = RenderConfig(**TRAIN, **(modes or {}))
    scene, camera = library.SCENES[name](device), camera_for(("yxz",), device)
    if frozen:
        cfg = diff.with_frozen_hints(cfg, scene)
    target = torch.zeros((cfg.height, cfg.width, 3), device=device)
    step, init, unpack = diff.make_packed_train_step(cfg, 1e-3, camera, scene,
                                                     frames_per_step=frames)
    model, opt = init(scene)
    vec0 = model.scene_vec.detach().clone()
    before = gradkernel.LAUNCHES, gradkernel.HINTED_LAUNCHES
    losses = []
    losses.append(step(model, opt, 1, target))  # warm-up
    ms = cuda_ms(lambda: losses.append(step(model, opt, len(losses) + 1, target)),
                 calls=TRAIN_CALLS, repeats=TRAIN_REPEATS)
    assert gradkernel.LAUNCHES - before[0] == len(losses), "one K4 launch per step"
    assert gradkernel.HINTED_LAUNCHES - before[1] == (len(losses) if megakernel.hinted(cfg)
                                                      else 0), \
        "the production step runs the hinted K4"
    losses = torch.stack(losses).cpu().numpy()
    assert np.isfinite(losses).all(), losses
    vec = model.scene_vec.detach()
    assert not torch.equal(vec, vec0), "the step did not move the scene"
    if megakernel.hinted(cfg):
        held = params.freeze_mask(cfg, scene).to(device) == 0
        assert torch.equal(vec[held], vec0[held]), "a frozen slot moved"
    assert np.isfinite(params.pack(unpack(model), camera).cpu().numpy()).all()
    rays = cfg.width * cfg.height * cfg.samples * frames
    med = statistics.median(ms)
    print(f"train step {name} F={frames} {'frozen hints' if frozen else 'unhinted'} "
          f"{megakernel.launch_config(cfg, params.layout(scene, camera))}: ms={ms} "
          f"median={med} grad_mrays_per_s={rays / med / 1e3} losses {losses[0]} -> "
          f"{losses[-1]}", flush=True)
    return ms


# Phase 10's runs of inverse_render --impl kernel: plain, the packed loop
# (which forces the frozen hints) and --freeze-hints; the hinted K4
# launches each makes (60 steps).
INVERSE_RUNS = (([], 0), (["--packed"], 60), (["--freeze-hints"], 60))


def run_inverse_render() -> None:
    """Phase 10: the entry point on the card, unhinted, with --packed (the
    frozen hints forced) and with --freeze-hints."""
    for extra, hinted in INVERSE_RUNS:
        before = gradkernel.LAUNCHES, gradkernel.HINTED_LAUNCHES
        rc = inverse_render.main(["--param", "glow", "--impl", "kernel", "--device", "cuda",
                                  *extra])
        assert rc == 0, f"inverse_render {extra}: glow not recovered"
        assert gradkernel.LAUNCHES - before[0] == 60, "one K4 launch per step"
        assert gradkernel.HINTED_LAUNCHES - before[1] == hinted, f"{extra}: hinted launches"


def run_app() -> None:
    """Phase 5: the batch app at the config's own settings and scene (the
    tiger); its PNGs go to out/chip_smoke_app/."""
    before = megakernel.LAUNCHES
    out = ROOT / "out" / "chip_smoke_app"
    rc = app.main(["--config", str(APP_CONFIG), "--frames", "8", "--out", str(out)])
    assert rc == 0
    for view in ("yxz", "ywz", "yxw"):
        assert (out / f"{view}.png").stat().st_size > 0, view
    assert (out / "layout.json").exists()
    assert megakernel.LAUNCHES == before + 2, "one 8-frame launch per view group"


# Phase 5b: the stdin script of the live session, in two parts: the second
# goes in once the preview thread has fetched its frame and posted
# LIVE_POST, so that the posted line runs before the save and the quit.
LIVE_HEAD = ("look 0.1 0 0", "capture", "w 0.25", "mouse 5 3", "mouse 9999 0", "wheel 1",
             "frames 16")
LIVE_TAIL = ("save {save}", "stats", "quit")
LIVE_POST = "frames 1"
LIVE_TIMEOUT_S = 120
# The resume checks: N frames, a checkpoint, M more frames (the engine);
# the packed train state at inverse_render's CKPT_EVERY steps, one more.
RESUME_FRAMES = (4, 4)
# 127.0.0.1 directly, whatever proxy the environment names.
LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))
# Phase 5b's fresh process, which a viewer's new session is: the seconds
# from its start (the interpreter's own start-up excluded) to the first
# frame of every view group on the host, split into the imports, the
# engine's build (the CUDA context, the native controls), precompile and
# the frame. The kernels and the controls are built on disk by then.
FIRST_FRAME = """
import json, sys, time
t0 = time.perf_counter()
import torch
from fourd_ray_tracing_tpu_torch import app
from fourd_ray_tracing_tpu_torch.utils.config import AppConfig
t_import = time.perf_counter()
engine = app.build_engine(AppConfig.load(sys.argv[1]), app.resolve_device("cuda"),
                          deterministic=True)
torch.cuda.synchronize()
t_engine = time.perf_counter()
precompile_s = engine.precompile()
t_precompile = time.perf_counter()
engine.step_frame()
frames = [g.accum.cpu() for g in engine.groups]
t_frame = time.perf_counter()
assert all(torch.isfinite(f).all() for f in frames)
print(json.dumps({"first_frame_s": t_frame - t0, "import_s": t_import - t0,
                  "engine_s": t_engine - t_import, "precompile_s": precompile_s,
                  "precompile_wall_s": t_precompile - t_engine,
                  "frame_s": t_frame - t_precompile, "controls": engine.controls}))
"""


class ScriptedStdin:
    """The live session's stdin: LIVE_HEAD, then LIVE_TAIL once ``ready``
    is set (or after LIVE_TIMEOUT_S, so that the session ends either way)."""

    def __init__(self, save: Path, ready: threading.Event):
        self.save, self.ready = save, ready

    def __iter__(self):
        for line in LIVE_HEAD:
            yield line + "\n"
        self.ready.wait(LIVE_TIMEOUT_S)
        for line in LIVE_TAIL:
            yield line.format(save=self.save) + "\n"


def png_size(data: bytes) -> tuple:
    """(width, height) of an 8-bit RGB PNG, after checking that its pixel
    data inflates to that size."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    w, h = struct.unpack(">II", data[16:24])
    pos, idat = 8, b""
    while pos < len(data):
        (n,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        if tag == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    assert len(zlib.decompress(idat)) == h * (1 + 3 * w), "PNG pixel data"
    return w, h


def preview_client(servers: list, result: dict, ready: threading.Event) -> None:
    """The second thread of phase 5b: once the session serves, fetch
    /frame.png?view=yxz and POST LIVE_POST to /cmd."""
    try:
        t0 = time.perf_counter()
        while not servers and time.perf_counter() - t0 < LIVE_TIMEOUT_S:
            time.sleep(0.01)
        url = servers[0].url
        result["url"] = url
        result["png_size"] = png_size(LOCAL.open(url + "frame.png?view=yxz", timeout=30).read())
        req = urllib.request.Request(url + "cmd", data=LIVE_POST.encode(), method="POST")
        result["post_status"] = LOCAL.open(req, timeout=30).status
    except Exception as exc:  # the session must end; the phase reports it
        result["error"] = repr(exc)
    finally:
        ready.set()


def live_session() -> dict:
    """Phase 5b: app.main --interactive --deterministic --serve 0
    --save-state on configs/properties.txt (the tiger, 121x75 + 2 x 60x37,
    100 spp, max_fps 60), fed LIVE_HEAD and LIVE_TAIL on stdin while a
    second thread reads the preview and posts LIVE_POST. Every K1 launch is
    precompile's (one per view group) or one per rendered frame per view
    group, all hinted; the controls are native; the windows and the state
    are written, and the state loads into a fresh engine."""
    out = ROOT / "out" / "chip_smoke_live"
    shutil.rmtree(out, ignore_errors=True)
    engines, servers, meters, precompile_s = [], [], [], []
    build_engine, make_preview, meter_cls = app.build_engine, app.make_preview, app.Meter

    def spy_build(*args, **kwargs):
        engine = build_engine(*args, **kwargs)
        warm = engine.precompile
        engine.precompile = lambda: precompile_s.append(warm()) or precompile_s[-1]
        engines.append(engine)
        return engine

    def spy_preview(*args, **kwargs):
        servers.append(make_preview(*args, **kwargs))
        return servers[-1]

    def spy_meter():
        meters.append(meter_cls())
        return meters[-1]

    ready, client = threading.Event(), {}
    thread = threading.Thread(target=preview_client, args=(servers, client, ready), daemon=True)
    log, stdin = io.StringIO(), sys.stdin
    app.build_engine, app.make_preview, app.Meter = spy_build, spy_preview, spy_meter
    sys.stdin = ScriptedStdin(out / "windows", ready)
    thread.start()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log):
            rc = app.main(["--config", str(APP_CONFIG), "--interactive", "--deterministic",
                           "--serve", "0", "--out", str(out), "--save-state", str(out / "state")])
    finally:
        session_s = time.perf_counter() - t0
        app.build_engine, app.make_preview, app.Meter = build_engine, make_preview, meter_cls
        sys.stdin = stdin
        thread.join(timeout=LIVE_TIMEOUT_S)
        print(log.getvalue(), end="", flush=True)
    assert rc == 0 and not thread.is_alive(), "the live session did not end"
    assert "error" not in client, client
    (engine,), (meter,) = engines, meters
    lines = log.getvalue().splitlines()
    assert "look ignored: cursor not captured (use 'capture')" in lines, "look before capture"
    assert "cursor recentered" in lines, "mouse 9999 0 must only recenter"
    assert engine.controls == "native", "the native controls did not build"
    main_group = engine.groups[0].cfg
    assert client["png_size"] == (main_group.width, main_group.height), client
    assert client["post_status"] == 204, client
    frames = meter.stats.frames
    groups = len(engine.groups)
    assert frames >= 1 + 1 + 1 + 16 + 1, f"{frames} frames rendered"
    assert megakernel.LAUNCHES == groups * (1 + frames), (megakernel.LAUNCHES, groups, frames)
    assert megakernel.HINTED_LAUNCHES == megakernel.LAUNCHES, "a live launch ran no hints"
    assert counts()["k4"] == counts()["k5"] == counts()["k6"] == 0, counts()
    for view in ("yxz", "ywz", "yxw"):
        assert (out / "windows" / f"{view}.png").stat().st_size > 0, view
    resumed = app.build_engine(AppConfig.load(APP_CONFIG), engine.device, deterministic=True)
    resumed.load_checkpoint(out / "state")
    assert (resumed.seed, resumed.frame_number, resumed._rng_draws) == \
        (engine.seed, engine.frame_number, engine._rng_draws), "--save-state"
    for g_r, g_e in zip(resumed.groups, engine.groups):
        assert g_r.accum.device == g_e.accum.device and torch.equal(g_r.accum, g_e.accum)
    return {"precompile_warm_s": precompile_s[0], "frames": frames, "session_s": session_s,
            "session_fps": frames / session_s, "render_fps": meter.stats.fps,
            "k1_launches": megakernel.LAUNCHES, "groups": groups,
            "window": [main_group.width, main_group.height], "preview": client}


def first_frame_fresh() -> dict:
    """Phase 5b: FIRST_FRAME in a fresh process on the config."""
    proc = subprocess.run([sys.executable, "-c", FIRST_FRAME, str(APP_CONFIG)], cwd=ROOT,
                          capture_output=True, text=True, timeout=LIVE_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["controls"] == "native", out
    return out


def engine_resume(device) -> dict:
    """Phase 5b: an engine on the room at the headline shape renders N
    frames and checkpoints; a fresh engine loads the checkpoint onto the
    card and renders M more: bitwise an uninterrupted N + M."""
    n, m = RESUME_FRAMES
    path = ROOT / "out" / "chip_smoke_resume"

    def make():
        return RenderEngine(library.room_with_sphere(device), RenderConfig(**HEADLINE),
                            Vec4.of(0.0, -2.0, 0.0, 0.0, device=device),
                            cam.CameraAngles.of(0.0, 0.0, 0.0, device=device), device=device,
                            deterministic=True)

    straight, first = make(), make()
    for engine in (straight, first):
        assert engine.mouse_moved(5, 3)
        engine.step_frames(n)
    first.save_checkpoint(path)
    resumed = make()
    resumed.load_checkpoint(path)
    assert resumed.accum.device == straight.accum.device and torch.equal(resumed.accum, first.accum)
    for engine in (straight, resumed):
        engine.step_frames(m)
    assert (resumed.seed, resumed.frame_number) == (straight.seed, straight.frame_number)
    assert torch.equal(resumed.accum, straight.accum), "the resumed engine is not bitwise"
    return {"frames": [n, m], "bitwise": True, "controls": resumed.controls}


def train_resume(device) -> dict:
    """Phase 5b: inverse_render --packed --ckpt at the headline shape
    writes its train state at step CKPT_EVERY; restored into a fresh loop,
    one more K4 step is bitwise the uninterrupted loop's step CKPT_EVERY +
    1 (loss, vector, Adam's moments and step count)."""
    path = ROOT / "out" / "chip_smoke_train_ckpt"
    shutil.rmtree(path, ignore_errors=True)
    k = inverse_render.CKPT_EVERY
    # --tol: CKPT_EVERY steps do not reach the glow; the check is the resume.
    argv = ["--param", "glow", "--impl", "kernel", "--packed", "--device", "cuda",
            "--width", str(HEADLINE["width"]), "--height", str(HEADLINE["height"]),
            "--samples", str(HEADLINE["samples"]), "--bounces", str(HEADLINE["reflections_amount"]),
            "--steps", str(k), "--tol", "100", "--ckpt", str(path)]
    assert inverse_render.main(argv) == 0
    args = inverse_render.parse_args(argv)
    cfg, camera, target, scene0 = inverse_render.setup(args, device)
    step, init, _ = inverse_render.packed_train_step(args, cfg, camera, scene0)
    assert cfg.freeze_hints, "--packed trains under the frozen hints"
    model, opt = init(scene0)
    first = step(model, opt, args.seed, target)
    for _ in range(k - 1):
        step(model, opt, args.seed, target)
    at_k = model.scene_vec.detach().clone()
    loss = step(model, opt, args.seed, target)
    fresh, fresh_opt = init(scene0)
    vec, opt_state, saved_step = checkpoint.restore_train_state(path, fresh.scene_vec,
                                                                fresh_opt.state_dict())
    assert saved_step == k and torch.equal(vec, at_k), "the saved train state"
    with torch.no_grad():
        fresh.scene_vec.copy_(vec)
    fresh_opt.load_state_dict(opt_state)
    assert torch.equal(step(fresh, fresh_opt, args.seed, target), loss), "resumed loss"
    assert torch.equal(fresh.scene_vec, model.scene_vec), "resumed vector"
    ours, ref = fresh_opt.state_dict()["state"][0], opt.state_dict()["state"][0]
    for key in ("step", "exp_avg", "exp_avg_sq"):
        assert torch.equal(ours[key], ref[key]), key
    return {"steps": k, "bitwise": True, "loss": float(loss), "argv": argv,
            "first_loss": first}


def check_train_resume_kernels(device, argv: list, first_loss: torch.Tensor) -> dict:
    """Phase 5b, after its counts are read: train_resume's inverse_render
    run (``argv``) at its shape, the target's K1 launch against the plain
    pipeline (BAND_ROWS-row bands), its light bitwise the target the run
    trained on, and the first step's K4 launch (its loss bitwise the
    run's ``first_loss``) against the plain version in BAND_ROWS-row bands
    under the frozen hints. Returns the errors."""
    args = inverse_render.parse_args(argv)
    cfg, camera, target, scene0 = inverse_render.setup(args, device)
    t = inverse_render.task(args.param)
    truth = t.scene(t.true, device)
    label = f"train_resume {cfg.width}x{cfg.height}x{cfg.samples}spp x{cfg.reflections_amount}"
    # The target's configuration: setup's before diff.with_frozen_hints.
    light_cfg = unhinted(replace(cfg, freeze_hints=False, grad_sample_chunk=1))
    light = megakernel.render_light_cuda(truth, camera, light_cfg, args.seed)
    assert torch.equal(light_to_color(light, light_cfg.light_coefficient), target), \
        f"{label}: the checked K1 launch is not the target's"
    plain_light = torch.cat([renderer.render_light(truth, camera, light_cfg, args.seed,
                                                   slice(r, r + BAND_ROWS))
                             for r in range(0, cfg.height, BAND_ROWS)], dim=-3)
    light_err = check_close(f"{label} target K1 vs plain ({BAND_ROWS}-row bands)", light,
                            plain_light)
    packed = params.pack(scene0, camera)
    kernel = gradkernel.loss_and_grad_cuda(packed, scene0, camera, cfg, args.seed, target)
    assert torch.equal(kernel[0], first_loss), f"{label}: the checked K4 launch is not step 1's"
    plain = gradkernel.loss_and_grad_plain(packed, scene0, camera, light_cfg, args.seed, target,
                                           band_rows=BAND_ROWS)
    err, rel = compare_grad(f"{label} step 1 frozen hints (plain in {BAND_ROWS}-row bands, "
                            "frozen)", kernel,
                            (plain[0], gradkernel.freeze(plain[1], scene0, cfg)))
    return {"k1_max_abs_err": light_err, "k4_max_abs_err": err, "k4_grad_mixed_rel": rel}


def reset_counts() -> None:
    for configs in (megakernel.CONFIG_LAUNCHES, gradkernel.CONFIG_LAUNCHES,
                    gradkernel.CONFIG_VJP_LAUNCHES, gradkernel.CONFIG_SOFT_LAUNCHES,
                    ablate.CONFIG_LAUNCHES):
        configs.clear()
    megakernel.LAUNCHES = megakernel.ROW_LAUNCHES = megakernel.SHARD_LAUNCHES = 0
    megakernel.HINTED_LAUNCHES = 0
    megakernel.VARIANT_LAUNCHES = k7.LAUNCHES = ablate.LAUNCHES = ablate.HINTED_LAUNCHES = 0
    gradkernel.LAUNCHES = gradkernel.VJP_LAUNCHES = gradkernel.SOFT_LAUNCHES = 0
    gradkernel.SHARD_LAUNCHES = gradkernel.SHARD_VJP_LAUNCHES = gradkernel.SHARD_SOFT_LAUNCHES = 0
    gradkernel.HINTED_LAUNCHES = gradkernel.HINTED_VJP_LAUNCHES = 0
    gradkernel.HINTED_SOFT_LAUNCHES = 0


def counts() -> dict:
    """Launches since the last reset_counts, per kernel (K2 = the forward
    kernel's launches over params rows, counted among K1's too), and those
    of the gradient kernels under the freeze_hints contract (``*_hinted``,
    counted among theirs too)."""
    return {"k1": megakernel.LAUNCHES, "k2_rows": megakernel.ROW_LAUNCHES,
            "k4": gradkernel.LAUNCHES, "k5": gradkernel.VJP_LAUNCHES,
            "k6": gradkernel.SOFT_LAUNCHES, "k4_hinted": gradkernel.HINTED_LAUNCHES,
            "k5_hinted": gradkernel.HINTED_VJP_LAUNCHES,
            "k6_hinted": gradkernel.HINTED_SOFT_LAUNCHES}


def image_shape(views, cfg) -> tuple:
    return (cfg.height, cfg.width) if len(views) == 1 else (len(views), cfg.height, cfg.width)


def compare_vec(label: str, kernel, plain, same_pattern: bool = True, nonzero: bool = True,
                floor: float = 0.0):
    """Hold a gradient kernel's output array against its plain version's
    within GRAD_BOUNDS' mixed-scale relative error and, if
    ``same_pattern``, with the same non-zero pattern on the entries above
    ``floor`` of the largest; unless ``nonzero`` is False, the plain
    version must not be all zeros (a block of rows the object does not
    reach may be). Prints the comparison and returns (max |kernel -
    plain|, mixed-scale relative error)."""
    k, p = kernel.detach().cpu().numpy(), plain.detach().cpu().numpy()
    assert k.shape == p.shape, f"{label}: {k.shape} vs {p.shape}"
    assert np.isfinite(k).all() and np.isfinite(p).all(), f"{label}: non-finite values"
    assert not nonzero or np.abs(p).max() > 0, f"{label}: the plain version is all zeros"
    rel, err = mixed_rel(k, p), float(np.abs(k - p).max())
    big = np.maximum(np.abs(k), np.abs(p)) > floor * np.abs(p).max()
    mismatch = int(((k != 0) != (p != 0))[big].sum())
    print(f"{label} size={k.size} mixed_rel={rel:.3g} max_abs_err={err:.3g} "
          f"nonzero={int((k != 0).sum())}/{int((p != 0).sum())} pattern_mismatches={mismatch}",
          flush=True)
    assert rel <= GRAD_BOUNDS["grad_mixed_rel"], f"{label}: error {rel}"
    assert not same_pattern or mismatch == 0, f"{label}: non-zero patterns differ"
    return err, rel


def compare_soft(label: str, kernel, plain, block: bool = False, floor: float = 0.0):
    """Hold K6's (loss, grad, alpha cotangent) against the plain version's
    within GRAD_BOUNDS. The alpha cotangent's pattern is not required to
    match: it is sum_ch 2 (img - t)(c_with - c_without), which the plain
    version's autograd takes as a difference of two channel sums, so a
    pixel whose two rows differ by an ulp may round to 0 on one side only;
    the mixed-scale bound still holds every pixel. A ``block`` of rows may
    have an alpha cotangent of zeros; the gradient's pattern is compared
    above ``floor`` of its largest slot (COMPOSITE_PATTERN_FLOOR with
    composites). Returns (max abs error, max mixed-scale relative error)."""
    k_l, p_l = float(kernel[0]), float(plain[0])
    assert np.isfinite(k_l), f"{label}: non-finite loss"
    loss_rel = abs(k_l - p_l) / abs(p_l)
    print(f"K6 {label} loss={k_l} plain={p_l} loss_rel={loss_rel:.3g}", flush=True)
    assert loss_rel <= GRAD_BOUNDS["loss_rtol"], f"{label}: loss"
    e_g, r_g = compare_vec(f"K6 {label} grad", kernel[1], plain[1], floor=floor)
    e_a, r_a = compare_vec(f"K6 {label} alpha_cot", kernel[2], plain[2], same_pattern=False,
                           nonzero=not block)
    return max(abs(k_l - p_l), e_g, e_a), max(r_g, r_a)


def check_light_vjp(device):
    """Phase 11 at 256x144: K5 against its plain version, single and two
    rows, and K2. Returns (max abs error, max mixed-scale relative error)."""
    cfg = RenderConfig(**GRAD_CHECK)
    seed = 0x2468ACE1
    errs = []
    for name in GRAD_SCENES:
        scene = library.SCENES[name](device)
        pair = (scene, diff.zero_object(scene, SOFT_REFS[name]))
        for views in (("yxz",), cam.VIEWS_ALL):
            label = f"{name} views={len(views)}"
            camera = camera_for(views, device)
            packed, lay = params.pack(scene, camera), params.layout(scene, camera)
            rng = np.random.default_rng(2)
            shape = (*image_shape(views, cfg), 3)
            cot = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(device)
            grad = gradkernel.launch_light_vjp(packed, lay, cfg, seed, cot)
            again = gradkernel.launch_light_vjp(packed, lay, cfg, seed, cot)
            plain = gradkernel.render_light_vjp_plain(packed, scene, camera, cfg, seed, cot)
            torch.cuda.synchronize()
            assert torch.equal(grad, again), f"K5 {label}: launches differ"
            errs.append(compare_vec(f"K5 {label}", grad, plain))
            # K2: the pair's params rows in one launch, row f bitwise K1 of scene f.
            light = megakernel.render_light_cuda_multi(pair, camera, cfg, seed)
            for f, s in enumerate(pair):
                single = megakernel.render_light_cuda(s, camera, cfg, seed)
                assert torch.equal(light[f], single), f"K2 {label}: row {f} != its K1 render"
            rows = params.stack_rows(pair, camera)
            cots = torch.from_numpy(rng.normal(0, 1, (2, *shape)).astype(np.float32)).to(device)
            multi = gradkernel.launch_light_vjp(rows, lay, cfg, seed, cots)
            plain = gradkernel.render_light_vjp_plain(rows, scene, camera, cfg, seed, cots)
            for f in range(len(pair)):
                single = gradkernel.launch_light_vjp(rows[f].contiguous(), lay, cfg, seed,
                                                     cots[f].contiguous())
                assert torch.equal(multi[f], single), f"K5 {label}: row {f} != its single launch"
                errs.append(compare_vec(f"K5 {label} row {f} of 2", multi[f], plain[f]))
            print(f"K2 {label}: rows bitwise single K1 renders; K5 two-row launch bitwise "
                  "single launches", flush=True)
            # Under the freeze_hints contract, one row and both (each row
            # folds over its own table).
            hcfg, keep, frozen = frozen_setup(scene, camera, cfg)
            for tag, vec, c, ref_grad, ref_plain in (
                    ("", packed, cot, grad, gradkernel.render_light_vjp_plain(
                        packed, scene, camera, cfg, seed, cot)),
                    (" two rows", rows, cots, multi, plain)):
                hinted = gradkernel.launch_light_vjp(vec, lay, hcfg, seed, c, keep=keep)
                assert torch.equal(hinted, gradkernel.launch_light_vjp(vec, lay, hcfg, seed, c,
                                                                       keep=keep)), \
                    f"K5 {label}{tag} frozen hints: launches differ"
                check_contract(f"K5 {label}{tag}", hinted, ref_grad, frozen)
                errs.append(compare_vec(f"K5 {label}{tag} frozen hints", hinted,
                                        gradkernel.freeze(ref_plain, scene, hcfg)))
    return max(e for e, _ in errs), max(r for _, r in errs)


def time_light_vjp(device):
    """Phase 11 at the soft fallback's shape (TRAIN): K5 and its plain
    version (whole) on a seeded random cotangent, held against each other
    and timed. Returns a dict of timings, errors and the plain version's
    peak memory."""
    cfg = RenderConfig(**TRAIN)
    scene, camera = library.room_with_sphere(device), camera_for(("yxz",), device)
    packed, lay = params.pack(scene, camera), params.layout(scene, camera)
    cot = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (cfg.height, cfg.width, 3)).astype(np.float32)).to(device)
    kernel = gradkernel.launch_light_vjp(packed, lay, cfg, 1, cot)  # and warm-up
    assert torch.equal(kernel, gradkernel.launch_light_vjp(packed, lay, cfg, 1, cot)), \
        "K5 1280x720: two launches differ"
    plain = []
    ms, peak = peak_gb(lambda: cuda_ms(lambda: plain.append(gradkernel.render_light_vjp_plain(
        packed, scene, camera, cfg, 1, cot)), calls=1, repeats=1))
    err, rel = compare_vec("K5 room 1280x720x8spp x4 (plain whole)", kernel, plain[0])
    hcfg, keep, frozen = frozen_setup(scene, camera, cfg)
    hinted = gradkernel.launch_light_vjp(packed, lay, hcfg, 1, cot, keep=keep)
    check_contract("K5 room 1280x720x8spp x4", hinted, kernel, frozen)
    e, r = compare_vec("K5 room 1280x720x8spp x4 frozen hints (plain whole, frozen)", hinted,
                       gradkernel.freeze(plain[0], scene, hcfg))
    # The production (hinted) launch and the unhinted one, in turns.
    k5_hinted_ms = cuda_ms(lambda: gradkernel.launch_light_vjp(packed, lay, hcfg, 1, cot,
                                                               keep=keep),
                           calls=TRAIN_CALLS, repeats=TRAIN_REPEATS)
    k5_ms = cuda_ms(lambda: gradkernel.launch_light_vjp(packed, lay, cfg, 1, cot),
                    calls=TRAIN_CALLS, repeats=TRAIN_REPEATS)
    print(f"K5 1280x720: frozen hints ms={k5_hinted_ms} unhinted ms={k5_ms} plain_ms={ms[0]} "
          f"plain_peak_gb={peak:.3f}", flush=True)
    return {"ms": k5_hinted_ms, "unhinted_ms": k5_ms, "plain_ms": ms[0], "plain_peak_gb": peak,
            "err": max(err, e), "rel": max(rel, r)}


def soft_inputs(scene, camera, cfg, ref, edge, target):
    """(packed, layout, zero map, coverage alpha, target) of a K6 launch."""
    alpha = diff.object_coverage(scene, ref, camera, cfg, edge).detach().contiguous()
    return (params.pack(scene, camera), params.layout(scene, camera),
            params.soft_zero_map(scene, camera, ref), alpha, target.contiguous())


def check_soft_kernel(device):
    """Phase 12 at 256x144: K6 against its plain version, and the zeroed
    row's light against the drop_object light. Returns (max abs error, max
    mixed-scale relative error)."""
    cfg = RenderConfig(**GRAD_CHECK)
    seed = 0x13579BDF
    errs = []
    for name, ref in SOFT_REFS.items():
        scene = library.SCENES[name](device)
        for views in (("yxz",), cam.VIEWS_ALL):
            label = f"{name} {ref} views={len(views)}"
            camera = camera_for(views, device)
            target = torch.from_numpy(np.random.default_rng(3).uniform(
                0, 1, (*image_shape(views, cfg), 3)).astype(np.float32)).to(device)
            packed, lay, zero_map, alpha, target = soft_inputs(scene, camera, cfg, ref,
                                                               SOFT_EDGE, target)
            out = gradkernel.launch_soft_loss_grad(packed, lay, cfg, seed, target, alpha, zero_map)
            again = gradkernel.launch_soft_loss_grad(packed, lay, cfg, seed, target, alpha,
                                                     zero_map)
            plain = gradkernel.render_soft_loss_and_grad_plain(packed, scene, camera, cfg, seed,
                                                               target, alpha, zero_map)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(out, again)), f"K6 {label}: launches differ"
            errs.append(compare_soft(label, out, plain))
            # Under the freeze_hints contract (row b's table built from row
            # b's params): the loss and alpha's cotangent bitwise the
            # unhinted launch's, the kept slots bitwise, the frozen ones 0.
            hcfg, keep, frozen = frozen_setup(scene, camera, cfg)
            hinted = gradkernel.launch_soft_loss_grad(packed, lay, hcfg, seed, target, alpha,
                                                      zero_map, keep=keep)
            assert all(torch.equal(a, b) for a, b in zip(hinted, gradkernel.launch_soft_loss_grad(
                packed, lay, hcfg, seed, target, alpha, zero_map, keep=keep))), \
                f"K6 {label} frozen hints: launches differ"
            check_contract(f"K6 {label}", hinted, out, frozen)
            errs.append(compare_soft(f"{label} frozen hints", hinted,
                                     (plain[0], gradkernel.freeze(plain[1], scene, hcfg),
                                      plain[2])))
            zeroed = megakernel.render_light_cuda(diff.zero_object(scene, ref), camera, cfg, seed)
            dropped = megakernel.render_light_cuda(diff.drop_object(scene, ref), camera, cfg, seed)
            assert torch.equal(zeroed, dropped), f"{label}: zeroed light != drop_object light"
            if views == cam.VIEWS_ALL:
                continue
            # A zero map that also rewrites wall 0's color, which row b's
            # lanes do reach: they must drop their cotangents of it.
            wall = lay.spaces + 10
            wider = [*zero_map, *((wall + k, 0.25) for k in range(3))]
            out = gradkernel.launch_soft_loss_grad(packed, lay, cfg, seed, target, alpha, wider)
            errs.append(compare_soft(f"{label} + wall 0 color in the zero map", out,
                                     gradkernel.render_soft_loss_and_grad_plain(
                                         packed, scene, camera, cfg, seed, target, alpha, wider)))
    print("zero_object light bitwise drop_object light on every K6 check", flush=True)
    return max(e for e, _ in errs), max(r for _, r in errs)


def check_zero_rows(label: str, scene, ref, camera, cfg: RenderConfig, seed) -> None:
    """The soft kernel's row b is a guaranteed miss of the object: K1 of
    the zero_object scene bitwise K1 of the drop_object scene (rendered
    under hints_for_dropped), and K2 over the scene and its zero_object
    copy in one launch row by row bitwise those single renders."""
    zeroed = diff.zero_object(scene, ref)
    light = megakernel.render_light_cuda(zeroed, camera, cfg, seed)
    dropped = megakernel.render_light_cuda(diff.drop_object(scene, ref), camera,
                                           diff.hints_for_dropped(cfg, ref), seed)
    assert torch.equal(light, dropped), f"{label}: zeroed light != drop_object light"
    rows = megakernel.render_light_cuda_multi((scene, zeroed), camera, cfg, seed)
    assert torch.equal(rows[1], light) and torch.equal(
        rows[0], megakernel.render_light_cuda(scene, camera, cfg, seed)), \
        f"{label}: K2's rows differ from the single renders"


def check_composite_k6(device):
    """Phase 12 on COMPOSITE_GRAD at GRAD_CHECK, 1 and 3 views, each
    scene's composite the soft object (COMPOSITE_SOFT_REFS; row b zeroes it
    by its radii and is swept whole): K6 unhinted (the composite
    descriptor without hints) against its plain version, bitwise across
    two launches; under the frozen hints (each library scene's own
    instance) the contract against the unhinted launch, bitwise across
    launches, within GRAD_BOUNDS of the plain version with the slots
    frozen; the zeroed row's light bitwise the drop_object light, unhinted
    and hinted, and K2's rows bitwise the single renders. Returns (max abs
    error, max mixed-scale relative error)."""
    cfg = RenderConfig(**GRAD_CHECK)
    seed = 0x13579BDF
    errs = []
    for name, ref in COMPOSITE_SOFT_REFS.items():
        scene = composite_scene(name, device)
        for views in (("yxz",), cam.VIEWS_ALL):
            label = f"{name} {ref} views={len(views)}"
            camera = camera_for(views, device)
            target = torch.from_numpy(np.random.default_rng(3).uniform(
                0, 1, (*image_shape(views, cfg), 3)).astype(np.float32)).to(device)
            packed, lay, zero_map, alpha, target = soft_inputs(scene, camera, cfg, ref,
                                                               SOFT_EDGE, target)
            out = gradkernel.launch_soft_loss_grad(packed, lay, cfg, seed, target, alpha, zero_map)
            again = gradkernel.launch_soft_loss_grad(packed, lay, cfg, seed, target, alpha,
                                                     zero_map)
            assert all(torch.equal(a, b) for a, b in zip(out, again)), f"K6 {label}: launches differ"
            plain = gradkernel.render_soft_loss_and_grad_plain(packed, scene, camera, cfg, seed,
                                                               target, alpha, zero_map)
            errs.append(compare_soft(label, out, plain, floor=COMPOSITE_PATTERN_FLOOR))
            hcfg, keep, frozen = frozen_setup(scene, camera, cfg)
            hinted = gradkernel.launch_soft_loss_grad(packed, lay, hcfg, seed, target, alpha,
                                                      zero_map, keep=keep)
            assert all(torch.equal(a, b) for a, b in zip(hinted, gradkernel.launch_soft_loss_grad(
                packed, lay, hcfg, seed, target, alpha, zero_map, keep=keep))), \
                f"K6 {label} frozen hints: launches differ"
            check_contract(f"K6 {label}", hinted, out, frozen)
            errs.append(compare_soft(f"{label} frozen hints", hinted,
                                     (plain[0], gradkernel.freeze(plain[1], scene, hcfg),
                                      plain[2]), floor=COMPOSITE_PATTERN_FLOOR))
            for c in (cfg, hcfg):
                check_zero_rows(f"{label} hints={c.axis_hints is not None}", scene, ref, camera,
                                c, seed)
    print("composites: zero_object light bitwise drop_object light, K2's rows bitwise K1, on "
          "every K6 check", flush=True)
    return max(e for e, _ in errs), max(r for _, r in errs)


def time_soft_kernel(device):
    """Phase 12 at the soft main path's shape (TRAIN, the room's sphere 0,
    a zero target): K6 and its plain version in row bands, held against
    each other and timed; then K6 at inverse_render --param position's
    shape against its plain version, with K1's target render. Returns a
    dict of timings, errors and the banded plain version's peak memory."""
    cfg = RenderConfig(**TRAIN)
    scene, camera = library.room_with_sphere(device), camera_for(("yxz",), device)
    ref = SOFT_REFS["room_with_sphere"]
    packed, lay, zero_map, alpha, target = soft_inputs(
        scene, camera, cfg, ref, SOFT_EDGE, torch.zeros((cfg.height, cfg.width, 3), device=device))
    kernel = gradkernel.launch_soft_loss_grad(packed, lay, cfg, 1, target, alpha, zero_map)
    again = gradkernel.launch_soft_loss_grad(packed, lay, cfg, 1, target, alpha, zero_map)
    assert all(torch.equal(a, b) for a, b in zip(kernel, again)), "K6 1280x720: launches differ"
    plain = []
    ms, peak = peak_gb(lambda: cuda_ms(lambda: plain.append(
        gradkernel.render_soft_loss_and_grad_plain(packed, scene, camera, cfg, 1, target, alpha,
                                                   zero_map, band_rows=BAND_ROWS)),
        calls=1, repeats=1))
    errs = [compare_soft(f"room 1280x720x8spp x4 (plain in {BAND_ROWS}-row bands)", kernel,
                         plain[0])]
    hcfg, keep, frozen = frozen_setup(scene, camera, cfg)
    hinted = gradkernel.launch_soft_loss_grad(packed, lay, hcfg, 1, target, alpha, zero_map,
                                              keep=keep)
    assert all(torch.equal(a, b) for a, b in zip(hinted, gradkernel.launch_soft_loss_grad(
        packed, lay, hcfg, 1, target, alpha, zero_map, keep=keep))), \
        "K6 1280x720 frozen hints: launches differ"
    check_contract("K6 room 1280x720x8spp x4", hinted, kernel, frozen)
    errs.append(compare_soft(f"room 1280x720x8spp x4 frozen hints (plain in {BAND_ROWS}-row "
                             "bands, frozen)", hinted,
                             (plain[0][0], gradkernel.freeze(plain[0][1], scene, hcfg),
                              plain[0][2])))
    # The production (hinted) launch and the unhinted one, in turns.
    k6_hinted_ms = cuda_ms(lambda: gradkernel.launch_soft_loss_grad(
        packed, lay, hcfg, 1, target, alpha, zero_map, keep=keep),
        calls=TRAIN_CALLS, repeats=TRAIN_REPEATS)
    k6_ms = cuda_ms(lambda: gradkernel.launch_soft_loss_grad(packed, lay, cfg, 1, target, alpha,
                                                             zero_map),
                    calls=TRAIN_CALLS, repeats=TRAIN_REPEATS)
    print(f"K6 1280x720: frozen hints ms={k6_hinted_ms} unhinted ms={k6_ms} "
          f"plain_banded_ms={ms[0]} plain_band_peak_gb={peak:.3f}", flush=True)
    # The pair K6 fused, at the same shape: K2 over the scene and its
    # zero_object row, and the two-row K5 (a seeded random cotangent).
    rows = params.stack_rows((scene, diff.zero_object(scene, ref)), camera)
    words = megakernel.seed_tensor([1, 1], device)
    cots = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (2, cfg.height, cfg.width, 3)).astype(np.float32)).to(device)
    pair_ms = {"k2": cuda_ms(lambda: megakernel.launch_forward(rows, lay, hcfg, words),
                             calls=TRAIN_CALLS, repeats=TRAIN_REPEATS),
               "k5_two_rows": cuda_ms(lambda: gradkernel.launch_light_vjp(rows, lay, hcfg, 1, cots,
                                                                          keep=keep),
                                      calls=TRAIN_CALLS, repeats=TRAIN_REPEATS)}
    pair_med = sum(statistics.median(v) for v in pair_ms.values())
    print(f"K6 {statistics.median(k6_hinted_ms)} ms against the pair it fused, K2 + two-row K5, "
          f"both with the frozen hints: {pair_med} ms ({pair_ms})", flush=True)
    args = inverse_render.parse_args(["--param", "position"])
    ir_cfg, ir_camera, ir_target, scene0 = inverse_render.setup(args, device)
    truth = inverse_render.make_scene(inverse_render.TRUE_X, inverse_render.TRUE_GLOW, device)
    label = f"inverse_render position {ir_cfg.width}x{ir_cfg.height}x{ir_cfg.samples}spp"
    light_err = check_close(f"{label} target", megakernel.render_light_cuda(
        truth, ir_camera, ir_cfg, args.seed), renderer.render_light(truth, ir_camera, ir_cfg,
                                                                     args.seed))
    ir_ref = ("spheres", inverse_render.SOFT_SPHERE)
    packed, _, zero_map, alpha, target = soft_inputs(scene0, ir_camera, ir_cfg, ir_ref,
                                                     inverse_render.EDGE_WIDTH, ir_target)
    errs.append(compare_soft(label, gradkernel.render_soft_loss_and_grad_cuda(
        packed, scene0, ir_camera, ir_cfg, args.seed, target, alpha, zero_map),
        gradkernel.render_soft_loss_and_grad_plain(packed, scene0, ir_camera, ir_cfg, args.seed,
                                                   target, alpha, zero_map)))
    return {"ms": k6_hinted_ms, "unhinted_ms": k6_ms, "plain_ms": ms[0],
            "plain_band_peak_gb": peak, "light_err": light_err,
            "err": max(e for e, _ in errs), "rel": max(r for _, r in errs),
            "pair_ms": pair_med, "pair_split_ms": pair_ms}


def k6_bound(scene, camera, cfg: RenderConfig, ref, packed, lay) -> dict:
    """K6's bound at ``cfg`` (one view) under the frozen hints, as k4_bound
    counts K4's: the hinted plain version's flops (both rows' forward and
    autograd backward) over BOUND_ROWS rows, scaled to the image, times the
    live share of the forward over the whole image, the mean of row a's
    (the scene) and row b's (its zero_object copy); the dense count and
    both shares beside it."""
    hcfg = diff.with_frozen_hints(cfg, scene)
    rows, scale = (0, BOUND_ROWS), cfg.height / BOUND_ROWS
    block = torch.zeros((BOUND_ROWS, cfg.width, 3), device=packed.device)
    alpha = diff.object_coverage(scene, ref, camera, cfg, SOFT_EDGE).detach()[:BOUND_ROWS]
    dense = count_flops(gradkernel.render_soft_loss_and_grad_plain, packed, scene, camera, hcfg,
                        1, block, alpha, params.soft_zero_map(scene, camera, ref),
                        rows=rows)[1] * scale
    shares = []
    for row in (scene, diff.zero_object(scene, ref)):
        with FlopCounter() as counter:
            _, _, flops = lane_calls(row, camera, hcfg, [1], slice(0, BAND_ROWS), counter)
        bands = [lane_calls(row, camera, hcfg, [1], slice(r, r + BAND_ROWS))[1]
                 for r in range(0, cfg.height, BAND_ROWS)]
        shares.append(sum(live_of(counter.flops, c, flops) for c in bands)
                      / (counter.flops * len(bands)))
    pixels = cfg.height * cfg.width
    nbytes = 4 * (2 * lay.size + 1 + pixels * 3 + 2 * pixels)
    share = sum(shares) / 2
    out = bound(dense * share, nbytes)
    out["live_share"] = share
    out["live_share_rows"] = shares
    out["dense"] = bound(dense, nbytes)
    return out


def vjp_plain_in_bands(packed, scene, camera, cfg: RenderConfig, seed, cot) -> torch.Tensor:
    """K5's plain version over the whole image, BAND_ROWS rows at a time:
    the sum of each band's gradient (the bands' rows are the image's)."""
    return sum(gradkernel.render_light_vjp_plain(packed, scene, camera, cfg, seed,
                                                 cot[r:r + BAND_ROWS].contiguous(),
                                                 rows=(r, BAND_ROWS))
               for r in range(0, cfg.height, BAND_ROWS))


def soft_composite_cells(device) -> tuple:
    """Phase 13b beside the composites' soft steps: K6 at TRAIN (1 view, a
    zero target, the coverage alpha) on SOFT_STEP_SCENES, each scene's
    composite the object, under the frozen hints bitwise across two
    launches, under the contract against the unhinted launch and within
    GRAD_BOUNDS of its plain version in BAND_ROWS-row bands (timed once);
    the hinted and the unhinted launch timed in turns; the tiger's bound.
    Then the hyperplane fallback's kernels on the tiger at TRAIN, as its
    step launches them: K5 (one row, a seeded random cotangent) on the
    tiger under the frozen hints and on the tiger without wall 0 under
    hints_for_dropped, each bitwise across launches, within GRAD_BOUNDS of
    its plain version in bands and timed; K1 of the scene without the wall
    against the plain pipeline in bands. Returns (K6 cells by scene, K5
    cells, K1's largest light difference)."""
    cfg = RenderConfig(**TRAIN)
    camera = camera_for(("yxz",), device)
    cells = {}
    for name in SOFT_STEP_SCENES:
        scene, ref = library.SCENES[name](device), COMPOSITE_SOFT_REFS[name]
        packed, lay, zero_map, alpha, target = soft_inputs(
            scene, camera, cfg, ref, SOFT_EDGE,
            torch.zeros((cfg.height, cfg.width, 3), device=device))
        hcfg, keep, frozen = frozen_setup(scene, camera, cfg)
        label = f"{name} {ref} 1280x720x8spp x4"
        hinted = gradkernel.launch_soft_loss_grad(packed, lay, hcfg, 1, target, alpha, zero_map,
                                                  keep=keep)
        again = gradkernel.launch_soft_loss_grad(packed, lay, hcfg, 1, target, alpha, zero_map,
                                                 keep=keep)
        assert all(torch.equal(a, b) for a, b in zip(hinted, again)), f"K6 {label}: launches differ"
        check_contract(f"K6 {label}", hinted, gradkernel.launch_soft_loss_grad(
            packed, lay, cfg, 1, target, alpha, zero_map), frozen)
        cell = {"P": lay.size, "zero_slots": len(zero_map)}
        plain = []
        cell["plain_ms"] = cuda_ms(lambda: plain.append(
            gradkernel.render_soft_loss_and_grad_plain(packed, scene, camera, hcfg, 1, target,
                                                       alpha, zero_map, band_rows=BAND_ROWS)),
            calls=1, repeats=1)[0]
        cell["max_abs_err"], cell["grad_mixed_rel"] = compare_soft(
            f"{label} frozen hints (plain in {BAND_ROWS}-row bands)", hinted, plain[0],
            floor=COMPOSITE_PATTERN_FLOOR)
        for key, c, k in (("ms", hcfg, keep), ("unhinted_ms", cfg, None)) * 2:
            cell.setdefault(key + "_all", []).extend(cuda_ms(
                lambda c=c, k=k: gradkernel.launch_soft_loss_grad(packed, lay, c, 1, target,
                                                                  alpha, zero_map, keep=k),
                calls=TRAIN_CALLS, repeats=TRAIN_REPEATS))
        for key in ("ms", "unhinted_ms"):
            cell[key] = statistics.median(cell[key + "_all"])
        if name == "tiger":
            cell.update(k6_bound(scene, camera, cfg, ref, packed, lay))
        cell["soft_grad_mrays_per_s"] = cfg.width * cfg.height * cfg.samples / cell["ms"] / 1e3
        cells[name] = cell
        print(json.dumps({"cell": f"soft K6 {label}, zero target, edge width {SOFT_EDGE}, the "
                                  "frozen hints", **cell}), flush=True)
    scene = library.tiger(device)
    hcfg = diff.with_frozen_hints(cfg, scene)
    dropped, dcfg = diff.drop_object(scene, FALLBACK_REF), diff.hints_for_dropped(hcfg,
                                                                                   FALLBACK_REF)
    cot = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (cfg.height, cfg.width, 3)).astype(np.float32)).to(device)
    k5 = {}
    for key, s, c in (("tiger", scene, hcfg), ("tiger_without_wall0", dropped, dcfg)):
        packed, lay = params.pack(s, camera), params.layout(s, camera)
        keep = params.freeze_mask(c, s, lay.size, device)
        label = f"K5 {key} 1280x720x8spp x4, 1 row"
        grad = gradkernel.launch_light_vjp(packed, lay, c, 1, cot, keep=keep)
        assert torch.equal(grad, gradkernel.launch_light_vjp(packed, lay, c, 1, cot, keep=keep)), \
            f"{label}: launches differ"
        plain = []
        plain_ms = cuda_ms(lambda: plain.append(vjp_plain_in_bands(packed, s, camera, c, 1, cot)),
                           calls=1, repeats=1)[0]
        err, rel = compare_vec(f"{label} frozen hints (plain in {BAND_ROWS}-row bands)", grad,
                               plain[0], floor=COMPOSITE_PATTERN_FLOOR)
        ms = cuda_ms(lambda: gradkernel.launch_light_vjp(packed, lay, c, 1, cot, keep=keep),
                     calls=TRAIN_CALLS, repeats=TRAIN_REPEATS)
        k5[key] = {"P": lay.size, "ms_all": ms, "ms": statistics.median(ms), "plain_ms": plain_ms,
                   "max_abs_err": err, "grad_mixed_rel": rel}
        print(json.dumps({"cell": f"{label}, seeded random cotangent, the frozen hints",
                          **k5[key]}), flush=True)
    k1_err = check_close(
        f"K1 tiger without wall 0 1280x720x8spp x4 hints_for_dropped vs plain in {BAND_ROWS}-row "
        "bands", megakernel.render_light_cuda(dropped, camera, dcfg, 1),
        plain_in_bands(dropped, camera, dcfg, 1)[0])
    return cells, k5, k1_err


def soft_step_host(step, state, target, steps: int) -> dict:
    """``steps`` soft steps (seeds 1, 2, ...), each started with the card
    idle and read on the host clock twice: when the call returns
    (``host_ms``, the host's part: the step issues its launches without
    waiting for the card) and when the card has finished (``wall_ms``)."""
    out = {"host_ms": [], "wall_ms": []}
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state[0], state[1], _, _ = step(state[0], state[1], i + 1, target)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        out["host_ms"].append((t1 - t0) * 1e3)
        out["wall_ms"].append((time.perf_counter() - t0) * 1e3)
    return out


def soft_train(device, ref, calls: int, repeats: int, name: str = "room_with_sphere",
               modes: dict | None = None):
    """Phase 13: make_train_step(impl="kernel", soft_object_ref=ref) at
    TRAIN on scene ``name``, in the production configuration (the frozen
    static hints); one warm-up step, then timed steps. ``modes`` (phase
    8c): as train_main_path's.
    Returns (ms per step, the steps, the trained scene and its optimizer,
    the target, the step)."""
    cfg = RenderConfig(**TRAIN, **(modes or {}))
    scene, camera = library.SCENES[name](device), camera_for(("yxz",), device)
    cfg = diff.with_frozen_hints(cfg, scene)
    target = torch.zeros((cfg.height, cfg.width, 3), device=device)
    step, init = diff.make_train_step(cfg, 1e-3, camera, impl="kernel", soft_object_ref=ref,
                                      edge_width=SOFT_EDGE)
    state = list(init(scene))
    start = params.pack(state[0], camera).detach().clone()
    losses = []

    def one():
        state[0], state[1], loss, _ = step(state[0], state[1], len(losses) + 1, target)
        losses.append(loss)

    one()  # warm-up
    ms = cuda_ms(one, calls=calls, repeats=repeats)
    out = torch.stack(losses).cpu().numpy()
    assert np.isfinite(out).all(), out
    vec = params.pack(state[0], camera).detach()
    assert np.isfinite(vec.cpu().numpy()).all() and not torch.equal(vec, start), \
        f"{ref}: the step did not move the scene"
    if megakernel.hinted(cfg):
        held = params.freeze_mask(cfg, scene).to(device) == 0
        n = held.numel()
        assert torch.equal(vec[:n][held], start[:n][held]), f"{ref}: a frozen slot moved"
    rays = cfg.width * cfg.height * cfg.samples
    med = statistics.median(ms)
    print(f"soft train step {name} {ref} frozen hints {cfg.sampler_method}/{cfg.intersect}: "
          f"ms={ms} "
          f"median={med} grad_mrays_per_s={rays / med / 1e3} losses {out[0]} -> {out[-1]}",
          flush=True)
    return ms, len(losses), state, target, step


SOFT_TURNS, SOFT_TURN_STEPS = 6, 5


def soft_step_turns(device, ref) -> dict:
    """Phase 13: the sphere soft step at TRAIN in the production
    configuration (the frozen static hints) and unhinted, in turns (hinted,
    unhinted, then unhinted, hinted, ...), SOFT_TURN_STEPS steps a turn
    after one warm-up turn each, each step read by soft_step_host. They
    run after the main path's counts are read. Returns {"hinted" | "unhinted":
    {"host_ms": [...], "wall_ms": [...]}}."""
    runs = {}
    for name in ("hinted", "unhinted"):
        scene, camera = library.room_with_sphere(device), camera_for(("yxz",), device)
        cfg = RenderConfig(**TRAIN)
        if name == "hinted":
            cfg = diff.with_frozen_hints(cfg, scene)
        step, init = diff.make_train_step(cfg, 1e-3, camera, impl="kernel", soft_object_ref=ref,
                                          edge_width=SOFT_EDGE)
        runs[name] = (step, list(init(scene)), torch.zeros((cfg.height, cfg.width, 3),
                                                           device=device))
    out = {name: {"host_ms": [], "wall_ms": []} for name in runs}
    order = [("hinted", "unhinted") if t % 2 == 0 else ("unhinted", "hinted")
             for t in range(SOFT_TURNS)]
    for k, name in enumerate(["hinted", "unhinted"] + [n for turn in order for n in turn]):
        times = soft_step_host(*runs[name], SOFT_TURN_STEPS)
        if k >= 2:  # after the warm-up turns
            for key, v in times.items():
                out[name][key].extend(v)
    return out


def contract_host_ms(device, reps: int = 200) -> float:
    """Phase 13: the host work the freeze_hints contract adds to one sphere
    soft step on the kernel route, the calls the unhinted step does not
    make, timed alone on the host clock (median of ``reps``): the hints
    derived where the cfg has none (soft_image_loss_kernel and K6's
    wrapper), the frozen leaves stopped for the coverage, the packed mask
    looked up, and K6's hints descriptor built."""
    scene, camera = library.room_with_sphere(device), camera_for(("yxz",), device)
    cfg = diff.with_frozen_hints(RenderConfig(**TRAIN), scene)
    leaves = params.map_leaves(lambda t: t.detach().clone().requires_grad_(True), scene)
    lay = params.layout(scene, camera)

    def once():
        gradkernel._auto_hints(leaves, cfg)
        diff.stop_frozen(leaves, cfg)
        gradkernel._auto_hints(leaves, cfg)
        params.freeze_mask(cfg, leaves, lay.size, device)
        megakernel.hint_table(cfg, lay)

    once()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        once()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def soft_step_split(device, state, target, ref=SOFT_REFS["room_with_sphere"]):
    """Phase 13: the parts of a soft step alone, at its state: K6, the
    coverage's forward and backward, and Adam (the room's sphere 0 by
    default; phase 13b the tiger). It runs after the main path's counts
    are read: its launches are timing runs. Returns a dict of ms lists."""
    camera = camera_for(("yxz",), device)
    scene, opt = state
    cfg = diff.with_frozen_hints(RenderConfig(**TRAIN), scene)
    keep = params.freeze_mask(cfg, scene, params.layout(scene, camera).size, device)
    packed, lay, zero_map, alpha, target = soft_inputs(scene, camera, cfg, ref, SOFT_EDGE, target)

    def coverage():
        vec = packed.clone().requires_grad_(True)
        a = diff.object_coverage(params.unpack(vec, scene, camera)[0], ref, camera, cfg,
                                 SOFT_EDGE)
        a.backward(alpha)

    return {
        "k6": cuda_ms(lambda: gradkernel.launch_soft_loss_grad(packed, lay, cfg, 1, target, alpha,
                                                               zero_map, keep=keep),
                      calls=TRAIN_CALLS, repeats=TRAIN_REPEATS),
        "coverage_fwd_bwd": cuda_ms(coverage, calls=TRAIN_CALLS, repeats=TRAIN_REPEATS),
        "adam": cuda_ms(opt.step, calls=TRAIN_CALLS, repeats=TRAIN_REPEATS),
    }


def mode_soft_ref(name: str):
    """The soft object of a GRAD_MODE_SCENES scene: a sphere of the plane
    scenes, the composite itself (the cells-only hypercube's cells
    zeroed)."""
    if name == "hypercube_cells":
        return COMPOSITE_SOFT_REFS["hypercube"]
    return SOFT_REFS.get(name) or COMPOSITE_SOFT_REFS[name]


def image_loss_of(light: torch.Tensor, target: torch.Tensor, cfg: RenderConfig) -> float:
    """The loss of K4's definition over K1's light (F, H, W, 3): the mean
    over frames, pixels and channels of (tone-mapped light - target)^2, in
    double."""
    image = light_to_color(light, cfg.light_coefficient)
    return float(torch.mean(((image - target) ** 2).double()))


def check_grad_modes(device) -> dict:
    """Phase 8c's checks at GRAD_CHECK, one view, on every GRAD_MODE_SCENES
    scene in each GRAD_MODES configuration (the cells-only hypercube in the
    production one too): K4 over a (2,) seed vector, K5 with a seeded random
    cotangent and K6 with a seeded random alpha (the scene's soft object
    zeroed in row b) against their plain versions within GRAD_BOUNDS (the
    composites' pattern floor), each bitwise across two launches; K4's loss
    within loss_rtol of the loss over K1's image in the same configuration;
    under diff.with_frozen_hints the fast fold's launches hold the contract
    and the literal folds' (no hints) are bitwise the unhinted launches. Then
    one K4 and one K6 launch in trig on the tiger cut into 2 row blocks: the
    blocks' sums within GRAD_BOUNDS of the whole launch, K6's alpha
    cotangent blocks bitwise its rows. Returns the worst errors by kernel
    and the launches checked, by kernel and configuration."""
    seeds = np.array([0x12345678, 0x9ABCDEF0], np.uint32)
    words = megakernel.seed_tensor(seeds, device)
    camera = camera_for(("yxz",), device)
    worst = {"k4": [0.0, 0.0], "k5": [0.0, 0.0], "k6": [0.0, 0.0]}
    checked = {"k4": {}, "k5": {}, "k6": {}}
    for name in GRAD_MODE_SCENES:
        scene = modes_scene(name, device)
        packed, lay = params.pack(scene, camera), params.layout(scene, camera)
        floor = COMPOSITE_PATTERN_FLOOR if lay.composite_kinds() else 0.0
        modes = list(GRAD_MODES.values()) + ([{}] if lay.hypercube_cells else [])
        zero_map = params.soft_zero_map(scene, camera, mode_soft_ref(name))
        for mode in modes:
            cfg = RenderConfig(**GRAD_CHECK, **mode)
            key = megakernel.launch_config(cfg, lay)
            assert not megakernel.production(cfg, lay), key
            rng = np.random.default_rng(3)
            target = torch.from_numpy(rng.uniform(0, 1, (cfg.height, cfg.width, 3)).astype(
                np.float32)).to(device)
            cot = torch.from_numpy(rng.normal(0, 1, (cfg.height, cfg.width, 3)).astype(
                np.float32)).to(device)
            alpha = torch.from_numpy(rng.uniform(0, 1, (cfg.height, cfg.width)).astype(
                np.float32)).to(device)
            label = f"8c {name} {key}"
            # K4
            k4 = gradkernel.launch_loss_grad(packed, lay, cfg, words, target)
            again = gradkernel.launch_loss_grad(packed, lay, cfg, words, target)
            plain = gradkernel.loss_and_grad_plain(packed, scene, camera, cfg, seeds, target)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(k4, again)), f"{label}: K4 launches"
            err, rel = compare_grad(label, k4, plain, floor)
            image = image_loss_of(megakernel.launch_forward(packed, lay, cfg, words)[:, 0],
                                  target, cfg)
            print(f"K4 {label} loss={float(k4[0])} over K1's image={image}", flush=True)
            assert abs(float(k4[0]) - image) <= GRAD_BOUNDS["loss_rtol"] * abs(image), label
            # K5, K6
            k5 = gradkernel.render_light_vjp_cuda(packed, scene, camera, cfg, 1, cot)
            assert torch.equal(k5, gradkernel.render_light_vjp_cuda(packed, scene, camera, cfg,
                                                                    1, cot)), f"{label}: K5"
            e5, r5 = compare_vec(f"K5 {label}", k5, gradkernel.render_light_vjp_plain(
                packed, scene, camera, cfg, 1, cot), floor=floor)
            k6 = gradkernel.render_soft_loss_and_grad_cuda(packed, scene, camera, cfg, 1, target,
                                                           alpha, zero_map)
            again = gradkernel.render_soft_loss_and_grad_cuda(packed, scene, camera, cfg, 1,
                                                              target, alpha, zero_map)
            assert all(torch.equal(a, b) for a, b in zip(k6, again)), f"{label}: K6 launches"
            e6, r6 = compare_soft(label, k6, gradkernel.render_soft_loss_and_grad_plain(
                packed, scene, camera, cfg, 1, target, alpha, zero_map), floor=floor)
            for k, e, r in (("k4", err, rel), ("k5", e5, r5), ("k6", e6, r6)):
                worst[k] = [max(worst[k][0], e), max(worst[k][1], r)]
            for k in checked:
                checked[k][key] = checked[k].get(key, 0) + 1
            # The contract: the fast fold's hints frozen, the literal folds' none.
            hcfg = diff.with_frozen_hints(cfg, scene)
            if megakernel.hinted(hcfg):
                keep = params.freeze_mask(hcfg, scene, lay.size, device)
                frozen = keep == 0
                check_contract(f"K4 {label}", gradkernel.launch_loss_grad(
                    packed, lay, hcfg, words, target, keep=keep), k4, frozen)
                check_contract(f"K5 {label}", gradkernel.render_light_vjp_cuda(
                    packed, scene, camera, hcfg, 1, cot), k5, frozen)
                check_contract(f"K6 {label}", gradkernel.render_soft_loss_and_grad_cuda(
                    packed, scene, camera, hcfg, 1, target, alpha, zero_map), k6, frozen)
            else:
                assert params.freeze_mask(hcfg, scene, lay.size, device) is None, label
                same = all(torch.equal(a, b) for a, b in zip(
                    gradkernel.render_soft_loss_and_grad_cuda(packed, scene, camera, hcfg, 1,
                                                              target, alpha, zero_map), k6))
                same = same and all(torch.equal(a, b) for a, b in zip(
                    gradkernel.launch_loss_grad(packed, lay, hcfg, words, target), k4))
                print(f"{label}: under with_frozen_hints no hints, nothing frozen, K4 and K6 "
                      f"bitwise the unhinted launches={same}", flush=True)
                assert same, label
    # Row blocks: K4 and K6 in trig on the tiger, 2 blocks.
    scene = library.tiger(device)
    packed, lay = params.pack(scene, camera), params.layout(scene, camera)
    cfg = RenderConfig(**GRAD_CHECK, **GRAD_TRIG)
    rng = np.random.default_rng(4)
    target = torch.from_numpy(rng.uniform(0, 1, (cfg.height, cfg.width, 3)).astype(
        np.float32)).to(device)
    alpha = torch.from_numpy(rng.uniform(0, 1, (cfg.height, cfg.width)).astype(
        np.float32)).to(device)
    zero_map = params.soft_zero_map(scene, camera, COMPOSITE_SOFT_REFS["tiger"])
    whole4 = gradkernel.launch_loss_grad(packed, lay, cfg, words, target)
    whole6 = gradkernel.render_soft_loss_and_grad_cuda(packed, scene, camera, cfg, 1, target,
                                                       alpha, zero_map)
    parts4, parts6 = [], []
    for row0, n_rows in shard_blocks(cfg.height, 2):
        rows = (row0, n_rows)
        parts4.append(gradkernel.launch_loss_grad(packed, lay, cfg, words,
                                                  target[row0:row0 + n_rows].contiguous(), rows))
        parts6.append(gradkernel.render_soft_loss_and_grad_cuda(
            packed, scene, camera, cfg, 1, target[row0:row0 + n_rows],
            alpha[row0:row0 + n_rows], zero_map, rows))
    err, rel = compare_grad("8c tiger trig K4 2 row blocks summed",
                            (sum(p[0] for p in parts4), sum(p[1] for p in parts4)), whole4,
                            COMPOSITE_PATTERN_FLOOR)
    acot = torch.cat([p[2] for p in parts6])
    assert torch.equal(acot, whole6[2]), "8c tiger trig K6 row blocks: alpha cotangent"
    e6, r6 = compare_soft("8c tiger trig 2 row blocks summed",
                          (sum(p[0] for p in parts6), sum(p[1] for p in parts6), acot), whole6,
                          floor=COMPOSITE_PATTERN_FLOOR)
    for k, e, r in (("k4", err, rel), ("k6", e6, r6)):
        worst[k] = [max(worst[k][0], e), max(worst[k][1], r)]
    return {"max_abs_err": {k: v[0] for k, v in worst.items()},
            "max_grad_mixed_rel": {k: v[1] for k, v in worst.items()}, "checked": checked,
            "row_blocks": {"k4": 2, "k6": 2}}


def mode_bound(kernel: str, scene, camera, cfg: RenderConfig, packed, lay) -> dict:
    """The bound of K4 (one frame) or K5 (one row) at ``cfg`` on the closed
    room (every lane lives): the plain version's flops over BOUND_ROWS rows
    (forward and autograd backward, newton's steps as its data needs them),
    scaled to the image, and K4's or K5's bytes (kernel_bounds')."""
    rows, scale = (0, BOUND_ROWS), cfg.height / BOUND_ROWS
    block = torch.zeros((BOUND_ROWS, cfg.width, 3), device=packed.device)
    pixels, p = cfg.height * cfg.width, lay.size
    if kernel == "k4":
        flops = count_flops(gradkernel.loss_and_grad_plain, packed, scene, camera, cfg, [1],
                            block, rows=rows)[1]
        return bound(flops * scale, 4 * (p + 1 + pixels * 3 + p + 1))
    flops = count_flops(gradkernel.render_light_vjp_plain, packed, scene, camera, cfg, 1, block,
                        rows=rows)[1]
    return bound(flops * scale, 4 * (p + pixels * 3 + p))


def grad_modes_main(device, card: str) -> dict:
    """Phase 8c's main path at TRAIN (1 frame, one view), from zeroed counts:
    the packed Adam step under with_frozen_hints on the room and on the
    tiger in GRAD_ORACLE (one K4 launch a step), the soft step on the room's
    sphere 0 in trig (one K6 launch a step) and its hyperplane fallback
    ("spaces", 0: two K1 and two K5 launches a step), every launch counted
    by configuration. Then, at the same shape, each kernel those steps run
    held against its plain version (K4 and K6 in BAND_ROWS-row bands, K5
    whole) within GRAD_BOUNDS and timed beside it (CUDA-event medians of
    MODE_CALLS x MODE_REPEATS, the plain version once) with its bound: K4 on
    the room in each GRAD_MODES configuration (with_frozen_hints: the fast
    fold's hints frozen) and on the tiger in GRAD_ORACLE (k4_bound: its live
    lanes), K6 on the room's sphere 0 in trig (k6_bound) and K5 one row in
    trig. Returns the counts, the times and the worst errors by kernel."""
    reset_counts()
    steps = {"room": train_main_path(device, 1, modes=GRAD_ORACLE),
             "tiger": train_main_path(device, 1, name="tiger", modes=GRAD_ORACLE)}
    soft_ms, n_soft, _, _, _ = soft_train(device, SOFT_REFS["room_with_sphere"], TRAIN_CALLS, 1,
                                          modes=GRAD_TRIG)
    fallback_ms, n_fallback, _, _, _ = soft_train(device, FALLBACK_REF, TRAIN_CALLS, 1,
                                                  modes=GRAD_TRIG)
    n_train = 1 + TRAIN_CALLS * TRAIN_REPEATS
    launches = {"counts": counts(), "k4": dict(gradkernel.CONFIG_LAUNCHES),
                "k5": dict(gradkernel.CONFIG_VJP_LAUNCHES),
                "k6": dict(gradkernel.CONFIG_SOFT_LAUNCHES),
                "k1": dict(megakernel.CONFIG_LAUNCHES)}
    oracle, trig = "per_sample/newton/trig", "per_sample/poly/trig"
    expect = {"k4": {oracle: 2 * n_train}, "k5": {trig: 2 * n_fallback},
              "k6": {trig: n_soft}, "k1": {trig: 2 * n_fallback}}
    assert {k: launches[k] for k in expect} == expect, (launches, expect)
    print(json.dumps({"phase": "8c main path", "card": card, "launches": launches}), flush=True)
    camera = camera_for(("yxz",), device)
    words = megakernel.seed_tensor([1], device)
    target = torch.zeros((TRAIN["height"], TRAIN["width"], 3), device=device)
    worst = {"k4": [0.0, 0.0], "k5": [0.0, 0.0], "k6": [0.0, 0.0]}

    def timed_against_plain(kernel: str, label: str, launch, plain_fn, compare) -> dict:
        """``launch`` twice (bitwise), against ``plain_fn``'s result, then
        timed beside it."""
        out = launch()
        assert all(torch.equal(a, b) for a, b in zip(out, launch())), f"{label}: launches differ"
        ms = cuda_ms(launch, calls=MODE_CALLS, repeats=MODE_REPEATS)
        plain = [None]
        plain_ms = cuda_ms(lambda: plain.__setitem__(0, plain_fn()), calls=1, repeats=1)[0]
        err, rel = compare(label, out, plain[0])
        worst[kernel] = [max(worst[kernel][0], err), max(worst[kernel][1], rel)]
        print(f"{label}: ms={ms} plain_ms={plain_ms}", flush=True)
        return {"ms": statistics.median(ms), "ms_runs": ms, "plain_ms": plain_ms,
                "max_abs_err": err, "grad_mixed_rel": rel}

    timed = {}
    for name, modes in (("room_with_sphere", GRAD_MODES),
                        ("tiger", {oracle: GRAD_ORACLE})):
        scene = library.SCENES[name](device)
        packed, lay = params.pack(scene, camera), params.layout(scene, camera)
        floor = COMPOSITE_PATTERN_FLOOR if lay.composite_kinds() else 0.0
        for key, mode in modes.items():
            cfg = diff.with_frozen_hints(RenderConfig(**TRAIN, **mode), scene)
            keep = params.freeze_mask(cfg, scene, lay.size, device)
            cell = timed_against_plain(
                "k4", f"8c K4 {name} {key} 1280x720x8spp x4 (plain in {BAND_ROWS}-row bands)",
                lambda cfg=cfg, keep=keep: gradkernel.launch_loss_grad(
                    packed, lay, cfg, words, target, keep=keep),
                lambda cfg=cfg: gradkernel.loss_and_grad_plain(
                    packed, scene, camera, cfg, [1], target, band_rows=BAND_ROWS),
                lambda label, k, p, floor=floor: compare_grad(label, k, p, floor))
            if name == "room_with_sphere":
                timed[key] = {**cell, **mode_bound("k4", scene, camera, cfg, packed, lay)}
                print(f"8c K4 room {key} 1280x720: bound_ms={timed[key]['bound_ms']}", flush=True)
            else:
                tiger = {**cell, **k4_bound(scene, camera, cfg, packed, lay)}
                print(f"8c K4 tiger {key} 1280x720: bound_ms={tiger['bound_ms']} (live share "
                      f"{tiger['live_share']})", flush=True)
    scene = library.room_with_sphere(device)
    packed, lay = params.pack(scene, camera), params.layout(scene, camera)
    cfg = RenderConfig(**TRAIN, **GRAD_TRIG)
    ref = SOFT_REFS["room_with_sphere"]
    _, _, zero_map, alpha, _ = soft_inputs(scene, camera, cfg, ref, SOFT_EDGE, target)
    k6 = timed_against_plain(
        "k6", f"8c K6 room {ref} trig 1280x720x8spp x4 (plain in {BAND_ROWS}-row bands)",
        lambda: gradkernel.launch_soft_loss_grad(packed, lay, cfg, 1, target, alpha, zero_map),
        lambda: gradkernel.render_soft_loss_and_grad_plain(
            packed, scene, camera, cfg, 1, target, alpha, zero_map, band_rows=BAND_ROWS),
        lambda label, k, p: compare_soft(label, k, p))
    k6.update(k6_bound(scene, camera, cfg, ref, packed, lay))
    print(f"8c K6 room trig 1280x720: bound_ms={k6['bound_ms']}", flush=True)
    cot = torch.from_numpy(np.random.default_rng(6).normal(
        0, 1, (cfg.height, cfg.width, 3)).astype(np.float32)).to(device)
    k5 = timed_against_plain(
        "k5", "8c K5 room trig 1 row 1280x720x8spp x4 (plain whole)",
        lambda: (gradkernel.render_light_vjp_cuda(packed, scene, camera, cfg, 1, cot),),
        lambda: (gradkernel.render_light_vjp_plain(packed, scene, camera, cfg, 1, cot),),
        lambda label, k, p: compare_vec(label, k[0], p[0]))
    k5.update(mode_bound("k5", scene, camera, cfg, packed, lay))
    print(f"8c K5 room trig 1 row 1280x720: bound_ms={k5['bound_ms']}", flush=True)
    return {"launches": launches,
            "packed_step_ms": {k: statistics.median(v) for k, v in steps.items()},
            "packed_step_ms_runs": steps, "oracle": oracle,
            "soft_step_trig_ms": statistics.median(soft_ms), "soft_step_trig_ms_runs": soft_ms,
            "fallback_step_trig_ms": statistics.median(fallback_ms),
            "k4_room": timed, "k4_tiger_oracle": tiger, "k6_room_trig": k6, "k5_room_trig": k5,
            "max_abs_err": {k: v[0] for k, v in worst.items()},
            "max_grad_mixed_rel": {k: v[1] for k, v in worst.items()}}


def run_inverse_render_position() -> int:
    """Phase 13: the entry point of the soft path on the card, in the
    production configuration (--freeze-hints). Returns its steps."""
    args = inverse_render.parse_args(["--param", "position"])
    before = gradkernel.SOFT_LAUNCHES, gradkernel.HINTED_SOFT_LAUNCHES
    rc = inverse_render.main(["--param", "position", "--impl", "kernel", "--device", "cuda",
                              "--freeze-hints"])
    assert rc == 0, "inverse_render --param position: x not recovered"
    assert gradkernel.SOFT_LAUNCHES - before[0] == args.steps, "one K6 launch per step"
    assert gradkernel.HINTED_SOFT_LAUNCHES - before[1] == args.steps, "K6 ran no hints"
    return args.steps


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of flops over the
    fp32 peak and bytes over the memory rate, and which of the two."""
    by_ops = flops / PEAKS["fp32_flops_per_s"] * 1e3
    by_bytes = nbytes / PEAKS["bytes_per_s"] * 1e3
    return {"bound_ms": max(by_ops, by_bytes),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def kernel_bounds(device) -> dict:
    """Each kernel's bound at the shape its summary time was taken: K1 at
    the headline 4-frame launch (hinted, and unhinted beside it), K4, K5
    (one row), K6 and K8 at TRAIN under the frozen hints (unhinted beside
    K4-K6). The
    flops are its plain version's over the first BOUND_ROWS rows (K4, K5
    and K6: forward and autograd backward), counted here and scaled to the
    image's rows; the plain versions are dense, so masked lanes count, but
    K1's hinted count takes the live lanes (live_lane_flops: all of them in
    the closed room)."""
    scene, camera = library.room_with_sphere(device), camera_for(("yxz",), device)
    packed, lay = params.pack(scene, camera), params.layout(scene, camera)
    p = lay.size
    head, cfg = RenderConfig(**HEADLINE), RenderConfig(**TRAIN)
    rows, scale = (0, BOUND_ROWS), cfg.height / BOUND_ROWS
    pixels = cfg.height * cfg.width
    frames = np.arange(1, FRAMES_PER_LAUNCH + 1, dtype=np.uint32)
    rng = np.random.default_rng(8)
    block = torch.from_numpy(rng.uniform(0, 1, (BOUND_ROWS, cfg.width, 3)).astype(np.float32)
                             ).to(device)
    ref = SOFT_REFS["room_with_sphere"]
    alpha = diff.object_coverage(scene, ref, camera, cfg, SOFT_EDGE).detach()[:BOUND_ROWS]
    zero_map = params.soft_zero_map(scene, camera, ref)
    f1_dense, f1 = live_lane_flops(scene, camera, megakernel.with_hints(scene, head), frames,
                                   slice(0, BOUND_ROWS))
    f1_unhinted = count_flops(renderer.render_light, scene, camera, head, frames,
                              slice(0, BOUND_ROWS))[1]
    # K4-K6 and K8 count the flops of their plain versions in the
    # production configuration, the frozen static hints (the hinted fold's
    # work), the unhinted count beside each.
    hcfg = diff.with_frozen_hints(cfg, scene)

    def grad_flops(c):
        return (count_flops(gradkernel.loss_and_grad_plain, packed, scene, camera, c, [1], block,
                            rows=rows)[1],
                count_flops(gradkernel.render_light_vjp_plain, packed, scene, camera, c, 1, block,
                            rows=rows)[1],
                count_flops(gradkernel.render_soft_loss_and_grad_plain, packed, scene, camera, c,
                            1, block, alpha, zero_map, rows=rows)[1])

    f4, f5, f6 = grad_flops(hcfg)
    rays = pixels * cfg.samples
    grad_bytes = {"k4": 4 * (p + 1 + pixels * 3 + p + 1), "k5": 4 * (p + pixels * 3 + p),
                  "k6": 4 * (p + pixels * 3 + pixels + p + 1 + pixels)}
    out = {
        "k1": bound(f1 * scale, 4 * (p + FRAMES_PER_LAUNCH + FRAMES_PER_LAUNCH * pixels * 3)),
        "k4": bound(f4 * scale, grad_bytes["k4"]),
        "k5": bound(f5 * scale, grad_bytes["k5"]),
        "k6": bound(f6 * scale, grad_bytes["k6"]),
    }
    for k, f in zip(("k4", "k5", "k6"), grad_flops(cfg)):
        out[k]["unhinted"] = bound(f * scale, grad_bytes[k])
    # K8 (each mode, one frame): the params, the target (loss and vjp) and
    # the value.
    out["k8"] = {mode: bound(count_flops(ablate.variant_plain, mode, scene, camera, hcfg, 1,
                                         block, rows)[1] * scale,
                             4 * (p + 1 + (0 if mode == "acc" else pixels * 3)))
                 for mode in ablate.MODES}
    # K1's bound counts the hinted plain version's flops, the production
    # forward's work; the unhinted count beside it.
    out["k1"]["flops_per_ray"] = f1 * scale / (rays * FRAMES_PER_LAUNCH)
    out["k1"]["dense_flops"] = f1_dense * scale  # the room is closed: every lane lives on
    out["k1"]["unhinted"] = bound(f1_unhinted * scale, out["k1"]["bytes"])
    for k in ("k4", "k5", "k6"):
        out[k]["flops_per_ray"] = out[k]["flops"] / rays
    print(json.dumps({"bounds": out, "peaks": PEAKS}), flush=True)
    return out


def shard_blocks(height: int, n: int) -> list:
    return [pmesh.row_block(height, n, i) for i in range(n)]


def time_shards(label: str, whole_fn, block_fn, height: int) -> dict:
    """CUDA-event milliseconds of the single launch and of each block's
    launch for every split of SHARDS; prints them."""
    res = {"whole_ms": statistics.median(cuda_ms(whole_fn, calls=TRAIN_CALLS,
                                                  repeats=TRAIN_REPEATS))}
    for n in SHARDS:
        res[n] = [statistics.median(cuda_ms(lambda r=r: block_fn(r), calls=TRAIN_CALLS,
                                            repeats=TRAIN_REPEATS))
                  for r in shard_blocks(height, n)]
    print(f"{label} launch ms: whole {res['whole_ms']}, "
          + ", ".join(f"{n} blocks {res[n]} (sum {sum(res[n])})" for n in SHARDS), flush=True)
    return res


def rows_of(x: torch.Tensor, block) -> torch.Tensor:
    """Rows block (row0, n_rows) of an (..., H, W, C) array, contiguous."""
    return x[..., block[0]:block[0] + block[1], :, :].contiguous()


def check_row_shards(device) -> dict:
    """Phase 14: every kernel's row blocks against its single launch, each
    block of PLAIN_SPLIT against its plain version on the same rows, and
    their times; the gradient kernels' under the freeze_hints contract.
    Returns the largest errors of the block sums against the single launch
    (``sum_errs``) and of the blocks against their plain versions
    (``block_errs``), and the times."""
    room = library.room_with_sphere(device)
    ref = SOFT_REFS["room_with_sphere"]
    sum_errs = {"k1": 0.0, "k4": 0.0, "k5": 0.0, "k6": 0.0}
    block_errs = dict(sum_errs)
    ms = {}
    for base, views, seeds in ((RenderConfig(**HEADLINE), ("yxz",), [1, 2, 3, 4]),
                               (RenderConfig(**GRAD_CHECK), cam.VIEWS_ALL, [5, 6])):
        camera = camera_for(views, device)
        packed, lay = params.pack(room, camera), params.layout(room, camera)
        words = megakernel.seed_tensor(seeds, device)
        scenes = (room, diff.zero_object(room, ref))
        cfg = megakernel.with_hints(scenes, base)  # K2's rows share the room's hints
        assert cfg == megakernel.with_hints(room, base) and cfg.plane_pairs is not None
        pair = params.stack_rows(scenes, camera)
        pair_words = megakernel.seed_tensor(seeds[:1] * 2, device)
        whole = megakernel.launch_forward(packed, lay, cfg, words)
        whole2 = megakernel.launch_forward(pair, lay, cfg, pair_words)
        label = f"{cfg.width}x{cfg.height} views={len(views)}"
        block_errs["k1"] = max(block_errs["k1"], check_close(
            f"K1 {label} hinted vs unhinted", whole,
            megakernel.launch_forward(packed, lay, base, words)), check_close(
            f"K2 {label} hinted vs unhinted", whole2,
            megakernel.launch_forward(pair, lay, base, pair_words)))
        for n in SHARDS:
            blocks = shard_blocks(cfg.height, n)
            cut = [megakernel.launch_forward(packed, lay, cfg, words, b) for b in blocks]
            cut2 = [megakernel.launch_forward(pair, lay, cfg, pair_words, b) for b in blocks]
            torch.cuda.synchronize()
            assert torch.equal(torch.cat(cut, dim=2), whole), f"K1 {n} row blocks != one launch"
            assert torch.equal(torch.cat(cut2, dim=2), whole2), f"K2 {n} row blocks != one launch"
            if n != PLAIN_SPLIT:
                continue
            for b, k1, k2 in zip(blocks, cut, cut2):
                band = slice(b[0], b[0] + b[1])
                label = f"{cfg.width}x{cfg.height} views={len(views)} rows {b}"
                for c, kind in ((cfg, "hinted"), (base, "unhinted")):
                    plain = renderer.render_light(room, camera, c, np.asarray(seeds, np.uint32),
                                                  band)
                    plain2 = torch.stack([renderer.render_light(s, camera, c, seeds[0], band)
                                          for s in scenes])
                    block_errs["k1"] = max(block_errs["k1"], check_close(
                        f"K1 block {label} vs {kind} plain", k1[:, 0] if len(views) == 1 else k1,
                        plain), check_close(f"K2 block {label} vs {kind} plain",
                                            k2[:, 0] if len(views) == 1 else k2, plain2))
        print(f"K1 and K2 {cfg.width}x{cfg.height} views={len(views)} frames={len(seeds)}, "
              f"hinted: {' and '.join(map(str, SHARDS))} row blocks bitwise the single launch",
              flush=True)
        if cfg.height == HEADLINE["height"]:
            ms["k1"] = time_shards("K1 4 frames 1280x720", lambda: megakernel.launch_forward(
                packed, lay, cfg, words), lambda b: megakernel.launch_forward(
                packed, lay, cfg, words, b), cfg.height)

    # The tiger's 3-view launch (its own instance of the fold, with the plane
    # and axis hints) cut into row blocks.
    tiger, camera = library.tiger(device), camera_for(cam.VIEWS_ALL, device)
    cfg = megakernel.with_hints(tiger, RenderConfig(**HEADLINE))
    assert cfg.axis_hints is not None
    packed, lay = params.pack(tiger, camera), params.layout(tiger, camera)
    words = megakernel.seed_tensor([1, 2, 3, 4], device)
    whole = megakernel.launch_forward(packed, lay, cfg, words)
    for n in SHARDS:
        cut = [megakernel.launch_forward(packed, lay, cfg, words, b)
               for b in shard_blocks(cfg.height, n)]
        torch.cuda.synchronize()
        assert torch.equal(torch.cat(cut, dim=2), whole), f"tiger K1 {n} row blocks != one launch"
    print(f"K1 tiger 1280x720 views=3 frames=4, hinted: {' and '.join(map(str, SHARDS))} row "
          "blocks bitwise the single launch", flush=True)
    ms["k1_tiger_3view"] = time_shards("K1 tiger 3 views 4 frames 1280x720", lambda: (
        megakernel.launch_forward(packed, lay, cfg, words)), lambda b: megakernel.launch_forward(
        packed, lay, cfg, words, b), cfg.height)

    # The gradient kernels' blocks in the production configuration, the
    # frozen static hints: every block and the single launch hinted.
    camera = camera_for(("yxz",), device)
    cfg, keep, _ = frozen_setup(room, camera, RenderConfig(**TRAIN))
    packed, lay = params.pack(room, camera), params.layout(room, camera)
    rng = np.random.default_rng(9)
    target = torch.from_numpy(rng.uniform(0, 1, (cfg.height, cfg.width, 3)).astype(np.float32)
                              ).to(device)
    for frames in TRAIN_FRAMES:
        seeds = list(range(1, frames + 1))
        words = megakernel.seed_tensor(seeds, device)
        whole = gradkernel.launch_loss_grad(packed, lay, cfg, words, target, keep=keep)
        for n in SHARDS:
            blocks = shard_blocks(cfg.height, n)
            parts = [gradkernel.launch_loss_grad(packed, lay, cfg, words, rows_of(target, b), b,
                                                 keep=keep) for b in blocks]
            summed = (sum(p[0] for p in parts), sum(p[1] for p in parts))
            sum_errs["k4"] = max(sum_errs["k4"], compare_grad(
                f"{n} row blocks summed, 1280x720x8spp x4 F={frames}", summed, whole)[0])
            if n != PLAIN_SPLIT or frames != 1:
                continue
            for b, part in zip(blocks, parts):
                block_errs["k4"] = max(block_errs["k4"], compare_grad(
                    f"block rows {b} of 1280x720x8spp x4 F=1 vs plain (in {BAND_ROWS}-row bands)",
                    part, gradkernel.loss_and_grad_plain(packed, room, camera, cfg, seeds,
                                                         rows_of(target, b), BAND_ROWS, b))[0])
        if frames == 1:
            ms["k4"] = time_shards("K4 1 frame 1280x720", lambda: gradkernel.launch_loss_grad(
                packed, lay, cfg, words, target, keep=keep), lambda b: gradkernel.launch_loss_grad(
                packed, lay, cfg, words, rows_of(target, b), b, keep=keep), cfg.height)

    pair = params.stack_rows((room, diff.zero_object(room, ref)), camera)
    cot = torch.from_numpy(rng.normal(0, 1, (2, cfg.height, cfg.width, 3)).astype(np.float32)
                           ).to(device)
    whole = gradkernel.launch_light_vjp(pair, lay, cfg, 1, cot, keep=keep)
    for n in SHARDS:
        blocks = shard_blocks(cfg.height, n)
        parts = [gradkernel.launch_light_vjp(pair, lay, cfg, 1, rows_of(cot, b), b, keep=keep)
                 for b in blocks]
        sum_errs["k5"] = max(sum_errs["k5"], compare_vec(
            f"K5 two rows, {n} row blocks summed, 1280x720x8spp x4", sum(parts), whole)[0])
        if n == PLAIN_SPLIT:
            for b, part in zip(blocks, parts):
                block_errs["k5"] = max(block_errs["k5"], compare_vec(
                    f"K5 two rows, block rows {b} of 1280x720x8spp x4 vs plain", part,
                    gradkernel.render_light_vjp_plain(pair, room, camera, cfg, 1,
                                                      rows_of(cot, b), b))[0])
    ms["k5"] = time_shards("K5 two rows 1280x720", lambda: gradkernel.launch_light_vjp(
        pair, lay, cfg, 1, cot, keep=keep), lambda b: gradkernel.launch_light_vjp(
        pair, lay, cfg, 1, rows_of(cot, b), b, keep=keep), cfg.height)

    packed, lay, zero_map, alpha, target = soft_inputs(room, camera, cfg, ref, SOFT_EDGE, target)

    def alpha_of(b):
        return alpha[b[0]:b[0] + b[1]].contiguous()

    def k6_block(b):
        return gradkernel.launch_soft_loss_grad(packed, lay, cfg, 1, rows_of(target, b),
                                                alpha_of(b), zero_map, b, keep=keep)

    whole = gradkernel.launch_soft_loss_grad(packed, lay, cfg, 1, target, alpha, zero_map,
                                             keep=keep)
    for n in SHARDS:
        blocks = shard_blocks(cfg.height, n)
        parts = [k6_block(b) for b in blocks]
        alpha_cot = torch.cat([p[2] for p in parts])
        assert torch.equal(alpha_cot, whole[2]), f"K6 {n} blocks: alpha cotangent not bitwise"
        summed = (sum(p[0] for p in parts), sum(p[1] for p in parts), alpha_cot)
        sum_errs["k6"] = max(sum_errs["k6"], compare_soft(
            f"{n} row blocks summed, 1280x720x8spp x4 (alpha cotangent bitwise)", summed,
            whole)[0])
        if n == PLAIN_SPLIT:
            for b, part in zip(blocks, parts):
                block_errs["k6"] = max(block_errs["k6"], compare_soft(
                    f"block rows {b} of 1280x720x8spp x4 vs plain (in {BAND_ROWS}-row bands)",
                    part, gradkernel.render_soft_loss_and_grad_plain(
                        packed, room, camera, cfg, 1, rows_of(target, b), alpha_of(b), zero_map,
                        BAND_ROWS, b), block=True)[0])
    ms["k6"] = time_shards("K6 1280x720", lambda: gradkernel.launch_soft_loss_grad(
        packed, lay, cfg, 1, target, alpha, zero_map, keep=keep), k6_block, cfg.height)
    return {"sum_errs": sum_errs, "block_errs": block_errs, "ms": ms}


def distributed_work() -> "multihost_run.Work":
    """Phases 15 and 15b: the room at TRAIN, 3 steps, sphere 0's soft loss."""
    return multihost_run.Work(width=TRAIN["width"], height=TRAIN["height"],
                              samples=TRAIN["samples"], bounces=TRAIN["reflections_amount"],
                              light_coefficient=TRAIN["light_coefficient"], steps=3,
                              soft_ref=SOFT_REFS["room_with_sphere"], edge_width=SOFT_EDGE)


def rank_launches(steps: int) -> dict:
    """The launches of one rank of several on multihost_run's default items:
    one K1 shard for the image, one hinted K4 (K6) shard a step, and the
    pair's K2 shard and two-row K5 shard."""
    return {"image": {"k1": 1, "k1_shard": 1},
            "kernel_hard": {"k4": steps, "k4_shard": steps, "k4_hinted": steps},
            "kernel_soft": {"k6": steps, "k6_shard": steps, "k6_hinted": steps},
            "pair": {"k1": 1, "k1_shard": 1, "k2": 1, "k5": 1, "k5_shard": 1, "k5_hinted": 1}}


def run_distributed(card: str) -> dict:
    """Phase 15: multihost_run on RANKS ranks at TRAIN, 3 steps, against
    the single process, the gradient items in the production configuration
    (the frozen static hints); checks the launches of every rank. Returns
    the runner's summary."""
    backend = "nccl" if torch.cuda.device_count() >= RANKS else "gloo"
    work = distributed_work()
    items = (*multihost_run.DEFAULT_ITEMS, "inverse_render")
    t0 = time.perf_counter()
    summary = multihost_run.run(RANKS, backend, "cuda", work, items, timeout=600)
    print(json.dumps({"phase": 15, "card": card, "wall_s": time.perf_counter() - t0,
                      "note": ("both ranks share one card: no scaling figure"
                               if backend == "gloo" else "one card per rank"),
                      **{k: v for k, v in summary.items() if k != "work"}}), flush=True)
    assert summary["ok"], summary["items"]
    expect = rank_launches(work.steps)
    for rank, launches in enumerate(summary["launches_per_rank"]):
        for item, want in expect.items():
            assert launches[item] == want, (rank, item, launches[item], want)
        ir = launches["inverse_render"]
        assert (ir.get("k4") == ir.get("k4_shard") == ir.get("k4_hinted") == 60
                and ir.get("k1") == 1), (rank, ir)
    print(f"phase 15 backend={backend}: every rank made one hinted K4 (K6) launch per step on "
          f"its rows; step ms per rank {summary['step_ms_per_rank']}, single process "
          f"{summary['single_step_ms']}", flush=True)
    return summary


def rank_sums(per_rank) -> dict:
    """The launches of a runner's ranks (each a dict of its items'
    counts), summed by key."""
    total = {}
    for rank in per_rank:
        for item in rank.values():
            for key, n in item.items():
                total[key] = total.get(key, 0) + n
    return total


def check_dryrun_kernels(device, lines) -> float:
    """Phase 15b's kernels against their plain versions at the inputs its
    runs give them, launched after the phase's counts are read so that
    they do not count. At the dry run's work (dryrun.multichip_work): K1's
    light under the image item's frozen hints, and from the scene after
    the plain stage's step, K4 at the hard stages' seeds and K6 on the
    soft stage's object and seed, all unhinted as there. At the
    measurement's work (multihost_run.MEASURE): K1's light and K4 against
    the zero target, and each scaling line's kernel_loss, kernel_grad_norm,
    kernel_mean_light and mean_light against the plain version's, within
    multihost_run.TOL (the ranks reassociate the sums). Returns the largest
    absolute error."""
    errs = []
    for label, work in (("dry run", dryrun.multichip_work(MESH_RANKS)[1]),
                        ("measure", multihost_run.MEASURE)):
        scene, camera, frozen, target = multihost_run._setup(work, device)
        cfg, seed = work.cfg(), work.seed()
        at = f"{label} {work.scene} {work.width}x{work.height}x{work.samples}spp x{work.bounces}"
        k1_cfg = frozen if label == "dry run" else cfg
        light = megakernel.render_light_cuda(scene, camera, k1_cfg, seed)
        plain_light = renderer.render_light(scene, camera, megakernel.with_hints(scene, k1_cfg),
                                            seed)
        errs.append(check_close(f"K1 {at}", light, plain_light))
        if label == "measure":
            packed = params.pack(scene, camera)
            plain = gradkernel.loss_and_grad_plain(packed, scene, camera, cfg, seed, target)
            errs.append(compare_grad(f"{at} zero target", gradkernel.loss_and_grad_cuda(
                packed, scene, camera, cfg, seed, target), plain)[0])
            tol, mean = multihost_run.TOL, float(torch.mean(plain_light))
            norm = float(torch.linalg.vector_norm(plain[1][:params.n_scene(scene)]))
            want = {"kernel_loss": (float(plain[0]), tol["loss_rtol"]),
                    "kernel_grad_norm": (norm, tol["grad_mixed_rel"]),
                    "kernel_mean_light": (mean, tol["loss_rtol"]),
                    "mean_light": (mean, tol["loss_rtol"])}
            for line in lines:
                for key, (value, rtol) in want.items():
                    assert abs(line[key] - value) <= rtol * abs(value), \
                        (line["nprocs"], key, line[key], value)
            print(f"{at}: every scaling line's figures within rtol of the plain version's "
                  f"{want}", flush=True)
            continue
        step, init = diff.make_train_step(cfg, work.lr, camera)  # the plain stage
        state, opt = init(scene)
        state = params.map_leaves(torch.Tensor.detach, step(state, opt, 7, target)[0])
        packed = params.pack(state, camera)
        for s in (11, 12):
            errs.append(compare_grad(f"{at} seed {s}", gradkernel.loss_and_grad_cuda(
                packed, state, camera, cfg, s, target), gradkernel.loss_and_grad_plain(
                packed, state, camera, cfg, s, target))[0])
        packed, _, zero_map, alpha, target = soft_inputs(state, camera, cfg, work.soft_ref,
                                                         work.edge_width, target)
        errs.append(compare_soft(f"{at} {work.soft_ref} seed 13",
                                 gradkernel.render_soft_loss_and_grad_cuda(
                                     packed, state, camera, cfg, 13, target, alpha, zero_map),
                                 gradkernel.render_soft_loss_and_grad_plain(
                                     packed, state, camera, cfg, 13, target, alpha, zero_map))[0])
    return max(errs)


def run_mesh_dryrun(device, card: str) -> dict:
    """Phase 15b: dryrun.entry's forward (one K1 launch, bitwise its plain
    version), dryrun.dryrun_multichip(MESH_RANKS) (its own checks against
    one process and of every rank's launches), phase 15's items on a
    MESH_SHAPE mesh at TRAIN against the single process with every rank's
    launches checked, and multihost_run's scaling measurement. Returns the
    launches of every rank and of this process, by key, and prints the
    phase's figures beside the card."""
    t0 = time.perf_counter()
    forward, example = dryrun.entry()
    image = forward(*example)
    torch.cuda.synchronize()
    entry_launches = counts()
    scene, camera, seed = example
    plain = light_to_color(renderer.render_light(scene, camera,
                                                 megakernel.with_hints(scene, dryrun.ENTRY),
                                                 seed), dryrun.ENTRY.light_coefficient)
    assert entry_launches["k1"] == 1 and sum(entry_launches.values()) == 1, entry_launches
    assert torch.equal(image, plain), float((image - plain).abs().max())
    entry_ms = statistics.median(cuda_ms(lambda: forward(*example)))
    reset_counts()
    t1 = time.perf_counter()
    multichip = dryrun.dryrun_multichip(MESH_RANKS)
    t2 = time.perf_counter()
    backend = multihost_run.backend_for("cuda", MESH_RANKS)
    work = distributed_work()
    mesh = multihost_run.run(MESH_RANKS, backend, "cuda", work, timeout=600, mesh=MESH_SHAPE)
    assert mesh["ok"], mesh["items"]
    expect = rank_launches(work.steps)
    for rank, got in enumerate(mesh["launches_per_rank"]):
        assert got == expect, (rank, got, expect)
    t3 = time.perf_counter()
    scaling = multihost_run.scaling(multihost_run.backend_for("cuda", 2), "cuda")
    for line in scaling[:2]:
        # K3: the figure, the warm-up and the timed rounds; K4: the figures.
        k1, shard = 2 + line["frames"], line["nprocs"] > 1
        want = {"k1": k1, "k4": 1, **({"k1_shard": k1, "k4_shard": 1} if shard else {})}
        assert line["launches_per_rank"] == [want] * line["nprocs"], line["launches_per_rank"]
        assert abs(line["kernel_mean_light"] - line["mean_light"]) <= 1e-5 * line["mean_light"]
    t4 = time.perf_counter()
    local = counts()  # the single-process references of the runs above
    kernel_err = check_dryrun_kernels(device, scaling[:2])
    launches = rank_sums(multichip["launches_per_rank"])
    for extra in (rank_sums(mesh["launches_per_rank"]),
                  *(rank_sums({"measure": c} for c in line["launches_per_rank"])
                    for line in scaling[:2]),
                  {"k1": entry_launches["k1"] + local["k1"], "k2": local["k2_rows"],
                   **{k: local[k] for k in ("k4", "k5", "k6", "k4_hinted", "k5_hinted",
                                            "k6_hinted")}}):
        for key, n in extra.items():
            launches[key] = launches.get(key, 0) + n
    print(json.dumps({
        "phase": "15b", "card": card, "wall_s": t4 - t0,
        "entry": {"shape": list(image.shape), "bitwise_plain": True, "ms": entry_ms,
                  "launches": entry_launches},
        "dryrun_multichip": {"s": t2 - t1, "mesh": multichip["mesh"],
                             "backend": multichip["backend"], "items": multichip["items"],
                             "launches_per_rank": multichip["launches_per_rank"]},
        "mesh_items": {"s": t3 - t2, "mesh": mesh["mesh"], "backend": backend,
                       "items": mesh["items"], "step_ms_per_rank": mesh["step_ms_per_rank"],
                       "single_step_ms": mesh["single_step_ms"]},
        "scaling": {"s": t4 - t3, "lines": scaling},
        "kernels_vs_plain_max_abs_err": kernel_err,
        "launches_all_ranks_and_references": launches}), flush=True)
    rates = scaling[2]
    print(f"phase 15b on {card}: {t4 - t0:.1f} s; rays/s 1 rank {rates['rays_per_s_1proc']:.4g} "
          f"(kernel {rates['kernel_rays_per_s_1proc']:.4g}), 2 ranks "
          f"{rates['rays_per_s_2proc']:.4g} (kernel {rates['kernel_rays_per_s_2proc']:.4g}); "
          f"{rates['note']}", flush=True)
    return launches


def check_peak_kernel(device, lib_path) -> float:
    """Phase 16: the SASS of each K7 instantiation's main loop (FFMAs, no
    FMUL/FADD: the -fmad=false trap), then K7 against its plain version at
    PEAK_CHECK_ROUNDS steps on the sweep's grid. Returns the largest
    |K7 - plain| block-sum difference."""
    for n_acc, c in sorted(k7.sass_loop_counts(lib_path).items()):
        print(f"K7 n_acc={n_acc} main loop SASS: FFMA={c['FFMA']} FMUL={c['FMUL']} "
              f"FADD={c['FADD']} (at least {k7.UNROLL * n_acc} FFMAs, no FMUL/FADD)", flush=True)
        assert c["FFMA"] >= k7.UNROLL * n_acc and c["FMUL"] == c["FADD"] == 0, (n_acc, c)
    blocks = vpu_peak.grid_blocks(device)
    worst = 0.0
    for n_acc in k7.N_ACCS:
        out = k7.launch_peak(n_acc, PEAK_CHECK_ROUNDS, vpu_peak.B,
                             torch.empty((blocks,), dtype=torch.float32, device=device))
        plain = k7.peak_plain(n_acc, PEAK_CHECK_ROUNDS, vpu_peak.B, programs=blocks,
                              rows=k7.ROWS_PER_BLOCK, device=device)
        a, b = out.cpu().numpy().astype(np.float64), plain.cpu().numpy().astype(np.float64)
        assert np.isfinite(a).all(), f"K7 n_acc={n_acc}: non-finite block sums"
        err, rel = float(np.abs(a - b).max()), float((np.abs(a - b) / np.abs(b)).max())
        print(f"K7 n_acc={n_acc} rounds={PEAK_CHECK_ROUNDS} blocks={blocks}: max_abs_err={err} "
              f"max_rel_err={rel} bitwise={bool(np.array_equal(a, b))}", flush=True)
        assert rel <= PEAK_RTOL, f"K7 n_acc={n_acc}: block sums off by {rel}"
        worst = max(worst, err)
    return worst


def check_peak_at_sweep(device, peak: dict) -> float:
    """Phase 16, after the sweep: K7 at each n_acc's sweep steps against
    k7.block_sum_plain; the sum at half the steps of the peak's n_acc must
    differ by more than PEAK_RESOLVE x PEAK_RTOL. Returns the largest
    |K7 - plain| block-sum difference."""
    blocks = vpu_peak.grid_blocks(device)
    worst = 0.0
    for n_acc in k7.N_ACCS:
        rounds = vpu_peak.default_rounds(n_acc)
        out = k7.launch_peak(n_acc, rounds, vpu_peak.B,
                             torch.empty((blocks,), dtype=torch.float32, device=device))
        a = out.cpu().numpy().astype(np.float64)
        p = float(k7.block_sum_plain(n_acc, rounds, vpu_peak.B, device))
        err, rel = float(np.abs(a - p).max()), float(np.abs(a - p).max() / abs(p))
        line = (f"K7 n_acc={n_acc} rounds={rounds} (the sweep's) blocks={blocks}: max_abs_err={err} "
                f"max_rel_err={rel} bitwise={bool((a == p).all())}")
        if n_acc == peak["n_acc"]:
            half = rounds // 2 // k7.UNROLL * k7.UNROLL
            resolve = abs(float(k7.block_sum_plain(n_acc, half, vpu_peak.B, device)) - p) / abs(p)
            line += f"; plain at {half} steps off by rel {resolve}"
            assert resolve > PEAK_RESOLVE * PEAK_RTOL, \
                f"K7 n_acc={n_acc}: the check cannot tell {rounds} steps from {half}"
        print(line, flush=True)
        assert np.isfinite(a).all() and rel <= PEAK_RTOL, f"K7 n_acc={n_acc}: {line}"
        worst = max(worst, err)
    return worst


def measure_counts() -> dict:
    """Launches since the last reset_counts of every kernel the
    measurement tools run."""
    return {**counts(), "k1_variant": megakernel.VARIANT_LAUNCHES, "k7": k7.LAUNCHES,
            "k8": ablate.LAUNCHES, "k8_hinted": ablate.HINTED_LAUNCHES}


def check_ablate_kernel(device) -> dict:
    """Phase 17: each K8 mode against its plain version at GRAD_CHECK (the
    GRAD_SCENES, 1 and 3 views, a seeded random target); loss and vjp against
    K4's loss from the same inputs too. Returns the largest absolute and
    relative errors against the plain version, by mode."""
    cfg = RenderConfig(**GRAD_CHECK)
    seed = 0x2468ACE1
    errs = {m: [0.0, 0.0] for m in ablate.MODES}
    for name in GRAD_SCENES:
        scene = library.SCENES[name](device)
        for views in (("yxz",), cam.VIEWS_ALL):
            label = f"K8 {name} views={len(views)}"
            camera = camera_for(views, device)
            packed, lay = params.pack(scene, camera), params.layout(scene, camera)
            target = torch.from_numpy(np.random.default_rng(6).uniform(
                0, 1, (*image_shape(views, cfg), 3)).astype(np.float32)).to(device)
            values = {}
            for mode in ablate.MODES:
                k = float(ablate.launch_variant(mode, packed, lay, cfg, seed, target))
                p = float(ablate.variant_plain(mode, scene, camera, cfg, seed, target))
                rel = abs(k - p) / abs(p)
                print(f"{label} {mode}: kernel={k} plain={p} rel={rel:.3g}", flush=True)
                assert rel <= (ACC_RTOL if mode == "acc" else GRAD_BOUNDS["loss_rtol"]), label
                values[mode] = k
                errs[mode] = [max(errs[mode][0], abs(k - p)), max(errs[mode][1], rel)]
            assert values["vjp"] == values["loss"], f"{label}: vjp changed the loss"
            # Under the freeze_hints contract, as the JAX tool runs them:
            # bitwise the unhinted variants, and so is K4's hinted loss.
            hcfg, keep, _ = frozen_setup(scene, camera, cfg)
            for mode in ablate.MODES:
                h = ablate.launch_variant(mode, packed, lay, hcfg, seed, target)
                check_contract(f"K8 {name} views={len(views)} {mode}", h.reshape(1),
                               torch.tensor([values[mode]], device=device),
                               torch.zeros(0, dtype=torch.bool, device=device))
            hinted_k4 = gradkernel.launch_loss_grad(packed, lay, hcfg,
                                                    megakernel.seed_tensor([seed], device),
                                                    target, keep=keep)[0]
            k4 = float(gradkernel.launch_loss_grad(packed, lay, cfg,
                                                   megakernel.seed_tensor([seed], device),
                                                   target)[0])
            assert float(hinted_k4) == k4, f"{label}: K4's hinted loss is not the unhinted one"
            scaled = float(np.float32(values["loss"])
                           * np.float32(1.0 / (lay.n_views * cfg.height * cfg.width * 3)))
            print(f"{label} loss * scale={scaled} K4 loss={k4} rel={abs(scaled - k4) / k4:.3g} "
                  f"bitwise={scaled == k4}", flush=True)
            assert abs(scaled - k4) <= GRAD_BOUNDS["loss_rtol"] * abs(k4), label
    return errs


def check_ablate_modes(device) -> dict:
    """Phase 17: K8 over K1's other configurations at GRAD_CHECK, one view,
    on every GRAD_MODE_SCENES scene in each GRAD_MODES configuration (the
    cells-only hypercube in the production one too) and ABLATE_SEQUENTIAL on
    the room, from zeroed counts. Each mode against its plain version (acc
    within ACC_RTOL, loss and vjp within the loss bound), bitwise across two
    launches and, under diff.with_frozen_hints, bitwise the unhinted launch
    (the fast fold's hints; the literal folds have none); acc the float64
    sum of K1's light (times the samples: exact at 4) in the same
    configuration and seed rounded to float32, which only that
    configuration's instances give; vjp bitwise loss; a sequential
    configuration's values bitwise its per-sample launch's (the JAX kernel
    draws per-sample streams). ablate.CONFIG_LAUNCHES must show every
    configuration key. Returns the worst errors by mode, the launches by
    configuration and the checks made."""
    reset_counts()
    seed = 0x2468ACE1
    camera = camera_for(("yxz",), device)
    errs = {m: [0.0, 0.0] for m in ablate.MODES}
    k1_rel, checked = 0.0, {}
    cases = [(name, mode) for name in GRAD_MODE_SCENES
             for mode in list(GRAD_MODES.values()) + ([{}] if name == "hypercube_cells" else [])]
    cases += [("room_with_sphere", mode) for mode in ABLATE_SEQUENTIAL]
    for name, mode in cases:
        scene = modes_scene(name, device)
        packed, lay = params.pack(scene, camera), params.layout(scene, camera)
        cfg = RenderConfig(**dict(GRAD_CHECK, **mode))
        key = megakernel.launch_config(cfg, lay)
        label = f"K8 modes {name} {key}"
        target = torch.from_numpy(np.random.default_rng(6).uniform(
            0, 1, (cfg.height, cfg.width, 3)).astype(np.float32)).to(device)
        hcfg = diff.with_frozen_hints(cfg, scene)
        values = {}
        for m in ablate.MODES:
            k = ablate.launch_variant(m, packed, lay, cfg, seed, target)
            assert torch.equal(k, ablate.launch_variant(m, packed, lay, cfg, seed, target)), \
                f"{label} {m}: launches differ"
            h = ablate.launch_variant(m, packed, lay, hcfg, seed, target)
            if megakernel.hinted(hcfg):
                check_contract(f"{label} {m}", h.reshape(1), k.reshape(1),
                               torch.zeros(0, dtype=torch.bool, device=device))
            else:
                assert torch.equal(h, k), f"{label} {m}: with_frozen_hints changed the value"
            values[m] = float(k)
            if m == "vjp":
                assert values["vjp"] == values["loss"], f"{label}: vjp changed the loss"
                continue
            p = float(ablate.variant_plain(m, scene, camera, cfg, seed, target))
            rel = abs(values[m] - p) / abs(p)
            print(f"{label} {m}: kernel={values[m]} plain={p} rel={rel:.3g}", flush=True)
            assert rel <= (ACC_RTOL if m == "acc" else GRAD_BOUNDS["loss_rtol"]), (label, m)
            for mm in ((m, "vjp") if m == "loss" else (m,)):
                errs[mm] = [max(errs[mm][0], abs(values[m] - p)), max(errs[mm][1], rel)]
        per_sample = ablate.per_sample(cfg)
        light = megakernel.launch_forward(packed, lay, per_sample,
                                          megakernel.seed_tensor([seed], device))[0]
        light = light * torch.tensor(float(cfg.samples), device=device)
        k1 = float((light[..., 0] + light[..., 1] + light[..., 2]).double().sum())
        rel = abs(values["acc"] - k1) / abs(k1)
        k1_rel = max(k1_rel, rel)
        print(f"{label} acc={values['acc']} K1's light sum={k1} rel={rel:.3g}", flush=True)
        assert values["acc"] == float(np.float32(k1)), (label, values["acc"], k1)
        if cfg.rng_mode == "sequential":
            for m in ablate.MODES:
                assert values[m] == float(ablate.launch_variant(m, packed, lay, per_sample, seed,
                                                                target)), (label, m)
            print(f"{label}: every mode bitwise the per-sample launch's", flush=True)
        checked[key] = checked.get(key, 0) + 1
    launches = dict(ablate.CONFIG_LAUNCHES)
    keys = {megakernel.launch_config(ablate.per_sample(RenderConfig(**dict(GRAD_CHECK, **mode))),
                                     params.layout(modes_scene(name, device), camera))
            for name, mode in cases}
    print(json.dumps({"phase": "17 K8 modes", "launches_by_config": launches}), flush=True)
    assert set(launches) == keys and not any(k.startswith("sequential") for k in launches), \
        (launches, keys)
    return {"errs": errs, "k1_max_rel": k1_rel, "launches": launches, "checked": checked,
            "launches_total": ablate.LAUNCHES}


def time_ablate_modes(device, card: str) -> dict:
    """Phase 17 at TRAIN (1 frame, one view, the room, with_frozen_hints):
    through grad_ablate.build, the tool's entry point, from zeroed counts,
    K8's acc, loss and vjp and K4 in the production configuration and in
    each GRAD_MODES one (seeds as the tool's: one warm-up, then
    ABLATE_ROUNDS rounds of ABLATE_CALLS calls, the median round), each K8
    mode held once against its plain version (timed once, whole image) and
    its bound (kernel_bounds' count over the plain version's flops); K4's
    bound (mode_bound). K4 - vjp is the sweep and the parameter reduction,
    its share of K4 the sweep's. Returns, by configuration, the times,
    bounds and launches."""
    scene, camera, _, target = grad_ablate.workload(device)
    packed, lay = params.pack(scene, camera), params.layout(scene, camera)
    pixels, p = TRAIN["height"] * TRAIN["width"], lay.size
    rows, scale = (0, BOUND_ROWS), TRAIN["height"] / BOUND_ROWS
    block = torch.zeros((BOUND_ROWS, TRAIN["width"], 3), device=device)
    configs = {"per_sample/poly/fast": {}, **GRAD_MODES}
    reset_counts()
    out = {}
    for key, mode in configs.items():
        cfg = diff.with_frozen_hints(RenderConfig(**TRAIN, **mode), scene)
        cell = {}
        for variant in grad_ablate.TIMED:
            fn = grad_ablate.build(scene, camera, cfg, target, variant)
            value, times = tool_common.time_seeded(fn, device, ABLATE_CALLS, ABLATE_ROUNDS)
            cell[variant] = {"ms": statistics.median(times), "ms_rounds": times,
                             "value": float(value)}
        for m in ablate.MODES:
            got = []
            plain_ms = cuda_ms(lambda m=m: got.append(ablate.variant_plain(
                m, scene, camera, cfg, 1, target)), calls=1, repeats=1)[0]
            k, pv = cell[m]["value"], float(got[0])
            rel = abs(k - pv) / max(abs(pv), 1e-30)
            assert rel <= (ACC_RTOL if m == "acc" else GRAD_BOUNDS["loss_rtol"]), (key, m, k, pv)
            flops = count_flops(ablate.variant_plain, m, scene, camera, cfg, 1, block, rows)[1]
            cell[m].update(plain_ms=plain_ms, rel_err=rel,
                           **bound(flops * scale, 4 * (p + 1 + (0 if m == "acc" else pixels * 3))))
        cell["k4"].update(mode_bound("k4", scene, camera, cfg, packed, lay))
        sweep = cell["k4"]["ms"] - cell["vjp"]["ms"]
        cell["split_ms"] = {"pass1": cell["acc"]["ms"],
                            "tone_map_loss": cell["loss"]["ms"] - cell["acc"]["ms"],
                            "cotangent": cell["vjp"]["ms"] - cell["loss"]["ms"],
                            "sweep_reduction": sweep}
        cell["sweep_share_of_k4"] = sweep / cell["k4"]["ms"]
        out[key] = cell
        print(json.dumps({"phase": "17 K8 by configuration", "card": card, "config": key,
                          "shape": "room_with_sphere 1280x720 8spp 4 bounces, 1 frame, zero "
                                   "target, with_frozen_hints", **cell}), flush=True)
    launches = {"k8": dict(ablate.CONFIG_LAUNCHES), "k4": dict(gradkernel.CONFIG_LAUNCHES),
                "counts": measure_counts()}
    n = 1 + ABLATE_CALLS * ABLATE_ROUNDS
    expect = {"k8": {k: 3 * n for k in configs}, "k4": {k: n for k in configs}}
    assert {k: launches[k] for k in expect} == expect, (launches, expect)
    return {"timed": out, "launches": launches}


def check_forward_variants(device, cfg: RenderConfig, scenes) -> float:
    """Phase 17: K1 with each stub variant compiled in, with the static
    hints fwd_ablate derives, against the plain pipeline under the same
    patches and hints, through fwd_ablate's own functions (fwd_ablate.fpl()
    frames a launch, the tool's camera, seed 1); each variant's light
    differs from K1's. The generic_fold variant (the fold's generic
    instance) and the unhinted launch must give K1's light, bitwise.
    Returns the largest |kernel - plain|."""
    worst = 0.0
    for name in scenes:
        scene, camera = library.SCENES[name](device), tool_common.default_camera(device)
        hinted = megakernel.with_hints(scene, cfg)
        base = fwd_ablate.build_fn(scene, camera, hinted)(1)
        for variant in (*megakernel.VARIANTS, megakernel.GENERIC_FOLD):
            out = fwd_ablate.build_fn(scene, camera, hinted, variant)(1)
            plain = fwd_ablate.plain_fn(scene, camera, hinted, variant)(1)
            label = f"K1 {variant} {name} {cfg.width}x{cfg.height} {fwd_ablate.fpl()} frames"
            worst = max(worst, check_close(label, out, plain))
            if variant == megakernel.GENERIC_FOLD:
                assert torch.equal(out, base), f"{name}: the generic fold differs from K1"
            else:
                assert not torch.equal(out, base), f"{variant}: the stubs changed nothing"
        out = fwd_ablate.build_fn(scene, camera, cfg)(1)
        assert torch.equal(out, base), f"{name}: the unhinted K1 differs from the hinted"
    return worst


def check_ablate_at_tool_shape(device, values: dict) -> dict:
    """Phase 17: the K8 values grad_ablate printed (seed 1, its shape,
    scene, camera and zero target) against the plain version on the same
    inputs, each plain mode timed once; K4's value against loss x scale.
    Returns {"errs": {mode: (abs, rel)}, "plain_ms": {mode: ms}}."""
    scene, camera, cfg, target = grad_ablate.workload(device)
    errs, plain_ms = {}, {}
    for mode in ablate.MODES:
        got = []
        plain_ms[mode] = cuda_ms(lambda: got.append(ablate.variant_plain(
            mode, scene, camera, cfg, 1, target)), calls=1, repeats=1)[0]
        p, k = float(got[0]), values[mode]
        rel = abs(k - p) / abs(p)
        print(f"K8 {mode} at grad_ablate's {cfg.width}x{cfg.height}x{cfg.samples}spp "
              f"x{cfg.reflections_amount}, seed 1: kernel={k} plain={p} rel={rel:.3g} "
              f"plain_ms={plain_ms[mode]}", flush=True)
        assert rel <= (ACC_RTOL if mode == "acc" else GRAD_BOUNDS["loss_rtol"]), (mode, k, p)
        errs[mode] = (abs(k - p), rel)
    scaled = float(np.float32(values["loss"]) * np.float32(1.0 / target.numel()))
    print(f"K8 loss * scale={scaled} K4 loss={values['k4']} bitwise={scaled == values['k4']}",
          flush=True)
    assert abs(scaled - values["k4"]) <= GRAD_BOUNDS["loss_rtol"] * abs(values["k4"])
    return {"errs": errs, "plain_ms": plain_ms}


def time_ablate_unhinted(device) -> dict:
    """Phase 17: each K8 mode at grad_ablate's shape, inputs and seeds
    without the hints, beside the tool's hinted times: ms per launch by
    mode (timing runs, after the tool's counts are read)."""
    scene, camera, hcfg, target = grad_ablate.workload(device)
    cfg = replace(hcfg, freeze_hints=False, plane_hints=None, plane_pairs=None, axis_hints=None)
    packed, lay = params.pack(scene, camera), params.layout(scene, camera)
    seeds = iter(range(2, 1000))
    return {mode: statistics.median(cuda_ms(lambda m=mode: ablate.launch_variant(
        m, packed, lay, cfg, next(seeds), target), calls=4, repeats=3))
        for mode in ablate.MODES}


def run_tools(device) -> dict:
    """Phase 17: the four attribution tools at 1280x720x8spp x4 bounces,
    each from zeroed counts, every tool's launches checked against the
    variants it times (each variant: one warm-up call, then rounds x calls
    timed calls). Returns their results and launches."""
    res, launches = {}, {}

    def ran(tool, expect):
        got = measure_counts()
        launches[tool] = got
        want = {k: 0 for k in got} | expect
        print(json.dumps({"tool": tool, "launches": got}), flush=True)
        assert got == want, (tool, got, want)

    # The training tools run the frozen static hints, as the JAX tools do:
    # every launch of K4-K6 and K8 hinted.
    reset_counts()
    res["grad_ablate"] = grad_ablate.run(device)
    n = 1 + 4 * 3  # its defaults: 4 calls x 3 rounds
    ran("grad_ablate", {"k8": 3 * n, "k4": n, "k8_hinted": 3 * n, "k4_hinted": n})

    rounds, calls = TOOL_ROUNDS["train_ablate"]
    reset_counts()
    res["train_ablate"] = train_ablate.run(device, calls=calls, rounds=rounds)
    n = 1 + rounds * calls
    scan = (1 + rounds * max(1, calls // train_ablate.SCAN)) * train_ablate.SCAN
    # fwd: K1; pass1: K8; kernel, loss_grad, vg, step: K4; scan4: SCAN K4 a call
    ran("train_ablate", {"k1": n, "k8": n, "k4": 4 * n + scan, "k8_hinted": n,
                         "k4_hinted": 4 * n + scan})

    rounds, calls = TOOL_ROUNDS["soft_ablate"]
    reset_counts()
    res["soft_ablate"] = soft_ablate.run(device, calls=calls, rounds=rounds)
    n = 1 + rounds * calls
    # fwd_pair (+ the premade rows' launch), pair_vg and pair_soft: K2;
    # pair_vg and pair_soft: two-row K5; soft_full: K6; glue_only: none
    ran("soft_ablate", {"k1": 3 * n + 1, "k2_rows": 3 * n + 1, "k5": 2 * n, "k6": n,
                        "k5_hinted": 2 * n, "k6_hinted": n})

    rounds, calls = TOOL_ROUNDS["fwd_ablate"]
    reset_counts()
    res["fwd_ablate"] = fwd_ablate.run(device, calls=calls, rounds=rounds)
    n = 1 + rounds * calls
    names = [v[0] for v in fwd_ablate.variants(library.room_with_sphere(device),
                                               RenderConfig(**HEADLINE))]
    variant = len(megakernel.VARIANTS) + 1  # the stubs and generic_fold: the variant launch
    ran("fwd_ablate", {"k1": (len(names) - variant) * n, "k1_variant": variant * n})
    return {"results": res, "launches": launches}


def with_shares(entry: dict) -> dict:
    """The entry with its achieved fp32 rate's share of the published and
    of the measured peak, and its bound at the measured peak."""
    rate = entry["flops"] / (entry["ms"] * 1e-3)
    measured = PEAKS["measured_fp32_flops_per_s"]
    entry["share_of_published_peak"] = rate / PEAKS["fp32_flops_per_s"]
    entry["share_of_measured_peak"] = rate / measured
    entry["bound_ms_at_measured_peak"] = max(entry["flops"] / measured,
                                             entry["bytes"] / PEAKS["bytes_per_s"]) * 1e3
    return entry


# The folds of the gradient kernels' instances (csrc/gradkernel.cu), as
# their mangled names spell them: without hints (ParamsFold, the key's
# plain name), and under the freeze_hints contract the room's 4 wall pairs
# (RoomFold, "_room": the production main path's) and any other pattern
# (AnyFold, "_any").
GRAD_FOLDS = {"": "NS_10ParamsFoldE", "_room": "NS_13GradTableFoldILi4ELi0EEE",
              "_any": "NS_13GradTableFoldILin1ELin1EEE"}


def grad_resources(log: str) -> dict:
    """Prints every kernel's registers, stack frame and spill stores from
    the build log; returns those of the gradient launches' kernels, keyed as
    grad_patterns. Fails if an instance K4 runs on a main path spills."""
    res = build.kernel_resources(log)
    for name, r in sorted(res.items()):
        if r:
            print(f"  {name}: {r}", flush=True)
    out = {}
    for k, pattern in grad_patterns().items():
        hits = [r for n, r in res.items() if pattern in n]
        assert len(hits) == 1, (k, hits)
        out[k] = hits[0]
    k4_main = ("sweep", "loss_cot", "sweep_room", "loss_cot_room", "sweep_any")
    assert all(out[k]["spill_bytes"] == 0 for k in k4_main), \
        f"K4's kernels spill: {[(k, out[k]) for k in k4_main]}"
    return out


# The folds of the modes sources' instances (the gradient kernels over
# Modes<Fold>), as their mangled names spell them.
MODE_FOLDS = {"spec": "8SpecFoldILb0EE", "trig": "8SpecFoldILb1EE",
              "cells": "GradCompositeFoldILin1ELin1ELin1ELin1ELin2EE",
              "composite": "GradCompositeFoldILin1ELin1ELin1ELin1ELin1EE",
              "table": "13GradTableFoldILin1ELin1EE"}


def modes_resources(log: str) -> dict:
    """Registers, stack frame and spill stores of the modes instances
    (each kernel of GRAD_KERNELS over Modes of each MODE_FOLDS fold, at
    kMaxBounces), by kernel and fold; prints them."""
    res = build.kernel_resources(log)
    out = {}
    for key, name in GRAD_KERNELS.items():
        for fold, pattern in MODE_FOLDS.items():
            hits = [r for n, r in res.items()
                    if f"{len(name)}{name}I" in n and "5ModesI" in n and pattern in n]
            assert len(hits) == 1, (key, fold, hits)
            out.setdefault(key, {})[fold] = hits[0]
    print(json.dumps({"modes_instances": out}), flush=True)
    return out


def ablate_modes_resources(log: str) -> dict:
    """Registers, stack frame and spill stores of K8's modes instances
    (ablate_kernel of each mode over Modes of each MODE_FOLDS fold), by mode
    and fold; prints them."""
    res = build.kernel_resources(log)
    out = {}
    for code, mode in enumerate(ablate.MODES):
        for fold, pattern in MODE_FOLDS.items():
            hits = [r for n, r in res.items()
                    if f"13ablate_kernelILi{code}EN" in n and "5ModesI" in n and pattern in n]
            assert len(hits) == 1, (mode, fold, hits)
            out.setdefault(mode, {})[fold] = hits[0]
    print(json.dumps({"k8_modes_instances": out}), flush=True)
    return out


def grad_patterns() -> dict:
    """A part of the mangled name of each gradient launch kernel's
    instance: per kernel of GRAD_KERNELS and fold of GRAD_FOLDS, a sweep's
    main-path instance (MAIN_BOUNCES; the key and the fold's suffix) and
    its generic one (suffix "_generic"; RoomFold has none: other bounce
    counts take AnyFold), and each pass-1 kernel's."""
    out = {}
    for key, name in GRAD_KERNELS.items():
        mangled = f"{len(name)}{name}"
        for suffix, fold in GRAD_FOLDS.items():
            if key not in SWEEPS:
                out[key + suffix] = f"{mangled}I{fold}"
                continue
            out[key + suffix] = f"{mangled}ILi{gradkernel.MAIN_BOUNCES}E{fold}"
            if suffix != "_room":
                out[key + suffix + "_generic"] = f"{mangled}ILi{gradkernel.MAX_BOUNCES}E{fold}"
    return out


def resident_warps(lib_path: Path, device) -> dict:
    """Resident warps per SM of the gradient launches' kernels (their
    main-path instances, unhinted and hinted) at the training shape (room,
    one view): build.resident_warps at each launch's block and shared
    memory, the hinted instances' with the room's fold table. Prints
    them."""
    scene, camera = library.room_with_sphere(device), camera_for(("yxz",), device)
    assert TRAIN["reflections_amount"] == gradkernel.MAIN_BOUNCES, TRAIN
    lay = params.layout(scene, camera)
    shapes = {"": gradkernel.launch_shapes(lay),
              "_hinted": gradkernel.launch_shapes(
                  lay, diff.with_frozen_hints(RenderConfig(**TRAIN), scene))}
    patterns = {k: p for k, p in grad_patterns().items() if not k.endswith("_generic")}

    def shape_of(key):
        base = next(k for k in GRAD_KERNELS if key == k or key.startswith(k + "_"))
        return shapes["" if key == base else "_hinted"][GRAD_KERNELS[base]]

    warps = build.resident_warps(lib_path, {re.escape(p): shape_of(k)
                                            for k, p in patterns.items()})
    out = {}
    for key, pattern in patterns.items():
        hits = [w for n, w in warps.items() if pattern in n]
        assert len(hits) == 1 and hits[0] > 0, (key, warps)
        out[key] = hits[0]
    print(json.dumps({"resident_warps_per_sm_at_train_shape": out,
                      "smem_bytes": {k: {n: v[1] for n, v in sh.items()}
                                     for k, sh in shapes.items()}}), flush=True)
    return out


# The composite folds of K4, K5, K6 and K8 (csrc/reduce.cuh) as their mangled
# names spell them, with the scene and views whose launch at TRAIN (under
# the frozen hints; the generic one unhinted, as every composite scene
# without hints takes it) sets each one's shared memory.
COMPOSITE_FOLDS = {"generic": ("17GradCompositeFoldILin1ELin1ELin1E", "tiger", ("yxz",)),
                   "duocylinder": ("17GradCompositeFoldILin1ELin1ELi2E", "duocylinder", ("yxz",)),
                   "tiger": ("17GradCompositeFoldILin1ELin1ELi8E", "tiger", ("yxz",)),
                   "hypercube": ("17GradCompositeFoldILin1ELin1ELi4E", "hypercube", ("yxz",)),
                   "hypercube_3view": ("17GradCompositeFoldILin1ELin1ELi4E", "hypercube",
                                       cam.VIEWS_ALL)}


def composite_resources(lib_path: Path, device) -> dict:
    """Phase 2 on the composite folds: the registers, stack frame and spill
    stores of each instance of K4's pass 1, the K4/K5 sweep, K6's pass 1
    and its row-a and row-b sweeps (the unrolled instances and, for the
    generic fold, the rolled ones) and K8's modes, and
    the resident warps per SM each reaches at its scene's launch
    (COMPOSITE_FOLDS; the hypercube's 3-view launch, P = 288, beside its
    1-view one). Prints them."""
    res = build.kernel_resources(build.build_log())
    main_b, max_b = gradkernel.MAIN_BOUNCES, gradkernel.MAX_BOUNCES
    kernels = {"sweep": f"12sweep_kernelILi{main_b}E", "sweep_generic": f"12sweep_kernelILi{max_b}E",
               "loss_cot": "15loss_cot_kernelI", "k8": "13ablate_kernelILi2E",
               "soft_sum": "15soft_sum_kernelI", "soft_row_a": f"17soft_row_a_kernelILi{main_b}E",
               "soft_row_a_generic": f"17soft_row_a_kernelILi{max_b}E",
               "soft_row_b": f"17soft_row_b_kernelILi{main_b}E",
               "soft_row_b_generic": f"17soft_row_b_kernelILi{max_b}E"}
    cfg = RenderConfig(**TRAIN)
    out = {}
    for fold, (mangled, name, views) in COMPOSITE_FOLDS.items():
        scene, camera = library.SCENES[name](device), camera_for(views, device)
        lay = params.layout(scene, camera)
        shapes = gradkernel.launch_shapes(lay, cfg if fold == "generic"
                                          else diff.with_frozen_hints(cfg, scene))
        launch = {"sweep": shapes["sweep_kernel"], "sweep_generic": shapes["sweep_kernel"],
                  "loss_cot": shapes["loss_cot_kernel"], "k8": shapes["loss_cot_kernel"],
                  "soft_sum": shapes["soft_sum_kernel"], "soft_row_a": shapes["soft_row_a_kernel"],
                  "soft_row_a_generic": shapes["soft_row_a_kernel"],
                  "soft_row_b": shapes["soft_row_b_kernel"],
                  "soft_row_b_generic": shapes["soft_row_b_kernel"]}
        patterns = {k: f"{p}NS_{mangled}" for k, p in kernels.items()}
        warps = build.resident_warps(lib_path, {re.escape(p): launch[k]
                                                for k, p in patterns.items()})
        entry = {"P": lay.size, "smem_bytes": {k: v[1] for k, v in launch.items()}}
        for k, pattern in patterns.items():
            hits = [n for n in res if pattern in n]
            if not hits:  # the library instances run at the main bounce count only
                continue
            assert len(hits) == 1, (fold, k, hits)
            entry[k] = {**res[hits[0]], "resident_warps_per_sm": warps.get(hits[0])}
        out[fold] = entry
    print(json.dumps({"composite_grad_instances": out}), flush=True)
    return out


def kernel_resources(key: str, resources: dict, warps: dict) -> dict:
    """A gradient launch's summary keys from the build and the occupancy
    query: its main sweep's production instance's (RoomFold: the frozen
    hints on the room at the main bounce count) registers, stack and spill
    bytes and resident warps per SM; every instance of that sweep (the
    unhinted ParamsFold ones, AnyFold's), and the production instances of
    the launch's pass-1 kernel and other sweep."""
    sweep_key = MAIN_SWEEP[key]
    sweep = resources[sweep_key + "_room"]
    out = {"kernels": [GRAD_KERNELS[k] for k in GRAD_LAUNCHES[key]],
           "instance": "GradTableFold<4, 0> (the room's wall pairs, the frozen hints)",
           "registers": sweep["registers"], "stack_bytes": sweep["stack_bytes"],
           "spill_bytes": sweep["spill_bytes"],
           "resident_warps_per_sm": warps[sweep_key + "_room"],
           "instances": {sweep_key + s: {**resources[sweep_key + s],
                                         "resident_warps_per_sm": warps.get(sweep_key + s)}
                         for s in ("", "_generic", "_room", "_any", "_any_generic")}}
    for kernel in (k for k in GRAD_LAUNCHES[key] if k != sweep_key):
        part = "other_sweep" if kernel in SWEEPS else "pass1"
        out[part] = {"kernel": GRAD_KERNELS[kernel], **resources[kernel + "_room"],
                     "resident_warps_per_sm": warps[kernel + "_room"],
                     "unhinted": {**resources[kernel], "resident_warps_per_sm": warps[kernel]}}
    return out


def main() -> int:
    phase("1 device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = smi_line()
    print(f"device={kind} count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda} nvidia-smi: {card}", flush=True)

    phase("2 build")
    t0 = time.perf_counter()
    lib_path = build.build()
    build_s = time.perf_counter() - t0
    build.load()
    print(f"built {lib_path.relative_to(ROOT)} in {build_s:.2f} s", flush=True)
    resources = grad_resources(build.build_log())
    warps = resident_warps(lib_path, device)
    k1_res = k1_resources(device, lib_path)
    comp_res = composite_resources(lib_path, device)
    mode_res = modes_resources(build.build_log())
    ablate_res = ablate_modes_resources(build.build_log())

    phase("3 kernel vs plain on the card")
    max_err = check_kernel_against_plain(device)

    phase("4 main path: RenderEngine -> kernel, headline shape")
    reset_counts()
    engine, engine_ms = main_path(device)
    phase("5 app")
    run_app()
    launches = {"render": (megakernel.LAUNCHES, gradkernel.LAUNCHES)}
    assert launches["render"] == (1 + CALLS * REPEATS + 2, 0), launches
    assert megakernel.HINTED_LAUNCHES == megakernel.LAUNCHES, "a render launch ran no hints"
    assert counts()["k2_rows"] == counts()["k5"] == counts()["k6"] == 0, counts()

    phase("5b live session: app --interactive --serve on the config, engine and train-state "
          "resume at the headline shape")
    reset_counts()
    live = live_session()
    print(f"5b precompile in the session {live['precompile_warm_s']:.3f} s (warm: phase 5 loaded "
          f"its kernel instance), live session {live['frames']} frames in "
          f"{live['session_s']:.3f} s = {live['session_fps']:.2f} fps (paced at max_fps; "
          f"rendering alone {live['render_fps']:.2f} fps) on {card}", flush=True)
    live["engine_resume"] = engine_resume(device)
    live["train_resume"] = train_resume(device)
    launches["live"] = counts()
    first_loss = live["train_resume"].pop("first_loss")
    live["train_resume"]["checked"] = check_train_resume_kernels(
        device, live["train_resume"].pop("argv"), first_loss)
    fresh = live["fresh_process"] = first_frame_fresh()
    print(f"5b time to the first frame of a fresh process {fresh['first_frame_s']:.3f} s "
          f"(imports {fresh['import_s']:.3f} s, engine {fresh['engine_s']:.3f} s, precompile "
          f"{fresh['precompile_s']:.3f} s, first frame {fresh['frame_s']:.3f} s) on {card}",
          flush=True)
    n_resume = 2 + 1 + 1  # the uninterrupted engine's two launches, the saved and the resumed
    k_ckpt = inverse_render.CKPT_EVERY
    assert launches["live"]["k1"] == live["k1_launches"] + n_resume + 2, launches["live"]
    assert launches["live"]["k4"] == launches["live"]["k4_hinted"] == 2 * k_ckpt + 2, \
        launches["live"]
    assert megakernel.HINTED_LAUNCHES == megakernel.LAUNCHES, "a 5b launch ran no hints"
    print(json.dumps({"phase": "5b", "card": card, **live, "launches": launches["live"]}),
          flush=True)

    phase("6 kernel alone and plain pipeline, headline shape")
    kernel_ms, unhinted_ms, plain_ms, headline_err = time_kernel_and_plain(engine)
    phase("7 app view groups: kernel vs plain on the card")
    max_err = max(max_err, headline_err, check_app_groups(device))
    rays = HEADLINE["width"] * HEADLINE["height"] * HEADLINE["samples"] * FRAMES_PER_LAUNCH
    med_engine, med_kernel = statistics.median(engine_ms), statistics.median(kernel_ms)
    print(json.dumps({
        "cell": "room_with_sphere 1280x720 8spp 4 bounces per_sample, 4 frames per launch",
        "card": card, "rays_per_launch": rays, "hints": "4 wall pairs, the engine's",
        "engine_step_frames_ms": engine_ms, "engine_ms_median": med_engine,
        "engine_mrays_per_s": rays / med_engine / 1e3,
        "kernel_ms": kernel_ms, "kernel_ms_median": med_kernel,
        "kernel_mrays_per_s": rays / med_kernel / 1e3,
        "unhinted_kernel_ms": unhinted_ms,
        "unhinted_kernel_ms_median": statistics.median(unhinted_ms),
        "plain_ms": plain_ms, "plain_mrays_per_s": rays / plain_ms / 1e3,
    }), flush=True)

    phase("7b composite cells: the engine and K1 at 1280x720x8spp x4, 4 frames a launch")
    cells = composite_cells(device)
    launches["composite"] = sum(c["engine_launches"] for c in cells.values())
    max_err = max(max_err, max(c["max_abs_err"] for c in cells.values()))

    phase("7c K1's other configurations: the engine in RenderConfig()'s modes and the "
          "oracle's, K1 by configuration at 1280x720x8spp x4, every configuration vs plain")
    modes_main = modes_engine(device)
    launches["modes"] = sum(d["launches"] for d in modes_main.values())
    mode_configs = {d["config"]: d["launches"] for d in modes_main.values()}
    mode_cells = modes_timed(device)
    mode_checks = check_modes(device)
    max_err = max(max_err, mode_checks["max_abs_err"],
                  max(c["max_abs_err"] for cell in mode_cells.values() for c in cell.values()))

    phase("8 value-and-grad kernel vs plain on the card")
    grad_err, grad_rel = check_grad_kernel(device)
    comp_err, comp_rel = check_composite_k4(device)
    grad_err, grad_rel = max(grad_err, comp_err), max(grad_rel, comp_rel)
    split_err, split_rel, splits = check_split_k4(device)
    print(json.dumps({"phase": "8", "split_check": SPLIT_CHECK, "frames": SPLIT_FRAMES,
                      "splits": splits, "max_abs_err": split_err,
                      "max_grad_mixed_rel": split_rel}), flush=True)
    grad_err, grad_rel = max(grad_err, split_err), max(grad_rel, split_rel)
    k4 = time_grad_kernel(device)
    inverse_cells = inverse_step_cells(device)
    light_err, ir_err, ir_rel = check_inverse_render_shapes(device)
    max_err = max(max_err, light_err)
    grad_err, grad_rel = max(grad_err, k4["err"], ir_err), max(grad_rel, k4["rel"], ir_rel)

    phase("8c gradient kernels by configuration: K4, K5 and K6 over K1's other "
          "configurations, every scene vs plain at 256x144; the packed and soft steps and the "
          "kernels at 1280x720")
    t_8c = time.perf_counter()
    grad_mode_checks = check_grad_modes(device)
    grad_mode_main = grad_modes_main(device, card)
    mode_launches = grad_mode_main["launches"]
    # The worst errors of phase 8c by kernel, at 256x144 and at TRAIN.
    mode_errs = {k: (max(grad_mode_checks["max_abs_err"][k], grad_mode_main["max_abs_err"][k]),
                     max(grad_mode_checks["max_grad_mixed_rel"][k],
                         grad_mode_main["max_grad_mixed_rel"][k]))
                 for k in ("k4", "k5", "k6")}
    print(json.dumps({"phase": "8c", "card": card, "seconds": time.perf_counter() - t_8c,
                      "max_abs_err": {k: e for k, (e, _) in mode_errs.items()},
                      "max_grad_mixed_rel": {k: r for k, (_, r) in mode_errs.items()},
                      "checked": grad_mode_checks["checked"],
                      **{k: v for k, v in grad_mode_main.items()
                         if k not in ("launches", "max_abs_err", "max_grad_mixed_rel")}}),
          flush=True)
    grad_err, grad_rel = max(grad_err, mode_errs["k4"][0]), max(grad_rel, mode_errs["k4"][1])

    phase("9 training main path: packed Adam step -> K4, 1280x720")
    reset_counts()
    train_ms = {f: train_main_path(device, f) for f in TRAIN_FRAMES}
    phase("10 inverse_render --impl kernel")
    run_inverse_render()
    launches["train"] = (megakernel.LAUNCHES, gradkernel.LAUNCHES)
    n_steps = (1 + TRAIN_CALLS * TRAIN_REPEATS) * len(TRAIN_FRAMES)
    n_runs = len(INVERSE_RUNS)
    assert launches["train"] == (n_runs, n_steps + n_runs * 60), launches
    launches["train_hinted"] = gradkernel.HINTED_LAUNCHES
    assert launches["train_hinted"] == n_steps + sum(h for _, h in INVERSE_RUNS), launches
    assert counts()["k2_rows"] == counts()["k5"] == counts()["k6"] == 0, counts()
    # The unhinted step beside the production one, at the same shape, in
    # turns after the counted run: unhinted, then hinted again.
    train_unhinted_ms = {f: train_main_path(device, f, frozen=False) for f in TRAIN_FRAMES}
    train_turn_ms = {f: train_main_path(device, f) for f in TRAIN_FRAMES}
    phase("9b training main path on the tiger: packed Adam step -> K4, 1280x720, 1 frame")
    reset_counts()
    tiger_train_ms = train_main_path(device, 1, name="tiger")
    launches["train_tiger"] = counts()
    assert (launches["train_tiger"]["k4"] == launches["train_tiger"]["k4_hinted"]
            == 1 + TRAIN_CALLS * TRAIN_REPEATS), launches["train_tiger"]
    train_rays = TRAIN["width"] * TRAIN["height"] * TRAIN["samples"]
    small_rays = TRAIN_SMALL["width"] * TRAIN_SMALL["height"] * TRAIN_SMALL["samples"]
    med_small, med_plain = statistics.median(k4["k4_small_ms"]), statistics.median(k4["plain_small_ms"])
    k4_full_med = {f: statistics.median(k4["k4_hinted_full_ms"][f]) for f in TRAIN_FRAMES}
    k4_unhinted_med = {f: statistics.median(k4["k4_full_ms"][f]) for f in TRAIN_FRAMES}
    print(json.dumps({
        "cell": "room_with_sphere 1280x720 8spp 4 bounces, packed Adam train step",
        "card": card,
        "config": "the production configuration: the frozen static hints "
                  "(diff.with_frozen_hints)",
        "train_step_ms": {str(f): train_ms[f] for f in TRAIN_FRAMES},
        "train_step_ms_median": {str(f): statistics.median(train_ms[f]) for f in TRAIN_FRAMES},
        "train_grad_mrays_per_s": {str(f): train_rays * f / statistics.median(train_ms[f]) / 1e3
                                   for f in TRAIN_FRAMES},
        "unhinted_train_step_ms": {str(f): train_unhinted_ms[f] for f in TRAIN_FRAMES},
        "unhinted_train_step_ms_median": {str(f): statistics.median(train_unhinted_ms[f])
                                          for f in TRAIN_FRAMES},
        "train_step_ms_after_unhinted": {str(f): train_turn_ms[f] for f in TRAIN_FRAMES},
        "train_step_ms_after_unhinted_median": {str(f): statistics.median(train_turn_ms[f])
                                                for f in TRAIN_FRAMES},
        "k4_ms_1280x720": {str(f): k4["k4_hinted_full_ms"][f] for f in TRAIN_FRAMES},
        "k4_ms_1280x720_median": {str(f): k4_full_med[f] for f in TRAIN_FRAMES},
        "unhinted_k4_ms_1280x720": {str(f): k4["k4_full_ms"][f] for f in TRAIN_FRAMES},
        "unhinted_k4_ms_1280x720_median": {str(f): k4_unhinted_med[f] for f in TRAIN_FRAMES},
        "plain_banded_ms_1280x720": {str(f): k4["plain_full_ms"][f] for f in TRAIN_FRAMES},
        "plain_band_peak_gb_1280x720": k4["plain_band_peak_gb"][1],
        "k4_ms_256x144": k4["k4_small_ms"], "k4_ms_256x144_median": med_small,
        "k4_grad_mrays_per_s_256x144": small_rays / med_small / 1e3,
        "plain_autograd_ms_256x144": k4["plain_small_ms"],
        "plain_autograd_ms_256x144_median": med_plain,
        "plain_grad_mrays_per_s_256x144": small_rays / med_plain / 1e3,
        "plain_peak_gb_256x144": k4["plain_small_peak_gb"],
    }), flush=True)

    phase("11 light-VJP kernel K5 and rows kernel K2 vs plain on the card")
    vjp_err, vjp_rel = check_light_vjp(device)
    comp_err, comp_rel = check_composite_k5(device)
    vjp_err, vjp_rel = max(vjp_err, comp_err), max(vjp_rel, comp_rel)
    k5 = time_light_vjp(device)
    vjp_err, vjp_rel = max(vjp_err, k5["err"]), max(vjp_rel, k5["rel"])
    vjp_err, vjp_rel = max(vjp_err, mode_errs["k5"][0]), max(vjp_rel, mode_errs["k5"][1])
    phase("12 soft value-and-grad kernel K6 vs plain on the card")
    soft_err, soft_rel = check_soft_kernel(device)
    comp_err, comp_rel = check_composite_k6(device)
    soft_err, soft_rel = max(soft_err, comp_err), max(soft_rel, comp_rel)
    k6 = time_soft_kernel(device)
    max_err = max(max_err, k6["light_err"])
    soft_err, soft_rel = max(soft_err, k6["err"]), max(soft_rel, k6["rel"])
    soft_err, soft_rel = max(soft_err, mode_errs["k6"][0]), max(soft_rel, mode_errs["k6"][1])

    phase("13 soft training main path: make_train_step(soft) -> K6, 1280x720")
    reset_counts()
    soft_ms, n_soft, soft_state, soft_target, _ = soft_train(
        device, SOFT_REFS["room_with_sphere"], TRAIN_CALLS, TRAIN_REPEATS)
    fallback_ms, n_fallback, _, _, _ = soft_train(device, FALLBACK_REF, TRAIN_CALLS, 1)
    n_ir = run_inverse_render_position()
    launches["soft"] = counts()
    expect = {"k1": 2 * n_fallback + 1, "k2_rows": 0, "k4": 0, "k5": 2 * n_fallback,
              "k6": n_soft + n_ir, "k4_hinted": 0, "k5_hinted": 2 * n_fallback,
              "k6_hinted": n_soft + n_ir}
    assert launches["soft"] == expect, (launches["soft"], expect)
    split = soft_step_split(device, soft_state, soft_target)
    # The unhinted sphere step beside the production one, at the same
    # shape, in turns after the counted run, with the host's part of each.
    turns = soft_step_turns(device, SOFT_REFS["room_with_sphere"])
    contract_ms = contract_host_ms(device)
    soft_med = statistics.median(soft_ms)
    split_med = {k: statistics.median(v) for k, v in split.items()}
    print(json.dumps({
        "cell": "room_with_sphere 1280x720 8spp 4 bounces, soft train step, sphere 0, zero "
                "target, edge width 0.05, lr 1e-3, the frozen static hints",
        "card": card,
        "soft_step_ms": soft_ms, "soft_step_ms_median": soft_med,
        "soft_step_turns": turns,
        "soft_step_turns_median": {name: {k: statistics.median(v) for k, v in t.items()}
                                   for name, t in turns.items()},
        "contract_host_ms": contract_ms,
        "soft_grad_mrays_per_s": train_rays / soft_med / 1e3,
        "split_ms": split, "split_ms_median": split_med,
        "split_rest_ms": soft_med - sum(split_med.values()),
        "fallback_spaces0_step_ms": fallback_ms,
        "fallback_step_ms_median": statistics.median(fallback_ms),
        "k6_ms_1280x720": k6["ms"], "k6_ms_1280x720_median": statistics.median(k6["ms"]),
        "unhinted_k6_ms_1280x720_median": statistics.median(k6["unhinted_ms"]),
        "unhinted_k5_ms_1280x720_median": statistics.median(k5["unhinted_ms"]),
        "k6_plain_banded_ms_1280x720": k6["plain_ms"],
        "k6_plain_band_peak_gb": k6["plain_band_peak_gb"],
        "k5_ms_1280x720": k5["ms"], "k5_ms_1280x720_median": statistics.median(k5["ms"]),
        "k5_plain_ms_1280x720": k5["plain_ms"], "k5_plain_peak_gb": k5["plain_peak_gb"],
        "launches": launches["soft"],
    }), flush=True)

    phase("13b soft training main path on the composites: make_train_step(soft, tiger | "
          "hypercube | duocylinder) -> K6, 1280x720")
    reset_counts()
    tiger_ref = COMPOSITE_SOFT_REFS["tiger"]
    tiger_soft_ms, n_tiger, tiger_state, tiger_target, tiger_step = soft_train(
        device, tiger_ref, TRAIN_CALLS, TRAIN_REPEATS, name="tiger")
    tiger_fb_ms, n_tiger_fb, _, _, _ = soft_train(device, FALLBACK_REF, TRAIN_CALLS, 1,
                                                  name="tiger")
    step_ms = {"tiger": tiger_soft_ms}
    n_comp = n_tiger
    for scene_name in SOFT_STEP_SCENES[1:]:
        step_ms[scene_name], n, _, _, _ = soft_train(
            device, COMPOSITE_SOFT_REFS[scene_name], TRAIN_CALLS, 1, name=scene_name)
        n_comp += n
    launches["soft_composites"] = counts()
    expect = {"k1": 2 * n_tiger_fb, "k2_rows": 0, "k4": 0, "k5": 2 * n_tiger_fb, "k6": n_comp,
              "k4_hinted": 0, "k5_hinted": 2 * n_tiger_fb, "k6_hinted": n_comp}
    assert launches["soft_composites"] == expect, (launches["soft_composites"], expect)
    tiger_split = soft_step_split(device, tiger_state, tiger_target, tiger_ref)
    tiger_host = soft_step_host(tiger_step, list(tiger_state), tiger_target, SOFT_TURN_STEPS)
    soft_cells, k5_cells, fallback_k1_err = soft_composite_cells(device)
    max_err = max(max_err, fallback_k1_err)
    soft_err = max(soft_err, *(c["max_abs_err"] for c in soft_cells.values()))
    soft_rel = max(soft_rel, *(c["grad_mixed_rel"] for c in soft_cells.values()))
    vjp_err = max(vjp_err, *(c["max_abs_err"] for c in k5_cells.values()))
    vjp_rel = max(vjp_rel, *(c["grad_mixed_rel"] for c in k5_cells.values()))
    tiger_soft_med = statistics.median(tiger_soft_ms)
    print(json.dumps({
        "cell": "tiger 1280x720 8spp 4 bounces, soft train step, the tiger, zero target, edge "
                "width 0.05, lr 1e-3, the frozen static hints",
        "card": card,
        "soft_step_ms": tiger_soft_ms, "soft_step_ms_median": tiger_soft_med,
        "soft_grad_mrays_per_s": train_rays / tiger_soft_med / 1e3,
        "soft_step_ms_by_scene": step_ms,
        "soft_step_ms_median_by_scene": {k: statistics.median(v) for k, v in step_ms.items()},
        "step_host": tiger_host,
        "step_host_median": {k: statistics.median(v) for k, v in tiger_host.items()},
        "split_ms": tiger_split,
        "split_ms_median": {k: statistics.median(v) for k, v in tiger_split.items()},
        "fallback_spaces0_step_ms": tiger_fb_ms,
        "fallback_step_ms_median": statistics.median(tiger_fb_ms),
        "k6_cells": soft_cells, "k5_cells": k5_cells,
        "launches": launches["soft_composites"],
    }), flush=True)

    phase("14 row-sharded launches (K3) on one card")
    shards = check_row_shards(device)
    tiger_shards = tiger_row_shards(device)
    tiger_soft_shards = tiger_soft_row_shards(device)
    bounds = kernel_bounds(device)

    phase("15 distributed main path: multihost_run, 2 ranks")
    reset_counts()
    dist_summary = run_distributed(card)
    ranks = dist_summary["launches_per_rank"]
    launches["sharded"] = {key: sum(item.get(key, 0) for rank in ranks for item in rank.values())
                           for key in ("k1", "k1_shard", "k2", "k4", "k4_shard", "k5", "k5_shard",
                                       "k6", "k6_shard", "k4_hinted", "k5_hinted", "k6_hinted")}
    print(json.dumps({"sharded_path_launches_all_ranks": launches["sharded"]}), flush=True)
    sharded = launches["sharded"]

    phase("15b the multi-device dry run: dryrun.entry, dryrun_multichip(4), the kernel route "
          "on a (2, 2) mesh at 1280x720, multihost_run --scaling")
    reset_counts()
    mesh_path = run_mesh_dryrun(device, card)
    mesh = {key: mesh_path.get(key, 0) for key in sharded}

    phase("16 fp32 FMA peak kernel K7: SASS, vs plain, the vpu_peak sweep")
    peak_err = check_peak_kernel(device, lib_path)
    reset_counts()
    peak = vpu_peak.run(device)
    launches["peak"] = measure_counts()
    n_peak = (len(k7.N_ACCS) + 1) * (1 + vpu_peak.CALLS) + vpu_peak.CLOCK_BURST
    assert launches["peak"]["k7"] == n_peak and sum(launches["peak"].values()) == n_peak, \
        launches["peak"]
    PEAKS["measured_fp32_flops_per_s"] = peak["value"] * 1e9
    peak_err = max(peak_err, check_peak_at_sweep(device, peak))
    blocks = vpu_peak.grid_blocks(device)
    peak_plain_ms = cuda_ms(lambda: k7.peak_plain(
        peak["n_acc"], peak["rounds"], vpu_peak.B, programs=blocks, rows=k7.ROWS_PER_BLOCK,
        device=device), calls=1, repeats=1)[0]
    bounds["k7"] = bound(k7.flops(peak["n_acc"], peak["rounds"], blocks * k7.BLOCK_THREADS),
                         4 * (1 + blocks))
    print(json.dumps({"peaks": PEAKS, "card": card, "sm_clock_mhz": peak["sm_clock_mhz"],
                      "peak_at_clock_gflops": peak["peak_at_clock_gflops"],
                      "k7_plain_ms": peak_plain_ms}), flush=True)

    phase("17 K8, the forward stub variants, and the attribution tools")
    ablate_errs = check_ablate_kernel(device)
    for mode, (err, rel) in check_composite_k8(device).items():
        ablate_errs[mode] = [max(ablate_errs[mode][0], err), max(ablate_errs[mode][1], rel)]
    ablate_modes = check_ablate_modes(device)
    for mode, (err, rel) in ablate_modes["errs"].items():
        ablate_errs[mode] = [max(ablate_errs[mode][0], err), max(ablate_errs[mode][1], rel)]
    variant_err = max(check_forward_variants(device, RenderConfig(**VARIANT_CHECK),
                                             sorted(library.SCENES)),
                      check_forward_variants(device, RenderConfig(**TRAIN),
                                             ("room_with_sphere",)))
    max_err = max(max_err, variant_err)
    tools = run_tools(device)
    measure = {k: sum(t[k] for t in tools["launches"].values())
               for k in ("k1", "k1_variant", "k4", "k5", "k6", "k8", "k4_hinted", "k5_hinted",
                         "k6_hinted", "k8_hinted")}
    k8_ms = tools["results"]["grad_ablate"]["ms"]
    k8_unhinted_ms = time_ablate_unhinted(device)
    k8_tool = check_ablate_at_tool_shape(device, tools["results"]["grad_ablate"]["values"])
    for mode, (err, rel) in k8_tool["errs"].items():
        ablate_errs[mode] = [max(ablate_errs[mode][0], err), max(ablate_errs[mode][1], rel)]
    k8_plain_ms = k8_tool["plain_ms"]["vjp"]
    k8_modes = time_ablate_modes(device, card)
    print(json.dumps({"phase": 17, "card": card, "k4_split_ms":
                      tools["results"]["grad_ablate"]["split_ms"], "k8_ms": k8_ms,
                      "k8_unhinted_ms": k8_unhinted_ms,
                      "k8_plain_ms": k8_tool["plain_ms"], "measure_path_launches": measure}),
          flush=True)

    def contract_of(kernel: str) -> dict:
        """The freeze_hints contract checks of ``kernel`` (K4-K6, K8)."""
        checks = [ok for label, ok in CONTRACT.items() if label.startswith(kernel + " ")]
        assert checks and all(checks), (kernel, CONTRACT)
        return {"checks": len(checks), "all_held": True,
                "what": "the hinted launch against the unhinted one: the loss and alpha's "
                        "cotangent bitwise, every kept slot bitwise, every frozen slot 0"}

    def grad_configurations(kernel: str, timed=None) -> dict:
        """Phase 8c's record of K4, K5 or K6 over K1's other
        configurations: the main path's launches by configuration, the
        launches checked against the plain version at GRAD_CHECK by
        configuration and their worst errors, the modes instances'
        resources, and what was timed at TRAIN."""
        out = {"main_path": mode_launches[kernel],
               "checked": grad_mode_checks["checked"][kernel],
               "checked_max_abs_err": grad_mode_checks["max_abs_err"][kernel],
               "checked_max_grad_mixed_rel": grad_mode_checks["max_grad_mixed_rel"][kernel],
               "max_abs_err": mode_errs[kernel][0],
               "max_grad_mixed_rel": mode_errs[kernel][1],
               "instances": {k: mode_res[k] for k in GRAD_LAUNCHES[kernel]}}
        if timed is not None:
            out["timed"] = timed
        return out

    no_library = {"library_ms": None,
                  "library_note": "no single PyTorch call computes a path trace or its adjoint"}

    summary = {"kernels": [{
        "name": "forward_megakernel",
        "route": "cuda",
        "source": "fourd_ray_tracing_tpu_torch/csrc/megakernel.cu",
        "replaces": "fourd_ray_tracing_tpu/ops/pallas/megakernel.py:316",
        "launches": (launches["render"][0] + launches["live"]["k1"] + launches["composite"]
                     + launches["modes"] + mode_launches["counts"]["k1"]
                     + launches["train"][0] + launches["soft"]["k1"]
                     + launches["soft_composites"]["k1"] + sharded["k1"] + mesh["k1"]
                     + measure["k1"]
                     + measure["k1_variant"]),
        "launches_by_path": {"render": launches["render"][0], "live": launches["live"]["k1"],
                             "composite": launches["composite"],
                             "modes": launches["modes"],
                             "grad_modes": mode_launches["counts"]["k1"],
                             "train": launches["train"][0], "soft": launches["soft"]["k1"],
                             "soft_composites": launches["soft_composites"]["k1"],
                             "sharded": sharded["k1"], "mesh": mesh["k1"],
                             "measure": measure["k1"]},
        # The stub variants of tools/fwd_ablate.py: this kernel with stubs
        # compiled in, held against the plain pipeline under the same
        # patches in phase 17.
        "variant_launches": measure["k1_variant"],
        # K2 is this kernel over (F, P) params rows (render_light_pair): the
        # sharded path's soft pair renders rows; phases 11 and 14 hold them
        # bitwise single renders. K3 is this kernel on a block of rows.
        "rows_launches": launches["soft"]["k2_rows"] + sharded["k2"] + mesh["k2"],
        "sharded_launches": sharded["k1_shard"] + mesh["k1_shard"],
        "shard_max_abs_err": shards["block_errs"]["k1"],
        "shard_sum_max_abs_err": shards["sum_errs"]["k1"],
        "shard_ms": shards["ms"]["k1"],
        "max_abs_err": max_err,
        "tolerance": CHECK_BOUNDS,
        # Every forward comparison (kernel vs plain, hinted vs unhinted) and
        # whether it was bitwise.
        "bitwise": all(BITWISE.values()),
        "not_bitwise": sorted(k for k, v in BITWISE.items() if not v),
        "ms": med_kernel,
        "plain_ms": plain_ms,
        **bounds["k1"], **no_library,
        "hints": "the room's 4 wall pairs, derived by the engine (static hyperplane hints)",
        "registers": k1_res["main"]["registers"], "stack_bytes": k1_res["main"]["stack_bytes"],
        "spill_bytes": k1_res["main"]["spill_bytes"],
        "resident_warps_per_sm": k1_res["main"]["resident_warps_per_sm"],
        "block_threads": k1_res["block_threads"], "smem_bytes": k1_res["smem_bytes"],
        "instances": {short_k1(n): r for n, r in k1_res["instances"].items()},
        "unhinted_ms": statistics.median(unhinted_ms),
        "shape": "room_with_sphere 1280x720 8spp 4 bounces, 4 frames per launch",
        # Phase 7b: bench.py's composite forward lines, each through the
        # engine (its launches counted) and K1 alone, hinted and unhinted.
        "composite_cells": {name: with_shares(dict(cell)) for name, cell in cells.items()},
        "tiger_3view_shard_ms": shards["ms"]["k1_tiger_3view"],
        # Phase 7c: the configurations K1 ran besides the production one.
        # The engine's main path in RenderConfig()'s modes and the oracle's
        # (launches by configuration); K1 by configuration at the headline
        # shape on the room and the tiger (3 views); every configuration
        # checked against its plain version at 256x144 (launches there by
        # configuration, compare launches, not counted above).
        "configurations": {"main_path": mode_configs, "engine": modes_main,
                           "timed": {name: {k: with_shares(dict(c)) for k, c in cell.items()}
                                     for name, cell in mode_cells.items()},
                           "checked": mode_checks["checked"],
                           "checked_max_abs_err": mode_checks["max_abs_err"],
                           "exact_without_transcendentals":
                               mode_checks["exact_without_transcendentals"]},
        "build_s": build_s,
    }, {
        "name": "loss_grad_kernel",
        "route": "cuda",
        **kernel_resources("k4", resources, warps),
        "source": "fourd_ray_tracing_tpu_torch/csrc/gradkernel.cu",
        "replaces": "fourd_ray_tracing_tpu/ops/pallas/gradkernel.py:117",
        "launches": (launches["train"][1] + launches["live"]["k4"] + launches["train_tiger"]["k4"]
                     + sharded["k4"] + mesh["k4"] + measure["k4"]
                     + mode_launches["counts"]["k4"]),
        "launches_by_path": {"render": launches["render"][1], "train": launches["train"][1],
                             "live": launches["live"]["k4"],
                             "grad_modes": mode_launches["counts"]["k4"],
                             "train_tiger": launches["train_tiger"]["k4"],
                             "sharded": sharded["k4"], "mesh": mesh["k4"],
                             "measure": measure["k4"]},
        "sharded_launches": sharded["k4_shard"] + mesh["k4_shard"],
        "shard_max_abs_err": shards["block_errs"]["k4"],
        "shard_sum_max_abs_err": shards["sum_errs"]["k4"],
        "shard_ms": shards["ms"]["k4"],
        "max_abs_err": grad_err,
        "max_grad_mixed_rel_err": grad_rel,
        "tolerance": GRAD_BOUNDS,
        "ms": k4_full_med[1],
        "unhinted_ms": k4_unhinted_med[1],
        "plain_ms": k4["plain_full_ms"][1],
        **bounds["k4"], **no_library,
        "shape": "room_with_sphere 1280x720 8spp 4 bounces, 1 frame, zero target, the frozen "
                 f"static hints (plain version in {BAND_ROWS}-row bands)",
        "hinted_launches": (launches["train_hinted"] + launches["train_tiger"]["k4_hinted"]
                            + sharded["k4_hinted"] + mesh["k4_hinted"] + measure["k4_hinted"]),
        "contract": contract_of("K4"),
        # The composite primitives: bench.py's inverse_step_tiger and the
        # hypercube and duocylinder at its shape (the frozen hints, 1 view,
        # 1 frame), the packed Adam step on the tiger, the tiger's row
        # blocks, and the composite instances' resources.
        "inverse_step": {n: with_shares(dict(c)) if "flops" in c else c
                         for n, c in inverse_cells.items()},
        "train_step_tiger_ms": tiger_train_ms,
        "train_step_tiger_ms_median": statistics.median(tiger_train_ms),
        "tiger_row_shards": tiger_shards,
        "composite_instances": comp_res,
        "ms_4_frames": k4_full_med[4],
        "unhinted_ms_4_frames": k4_unhinted_med[4],
        "plain_ms_4_frames": k4["plain_full_ms"][4],
        "ms_256x144": med_small,
        "plain_ms_256x144": med_plain,
        # Phase 8c: the packed step on the room and the tiger in the
        # oracle's sampler and fold, K4 on the room one axis off the
        # production configuration at a time and on the tiger in the
        # oracle's modes.
        "configurations": grad_configurations("k4", {
            "room": {k: with_shares(dict(c)) for k, c in grad_mode_main["k4_room"].items()},
            "tiger_oracle": with_shares(dict(grad_mode_main["k4_tiger_oracle"])),
            "packed_step_ms": grad_mode_main["packed_step_ms"],
            "packed_step_config": grad_mode_main["oracle"]}),
        "build_s": build_s,
    }, {
        "name": "light_vjp_kernel",
        "route": "cuda",
        **kernel_resources("k5", resources, warps),
        "source": "fourd_ray_tracing_tpu_torch/csrc/gradkernel.cu",
        "replaces": "fourd_ray_tracing_tpu/ops/pallas/gradkernel.py:294",
        "launches": (launches["soft"]["k5"] + launches["soft_composites"]["k5"] + sharded["k5"]
                     + mesh["k5"] + measure["k5"] + mode_launches["counts"]["k5"]),
        "launches_by_path": {"soft": launches["soft"]["k5"],
                             "grad_modes": mode_launches["counts"]["k5"],
                             "soft_composites": launches["soft_composites"]["k5"],
                             "sharded": sharded["k5"], "mesh": mesh["k5"],
                             "measure": measure["k5"]},
        "sharded_launches": sharded["k5_shard"] + mesh["k5_shard"],
        "shard_max_abs_err": shards["block_errs"]["k5"],
        "shard_sum_max_abs_err": shards["sum_errs"]["k5"],
        "shard_ms": shards["ms"]["k5"],
        "max_abs_err": vjp_err,
        "max_grad_mixed_rel_err": vjp_rel,
        "tolerance": GRAD_BOUNDS,
        "ms": statistics.median(k5["ms"]),
        "unhinted_ms": statistics.median(k5["unhinted_ms"]),
        "plain_ms": k5["plain_ms"],
        **bounds["k5"], **no_library,
        "shape": "room_with_sphere 1280x720 8spp 4 bounces, 1 row, seeded random cotangent, "
                 "the frozen static hints (plain version whole)",
        "hinted_launches": (launches["soft"]["k5_hinted"]
                            + launches["soft_composites"]["k5_hinted"]
                            + sharded["k5_hinted"] + mesh["k5_hinted"] + measure["k5_hinted"]),
        "contract": contract_of("K5"),
        # The hyperplane fallback's K5 on the tiger at the same shape, and
        # on the tiger without wall 0 (phase 13b).
        "tiger_ms": k5_cells["tiger"]["ms"],
        "composite_cells": k5_cells,
        "configurations": grad_configurations("k5", {
            "room_trig_1_row": with_shares(dict(grad_mode_main["k5_room_trig"])),
            "fallback_step_trig_ms": grad_mode_main["fallback_step_trig_ms"]}),
        "build_s": build_s,
    }, {
        "name": "soft_loss_grad_kernel",
        "route": "cuda",
        **kernel_resources("k6", resources, warps),
        "source": "fourd_ray_tracing_tpu_torch/csrc/gradkernel.cu",
        "replaces": "fourd_ray_tracing_tpu/ops/pallas/gradkernel.py:1207",
        "launches": (launches["soft"]["k6"] + launches["soft_composites"]["k6"] + sharded["k6"]
                     + mesh["k6"] + measure["k6"] + mode_launches["counts"]["k6"]),
        "launches_by_path": {"soft": launches["soft"]["k6"],
                             "grad_modes": mode_launches["counts"]["k6"],
                             "soft_composites": launches["soft_composites"]["k6"],
                             "sharded": sharded["k6"], "mesh": mesh["k6"],
                             "measure": measure["k6"]},
        "sharded_launches": sharded["k6_shard"] + mesh["k6_shard"],
        "shard_max_abs_err": shards["block_errs"]["k6"],
        "shard_sum_max_abs_err": shards["sum_errs"]["k6"],
        "shard_ms": shards["ms"]["k6"],
        "max_abs_err": soft_err,
        "max_grad_mixed_rel_err": soft_rel,
        "tolerance": GRAD_BOUNDS,
        "ms": statistics.median(k6["ms"]),
        "unhinted_ms": statistics.median(k6["unhinted_ms"]),
        "plain_ms": k6["plain_ms"],
        "hinted_launches": (launches["soft"]["k6_hinted"]
                            + launches["soft_composites"]["k6_hinted"]
                            + sharded["k6_hinted"] + mesh["k6_hinted"] + measure["k6_hinted"]),
        "contract": contract_of("K6"),
        # The composites (phase 13b): K6 on the tiger, the hypercube and the
        # duocylinder at the same shape, the tiger's soft step and its row
        # blocks (phase 14).
        "composite_cells": {n: with_shares(dict(c)) if "flops" in c else c
                            for n, c in soft_cells.items()},
        "soft_step_tiger_ms_median": tiger_soft_med,
        "soft_step_ms_median_by_scene": {k: statistics.median(v) for k, v in step_ms.items()},
        "tiger_row_shards": tiger_soft_shards,
        "pair_ms": k6["pair_ms"],
        "pair_note": "K2 over both rows + the two-row K5, the launches K6 fused, same shape",
        "configurations": grad_configurations("k6", {
            "room_trig": with_shares(dict(grad_mode_main["k6_room_trig"])),
            "soft_step_trig_ms": grad_mode_main["soft_step_trig_ms"]}),
        **bounds["k6"], **no_library,
        "shape": "room_with_sphere 1280x720 8spp 4 bounces, sphere 0, zero target, edge "
                 f"width 0.05, the frozen static hints (plain version in {BAND_ROWS}-row bands)",
        "build_s": build_s,
    }, {
        "name": "fp32_peak_kernel",
        "route": "cuda",
        "source": "fourd_ray_tracing_tpu_torch/csrc/vpu_peak.cu",
        "replaces": "tools/vpu_peak.py:55",
        "launches": launches["peak"]["k7"],
        "launches_by_path": {"measure": launches["peak"]["k7"]},
        "max_abs_err": peak_err,
        "tolerance": {"rtol": PEAK_RTOL, "rounds": [PEAK_CHECK_ROUNDS, "the sweep's"]},
        "ms": peak["ms"],
        "plain_ms": peak_plain_ms,
        **bounds["k7"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes a chain of dependent FMAs",
        "shape": f"n_acc {peak['n_acc']} (the sweep's best), {peak['rounds']} steps, "
                 f"{blocks} blocks of {k7.BLOCK_THREADS} threads",
        "measured_gflops": peak["value"],
        "sm_clock_mhz": peak["sm_clock_mhz"],
        "peak_at_clock_gflops": peak["peak_at_clock_gflops"],
        "linearity_ratio": peak["linearity_ratio"],
        "build_s": build_s,
    }, {
        "name": "grad_ablate_kernel",
        "route": "cuda",
        "source": "fourd_ray_tracing_tpu_torch/csrc/ablate.cu",
        "replaces": "tools/grad_ablate.py:57",
        "launches": (measure["k8"] + ablate_modes["launches_total"]
                     + k8_modes["launches"]["counts"]["k8"]),
        "launches_by_path": {"measure": measure["k8"],
                             "modes_checked": ablate_modes["launches_total"],
                             "modes_timed": k8_modes["launches"]["counts"]["k8"]},
        "max_abs_err": max(e for e, _ in ablate_errs.values()),
        "max_rel_err_by_mode": {m: r for m, (_, r) in ablate_errs.items()},
        "tolerance": {"acc_rtol": ACC_RTOL, "loss_rtol": GRAD_BOUNDS["loss_rtol"]},
        "ms": k8_ms["vjp"],
        "ms_by_mode": {m: k8_ms[m] for m in ablate.MODES},
        "unhinted_ms": k8_unhinted_ms["vjp"],
        "unhinted_ms_by_mode": k8_unhinted_ms,
        "hinted_launches": measure["k8_hinted"],
        "contract": contract_of("K8"),
        "plain_ms": k8_plain_ms,
        **bounds["k8"]["vjp"],
        "bound_ms_by_mode": {m: bounds["k8"][m]["bound_ms"] for m in ablate.MODES},
        **no_library,
        "shape": "room_with_sphere 1280x720 8spp 4 bounces, zero target, mode vjp, the frozen "
                 "static hints, as grad_ablate runs it (plain version whole)",
        # K8 over K1's other configurations (csrc/ablatemodes.cu): the
        # launches by configuration of the checks at GRAD_CHECK and of the
        # timed path through grad_ablate.build at TRAIN, acc against K1's
        # light, the instances' resources, and each configuration's times,
        # bounds and K4 - vjp split at TRAIN.
        "configurations": {
            "source": "fourd_ray_tracing_tpu_torch/csrc/ablatemodes.cu",
            "checked": ablate_modes["checked"],
            "checked_launches_by_config": ablate_modes["launches"],
            "acc_vs_k1_light_max_rel": ablate_modes["k1_max_rel"],
            "timed_launches_by_config": k8_modes["launches"]["k8"],
            "instances": ablate_res,
            "timed": k8_modes["timed"]},
        "build_s": build_s,
    }]}
    for entry in summary["kernels"]:
        with_shares(entry)
    k1 = summary["kernels"][0]  # the shares at the unhinted flops, as PRs 1-6 counted them
    k1["unhinted"]["share_of_published_peak"] = (
        k1["unhinted"]["flops"] / (k1["ms"] * 1e-3) / PEAKS["fp32_flops_per_s"])
    print(json.dumps(summary), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
