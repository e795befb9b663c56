"""The ``render`` loop: a viewer's progressive render with the camera
still. A closed loop of ``RenderEngine.step_frames(frames_per_launch)``
over the configuration's windows (the main window's views, and the
additional windows' views as a second group at their own size), each
call followed by a synchronise (a viewer presents the accumulation once
a step); each step timed on the host clock from the call to after the
synchronise.

Correct: every window's accumulation that the window's first step leaves
(from the empty buffers, so the reference works it out whole) and that
of one more step drawn from the seed (blended onto the program's
accumulation before it), each against the reference's frames blended in
the same order."""
from __future__ import annotations

from contextlib import nullcontext

import torch

from benchmark.harness import common, roofline
from benchmark.harness.common import BAND_ROWS, COUNT_ROWS, MASK32


class Loop:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.config, self.traffic = cell.config, cell.traffic
        self.fpl = int(self.traffic["frames_per_launch"])
        self.windows = self.config["windows"]
        if not 1 <= len(self.windows) <= 2:
            raise ValueError("the engine renders a main group and at most one more")
        lo, hi = self.traffic["check_step_range"]
        self.check_steps = (0, int(common.seed_rng(seed, 1).integers(lo, hi)))
        self.snaps = {}
        self.spans = []

    def make_inputs(self) -> None:
        """Nothing: the engine renders the configuration's scene."""

    # --- the program --------------------------------------------------

    def setup(self) -> None:
        from fourd_ray_tracing_tpu_torch import camera as cam
        from fourd_ray_tracing_tpu_torch.engine import RenderEngine
        from fourd_ray_tracing_tpu_torch.models import library
        from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig
        from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4

        c, dev = self.config, self.device
        cam_c = c["camera"]
        additional = None
        if len(self.windows) > 1:
            additional = (common.render_config(RenderConfig, c, 1),
                          tuple(self.windows[1]["views"]))
        self.engine = RenderEngine(
            library.SCENES[c["scene"]](dev), common.render_config(RenderConfig, c, 0),
            Vec4.of(*cam_c["focus"], device=dev), cam.CameraAngles.of(*cam_c["angles"], device=dev),
            device=dev, focus_to_matrix_distance=cam_c["focus_to_matrix_distance"],
            matrix_height=cam_c["matrix_height"], views=tuple(self.windows[0]["views"]),
            deterministic=True, impl="cuda", additional=additional)
        self.engine.seed = self.seed & MASK32
        self.engine.precompile()  # the kernels' build and load, one launch per view group
        # The blend's elementwise kernels, on scratch buffers of the accumulations' shapes.
        for g in self.engine.groups:
            scratch = torch.zeros_like(g.accum)
            scratch.add_((scratch - scratch) * 0.5)
        common.sync(dev)

    def accums(self) -> list:
        return [g.accum.clone() for g in self.engine.groups]

    def window(self, seconds: float) -> dict:
        engine, fpl, dev = self.engine, self.fpl, self.device
        steps, spans = [], self.spans
        t_start = common.now()
        while True:
            k = len(steps)
            if k in self.check_steps:
                before = self.accums()
            t0 = common.now()
            engine.step_frames(fpl)
            t_call = common.now()
            common.sync(dev)
            t1 = common.now()
            steps.append(t1 - t0)
            spans.append(("engine.step_frames", t0, t_call))
            spans.append(("present.sync", t_call, t1))
            if k in self.check_steps:
                self.snaps[k] = (before, self.accums())
            if t1 - t_start >= seconds:
                break
        self.window_span = (t_start, common.now())
        self.window_s = self.window_span[1] - t_start
        self.steps = steps
        return {"attempted": len(steps), "window_s": self.window_s}

    def rays_per_step(self) -> int:
        return sum(len(w["views"]) * w["width"] * w["height"] for w in self.windows) \
            * self.config["samples"] * self.fpl

    def end_to_end(self) -> dict:
        from benchmark.harness.stats import percentile

        return {"render_rays_per_s": len(self.steps) * self.rays_per_step() / self.window_s,
                "render_step_ms_p95": 1e3 * percentile(self.steps, 95)}

    def host_steps(self) -> dict:
        """The steps' spread on the host, beside the metrics: the median,
        the 99th percentile and the longest step, and the share of the
        window spent in steps over twice the median."""
        from benchmark.harness.stats import percentile

        p50 = percentile(self.steps, 50)
        return {"step_ms_p50": 1e3 * p50, "step_ms_p99": 1e3 * percentile(self.steps, 99),
                "step_ms_max": 1e3 * max(self.steps),
                "slow_step_share": sum(s for s in self.steps if s > 2 * p50) / self.window_s}

    def release(self) -> None:
        self.engine = None
        common.free(self.device)

    # --- the reference ----------------------------------------------------

    def _reference(self, window: int):
        from benchmark.reference.models.renderer import RenderConfig

        scene = common.reference_scene(self.config, self.device)
        camera = common.reference_camera(self.config, self.windows[window]["views"], self.device)
        return scene, camera, common.render_config(RenderConfig, self.config, window)

    def step_seeds(self, k: int) -> list:
        """The frame seeds of window step ``k``."""
        from benchmark.reference import progressive

        return progressive.frame_seeds(self.seed, (k + 1) * self.fpl)[k * self.fpl:]

    def reference_step(self, k: int, window: int, before: torch.Tensor,
                       arithmetic=None) -> torch.Tensor:
        """Window ``window``'s accumulation after window step ``k`` from
        ``before``."""
        from benchmark.reference import grad, progressive

        scene, camera, cfg = self._reference(window)
        with arithmetic or nullcontext():
            frames = grad.render_banded(scene, camera, cfg, self.step_seeds(k), BAND_ROWS)
            return progressive.blend(before, frames, k * self.fpl + 1)

    def check(self) -> dict:
        """The compared numbers: over the checked steps and the windows'
        accumulations, the largest mean absolute difference from the
        reference and the largest share of values more than 1e-4 from it."""
        return self._compare(lambda k, w, before, after: after)

    def control(self, arithmetic) -> dict:
        """The same numbers with the reference under ``arithmetic`` (the
        lower-precision control) in the program's place."""
        return self._compare(
            lambda k, w, before, after: self.reference_step(k, w, before, arithmetic))

    def _compare(self, produced) -> dict:
        out = {"mean_abs_diff": 0.0, "far_share": 0.0}
        for k, (befores, afters) in sorted(self.snaps.items()):
            for w, (before, after) in enumerate(zip(befores, afters)):
                if k == 0:
                    before = torch.zeros_like(before)  # the first step's part 1 overwrites it
                ref = self.reference_step(k, w, before)
                diff = (produced(k, w, before, after) - ref).abs()
                out["mean_abs_diff"] = max(out["mean_abs_diff"], float(diff.mean()))
                out["far_share"] = max(out["far_share"], float((diff > 1e-4).float().mean()))
        out["checked_steps"] = len(self.snaps)
        return out

    # --- the yardstick's work counts ---------------------------------------

    def k1_work(self) -> dict:
        """One step's K1 work, one launch per window: the flops (the hinted
        copy's, live lanes only), and the least time the launches could
        take, each from its flops and bytes (the params and seeds read, the
        frames written)."""
        if getattr(self, "_k1", None) is None:
            from benchmark.reference import hints, lanes
            from benchmark.reference.models import params

            flops = bound = 0.0
            for i, w in enumerate(self.windows):
                scene, camera, cfg = self._reference(i)
                hcfg = hints.with_hints(scene, cfg)
                seeds = self.step_seeds(0)[:1]
                dense, share = lanes.live_share(scene, camera, hcfg, seeds, BAND_ROWS,
                                                COUNT_ROWS)
                f = dense * w["height"] / COUNT_ROWS * share * self.fpl
                pixels = w["width"] * w["height"] * len(w["views"])
                p = params.layout(scene, camera).size
                flops += f
                bound += roofline.bound_s(f, 4 * (p + self.fpl + self.fpl * pixels * 3))
            self._k1 = {"flops": flops, "bound_s": bound, "launches": len(self.windows)}
        return self._k1
