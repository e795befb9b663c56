"""The ``train`` loop: inverse rendering with the packed Adam step
(``diff.make_packed_train_step`` under ``diff.with_frozen_hints``, the
production configuration) toward a target image the benchmark renders
with the reference from the configuration's scene; the start point is
that scene with its materials perturbed from the seed.

Set-up builds the step and its state once and drives it through the
traffic's ``setup_steps`` (the kernels' build and load, Adam's state);
the window goes on with that same step and state, dispatching steps
ahead, reading the loss back every ``log_every`` steps as
``inverse_render --log-every`` does, and ends after a final synchronise.

Correct: the traffic's ``first_steps`` (set-up's and the window's first
ones), which the reference follows: each step's loss, the first step's
gradient as Adam gets it (after the freeze mask), and the change of the
packed vector over those steps, against the reference's autograd over
the copy with the same mask and Adam written out; gradients and changes
by the worst parameter group."""
from __future__ import annotations

from contextlib import nullcontext

import torch

from benchmark.harness import common
from benchmark.harness.common import BAND_ROWS, COUNT_ROWS, MASK32


def perturb(scene, gen: torch.Generator, rel: float):
    """``scene`` with every material's glow and color scaled by 1 + u,
    u uniform in [-rel, rel) from ``gen`` (one draw for all of them)."""
    from benchmark.reference.ops.geometry import Material
    from benchmark.reference.ops.vec4 import Vec3

    mats = []

    def collect(node):
        if isinstance(node, Material):
            mats.append(node)
        elif isinstance(node, tuple):
            for child in node:
                collect(child)

    collect(scene)
    device = scene_device(scene)
    u = (torch.rand(4 * len(mats), generator=gen, device=device) * 2 - 1) * rel
    scale = iter((1 + u).unbind())

    def rebuild(node):
        if isinstance(node, Material):
            return Material(node.glow * next(scale), node.refl_prob,
                            Vec3(*(c * next(scale) for c in node.color)))
        if isinstance(node, tuple) and not isinstance(node, torch.Tensor):
            children = [rebuild(c) for c in node]
            return type(node)(*children) if hasattr(node, "_fields") else tuple(children)
        return node

    return rebuild(scene)


def scene_device(scene):
    from benchmark.reference.models import params

    return next(params.tree_leaves(scene)).device


class Loop:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.config, self.traffic = cell.config, cell.traffic
        self.frames = int(self.traffic["frames_per_step"])
        self.first = int(self.traffic["first_steps"])
        self.setup_steps = int(self.traffic["setup_steps"])
        if not 1 <= self.setup_steps < self.first:
            raise ValueError("set-up drives at least one step, and the window one checked step")
        self.view = (self.config["train_view"],)
        self.spans = []

    def step_seed(self, i: int) -> int:
        return (self.seed * 1000003 + i) & MASK32

    # --- inputs (the benchmark's) ------------------------------------------

    def _reference(self):
        from benchmark.reference.models.renderer import RenderConfig

        return (common.reference_scene(self.config, self.device),
                common.reference_camera(self.config, self.view, self.device),
                common.render_config(RenderConfig, self.config))

    def make_inputs(self) -> None:
        from benchmark.reference import grad

        scene, camera, cfg = self._reference()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed & 0xFFFFFFFFFFFFFFFF)
        self.start_scene = perturb(scene, gen, float(self.traffic["perturb_rel"]))
        target_seed = (self.seed ^ 0x5EED5EED) & MASK32
        self.target = grad.render_banded(scene, camera, cfg, [target_seed], BAND_ROWS)[0]

    # --- the program --------------------------------------------------

    def setup(self) -> None:
        from fourd_ray_tracing_tpu_torch import camera as cam
        from fourd_ray_tracing_tpu_torch import diff
        from fourd_ray_tracing_tpu_torch.models import library, params
        from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig
        from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4

        from benchmark.reference.models import params as ref_params

        c, dev = self.config, self.device
        values = iter(list(ref_params.tree_leaves(self.start_scene)))
        scene = params.map_leaves(lambda t: next(values).detach().clone(),
                                  library.SCENES[c["scene"]](dev))
        if next(values, None) is not None:
            raise ValueError("the reference's scene has more leaves than the program's")
        cam_c = c["camera"]
        orient = cam.orientation_from_angles(*cam.CameraAngles.of(*cam_c["angles"], device=dev),
                                             dev)
        camera = cam.make_camera(Vec4.of(*cam_c["focus"], device=dev), orient,
                                 cam_c["focus_to_matrix_distance"], cam_c["matrix_height"],
                                 self.view, dev)
        cfg = diff.with_frozen_hints(common.render_config(RenderConfig, c), scene)
        self.step_fn, init, _ = diff.make_packed_train_step(
            cfg, float(self.traffic["lr"]), camera, scene, frames_per_step=self.frames)
        self.model, self.opt = init(scene)
        self.vec0 = self.model.scene_vec.detach().clone()
        self.first_losses = []
        for i in range(self.setup_steps):
            self._record(i, self.step_fn(self.model, self.opt, self.step_seed(i), self.target))
        common.sync(dev)

    def _record(self, i: int, loss) -> None:
        """Keep what the check compares of step ``i`` (on the device, no
        synchronise)."""
        if i >= self.first:
            return
        self.first_losses.append(loss)
        if i == 0:
            self.grad1 = self.model.scene_vec.grad.detach().clone()
        if i == self.first - 1:
            self.vec_end = self.model.scene_vec.detach().clone()

    def window(self, seconds: float) -> dict:
        model, opt, step, target = self.model, self.opt, self.step_fn, self.target
        log_every = int(self.traffic["log_every"])
        i, n, spans = self.setup_steps, 0, self.spans
        t_start = common.now()
        while True:
            t0 = common.now()
            loss = step(model, opt, self.step_seed(i), target)
            t1 = common.now()
            spans.append(("train.step", t0, t1))
            if i < self.first:
                self._record(i, loss)
            i, n = i + 1, n + 1
            if n % log_every == 0:
                loss.item()
                t2 = common.now()
                spans.append(("train.loss_readback", t1, t2))
                if t2 - t_start >= seconds:
                    break
        t1 = common.now()
        common.sync(self.device)
        spans.append(("train.sync", t1, common.now()))
        self.window_span = (t_start, common.now())
        self.window_s = self.window_span[1] - t_start
        self.steps = n
        return {"attempted": n, "window_s": self.window_s}

    def rays_per_step(self) -> int:
        w = self.config["windows"][0]
        return w["width"] * w["height"] * self.config["samples"] * self.frames

    def end_to_end(self) -> dict:
        return {"train_grad_rays_per_s": self.steps * self.rays_per_step() / self.window_s}

    def release(self) -> None:
        self.first_state = {"losses": torch.stack(self.first_losses).cpu(),
                            "grad1": self.grad1.cpu(),
                            "change": (self.vec_end - self.vec0).cpu()}
        self.model = self.opt = self.step_fn = self.first_losses = None
        self.grad1 = self.vec0 = self.vec_end = None
        common.free(self.device)

    # --- the reference ----------------------------------------------------

    def reference_steps(self, arithmetic=None, frames=None) -> dict:
        """The first steps by the reference: autograd over the copy (the
        unhinted fold), the contract's mask derived from the scene, Adam
        written out. ``arithmetic``: a lower precision (the control);
        ``frames``: the first so many of each step's frames alone (the
        half-batch fault)."""
        from benchmark.reference import grad, hints
        from benchmark.reference.models import params

        _, camera, cfg = self._reference()
        scene = self.start_scene
        mask = params.freeze_mask(hints.with_frozen_hints(cfg, scene), scene)
        n = params.n_scene(scene)
        vec = params.pack(scene, camera).detach()
        vec0 = vec[:n].clone()
        adam = grad.Adam(float(self.traffic["lr"]))
        losses = []
        with arithmetic or nullcontext():
            for i in range(self.first):
                loss, g = grad.loss_and_grad(vec, scene, camera, hints.unhinted(cfg),
                                             grad.frame_seeds(self.step_seed(i),
                                                              self.frames)[:frames],
                                             self.target, BAND_ROWS)
                g = g[:n] if mask is None else g[:n] * mask.to(g.device)
                if i == 0:
                    grad1 = g.clone()
                vec = torch.cat([adam.step(vec[:n], g), vec[n:]])
                losses.append(loss)
        return {"losses": torch.stack(losses).cpu(), "grad1": grad1.cpu(),
                "change": (vec[:n] - vec0).cpu(), "groups": grad.leaf_groups(scene)}

    def check(self) -> dict:
        self.reference = self.reference_steps()
        return compare(self.first_state, self.reference)

    def control(self, arithmetic) -> dict:
        """The compared numbers with the reference under ``arithmetic`` in
        the program's place (after ``check``, whose reference it reuses)."""
        return compare(self.reference_steps(arithmetic), self.reference)

    def half_batch(self) -> dict:
        """The compared numbers of the half-batch fault: the reference on
        the first half of each step's frames in the program's place."""
        return compare(self.reference_steps(frames=self.frames // 2), self.reference)

    # --- the yardstick's work counts ---------------------------------------

    def k4_work(self) -> dict:
        """One K4 call's flops (autograd over the hinted copy on COUNT_ROWS
        rows, scaled to the image, times the hinted forward's live share)
        and bytes (params, seeds and target read; loss and gradient
        written)."""
        if getattr(self, "_k4", None) is None:
            from benchmark.reference import grad, hints, lanes
            from benchmark.reference.models import params
            from benchmark.reference.utils.flops import FlopCounter

            scene, camera, cfg = self._reference()
            hcfg = hints.with_frozen_hints(cfg, scene)
            packed = params.pack(scene, camera)
            seeds = grad.frame_seeds(self.step_seed(0), 1)
            with FlopCounter() as counter:
                grad.loss_and_grad(packed, scene, camera, hcfg, seeds,
                                   self.target[:COUNT_ROWS], COUNT_ROWS, rows=(0, COUNT_ROWS))
            _, share = lanes.live_share(scene, camera, hcfg, seeds, BAND_ROWS, COUNT_ROWS)
            w = self.config["windows"][0]
            flops = counter.flops * w["height"] / COUNT_ROWS * share * self.frames
            p = params.layout(scene, camera).size
            pixels = w["width"] * w["height"]
            self._k4 = {"flops": flops, "bytes": 4 * (2 * p + 1 + self.frames + pixels * 3),
                        "live_share": share}
        return self._k4


def _group_norms(vec: torch.Tensor, groups) -> torch.Tensor:
    return torch.stack([vec[a:b].double().norm() for a, b in groups])


def worst_group_gap(prog: torch.Tensor, ref: torch.Tensor, groups, keep) -> float:
    """max over the kept groups of | |prog_g| - |ref_g| | / max(|ref_g|,
    median |ref_g|)."""
    p, r = _group_norms(prog, groups), _group_norms(ref, groups)
    scale = torch.maximum(r, r[keep].median())
    return float(((p - r).abs() / scale)[keep].max())


def compare(prog: dict, ref: dict) -> dict:
    """The train cells' compared numbers. Groups whose reference gradient
    norm is under a thousandth of the median group's (frozen slots, and
    leaves nought to rounding, which Adam moves by round-off alone) are
    left out of the change."""
    groups = ref["groups"]
    g_ref = _group_norms(ref["grad1"], groups)
    moving = g_ref > 1e-3 * g_ref[g_ref > 0].median()
    nonzero = g_ref > 0
    rel = ((prog["losses"].double() - ref["losses"].double()).abs()
           / ref["losses"].double().abs())
    return {"loss_rel": float(rel.max()),
            "grad1_group_gap": worst_group_gap(prog["grad1"], ref["grad1"], groups, nonzero),
            "change_group_gap": worst_group_gap(prog["change"], ref["change"], groups, moving),
            "groups_compared": int(moving.sum())}
