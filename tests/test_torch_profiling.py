"""The port's profiling module (utils/profiling.py) and the app's use of it:
the checks tests/test_app.py makes of the JAX Meter, the app's JSON
line, and the span recorder: nothing recorded and nothing changed with no
profiler, the render step's and the packed train step's span trees under
one, the cap. The tests marked ``card`` run on an NVIDIA card (``python -m
pytest tests/test_torch_profiling.py -m card --noconftest -o addopts=""``)
and skip without one: the kernels' spans under the benchmark's CUDA-only
profiler, and every synchronizing copy of a render step and a train step
inside a ``sync.*`` span."""
import json
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fourd_ray_tracing_tpu_torch import app, diff
from fourd_ray_tracing_tpu_torch import camera as cam
from fourd_ray_tracing_tpu_torch.engine import RenderEngine
from fourd_ray_tracing_tpu_torch.models import library
from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4
from fourd_ray_tracing_tpu_torch.utils import profiling
from fourd_ray_tracing_tpu_torch.utils.profiling import FrameStats, Meter

TINY_CONFIG = """
show_additional_windows = false
window.main.width = 48
window.main.cell_size = 4
window.additional.width = 40
window.additional.cell_size = 5
ray_tracing.samples = 1
ray_tracing.reflections_amount = 2
ray_tracing.small_indent = 0.005
camera.focus_to_matrix_distance = 1.5
camera.matrix_height = 2.0
camera.initial_position.x = 0.0
camera.initial_position.y = -2.0
camera.initial_position.z = 0.0
camera.initial_position.w = 0.0
camera.initial_position.fi = 0.0
camera.initial_position.te = 0.0
camera.initial_position.psi = 0.0
mouse_border_width = 15
constrain_psi_range = true
psi_range_radius = 45.0
mouse_sensitivity = 0.005
wheel_sensitivity = 0.1
movement_speed = 3.0
light_to_color_conversion_coefficient = 1.0
max_fps = 60
scene = sphere_plane_light
"""


def test_meter_counts_rays():
    m = Meter()
    with m.measure(1000) as h:
        h["result"] = np.zeros(3)
    assert m.stats.frames == 1 and m.stats.rays == 1000
    payload = json.loads(m.stats.as_json())
    assert payload["frames"] == 1 and payload["rays_per_s"] > 0


def test_meter_accumulates_over_blocks():
    m = Meter()
    with m.measure(64, frames=4) as h:
        h["result"] = (torch.ones(8), {"light": torch.zeros(2, 3)})
    with m.measure(16):
        pass  # no result: nothing to wait for
    assert (m.stats.frames, m.stats.rays) == (5, 80)
    assert m.stats.seconds > 0 and m.stats.fps == 5 / m.stats.seconds
    assert m.stats.rays_per_s == 80 / m.stats.seconds


def test_frame_stats_without_time():
    stats = FrameStats()
    assert stats.fps == 0.0 and stats.rays_per_s == 0.0
    assert set(json.loads(stats.as_json())) == {"frames", "seconds", "fps", "rays_per_s"}


def test_app_json_line_keeps_its_keys(tmp_path, capsys):
    (tmp_path / "properties.txt").write_text(TINY_CONFIG)
    assert app.main(["--config", str(tmp_path / "properties.txt"), "--frames", "2",
                     "--out", str(tmp_path / "out"), "--device", "cpu"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert len(lines) == 1
    assert set(lines[0]) == {"frames", "seconds", "rays_per_s"}
    assert lines[0]["frames"] == 2 and lines[0]["rays_per_s"] > 0


# --- the span recorder --------------------------------------------------

MAIN = dict(width=8, height=6, samples=2, reflections_amount=2, rng_mode="per_sample")
ADD = dict(width=6, height=4, samples=2, reflections_amount=2, rng_mode="per_sample")
ENGINE_CHILDREN = ["engine.seeds", "engine.camera", "engine.tonemap", "engine.blend",
                   "engine.camera", "engine.tonemap", "engine.blend"]


@pytest.fixture(autouse=True)
def no_records():
    profiling.clear()
    yield
    profiling.clear()


def cpu_profiler():
    return profile(activities=[ProfilerActivity.CPU])


def make_engine(device="cpu", controls="python"):
    """The room in two view groups (the main window, and two more views at
    their own size), as the benchmark's render cells build it."""
    dev = torch.device(device)
    return RenderEngine(
        library.room_with_sphere(dev), RenderConfig(**MAIN), Vec4.of(0.0, -2.0, 0.0, 0.0, device=dev),
        cam.CameraAngles.of(0.0, 0.0, 0.0, device=dev), device=dev, deterministic=True,
        additional=(RenderConfig(**ADD), ("ywz", "yxw")), use_native_controls=controls)


def make_packed(device="cpu"):
    """The packed Adam step under the frozen hints on the room, 2 frames a
    step: (step, model, optimizer, target)."""
    dev = torch.device(device)
    scene = library.room_with_sphere(dev)
    camera = cam.make_camera(Vec4.of(0.0, -2.0, 0.0, 0.0, device=dev),
                             cam.orientation_from_angles(*cam.CameraAngles.of(0.0, 0.0, 0.0, dev), dev),
                             1.5, 2.0, ("yxz",), dev)
    cfg = diff.with_frozen_hints(RenderConfig(**MAIN), scene)
    step, init, _ = diff.make_packed_train_step(cfg, 1e-3, camera, scene, frames_per_step=2)
    model, opt = init(scene)
    target = torch.full((MAIN["height"], MAIN["width"], 3), 0.25, device=dev)
    return step, model, opt, target


def train(packed, seed: int) -> torch.Tensor:
    step, model, opt, target = packed
    return step(model, opt, seed, target)


def tree(records) -> dict:
    """{top-level name: [children's names]} with every record checked
    against its parent: inside it, of its step."""
    out = {}
    for r in records:
        assert r.end is not None and r.end >= r.start
        if r.parent == -1:
            out.setdefault(r.name, [])
            continue
        parent = records[r.parent]
        assert parent.start <= r.start and r.end <= parent.end and r.step == parent.step
        if parent.parent == -1:
            out[parent.name].append(r.name)
    return out


def test_off_records_nothing_and_changes_nothing():
    """With no profiler the render step and the packed step record no span,
    and what they compute is bitwise what they compute under one."""
    engines = make_engine(), make_engine()
    steps = make_packed(), make_packed()
    engines[0].step_frames(2)
    loss_off = train(steps[0], 11)
    assert profiling.records() == [] and profiling.dropped() == 0
    with cpu_profiler():
        engines[1].step_frames(2)
        loss_on = train(steps[1], 11)
    assert len(profiling.records()) > 0
    for g_off, g_on in zip(engines[0].groups, engines[1].groups):
        assert torch.equal(g_off.accum, g_on.accum)
    assert torch.equal(loss_off, loss_on)
    assert torch.equal(steps[0][1].scene_vec, steps[1][1].scene_vec)


def test_off_span_is_one_shared_no_op(monkeypatch):
    """Off, span and sync return the same no-op context and read no clock."""
    def no_clock():
        raise AssertionError("the clock was read")

    monkeypatch.setattr(profiling.time, "perf_counter", no_clock)
    assert profiling.span("a") is profiling.span("b") is profiling.sync("seeds", "cuda")
    with profiling.span("a"), profiling.sync("seeds", "cuda"):
        pass
    assert profiling.records() == []


def test_engine_step_records_its_span_tree():
    """step_frames(2) on two view groups: one engine.step a call, its
    children per group in order, one step id per call; the plain path
    on the CPU copies nothing to a card and launches no kernel."""
    engine = make_engine()
    with cpu_profiler():
        engine.step_frames(2)
        engine.step_frames(2)
    records = profiling.records()
    tops = [r for r in records if r.parent == -1]
    assert [r.name for r in tops] == ["engine.step", "engine.step"]
    assert [r.step for r in tops] == [0, 1]
    assert {r.step for r in records} == {0, 1}
    assert tree(records) == {"engine.step": ENGINE_CHILDREN * 2}
    first = [r for r in records if r.step == 0]
    assert [r.name for r in first][1:] == ENGINE_CHILDREN
    assert all(records[r.parent].name == "engine.step" for r in first[1:])
    assert not any(r.name.startswith(("sync.", "k1.")) for r in records)


def test_packed_step_records_its_span_tree():
    """The packed step on the CPU path: train.step around the zeroing,
    the packing, the backward pass and the update."""
    packed = make_packed()
    with cpu_profiler():
        train(packed, 11)
    records = profiling.records()
    assert tree(records) == {"train.step": ["train.adam", "k4.pack", "train.backward",
                                            "train.adam"]}
    assert {r.step for r in records} == {0}


def test_spans_nest_and_number_their_steps():
    with cpu_profiler():
        with profiling.span("a"):
            with profiling.span("b"):
                with profiling.span("c"):
                    pass
            with profiling.span("d"):
                pass
        with profiling.span("e"):
            pass
    records = profiling.records()
    assert [(r.name, r.parent, r.step) for r in records] == [
        ("a", -1, 0), ("b", 0, 0), ("c", 1, 0), ("d", 0, 0), ("e", -1, 1)]
    assert records[0].start <= records[1].start <= records[2].end <= records[1].end


def test_a_span_records_when_its_block_raises():
    with cpu_profiler():
        with pytest.raises(ValueError), profiling.span("a"):
            raise ValueError("x")
        with profiling.span("b"):
            pass
    assert [(r.name, r.parent, r.end is not None) for r in profiling.records()] == [
        ("a", -1, True), ("b", -1, True)]


def test_sync_spans_only_on_a_card():
    with cpu_profiler():
        with profiling.sync("seeds", "cpu"), profiling.sync("camera", torch.device("cpu")):
            pass
    assert profiling.records() == []


def test_records_stay_within_the_cap_and_clear_empties_them(monkeypatch):
    monkeypatch.setattr(profiling, "CAP", 3)
    with cpu_profiler():
        with profiling.span("a"):
            with profiling.span("b"):
                pass
        with profiling.span("c"):
            pass
        with profiling.span("d"):  # past the cap, and its child with it
            with profiling.span("e"):
                pass
    assert [r.name for r in profiling.records()] == ["a", "b", "c"]
    assert profiling.dropped() == 2
    profiling.clear()
    assert profiling.records() == [] and profiling.dropped() == 0
    with cpu_profiler():
        with profiling.span("f"):
            pass
    assert [(r.name, r.step) for r in profiling.records()] == [("f", 0)]


# --- on the card --------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def cuda_profiler():
    """The benchmark's traced window's profiler: the device's activity alone."""
    return profile(activities=[ProfilerActivity.CUDA])


def synchronizing_warnings(fn) -> int:
    """The synchronizing operations ``fn`` runs, by torch's sync debug mode:
    one warning each (the mode's own notice, once a process, that it is a
    prototype is not one)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in got)


def warm_engine(device):
    engine = make_engine(device, controls="auto")
    engine.precompile()
    engine.step_frames(1)
    torch.cuda.synchronize()
    return engine


def warm_packed(device):
    packed = make_packed(device)
    train(packed, 10)
    torch.cuda.synchronize()
    return packed


@pytest.mark.card
def test_card_spans_under_the_cuda_only_profiler(card):
    """A first step and a step after a rotation pack both groups' params
    and copy their cameras to the card; a warm, still step does neither."""
    engine, packed = warm_engine(card), warm_packed(card)
    first = make_engine(card, controls="auto")
    with cuda_profiler():
        first.step_frames(4)
        engine.step_frames(4)
        engine.rotate(d_fi=0.01)
        engine.step_frames(4)
        train(packed, 11)
    records = profiling.records()
    steps = [[r.name for r in records if r.step == top.step]
             for top in records if top.parent == -1]
    assert [names[0] for names in steps] == ["engine.step"] * 3 + ["train.step"]
    camera_copies = 4 if engine.controls == "native" else 0
    for names, packs, copies in zip(steps, (2, 0, 2), (camera_copies, 0, camera_copies)):
        assert names.count("k1.pack") == packs
        assert names.count("sync.camera") == copies
        assert names.count("k1.upload") == names.count("k1.launch") == 2
        assert names.count("sync.seeds") == 2
    names = steps[3]
    for name in ("k4.upload", "k4.launch", "train.backward", "sync.seeds"):
        assert names.count(name) == 1, name
    assert names.count("k4.pack") == 2 and names.count("train.adam") == 2


@pytest.mark.card
def test_card_still_step_is_bitwise_the_direct_launch(card):
    """A warm, still step_frames(4) gives bitwise the accumulations of
    render_light_cuda called with freshly built cameras, packs nothing and
    makes two synchronizing copies (the groups' seeds)."""
    from fourd_ray_tracing_tpu_torch.models.renderer import accumulate
    from fourd_ray_tracing_tpu_torch.ops.cuda.megakernel import render_light_cuda
    from fourd_ray_tracing_tpu_torch.ops.sky import light_to_color

    engine = warm_engine(card)
    twin = make_engine(card, controls="auto")
    twin.load_state_dict(engine.state_dict())
    with cuda_profiler():
        assert synchronizing_warnings(lambda: engine.step_frames(4)) == 2
    names = [r.name for r in profiling.records()]
    assert names.count("k1.pack") == 0 and names.count("sync.seeds") == 2
    seeds, parts = zip(*(twin._next_seed() for _ in range(4)))
    for g, g_twin in zip(engine.groups, twin.groups):
        light = render_light_cuda(twin.scene, g_twin.camera(twin), g_twin.cfg,
                                  np.asarray(seeds, np.uint32))
        for frame, part in zip(light_to_color(light, g_twin.cfg.light_coefficient), parts):
            accumulate(g_twin.accum, frame, part)
        assert torch.equal(g.accum, g_twin.accum)


@pytest.mark.card
@pytest.mark.parametrize("path", ["render", "train"])
def test_card_every_synchronizing_copy_is_a_sync_span(card, path):
    """torch's sync debug mode counts the synchronizing operations of one
    step_frames(4) and of one packed step: as many as their sync.* spans."""
    if path == "render":
        engine = warm_engine(card)
        run = lambda: engine.step_frames(4)  # noqa: E731
    else:
        packed = warm_packed(card)
        run = lambda: train(packed, 11)  # noqa: E731
    with cuda_profiler():
        count = synchronizing_warnings(run)
    syncs = [r for r in profiling.records() if r.name.startswith("sync.")]
    assert count > 0
    assert len(syncs) == count
