"""The counter recorder (utils/profiling.py ``count``) and K4's occupancy
counters (ops/cuda/gradkernel.py): ``k4.resident_warps`` and
``k4.sweep_waves``, recorded inside ``k4.launch`` while a profiler
records, from one occupancy query per launch key. The arithmetic runs here
with the card's counts as given inputs; the test marked ``card`` runs a
warm packed step on an NVIDIA card (``python3 -m pytest
tests/test_torch_k4_occupancy.py -m card --noconftest -o addopts=""``) and
skips without one. Imports no JAX, so that it runs on the card machine."""
import time
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fourd_ray_tracing_tpu_torch import camera as cam
from fourd_ray_tracing_tpu_torch import diff
from fourd_ray_tracing_tpu_torch.models import library, params
from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig
from fourd_ray_tracing_tpu_torch.ops.cuda import gradkernel
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4
from fourd_ray_tracing_tpu_torch.utils import profiling

# The benchmark's train cells: the main window of the upstream's
# executable/properties.txt, 4 frames a step.
TRAIN = dict(width=121, height=75, samples=100, reflections_amount=4, rng_mode="per_sample")
FRAMES = 4
H100_SMS = 132


@pytest.fixture(autouse=True)
def no_records():
    profiling.clear()
    yield
    profiling.clear()


def cpu_profiler():
    return profile(activities=[ProfilerActivity.CPU])


def train_setup(name: str, device="cpu", **over):
    """(scene, camera, cfg under the frozen hints) of a train cell."""
    dev = torch.device(device)
    scene = library.SCENES[name](dev)
    camera = cam.make_camera(Vec4.of(0.0, -2.0, 0.0, 0.0, device=dev),
                             cam.orientation_from_angles(*cam.CameraAngles.of(0.0, 0.0, 0.0, dev),
                                                         dev),
                             1.5, 2.0, ("yxz",), dev)
    return scene, camera, diff.with_frozen_hints(RenderConfig(**dict(TRAIN, **over)), scene)


# --- profiling.count ------------------------------------------------------

def test_count_records_nothing_without_a_profiler():
    profiling.count("k4.sweep_waves", 1.5)
    with profiling.span("train.step"):
        profiling.count("k4.sweep_waves", 1.5)
    assert profiling.counters() == [] and profiling.records() == []


def test_count_is_stamped_with_the_enclosing_step_and_the_clock():
    with cpu_profiler():
        profiling.count("outside", 1)
        with profiling.span("a"):
            pass
        with profiling.span("b"):
            with profiling.span("b.child"):
                before = time.perf_counter()
                profiling.count("inside", 2.5)
                after = time.perf_counter()
    got = profiling.counters()
    assert [(c.name, c.value, c.step) for c in got] == [("outside", 1.0, -1), ("inside", 2.5, 1)]
    assert before <= got[1].t <= after
    assert all(isinstance(c, profiling.Counter) for c in got)


def test_count_leaves_the_span_records_as_they_are():
    with cpu_profiler():
        with profiling.span("a"):
            profiling.count("c", 3)
        with profiling.span("b"):
            pass
    records = profiling.records()
    assert [(r.name, r.parent, r.step) for r in records] == [("a", -1, 0), ("b", -1, 1)]
    assert all(isinstance(r, profiling.Record) and len(r) == 5 for r in records)


def test_clear_empties_the_counters_and_they_share_the_cap(monkeypatch):
    monkeypatch.setattr(profiling, "CAP", 2)
    with cpu_profiler():
        for k in range(3):
            profiling.count("c", k)
    assert [c.value for c in profiling.counters()] == [0.0, 1.0]
    assert profiling.dropped() == 1
    profiling.clear()
    assert profiling.counters() == [] and profiling.dropped() == 0


# --- the occupancy arithmetic ---------------------------------------------

@pytest.mark.parametrize("name, size, sweep_bytes", [
    ("room_with_sphere", 154, 40808), ("tiger", 115, 30604), ("hypercube", 272, 71984)])
def test_sweep_bytes_of_the_train_cells(name, size, sweep_bytes):
    """The sweep's dynamic shared memory at the train cells' layout under
    the frozen hints: the params row and its fold table, and 64 + 1
    columns of P floats."""
    scene, camera, cfg = train_setup(name)
    lay = params.layout(scene, camera)
    assert lay.size == size
    assert gradkernel.launch_shapes(lay, cfg)["sweep_kernel"] == (gradkernel.GRAD_BLOCK,
                                                                   sweep_bytes)


@pytest.mark.parametrize("resident, waves", [(5, 0.8606), (7, 0.6147), (3, 1.4343)],
                         ids=["room", "tiger", "hypercube"])
def test_sweep_waves_of_the_train_launch(resident, waves):
    """4 frames of 121 x 75 pixels in blocks of 64: 568 sweep blocks, over
    the blocks an H100's 132 SMs hold at the shared memory's count."""
    blocks = -(-TRAIN["width"] * TRAIN["height"] // gradkernel.GRAD_BLOCK) * FRAMES
    assert blocks == 568
    assert gradkernel.sweep_waves(blocks, resident, H100_SMS) == pytest.approx(waves, abs=1e-4)


class FakeLib:
    """The occupancy entry points of the kernels' library, counted."""

    def __init__(self):
        self.calls = []

    def fourd_loss_grad_occupancy(self, table, reflections, hints, out):
        self.calls.append(("production", reflections))
        out[0], out[1] = 3, 71984
        return 0

    def fourd_loss_grad_modes_occupancy(self, fold, sampler, iters, table, reflections, hints,
                                        out):
        self.calls.append(("modes", reflections))
        out[0], out[1] = 2, 71984
        return 0


def test_occupancy_is_queried_once_per_launch_key(monkeypatch):
    """A second launch of the same layout, descriptor, bounce count and
    configuration reuses the first query; another bounce count or modes
    launch queries anew."""
    props = type("Props", (), {"multi_processor_count": H100_SMS})()
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: props)
    monkeypatch.setattr(gradkernel, "_SWEEP_OCCUPANCY", {})
    scene, camera, cfg = train_setup("hypercube")
    lay = params.layout(scene, camera)
    hints = gradkernel.launch_words(lay, cfg)
    lib, device, start = FakeLib(), torch.device("cuda", 0), gradkernel.OCCUPANCY_QUERIES
    for _ in range(3):
        assert gradkernel._sweep_occupancy(lib, None, lay, cfg, hints, None, device) == (3, 132)
    cfg3 = diff.with_frozen_hints(RenderConfig(**dict(TRAIN, reflections_amount=3)), scene)
    assert gradkernel._sweep_occupancy(lib, None, lay, cfg3, hints, None, device) == (3, 132)
    assert gradkernel._sweep_occupancy(lib, None, lay, cfg, hints, (0, 1, 3), device) == (2, 132)
    assert lib.calls == [("production", 4), ("production", 3), ("modes", 4)]
    assert gradkernel.OCCUPANCY_QUERIES == start + 3


# --- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def synchronizing_warnings(fn) -> int:
    """The synchronizing operations ``fn`` runs, by torch's sync debug mode."""
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


@pytest.mark.card
@pytest.mark.parametrize("name", ["room_with_sphere", "tiger", "hypercube"])
def test_card_warm_packed_step_records_the_counters(card, name):
    """At the train cells' shape a warm packed step records each counter
    once per K4 launch, inside ``k4.launch``, with no synchronizing
    operation beyond the step's one (the seeds' upload) and no occupancy
    query; the hypercube's sweep holds at most 6 warps a SM and takes at
    least 1.4 waves."""
    scene, camera, cfg = train_setup(name, card)
    step, init, _ = diff.make_packed_train_step(cfg, 1e-3, camera, scene,
                                                frames_per_step=FRAMES)
    model, opt = init(scene)
    target = torch.full((TRAIN["height"], TRAIN["width"], 3), 0.25, device=card)
    step(model, opt, 1, target)
    torch.cuda.synchronize()
    queries, launches = gradkernel.OCCUPANCY_QUERIES, gradkernel.LAUNCHES
    assert synchronizing_warnings(lambda: step(model, opt, 2, target)) == 1
    with profile(activities=[ProfilerActivity.CUDA]):
        assert synchronizing_warnings(lambda: step(model, opt, 3, target)) == 1
    assert gradkernel.OCCUPANCY_QUERIES == queries
    assert gradkernel.LAUNCHES == launches + 2
    records, got = profiling.records(), profiling.counters()
    (launch,) = [r for r in records if r.name == "k4.launch"]
    assert [c.name for c in got] == ["k4.resident_warps", "k4.sweep_waves"]
    assert all(c.step == launch.step and launch.start <= c.t <= launch.end for c in got)
    warps, waves = (c.value for c in got)
    blocks = warps * 32 // gradkernel.GRAD_BLOCK
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert waves == pytest.approx(gradkernel.sweep_waves(568, blocks, sms))
    if name == "hypercube":
        assert warps <= 6 and waves >= 1.4


@pytest.mark.card
def test_card_hypercube_three_view_fold_table(card):
    """K1 over the hypercube's three views in one launch (P = 288, the
    widest params row and fold table of the library's scenes) at the main
    window's size: bitwise the plain pipeline with the same hints and
    without them."""
    import numpy as np

    from fourd_ray_tracing_tpu_torch.models import renderer
    from fourd_ray_tracing_tpu_torch.ops.cuda import megakernel

    scene = library.hypercube(card)
    camera = cam.make_camera(Vec4.of(0.0, -2.0, 0.0, 0.0, device=card),
                             cam.orientation_from_angles(*cam.CameraAngles.of(0.0, 0.0, 0.0, card),
                                                         card),
                             1.5, 2.0, ("yxz", "ywz", "yxw"), card)
    assert params.layout(scene, camera).size == 288
    cfg = RenderConfig(**dict(TRAIN, samples=8))
    hinted = megakernel.with_hints(scene, cfg)
    assert hinted.axis_hints is not None and hinted.axis_hints.hypercube is not None
    seeds = np.asarray([7, 2**32 - 3], np.uint32)
    got = megakernel.render_light_cuda(scene, camera, hinted, seeds)
    assert got.shape == (2, 3, TRAIN["height"], TRAIN["width"], 3)
    assert torch.equal(got, renderer.render_light(scene, camera, hinted, seeds))
    assert torch.equal(got, renderer.render_light(scene, camera, cfg, seeds))
