"""A run with the timed path broken underneath comes out not correct, at
a size the CPU holds (the harness's look for a card skipped): once for
each fault a cell can have. A step that returns its state unchanged;
half of the batch left out, the mean taken over the rest; an answer
altered where it is produced. (No cell spans chips, so none can leave
out the exchange between them.) The lower-precision control, the
reference computed in bfloat16 in the program's place, fails too; a
sound run passes."""
import pytest
import torch

from benchmark.harness import main
from benchmark.harness.precision import BFloat16Arithmetic
from benchmark.tests.helpers import tiny_cell

SEED = 2**31 + 5
RENDER = ("room.render3", "tiger.render3")
TRAIN = ("room.train4", "tiger.train4")


def run(name, seconds=0.05):
    return main.run_cell(tiny_cell(name), SEED, seconds, False, "cpu")


@pytest.mark.parametrize("name", RENDER + TRAIN)
def test_sound_run_is_correct(name):
    result, _ = run(name)
    assert result["correct"] is True, result["check"]


def render_faults(monkeypatch, fault):
    from fourd_ray_tracing_tpu_torch import engine

    real = engine.RenderEngine.step_frames
    if fault == "unchanged":
        monkeypatch.setattr(engine.RenderEngine, "step_frames", lambda self, n: self.accum)
    elif fault == "half_batch":
        monkeypatch.setattr(engine.RenderEngine, "step_frames",
                            lambda self, n: real(self, n // 2))
    else:
        render = engine._ViewGroup.step_n

        def altered(self, scene, camera, seeds, parts):
            self._render, inner = (lambda *a: inner(*a) * 1.01), self._render
            try:
                return render(self, scene, camera, seeds, parts)
            finally:
                self._render = inner

        monkeypatch.setattr(engine._ViewGroup, "step_n", altered)


def train_faults(monkeypatch, fault):
    from fourd_ray_tracing_tpu_torch import diff

    if fault == "unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif fault == "half_batch":
        real = diff.frame_seeds
        monkeypatch.setattr(diff, "frame_seeds", lambda seed, f: real(seed, f)[:f // 2])
    else:
        real = diff.image_loss_kernel
        monkeypatch.setattr(diff, "image_loss_kernel", lambda *a, **k: real(*a, **k) * 1.01)


@pytest.mark.parametrize("fault", ("unchanged", "half_batch", "altered"))
@pytest.mark.parametrize("name", RENDER + TRAIN)
def test_fault_is_not_correct(monkeypatch, name, fault):
    (render_faults if name in RENDER else train_faults)(monkeypatch, fault)
    result, _ = run(name)
    assert result["correct"] is False, result["check"]


@pytest.mark.parametrize("name", RENDER + TRAIN)
def test_control_is_not_correct(name):
    cell = tiny_cell(name)
    _, loop = main.run_cell(cell, SEED, 0.05, False, "cpu")
    correct, failed, shown = main.judge(loop.control(BFloat16Arithmetic()), cell.limits)
    assert correct is False and failed >= 1, shown


@pytest.mark.parametrize("name", TRAIN)
def test_half_batch_reference_is_not_correct(name):
    cell = tiny_cell(name)
    _, loop = main.run_cell(cell, SEED, 0.05, False, "cpu")
    correct, _, shown = main.judge(loop.half_batch(), cell.limits)
    assert correct is False, shown
