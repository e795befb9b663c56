"""The reader of K4's sample-split counter (benchmark/metrics/
k4.sweep_split.py over harness/program_counters.py) on synthetic counter
readings: the mean of the readings inside the window alone, and None
when the window holds none, as on a program that records the occupancy
counters but no split, or no counters at all."""
from types import SimpleNamespace

import pytest

from benchmark.harness import spec
from fourd_ray_tracing_tpu_torch.utils import profiling

T0 = 100.0  # the window's start on the host clock; it lasts 1 s
NAME = "k4.sweep_split"


def run():
    return SimpleNamespace(window_span=(T0, T0 + 1.0))


def launches(at, splits) -> list:
    """Each K4 launch's three readings at each offset of ``at`` (seconds
    from the window's start), as the recorder keeps them."""
    out = []
    for step, (offset, split) in enumerate(zip(at, splits)):
        out += [profiling.Counter("k4.resident_warps", T0 + offset, 8.0, step),
                profiling.Counter(NAME, T0 + offset, float(split), step),
                profiling.Counter("k4.sweep_waves", T0 + offset, 1.076 * split, step)]
    return out


def read(counters, monkeypatch):
    monkeypatch.setattr(profiling, "counters", lambda: list(counters))
    return spec.load_reader(NAME)(run())


def test_reader_takes_the_mean_inside_the_window(monkeypatch):
    # Launches before the window, at its edges, inside it and after it:
    # only those at 0.0-1.0 s count.
    counters = launches((-0.5, 0.0, 0.4, 1.0, 1.5), (1, 8, 8, 2, 1))
    assert read(counters, monkeypatch) == pytest.approx(6.0)


@pytest.mark.parametrize("counters", [
    [], launches((-0.5, 1.5), (8, 8)),
    [profiling.Counter("k4.resident_warps", T0 + 0.5, 8.0, 0),
     profiling.Counter("k4.sweep_waves", T0 + 0.5, 1.076, 0)]],
    ids=["no_counter", "none_in_the_window", "occupancy_without_split"])
def test_reader_without_a_reading_in_the_window_is_none(counters, monkeypatch):
    assert read(counters, monkeypatch) is None


def test_a_program_without_the_counter_recorder_reads_none(monkeypatch):
    """An older tree's profiling module has records() and no counters()."""
    monkeypatch.delattr(profiling, "counters")
    assert spec.load_reader(NAME)(run()) is None
