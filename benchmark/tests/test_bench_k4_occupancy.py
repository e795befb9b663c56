"""The readers of K4's occupancy counters (benchmark/metrics/
k4.resident_warps.py and k4.sweep_waves.py over harness/program_counters.py)
on synthetic counter readings: the mean of the readings inside the window
alone, and None when the window holds none, as on a program without the
counter recorder."""
from types import SimpleNamespace

import pytest

from benchmark.harness import program_counters, spec
from fourd_ray_tracing_tpu_torch.utils import profiling

T0 = 100.0  # the window's start on the host clock; it lasts 1 s
NAMES = ("k4.resident_warps", "k4.sweep_waves")


def run():
    return SimpleNamespace(window_span=(T0, T0 + 1.0))


def launches(at, warps, waves) -> list:
    """Each K4 launch's two readings at each offset of ``at`` (seconds
    from the window's start), as the recorder keeps them."""
    out = []
    for step, (offset, n, w) in enumerate(zip(at, warps, waves)):
        out += [profiling.Counter("k4.resident_warps", T0 + offset, float(n), step),
                profiling.Counter("k4.sweep_waves", T0 + offset, w, step)]
    return out


def read_all(counters, monkeypatch) -> dict:
    monkeypatch.setattr(profiling, "counters", lambda: list(counters))
    return {n: spec.load_reader(n)(run()) for n in NAMES}


def test_readers_take_the_mean_inside_the_window(monkeypatch):
    # Launches before the window, at its edges, inside it and after it:
    # only those at 0.0-1.0 s count.
    counters = launches((-0.5, 0.0, 0.4, 1.0, 1.5), (10, 6, 6, 4, 10), (9.0, 1.5, 1.4, 1.3, 9.0))
    counters.append(profiling.Counter("k4.other", T0 + 0.5, 99.0, 2))
    got = read_all(counters, monkeypatch)
    assert got == {"k4.resident_warps": pytest.approx(16 / 3),
                   "k4.sweep_waves": pytest.approx(1.4)}


@pytest.mark.parametrize("counters", [[], launches((-0.5, 1.5), (6, 6), (1.4, 1.4))],
                         ids=["no_counter", "none_in_the_window"])
def test_readers_without_a_reading_in_the_window_are_none(counters, monkeypatch):
    assert read_all(counters, monkeypatch) == {n: None for n in NAMES}


def test_a_program_without_the_counter_recorder_reads_none(monkeypatch):
    """An older tree's profiling module has records() and no counters()."""
    monkeypatch.delattr(profiling, "counters")
    assert program_counters.in_window(run(), "k4.sweep_waves") == []
    assert {n: spec.load_reader(n)(run()) for n in NAMES} == {n: None for n in NAMES}
