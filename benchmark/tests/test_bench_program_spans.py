"""The readers of the program's own spans (benchmark/metrics/engine.*,
train_step.*_ms, *.syncs_per_step, *.idle_in_program_pct over
harness/program_spans.py) on a synthetic window: the program's records
and the device's intervals made by hand, each reader's number worked out
by hand; and None from every reader when the window holds no program
span, as on a program without the recorder."""
from types import SimpleNamespace

import pytest

from benchmark.harness import program_spans, spec
from benchmark.harness.trace import Profile
from fourd_ray_tracing_tpu_torch.utils import profiling

T0 = 100.0  # the window's start on the host clock; it lasts 1 s

RENDER = ("engine.syncs_per_step", "engine.sync_wait_ms", "engine.camera_ms",
          "engine.launch_ms", "engine.blend_ms", "render.idle_in_program_pct")
TRAIN = ("train_step.syncs_per_step", "train_step.sync_wait_ms", "train_step.adam_ms",
         "train.idle_in_program_pct")

# (name, start, end, parent's position in the list) of one step, in seconds
# from the step's start.
RENDER_STEP = [("engine.step", 0.00, 0.10, None), ("engine.seeds", 0.00, 0.01, 0),
               ("engine.camera", 0.01, 0.04, 0), ("sync.camera", 0.02, 0.03, 2),
               ("k1.pack", 0.04, 0.05, 0), ("k1.upload", 0.05, 0.07, 0),
               ("sync.seeds", 0.05, 0.06, 5), ("k1.launch", 0.07, 0.08, 0),
               ("engine.tonemap", 0.08, 0.09, 0), ("engine.blend", 0.09, 0.10, 0)]
TRAIN_STEP = [("train.step", 0.00, 0.10, None), ("train.adam", 0.00, 0.01, 0),
              ("k4.pack", 0.01, 0.02, 0), ("k4.pack", 0.02, 0.03, 0),
              ("k4.upload", 0.03, 0.05, 0), ("sync.seeds", 0.03, 0.045, 4),
              ("k4.launch", 0.05, 0.06, 0), ("train.backward", 0.06, 0.07, 0),
              ("train.adam", 0.07, 0.10, 0)]


def records(step, at) -> list:
    """``step``'s spans repeated at each offset of ``at`` (seconds from the
    window's start), as the recorder keeps them."""
    out = []
    for k, offset in enumerate(at):
        base = len(out)
        for name, s, e, parent in step:
            out.append(profiling.Record(name, T0 + offset + s, T0 + offset + e,
                                        -1 if parent is None else base + parent, k))
    return out


def fake_run(busy) -> SimpleNamespace:
    device = [("kernel", T0 + s, T0 + e) for s, e in busy]
    return SimpleNamespace(window_span=(T0, T0 + 1.0), profile=Profile(device, [], (T0, T0 + 1.0)))


def read_all(names, run, recs, monkeypatch) -> dict:
    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    return {n: spec.load_reader(n)(run) for n in names}


def test_render_readers_on_a_synthetic_window(monkeypatch):
    # Two steps at 0 and 0.5 s, one before the window (left out). The device
    # works 0-0.025, 0.075-0.3 and 0.575-0.8: idle 0.025-0.075 (begins in
    # sync.camera), 0.3-0.575 and 0.8-1.0 (begin outside every span).
    recs = records(RENDER_STEP, (-0.5, 0.0, 0.5))
    run = fake_run([(0.0, 0.025), (0.075, 0.3), (0.575, 0.8)])
    got = read_all(RENDER, run, recs, monkeypatch)
    assert got == {"engine.syncs_per_step": 2.0,
                   "engine.sync_wait_ms": pytest.approx(20.0),
                   "engine.camera_ms": pytest.approx(20.0),    # 30 less its 10 ms copy
                   "engine.launch_ms": pytest.approx(30.0),    # 10 + (20 - 10) + 10
                   "engine.blend_ms": pytest.approx(20.0),
                   "render.idle_in_program_pct": pytest.approx(100 * 0.05 / 0.525)}
    assert program_spans.idle_by_span(run, recs) == pytest.approx(
        {"sync.camera": 0.05, None: 0.475})


def test_train_readers_on_a_synthetic_window(monkeypatch):
    # Steps at 0 and 0.5 s. The device idles 0-0.045 (begins in train.adam)
    # and 0.4-0.545 (begins between the steps).
    recs = records(TRAIN_STEP, (0.0, 0.5))
    run = fake_run([(0.045, 0.4), (0.545, 1.0)])
    got = read_all(TRAIN, run, recs, monkeypatch)
    assert got == {"train_step.syncs_per_step": 1.0,
                   "train_step.sync_wait_ms": pytest.approx(15.0),
                   "train_step.adam_ms": pytest.approx(40.0),
                   "train.idle_in_program_pct": pytest.approx(100 * 0.045 / 0.19)}
    assert program_spans.idle_by_span(run, recs) == pytest.approx(
        {"train.adam": 0.045, None: 0.145})


def test_the_innermost_span_names_the_gap():
    # A gap that begins in a child, one in its parent after the child ended,
    # one in a later sibling.
    step = [("engine.step", 0.0, 0.5, None), ("engine.camera", 0.0, 0.2, 0),
            ("sync.camera", 0.05, 0.1, 1), ("engine.blend", 0.3, 0.4, 0)]
    run = fake_run([(0.0, 0.06), (0.07, 0.15), (0.16, 0.25), (0.26, 0.32), (0.33, 1.0)])
    assert program_spans.idle_by_span(run, records(step, (0.0,))) == pytest.approx(
        {"sync.camera": 0.01, "engine.camera": 0.01, "engine.step": 0.01, "engine.blend": 0.01})


@pytest.mark.parametrize("names", [RENDER, TRAIN])
def test_readers_find_nothing_without_program_spans(names, monkeypatch):
    run = fake_run([(0.1, 0.2)])
    assert set(read_all(names, run, [], monkeypatch).values()) == {None}
    # Steps outside the window, or of the other kind, are not this cell's.
    others = records(TRAIN_STEP if names == RENDER else RENDER_STEP, (0.0,))
    early = records(RENDER_STEP if names == RENDER else TRAIN_STEP, (-0.5,))
    got = read_all(names, run, others + early, monkeypatch)
    assert all(got[n] is None for n in names if "idle" not in n)


def test_a_program_without_the_recorder_reads_as_none(monkeypatch):
    monkeypatch.delattr(profiling, "records")
    run = fake_run([(0.1, 0.2)])
    for name in RENDER + TRAIN:
        assert spec.load_reader(name)(run) is None
