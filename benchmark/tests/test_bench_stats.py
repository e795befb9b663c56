"""The harness's arithmetic on synthetic numbers: the 95th percentile
over all steps, the idle share, the idle gaps by host span,
the kernels' times and the roofline shares."""
import numpy as np
import pytest

from benchmark.harness import roofline, stats
from benchmark.harness.trace import Profile


def test_p95_is_taken_over_all_steps():
    rng = np.random.default_rng(3)
    steps = list(rng.uniform(5, 6, 400)) + [40.0] * 20 + list(rng.uniform(5, 6, 80))
    assert stats.percentile(steps, 95) == pytest.approx(np.percentile(steps, 95))
    chunked = np.mean([np.percentile(steps[i:i + 100], 95) for i in range(0, 500, 100)])
    assert stats.percentile(steps, 95) != pytest.approx(chunked)


def test_idle_share_and_gaps_on_a_synthetic_profile():
    # Window 10..20 s; kernels 11-13, 12-14 (overlap), 16-17, 19-21 (cut at the end).
    device = [("forward_kernel<1>", 11, 13), ("Memcpy HtoD", 12, 14),
              ("forward_kernel<1>", 16, 17), ("sweep_kernel<4>", 19, 21)]
    spans = [("engine.step_frames", 10, 10.5), ("present.sync", 14, 16.5)]
    p = Profile(device, spans, (10, 20))
    assert p.window_s == 10
    assert p.busy_s() == pytest.approx(3 + 1 + 1)
    assert p.idle_share() == pytest.approx(0.5)
    gaps = dict(p.idle_gaps())
    assert gaps["engine.step_frames"] == pytest.approx(1.0)  # 10-11 starts in the call
    assert gaps["present.sync"] == pytest.approx(2.0)        # 14-16 starts in the sync
    assert gaps["loop"] == pytest.approx(2.0)                # 17-19 starts outside any span
    assert p.kernel_seconds(("forward_kernel",)) == pytest.approx(3.0)
    assert len(p.kernels(("forward_kernel",))) == 2
    assert p.device_ops()[0] == ["forward_kernel<1>", pytest.approx(3.0)]


def test_roofline_arithmetic():
    flops, nbytes = 67e12 * 1e-3, 3.35e12 * 2e-3  # 1 ms of flops, 2 ms of bytes
    assert roofline.bound_s(flops, nbytes) == pytest.approx(2e-3)
    assert roofline.share_pct(flops, nbytes, 8e-3) == pytest.approx(25.0)
    assert roofline.peak_share_pct(flops, 4e-3) == pytest.approx(25.0)


class _Run:
    """What a reader sees of a traced run: the profile and the work counts."""

    def __init__(self, profile, work):
        self.profile, self._work = profile, work

    def k1_work(self):
        return self._work


def test_k1_roofline_counts_a_step_s_launches_together():
    from benchmark.harness import spec

    # 2 steps, each a 3 ms launch (the main window) and a 1 ms one (the others).
    device = [("forward_kernel<0>", 0.000, 0.003), ("forward_kernel<0>", 0.003, 0.004),
              ("forward_kernel<0>", 0.010, 0.013), ("forward_kernel<0>", 0.013, 0.014)]
    run = _Run(Profile(device, [], (0, 0.02)), {"bound_s": 1e-3, "launches": 2, "flops": 0})
    assert spec.load_reader("k1_roofline")(run) == pytest.approx(25.0)  # 1 ms a step of 4
    run = _Run(Profile([], [], (0, 0.02)), {"bound_s": 1e-3, "launches": 2, "flops": 0})
    assert spec.load_reader("k1_roofline")(run) is None


def test_device_events_come_from_the_raw_trace():
    from types import SimpleNamespace

    from benchmark.harness import trace

    def event(name, device, start_ns, dur_ns, note=False):
        return SimpleNamespace(name=lambda: name, device_type=lambda: f"DeviceType.{device}",
                               start_ns=lambda: start_ns, duration_ns=lambda: dur_ns,
                               is_user_annotation=lambda: note)

    raw = [event("forward_kernel<0>", "CUDA", 2_000_000_000, 3_000_000),
           event("aten::add", "CPU", 2_000_000_000, 1_000),
           event("engine.step_frames", "CUDA", 2_000_000_000, 9_000_000, note=True)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: raw)))
    (got,) = trace._device_events(prof)
    assert got[0] == "forward_kernel<0>"
    assert got[1:] == (pytest.approx(2.0), pytest.approx(2.003))
