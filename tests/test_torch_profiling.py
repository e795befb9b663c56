"""The port's profiling module (utils/profiling.py) and the app's use of it:
the checks tests/test_app.py makes of the JAX Meter, the trace capture,
and the app's JSON line."""
import json

import numpy as np
import torch

from fourd_ray_tracing_tpu_torch import app
from fourd_ray_tracing_tpu_torch.utils.profiling import FrameStats, Meter, trace_capture

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


def test_trace_capture_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with trace_capture(str(log_dir)):
        torch.ones(64).add_(1.0).sum()
    (path,) = log_dir.glob("trace_*.json")
    assert "traceEvents" in json.loads(path.read_text())


def test_trace_capture_off_does_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for log_dir in (None, ""):
        with trace_capture(log_dir):
            torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == []


def test_app_json_line_keeps_its_keys(tmp_path, capsys):
    (tmp_path / "properties.txt").write_text(TINY_CONFIG)
    assert app.main(["--config", str(tmp_path / "properties.txt"), "--frames", "2",
                     "--out", str(tmp_path / "out"), "--device", "cpu"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert len(lines) == 1
    assert set(lines[0]) == {"frames", "seconds", "rays_per_s"}
    assert lines[0]["frames"] == 2 and lines[0]["rays_per_s"] > 0
