"""The harness finds every cell's configuration, traffic mix, loop kind,
metrics and limits by name, refuses an unknown name, and takes a cell, a
traffic mix, a loop kind and a metric added as new files and entries
alone; BENCHMARK.json keeps to the format the benchmark file is held
to."""
import json
import re
import shutil

import pytest

from benchmark.harness import main, spec
from benchmark.tests.helpers import CELLS, ROOT, tiny

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_files(name):
    cell = spec.load_cell(name)
    assert cell.config["name"] == cell.config_name
    loop = spec.load_loop(cell.traffic["loop"])
    assert all(callable(getattr(loop, f)) for f in ("make_inputs", "setup", "window",
                                                    "end_to_end", "release", "check"))
    assert cell.limits and all(v >= 0 for v in cell.limits.values())
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in e2e, f"{m['name']} moves a metric {name} does not report"
        assert callable(spec.load_reader(m["name"]))


def test_unknown_names_are_refused(tmp_path):
    with pytest.raises(KeyError):
        spec.load_cell("room.nonesuch")
    with pytest.raises(FileNotFoundError):
        spec.load_reader("nonesuch_metric")
    with pytest.raises(FileNotFoundError):
        spec.load_loop("nonesuch")


def test_a_cell_added_by_new_files_alone(tmp_path):
    """A later PR's cell: a new traffic mix, limits and per-layer metric
    file and entries, and nothing else edited; it runs on the CPU."""
    (tmp_path / "benchmark").mkdir()
    for sub in ("configs", "traffic", "loops", "limits", "metrics"):
        shutil.copytree(ROOT / "benchmark" / sub, tmp_path / "benchmark" / sub)
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "room.train2", "config": "room", "traffic": "train2",
                               "chips": 1, "why": "2 frames a step"})
    bench["per_layer"].append({"name": "train.steps_in_window", "unit": "steps",
                               "better": "higher", "source": "host_clock", "layer": "train step",
                               "moves": "train_grad_rays_per_s", "workloads": ["room.train2"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_grad_rays_per_s":
            m["workloads"].append("room.train2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((ROOT / "benchmark/traffic/train.json").read_text())
    (tmp_path / "benchmark/traffic/train2.json").write_text(
        json.dumps(dict(traffic, frames_per_step=2, first_steps=2)))
    shutil.copy(ROOT / "benchmark/limits/room.train4.json",
                tmp_path / "benchmark/limits/room.train2.json")
    (tmp_path / "benchmark/metrics/train.steps_in_window.py").write_text(
        "def read(run):\n    return run.steps\n")
    cell = spec.load_cell("room.train2", tmp_path)
    assert cell.traffic["frames_per_step"] == 2
    assert [m["name"] for m in cell.per_layer][-1] == "train.steps_in_window"
    cell.config = tiny(cell.config)
    result, _ = main.run_cell(cell, 2**31 + 17, 0.2, False, "cpu")
    assert result["correct"] is True
    assert set(result["metrics"]) == {"setup_s", "train_grad_rays_per_s"}


ECHO_LOOP = """
import time


class Loop:
    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.spans = cell, seed, []

    def make_inputs(self):
        self.value = self.seed % 7

    def setup(self):
        self.answer = None

    def window(self, seconds):
        t0, n = time.perf_counter(), 0
        while time.perf_counter() - t0 < seconds:
            self.answer, n = self.value * 2, n + 1
        self.window_span = (t0, time.perf_counter())
        self.steps = n
        return {"attempted": n, "window_s": self.window_span[1] - t0}

    def end_to_end(self):
        return {"echo_per_s": self.steps / (self.window_span[1] - self.window_span[0])}

    def release(self):
        pass

    def check(self):
        return {"echo_gap": abs(self.answer - 2 * (self.seed % 7))}
"""


def test_a_loop_kind_added_by_new_files_alone(tmp_path):
    """A later PR's traffic that needs a loop of its own: ``loops/<kind>.py``
    and a mix naming it, a cell, an end-to-end metric, and nothing edited."""
    (tmp_path / "benchmark").mkdir()
    for sub in ("configs", "traffic", "loops", "limits", "metrics"):
        shutil.copytree(ROOT / "benchmark" / sub, tmp_path / "benchmark" / sub)
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "room.echo", "config": "room", "traffic": "echo",
                               "chips": 1, "why": "a loop kind from a new file"})
    bench["end_to_end"].append({"name": "echo_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.1, "source": "host_clock", "workloads": ["room.echo"]})
    bench["per_layer"].append({"name": "echo.steps", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "echo", "moves": "echo_per_s",
                               "workloads": ["room.echo"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "benchmark/loops/echo.py").write_text(ECHO_LOOP)
    (tmp_path / "benchmark/traffic/echo.json").write_text(json.dumps({"loop": "echo"}))
    (tmp_path / "benchmark/limits/room.echo.json").write_text(
        json.dumps({"limits": {"echo_gap": 0}}))
    (tmp_path / "benchmark/metrics/echo.steps.py").write_text(
        "def read(run):\n    return run.steps\n")
    cell = spec.load_cell("room.echo", tmp_path)
    result, loop = main.run_cell(cell, 2**31 + 23, 0.05, False, "cpu")
    assert type(loop).__module__ == "benchmark_loops_echo"
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "echo_per_s"}
    assert result["metrics"]["echo_per_s"]["value"] > 0
    assert list(result)[-1] == "check"


def test_benchmark_json_keeps_to_its_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    r = BENCH["run_seconds"]
    assert 1 <= r <= 51 and (2 + 14 * 24) * (r + 60) + 24 * 180 + 1200 <= 43200
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= cells
    assert len(json.dumps(BENCH)) < 64 * 1024
