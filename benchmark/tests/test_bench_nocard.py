"""A run without a card fails and prints no result; so does a run from a
directory that holds only BENCHMARK.json and the benchmark's files. The
card test runs a cell for real (skipped without a card)."""
import json
import shutil
import subprocess
import sys

import pytest

from benchmark.tests.helpers import ROOT, need_card

ARGS = ["--workload", "room.render3", "--seed", "2147483659", "--seconds", "1", "--trace", "0"]


def run_from(root):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=root,
                          capture_output=True, text=True, timeout=600)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = run_from(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_from(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.card
def test_a_cell_on_the_card():
    need_card()
    out = subprocess.run([sys.executable, "benchmark/run.py", *ARGS[:-3], "2", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert "k1_roofline" in line["metrics"]
