"""Everything a run finds by name: ``BENCHMARK.json`` at the checkout's
root, a configuration's file, a traffic mix in ``traffic/<name>.json``,
the loop kind it names in ``loops/<kind>.py``, a per-layer metric's
reader in ``metrics/<name>.py`` and a cell's limits in
``limits/<cell>.json`` (all under ``benchmark/``). A later cell, mix,
loop kind or metric is new files and entries: nothing here names one."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = "benchmark"


@dataclass
class Cell:
    """One workload of BENCHMARK.json with what it names, loaded."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    limits: dict = field(default_factory=dict)
    root: Path = ROOT


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return read_json(Path(root) / "BENCHMARK.json")


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    known = ", ".join(sorted(e["name"] for e in entries))
    raise KeyError(f"unknown {what} {name!r}; known: {known}")


def _listed(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The workload ``name`` of BENCHMARK.json under ``root``, with its
    configuration, traffic mix, metrics and limits. KeyError for a name
    that BENCHMARK.json does not hold; FileNotFoundError for a file it
    names that is missing."""
    root = Path(root)
    bench = load_benchmark(root)
    work = _named(bench["workloads"], name, "workload")
    conf = _named(bench["configs"], work["config"], "configuration")
    e2e = [m for m in bench["end_to_end"] if _listed(m, name, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _listed(m, name, names)]
    limits_path = root / BENCH_DIR / "limits" / f"{name}.json"
    return Cell(name=name, chips=int(work["chips"]), config_name=conf["name"],
                config=read_json(root / conf["file"]), traffic_name=work["traffic"],
                traffic=read_json(root / BENCH_DIR / "traffic" / f"{work['traffic']}.json"),
                end_to_end=e2e, per_layer=per_layer, limits=read_json(limits_path)["limits"],
                root=root)


def _module(kind: str, name: str, root: Path):
    """The module of ``<kind>/<name>.py`` under the benchmark's folder."""
    path = Path(root) / BENCH_DIR / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} file for {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(metric: str, root: Path = ROOT):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    return _module("metrics", metric, root).read


def load_loop(kind: str, root: Path = ROOT):
    """The ``Loop`` class of ``loops/<kind>.py``: built as ``Loop(cell,
    seed, device)``, it has ``make_inputs``, ``setup``, ``window(seconds)``,
    ``end_to_end``, ``release`` and ``check``."""
    return _module("loops", kind, root).Loop
