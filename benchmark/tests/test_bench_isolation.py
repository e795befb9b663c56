"""What the benchmark loads: the harness, its readers and the reference
load no module whose top-level name (the part before the first dot,
compared whole) is jax, jaxlib, flax or the JAX package, and the
reference loads nothing of the port."""
import ast
import subprocess
import sys

from benchmark.tests.helpers import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "fourd_ray_tracing_tpu"}
PORT = "fourd_ray_tracing_tpu_torch"


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(ROOT)!r}); {code}; "
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, check=True, timeout=300, cwd=ROOT)
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    readers = "; ".join(f"spec.load_reader({p.stem!r})"
                        for p in sorted((ROOT / "benchmark/metrics").glob("*.py")))
    loops = "; ".join(f"spec.load_loop({p.stem!r})"
                      for p in sorted((ROOT / "benchmark/loops").glob("*.py"))
                      if p.stem != "__init__")
    names = loaded_after("from benchmark.harness import main, spec, precision; "
                         f"import benchmark.calibrate; {readers}; {loops}")
    assert not names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    modules = sorted(p.relative_to(ROOT).with_suffix("").as_posix().replace("/", ".")
                     for p in (ROOT / "benchmark/reference").rglob("*.py"))
    names = loaded_after("; ".join(f"import {m}" for m in modules))
    assert not names & (FORBIDDEN | {PORT})


def test_reference_sources_import_nothing_of_the_program():
    for path in (ROOT / "benchmark/reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]}
            else:
                continue
            assert not tops & (FORBIDDEN | {PORT}), f"{path}: imports {tops}"


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    from benchmark.harness import main

    monkeypatch.setitem(sys.modules, "fourd_ray_tracing_tpu_torch_like", sys)
    assert "fourd_ray_tracing_tpu" not in main.forbidden_modules()
    monkeypatch.setitem(sys.modules, "fourd_ray_tracing_tpu.models", sys)
    assert main.forbidden_modules() == ["fourd_ray_tracing_tpu"]
