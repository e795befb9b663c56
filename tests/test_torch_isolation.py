"""The port stands alone: it never imports jax, and its chip smoke test
never falls back to the CPU."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "fourd_ray_tracing_tpu_torch"

TINY_CONFIG = """
show_additional_windows = true
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


def port_modules():
    mods = []
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        if parts[-1] != "__main__":
            mods.append(".".join(parts))
    return mods


def run(code, tmp_path, env_extra=None):
    env = {**os.environ, "PYTHONPATH": str(ROOT), **(env_extra or {})}
    return subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_never_imports_jax(tmp_path):
    """With jax and the JAX package blocked, every module imports and the
    app renders on the CPU."""
    (tmp_path / "properties.txt").write_text(TINY_CONFIG)
    code = textwrap.dedent(f"""
        import importlib, sys

        BLOCKED = ("jax", "jaxlib", "fourd_ray_tracing_tpu")

        class BlockJax:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, BlockJax())
        for mod in {port_modules()!r}:
            importlib.import_module(mod)
        from fourd_ray_tracing_tpu_torch import app
        assert app.main(["--config", "properties.txt", "--frames", "2", "--out", "out",
                         "--device", "cpu", "--deterministic"]) == 0
        assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        print("isolated-ok")
    """)
    proc = run(code, tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "isolated-ok" in proc.stdout
    for name in ("yxz.png", "ywz.png", "yxw.png", "layout.json"):
        assert (tmp_path / "out" / name).is_file()
    assert len(port_modules()) >= 15


def test_chip_smoke_fails_without_a_card(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No compiler, no kernel: the build raises instead of falling back."""
    from fourd_ray_tracing_tpu_torch.ops.cuda import build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "_build").exists() or not list((tmp_path / "_build").rglob("*.so"))


def test_build_key_follows_sources_and_flags(monkeypatch):
    from fourd_ray_tracing_tpu_torch.ops.cuda import build

    key = build.build_key()
    assert build.library_path().parent.name == key
    assert any(p.name == "megakernel.cu" for p in build.sources())
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.build_key() != key
    assert "-fmad=false" in build.NVCC_FLAGS and "--use_fast_math" not in build.NVCC_FLAGS
