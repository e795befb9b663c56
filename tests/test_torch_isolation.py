"""The port stands alone: it never imports jax, and its chip smoke test
never falls back to the CPU."""
import json
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
    """With jax, the JAX package and the oracle (the tests' alone) blocked,
    every module of the port, its tools and chip_smoke.py import, every
    configuration of the forward renders on the CPU, the gradient kernels'
    routes take K1's other configurations there (the kernel route's loss
    in trig with newton and in kepler, its gradient finite, and K6's soft
    loss in trig), and the app renders; then a short --interactive stdin
    session with the preview server, the FPS overlay and --save-state, a
    --load-state resume, a packed train state written by inverse_render
    --ckpt and read back, and dryrun's flagship forward (a lazy import
    inside a function shows only when the function runs)."""
    (tmp_path / "properties.txt").write_text(TINY_CONFIG)
    code = textwrap.dedent(f"""
        import importlib, importlib.util, sys

        BLOCKED = ("jax", "jaxlib", "fourd_ray_tracing_tpu", "oracle")

        class BlockJax:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, BlockJax())
        for mod in {port_modules()!r}:
            importlib.import_module(mod)
        spec = importlib.util.spec_from_file_location("chip_smoke", {str(ROOT / "chip_smoke.py")!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        import torch
        from fourd_ray_tracing_tpu_torch.models import library, renderer
        from fourd_ray_tracing_tpu_torch import camera as cam
        from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4
        camera = cam.camera_from_state(Vec4.of(0.0, -2.0, 0.0, 0.0, device="cpu"),
                                       cam.CameraAngles.of(0.0, 0.0, 0.0, device="cpu"), 1.5,
                                       2.0, device="cpu")
        for modes in (dict(), dict(sampler_method="newton", intersect="trig"),
                      dict(rng_mode="per_sample", sampler_method="kepler", intersect="spec")):
            cfg = renderer.RenderConfig(width=8, height=4, samples=2, reflections_amount=2,
                                        **modes)
            assert torch.isfinite(renderer.render_light(library.tiger("cpu"), camera, cfg,
                                                        1)).all()
        from fourd_ray_tracing_tpu_torch import diff
        from fourd_ray_tracing_tpu_torch.models import params
        tiger = library.tiger("cpu")
        for modes in (dict(sampler_method="newton", intersect="trig"),
                      dict(sampler_method="kepler")):
            cfg = renderer.RenderConfig(width=8, height=4, samples=2, reflections_amount=2,
                                        rng_mode="per_sample", **modes)
            vec = params.pack(tiger, camera).requires_grad_(True)
            loss = diff.image_loss_kernel(vec, tiger, camera, cfg, 1, torch.zeros(4, 8, 3))
            loss.backward()
            assert torch.isfinite(loss) and torch.isfinite(vec.grad).all()
        trig = renderer.RenderConfig(width=8, height=4, samples=2, reflections_amount=2,
                                     rng_mode="per_sample", intersect="trig")
        soft = diff.soft_image_loss_kernel(params.pack(tiger, camera), tiger, camera, trig, 1,
                                           torch.zeros(4, 8, 3), object_ref=("tiger", None))
        assert torch.isfinite(soft)
        from fourd_ray_tracing_tpu_torch import app
        assert app.main(["--config", "properties.txt", "--frames", "2", "--out", "out",
                         "--device", "cpu", "--deterministic"]) == 0
        import io
        sys.stdin = io.StringIO("capture\\nw 0.1\\nmouse 4 2\\nwheel 1\\nframes 2\\n"
                                "save live\\nquit\\n")
        assert app.main(["--config", "properties.txt", "--interactive", "--serve", "0",
                         "--device", "cpu", "--deterministic", "--fps-overlay",
                         "--save-state", "state"]) == 0
        assert app.main(["--config", "properties.txt", "--frames", "1", "--out", "resumed",
                         "--device", "cpu", "--load-state", "state", "--fps-overlay"]) == 0
        from fourd_ray_tracing_tpu_torch import inverse_render
        from fourd_ray_tracing_tpu_torch.utils import checkpoint
        argv = ["--device", "cpu", "--impl", "kernel", "--packed", "--width", "8", "--height",
                "4", "--bounces", "1", "--steps", "20", "--tol", "100", "--ckpt", "ckpt"]
        assert inverse_render.main(argv) == 0
        args = inverse_render.parse_args(argv)
        cfg, camera, _, scene0 = inverse_render.setup(args, "cpu")
        _, init, _ = inverse_render.packed_train_step(args, cfg, camera, scene0)
        model, opt = init(scene0)
        assert checkpoint.restore_train_state("ckpt", model.scene_vec, opt.state_dict())[2] == 20
        from fourd_ray_tracing_tpu_torch import dryrun
        forward, example = dryrun.entry("cpu")
        assert torch.isfinite(forward(*example)).all()
        assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        print("isolated-ok")
    """)
    proc = run(code, tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "isolated-ok" in proc.stdout
    for name in ("yxz.png", "ywz.png", "yxw.png", "layout.json"):
        assert (tmp_path / "out" / name).is_file()
        assert name == "layout.json" or (tmp_path / "live" / name).is_file()
    assert (tmp_path / "state" / "state.pt").is_file()
    assert len(port_modules()) >= 15


def test_sharded_runner_and_its_workers_never_import_jax(tmp_path):
    """parallel/ and multihost_run, in the parent and in the spawned
    workers: a sitecustomize on PYTHONPATH blocks jax and the JAX package
    in every process, and the 2-rank run matches the single process."""
    (tmp_path / "sitecustomize.py").write_text(textwrap.dedent("""
        import sys

        class BlockJax:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "fourd_ray_tracing_tpu"):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, BlockJax())
    """))
    env = {**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{ROOT}"}
    proc = subprocess.run([sys.executable, "-m", "fourd_ray_tracing_tpu_torch.multihost_run",
                           "--nprocs", "2", "--device", "cpu", "--timeout", "300"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stderr[-4000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["ok"] and summary["nprocs"] == 2 and summary["backend"] == "gloo"
    assert summary["items"]["image"]["bitwise"]
    assert {"parallel.mesh", "multihost_run"} <= {m.split("fourd_ray_tracing_tpu_torch.")[-1]
                                                   for m in port_modules()}


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
    assert {"gradmodes.cu", "softmodes.cu"} <= {p.name for p in build.sources()}
    assert {"fourd_loss_grad_modes", "fourd_light_vjp_modes",
            "fourd_soft_loss_grad_modes"} <= set(build.SIGNATURES)
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.build_key() != key
    assert "-fmad=false" in build.NVCC_FLAGS and "--use_fast_math" not in build.NVCC_FLAGS


def test_kernels_keep_no_state_between_launches():
    """No kernel source holds device state that outlives a launch: no
    namespace-scope __device__ variable, no __constant__ table the host
    writes. A launch's configuration (the modes launches' sampler included,
    trace.cuh sampler_slot) travels in its arguments, so launches in
    several streams at once never read each other's."""
    import re

    for src in sorted((PACKAGE / "csrc").iterdir()):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        assert not re.search(r"^\s*(?:static\s+)?__device__\s+[^(;{]*;", text, re.M), src.name
        assert "cudaMemcpyToSymbol" not in text, src.name
        for decl in re.findall(r"__constant__[^;]*;", text, re.S):
            assert "=" in decl, (src.name, decl)
