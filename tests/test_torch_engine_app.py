"""The port's engine and batch app against the JAX package's, on the CPU."""
import dataclasses
import io
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import assert_images_close

from fourd_ray_tracing_tpu import app as japp
from fourd_ray_tracing_tpu import camera as jcam
from fourd_ray_tracing_tpu.engine import RenderEngine as JEngine
from fourd_ray_tracing_tpu.models import library as jlib
from fourd_ray_tracing_tpu.models import renderer as jrenderer
from fourd_ray_tracing_tpu.ops.vec4 import Vec4 as JVec4
from fourd_ray_tracing_tpu.utils.config import AppConfig as JAppConfig
from fourd_ray_tracing_tpu.utils.config import Properties as JProperties
from fourd_ray_tracing_tpu.utils.config import parse_properties_text

from fourd_ray_tracing_tpu_torch import app as tapp
from fourd_ray_tracing_tpu_torch import camera as tcam
from fourd_ray_tracing_tpu_torch import engine as tengine
from fourd_ray_tracing_tpu_torch.models import library as tlib
from fourd_ray_tracing_tpu_torch.models import renderer as trenderer
from fourd_ray_tracing_tpu_torch.ops.cuda import megakernel as tkernel
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4 as TVec4
from fourd_ray_tracing_tpu_torch.utils.config import AppConfig as TAppConfig

CPU = torch.device("cpu")
MAIN = dict(width=32, height=20, samples=2, reflections_amount=2, rng_mode="per_sample")
ADD = dict(width=20, height=12, samples=2, reflections_amount=2, rng_mode="per_sample")


def jax_engine():
    return JEngine(
        jlib.room_with_sphere(), jrenderer.RenderConfig(**MAIN), JVec4.of(0.0, -2.0, 0.0, 0.0),
        jcam.CameraAngles(jnp.float32(0.0), jnp.float32(0.0), jnp.float32(0.0)),
        impl="xla", deterministic=True, use_native_controls="python",
        psi_constraint=(0.0, 0.785),
        additional=(jrenderer.RenderConfig(**ADD), ("ywz", "yxw")),
    )


def torch_engine(impl="torch", scene=None, controls="auto"):
    return tengine.RenderEngine(
        tlib.room_with_sphere(CPU) if scene is None else scene, trenderer.RenderConfig(**MAIN),
        TVec4.of(0.0, -2.0, 0.0, 0.0, device=CPU), tcam.CameraAngles.of(0.0, 0.0, 0.0, device=CPU),
        device=CPU, impl=impl, deterministic=True, psi_constraint=(0.0, 0.785),
        additional=(trenderer.RenderConfig(**ADD), ("ywz", "yxw")), use_native_controls=controls,
    )


def eager_jax_windows(je, n_frames):
    """The JAX engine's accumulation recomputed with its eager renderer
    (op by op, no fusion), over the engine's own seed sequence."""
    from fourd_ray_tracing_tpu.engine import generate_seed

    rng, seed = np.random.default_rng(0), 0
    accs = [np.zeros(g.accum.shape, np.float32) for g in je.groups]
    for frame in range(1, n_frames + 1):
        seed ^= generate_seed(rng, wall_clock=False)
        part = np.float32(1.0 / frame)
        for k, g in enumerate(je.groups):
            img = np.asarray(jrenderer.render_image(je.scene, g.camera(je), g.cfg, np.uint32(seed)))
            accs[k] = accs[k] + (img - accs[k]) * part
    return [img for acc in accs for img in (acc[None] if acc.ndim == 3 else acc)]


def test_engine_matches_jax_engine():
    """Same seed sequence and windows. Against the JAX package's eager
    renderer the port agrees to 1e-5 on all but test_pallas.py's 2% of
    pixels (measured: every pixel). The JAX engine's jitted step fuses
    multiply-adds and so flips silhouette pixels against its own eager
    renderer (measured 1.4-3.3% at these sizes): against it, 5%."""
    je, te = jax_engine(), torch_engine()
    eager = eager_jax_windows(je, 3)
    je.step_frames(3)
    te.step_frames(3)
    assert te.seed == je.seed and te.frame_number == je.frame_number == 4
    jw, tw = je.windows(), te.windows()
    assert [v for v, _ in tw] == [v for v, _ in jw] == ["yxz", "ywz", "yxw"]
    for (_, a), (_, b), c in zip(tw, jw, eager):
        assert a.shape == b.shape == c.shape
        assert_images_close(a, c, atol=1e-5, boundary_frac=0.02, mean_atol=0.05)
        assert_images_close(a, b, atol=1e-5, boundary_frac=0.05, mean_atol=0.05)


def test_generate_seed_sequence_matches_jax():
    from fourd_ray_tracing_tpu.engine import generate_seed as jseed

    a, b = np.random.default_rng(0), np.random.default_rng(0)
    assert [tengine.generate_seed(a, False) for _ in range(16)] == [jseed(b, False) for _ in range(16)]


def test_step_frames_is_bitwise_single_steps():
    """9 frames in one 9-frame launch per group = 9 single-frame steps."""
    batched, single = torch_engine("cuda"), torch_engine("cuda")
    batched.step_frames(9)
    for _ in range(9):
        single.step_frame()
    assert batched.seed == single.seed and batched.frame_number == single.frame_number == 10
    for g_b, g_s in zip(batched.groups, single.groups):
        assert torch.equal(g_b.accum, g_s.accum)


def test_rotate_resets_accumulation():
    te = torch_engine()
    te.step_frame()
    te.rotate(d_fi=0.1, d_psi=2.0)
    assert te.frame_number == 1
    assert abs(float(te.angles.fi) - 0.1) < 1e-7
    assert float(te.angles.psi) == pytest.approx(0.785, abs=1e-6)  # clamped by the constraint
    assert te.rays_per_frame() == 32 * 20 * 2 + 2 * 20 * 12 * 2


def test_still_camera_builds_each_groups_inputs_once():
    """Over several steps with the camera still each group builds its
    camera once, and the frames are bitwise those of an engine that
    rebuilds them every step."""
    kept, rebuilt = torch_engine("cuda"), torch_engine("cuda")
    for _ in range(3):
        kept.step_frames(2)
        rebuilt._pose += 1  # a new pose generation: every group rebuilds
        rebuilt.step_frames(2)
    assert [g.builds for g in kept.groups] == [1, 1]
    assert [g.builds for g in rebuilt.groups] == [3, 3]
    for g_k, g_r in zip(kept.groups, rebuilt.groups):
        assert torch.equal(g_k.accum, g_r.accum)


def _smaller_sphere(scene):
    s0 = scene.spheres[0]
    return scene._replace(spheres=(s0._replace(r=s0.r * 0.8),) + scene.spheres[1:])


def _load_rotated_state(engine):
    other = torch_engine("cuda", controls=engine.controls)
    other.rotate(d_fi=-0.15, d_te=0.05)
    other.step_frame()
    engine.load_state_dict(other.state_dict())


# (controls, what changes, whether the next step rebuilds the launch inputs)
CHANGES = {
    "rotate": ("auto", lambda e: e.rotate(d_fi=0.1, d_psi=0.05), True),
    "move": ("auto", lambda e: e.move(tcam.MoveKeys(forward=True, w_pos=True), 0.1), True),
    "move_cancelled": ("auto", lambda e: e.move(tcam.MoveKeys(forward=True, back=True), 0.1),
                       False),
    "angles_setter": ("auto", lambda e: setattr(
        e, "angles", tcam.CameraAngles.of(0.05, -0.02, 0.1, device=CPU)), True),
    "focus_setter": ("auto", lambda e: setattr(
        e, "focus", TVec4.of(0.1, -1.8, 0.05, 0.0, device=CPU)), True),
    "load_state_dict": ("auto", _load_rotated_state, True),
    "new_scene": ("auto", lambda e: setattr(e, "scene", _smaller_sphere(e.scene)), True),
    "scene_in_place": ("auto", lambda e: e.scene.spheres[0].r.mul_(0.8), True),
    "python_rotate": ("python", lambda e: e.rotate(d_fi=0.1), True),
    "python_pose_in_place": ("python", lambda e: e._angles.fi.add_(0.1), True),
    "python_move_cancelled": ("python", lambda e: e.move(
        tcam.MoveKeys(right=True, left=True), 0.1), False),
}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_a_change_of_pose_or_scene_rebuilds_the_launch_inputs(change):
    """After each change of pose or scene the next step builds each group's
    camera anew (a cancelled move is none), and its accumulations are
    bitwise those of a freshly built engine at that pose and scene from
    the same state."""
    controls, apply, rebuilds = CHANGES[change]
    engine = torch_engine("cuda", controls=controls)
    engine.step_frame()
    apply(engine)
    fresh = torch_engine("cuda", scene=engine.scene, controls=controls)
    fresh.load_state_dict(engine.state_dict())
    engine.step_frames(2)
    fresh.step_frames(2)
    assert [g.builds for g in engine.groups] == [1 + rebuilds] * 2
    for g_e, g_f in zip(engine.groups, fresh.groups):
        assert torch.equal(g_e.accum, g_f.accum)


def test_engine_rejects_unknown_impl():
    with pytest.raises(ValueError):
        torch_engine("auto")


TINY_CONFIG = """
show_additional_windows = true
window.main.width = 64
window.main.cell_size = 4
window.additional.width = 40
window.additional.cell_size = 4
ray_tracing.samples = 2
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
scene = room_with_sphere
"""


@pytest.fixture
def tiny_config(tmp_path):
    p = tmp_path / "properties.txt"
    p.write_text(TINY_CONFIG)
    return p


def jax_config(path):
    """The JAX package's AppConfig, parsed in Python (its native parser
    is not built here)."""
    return JAppConfig.from_properties(JProperties(parse_properties_text(path.read_text())))


@pytest.mark.parametrize("config", ["tiny", "repo"])
def test_config_parses_like_jax(config, tiny_config):
    """The port's own AppConfig: same fields, values and window sizes."""
    path = tiny_config if config == "tiny" else Path(__file__).resolve().parents[1] / "configs" / "properties.txt"
    ours, ref = TAppConfig.load(path), jax_config(path)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for w_ours, w_ref in [(ours.main_window, ref.main_window), (ours.additional_window, ref.additional_window)]:
        assert (w_ours.height, w_ours.cells_width, w_ours.cells_height) == \
            (w_ref.height, w_ref.cells_width, w_ref.cells_height)
    assert tapp.window_layout(ours) == japp.window_layout(ref)


def test_png_bytes_match_jax(rng_np):
    from fourd_ray_tracing_tpu.utils.image import encode_png as j_encode
    from fourd_ray_tracing_tpu_torch.utils.image import encode_png as t_encode

    img = rng_np.random((7, 5, 3), dtype=np.float32) * 1.2 - 0.1
    assert t_encode(img) == j_encode(img)


def png_size(path):
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    return int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")


def test_app_writes_windows_and_layout(tiny_config, tmp_path):
    out = tmp_path / "out"
    before = tkernel.LAUNCHES
    rc = tapp.main(["--config", str(tiny_config), "--frames", "3", "--out", str(out),
                    "--device", "cpu", "--deterministic"])
    assert rc == 0
    assert png_size(out / "yxz.png") == (16, 9)
    assert png_size(out / "ywz.png") == png_size(out / "yxw.png") == (10, 6)
    assert json.loads((out / "layout.json").read_text()) == json.loads(
        json.dumps(japp.window_layout(jax_config(tiny_config))))
    assert tkernel.LAUNCHES == before  # CPU tensors: the plain pipeline


def test_app_engine_matches_jax_build_engine(tiny_config, monkeypatch):
    """Same window configs, cameras and first frame as the JAX app's
    engine (first frame against its eager renderer, as above). The JAX
    engine keeps its Python camera state: its native library is not
    loaded (nor built) here. On the CPU the JAX engine runs impl="xla",
    without hints; the port's engine (impl="cuda") holds the static hints
    that the JAX engine derives for impl="pallas" (engine.py:196-228)."""
    from fourd_ray_tracing_tpu.models.scene import plane_norm_hints, plane_pair_hints
    from fourd_ray_tracing_tpu.native import binding
    from fourd_ray_tracing_tpu.ops.pallas.megakernel import _pack_pytree
    from fourd_ray_tracing_tpu_torch.models import params

    def no_native():
        raise OSError("native controls are not used by this test")

    monkeypatch.setattr(binding, "load", no_native)
    je = japp.build_engine(jax_config(tiny_config), deterministic=True)
    assert je._native is None
    te = tapp.build_engine(TAppConfig.load(tiny_config), CPU, deterministic=True)
    hints = plane_norm_hints(je.scene)
    for gt, gj in zip(te.groups, je.groups):
        assert gt.views == gj.views
        assert (gt.cfg.plane_hints, gt.cfg.plane_pairs) == (
            hints, plane_pair_hints(je.scene, hints))
        unhinted = dataclasses.replace(gt.cfg, plane_hints=None, plane_pairs=None)
        assert dataclasses.asdict(unhinted) == dataclasses.asdict(gj.cfg)
        np.testing.assert_array_equal(params.pack(te.scene, gt.camera(te)).numpy(),
                                      np.asarray(_pack_pytree((je.scene, gj.camera(je)))[0]))
    eager = eager_jax_windows(je, 1)
    te.step_frame()
    for (_, a), b in zip(te.windows(), eager):
        assert_images_close(a, b, atol=1e-5, boundary_frac=0.02, mean_atol=0.05)


def test_app_upscale(tiny_config, tmp_path):
    out = tmp_path / "up"
    assert tapp.main(["--config", str(tiny_config), "--frames", "1", "--out", str(out),
                      "--device", "cpu", "--upscale"]) == 0
    assert png_size(out / "yxz.png") == (64, 36)


@pytest.mark.parametrize("flag", ["--interactive", "--serve=0", "--precompile", "--save-state=x"])
def test_app_rejects_unported_flags(flag, tiny_config, tmp_path, capsys, monkeypatch):
    """The four flags the batch-only port once refused now run on the CPU:
    a stdin session, the preview server, the precompile, and a checkpoint
    that --load-state resumes."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("sys.stdin", io.StringIO("capture\nframes 2\nstats\nquit\n"))
    assert tapp.main(["--config", str(tiny_config), "--device", "cpu", "--deterministic",
                      "--frames", "1", "--out", "o", flag]) == 0
    out = capsys.readouterr().out
    expect = {"--interactive": ["cursor captured (hidden)", "precompile done",
                                '{"frames": 2'],
              "--serve=0": ["live preview at http://127.0.0.1:", "precompile done",
                            "wrote o/yxz.png"],
              "--precompile": ["precompile done", "wrote o/yxz.png"],
              "--save-state=x": ["saved state to x"]}[flag]
    assert all(line in out for line in expect), out
    if flag == "--save-state=x":
        assert tapp.main(["--config", str(tiny_config), "--device", "cpu", "--frames", "1",
                          "--out", "o2", "--load-state", "x"]) == 0
        assert "resumed from x at frame 2" in capsys.readouterr().out


def test_app_cuda_without_a_card_raises(tiny_config, tmp_path, monkeypatch):
    """--device cuda never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapp.main(["--config", str(tiny_config), "--out", str(tmp_path / "o"), "--device", "cuda"])


def test_app_unported_scene_raises(tiny_config, tmp_path):
    """Once refused, the tiger (configs/properties.txt's own scene) now
    renders: the tiny app on the CPU writes its windows, not constant."""
    out = tmp_path / "o"
    assert tapp.main(["--config", str(tiny_config), "--scene", "tiger", "--device", "cpu",
                      "--frames", "1", "--out", str(out)]) == 0
    assert png_size(out / "yxz.png") == (16, 9) and png_size(out / "ywz.png") == (10, 6)
    app = dataclasses.replace(TAppConfig.load(tiny_config), scene="tiger")
    engine = tapp.build_engine(app, torch.device("cpu"), deterministic=True)
    assert engine.cfg.axis_hints is not None  # derived beside the plane hints
    engine.step_frames(1)
    assert all(float(g.accum.std()) > 0 for g in engine.groups)
