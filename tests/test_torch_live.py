"""The port's live session (app.py interactive_loop, CaptureState, the
preview server of utils/viewer.py, the FPS overlay of utils/overlay.py)
and the engine's camera half against the JAX package's, on the CPU.

One stdin script goes through the JAX package's app and the port's, once
per module (a JAX session compiles its steps: about 10 s here), on a
tiny config with --no-precompile; the tests read the two sessions' logs,
windows and engines. The JAX engine's jitted step fuses multiply-adds and
flips silhouette pixels against its own eager renderer (7 of 60 pixels
of a 10x6 window here), so the windows are held against the JAX
package's eager renderer over the JAX engine's own cameras and seed
sequence (test_torch_engine_app.py's eager_jax_windows), within
assert_images_close at its 2% boundary share; the port matched it on
every pixel when this was written.
"""
import contextlib
import io
import json
import struct
import sys
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from helpers import assert_images_close

from fourd_ray_tracing_tpu import app as japp
from fourd_ray_tracing_tpu import camera as jcam
from fourd_ray_tracing_tpu.engine import generate_seed
from fourd_ray_tracing_tpu.models import renderer as jrenderer
from fourd_ray_tracing_tpu.utils import overlay as joverlay

from fourd_ray_tracing_tpu_torch import app as tapp
from fourd_ray_tracing_tpu_torch import camera as tcam
from fourd_ray_tracing_tpu_torch.utils import overlay as toverlay
from fourd_ray_tracing_tpu_torch.utils.config import AppConfig
from fourd_ray_tracing_tpu_torch.utils.image import to_uint8

CPU = torch.device("cpu")
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
# Every command of the grammar: gated ones before capture, the
# uncaptured wheel, a recentering mouse offset, escape before the save
# (no FPS overlay: its digits are the session's timing), an unknown one.
SCRIPT = ("look 0.1 0 0\nframes 2\nwheel 1\ncapture\nw 0.25\nmouse 5 3\nmouse 9999 0\n"
          "wheel -1\ne 0.1\nlook 0.02 -0.01 0.03\nframes 3\nescape\nsave {save}\nstats\n"
          "bogus\nquit\n")
WINDOWS = {"yxz": (16, 9), "ywz": (10, 6), "yxw": (10, 6)}
# 127.0.0.1 directly, whatever proxy the environment names.
OPEN = urllib.request.build_opener(urllib.request.ProxyHandler({})).open


def run_session(main, module, config, out, save, extra=()):
    """main(--interactive) fed SCRIPT on stdin: (stdout lines, its engine)."""
    engines = []
    build = module.build_engine

    def spy(*args, **kwargs):
        engines.append(build(*args, **kwargs))
        return engines[-1]

    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.setattr(module, "build_engine", spy)
        mp.setattr(sys, "stdin", io.StringIO(SCRIPT.format(save=save)))
        assert main(["--config", str(config), "--interactive", "--deterministic",
                     "--no-precompile", "--out", str(out), *extra]) == 0
    return buf.getvalue().splitlines(), engines[0]


def eager_jax_windows(je):
    """The JAX engine's windows recomputed with its eager renderer: the
    frames since its last reset (frame_number - 1 of them, the last seeds
    of its sequence) at its current camera, blended as the engine blends."""
    rng, seed, seeds = np.random.default_rng(0), 0, []
    for _ in range(je._rng_draws):
        seed ^= generate_seed(rng, wall_clock=False)
        seeds.append(seed)
    accs = [np.zeros(g.accum.shape, np.float32) for g in je.groups]
    for i, frame_seed in enumerate(seeds[len(seeds) - (je.frame_number - 1):]):
        part = np.float32(1.0 / (i + 1))
        for k, g in enumerate(je.groups):
            img = np.asarray(jrenderer.render_image(je.scene, g.camera(je), g.cfg,
                                                    np.uint32(frame_seed)))
            accs[k] = accs[k] + (img - accs[k]) * part
    return [img for acc in accs for img in (acc[None] if acc.ndim == 3 else acc)]


def engine_state(engine):
    return dict(seed=engine.seed, frame_number=engine.frame_number, rng_draws=engine._rng_draws,
                angles=[float(a) for a in engine.angles], focus=[float(c) for c in engine.focus],
                windows=[(v, np.array(img)) for v, img in engine.windows()])


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """The JAX and the port session of SCRIPT: their logs, their engines'
    states at the session's end, their saved windows' directories and the
    engines."""
    root = tmp_path_factory.mktemp("live")
    config = root / "properties.txt"
    config.write_text(TINY_CONFIG)
    out = {}
    for name, main, module, extra in (("jax", japp.main, japp, ()),
                                      ("torch", tapp.main, tapp, ("--device", "cpu"))):
        lines, engine = run_session(main, module, config, root / f"{name}_out",
                                    root / f"{name}_save", extra)
        out[name] = dict(lines=lines, state=engine_state(engine), save=root / f"{name}_save",
                         engine=engine)
    out["eager"] = eager_jax_windows(out["jax"]["engine"])
    return out


def commands_log(lines, save):
    """The session's log without its timings: JSON lines as their frame
    counts, the header (device names differ) dropped, paths relative."""
    out = []
    for line in lines:
        if line.startswith("scene="):
            continue
        if line.startswith("{"):
            out.append(("stats", json.loads(line)["frames"]))
        else:
            out.append(line.replace(str(save), "SAVE"))
    return out


def test_session_logs_match_jax(sessions):
    jax_log = commands_log(sessions["jax"]["lines"], sessions["jax"]["save"])
    ours = commands_log(sessions["torch"]["lines"], sessions["torch"]["save"])
    assert ours == jax_log
    for line in ("look ignored: cursor not captured (use 'capture')",
                 "frames ignored: cursor not captured (use 'capture')",
                 "cursor recentered", "cursor released", "unknown command: bogus"):
        assert line in ours
    assert ("stats", 8) in ours  # w, mouse, wheel, e, look: one frame each; frames 3


def test_session_engine_state_matches_jax(sessions):
    """Seed, frame counter and seed draws equal; the pose within 1e-6
    (both sessions drive the native controls); the windows within the
    image tolerance of the JAX engine's, recomputed eagerly."""
    ours, ref = sessions["torch"]["state"], sessions["jax"]["state"]
    assert sessions["torch"]["engine"].controls == "native"
    for key in ("seed", "frame_number", "rng_draws"):
        assert ours[key] == ref[key], key
    np.testing.assert_allclose(ours["angles"], ref["angles"], atol=1e-6)
    np.testing.assert_allclose(ours["focus"], ref["focus"], atol=1e-6)
    for (v_t, a), (v_j, _), b in zip(ours["windows"], ref["windows"], sessions["eager"]):
        assert v_t == v_j
        assert_images_close(a, b, atol=1e-5, boundary_frac=0.02, mean_atol=0.05)


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of an 8-bit RGB PNG whose rows all use filter 0
    (utils/image.encode_png's)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    pos, idat = 8, b""
    while pos < len(data):
        (n,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        if tag == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert not raw[:, 0].any()
    return raw[:, 1:].reshape(h, w, 3)


def test_saved_windows_match_jax(sessions):
    """The windows that ``save`` wrote: the JAX session's names and sizes,
    the port's within the image tolerance of the JAX engine's windows
    recomputed eagerly (one 8-bit level)."""
    for (view, size), ref in zip(WINDOWS.items(), sessions["eager"]):
        ours = decode_png((sessions["torch"]["save"] / f"{view}.png").read_bytes())
        theirs = decode_png((sessions["jax"]["save"] / f"{view}.png").read_bytes())
        assert ours.shape == theirs.shape == (size[1], size[0], 3)
        assert_images_close(ours / 255.0, to_uint8(ref) / 255.0, atol=1.5 / 255,
                            boundary_frac=0.02, mean_atol=0.05)


def test_engines_drive_like_jax(sessions):
    """After the session, both engines take the same mouse_moved,
    wheel_scrolled, move and step_frames sequence directly."""
    je, te = sessions["jax"]["engine"], sessions["torch"]["engine"]
    for engine, keys in ((je, jcam.MoveKeys), (te, tcam.MoveKeys)):
        assert engine.mouse_moved(-7, 4)
        assert not engine.mouse_moved(51, 0)  # beyond the border: recenter only
        engine.wheel_scrolled(2.5)
        engine.move(keys(back=True, left=True, w_neg=True), 0.3)
        engine.step_frames(2)
        engine.move(keys(forward=True, back=True), 0.3)  # cancels: no reset
        engine.step_frames(1)
    ours, ref = engine_state(te), engine_state(je)
    assert ours["frame_number"] == ref["frame_number"] == 4
    for key in ("seed", "rng_draws"):
        assert ours[key] == ref[key], key
    np.testing.assert_allclose(ours["angles"], ref["angles"], atol=1e-6)
    np.testing.assert_allclose(ours["focus"], ref["focus"], atol=1e-6)
    for (_, a), b in zip(ours["windows"], eager_jax_windows(je)):
        assert_images_close(a, b, atol=1e-5, boundary_frac=0.02, mean_atol=0.05)


@pytest.fixture
def tiny(tmp_path):
    path = tmp_path / "properties.txt"
    path.write_text(TINY_CONFIG)
    return AppConfig.load(path)


@pytest.mark.parametrize("controls", ["native", "python"])
def test_precompile_preserves_state_and_results(tiny, controls):
    """precompile leaves the seed, frame counter and accumulation bitwise
    as they were, and a warmed engine renders the cold one's frames."""
    def engine():
        e = tapp.build_engine(tiny, CPU, deterministic=True)
        if controls == "python":
            e = tapp.RenderEngine(e.scene, e.cfg, e.focus, e.angles, device=CPU,
                                  deterministic=True, use_native_controls="python",
                                  additional=(e.groups[1].cfg, e.groups[1].views))
        return e

    cold, warm = engine(), engine()
    assert warm.controls == controls
    cold.step_frames(2)
    warm.step_frames(2)
    draws = warm._rng_draws
    assert warm.precompile() >= 0.0
    assert (warm.seed, warm.frame_number, warm._rng_draws) == (cold.seed, cold.frame_number, draws)
    for gw, gc in zip(warm.groups, cold.groups):
        assert torch.equal(gw.accum, gc.accum)
    cold.step_frames(3)
    warm.step_frames(3)
    for gw, gc in zip(warm.groups, cold.groups):
        assert torch.equal(gw.accum, gc.accum)


def test_capture_state_machine_matches_jax():
    ours, ref = tapp.CaptureState(), japp.CaptureState()
    for op in ("capture", "frame_rendered", "capture", "release", "capture", "frame_rendered",
               "release", "release", "capture"):
        getattr(ours, op)()
        getattr(ref, op)()
        assert (ours.captured, ours.fps_suppress) == (ref.captured, ref.fps_suppress), op
    cap = tapp.CaptureState()
    assert not cap.captured
    cap.capture()
    assert cap.captured and cap.fps_suppress
    cap.frame_rendered()
    cap.capture()  # capturing again while captured does not re-arm
    assert not cap.fps_suppress


@pytest.mark.parametrize("fps,text_size", [(59.94, 24), (7.0, 12), (123.45, 36), (0.0, 8)])
def test_draw_fps_bytes_match_jax(fps, text_size, rng_np):
    img = rng_np.random((40, 64, 3), dtype=np.float32)
    ours = toverlay.draw_fps(img, fps, text_size)
    assert ours.dtype == np.float32 and ours.tobytes() == joverlay.draw_fps(img, fps,
                                                                            text_size).tobytes()
    small = img[:5, :7]
    assert toverlay.draw_fps(small, fps, text_size).tobytes() == \
        joverlay.draw_fps(small, fps, text_size).tobytes()


def test_preview_serves_the_published_snapshot(tiny):
    """--serve's server on port 0 at 127.0.0.1: the page lists every
    window; /frame.png is the last published snapshot (not the live
    buffer a later step changed) at the window's size; the stream yields a
    PNG part; POST /cmd hands the line to the command queue."""
    engine = tapp.build_engine(tiny, CPU, deterministic=True)
    engine.step_frames(2)
    snapshot = tapp.Snapshot(engine)
    published = [g.accum.clone() for g in engine.groups]
    engine.step_frames(2)  # not published
    commands = []
    server = tapp.make_preview(engine, port=0, fps=30.0, on_command=commands.append,
                               snapshot=snapshot)
    try:
        base = server.url
        assert base.startswith("http://127.0.0.1:")
        html = OPEN(base, timeout=10).read().decode()
        assert all(f"/stream?view={v}" in html for v in WINDOWS)
        for view, (w, h) in WINDOWS.items():
            png = OPEN(f"{base}frame.png?view={view}", timeout=10).read()
            got = decode_png(png)
            k = 0 if view == "yxz" else 1
            want = published[k] if k == 0 else published[k][engine.groups[1].views.index(view)]
            assert got.shape == (h, w, 3)
            np.testing.assert_array_equal(got, to_uint8(want.numpy()))
        snapshot.publish()
        png = OPEN(base + "frame.png?view=yxz", timeout=10).read()
        np.testing.assert_array_equal(decode_png(png), to_uint8(engine.accum.numpy()))
        resp = OPEN(base + "stream?view=ywz", timeout=10)
        assert "multipart/x-mixed-replace" in resp.headers["Content-Type"]
        head = resp.read(64)
        assert b"--frame" in head and b"image/png" in head
        resp.close()
        req = urllib.request.Request(base + "cmd", data=b"frames 1\n", method="POST")
        assert OPEN(req, timeout=10).status == 204
        assert commands == ["frames 1"]
        big = urllib.request.Request(base + "cmd", data=b"x" * 2048, method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            OPEN(big, timeout=10)
        assert err.value.code == 413 and commands == ["frames 1"]
    finally:
        server.close()


def test_interactive_serve_session_quits_on_a_posted_command(tiny, tmp_path, monkeypatch,
                                                             capsys):
    """--interactive --serve 0 with stdin at its end: the session runs
    from the preview's POST /cmd lines, rendering between commands while
    captured, until a posted quit; --save-state writes the engine's
    checkpoint, which --load-state resumes."""
    import threading
    import time

    path = tmp_path / "properties.txt"
    path.write_text(TINY_CONFIG)
    servers = []
    make = tapp.make_preview
    monkeypatch.setattr(tapp, "make_preview",
                        lambda *a, **k: servers.append(make(*a, **k)) or servers[-1])
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))

    def browser():
        while not servers:
            time.sleep(0.01)
        for line in ("capture", "frames 2", "quit"):
            req = urllib.request.Request(servers[0].url + "cmd", data=line.encode(),
                                         method="POST")
            assert OPEN(req, timeout=10).status == 204

    thread = threading.Thread(target=browser)
    thread.start()
    state = tmp_path / "state"
    rc = tapp.main(["--config", str(path), "--interactive", "--deterministic", "--serve", "0",
                    "--device", "cpu", "--out", str(tmp_path / "o"), "--save-state", str(state)])
    thread.join(timeout=60)
    assert rc == 0 and not thread.is_alive()
    out = capsys.readouterr().out
    assert "live preview at http://127.0.0.1:" in out and "precompile done" in out
    assert "cursor captured (hidden)" in out and f"saved state to {state}" in out
    assert tapp.main(["--config", str(path), "--device", "cpu", "--frames", "1", "--out",
                      str(tmp_path / "o2"), "--load-state", str(state), "--deterministic"]) == 0
    assert "resumed from" in capsys.readouterr().out
