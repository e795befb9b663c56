"""The port's native host layer (native/: controls.cc, properties.cc) and
camera movement against the JAX package's, on the CPU.

The same C++ built with the same flags must leave the camera state
bitwise equal through a seeded sequence of rotations and moves; the
port's Python camera (camera.py) must track it within 1e-6, as the JAX
package's test_native.py holds its own jnp camera.
"""
import ctypes
import shutil
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourd_ray_tracing_tpu import camera as jcam
from fourd_ray_tracing_tpu.ops.vec4 import Vec4 as JVec4

from fourd_ray_tracing_tpu_torch import camera as tcam
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4 as TVec4
from fourd_ray_tracing_tpu_torch.utils.config import parse_properties_text

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
BASES = ("forward", "top", "right", "w_drct", "h_forward", "h_right", "v_top")
ORIENT = dict(forward="forward", top="top", right="right", w_drct="w_drct",
              h_forward="horizontal_forward", h_right="horizontal_right", v_top="vertical_top")
SAMPLE = """
# comment
a = 1
window.main.width = 850   # trailing comment
  spaced.key   =   value with spaces
dup = first
dup = second
noequals line
= novalue
"""


@pytest.fixture(scope="module")
def native():
    """(the port's binding, the JAX package's), both built with g++."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native controls")
    from fourd_ray_tracing_tpu.native import binding as jbinding
    from fourd_ray_tracing_tpu_torch.native import binding

    binding.load()
    # The JAX package builds its library in place, beside its sources: a
    # test process that loads it while another one's g++ still writes it
    # reads a partial file. Its load caches only a success, so try again.
    for attempt in range(40):
        try:
            jbinding.load()
            break
        except OSError:
            if attempt == 39:
                raise
            time.sleep(0.5)
    return binding, jbinding


def seeded_script(seed=3, n=24):
    """A seeded sequence of ("rotate", d_fi, d_te, d_psi) and ("move",
    key mask, seconds, speed) calls."""
    rng = np.random.default_rng(seed)
    calls = []
    for _ in range(n):
        if rng.random() < 0.5:
            calls.append(("rotate", *(float(v) for v in rng.uniform(-2.0, 2.0, 3).astype(np.float32))))
        else:
            calls.append(("move", int(rng.integers(0, 256)), float(np.float32(rng.uniform(0.0, 0.5))),
                          float(np.float32(rng.uniform(0.5, 4.0)))))
    return calls


def keys_of(mask, binding):
    return tcam.MoveKeys(*(bool(mask & bit) for bit in (
        binding.KEY_FORWARD, binding.KEY_BACK, binding.KEY_RIGHT, binding.KEY_LEFT,
        binding.KEY_TOP, binding.KEY_DOWN, binding.KEY_W_POS, binding.KEY_W_NEG)))


def test_parse_properties_matches_jax(native):
    binding, jbinding = native
    text = (ROOT / "configs" / "properties.txt").read_text()
    assert binding.parse_properties(text) == jbinding.parse_properties(text)
    assert binding.parse_properties(SAMPLE) == jbinding.parse_properties(SAMPLE) == \
        parse_properties_text(SAMPLE)


@pytest.mark.parametrize("psi_constraint", [None, (0.1, 0.7)], ids=["wrap", "clamp"])
def test_camera_state_matches_jax_bitwise(native, psi_constraint):
    """Same C++, same flags: every field of the state (angles, focus, the
    seven bases) bitwise equal after each call of the seeded sequence."""
    binding, jbinding = native
    kw = dict(fi=0.3, te=-0.2, psi=0.05, focus=(0.0, -2.0, 0.5, 0.25),
              psi_constraint=psi_constraint)
    ours, ref = binding.new_camera_state(**kw), jbinding.new_camera_state(**kw)
    assert ctypes.sizeof(ours) == ctypes.sizeof(ref)
    assert bytes(ours) == bytes(ref)
    for kind, *call in seeded_script():
        if kind == "rotate":
            assert binding.rotate(ours, *call) == jbinding.rotate(ref, *call)
        else:
            assert binding.move(ours, *call) == jbinding.move(ref, *call)
        assert bytes(ours) == bytes(ref), (kind, call)


def test_python_camera_tracks_the_native_state(native):
    """The port's Python camera (normalized angles, orientation_from_angles,
    move_focus) follows the native state within 1e-6 through the seeded
    sequence."""
    binding, _ = native
    constraint = (0.1, 0.7)
    s = binding.new_camera_state(fi=0.3, te=-0.2, psi=0.05, focus=(0.0, -2.0, 0.5, 0.25),
                                 psi_constraint=constraint)
    angles = tcam.CameraAngles.of(0.3, -0.2, 0.05, device=CPU)
    focus = TVec4.of(0.0, -2.0, 0.5, 0.25, device=CPU)
    for kind, *call in seeded_script(seed=4):
        if kind == "rotate":
            binding.rotate(s, *call)
            angles = tcam.CameraAngles(*(a + float(d) for a, d in zip(angles, call))).normalized(
                *constraint)
        else:
            mask, seconds, speed = call
            moved = binding.move(s, mask, seconds, speed)
            orient = tcam.orientation_from_angles(*angles, CPU)
            new_focus, t_moved = tcam.move_focus(focus, orient, keys_of(mask, binding), seconds,
                                                 speed)
            assert bool(t_moved) == moved
            focus = new_focus if moved else focus
        np.testing.assert_allclose([float(a) for a in angles], [s.fi, s.te, s.psi], atol=1e-6)
        np.testing.assert_allclose([float(c) for c in focus], list(s.focus), atol=1e-6)
        orient = tcam.orientation_from_angles(*angles, CPU)
        for name in BASES:
            np.testing.assert_allclose([float(c) for c in getattr(orient, ORIENT[name])],
                                       list(getattr(s, name)), atol=1e-6, err_msg=name)


def test_move_focus_matches_jax(rng_np):
    """move_focus on seeded keys, seconds and angles: within 1e-6 of the
    JAX package's, ``moved`` equal."""
    for _ in range(32):
        fi, te, psi = (float(v) for v in rng_np.uniform(-3.0, 3.0, 3).astype(np.float32))
        focus = [float(v) for v in rng_np.uniform(-2.0, 2.0, 4).astype(np.float32)]
        keys = tcam.MoveKeys(*(bool(b) for b in rng_np.integers(0, 2, 8)))
        seconds, speed = (float(np.float32(v)) for v in rng_np.uniform(0.0, 2.0, 2))
        t_focus, t_moved = tcam.move_focus(
            TVec4.of(*focus, device=CPU), tcam.orientation_from_angles(
                *tcam.CameraAngles.of(fi, te, psi, device=CPU), CPU),
            keys, seconds, speed)
        j_focus, j_moved = jcam.move_focus(
            JVec4.of(*focus), jcam.orientation_from_angles(jnp.float32(fi), jnp.float32(te),
                                                           jnp.float32(psi)),
            jcam.MoveKeys(*keys), jnp.float32(seconds), jnp.float32(speed))
        assert bool(t_moved) == bool(j_moved)
        np.testing.assert_allclose([float(c) for c in t_focus], [float(c) for c in j_focus],
                                   atol=1e-6)


def test_pull_into_range_matches_jax(rng_np):
    x = rng_np.uniform(-3.0, 3.0, 64).astype(np.float32)
    np.testing.assert_array_equal(tcam.pull_into_range(torch.from_numpy(x), 0.25, 1.0).numpy(),
                                  np.asarray(jcam.pull_into_range(jnp.asarray(x), 0.25, 1.0)))


def test_native_rotation_normalization(native):
    binding, _ = native
    s = binding.new_camera_state(fi=3.0, te=1.4)
    binding.rotate(s, d_fi=0.5)  # wraps past pi
    assert -np.pi < s.fi <= np.pi
    binding.rotate(s, d_te=1.0)  # clamps at pi/2
    assert abs(s.te) <= np.pi / 2 + 1e-6
    assert not binding.move(s, 0, 0.5, 3.0)  # no keys, no move


def test_library_builds_under_the_ignored_build_dir(native, tmp_path, monkeypatch):
    """The library lands in _build/native-<hash>/ (keyed by sources and
    flags), never beside the sources; without g++ the build raises."""
    binding, _ = native
    path = binding.library_path()
    assert path.is_file() and path.parent.parent == ROOT / "fourd_ray_tracing_tpu_torch" / "_build"
    assert path.parent.name == f"native-{binding.build_key()}"
    assert not list((ROOT / "fourd_ray_tracing_tpu_torch" / "native").glob("*.so"))
    monkeypatch.setattr(binding, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        binding.build()
