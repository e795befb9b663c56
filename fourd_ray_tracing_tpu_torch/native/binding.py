"""ctypes binding to the native host layer (controls.cc, properties.cc).

Counterpart of the JAX package's native/binding.py, over the port's own
copies of its sources. The library builds with g++ at first use into
``fourd_ray_tracing_tpu_torch/_build/native-<hash>/``, keyed by a hash of
the sources and the compiler flags, never beside the sources; it is
written to a temporary name and renamed into place, so processes that
build it at once never load a partial file. A missing g++ or a failed
build raises (engine.py falls back to the Python camera under
``use_native_controls="auto"``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
LIB_NAME = "libfourd_native.so"
SOURCES = (_DIR / "properties.cc", _DIR / "controls.cc")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class FourdCameraState(ctypes.Structure):
    """Mirror of FourdCameraState in controls.cc (field order is ABI)."""

    _fields_ = [
        ("fi", ctypes.c_float),
        ("te", ctypes.c_float),
        ("psi", ctypes.c_float),
        ("constrain_psi", ctypes.c_int32),
        ("psi_center", ctypes.c_float),
        ("psi_radius", ctypes.c_float),
        ("focus", ctypes.c_float * 4),
        ("forward", ctypes.c_float * 4),
        ("top", ctypes.c_float * 4),
        ("right", ctypes.c_float * 4),
        ("w_drct", ctypes.c_float * 4),
        ("h_forward", ctypes.c_float * 4),
        ("h_right", ctypes.c_float * 4),
        ("v_top", ctypes.c_float * 4),
    ]


KEY_FORWARD = 1 << 0
KEY_BACK = 1 << 1
KEY_RIGHT = 1 << 2
KEY_LEFT = 1 << 3
KEY_TOP = 1 << 4
KEY_DOWN = 1 << 5
KEY_W_POS = 1 << 6
KEY_W_NEG = 1 << 7


def build_key() -> str:
    h = hashlib.sha256()
    for path in SOURCES:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"native-{build_key()}" / LIB_NAME


def build() -> Path:
    """Compile the sources into the keyed library unless it exists;
    returns its path."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: cannot build the native controls")
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, *map(str, SOURCES), "-o", tmp],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed building the native controls:\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load() -> ctypes.CDLL:
    """The native library, built and loaded at the first call of the
    process, with argtypes set."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.fourd_parse_properties.argtypes = [ctypes.c_char_p]
        lib.fourd_parse_properties.restype = ctypes.c_void_p
        lib.fourd_free.argtypes = [ctypes.c_void_p]
        lib.fourd_free.restype = None
        lib.fourd_camera_update.argtypes = [ctypes.POINTER(FourdCameraState)]
        lib.fourd_camera_update.restype = None
        lib.fourd_camera_rotate.argtypes = [
            ctypes.POINTER(FourdCameraState),
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ]
        lib.fourd_camera_rotate.restype = ctypes.c_int32
        lib.fourd_camera_move.argtypes = [
            ctypes.POINTER(FourdCameraState),
            ctypes.c_uint32, ctypes.c_float, ctypes.c_float,
        ]
        lib.fourd_camera_move.restype = ctypes.c_int32
        _lib = lib
        return lib


def parse_properties(text: str) -> Dict[str, str]:
    """Parse a properties file's text with the C++ parser (properties.cc)."""
    lib = load()
    ptr = lib.fourd_parse_properties(text.encode("utf-8"))
    if not ptr:
        raise MemoryError("fourd_parse_properties returned null")
    try:
        raw = ctypes.string_at(ptr).decode("utf-8")
    finally:
        lib.fourd_free(ptr)
    out: Dict[str, str] = {}
    for record in raw.split("\x1e"):
        if not record:
            continue
        key, _, value = record.partition("\x1f")
        out[key] = value
    return out


def new_camera_state(fi: float = 0.0, te: float = 0.0, psi: float = 0.0,
                     focus=(0.0, 0.0, 0.0, 0.0), psi_constraint=None) -> FourdCameraState:
    """A camera state with its bases computed. ``psi_constraint`` is
    (center, radius) or None (psi wraps)."""
    lib = load()
    s = FourdCameraState()
    s.fi, s.te, s.psi = fi, te, psi
    if psi_constraint is not None:
        s.constrain_psi = 1
        s.psi_center, s.psi_radius = psi_constraint
    for i, v in enumerate(focus):
        s.focus[i] = v
    lib.fourd_camera_update(ctypes.byref(s))
    return s


def update(s: FourdCameraState) -> None:
    """Recompute the bases from the angles (after they were set)."""
    load().fourd_camera_update(ctypes.byref(s))


def rotate(s: FourdCameraState, d_fi=0.0, d_te=0.0, d_psi=0.0) -> bool:
    """Mouse-look/wheel rotation; True means accumulation must reset."""
    return bool(load().fourd_camera_rotate(ctypes.byref(s), d_fi, d_te, d_psi))


def move(s: FourdCameraState, keys: int, seconds: float, speed: float) -> bool:
    """Key movement; True if the focus moved (accumulation resets)."""
    return bool(load().fourd_camera_move(ctypes.byref(s), keys, seconds, speed))
