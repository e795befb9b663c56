"""Build the CUDA sources of the port with nvcc and load them with ctypes.

The kernels in ``csrc/*.cu`` expose a plain C interface (no PyTorch
headers). Each source compiles in its own nvcc process, all started
together, and one more nvcc links the objects into a shared library. The
library goes to ``fourd_ray_tracing_tpu_torch/_build/<hash>/``, keyed by a
hash of the sources and flags, built at first use and reused after. A
missing nvcc or a failed build raises with the compiler's output.
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

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libfourd_kernels.so"
# -fmad=false: no a*b+c -> FMA contraction, so the kernel rounds like its
# plain torch version (csrc/megakernel.cu, "Numerics"). Never fast math.
# The gradient kernels' per-thread array sizes: packed parameters
# (cotangents) and bounce records per sample; and the slots K6's zero map
# may overwrite. Their wrappers read them here.
K4_MAX_PARAMS, K4_MAX_BOUNCES, K6_MAX_ZERO_SLOTS = 256, 16, 16
DEFINES = (f"-DFOURD_K4_MAX_PARAMS={K4_MAX_PARAMS}", f"-DFOURD_K4_MAX_BOUNCES={K4_MAX_BOUNCES}",
           f"-DFOURD_K6_MAX_ZERO_SLOTS={K6_MAX_ZERO_SLOTS}")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", *DEFINES,
)

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    for candidate in (shutil.which("nvcc"),
                      os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if candidate and os.path.isfile(candidate):
            return candidate
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: cannot build the CUDA kernels")


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def build_key() -> str:
    h = hashlib.sha256()
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / build_key() / LIB_NAME


def build() -> Path:
    """Compile csrc/*.cu into the keyed shared library unless it exists;
    returns its path. The compilers' output (with -Xptxas -v register and
    shared-memory counts) is kept beside it in build.log."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    lib.parent.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=lib.parent))
    try:
        jobs = []
        for src in (p for p in sources() if p.suffix == ".cu"):
            obj = work / f"{src.stem}.o"
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((src, obj, proc))
        log, failed = "", []
        for src, _, proc in jobs:
            out, _ = proc.communicate()
            log += f"== nvcc {src.name} (exit {proc.returncode})\n{out}"
            if proc.returncode != 0:
                failed.append(src.name)
        if not failed:
            proc = subprocess.run([nvcc, "-shared", "-o", str(work / LIB_NAME),
                                   *(str(obj) for _, obj, _ in jobs)],
                                  capture_output=True, text=True, check=False)
            log += f"== nvcc -shared (exit {proc.returncode})\n{proc.stdout}{proc.stderr}"
            if proc.returncode != 0:
                failed.append("link")
        (lib.parent / "build.log").write_text(log)
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
        os.replace(work / LIB_NAME, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


def build_log() -> str:
    path = library_path().parent / "build.log"
    return path.read_text() if path.exists() else ""


def load() -> ctypes.CDLL:
    """The kernels' library, built and loaded at the first call of the
    process, with argtypes set; later calls return it at once."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        fn = lib.fourd_forward_launch
        fn.argtypes = [
            ctypes.c_void_p,                  # params (P,) or (F, P) float32, device
            ctypes.c_longlong,                # row_stride: 0, or P for (F, P) rows
            ctypes.c_void_p,                  # seeds (F,) uint32, device
            ctypes.c_int,                     # n_frames
            ctypes.c_void_p,                  # layout table (int[14]), host
            ctypes.c_int, ctypes.c_int,       # width, height
            ctypes.c_int, ctypes.c_int,       # row0, n_rows: the launch's block of image rows
            ctypes.c_int, ctypes.c_int,       # samples, reflections
            ctypes.c_float,                   # small_indent
            ctypes.c_void_p,                  # out (F, V, n_rows, W, 3) float32, device
            ctypes.c_void_p,                  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
        fn = lib.fourd_loss_grad_launch
        fn.argtypes = [
            ctypes.c_void_p,                  # params (P,) float32, device
            ctypes.c_void_p,                  # seeds (F,) uint32, device
            ctypes.c_int,                     # n_frames
            ctypes.c_void_p,                  # layout table (int[14]), host
            ctypes.c_int, ctypes.c_int,       # width, height
            ctypes.c_int, ctypes.c_int,       # row0, n_rows: the launch's block of image rows
            ctypes.c_int, ctypes.c_int,       # samples, reflections
            ctypes.c_float, ctypes.c_float,   # small_indent, light_coefficient
            ctypes.c_void_p,                  # target (V, n_rows, W, 3) float32, device
            ctypes.c_float,                   # scale
            ctypes.c_void_p,                  # grad_parts (P, n_cols) float32, device
            ctypes.c_void_p,                  # loss_parts (n_cols,) float64, device
            ctypes.c_void_p,                  # grad out (P,) float32, device
            ctypes.c_void_p,                  # loss out () float32, device
            ctypes.c_void_p,                  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
        fn = lib.fourd_grad_scratch_cols
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_int
        fn = lib.fourd_light_vjp_launch
        fn.argtypes = [
            ctypes.c_void_p,                  # params (P,) or (F, P) float32, device
            ctypes.c_longlong,                # row_stride: 0, or P for (F, P) rows
            ctypes.c_int,                     # params rows F
            ctypes.c_uint32,                  # seed
            ctypes.c_void_p,                  # layout table (int[14]), host
            ctypes.c_int, ctypes.c_int,       # width, height
            ctypes.c_int, ctypes.c_int,       # row0, n_rows: the launch's block of image rows
            ctypes.c_int, ctypes.c_int,       # samples, reflections
            ctypes.c_float,                   # small_indent
            ctypes.c_void_p,                  # cot (F, V, n_rows, W, 3) float32, device
            ctypes.c_void_p,                  # grad_parts (F*P, n_cols) float32, device
            ctypes.c_void_p,                  # grad out (F, P) float32, device
            ctypes.c_void_p,                  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
        fn = lib.fourd_soft_loss_grad_launch
        fn.argtypes = [
            ctypes.c_void_p,                  # params (P,) float32, device
            ctypes.c_uint32,                  # seed
            ctypes.c_void_p,                  # layout table (int[14]), host
            ctypes.c_int,                     # n_zero
            ctypes.c_void_p, ctypes.c_void_p,  # zero-map slots (int[n]), values (float[n]), host
            ctypes.c_int, ctypes.c_int,       # width, height
            ctypes.c_int, ctypes.c_int,       # row0, n_rows: the launch's block of image rows
            ctypes.c_int, ctypes.c_int,       # samples, reflections
            ctypes.c_float, ctypes.c_float,   # small_indent, light_coefficient
            ctypes.c_void_p,                  # target (V, n_rows, W, 3) float32, device
            ctypes.c_void_p,                  # alpha (V, n_rows, W) float32, device
            ctypes.c_float,                   # scale
            ctypes.c_void_p,                  # grad_parts (P, n_cols) float32, device
            ctypes.c_void_p,                  # loss_parts (n_cols,) float64, device
            ctypes.c_void_p,                  # grad out (P,) float32, device
            ctypes.c_void_p,                  # loss out () float32, device
            ctypes.c_void_p,                  # alpha_cot out (V, n_rows, W) float32, device
            ctypes.c_void_p,                  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
        _lib = lib
        return lib
