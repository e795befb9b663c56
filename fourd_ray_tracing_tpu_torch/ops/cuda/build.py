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
import re
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
# The gradient kernels' caps: packed parameters (a sweep block holds the
# params row and its threads' columns, (P + 1) x 65 floats, and a byte a
# slot in shared memory, which must fit the SM's 227 KB: 265 P bytes),
# bounce records per sample (the generic instance), and the slots K6's zero
# map may overwrite; and the bounce count of every main-path
# configuration, which has its own unrolled instance. Their wrappers read
# them here.
K4_MAX_PARAMS, K4_MAX_BOUNCES, K4_MAIN_BOUNCES, K6_MAX_ZERO_SLOTS = 768, 16, 4, 16
# K1's static hints descriptor (csrc/trace.cuh Hints): the counts, then up
# to MAX_HINT_PLANES / 2 pairs and MAX_HINT_PLANES singles; then the
# composite primitives: the cylinder count and the four offsets
# (HINT_COMPOSITES is the first), and the axis hints of up to
# MAX_CYLINDERS cylinders, the duocylinder's two families, the hypercube
# and the tiger's two families.
MAX_HINT_PLANES = 64
MAX_CYLINDERS = 16
HINT_COMPOSITES = 2 + MAX_HINT_PLANES // 2 + MAX_HINT_PLANES
HINT_INTS = HINT_COMPOSITES + 5 + MAX_CYLINDERS + 2 + 1 + 2
DEFINES = (f"-DFOURD_K4_MAX_PARAMS={K4_MAX_PARAMS}", f"-DFOURD_K4_MAX_BOUNCES={K4_MAX_BOUNCES}",
           f"-DFOURD_K4_MAIN_BOUNCES={K4_MAIN_BOUNCES}",
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
    return build_log_of(library_path())


def kernel_resources(log: str) -> dict:
    """Each function's registers, stack frame and spill stores (bytes), by
    mangled name, as ``-Xptxas -v`` reports them in a build log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m and name:
            out[name].update(stack_bytes=int(m.group(1)), spill_bytes=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


# CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES (cuda.h): a launch with
# more than 48 KB of dynamic shared memory sets it first, and so does the
# occupancy query of such a launch.
_MAX_DYNAMIC_SHARED = 8


def resident_warps(lib: Path, launches: dict) -> dict:
    """Resident warps per SM on the current card of the kernels of the
    built library ``lib``, by mangled name: ``launches`` maps a pattern of
    mangled names to the (threads a block, dynamic shared-memory bytes) of
    their launch, and every kernel that matches a pattern (the first it
    matches) is queried at that launch, with libcuda's
    cuOccupancyMaxActiveBlocksPerMultiprocessor on the library's cubins,
    which ``cuobjdump -xelf`` extracts. Works on any build of the sources,
    an older tree's too. The CUDA context must exist (torch made it)."""
    tool = Path(find_nvcc()).with_name("cuobjdump")
    shapes = {}
    for name in kernel_resources(build_log_of(lib)):
        shape = next((v for pattern, v in launches.items() if re.search(pattern, name)), None)
        if shape is not None:
            shapes[name] = shape
    cuda = ctypes.CDLL("libcuda.so.1")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([str(tool), "-xelf", "all", str(Path(lib).resolve())], cwd=tmp,
                       capture_output=True, check=True)
        for cubin in sorted(Path(tmp).glob("*.cubin")):
            mod = ctypes.c_void_p()
            if cuda.cuModuleLoad(ctypes.byref(mod), str(cubin).encode()) != 0:
                continue
            for name, (threads, smem) in shapes.items():
                fn, blocks = ctypes.c_void_p(), ctypes.c_int()
                if cuda.cuModuleGetFunction(ctypes.byref(fn), mod, name.encode()) != 0:
                    continue
                if smem > 48 * 1024 and cuda.cuFuncSetAttribute(fn, _MAX_DYNAMIC_SHARED,
                                                                 ctypes.c_int(smem)) != 0:
                    continue
                if cuda.cuOccupancyMaxActiveBlocksPerMultiprocessor(
                        ctypes.byref(blocks), fn, threads, ctypes.c_size_t(smem)) == 0:
                    out[name] = blocks.value * threads // 32
            cuda.cuModuleUnload(mod)
    return out


def build_log_of(lib: Path) -> str:
    path = Path(lib).parent / "build.log"
    return path.read_text() if path.exists() else ""


def load() -> ctypes.CDLL:
    """The kernels' library, built and loaded at the first call of the
    process, with argtypes set; later calls return it at once."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(ctypes.CDLL(str(build())))
        return _lib


# K1's arguments (csrc/megakernel.cu fourd_forward_launch).
_FORWARD_ARGS = [
    ctypes.c_void_p,                  # params (P,) or (F, P) float32, device
    ctypes.c_longlong,                # row_stride: 0, or P for (F, P) rows
    ctypes.c_void_p,                  # seeds (F,) uint32, device
    ctypes.c_int,                     # n_frames
    ctypes.c_void_p,                  # layout table (int[14]), host
    ctypes.c_void_p,                  # static hints (int[HINT_INTS]), host
    ctypes.c_int, ctypes.c_int,       # width, height
    ctypes.c_int, ctypes.c_int,       # row0, n_rows: the launch's block of image rows
    ctypes.c_int, ctypes.c_int,       # samples, reflections
    ctypes.c_float,                   # small_indent
    ctypes.c_void_p,                  # out (F, V, n_rows, W, 3) float32, device
    ctypes.c_void_p,                  # cudaStream_t
]
# Each entry point's (argtypes, restype).
SIGNATURES = {
    "fourd_forward_launch": (_FORWARD_ARGS, ctypes.c_int),
    "fourd_forward_variant_launch": ([ctypes.c_int, *_FORWARD_ARGS], ctypes.c_int),  # variant
    # fold (0 fast, 1 spec, 2 trig), sampler (0 poly, 1 kepler, 2 newton),
    # sequential (0/1), kepler's sampler_iters (csrc/forwardmodes.cu)
    "fourd_forward_modes_launch": ([ctypes.c_int] * 4 + _FORWARD_ARGS, ctypes.c_int),
    "fourd_peak_launch": ([
        ctypes.c_int,                     # n_acc: 8, 16, 32 or 48
        ctypes.c_float,                   # b
        ctypes.c_int, ctypes.c_int,       # trips (rounds / 16), blocks
        ctypes.c_void_p,                  # block_sums (blocks,) float32, device
        ctypes.c_void_p,                  # cudaStream_t
    ], ctypes.c_int),
    "fourd_ablate_launch": (_ABLATE_ARGS := [
        ctypes.c_int,                     # mode: 0 acc, 1 loss, 2 vjp
        ctypes.c_void_p,                  # params (P,) float32, device
        ctypes.c_uint32,                  # seed
        ctypes.c_void_p,                  # layout table (int[14]), host
        ctypes.c_int, ctypes.c_int,       # width, height
        ctypes.c_int, ctypes.c_int,       # samples, reflections
        ctypes.c_float, ctypes.c_float,   # small_indent, light_coefficient
        ctypes.c_void_p,                  # target (V, H, W, 3) float32, device
        ctypes.c_void_p,                  # loss_parts (n_cols,) float64, device
        ctypes.c_void_p,                  # value out () float32, device
        ctypes.c_void_p,                  # static hints (int[HINT_INTS]), host, or null
        ctypes.c_void_p,                  # cudaStream_t
    ], ctypes.c_int),
    "fourd_loss_grad_launch": (_LOSS_GRAD_ARGS := [
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
        ctypes.c_void_p,                  # g_mean (F, V, n_rows, W, 3) float32, device
        ctypes.c_void_p,                  # grad_parts (P, n_cols) float32, device
        ctypes.c_void_p,                  # loss_parts (n_cols,) float64, device
        ctypes.c_void_p,                  # grad out (P,) float32, device
        ctypes.c_void_p,                  # loss out () float32, device
        ctypes.c_void_p,                  # static hints (int[HINT_INTS]), host, or null
        ctypes.c_void_p,                  # keep: the frozen-slot mask (P,) float32, device, or null
        ctypes.c_void_p,                  # cudaStream_t
    ], ctypes.c_int),
    "fourd_grad_scratch_cols": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int],
                                ctypes.c_int),
    # the occupancy of K4's sweep: layout table, reflections, static hints
    # (or null), out int[2] (resident blocks a SM, dynamic shared bytes);
    # the modes one after fold, sampler and sampler_iters
    "fourd_loss_grad_occupancy": (_OCCUPANCY_ARGS := [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int),
    "fourd_loss_grad_modes_occupancy": ([ctypes.c_int] * 3 + _OCCUPANCY_ARGS, ctypes.c_int),
    "fourd_light_vjp_launch": (_LIGHT_VJP_ARGS := [
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
        ctypes.c_void_p,                  # static hints (int[HINT_INTS]), host, or null
        ctypes.c_void_p,                  # keep: the frozen-slot mask (P,) float32, device, or null
        ctypes.c_void_p,                  # cudaStream_t
    ], ctypes.c_int),
    "fourd_soft_loss_grad_launch": (_SOFT_ARGS := [
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
        ctypes.c_void_p,                  # sums (2, V, n_rows, W, 3) float32, device
        ctypes.c_void_p,                  # row_b (V, n_rows, W) uint32, device
        ctypes.c_void_p,                  # grad_parts (P, n_cols) float32, device
        ctypes.c_void_p,                  # loss_parts (n_cols,) float64, device
        ctypes.c_void_p,                  # grad out (P,) float32, device
        ctypes.c_void_p,                  # loss out () float32, device
        ctypes.c_void_p,                  # alpha_cot out (V, n_rows, W) float32, device
        ctypes.c_void_p,                  # static hints (int[HINT_INTS]), host, or null
        ctypes.c_void_p,                  # keep: the frozen-slot mask (P,) float32, device, or null
        ctypes.c_void_p,                  # cudaStream_t
    ], ctypes.c_int),
    # K4, K5 (csrc/gradmodes.cu), K6 (softmodes.cu) and K8 (ablatemodes.cu)
    # over K1's other configurations: fold (0 fast, 1 spec, 2 trig), sampler
    # (0 poly, 1 kepler, 2 newton), kepler's sampler_iters, then the
    # launch's arguments (hints never null)
    "fourd_loss_grad_modes": ([ctypes.c_int] * 3 + _LOSS_GRAD_ARGS, ctypes.c_int),
    "fourd_light_vjp_modes": ([ctypes.c_int] * 3 + _LIGHT_VJP_ARGS, ctypes.c_int),
    "fourd_soft_loss_grad_modes": ([ctypes.c_int] * 3 + _SOFT_ARGS, ctypes.c_int),
    "fourd_ablate_modes": ([ctypes.c_int] * 3 + _ABLATE_ARGS, ctypes.c_int),
}


def bind(lib: ctypes.CDLL, names=None) -> ctypes.CDLL:
    """Sets the argument and result types of the library's entry points
    (``names``, every entry of SIGNATURES by default); returns it."""
    for name in names or SIGNATURES:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = SIGNATURES[name]
    return lib
