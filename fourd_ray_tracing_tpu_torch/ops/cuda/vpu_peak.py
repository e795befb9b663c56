"""Wrapper of the fp32 FMA-peak kernel K7 (csrc/vpu_peak.cu), its plain
version, and the check of its compiled loop.

Counterpart of the JAX package's tools/vpu_peak.py ``_peak_kernel`` and
``_build``: independent chains y <- y*y + b per lane, whose rate is the
card's sustained fp32 rate. ``launch_peak`` launches the kernel on a CUDA
device and returns its per-block sums; ``peak_plain`` computes the same
chains in torch over a (programs, rows, 128) layout; with 64 programs of 8
rows it computes what the JAX ``_build(n_acc, rounds)(b)`` computes, per
program. ``block_sum_plain`` is the sum every block of the kernel writes,
computed as the kernel computes it (one rounding a step, its order of
sums), to hold the kernel at the measurement's own step counts.
``LAUNCHES`` counts kernel launches. ``sass_loop_counts`` reads the built
library's SASS and counts the FFMA, FMUL and FADD instructions of each
kernel's main loop.
"""
from __future__ import annotations

import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from fourd_ray_tracing_tpu_torch.ops.cuda import build

LAUNCHES = 0
N_ACCS = (8, 16, 32, 48)  # the instantiations of the kernel, the JAX sweep (vpu_peak.py:128)
UNROLL = 16  # chain steps per loop trip
LANES = 128
BLOCK_THREADS = 256  # csrc/vpu_peak.cu kPeakBlock
ROWS_PER_BLOCK = BLOCK_THREADS // LANES
JAX_PROGRAMS, JAX_ROWS = 64, 8  # the JAX kernel's grid and (8, 128) accumulator tile


def flops(n_acc: int, rounds: int, threads: int) -> float:
    """Flops of one launch: an FMA is 2 per step, accumulator and thread."""
    return 2.0 * n_acc * rounds * threads


def _check(n_acc: int, rounds: int) -> None:
    if n_acc not in N_ACCS:
        raise ValueError(f"n_acc must be one of {N_ACCS}, got {n_acc}")
    if rounds < 0 or rounds % UNROLL:
        raise ValueError(f"rounds must be a non-negative multiple of {UNROLL}, got {rounds}")


def chains(n_acc: int, rounds: int, b: float, programs: int = JAX_PROGRAMS,
           rows: int = JAX_ROWS, device="cpu", fused: bool = False) -> torch.Tensor:
    """(n_acc, programs, rows, 128) float32 accumulators: accumulator k of
    lane l starts at l * (0.5 / 128) + 0.001 * (k + 1) and steps
    y <- y * y + b ``rounds`` times. A step rounds twice (a float32
    product, then a float32 sum), or with ``fused`` once, as an FMA does:
    the float64 product of two float32 values is exact, and the float64
    sum is exact too while 0.125 <= |y| < 1 and |b| < 1 (the tool's
    chains after their first step), so its rounding to float32 is the
    FMA's."""
    _check(n_acc, rounds)
    lane = torch.arange(LANES, dtype=torch.float32, device=device).expand(programs, rows, LANES)
    start = torch.tensor([np.float32(0.001 * (k + 1)) for k in range(n_acc)], dtype=torch.float32,
                         device=device)
    y = lane * np.float32(0.5 / LANES) + start[:, None, None, None]
    if fused:
        b64 = torch.tensor(float(np.float32(b)), dtype=torch.float64, device=device)
        for _ in range(rounds):
            y64 = y.double()
            y = (y64 * y64 + b64).float()
        return y
    b_t = torch.tensor(b, dtype=torch.float32, device=device)
    for _ in range(rounds):
        y = y * y + b_t
    return y


def _thread_sums(y: torch.Tensor) -> torch.Tensor:
    """Each lane's accumulators summed in order, y[0] + y[1] + ..."""
    acc = y[0]
    for k in range(1, y.shape[0]):
        acc = acc + y[k]
    return acc


def peak_plain(n_acc: int, rounds: int, b: float, programs: int = JAX_PROGRAMS,
               rows: int = JAX_ROWS, device="cpu") -> torch.Tensor:
    """(programs,) float32 sums: program p holds n_acc (rows, 128) float32
    accumulators (``chains``, two roundings a step), sums them in order,
    then its lanes."""
    return _thread_sums(chains(n_acc, rounds, b, programs, rows, device)).sum(dim=(1, 2))


def block_sum_plain(n_acc: int, rounds: int, b: float, device="cpu") -> torch.Tensor:
    """0-d float32: the sum that every block of ``launch_peak`` writes,
    computed as the kernel computes it: one rounding a step (``chains``
    with ``fused``), a thread's accumulators summed in order, a warp's 32
    threads by the shuffle tree (offsets 16, 8, 4, 2, 1), the block's
    warps in order. A thread's lane is its index mod 128 and a block holds
    256 threads, so every block computes the same."""
    s = _thread_sums(chains(n_acc, rounds, b, 1, ROWS_PER_BLOCK, device, fused=True))
    s = s.reshape(BLOCK_THREADS // 32, 32)
    off = 16
    while off:
        s = s[:, :off] + s[:, off:2 * off]
        off //= 2
    total = s[0, 0]
    for w in range(1, s.shape[0]):
        total = total + s[w, 0]
    return total


def launch_peak(n_acc: int, rounds: int, b: float, out: torch.Tensor) -> torch.Tensor:
    """One K7 launch of ``out.numel()`` 256-thread blocks on ``out``'s CUDA
    device: ``out`` (blocks,) float32 receives the per-block sums, the same
    chains as ``peak_plain(n_acc, rounds, b, programs=blocks, rows=2)``
    with one FMA (one rounding) a step; each is ``block_sum_plain``."""
    global LAUNCHES
    _check(n_acc, rounds)
    if (out.device.type != "cuda" or out.dtype != torch.float32 or out.dim() != 1
            or out.numel() == 0 or not out.is_contiguous()):
        raise ValueError("out must be a contiguous non-empty (blocks,) float32 CUDA tensor")
    lib = build.load()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fourd_peak_launch(n_acc, float(np.float32(b)), rounds // UNROLL, out.numel(),
                                    out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fp32 peak kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def find_cuobjdump() -> str:
    nvcc = Path(build.find_nvcc())
    tool = nvcc.with_name("cuobjdump")
    if not tool.is_file():
        raise RuntimeError(f"cuobjdump not found beside {nvcc}: cannot read the kernel's SASS")
    return str(tool)


_FUNCTION = re.compile(r"Function : (\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
_KERNEL = re.compile(r"fourd_peak_kernelILi(\d+)E")


def parse_sass(text: str) -> dict:
    """{function name: [(address, opcode, operands), ...]} of cuobjdump
    -sass output."""
    funcs, current = {}, None
    for line in text.splitlines():
        m = _FUNCTION.search(line)
        if m:
            current = funcs.setdefault(m.group(1), [])
            continue
        m = _INSTR.search(line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(2), m.group(3).strip()))
    return funcs


def loop_counts(instrs: list) -> dict:
    """Opcode counts (FFMA, FMUL, FADD) of the body of the function's
    largest loop, the span from a backward branch's target to the branch."""
    best = None
    for addr, op, operands in instrs:
        if not op.startswith("BRA"):
            continue
        m = re.search(r"0x([0-9a-f]+)", operands)
        if not m or int(m.group(1), 16) >= addr:
            continue
        start = int(m.group(1), 16)
        body = [o for a, o, _ in instrs if start <= a <= addr]
        counts = {k: sum(o.split(".")[0] == k for o in body) for k in ("FFMA", "FMUL", "FADD")}
        if best is None or counts["FFMA"] > best["FFMA"]:
            best = counts
    if best is None:
        raise RuntimeError("no loop (backward branch) found in the kernel's SASS")
    return best


def sass_loop_counts(lib_path: Path) -> dict:
    """{n_acc: {"FFMA", "FMUL", "FADD"}} of each K7 instantiation's main
    loop in the built library, read with cuobjdump -sass."""
    proc = subprocess.run([find_cuobjdump(), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300)
    out = {}
    for name, instrs in parse_sass(proc.stdout).items():
        m = _KERNEL.search(name)
        if m:
            out[int(m.group(1))] = loop_counts(instrs)
    missing = set(N_ACCS) - set(out)
    if missing:
        raise RuntimeError(f"the K7 instantiations {sorted(missing)} are not in the SASS of "
                           f"{lib_path}")
    return out
