"""Measure the card's sustained fp32 FMA rate with the K7 kernel
(csrc/vpu_peak.cu), the denominator every kernel's share of peak is read
against.

Counterpart of the JAX package's tools/vpu_peak.py (``measure``, ``main``):
n_acc independent chains y <- fma(y, y, b) per thread, held in registers,
swept over n_acc = 8, 16, 32, 48. One JSON line per n_acc, then the
payload line ``{"metric": "fp32_fma_peak_gflops", "value", "unit",
"device", "n_acc", "note", ...}`` with the SM clock read during the run
(nvidia-smi), the card's own peak at that clock (SMs x 128 FMA lanes x 2
flops x clock) and NVIDIA's published 67 TFLOP/s beside it.

Each launch is timed with CUDA events (the best of ``CALLS`` launches after
a warm-up). ``rounds`` defaults to 2^20 / n_acc chain steps, about 35 ms a
launch on an H100 at its published rate. At n_acc = 8 the tool times 2x rounds too and raises
unless that takes 1.5-2.7x as long: the timing must be paced by the
kernel's arithmetic, not by launches. No rate may exceed the card's own
peak at its maximum SM clock (SMs x 128 FMA lanes x 2 flops x the clock)
by more than PEAK_MARGIN: a kernel that skipped steps would. The clock
read during the burst is a sample taken after the timed launches (a card
held below its power limit may clock lower then than it ran), so the
share of the peak at that clock is reported, not asserted. The JAX tool's ``--update`` (which
rewrote bench.py) has no counterpart: the port has no bench yet, and
chip_smoke.py reads the measured peak from ``run``.

``--device cpu`` runs the plain torch version over the JAX kernel's layout
(64 programs of (8, 128) lanes) at ``--rounds`` (default 32): a check of
the tool's control flow, whose rate is the CPU's, not the card's.

    python -m fourd_ray_tracing_tpu_torch.tools.vpu_peak
    python -m fourd_ray_tracing_tpu_torch.tools.vpu_peak --device cpu --rounds 16
"""
from __future__ import annotations

import argparse
import sys

import torch

from fourd_ray_tracing_tpu_torch.app import resolve_device
from fourd_ray_tracing_tpu_torch.ops.cuda import vpu_peak as k7
from fourd_ray_tracing_tpu_torch.tools import common

STEPS_PER_THREAD = 1 << 20  # n_acc * rounds of one launch on the card
BLOCKS_PER_SM = 32  # 4-8 waves of 256-thread blocks (csrc/vpu_peak.cu)
CALLS = 3
# b = -0.75 puts y <- y*y + b at its period-doubling point: every chain
# (start values 0.001-0.544) approaches -0.5 as 1/sqrt(steps), so the sums
# depend on the step count and the start values for tens of thousands of
# steps before float32 rounding stalls them. At the JAX tool's b = 0.01 a
# chain reaches its fixed point within ~8 steps, and its sums say nothing
# of how many steps ran. The rate does not depend on b.
B = -0.75
PEAK_MARGIN = 0.02
LINEARITY = (1.5, 2.7)
PUBLISHED_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (NVIDIA's data sheet, 700 W)
CLOCK_BURST = 25  # launches in flight while nvidia-smi reads the clock
CPU_ROUNDS = 32


def default_rounds(n_acc: int) -> int:
    return STEPS_PER_THREAD // n_acc // k7.UNROLL * k7.UNROLL


def grid_blocks(device: torch.device) -> int:
    return BLOCKS_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count


def launch_ms(n_acc: int, rounds: int, out: torch.Tensor) -> float:
    """Best CUDA-event time of one K7 launch over CALLS launches, after a
    warm-up launch."""
    k7.launch_peak(n_acc, rounds, B, out)
    return min(common.time_ms(lambda: k7.launch_peak(n_acc, rounds, B, out), out.device,
                              calls=1, rounds=CALLS))


def measure(n_acc: int, rounds: int, device: torch.device, check: bool = False) -> dict:
    """One n_acc of the sweep: ms of one launch and GFLOP/s; with
    ``check``, the 2x-rounds time ratio, raising outside LINEARITY."""
    if device.type == "cpu":
        fn = lambda: k7.peak_plain(n_acc, rounds, B, device=device)  # noqa: E731
        ms = min(common.time_ms(fn, device, calls=1, rounds=1))
        threads = k7.JAX_PROGRAMS * k7.JAX_ROWS * k7.LANES
        return {"n_acc": n_acc, "rounds": rounds, "programs": k7.JAX_PROGRAMS, "ms": ms,
                "gflops": k7.flops(n_acc, rounds, threads) / ms / 1e6, "device": "cpu"}
    blocks = grid_blocks(device)
    out = torch.empty((blocks,), dtype=torch.float32, device=device)
    ms = launch_ms(n_acc, rounds, out)
    assert torch.isfinite(out).all(), "non-finite K7 block sums"
    threads = blocks * k7.BLOCK_THREADS
    res = {"n_acc": n_acc, "rounds": rounds, "blocks": blocks, "threads": threads, "ms": ms,
           "gflops": k7.flops(n_acc, rounds, threads) / ms / 1e6,
           "device": torch.cuda.get_device_name(device)}
    if check:
        ratio = launch_ms(n_acc, 2 * rounds, out) / ms
        res["linearity_ratio"] = ratio
        if not LINEARITY[0] < ratio < LINEARITY[1]:
            raise RuntimeError(f"timing not compute-paced: 2x rounds took {ratio:.2f}x")
    return res


def clock_during(n_acc: int, rounds: int, device: torch.device) -> dict:
    """nvidia-smi's SM clock, max SM clock and power draw, read while a
    burst of K7 launches runs."""
    out = torch.empty((grid_blocks(device),), dtype=torch.float32, device=device)
    for _ in range(CLOCK_BURST):
        k7.launch_peak(n_acc, rounds, B, out)
    reading = common.smi("clocks.sm,clocks.max.sm,power.draw")
    torch.cuda.synchronize(device)
    sm, max_sm, draw = (field.strip().split()[0] for field in reading.split(","))
    return {"sm_clock_mhz": float(sm), "max_sm_clock_mhz": float(max_sm),
            "power_draw_w": float(draw), "smi": reading}


def check_below_peak(gflops: float, peak_gflops: float, what: str) -> None:
    """Raise if ``gflops`` exceeds the card's ``peak_gflops`` by more than
    PEAK_MARGIN: the kernel did less work than it was counted for."""
    if gflops > peak_gflops * (1.0 + PEAK_MARGIN):
        raise RuntimeError(f"{what}: {gflops:.0f} GFLOP/s exceeds the card's peak "
                           f"{peak_gflops:.0f} GFLOP/s: the kernel skipped steps")


def run(device: torch.device, rounds: int | None = None) -> dict:
    """The sweep: prints one line per n_acc and the payload; returns the
    payload."""
    lines = []
    for n_acc in k7.N_ACCS:
        r = rounds or (default_rounds(n_acc) if device.type == "cuda" else CPU_ROUNDS)
        lines.append(common.emit(measure(n_acc, r, device,
                                         check=device.type == "cuda" and n_acc == k7.N_ACCS[0])))
    best = max(lines, key=lambda line: line["gflops"])
    payload = {"metric": "fp32_fma_peak_gflops", "value": best["gflops"], "unit": "GFLOP/s",
               "device": best["device"], "n_acc": best["n_acc"], "rounds": best["rounds"],
               "ms": best["ms"], "card": common.card(device)}
    if device.type == "cpu":
        payload["note"] = ("plain torch version on the CPU (two roundings a step): a check of "
                           "the tool, not a device peak")
        return common.emit(payload)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock = clock_during(best["n_acc"], best["rounds"], device)
    at_clock = sms * 128 * 2 * clock["sm_clock_mhz"] * 1e6
    at_max_clock = sms * 128 * 2 * clock["max_sm_clock_mhz"] * 1e6
    for line in lines:
        check_below_peak(line["gflops"], at_max_clock / 1e9, f"K7 n_acc {line['n_acc']}")
    payload.update({
        "note": "CUDA C++ in-register fma(y, y, b) chains (one FFMA a step); CUDA-event "
                "timed, best of 3 launches; rounds-linearity asserted at n_acc 8; no rate above "
                f"the card's peak at its max SM clock + {PEAK_MARGIN:.0%}",
        "linearity_ratio": lines[0]["linearity_ratio"], "blocks": best["blocks"], "sms": sms,
        **clock, "peak_at_clock_gflops": at_clock / 1e9,
        "peak_at_max_clock_gflops": at_max_clock / 1e9,
        "published_gflops": PUBLISHED_FLOPS / 1e9,
        "share_of_peak_at_clock": best["gflops"] * 1e9 / at_clock,
        "share_of_published": best["gflops"] * 1e9 / PUBLISHED_FLOPS,
    })
    return common.emit(payload)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device_flag(ap)
    ap.add_argument("--rounds", type=int, default=None,
                    help="chain steps per accumulator, a multiple of 16 (default: 2^20 / n_acc "
                         f"on the card, {CPU_ROUNDS} on the CPU)")
    args = ap.parse_args(argv)
    run(resolve_device(args.device), args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
