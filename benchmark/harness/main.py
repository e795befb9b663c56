"""One run of one cell: ``benchmark/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>``.

The run makes its inputs from the seed, builds and warms the program
(set-up, timed as ``setup_s`` from the process's start, less the time
the benchmark spends making its inputs), measures for
``--seconds``, reads the device's peak memory, frees the program, checks
what the timed path produced against the reference, and prints the
compared numbers beside their limits on standard error and, last on
standard output, the result line. With ``--trace 1`` the window runs
under torch.profiler and the line carries the cell's per-layer metrics
and the breakdown instead of its end-to-end metrics."""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

from benchmark.harness import spec, trace
from benchmark.harness.common import now
from benchmark.harness.hostwatch import HostWatch

FORBIDDEN = ("jax", "jaxlib", "flax", "fourd_ray_tracing_tpu")


class NoCard(RuntimeError):
    pass


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def check_card(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, {torch.cuda.device_count()} visible")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, failed, {name: {value, limit}}): every limited number at
    or under its limit."""
    shown, failed = {}, 0
    for name, limit in limits.items():
        value = numbers[name]
        shown[name] = {"value": value, "limit": limit}
        failed += not value <= limit
    return failed == 0, failed, shown


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device="cuda",
             t_start: float | None = None) -> tuple:
    """One run of ``cell``: (the result line as a dict, the loop, whose
    reference the calibration reuses)."""
    import torch

    t_start = now() if t_start is None else t_start
    loop = spec.load_loop(cell.traffic["loop"], cell.root)(cell, seed, device)
    cuda = torch.device(device).type == "cuda"
    t_inputs = now()
    loop.make_inputs()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()  # the benchmark's inputs are not the program's
    inputs_s = now() - t_inputs  # the reference's work: no part of set-up
    loop.setup()
    setup_s = now() - t_start - inputs_s
    t_window = now()
    prof = anchor_t = None
    with HostWatch() as host:
        if traced:
            with trace.profiler() as prof:
                anchor_t = trace.anchor(device)
                stats = loop.window(seconds)
        else:
            stats = loop.window(seconds)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0}
    e2e = loop.end_to_end()
    loop.release()
    result = {"correct": None, "attempted": stats["attempted"], "failed": 0, "metrics": {},
              "device": dev}
    if traced:
        profile = trace.Profile.of(prof, loop.spans, loop.window_span, anchor_t)
        prof = None
        loop.profile = profile
        dev["busy_s"] = profile.busy_s()
        dev["window_s"] = profile.window_s
        for m in cell.per_layer:
            value = spec.load_reader(m["name"], cell.root)(loop)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": profile.device_ops(),
                               "idle_gaps": profile.idle_gaps()}
    else:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else e2e.get(m["name"])
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    t_check = now()
    numbers = loop.check()
    result["seconds"] = {"setup": setup_s, "inputs": inputs_s,
                         "window_and_trace": t_check - t_window, "check": now() - t_check}
    result["host"] = dict(host.summary, **getattr(loop, "host_steps", dict)())
    correct, failed, shown = judge(numbers, cell.limits)
    result["correct"], result["failed"] = correct, failed
    dev["power_limit"] = power_limit() if cuda else "cpu"
    result["check"] = shown
    return result, loop


def main(argv, t_start: float) -> int:
    args = parse(argv)
    try:
        cell = spec.load_cell(args.workload)
        check_card(cell.chips)
    except (KeyError, FileNotFoundError, NoCard) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    result, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
