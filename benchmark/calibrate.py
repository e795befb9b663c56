"""The readings that a cell's limits are set from, on the card, in one
process: for each seed a short run of the cell (its compared numbers,
the program's readings) and, with ``--control``, the lower-precision
control (the reference computed in bfloat16 in the program's place) and,
for a train cell, the half-batch fault (the reference on half of each
step's frames). One JSON line per seed.

    python3 benchmark/calibrate.py --workload room.render3 --seeds 11,12,13 \
        --seconds 2 [--control] [--out out/calibrate.jsonl]

The benchmark's own runs never run this."""
import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
os.environ.setdefault("USE_FLAX", "0")

from benchmark.harness import main, spec  # noqa: E402
from benchmark.harness.precision import BFloat16Arithmetic  # noqa: E402


def calibrate(workload: str, seed: int, seconds: float, control: bool, device="cuda",
              cell=None) -> dict:
    cell = cell or spec.load_cell(workload)
    t0 = time.perf_counter()
    result, loop = main.run_cell(cell, seed, seconds, False, device)
    line = {"workload": cell.name, "seed": seed, "correct": result["correct"],
            "program": {k: v["value"] for k, v in result["check"].items()},
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "device": result["device"]}
    if control:
        line["control"] = loop.control(BFloat16Arithmetic())
        if hasattr(loop, "half_batch"):
            line["half_batch"] = loop.half_batch()
    line["seconds"] = time.perf_counter() - t0
    return line


def run(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    main.check_card(cell.chips)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(calibrate(args.workload, seed, args.seconds, args.control, cell=cell))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
