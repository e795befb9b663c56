"""Compare the kernels of this checkout with another source tree's on the card.

    python -m fourd_ray_tracing_tpu_torch.tools.compare_trees OTHER [--repeats N]

OTHER is another checkout of the repository, for example the parent
commit unpacked with ``git archive`` into a git-ignored directory. Both
trees build their kernels (each from its own sources, into its own build
directory). Then each tree's gradient launches are timed in a process of
its own, the trees in turns (other, this, this, other), at the soft bench
shape (room_with_sphere, 1280x720, 8 spp, 4 bounces, light_coefficient
0.12, sphere 0, edge width 0.05, a zero target, the bench camera): K4 at
1 and 4 frames, K5 over 1 and 2 rows (a seeded random cotangent), K2
over the scene and its zero_object row, and K6; ms per call, the median of
``--repeats`` runs of 4 back-to-back calls, CUDA events; one JSON line a
turn, with the gradient kernels' registers, stack and spill from the
tree's build log. Last, the SASS of K1 and its stub variants in both
builds, instruction for instruction (cuobjdump).
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve()
ROOT = HERE.parents[2]
K1_KINDS = {f"forward_kernel<{v}>": rf"14forward_kernelILi{v}E" for v in range(4)}


def time_tree(tree: Path, repeats: int) -> dict:
    """The timings of ``tree``'s kernels; runs in a process whose package
    is that tree's."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    from fourd_ray_tracing_tpu_torch import diff
    from fourd_ray_tracing_tpu_torch.models import library, params
    from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig
    from fourd_ray_tracing_tpu_torch.ops.cuda import build, gradkernel, megakernel
    from fourd_ray_tracing_tpu_torch.tools import common

    def ms(fn, calls=4):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(repeats):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / calls)
        return statistics.median(out)

    dev = torch.device("cuda")
    build.load()
    cfg = RenderConfig(width=1280, height=720, samples=8, reflections_amount=4,
                       rng_mode="per_sample", light_coefficient=0.12)
    scene, camera = library.room_with_sphere(dev), common.default_camera(dev)
    packed, lay = params.pack(scene, camera), params.layout(scene, camera)
    target = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    ref = ("spheres", 0)
    pair = params.stack_rows((scene, diff.zero_object(scene, ref)), camera)
    rng = np.random.default_rng(4)
    cot1 = torch.from_numpy(rng.normal(0, 1, (720, 1280, 3)).astype(np.float32)).to(dev)
    cot2 = torch.from_numpy(rng.normal(0, 1, (2, 720, 1280, 3)).astype(np.float32)).to(dev)
    alpha = diff.object_coverage(scene, ref, camera, cfg, 0.05).detach().contiguous()
    zero_map = params.soft_zero_map(scene, camera, ref)
    w1, w4 = megakernel.seed_tensor([1], dev), megakernel.seed_tensor([1, 2, 3, 4], dev)
    pw = megakernel.seed_tensor([1, 1], dev)
    out = {
        "k4_1f": ms(lambda: gradkernel.launch_loss_grad(packed, lay, cfg, w1, target)),
        "k4_4f": ms(lambda: gradkernel.launch_loss_grad(packed, lay, cfg, w4, target), calls=2),
        "k5_1row": ms(lambda: gradkernel.launch_light_vjp(packed, lay, cfg, 1, cot1)),
        "k5_2rows": ms(lambda: gradkernel.launch_light_vjp(pair, lay, cfg, 1, cot2)),
        "k2_pair": ms(lambda: megakernel.launch_forward(pair, lay, cfg, pw)),
        "k6": ms(lambda: gradkernel.launch_soft_loss_grad(packed, lay, cfg, 1, target, alpha,
                                                          zero_map)),
    }
    out["pair_k2_plus_k5"] = out["k2_pair"] + out["k5_2rows"]
    if hasattr(build, "kernel_resources"):  # trees older than this tool have none
        out["resources"] = {name: res for name, res in
                            build.kernel_resources(build.build_log()).items()
                            if "gradkernel" in name and res}
    out["card"] = common.smi("name,power.limit")
    return out


def build_tree(tree: Path) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", "from fourd_ray_tracing_tpu_torch.ops.cuda "
                             "import build; print(build.build())"], cwd=tree,
                            stdout=subprocess.PIPE, text=True)


def sass(lib: str) -> dict:
    """Each function's SASS instructions in the library."""
    from fourd_ray_tracing_tpu_torch.ops.cuda import vpu_peak

    text = subprocess.run([vpu_peak.find_cuobjdump(), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?;)", line)
        if m and cur is not None:
            cur.append(m.group(1).strip())
    return out


def compare_k1(other_lib: str, this_lib: str) -> bool:
    """Prints, for K1 and each stub variant, how many SASS instructions
    differ between the two builds; True when none does."""
    old, new = sass(other_lib), sass(this_lib)
    same = True
    for kind, pattern in K1_KINDS.items():
        a = [f for n, f in old.items() if re.search(pattern, n)]
        b = [f for n, f in new.items() if re.search(pattern, n)]
        assert len(a) == len(b) == 1, (kind, len(a), len(b))
        a, b = a[0], b[0]
        diff = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
        print(json.dumps({"sass": kind, "other": len(a), "this": len(b), "differing": diff}),
              flush=True)
        same = same and diff == 0
    return same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="another checkout of the repository")
    ap.add_argument("--repeats", type=int, default=5, help="timed runs of 4 calls each")
    ap.add_argument("--time", type=Path, help=argparse.SUPPRESS)  # one tree's turn
    args = ap.parse_args(argv)
    if args.time is not None:
        print(json.dumps({"tree": str(args.time), **time_tree(args.time, args.repeats)}),
              flush=True)
        return 0
    other = args.other.resolve()
    builds = {tree: build_tree(tree) for tree in (other, ROOT)}
    libs = {}
    for tree, proc in builds.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"the build of {tree} failed")
        libs[tree] = out.strip().splitlines()[-1]
    for tree in (other, ROOT, ROOT, other):
        subprocess.run([sys.executable, str(HERE), str(other), "--time", str(tree),
                        "--repeats", str(args.repeats)], check=True)
    same = compare_k1(libs[other], libs[ROOT])
    print(json.dumps({"k1_sass_identical": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
