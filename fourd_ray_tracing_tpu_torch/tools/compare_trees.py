"""Compare the kernels of this checkout with another source tree's on the card.

    python -m fourd_ray_tracing_tpu_torch.tools.compare_trees OTHER [--repeats N]

OTHER is another checkout of the repository, for example the parent
commit unpacked with ``git archive`` into a git-ignored directory. Both
trees build their kernels (each from its own sources, into its own build
directory). Then each tree's launches are timed in a process of its own,
the trees in turns (other, this, this, other), on room_with_sphere at
1280x720, 8 spp, 4 bounces, the bench camera: the forward kernel K1 at the
headline 4-frame launch (with the static hints where the tree has them)
and the engine's ``step_frames(4)``; at light_coefficient 0.12, sphere 0,
edge width 0.05 and a zero target, K4 at 1 and 4 frames, K5 over 1 and 2
rows (a seeded random cotangent), K2 over the scene and its zero_object
row, and K6; where the tree has the freeze_hints contract
(diff.with_frozen_hints), K4, K5 and K6 under it too (``*_hinted``: the
room's instance of the hinted fold), and the same on the room with its
walls listed y, x, z, w (``*_hinted_generic``: its pairs off the axis
order, so the launches take the generic instance of the fold over the
same walls); then on the tiger under the frozen hints, K1 at bench.py's
tiger_3view launch (3 views, 4 frames), K4 at its inverse_step_tiger (1
view, 1 frame) and, where the tree's soft paths take composites, K6 with
the tiger the object. Each figure is ms per call, the median of ``--repeats`` runs
of 4 back-to-back calls, CUDA events; one JSON line a turn. Then each
tree's kernels' registers, stack and spill (its build log) and K1's
resident warps per SM (libcuda's occupancy query on its cubins), and
last the SASS of every kernel in both builds, instruction for instruction
(cuobjdump): every function the two builds share is compared, K1's
instances included; one line reads whether every shared kernel but K1's
is identical (the gradient kernels K4-K6 and K8, which a change of the
forward fold must leave as they are, and K7), one whether K1's
production and measurement instances are (every forward_kernel instance
but those of K1's other configurations, forwardmodes.cu's, whose RNG mode
is a launch argument), and the kernels only one tree has are listed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve()
ROOT = HERE.parents[2]
K1 = r"forward_kernel"  # every instance of K1 and of its measurement variants
# K1's instances over its other configurations (forwardmodes.cu): the RNG
# mode kRngArg (-1), their last template argument.
K1_MODES = r"forward_kernel\w*Lin1EEEv"


def time_tree(tree: Path, repeats: int) -> dict:
    """The timings of ``tree``'s kernels; runs in a process whose package
    is that tree's."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    from fourd_ray_tracing_tpu_torch import camera as cam
    from fourd_ray_tracing_tpu_torch import diff
    from fourd_ray_tracing_tpu_torch.engine import RenderEngine
    from fourd_ray_tracing_tpu_torch.models import library, params
    from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig
    from fourd_ray_tracing_tpu_torch.ops.cuda import build, gradkernel, megakernel
    from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4
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
    head = RenderConfig(width=1280, height=720, samples=8, reflections_amount=4,
                        rng_mode="per_sample")
    cfg = dataclasses.replace(head, light_coefficient=0.12)
    scene, camera = library.room_with_sphere(dev), common.default_camera(dev)
    packed, lay = params.pack(scene, camera), params.layout(scene, camera)
    hinted = getattr(megakernel, "with_hints", lambda s, c: c)(scene, head)
    engine = RenderEngine(scene, head, Vec4.of(0.0, -2.0, 0.0, 0.0, device=dev),
                          cam.CameraAngles.of(0.0, 0.0, 0.0, device=dev), device=dev,
                          deterministic=True)
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
        "k1_4f": ms(lambda: megakernel.launch_forward(packed, lay, hinted, w4)),
        "k1_hints": hinted.plane_pairs is not None,
        "engine_step_frames_4": ms(lambda: engine.step_frames(4)),
        "k4_1f": ms(lambda: gradkernel.launch_loss_grad(packed, lay, cfg, w1, target)),
        "k4_4f": ms(lambda: gradkernel.launch_loss_grad(packed, lay, cfg, w4, target), calls=2),
        "k5_1row": ms(lambda: gradkernel.launch_light_vjp(packed, lay, cfg, 1, cot1)),
        "k5_2rows": ms(lambda: gradkernel.launch_light_vjp(pair, lay, cfg, 1, cot2)),
        "k2_pair": ms(lambda: megakernel.launch_forward(pair, lay, cfg, pw)),
        "k6": ms(lambda: gradkernel.launch_soft_loss_grad(packed, lay, cfg, 1, target, alpha,
                                                          zero_map)),
    }
    out["pair_k2_plus_k5"] = out["k2_pair"] + out["k5_2rows"]
    if hasattr(diff, "with_frozen_hints"):
        walls = scene.spaces
        off_order = scene._replace(spaces=(*walls[2:4], *walls[:2], *walls[4:]))
        for tag, s in (("_hinted", scene), ("_hinted_generic", off_order)):
            hcfg = diff.with_frozen_hints(cfg, s)
            p, lay_s = params.pack(s, camera), params.layout(s, camera)
            keep = params.freeze_mask(hcfg, s, lay_s.size, dev)
            rows2 = params.stack_rows((s, diff.zero_object(s, ref)), camera)
            a_s = diff.object_coverage(s, ref, camera, hcfg, 0.05).detach().contiguous()
            zm = params.soft_zero_map(s, camera, ref)
            out.update({
                "k4_1f" + tag: ms(lambda: gradkernel.launch_loss_grad(p, lay_s, hcfg, w1, target,
                                                                      keep=keep)),
                "k4_4f" + tag: ms(lambda: gradkernel.launch_loss_grad(p, lay_s, hcfg, w4, target,
                                                                      keep=keep), calls=2),
                "k5_1row" + tag: ms(lambda: gradkernel.launch_light_vjp(p, lay_s, hcfg, 1, cot1,
                                                                        keep=keep)),
                "k5_2rows" + tag: ms(lambda: gradkernel.launch_light_vjp(rows2, lay_s, hcfg, 1,
                                                                         cot2, keep=keep)),
                "k6" + tag: ms(lambda: gradkernel.launch_soft_loss_grad(
                    p, lay_s, hcfg, 1, target, a_s, zm, keep=keep)),
            })
    # The composite folds: the tiger's 3-view forward launch (bench.py's
    # tiger_3view, 4 frames) and its K4 at bench.py's inverse_step_tiger
    # (1 view, 1 frame), under the frozen hints; K6 on the tiger (the
    # tiger the object) where the tree's soft paths take composites.
    if hasattr(diff, "with_frozen_hints") and hasattr(megakernel, "with_hints"):
        tiger = library.tiger(dev)
        cam3 = common.default_camera(dev, cam.VIEWS_ALL)
        t_cfg = diff.with_frozen_hints(cfg, tiger)
        t_packed, t_lay = params.pack(tiger, camera), params.layout(tiger, camera)
        keep = params.freeze_mask(t_cfg, tiger, t_lay.size, dev)
        p3, lay3 = params.pack(tiger, cam3), params.layout(tiger, cam3)
        h3 = megakernel.with_hints(tiger, head)
        out["k1_tiger_3view_4f"] = ms(lambda: megakernel.launch_forward(p3, lay3, h3, w4))
        out["k4_tiger_1f_hinted"] = ms(lambda: gradkernel.launch_loss_grad(
            t_packed, t_lay, t_cfg, w1, target, keep=keep))
        if hasattr(diff, "_tiger_coverage"):
            t_ref = ("tiger", None)
            t_alpha = diff.object_coverage(tiger, t_ref, camera, t_cfg, 0.05).detach().contiguous()
            t_zm = params.soft_zero_map(tiger, camera, t_ref)
            out["k6_tiger_hinted"] = ms(lambda: gradkernel.launch_soft_loss_grad(
                t_packed, t_lay, t_cfg, 1, target, t_alpha, t_zm, keep=keep))
    out["card"] = common.smi("name,power.limit")
    return out


def k1_launch_shape(tree: Path) -> tuple:
    """(threads a block, dynamic shared-memory bytes) of ``tree``'s K1 at
    the headline launch: its wrapper says so where it can, else the first
    design's 128 threads and the packed params alone."""
    code = ("import json; from fourd_ray_tracing_tpu_torch.ops.cuda import megakernel as m; "
            "from fourd_ray_tracing_tpu_torch.models import library, params; "
            "from fourd_ray_tracing_tpu_torch.tools import common; import torch; "
            "d = torch.device('cpu'); s = library.room_with_sphere(d); "
            "c = common.default_camera(d); lay = params.layout(s, c); "
            "f = getattr(m, 'launch_shape', None); "
            "print(json.dumps(f(s, lay) if f else (128, 4 * lay.size)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True, text=True,
                         check=True)
    return tuple(json.loads(out.stdout.strip().splitlines()[-1]))


def resources(tree: Path, lib: str) -> dict:
    """Registers, stack and spill of every kernel of ``tree``'s build, and
    the resident warps per SM of its K1 instances at the headline launch."""
    import torch

    from fourd_ray_tracing_tpu_torch.ops.cuda import build

    torch.zeros(1, device="cuda")  # the context the occupancy query runs in
    res = {n: r for n, r in build.kernel_resources(build.build_log_of(Path(lib))).items() if r}
    threads, smem = k1_launch_shape(tree)
    try:
        warps = build.resident_warps(Path(lib), {K1: (threads, smem)})
    except (OSError, RuntimeError, subprocess.CalledProcessError) as err:
        print(json.dumps({"resident_warps_error": repr(err)}), flush=True)
        warps = {}
    k1 = {n: {**r, "resident_warps_per_sm": warps.get(n)} for n, r in res.items()
          if re.search(K1, n)}
    return {"k1": k1, "k1_block_threads": threads, "k1_smem_bytes": smem,
            "others": {n: r for n, r in res.items() if not re.search(K1, n)}}


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


def compare_others(other_lib: str, this_lib: str) -> dict:
    """Prints, for every function the two builds share, how many SASS
    instructions differ, and lists the functions only one build has.
    Returns {"sass_identical_but_k1": every shared function but K1's
    identical and none of the other build's missing here,
    "k1_production_identical": the same for K1's instances but those of
    its other configurations (K1_MODES), "only_this": the functions only
    this build has}. Names are compared from the kernel's own name on,
    without the anonymous namespace's per-build prefix."""
    def key(name):
        for m in re.finditer(r"(?=(\d+)([A-Za-z_]\w*))", name):
            if m.group(2)[:int(m.group(1))].endswith("_kernel"):
                return name[m.start():]
        return name

    old = {key(n): f for n, f in sass(other_lib).items()}
    new = {key(n): f for n, f in sass(this_lib).items()}
    others = k1 = True
    for name in sorted(old.keys() & new.keys()):
        a, b = old[name], new[name]
        diff = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
        print(json.dumps({"sass": name, "other": len(a), "this": len(b), "differing": diff}),
              flush=True)
        if not re.search(K1, name):
            others = others and diff == 0
        elif not re.search(K1_MODES, name):
            k1 = k1 and diff == 0
    missing = sorted(old.keys() - new.keys())
    only_this = sorted(new.keys() - old.keys())
    print(json.dumps({"sass_only_other": missing, "sass_only_this": only_this}), flush=True)
    others = others and not [n for n in missing if not re.search(K1, n)]
    k1 = k1 and not [n for n in missing if re.search(K1, n) and not re.search(K1_MODES, n)]
    return {"sass_identical_but_k1": others, "k1_production_identical": k1,
            "only_this": len(only_this)}


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
    for tree in (other, ROOT):
        print(json.dumps({"resources": str(tree), **resources(tree, libs[tree])}), flush=True)
    print(json.dumps(compare_others(libs[other], libs[ROOT])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
