"""Split the time of K4 as it stood before its sweep was redesigned.

    python fourd_ray_tracing_tpu_torch/tools/k4_stage_split.py OLD

OLD is a checkout of the repository from before the redesign (commit
880def9, whose K4 kept a dense per-thread cotangent array in local
memory), for example unpacked with ``git archive`` into a git-ignored
directory. The tool builds OLD's kernels and three patched copies (under
``out/stage_split/`` of this checkout, git-ignored), each with one stage of
K4 compiled out: the block reduction (``noreduce``), the scattered writes
of the cotangents (``nowrites``: every write goes to the same slots), and
the reverse sweep (``nosweep``: the recording re-trace stays, its records
are read once). Then it times every K4 in one process, in turns, at
1280x720x8spp x4 (room, 1 frame, a zero target), beside K8's vjp mode
(pass 1, the loss and its cotangent), and prints each build's registers,
stack and spill (-Xptxas -v) and the split. The patches only fit OLD's
sources; the builds are throwaway.
"""
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OLD = Path(sys.argv[1]).resolve() if __name__ == "__main__" else None
if OLD is not None:
    sys.path.insert(0, str(OLD))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from fourd_ray_tracing_tpu_torch import camera as cam  # noqa: E402
from fourd_ray_tracing_tpu_torch.models import library, params  # noqa: E402
from fourd_ray_tracing_tpu_torch.models.renderer import RenderConfig  # noqa: E402
from fourd_ray_tracing_tpu_torch.ops.cuda import ablate, build, gradkernel, megakernel  # noqa: E402
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4  # noqa: E402

REDUCE_OLD = """  for (int k = 0; k < n; ++k) {
    float v = g[k];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][k] = v;
  }"""
REDUCE_NEW = "  if (n > 0 && lane == 0) red[warp][0] = g[0] + g[n - 1];"
SWEEP_OLD = "sample_adj(P, L, rec, n_rec, reflections, small_indent, g_light, g, g_o, g_d, g_thr);"
SWEEP_NEW = """{
        float s = 0.0f;
        for (int i = 0; i < n_rec; ++i) {
          const Bounce& r = rec[i];
          s += r.o.x + r.o.y + r.o.z + r.o.w + r.d.x + r.d.y + r.d.z + r.d.w + r.throughput.x +
               r.throughput.y + r.throughput.z + r.h.dist + r.h.norm.x + r.h.norm.y + r.h.norm.z +
               r.h.norm.w + r.h.glow + r.h.refl + r.h.color.x + r.h.color.y + r.h.color.z +
               r.v.x + r.v.y + r.v.z + r.v.w + (float)r.h.idx + (float)r.h.hit + (float)r.mirror;
        }
        g_o = {0.0f * s, 0.0f, 0.0f, 0.0f};
        g_d = {0.0f, 0.0f, 0.0f, 0.0f};
        g_thr = {0.0f, 0.0f, 0.0f};
      }"""


def patch_nowrites(src: str) -> str:
    """Every cotangent write of the adjoint goes to constant slots g[0..3]."""
    src = src.replace("float* g_env = g + L.env;", "float* g_env = g;")
    src = re.sub(r"acc([34])\(g(_env)? \+ [^,]+,", r"acc\1(g\2,", src)
    src = re.sub(r"\bg(_env)?\[[^\]]+\] \+=", r"g\1[0] +=", src)
    return src


VARIANTS = {
    "noreduce": {"reduce.cuh": [(REDUCE_OLD, REDUCE_NEW)]},
    "nowrites": {"adjoint.cuh": [patch_nowrites]},
    "nosweep": {"adjoint.cuh": [(SWEEP_OLD, SWEEP_NEW)]},
}


def make_tree(name, patches):
    tree = ROOT / "out" / "stage_split" / name
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(OLD / "fourd_ray_tracing_tpu_torch", tree / "fourd_ray_tracing_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for fname, edits in patches.items():
        path = tree / "fourd_ray_tracing_tpu_torch" / "csrc" / fname
        text = path.read_text()
        for e in edits:
            if callable(e):
                new = e(text)
            else:
                assert e[0] in text, (name, fname, e[0][:60])
                new = text.replace(e[0], e[1])
            assert new != text, (name, fname)
            text = new
        path.write_text(text)
    return tree


def build_in(tree):
    """Starts the build of ``tree``'s kernels; its result() gives the
    library's path and its build log."""
    proc = subprocess.Popen([sys.executable, "-c", "from fourd_ray_tracing_tpu_torch.ops.cuda "
                             "import build; print(build.build())"], cwd=tree,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def result():
        out, err = proc.communicate()
        assert proc.returncode == 0, err[-4000:]
        lib = Path(out.strip().splitlines()[-1])
        return lib, (lib.parent / "build.log").read_text()
    return result


def ptxas_lines(log):
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
        if ("registers" in line or "spill" in line) and cur and "loss_grad" in cur:
            out.append(line.strip())
    return out


def main():
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    libs = {}
    base = build.load()
    libs["k4"] = base
    print("k4 (old)", *ptxas_lines(build.build_log()), sep="\n  ", flush=True)
    pending = {name: build_in(make_tree(name, patches)) for name, patches in VARIANTS.items()}
    for name, result in pending.items():
        path, log = result()
        lib = ctypes.CDLL(str(path))
        lib.fourd_loss_grad_launch.argtypes = base.fourd_loss_grad_launch.argtypes
        lib.fourd_loss_grad_launch.restype = ctypes.c_int
        libs[name] = lib
        print(name, *ptxas_lines(log), sep="\n  ", flush=True)

    cfg = RenderConfig(width=1280, height=720, samples=8, reflections_amount=4,
                       rng_mode="per_sample", light_coefficient=0.12)
    scene = library.room_with_sphere(dev)
    orient = cam.orientation_from_angles(*cam.CameraAngles.of(0.0, 0.0, 0.0, device=dev), dev)
    camera = cam.make_camera(Vec4.of(0.0, -2.0, 0.0, 0.0, device=dev), orient, 1.5, 2.0, ("yxz",), dev)
    packed, lay = params.pack(scene, camera), params.layout(scene, camera)
    target = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    words = megakernel.seed_tensor([1], dev)
    table = (ctypes.c_int * len(lay))(*lay)
    n_cols = base.fourd_grad_scratch_cols(ctypes.addressof(table), cfg.width, cfg.height, 1)
    gp = torch.empty((lay.size, n_cols), dtype=torch.float32, device=dev)
    lp = torch.empty((n_cols,), dtype=torch.float64, device=dev)
    grad = torch.empty((lay.size,), dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def k4(lib):
        err = lib.fourd_loss_grad_launch(
            packed.data_ptr(), words.data_ptr(), 1, ctypes.addressof(table), cfg.width, cfg.height,
            0, cfg.height, cfg.samples, cfg.reflections_amount, float(np.float32(cfg.small_indent)),
            float(np.float32(cfg.light_coefficient)), target.data_ptr(), 1.0, gp.data_ptr(),
            lp.data_ptr(), grad.data_ptr(), loss.data_ptr(), stream)
        assert err == 0, err

    fns = {name: (lambda lib=lib: k4(lib)) for name, lib in libs.items()}
    fns["k8_vjp"] = lambda: ablate.launch_variant("vjp", packed, lay, cfg, 1, target)
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for _ in range(5):
        for name, fn in fns.items():
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(5):
                fn()
            e.record()
            e.synchronize()
            times[name].append(s.elapsed_time(e) / 5)
    med = {k: statistics.median(v) for k, v in times.items()}
    for k, v in times.items():
        print(f"{k}: median {med[k]:.4f} ms, rounds {[round(t, 4) for t in v]}", flush=True)
    print(f"split (old K4 {med['k4']:.4f} ms): block reduction {med['k4'] - med['noreduce']:.4f}, "
          f"scattered cotangent writes {med['k4'] - med['nowrites']:.4f}, reverse sweep "
          f"(arithmetic + writes) {med['k4'] - med['nosweep']:.4f}, re-trace + records + bounce 0 + "
          f"reduction {med['nosweep'] - med['k8_vjp']:.4f}, pass 1 + loss (K8 vjp) "
          f"{med['k8_vjp']:.4f}", flush=True)


if __name__ == "__main__":
    main()
