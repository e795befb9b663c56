"""The port's checkpoints (utils/checkpoint.py, the engine's state dict,
inverse_render's --ckpt) on the CPU, and the JAX engine's state dict
carried into the port's engine.

A resumed engine or packed training loop must continue bitwise as the
uninterrupted one does. A state dict of the JAX engine (numpy arrays)
loads into the port's engine; its continuation is held against the JAX
package's eager renderer on the same seeds (test_torch_live.py says why
not against the jitted engine), with the integers equal to the JAX
engine's own continuation.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import assert_images_close

from fourd_ray_tracing_tpu import camera as jcam
from fourd_ray_tracing_tpu.engine import RenderEngine as JEngine
from fourd_ray_tracing_tpu.engine import generate_seed
from fourd_ray_tracing_tpu.models import library as jlib
from fourd_ray_tracing_tpu.models import renderer as jrenderer
from fourd_ray_tracing_tpu.ops.vec4 import Vec4 as JVec4

from fourd_ray_tracing_tpu_torch import camera as tcam
from fourd_ray_tracing_tpu_torch import diff, inverse_render
from fourd_ray_tracing_tpu_torch.engine import RenderEngine as TEngine
from fourd_ray_tracing_tpu_torch.models import library as tlib
from fourd_ray_tracing_tpu_torch.models import params
from fourd_ray_tracing_tpu_torch.models import renderer as trenderer
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4 as TVec4
from fourd_ray_tracing_tpu_torch.utils import checkpoint

CPU = torch.device("cpu")
MAIN = dict(width=16, height=10, samples=2, reflections_amount=2, rng_mode="per_sample")
ADD = dict(width=10, height=6, samples=2, reflections_amount=2, rng_mode="per_sample")


def torch_engine(controls="auto", additional=True):
    return TEngine(
        tlib.room_with_sphere(CPU), trenderer.RenderConfig(**MAIN),
        TVec4.of(0.0, -2.0, 0.0, 0.0, device=CPU), tcam.CameraAngles.of(0.1, 0.0, 0.0, device=CPU),
        device=CPU, deterministic=True, psi_constraint=(0.0, 0.785), use_native_controls=controls,
        additional=(trenderer.RenderConfig(**ADD), ("ywz", "yxw")) if additional else None,
    )


def test_round_trip(tmp_path):
    """Tensors, numpy arrays (saved as tensors), ints, floats and nested
    lists and dicts come back equal, on the CPU; the sidecar records the
    format version and the structure."""
    state = {"accum": torch.arange(12, dtype=torch.float32).reshape(2, 2, 3),
             "frame_number": 7, "seed": 2**32 - 1, "rate": 0.25,
             "np": np.arange(3, dtype=np.int64),
             "nested": [torch.ones(2, dtype=torch.float64), {"k": torch.zeros((), dtype=torch.int32)}]}
    checkpoint.save(tmp_path / "ck", state)
    got = checkpoint.restore(tmp_path / "ck", state)
    assert set(got) == set(state)
    assert torch.equal(got["accum"], state["accum"]) and got["accum"].device == CPU
    assert (got["frame_number"], got["seed"], got["rate"]) == (7, 2**32 - 1, 0.25)
    assert torch.equal(got["np"], torch.arange(3))
    assert torch.equal(got["nested"][0], state["nested"][0])
    assert got["nested"][1]["k"].dtype == torch.int32
    meta = json.loads((tmp_path / "ck" / "fourd_ckpt_meta.json").read_text())
    assert meta["format_version"] == checkpoint.FORMAT_VERSION and meta["n_leaves"] == 7


def test_structure_mismatch_and_newer_format_raise(tmp_path):
    state = {"a": torch.arange(4, dtype=torch.float32), "b": 2}
    path = tmp_path / "ck"
    checkpoint.save(path, state)
    for wrong in ({"a": torch.arange(5, dtype=torch.float32), "b": 2},
                  {"a": torch.arange(4, dtype=torch.float64), "b": 2},
                  {"a": torch.arange(4, dtype=torch.float32), "c": 2}):
        with pytest.raises(ValueError, match="structure mismatch"):
            checkpoint.restore(path, wrong)
    meta = json.loads((path / "fourd_ckpt_meta.json").read_text())
    (path / "fourd_ckpt_meta.json").write_text(
        json.dumps({**meta, "format_version": checkpoint.FORMAT_VERSION + 1}))
    with pytest.raises(ValueError, match="newer than this build"):
        checkpoint.restore(path, state)


@pytest.mark.parametrize("controls", ["native", "python"])
def test_engine_resume_continues_bitwise(controls, tmp_path):
    """N frames, a checkpoint, a fresh engine that loads it and M more
    frames: bitwise the uninterrupted N + M, seeds and counters equal."""
    straight, first = torch_engine(controls), torch_engine(controls)
    for engine in (straight, first):
        engine.mouse_moved(6, -2)
        engine.move(tcam.MoveKeys(forward=True, w_pos=True), 0.2)
        engine.step_frames(2)
    first.save_checkpoint(tmp_path / "ck")
    resumed = torch_engine(controls)
    assert resumed.controls == controls
    resumed.load_checkpoint(tmp_path / "ck")
    for engine in (straight, resumed):
        engine.step_frames(3)
    assert (resumed.seed, resumed.frame_number, resumed._rng_draws) == \
        (straight.seed, straight.frame_number, straight._rng_draws) == (straight.seed, 6, 5)
    assert [float(a) for a in resumed.angles] == [float(a) for a in straight.angles]
    assert [float(c) for c in resumed.focus] == [float(c) for c in straight.focus]
    for g_r, g_s in zip(resumed.groups, straight.groups):
        assert g_r.accum.device == CPU and torch.equal(g_r.accum, g_s.accum)


def test_engine_refuses_another_layout(tmp_path):
    torch_engine().save_checkpoint(tmp_path / "ck")
    with pytest.raises(ValueError, match="structure mismatch"):
        torch_engine(additional=False).load_checkpoint(tmp_path / "ck")
    state = torch_engine().state_dict()
    with pytest.raises(ValueError, match="view groups"):
        torch_engine(additional=False).load_state_dict(state)


def test_jax_engine_state_carries_into_the_port():
    """The JAX engine's state_dict (numpy) loads into the port's engine as
    is: both continue 2 frames with equal seed, frame counter and draws,
    the pose within 1e-6, and the port's accumulation is the loaded one
    blended with the JAX eager renderer's frames on the next seeds."""
    je = JEngine(jlib.room_with_sphere(), jrenderer.RenderConfig(**MAIN), JVec4.of(0.0, -2.0, 0.0, 0.0),
                 jcam.CameraAngles(jnp.float32(0.1), jnp.float32(0.0), jnp.float32(0.0)),
                 impl="xla", deterministic=True, psi_constraint=(0.0, 0.785))
    je.rotate(d_fi=0.05, d_psi=0.2)
    je.step_frames(2)
    state = je.state_dict()
    te = torch_engine(additional=False)
    te.load_state_dict(state)
    assert torch.equal(te.accum, torch.from_numpy(np.array(state["accums"][0])))
    je.step_frames(2)
    te.step_frames(2)
    assert (te.seed, te.frame_number, te._rng_draws) == (je.seed, je.frame_number, je._rng_draws)
    np.testing.assert_allclose([float(a) for a in te.angles], [float(a) for a in je.angles],
                               atol=1e-6)
    np.testing.assert_allclose([float(c) for c in te.focus], [float(c) for c in je.focus],
                               atol=1e-6)
    rng, seed, seeds = np.random.default_rng(0), 0, []
    for _ in range(je._rng_draws):
        seed ^= generate_seed(rng, wall_clock=False)
        seeds.append(seed)
    want = np.asarray(state["accums"][0])
    for frame, frame_seed in ((3, seeds[2]), (4, seeds[3])):
        img = np.asarray(jrenderer.render_image(je.scene, je.groups[0].camera(je),
                                                je.groups[0].cfg, np.uint32(frame_seed)))
        want = want + (img - want) * np.float32(1.0 / frame)
    assert_images_close(te.accum.numpy(), want, atol=1e-5, boundary_frac=0.02, mean_atol=0.05)


def packed_loop():
    """The packed loop of inverse_render --packed at a small shape."""
    args = inverse_render.parse_args(["--device", "cpu", "--impl", "kernel", "--packed",
                                      "--width", "16", "--height", "8", "--bounces", "1"])
    cfg, camera, target, scene0 = inverse_render.setup(args, CPU)
    step, init, unpack = inverse_render.packed_train_step(args, cfg, camera, scene0)
    return step, init, target, scene0, args.seed


def test_packed_train_state_resumes_bitwise(tmp_path):
    """k steps, save_train_state, a fresh loop that restores it, one more
    step: bitwise the uninterrupted k + 1 steps (vector, Adam's moments and
    step count, loss)."""
    step, init, target, scene0, seed = packed_loop()
    model, opt = init(scene0)
    for _ in range(3):
        step(model, opt, seed, target)
    checkpoint.save_train_state(tmp_path / "ck", model.scene_vec, opt.state_dict(), step=3)
    loss = step(model, opt, seed, target)

    fresh_model, fresh_opt = init(scene0)
    vec, opt_state, k = checkpoint.restore_train_state(tmp_path / "ck", fresh_model.scene_vec,
                                                       fresh_opt.state_dict())
    assert k == 3
    with torch.no_grad():
        fresh_model.scene_vec.copy_(vec)
    fresh_opt.load_state_dict(opt_state)
    assert torch.equal(step(fresh_model, fresh_opt, seed, target), loss)
    assert torch.equal(fresh_model.scene_vec, model.scene_vec)
    ours, ref = fresh_opt.state_dict()["state"][0], opt.state_dict()["state"][0]
    for key in ("step", "exp_avg", "exp_avg_sq"):
        assert torch.equal(ours[key], ref[key]), key


def test_adam_state_like_is_a_stepped_adams_structure(tmp_path):
    """adam_state_like turns a fresh Adam's state dict into a restore
    target for a stepped one's: restore accepts it, and the restored
    state loads into the fresh optimizer, whose next step is bitwise the
    stepped optimizer's."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(9, generator=g).requires_grad_(True)
    b = a.detach().clone().requires_grad_(True)
    stepped, fresh = torch.optim.Adam([a], lr=0.1), torch.optim.Adam([b], lr=0.1)
    for _ in range(3):
        a.grad = torch.randn(9, generator=g)
        stepped.step()
    checkpoint.save(tmp_path / "ck", {"opt": stepped.state_dict()})
    like = checkpoint.adam_state_like(fresh.state_dict(), [b])
    assert set(like["state"][0]) == set(stepped.state_dict()["state"][0])
    fresh.load_state_dict(checkpoint.restore(tmp_path / "ck", {"opt": like})["opt"])
    with torch.no_grad():
        b.copy_(a)
    grad = torch.randn(9, generator=g)
    for p, opt in ((a, stepped), (b, fresh)):
        p.grad = grad.clone()
        opt.step()
    assert torch.equal(a, b)


@pytest.mark.parametrize("route", [["--impl", "plain"], ["--impl", "kernel", "--packed"]],
                         ids=["pytree", "packed"])
def test_inverse_render_ckpt_restores(route, tmp_path, capsys):
    """--ckpt every 20 steps: the packed route's train state reads back
    with restore_train_state at step 20, the value it logged; the pytree
    route's {"scene", "opt"} with restore against a fresh step's
    structure."""
    ck = tmp_path / "ck"
    argv = ["--device", "cpu", "--width", "16", "--height", "10", "--steps", "20",
            "--bounces", "1", "--log-every", "19", "--tol", "100", "--ckpt", str(ck), *route]
    assert inverse_render.main(argv) == 0
    logged = [json.loads(line) for line in capsys.readouterr().out.splitlines()
              if line.startswith("{")]
    assert logged[-1]["step"] == 19
    args = inverse_render.parse_args(argv)
    cfg, camera, _, scene0 = inverse_render.setup(args, CPU)
    t = inverse_render.task(args.param)
    if args.packed:
        _, init, unpack = inverse_render.packed_train_step(args, cfg, camera, scene0)
        model, opt = init(scene0)
        vec, _, k = checkpoint.restore_train_state(ck, model.scene_vec, opt.state_dict())
        assert k == 20 and t.read(unpack(vec)) == logged[-1]["value"]
    else:
        _, init = diff.make_train_step(cfg, t.lr, camera, param_filter=t.param_filter)
        scene, opt = init(scene0)
        leaves = list(params.tree_leaves(scene))
        got = checkpoint.restore(ck, {"scene": leaves,
                                      "opt": checkpoint.adam_state_like(opt.state_dict(), leaves)})
        saved = iter(got["scene"])
        restored = params.map_leaves(lambda _: next(saved), scene)
        assert t.read(restored) == logged[-1]["value"]
        assert len(got["opt"]["state"]) == len(list(params.tree_leaves(scene)))
