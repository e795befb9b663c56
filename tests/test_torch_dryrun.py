"""The port's compile check and multi-device dry run (dryrun.py) and the
measurement half of its runner (multihost_run --frames/--scaling), on the
CPU over gloo ranks.

The entry's forward is held against the JAX package's flagship forward
(the repo's root entry file, jitted as its ``__main__`` runs it) within
tests/helpers.py:assert_images_close (XLA on the CPU fuses multiply-adds);
the measurement's mean light within rtol 1e-5 and gradient norm within
1e-4 of the JAX single-process values at the same work, computed as
tests/test_multihost.py does, and the sharded K4's loss against a zero
target and the norm of its scene gradient within the same tolerances of
JAX's image_loss and its gradient there.
"""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from test_multihost import _expected

from fourd_ray_tracing_tpu_torch import dryrun, multihost_run

from helpers import assert_images_close


@pytest.fixture(scope="module")
def jax_figures():
    """The JAX single process at the measurement's work: the mean light
    and the norm of its scene gradient (test_multihost._expected), and
    image_loss against a zero target with the global norm of its scene
    gradient (the figures the sharded K4 gives), all through the jnp
    route."""
    import optax
    from fourd_ray_tracing_tpu import camera as jcam
    from fourd_ray_tracing_tpu import diff as jdiff
    from fourd_ray_tracing_tpu.models import library as jlibrary
    from fourd_ray_tracing_tpu.models.renderer import RenderConfig as JaxConfig
    from fourd_ray_tracing_tpu.ops.vec4 import Vec4 as JaxVec4
    from tools.multihost_run import BOUNCES, HEIGHT, SAMPLES, WIDTH

    cfg = JaxConfig(width=WIDTH, height=HEIGHT, samples=SAMPLES, reflections_amount=BOUNCES,
                    rng_mode="per_sample")
    camera = jcam.camera_from_state(
        JaxVec4.of(0.0, -2.0, 0.0, 0.0),
        jcam.CameraAngles(jnp.float32(0), jnp.float32(0), jnp.float32(0)), 1.5, 2.0)
    loss, grad = jdiff.render_grad(jlibrary.sphere_plane_light(), camera, cfg, jnp.uint32(7),
                                   jnp.zeros((HEIGHT, WIDTH, 3), jnp.float32))
    return (*_expected(), float(loss), float(optax.global_norm(grad)))


def test_entry_matches_the_jax_flagship_forward():
    fn, args = __graft_entry__.entry()
    ref = np.asarray(jax.jit(fn)(*args))
    forward, example = dryrun.entry("cpu")
    out = forward(*example)
    assert out.shape == ref.shape == (64, 128, 3) and out.device.type == "cpu"
    assert_images_close(out.numpy(), ref)


def test_entry_and_the_cli_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main([])


def test_dryrun_multichip_on_four_ranks():
    """A (2, 2) mesh: the plain step, two kernel-route hard steps and a soft
    step, and the kernel route's image, against one process (dryrun raises
    on a disagreement); no launch on the CPU."""
    summary = dryrun.dryrun_multichip(4, device="cpu")
    assert summary["ok"] and summary["mesh"] == [2, 2] and summary["backend"] == "gloo"
    assert summary["items"]["image"]["bitwise"]
    assert summary["items"]["dryrun"]["loss_rel"] <= multihost_run.TOL["loss_rtol"]
    assert summary["launches_per_rank"] == [{"dryrun": {}, "image": {}}] * 4
    shape, work = dryrun.multichip_work(4)
    assert shape == (2, 2) and (work.width, work.height, work.samples) == (16, 8, 4)
    assert dryrun.multichip_work(3)[0] == (3, 1) and dryrun.multichip_work(1)[0] == (1, 1)


def test_dryrun_multihost_on_two_processes(jax_figures):
    result = dryrun.dryrun_multihost(2, device="cpu")
    assert result["nprocs"] == 2 and result["mesh"] == [1, 2] and result["frames"] == 1
    assert math.isfinite(result["mean_light"]) and math.isfinite(result["grad_norm"])
    np.testing.assert_allclose(result["mean_light"], jax_figures[0], rtol=1e-5)
    np.testing.assert_allclose(result["grad_norm"], jax_figures[1], rtol=1e-4)


def test_scaling_matches_the_jax_single_process(capsys, jax_figures):
    """--scaling: 1 rank on a (1, 1) mesh, then 2 on a (1, 2) mesh whose
    samples axis straddles them; each line's plain-route figures against
    the JAX single process, K3's mean light too, and the scaling line's
    keys, flagged as a plumbing check on the CPU."""
    assert multihost_run.main(["--scaling", "--device", "cpu"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [line["mode"] for line in lines] == ["worker0", "worker0", "scaling"]
    want_mean, want_norm, want_loss, want_kernel_norm = jax_figures
    for n, line in zip((1, 2), lines):
        assert line["nprocs"] == n and line["mesh"] == list(multihost_run.mesh_shape(n))
        np.testing.assert_allclose(line["mean_light"], want_mean, rtol=1e-5)
        np.testing.assert_allclose(line["kernel_mean_light"], want_mean, rtol=1e-5)
        np.testing.assert_allclose(line["grad_norm"], want_norm, rtol=1e-4)
        np.testing.assert_allclose(line["kernel_loss"], want_loss, rtol=1e-5)
        np.testing.assert_allclose(line["kernel_grad_norm"], want_kernel_norm, rtol=1e-4)
        assert line["rays_per_s"] > 0 and line["kernel_rays_per_s"] > 0
    scaling = lines[2]
    assert scaling["rays_per_s_1proc"] == lines[0]["rays_per_s"]
    assert scaling["kernel_scaling_efficiency"] == pytest.approx(
        lines[1]["kernel_rays_per_s"] / lines[0]["kernel_rays_per_s"])
    assert {"rays_per_s_2proc", "scaling_efficiency", "kernel_rays_per_s_1proc",
            "kernel_rays_per_s_2proc"} <= set(scaling)
    assert "plumbing check" in scaling["note"]
    # The kernel figures agree between the two runs up to the order of the sums.
    np.testing.assert_allclose(lines[1]["kernel_loss"], lines[0]["kernel_loss"], rtol=1e-5)
    np.testing.assert_allclose(lines[1]["kernel_grad_norm"], lines[0]["kernel_grad_norm"],
                               rtol=1e-4)
