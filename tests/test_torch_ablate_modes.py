"""K8's plain version (ops/cuda/ablate.py variant_plain) over K1's other
configurations against the JAX package's tools/grad_ablate.py ``build`` in
interpret mode: the sequential stream, the kepler and newton samplers and
the literal spec and trig folds.

The JAX ``_variant_kernel`` draws per-sample streams whatever
``cfg.rng_mode`` says (grad_ablate.py:80-87: each sample's
``sample_stream_bits`` and a fresh counter), so the port's K8 computes the
sequential configuration as the per-sample one. Each configuration runs
on sphere_plane_light and the duocylinder (the room for the sequential
stream, as tests/test_torch_ablate.py's references), JAX's leaves crossed
over to the port's, at tests/test_torch_ablate.py's K8_SHAPE (32x16, 2 spp,
2 bounces, light_coefficient 0.7, seed 5, a seeded uniform target);
tile_sublanes 4 makes the 512 pixels one JAX tile, so no padded lane enters
JAX's unmasked ``acc`` sum. K8 differentiates nothing, so the trig fold's
values need no nan-safe derivatives. The JAX values of a case are
computed once, all three modes together.

Tolerances: the room's, tests/test_torch_ablate.py's RTOL (its light comes
in whole quanta, which a float32 sum adds exactly). Elsewhere ``acc`` is
held within 1e-5, the loss's bound: the JAX kernel sums the 1536 channel
values in float32 (jnp.sum), whose rounding moves the sum by up to a few
1e-6 (sphere_plane_light: JAX 10182.490234375, a float32, against the
port's double sum 10182.5025, and float32 sums of the port's own values in
four orders 10182.521 to 10182.529), while the port sums in double.

At such shapes the five configurations can give the same values (the lit
pixels see the lamp directly or by a mirror, the samplers agree to
rounding, the folds find the same hits), so these tests hold the values;
chip_smoke.py's phase 17 holds each configuration's ``acc`` against K1's
light in the same configuration, which only that configuration's instance
gives.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import grad_ablate as jax_grad_ablate

from fourd_ray_tracing_tpu.models import renderer as jrenderer

from fourd_ray_tracing_tpu_torch.models import params
from fourd_ray_tracing_tpu_torch.models import renderer as trenderer
from fourd_ray_tracing_tpu_torch.ops.cuda import ablate, gradkernel, megakernel

from test_torch_ablate import K8_SHAPE, RTOL, SEED
from test_torch_soft_kernels import crossed, uniform

# One axis off the production configuration at a time.
CONFIGS = {"kepler": dict(sampler_method="kepler"), "newton": dict(sampler_method="newton"),
           "spec": dict(intersect="spec"), "trig": dict(intersect="trig")}
SCENES = ["sphere_plane_light", "duocylinder"]
SEQUENTIAL = dict(rng_mode="sequential")
JAX_RTOL = dict(RTOL, acc=RTOL["loss"])


def jax_values(name, change):
    """The JAX tool's three values of the case, at seed SEED."""
    js, jc, _, _ = crossed(name)
    cfg = jrenderer.RenderConfig(**dict(K8_SHAPE, **change), tile_sublanes=4)
    target = jnp.asarray(uniform(1, (16, 32, 3)))
    return {mode: float(jax_grad_ablate.build(js, jc, cfg, target, mode)(np.uint32(SEED)))
            for mode in ablate.MODES}


def port_values(name, change):
    _, _, ts, tc = crossed(name)
    cfg = trenderer.RenderConfig(**dict(K8_SHAPE, **change))
    target = torch.from_numpy(uniform(1, (16, 32, 3)))
    return {mode: ablate.variant_plain(mode, ts, tc, cfg, SEED, target) for mode in ablate.MODES}


def assert_values(label, values, ref, rtol):
    for mode in ablate.MODES:
        value = values[mode]
        print(f"K8 {label} {mode}: port {float(value)} JAX {ref[mode]}")
        assert value.dtype == torch.float64 and value.dim() == 0
        np.testing.assert_allclose(float(value), ref[mode], rtol=rtol[mode], err_msg=mode)
    assert float(values["vjp"]) == float(values["loss"])


def test_sequential_stream_is_the_per_sample_one():
    """The sequential configuration: JAX's per-sample value in every mode,
    and the port's values bitwise its per-sample configuration's."""
    ref = jax_values("room_with_sphere", SEQUENTIAL)
    values = port_values("room_with_sphere", SEQUENTIAL)
    assert_values("room_with_sphere sequential", values, ref, RTOL)
    per_sample = port_values("room_with_sphere", {})
    assert all(torch.equal(values[m], per_sample[m]) for m in ablate.MODES)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("name", SCENES)
def test_plain_variant_matches_jax_kernel(name, config):
    """acc, loss and vjp of one configuration and scene against the JAX
    tool's."""
    assert_values(f"{name} {config}", port_values(name, CONFIGS[config]),
                  jax_values(name, CONFIGS[config]), JAX_RTOL)


def test_kernel_configs_refuse_the_sequential_stream_but_k8():
    """K4, K5 and K6 keep refusing the sequential stream (as JAX's
    _check_cfg refuses it); K8 takes it as the per-sample configuration,
    whose launch and count key it gets."""
    _, _, ts, tc = crossed("room_with_sphere")
    lay = params.layout(ts, tc)
    for change in ({}, dict(sampler_method="newton", intersect="trig")):
        cfg = trenderer.RenderConfig(**dict(K8_SHAPE, rng_mode="sequential", **change))
        with pytest.raises(ValueError, match="per-sample"):
            gradkernel.check_kernel_config(cfg)
        per_sample = ablate.per_sample(cfg)
        assert per_sample == dataclasses.replace(cfg, rng_mode="per_sample")
        gradkernel.check_kernel_config(per_sample)
        assert megakernel.launch_config(per_sample, lay).startswith("per_sample/")
        assert gradkernel._modes(per_sample, lay) == (None if not change else (2, 2, 2))
