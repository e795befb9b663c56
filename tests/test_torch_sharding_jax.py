"""The port's plain sharded render on a (2, 2) mesh of 4 gloo ranks against
the JAX package's parallel/mesh.py sharded_render_image on a (2, 2) mesh of
the CPU's virtual devices, within tests/helpers.py:assert_images_close (XLA
on the CPU fuses multiply-adds; torch does not). Its own file: the JAX
mesh render compiles for about a minute here, and tests/test_torch_sharding.py
runs beside it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fourd_ray_tracing_tpu import camera as jcam
from fourd_ray_tracing_tpu.models import library as jlib
from fourd_ray_tracing_tpu.models import renderer as jrenderer
from fourd_ray_tracing_tpu.ops.vec4 import Vec4 as JVec4
from fourd_ray_tracing_tpu.parallel import mesh as jmesh

from fourd_ray_tracing_tpu_torch import multihost_run

from helpers import assert_images_close

W = multihost_run.Work()  # room, 32x16, 4 spp, 2 bounces, light_coefficient 0.7, seed 7


@pytest.fixture(scope="module")
def jax_mesh_image():
    zero = jnp.float32(0)
    camera = jcam.camera_from_state(JVec4.of(0.0, -2.0, 0.0, 0.0),
                                    jcam.CameraAngles(zero, zero, zero), 1.5, 2.0)
    cfg = jrenderer.RenderConfig(width=W.width, height=W.height, samples=W.samples,
                                 reflections_amount=W.bounces, rng_mode="per_sample",
                                 light_coefficient=W.light_coefficient)
    mesh = jmesh.make_mesh(rays=2, samples=2, devices=jax.devices()[:4])
    return np.asarray(jmesh.sharded_render_image(jlib.room_with_sphere(), camera, cfg,
                                                 W.seeds[0], mesh))


@pytest.fixture(scope="module")
def port_mesh_images():
    return [rank[0]["plain_image"]["image"]
            for rank in multihost_run.spawn([(2, 2, W, ["plain_image"])], nprocs=4)]


def test_port_mesh_matches_jax_mesh(jax_mesh_image, port_mesh_images):
    assert jax_mesh_image.shape == (W.height, W.width, 3)
    for image in port_mesh_images:
        assert_images_close(image, jax_mesh_image)
