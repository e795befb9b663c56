"""The port's row-sharded path (parallel/mesh.py, the kernel wrappers'
``sharded_*`` functions, diff.py's mesh branches, inverse_render --mesh,
multihost_run) on the CPU, over gloo.

The sharded runs happen in worker processes (multihost_run.spawn: one
spawn per world size, each doing all of its checks and returning numpy
results); the single-process references run here without a mesh. On the
CPU the kernel route runs the kernels' plain versions on each rank's rows.
Tolerances (the counterparts of tests/test_sharding.py): images bitwise
when the samples axis is 1, within 2e-6 when it is split (the per-pixel
sum reassociates); gradients within rtol 1e-4, atol 1e-7; losses and
parameters after 3 Adam steps within rtol 1e-5 (multihost_run.TOL). The
kernel route splits the rows over every rank whatever the mesh's shape, so
its images stay bitwise on (2, 2), (1, 4) and (4, 1) meshes too, and on 3
rows over 4 ranks, where rank 0's block is empty.
render_light_tile is held against the JAX package's within
tests/helpers.py:assert_images_close (XLA on the CPU fuses multiply-adds).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourd_ray_tracing_tpu import camera as jcam
from fourd_ray_tracing_tpu.models import library as jlib
from fourd_ray_tracing_tpu.models import renderer as jrenderer
from fourd_ray_tracing_tpu.ops.vec4 import Vec4 as JVec4

from fourd_ray_tracing_tpu_torch import camera as tcam
from fourd_ray_tracing_tpu_torch import diff, inverse_render, multihost_run
from fourd_ray_tracing_tpu_torch.models import library as tlib
from fourd_ray_tracing_tpu_torch.models import params
from fourd_ray_tracing_tpu_torch.models import renderer as trenderer
from fourd_ray_tracing_tpu_torch.ops.cuda import gradkernel, megakernel
from fourd_ray_tracing_tpu_torch.ops.vec4 import Vec4 as TVec4
from fourd_ray_tracing_tpu_torch.parallel import mesh as pmesh

from helpers import assert_images_close

CPU = torch.device("cpu")
Work = multihost_run.Work
W = Work(steps=3)  # room, 32x16, 4 spp, 2 bounces, seed 7
W3 = Work(views=tcam.VIEWS_ALL, seeds=(5, 6), steps=1)  # 3 views, a (2,) seed vector
TRAIN = ("kernel_hard", "kernel_soft", "plain_hard", "plain_soft")
KERNEL = ("image", "kernel_hard", "kernel_soft", "pair")
W_EMPTY = Work(height=3, steps=1)  # 3 rows over 4 ranks: blocks of 0, 1, 1 and 1 rows
MESHES = {"2x2": 0, "1x4": 1, "4x1": 2, "empty": 3}  # the kernel route's tasks of world4


@pytest.fixture(scope="module")
def world2():
    """Rank 0's and rank 1's results of a 2-rank run: (2, 1) mesh."""
    return multihost_run.spawn([(2, 1, W, ["plain_image", "image", *TRAIN, "pair"]),
                                (2, 1, W3, ["image"])], nprocs=2)


@pytest.fixture(scope="module")
def world3():
    """3 ranks: H = 16 rows in blocks of 5, 5 and 6."""
    return multihost_run.spawn([(3, 1, W3, ["image", "kernel_hard"])], nprocs=3)


@pytest.fixture(scope="module")
def world4():
    """4 ranks: the (2, 2), (1, 4) and (4, 1) meshes, and 3 rows on a (2, 2)
    mesh."""
    return multihost_run.spawn([(2, 2, W, ["plain_image", "plain_hard", "plain_soft", *KERNEL]),
                                (1, 4, W, ["plain_image", *KERNEL]),
                                (4, 1, W, KERNEL),
                                (2, 2, W_EMPTY, KERNEL)], nprocs=4)


@pytest.fixture(scope="module")
def single():
    items = ["plain_image", "image", *TRAIN, "pair"]
    return {"W": multihost_run.run_items(None, W, items, CPU),
            "W3": multihost_run.run_items(None, W3, ["image", "kernel_hard"], CPU),
            "W_EMPTY": multihost_run.run_items(None, W_EMPTY, KERNEL, CPU)}


def room_and_camera(views=("yxz",)):
    orient = tcam.orientation_from_angles(*tcam.CameraAngles.of(0.1, -0.2, 0.3, device=CPU), CPU)
    camera = tcam.make_camera(TVec4.of(0.0, -2.0, 0.3, 0.1, device=CPU), orient, 1.5, 2.0,
                              views, CPU)
    return tlib.room_with_sphere(CPU), camera


# --- render_light_tile ------------------------------------------------------------

@pytest.mark.parametrize("views", [("yxz",), tcam.VIEWS_ALL], ids=["1view", "3views"])
def test_tile_row_blocks_are_the_image_rows(views):
    """Row blocks of render_light_tile, scaled by 1/spp and concatenated,
    are bitwise render_light, for an uneven split."""
    scene, camera = room_and_camera(views)
    cfg = W.cfg()
    full = trenderer.render_light(scene, camera, cfg, 9)
    blocks = [trenderer.render_light_tile(scene, camera, cfg, 9, *pmesh.row_block(16, 3, i))
              * trenderer.inv_samples(cfg) for i in range(3)]
    assert torch.equal(torch.cat(blocks, dim=-3), full)


def test_tile_sample_blocks_sum_to_the_image():
    """Single-sample tiles added in order are bitwise the sample sum; two
    2-sample blocks reassociate it, within 2e-6."""
    scene, camera = room_and_camera()
    cfg = W.cfg()
    whole = trenderer.render_light_tile(scene, camera, cfg, 9)
    acc = trenderer.render_light_tile(scene, camera, cfg, 9, sample0=0, n_samples=1)
    for s in range(1, cfg.samples):
        acc = acc + trenderer.render_light_tile(scene, camera, cfg, 9, sample0=s, n_samples=1)
    assert torch.equal(acc, whole)
    halves = sum(trenderer.render_light_tile(scene, camera, cfg, 9, sample0=s, n_samples=2)
                 for s in (0, 2))
    np.testing.assert_allclose(halves.numpy(), whole.numpy(), atol=2e-6 * cfg.samples)
    assert torch.equal(whole * trenderer.inv_samples(cfg),
                       trenderer.render_light(scene, camera, cfg, 9))


@pytest.mark.parametrize("block", [(0, 16, 0, 4), (4, 8, 1, 2), (11, 5, 3, 1)])
def test_tile_matches_jax_render_light_tile(block):
    row0, n_rows, sample0, n_samples = block
    zero = jnp.float32(0)
    jc = jcam.camera_from_state(JVec4.of(0.0, -2.0, 0.0, 0.0), jcam.CameraAngles(zero, zero, zero),
                                1.5, 2.0)
    jcfg = jrenderer.RenderConfig(width=32, height=16, samples=4, reflections_amount=2,
                                  rng_mode="per_sample")
    ref = np.asarray(jrenderer.render_light_tile(jlib.room_with_sphere(), jc, jcfg, 7, row0=row0,
                                                 n_rows=n_rows, sample0=sample0,
                                                 n_samples=n_samples))
    tc = tcam.camera_from_state(TVec4.of(0.0, -2.0, 0.0, 0.0, device=CPU),
                                tcam.CameraAngles.of(0.0, 0.0, 0.0, device=CPU), 1.5, 2.0,
                                device=CPU)
    out = trenderer.render_light_tile(tlib.room_with_sphere(CPU), tc, W.cfg(), 7, row0, n_rows,
                                      sample0, n_samples)
    assert out.shape == ref.shape == (n_rows, 32, 3)
    assert_images_close(out.numpy() / n_samples, ref / n_samples)


# --- The mesh ---------------------------------------------------------------------

def test_row_blocks_cover_the_image_evenly():
    assert [pmesh.row_block(16, 3, i) for i in range(3)] == [(0, 5), (5, 5), (10, 6)]
    for height, n in ((720, 4), (720, 7), (16, 16)):
        blocks = [pmesh.row_block(height, n, i) for i in range(n)]
        assert sum(b for _, b in blocks) == height
        assert all(a + b == c for (a, b), (c, _) in zip(blocks, blocks[1:]))
        assert max(b for _, b in blocks) - min(b for _, b in blocks) <= 1


def test_one_process_mesh_and_validation():
    mesh = pmesh.make_mesh()
    assert (mesh.rays, mesh.samples, mesh.rank, mesh.world, mesh.backend) == (1, 1, 0, 1, None)
    t = torch.arange(3.0)
    assert pmesh.all_reduce(t, mesh) is t
    with pytest.raises(ValueError, match="mesh 2x1"):
        pmesh.make_mesh(rays=2)
    with pytest.raises(ValueError, match="not divisible by rays"):
        pmesh._validate(trenderer.RenderConfig(height=15), 2, 1)
    with pytest.raises(ValueError, match="per_sample"):
        pmesh._validate(trenderer.RenderConfig(height=16, samples=4), 2, 2)
    with pytest.raises(ValueError, match="backend"):
        pmesh.initialize_distributed("mpi")


def test_one_rank_mesh_is_the_single_process():
    """A 1-rank mesh: the plain and kernel routes and the train step are
    bitwise the calls without a mesh."""
    scene, camera = room_and_camera(tcam.VIEWS_ALL)
    cfg, mesh = W.cfg(), pmesh.make_mesh()
    seeds = np.array([3, 4], np.uint32)
    ref = trenderer.render_image(scene, camera, cfg, seeds)
    assert torch.equal(pmesh.sharded_render_image(scene, camera, cfg, seeds, mesh), ref)
    assert torch.equal(megakernel.sharded_render_image_cuda(scene, camera, cfg, seeds, mesh), ref)
    assert torch.equal(pmesh.sharded_renderer(cfg, mesh, impl="kernel")(scene, camera, seeds), ref)
    with pytest.raises(ValueError, match="impl"):
        pmesh.sharded_renderer(cfg, mesh, impl="xla")


def test_sharded_calls_off_the_mesh_device_raise():
    """No fallback: a mesh on a card takes no CPU tensors."""
    scene, camera = room_and_camera()
    cfg = W.cfg()
    mesh = pmesh.Mesh(rays=1, samples=1, rank=0, device=torch.device("cuda", 0))
    vec = params.pack(scene, camera)
    with pytest.raises(ValueError, match="mesh's device"):
        megakernel.sharded_render_light_cuda(scene, camera, cfg, 1, mesh)
    with pytest.raises(ValueError, match="mesh's device"):
        gradkernel.sharded_loss_and_grad(vec, scene, camera, cfg, 1, torch.zeros(16, 32, 3), mesh)
    with pytest.raises(ValueError, match="mesh's device"):
        diff.image_loss_kernel(vec, scene, camera, cfg, 1, torch.zeros(16, 32, 3), mesh)


@pytest.mark.parametrize("rays,samples", [(2, 2), (4, 1), (1, 4)])
def test_kernel_blocks_split_the_rows_over_the_whole_mesh(rays, samples):
    """A kernel launch takes every sample, so the kernel route's blocks
    split the rows over every rank of the mesh, whatever its shape: rank
    ray_index * samples + sample_index holds block rank of world, as the
    JAX package's linear device index; 3 rows over 4 ranks leave rank 0
    an empty block. The plain route keeps its (rays block, samples block)
    layout; a tensor off the mesh's device raises."""
    meshes = [pmesh.Mesh(rays=rays, samples=samples, rank=r, device=CPU) for r in range(4)]
    for r, mesh in enumerate(meshes):
        assert mesh.ray_index * samples + mesh.sample_index == r
        assert mesh.kernel_rows(16, CPU) == pmesh.row_block(16, 4, r) == (4 * r, 4)
        assert mesh.rows(16) == pmesh.row_block(16, rays, r // samples)
    assert [m.kernel_rows(3, CPU) for m in meshes] == [(0, 0), (0, 1), (1, 1), (2, 1)]
    on_card = pmesh.Mesh(rays=rays, samples=samples, rank=1, device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="mesh's device"):
        on_card.kernel_rows(16, CPU)


def test_kernel_route_with_a_mesh_runs_the_sharded_wrappers(monkeypatch):
    """make_train_step(impl="kernel", mesh=...) and render_light_pair with a
    mesh go through the sharded wrappers, once per step or call, and on a
    1-rank mesh give the calls without a mesh."""
    calls = []

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)

    for name in ("sharded_loss_and_grad", "sharded_render_light_vjp_multi",
                 "sharded_soft_loss_and_grad"):
        spy(gradkernel, name)
    spy(megakernel, "sharded_render_light_cuda_multi")
    scene, camera = room_and_camera()
    cfg, mesh = W.cfg(), pmesh.make_mesh()
    target = torch.zeros(16, 32, 3)
    for soft in (None, ("spheres", 0)):
        losses = []
        for m in (None, mesh):
            step, init = diff.make_train_step(cfg, 1e-3, camera, impl="kernel", mesh=m,
                                              soft_object_ref=soft)
            losses.append(float(step(*init(scene), 3, target)[2]))
        np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    vec = params.pack(scene, camera).detach().requires_grad_(True)
    grads = []
    for m in (None, mesh):
        s, c = params.unpack(vec, scene, camera)
        light = diff.render_light_pair(s, diff.zero_object(s, ("spheres", 0)), c, cfg, 3, m)
        grads.append(torch.autograd.grad(light.sum(), vec)[0])
    assert torch.equal(grads[1], grads[0])
    assert calls == ["sharded_loss_and_grad", "sharded_soft_loss_and_grad",
                     "sharded_render_light_cuda_multi", "sharded_render_light_vjp_multi"]


def test_multihost_run_defaults_to_the_card(monkeypatch):
    """The runner runs on the card unless asked for the CPU; with no card
    it exits."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        multihost_run.main(["--nprocs", "2"])


def test_hyperplane_soft_loss_with_a_mesh_raises():
    scene, camera = room_and_camera()
    vec = params.pack(scene, camera)
    with pytest.raises(ValueError, match="hyperplanes have no miss radius"):
        diff.soft_image_loss_kernel(vec, scene, camera, W.cfg(), 1, torch.zeros(16, 32, 3),
                                    ("spaces", 0), mesh=pmesh.make_mesh())
    step, init = diff.make_train_step(W.cfg(), 1e-3, camera, impl="kernel",
                                      soft_object_ref=("spaces", 0), mesh=pmesh.make_mesh())
    state = init(scene)
    with pytest.raises(ValueError, match="hyperplanes have no miss radius"):
        step(*state, 1, torch.zeros(16, 32, 3))


def test_sharded_wrappers_on_one_rank_match_the_plain_versions():
    """The sharded K4/K5/K6 wrappers (CPU: the plain versions on the
    rank's rows) on a 1-rank mesh are the unsharded plain versions (K5
    and K6 bitwise)."""
    scene, camera = room_and_camera()
    cfg, mesh = W.cfg(), pmesh.make_mesh()
    vec = params.pack(scene, camera)
    rng = np.random.default_rng(3)
    target = torch.from_numpy(rng.uniform(0, 1, (16, 32, 3)).astype(np.float32))
    # K4's plain version by rows sums in float64 (the banded form): equal
    # up to the order of the sums.
    loss, grad = gradkernel.sharded_loss_and_grad(vec, scene, camera, cfg, 2, target, mesh)
    ref = gradkernel.loss_and_grad_plain(vec, scene, camera, cfg, 2, target)
    np.testing.assert_allclose(float(loss), float(ref[0]), rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), ref[1].numpy(), rtol=1e-5, atol=1e-8)
    rows = params.stack_rows((scene, diff.zero_object(scene, ("spheres", 0))), camera)
    cot = torch.from_numpy(rng.normal(0, 1, (2, 16, 32, 3)).astype(np.float32))
    assert torch.equal(
        gradkernel.sharded_render_light_vjp_multi(rows, scene, camera, cfg, 2, cot, mesh),
        gradkernel.render_light_vjp_plain(rows, scene, camera, cfg, 2, cot))
    alpha = diff.object_coverage(scene, ("spheres", 0), camera, cfg, 0.05).detach()
    zmap = params.soft_zero_map(scene, camera, ("spheres", 0))
    out = gradkernel.sharded_soft_loss_and_grad(vec, scene, camera, cfg, 2, target, alpha, zmap,
                                                mesh)
    ref = gradkernel.render_soft_loss_and_grad_plain(vec, scene, camera, cfg, 2, target, alpha,
                                                     zmap)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


def test_plain_versions_by_rows_sum_to_the_whole():
    """The rows' parts of K4's, K5's and K6's plain versions over a 3-way
    split (5, 5, 6 rows) sum to the whole image's, within float32 sums; K6's
    alpha cotangent of a block is bitwise those rows of the whole one."""
    scene, camera = room_and_camera()
    cfg = W.cfg()
    vec = params.pack(scene, camera)
    rng = np.random.default_rng(4)
    target = torch.from_numpy(rng.uniform(0, 1, (16, 32, 3)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(0, 1, (16, 32, 3)).astype(np.float32))
    alpha = diff.object_coverage(scene, ("spheres", 0), camera, cfg, 0.05).detach()
    zmap = params.soft_zero_map(scene, camera, ("spheres", 0))
    blocks = [pmesh.row_block(16, 3, i) for i in range(3)]
    close = dict(rtol=1e-4, atol=1e-7)
    parts = [gradkernel.loss_and_grad_plain(vec, scene, camera, cfg, 2, target[r0:r0 + n],
                                            rows=(r0, n)) for r0, n in blocks]
    whole = gradkernel.loss_and_grad_plain(vec, scene, camera, cfg, 2, target)
    np.testing.assert_allclose(sum(float(p[0]) for p in parts), float(whole[0]), rtol=1e-6)
    np.testing.assert_allclose(sum(p[1] for p in parts).numpy(), whole[1].numpy(), **close)
    vjp = [gradkernel.render_light_vjp_plain(vec, scene, camera, cfg, 2, cot[r0:r0 + n],
                                             rows=(r0, n)) for r0, n in blocks]
    np.testing.assert_allclose(sum(vjp).numpy(), gradkernel.render_light_vjp_plain(
        vec, scene, camera, cfg, 2, cot).numpy(), **close)
    soft = gradkernel.render_soft_loss_and_grad_plain(vec, scene, camera, cfg, 2, target, alpha,
                                                      zmap)
    parts = [gradkernel.render_soft_loss_and_grad_plain(
        vec, scene, camera, cfg, 2, target[r0:r0 + n], alpha[r0:r0 + n], zmap, rows=(r0, n))
        for r0, n in blocks]
    np.testing.assert_allclose(sum(float(p[0]) for p in parts), float(soft[0]), rtol=1e-6)
    np.testing.assert_allclose(sum(p[1] for p in parts).numpy(), soft[1].numpy(), **close)
    assert torch.equal(torch.cat([p[2] for p in parts]), soft[2])


# --- The sharded runs against the single process ------------------------------------

def test_every_rank_returns_every_task(world2, world3, world4):
    assert [len(world2), len(world3), len(world4)] == [2, 3, 4]
    assert [len(r) for r in world2] == [2, 2] and [len(r) for r in world4] == [4] * 4


@pytest.mark.parametrize("shape", ["2x1", "2x2", "1x4"])
def test_plain_route_images(world2, world4, single, shape):
    """The plain route on meshes (2, 1), (2, 2) and (1, 4): bitwise the
    single process with the samples axis at 1, within 2e-6 with it split."""
    runs = {"2x1": [r[0] for r in world2], "2x2": [r[0] for r in world4],
            "1x4": [r[1] for r in world4]}[shape]
    ref = single["W"]["plain_image"]["image"]
    for task in runs:
        out = task["plain_image"]["image"]
        if shape == "2x1":
            np.testing.assert_array_equal(out, ref)
        else:
            np.testing.assert_allclose(out, ref, atol=2e-6)


@pytest.mark.parametrize("world", [2, 3])
def test_kernel_route_images_are_bitwise(world, world2, world3, single):
    """The kernel route (its plain version on each rank's rows here): one
    view and a scalar seed; 3 views and a (2,) seed vector; 16 rows over 3
    ranks in blocks of 5, 5 and 6."""
    if world == 2:
        for rank in world2:
            np.testing.assert_array_equal(rank[0]["image"]["image"], single["W"]["image"]["image"])
            np.testing.assert_array_equal(rank[1]["image"]["image"],
                                          single["W3"]["image"]["image"])
    else:
        for rank in world3:
            out = rank[0]["image"]["image"]
            assert out.shape == (2, 3, 16, 32, 3)
            np.testing.assert_array_equal(out, single["W3"]["image"]["image"])


@pytest.mark.parametrize("item", TRAIN)
def test_sharded_train_steps_match_the_single_process(item, world2, world4, single):
    """3 steps of make_train_step(mesh=...): the last step's gradients
    within rtol 1e-4, atol 1e-7, losses and parameters within rtol 1e-5
    (multihost_run.TOL); the kernel route on the (2, 1) mesh, the plain
    route on it and on the (2, 2) mesh (split samples: the sample sum's
    backward is the identity, so no gradient is counted twice)."""
    ref = single["W"][item]
    runs = [r[0][item] for r in world2]
    if item.startswith("plain"):
        runs += [r[0][item] for r in world4]
    for res in runs:
        np.testing.assert_allclose(res["grad"], ref["grad"], rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(res["losses"], ref["losses"], rtol=1e-5)
        np.testing.assert_allclose(res["params"], ref["params"], rtol=1e-5)
        assert multihost_run.compare({item: res}, {item: ref}, W.lr)[item]["ok"]
    assert np.abs(ref["grad"]).max() > 0 and len(ref["losses"]) == 3


def test_uneven_kernel_route_grads(world3, single):
    """K4's plain version on row blocks of 5, 5 and 6 rows, 3 views."""
    ref = single["W3"]["kernel_hard"]
    for rank in world3:
        res = rank[0]["kernel_hard"]
        np.testing.assert_allclose(res["grad"], ref["grad"], rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(res["losses"], ref["losses"], rtol=1e-5)


@pytest.mark.parametrize("item", KERNEL)
@pytest.mark.parametrize("shape", list(MESHES))
def test_kernel_route_on_any_mesh(shape, item, world4, single):
    """The kernel route on (2, 2), (1, 4) and (4, 1) meshes of 4 ranks, and
    on 3 rows over a (2, 2) mesh (rank 0's block empty: no launch, zeros to
    the all-reduce, an empty block to the gather): the image bitwise the
    single process, the hard (K4) and soft (K6) steps' losses and
    parameters within multihost_run.TOL, the pair's gradient (K2 + K5)
    within mixed 1e-4."""
    ref = single["W_EMPTY" if shape == "empty" else "W"][item]
    for rank in world4:
        res = rank[MESHES[shape]][item]
        if item == "image":
            np.testing.assert_array_equal(res["image"], ref["image"])
        else:
            assert multihost_run.compare({item: res}, {item: ref}, W.lr)[item]["ok"]
        if item == "pair":
            assert np.abs(res["grad"]).max() > 0


def test_sharded_pair_grads(world2, single):
    """render_light_pair on each rank's rows (K2 forward, two-row K5
    backward on the card), gradients all-reduced."""
    ref = single["W"]["pair"]["grad"]
    for rank in world2:
        assert multihost_run.mixed_rel(rank[0]["pair"]["grad"], ref) < 1e-4


def test_every_rank_holds_the_same_results(world2, world4):
    for runs in (world2, world4):
        for item, res in runs[0][0].items():
            for other in runs[1:]:
                for key in ("image", "params", "losses"):
                    if key in res:
                        np.testing.assert_array_equal(other[0][item][key], res[key])


# --- Entry points -------------------------------------------------------------------

def test_inverse_render_mesh_one_rank_recovers_glow(capsys):
    rc = inverse_render.main(["--mesh", "--device", "cpu", "--impl", "kernel", "--width", "32",
                              "--height", "20", "--steps", "40"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0, out[-1]
    assert out[0].startswith("mesh 1x1 backend=none")
    assert out[-1].startswith("recovered glow=")


def test_inverse_render_mesh_refuses_packed():
    with pytest.raises(SystemExit, match="no --mesh"):
        inverse_render.main(["--mesh", "--packed", "--impl", "kernel", "--device", "cpu"])
