"""K8 over K1's other configurations (csrc/ablatemodes.cu: the pass-budget
variants with the kepler and newton samplers, the literal spec and trig
folds, and the fast fold over a hypercube without generators), compiled
for the host and run by the CPU stand-in for the card
(tests/test_torch_emulated_runtime.py, EMU), against the plain version
(ablate.variant_plain).

g++ builds ablate.cu and ablatemodes.cu alone behind EMU. Every library
scene and the hypercube built from its cells alone runs one configuration
(scene k configuration k mod 4: each configuration on one or two scenes),
all three variants, at 16x8, 2 spp, 3 bounces, held to the plain version
within tests/test_torch_ablate.py's RTOL; each launch is called as
ablate.launch_variant calls it (``launch``: the per-sample configuration,
gradkernel._modes' codes and launch_words' descriptor). Where the
configuration's light equals the production configuration's bit for bit
(the plain pipeline's render_light_tile), ``acc`` is the production
launch's bitwise, as the kernel sums the same values in the same order;
where it differs, ``acc`` differs. The kepler and newton samplers and the
trig fold call glibc's expf, logf, sinf, cosf, acosf and asinf here and
torch's own versions in the plain version: the light is piecewise constant
in the geometry, so an ulp apart moves no hit at these shapes. The card's
own runs are chip_smoke.py's phase 17.
"""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from fourd_ray_tracing_tpu_torch import diff
from fourd_ray_tracing_tpu_torch.models import params, renderer
from fourd_ray_tracing_tpu_torch.ops.cuda import ablate, build, gradkernel, megakernel

from test_torch_ablate import RTOL
from test_torch_adjoint_host import camera_of, ptr
from test_torch_emulated_runtime import VIEWS_1, ablate_launch, emulated_library, f32, layout_table
from test_torch_grad_modes_emulated import CONFIGS, SCENES, scene_of

SHAPE = dict(width=16, height=8, samples=2, reflections_amount=3, rng_mode="per_sample",
             light_coefficient=0.7)
SEED = 3  # ablate_launch's


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    so = emulated_library(tmp_path_factory.mktemp("ablate_modes_emulated"),
                          ("ablate.cu", "ablatemodes.cu"))
    return build.bind(ctypes.CDLL(str(so)), ("fourd_ablate_launch", "fourd_ablate_modes"))


def config(sampler="poly", intersect="fast", **kw):
    return renderer.RenderConfig(**dict(SHAPE, sampler_method=sampler, intersect=intersect,
                                        **dict(dict(sampler_iters=3), **kw)))


def target_of(cfg):
    return np.random.default_rng(4).uniform(0, 1, (cfg.height, cfg.width, 3)).astype(np.float32)


def launch(lib, mode, packed, lay, cfg, target):
    """The K8 launch of ``mode`` as ablate.launch_variant makes it."""
    cfg = ablate.per_sample(cfg)
    return ablate_launch(lib, ablate.MODES.index(mode), packed, lay, cfg, target,
                         gradkernel.launch_words(lay, cfg), gradkernel._modes(cfg, lay))


CASES = [(name, *CONFIGS[k % 4]) for k, name in enumerate(SCENES)]


@pytest.mark.parametrize("name,sampler,intersect", CASES,
                         ids=[f"{n}-{s if s != 'poly' else f}" for n, s, f in CASES])
def test_ablate_modes_match_plain(lib, name, sampler, intersect):
    """acc, loss and vjp of the configuration against variant_plain; vjp
    bitwise loss; acc bitwise the production launch's where the light is
    the production configuration's, else apart from it."""
    cfg = config(sampler, intersect)
    scene, camera = scene_of(name), camera_of(VIEWS_1)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    assert gradkernel._modes(cfg, lay) is not None
    target = target_of(cfg)
    values = {m: launch(lib, m, packed, lay, cfg, target) for m in ablate.MODES}
    for mode, value in values.items():
        ref = ablate.variant_plain(mode, scene, camera, cfg, SEED, torch.from_numpy(target))
        print(f"K8 {name} {sampler}/{intersect} {mode}: kernel {value} plain {float(ref)}")
        np.testing.assert_allclose(value, float(ref), rtol=RTOL[mode], err_msg=mode)
    assert values["vjp"] == values["loss"] and np.isfinite(values["acc"])
    if lay.hypercube_cells:  # no production launch takes it
        return
    prod = dataclasses.replace(cfg, sampler_method="poly", intersect="fast")
    same = torch.equal(*(renderer.render_light_tile(scene, camera, c, SEED, 0, cfg.height)
                         for c in (cfg, prod)))
    acc = launch(lib, "acc", packed, lay, prod, target)
    assert (values["acc"] == acc) == same, (values["acc"], acc, same)


def test_cells_only_hypercube_in_the_production_modes(lib):
    """The fast fold with the poly sampler over a hypercube without
    generators: the modes launch (CellsFold), against the plain version."""
    cfg = config()
    scene, camera = scene_of("hypercube_cells"), camera_of(VIEWS_1)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    assert gradkernel._modes(cfg, lay) == (0, 0, 3) and lay.hypercube_cells
    target = target_of(cfg)
    for mode in ablate.MODES:
        ref = ablate.variant_plain(mode, scene, camera, cfg, SEED, torch.from_numpy(target))
        np.testing.assert_allclose(launch(lib, mode, packed, lay, cfg, target), float(ref),
                                   rtol=RTOL[mode], err_msg=mode)


@pytest.mark.parametrize("change", [{}, dict(sampler="newton", intersect="trig")],
                         ids=["production", "newton-trig"])
def test_sequential_config_launches_its_per_sample_one(lib, change):
    """A sequential configuration launches its per-sample one (the
    production instances or the modes ones), as the JAX kernel draws
    per-sample streams: every variant bitwise that launch's."""
    scene, camera = scene_of("room_with_sphere"), camera_of(VIEWS_1)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    cfg = config(**change)
    seq = dataclasses.replace(cfg, rng_mode="sequential")
    assert gradkernel._modes(ablate.per_sample(seq), lay) == gradkernel._modes(cfg, lay)
    target = target_of(cfg)
    for mode in ablate.MODES:
        assert (launch(lib, mode, packed, lay, seq, target)
                == launch(lib, mode, packed, lay, cfg, target)), mode


@pytest.mark.parametrize("name", ["room_with_sphere", "tiger"])
def test_kepler_under_the_contract_is_the_unhinted_launch(lib, name):
    """The fast fold's kepler launch under with_frozen_hints (the hinted
    AnyFold and CompFold) bitwise the unhinted launch in every variant; a
    trig configuration under with_frozen_hints carries no hints."""
    scene, camera = scene_of(name), camera_of(VIEWS_1)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    cfg = config("kepler")
    hcfg = diff.with_frozen_hints(cfg, scene)
    assert megakernel.hinted(hcfg)
    target = target_of(cfg)
    for mode in ablate.MODES:
        assert (launch(lib, mode, packed, lay, hcfg, target)
                == launch(lib, mode, packed, lay, cfg, target)), mode
    assert not megakernel.hinted(diff.with_frozen_hints(config("newton", "trig"), scene))


def test_each_launch_reads_its_own_sampler(lib):
    """The sampler travels in each launch's descriptor: on the tiger,
    launches in kepler with 0 and with 3 Halley steps and in newton, in
    turns, bitwise across the turns and each its own plain version's acc;
    kepler's cube-root seed alone (0 steps) moves the sum."""
    scene, camera = scene_of("tiger"), camera_of(VIEWS_1)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    cfgs = [config("kepler", sampler_iters=0), config("kepler"), config("newton")]
    target = target_of(cfgs[0])
    first = [launch(lib, "acc", packed, lay, c, target) for c in cfgs]
    again = [launch(lib, "acc", packed, lay, c, target) for c in reversed(cfgs)][::-1]
    assert first == again
    for c, value in zip(cfgs, first):
        ref = ablate.variant_plain("acc", scene, camera, c, SEED, None)
        np.testing.assert_allclose(value, float(ref), rtol=RTOL["acc"])
    assert first[0] != first[1]


def test_modes_launch_refuses_what_it_does_not_take(lib):
    """cudaErrorInvalidValue (1) for a variant, fold or sampler code out of
    range, more than 16 Halley steps, no descriptor, and a literal fold
    handed a hinted descriptor."""
    cfg = config("kepler")
    scene, camera = scene_of("room_with_sphere"), camera_of(VIEWS_1)
    lay, packed = params.layout(scene, camera), params.pack(scene, camera).numpy()
    target = target_of(cfg)
    table = layout_table(lay)
    loss_parts, value = np.zeros(2, np.float64), np.zeros(1, np.float32)
    hinted = megakernel.hint_table(diff.with_frozen_hints(cfg, scene), lay)
    unhinted = megakernel.hint_table(cfg, lay)

    def call(mode, fold, sampler, iters, words):
        return lib.fourd_ablate_modes(
            fold, sampler, iters, mode, ptr(packed), 3, ctypes.addressof(table), cfg.width,
            cfg.height, cfg.samples, cfg.reflections_amount, f32(cfg.small_indent),
            f32(cfg.light_coefficient), ptr(target), ptr(loss_parts), ptr(value),
            None if words is None else ctypes.addressof(words), None)

    assert call(0, 0, 1, 3, unhinted) == 0 and call(2, 0, 1, 3, hinted) == 0
    assert call(1, 1, 0, 0, unhinted) == 0
    for args in ((3, 0, 1, 3, unhinted), (-1, 0, 1, 3, unhinted), (0, 3, 0, 0, unhinted),
                 (0, 0, 3, 0, unhinted), (0, 0, 1, 17, unhinted), (0, 0, 1, 3, None),
                 (0, 1, 0, 0, hinted), (0, 2, 2, 0, hinted)):
        assert call(*args) == 1, args
