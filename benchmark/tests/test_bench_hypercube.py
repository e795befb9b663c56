"""The hypercube's configuration: its file and both cells resolve by name,
and the frozen copy agrees with the port's plain pipeline on it at a tiny
size on the CPU, as test_bench_reference.py holds the room and the tiger:
the image, the static hints and freeze mask (over the 8 cells' own
copies and the generators' point, axes and r), and the loss and
gradient; and, as test_bench_faults.py holds the other cells, a sound run
of each cell is correct and its faults and the bfloat16 control are
not."""
import pytest

from benchmark.harness import spec
from benchmark.tests import test_bench_faults as faults
from benchmark.tests import test_bench_reference as ref
from benchmark.tests.helpers import ROOT, tiny_cell

TRAFFIC = {"hypercube.train4": "train", "hypercube.render3": "render"}
CELLS = tuple(TRAFFIC)
COUNTERS = {"k4.resident_warps", "k4.sweep_waves"}


@pytest.mark.parametrize("name", CELLS)
def test_hypercube_cells_find_their_files(name):
    """Each cell resolves through harness/spec.py to the hypercube's file,
    its mix and calibrated limits, at the room's settings, and reports
    what the room's cell of its mix reports."""
    cell = spec.load_cell(name, ROOT)
    assert cell.config_name == "hypercube" and cell.config["scene"] == "hypercube"
    assert cell.chips == 1 and cell.traffic_name == TRAFFIC[name]
    assert cell.limits and all(v >= 0 for v in cell.limits.values())
    bench = spec.load_benchmark(ROOT)
    (conf,) = [c for c in bench["configs"] if c["name"] == "hypercube"]
    assert conf["reduced"] == [] and conf["file"] == "benchmark/configs/hypercube.json"
    room = spec.load_cell(name.replace("hypercube", "room"), ROOT)
    for key in ("samples", "reflections_amount", "windows", "camera", "train_view", "dtype",
                *ref.common.RENDER_KEYS):
        assert cell.config[key] == room.config[key], key
    assert {m["name"] for m in cell.per_layer} == {m["name"] for m in room.per_layer}
    assert COUNTERS <= {m["name"] for m in cell.per_layer} or TRAFFIC[name] == "render"
    assert [m["name"] for m in cell.end_to_end] == [m["name"] for m in room.end_to_end]


def test_copy_renders_the_port_s_image():
    ref.test_copy_renders_the_port_s_image("hypercube")


def test_copy_derives_the_port_s_hints_and_mask():
    ref.test_copy_derives_the_port_s_hints_and_mask("hypercube")


def test_frozen_slots_of_the_hypercube():
    """Under the frozen hints the mask zeroes the floor's normal and the
    hypercube's generator axes, which the hints fix on the coordinate
    axes; the 8 cells' own copies (point, normal, axes, r), the generators'
    point and r, and every material stay trainable."""
    from fourd_ray_tracing_tpu_torch import diff
    from fourd_ray_tracing_tpu_torch.models import params

    config = tiny_cell("hypercube.train4").config
    scene, camera, cfg = ref.port_side(config, ("yxz",))
    mask = params.freeze_mask(diff.with_frozen_hints(cfg, scene), scene)
    lay = params.layout(scene, camera)
    generators = lay.hypercube + 8 * 26  # after the 8 cells of 26 floats: point(4), axes(16), r
    want = [*range(lay.spaces + 4, lay.spaces + 8), *range(generators + 4, generators + 20)]
    assert [i for i, m in enumerate(mask.tolist()) if m == 0] == want


def test_copy_s_loss_and_gradient_match_the_port_s():
    ref.test_copy_s_loss_and_gradient_match_the_port_s("hypercube")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    faults.test_sound_run_is_correct(name)


@pytest.mark.parametrize("fault", ("unchanged", "half_batch", "altered"))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(monkeypatch, name, fault):
    (faults.render_faults if name.endswith("render3") else faults.train_faults)(monkeypatch,
                                                                                 fault)
    result, _ = faults.run(name)
    assert result["correct"] is False, result["check"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    faults.test_control_is_not_correct(name)
