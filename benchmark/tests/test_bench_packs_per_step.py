"""The reader of ``engine.packs_per_step`` (benchmark/metrics) on a
synthetic window, as test_bench_program_spans.py holds the other readers:
two ``k1.pack`` spans under each ``engine.step`` read 2.0, none read 0.0,
and a window without program spans reads None."""
import pytest

from benchmark.harness import spec
from benchmark.tests.test_bench_program_spans import fake_run, records

NAME = "engine.packs_per_step"
# A step of two view groups, each packing its params before its launch, and
# the same step with the launch inputs kept.
PACKING = [("engine.step", 0.00, 0.10, None), ("engine.seeds", 0.00, 0.01, 0),
           ("engine.camera", 0.01, 0.02, 0), ("k1.pack", 0.02, 0.03, 0),
           ("k1.upload", 0.03, 0.04, 0), ("k1.launch", 0.04, 0.05, 0),
           ("engine.camera", 0.05, 0.06, 0), ("k1.pack", 0.06, 0.07, 0),
           ("k1.upload", 0.07, 0.08, 0), ("k1.launch", 0.08, 0.09, 0)]
KEPT = [span for span in PACKING if span[0] != "k1.pack"]


def read(recs, monkeypatch):
    from fourd_ray_tracing_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    return spec.load_reader(NAME)(fake_run([(0.0, 1.0)]))


@pytest.mark.parametrize("step, packs", [(PACKING, 2.0), (KEPT, 0.0)])
def test_packs_per_step_counts_k1_pack_spans(step, packs, monkeypatch):
    # Steps at 0 and 0.5 s, and one before the window, which is left out.
    assert read(records(step, (-0.5, 0.0, 0.5)), monkeypatch) == packs


def test_packs_per_step_without_program_spans_is_none(monkeypatch):
    assert read([], monkeypatch) is None
