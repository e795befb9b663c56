"""The program's counter readings (fourd_ray_tracing_tpu_torch/utils/
profiling.py ``count``) in a traced window: the port records them while
torch.profiler records, stamped on time.perf_counter, the clock
``common.now`` reads, so a reading lies in the run's window when its
``t`` lies in ``run.window_span``. A program without the counter recorder
records none: every function here then finds nothing."""
from __future__ import annotations


def _counters() -> list:
    try:
        from fourd_ray_tracing_tpu_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "counters", None)
    return read() if read is not None else []


def in_window(run, name: str, counters=None) -> list:
    """The values of the counter ``name`` read inside the run's window."""
    counters = _counters() if counters is None else counters
    t0, t1 = run.window_span
    return [c.value for c in counters if c.name == name and t0 <= c.t <= t1]


def mean(run, name: str, counters=None):
    """The mean of the counter ``name`` over the window; None when the
    window holds no reading of it."""
    values = in_window(run, name, counters)
    return sum(values) / len(values) if values else None
