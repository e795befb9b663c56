"""The program's own spans (fourd_ray_tracing_tpu_torch/utils/profiling.py)
in a traced window: the port records them while torch.profiler records,
on time.perf_counter, the clock ``common.now`` reads, so a span's offset
from the window's start, ``t - run.window_span[0]``, lies on the same
axis as ``run.profile``'s device intervals. A program without the
recorder records nothing: every function here then finds no span."""
from __future__ import annotations

import bisect
from collections import defaultdict


def _records() -> list:
    try:
        from fourd_ray_tracing_tpu_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "records", None)
    return read() if read is not None else []


class Steps:
    """The program's steps inside the run's window whose top-level span is
    named ``top`` (``engine.step``, ``train.step``), with every span of
    those steps."""

    def __init__(self, run, top: str, records=None):
        records = _records() if records is None else records
        t0, t1 = run.window_span
        ids = {r.step for r in records if r.parent == -1 and r.name == top
               and r.end is not None and t0 <= r.start and r.end <= t1}
        self.n = len(ids)
        self.spans = [(i, r) for i, r in enumerate(records) if r.step in ids]
        self._children = defaultdict(float)  # parent index: its children's summed time
        for _, r in self.spans:
            if r.parent >= 0:
                self._children[r.parent] += r.end - r.start

    def _per_step(self, total: float):
        return total / self.n if self.n else None

    def count(self, prefix: str):
        """Spans whose name starts with ``prefix``, per step."""
        return self._per_step(sum(r.name.startswith(prefix) for _, r in self.spans))

    def ms(self, names=(), prefix: str | None = None):
        """Summed time of the spans named in ``names`` (or starting with
        ``prefix``), per step, in ms."""
        return self._per_step(1e3 * sum(r.end - r.start for _, r in self.spans
                                        if r.name in names or (prefix and r.name.startswith(prefix))))

    def self_ms(self, names):
        """Summed self time (a span's time less its children's) of the
        spans named in ``names``, per step, in ms."""
        return self._per_step(1e3 * sum(r.end - r.start - self._children[i]
                                        for i, r in self.spans if r.name in names))


def idle_by_span(run, records=None) -> dict:
    """{span name: seconds} of the device's idle time in the window, each
    gap under the innermost program span the host was in at the gap's
    start (spans nest); gaps that begin outside every program span under
    None. Empty when the window recorded no program span."""
    records = _records() if records is None else records
    t0, t1 = run.window_span
    spans = sorted((r.start - t0, _depth(records, i), r.end - t0, r.name)
                   for i, r in enumerate(records)
                   if r.end is not None and t0 <= r.start and r.end <= t1)
    if not spans:
        return {}
    out = defaultdict(float)
    open_, k, edge = [], 0, 0.0  # open_: (end, name) of the spans around the sweep's time
    profile = run.profile
    for s, e in profile.busy_intervals() + [[profile.window_s, profile.window_s]]:
        if s > edge:
            while k < len(spans) and spans[k][0] <= edge:
                start, _, end, name = spans[k]
                while open_ and open_[-1][0] < start:
                    open_.pop()
                open_.append((end, name))
                k += 1
            while open_ and open_[-1][0] < edge:
                open_.pop()
            out[open_[-1][1] if open_ else None] += s - edge
        edge = max(edge, e)
    return dict(out)


def _depth(records, i: int) -> int:
    d = 0
    while records[i].parent >= 0:
        i, d = records[i].parent, d + 1
    return d


def idle_in_program_pct(run, records=None):
    """The share of the window's device idle time whose gap begins while
    the host is inside a program span, in percent; None when the window
    recorded no program span or the device never idled."""
    gaps = idle_by_span(run, records)
    idle = sum(gaps.values())
    if not gaps or idle <= 0:
        return None
    return 100.0 * (idle - gaps.get(None, 0.0)) / idle
