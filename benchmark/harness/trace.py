"""The traced window: torch.profiler records the device's activity alone
(kernels, copies and sets, through CUPTI), so the host runs near its
untraced speed. The host spans are the harness's own, on the host clock
around its calls into the program, and are placed on the device's
timeline by an anchor: torch.cuda._sleep's kernel, launched on the idle
card just before the window (its start lies a launch's latency, some
microseconds, after the host's clock reading)."""
from __future__ import annotations

import bisect
import re
from collections import defaultdict

ANCHOR = "spin_kernel"  # torch.cuda._sleep's kernel
OUTSIDE = "loop"  # the host between the harness's spans


def profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    return profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])


def anchor(device):
    """On the card: the host clock's reading when the anchor kernel was
    launched on the idle card; None elsewhere."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    from benchmark.harness.common import now

    torch.cuda.synchronize(device)
    t = now()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize(device)
    return t


def _device_events(prof) -> list:
    """(name, start_s, end_s) of the device's work; a host range's copy
    on the device's timeline (a user annotation) is no work. Read from the
    profiler's raw events: building its per-event Python objects
    (``prof.events()``) takes seconds for every ten thousand kernels."""
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is None:
        return [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
                for e in prof.events()
                if str(e.device_type).endswith("CUDA")
                and not getattr(e, "is_user_annotation", False)]
    out = []
    for e in raw.events():
        if str(e.device_type()).endswith("CUDA") and not e.is_user_annotation():
            start = e.start_ns()
            out.append((e.name(), start * 1e-9, (start + e.duration_ns()) * 1e-9))
    return out


class Profile:
    """Device intervals and host spans of one traced window, in seconds
    from the window's start."""

    def __init__(self, device, spans, window):
        t0, t1 = window
        self.window_s = t1 - t0
        self.device = sorted((n, s - t0, e - t0) for n, s, e in device)
        self.spans = sorted(((n, s - t0, e - t0) for n, s, e in spans), key=lambda x: x[1])

    @classmethod
    def of(cls, prof, spans, window, anchor_t) -> "Profile":
        """From the profiler, the loop's host spans and window (host clock)
        and the anchor's launch time (None: no device, no shift)."""
        device, offset = _device_events(prof), 0.0
        if anchor_t is not None:
            marks = [d for d in device if ANCHOR in d[0]]
            if len(marks) != 1:
                raise RuntimeError(f"expected one {ANCHOR} in the trace, found {len(marks)}")
            offset = marks[0][1] - anchor_t
            device = [d for d in device if ANCHOR not in d[0]]
        return cls(device, [(n, s + offset, e + offset) for n, s, e in spans],
                   (window[0] + offset, window[1] + offset))

    def busy_intervals(self) -> list:
        """The union of the device's intervals inside the window, merged."""
        merged = []
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            s, e = max(s, 0.0), min(e, self.window_s)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.window_s

    def kernels(self, names) -> list:
        """Device intervals of the kernels named ``names`` (a kernel's
        name, a template's or a function's, as its symbol shows it)."""
        pattern = re.compile(r"(^|[\s:])(%s)[<(]" % "|".join(map(re.escape, names)))
        return [(n, s, e) for n, s, e in self.device if pattern.search(n)]

    def kernel_seconds(self, names) -> float:
        return sum(e - s for _, s, e in self.kernels(names))

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        total = defaultdict(float)
        for n, s, e in self.device:
            total[n[:200]] += e - s
        return [[n, t] for n, t in sorted(total.items(), key=lambda x: -x[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[host span, seconds]: the device's idle time inside the window,
        each gap under the span the host was in at the gap's start."""
        starts = [s for _, s, _ in self.spans]
        total = defaultdict(float)
        edge = 0.0
        for s, e in self.busy_intervals() + [[self.window_s, self.window_s]]:
            if s > edge:
                i = bisect.bisect_right(starts, edge) - 1
                name = OUTSIDE
                if i >= 0 and self.spans[i][2] >= edge:
                    name = self.spans[i][0]
                total[name] += s - edge
            edge = max(edge, e)
        return [[n, t] for n, t in sorted(total.items(), key=lambda x: -x[1])[:top]]
