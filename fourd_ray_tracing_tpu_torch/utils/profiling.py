"""Profiling: rays/s counters, the program's host spans and its counter readings.

Counterpart of fourd_ray_tracing_tpu/utils/profiling.py: ``FrameStats``
(frames, seconds, rays and the rates over them) and ``Meter`` (a
wall-clock meter of render steps that waits for the device before it
reads the clock).

The span recorder: ``span(name)`` wraps a piece of the program's host
work, ``sync(site, device)`` a host-device copy that blocks the host
until the device's stream drains (``span("sync.<site>")``, on a CUDA
device only). They record while a torch.profiler session records (the
autograd profiler's enabled flag), so any profiler an operator or a
benchmark opens sees the program's spans, and nothing otherwise: off,
each returns one shared no-op context after that single check, reads no
clock and allocates nothing. A record holds the span's name, its start
and end on ``time.perf_counter`` (the clock a benchmark times its window
with), the index in ``records()`` of its parent span (-1 for a top-level
span) and its step: the sequence number of its top-level span, which its
descendants share. Records stay in memory, at most ``CAP`` of them;
``dropped()`` counts the spans past the cap (and their children), and
``clear()`` empties both. Spans nest per thread.

The counter recorder: ``count(name, value)`` records a number the
program knows at that point (a launch's occupancy, say), gated as a span
is: the name, the value, the clock's reading and the step of the span
that encloses it (-1 outside every span). ``counters()`` reads them
(``Counter``); ``clear()`` empties them too, and they share ``CAP`` and
``dropped()`` with the spans.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


@dataclass
class FrameStats:
    frames: int = 0
    seconds: float = 0.0
    rays: int = 0

    @property
    def fps(self) -> float:
        return self.frames / self.seconds if self.seconds else 0.0

    @property
    def rays_per_s(self) -> float:
        return self.rays / self.seconds if self.seconds else 0.0

    def as_json(self) -> str:
        return json.dumps(
            {
                "frames": self.frames,
                "seconds": round(self.seconds, 6),
                "fps": round(self.fps, 3),
                "rays_per_s": round(self.rays_per_s, 1),
            }
        )


def _cuda_devices(result) -> set:
    """The CUDA devices of the tensors in ``result`` (a tensor or a
    nested tuple, list or dict of them)."""
    if isinstance(result, torch.Tensor):
        return {result.device} if result.device.type == "cuda" else set()
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (tuple, list)):
        return set().union(*(_cuda_devices(r) for r in result)) if result else set()
    return set()


class Meter:
    """Wall-clock meter for render steps; call inside a `measure` block.

    Waits for the devices of the block's result (``holder["result"]``)
    with ``torch.cuda.synchronize`` before it reads the clock, so timings
    are device time, not enqueue time; a result on the CPU is ready when
    the block ends.
    """

    def __init__(self):
        self.stats = FrameStats()

    @contextlib.contextmanager
    def measure(self, rays: int, frames: int = 1):
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            for device in _cuda_devices(holder.get("result")):
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            self.stats.frames += frames
            self.stats.seconds += dt
            self.stats.rays += rays


CAP = 1_000_000


class Record(NamedTuple):
    """One span: ``name``, ``start`` and ``end`` (time.perf_counter
    seconds; ``end`` None while it is open), ``parent`` (its parent's
    index in ``records()``, -1 at the top) and ``step`` (its top-level
    span's sequence number)."""

    name: str
    start: float
    end: Optional[float]
    parent: int
    step: int


class Counter(NamedTuple):
    """One counter reading: ``name``, ``t`` (time.perf_counter seconds),
    ``value`` and ``step`` (the enclosing span's step; -1 outside every
    span)."""

    name: str
    t: float
    value: float
    step: int


# [name, start, end, parent, step] of every span, in the order opened: a
# list, so that a span's end is one item set, and records() reads them.
_records: list = []
_counters: list = []  # Counter of every reading, in the order recorded
_dropped = 0
_steps = 0
_open = threading.local()  # .stack: the indices of the thread's open spans (None: dropped)
_OFF = contextlib.nullcontext()


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


class _Span:
    __slots__ = ("name", "index", "stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _dropped, _steps
        self.stack = stack = _stack()
        parent = stack[-1] if stack else -1
        index = None
        if parent is None or len(_records) >= CAP:
            _dropped += 1
        else:
            if parent == -1:
                step = _steps
                _steps += 1
            else:
                step = _records[parent][4]
            index = len(_records)
            _records.append([self.name, time.perf_counter(), None, parent, step])
        self.index = index
        stack.append(index)

    def __exit__(self, *exc):
        end = time.perf_counter()
        self.stack.pop()
        if self.index is not None:
            _records[self.index][2] = end


def span(name: str):
    """A context manager that records the block as the span ``name`` while
    a profiler records; the shared no-op context otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def sync(site: str, device):
    """``span("sync." + site)`` around a copy between the host and
    ``device`` that blocks the host until the device's stream drains (a
    copy from pageable host memory, a read-back); the no-op context when
    ``device`` is not a CUDA device."""
    if not _autograd_profiler._is_profiler_enabled or torch.device(device).type != "cuda":
        return _OFF
    return _Span("sync." + site)


def count(name: str, value: float) -> None:
    """Record ``value`` as the counter ``name`` while a profiler records;
    nothing otherwise."""
    global _dropped
    if not _autograd_profiler._is_profiler_enabled:
        return
    if len(_counters) >= CAP:
        _dropped += 1
        return
    stack = _stack()
    step = _records[stack[-1]][4] if stack and stack[-1] is not None else -1
    _counters.append(Counter(name, time.perf_counter(), float(value), step))


def counters() -> list:
    """The recorded counter readings (``Counter``), in the order recorded."""
    return list(_counters)


def records() -> list:
    """The recorded spans (``Record``), in the order they were opened."""
    return [Record(*r) for r in _records]


def dropped() -> int:
    """Spans and counter readings not recorded because ``CAP`` of them
    were held."""
    return _dropped


def clear() -> None:
    """Forget every record, counter reading and the dropped count; call it
    with no span open."""
    global _dropped, _steps
    _records.clear()
    _counters.clear()
    _dropped = _steps = 0
    _stack().clear()
