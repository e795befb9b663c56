"""The host's side of a window, for the spread of host-paced cells: the
process's CPU time and context switches, the garbage collector's pauses,
and the machine's CPU time stolen by its hypervisor (from /proc/stat,
where there is one), over the window. Reported beside the metrics, never
as one."""
from __future__ import annotations

import gc
import os
import resource
import time


def _cpu_stat():
    """(steal, total) jiffies of all CPUs, or None."""
    try:
        with open("/proc/stat") as f:
            fields = [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        return None
    return (fields[7] if len(fields) > 7 else 0), sum(fields[:8])


class HostWatch:
    def __enter__(self) -> "HostWatch":
        self.gc_s, self.gc_runs, self._gc_t = 0.0, [0, 0, 0], None
        gc.callbacks.append(self._on_gc)
        self._usage = resource.getrusage(resource.RUSAGE_SELF)
        self._cpu, self._wall, self._stat = time.process_time(), time.perf_counter(), _cpu_stat()
        return self

    def _on_gc(self, phase, info) -> None:
        if phase == "start":
            self._gc_t = time.perf_counter()
        elif self._gc_t is not None:
            self.gc_s += time.perf_counter() - self._gc_t
            self.gc_runs[info["generation"]] += 1
            self._gc_t = None

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._on_gc)
        usage, stat = resource.getrusage(resource.RUSAGE_SELF), _cpu_stat()
        self.summary = {
            "wall_s": time.perf_counter() - self._wall,
            "cpu_s": time.process_time() - self._cpu,
            "gc_s": self.gc_s,
            "gc_runs": list(self.gc_runs),
            "ctx_voluntary": usage.ru_nvcsw - self._usage.ru_nvcsw,
            "ctx_involuntary": usage.ru_nivcsw - self._usage.ru_nivcsw,
            "steal_share": (None if stat is None or self._stat is None
                            or stat[1] == self._stat[1]
                            else (stat[0] - self._stat[0]) / (stat[1] - self._stat[1])),
            "loadavg_1m": os.getloadavg()[0],
        }
