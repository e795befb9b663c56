"""Live-lane flop counts (the port's chip_smoke.lane_calls / live_of /
live_lane_flops, over this copy): the work that a kernel which stops a
lane once its ray leaves the scene needs, where the plain version
computes every lane to the last bounce."""
from __future__ import annotations

from benchmark.reference.models import renderer
from benchmark.reference.utils.flops import FlopCounter


def lane_calls(scene, camera, cfg, seeds, rows, counter=None) -> tuple:
    """(light, calls, flops) of the plain pipeline on ``rows``: its light;
    each shade and scatter call in order as (lanes alive, lanes), the
    first a device count; and, with a FlopCounter running as ``counter``,
    the flops each of those calls stands for (a shade its own; a scatter
    its own with the updates since the shade before it), else None."""
    calls, flops, mark = [], [], [None]
    real = renderer.trace_rays, renderer._shade, renderer._scatter

    def now() -> float:
        return 0.0 if counter is None else counter.flops

    def trace_rays(*args, **kwargs):
        mark[0] = None
        return real[0](*args, **kwargs)

    def shade(scene_, o, d, result, throughput, alive, cfg_):
        before = now()
        out = real[1](scene_, o, d, result, throughput, alive, cfg_)
        calls.append((alive.sum(), alive.numel()))
        flops.append(now() - before)
        mark[0] = now()
        return out

    def scatter(d, norm, mirrored, alive, *rest):
        before = now()
        out = real[2](d, norm, mirrored, alive, *rest)
        calls.append((alive.sum(), alive.numel()))
        flops.append(now() - (before if mark[0] is None else mark[0]))
        mark[0] = None
        return out

    renderer.trace_rays, renderer._shade, renderer._scatter = trace_rays, shade, scatter
    try:
        light = renderer.render_light(scene, camera, cfg, seeds, rows)
    finally:
        renderer.trace_rays, renderer._shade, renderer._scatter = real
    return light, calls, (flops if counter is not None else None)


def live_of(dense: float, calls, flops) -> float:
    """The flops of a run of ``dense`` flops that the live lanes need:
    each call's flops count for the share of its lanes alive."""
    return dense - sum((1.0 - int(alive) / lanes) * f for (alive, lanes), f in zip(calls, flops))


def live_share(scene, camera, cfg, seeds, band_rows: int, count_rows: int) -> tuple:
    """(dense flops of ``count_rows`` rows, live share of the whole image):
    the flops counted on the first ``count_rows`` rows, and the share of
    that dense work which the live lanes of every band of the image need,
    each band weighted by its rows."""
    with FlopCounter() as counter:
        _, _, flops = lane_calls(scene, camera, cfg, seeds, slice(0, count_rows), counter)
    dense = counter.flops
    total = weight = 0.0
    for r in range(0, cfg.height, band_rows):
        n = min(band_rows, cfg.height - r)
        _, calls, _ = lane_calls(scene, camera, cfg, seeds, slice(r, r + n))
        total += live_of(dense, calls, flops) / dense * n
        weight += n
    return dense, total / weight
