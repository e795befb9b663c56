"""The yardstick's peaks and the roofline arithmetic.

The peaks are NVIDIA's published figures for one H100 SXM (dense, no
sparsity, at its 700 W limit): 67 TFLOP/s in float32 outside the tensor
cores and 3.35 TB/s of HBM. A run records the card's power limit beside
its numbers; a card set below 700 W reads lower shares."""
from __future__ import annotations

PEAKS = {"fp32_flops_per_s": 67e12, "bytes_per_s": 3.35e12}


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the flops over
    the fp32 peak and the bytes over the memory rate."""
    return max(flops / PEAKS["fp32_flops_per_s"], nbytes / PEAKS["bytes_per_s"])


def share_pct(flops: float, nbytes: float, seconds: float) -> float:
    """The bound's share of ``seconds`` of device time, in percent."""
    return 100.0 * bound_s(flops, nbytes) / seconds


def peak_share_pct(flops: float, seconds: float) -> float:
    """``flops`` in ``seconds`` as a share of the fp32 peak, in percent."""
    return 100.0 * flops / (seconds * PEAKS["fp32_flops_per_s"])
