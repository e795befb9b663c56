"""Counter-based per-pixel PRNG, bitwise equal to ops/rng.py of the JAX package.

Every random number is ``hash(pixel_bits ^ counter ^ seed)``; the counter
advances by CALL_DELTA per draw, and only on lanes that draw. Torch has
no uint32 shifts or adds on the CPU and its int32 ``>>`` is arithmetic,
so here a uint32 word is held in an int64 tensor with values in
[0, 2^32): shifts of a non-negative int64 are logical, and every add or
left shift is masked back to 32 bits. The CUDA kernel uses ``uint32_t``.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
CALL_DELTA = 0x79A010A9
_MANTISSA = 0x007FFFFF
_ONE_BITS = 0x3F800000


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """The 6-round shift/xor/add mixer on uint32 words held in int64."""
    x = (x + (x << 10)) & MASK32
    x = x ^ (x >> 6)
    x = (x + (x << 3)) & MASK32
    x = x ^ (x >> 11)
    x = (x + (x << 15)) & MASK32
    return x ^ (x >> 9)


def float_bits(f: torch.Tensor) -> torch.Tensor:
    """IEEE-754 bit pattern of a float32 tensor, as uint32 in int64."""
    return f.contiguous().view(torch.int32).to(torch.int64) & MASK32


def bits_to_float(bits: torch.Tensor) -> torch.Tensor:
    """Reinterpret uint32 words (held in int64, < 2^31 here) as float32."""
    return bits.to(torch.int32).view(torch.float32)


def pixel_stream_bits(scr_x: torch.Tensor, scr_y: torch.Tensor) -> torch.Tensor:
    """``bits(x) ^ (bits(y) << 9)`` of the normalized pixel center."""
    return float_bits(scr_x) ^ ((float_bits(scr_y) << 9) & MASK32)


def random_uint(pixel_bits, seed, counter):
    """One draw of raw bits; returns (bits, advanced_counter)."""
    counter = (counter + CALL_DELTA) & MASK32
    return hash_u32(pixel_bits ^ counter ^ seed), counter


def uniform01(pixel_bits, seed, counter):
    """One uniform float32 in [0, 1): 23 random mantissa bits under the
    exponent of 1.0, minus 1. Returns (value, advanced_counter)."""
    bits, counter = random_uint(pixel_bits, seed, counter)
    value = bits_to_float((bits & _MANTISSA) | _ONE_BITS) - 1.0
    return value, counter


def init_counter(seed: int, like: torch.Tensor) -> torch.Tensor:
    """Fresh per-lane counters for a frame: every lane starts at the seed."""
    return torch.full_like(like, seed & MASK32, dtype=torch.int64)


def masked_uniform01(pixel_bits, seed, counter, active):
    """uniform01 that advances only the counters of ``active`` lanes."""
    value, new_counter = uniform01(pixel_bits, seed, counter)
    return value, torch.where(active, new_counter, counter)
