"""Minimal PNG writer (no external imaging deps).

Counterpart of fourd_ray_tracing_tpu/utils/image.py, byte for byte the
same files; the port carries its own copy so that it runs without the
JAX package. Plain zlib-deflated 8-bit RGB PNG.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[0,1] float image -> uint8, clipping."""
    return (np.clip(np.asarray(img, np.float32), 0.0, 1.0) * 255.0 + 0.5).astype(
        np.uint8
    )


def encode_png(img: np.ndarray, compress_level: int = 6) -> bytes:
    """Encode an (H, W, 3) float [0,1] or uint8 array as PNG bytes."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    h, w, c = arr.shape
    assert c == 3, f"expected RGB, got {arr.shape}"

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(
            ">I", zlib.crc32(body)
        )

    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))
    return b"".join(
        [
            b"\x89PNG\r\n\x1a\n",
            chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
            chunk(b"IDAT", zlib.compress(raw, compress_level)),
            chunk(b"IEND", b""),
        ]
    )


def write_png(path: str | Path, img: np.ndarray) -> None:
    """Write an (H, W, 3) float [0,1] or uint8 array as a PNG file."""
    Path(path).write_bytes(encode_png(img))
