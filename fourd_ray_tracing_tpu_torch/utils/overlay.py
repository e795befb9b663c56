"""FPS text overlay burned into the rendered frame.

Counterpart of the JAX package's utils/overlay.py, the same bytes out: the
reference draws "FPS: xx.x" on the main window with a font (white fill,
black outline, text.size, at (15, 10)); a headless PNG has no font stack,
so ``draw_fps`` rasterizes the string with a built-in 3x5 bitmap font,
white glyphs with a 1px black outline, scaled by round(text.size / 12),
at (2, 2) of the cell-resolution image. Numpy only.
"""
from __future__ import annotations

import numpy as np

# 3x5 glyphs, rows top->down, 1 = lit.
_GLYPHS = {
    "0": ["111", "101", "101", "101", "111"],
    "1": ["010", "110", "010", "010", "111"],
    "2": ["111", "001", "111", "100", "111"],
    "3": ["111", "001", "111", "001", "111"],
    "4": ["101", "101", "111", "001", "001"],
    "5": ["111", "100", "111", "001", "111"],
    "6": ["111", "100", "111", "101", "111"],
    "7": ["111", "001", "010", "010", "010"],
    "8": ["111", "101", "111", "101", "111"],
    "9": ["111", "101", "111", "001", "111"],
    ".": ["000", "000", "000", "000", "010"],
    ":": ["000", "010", "000", "010", "000"],
    " ": ["000", "000", "000", "000", "000"],
    "F": ["111", "100", "111", "100", "100"],
    "P": ["111", "101", "111", "100", "100"],
    "S": ["111", "100", "111", "001", "111"],
}


def _raster(text: str, scale: int) -> np.ndarray:
    """(H, W) float mask of the string at integer ``scale``."""
    rows = 5
    cols = sum(4 for _ in text)  # 3px glyph + 1px spacing
    mask = np.zeros((rows, cols), np.float32)
    x = 0
    for ch in text:
        g = _GLYPHS.get(ch, _GLYPHS[" "])
        for r in range(5):
            for c in range(3):
                if g[r][c] == "1":
                    mask[r, x + c] = 1.0
        x += 4
    if scale > 1:
        mask = np.repeat(np.repeat(mask, scale, axis=0), scale, axis=1)
    return mask


def draw_fps(img: np.ndarray, fps: float, text_size: int = 24,
             outline: bool = True) -> np.ndarray:
    """Return a copy of (H, W, 3) float image with "FPS: xx.x" burned in
    near the top-left (the reference's (15, 10) anchor maps to (2, 2) at
    cell resolution)."""
    img = np.array(img, np.float32, copy=True)
    scale = max(1, round(text_size / 12))
    mask = _raster(f"FPS: {fps:.1f}", scale)
    h, w = mask.shape
    y0, x0 = 2, 2
    h = min(h, img.shape[0] - y0)
    w = min(w, img.shape[1] - x0)
    if h <= 0 or w <= 0:
        return img
    m = mask[:h, :w]
    region = img[y0:y0 + h, x0:x0 + w]
    if outline:
        # 1px black outline: dilate the mask and darken where dilated.
        pad = np.pad(m, 1)
        dil = np.maximum.reduce([
            pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            for dy in (-1, 0, 1) for dx in (-1, 0, 1)
        ])
        region = region * (1.0 - dil[..., None])
    img[y0:y0 + h, x0:x0 + w] = region * (1.0 - m[..., None]) + m[..., None]
    return img
