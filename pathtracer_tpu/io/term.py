"""Terminal live viewer — the blit-loop role, headless.

The reference blits the in-progress framebuffer to a Win32 window every
frame (win32_main.cpp:252-274, StretchDIBits). A device render has no window;
the cheap equivalent is drawing the progressive image into the terminal
with half-block glyphs: each character cell shows TWO image rows — the
upper half as the foreground color of U+2580 (upper half block), the lower
half as the background — using 24-bit ANSI color. Repaints rewrite in
place with cursor-up, so the image animates as samples accumulate.
"""

from __future__ import annotations

import os
import sys

import numpy as np

_RESET = "\x1b[0m"


def supports_color(stream=None) -> bool:
    stream = stream or sys.stdout
    if os.environ.get("NO_COLOR"):
        return False
    return hasattr(stream, "isatty") and stream.isatty()


def _downscale(rgb: np.ndarray, max_w: int, max_h: int) -> np.ndarray:
    """Box-ish downscale by integer striding with mean pooling; cheap and
    dependency-free (PIL not required on the hot path)."""
    h, w = rgb.shape[:2]
    fx = max(1, -(-w // max_w))   # ceil div
    fy = max(1, -(-h // max_h))
    f = max(fx, fy)
    if f == 1:
        return rgb
    th, tw = h // f * f, w // f * f
    pooled = rgb[:th, :tw].reshape(th // f, f, tw // f, f, 3)
    return pooled.mean(axis=(1, 3)).astype(rgb.dtype)


def frame_to_text(rgb: np.ndarray, max_cols: int = 100,
                  max_rows: int = 50) -> str:
    """(H, W, 3) uint8, row 0 = top -> ANSI half-block string."""
    img = _downscale(np.asarray(rgb, np.uint8), max_cols, max_rows * 2)
    h = img.shape[0] // 2 * 2
    img = img[:h]
    lines = []
    for y in range(0, h, 2):
        top, bot = img[y], img[y + 1]
        cells = [
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
            for t, b in zip(top, bot)
        ]
        lines.append("".join(cells) + _RESET)
    return "\n".join(lines)


class LiveView:
    """Rewrite-in-place progressive display. Call update() per chunk."""

    def __init__(self, stream=None, max_cols: int = 100, max_rows: int = 45):
        self.stream = stream or sys.stdout
        self.max_cols = max_cols
        self.max_rows = max_rows
        self._drawn_lines = 0
        try:
            cols, rows = os.get_terminal_size(self.stream.fileno())
            self.max_cols = min(self.max_cols, cols)
            self.max_rows = min(self.max_rows, max(4, rows - 4))
        except (OSError, ValueError):
            pass

    def update(self, rgb: np.ndarray, status: str = "") -> None:
        text = frame_to_text(rgb, self.max_cols, self.max_rows)
        n_lines = text.count("\n") + 1 + (1 if status else 0)
        out = self.stream
        if self._drawn_lines:
            out.write(f"\x1b[{self._drawn_lines}F")  # cursor to frame start
        out.write(text + ("\n" + status + "\x1b[K" if status else "") + "\n")
        out.flush()
        self._drawn_lines = n_lines
