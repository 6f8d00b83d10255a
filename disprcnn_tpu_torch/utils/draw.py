"""Drawing on uint8 images in numpy, for tools/visualize.py: the card
machine has no OpenCV, so the line raster is the port's own.

``draw_line(img, p0, p1, color)`` sets the pixels that ``cv2.line(img,
p0, p1, color, 1)`` sets (thickness 1, LINE_8, shift 0): the endpoints are
first cut to the image by OpenCV's ``clipLine`` (its Cohen-Sutherland
steps in 64-bit integers and doubles, each intersection truncated toward
zero), then walked left to right by OpenCV's ``LineIterator``: Bresenham
with 8-connected steps, one pixel a column of the major axis, the minor
coordinate of pixel k being floor((2 dy k + dx - 1) / (2 dx)) minor steps
from the start (the iterator's error term, err < 0 taking the step,
counted in closed form). A segment that misses the image draws nothing.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def clip_line(w: int, h: int, p1: Tuple[int, int],
              p2: Tuple[int, int]) -> Optional[Tuple[Tuple[int, int], Tuple[int, int]]]:
    """OpenCV's clipLine of integer endpoints to [0, w - 1] x [0, h - 1]:
    -> the clipped (p1, p2), or None when the segment misses the image."""
    if w <= 0 or h <= 0:
        return None
    right, bottom = w - 1, h - 1
    (x1, y1), (x2, y2) = p1, p2
    code = lambda x, y: (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8
    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def line_pixels(p0: Sequence[int], p1: Sequence[int], h: int,
                w: int) -> Tuple[np.ndarray, np.ndarray]:
    """The (ys, xs) of cv2.line's pixels from p0 to p1 (integer x, y) on an
    h x w image."""
    p0 = (int(p0[0]), int(p0[1]))
    p1 = (int(p1[0]), int(p1[1]))
    inside = lambda p: 0 <= p[0] < w and 0 <= p[1] < h
    if not (inside(p0) and inside(p1)):
        clipped = clip_line(w, h, p0, p1)
        if clipped is None:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        p0, p1 = clipped
    if p1[0] < p0[0]:  # left to right
        p0, p1 = p1, p0
    dx, dy = p1[0] - p0[0], p1[1] - p0[1]
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    k = np.arange(major + 1, dtype=np.int64)
    m = (2 * minor * k + major - 1) // (2 * major) if major else np.zeros_like(k)
    if vert:
        return p0[1] + sy * k, p0[0] + m
    return p0[1] + sy * m, p0[0] + k


def draw_line(img: np.ndarray, p0: Sequence[float], p1: Sequence[float], color) -> None:
    """cv2.line(img, (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1])),
    color, 1) on an (H, W, C) or (H, W) uint8 image, in place."""
    ys, xs = line_pixels((int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1])), *img.shape[:2])
    img[ys, xs] = np.asarray(color, dtype=img.dtype)
