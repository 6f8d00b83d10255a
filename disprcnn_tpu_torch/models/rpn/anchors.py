"""Anchor generation (host-side numpy; anchors are static given the feature
sizes). The FPN part of disprcnn_tpu/models/rpn/anchors.py, copied, with the
visibility mask that the RPN loss reads.

Reproduces the reference cell-anchor recipe (modeling/rpn/anchor_generator.py:
223-295): base window (0, 0, stride-1, stride-1), ratio enumeration with
rounding, scale enumeration, then grid shifts of `stride`. Per level the
anchor order is (H, W, A) with A fastest — matching the head's NHWC
(N, H, W, A*c) flatten order.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# RPN.STRADDLE_THRESH: the default 0 of every config (none sets it)
STRADDLE_THRESH = 0


def cell_anchors(stride: int, sizes: Sequence[float], ratios: Sequence[float]) -> np.ndarray:
    """(A, 4) anchors centred on the (0,0,stride-1,stride-1) window."""
    base = np.array([0, 0, stride - 1, stride - 1], np.float64)

    def whctr(a):
        w = a[2] - a[0] + 1
        h = a[3] - a[1] + 1
        return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)

    def mk(ws, hs, xc, yc):
        ws, hs = ws[:, None], hs[:, None]
        return np.hstack(
            [xc - 0.5 * (ws - 1), yc - 0.5 * (hs - 1), xc + 0.5 * (ws - 1), yc + 0.5 * (hs - 1)]
        )

    w, h, xc, yc = whctr(base)
    size = w * h
    ws = np.round(np.sqrt(size / np.asarray(ratios)))
    hs = np.round(ws * np.asarray(ratios))
    ratio_anchors = mk(ws, hs, xc, yc)
    out = []
    for ra in ratio_anchors:
        w, h, xc, yc = whctr(ra)
        scales = np.asarray(sizes, np.float64) / stride
        out.append(mk(w * scales, h * scales, xc, yc))
    return np.vstack(out).astype(np.float32)


def grid_anchors(
    feature_hw: Tuple[int, int], stride: int, cells: np.ndarray
) -> np.ndarray:
    """(H*W*A, 4) anchors for one level, (H, W, A) order."""
    h, w = feature_hw
    shift_x = np.arange(w, dtype=np.float32) * stride
    shift_y = np.arange(h, dtype=np.float32) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)  # (H, W)
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
    return (shifts + cells[None]).reshape(-1, 4)


class AnchorGenerator:
    """FPN anchor generator: one size per level (reference make_anchor_generator
    FPN branch: len(strides) == len(sizes), ratios shared), or with one
    stride every size at that one level (the C4/C5 single-map RPN)."""

    def __init__(
        self,
        sizes: Sequence[float] = (32, 64, 128, 256, 512),
        strides: Sequence[int] = (4, 8, 16, 32, 64),
        ratios: Sequence[float] = (0.5, 1.0, 2.0),
    ):
        if len(strides) == len(sizes):
            self.cells = [cell_anchors(st, (sz,), ratios) for st, sz in zip(strides, sizes)]
        elif len(strides) == 1:
            self.cells = [cell_anchors(strides[0], sizes, ratios)]
        else:
            raise ValueError(f"one anchor size per FPN level, got {sizes} for {strides}")
        self.strides = list(strides)

    @classmethod
    def from_cells(cls, cells: Sequence[np.ndarray], strides: Sequence[int]) -> "AnchorGenerator":
        """A generator of given cell anchors, one (A, 4) array a level."""
        gen = cls.__new__(cls)
        gen.cells, gen.strides = list(cells), list(strides)
        return gen

    @property
    def num_anchors_per_location(self) -> int:
        return self.cells[0].shape[0]

    def __call__(self, feature_hws: List[Tuple[int, int]]) -> np.ndarray:
        """-> anchors (N_total, 4), levels in order."""
        return np.concatenate([
            grid_anchors(fhw, st, c)
            for fhw, st, c in zip(feature_hws, self.strides, self.cells)
        ], axis=0)


def visibility(anchors, image_hw: Tuple[int, int]):
    """(N, 4) anchors (numpy or torch) -> (N,) bool: the anchors within
    STRADDLE_THRESH px of the image (anchor_generator.py add_visibility_to)."""
    h, w = image_hw
    t = STRADDLE_THRESH
    return ((anchors[:, 0] >= -t) & (anchors[:, 1] >= -t)
            & (anchors[:, 2] < w + t) & (anchors[:, 3] < h + t))
