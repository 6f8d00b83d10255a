"""Instance masks cropped to ROIs (counterpart of the ROI-crop part of
disprcnn_tpu/structures/masks.py; reference mask_head/loss.py
project_masks_on_boxes).

``crop_and_resize_mask`` samples each ROI's full-image GT mask bilinearly
on an out_size x out_size grid of the box, with the JAX package's border
rule: coordinates clipped to [0, size - 1], the lower tap to size - 2. The
JAX function takes one (H, W) mask and one box; here a batch of R boxes
reads its masks out of an (N, H, W) stack by index, gathering only the
four taps of each sample (no per-ROI copy of a full mask).
"""
from __future__ import annotations

import torch


def _axis_taps(coords: torch.Tensor, size: int):
    """Clipped coordinates -> (lower tap, upper tap, fraction)."""
    c = coords.clamp(0.0, size - 1.0)
    lo = torch.floor(c).long().clamp(0, size - 2) if size > 1 else torch.zeros_like(c).long()
    return lo, (lo + 1).clamp_max(size - 1), c - lo.to(c.dtype)


def _sample_bilinear_2d(imgs: torch.Tensor, which: torch.Tensor, ys: torch.Tensor,
                        xs: torch.Tensor) -> torch.Tensor:
    """imgs (N, H, W); which (R,) image indices; ys, xs (R, ...) float
    coordinates -> (R, ...) samples of imgs[which] at (ys, xs)."""
    n, h, w = imgs.shape
    flat = imgs.reshape(-1)
    base = (which.long() * (h * w)).reshape(-1, *(1,) * (ys.dim() - 1))
    y0, y1, ly = _axis_taps(ys, h)
    x0, x1, lx = _axis_taps(xs, w)
    at = lambda yi, xi: flat[base + yi * w + xi]
    return (at(y0, x0) * (1 - ly) * (1 - lx) + at(y0, x1) * (1 - ly) * lx
            + at(y1, x0) * ly * (1 - lx) + at(y1, x1) * ly * lx)


def crop_and_resize_mask(masks: torch.Tensor, which: torch.Tensor, boxes: torch.Tensor,
                         out_size: int) -> torch.Tensor:
    """masks (N, H, W) float or bool; which (R,) the mask of each box;
    boxes (R, 4) xyxy -> (R, out_size, out_size) float32 samples."""
    g = (torch.arange(out_size, dtype=torch.float32, device=boxes.device) + 0.5) / out_size
    x1, y1, x2, y2 = (boxes[:, i, None, None] for i in range(4))
    yy = y1 + g[None, :, None] * (y2 - y1) - 0.5
    xx = x1 + g[None, None, :] * (x2 - x1) - 0.5
    yy, xx = torch.broadcast_tensors(yy, xx)
    return _sample_bilinear_2d(masks.float(), which, yy, xx)
