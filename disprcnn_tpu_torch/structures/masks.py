"""Instance masks: ROI crops and the paste into the image (counterpart of
disprcnn_tpu/structures/masks.py; reference mask_head/loss.py
project_masks_on_boxes and roi_heads/mask_head/inference.py:108-201).

``crop_and_resize_mask`` samples each ROI's full-image GT mask bilinearly
on an out_size x out_size grid of the box, with the JAX package's border
rule: coordinates clipped to [0, size - 1], the lower tap to size - 2. The
JAX function takes one (H, W) mask and one box; here a batch of R boxes
reads its masks out of an (N, H, W) stack by index, gathering only the
four taps of each sample (no per-ROI copy of a full mask).

``paste_masks_in_image`` is the reference Masker's paste in the JAX
package's inverted form: each M x M mask is padded by one pixel, its box
expanded by (M + 2) / M about its centre and cut to whole pixels, and every
image pixel inside that box samples the padded mask at its source
coordinate (the inverse of an align_corners=False resize) and keeps it
where the sample exceeds the threshold. One batched op over (N, H, W).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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


def paste_masks_in_image(masks: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                         im_h: int, im_w: int, thresh: float = 0.5,
                         padding: int = 1) -> torch.Tensor:
    """masks (N, M, M) probabilities, boxes (N, 4) xyxy, valid (N,) ->
    (N, im_h, im_w) bool; invalid rows come back empty."""
    n, m = masks.shape[0], masks.shape[-1]
    padded = F.pad(masks.float(), (padding,) * 4)
    size = m + 2 * padding
    scale = size / m
    cx, cy = (boxes[:, 0] + boxes[:, 2]) * 0.5, (boxes[:, 1] + boxes[:, 3]) * 0.5
    hw, hh = (boxes[:, 2] - boxes[:, 0]) * 0.5 * scale, (boxes[:, 3] - boxes[:, 1]) * 0.5 * scale
    x0, y0 = torch.floor(cx - hw).int(), torch.floor(cy - hh).int()
    x1, y1 = torch.floor(cx + hw).int(), torch.floor(cy + hh).int()
    bw, bh = (x1 - x0 + 1).clamp_min(1), (y1 - y0 + 1).clamp_min(1)
    dev = masks.device
    yy = torch.arange(im_h, dtype=torch.int32, device=dev)[None, :, None]
    xx = torch.arange(im_w, dtype=torch.int32, device=dev)[None, None, :]
    col = lambda t: t[:, None, None]
    src_y = (yy - col(y0) + 0.5) * (size / col(bh)) - 0.5
    src_x = (xx - col(x0) + 0.5) * (size / col(bw)) - 0.5
    src_y, src_x = torch.broadcast_tensors(src_y, src_x)
    vals = _sample_bilinear_2d(padded, torch.arange(n, device=dev), src_y, src_x)
    inside = (yy >= col(y0)) & (yy <= col(y1)) & (xx >= col(x0)) & (xx <= col(x1))
    return inside & (vals > thresh) & col(valid.bool())


def paste_mask_in_image(mask: torch.Tensor, box: torch.Tensor, im_h: int, im_w: int,
                        thresh: float = 0.5, padding: int = 1) -> torch.Tensor:
    """One (M, M) mask and its (4,) box -> (im_h, im_w) bool."""
    return paste_masks_in_image(mask[None], box[None], torch.ones(1, dtype=torch.bool,
                                                                  device=mask.device),
                                im_h, im_w, thresh, padding)[0]
