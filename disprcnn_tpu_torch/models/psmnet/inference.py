"""iDispNet's postprocessing: ROI disparities back into a full-image map
(counterpart of disprcnn_tpu/models/psmnet/inference.py; reference
modeling/psmnet/inference.py DisparityMapProcessor).

Each ROI's S x S disparity is resized to its integer-expanded box (the
values rescaled by max(w, w') / S and shifted by x1 - x1'), kept where its
instance mask, resized to the float box, is above the threshold, and the
instances are combined by their maximum; pixels that no instance covers
are 0. One batched op over (R, H, W): every ROI's inverse sampling of the
whole image, as the JAX package's vmap, with no per-ROI loop.
"""
from __future__ import annotations

import torch

from ...structures.masks import _sample_bilinear_2d
from ..pointrcnn.lift import expand_box_to_integer


def rois_to_fullimage_disparity(disp_roi: torch.Tensor, masks: torch.Tensor,
                                left_boxes: torch.Tensor, right_boxes: torch.Tensor,
                                valid: torch.Tensor, im_h: int, im_w: int,
                                mask_thresh: float = 0.5) -> torch.Tensor:
    """disp_roi (R, S, S), masks (R, M, M) probabilities, left_boxes and
    right_boxes (R, 4), valid (R,) -> (im_h, im_w) disparity."""
    r, s = disp_roi.shape[0], disp_roi.shape[-1]
    m = masks.shape[-1]
    dev = disp_roi.device
    yy = torch.arange(im_h, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(im_w, dtype=torch.float32, device=dev)[None, None, :]
    col = lambda t: t[:, None, None]
    li, ri = expand_box_to_integer(left_boxes), expand_box_to_integer(right_boxes)
    w, h = li[:, 2] - li[:, 0], li[:, 3] - li[:, 1]
    wmax = torch.maximum(w, ri[:, 2] - ri[:, 0])
    rows = torch.arange(r, device=dev)
    sy, sx = torch.broadcast_tensors((yy - col(li[:, 1])) / col(h.clamp_min(1.0)) * s - 0.5,
                                     (xx - col(li[:, 0])) / col(wmax.clamp_min(1.0)) * s - 0.5)
    vals = (_sample_bilinear_2d(disp_roi, rows, sy, sx) * col(wmax / s)
            + col(li[:, 0] - ri[:, 0]))
    lb = left_boxes
    my, mx = torch.broadcast_tensors(
        (yy - col(lb[:, 1])) / col((lb[:, 3] - lb[:, 1]).clamp_min(1.0)) * m - 0.5,
        (xx - col(lb[:, 0])) / col((lb[:, 2] - lb[:, 0]).clamp_min(1.0)) * m - 0.5)
    keep = _sample_bilinear_2d(masks.float(), rows, my, mx) > mask_thresh
    inside = ((yy >= col(li[:, 1])) & (yy < col(li[:, 3])) & (xx >= col(li[:, 0]))
              & (xx < col(li[:, 2])))
    per = torch.where(inside & keep & col(valid.bool()), vals,
                      torch.full_like(vals, -float("inf")))
    out = per.amax(dim=0) if r else torch.full((im_h, im_w), -float("inf"), device=dev)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
