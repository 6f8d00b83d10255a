"""The pseudo-LiDAR lift: instance disparity and mask -> fixed-size point
clouds per ROI (counterpart of disprcnn_tpu/models/pointrcnn/lift.py).

- boxes are integer-expanded (floor/ceil);
- the roi_size^2 disparity of each ROI is sampled on a G x G sub-pixel grid
  over its box, rescaled by max(w, w') / roi_size, shifted by the left/right
  x offset, and turned into depth fu * baseline / disparity;
- pixels are kept where the instance mask is above the threshold, the
  depth is positive and the pixel lies inside the box, and lifted through
  the calibration;
- exactly `npoints` points are drawn per ROI by priority: the top
  `npoints` of given uniform priorities among the kept pixels, repeated
  cyclically when fewer are kept. The JAX package draws the priorities
  with jax.random inside; here they are an input (R, G*G), drawn by the
  caller (DispRCNN3D uses a torch.Generator);
- clouds are rotated by their viewing angle atan2(cx - W/2, fu) and
  mean-centred.

Constants that involve a division by a Python number are built on the CPU
and moved, or divided tensor by tensor: PyTorch on CUDA divides by a
scalar as a multiply by its reciprocal, which is not the division.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from ...ops.roipool3d import pts_in_boxes3d
from ...structures.boxes3d import (corners_from_xyzhwl_ry, rotate_points_along_y,
                                   xyzhwl_ry_from_corners)


def expand_box_to_integer(box: torch.Tensor) -> torch.Tensor:
    """floor x1/y1, ceil x2/y2 (reference utils/stereo_utils.py)."""
    return torch.stack([torch.floor(box[..., 0]), torch.floor(box[..., 1]),
                        torch.ceil(box[..., 2]), torch.ceil(box[..., 3])], dim=-1)


@functools.lru_cache(maxsize=8)
def _grid_fractions(grid: int, device: torch.device) -> torch.Tensor:
    """(arange(grid) + 0.5) / grid in float32, divided on the CPU, copied to
    `device` once (a normal tensor, also under inference mode)."""
    with torch.inference_mode(False):
        return ((torch.arange(grid, dtype=torch.float32) + 0.5) / grid).to(device)


def _axis_taps(coords: torch.Tensor, size: int) -> torch.Tensor:
    """(..., G) float coordinates -> (..., G, size) border-clamped bilinear
    tap matrix."""
    c = coords.clamp(0.0, size - 1.0)
    i0 = torch.floor(c).long().clamp(0, max(size - 2, 0))
    frac = c - i0
    iota = torch.arange(size, device=coords.device)
    return ((iota == i0[..., None]) * (1.0 - frac)[..., None]
            + (iota == (i0 + 1)[..., None]) * frac[..., None])


def _bilinear_separable(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """(R, H, W) sampled on the separable grid ys (R, Gy) x xs (R, Gx) ->
    (R, Gy, Gx), as two matrix products."""
    my = _axis_taps(ys, img.shape[-2])
    mx = _axis_taps(xs, img.shape[-1])
    return (my @ img) @ mx.transpose(-1, -2)


def roi_points_candidates(disp_roi: torch.Tensor, mask_prob: torch.Tensor,
                          left_box: torch.Tensor, right_box: torch.Tensor, fu, fv, cu, cv, tx,
                          ty, fuxbaseline, grid: int = 112, mask_thresh: float = 0.5,
                          min_depth: float = 0.0, max_depth: float = 160.0):
    """disp_roi (R, S, S), mask_prob (R, M, M), boxes (R, 4), calibration
    (R,) each -> (pts (R, G*G, 3) rect frame, valid (R, G*G))."""
    s = disp_roi.shape[-1]
    li, ri = expand_box_to_integer(left_box), expand_box_to_integer(right_box)
    x1, y1, x2, y2 = (li[:, i:i + 1] for i in range(4))
    w, h = x2 - x1, y2 - y1
    wmax = torch.maximum(w, ri[:, 2:3] - ri[:, 0:1])
    g = _grid_fractions(grid, disp_roi.device)[None, :]
    v1 = y1 + g * h  # (R, G)
    u1 = x1 + g * w
    sy = (v1 - y1) / torch.clamp_min(h, 1.0) * s - 0.5
    sx = (u1 - x1) / torch.clamp_min(wmax, 1.0) * s - 0.5
    scale = (wmax / torch.full_like(wmax, s))[:, :, None]
    d = _bilinear_separable(disp_roi, sy, sx) * scale
    d = d + (x1 - ri[:, 0:1])[:, :, None]
    depth = fuxbaseline[:, None, None] / (d + 1e-6)
    m = mask_prob.shape[-1]
    lb = left_box
    my = (v1 - lb[:, 1:2]) / torch.clamp_min(lb[:, 3:4] - lb[:, 1:2], 1.0) * m - 0.5
    mx = (u1 - lb[:, 0:1]) / torch.clamp_min(lb[:, 2:3] - lb[:, 0:1], 1.0) * m - 0.5
    mval = _bilinear_separable(mask_prob, my, mx)
    v = v1[:, :, None].expand(-1, grid, grid)
    u = u1[:, None, :].expand(-1, grid, grid)
    ok = ((mval > mask_thresh) & (depth > min_depth) & (u < x2[:, :, None])
          & (v < y2[:, :, None]))
    depth = depth.clamp_max(max_depth)
    x = (u - cu[:, None, None]) * depth / fu[:, None, None] + tx[:, None, None]
    y = (v - cv[:, None, None]) * depth / fv[:, None, None] + ty[:, None, None]
    pts = torch.stack([x, y, depth], dim=-1).reshape(disp_roi.shape[0], -1, 3)
    return pts, ok.reshape(disp_roi.shape[0], -1)


def sample_fixed_points(priorities: torch.Tensor, pts: torch.Tensor, valid: torch.Tensor,
                        npoints: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """priorities (R, C) uniform draws, candidates pts (R, C, 3) and valid
    (R, C) -> (sampled (R, npoints, 3), roi_ok (R,)): the npoints valid
    candidates of highest priority (invalid ones tie at -1, lowest index
    first: a stable sort), cycled when fewer are valid."""
    pri = torch.where(valid, priorities, torch.full_like(priorities, -1.0))
    idx = torch.sort(pri, dim=-1, descending=True, stable=True).indices[:, :npoints]
    cnt = valid.sum(-1).clamp_max(npoints)
    slot = torch.arange(npoints, device=pts.device)[None, :]
    sel = torch.where(slot < cnt[:, None], slot, slot % cnt[:, None].clamp_min(1))
    take = torch.gather(idx, 1, sel)
    return torch.gather(pts, 1, take[..., None].expand(-1, -1, 3)), cnt > 0


def canonical_angles(left_box: torch.Tensor, image_w: float, fu: torch.Tensor) -> torch.Tensor:
    """atan2(box_cx - W/2, fu) per ROI."""
    cx = (left_box[..., 0] + left_box[..., 2]) / 2
    return torch.atan2(cx - image_w / 2, fu)


def canonicalize(pts: torch.Tensor, angles: torch.Tensor):
    """Rotate per-ROI clouds by their viewing angle, then mean-centre.
    -> (pts_canonical, pts_mean)."""
    rot = rotate_points_along_y(pts, angles)
    mean = rot.mean(dim=1)
    return rot - mean[:, None, :], mean


def decanonicalize(pts: torch.Tensor, angles: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """Inverse of canonicalize."""
    return rotate_points_along_y(pts + mean[:, None, :], -angles)


def canonicalize_boxes3d(boxes: torch.Tensor, angles: torch.Tensor, mean: torch.Tensor):
    """(R, 7) xyzhwl_ry boxes into each ROI's canonical frame, through their
    corners."""
    corners = rotate_points_along_y(corners_from_xyzhwl_ry(boxes), angles) - mean[:, None, :]
    return xyzhwl_ry_from_corners(corners)


def decanonicalize_boxes3d(boxes: torch.Tensor, angles: torch.Tensor, mean: torch.Tensor):
    """Inverse of canonicalize_boxes3d: un-centre, then rotate back."""
    corners = corners_from_xyzhwl_ry(boxes) + mean[:, None, :]
    return xyzhwl_ry_from_corners(rotate_points_along_y(corners, -angles))


def rpn_point_labels(pts: torch.Tensor, gt_boxes: torch.Tensor, gt_ok: torch.Tensor):
    """The RPN's per-point targets (point_rcnn.py:402-432
    generate_rpn_training_labels). pts (R, N, 3) and the matched GT boxes
    (R, 7) xyzhwl_ry, both in the canonical frame, gt_ok (R,) ->
    cls_label (R, N): 1 inside the GT box, -1 inside the box grown by 0.2
    (h, w, l + 0.4, bottom y + 0.2) but not in it, else 0, and 0 for every
    point of an instance without GT; reg_label (R, N, 7): the true centre
    (bottom y - h / 2) minus the point, then h, w, l and ry."""
    boxes = gt_boxes[:, None, :]
    inside = pts_in_boxes3d(pts, boxes)[:, 0]
    grow = gt_boxes.new_tensor([0.0, 0.2, 0.0, 0.4, 0.4, 0.4, 0.0])
    near = pts_in_boxes3d(pts, boxes + grow)[:, 0]
    one = torch.ones_like(pts[..., 0])
    cls = torch.where(inside, one, torch.where(near, -one, torch.zeros_like(one)))
    cls = torch.where(gt_ok[:, None], cls, torch.zeros_like(cls))
    center = torch.stack([gt_boxes[:, 0], gt_boxes[:, 1] - gt_boxes[:, 3] / 2, gt_boxes[:, 2]],
                         dim=-1)
    reg = torch.cat([center[:, None, :] - pts, gt_boxes[:, None, 3:7].expand(-1, pts.shape[1], -1)],
                    dim=-1)
    return cls, reg
