"""3D RoI pooling in plain PyTorch: point-in-box tests and the first-k
selection with a cycled tail (counterpart of disprcnn_tpu/ops/roipool3d.py;
reference roipool3d_kernel.cu). The kernel and the dispatching
``roipool3d`` are in ops/cuda/roipool3d.py.

A box is (cx, bottom_y, cz, h, w, l, ry) in the y-down camera frame, its
centre y at bottom_y - h/2. A point is inside when it is within
``max_dis`` of the centre in x and z, within h/2 in y, and within the box
in the box's own frame: |x c - z s| <= l/2 and |x s + z c| <= w/2 for the
offsets x, z from the centre and c, s the cosine and sine of ry.
"""
from __future__ import annotations

import torch

from .points import first_k_true


def pts_in_boxes3d(pts: torch.Tensor, boxes3d: torch.Tensor,
                   max_dis: float = 10.0) -> torch.Tensor:
    """(..., N, 3) points x (..., M, 7) boxes -> bool (..., M, N)."""
    x, y, z = (pts[..., None, :, i] for i in range(3))
    cx, by, cz, h, w, l, ry = (boxes3d[..., i:i + 1] for i in range(7))
    cy = by - h / 2.0
    dx, dy, dz = x - cx, y - cy, z - cz
    near = (dx.abs() <= max_dis) & (dy.abs() <= h / 2.0) & (dz.abs() <= max_dis)
    cosa, sina = torch.cos(ry), torch.sin(ry)
    x_rot = dx * cosa - dz * sina
    z_rot = dx * sina + dz * cosa
    inside = (x_rot >= -l / 2.0) & (x_rot <= l / 2.0) & (z_rot >= -w / 2.0) & (z_rot <= w / 2.0)
    return near & inside


def _first_k_cycled_rows(mask: torch.Tensor, k: int):
    """(R, N) mask -> (idx (R, k), cnt (R,)): the first k True entries in
    scan order, slot j >= cnt taking the (j mod cnt)-th; all-False rows give
    zeros."""
    cand, cnt = first_k_true(mask, k)
    slot = torch.arange(k, device=mask.device)[None, :]
    sel = torch.where(slot < cnt[:, None], slot, slot % cnt[:, None].clamp_min(1))
    out = torch.gather(cand, 1, sel)
    return torch.where(cnt[:, None] > 0, out, torch.zeros_like(out)), cnt


def roipool3d_plain(pts: torch.Tensor, feats: torch.Tensor, boxes3d: torch.Tensor,
                    sampled_pts_num: int = 512, max_dis: float = 10.0):
    """pts (B, N, 3), feats (B, N, C), boxes (B, M, 7) -> pooled (B, M, S, 3 +
    C) of [xyz, features] rows, empty (B, M) bool; an empty box's rows are 0."""
    b, n = pts.shape[:2]
    m = boxes3d.shape[1]
    mask = pts_in_boxes3d(pts, boxes3d, max_dis)  # (B, M, N)
    idx, cnt = _first_k_cycled_rows(mask.reshape(b * m, n), sampled_pts_num)
    full = torch.cat([pts, feats], dim=-1)
    pooled = torch.gather(full, 1, idx.reshape(b, m * sampled_pts_num, 1).expand(
        -1, -1, full.shape[-1])).reshape(b, m, sampled_pts_num, full.shape[-1])
    empty = (cnt == 0).reshape(b, m)
    return torch.where(empty[:, :, None, None], torch.zeros_like(pooled), pooled), empty


def enlarge_box3d(boxes3d: torch.Tensor, extra_width: float) -> torch.Tensor:
    """Grow h, w, l by 2 * extra_width and move the bottom y down by
    extra_width (reference kitti_utils.enlarge_box3d)."""
    grow = boxes3d.new_tensor([0.0, extra_width, 0.0, 2 * extra_width, 2 * extra_width,
                               2 * extra_width, 0.0])
    return boxes3d + grow
