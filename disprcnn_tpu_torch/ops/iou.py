"""Axis-aligned 2D IoU, with the legacy +1 pixel convention by default
(counterpart of the 2D part of disprcnn_tpu/ops/iou.py; reference
boxlist_ops.py:130-132, csrc/cuda/nms.cu devIoU), and the BEV form of 3D
boxes. The 3D proposal NMS uses the axis-aligned IoU of BEV boxes with
to_remove=0 (RPN.NMS_TYPE "normal"); rotated BEV IoU is not ported yet."""
from __future__ import annotations

import torch


def box_area(boxes: torch.Tensor, to_remove: float = 1.0) -> torch.Tensor:
    """Area of (..., 4) xyxy boxes with the reference's +1 convention."""
    wh = (boxes[..., 2:4] - boxes[..., 0:2] + to_remove).clamp_min(0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(a: torch.Tensor, b: torch.Tensor, to_remove: float = 1.0) -> torch.Tensor:
    """IoU matrix between (N, 4) and (M, 4) xyxy boxes -> (N, M)."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt + to_remove).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a, to_remove)[:, None] + box_area(b, to_remove)[None, :] - inter
    return inter / union.clamp_min(1e-12)


def boxes3d_to_bev(boxes3d: torch.Tensor) -> torch.Tensor:
    """(..., 7) [x, y, z, h, w, l, ry] -> BEV (..., 5) [x1, y1, x2, y2, ry] in
    the x/z plane: half-length along x, half-width along z (reference
    kitti_utils.boxes3d_to_bev_torch)."""
    cu, cv = boxes3d[..., 0], boxes3d[..., 2]
    half_l, half_w = boxes3d[..., 5] / 2, boxes3d[..., 4] / 2
    return torch.stack([cu - half_l, cv - half_w, cu + half_l, cv + half_w, boxes3d[..., 6]],
                       dim=-1)
