"""Axis-aligned 2D IoU, with the legacy +1 pixel convention by default
(counterpart of the 2D part of disprcnn_tpu/ops/iou.py; reference
boxlist_ops.py:130-132, csrc/cuda/nms.cu devIoU), the BEV form of 3D
boxes, and the rotated BEV and 3D IoU of the JAX package (reference
iou3d_kernel.cu polygon clipping, iou3d_utils.boxes_iou3d_gpu:23-57). The
3D proposal NMS uses the axis-aligned IoU of BEV boxes with to_remove=0
(RPN.NMS_TYPE "normal"); the RCNN's proposal sampler and ROI noise use
pairwise_iou3d, which a "rotate" NMS can reuse through pairwise_bev_iou."""
from __future__ import annotations

import torch


def box_area(boxes: torch.Tensor, to_remove: float = 1.0) -> torch.Tensor:
    """Area of (..., 4) xyxy boxes with the reference's +1 convention."""
    wh = (boxes[..., 2:4] - boxes[..., 0:2] + to_remove).clamp_min(0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(a: torch.Tensor, b: torch.Tensor, to_remove: float = 1.0) -> torch.Tensor:
    """IoU matrix between (..., N, 4) and (..., M, 4) xyxy boxes -> (..., N,
    M); leading axes broadcast."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt + to_remove).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a, to_remove)[..., :, None] + box_area(b, to_remove)[..., None, :] - inter
    return inter / union.clamp_min(1e-12)


def boxes3d_to_bev(boxes3d: torch.Tensor) -> torch.Tensor:
    """(..., 7) [x, y, z, h, w, l, ry] -> BEV (..., 5) [x1, y1, x2, y2, ry] in
    the x/z plane: half-length along x, half-width along z (reference
    kitti_utils.boxes3d_to_bev_torch)."""
    cu, cv = boxes3d[..., 0], boxes3d[..., 2]
    half_l, half_w = boxes3d[..., 5] / 2, boxes3d[..., 4] / 2
    return torch.stack([cu - half_l, cv - half_w, cu + half_l, cv + half_w, boxes3d[..., 6]],
                       dim=-1)


# A BEV box is (x1, y1, x2, y2, ry): the axis-aligned rectangle rotated by
# ry about its own centre (reference kitti_utils.boxes3d_to_bev_torch).


def _rect_frame(bev: torch.Tensor):
    """(cx, cy, half width, half height, cos ry, sin ry) of (..., 5)."""
    cx, cy = (bev[..., 0] + bev[..., 2]) * 0.5, (bev[..., 1] + bev[..., 3]) * 0.5
    hw, hh = (bev[..., 2] - bev[..., 0]) * 0.5, (bev[..., 3] - bev[..., 1]) * 0.5
    return cx, cy, hw, hh, torch.cos(bev[..., 4]), torch.sin(bev[..., 4])


def bev_corners(bev: torch.Tensor) -> torch.Tensor:
    """Corners (..., 4, 2) of (..., 5) BEV boxes, counter-clockwise."""
    cx, cy, hw, hh, c, s = _rect_frame(bev)
    dx = torch.stack([hw, -hw, -hw, hw], dim=-1)
    dy = torch.stack([hh, hh, -hh, -hh], dim=-1)
    x = cx[..., None] + dx * c[..., None] - dy * s[..., None]
    y = cy[..., None] + dx * s[..., None] + dy * c[..., None]
    return torch.stack([x, y], dim=-1)


def _point_in_rect(pts: torch.Tensor, bev: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """pts (..., K, 2) inside the rects (..., 5) -> (..., K)."""
    cx, cy, hw, hh, c, s = (t[..., None] for t in _rect_frame(bev))
    px, py = pts[..., 0] - cx, pts[..., 1] - cy
    u, v = px * c + py * s, -px * s + py * c
    return (u.abs() <= hw + eps) & (v.abs() <= hh + eps)


def _cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]


def _seg_intersections(ca: torch.Tensor, cb: torch.Tensor):
    """The 16 edge-pair intersections of two quads (..., 4, 2) -> points
    (..., 16, 2) and their validity (..., 16)."""
    p, r = ca[..., :, None, :], (torch.roll(ca, -1, dims=-2) - ca)[..., :, None, :]
    q, sv = cb[..., None, :, :], (torch.roll(cb, -1, dims=-2) - cb)[..., None, :, :]
    denom = _cross(r, sv)
    flat = denom.abs() < 1e-12
    safe = torch.where(flat, torch.ones_like(denom), denom)
    qp = q - p
    t, u = _cross(qp, sv) / safe, _cross(qp, r) / safe
    ok = ~flat & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    pts = p + t[..., None] * r
    return pts.reshape(*pts.shape[:-3], 16, 2), ok.reshape(*ok.shape[:-2], 16)


def rotated_rect_intersection_area(bev_a: torch.Tensor, bev_b: torch.Tensor) -> torch.Tensor:
    """Intersection area of rotated rects (..., 5), elementwise -> (...).
    The candidate vertices (the corners of each inside the other and the
    edge intersections, 24 slots) are ordered by angle about their centroid
    (ties by slot) and summed by the shoelace formula, as the JAX package
    computes it."""
    ca, cb = bev_corners(bev_a), bev_corners(bev_b)
    xpts, xok = _seg_intersections(ca, cb)
    pts = torch.cat([ca, cb, xpts], dim=-2)
    ok = torch.cat([_point_in_rect(ca, bev_b), _point_in_rect(cb, bev_a), xok], dim=-1)
    nv = ok.sum(-1)
    okf = ok[..., None].to(pts.dtype)
    centroid = (pts * okf).sum(-2) / nv.clamp_min(1)[..., None].to(pts.dtype)
    ang = torch.atan2(pts[..., 1] - centroid[..., None, 1], pts[..., 0] - centroid[..., None, 0])
    ang = torch.where(ok, ang, torch.full_like(ang, 1e9))
    idx = torch.arange(24, device=pts.device)
    less = (ang[..., None, :] < ang[..., :, None]) | (
        (ang[..., None, :] == ang[..., :, None]) & (idx[None, :] < idx[:, None]))
    rank = less.sum(-1)
    succ = (rank[..., :, None] + 1) % nv.clamp_min(1)[..., None, None] == rank[..., None, :]
    adj = succ & ok[..., :, None] & ok[..., None, :]
    x, y = pts[..., 0], pts[..., 1]
    cross = x[..., :, None] * y[..., None, :] - y[..., :, None] * x[..., None, :]
    area = 0.5 * torch.where(adj, cross, torch.zeros_like(cross)).sum((-2, -1)).abs()
    return torch.where(nv >= 3, area, torch.zeros_like(area))


def pairwise_bev_overlap(bev_a: torch.Tensor, bev_b: torch.Tensor) -> torch.Tensor:
    """(..., N, 5) x (..., M, 5) -> (..., N, M) rotated intersection areas."""
    a, b = torch.broadcast_tensors(bev_a[..., :, None, :], bev_b[..., None, :, :])
    return rotated_rect_intersection_area(a, b)


def pairwise_bev_iou(bev_a: torch.Tensor, bev_b: torch.Tensor) -> torch.Tensor:
    """Rotated BEV IoU matrix (..., N, M) of (..., N, 5) x (..., M, 5)."""
    inter = pairwise_bev_overlap(bev_a, bev_b)
    area = lambda b: (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area(bev_a)[..., :, None] + area(bev_b)[..., None, :]
                    - inter).clamp_min(1e-7)


def iou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """3D IoU of (..., 7) [x, y, z, h, w, l, ry] boxes, elementwise, in the
    camera frame (y down, y the bottom face): rotated BEV overlap times the
    vertical overlap, over the union of the volumes."""
    bev = rotated_rect_intersection_area(boxes3d_to_bev(boxes_a), boxes3d_to_bev(boxes_b))
    a_top, b_top = boxes_a[..., 1] - boxes_a[..., 3], boxes_b[..., 1] - boxes_b[..., 3]
    h = (torch.minimum(boxes_a[..., 1], boxes_b[..., 1])
         - torch.maximum(a_top, b_top)).clamp_min(0.0)
    inter = bev * h
    vol = lambda b: b[..., 3] * b[..., 4] * b[..., 5]
    return inter / (vol(boxes_a) + vol(boxes_b) - inter).clamp_min(1e-7)


def pairwise_iou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """3D IoU matrix (N, M) of (N, 7) x (M, 7) boxes (iou3d of every pair;
    reference iou3d_utils.boxes_iou3d_gpu:23-57)."""
    n, m = boxes_a.shape[0], boxes_b.shape[0]
    return iou3d(boxes_a[:, None].expand(n, m, 7), boxes_b[None].expand(n, m, 7))
