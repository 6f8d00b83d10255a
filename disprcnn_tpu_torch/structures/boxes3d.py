"""3D boxes in the ``xyzhwl_ry`` form and their corners (counterpart of the
parts of disprcnn_tpu/structures/boxes3d.py that the eval path uses).

A box is (x, y, z, h, w, l, ry): bottom centre (y points down), height,
width, length, yaw. Corner 0 is (-l/2, 0, w/2) in the object frame, and the
rotation is R_y(ry) = [[c, 0, s], [0, 1, 0], [-s, 0, c]].
"""
from __future__ import annotations

import torch


def rotate_points_along_y(pts: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotate (..., N, 3) points about the camera y-axis by (...,) angles:
    x' = x c - z s, z' = x s + z c (reference
    kitti_utils.rotate_pc_along_y_torch)."""
    c, s = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    x, z = pts[..., 0], pts[..., 2]
    return torch.stack([x * c - z * s, pts[..., 1], x * s + z * c], dim=-1)


def corners_from_xyzhwl_ry(b: torch.Tensor) -> torch.Tensor:
    """(..., 7) -> (..., 8, 3) rect-frame corners; xyz is the bottom centre,
    the top face at y - h."""
    x, y, z = b[..., 0], b[..., 1], b[..., 2]
    h, w, l, ry = b[..., 3], b[..., 4], b[..., 5], b[..., 6]
    zero = torch.zeros_like(h)
    xc = torch.stack([-l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2], -1)
    yc = torch.stack([zero, -h, -h, zero, zero, -h, -h, zero], -1)
    zc = torch.stack([w / 2, w / 2, w / 2, w / 2, -w / 2, -w / 2, -w / 2, -w / 2], -1)
    c, s = torch.cos(ry)[..., None], torch.sin(ry)[..., None]
    xr = c * xc + s * zc
    zr = -s * xc + c * zc
    return torch.stack([xr + x[..., None], yc + y[..., None], zr + z[..., None]], dim=-1)


def xyzhwl_ry_from_corners(corners: torch.Tensor) -> torch.Tensor:
    """(..., 8, 3) -> (..., 7), the inverse of corners_from_xyzhwl_ry; ry
    from corner 3 - corner 0."""
    c0, c1, c3, c4, c7 = (corners[..., i, :] for i in (0, 1, 3, 4, 7))
    dif = c3 - c0
    ry = -torch.atan2(dif[..., 2], dif[..., 0])
    xyz = (c7 + c0) / 2.0
    l = torch.linalg.vector_norm(c0 - c3, dim=-1)
    h = torch.linalg.vector_norm(c0 - c1, dim=-1)
    w = torch.linalg.vector_norm(c0 - c4, dim=-1)
    return torch.cat([xyz, h[..., None], w[..., None], l[..., None], ry[..., None]], dim=-1)
