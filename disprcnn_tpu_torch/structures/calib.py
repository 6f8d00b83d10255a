"""Stereo camera calibration (counterpart of disprcnn_tpu/structures/calib.py;
reference utils/kitti_utils.py:12-384, structures/calib.py:10-215).

``Calib`` holds the left/right colour cameras' projection matrices P2, P3
((3, 4) tensors) and the image size (width, height); the projections are
torch ops on (...)-shaped tensors, and ``crop``/``resize`` return adjusted
copies.

Key identity: ``stereo_baseline`` = P2[0,3] - P3[0,3] = fu * baseline_meters,
so depth = stereo_baseline / disparity (utils/kitti_utils.py:66-68, 238-241).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass(frozen=True)
class Calib:
    P2: torch.Tensor  # (3, 4) left colour camera projection
    P3: torch.Tensor  # (3, 4) right colour camera projection
    size: Tuple[int, int]  # (width, height)

    # -- intrinsics --------------------------------------------------------
    @property
    def fu(self):
        return self.P2[..., 0, 0]

    @property
    def fv(self):
        return self.P2[..., 1, 1]

    @property
    def cu(self):
        return self.P2[..., 0, 2]

    @property
    def cv(self):
        return self.P2[..., 1, 2]

    @property
    def tx(self):
        return self.P2[..., 0, 3] / (-self.fu)

    @property
    def ty(self):
        return self.P2[..., 1, 3] / (-self.fv)

    @property
    def stereo_baseline(self):
        """fu x baseline (pixel-meters): depth = stereo_baseline / disparity."""
        return self.P2[..., 0, 3] - self.P3[..., 0, 3]

    @property
    def width(self):
        return self.size[0]

    @property
    def height(self):
        return self.size[1]

    # -- projections -------------------------------------------------------
    def img_to_rect(self, u, v, depth):
        """Pixel coordinates + depth -> rect-frame points (..., 3)
        (utils/kitti_utils.py:196-212)."""
        x = (u - self.cu) * depth / self.fu + self.tx
        y = (v - self.cv) * depth / self.fv + self.ty
        return torch.stack([x, y, depth], dim=-1)

    def rect_to_img(self, pts):
        """(..., 3) rect points -> ((..., 2) pixels, (...,) depth)
        (utils/kitti_utils.py:141-158)."""
        hom = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
        img = hom @ self.P2.T
        # the reference divides by the input z, not the homogeneous w (which
        # differs by P2[2,3]): utils/kitti_utils.py:149-150
        return img[..., :2] / pts[..., 2:3], img[..., 2] - self.P2[2, 3]

    def disparity_to_depth(self, disp, epsilon: float = 1e-6):
        return self.stereo_baseline / (disp + epsilon)

    def depth_to_disparity(self, depth, epsilon: float = 1e-6):
        return self.stereo_baseline / (depth + epsilon)

    def depth_map_to_rect(self, depth_map: torch.Tensor) -> torch.Tensor:
        """(H, W) depth -> (H*W, 3) rect points, row-major pixel order
        (utils/kitti_utils.py:214-231)."""
        h, w = depth_map.shape
        v, u = torch.meshgrid(torch.arange(h, device=depth_map.device),
                              torch.arange(w, device=depth_map.device), indexing="ij")
        return self.img_to_rect(u.reshape(-1).to(depth_map.dtype),
                                v.reshape(-1).to(depth_map.dtype), depth_map.reshape(-1))

    # -- geometric adjustments --------------------------------------------
    def crop(self, box) -> "Calib":
        """Shift the principal points by the crop's origin
        (utils/kitti_utils.py:336-347)."""
        x1, y1, x2, y2 = box
        shift = torch.zeros((3, 4), dtype=self.P2.dtype, device=self.P2.device)
        shift[0, 2], shift[1, 2] = x1, y1
        return Calib(P2=self.P2 - shift, P3=self.P3 - shift, size=(int(x2 - x1), int(y2 - y1)))

    def resize(self, dst_size: Tuple[int, int]) -> "Calib":
        """Scale rows 0 and 1 by the size ratio (utils/kitti_utils.py:348-366)."""
        w, h = dst_size
        scale = torch.tensor([w / self.width, h / self.height, 1.0], dtype=self.P2.dtype,
                             device=self.P2.device)[:, None]
        return Calib(P2=self.P2 * scale, P3=self.P3 * scale, size=(int(w), int(h)))
