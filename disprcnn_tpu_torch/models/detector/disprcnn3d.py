"""DispRCNN3D eval forward up to the instance disparity (counterpart of
disprcnn_tpu/models/detector/disprcnn3d.py with train=False and
det3d_on=False, the configuration of configs/kitti/car/vob/idispnet.yaml;
reference modeling/detector/disprcnn3d.py).

It takes the 2D stage's detections, crops both RAW [0, 1] RGB images to
width-aligned roi_size^2 ROIs (one batched ROIAlign), normalizes them with
the ImageNet mean/std, and runs iDispNet (PSMNet) over every one of the
B * max_det ROIs, valid or not, as the JAX package does (fixed shapes).
The pseudo-LiDAR lift and PointRCNN (det3d_on=True) come with the next
slice of the port.
"""
from __future__ import annotations

import functools
from dataclasses import replace
from typing import Dict

import torch
from torch import nn

from ...ops.roi_align import roi_align_batched
from ...structures.stereo import StereoBoxes
from ..pointrcnn.lift import expand_box_to_integer
from ..psmnet.psmnet import PSMNet

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def width_aligned_crop_boxes(left: torch.Tensor, right: torch.Tensor):
    """Integer-expanded (R, 4) boxes sharing the width max(w_left, w_right),
    each starting at its own x1; the right crop takes its y from the left
    box (disprcnn3d.py:62-96). -> (left_crop, right_crop)."""
    li = expand_box_to_integer(left)
    ri = expand_box_to_integer(right)
    w = torch.maximum(li[:, 2] - li[:, 0], ri[:, 2] - ri[:, 0])
    lb = torch.stack([li[:, 0], li[:, 1], li[:, 0] + w, li[:, 3]], dim=-1)
    rb = torch.stack([ri[:, 0], li[:, 1], ri[:, 0] + w, li[:, 3]], dim=-1)
    return lb, rb


def crop_and_normalize(images: torch.Tensor, boxes: torch.Tensor, batch_idx: torch.Tensor,
                       size: int = 224) -> torch.Tensor:
    """images (B, H, W, 3) raw RGB in [0, 1], boxes (R, 4) -> (R, 3, size,
    size) crops, ImageNet-normalized (ROIAlign at scale 1, one sample per
    bin; disprcnn3d.py:44-50)."""
    crops = roi_align_batched(images.permute(0, 3, 1, 2), boxes, batch_idx, size, 1.0,
                              sampling_ratio=1)
    mean, std = _imagenet_stats(crops.device)
    return (crops - mean) / std


@functools.lru_cache(maxsize=8)
def _imagenet_stats(device: torch.device):
    """(mean, std) as (1, 3, 1, 1) tensors, copied to `device` once (normal
    tensors, also when first asked for under inference mode)."""
    with torch.inference_mode(False):
        return tuple(torch.tensor(v, device=device).view(1, 3, 1, 1)
                     for v in (IMAGENET_MEAN, IMAGENET_STD))


def remove_illegal_detections(dets: StereoBoxes, min_wh: float = 1.0) -> StereoBoxes:
    """Invalidate degenerate boxes (reference disprcnn3d.py:286-294)."""
    ok = ((dets.left[..., 2] - dets.left[..., 0] >= min_wh)
          & (dets.left[..., 3] - dets.left[..., 1] >= min_wh)
          & (dets.right[..., 2] - dets.right[..., 0] >= min_wh)
          & (dets.right[..., 3] - dets.right[..., 1] >= min_wh))
    return replace(dets, valid=dets.valid & ok)


class DispRCNN3D(nn.Module):
    def __init__(self, max_det: int = 32, roi_size: int = 224, maxdisp: int = 48,
                 mindisp: int = -48, det3d_on: bool = False, psm_hourglass: int = 3,
                 device: str | torch.device = "cuda"):
        super().__init__()
        if det3d_on:
            raise NotImplementedError(
                "det3d_on=True (pseudo-LiDAR lift + PointRCNN) is the next slice of the "
                "port; build DispRCNN3D(det3d_on=False)")
        self.max_det = max_det
        self.roi_size = roi_size
        with torch.device(device):
            self.idispnet = PSMNet(maxdisp=maxdisp, mindisp=mindisp,
                                   num_hourglass=psm_hourglass)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.idispnet.dres0_0.Conv_0.weight.device

    def forward(self, left_img: torch.Tensor, right_img: torch.Tensor,
                dets: StereoBoxes) -> Dict[str, torch.Tensor]:
        """left_img, right_img (B, H, W, 3) raw [0, 1] RGB; dets batched
        (B, D, ...) 2D detections -> {"disparity_roi": (B * D, roi, roi)},
        the JAX eval output."""
        dets = remove_illegal_detections(dets)
        b, d = dets.left.shape[:2]
        batch_idx = torch.arange(b, device=left_img.device).repeat_interleave(d)
        lb, rb = width_aligned_crop_boxes(dets.left.reshape(b * d, 4),
                                          dets.right.reshape(b * d, 4))
        left_crops = crop_and_normalize(left_img, lb, batch_idx, self.roi_size)
        right_crops = crop_and_normalize(right_img, rb, batch_idx, self.roi_size)
        return {"disparity_roi": self.idispnet(left_crops, right_crops)}
