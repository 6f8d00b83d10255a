"""DispRCNN3D eval forward (counterpart of
disprcnn_tpu/models/detector/disprcnn3d.py with train=False; reference
modeling/detector/disprcnn3d.py).

It takes the 2D stage's detections, crops both RAW [0, 1] RGB images to
width-aligned roi_size^2 ROIs (one batched ROIAlign), normalizes them with
the ImageNet mean/std, and runs iDispNet (PSMNet) over every one of the
B * max_det ROIs, valid or not, as the JAX package does (fixed shapes).
With det3d_on=False (configs/kitti/car/vob/idispnet.yaml) that is all.
With det3d_on=True (configs/kitti/car/vob/rcnn.yaml) the instance
disparity is lifted to one fixed-size pseudo-LiDAR cloud per ROI and
PointRCNN returns one 3D box per ROI.
"""
from __future__ import annotations

import functools
from dataclasses import replace
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ...ops.roi_align import roi_align_batched
from ...structures.stereo import StereoBoxes
from ..pointrcnn import lift
from ..pointrcnn.lift import expand_box_to_integer
from ..pointrcnn.point_rcnn import MEAN_SIZE, ROI_BLOCK, PointRCNN
from ..pointrcnn.pointnet2 import SA_MIN_C0
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


CALIB_KEYS = ("fu", "fv", "cu", "cv", "tx", "ty", "fuxb")


class DispRCNN3D(nn.Module):
    """The JAX constructor's names and defaults for the eval fields that the
    port runs, but det3d_on defaults to False (the iDispNet-only
    configuration). The JAX package's rcnn_enabled (True), rpn_nms_rotated
    and rpn_distance_based (False) are not options here: the port runs
    only those values. Its DISPRCNN_SA_MIN_C0 and DISPRCNN_RCNN_ROI_BLOCK
    knobs are the arguments sa_min_c0 and roi_block, with the shipped
    values."""

    def __init__(self, max_det: int = 32, roi_size: int = 224, maxdisp: int = 48,
                 mindisp: int = -48, npoints: int = 768, lift_grid: int = 112,
                 mask_thresh_eval: float = 0.5,
                 mean_size: Tuple[float, float, float] = MEAN_SIZE, det3d_on: bool = False,
                 proposals_per_roi: int = 16, rpn_pre_nms_per_roi: int = 128,
                 sa_npoints: Tuple[int, ...] = (768, 512, 256, 64),
                 rpn_score_thresh: float = 0.3, rpn_nms_thresh: float = 0.8,
                 psm_hourglass: int = 3, sa_min_c0: int = SA_MIN_C0,
                 roi_block: int = ROI_BLOCK, device: str | torch.device = "cuda"):
        super().__init__()
        self.max_det = max_det
        self.roi_size = roi_size
        self.det3d_on = det3d_on
        self.npoints = npoints
        self.lift_grid = lift_grid
        self.mask_thresh_eval = mask_thresh_eval
        with torch.device(device):
            self.idispnet = PSMNet(maxdisp=maxdisp, mindisp=mindisp,
                                   num_hourglass=psm_hourglass)
            if det3d_on:
                self.pointrcnn = PointRCNN(
                    npoints=npoints, mean_size=mean_size, proposals_per_roi=proposals_per_roi,
                    rpn_pre_nms_per_roi=rpn_pre_nms_per_roi, sa_npoints=sa_npoints,
                    rpn_score_thresh=rpn_score_thresh, rpn_nms_thresh=rpn_nms_thresh,
                    sa_min_c0=sa_min_c0, roi_block=roi_block)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.idispnet.dres0_0.Conv_0.weight.device

    def forward(self, left_img: torch.Tensor, right_img: torch.Tensor, dets: StereoBoxes,
                calib: Optional[Dict[str, torch.Tensor]] = None,
                priorities: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """left_img, right_img (B, H, W, 3) raw [0, 1] RGB; dets batched
        (B, D, ...) 2D detections, with the "mask" field (B, D, M, M) when
        det3d_on. Returns the JAX eval outputs: "disparity_roi" (B * D, roi,
        roi); with det3d_on also "box3d" (B, D, 7), "score3d" (B, D), "random"
        (B, D) and "roi_ok" (B, D).

        det3d_on needs `calib`, {fu, fv, cu, cv, tx, ty, fuxb} of (B,)
        tensors, and the lift's sampling priorities: `priorities` (B * D,
        lift_grid^2) uniform draws, or a `generator` on the model's device to
        draw them from."""
        dets = remove_illegal_detections(dets)
        b, d = dets.left.shape[:2]
        batch_idx = torch.arange(b, device=left_img.device).repeat_interleave(d)
        left_b, right_b = dets.left.reshape(b * d, 4), dets.right.reshape(b * d, 4)
        lb, rb = width_aligned_crop_boxes(left_b, right_b)
        left_crops = crop_and_normalize(left_img, lb, batch_idx, self.roi_size)
        right_crops = crop_and_normalize(right_img, rb, batch_idx, self.roi_size)
        disp = self.idispnet(left_crops, right_crops)
        out = {"disparity_roi": disp}
        if not self.det3d_on:
            return out
        if calib is None or set(calib) != set(CALIB_KEYS):
            raise ValueError(f"det3d_on needs calib with the keys {CALIB_KEYS}")
        cal = {k: calib[k][batch_idx] for k in CALIB_KEYS}
        masks = dets.fields["mask"]
        pts_cand, cand_ok = lift.roi_points_candidates(
            disp, masks.reshape(b * d, *masks.shape[2:]), left_b, right_b, cal["fu"],
            cal["fv"], cal["cu"], cal["cv"], cal["tx"], cal["ty"], cal["fuxb"],
            grid=self.lift_grid, mask_thresh=self.mask_thresh_eval)
        if priorities is None:
            if generator is None:
                raise ValueError("det3d_on needs sampling priorities or a generator")
            priorities = torch.rand(cand_ok.shape, generator=generator, device=disp.device)
        pts, has_pts = lift.sample_fixed_points(priorities, pts_cand, cand_ok, self.npoints)
        roi_ok = dets.valid.reshape(b * d) & has_pts
        angles = lift.canonical_angles(left_b, float(left_img.shape[2]), cal["fu"])
        pts_c, pts_mean = lift.canonicalize(pts, angles)
        pr = self.pointrcnn(pts_c, roi_ok, angles, pts_mean)
        for k in ("box3d", "score3d", "random"):
            out[k] = pr[k].reshape((b, d) + pr[k].shape[1:])
        out["roi_ok"] = roi_ok.reshape(b, d)
        return out
