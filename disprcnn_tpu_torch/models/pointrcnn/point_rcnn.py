"""The PointRCNN 3D stage, eval only: 3D RPN -> proposals -> RoI-pool 3D ->
RCNN -> one box per instance (counterpart of the eval branch of
disprcnn_tpu/models/pointrcnn/point_rcnn.py with rcnn_enabled, the score-
based proposals and RPN.NMS_TYPE "normal"; reference lib/net/point_rcnn.py).
Each 2D detection is one fixed-size canonical cloud on the instance axis.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from . import bbox3d_codec as codec
from . import lift, rcnn3d, rpn3d
from .pointnet2 import SA_MIN_C0

MEAN_SIZE = (1.52563191462, 1.62856739989, 3.88311640418)  # h, w, l
ROI_BLOCK = 6400  # disprcnn_tpu point_rcnn._roi_blocks, the shipped cap


class PointRCNN(nn.Module):
    def __init__(self, npoints: int = 768, mean_size: Tuple[float, float, float] = MEAN_SIZE,
                 rpn_codec: codec.CodecCfg = codec.CodecCfg(loc_scope=3.0, loc_bin_size=0.5,
                                                            num_head_bin=12, xz_fine=False),
                 rpn_use_bn: bool = True, rpn_score_thresh: float = 0.3,
                 proposals_per_roi: int = 16, rpn_pre_nms_per_roi: int = 128,
                 rpn_nms_thresh: float = 0.8, rcnn_num_points: int = 512,
                 rcnn_score_thresh: float = 0.1,
                 sa_npoints: Tuple[int, ...] = (768, 512, 256, 64),
                 sa_min_c0: int = SA_MIN_C0, roi_block: int = ROI_BLOCK):
        super().__init__()
        self.npoints = npoints
        self.register_buffer("anchor", torch.tensor(mean_size, dtype=torch.float32),
                             persistent=False)
        self.rpn_codec = rpn_codec
        self.rpn_score_thresh = rpn_score_thresh
        self.proposals_per_roi = proposals_per_roi
        self.rpn_pre_nms_per_roi = rpn_pre_nms_per_roi
        self.rpn_nms_thresh = rpn_nms_thresh
        self.rcnn_num_points = rcnn_num_points
        self.rcnn_score_thresh = rcnn_score_thresh
        self.roi_block = roi_block
        self.rpn = rpn3d.RPN3D(codec_cfg=rpn_codec, use_bn=rpn_use_bn, npoints=sa_npoints,
                               sa_min_c0=sa_min_c0)
        self.rcnn = rcnn3d.RCNNNet(rpn_channels=self.rpn.backbone.out_channels,
                                   sa_min_c0=sa_min_c0)

    def forward(self, pts: torch.Tensor, roi_valid: torch.Tensor, angles: torch.Tensor,
                pts_mean: torch.Tensor) -> Dict[str, torch.Tensor]:
        """pts (R, N, 3) canonical clouds, roi_valid (R,), angles (R,),
        pts_mean (R, 3) -> box3d (R, 7), score3d (R,), random (R,)."""
        rpn_out = self.rpn(pts)
        rois_c, roi_scores, prop_valid = rpn3d.propose(
            rpn_out["cls"], rpn_out["reg"], rpn_out["xyz"], self.anchor, self.rpn_codec,
            pre_nms_top_n=min(self.rpn_pre_nms_per_roi, pts.shape[1]),
            post_nms_top_n=self.proposals_per_roi, nms_thresh=self.rpn_nms_thresh)
        r, k = rois_c.shape[:2]
        rois = _decanon_rois(rois_c, angles, pts_mean)
        prop_valid = prop_valid & roi_valid[:, None]
        xyz_rect = lift.decanonicalize(rpn_out["xyz"], angles, pts_mean)
        seg_mask = (torch.sigmoid(rpn_out["cls"]) > self.rpn_score_thresh).to(pts.dtype)
        # proposal blocks bound the live (R * k / nb, 512, 133) activations
        nb = _roi_blocks(r, k, self.roi_block)
        mb = k // nb
        cls, reg, empty = [], [], []
        for j in range(nb):
            pts_in, e = rcnn3d.pool_rcnn_inputs(xyz_rect, rpn_out["features"], seg_mask,
                                                rois[:, j * mb:(j + 1) * mb],
                                                num_points=self.rcnn_num_points)
            c, g = self.rcnn(pts_in.reshape(r * mb, self.rcnn_num_points, -1))
            cls.append(c.reshape(r, mb))
            reg.append(g.reshape(r, mb, -1))
            empty.append(e)
        box3d, score3d, is_random = rcnn3d.rcnn_postprocess(
            torch.cat(cls, 1), torch.cat(reg, 1), rois, prop_valid & ~torch.cat(empty, 1),
            roi_scores, self.anchor, score_thresh=self.rcnn_score_thresh)
        return {"box3d": box3d, "score3d": score3d, "random": is_random}


def _roi_blocks(r: int, k: int, cap: int = ROI_BLOCK) -> int:
    """The number of proposal blocks: the smallest divisor nb of k that keeps
    r * k / nb ROIs at once within `cap`; 1 when all of them fit."""
    if r * k <= cap or k <= 1:
        return 1
    for nb in range(2, k + 1):
        if k % nb == 0 and r * (k // nb) <= cap:
            return nb
    return k


def _decanon_rois(rois_c: torch.Tensor, angles: torch.Tensor,
                  pts_mean: torch.Tensor) -> torch.Tensor:
    """(R, M, 7) canonical rois -> rect frame."""
    r, m, _ = rois_c.shape
    return lift.decanonicalize_boxes3d(rois_c.reshape(r * m, 7), angles.repeat_interleave(m),
                                       pts_mean.repeat_interleave(m, dim=0)).reshape(r, m, 7)
