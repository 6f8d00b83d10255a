"""The 3D RCNN refinement stage, eval only (counterpart of
disprcnn_tpu/models/pointrcnn/rcnn3d.py; reference lib/net/rcnn_net.py and
rcnn_inference.py).

Per proposal: pool 512 points and their features in the enlarged box
(RoI-pool 3D, ops/cuda/roipool3d.py), with two extra channels (the RPN's
segmentation mask and depth / 70 - 0.5); move them into the proposal's
canonical frame; the BN-free RCNN PointNet (xyz_up, merge_down, SA 128 /
32 / group-all, cls and bin-reg heads); then per instance the
best-scoring refined box above the threshold, or the best RPN proposal
with the ``random`` flag.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ...ops.cuda.roipool3d import roipool3d
from ...ops.roipool3d import enlarge_box3d
from ...structures.boxes3d import rotate_points_along_y
from . import bbox3d_codec as codec
from .pointnet2 import SA_MIN_C0, SAModule, SharedMLP

RCNN_CODEC = codec.CodecCfg(loc_scope=1.5, loc_bin_size=0.5, num_head_bin=9, xz_fine=True,
                            ry_fine=True)


class RCNNNet(nn.Module):
    def __init__(self, xyz_up: Sequence[int] = (128, 128),
                 sa_npoints: Sequence[int] = (128, 32, -1),
                 sa_radius: Sequence[float] = (0.2, 0.4, 100.0),
                 sa_nsample: Sequence[int] = (64, 64, 64),
                 sa_mlps: Sequence[Sequence[int]] = ((128, 128, 128), (128, 128, 256),
                                                     (256, 256, 512)),
                 cls_fc: Sequence[int] = (256, 256), reg_fc: Sequence[int] = (256, 256),
                 rpn_channels: int = 128, input_extra: int = 2, sa_min_c0: int = SA_MIN_C0):
        super().__init__()
        self.nc_in = 3 + input_extra
        self.xyz_up = SharedMLP(xyz_up, self.nc_in, use_bn=False)
        self.merge_down = SharedMLP((xyz_up[-1],), xyz_up[-1] + rpn_channels, use_bn=False)
        feat = xyz_up[-1]
        self.n_sa = len(sa_npoints)
        for i, (npt, r, ns, mlp) in enumerate(zip(sa_npoints, sa_radius, sa_nsample, sa_mlps)):
            setattr(self, f"sa{i}", SAModule(None if npt == -1 else npt, r, ns, mlp, feat,
                                             use_bn=False, sa_min_c0=sa_min_c0))
            feat = mlp[-1]
        self.cls_fc, self.reg_fc = tuple(cls_fc), tuple(reg_fc)
        for name, hidden, out in (("cls", cls_fc, 1), ("reg", reg_fc, RCNN_CODEC.reg_channels)):
            cin = feat
            for i, c in enumerate(hidden):
                setattr(self, f"{name}_fc{i}", nn.Linear(cin, c))
                cin = c
            setattr(self, f"{name}_out", nn.Linear(cin, out))

    def _head(self, x: torch.Tensor, name: str, hidden) -> torch.Tensor:
        for i in range(len(hidden)):
            x = torch.relu(getattr(self, f"{name}_fc{i}")(x))
        return getattr(self, f"{name}_out")(x)

    def forward(self, pts_input: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """pts_input (B, P, 5 + C_rpn) -> (cls (B,), reg (B, C))."""
        xyz = pts_input[..., 0:3].contiguous()
        xyz_feat = self.xyz_up(pts_input[..., :self.nc_in])
        feats = self.merge_down(torch.cat([xyz_feat, pts_input[..., self.nc_in:]], dim=-1))
        for i in range(self.n_sa):
            xyz, feats = getattr(self, f"sa{i}")(xyz, feats)
        g = feats[:, 0, :]  # group-all leaves one descriptor
        return self._head(g, "cls", self.cls_fc)[:, 0], self._head(g, "reg", self.reg_fc)


def pool_rcnn_inputs(xyz: torch.Tensor, rpn_feats: torch.Tensor, seg_mask: torch.Tensor,
                     rois: torch.Tensor, num_points: int = 512, pool_extra_width: float = 1.0):
    """xyz (R, N, 3) rect frame, rpn_feats (R, N, C), seg_mask (R, N), rois
    (R, M, 7) -> pts_input (R, M, num_points, 5 + C), empty (R, M): points
    pooled in the enlarged rois, centred on and rotated by the roi."""
    norm = torch.linalg.vector_norm(xyz, dim=-1)
    depth = norm / torch.full_like(norm, 70.0) - 0.5  # a division, not a reciprocal multiply
    feats = torch.cat([seg_mask[..., None], depth[..., None], rpn_feats], dim=-1).contiguous()
    grown = enlarge_box3d(rois, pool_extra_width).contiguous()
    pooled, empty = roipool3d(xyz.contiguous(), feats, grown, num_points)
    r, m = rois.shape[:2]
    p_xyz = pooled[..., 0:3] - rois[..., None, 0:3]
    p_xyz = rotate_points_along_y(p_xyz.reshape(r * m, num_points, 3),
                                  rois[..., 6].reshape(r * m)).reshape(r, m, num_points, 3)
    return torch.cat([p_xyz, pooled[..., 3:]], dim=-1), empty


def rcnn_postprocess(cls_pred: torch.Tensor, reg_pred: torch.Tensor, rois: torch.Tensor,
                     roi_valid: torch.Tensor, roi_scores: torch.Tensor,
                     anchor_size: torch.Tensor, score_thresh: float = 0.1):
    """cls (R, M), reg (R, M, C), rois (R, M, 7), roi_valid and roi_scores
    (R, M) -> (box3d (R, 7), score (R,) raw logit, random (R,)): the best
    refined box with sigmoid(score) > thresh (ties to the first), else the
    best valid RPN proposal (slot 0 when none is valid), score 0 and random."""
    r, m = cls_pred.shape
    flat = rois.reshape(r * m, 7)
    boxes = codec.decode(flat[:, 0:3], reg_pred.reshape(r * m, -1), anchor_size, RCNN_CODEC,
                         base_ry=flat[:, 6]).reshape(r, m, 7)
    ok = (torch.sigmoid(cls_pred) > score_thresh) & roi_valid
    neg = torch.full_like(cls_pred, -1e10)
    best = torch.argmax(torch.where(ok, cls_pred, neg), dim=1)
    fallback = torch.argmax(torch.where(roi_valid, roi_scores, neg), dim=1)
    any_ok = ok.any(dim=1)
    rows = torch.arange(r, device=cls_pred.device)
    box = torch.where(any_ok[:, None], boxes[rows, best], rois[rows, fallback])
    score = torch.where(any_ok, cls_pred[rows, best], torch.zeros_like(any_ok, dtype=cls_pred.dtype))
    return box, score, ~any_ok
