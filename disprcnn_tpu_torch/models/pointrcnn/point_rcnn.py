"""The PointRCNN 3D stage: 3D RPN -> proposals -> RoI-pool 3D -> RCNN ->
one box per instance (counterpart of disprcnn_tpu/models/pointrcnn/
point_rcnn.py; reference lib/net/point_rcnn.py). The proposals are
score-based (``rpn3d.propose``) or, with rpn_distance_based
(TEST.RPN_DISTANCE_BASED_PROPOSE), distance-based
(``rpn3d.distance_propose``), over the axis-aligned BEV NMS or, with
rpn_nms_rotated (RPN.NMS_TYPE "rotate"), the rotated one, in eval and in
the RCNN's train step alike. Each 2D detection is one fixed-size
canonical cloud on the instance axis. With rcnn_enabled=False (RCNN.ENABLED,
rpn.yaml) there is no RCNN: eval returns the RPN's per-point scores
``rpn_cls``.

Train mode (point_rcnn.py:74-135) trains by rpn_fixed (RPN.FIXED) and
rcnn_enabled (RCNN.ENABLED), JAX's names and defaults:
- the RPN alone (rcnn_enabled=False: stage 3, rpn.yaml): the RPN in train
  mode (batch-statistics BN, the heads' dropout on the ``RPNDraws``
  masks), the matched GT moved into each cloud's canonical frame, the
  per-point labels (``lift.rpn_point_labels``), and the losses
  ``loss_rpn_cls`` and ``loss_rpn_reg`` over the instances that are valid
  and matched;
- the RCNN on a fixed RPN (rpn_fixed=True: stage 4, rcnn.yaml): the RPN
  runs in eval without gradients, with the TRAIN proposal budgets and
  NMS threshold; the proposal target layer (``rcnn_targets``) samples,
  noises, pools and augments the RCNN's inputs, also without gradients;
  then the RCNN runs with gradients and the step's loss is ``loss_box3d``;
- both in one step (rpn_fixed=False with the RCNN, JAX's default;
  ``joint_train_loss``): the RPN in train mode and its two losses as
  above, the TRAIN proposals from that train-mode output, the proposal
  target layer and the RCNN, and ``loss_box3d`` beside the RPN's losses.
  Gradients flow where the JAX package's jax.grad sends them (ROADMAP
  C36): loss_box3d reaches the RPN through the pooled RPN features (row
  14's train form on the card) and through the proposal boxes (decoded
  from the RPN's regression; the sampling, noise, augmentation and
  canonical transform are differentiable in them), but not through the
  top-k, NMS, IoU or in-box decisions, nor the segmentation mask. The
  reference runs this under torch.no_grad().
rpn_fixed with no RCNN has nothing to train and raises in train mode.

The compute dtype (``dtype``, TPU.COMPUTE_DTYPE): float32, or bfloat16 as
the JAX package's ``PointRCNN(dtype=jnp.bfloat16)`` computes, in eval and
in train mode (ROADMAP A8.3, A8.4). In bf16 the anchor is
the mean size rounded to bf16 (point_rcnn.py:69: for the car (1.5234375,
1.625, 3.890625)), the RPN and the RCNN compute in bf16 (pointnet2.py,
rpn3d.py and rcnn3d.py), the segmentation mask is jax.nn.sigmoid's bf16
arithmetic on the bf16 scores compared with the threshold in bf16
(point_rcnn.py:113), and box3d comes out float32, score3d bf16, random
bool, as JAX's do. The clouds, the proposals' boxes and the lift stay
float32. In train mode the losses are computed where and at the dtype JAX
computes them (rpn3d.rpn_loss, rcnn3d.rcnn_loss: bf16 head outputs, their
sums rounded to bf16, the integer counts widened to float32), the RCNN's
BN-free scales take row 11's bf16 train form and the joint step's pooling
row 14's (pointnet2.py, rcnn3d.py).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from . import bbox3d_codec as codec
from . import lift, rcnn3d, rpn3d
from ...ops.losses import sigmoid
from .pointnet2 import BF16, SA_MIN_C0

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
                 sa_min_c0: int = SA_MIN_C0, kernels_off=frozenset(),
                 roi_block: int = ROI_BLOCK, proposals_per_roi_train: Optional[int] = None,
                 rpn_pre_nms_per_roi_train: Optional[int] = None,
                 rcnn_rois_per_instance: int = 16, rcnn_enabled: bool = True,
                 rpn_nms_rotated: bool = False, rpn_distance_based: bool = False,
                 rpn_loss_cls: str = "BinaryCrossEntropy", rpn_fixed: bool = False,
                 rcnn_loss_cls: str = "BinaryCrossEntropy", aug_data: bool = True,
                 fg_aug_times: int = rcnn3d.FG_AUG_TIMES,
                 aug_rot_range: float = rcnn3d.AUG_ROT_RANGE,
                 rpn_nms_thresh_train: Optional[float] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.rpn_nms_rotated, self.rpn_distance_based = rpn_nms_rotated, rpn_distance_based
        if rpn_loss_cls not in rpn3d.RPN_LOSS_CLS:
            raise ValueError(f"rpn_loss_cls {rpn_loss_cls!r}: one of {rpn3d.RPN_LOSS_CLS}")
        if rcnn_loss_cls not in rcnn3d.RCNN_LOSS_CLS:
            raise ValueError(f"rcnn_loss_cls {rcnn_loss_cls!r}: one of {rcnn3d.RCNN_LOSS_CLS}")
        self.rpn_loss_cls, self.rcnn_loss_cls = rpn_loss_cls, rcnn_loss_cls
        self.rpn_fixed = rpn_fixed
        # the proposal target layer's augmentation (AUG_DATA, RCNN.ROI_FG_AUG_TIMES,
        # AUG_ROT_RANGE)
        self.aug_data, self.fg_aug_times, self.aug_rot_range = aug_data, fg_aug_times, \
            aug_rot_range
        self.npoints = npoints
        self.rcnn_enabled = rcnn_enabled
        self.register_buffer("anchor", torch.tensor(mean_size, dtype=torch.float32).to(dtype),
                             persistent=False)
        self.rpn_codec = rpn_codec
        self.rpn_score_thresh = rpn_score_thresh
        self.proposals_per_roi = proposals_per_roi
        self.rpn_pre_nms_per_roi = rpn_pre_nms_per_roi
        self.rpn_nms_thresh = rpn_nms_thresh
        self.rcnn_num_points = rcnn_num_points
        self.rcnn_score_thresh = rcnn_score_thresh
        self.roi_block = roi_block
        # TRAIN budgets (proposal_layer.py:19-24); None takes the eval value
        self.proposals_per_roi_train = proposals_per_roi_train
        self.rpn_pre_nms_per_roi_train = rpn_pre_nms_per_roi_train
        self.rpn_nms_thresh_train = rpn_nms_thresh_train
        self.rcnn_rois_per_instance = rcnn_rois_per_instance
        self.rpn = rpn3d.RPN3D(codec_cfg=rpn_codec, use_bn=rpn_use_bn, npoints=sa_npoints,
                               sa_min_c0=sa_min_c0, kernels_off=kernels_off, dtype=dtype)
        if rcnn_enabled:
            self.rcnn = rcnn3d.RCNNNet(rpn_channels=self.rpn.backbone.out_channels,
                                       sa_min_c0=sa_min_c0, kernels_off=kernels_off, dtype=dtype)
        self.eval()  # train mode only on request (model.train())

    def forward(self, pts: torch.Tensor, roi_valid: torch.Tensor, angles: torch.Tensor,
                pts_mean: torch.Tensor, gt_boxes3d: Optional[torch.Tensor] = None,
                gt_ok: Optional[torch.Tensor] = None,
                draws: Optional[rcnn3d.RCNNDraws] = None,
                rpn_draws: Optional[rpn3d.RPNDraws] = None) -> Dict[str, torch.Tensor]:
        """pts (R, N, 3) canonical clouds, roi_valid (R,), angles (R,),
        pts_mean (R, 3) -> box3d (R, 7), score3d (R,), random (R,), or with
        the RCNN disabled rpn_cls (R, N). In train mode, with the matched GT
        gt_boxes3d (R, 7) rect frame and gt_ok (R,): with the RCNN the
        proposal target layer's draws -> loss_box3d; where the RPN trains
        (not rpn_fixed) the RPN's dropout masks rpn_draws -> loss_rpn_cls,
        loss_rpn_reg."""
        train = self.training
        self.rpn.train(train and not self.rpn_fixed)
        if train:
            if gt_boxes3d is None or gt_ok is None:
                raise ValueError("training needs gt_boxes3d and gt_ok")
            if not self.rcnn_enabled:
                if self.rpn_fixed:
                    raise ValueError("rpn_fixed without an RCNN: there is nothing to train")
                return self.rpn_train_loss(pts, roi_valid, angles, pts_mean, gt_boxes3d, gt_ok,
                                           rpn_draws)
            if not self.rpn_fixed:
                return self.joint_train_loss(pts, roi_valid, angles, pts_mean, gt_boxes3d, gt_ok,
                                             draws, rpn_draws)
            targets = self.rcnn_targets(pts, roi_valid, angles, pts_mean, gt_boxes3d, gt_ok,
                                        draws)
            return {"loss_box3d": self.rcnn_train_loss(targets)}
        rpn_out = self.rpn(pts)
        if not self.rcnn_enabled:
            return {"rpn_cls": rpn_out["cls"]}
        rois_c, roi_scores, prop_valid = self.propose(
            rpn_out, pre_nms_top_n=min(self.rpn_pre_nms_per_roi, pts.shape[1]),
            post_nms_top_n=self.proposals_per_roi, nms_thresh=self.rpn_nms_thresh)
        r, k = rois_c.shape[:2]
        rois = _decanon_rois(rois_c, angles, pts_mean)
        prop_valid = prop_valid & roi_valid[:, None]
        xyz_rect = lift.decanonicalize(rpn_out["xyz"], angles, pts_mean)
        cls = rpn_out["cls"]
        seg_mask = (sigmoid(cls) > self.rpn_score_thresh).to(cls.dtype)
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

    def propose(self, rpn_out: Dict[str, torch.Tensor], pre_nms_top_n: int,
                post_nms_top_n: int, nms_thresh: float):
        """The proposal layer of the model's options on the RPN's output."""
        fn = rpn3d.distance_propose if self.rpn_distance_based else rpn3d.propose
        return fn(rpn_out["cls"], rpn_out["reg"], rpn_out["xyz"], self.anchor, self.rpn_codec,
                  pre_nms_top_n=pre_nms_top_n, post_nms_top_n=post_nms_top_n,
                  nms_thresh=nms_thresh, rotated=self.rpn_nms_rotated)

    def rpn_train_loss(self, pts, roi_valid, angles, pts_mean, gt_boxes3d, gt_ok,
                       rpn_draws, rpn_out=None) -> Dict[str, torch.Tensor]:
        """The RPN in train mode on the clouds (or its output rpn_out), the
        per-point labels of the matched GT in the canonical frame, and the
        RPN loss over the valid, matched instances (point_rcnn.py:74-88)."""
        if rpn_out is None:
            rpn_out = self.rpn(pts, rpn_draws)
        gt_canon = lift.canonicalize_boxes3d(gt_boxes3d, angles, pts_mean)
        cls_label, reg_label = lift.rpn_point_labels(pts, gt_canon, gt_ok)
        return rpn3d.rpn_loss(rpn_out["cls"], rpn_out["reg"], cls_label, reg_label,
                              roi_valid & gt_ok, self.anchor, self.rpn_codec,
                              loss_cls=self.rpn_loss_cls)

    def _targets(self, rpn_out, pts, roi_valid, angles, pts_mean, gt_boxes3d, gt_ok, draws):
        """The TRAIN proposals of an RPN output, then the proposal target
        layer (point_rcnn.py:90-125). -> {pts_input (R * K, P, 5 + C),
        cls_label, reg_mask (R * K,), gt_ct (R * K, 7)}."""
        if draws is None:
            raise ValueError("training the RCNN needs its draws")
        rois_c, _, prop_valid = self.propose(
            rpn_out, pre_nms_top_n=min(self.rpn_pre_nms_per_roi_train or self.rpn_pre_nms_per_roi,
                                       pts.shape[1]),
            post_nms_top_n=self.proposals_per_roi_train or self.proposals_per_roi,
            nms_thresh=self.rpn_nms_thresh_train or self.rpn_nms_thresh)
        rois = _decanon_rois(rois_c, angles, pts_mean)
        xyz_rect = lift.decanonicalize(rpn_out["xyz"], angles, pts_mean)
        seg_mask = (sigmoid(rpn_out["cls"]) > self.rpn_score_thresh).to(rpn_out["cls"].dtype)
        pts_input, cls_label, reg_mask, gt_ct, _, _ = rcnn3d.prepare_rcnn_train_inputs(
            rois, prop_valid & roi_valid[:, None], gt_boxes3d, gt_ok & roi_valid, xyz_rect,
            rpn_out["features"], seg_mask, draws,
            rois_per_instance=self.rcnn_rois_per_instance, num_points=self.rcnn_num_points,
            aug_data=self.aug_data, fg_aug_times=self.fg_aug_times,
            aug_rot_range=self.aug_rot_range)
        n = cls_label.numel()
        return {"pts_input": pts_input.reshape(n, self.rcnn_num_points, -1),
                "cls_label": cls_label.reshape(n), "reg_mask": reg_mask.reshape(n),
                "gt_ct": gt_ct.reshape(n, 7)}

    def rcnn_targets(self, pts, roi_valid, angles, pts_mean, gt_boxes3d, gt_ok, draws):
        """The frozen part of an RCNN train step on a fixed RPN, without
        gradients: the RPN in eval (RPN.FIXED), then ``_targets``."""
        with torch.no_grad():
            return self._targets(self.rpn(pts), pts, roi_valid, angles, pts_mean, gt_boxes3d,
                                 gt_ok, draws)

    def joint_train_loss(self, pts, roi_valid, angles, pts_mean, gt_boxes3d, gt_ok, draws,
                         rpn_draws) -> Dict[str, torch.Tensor]:
        """The RPN and the RCNN trained in one step (RPN.FIXED False,
        point_rcnn.py:74-135): the train-mode RPN's losses, the proposal
        target layer on its output, and the RCNN's loss, with gradients
        through all of it."""
        rpn_out = self.rpn(pts, rpn_draws)
        out = self.rpn_train_loss(pts, roi_valid, angles, pts_mean, gt_boxes3d, gt_ok, None,
                                  rpn_out)
        targets = self._targets(rpn_out, pts, roi_valid, angles, pts_mean, gt_boxes3d, gt_ok,
                                draws)
        out["loss_box3d"] = self.rcnn_train_loss(targets)
        return out

    def rcnn_train_loss(self, targets: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The RCNN on the targets' pooled inputs, with gradients, and its loss."""
        cls_pred, reg_pred = self.rcnn(targets["pts_input"])
        return rcnn3d.rcnn_loss(cls_pred, reg_pred, targets["cls_label"], targets["reg_mask"],
                                targets["gt_ct"], self.anchor, loss_cls=self.rcnn_loss_cls)


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
