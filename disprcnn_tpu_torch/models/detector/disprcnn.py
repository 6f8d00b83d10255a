"""DispRCNN 2D stereo detector (counterpart of
disprcnn_tpu/models/detector/disprcnn.py; reference
modeling/detector/disprcnn.py:93-160), on a ResNet-FPN body with
FrozenBatchNorm or GroupNorm (use_gn, use_gn_fpn) or an FBNet[-<arch>]
body (the four fbnet_* settings, MODEL.FBNET.*), with or without its
mask head (mask_on) and its in-framework iDispNet (dispnet_on,
models/psmnet/dispmodule.py).

Left and right images go through one backbone pass as a doubled batch and
the stereo RPN scores every anchor. Inputs are NHWC at the public
boundary, as in the JAX package; NCHW inside.

- Eval (the default mode): the RPN proposes post_nms_top_n_test pairs per
  image, the stereo box head scores and refines them into max_det
  detections, and (mask_on) the mask head predicts 28x28 masks on the left
  view. With dispnet_on, DispModule runs on the B x max_det detections,
  each pair widened to a common width (expand_left_right_freex), and gives
  their disparity at dispnet_disp_resolution^2 ("disparity_roi").
- Train (``model.train()``, as ``engine/trainer.py`` sets it): the
  proposals at the train budgets, the SRPN loss, the GT appended to the
  proposals, ROI matching and balanced sampling per image, the sampled
  rows compacted to roi_batch_per_image a image (positives first, then
  negatives, then the rest in index order), the box head and the mask
  head on them (mask_on), and the JAX package's five losses (four without
  the mask head). With dispnet_on, train_psm and a GT disparity, DispModule
  runs in train mode on every compacted row (its batch statistics take
  them all, as Flax's), and ``loss_psm`` is its deep-supervised smooth L1
  (0.5, 0.7, 1.0) against the GT disparity warped to each widened box,
  over the pixels of the positive rows where the matched GT mask is on
  (``gt_mask_on_roi``; every pixel without GT masks) and the GT lies
  strictly inside (mindisp, maxdisp), normalized by that pixel count
  (at least 1; summed over the ranks), times dispnet_loss_weight. The box head runs its
  dropout in train mode even where the optimizer freezes it
  (SOLVER.FIX_BOX_HEAD), because the JAX package's does: its
  loss_classifier and loss_box_reg see the dropped features. Every random
  draw of a step (the two samplers' priorities, the dropout masks) is an
  input, ``Det2DDraws``, or drawn in the forward from a given generator
  (with several ranks, the global batch's draws, of which each rank keeps
  its samples' rows: parallel/mesh.py::shard_batch).
  The proposals keep the gradient of their coordinates (RoIAlign's
  sampling weights, the regression targets), as in the JAX package; only
  the NMS decision is cut. The SRPN's matcher and sampler (rpn_fg_iou,
  rpn_bg_iou, rpn_batch_per_image, rpn_positive_fraction: MODEL.RPN.*),
  the anchors' straddle threshold (straddle_thresh, RPN.STRADDLE_THRESH;
  negative: every anchor counts) and the ROI matcher and sampler
  (roi_fg_iou, roi_bg_iou, roi_positive_fraction: MODEL.ROI_HEADS.*) are
  options with the JAX names and defaults, as is the ResNet body's
  freeze_at (MODEL.BACKBONE.FREEZE_CONV_BODY_AT).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops.losses import psm_deep_supervision_loss
from ...parallel.mesh import shard_batch
from ...parallel.multihost import process_count
from ...structures.masks import _sample_bilinear_2d
from ...structures.stereo import StereoBoxes
from ..backbone.fpn import ResNetFPNBackbone
from ..psmnet.dispmodule import DispModule, expand_left_right_freex
from ..roi_heads import box_head as bh
from ..roi_heads import mask_head as mh
from ..rpn import stereo_rpn
from ..rpn.anchors import AnchorGenerator, visibility
from .disprcnn3d import _crop_grid, warp_gt_disparity_to_roi


@dataclass
class Det2DDraws:
    """The random draws of one train step of B images: uniform priorities
    of the SRPN's anchor sampler and of the ROI sampler, and the box head's
    two dropout keep masks (True keeps an entry)."""
    rpn_pos: torch.Tensor  # (B, anchors)
    rpn_neg: torch.Tensor  # (B, anchors)
    roi_pos: torch.Tensor  # (B, post_nms_top_n_train + GT slots)
    roi_neg: torch.Tensor  # (B, post_nms_top_n_train + GT slots)
    keep0: torch.Tensor  # (B * roi_batch_per_image, mlp_head_dim) bool
    keep1: torch.Tensor  # (B * roi_batch_per_image, mlp_head_dim) bool


def draw_det2d_draws(b: int, n_anchors: int, n_proposals: int, roi_batch: int, mlp_dim: int,
                     generator: torch.Generator, device=None) -> Det2DDraws:
    """One Det2DDraws from `generator` (on `device`): uniforms in [0, 1),
    and each dropout entry kept with probability 1 - bh.DROPOUT."""
    def u(*shape):
        return torch.rand(shape, generator=generator, device=device)

    return Det2DDraws(rpn_pos=u(b, n_anchors), rpn_neg=u(b, n_anchors),
                      roi_pos=u(b, n_proposals), roi_neg=u(b, n_proposals),
                      keep0=u(b * roi_batch, mlp_dim) < 1.0 - bh.DROPOUT,
                      keep1=u(b * roi_batch, mlp_dim) < 1.0 - bh.DROPOUT)


def compact_sampled(proposals: StereoBoxes, labels: torch.Tensor, reg_targets: torch.Tensor,
                    pos: torch.Tensor, sampled: torch.Tensor, matched_gt: torch.Tensor,
                    roi_batch: int) -> Tuple[StereoBoxes, Dict[str, torch.Tensor]]:
    """The first roi_batch rows of each image (B, P) in the order: sampled
    positives, sampled negatives, the rest, each in index order (a stable
    descending sort, as the JAX package's top-k orders equal priorities).
    -> (rois (B, roi_batch), {labels (-1 where not sampled), reg_targets,
    pos, sampled, matched_gt})."""
    pri = sampled.float() + pos.float()
    idx = torch.sort(pri, dim=-1, descending=True, stable=True).indices[:, :roi_batch]
    keep = torch.gather(sampled, 1, idx)
    rows = lambda x: torch.gather(x, 1, idx)
    meta = {"labels": torch.where(keep, rows(labels), torch.full_like(idx, -1)),
            "reg_targets": torch.gather(reg_targets, 1, idx[..., None].expand(-1, -1, 6)),
            "pos": rows(pos) & keep, "sampled": keep, "matched_gt": rows(matched_gt)}
    return proposals.take(idx, keep), meta


class DispRCNN(nn.Module):
    def __init__(
        self,
        body: str = "R-101",
        out_channels: int = 256,
        anchor_sizes: Sequence[int] = (32, 64, 128, 256, 512),
        anchor_strides: Sequence[int] = (4, 8, 16, 32, 64),
        aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
        pre_nms_top_n_train: int = 2000,
        pre_nms_top_n_test: int = 6000,
        post_nms_top_n_train: int = 2000,
        post_nms_top_n_test: int = 300,
        rpn_nms_thresh: float = 0.7,
        rpn_min_size: float = 0.0,
        num_classes: int = 2,
        mlp_head_dim: int = 2048,
        box_resolution: int = 7,
        box_sampling_ratio: int = 0,
        pooler_scales: Sequence[float] = (0.25, 0.125, 0.0625, 0.03125),
        roi_batch_per_image: int = 512,
        score_thresh: float = 0.05,
        box_nms_thresh: float = 0.5,
        detections_per_img: int = 100,
        max_det: int = 32,
        mask_on: bool = True,
        mask_resolution: int = 14,
        mask_sampling_ratio: int = 2,
        dispnet_on: bool = False,
        dispnet_maxdisp: int = 48,
        dispnet_mindisp: int = -48,
        dispnet_resolution: int = 28,
        dispnet_disp_resolution: int = 112,
        dispnet_conv_layers: Sequence[int] = (256,),
        dispnet_loss_weight: float = 1.0,
        use_gn: bool = False,  # MODEL.BACKBONE.USE_GN
        use_gn_fpn: bool = False,  # MODEL.FPN.USE_GN
        srpn_quirk_exact: bool = False,  # TPU.SRPN_QUIRK_EXACT
        fbnet_scale_factor: float = 1.0,  # MODEL.FBNET.SCALE_FACTOR
        fbnet_width_divisor: int = 1,  # MODEL.FBNET.WIDTH_DIVISOR
        fbnet_dw_skip_bn: bool = True,  # MODEL.FBNET.DW_CONV_SKIP_BN
        fbnet_dw_skip_relu: bool = True,  # MODEL.FBNET.DW_CONV_SKIP_RELU
        freeze_at: int = 2,  # MODEL.BACKBONE.FREEZE_CONV_BODY_AT
        straddle_thresh: float = 0.0,  # MODEL.RPN.STRADDLE_THRESH
        rpn_fg_iou: float = 0.7,  # MODEL.RPN.FG_IOU_THRESHOLD
        rpn_bg_iou: float = 0.3,  # MODEL.RPN.BG_IOU_THRESHOLD
        rpn_batch_per_image: int = 256,  # MODEL.RPN.BATCH_SIZE_PER_IMAGE
        rpn_positive_fraction: float = 0.5,  # MODEL.RPN.POSITIVE_FRACTION
        roi_positive_fraction: float = 0.25,  # MODEL.ROI_HEADS.POSITIVE_FRACTION
        roi_fg_iou: float = 0.5,  # MODEL.ROI_HEADS.FG_IOU_THRESHOLD
        roi_bg_iou: float = 0.5,  # MODEL.ROI_HEADS.BG_IOU_THRESHOLD
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        self.straddle_thresh = straddle_thresh
        self.rpn_fg_iou, self.rpn_bg_iou = rpn_fg_iou, rpn_bg_iou
        self.rpn_batch_per_image, self.rpn_positive_fraction = rpn_batch_per_image, \
            rpn_positive_fraction
        self.roi_fg_iou, self.roi_bg_iou = roi_fg_iou, roi_bg_iou
        self.roi_positive_fraction = roi_positive_fraction
        self.mask_on, self.dispnet_on = mask_on, dispnet_on
        self.dispnet_maxdisp, self.dispnet_mindisp = dispnet_maxdisp, dispnet_mindisp
        self.dispnet_loss_weight = dispnet_loss_weight
        self.anchor_gen = AnchorGenerator(anchor_sizes, anchor_strides, aspect_ratios)
        # anchors on the card, per (feature sizes, device): a fixed input
        # geometry builds and copies them once
        self._anchors: Dict[tuple, torch.Tensor] = {}
        self.pre_nms_top_n_train, self.pre_nms_top_n_test = pre_nms_top_n_train, pre_nms_top_n_test
        self.post_nms_top_n_train = post_nms_top_n_train
        self.post_nms_top_n_test = post_nms_top_n_test
        self.rpn_nms_thresh = rpn_nms_thresh
        self.rpn_min_size = rpn_min_size
        self.mlp_head_dim = mlp_head_dim
        self.roi_batch_per_image = roi_batch_per_image
        self.score_thresh = score_thresh
        self.box_nms_thresh = box_nms_thresh
        self.detections_per_img = detections_per_img
        self.max_det = max_det
        self.srpn_quirk_exact = srpn_quirk_exact
        with torch.device(device):
            self.backbone = ResNetFPNBackbone(
                body=body, out_channels=out_channels, use_gn_body=use_gn, use_gn_fpn=use_gn_fpn,
                fbnet_scale_factor=fbnet_scale_factor, fbnet_width_divisor=fbnet_width_divisor,
                fbnet_dw_skip_bn=fbnet_dw_skip_bn, fbnet_dw_skip_relu=fbnet_dw_skip_relu,
                freeze_at=freeze_at)
            self.rpn_head = stereo_rpn.SRPNHead(
                out_channels, self.anchor_gen.num_anchors_per_location, srpn_quirk_exact)
            self.box_extractor = bh.StereoBoxFeatureExtractor(
                out_channels, mlp_head_dim, box_resolution, pooler_scales, box_sampling_ratio)
            self.box_predictor = bh.StereoBoxPredictor(mlp_head_dim, num_classes)
            if mask_on:
                self.mask_head = mh.MaskHead(
                    out_channels, num_classes, resolution=mask_resolution,
                    scales=pooler_scales, sampling_ratio=mask_sampling_ratio)
            if dispnet_on:
                self.dispnet = DispModule(
                    out_channels, dispnet_maxdisp, dispnet_mindisp, dispnet_resolution,
                    dispnet_disp_resolution, pooler_scales, dispnet_conv_layers)
        self.eval()  # train mode only on request, as the JAX module defaults to train=False

    @property
    def device(self) -> torch.device:
        return self.rpn_head.conv.weight.device

    def anchors(self, feature_hws: Sequence[tuple], device: torch.device) -> torch.Tensor:
        """The anchors (N, 4) on `device`."""
        key = (tuple(feature_hws), device)
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(self.anchor_gen(feature_hws)).to(device)
        return self._anchors[key]

    def forward(self, left: torch.Tensor, right: torch.Tensor,
                gt_left: Optional[torch.Tensor] = None, gt_right: Optional[torch.Tensor] = None,
                gt_labels: Optional[torch.Tensor] = None,
                gt_valid: Optional[torch.Tensor] = None,
                gt_masks: Optional[torch.Tensor] = None,
                draws: Optional[Det2DDraws] = None,
                generator: Optional[torch.Generator] = None, train_psm: bool = False,
                gt_disp: Optional[torch.Tensor] = None) -> Dict[str, object]:
        """left, right (B, H, W, 3) normalized images.

        Eval -> {"detections": StereoBoxes (B, max_det) with 'labels',
        "masks": (B, max_det, 28, 28) (mask_on), "disparity_roi": (B,
        max_det, R, R) at R = dispnet_disp_resolution (dispnet_on)}.

        Train, with the GT padded to M slots a image (gt_left, gt_right
        (B, M, 4), gt_labels (B, M) int, gt_valid (B, M) bool, gt_masks
        (B, M, H, W)) and the step's `draws` (or a `generator` on the
        model's device to draw them from) -> {"loss_objectness",
        "loss_rpn_box_reg", "loss_classifier", "loss_box_reg", "loss_mask",
        "proposals": StereoBoxes (B, post_nms_top_n_train + M) with the GT
        appended, "roi_pos": (B, post_nms_top_n_train + M) bool, the
        sampled positives among them}; without the mask head no
        "loss_mask"; with dispnet_on, train_psm (SOLVER.TRAIN_PSM) and
        gt_disp (B, H, W) also "loss_psm"."""
        b, img_h, img_w, _ = left.shape
        feats = self.backbone(torch.cat([left, right], dim=0).permute(0, 3, 1, 2).contiguous())
        lf = [f[:b] for f in feats]
        rf = [f[b:] for f in feats]
        hws = [tuple(f.shape[-2:]) for f in feats]
        obj_logits, deltas = stereo_rpn.flatten_levels(self.rpn_head(feats))
        if self.training:
            return self._train_forward(lf, rf, hws, obj_logits, deltas, (img_h, img_w), gt_left,
                                       gt_right, gt_labels, gt_valid, gt_masks, draws, generator,
                                       gt_disp if train_psm and self.dispnet_on else None)

        anchors = self.anchors(hws, left.device)
        rois = stereo_rpn.postprocess_batched(
            anchors, obj_logits, deltas, (img_h, img_w), self.pre_nms_top_n_test,
            self.post_nms_top_n_test, self.rpn_nms_thresh, self.rpn_min_size,
            scores_are_probs=self.srpn_quirk_exact,
        )
        p = rois.left.shape[1]
        batch_idx = torch.arange(b, device=left.device).repeat_interleave(p)
        x = self.box_extractor(lf[:-1], rf[:-1], rois.left.reshape(b * p, 4),
                               rois.right.reshape(b * p, 4), batch_idx)
        class_logits, box_deltas = self.box_predictor(x)
        dets = bh.postprocess_batched(
            class_logits.reshape(b, p, -1), box_deltas.reshape(b, p, -1), rois,
            (img_h, img_w), self.score_thresh, self.box_nms_thresh,
            self.detections_per_img, self.max_det,
        )
        d = self.max_det
        det_batch_idx = torch.arange(b, device=left.device).repeat_interleave(d)
        out = {"detections": dets}
        if self.mask_on:
            logits = self.mask_head(lf[:-1], dets.left.reshape(b * d, 4), det_batch_idx)
            probs = mh.mask_probs(logits, dets.fields["labels"].reshape(b * d))
            out["masks"] = probs.reshape(b, d, *probs.shape[1:])
        if self.dispnet_on:
            lb, rb = expand_left_right_freex(dets.left.reshape(b * d, 4),
                                             dets.right.reshape(b * d, 4), float(img_w))
            disp = self.dispnet(lf[:-1], rf[:-1], lb, rb, det_batch_idx)
            out["disparity_roi"] = disp.reshape(b, d, *disp.shape[1:])
        return out

    def _train_forward(self, lf, rf, hws, obj_logits, deltas, image_hw, gt_left, gt_right,
                       gt_labels, gt_valid, gt_masks, draws, generator,
                       gt_disp) -> Dict[str, object]:
        needs = {"gt_left": gt_left, "gt_right": gt_right, "gt_labels": gt_labels,
                 "gt_valid": gt_valid}
        if self.mask_on:
            needs["gt_masks"] = gt_masks
        if any(x is None for x in needs.values()):
            raise ValueError(f"the 2D train step needs {', '.join(needs)}")
        (b, n_anchors), dev, m = obj_logits.shape[:2], obj_logits.device, gt_left.shape[1]
        if draws is None:
            if generator is None:
                raise ValueError("the 2D train step needs draws or a generator")
            # the global batch's draws, of which this rank keeps its samples' rows
            gb = b * process_count()
            draws = shard_batch(draw_det2d_draws(gb, n_anchors, self.post_nms_top_n_train + m,
                                                 self.roi_batch_per_image, self.mlp_head_dim,
                                                 generator, dev), gb)
        anchors = self.anchors(hws, dev)
        if draws.rpn_pos.shape != obj_logits.shape[:2]:
            raise ValueError(f"SRPN priorities {tuple(draws.rpn_pos.shape)} for "
                             f"{tuple(obj_logits.shape[:2])} anchors")
        props = stereo_rpn.postprocess_batched(
            anchors, obj_logits, deltas, image_hw, self.pre_nms_top_n_train,
            self.post_nms_top_n_train, self.rpn_nms_thresh, self.rpn_min_size,
            scores_are_probs=self.srpn_quirk_exact,
        )
        out = {}
        out["loss_objectness"], out["loss_rpn_box_reg"] = stereo_rpn.loss(
            anchors, visibility(anchors, image_hw, self.straddle_thresh), obj_logits, deltas,
            gt_left, gt_right, gt_valid, draws.rpn_pos, draws.rpn_neg, self.rpn_fg_iou,
            self.rpn_bg_iou, self.rpn_batch_per_image, self.rpn_positive_fraction)
        # the GT appended to the proposals (SRPNPostProcessor.add_gt_proposals)
        proposals = StereoBoxes(
            left=torch.cat([props.left, gt_left], 1), right=torch.cat([props.right, gt_right], 1),
            score=torch.cat([props.score, torch.ones_like(gt_valid, dtype=props.score.dtype)], 1),
            valid=torch.cat([props.valid, gt_valid], 1))
        labels, reg_targets, pos, sampled, matched_gt = bh.subsample(
            proposals, gt_left, gt_right, gt_labels, gt_valid, draws.roi_pos, draws.roi_neg,
            self.roi_fg_iou, self.roi_bg_iou, self.roi_batch_per_image,
            self.roi_positive_fraction)
        rois, meta = compact_sampled(proposals, labels, reg_targets, pos, sampled, matched_gt,
                                     self.roi_batch_per_image)
        p = self.roi_batch_per_image
        flat = lambda x: x.reshape(b * p, *x.shape[2:])
        batch_idx = torch.arange(b, device=dev).repeat_interleave(p)
        left_rois = flat(rois.left)
        x = self.box_extractor(lf[:-1], rf[:-1], left_rois, flat(rois.right), batch_idx,
                               keep=(draws.keep0, draws.keep1))
        class_logits, box_deltas = self.box_predictor(x)
        labels_f, pos_f = flat(meta["labels"]), flat(meta["pos"])
        out["loss_classifier"], out["loss_box_reg"] = bh.head_loss(
            class_logits, box_deltas, labels_f, flat(meta["reg_targets"]), pos_f,
            flat(meta["sampled"]))
        if self.mask_on:
            mask_logits = self.mask_head(lf[:-1], left_rois, batch_idx)
            # each image's GT masks are rows [i * m, (i + 1) * m)
            out["loss_mask"] = mh.mask_loss(
                mask_logits, left_rois, labels_f, pos_f,
                gt_masks.reshape(-1, *gt_masks.shape[2:]),
                flat(meta["matched_gt"]) + batch_idx * m)
        if gt_disp is not None:
            out["loss_psm"] = self._psm_loss(lf, rf, left_rois, flat(rois.right), batch_idx,
                                             pos_f, flat(meta["matched_gt"]), gt_disp, gt_masks,
                                             float(image_hw[1]))
        out["proposals"], out["roi_pos"] = proposals, pos
        return out

    def _psm_loss(self, lf, rf, left_rois, right_rois, batch_idx, pos_f, matched_gt, gt_disp,
                  gt_masks, img_w: float) -> torch.Tensor:
        """DispModule in train mode on every row, and its masked,
        deep-supervised smooth L1 (disprcnn.py:219-258 of the JAX package)."""
        dlb, drb = expand_left_right_freex(left_rois, right_rois, img_w)
        size = self.dispnet.disp_resolution
        preds = self.dispnet(lf[:-1], rf[:-1], dlb, drb, batch_idx)
        tgt = warp_gt_disparity_to_roi(gt_disp, dlb, drb, size, which=batch_idx)
        if gt_masks is not None:
            gmask = gt_mask_on_roi(gt_masks, matched_gt, batch_idx, dlb, size)
        else:
            gmask = torch.ones_like(tgt, dtype=torch.bool)
        m = (gmask & (tgt > self.dispnet_mindisp) & (tgt < self.dispnet_maxdisp)
             & pos_f[:, None, None])
        return self.dispnet_loss_weight * psm_deep_supervision_loss(preds, tgt, m)


def gt_mask_on_roi(gt_masks: torch.Tensor, matched_gt: torch.Tensor, batch_idx: torch.Tensor,
                   boxes: torch.Tensor, size: int) -> torch.Tensor:
    """Each ROI's matched GT instance mask sampled on the ROI's size x size
    pixel grid (DispModule.prepare_target's mask warping; the JAX package's
    ``_gt_mask_on_roi``): gt_masks (B, M, H, W), matched_gt (R,) (clipped
    to [0, M - 1]), batch_idx (R,), boxes (R, 4) -> (R, size, size) bool,
    the bilinear sample above 0.5. Only each sample's four taps are read
    (no per-ROI copy of a full mask)."""
    b, m = gt_masks.shape[:2]
    which = batch_idx.long() * m + matched_gt.long().clamp(0, m - 1)
    gy = _crop_grid(boxes[:, 1:2], boxes[:, 3:4] - boxes[:, 1:2], size)
    gx = _crop_grid(boxes[:, 0:1], boxes[:, 2:3] - boxes[:, 0:1], size)
    gy, gx = torch.broadcast_tensors(gy[:, :, None], gx[:, None, :])
    flat = gt_masks.reshape(b * m, *gt_masks.shape[2:]).float()
    return _sample_bilinear_2d(flat, which, gy, gx) > 0.5
