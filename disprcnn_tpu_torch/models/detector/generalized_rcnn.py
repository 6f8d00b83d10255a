"""The mono (single-view) GeneralizedRCNN (counterpart of
disprcnn_tpu/models/detector/generalized_rcnn.py; reference
modeling/detector/generalized_rcnn.py): backbone -> RPN -> box head (+ the
FPN mask head) on one view, MODEL.META_ARCHITECTURE "GeneralizedRCNN" with
MODEL.STEREO_ON False.

Bodies: R-x-C4 and R-x-C5 (one map, at stride 16 or 32, every anchor size
at that stride; the box head pools 14x14 on it and runs res5 on the ROIs,
``C4BoxHead``), or R-x-FPN / FBNet (``MonoBoxHead``: two FC layers over 7x7
pooled from P2-P5).

- Eval (the default mode): the RPN's post_nms_top_n_test proposals an
  image, the box head, softmax, decode with weights (10, 10, 5, 5), clip,
  score > score_thresh on valid proposals, greedy NMS per class to max_det,
  then one top-k of every class's survivors to max_det; with mask_on (FPN
  bodies only: a C4/C5 body raises there, as the JAX package does) the
  mask head's probabilities of each detection's label. The per-class NMS
  is one launch of row 1 over the B x (C - 1) class rows (each row's
  survivors are independent, so this is the JAX package's loop of C - 1
  calls).
- Train (``model.train()``): the proposals at the train budgets, the RPN
  loss, the proposals matched to the GT (0.5/0.5, no low-quality
  recovery) and sampled (roi_batch_per_image at 0.25 on given priorities),
  the box head on every proposal, and loss_classifier / loss_box_reg
  (smooth-L1, beta 1, on the matched class's 4 deltas) over the sampled
  rows, each divided by their count. The JAX package computes no mask loss
  here: neither does the port (the mask head gets no gradient). The
  draws are ``MonoDraws`` or come from a ``generator``; the proposals keep
  the gradient of their coordinates.

Input images are NHWC at the public boundary, as in the JAX package. The
body's freeze_at (MODEL.BACKBONE.FREEZE_CONV_BODY_AT, default 2) is
models/backbone/resnet.py's; the RPN's and the ROI
sampler's thresholds and sizes are the defaults of rpn.loss and of
``_subsample`` here, the RPN's min size 0, as the JAX model fixes them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.iou import pairwise_iou
from ...ops.losses import smooth_l1
from ...ops.nms import nms_topk_batched
from ...ops.roi_align import roi_align_batched
from ...ops.topk_select import topk_scores
from ...structures.boxes import Boxes2D
from ..backbone.fpn import ResNetFPNBackbone
from ..backbone.resnet import ResNet, Stage5Head
from ..roi_heads import mask_head as mh
from ..roi_heads.pooler import fpn_roi_align
from ..rpn import box_coder, rpn
from ..rpn.anchors import AnchorGenerator, visibility
from ..rpn.matcher import balanced_sample, match

_W10 = (10.0, 10.0, 5.0, 5.0)
# ROIs pooled at once by the C4 box head: its bilinear taps hold (ROIs, 28,
# 28, C) floats each, 1.6 GB a tap at 512 ROIs of the C4 map's 1024 channels
C4_POOL_CHUNK = 512


@dataclass
class MonoDraws:
    """The random draws of one train step of B images: uniform priorities
    of the RPN's anchor sampler and of the ROI sampler."""
    rpn_pos: torch.Tensor  # (B, anchors)
    rpn_neg: torch.Tensor  # (B, anchors)
    roi_pos: torch.Tensor  # (B, proposals)
    roi_neg: torch.Tensor  # (B, proposals)


def draw_mono_draws(b: int, n_anchors: int, n_proposals: int, generator: torch.Generator,
                    device=None) -> MonoDraws:
    u = lambda n: torch.rand((b, n), generator=generator, device=device)
    return MonoDraws(u(n_anchors), u(n_anchors), u(n_proposals), u(n_proposals))


class MonoBoxHead(nn.Module):
    """FPN2MLPFeatureExtractor + FPNPredictor: 7x7 from P2-P5, fc6, fc7,
    linear class scores and per-class 4-parameter deltas. The pooled map
    flattens in Flax's (H, W, C) order."""

    def __init__(self, in_channels: int, num_classes: int = 81, mlp_dim: int = 1024,
                 resolution: int = 7,
                 scales: Sequence[float] = (0.25, 0.125, 0.0625, 0.03125),
                 sampling_ratio: int = 0):
        super().__init__()
        self.resolution, self.scales, self.sampling_ratio = resolution, tuple(scales), \
            sampling_ratio
        self.fc6 = nn.Linear(in_channels * resolution * resolution, mlp_dim)
        self.fc7 = nn.Linear(mlp_dim, mlp_dim)
        self.cls_score = nn.Linear(mlp_dim, num_classes)
        self.bbox_pred = nn.Linear(mlp_dim, num_classes * 4)

    def forward(self, feats, boxes: torch.Tensor, batch_idx: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = fpn_roi_align(feats, boxes, batch_idx, self.scales, self.resolution,
                          self.sampling_ratio)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.fc7(F.relu(self.fc6(x))))
        return self.cls_score(x), self.bbox_pred(x)


class C4BoxHead(nn.Module):
    """ResNet50Conv5ROIFeatureExtractor + FastRCNNPredictor: 14x14 ROIAlign on
    the single map, res5 (``head``, stride 2 -> 7x7x2048), the spatial mean,
    linear class scores and deltas."""

    def __init__(self, body: str = "R-50", in_channels: int = 1024, num_classes: int = 81,
                 resolution: int = 14, scale: float = 1.0 / 16.0, sampling_ratio: int = 0,
                 use_gn: bool = False):
        super().__init__()
        self.resolution, self.scale, self.sampling_ratio = resolution, scale, sampling_ratio
        self.head = Stage5Head(body, in_channels, use_gn=use_gn)
        self.cls_score = nn.Linear(2048, num_classes)
        self.bbox_pred = nn.Linear(2048, num_classes * 4)

    def forward(self, feat: torch.Tensor, boxes: torch.Tensor, batch_idx: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.cat([
            roi_align_batched(feat, boxes[i:i + C4_POOL_CHUNK], batch_idx[i:i + C4_POOL_CHUNK],
                              self.resolution, spatial_scale=self.scale,
                              sampling_ratio=self.sampling_ratio)
            for i in range(0, boxes.shape[0], C4_POOL_CHUNK)])
        x = self.head(x).mean(dim=(2, 3))
        return self.cls_score(x), self.bbox_pred(x)


def _subsample(proposals: Boxes2D, gt: torch.Tensor, gt_labels: torch.Tensor,
               gt_valid: torch.Tensor, pos_priorities: torch.Tensor,
               neg_priorities: torch.Tensor, batch_size: int = 512,
               positive_fraction: float = 0.25, fg_iou: float = 0.5, bg_iou: float = 0.5):
    """Match the (B, P) proposals to the GT and sample them -> (labels,
    reg_targets (B, P, 4), pos, sampled)."""
    quality = pairwise_iou(gt, proposals.xyxy) * proposals.valid[:, None, :]
    m = match(quality, gt_valid, fg_iou, bg_iou, allow_low_quality=False)
    mi = m.clamp_min(0)
    labels = torch.where(m >= 0, torch.gather(gt_labels.long(), 1, mi),
                         torch.where(m == -1, torch.zeros_like(m), torch.full_like(m, -1)))
    labels = torch.where(proposals.valid, labels, torch.full_like(labels, -1))
    matched = torch.gather(gt, 1, mi[..., None].expand(-1, -1, 4))
    reg_targets = box_coder.encode4(matched, proposals.xyxy, weights=_W10)
    pos, neg = balanced_sample(labels, batch_size, positive_fraction, pos_priorities,
                               neg_priorities)
    return labels, reg_targets, pos, pos | neg


class GeneralizedRCNN(nn.Module):
    def __init__(
        self,
        body: str = "R-50",
        out_channels: int = 256,
        anchor_sizes: Sequence[int] = (32, 64, 128, 256, 512),
        anchor_strides: Sequence[int] = (4, 8, 16, 32, 64),
        aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
        pre_nms_top_n_train: int = 2000,
        pre_nms_top_n_test: int = 1000,
        post_nms_top_n_train: int = 1000,
        post_nms_top_n_test: int = 300,
        rpn_nms_thresh: float = 0.7,
        num_classes: int = 81,
        mlp_head_dim: int = 1024,
        roi_batch_per_image: int = 512,
        score_thresh: float = 0.05,
        box_nms_thresh: float = 0.5,
        max_det: int = 32,
        mask_on: bool = False,
        use_gn: bool = False,
        fbnet_scale_factor: float = 1.0,
        fbnet_width_divisor: int = 1,
        freeze_at: int = 2,  # MODEL.BACKBONE.FREEZE_CONV_BODY_AT
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        self.body = body
        self.c4_mode = body.endswith(("-C4", "-C5"))
        self.mask_on = mask_on
        self.pre_nms_top_n_train, self.pre_nms_top_n_test = pre_nms_top_n_train, pre_nms_top_n_test
        self.post_nms_top_n_train = post_nms_top_n_train
        self.post_nms_top_n_test = post_nms_top_n_test
        self.rpn_nms_thresh = rpn_nms_thresh
        self.roi_batch_per_image = roi_batch_per_image
        self.score_thresh, self.box_nms_thresh, self.max_det = score_thresh, box_nms_thresh, \
            max_det
        self._anchors: Dict[tuple, torch.Tensor] = {}
        with torch.device(device):
            if self.c4_mode:
                c5 = body.endswith("-C5")
                # one map: stem + res2..res4 (C4, stride 16) or res5 too (C5, stride 32)
                self.backbone = ResNet(body=body, use_gn=use_gn, num_stages=4 if c5 else 3,
                                       freeze_at=freeze_at)
                feat_ch = 2048 if c5 else 1024
                self.anchor_gen = AnchorGenerator(anchor_sizes, (32 if c5 else 16,),
                                                  aspect_ratios)
                self.box_head = C4BoxHead(body, feat_ch, num_classes,
                                          scale=1.0 / 32.0 if c5 else 1.0 / 16.0, use_gn=use_gn)
            else:
                self.backbone = ResNetFPNBackbone(
                    body=body, out_channels=out_channels, use_gn_body=use_gn,
                    use_gn_fpn=use_gn, fbnet_scale_factor=fbnet_scale_factor,
                    fbnet_width_divisor=fbnet_width_divisor, freeze_at=freeze_at)
                feat_ch = out_channels
                self.anchor_gen = AnchorGenerator(anchor_sizes, anchor_strides, aspect_ratios)
                self.box_head = MonoBoxHead(out_channels, num_classes, mlp_head_dim)
                if mask_on:
                    self.mask_head = mh.MaskHead(out_channels, num_classes)
            self.rpn_head = rpn.RPNHead(feat_ch, self.anchor_gen.num_anchors_per_location)
        self.eval()  # train mode only on request, as the JAX module defaults to train=False

    @property
    def device(self) -> torch.device:
        return self.rpn_head.conv.weight.device

    def anchors(self, feature_hws: Sequence[tuple], device: torch.device) -> torch.Tensor:
        key = (tuple(feature_hws), device)
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(self.anchor_gen(feature_hws)).to(device)
        return self._anchors[key]

    def _box_head(self, feats, boxes, batch_idx):
        if self.c4_mode:
            return self.box_head(feats[0], boxes, batch_idx)
        return self.box_head(feats[:-1], boxes, batch_idx)

    def forward(self, images: torch.Tensor, gt_boxes: Optional[torch.Tensor] = None,
                gt_labels: Optional[torch.Tensor] = None,
                gt_valid: Optional[torch.Tensor] = None,
                gt_masks: Optional[torch.Tensor] = None, draws: Optional[MonoDraws] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, object]:
        """images (B, H, W, 3) normalized.

        Eval -> {"detections": Boxes2D (B, max_det) with "scores" and
        "labels" fields, "masks": (B, max_det, 28, 28) (mask_on)}.

        Train, with the GT in M slots (gt_boxes (B, M, 4), gt_labels (B, M)
        int, gt_valid (B, M) bool; gt_masks is not read, as in the JAX
        package) and the step's `draws` (or a `generator`) ->
        {"loss_objectness", "loss_rpn_box_reg", "loss_classifier",
        "loss_box_reg"}."""
        b, img_h, img_w, _ = images.shape
        x = images.permute(0, 3, 1, 2).contiguous()
        feats = (self.backbone(x)[-1],) if self.c4_mode else self.backbone(x)
        hws = [tuple(f.shape[-2:]) for f in feats]
        logits, deltas = rpn.flatten_levels(self.rpn_head(feats))
        anchors = self.anchors(hws, images.device)
        if anchors.shape[0] != logits.shape[1]:
            raise ValueError(f"{anchors.shape[0]} anchors for {logits.shape[1]} RPN outputs: "
                             f"MODEL.RPN.ANCHOR_STRIDE needs one stride a level ({len(feats)})")
        pre, post = ((self.pre_nms_top_n_train, self.post_nms_top_n_train) if self.training
                     else (self.pre_nms_top_n_test, self.post_nms_top_n_test))
        proposals = rpn.postprocess_batched(anchors, logits, deltas, (img_h, img_w), pre, post,
                                            self.rpn_nms_thresh, 0.0)
        p = proposals.xyxy.shape[1]
        batch_idx = torch.arange(b, device=images.device).repeat_interleave(p)
        if self.training:
            return self._train_forward(feats, anchors, logits, deltas, proposals, batch_idx,
                                       (img_h, img_w), gt_boxes, gt_labels, gt_valid, draws,
                                       generator)
        scores, box_deltas = self._box_head(feats, proposals.xyxy.reshape(b * p, 4), batch_idx)
        dets = self._postprocess(scores.reshape(b, p, -1), box_deltas.reshape(b, p, -1),
                                 proposals, (img_h, img_w))
        out = {"detections": dets}
        if self.mask_on and self.c4_mode:
            raise NotImplementedError("the C4/C5 mask head (shared res5 extractor) is not "
                                      "supported; use an FPN body for MASK_ON (reference "
                                      "MaskRCNNC4Predictor)")
        if self.mask_on:
            d = self.max_det
            det_bi = torch.arange(b, device=images.device).repeat_interleave(d)
            ml = self.mask_head(feats[:-1], dets.xyxy.reshape(b * d, 4), det_bi)
            probs = mh.mask_probs(ml, dets.fields["labels"].reshape(-1))
            out["masks"] = probs.reshape(b, d, *probs.shape[1:])
        return out

    def _postprocess(self, scores, box_deltas, proposals: Boxes2D, image_hw) -> Boxes2D:
        """(B, P, C) scores and (B, P, 4C) deltas -> Boxes2D (B, max_det)."""
        b, p, c = scores.shape
        h, w = image_hw
        dev = scores.device
        probs = torch.softmax(scores, dim=-1)
        boxes = box_coder.decode4(box_deltas.reshape(b * p, c * 4),
                                  proposals.xyxy.reshape(b * p, 4), _W10)
        # (B, C - 1, P, ...): one NMS row a class of an image
        boxes = boxes.reshape(b, p, c, 4)[:, :, 1:].transpose(1, 2)
        lims = torch.tensor([w - 1.0, h - 1.0, w - 1.0, h - 1.0], device=dev)
        boxes = torch.clamp(boxes, torch.zeros(4, device=dev), lims)
        sc = probs[..., 1:].transpose(1, 2)
        ok = (sc > self.score_thresh) & proposals.valid[:, None, :]
        k = self.max_det
        idx, kept = nms_topk_batched(boxes.reshape(-1, p, 4), sc.reshape(-1, p),
                                     ok.reshape(-1, p), self.box_nms_thresh, k)
        rows = boxes.reshape(-1, p, 4)
        bx = torch.gather(rows, 1, idx[..., None].expand(-1, -1, 4)).reshape(b, -1, 4)
        s2 = torch.gather(sc.reshape(-1, p), 1, idx).reshape(b, -1)
        ok2 = kept.reshape(b, -1)
        lb2 = torch.arange(1, c, device=dev).repeat_interleave(idx.shape[1]).expand(b, -1)
        top, sel = topk_scores(torch.where(ok2, s2, torch.full_like(s2, -1.0)), k)
        take = lambda t: torch.gather(t, 1, sel)
        return Boxes2D(xyxy=torch.gather(bx, 1, sel[..., None].expand(-1, -1, 4)),
                       valid=take(ok2) & (top > 0), size=(w, h),
                       fields={"scores": take(s2), "labels": take(lb2)})

    def _train_forward(self, feats, anchors, logits, deltas, proposals, batch_idx, image_hw,
                       gt_boxes, gt_labels, gt_valid, draws, generator) -> Dict[str, object]:
        if gt_boxes is None or gt_labels is None or gt_valid is None:
            raise ValueError("the mono train step needs gt_boxes, gt_labels and gt_valid")
        b, n = logits.shape
        p = proposals.xyxy.shape[1]
        if draws is None:
            if generator is None:
                raise ValueError("the mono train step needs draws or a generator")
            draws = draw_mono_draws(b, n, p, generator, logits.device)
        out = {}
        out["loss_objectness"], out["loss_rpn_box_reg"] = rpn.loss(
            anchors, visibility(anchors, image_hw), logits, deltas, gt_boxes, gt_valid,
            draws.rpn_pos, draws.rpn_neg)
        labels, regt, pos, sampled = _subsample(proposals, gt_boxes, gt_labels, gt_valid,
                                                draws.roi_pos, draws.roi_neg,
                                                batch_size=self.roi_batch_per_image)
        scores, box_deltas = self._box_head(feats, proposals.xyxy.reshape(b * p, 4), batch_idx)
        lbl = labels.reshape(-1).clamp_min(0)
        ce = -torch.gather(torch.log_softmax(scores, -1), 1, lbl[:, None])[:, 0]
        sampled, pos = sampled.reshape(-1), pos.reshape(-1)
        cnt = sampled.sum().clamp_min(1).to(ce.dtype)
        out["loss_classifier"] = (ce * sampled).sum() / cnt
        d = box_deltas.reshape(b * p, -1, 4)
        d_pos = torch.gather(d, 1, lbl[:, None, None].expand(-1, 1, 4))[:, 0]
        out["loss_box_reg"] = (smooth_l1(d_pos - regt.reshape(-1, 4))
                               * pos[:, None]).sum() / cnt
        return out
