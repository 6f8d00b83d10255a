"""The RetinaNet detector, single-stage and single-view (counterpart of
disprcnn_tpu/models/detector/retinanet_det.py; reference
modeling/rpn/retinanet/retinanet.py:13-152 through MODEL.RETINANET_ON):
an R-x-FPN ``backbone`` with LastLevelP6P7 over C3-C5 (P3-P7), the
``head`` (models/rpn/retinanet.py), octave anchors, the focal loss in
train and the top-k + NMS postprocessing in eval. Images are NHWC at the
public boundary; the body's freeze_at (MODEL.BACKBONE.FREEZE_CONV_BODY_AT)
defaults to 2.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..backbone.fpn import ResNetFPNBackbone
from ..rpn import retinanet as rn


class RetinaNetDetector(nn.Module):
    def __init__(
        self,
        body: str = "R-50",
        out_channels: int = 256,
        num_classes: int = 80,  # foreground classes (the config's NUM_CLASSES - 1)
        anchor_sizes: Sequence[int] = (32, 64, 128, 256, 512),
        anchor_strides: Sequence[int] = (8, 16, 32, 64, 128),
        aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
        octave: float = 2.0,
        scales_per_octave: int = 3,
        fg_iou: float = 0.5,
        bg_iou: float = 0.4,
        loss_gamma: float = 2.0,
        loss_alpha: float = 0.25,
        pre_nms_top_n: int = 1000,
        score_thresh: float = 0.05,
        nms_thresh: float = 0.4,
        max_det: int = 100,
        use_gn: bool = False,
        freeze_at: int = 2,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        self.fg_iou, self.bg_iou = fg_iou, bg_iou
        self.loss_gamma, self.loss_alpha = loss_gamma, loss_alpha
        self.pre_nms_top_n, self.score_thresh = pre_nms_top_n, score_thresh
        self.nms_thresh, self.max_det = nms_thresh, max_det
        self.anchor_gen = rn.octave_anchor_generator(anchor_sizes, anchor_strides, aspect_ratios,
                                                     octave, scales_per_octave)
        self._anchors: Dict[tuple, torch.Tensor] = {}
        with torch.device(device):
            self.backbone = ResNetFPNBackbone(body=body, out_channels=out_channels,
                                              use_gn_body=use_gn, top_blocks="p6p7",
                                              skip_c2=True, freeze_at=freeze_at)
            self.head = rn.RetinaNetHead(out_channels, num_classes,
                                         len(aspect_ratios) * scales_per_octave)
        self.eval()  # train mode only on request

    @property
    def device(self) -> torch.device:
        return self.head.cls_logits.weight.device

    def anchors(self, feature_hws, device: torch.device) -> torch.Tensor:
        key = (tuple(feature_hws), device)
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(self.anchor_gen(feature_hws)).to(device)
        return self._anchors[key]

    def forward(self, images: torch.Tensor, gt_boxes: Optional[torch.Tensor] = None,
                gt_labels: Optional[torch.Tensor] = None,
                gt_valid: Optional[torch.Tensor] = None) -> Dict[str, object]:
        """images (B, H, W, 3) -> eval {"detections": Boxes2D (B, max_det)
        with "scores" and "labels"}; train (gt_boxes (B, M, 4), gt_labels
        (B, M) in 1..num_classes, gt_valid (B, M)) {"loss_retina_cls",
        "loss_retina_reg"}."""
        b, img_h, img_w, _ = images.shape
        feats = self.backbone(images.permute(0, 3, 1, 2).contiguous())  # P3..P7
        anchors = self.anchors([tuple(f.shape[-2:]) for f in feats], images.device)
        outs = self.head(feats)
        cls_logits = torch.cat([o[0] for o in outs], 1)
        box_deltas = torch.cat([o[1] for o in outs], 1)
        if self.training:
            if gt_boxes is None or gt_labels is None or gt_valid is None:
                raise ValueError("the RetinaNet train step needs gt_boxes, gt_labels and "
                                 "gt_valid")
            cls_l, box_l = rn.retinanet_loss(anchors, cls_logits, box_deltas, gt_boxes,
                                             gt_labels, gt_valid, fg_iou=self.fg_iou,
                                             bg_iou=self.bg_iou, gamma=self.loss_gamma,
                                             alpha=self.loss_alpha)
            return {"loss_retina_cls": cls_l, "loss_retina_reg": box_l}
        return {"detections": rn.retinanet_postprocess_batched(
            anchors, cls_logits, box_deltas, (img_h, img_w), self.pre_nms_top_n,
            self.score_thresh, self.nms_thresh, self.max_det)}
