"""The 3D RPN over per-instance pseudo-LiDAR clouds, its loss and its
proposal layer (counterpart of disprcnn_tpu/models/pointrcnn/rpn3d.py;
reference lib/net/rpn.py, rpn/proposal_layer.py, net/rpn_loss.py).

In train mode the heads' BN takes batch statistics (Flax's, as
``batch_norm_train`` computes them) and the dropout after each head's
first layer keeps the entries of an input mask (``RPNDraws``, drawn by
``draw_rpn_draws``): every train-time random draw is an input.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops.iou import boxes3d_to_bev
from ...ops.losses import binary_cross_entropy
from ...ops.nms import bev_nms_mask, topk_after_nms
from ...ops.topk_select import topk_scores
from ...parallel.mesh import sum_over_ranks
from ..psmnet.psmnet import batch_norm_train
from . import bbox3d_codec as codec
from .pointnet2 import BN_EPS, SA_MIN_C0, Pointnet2MSG, batch_norm_eval

DP_RATIO = 0.5  # RPN.DP_RATIO (config/defaults.py:229)


@dataclass
class RPNDraws:
    """The dropout keep masks of one train-mode RPN forward over R clouds
    of N points: True keeps an entry of the heads' first hidden layer."""
    cls_keep: torch.Tensor  # (R, N, cls_fc[0]) bool
    reg_keep: torch.Tensor  # (R, N, reg_fc[0]) bool


def draw_rpn_draws(r: int, n: int, generator: torch.Generator, device=None,
                   widths: Tuple[int, int] = (128, 128)) -> RPNDraws:
    """One RPNDraws from `generator` (on `device`) for heads of the given
    first widths: each entry kept with probability 1 - DP_RATIO, as Flax's
    Dropout keeps it."""
    def keep(c):
        return torch.rand((r, n, c), generator=generator, device=device) < 1.0 - DP_RATIO

    return RPNDraws(cls_keep=keep(widths[0]), reg_keep=keep(widths[1]))


class ConvHead(nn.Module):
    """Per-point dense head: fc{i} (+ BN) + ReLU per hidden width, dropout
    after the first (train mode: the kept entries scaled by 1 / (1 -
    DP_RATIO), the others 0), then ``out``."""

    def __init__(self, hidden: Sequence[int], out: int, in_channels: int, use_bn: bool = True):
        super().__init__()
        self.hidden, self.use_bn = tuple(hidden), use_bn
        cin = in_channels
        for i, c in enumerate(self.hidden):
            setattr(self, f"fc{i}", nn.Linear(cin, c, bias=not use_bn))
            if use_bn:
                setattr(self, f"bn{i}", nn.BatchNorm1d(c, eps=BN_EPS))
            cin = c
        self.out = nn.Linear(cin, out)
        self.eval()  # train mode only on request, as the JAX modules default to train=False

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (..., C) -> (..., out); in train mode with dropout, `keep` is
        the first layer's keep mask (..., hidden[0])."""
        dropout = self.training and len(self.hidden) > 0
        if dropout and keep is None:
            raise ValueError("train-mode dropout needs its keep mask")
        for i in range(len(self.hidden)):
            x = getattr(self, f"fc{i}")(x)
            if self.use_bn:
                bn = getattr(self, f"bn{i}")
                x = batch_norm_train(bn, x, axis=-1) if self.training else batch_norm_eval(bn, x)
            x = torch.relu(x)
            if i == 0 and dropout:
                x = torch.where(keep, x / (1.0 - DP_RATIO), torch.zeros_like(x))
        return self.out(x)


class RPN3D(nn.Module):
    """PointNet++ backbone + per-point classification and box regression."""

    def __init__(self, codec_cfg: codec.CodecCfg = codec.CodecCfg(),
                 cls_fc: Sequence[int] = (128,), reg_fc: Sequence[int] = (128,),
                 use_bn: bool = True, npoints: Sequence[int] = (4096, 1024, 256, 64),
                 sa_min_c0: int = SA_MIN_C0, kernels_off=frozenset()):
        super().__init__()
        self.backbone = Pointnet2MSG(npoints=npoints, use_bn=use_bn, sa_min_c0=sa_min_c0,
                                     kernels_off=kernels_off)
        c = self.backbone.out_channels
        self.cls_head = ConvHead(cls_fc, 1, c, use_bn)
        self.reg_head = ConvHead(reg_fc, codec_cfg.reg_channels, c, use_bn)
        self.eval()

    def forward(self, pts: torch.Tensor,
                draws: Optional[RPNDraws] = None) -> Dict[str, torch.Tensor]:
        """pts (R, N, 3) -> xyz (R, N, 3), features (R, N, C), per-point cls
        (R, N) and reg (R, N, reg_channels). Train mode takes the heads'
        dropout masks, `draws`."""
        xyz, feats = self.backbone(pts)
        cls_keep = reg_keep = None
        if draws is not None:
            cls_keep, reg_keep = draws.cls_keep, draws.reg_keep
        return {"xyz": xyz, "features": feats, "cls": self.cls_head(feats, cls_keep)[..., 0],
                "reg": self.reg_head(feats, reg_keep)}


def rpn_loss(cls_pred: torch.Tensor, reg_pred: torch.Tensor, cls_label: torch.Tensor,
             reg_label: torch.Tensor, roi_valid: torch.Tensor, anchor_size: torch.Tensor,
             cfg: codec.CodecCfg) -> Dict[str, torch.Tensor]:
    """cls_pred (R, N), reg_pred (R, N, C), cls_label (R, N) in {1, 0, -1},
    reg_label (R, N, 7), roi_valid (R,) -> {loss_rpn_cls, loss_rpn_reg}
    (reference rpn_loss.py:7-70). The classification loss is the BCE (each
    log clipped at 1e-12) averaged over the labelled points (not -1) of
    valid instances: RPN.LOSS_CLS BinaryCrossEntropy, as every rpn.yaml of
    the repo sets it (JAX's focal and dice forms are not ported). The
    bin-based regression loss takes the positive points."""
    care = (cls_label >= 0) & roi_valid[:, None]
    pos = (cls_label > 0) & roi_valid[:, None]
    tgt = pos.to(cls_pred.dtype)
    bce = binary_cross_entropy(cls_pred, tgt)
    cls_l = (bce * care).sum() / sum_over_ranks(care.sum()).to(cls_pred.dtype).clamp_min(1.0)
    loc, angle, size = codec.reg_loss(reg_pred.reshape(-1, reg_pred.shape[-1]),
                                      reg_label.reshape(-1, 7), tgt.reshape(-1), anchor_size,
                                      cfg)
    return {"loss_rpn_cls": cls_l, "loss_rpn_reg": loc + angle + size}


def propose(cls_pred: torch.Tensor, reg_pred: torch.Tensor, xyz: torch.Tensor,
            anchor_size: torch.Tensor, cfg: codec.CodecCfg, pre_nms_top_n: int,
            post_nms_top_n: int,
            nms_thresh: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score-based proposals (reference score_based_proposal): decode every
    point's box with its y moved to the bottom face, keep the pre-NMS top-k
    scores (ties by index), axis-aligned BEV NMS (RPN.NMS_TYPE "normal"),
    then the post-NMS top-k.
    -> (rois (R, post, 7), scores (R, post), valid (R, post))."""
    r, n = cls_pred.shape
    boxes = codec.decode(xyz.reshape(r * n, 3), reg_pred.reshape(r * n, -1), anchor_size,
                         cfg).reshape(r, n, 7)
    boxes = torch.cat([boxes[..., :1], boxes[..., 1:2] + boxes[..., 3:4] / 2, boxes[..., 2:]],
                      dim=-1)
    k = min(pre_nms_top_n, n)
    top_s, top_i = topk_scores(cls_pred, k)
    b = torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 7))
    keep = bev_nms_mask(boxes3d_to_bev(b), top_s, torch.ones_like(top_s, dtype=torch.bool),
                        nms_thresh)
    idx, ok = topk_after_nms(keep, top_s, post_nms_top_n)
    return (torch.gather(b, 1, idx[..., None].expand(-1, -1, 7)), torch.gather(top_s, 1, idx),
            ok)
