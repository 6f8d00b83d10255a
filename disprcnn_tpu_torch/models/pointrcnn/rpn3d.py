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
from ...ops.losses import binary_cross_entropy, sigmoid_focal_loss_binary
from ...ops.nms import bev_nms_mask, topk_after_nms
from ...ops.topk_select import topk_scores
from ...parallel.mesh import sum_over_ranks
from ...parallel.multihost import process_count
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


RPN_LOSS_CLS = ("BinaryCrossEntropy", "SigmoidFocalLoss", "DiceLoss")


def rpn_loss(cls_pred: torch.Tensor, reg_pred: torch.Tensor, cls_label: torch.Tensor,
             reg_label: torch.Tensor, roi_valid: torch.Tensor, anchor_size: torch.Tensor,
             cfg: codec.CodecCfg, loss_cls: str = "BinaryCrossEntropy",
             focal_alpha: float = 0.25, focal_gamma: float = 2.0) -> Dict[str, torch.Tensor]:
    """cls_pred (R, N), reg_pred (R, N, C), cls_label (R, N) in {1, 0, -1},
    reg_label (R, N, 7), roi_valid (R,) -> {loss_rpn_cls, loss_rpn_reg}
    (reference rpn_loss.py:7-70). The points that count are the labelled
    ones (not -1) of valid instances; the positives those labelled 1. The
    classification loss by RPN.LOSS_CLS:
    - "BinaryCrossEntropy": the BCE (each log clipped at 1e-12) averaged
      over the counted points;
    - "SigmoidFocalLoss": the binary focal loss (alpha, gamma) summed over
      the counted points, divided by the positives (at least 1);
    - "DiceLoss": 1 - (inter + 1e-5) / (sum p + sum t + 1e-5) with p the
      sigmoid zeroed off the counted points and inter = sum p t (no factor
      2 on inter: not ops.losses.dice_loss). Its sums are this process's:
      it raises with several ranks (ROADMAP C35).
    The bin-based regression loss takes the positive points."""
    care = (cls_label >= 0) & roi_valid[:, None]
    pos = (cls_label > 0) & roi_valid[:, None]
    tgt = pos.to(cls_pred.dtype)
    if loss_cls == "SigmoidFocalLoss":
        raw = sigmoid_focal_loss_binary(cls_pred, tgt, focal_gamma, focal_alpha)
        cls_l = (raw * care).sum() / sum_over_ranks(pos.sum()).to(cls_pred.dtype).clamp_min(1.0)
    elif loss_cls == "DiceLoss":
        if process_count() > 1:
            raise NotImplementedError("RPN.LOSS_CLS DiceLoss over several ranks: its sums are "
                                      "one process's")
        p = torch.where(care, torch.sigmoid(cls_pred), torch.zeros_like(cls_pred))
        cls_l = 1.0 - ((p * tgt).sum() + 1e-5) / (p.sum() + tgt.sum() + 1e-5)
    elif loss_cls == "BinaryCrossEntropy":
        bce = binary_cross_entropy(cls_pred, tgt)
        cls_l = (bce * care).sum() / sum_over_ranks(care.sum()).to(cls_pred.dtype).clamp_min(1.0)
    else:
        raise ValueError(f"RPN.LOSS_CLS {loss_cls!r}: one of {RPN_LOSS_CLS}")
    loc, angle, size = codec.reg_loss(reg_pred.reshape(-1, reg_pred.shape[-1]),
                                      reg_label.reshape(-1, 7), tgt.reshape(-1), anchor_size,
                                      cfg)
    return {"loss_rpn_cls": cls_l, "loss_rpn_reg": loc + angle + size}


def _decode_bottom(cls_pred, reg_pred, xyz, anchor_size, cfg) -> torch.Tensor:
    """Every point's decoded box (R, N, 7) with its y moved to the bottom
    face (proposal_layer.py:40)."""
    r, n = cls_pred.shape
    boxes = codec.decode(xyz.reshape(r * n, 3), reg_pred.reshape(r * n, -1), anchor_size,
                         cfg).reshape(r, n, 7)
    return torch.cat([boxes[..., :1], boxes[..., 1:2] + boxes[..., 3:4] / 2, boxes[..., 2:]],
                     dim=-1)


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (R, N, ...) at idx (R, K) -> (R, K, ...)."""
    return torch.gather(t, 1, idx.reshape(idx.shape + (1,) * (t.dim() - 2)).expand(
        idx.shape + t.shape[2:]))


def propose(cls_pred: torch.Tensor, reg_pred: torch.Tensor, xyz: torch.Tensor,
            anchor_size: torch.Tensor, cfg: codec.CodecCfg, pre_nms_top_n: int,
            post_nms_top_n: int, nms_thresh: float,
            rotated: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score-based proposals (reference score_based_proposal): decode every
    point's box with its y moved to the bottom face, keep the pre-NMS top-k
    scores (ties by index), BEV NMS (RPN.NMS_TYPE "normal" axis-aligned, or
    with `rotated` "rotate", ops/nms.py), then the post-NMS top-k.
    -> (rois (R, post, 7), scores (R, post), valid (R, post))."""
    n = cls_pred.shape[1]
    boxes = _decode_bottom(cls_pred, reg_pred, xyz, anchor_size, cfg)
    k = min(pre_nms_top_n, n)
    top_s, top_i = topk_scores(cls_pred, k)
    b = _rows(boxes, top_i)
    keep = bev_nms_mask(boxes3d_to_bev(b), top_s, torch.ones_like(top_s, dtype=torch.bool),
                        nms_thresh, rotated=rotated)
    idx, ok = topk_after_nms(keep, top_s, post_nms_top_n)
    return _rows(b, idx), torch.gather(top_s, 1, idx), ok


NMS_RANGES = (0.0, 40.0, 80.0)  # the distance bands' z limits (proposal_layer.py:70-134)
NEAR_FRAC = 0.7  # the near band's share of the pre- and post-NMS budgets


def distance_propose(cls_pred: torch.Tensor, reg_pred: torch.Tensor, xyz: torch.Tensor,
                     anchor_size: torch.Tensor, cfg: codec.CodecCfg, pre_nms_top_n: int,
                     post_nms_top_n: int, nms_thresh: float,
                     rotated: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Distance-based proposals (TEST.RPN_DISTANCE_BASED_PROPOSE, reference
    proposal_layer.py:70-134, the JAX package's ``distance_propose``): the
    decoded boxes split into a near band (z in (0, 40]) and a far band (z
    in (40, 80]) with a 70/30 split of the pre- and post-NMS budgets, BEV
    NMS in each band, the two concatenated. Where a cloud's far band is
    empty, its second band is the near band's overflow window, score ranks
    [pre_near, pre_near + pre_far), chosen per row without a branch.
    -> (rois (R, post, 7), scores (R, post), valid (R, post))."""
    pre1 = int(pre_nms_top_n * NEAR_FRAC)
    pre2 = pre_nms_top_n - pre1
    post1 = int(post_nms_top_n * NEAR_FRAC)
    post2 = post_nms_top_n - post1
    neg = -1e10
    scores = cls_pred
    boxes = _decode_bottom(cls_pred, reg_pred, xyz, anchor_size, cfg)
    z = boxes[..., 2]
    band1 = (z > NMS_RANGES[0]) & (z <= NMS_RANGES[1])
    band2 = (z > NMS_RANGES[1]) & (z <= NMS_RANGES[2])
    neg_t = torch.full_like(scores, neg)

    t1_s, t1_i = topk_scores(torch.where(band1, scores, neg_t), pre1 + pre2)
    i1, v1 = t1_i[:, :pre1], t1_s[:, :pre1] > neg / 2
    over_i, over_v = t1_i[:, pre1:], t1_s[:, pre1:] > neg / 2
    any2 = band2.any(dim=1, keepdim=True)
    t2_s, t2_i = topk_scores(torch.where(band2, scores, neg_t), pre2)
    i2 = torch.where(any2, t2_i, over_i)
    v2 = torch.where(any2, t2_s > neg / 2, over_v)

    def band_nms(idx, vmask, post_n):
        b = _rows(boxes, idx)
        raw = torch.gather(scores, 1, idx)
        sc = torch.where(vmask, raw, torch.full_like(raw, neg))
        keep = bev_nms_mask(boxes3d_to_bev(b), sc, vmask, nms_thresh, rotated=rotated)
        kidx, kok = topk_after_nms(keep, sc, post_n)
        return _rows(b, kidx), torch.gather(raw, 1, kidx), kok

    b1, sc1, ok1 = band_nms(i1, v1, post1)
    b2, sc2, ok2 = band_nms(i2, v2, post2)
    return torch.cat([b1, b2], 1), torch.cat([sc1, sc2], 1), torch.cat([ok1, ok2], 1)
