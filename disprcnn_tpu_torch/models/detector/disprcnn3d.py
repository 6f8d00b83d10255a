"""DispRCNN3D, eval and train forward (counterpart of
disprcnn_tpu/models/detector/disprcnn3d.py; reference
modeling/detector/disprcnn3d.py).

It takes the 2D stage's detections, crops both RAW [0, 1] RGB images to
width-aligned roi_size^2 ROIs (one batched ROIAlign), normalizes them with
the ImageNet mean/std, and runs iDispNet (PSMNet) over every one of the
B * max_det ROIs, valid or not, as the JAX package does (fixed shapes).
With det3d_on=False (configs/kitti/car/vob/idispnet.yaml) that is all.
With det3d_on=True (configs/kitti/car/vob/rcnn.yaml) the instance
disparity is lifted to one fixed-size pseudo-LiDAR cloud per ROI and
PointRCNN returns one 3D box per ROI; with rcnn_enabled=False (rpn.yaml)
it has no RCNN, and eval returns the disparity and roi_ok only, as JAX's
does.

Train mode (SOLVER.TRAIN_PSM / TRAIN_PC, disprcnn3d.py:162-290) first drops
the low-score detections (keeping the best two) and keeps the
max_roi_train best of each image. With train_psm, iDispNet trains on the
crops against the GT disparity warped into each crop, masked by the
detection's mask and the disparity range (loss_psm, deep supervision
0.5/0.7/1.0). With train_pc, iDispNet is frozen (eval, no gradients), the
lift runs on its disparity, each detection takes the GT box its left box
overlaps most (IoU >= 0.5), and PointRCNN trains either its 3D RPN
(rcnn_enabled=False: stage 3, rpn.yaml; loss_rpn_cls and loss_rpn_reg)
or its RCNN on a fixed RPN (rcnn_enabled=True: stage 4, rcnn.yaml;
loss_box3d).
"""
from __future__ import annotations

import functools
from dataclasses import replace
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ...ops.iou import pairwise_iou
from ...ops.losses import psm_deep_supervision_loss
from ...ops.roi_align import roi_align_batched
from ...ops.topk_select import topk_scores
from ...parallel.mesh import shard_batch
from ...parallel.multihost import process_count
from ...structures.masks import _sample_bilinear_2d
from ...structures.stereo import StereoBoxes
from ..pointrcnn import lift
from ..pointrcnn.lift import _bilinear_separable, _grid_fractions, expand_box_to_integer
from ..pointrcnn.point_rcnn import MEAN_SIZE, ROI_BLOCK, PointRCNN
from ..pointrcnn.rcnn3d import FG_AUG_TIMES, RCNNDraws, draw_rcnn_draws
from ..pointrcnn.rpn3d import RPNDraws, draw_rpn_draws
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


def remove_low_score_rois(dets: StereoBoxes, min_score: float,
                          keep_at_least: int = 2) -> StereoBoxes:
    """Invalidate detections scoring min_score or less, but keep the best
    `keep_at_least` of each image (reference disprcnn3d.py:192-207)."""
    score = torch.where(dets.valid, dets.score, torch.full_like(dets.score, -1.0))
    rank = torch.argsort(topk_scores(score, score.shape[-1])[1], dim=-1)
    return replace(dets, valid=dets.valid & ((score > min_score) | (rank < keep_at_least)))


def top_score_rois(dets: StereoBoxes, k: int) -> StereoBoxes:
    """The k best-scoring valid detections of each image (B, D) -> (B, k),
    fields included (the MAX_ROI_FOR_TRAINING cap, disprcnn3d.py:222-235)."""
    score = torch.where(dets.valid, dets.score, torch.full_like(dets.score, -1.0))
    idx = topk_scores(score, k)[1]

    def take(t):
        return torch.gather(t, 1, idx.reshape(idx.shape + (1,) * (t.dim() - 2)).expand(
            idx.shape + t.shape[2:]))

    return StereoBoxes(left=take(dets.left), right=take(dets.right), score=take(dets.score),
                       valid=take(dets.valid), fields={k_: take(v) for k_, v in
                                                       dets.fields.items()})


def _crop_grid(start: torch.Tensor, extent: torch.Tensor, size: int) -> torch.Tensor:
    """Pixel-centre sample positions of `size` steps over [start, start +
    extent) per row: (R, 1) -> (R, size)."""
    return start + _grid_fractions(size, start.device)[None, :] * extent - 0.5


def warp_gt_disparity_to_roi(gt_disp: torch.Tensor, left_crop: torch.Tensor,
                             right_crop: torch.Tensor, size: int = 224,
                             which: Optional[torch.Tensor] = None) -> torch.Tensor:
    """gt_disp (R, H, W) full-image GT disparity of each ROI's image, crops
    (R, 4) -> (R, size, size) GT disparity in ROI coordinates: sampled over
    the left crop, shifted by x1 - x1' and rescaled by size / width
    (generate_psmnet_input_inf.py semantics). With `which` (R,), gt_disp is
    (N, H, W) and ROI r reads gt_disp[which[r]], by gathering each sample's
    four taps (no per-ROI copy of a full map)."""
    x1, y1, x2, y2 = (left_crop[:, i:i + 1] for i in range(4))
    w = x2 - x1
    gy, gx = _crop_grid(y1, y2 - y1, size), _crop_grid(x1, w, size)
    if which is None:
        vals = _bilinear_separable(gt_disp, gy, gx)
    else:
        gy, gx = torch.broadcast_tensors(gy[:, :, None], gx[:, None, :])
        vals = _sample_bilinear_2d(gt_disp, which, gy, gx)
    scale = torch.full_like(w, float(size)) / w.clamp_min(1.0)
    return (vals - (x1 - right_crop[:, 0:1])[:, :, None]) * scale[:, :, None]


def _mask_on_crop(masks: torch.Tensor, box: torch.Tensor, crop: torch.Tensor, size: int,
                  thresh: float) -> torch.Tensor:
    """Each instance mask (R, M, M) over its box (R, 4), sampled on its
    crop's (R, 4) pixel grid -> (R, size, size) bool above thresh."""
    m = masks.shape[-1]
    gy = _crop_grid(crop[:, 1:2], crop[:, 3:4] - crop[:, 1:2], size)
    gx = _crop_grid(crop[:, 0:1], crop[:, 2:3] - crop[:, 0:1], size)
    my = (gy - box[:, 1:2]) / (box[:, 3:4] - box[:, 1:2]).clamp_min(1.0) * m - 0.5
    mx = (gx - box[:, 0:1]) / (box[:, 2:3] - box[:, 0:1]).clamp_min(1.0) * m - 0.5
    return _bilinear_separable(masks, my, mx) > thresh


def match_gt(left: torch.Tensor, valid: torch.Tensor, gt_left: torch.Tensor,
             gt_boxes3d: torch.Tensor, gt_valid: torch.Tensor):
    """Each detection's GT box: the valid GT whose left box overlaps its left
    box most (the first of equal IoUs), taken where that IoU is >= 0.5
    (PointRCNN match_targets_to_proposals, disprcnn3d.py:250-262). left (B,
    D, 4), valid (B, D), gt_left (B, M, 4), gt_boxes3d (B, M, 7), gt_valid
    (B, M) -> (gt (B, D, 7), ok (B, D))."""
    iou = torch.stack([pairwise_iou(g, l) for g, l in zip(gt_left, left)])
    iou = iou * gt_valid[:, :, None]
    best = torch.argmax(iou, dim=1)  # the first of equal maxima
    best_iou = iou.amax(dim=1)
    gt = torch.gather(gt_boxes3d, 1, best[..., None].expand(-1, -1, 7))
    return gt, (best_iou >= 0.5) & valid


CALIB_KEYS = ("fu", "fv", "cu", "cv", "tx", "ty", "fuxb")


class DispRCNN3D(nn.Module):
    """The JAX constructor's names and defaults for the fields that the port
    runs, but det3d_on defaults to False (the iDispNet-only
    configuration). Stage 3 (rpn.yaml) is det3d_on=True,
    rcnn_enabled=False. The JAX package's rpn_fixed is rcnn_enabled here:
    every config of the repo trains the RPN without an RCNN (rpn.yaml) or
    the RCNN on a fixed RPN (rcnn.yaml), and both in one step (JAX's
    default) is not ported (ROADMAP A4.4). Its rpn_nms_rotated and
    rpn_distance_based (default False) and rpn_loss_cls (BinaryCrossEntropy,
    SigmoidFocalLoss or DiceLoss, default BinaryCrossEntropy) are options,
    passed to PointRCNN; the train fields that every config of
    the repo sets alike (aug_data True, fg_aug_times 10, aug_rot_range 18,
    rcnn_loss_cls BinaryCrossEntropy, rpn_nms_thresh_train
    0.85, point_rcnn.TRAIN_RPN_NMS_THRESH) are not options here:
    the port runs only those values (models/build.py raises on a config that
    asks for another). Its
    DISPRCNN_SA_MIN_C0 and DISPRCNN_RCNN_ROI_BLOCK knobs are the arguments
    sa_min_c0 and roi_block, with the shipped values; DISPRCNN_PALLAS_DISABLE's PointNet++
    tags ("sa", "pool", "fp") are the argument kernels_off (none off by
    default; models/pointrcnn/pointnet2.py)."""

    def __init__(self, max_det: int = 32, roi_size: int = 224, maxdisp: int = 48,
                 mindisp: int = -48, npoints: int = 768, lift_grid: int = 112,
                 mask_thresh_train: float = 0.7, mask_thresh_eval: float = 0.5,
                 roi_min_score: float = 0.05, max_roi_train: int = 0,
                 mean_size: Tuple[float, float, float] = MEAN_SIZE, det3d_on: bool = False,
                 proposals_per_roi: int = 16, rpn_pre_nms_per_roi: int = 128,
                 proposals_per_roi_train: Optional[int] = None,
                 rpn_pre_nms_per_roi_train: Optional[int] = None, rcnn_rois_per_instance: int = 16,
                 sa_npoints: Tuple[int, ...] = (768, 512, 256, 64), rpn_score_thresh: float = 0.3,
                 rpn_nms_thresh: float = 0.8, psm_hourglass: int = 3,
                 sa_min_c0: int = SA_MIN_C0, kernels_off=frozenset(),
                 roi_block: int = ROI_BLOCK, rcnn_enabled: bool = True,
                 rpn_nms_rotated: bool = False, rpn_distance_based: bool = False,
                 rpn_loss_cls: str = "BinaryCrossEntropy",
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.max_det = max_det
        self.roi_size = roi_size
        self.det3d_on = det3d_on
        self.npoints = npoints
        self.lift_grid = lift_grid
        self.mask_thresh_train, self.mask_thresh_eval = mask_thresh_train, mask_thresh_eval
        self.roi_min_score, self.max_roi_train = roi_min_score, max_roi_train
        with torch.device(device):
            self.idispnet = PSMNet(maxdisp=maxdisp, mindisp=mindisp,
                                   num_hourglass=psm_hourglass)
            if det3d_on:
                self.pointrcnn = PointRCNN(
                    npoints=npoints, mean_size=mean_size, proposals_per_roi=proposals_per_roi,
                    rpn_pre_nms_per_roi=rpn_pre_nms_per_roi, sa_npoints=sa_npoints,
                    rpn_score_thresh=rpn_score_thresh, rpn_nms_thresh=rpn_nms_thresh,
                    sa_min_c0=sa_min_c0, kernels_off=kernels_off, roi_block=roi_block,
                    proposals_per_roi_train=proposals_per_roi_train,
                    rpn_pre_nms_per_roi_train=rpn_pre_nms_per_roi_train,
                    rcnn_rois_per_instance=rcnn_rois_per_instance, rcnn_enabled=rcnn_enabled,
                    rpn_nms_rotated=rpn_nms_rotated, rpn_distance_based=rpn_distance_based,
                    rpn_loss_cls=rpn_loss_cls)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.idispnet.dres0_0.Conv_0.weight.device

    def forward(self, left_img: torch.Tensor, right_img: torch.Tensor, dets: StereoBoxes,
                calib: Optional[Dict[str, torch.Tensor]] = None,
                priorities: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, train_psm: bool = False,
                train_pc: bool = False, gt_disp: Optional[torch.Tensor] = None,
                gt_left: Optional[torch.Tensor] = None,
                gt_boxes3d: Optional[torch.Tensor] = None,
                gt_valid: Optional[torch.Tensor] = None,
                rcnn_draws: Optional[RCNNDraws] = None,
                rpn_draws: Optional[RPNDraws] = None) -> Dict[str, torch.Tensor]:
        """left_img, right_img (B, H, W, 3) raw [0, 1] RGB; dets batched
        (B, D, ...) 2D detections, with the "mask" field (B, D, M, M) when
        det3d_on or training. In eval returns the JAX eval outputs:
        "disparity_roi" (B * D, roi, roi); with det3d_on also "roi_ok" (B,
        D) and, with the RCNN enabled, "box3d" (B, D, 7), "score3d" (B, D)
        and "random" (B, D).

        det3d_on needs `calib`, {fu, fv, cu, cv, tx, ty, fuxb} of (B,)
        tensors, and the lift's sampling priorities: `priorities` (B * D',
        lift_grid^2) uniform draws, or a `generator` on the model's device to
        draw them from.

        In train mode, with train_psm: gt_disp (B, H, W), and the outputs
        gain "loss_psm"; with train_pc (det3d_on): calib, gt_left (B, M, 4),
        gt_boxes3d (B, M, 7) rect frame, gt_valid (B, M) and the priorities,
        then with the RCNN `rcnn_draws` (or the generator for both) and the
        outputs gain "loss_box3d", without it `rpn_draws` (the RPN's dropout
        masks, or the generator) and they gain "loss_rpn_cls" and
        "loss_rpn_reg". D' is max_roi_train when it caps D. With several
        ranks (parallel/) a generator draws the global batch's draws, of
        which this rank keeps its samples' rows (mesh.shard_batch), so the
        ranks together draw what one process draws at the global batch."""
        dets = remove_illegal_detections(dets)
        train = self.training
        if train:
            if not (train_psm or train_pc):
                raise ValueError("train mode needs train_psm or train_pc")
            dets = remove_low_score_rois(dets, self.roi_min_score)
            if self.max_roi_train and self.max_roi_train < dets.left.shape[1]:
                dets = top_score_rois(dets, self.max_roi_train)
            self.idispnet.train(train_psm)  # frozen (FIX_DISPARITY) unless trained
        b, d = dets.left.shape[:2]
        gb = b * process_count()  # the global batch, whose draws a generator makes
        batch_idx = torch.arange(b, device=left_img.device).repeat_interleave(d)
        left_b, right_b = dets.left.reshape(b * d, 4), dets.right.reshape(b * d, 4)
        valid = dets.valid.reshape(b * d)
        lb, rb = width_aligned_crop_boxes(left_b, right_b)
        left_crops = crop_and_normalize(left_img, lb, batch_idx, self.roi_size)
        right_crops = crop_and_normalize(right_img, rb, batch_idx, self.roi_size)
        out = {}
        if train and train_psm:
            if gt_disp is None:
                raise ValueError("train_psm needs gt_disp")
            preds = self.idispnet(left_crops, right_crops)
            disp = preds[-1]
            psm = self.idispnet
            tgt = warp_gt_disparity_to_roi(gt_disp[batch_idx], lb, rb, self.roi_size)
            masks = dets.fields["mask"].reshape(b * d, *dets.fields["mask"].shape[2:])
            m = (_mask_on_crop(masks, left_b, lb, self.roi_size, self.mask_thresh_train)
                 & (tgt > psm.mindisp) & (tgt < psm.maxdisp) & valid[:, None, None])
            out["loss_psm"] = psm_deep_supervision_loss(preds, tgt, m)
        else:
            with torch.set_grad_enabled(torch.is_grad_enabled() and not train):
                disp = self.idispnet(left_crops, right_crops)
        out["disparity_roi"] = disp
        if not (self.det3d_on and (train_pc or not train)):
            return out
        if calib is None or set(calib) != set(CALIB_KEYS):
            raise ValueError(f"det3d_on needs calib with the keys {CALIB_KEYS}")
        cal = {k: calib[k][batch_idx] for k in CALIB_KEYS}
        masks = dets.fields["mask"]
        # the 3D stage lifts detached disparity and masks (the reference's
        # 3D losses never train iDispNet)
        pts_cand, cand_ok = lift.roi_points_candidates(
            disp.detach(), masks.reshape(b * d, *masks.shape[2:]), left_b, right_b, cal["fu"],
            cal["fv"], cal["cu"], cal["cv"], cal["tx"], cal["ty"], cal["fuxb"],
            grid=self.lift_grid,
            mask_thresh=self.mask_thresh_train if train else self.mask_thresh_eval)
        if priorities is None:
            if generator is None:
                raise ValueError("det3d_on needs sampling priorities or a generator")
            priorities = shard_batch(torch.rand((gb * d, cand_ok.shape[1]), generator=generator,
                                                device=disp.device), gb)
        pts, has_pts = lift.sample_fixed_points(priorities, pts_cand, cand_ok, self.npoints)
        roi_ok = valid & has_pts
        angles = lift.canonical_angles(left_b, float(left_img.shape[2]), cal["fu"])
        pts_c, pts_mean = lift.canonicalize(pts, angles)
        prc = self.pointrcnn
        if train:
            if gt_left is None or gt_boxes3d is None or gt_valid is None:
                raise ValueError("train_pc needs gt_left, gt_boxes3d and gt_valid")
            gt, gt_ok = match_gt(dets.left, dets.valid, gt_left, gt_boxes3d, gt_valid)
            if prc.rcnn_enabled and rcnn_draws is None:
                if generator is None:
                    raise ValueError("train_pc needs rcnn_draws or a generator")
                rcnn_draws = shard_batch(draw_rcnn_draws(
                    gb * d, prc.proposals_per_roi_train or prc.proposals_per_roi,
                    prc.rcnn_rois_per_instance, FG_AUG_TIMES, generator, disp.device), gb)
            if not prc.rcnn_enabled and rpn_draws is None:
                if generator is None:
                    raise ValueError("training the RPN needs rpn_draws or a generator")
                rpn = prc.rpn
                rpn_draws = shard_batch(draw_rpn_draws(
                    gb * d, self.npoints, generator, disp.device,
                    (rpn.cls_head.hidden[0], rpn.reg_head.hidden[0])), gb)
            out.update(prc(pts_c, roi_ok, angles, pts_mean, gt.reshape(b * d, 7),
                           gt_ok.reshape(b * d), rcnn_draws, rpn_draws))
            return out
        pr = prc(pts_c, roi_ok, angles, pts_mean)
        if prc.rcnn_enabled:
            for k in ("box3d", "score3d", "random"):
                out[k] = pr[k].reshape((b, d) + pr[k].shape[1:])
        out["roi_ok"] = roi_ok.reshape(b, d)
        return out
