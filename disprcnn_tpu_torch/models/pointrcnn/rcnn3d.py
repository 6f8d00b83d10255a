"""The 3D RCNN refinement stage (counterpart of
disprcnn_tpu/models/pointrcnn/rcnn3d.py; reference lib/net/rcnn_net.py,
rcnn_inference.py, rpn/proposal_target_layer.py and net/rcnn_loss.py).

Per proposal: pool 512 points and their features in the enlarged box
(RoI-pool 3D, ops/cuda/roipool3d.py), with two extra channels (the RPN's
segmentation mask and depth / 70 - 0.5); move them into the proposal's
canonical frame; the BN-free RCNN PointNet (xyz_up, merge_down, SA 128 /
32 / group-all, cls and bin-reg heads); then per instance the
best-scoring refined box above the threshold, or the best RPN proposal
with the ``random`` flag.

Training (the proposal target layer, then the loss): per instance 16
proposals are sampled by 3D IoU with the matched GT box (foreground, hard
and easy background), noised (``aug_roi_by_noise``, fg_aug_times trials,
RCNN.ROI_FG_AUG_TIMES), pooled, rotated, scaled and flipped with the GT
(``rcnn_data_augmentation``, rotations up to pi / aug_rot_range,
AUG_ROT_RANGE, with the reference's ``(rand - 0.5 / 0.5)`` precedence
quirk that makes the rotation one-sided) and moved into each proposal's
canonical frame; aug_data False (POINTRCNN.AUG_DATA) skips the noise and
the rotation, scaling and flip. The JAX package draws the randomness with
jax.random inside; here every draw is an input, an ``RCNNDraws``
(``draw_rcnn_draws`` draws one from a torch.Generator).

Where the pooled points or features carry a gradient (the RPN and RCNN
trained in one step), the pooling takes row 14's train form
(``roipool3d_train``); otherwise its eval kernel.

At the compute dtype bf16 (``RCNNNet(dtype=torch.bfloat16)``, eval and
train) the RPN's features and segmentation mask are bf16, as JAX's are: the
pooling takes row 14's bf16 read (``roipool3d_bf16``: the mask and the
depth in float32, as JAX's concat promotes them, the features widened in
the gather; where they carry a gradient, its train form
``roipool3d_train_bf16``, the features' gradient rounded once to bf16),
and the pooled input stays float32 (bf16-exact features); the
RCNN's dense layers, SA scales and heads compute as pointnet2.py's module
doc says, and cls and reg come out bf16. ``rcnn_postprocess`` takes them
as JAX's does: jax.nn.sigmoid's bf16 arithmetic (ops/losses.py::sigmoid), the
threshold and the -1e10 fill compared in bf16, ties to the first, the
decoded boxes float32, the score bf16.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops.cuda.roipool3d import roipool3d, roipool3d_bf16, roipool3d_train, roipool3d_train_bf16
from ...ops.iou import iou3d
from ...ops.losses import binary_cross_entropy, sigmoid, sigmoid_focal_loss_binary
from ...ops.roipool3d import enlarge_box3d
from ...ops.topk_select import topk_scores
from ...parallel.mesh import sum_over_ranks
from ...structures.boxes3d import rotate_points_along_y
from . import bbox3d_codec as codec
from .pointnet2 import BF16, SA_MIN_C0, SAModule, SharedMLP, dense

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
                 rpn_channels: int = 128, input_extra: int = 2, sa_min_c0: int = SA_MIN_C0,
                 kernels_off=frozenset(), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.nc_in = 3 + input_extra
        self.xyz_up = SharedMLP(xyz_up, self.nc_in, use_bn=False, dtype=dtype)
        self.merge_down = SharedMLP((xyz_up[-1],), xyz_up[-1] + rpn_channels, use_bn=False,
                                    dtype=dtype)
        feat = xyz_up[-1]
        self.n_sa = len(sa_npoints)
        for i, (npt, r, ns, mlp) in enumerate(zip(sa_npoints, sa_radius, sa_nsample, sa_mlps)):
            setattr(self, f"sa{i}", SAModule(None if npt == -1 else npt, r, ns, mlp, feat,
                                             use_bn=False, sa_min_c0=sa_min_c0,
                                             kernels_off=kernels_off, dtype=dtype))
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
            x = torch.relu(dense(getattr(self, f"{name}_fc{i}"), x, self.dtype))
        return dense(getattr(self, f"{name}_out"), x, self.dtype)

    def forward(self, pts_input: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """pts_input (B, P, 5 + C_rpn) -> (cls (B,), reg (B, C))."""
        xyz = pts_input[..., 0:3].contiguous()
        xyz_feat = self.xyz_up(pts_input[..., :self.nc_in])
        feats = self.merge_down(torch.cat([xyz_feat, pts_input[..., self.nc_in:]], dim=-1))
        for i in range(self.n_sa):
            xyz, feats = getattr(self, f"sa{i}")(xyz, feats)
        g = feats[:, 0, :]  # group-all leaves one descriptor
        return self._head(g, "cls", self.cls_fc)[:, 0], self._head(g, "reg", self.reg_fc)


def _pool(xyz, rpn_feats, seg_mask, rois, num_points, pool_extra_width):
    """Points and [seg_mask, depth / 70 - 0.5, rpn features] pooled in the
    enlarged rois (R, M, 7) -> pooled (R, M, num_points, 3 + 2 + C) float32,
    empty. bf16 rpn features take row 14's bf16 read, the mask and depth
    float32 beside them."""
    norm = torch.linalg.vector_norm(xyz, dim=-1)
    depth = norm / torch.full_like(norm, 70.0) - 0.5  # a division, not a reciprocal multiply
    grown = enlarge_box3d(rois, pool_extra_width).contiguous()
    if rpn_feats.dtype == BF16:
        extra = torch.stack([seg_mask.float(), depth], dim=-1).contiguous()
        grads = torch.is_grad_enabled() and (extra.requires_grad or rpn_feats.requires_grad)
        pool = roipool3d_train_bf16 if grads else roipool3d_bf16
        return pool(xyz.contiguous(), extra, rpn_feats.contiguous(), grown.detach(), num_points)
    feats = torch.cat([seg_mask[..., None], depth[..., None], rpn_feats], dim=-1).contiguous()
    pool = roipool3d_train if torch.is_grad_enabled() and feats.requires_grad else roipool3d
    return pool(xyz.contiguous(), feats, grown.detach(), num_points)


def pool_rcnn_inputs(xyz: torch.Tensor, rpn_feats: torch.Tensor, seg_mask: torch.Tensor,
                     rois: torch.Tensor, num_points: int = 512, pool_extra_width: float = 1.0):
    """xyz (R, N, 3) rect frame, rpn_feats (R, N, C), seg_mask (R, N), rois
    (R, M, 7) -> pts_input (R, M, num_points, 5 + C), empty (R, M): points
    pooled in the enlarged rois, centred on and rotated by the roi."""
    pooled, empty = _pool(xyz, rpn_feats, seg_mask, rois, num_points, pool_extra_width)
    r, m = rois.shape[:2]
    p_xyz = pooled[..., 0:3] - rois[..., None, 0:3]
    p_xyz = rotate_points_along_y(p_xyz.reshape(r * m, num_points, 3),
                                  rois[..., 6].reshape(r * m)).reshape(r, m, num_points, 3)
    # in place: the canonical xyz over the pooled xyz, not a copy of the
    # whole (R, M, num_points, 5 + C) tensor; pooled is this call's own
    pooled[..., 0:3] = p_xyz
    return pooled, empty


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
    ok = (sigmoid(cls_pred) > score_thresh) & roi_valid
    neg = torch.full_like(cls_pred, -1e10)
    best = torch.argmax(torch.where(ok, cls_pred, neg), dim=1)
    fallback = torch.argmax(torch.where(roi_valid, roi_scores, neg), dim=1)
    any_ok = ok.any(dim=1)
    rows = torch.arange(r, device=cls_pred.device)
    box = torch.where(any_ok[:, None], boxes[rows, best], rois[rows, fallback])
    score = torch.where(any_ok, cls_pred[rows, best], torch.zeros_like(any_ok, dtype=cls_pred.dtype))
    return box, score, ~any_ok


# -- training: the proposal target layer and the loss --------------------------

# (pos, hwl, angle) noise ranges per tier (proposal_target_layer
# random_aug_box3d, REG_AUG_METHOD 'multiple')
FG_AUG_TIMES = 10  # RCNN.ROI_FG_AUG_TIMES' default, the noise trials of a foreground roi
AUG_ROT_RANGE = 18.0  # AUG_ROT_RANGE's default: the rotation reaches pi / 18
AUG_RANGES = ((0.2, 0.1, math.pi / 12), (0.3, 0.15, math.pi / 12), (0.5, 0.15, math.pi / 9),
              (0.8, 0.15, math.pi / 6), (1.0, 0.15, math.pi / 3))


@dataclass
class RCNNDraws:
    """Every random draw of one proposal target layer, for R instances of
    M proposals, K = rois_per_instance samples each and T noise trials:
    uniforms in [0, 1) unless said otherwise."""
    fg: torch.Tensor  # (R, M) sampling priorities of the foreground proposals
    hard: torch.Tensor  # (R, M) of the hard background
    easy: torch.Tensor  # (R, M) of the easy background
    keep: torch.Tensor  # (R * K, T) a trial keeps the roi unnoised where < 0.2
    tier: torch.Tensor  # (R * K, T) int64 in [0, 5): the row of AUG_RANGES
    pos: torch.Tensor  # (R * K, T, 3) centre noise
    hwl: torch.Tensor  # (R * K, T, 3) size noise
    ang: torch.Tensor  # (R * K, T) yaw noise
    rot: torch.Tensor  # (R * K,) rotation of the pooled points, boxes and GT
    scale: torch.Tensor  # (R * K,) their scaling
    flip: torch.Tensor  # (R * K,) their x flip


def draw_rcnn_draws(r: int, m: int, k: int, aug_times: int, generator: torch.Generator,
                    device=None) -> RCNNDraws:
    """One RCNNDraws from `generator` (on `device`)."""
    def u(*shape):
        return torch.rand(shape, generator=generator, device=device)

    n, t = r * k, max(aug_times, 1)
    return RCNNDraws(fg=u(r, m), hard=u(r, m), easy=u(r, m), keep=u(n, t),
                     tier=torch.randint(0, len(AUG_RANGES), (n, t), generator=generator,
                                        device=device),
                     pos=u(n, t, 3), hwl=u(n, t, 3), ang=u(n, t), rot=u(n), scale=u(n),
                     flip=u(n))


def canonical_gt(rois: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """GT boxes (..., 7) in the canonical frame of their rois (..., 7): the
    centre offset rotated by the roi's yaw, the yaw relative."""
    off = rotate_points_along_y((gt[..., 0:3] - rois[..., 0:3]).reshape(-1, 1, 3),
                                rois[..., 6].reshape(-1)).reshape(gt.shape[:-1] + (3,))
    return torch.cat([off, gt[..., 3:6], (gt[..., 6] - rois[..., 6])[..., None]], dim=-1)


def _random_aug_box3d(box: torch.Tensor, tier: torch.Tensor, pos: torch.Tensor,
                      hwl: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Noised candidates of boxes (..., 7) (random_aug_box3d 'multiple')."""
    ranges = box.new_tensor(AUG_RANGES)[tier]  # (..., 3)
    d_pos = (pos - 0.5) / 0.5 * ranges[..., 0:1]
    f_hwl = (hwl - 0.5) / 0.5 * ranges[..., 1:2] + 1.0
    d_ang = (ang - 0.5) / 0.5 * ranges[..., 2]
    return torch.cat([box[..., 0:3] + d_pos, box[..., 3:6] * f_hwl,
                      (box[..., 6] + d_ang)[..., None]], dim=-1)


def aug_roi_by_noise(rois: torch.Tensor, gts: torch.Tensor, iou_src: torch.Tensor,
                     pos_thresh: float, draws: RCNNDraws, aug_times: int = FG_AUG_TIMES,
                     fg_mask: Optional[torch.Tensor] = None):
    """ROI noise (aug_roi_by_noise_torch, proposal_target_layer.py:219-246):
    for each of the K rois (K, 7), T = aug_times trials, each keeping the
    roi (draws.keep < 0.2) or noising it; a foreground roi takes the first
    trial whose 3D IoU with its GT reaches pos_thresh (the last when none
    does), a background roi its first trial (proposal_target_layer.py:170).
    -> (rois', iou'), iou' the source IoU where the kept roi was taken."""
    if aug_times <= 0:
        return rois, iou_src
    if fg_mask is None:
        fg_mask = torch.ones_like(iou_src, dtype=torch.bool)
    keep = draws.keep[:, :aug_times] < 0.2
    noised = _random_aug_box3d(rois[:, None], draws.tier[:, :aug_times],
                               draws.pos[:, :aug_times], draws.hwl[:, :aug_times],
                               draws.ang[:, :aug_times])
    cands = torch.where(keep[..., None], rois[:, None].expand_as(noised), noised)
    ious = iou3d(cands, gts[:, None].expand_as(cands))
    success = ious >= pos_thresh
    first = torch.argmax(success.to(torch.uint8), dim=1)  # the first success
    sel_fg = torch.where(success.any(1), first, torch.full_like(first, aug_times - 1))
    sel = torch.where(fg_mask, sel_fg, torch.zeros_like(sel_fg))
    rows = torch.arange(rois.shape[0], device=rois.device)
    iou = torch.where(keep[rows, sel], iou_src, ious[rows, sel])
    return cands[rows, sel], iou


def rcnn_data_augmentation(pts: torch.Tensor, rois: torch.Tensor, gts: torch.Tensor,
                           draws: RCNNDraws, aug_rot_range: float = AUG_ROT_RANGE):
    """Joint rotation, scaling and x flip of pooled points (K, P, 3), rois
    and GT (K, 7) (proposal_target_layer.data_augmentation:291-348). The
    rotated boxes keep their viewing angle alpha. The rotation angle is
    (u - 0.5 / 0.5) * pi / aug_rot_range = (u - 1) * pi / aug_rot_range,
    the reference's precedence quirk: one-sided."""
    angles = (draws.rot - 0.5 / 0.5) * (math.pi / aug_rot_range)

    def alpha(b):
        beta = torch.atan2(b[..., 2], b[..., 0])
        return -torch.sign(beta) * math.pi / 2 + beta + b[..., 6]

    def rot_box(b, a):
        c = rotate_points_along_y(b[:, None, 0:3], angles)[:, 0]
        beta = torch.atan2(c[:, 2], c[:, 0])
        return torch.cat([c, b[:, 3:6], (torch.sign(beta) * math.pi / 2 + a - beta)[:, None]],
                         dim=-1)

    gt_alpha, roi_alpha = alpha(gts), alpha(rois)
    pts = rotate_points_along_y(pts, angles)
    gts, rois = rot_box(gts, gt_alpha), rot_box(rois, roi_alpha)
    scales = 1.0 + (draws.scale - 0.5) / 0.5 * 0.05
    pts = pts * scales[:, None, None]
    gts = torch.cat([gts[:, 0:6] * scales[:, None], gts[:, 6:]], dim=-1)
    rois = torch.cat([rois[:, 0:6] * scales[:, None], rois[:, 6:]], dim=-1)
    flip = torch.sign(draws.flip - 0.5)
    pts = torch.cat([pts[..., 0:1] * flip[:, None, None], pts[..., 1:]], dim=-1)

    def flip_box(b):
        ry = torch.where(flip == 1.0, b[:, 6], torch.sign(b[:, 6]) * math.pi - b[:, 6])
        return torch.cat([(b[:, 0] * flip)[:, None], b[:, 1:6], ry[:, None]], dim=-1)

    return pts, flip_box(rois), flip_box(gts)


def sample_rcnn_rois(rois: torch.Tensor, roi_valid: torch.Tensor, gt: torch.Tensor,
                     gt_ok: torch.Tensor, draws: RCNNDraws, rois_per_instance: int = 16,
                     fg_ratio: float = 0.5, reg_fg_thresh: float = 0.55,
                     cls_fg_thresh: float = 0.6, cls_bg_thresh: float = 0.45,
                     cls_bg_thresh_lo: float = 0.05, hard_bg_ratio: float = 0.8):
    """rois (R, M, 7), roi_valid (R, M), gt (R, 7) one matched GT per
    instance, gt_ok (R,) -> (rois (R, K, 7), iou (R, K), fg_slot (R, K),
    ok (R, K)): up to K * fg_ratio foreground proposals, then hard
    background up to hard_bg_ratio of the rest, then easy background, each
    class in the order of its priorities (proposal_target_layer
    sample_rois_for_rcnn + sample_bg_inds)."""
    r, m, _ = rois.shape
    n_fg = int(round(rois_per_instance * fg_ratio))
    n_bg = rois_per_instance - n_fg
    n_hard = int(round(n_bg * hard_bg_ratio))
    iou = iou3d(rois, gt[:, None].expand_as(rois)) * roi_valid
    is_fg = (iou >= min(reg_fg_thresh, cls_fg_thresh)) & roi_valid & gt_ok[:, None]
    hard = (iou >= cls_bg_thresh_lo) & (iou < cls_bg_thresh) & roi_valid
    easy = (iou < cls_bg_thresh_lo) & roi_valid

    def prio(u, mask):
        return torch.where(mask, u, torch.full_like(u, -1.0))

    fg_idx = topk_scores(prio(draws.fg, is_fg), n_fg)[1]
    hard_idx = topk_scores(prio(draws.hard, hard), n_bg)[1]
    easy_idx = topk_scores(prio(draws.easy, easy), n_bg)[1]
    fg_cnt = is_fg.sum(1, keepdim=True).clamp_max(n_fg)
    hard_cnt = hard.sum(1, keepdim=True).clamp_max(n_hard)
    slot = torch.arange(n_bg, device=rois.device)[None, :]
    from_easy = torch.gather(easy_idx, 1, (slot - hard_cnt).clamp_min(0))
    bg_idx = torch.where(slot < hard_cnt, hard_idx, from_easy)
    bg_ok = (slot < hard_cnt) | torch.gather(easy, 1, from_easy)
    idx = torch.cat([fg_idx, bg_idx], dim=1)
    fg_slot = torch.arange(n_fg, device=rois.device)[None, :] < fg_cnt
    ok = torch.cat([fg_slot, bg_ok], dim=1)
    fg_slot = torch.cat([fg_slot, torch.zeros_like(bg_ok)], dim=1)
    return (torch.gather(rois, 1, idx[..., None].expand(-1, -1, 7)), torch.gather(iou, 1, idx),
            fg_slot, ok)


def prepare_rcnn_train_inputs(rois: torch.Tensor, roi_valid: torch.Tensor, gt: torch.Tensor,
                              gt_ok: torch.Tensor, xyz: torch.Tensor, rpn_feats: torch.Tensor,
                              seg_mask: torch.Tensor, draws: RCNNDraws,
                              rois_per_instance: int = 16, num_points: int = 512,
                              aug_data: bool = True, fg_aug_times: int = FG_AUG_TIMES,
                              aug_rot_range: float = AUG_ROT_RANGE,
                              reg_fg_thresh: float = 0.55,
                              cls_fg_thresh: float = 0.6, cls_bg_thresh: float = 0.45,
                              pool_extra_width: float = 1.0):
    """The proposal target layer (proposal_target_layer.py:15-120): sample,
    noise the rois, pool (RoI-pool 3D), rotate/scale/flip, canonical frame.
    rois (R, M, 7) rect frame, roi_valid (R, M), gt (R, 7), gt_ok (R,), xyz
    (R, N, 3), rpn_feats (R, N, C), seg_mask (R, N) -> (pts_input (R, K,
    num_points, 5 + C), cls_label (R, K) of 1/0/-1, reg_mask (R, K), gt_ct
    (R, K, 7) canonical GT, rois (R, K, 7), valid (R, K)). Labels come from
    the noised rois' IoU; an empty pooled roi is ignored. aug_data (AUG_DATA)
    turns on the noise, fg_aug_times trials of a foreground roi
    (ROI_FG_AUG_TIMES; 0 skips it), and the rotation (up to pi /
    aug_rot_range, AUG_ROT_RANGE), scaling and flip; draws holds at least
    fg_aug_times trials."""
    r, k = rois.shape[0], rois_per_instance
    s_rois, s_iou, fg_slot, ok = sample_rcnn_rois(
        rois, roi_valid, gt, gt_ok, draws, rois_per_instance=k, reg_fg_thresh=reg_fg_thresh,
        cls_fg_thresh=cls_fg_thresh, cls_bg_thresh=cls_bg_thresh)
    gt_rep = gt[:, None, :].expand(r, k, 7)
    if aug_data and fg_aug_times > 0:
        a_rois, a_iou = aug_roi_by_noise(
            s_rois.reshape(r * k, 7), gt_rep.reshape(r * k, 7), s_iou.reshape(r * k),
            min(reg_fg_thresh, cls_fg_thresh), draws, fg_aug_times, fg_slot.reshape(r * k))
        s_rois, s_iou = a_rois.reshape(r, k, 7), a_iou.reshape(r, k)
    pooled, empty = _pool(xyz, rpn_feats, seg_mask, s_rois, num_points, pool_extra_width)
    p_xyz, p_feats = pooled[..., 0:3], pooled[..., 3:]
    if aug_data:
        pts_f, rois_f, gts_f = rcnn_data_augmentation(
            p_xyz.reshape(r * k, num_points, 3), s_rois.reshape(r * k, 7),
            gt_rep.reshape(r * k, 7), draws, aug_rot_range)
        p_xyz = pts_f.reshape(r, k, num_points, 3)
        s_rois, gt_rep = rois_f.reshape(r, k, 7), gts_f.reshape(r, k, 7)
    p_xyz = rotate_points_along_y((p_xyz - s_rois[:, :, None, 0:3]).reshape(r * k, num_points, 3),
                                  s_rois[..., 6].reshape(r * k)).reshape(r, k, num_points, 3)
    gt_ct = canonical_gt(s_rois, gt_rep)
    valid = ok & ~empty
    one, zero, ign = (torch.full_like(s_iou, v) for v in (1.0, 0.0, -1.0))
    cls = torch.where(s_iou > cls_fg_thresh, one, torch.where(s_iou < cls_bg_thresh, zero, ign))
    cls_label = torch.where(valid, cls, ign)
    reg_mask = (s_iou > reg_fg_thresh) & valid
    return torch.cat([p_xyz, p_feats], dim=-1), cls_label, reg_mask, gt_ct, s_rois, valid


RCNN_LOSS_CLS = ("BinaryCrossEntropy", "SigmoidFocalLoss")


def rcnn_loss(cls_pred: torch.Tensor, reg_pred: torch.Tensor, cls_label: torch.Tensor,
              reg_mask: torch.Tensor, gt_ct: torch.Tensor, anchor_size: torch.Tensor,
              loss_cls: str = "BinaryCrossEntropy", focal_alpha: float = 0.25,
              focal_gamma: float = 2.0) -> torch.Tensor:
    """The RCNN loss (rcnn_loss.py:27-134): the classification loss over the
    labelled rois plus the bin-based loc + angle + 3 * size over reg_mask.
    cls_pred (B,), reg_pred (B, C), cls_label (B,) of 1/0/-1, reg_mask
    (B,), gt_ct (B, 7). The classification loss by RCNN.LOSS_CLS:
    "BinaryCrossEntropy" averaged over the labelled rois, or
    "SigmoidFocalLoss" (alpha, gamma) summed over them and divided by the
    labelled foreground (at least 1; rcnn_loss.py:57-72). The reference's
    "CrossEntropy" branch reads an undefined name, and the JAX package
    leaves it out: it raises here, as any other name does."""
    if loss_cls not in RCNN_LOSS_CLS:
        raise ValueError(f"RCNN.LOSS_CLS {loss_cls!r}: one of {RCNN_LOSS_CLS}")
    t = (cls_label > 0).to(cls_pred.dtype)
    care = (cls_label >= 0).to(cls_pred.dtype)
    if loss_cls == "SigmoidFocalLoss":
        raw = sigmoid_focal_loss_binary(cls_pred, t, focal_gamma, focal_alpha)
        cls_l = (raw * care).sum() / sum_over_ranks((t * care).sum()).clamp_min(1.0)
    else:
        cls_l = (binary_cross_entropy(cls_pred, t) * care).sum() / sum_over_ranks(
            care.sum()).clamp_min(1.0)
    loc, angle, size = codec.reg_loss(reg_pred, gt_ct, reg_mask.to(cls_pred.dtype),
                                      anchor_size, RCNN_CODEC)
    return cls_l + loc + angle + 3.0 * size
