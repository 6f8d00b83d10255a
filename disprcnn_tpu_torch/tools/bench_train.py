"""The port's train stages for the bench (counterpart of
tools/bench_train.py: bench_2d and bench_3d): the DispRCNN 2D step of the
mask stage (``2d``, configs/kitti/car/vob/mask.yaml: backbone, RPN and box
head frozen, the mask head trains, all five losses computed) at 4 pairs a
step, and the DispRCNN3D train step of the iDispNet stage (``psm``,
idispnet.yaml) and of the RCNN stage (``pc``, rcnn.yaml) at bench_3d's
geometry (384x1248 pairs, 16 detections each), with random weights and
synthetic detections and ground truth made from a seeded torch.Generator.
``rpn_stage`` builds the 3D RPN stage's step (rpn.yaml) the same way; the
bench does not time it yet.

``build_stage(name, pairs, gen)`` returns a ``TrainStage`` (model,
optimizer, step, batch); ``time_steps`` runs and times it. chip_smoke.py
builds its train steps (phases 15, 16, 18 and 19) from the same pieces.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import torch

from torch import nn

from ..bench import BENCH_3D, CALIB, IMG_HW, PIXEL_MEAN_BGR, timed
from ..engine.trainer import make_train_step
from ..models.detector.disprcnn import DispRCNN
from ..models.detector.disprcnn3d import DispRCNN3D
from ..models.pointrcnn import lift, rcnn3d, rpn3d
from ..ops import roipool3d as troi
from ..solver.build import frozen_path_prefixes, make_optimizer
from ..solver.schedules import one_cycle, one_cycle_momentum
from ..structures.stereo import StereoBoxes
from ..utils.weights import init_random_

# The stage configs at bench_3d's geometry. idispnet.yaml: ROI_MIN_SCORE
# 0.5, MAX_ROI_FOR_TRAINING 12, WEIGHT_DECAY 1e-4, OneCycle BASE_LR 0.01
# over MAX_ITER 41000; rcnn.yaml: MASK_THRESH 0.5, RPN.FIXED,
# TRAIN.RPN_PRE/POST_NMS_TOP_N 9000/512 (pre capped at the 768 points),
# the defaults' TRAIN.RPN_NMS_THRESH 0.85,
# RCNN.ROI_PER_IMAGE 16, FIX_DISPARITY, FIX_POINTRCNN_RPN, DO_GRAD_CLIP,
# MAX_ITER 62100; the defaults' MOMENTUM 0.9, BIAS_LR_FACTOR 2 and
# WEIGHT_DECAY_BIAS 0, GRAD_CLIP 10 as bench_3d sets it
PSM_TRAIN = dict(max_det=16, roi_size=224, maxdisp=48, mindisp=-48, roi_min_score=0.5,
                 max_roi_train=12)
PC_TRAIN = dict(BENCH_3D, mask_thresh_train=0.5, rpn_pre_nms_per_roi_train=768,
                proposals_per_roi_train=512, rpn_nms_thresh_train=0.85,
                rcnn_rois_per_instance=16, rpn_fixed=True)
# rcnn.yaml with RPN.FIXED False and FIX_POINTRCNN_RPN False: the RPN (in
# train mode, dropout on fixed masks) and the RCNN trained in one step
JOINT_TRAIN = dict(PC_TRAIN, rpn_fixed=False)
# rpn.yaml: IMS_PER_BATCH 3, PCNET.MAX_ROI_FOR_TRAINING 20 (no cap on 16
# detections), MASK_THRESH 0.5, RPN.LOSS_CLS BinaryCrossEntropy (cfg's
# rpn_loss_cls takes the other forms), the RPN training (RPN.FIXED False) and no RCNN
# (RCNN.ENABLED False), FIX_DISPARITY, DO_GRAD_CLIP, OneCycle BASE_LR 0.002
# over MAX_ITER 27600
RPN_TRAIN = dict(BENCH_3D, mask_thresh_train=0.5, mask_thresh_eval=0.5, max_roi_train=20,
                 rcnn_enabled=False)
RPN_PAIRS, RPN_LR = 3, 0.002
PSM_ITER, PC_ITER, RPN_ITER, GRAD_CLIP = 41000, 62100, 27600, 10.0
SOLVER = dict(momentum=0.9, weight_decay=1e-4, weight_decay_bias=0.0, bias_lr_factor=2.0)
# mask.yaml: R-101-FPN, IMS_PER_BATCH 4, RPN.PRE_NMS_TOP_N_TRAIN 2000 (and the
# defaults' POST_NMS_TOP_N_TRAIN 2000, 512 ROIs an image at 0.25 positive),
# FIX_BACKBONE, FIX_RPN, FIX_BOX_HEAD, DO_GRAD_CLIP, OneCycle BASE_LR 0.01
# over MAX_ITER 4140 with BIAS_LR_FACTOR 1 and WEIGHT_DECAY 5e-4 (the model's
# defaults hold the RPN and ROI budgets); bench_2d's 8 GT slots an image
DET2D_TRAIN = dict(body="R-101")
DET2D_PAIRS, DET2D_GT, DET2D_LR, DET2D_ITER = 4, 8, 0.01, 4140
DET2D_SOLVER = dict(momentum=0.9, weight_decay=5e-4, weight_decay_bias=0.0, bias_lr_factor=1.0)
DET2D_FROZEN = dict(FIX_BACKBONE=True, FIX_RPN=True, FIX_BOX_HEAD=True)
# pairs a step in the JAX bench's train stages (bench.py:412; bench_2d at
# mask.yaml's IMS_PER_BATCH)
BENCH_PAIRS = {"psm": 1, "pc": 1, "2d": DET2D_PAIRS}


@dataclass
class TrainStage:
    model: nn.Module
    optimizer: object
    step: object
    batch: dict
    units: int  # crops a step (psm) or pairs a step (pc, rpn, 2d)
    pairs: int
    with_points: int = 0  # pc: instances with lifted points in a proposal
    positive: int = 0  # rpn: points labelled inside their GT box
    ignored: int = 0  # rpn: points in the 0.2 band around it (label -1)
    # 2d: the last step's sampled positive ROIs, "roi_pos" (B, proposals)
    record: dict = field(default_factory=dict)


def random_dets(gen: torch.Generator, b: int, d: int, img_hw=IMG_HW) -> StereoBoxes:
    """(b, d) stereo detections inside img_hw: boxes 60-360 x 60-200 px
    (narrower on a small image), the right box 10-30 px left of the left
    one, scores above 0.55, masks uniform; on gen's device."""
    h, w = img_hw
    bw, bh = min(300, (w - 60) // 2), min(140, (h - 60) // 2)

    def u(*shape):
        return torch.rand(shape, generator=gen, device=gen.device)

    x1, y1 = u(b, d) * (w - 60 - bw), u(b, d) * (h - 60 - bh)
    left = torch.stack([x1, y1, x1 + 60 + bw * u(b, d), y1 + 60 + bh * u(b, d)], -1)
    shift = 10 + 20 * u(b, d)
    right = left - torch.stack([shift, torch.zeros_like(shift)] * 2, -1)
    return StereoBoxes(left=left, right=right, score=0.55 + 0.45 * u(b, d),
                       valid=torch.ones(b, d, dtype=torch.bool, device=gen.device),
                       fields={"mask": u(b, d, 28, 28)})


def centre_rpn_boxes_(model: DispRCNN3D) -> None:
    """Scale the random RPN's box-regression output down and bias its x and
    z bins to the middle one: each proposal becomes a car-sized box about
    its point (the random head throws them off the clouds, and every pooled
    ROI comes out empty, so the sampler finds no foreground)."""
    out = model.pointrcnn.rpn.reg_head.out
    nbin = model.pointrcnn.rpn_codec.per_loc_bin_num
    with torch.no_grad():
        out.weight.mul_(0.01)
        out.bias.zero_()
        out.bias[[nbin // 2, nbin + nbin // 2]] = 2.0


def psm_stage(pairs: int, gen: torch.Generator, cfg: dict = PSM_TRAIN,
              img_hw=IMG_HW) -> TrainStage:
    """The iDispNet step: SGD with OneCycle, a smooth ground-truth
    disparity."""
    dev = gen.device
    model = init_random_(DispRCNN3D(**cfg, device=dev), gen)
    opt = make_optimizer(model, one_cycle(0.01, PSM_ITER), one_cycle_momentum(PSM_ITER),
                         **SOLVER)
    step = make_train_step(model, opt, forward_kwargs=dict(train_psm=True))
    h, w = img_hw
    cols = torch.arange(w, device=dev, dtype=torch.float32)
    batch = dict(left_img=torch.rand(pairs, h, w, 3, generator=gen, device=dev),
                 right_img=torch.rand(pairs, h, w, 3, generator=gen, device=dev),
                 dets=random_dets(gen, pairs, cfg["max_det"], img_hw),
                 gt_disp=(20 + 5 * torch.sin(cols / 40)).expand(pairs, h, w).contiguous())
    crops = pairs * min(cfg["max_det"], cfg.get("max_roi_train") or cfg["max_det"])
    return TrainStage(model, opt, step, batch, crops, pairs)


def pc_stage(pairs: int, gen: torch.Generator, cfg: dict = PC_TRAIN, img_hw=IMG_HW,
             calib: dict = CALIB) -> TrainStage:
    """The RCNN step on a fixed RPN (PC_TRAIN), or with cfg JOINT_TRAIN the
    RPN and the RCNN in one step (the RPN trains too, its dropout on fixed
    masks), the RPN's box regression centred (centre_rpn_boxes_): each
    instance's ground-truth box is its proposal that holds the most lifted
    points, found by one train-mode forward. Raises if no instance has a
    proposal with points."""
    dev = gen.device
    model = init_random_(DispRCNN3D(**cfg, device=dev), gen)
    centre_rpn_boxes_(model)
    fixed = model.pointrcnn.rpn_fixed
    frozen = frozen_path_prefixes(FIX_DISPARITY=True, FIX_POINTRCNN_RPN=fixed)
    opt = make_optimizer(model, one_cycle(0.01, PC_ITER), one_cycle_momentum(PC_ITER), frozen,
                         **SOLVER)
    step = make_train_step(model, opt, do_grad_clip=True, grad_clip=GRAD_CLIP,
                           forward_kwargs=dict(train_pc=True))
    h, w = img_hw
    d = cfg["max_det"]
    dets = random_dets(gen, pairs, d, img_hw)
    prc = model.pointrcnn
    batch = dict(left_img=torch.rand(pairs, h, w, 3, generator=gen, device=dev),
                 right_img=torch.rand(pairs, h, w, 3, generator=gen, device=dev),
                 dets=dets, calib={k: torch.full((pairs,), v, device=dev)
                                   for k, v in calib.items()},
                 priorities=torch.rand(pairs * d, cfg["lift_grid"] ** 2, generator=gen,
                                       device=dev),
                 rcnn_draws=rcnn3d.draw_rcnn_draws(pairs * d, prc.proposals_per_roi_train,
                                                   prc.rcnn_rois_per_instance, 10, gen, dev),
                 gt_left=dets.left, gt_valid=torch.ones(pairs, d, dtype=torch.bool, device=dev))
    if not fixed:
        batch["rpn_draws"] = rpn3d.draw_rpn_draws(pairs * d, cfg["npoints"], gen, dev)
    seen = {}
    orig = rcnn3d.prepare_rcnn_train_inputs

    def record(rois, roi_valid, gt, gt_ok, xyz, *args, **kwargs):
        seen.update(rois=rois, roi_valid=roi_valid, xyz=xyz)
        return orig(rois, roi_valid, gt, gt_ok, xyz, *args, **kwargs)

    rcnn3d.prepare_rcnn_train_inputs = record
    try:
        model.train()
        with torch.no_grad():
            model(**batch, gt_boxes3d=torch.zeros(pairs, d, 7, device=dev), train_pc=True)
    finally:
        rcnn3d.prepare_rcnn_train_inputs = orig
    inside = troi.pts_in_boxes3d(seen["xyz"], troi.enlarge_box3d(seen["rois"], 1.0)).sum(-1)
    inside = torch.where(seen["roi_valid"], inside, torch.zeros_like(inside))
    with_points = int((inside.amax(1) > 0).sum())
    if with_points == 0:
        raise AssertionError("RCNN step: no instance has a proposal with lifted points")
    rows = torch.arange(pairs * d, device=dev)
    batch["gt_boxes3d"] = seen["rois"][rows, inside.argmax(1)].reshape(pairs, d, 7)
    return TrainStage(model, opt, step, batch, pairs, pairs, with_points)


def boxes_on_clouds(pts_c: torch.Tensor, angles: torch.Tensor,
                    pts_mean: torch.Tensor) -> torch.Tensor:
    """One GT box (R, 7) rect frame on each canonical cloud (R, N, 3):
    centred at its median, the inter-quartile extent on each axis (at least
    0.5 m), yawed by 0.2 in the canonical frame, so that points fall inside
    it, in the 0.2 band around it and outside."""
    med = pts_c.median(dim=1).values
    q = torch.quantile(pts_c, torch.tensor([0.25, 0.75], device=pts_c.device), dim=1)
    ext = (q[1] - q[0]).clamp_min(0.5)
    canon = torch.stack([med[:, 0], med[:, 1] + ext[:, 1] / 2, med[:, 2], ext[:, 1], ext[:, 2],
                         ext[:, 0], torch.full_like(med[:, 0], 0.2)], -1)
    return lift.decanonicalize_boxes3d(canon, angles, pts_mean)


def rpn_stage(pairs: int, gen: torch.Generator, cfg: dict = RPN_TRAIN, img_hw=IMG_HW,
              calib: dict = CALIB) -> TrainStage:
    """The 3D RPN step (stage 3, rpn.yaml): iDispNet frozen, the RPN in
    train mode with fixed dropout masks, BCE (or cfg's rpn_loss_cls), grad
    clip 10. Each
    instance's ground-truth box lies on its own lifted cloud (one eval
    forward gives the clouds; boxes_on_clouds). Raises if no point is
    labelled positive or ignored."""
    dev = gen.device
    model = init_random_(DispRCNN3D(**cfg, device=dev), gen)
    opt = make_optimizer(model, one_cycle(RPN_LR, RPN_ITER), one_cycle_momentum(RPN_ITER),
                         frozen_path_prefixes(FIX_DISPARITY=True), **SOLVER)
    step = make_train_step(model, opt, do_grad_clip=True, grad_clip=GRAD_CLIP,
                           forward_kwargs=dict(train_pc=True))
    h, w = img_hw
    d = cfg["max_det"]
    dets = random_dets(gen, pairs, d, img_hw)
    rpn = model.pointrcnn.rpn
    batch = dict(left_img=torch.rand(pairs, h, w, 3, generator=gen, device=dev),
                 right_img=torch.rand(pairs, h, w, 3, generator=gen, device=dev),
                 dets=dets, calib={k: torch.full((pairs,), v, device=dev)
                                   for k, v in calib.items()},
                 priorities=torch.rand(pairs * d, cfg["lift_grid"] ** 2, generator=gen,
                                       device=dev),
                 rpn_draws=rpn3d.draw_rpn_draws(pairs * d, cfg["npoints"], gen, dev,
                                                (rpn.cls_head.hidden[0],
                                                 rpn.reg_head.hidden[0])),
                 gt_left=dets.left, gt_valid=torch.ones(pairs, d, dtype=torch.bool, device=dev))
    # the eval forward lifts the clouds that the train step lifts: the
    # scores pass ROI_MIN_SCORE, MAX_ROI_FOR_TRAINING does not cap and the
    # two mask thresholds are equal
    seen = []
    hook = model.pointrcnn.register_forward_pre_hook(lambda mod, args: seen.append(args[:4]))
    try:
        with torch.no_grad():
            model(batch["left_img"], batch["right_img"], dets, batch["calib"],
                  batch["priorities"])
    finally:
        hook.remove()
    pts_c, roi_ok, angles, pts_mean = seen[0]
    gt = boxes_on_clouds(pts_c, angles, pts_mean)
    batch["gt_boxes3d"] = gt.reshape(pairs, d, 7)
    labels = lift.rpn_point_labels(pts_c, lift.canonicalize_boxes3d(gt, angles, pts_mean),
                                   roi_ok)[0]
    positive, ignored = int((labels == 1).sum()), int((labels == -1).sum())
    if positive == 0 or ignored == 0:
        raise AssertionError(f"RPN step: {positive} positive and {ignored} ignored points")
    return TrainStage(model, opt, step, batch, pairs, pairs, int(roi_ok.sum()), positive,
                      ignored)


def gt_pairs(gen: torch.Generator, b: int, m: int, img_hw=IMG_HW) -> dict:
    """Padded 2D GT for b pairs on gen's device: 2-4 valid pairs of m slots
    an image, left boxes 60-360 x 40-200 px inside the image (narrower on a
    small one), the right box the left shifted 10-40 px left (a disparity),
    label 1, and as each mask a filled ellipse inside its left box."""
    dev = gen.device
    h, w = img_hw
    bw, bh = min(300, (w - 20) // 2), min(160, (h - 20) // 2)

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    sw, sh = 0.2 * bw + 0.8 * bw * u(b, m), 0.25 * bh + 0.75 * bh * u(b, m)
    x1, y1 = u(b, m) * (w - 1 - sw), u(b, m) * (h - 1 - sh)
    left = torch.stack([x1, y1, x1 + sw, y1 + sh], -1)
    shift = (10 + 30 * u(b, m)).clamp_max(x1 + 1)
    right = left - torch.stack([shift, torch.zeros_like(shift)] * 2, -1)
    count = torch.randint(2, 5, (b, 1), generator=gen, device=dev)
    valid = torch.arange(m, device=dev) < count
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    c = lambda i, j: ((left[..., i] + left[..., j]) / 2)[..., None, None]
    r = lambda i, j: ((left[..., j] - left[..., i]) * 0.45)[..., None, None]
    masks = (((xs - c(0, 2)) / r(0, 2)) ** 2 + ((ys - c(1, 3)) / r(1, 3)) ** 2 <= 1) \
        & valid[..., None, None]
    zero = lambda x: x * valid[..., None]
    return dict(gt_left=zero(left), gt_right=zero(right),
                gt_labels=valid.long(), gt_valid=valid, gt_masks=masks.float())


def det2d_stage(pairs: int, gen: torch.Generator, cfg: dict = DET2D_TRAIN, img_hw=IMG_HW,
                frozen: dict = DET2D_FROZEN) -> TrainStage:
    """The 2D step (stage 1, mask.yaml): random weights (init_random_: zero
    box regressors, so the proposals are the anchors), GT from gt_pairs,
    the images BGR255 less the pixel mean; the SOLVER.FIX_* flags in
    `frozen`. Each step draws its sampler priorities and dropout masks
    from `gen`, which the batch holds, and
    records its sampled positive ROIs in the stage's record (time_steps
    raises where an image has none)."""
    dev = gen.device
    model = init_random_(DispRCNN(**cfg, device=dev), gen)
    opt = make_optimizer(model, one_cycle(DET2D_LR, DET2D_ITER), one_cycle_momentum(DET2D_ITER),
                         frozen_path_prefixes(**frozen), **DET2D_SOLVER)
    step = make_train_step(model, opt, do_grad_clip=True, grad_clip=GRAD_CLIP)
    h, w = img_hw
    mean = torch.tensor(PIXEL_MEAN_BGR, device=dev)
    left, right = (torch.rand(pairs, h, w, 3, generator=gen, device=dev) * 255.0 - mean
                   for _ in range(2))
    batch = dict(left=left, right=right, **gt_pairs(gen, pairs, DET2D_GT, img_hw),
                 generator=gen)
    record = {}

    def keep_roi_pos(module, args, out):
        if module.training:
            record["roi_pos"] = out["roi_pos"]

    model.register_forward_hook(keep_roi_pos)
    return TrainStage(model, opt, step, batch, pairs, pairs, record=record)


def build_stage(name: str, pairs: int, gen: torch.Generator) -> TrainStage:
    """The train stage `name` ("2d", "psm" or "pc") at the bench's
    geometry."""
    if name == "2d":
        return det2d_stage(pairs, gen)
    if name == "psm":
        return psm_stage(pairs, gen)
    if name == "pc":
        return pc_stage(pairs, gen)
    raise ValueError(f"unknown train stage {name!r}: the stages are {tuple(BENCH_PAIRS)}")


def time_steps(stage: TrainStage, steps: int, warmup: int = 1) -> List[float]:
    """`warmup` untimed and `steps` timed steps -> ms per timed step (CUDA
    events on the card, the host clock on the CPU). Each step's losses must
    be finite, no step skipped, no trainable parameter left without a
    gradient and (2d) no image without a positive ROI."""
    ms = []
    for i in range(warmup + steps):
        m, dt = timed(lambda: stage.step(stage.batch), stage.model.device)
        if i >= warmup:
            ms.append(dt)
        losses = {k: float(v) for k, v in m.items() if k.startswith("loss")}
        if not all(v == v and abs(v) != float("inf") for v in losses.values()):
            raise AssertionError(f"train step: non-finite losses {losses}")
        if float(m["skipped_nonfinite"]) or int(m["params_without_grad"]):
            raise AssertionError(f"train step skipped or parameters without gradient: {m}")
        pos = stage.record.get("roi_pos")
        if pos is not None and not bool(pos.any(1).all()):
            raise AssertionError(f"2D step: positive ROIs per image {pos.sum(1).tolist()}")
    return ms
