"""Config -> model construction (counterpart of disprcnn_tpu/models/build.py;
reference modeling/detector/detectors.py:11-14).

``build_detection_model(cfg, device="cuda")`` builds the port's model of
MODEL.META_ARCHITECTURE, as the JAX build_detection_model dispatches:
- MODEL.RETINANET_ON: ``RetinaNetDetector`` (R-x-FPN over P3-P7; the body
  is CONV_BODY without -FPN and -RETINANET, num_classes
  RETINANET.NUM_CLASSES - 1, max_det TEST.DETECTIONS_PER_IMG);
- "GeneralizedRCNN" with MODEL.STEREO_ON False: the mono
  ``GeneralizedRCNN`` on CONV_BODY as given (R-x-C4, R-x-C5, R-x-FPN or
  FBNet[-<arch>]), max_det TPU.MAX_DETECTIONS;
- "DispRCNN", or "GeneralizedRCNN" with MODEL.STEREO_ON: the 2D stereo
  detector (``DispRCNN``), as every shipped mask.yaml asks;
  on a ResNet-FPN or FBNet[-<arch>]-FPN body (MODEL.FBNET.{SCALE_FACTOR,
  WIDTH_DIVISOR, DW_CONV_SKIP_BN, DW_CONV_SKIP_RELU}), with
  MODEL.BACKBONE.USE_GN / MODEL.FPN.USE_GN (GroupNorm), MODEL.MASK_ON and
  MODEL.DISPNET_ON (DispModule, wired from MODEL.DISPNET.{MAX_DISP,
  MIN_DISP, RESOLUTIONS[0], DISP_RESOLUTIONS[0], CONV_LAYERS, LOSS_WEIGHT}
  as the JAX build_detection_model wires them);
- "DispRCNN3D": the stage 2-4 model over offline 2D predictions, with
  MODEL.POINTRCNN.RPN.NMS_TYPE ("rotate": the rotated BEV NMS),
  TEST.RPN_DISTANCE_BASED_PROPOSE and RPN.LOSS_CLS (BinaryCrossEntropy,
  SigmoidFocalLoss or DiceLoss, at the JAX package's focal alpha 0.25 and
  gamma 2).
Each reads the keys the JAX build reads for that model and no other: the
RetinaNet and mono models do not read RETINANET.NUM_CONVS, PRIOR_PROB,
BBOX_REG_WEIGHT, BBOX_REG_BETA, USE_C5 or STRADDLE_THRESH, nor the RPN's
and ROI heads' matching thresholds and sampler sizes (the JAX models fix
them at the reference defaults), and neither reads MODEL.FBNET.ARCH (an
FBNet body's arch is its name's).

The JAX build passes some settings that the port's constructors do not
take, because the port runs one value of each. For those the build reads
the config and raises ValueError, naming the key and the ROADMAP item,
whenever the config asks for another value:

| key | the port runs | item |
|---|---|---|
| MODEL.BACKBONE.FREEZE_CONV_BODY_AT (ResNet bodies; every model) | 2 (stem and layer1 detached) | A7 |
| MODEL.RPN.STRADDLE_THRESH (DispRCNN) | anchors.STRADDLE_THRESH (0) | A7 |
| MODEL.RPN.FG/BG_IOU_THRESHOLD, BATCH_SIZE_PER_IMAGE, POSITIVE_FRACTION (DispRCNN) | stereo_rpn.loss's defaults | A7 |
| MODEL.ROI_HEADS.FG/BG_IOU_THRESHOLD, POSITIVE_FRACTION (DispRCNN) | box_head.subsample's defaults | A7 |
| MODEL.POINTRCNN.RPN.FIXED (DET3D_ON) | equal to RCNN.ENABLED | A4.4 |
| MODEL.POINTRCNN.RCNN.LOSS_CLS (RCNN.ENABLED) | BinaryCrossEntropy | A7 |
| MODEL.POINTRCNN.AUG_DATA, RCNN.ROI_FG_AUG_TIMES, AUG_ROT_RANGE (RCNN.ENABLED) | True, rcnn3d.FG_AUG_TIMES, rcnn3d.AUG_ROT_RANGE | A7 |
| MODEL.POINTRCNN.TRAIN.RPN_NMS_THRESH (RCNN.ENABLED) | point_rcnn.TRAIN_RPN_NMS_THRESH (0.85) | A7 |

A key is checked only where the JAX model would read it (the DISPNET_*
widths only with their module on, FREEZE_CONV_BODY_AT only with a ResNet
body, the 3D train settings only with the 3D stage on). Every one of the
20 configs under configs/ sets the port's values.

Read and not obeyed: TPU.COMPUTE_DTYPE and TPU.PARAM_DTYPE (the port
computes in float32, ROADMAP C7), and the TPU layout keys TPU.REMAT_* and
TPU.MESH_*. Obeyed: TPU.MAX_DETECTIONS, TPU.ROI_CROP_SIZE and
TPU.SRPN_QUIRK_EXACT here, and TPU.MAX_GT by the datasets
(data/catalog.py). POINTRCNN.TEST.RPN_PRE_NMS_TOP_N above the cloud's
points (rcnn.yaml's 9000 over 768) is capped at the points in the
forward, as in the JAX package.
"""
from __future__ import annotations

import inspect

import torch

from .backbone.resnet import body_blocks
from .detector.disprcnn import DispRCNN
from .detector.disprcnn3d import DispRCNN3D
from .detector.generalized_rcnn import GeneralizedRCNN
from .detector.retinanet_det import RetinaNetDetector
from .pointrcnn import point_rcnn, rcnn3d
from .roi_heads import box_head
from .rpn import anchors, stereo_rpn


def _default(fn, name: str):
    return inspect.signature(fn).parameters[name].default


def _require(cfg, key: str, want, item: str) -> None:
    node = cfg
    for part in key.split("."):
        node = node[part]
    if node != want:
        raise ValueError(f"{key} = {node!r}: the port runs only {want!r} (ROADMAP {item})")


def _check_body(cfg, body: str) -> None:
    """A ResNet body (its blocks known) with FREEZE_CONV_BODY_AT 2, or an
    FBNet body (which the JAX package never freezes, and so does not read
    FREEZE_CONV_BODY_AT for)."""
    if body.startswith("FBNet"):
        return
    try:
        body_blocks(body)
    except KeyError:
        raise ValueError(f"MODEL.BACKBONE.CONV_BODY = {cfg.MODEL.BACKBONE.CONV_BODY!r}: not a "
                         "ResNet (R-50/101/152) or FBNet body") from None
    _require(cfg, "MODEL.BACKBONE.FREEZE_CONV_BODY_AT", 2, "A7")


def _check_2d(cfg) -> str:
    """The 2D stereo detector's fixed settings; -> its body."""
    body = cfg.MODEL.BACKBONE.CONV_BODY.replace("-FPN", "")
    _check_body(cfg, body)
    fixed = (
        ("MODEL.RPN.STRADDLE_THRESH", anchors.STRADDLE_THRESH, "A7"),
        ("MODEL.RPN.FG_IOU_THRESHOLD", _default(stereo_rpn.loss, "fg_iou"), "A7"),
        ("MODEL.RPN.BG_IOU_THRESHOLD", _default(stereo_rpn.loss, "bg_iou"), "A7"),
        ("MODEL.RPN.BATCH_SIZE_PER_IMAGE", _default(stereo_rpn.loss, "batch_per_image"), "A7"),
        ("MODEL.RPN.POSITIVE_FRACTION", _default(stereo_rpn.loss, "positive_fraction"), "A7"),
        ("MODEL.ROI_HEADS.FG_IOU_THRESHOLD", _default(box_head.subsample, "fg_iou"), "A7"),
        ("MODEL.ROI_HEADS.BG_IOU_THRESHOLD", _default(box_head.subsample, "bg_iou"), "A7"),
        ("MODEL.ROI_HEADS.POSITIVE_FRACTION",
         _default(box_head.subsample, "positive_fraction"), "A7"),
    )
    for key, want, item in fixed:
        _require(cfg, key, want, item)
    return body


def _check_3d(cfg) -> None:
    """The 3D stage's fixed settings (read only with DET3D_ON, as the JAX
    model reads them)."""
    p = cfg.MODEL.POINTRCNN
    if not cfg.MODEL.DET3D_ON:
        return
    _require(cfg, "MODEL.POINTRCNN.RPN.FIXED", p.RCNN.ENABLED, "A4.4")
    if p.RCNN.ENABLED:
        _require(cfg, "MODEL.POINTRCNN.RCNN.LOSS_CLS", "BinaryCrossEntropy", "A7")
        _require(cfg, "MODEL.POINTRCNN.AUG_DATA", True, "A7")
        _require(cfg, "MODEL.POINTRCNN.RCNN.ROI_FG_AUG_TIMES", rcnn3d.FG_AUG_TIMES, "A7")
        _require(cfg, "MODEL.POINTRCNN.AUG_ROT_RANGE", rcnn3d.AUG_ROT_RANGE, "A7")
        _require(cfg, "MODEL.POINTRCNN.TRAIN.RPN_NMS_THRESH", point_rcnn.TRAIN_RPN_NMS_THRESH,
                 "A7")


def build_detection_model(cfg, device: str | torch.device = "cuda", kernels_off=frozenset()):
    """The port's model of `cfg` on `device`, with constructor-default
    weights (utils/weights.py loads or draws them). kernels_off routes
    PointNet++ families off a DispRCNN3D (models/pointrcnn/pointnet2.py)."""
    meta = cfg.MODEL.META_ARCHITECTURE
    if cfg.MODEL.RETINANET_ON:
        r = cfg.MODEL.RETINANET
        body = cfg.MODEL.BACKBONE.CONV_BODY.replace("-FPN", "").replace("-RETINANET", "")
        _check_body(cfg, body)
        return RetinaNetDetector(
            body=body,
            out_channels=cfg.MODEL.RESNETS.BACKBONE_OUT_CHANNELS,
            num_classes=r.NUM_CLASSES - 1,
            anchor_sizes=tuple(r.ANCHOR_SIZES),
            anchor_strides=tuple(r.ANCHOR_STRIDES),
            aspect_ratios=tuple(r.ASPECT_RATIOS),
            octave=r.OCTAVE,
            scales_per_octave=r.SCALES_PER_OCTAVE,
            fg_iou=r.FG_IOU_THRESHOLD,
            bg_iou=r.BG_IOU_THRESHOLD,
            loss_gamma=r.LOSS_GAMMA,
            loss_alpha=r.LOSS_ALPHA,
            pre_nms_top_n=r.PRE_NMS_TOP_N,
            score_thresh=r.INFERENCE_TH,
            nms_thresh=r.NMS_TH,
            max_det=cfg.TEST.DETECTIONS_PER_IMG,
            use_gn=cfg.MODEL.BACKBONE.USE_GN,
            device=device,
        )
    if meta == "GeneralizedRCNN" and not cfg.MODEL.STEREO_ON:
        rpn = cfg.MODEL.RPN
        _check_body(cfg, cfg.MODEL.BACKBONE.CONV_BODY)
        return GeneralizedRCNN(
            body=cfg.MODEL.BACKBONE.CONV_BODY,
            out_channels=cfg.MODEL.RESNETS.BACKBONE_OUT_CHANNELS,
            anchor_sizes=tuple(rpn.ANCHOR_SIZES),
            anchor_strides=tuple(rpn.ANCHOR_STRIDE),
            aspect_ratios=tuple(rpn.ASPECT_RATIOS),
            pre_nms_top_n_train=rpn.PRE_NMS_TOP_N_TRAIN,
            pre_nms_top_n_test=rpn.PRE_NMS_TOP_N_TEST,
            post_nms_top_n_train=rpn.POST_NMS_TOP_N_TRAIN,
            post_nms_top_n_test=rpn.POST_NMS_TOP_N_TEST,
            rpn_nms_thresh=rpn.NMS_THRESH,
            num_classes=cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES,
            mlp_head_dim=cfg.MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM,
            roi_batch_per_image=cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
            score_thresh=cfg.MODEL.ROI_HEADS.SCORE_THRESH,
            box_nms_thresh=cfg.MODEL.ROI_HEADS.NMS,
            max_det=cfg.TPU.MAX_DETECTIONS,
            mask_on=cfg.MODEL.MASK_ON,
            use_gn=cfg.MODEL.BACKBONE.USE_GN,
            fbnet_scale_factor=cfg.MODEL.FBNET.SCALE_FACTOR,
            fbnet_width_divisor=cfg.MODEL.FBNET.WIDTH_DIVISOR,
            device=device,
        )
    if meta in ("DispRCNN", "GeneralizedRCNN"):
        body = _check_2d(cfg)
        rpn, heads = cfg.MODEL.RPN, cfg.MODEL.ROI_HEADS
        box, mask = cfg.MODEL.ROI_BOX_HEAD, cfg.MODEL.ROI_MASK_HEAD
        disp = cfg.MODEL.DISPNET
        return DispRCNN(
            body=body,
            out_channels=cfg.MODEL.RESNETS.BACKBONE_OUT_CHANNELS,
            anchor_sizes=tuple(rpn.ANCHOR_SIZES),
            anchor_strides=tuple(rpn.ANCHOR_STRIDE),
            aspect_ratios=tuple(rpn.ASPECT_RATIOS),
            pre_nms_top_n_train=rpn.PRE_NMS_TOP_N_TRAIN,
            pre_nms_top_n_test=rpn.PRE_NMS_TOP_N_TEST,
            post_nms_top_n_train=rpn.POST_NMS_TOP_N_TRAIN,
            post_nms_top_n_test=rpn.POST_NMS_TOP_N_TEST,
            rpn_nms_thresh=rpn.NMS_THRESH,
            rpn_min_size=rpn.MIN_SIZE,
            num_classes=box.NUM_CLASSES,
            mlp_head_dim=box.MLP_HEAD_DIM,
            box_resolution=box.POOLER_RESOLUTION,
            box_sampling_ratio=box.POOLER_SAMPLING_RATIO,
            pooler_scales=tuple(box.POOLER_SCALES),
            roi_batch_per_image=heads.BATCH_SIZE_PER_IMAGE,
            score_thresh=heads.SCORE_THRESH,
            box_nms_thresh=heads.NMS,
            detections_per_img=cfg.TEST.DETECTIONS_PER_IMG,
            max_det=cfg.TPU.MAX_DETECTIONS,
            mask_on=cfg.MODEL.MASK_ON,
            mask_resolution=mask.POOLER_RESOLUTION,
            mask_sampling_ratio=mask.POOLER_SAMPLING_RATIO,
            dispnet_on=cfg.MODEL.DISPNET_ON,
            dispnet_maxdisp=disp.MAX_DISP,
            dispnet_mindisp=disp.MIN_DISP,
            dispnet_resolution=disp.RESOLUTIONS[0],
            dispnet_disp_resolution=disp.DISP_RESOLUTIONS[0],
            dispnet_conv_layers=tuple(disp.CONV_LAYERS),
            dispnet_loss_weight=disp.LOSS_WEIGHT,
            use_gn=cfg.MODEL.BACKBONE.USE_GN,
            use_gn_fpn=cfg.MODEL.FPN.USE_GN,
            srpn_quirk_exact=cfg.TPU.SRPN_QUIRK_EXACT,
            fbnet_scale_factor=cfg.MODEL.FBNET.SCALE_FACTOR,
            fbnet_width_divisor=cfg.MODEL.FBNET.WIDTH_DIVISOR,
            fbnet_dw_skip_bn=cfg.MODEL.FBNET.DW_CONV_SKIP_BN,
            fbnet_dw_skip_relu=cfg.MODEL.FBNET.DW_CONV_SKIP_RELU,
            device=device,
        )
    if meta == "DispRCNN3D":
        _check_3d(cfg)
        p = cfg.MODEL.POINTRCNN
        if cfg.SOLVER.TRAIN_PSM:
            max_roi_train = cfg.MODEL.DISPNET.MAX_ROI_FOR_TRAINING
        elif cfg.SOLVER.TRAIN_PC:
            max_roi_train = cfg.MODEL.PCNET.MAX_ROI_FOR_TRAINING
        else:
            max_roi_train = 0
        return DispRCNN3D(
            max_det=cfg.TPU.MAX_DETECTIONS,
            roi_size=cfg.TPU.ROI_CROP_SIZE,
            maxdisp=cfg.MODEL.DISPNET.MAX_DISP,
            mindisp=cfg.MODEL.DISPNET.MIN_DISP,
            npoints=p.RPN.NPOINTS,
            # the reference thresholds both paths by POINTRCNN.MASK_THRESH
            mask_thresh_train=p.MASK_THRESH,
            mask_thresh_eval=p.MASK_THRESH,
            # every shipped config writes MEAN_SIZE as (h, w, l), the codec's order
            mean_size=tuple(p.MEAN_SIZE[0]),
            det3d_on=cfg.MODEL.DET3D_ON,
            rcnn_enabled=p.RCNN.ENABLED,
            rcnn_rois_per_instance=p.RCNN.ROI_PER_IMAGE,
            roi_min_score=cfg.MODEL.DISPNET.ROI_MIN_SCORE,
            max_roi_train=max_roi_train,
            sa_npoints=tuple(p.RPN.SA_CONFIG.NPOINTS),
            rpn_score_thresh=p.RPN.SCORE_THRESH,
            rpn_nms_thresh=p.TEST.RPN_NMS_THRESH,
            rpn_nms_rotated=p.RPN.NMS_TYPE == "rotate",
            rpn_distance_based=p.TEST.RPN_DISTANCE_BASED_PROPOSE,
            rpn_loss_cls=p.RPN.LOSS_CLS,
            rpn_pre_nms_per_roi=p.TEST.RPN_PRE_NMS_TOP_N,
            proposals_per_roi=p.TEST.RPN_POST_NMS_TOP_N,
            rpn_pre_nms_per_roi_train=p.TRAIN.RPN_PRE_NMS_TOP_N,
            proposals_per_roi_train=p.TRAIN.RPN_POST_NMS_TOP_N,
            kernels_off=frozenset(kernels_off),
            device=device,
        )
    raise NotImplementedError(meta)
