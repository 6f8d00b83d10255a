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
Each reads the keys the JAX build reads for that model and passes them
as the JAX build does, MODEL.BACKBONE.FREEZE_CONV_BODY_AT (freeze_at) to
every model's ResNet body; DispRCNN also MODEL.RPN.STRADDLE_THRESH, the
SRPN's FG/BG_IOU_THRESHOLD, BATCH_SIZE_PER_IMAGE and POSITIVE_FRACTION and
the ROI heads' FG/BG_IOU_THRESHOLD and POSITIVE_FRACTION; DispRCNN3D also
MODEL.POINTRCNN.RPN.FIXED (rpn_fixed), RCNN.LOSS_CLS, AUG_DATA,
RCNN.ROI_FG_AUG_TIMES, AUG_ROT_RANGE and TRAIN.RPN_NMS_THRESH. The
RetinaNet and mono models do not read RETINANET.NUM_CONVS, PRIOR_PROB,
BBOX_REG_WEIGHT, BBOX_REG_BETA, USE_C5 or STRADDLE_THRESH, nor the RPN's
and ROI heads' matching thresholds and sampler sizes (the JAX models fix
them at the reference defaults), and neither reads MODEL.FBNET.ARCH (an
FBNet body's arch is its name's; an FBNet body is never frozen, as in
the JAX package).

TPU.COMPUTE_DTYPE (default bfloat16, as in the JAX build) is obeyed by
the models whose bf16 form is ported: DispRCNN3D (``dtype=torch.bfloat16``)
builds iDispNet at that dtype (idispnet.yaml; ROADMAP A8.1) and, with
MODEL.DET3D_ON (rpn.yaml, rcnn.yaml), PointRCNN too (A8.3), in eval and,
with ``train=True`` (tools/train_net.py), in train mode (A8.4), as JAX's
tools/train_net.py builds at the config's dtype; the lift between them
stays float32, as JAX's kernel route keeps it. The others compute in
float32 until their bf16 form is ported, and the build logs one line
naming the pending item: DispRCNN (its DispModule too), the mono models
and RetinaNet (A8.2), and with ``train=True`` their bf16 training after
it (A8.5: mask.yaml's 2D stage). TPU.PARAM_DTYPE is float32 in every
shipped config and the port's parameters are float32 (the bf16 kernels
round the weights where they pack them). Read and not obeyed: the TPU
layout keys TPU.REMAT_* and TPU.MESH_*. Obeyed: TPU.MAX_DETECTIONS,
TPU.ROI_CROP_SIZE and TPU.SRPN_QUIRK_EXACT here, and TPU.MAX_GT by the
datasets (data/catalog.py). POINTRCNN.TEST.RPN_PRE_NMS_TOP_N above the cloud's
points (rcnn.yaml's 9000 over 768) is capped at the points in the
forward, as in the JAX package.
"""
from __future__ import annotations

import logging
from typing import Optional

import torch

from .backbone.resnet import body_blocks
from .detector.disprcnn import DispRCNN
from .detector.disprcnn3d import DispRCNN3D
from .detector.generalized_rcnn import GeneralizedRCNN
from .detector.retinanet_det import RetinaNetDetector


def _check_body(cfg, body: str) -> None:
    """A ResNet body (its blocks known) or an FBNet body."""
    if body.startswith("FBNet"):
        return
    try:
        body_blocks(body)
    except KeyError:
        raise ValueError(f"MODEL.BACKBONE.CONV_BODY = {cfg.MODEL.BACKBONE.CONV_BODY!r}: not a "
                         "ResNet (R-50/101/152) or FBNet body") from None


# the ROADMAP item that ports each model's bf16 form, for the models that
# still compute in float32 at TPU.COMPUTE_DTYPE bfloat16
_BF16_PENDING = {"RetinaNetDetector": "A8.2", "GeneralizedRCNN": "A8.2", "DispRCNN": "A8.2"}


def _compute_dtype(cfg, model: str, obeyed: bool, train: bool,
                   logger: Optional[logging.Logger]) -> torch.dtype:
    """TPU.COMPUTE_DTYPE for `model`: bfloat16 where its bf16 form is ported
    (`obeyed`), in eval and in train, else float32, with one log line naming
    the pending ROADMAP item (and, built to train, the bf16 training item
    after it)."""
    if cfg.TPU.COMPUTE_DTYPE != "bfloat16":
        return torch.float32
    if obeyed:
        return torch.bfloat16
    item = _BF16_PENDING[model] + (", then A8.5" if train else "")
    (logger or logging.getLogger(__name__)).info(
        f"TPU.COMPUTE_DTYPE bfloat16: {model} {'trains' if train else 'computes'} in float32 "
        f"until its bf16 form is ported (ROADMAP {item})")
    return torch.float32


def build_detection_model(cfg, device: str | torch.device = "cuda", kernels_off=frozenset(),
                          train: bool = False, logger: Optional[logging.Logger] = None):
    """The port's model of `cfg` on `device`, with constructor-default
    weights (utils/weights.py loads or draws them). kernels_off routes
    PointNet++ families off a DispRCNN3D (models/pointrcnn/pointnet2.py).
    `train` builds the model to train (tools/train_net.py: at
    TPU.COMPUTE_DTYPE where the model's bf16 form is ported, ROADMAP A8.4);
    `logger` takes the line that names a pending bf16 form (default: this
    module's logger)."""
    meta = cfg.MODEL.META_ARCHITECTURE
    if cfg.MODEL.RETINANET_ON:
        _compute_dtype(cfg, "RetinaNetDetector", False, train, logger)
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
            freeze_at=cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT,
            device=device,
        )
    if meta == "GeneralizedRCNN" and not cfg.MODEL.STEREO_ON:
        _compute_dtype(cfg, "GeneralizedRCNN", False, train, logger)
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
            freeze_at=cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT,
            device=device,
        )
    if meta in ("DispRCNN", "GeneralizedRCNN"):
        _compute_dtype(cfg, "DispRCNN", False, train, logger)
        body = cfg.MODEL.BACKBONE.CONV_BODY.replace("-FPN", "")
        _check_body(cfg, body)
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
            freeze_at=cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT,
            straddle_thresh=rpn.STRADDLE_THRESH,
            rpn_fg_iou=rpn.FG_IOU_THRESHOLD,
            rpn_bg_iou=rpn.BG_IOU_THRESHOLD,
            rpn_batch_per_image=rpn.BATCH_SIZE_PER_IMAGE,
            rpn_positive_fraction=rpn.POSITIVE_FRACTION,
            roi_positive_fraction=heads.POSITIVE_FRACTION,
            roi_fg_iou=heads.FG_IOU_THRESHOLD,
            roi_bg_iou=heads.BG_IOU_THRESHOLD,
            device=device,
        )
    if meta == "DispRCNN3D":
        p = cfg.MODEL.POINTRCNN
        if cfg.SOLVER.TRAIN_PSM:
            max_roi_train = cfg.MODEL.DISPNET.MAX_ROI_FOR_TRAINING
        elif cfg.SOLVER.TRAIN_PC:
            max_roi_train = cfg.MODEL.PCNET.MAX_ROI_FOR_TRAINING
        else:
            max_roi_train = 0
        dtype = _compute_dtype(cfg, "DispRCNN3D", True, train, logger)
        # passed where it is the JAX build's dtype; a model whose bf16 form
        # is pending keeps the constructor's float32
        obeyed = {"dtype": dtype} if dtype != torch.float32 else {}
        return DispRCNN3D(
            **obeyed,
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
            rpn_fixed=p.RPN.FIXED,
            rcnn_loss_cls=p.RCNN.LOSS_CLS,
            aug_data=p.AUG_DATA,
            fg_aug_times=p.RCNN.ROI_FG_AUG_TIMES,
            aug_rot_range=p.AUG_ROT_RANGE,
            rpn_nms_thresh_train=p.TRAIN.RPN_NMS_THRESH,
            rpn_pre_nms_per_roi=p.TEST.RPN_PRE_NMS_TOP_N,
            proposals_per_roi=p.TEST.RPN_POST_NMS_TOP_N,
            rpn_pre_nms_per_roi_train=p.TRAIN.RPN_PRE_NMS_TOP_N,
            proposals_per_roi_train=p.TRAIN.RPN_POST_NMS_TOP_N,
            kernels_off=frozenset(kernels_off),
            device=device,
        )
    raise NotImplementedError(meta)
