#!/usr/bin/env python3
"""Smoke run of the PyTorch port (disprcnn_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each ending in torch.cuda.synchronize() and one progress line:
  1. build every CUDA kernel of the port (build.SOURCES: csrc/nms.cu,
     conv3d.cu, conv3d_tc.cu, cost_volume_tc.cu, softargmin.cu, fps.cu,
     sa.cu, grouped_mlp.cu, fp.cu, roipool3d.cu), one nvcc per source, all
     at once, into
     disprcnn_tpu_torch/csrc/build/ (listed in .gitignore), printing each
     kernel's registers, spills and shared memory from ptxas;
  2. the greedy-NMS kernel against its plain PyTorch version at the SRPN
     call (8, 6000) k=300 IoU 0.7, the SRPN's train budget in the 2D train
     step (4, 2000) k=2000 IoU 0.7, the box head's (8, 300) k=16 IoU 0.5,
     the 3D proposals' BEV NMS without the +1 term at (128, 128) and the
     reference budget's (128, 768), k = N, IoU 0.8, an N off the 64-box
     tile walked in two passes (8, 3000) k=100, and an N whose walk reads
     global memory (2, 12000) k=2000, on random, clustered, duplicate,
     tied-score, all-invalid-row and few-survivor inputs: indices and
     flags equal;
  3. the iDispNet kernels against their plain versions at every shape the
     main path gives them, on seeded random inputs: the tower's 2D conv
     (32 channels at 112^2, 64 at 56^2; with and without residual and
     ReLU), the cost-volume conv, the stride-1 3D conv (56^2, 28^2, 14^2;
     with and without residual and ReLU), its 32 -> 1 classifier form
     (with and without the previous classifier's cost as residual), the
     stride-2 and the transposed 3D convs of the hourglasses and the
     soft-argmin; the tensor-core convs (the 2D conv, the 3D conv at stride
     1 and 2, the cost-volume conv, the transposed conv) and the
     classifier's conv, their plain versions and cuDNN's float32 conv are
     also compared with the same conv in float64 (logged), the soft-argmin
     and its plain version with the same function in float64 (logged, px),
     and the weight packings held equal to their plain versions;
  4. the PointRCNN kernels against their plain versions at every site
     shape of both budgets, on seeded clouds that hold empty, partial and
     full balls, coincident points, and boxes with no point, fewer than 512
     and more than 512: FPS indices (on both of the kernel's routes) and
     RoI-pool rows exactly, SA and FP
     values within CONV_RTOL/CONV_ATOL; the SA and FP kernels' chain
     packing equal to its plain version, and each kernel's and plain
     version's distance from the same function with its chain in float64
     logged;
  5. row 12, the grouped MLP + max, against its plain version at the 8
     site shapes of the SA-off route at the headline budget (RPN SA1-SA3,
     two scales each, and RCNN SA0 and SA1, whole: G groups of S rows) and
     at edge cases (all pre-activations negative, S = 1, S = 48 and 24 that
     do not divide the row tile, a last partial tile at S = 16, 32 and 64 and on
     one consumer warpgroup, widths that are not multiples of 4), seeded
     inputs with non-trivial BN affines, within CONV_RTOL/CONV_ATOL; the
     weight packing equal to its plain version;
  6. the main path: predict answers 2 requests of 8 stereo pairs at
     384x1248 at the headline 3D budget and 1 at the reference budget (R-101
     2D detector, iDispNet over 16 ROIs of 224^2 per pair, disparity
     -48..48, the lift to 768 points per ROI, PointRCNN's RPN, proposals,
     RoI-pool 3D and RCNN; random weights and sampling priorities from
     seeded torch.Generators), timed with CUDA events, with every kernel's
     launches counted from 0 over exactly these requests;
  7. the same requests with every kernel's launch point routed to its
     plain version on the card: detections and masks equal, disparity
     within DISP_TOL_PX; the 3D stage then runs on the kernel path's
     disparity (so that both runs lift the same clouds): roi_ok and random
     equal, box3d and score3d within BOX3D_TOL on at least BOX3D_AGREE of
     the instances;
  8. small references: the R-50 2D test configuration at 64x128, a small
     DispRCNN3D (2 ROIs of 64^2, disparity -16..16), and the same with
     det3d_on (clouds of 128 points), on the CPU (plain versions) and on
     the card (kernels), to stated tolerances;
  9. each kernel timed on the inputs the main path gave it in one headline
     request, beside its plain version, the one PyTorch call that computes
     the same function where there is one (cuDNN free to pick
     non-deterministic algorithms), and the bound of the work the function
     needs (products with padding, and neighbour slots that repeat a
     ball's first point, are not counted; the cost-volume conv counts its
     tap planes and their sums, with the dense conv's count logged and
     kept as dense_bound_ms); the tensor-core kernels (rows 2, 3, 5, 6, 7,
     10 and 13, and rows 8 and 11 in phase 17) also get the bound at the
     3xTF32 tensor-core rate (bound_tc_ms) and their weight packing's time
     alone (pack_ms); every row lists each launch's time (launch_ms), and
     FP each site's (form_ms: fp3, fp2, fp1); the soft-argmin's bound is the
     longest of bytes, FP32 operations and the exponentials the function
     needs (two a segment of the D interpolation) at the SFU rate
     (bound_parts_ms, binds; beside them, not a bound, the SFU time of the
     kernel's one exponential a disparity, sfu_design); FPS also gets the
     serial chain of each launch, one cloud of its N on its route at B = 1,
     npoint against 1 (chain_ms, the median of 5, chain_spread_ms, and
     step_us a step), summed over the launches as the serial floor
     (serial_floor_ms); NMS likewise each site's launch on its first image
     alone (chain_ms by site: SRPN, box head, 3D proposals, the median of
     5, and chain_spread_ms; serial_floor_ms their sum over the launches),
     and the sorted position where each site's walk stopped (walk_stop);
     every row also gets the
     device's time alone, its launches queued behind a sleeping kernel
     (device_ms, device_launch_ms: ms times a launch at the host's call
     rate where a kernel is shorter than a call, ~25 us);
 10. where a request's time goes, at both budgets: one request split into
     stages (2D detector, crops, feature tower, cost volume + dres,
     hourglasses, classifiers + regression, lift, RPN backbone, RPN heads,
     propose + NMS, RoI-pool 3D, RCNN, postprocess) by CUDA events that
     forward hooks and wrappers record; the headline request is also timed
     with cuDNN free to pick non-deterministic algorithms; pairs per second
     at both budgets.
 11. the SA-off route (kernels_off={"sa"}, the route the JAX package takes
     with DISPRCNN_PALLAS_DISABLE=sa): one headline request with the
     launches counted from 0 (row 12 launched, row 10 not), its 3D stage
     on the clouds of the default route's run of the same request held to
     that run as phase 7 holds the plain path; its time, the RPN backbone
     and RCNN stages beside the default route's, and its peak memory; then
     row 12 timed on the inputs that request gave it (every row of the
     grouped tensor counted in its bound: it cannot tell repeated ball
     slots apart), with its 3xTF32 bound and weight packing's time; and
     row 12 and its plain version at the 8 sites against the same function
     in float64, the kernel held within twice the plain version's
     distance;
 12. the bench (disprcnn_tpu_torch/bench.py): its canary (every kernel row
     at tiny shapes against its plain version), then time_pipeline at the
     headline budget on the models of phase 6, 3 requests after a warm-up:
     pairs/s and the spread;
 13. row 8, the stride-1 conv's train form (conv3d_train), at each trunk
     site of the iDispNet train step (24 crops: 56^2 32 -> 32, 28^2 and
     14^2 64 -> 64): the kernel's raw conv, dx through the kernel and dk
     against F.conv3d and its autograd;
 14. row 11, the SA train form (sa_ball_mlp_max_train), at the RCNN's SA0
     and SA1 of the RCNN train step (256 ROIs): the kernel forward and
     every input and weight gradient against autograd of the plain
     version;
 15. the iDispNet train step (configs/kitti/car/vob/idispnet.yaml, built by
     disprcnn_tpu_torch/tools/bench_train.py): 2 pairs of 384x1248 with 16
     offline detections each, ROI_MIN_SCORE 0.5 and MAX_ROI_FOR_TRAINING 12
     (24 crops of 224^2), disparity -48..48, 3 hourglasses, deep
     supervision, SGD with OneCycle; 1 warm-up and TRAIN_STEPS timed steps
     with the kernels' launches counted from 0: finite losses, no skipped
     step, a finite gradient on every trainable parameter, moved BN
     statistics; then one step from the same weights on the kernels, on
     the plain versions (all_plain), and on the plain versions with row 8
     exact (float64, rounded once), in two more float32 orders and as one
     TF32 product: the loss within 1e-4 relative of the plain step's; the
     whole gradient no further from the exact step's than the plain
     step's is, + 1e-3 of its norm, and each tensor within twice the
     furthest float32 order's distance, + 1e-3 of its norm (STEP_GRAD_TOL
     says why); the one-TF32 step, and the kernel step's gradients with
     the smallest tensor negated, must both fail that check;
 16. the RCNN train step (configs/kitti/car/vob/rcnn.yaml, tools/
     bench_train.py): 1 pair, 16 detections lifted to 768 points, iDispNet
     and the RPN frozen (eval, no gradients), TRAIN proposals 768 -> 512, 16
     RCNN ROIs per instance (256 x 512 pooled points), AUG_DATA with 10
     noise trials, grad clip 10; the same checks, the kernel and plain
     steps sharing one frozen-stage output and starting from the seeded
     weights (the timed steps leave weights that differ in their last bits
     from run to run);
 17. each train form timed on the inputs one step gave it (row 8 forward
     and dx, row 11 forward), beside its plain version, the library call
     (row 8: F.conv3d and cuDNN's input gradient) and its bound; ms per
     step, crops/s and pairs/s;
 18. the 3D RPN train step (configs/kitti/car/vob/rpn.yaml, tools/
     bench_train.py rpn_stage): 3 pairs with 16 detections each (48 clouds
     of 768 points), iDispNet frozen, the RPN in train mode (BN batch
     statistics through PointNet++ and the heads, fixed dropout masks), the
     RCNN disabled, each GT box on its own cloud, BCE, OneCycle BASE_LR
     0.002, grad clip 10; 1 warm-up and TRAIN_STEPS timed steps with the
     launches counted from 0: rows 2-7, 9 and 15 launch, rows 1, 8 and
     10-14 not; every trainable parameter with a finite gradient, every
     RPN BN statistic moved and finite; peak memory, the positive and
     ignored point counts and the losses logged; then the kernel step
     against the plain step from the seeded weights on one frozen-stage
     output, as phase 16 (the RPN's input is shared, so of the kernels
     only row 9, FPS, is inside what this compares: rows 2-7 and 15 are
     held to their plain versions in phases 3, 9 and 15), and one step
     split into stages by CUDA events;
 19. the 2D train step (stage 1, configs/kitti/car/vob/mask.yaml, tools/
     bench_train.py build_stage("2d")): R-101-FPN on 4 pairs of 384x1248,
     2-4 GT pairs an image with ellipse masks, the SRPN's train budget
     (top 2000 -> double-view NMS, row 1 -> 2000), its loss, the GT
     appended, ROI matching and sampling to 512 an image, the box head
     (frozen, dropout on) and the mask head, all five losses; backbone,
     RPN and box head frozen, grad clip 10, OneCycle BASE_LR 0.01; 1
     warm-up and TRAIN_STEPS timed steps with the launches counted from 0:
     row 1 once a step and no other kernel; finite losses, loss_mask > 0,
     a positive ROI in every image (each step draws anew), a finite gradient on every mask-head
     parameter and no trainable parameter without one, exactly the
     mask-head parameters changed, every frozen weight and FrozenBN
     constant bit-equal; then the kernel step against the plain step from
     the seeded weights and draws under deterministic algorithms: the five losses and
     every mask-head gradient equal (where not bit-equal, the ops that
     have no deterministic CUDA form are named and the step is held in
     phase 16's per-tensor form); row 1 timed on the inputs the step gave
     it (kernel, device, plain, bound, its one-image walk and where it
     stopped), one step split into stages, ms per step, pairs/s and peak
     memory; and bench.time_train_stage("2d") as the bench runs it.
 20. the eval entry point, tools/test_net.run in-process: configs/kitti/
     car/vob/mask.yaml on synthetic_8 (R-101-FPN at 384x1248, the resize
     to the 600-pixel short side, 4 pairs a batch, 100 detections into 32
     slots) and configs/kitti/car/vob/rcnn.yaml on synthetic3d_8 (the 3D
     model over each scene's 32 offline slots, 224^2 ROIs at +-48,
     768-point clouds, TEST's 9000 pre-NMS proposals capped to 768 -> 100
     an instance, 1 pair a batch), random weights from a seed, each run
     with the launches counted from 0: row 1 launched by mask.yaml, rows
     1-7, 9, 10 and 13-15 by rcnn.yaml (and no train form, no row 12);
     predictions.pkl and the KITTI txt written, with the JAX package's
     keys and dtypes, finite and of the configs' shapes; the first batch
     of each rerun with every kernel routed to its plain version: the 2D
     predictions equal, and (on the kernel run's disparity, as phase 7)
     roi_ok and random equal and box3d/score3d within BOX3D_TOL on
     BOX3D_AGREE of the instances; the synthetic scenes' GT written as
     KITTI label files, on which the port's evaluator gives AP 100 (bbox,
     BEV, 3D, both IoU thresholds) with the GT as the detections (48
     scenes: the devkit's 41 recall points need 41 GT instances), then
     scores each run's txt (logged, random weights: not gated); images/s
     of each loop, split into the data layer (dataset, transforms,
     collate), the copy to the card, the model (CUDA events), the copy
     back with the prediction dicts, and the txt and AP.
 21. the train entry points in-process: tools/train_net on mask, idispnet,
     rpn and rcnn.yaml with the stage handoff, test_net --ckpt and
     tools/train_idispnet (phase_train_entry); mask.yaml's MODEL.WEIGHT is
     a 2D mrcnn .pth in the reference's layout, written from the random-init
     model (every entry filled from it, the frozen ones bit-equal after
     training).
 22. the distributed paths, two ranks sharing the card on gloo (each a
     process of this script with --dist-worker and torchrun's
     environment; no time of theirs is a scaling figure): (a) train_net on
     idispnet, rpn and rcnn.yaml at the test size (DIST_TINY), 1 pair a
     rank against one process at 2 pairs from the same seeded weights and
     draws, float32 on the kernels, and the two train-BN stages also in
     float64 on the plain versions: the first step's losses, gradients and
     BN statistics (DIST_LOSS_RTOL, phase 16's per-tensor form, ...), the
     ranks bit-equal after 3 iterations, rank 0's checkpoint and log.txt
     alone, the launches; (b) test_net on rcnn.yaml over synthetic3d_8:
     the merged predictions.pkl bit-equal to one process's, the same AP;
     (c) NCCL refusing two ranks on the card, and a world-1 NCCL group's
     all_reduce and train_net iteration bit-equal to the run without a
     group; (d) the recipe: test_net on mask.yaml -> split_predictions ->
     generate_psmnet_input (records on the card against the CPU's) ->
     train_idispnet on the records; (e) utils/profiling.py: a trace of one
     train iteration naming csrc kernels, StepTimer, device_memory_stats.
 23. a user's files on the card, at full width (R-101, the shipped configs):
     (a) the port's make_mini_kitti writes 4 train and 4 val scenes at
     375x1242 and KittiStereoDataset reads them back through data/png.py
     (no PIL): images, disparities and masks equal to the synthetic scenes
     after the uint8 and uint16 rounding, the image sizes from IHDR; (b) the
     reference's five released layouts (the 2D mrcnn .pth, pointrcnn.pth,
     the full 3D stage .pth with module. prefixes, a PSMNet bestmodel .tar
     under state_dict, an R-101 Detectron .pkl) written from random-init
     mask.yaml and rcnn.yaml models by tests/torch_ckpt_writer.py, each
     loaded by load_stage_weights into a freshly drawn model: its entries
     torch.equal to the source's (the .pkl's weights only: Caffe2 norms
     carry no statistics); (c) disprcnn_tpu_torch/scripts/car/vob/
     eval_with_trained_model.sh on the mini-KITTI (DISPRCNN_DATA_DIR), its
     --ckpt files (b)'s, run with --deterministic from a directory that links
     the checkout's package and configs: rc 0, each stage's predictions;
     the native evaluator's stats equal to the Python evaluator's to their
     print precision on rcnn.yaml's txt and on the mini-KITTI's GT jittered
     into detections (an AP strictly between 0 and 100); rcnn.yaml in this process on
     the script's model with its pointrcnn.* from the source model's own
     state_dict: predictions bit-equal to the script's, rows 1-7, 9, 10 and
     13-15 launched; (d) each load's wall time, each CLI's images/s, the
     mini-KITTI's write and read rates.
 24. the stereo detector's last options and A2, at full width: (a)
     mask.yaml with MODEL.DISPNET_ON (R-101-FPN, 8 pairs of 384x1248, 32
     detections each, DispModule at 28^2 -> 112^2 over [-48, 48)): one
     request with the launches counted from 0 (rows 1-6 and 15, and no
     other), each of DispModule's kernel launches held and timed against
     its plain version at its shape (rows 2-6 at (24, 28^2), (12, 14^2) and
     (6, 7^2); row 15 against the same function in float64 on its logits,
     within twice the plain version's distance + SOFTARGMIN_TOL_PX), the
     kernel and plain runs' detections and masks equal and disparity_roi
     held to DispModule in float64 on the same inputs (DISPNET_ORDER_FACTOR),
     the request's time and peak memory, and rois_to_fullimage_disparity on
     the card against the CPU; (b) tools/train_net on mask.yaml with
     DISPNET_ON and SOLVER.TRAIN_PSM, 2 iterations of 2 pairs x 128 ROIs
     (the cut: DISPNET_TRAIN_OPTS): loss_psm finite, every dispnet
     parameter updated, rows 1 and 8 launched and no other; row 8 timed at
     DispModule's three trunk levels; (c) mask.yaml with both USE_GN: a
     request against its plain run, one train iteration; (d) test_net on
     mask.yaml with MASK_ON False: no mask head, predictions without masks;
     (e) rcnn.yaml at the headline budget with RPN.NMS_TYPE rotate, then
     TEST.RPN_DISTANCE_BASED_PROPOSE: one predict each, the proposal
     layer's inputs re-proposed on the CPU (clouds that differ must hold
     an IoU or a z within A2_NEAR of a decision, C16), row 1's launches
     and the rotated route's fixpoint passes and host syncs; (f) test_net
     on (a)'s config without the resize, then tools/visualize on its
     predictions, the PNGs read back by data/png.py equal to the drawings,
     and one box outline for each valid detection in the outlines drawn
     alone.
 25. the models off the stereo path and the 3D RPN's other losses, at
     full width, through build_detection_model and the model's forward, on
     2 images of 800x1344 (INPUT.MIN/MAX_SIZE_TEST 800/1333, padded to
     32), float32, random weights with the class heads drawn so that boxes
     clear the score thresholds (A6_LOGIT_STD; RetinaNet's bias 0): (a)
     the mono R-50-C4 of the bare default config (81 classes, RPN 6000 ->
     1000, res5 on every proposal, 32 detections) and (b) the mono
     R-50-FPN with MASK_ON and R-50-C5: one request each with the launches
     counted from 0 (row 1 twice: the RPN's and one launch for every
     class of both images), its ms and peak memory, and the run with row 1
     on its plain version: detections (and masks) equal; (c) a mono C4
     train step (4 GT boxes an image on its first proposals, moved by up
     to 5%, seeded draws, RPN cut to 512 proposals an image:
     A6_TRAIN_OPTS), kernels against plain under
     deterministic algorithms, ms a step and peak memory; (d) RetinaNet
     R-50-FPN (80 classes, 9 anchors a location, P3-P7) in eval as (a)
     (row 1 once) and one train forward, losses finite and equal on the
     plain route; (e) mask.yaml on FBNet-FPN, 8 pairs of 384x1248, as (a)
     (the SRPN and the box head), and tools/train_net for 2 iterations at
     mask.yaml's batch: FBNet's running statistics bit-equal; (f) phase
     18's rpn.yaml step with RPN.LOSS_CLS SigmoidFocalLoss and DiceLoss:
     rows 2-7, 9 and 15 launched, rows 1, 8, 10-14 not, the kernel step
     against the plain step as phase 18 holds it; (g) row 1 timed at each
     new site on its own inputs (kernel, device, plain, bound), with the
     valid boxes that entered it (each site must have some).
Then it prints the card (name, power limit) from nvidia-smi, one JSON line
of per-kernel numbers (eval kernels per headline request, row 12 per
SA-off headline request, train forms per train step), and as its last
line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Row 1's entry also holds `a6_sites` (phase 25's sites: shape, k, valid
boxes in, ms, device_ms, plain_ms, bound_ms) and every row `a6_launches`
(its launches in each run of phase 25).
Without a CUDA device, or on any failure, it exits non-zero and prints no
result. Float32 throughout with TF32 off and deterministic cuDNN.
"""
from __future__ import annotations

import contextlib
import copy
import datetime
import json
import math
import os
import pickle
import re
import socket
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from functools import partial

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from disprcnn_tpu_torch import bench
from disprcnn_tpu_torch.bench import (BENCH_2D, BENCH_3D, BUDGETS, CALIB, CONV_ATOL, CONV_RTOL,
                                      IMG_HW, SOFTARGMIN_TOL_PX, card_line, set_budget,
                                      time_ms)
from disprcnn_tpu_torch.config import get_default_cfg
from disprcnn_tpu_torch.data.catalog import resolve
from disprcnn_tpu_torch.engine import batching
from disprcnn_tpu_torch.engine import trainer as trainer_mod
from disprcnn_tpu_torch.engine.batching import make_batch_converter
from disprcnn_tpu_torch.engine.inference import predict, predict_2d
from disprcnn_tpu_torch.evaluation.kitti_eval import evaluate_kitti
from disprcnn_tpu_torch.models.detector.disprcnn import DispRCNN
from disprcnn_tpu_torch.models.detector.disprcnn3d import DispRCNN3D
from disprcnn_tpu_torch.models.detector import generalized_rcnn
from disprcnn_tpu_torch.models.backbone.resnet import GroupNorm
from disprcnn_tpu_torch.models.psmnet.inference import rois_to_fullimage_disparity
from disprcnn_tpu_torch.ops.iou import boxes3d_to_bev, pairwise_bev_iou, pairwise_iou
from disprcnn_tpu_torch.data.png import read_png
from disprcnn_tpu_torch.models.pointrcnn import rcnn3d, rpn3d
from disprcnn_tpu_torch.models.pointrcnn.pointnet2 import set_kernels_off
from disprcnn_tpu_torch.ops import nms as port_nms
from disprcnn_tpu_torch.ops import points as tpoints
from disprcnn_tpu_torch.ops import roipool3d as troi
from disprcnn_tpu_torch.ops.cuda import build
from disprcnn_tpu_torch.ops.cuda import conv3d as cconv
from disprcnn_tpu_torch.ops.cuda import fp as cfp
from disprcnn_tpu_torch.ops.cuda import fps as cfps
from disprcnn_tpu_torch.ops.cuda import grouped_mlp as cgm
from disprcnn_tpu_torch.ops.cuda import nms as cuda_nms
from disprcnn_tpu_torch.ops.cuda import roipool3d as croi
from disprcnn_tpu_torch.ops.cuda import sa as csa
from disprcnn_tpu_torch.ops.cuda import softargmin as csam
from disprcnn_tpu_torch.parallel.multihost import init_distributed
from disprcnn_tpu_torch.structures.stereo import StereoBoxes
from disprcnn_tpu_torch.tools import bench_train
from disprcnn_tpu_torch.models.build import build_detection_model
from disprcnn_tpu_torch.tools import (generate_psmnet_input, split_predictions, test_net,
                                      train_idispnet, train_net)
from disprcnn_tpu_torch.utils import profiling
from disprcnn_tpu_torch.utils.checkpoint import Checkpointer, load_stage_weights
from disprcnn_tpu_torch.tools.bench_train import PC_TRAIN, PSM_TRAIN, RPN_PAIRS, RPN_TRAIN
from disprcnn_tpu_torch.utils.weights import init_random_
from disprcnn_tpu_torch.data.datasets.kitti import KittiStereoDataset
from disprcnn_tpu_torch.data.datasets.synthetic import SyntheticStereoDataset
from disprcnn_tpu_torch.evaluation import kitti_eval
from disprcnn_tpu_torch.tools import make_mini_kitti, visualize

ROOT = os.path.dirname(os.path.abspath(__file__))
# the reference's released layouts are written by the writer the CPU tests
# use (tests/torch_ckpt_writer.py: torch and numpy only)
sys.path.insert(0, os.path.join(ROOT, "tests"))
import torch_ckpt_writer as ckpt_writer  # noqa: E402

# The pipeline's geometry, budgets, calibration and the kernel-against-
# plain tolerances CONV_RTOL/CONV_ATOL and SOFTARGMIN_TOL_PX (fixed before
# the first card run of these kernels) are the bench's
# (disprcnn_tpu_torch/bench.py); the train stages' configurations are
# disprcnn_tpu_torch/tools/bench_train.py's.
PHASES = 25
PAIRS = 8
REQUESTS = 2  # at the headline budget; one more at the reference budget
# the tests' small configurations (tests/torch_port_helpers.py, tests/test_torch_disprcnn3d.py)
SMALL_2D = dict(body="R-50", out_channels=32, mlp_head_dim=64, pre_nms_top_n_test=200,
                post_nms_top_n_test=48, max_det=8, detections_per_img=8)
SMALL_3D = dict(max_det=2, roi_size=64, maxdisp=16, mindisp=-16)
SMALL_DET3D = dict(SMALL_3D, det3d_on=True, npoints=128, lift_grid=32,
                   sa_npoints=(128, 64, 32, 16))
NMS_CASES = ("random", "clustered", "duplicates", "ties", "invalid_rows", "few_survivors")
# (site, B, N, k, IoU, +1 term): the SRPN, its train budget in the 2D train
# step (k = N: one pass over all 32 tiles) and the box head; the 3D
# proposals' BEV NMS at both budgets; an N off the 64-box tile, walked in
# two passes; and an N whose walk reads global memory (ops/cuda/nms.py
# walk_routes)
NMS_SHAPES = (("SRPN", PAIRS, 6000, 300, 0.7, 1.0), ("SRPN train", 4, 2000, 2000, 0.7, 1.0),
              ("box head", PAIRS, 300, 16, 0.5, 1.0),
              ("3D proposals", 128, 128, 128, 0.8, 0.0),
              ("3D proposals, reference", 128, 768, 768, 0.8, 0.0),
              ("N off the tile", PAIRS, 3000, 100, 0.7, 1.0),
              ("global route", 2, 12000, 2000, 0.7, 1.0))
# Kernel launches per headline request on the main path (the kernel table of
# PERF.md): the tower's 2D conv: ConvBN_1, ConvBN_2, layer1's 6, layer2's 31,
# over both views at once; 2 stride-2 and 2 transposed convs per hourglass;
# NMS: SRPN, box head and the 3D proposals; FPS at RPN SA1-3 (SA0 keeps all
# 768 points) and RCNN SA0-1; SA at the 6 RPN scales with 64+ channels and
# RCNN SA0-1 (one launch per scale); FP at fp3, fp2 and fp1 (fp0 has no
# skip features); RoI-pool once per proposal block
EXPECTED_LAUNCHES = {"nms_sorted": 3, "conv2d": 39, "cost_volume_conv": 1, "conv3d": 12,
                     "conv3d_cl1": 3, "conv3d_s2": 6, "deconv3d": 6, "softargmin": 1,
                     "fps": 5, "sa": 8, "fp": 3, "roipool3d": 1}
# at the reference budget the RCNN runs its 12 800 ROIs in two blocks of 6400
EXPECTED_REFERENCE = {**EXPECTED_LAUNCHES, "fps": 7, "sa": 10, "roipool3d": 2}
# a headline request on the SA-off route: no SA launch; row 12 once per
# chunk of clouds of the grouped pre-activation (pointnet2.py
# GROUPED_CHUNK_ELEMS, 2^28 values): the 6 RPN scales one each, RCNN SA0's
# 2048 clouds in 8 chunks of 256, SA1's in 2 of 1024
EXPECTED_SA_OFF = {**EXPECTED_LAUNCHES, "sa": 0, "grouped_mlp": 16}
# disparity of a whole forward, kernels against plain versions (phase 7)
# or card against CPU (phase 8): the differences above through ~20 3D conv
# layers and a softmax over 96 (32) disparities: max |diff| <= 1e-2 px.
DISP_TOL_PX = 1e-2
# box3d and score3d of the 3D stage on the same clouds, kernels against
# plain versions or card against CPU: per instance max |diff| <= BOX3D_TOL *
# (1 + max |plain|). The float32 sums of the SA/FP products differ in order
# (~1e-6 relative); an argmax over the box codec's bins, or an NMS or score
# threshold, that those differences tip for one point changes that
# instance's proposals, so at least BOX3D_AGREE of the instances with
# points must be within the tolerance, and roi_ok and random equal.
BOX3D_TOL = 1e-3
BOX3D_AGREE = 0.95
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit); the 3xTF32 rate is
# the dense TF32 tensor-core peak over the 3 TF32 products a float32 product
# takes in csrc/conv3d_tc.cu, csrc/mlp_tc.cuh and csrc/mlp_wgmma.cuh
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TC_3XTF32_OPS_PER_S = 495e12 / 3
# the rows whose kernel runs on the tensor cores, with a second bound at that
# rate, and the weight packing each of their launches runs first (a function
# of the launch's arguments)
TC_ROWS = {"cost_volume_conv": lambda a: cconv.pack_tf32_cost_volume_weight_cuda(a[2]),
           "deconv3d": lambda a: cconv.pack_tf32_deconv_weight_cuda(a[1]),
           "conv3d": lambda a: cconv.pack_tf32_weight_cuda(a[1]),
           "conv3d_s2": lambda a: cconv.pack_tf32_weight_cuda(a[1]),
           "conv3d_train": lambda a: cconv.pack_tf32_weight_cuda(a[1]),
           "conv2d": lambda a: cconv.pack_tf32_weight_cuda(a[1]),
           "sa": lambda a: csa.pack_tf32_chain_cuda(a[6]),
           "sa_train": lambda a: csa.pack_tf32_chain_cuda(a[6]),
           "fp": lambda a: csa.pack_tf32_chain_cuda(a[4]),
           "grouped_mlp": lambda a: cgm.pack_for_launch(a[0], a[3])}
IOU_OPS = 17  # float ops of one IoU and its threshold test (nms.cu box_iou)
# soft-argmin: ops per (pixel, logit slice) of the bilinear H/W taps, and per
# (pixel, disparity) of the D interpolation, exp, running max and two sums;
# the exponentials it needs: within a segment of the D interpolation z
# steps by a constant, so exp(z - m) is a geometric sequence given by two
# exponentials (its first term and its ratio); the SFU takes 16 a clock per
# SM (132 SMs, 1.98 GHz)
SAM_TAP_OPS, SAM_DISP_OPS, SAM_SEGMENT_EXPS = 8, 8, 2
SFU_PER_S = 16 * 132 * 1.98e9
# FPS: per point and step, 3 differences, 3 squares, 2 sums, the running
# minimum and the argmax comparison
FPS_OPS = 10
# a squared distance and its test (3 differences, 3 squares, 2 sums, 1
# comparison); the in-box test of RoI-pool 3D (3 offsets, 3 bounds on them,
# a rotation of 4 products and 2 sums, 4 bounds)
DIST_OPS, INBOX_OPS = 9, 16
# the PointRCNN kernels' site shapes (kernel table of PERF.md), both budgets:
# FPS (clouds, N, npoint)
FPS_SITES = ((128, 768, 512), (128, 512, 256), (128, 256, 64), (2048, 512, 128),
             (2048, 128, 32), (6400, 512, 128), (6400, 128, 32))
# SA (site, clouds, N, M, C0, chain after mlp0, radius, S)
SA_SITES = (("RPN SA1 scale 0", 128, 768, 512, 64, (64, 128), 0.5, 16),
            ("RPN SA1 scale 1", 128, 768, 512, 64, (96, 128), 1.0, 32),
            ("RPN SA2 scale 0", 128, 512, 256, 128, (196, 256), 1.0, 16),
            ("RPN SA2 scale 1", 128, 512, 256, 128, (196, 256), 2.0, 32),
            ("RPN SA3 scale 0", 128, 256, 64, 256, (256, 512), 2.0, 16),
            ("RPN SA3 scale 1", 128, 256, 64, 256, (384, 512), 4.0, 32),
            ("RCNN SA0", 2048, 512, 128, 128, (128, 128), 0.2, 64),
            ("RCNN SA1", 2048, 128, 32, 128, (128, 256), 0.4, 64),
            ("RCNN SA0 reference", 6400, 512, 128, 128, (128, 128), 0.2, 64),
            ("RCNN SA1 reference", 6400, 128, 32, 128, (128, 256), 0.4, 64))
# FP (site, clouds, targets, sources, C, C skip, chain)
FP_SITES = (("fp3", 128, 256, 64, 1024, 512, (512, 512)),
            ("fp2", 128, 512, 256, 512, 256, (512, 512)),
            ("fp1", 128, 768, 512, 512, 96, (256, 256)))
# rows that phase 9 times per site (form_ms): a launch's site from its
# arguments, FP's by its (targets, sources), NMS's by its +1 term (the 3D
# proposals' BEV NMS has none) and N (the SRPN's 6000 pre-NMS boxes, the
# box head's 300 proposals)
LAUNCH_SITE = {"fp": lambda a: {(nt, ns): site for site, _, nt, ns, *_ in FP_SITES}[
    (a[0].shape[1], a[1].shape[1])],
    "nms_sorted": lambda a: "3D proposals" if a[4] == 0 else (
        "SRPN" if a[0].shape[1] >= 1000 else "box head")}
# RoI-pool 3D (clouds, N, boxes, C, S): headline, and one reference block
ROI_SITES = ((128, 768, 16, 130, 512), (128, 768, 50, 130, 512))
# Row 12 at the SA-off route's sites of a headline request, whole (site,
# groups G, S, C0, chain after the input affine): G = clouds x centres
GM_SITES = (("RPN SA1 scale 0", 65536, 16, 64, (64, 128)),
            ("RPN SA1 scale 1", 65536, 32, 64, (96, 128)),
            ("RPN SA2 scale 0", 32768, 16, 128, (196, 256)),
            ("RPN SA2 scale 1", 32768, 32, 128, (196, 256)),
            ("RPN SA3 scale 0", 8192, 16, 256, (256, 512)),
            ("RPN SA3 scale 1", 8192, 32, 256, (384, 512)),
            ("RCNN SA0", 262144, 64, 128, (128, 128)),
            ("RCNN SA1", 65536, 64, 128, (128, 256)))
# and its edge cases: every pre-activation negative (the max is 0), S = 1,
# S = 48 (a 64-row tile holding one group and 16 padding rows), a last
# partial tile, widths that are not multiples of 4 (the scalar path)
GM_EDGES = (("all negative", 1000, 16, 64, (64, 128)), ("S = 1", 777, 1, 128, (196, 256)),
            ("S = 48", 301, 48, 64, (96, 128)), ("partial tile", 1001, 16, 128, (128,)),
            ("odd widths", 517, 32, 65, (70, 33, 18)),
            # a last partial tile at S = 64 (two groups a tile), and at S = 32
            # on one consumer warpgroup (the widest chain: two groups a tile)
            ("partial tile, S = 64", 1001, 64, 128, (128, 128)),
            ("partial tile, S = 32, one warpgroup", 1001, 32, 256, (384, 512)),
            # S neither dividing 16 nor a multiple of 16: groups across warps
            ("S = 24", 301, 24, 64, (96, 128)))
# The train steps (tools/bench_train.py: idispnet.yaml's IMS_PER_BATCH 2,
# rcnn.yaml's 1)
PSM_PAIRS, PC_PAIRS = 2, 1
TRAIN_STEPS = 3  # timed, after one warm-up step
# row 8's sites in the iDispNet step (crops, channels, depth, side), row
# 11's in the RCNN step (site, clouds, N, M, C0, chain, radius, S)
TRAIN_CONV_SITES = ((24, 32, 24, 56), (24, 64, 12, 28), (24, 64, 6, 14))
TRAIN_SA_SITES = (("RCNN SA0", 256, 512, 128, 128, (128, 128), 0.2, 64),
                  ("RCNN SA1", 256, 128, 32, 128, (128, 256), 0.4, 64))
# Kernel against plain train step from the same weights: losses within
# 1e-4 relative, each gradient tensor within 1e-3 * max |plain|. The
# iDispNet step's gradients are ill-conditioned in row 8's rounding (ReLUs
# at ~0 flip, ROADMAP.md C19): any float32 row 8 that does not repeat
# cuDNN's sums bit for bit, cuDNN itself over the channels in another order
# included, is off the plain step by more than 1e-3 of max |plain| on most
# tensors, up to ~2e-2 (PERF.md, Findings). That step is held instead to
# one whose row 8 is exact (float64, rounded once to float32), beside
# STEP_ORDERS, the plain step and two more float32 orders of row 8:
# - over the whole gradient (2-norms over every tensor), |g_kernel -
#   g_exact| <= |g_plain - g_exact| + 1e-3 |g_exact|;
# - each tensor within STEP_ORDER_FACTOR times the furthest order's
#   distance from the exact step's, + 1e-3 of its norm (2-norms).
# Two controls must fail that check: row 8 as one TF32 product, and the
# kernel step's gradients with their smallest tensor negated.
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_TOL = 1e-3
STEP_ORDER_FACTOR = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_build() -> float:
    names = build.SOURCES
    t0 = time.perf_counter()
    texts = build.build(*names)
    dt = time.perf_counter() - t0
    for name in names:
        for line in texts[name].splitlines():
            if "entry function" in line or "registers" in line or "bytes stack" in line:
                log(f"  ptxas {name}: {line.strip()}")
    # load them: a library that does not load fails here
    for mod in (cuda_nms, cconv, csam, cfps, csa, cgm, cfp, croi):
        mod._lib()
    cconv._tc_lib()
    cconv._cv_lib()
    torch.cuda.synchronize()
    log(f"[1/{PHASES}] build: {', '.join(n + '.cu' for n in names)} with nvcc in {dt:.1f} s")
    return dt


@contextlib.contextmanager
def launches_replaced(**fns):
    """Route the named launch points (nms_sorted_cuda, conv3d_bn_cuda,
    cost_volume_conv_bn_cuda, deconv3d_bn_cuda, conv2d_bn_cuda,
    softargmin_cuda, furthest_point_sample_cuda, sa_ball_mlp_max_cuda,
    grouped_mlp_max_cuda, fp_fused_cuda, roipool3d_cuda, and the train
    forms' conv3d_train_cuda, conv3d_train_dx_cuda,
    sa_ball_mlp_max_train_cuda) through the given functions; yields the
    original launches by name."""
    modules = {"nms_sorted_cuda": cuda_nms, "conv3d_bn_cuda": cconv,
               "cost_volume_conv_bn_cuda": cconv, "deconv3d_bn_cuda": cconv,
               "conv2d_bn_cuda": cconv, "softargmin_cuda": csam,
               "furthest_point_sample_cuda": cfps, "sa_ball_mlp_max_cuda": csa,
               "grouped_mlp_max_cuda": cgm, "fp_fused_cuda": cfp, "roipool3d_cuda": croi,
               "conv3d_train_cuda": cconv, "conv3d_train_dx_cuda": cconv,
               "sa_ball_mlp_max_train_cuda": csa}
    orig = {name: getattr(modules[name], name) for name in fns}
    for name, fn in fns.items():
        setattr(modules[name], name, fn)
    try:
        yield orig
    finally:
        for name, fn in orig.items():
            setattr(modules[name], name, fn)


def all_plain(**overrides):
    """Every launch point routed to its plain version (or to `overrides`)."""
    plain = dict(nms_sorted_cuda=cuda_nms.nms_sorted_plain,
                 conv3d_bn_cuda=cconv.conv3d_bn_plain,
                 cost_volume_conv_bn_cuda=cconv.cost_volume_conv_bn_plain,
                 deconv3d_bn_cuda=cconv.deconv3d_bn_plain,
                 conv2d_bn_cuda=cconv.conv2d_bn_plain,
                 softargmin_cuda=csam.softargmin_plain,
                 furthest_point_sample_cuda=cfps.furthest_point_sample_plain,
                 sa_ball_mlp_max_cuda=csa.sa_ball_mlp_max_plain,
                 grouped_mlp_max_cuda=cgm.grouped_mlp_max_plain,
                 fp_fused_cuda=cfp.fp_fused_plain,
                 roipool3d_cuda=croi.roipool3d_plain,
                 conv3d_train_cuda=cconv.conv3d_train_plain,
                 conv3d_train_dx_cuda=cconv.conv3d_train_dx_plain,
                 sa_ball_mlp_max_train_cuda=csa.sa_ball_mlp_max_plain)
    return launches_replaced(**{**plain, **overrides})


def row8_as(conv) -> dict:
    """Row 8's two launch points (forward and input gradient) computed by
    conv(x, weight), a stride-1 pad-1 3x3x3 conv."""
    return dict(conv3d_train_cuda=conv,
                conv3d_train_dx_cuda=lambda dy, w: conv(dy.contiguous(), cconv.flip_transpose(w)))


# the iDispNet step's row 8 other ways (launch overrides on top of all_plain):
# exact (float64, rounded once), the float32 orders that the gradient check
# reads besides the plain step's, and the control that it must reject
ROW8_EXACT = row8_as(lambda x, w: F.conv3d(x.double(), w.double(), padding=1).float())
STEP_ORDERS = {
    "cuDNN, channels reversed": row8_as(lambda x, w: F.conv3d(x.flip(1), w.flip(1), padding=1)),
    "3xTF32 emulation": row8_as(cconv.conv3d_bn_3xtf32_plain)}
ROW8_ONE_TF32 = row8_as(lambda x, w: F.conv3d(cconv.split_tf32(x)[0], cconv.split_tf32(w)[0],
                                              padding=1))


def nms_case(kind: str, b: int, n: int, gen: torch.Generator):
    """Random (boxes (b, n, 4), scores (b, n), valid (b, n)) on the card."""
    def u(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    h, w = IMG_HW
    xy = u(b, n, 2) * torch.tensor([w, h], device="cuda")
    wh = 16 + u(b, n, 2) * 240
    if kind in ("clustered", "few_survivors"):
        m = n // 2 if kind == "clustered" else n
        xy[:, n - m:] = xy[:, n - m:n - m + 1] + (u(b, m, 2) - 0.5) * 12
        wh[:, n - m:] = 60 + (u(b, m, 2) - 0.5) * 8
    boxes = torch.cat([xy, xy + wh], -1)
    if kind == "duplicates":
        boxes[:, 1::2] = boxes[:, 0::2]
    scores = torch.floor(u(b, n) * 4) / 4 if kind == "ties" else u(b, n)
    valid = u(b, n) > 0.15
    if kind == "invalid_rows":
        valid[0] = False
    return boxes, scores, valid


def phase_nms_compare() -> float:
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    for site, b, n, k, thresh, to_remove in NMS_SHAPES:
        routes = cuda_nms.walk_routes(n, k)
        if site == "global route" and "global" not in routes:
            raise AssertionError(f"NMS at N={n} k={k} walks {routes}, not from global memory")
        for kind in NMS_CASES:
            boxes, scores, valid = nms_case(kind, b, n, gen)
            ki, kok = port_nms.nms_topk_batched(boxes, scores, valid, thresh, k, to_remove)
            with launches_replaced(nms_sorted_cuda=cuda_nms.nms_sorted_plain):
                pi, pok = port_nms.nms_topk_batched(boxes, scores, valid, thresh, k, to_remove)
            torch.cuda.synchronize()
            err = float((ki - pi).abs().max())
            if not (torch.equal(kok, pok) and err == 0):
                raise AssertionError(f"NMS kernel != plain at {site} N={n} k={k} {kind}: "
                                     f"max |idx diff| {err}, flags equal {torch.equal(kok, pok)}")
            worst = max(worst, err)
            log(f"  nms {site} ({b}, {n}) k={k} iou={thresh} +{to_remove:g} {kind}: equal, "
                f"{int(kok.sum())} kept; walk {' then '.join(routes)}")
    log(f"[2/{PHASES}] NMS kernel equals its plain version on "
        f"{len(NMS_SHAPES) * len(NMS_CASES)} cases")
    return worst


def conv_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    err = float((got - want).abs().max())
    limit = CONV_RTOL * float(want.abs().max()) + CONV_ATOL
    if not err <= limit:
        raise AssertionError(f"{what}: kernel off its plain version by {err} > {limit}")
    return err


def sam_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    err = float((got - want).abs().max())
    if not err <= SOFTARGMIN_TOL_PX:
        raise AssertionError(f"{what}: kernel off its plain version by {err} px")
    return err


def phase_3d_compare() -> dict:
    """The iDispNet kernels at the main path's shapes (R = 128 ROIs, both
    views through the tower, quarter-res 56^2, D4 = 24) against their plain
    versions."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    r, d4, q = PAIRS * BENCH_3D["max_det"], 24, BENCH_3D["roi_size"] // 4

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def affine(co):
        return 1 + randn(co, scale=0.3), randn(co, scale=0.1)

    errs = {k: 0.0 for k in ("conv2d", "cost_volume_conv", "conv3d", "conv3d_cl1",
                             "conv3d_s2", "deconv3d", "softargmin")}

    def check(name, what, got, want):
        e = conv_err(got, want, what)
        errs[name] = max(errs[name], e)
        log(f"  {name} {what} -> {tuple(got.shape)}: max |diff| {e:.3g} "
            f"(max |plain| {float(want.abs().max()):.3g})")

    def log_exact(name, got, want, exact):
        """The kernel's and the plain version's distance from the same
        function in float64 (max |diff| / max |exact|)."""
        scale = float(exact.abs().max())
        log(f"    against float64: kernel {float((got - exact).abs().max()) / scale:.3g}, plain "
            f"{float((want - exact).abs().max()) / scale:.3g} of max |exact|")

    def check_tc(name, what, x, w, mul, add, rt, relu, stride):
        """A tensor-core conv (rows 3, 6 and 7) against its plain version,
        and both against the same conv in float64 (max |diff| / max
        |exact|); its weight packing, and in 3D the input gradient's, equal
        to their plain version."""
        for flip in (False, True) if w.dim() == 5 else (False,):
            if not torch.equal(cconv.pack_tf32_weight_cuda(w, flip), cconv.pack_tf32_weight(
                    cconv.flip_transpose(w) if flip else w)):
                raise AssertionError(f"{name}: the weight packing (flip={flip}) != its plain "
                                     f"version at {tuple(w.shape)}")
        if w.dim() == 4:
            kernel, plain = cconv.conv2d_bn_cuda, cconv.conv2d_bn_plain
        else:
            kernel = partial(cconv.conv3d_bn_cuda, stride=stride)
            plain = partial(cconv.conv3d_bn_plain, stride=stride)
        got = kernel(x, w, mul, add, rt, relu)
        want = plain(x, w, mul, add, rt, relu)
        check(name, what, got, want)
        log_exact(name, got, want, plain(
            *(None if t is None else t.double() for t in (x, w, mul, add, rt)), relu))

    # the tower's 3x3 stride-1 convs: (channels, side, residual, relu)
    for c, s, res, relu in ((32, 2 * q, False, True), (32, 2 * q, True, False),
                            (64, q, False, True), (64, q, True, False)):
        x = randn(2 * r, c, s, s)
        w = randn(c, c, 3, 3, scale=0.05)
        mul, add = affine(c)
        rt = randn(2 * r, c, s, s) if res else None
        check_tc("conv2d", f"{tuple(x.shape)} residual={res} relu={relu}", x, w, mul, add, rt,
                 relu, 1)
        del x, rt
    left, right = randn(r, 32, q, q), randn(r, 32, q, q)
    w = randn(32, 64, 3, 3, 3, scale=0.05)
    mul, add = affine(32)
    if not torch.equal(cconv.pack_tf32_cost_volume_weight_cuda(w),
                       cconv.pack_tf32_cost_volume_weight(w)):
        raise AssertionError("cost_volume_conv: the weight packing != its plain version")
    got = cconv.cost_volume_conv_bn_cuda(left, right, w, mul, add, -12, 12)
    want = cconv.cost_volume_conv_bn_plain(left, right, w, mul, add, -12, 12)
    check("cost_volume_conv", f"{tuple(left.shape)} x2", got, want)
    # the planes form in float64 is the exact conv of the volume (its
    # identity, tests/test_torch_tf32_cv_deconv.py)
    log_exact("cost_volume_conv", got, want, cconv.cost_volume_conv_bn_planes_plain(
        left.double(), right.double(), w.double(), mul.double(), add.double(), -12, 12))
    del left, right, got, want
    # (channels, depth, side, residual, relu) of the trunk's stride-1 sites
    for c, d, s, res, relu in ((32, d4, q, False, True), (32, d4, q, True, False),
                               (64, d4 // 2, q // 2, True, True),
                               (64, d4 // 2, q // 2, False, True),
                               (64, d4 // 4, q // 4, False, True)):
        x = randn(r, c, d, s, s)
        w = randn(c, c, 3, 3, 3, scale=0.05)
        mul, add = affine(c)
        rt = randn(r, c, d, s, s) if res else None
        check_tc("conv3d", f"{tuple(x.shape)} residual={res} relu={relu}", x, w, mul, add, rt,
                 relu, 1)
        del x, rt
    # the classifiers' 32 -> 1 conv; the second and third add the previous
    # classifier's cost as the residual
    x = randn(r, 32, d4, q, q)
    w = randn(1, 32, 3, 3, 3, scale=0.05)
    for res in (False, True):
        rt = randn(r, 1, d4, q, q) if res else None
        got = cconv.conv3d_bn_cuda(x, w, residual=rt)
        want = cconv.conv3d_bn_plain(x, w, residual=rt)
        check("conv3d_cl1", f"{tuple(x.shape)} residual={res}", got, want)
        log_exact("conv3d_cl1", got, want, cconv.conv3d_bn_plain(
            x.double(), w.double(), residual=None if rt is None else rt.double()))
        del rt, got, want
    # the hourglass's stride-2 convs (32 -> 64 at 56^2, 64 -> 64 at 28^2)
    for ci, d, s in ((32, d4, q), (64, d4 // 2, q // 2)):
        x = randn(r, ci, d, s, s)
        w = randn(64, ci, 3, 3, 3, scale=0.05)
        mul, add = affine(64)
        check_tc("conv3d_s2", f"{tuple(x.shape)}", x, w, mul, add, None, True, 2)
    del x
    # its transposed convs (64 -> 64 from 14^2 with residual and ReLU,
    # 64 -> 32 from 28^2 with residual)
    for co, d, s, relu in ((64, d4 // 4, q // 4, True), (32, d4 // 2, q // 2, False)):
        x = randn(r, 64, d, s, s)
        w = randn(64, co, 3, 3, 3, scale=0.05)
        mul, add = affine(co)
        rt = randn(r, co, 2 * d, 2 * s, 2 * s)
        if not torch.equal(cconv.pack_tf32_deconv_weight_cuda(w),
                           cconv.pack_tf32_deconv_weight(w)):
            raise AssertionError(f"deconv3d: the weight packing != its plain version at "
                                 f"{tuple(w.shape)}")
        got = cconv.deconv3d_bn_cuda(x, w, mul, add, rt, relu)
        want = cconv.deconv3d_bn_plain(x, w, mul, add, rt, relu)
        check("deconv3d", f"{tuple(x.shape)} relu={relu}", got, want)
        log_exact("deconv3d", got, want, cconv.deconv3d_bn_plain(
            *(t.double() for t in (x, w, mul, add, rt)), relu))
        del x, rt, got, want
    logits = randn(r, d4, q, q, scale=3.0)
    size = (BENCH_3D["roi_size"],) * 2
    disp = BENCH_3D["mindisp"], BENCH_3D["maxdisp"]
    got = csam.softargmin_cuda(logits, size, *disp)
    want = csam.softargmin_plain(logits, size, *disp)
    errs["softargmin"] = sam_err(got, want, "softargmin")
    log(f"  softargmin {tuple(logits.shape)} -> {tuple(got.shape)}: max |diff| "
        f"{errs['softargmin']:.3g} px")
    # the same function in float64 (a quarter of the ROIs at a time)
    exact = torch.cat([csam.softargmin_plain(part.double(), size, *disp)
                       for part in logits.split(r // 4)])
    log(f"    against float64: kernel {float((got - exact).abs().max()):.3g} px, plain "
        f"{float((want - exact).abs().max()):.3g} px")
    del exact
    # the kernel's order of operations in PyTorch on the same card
    twin = csam.softargmin_segments_plain(logits, size, *disp)
    log(f"    against its twin (softargmin_segments_plain): kernel "
        f"{float((got - twin).abs().max()):.3g} px")
    del twin
    torch.cuda.synchronize()
    log(f"[3/{PHASES}] iDispNet kernels match their plain versions at the main path's shapes")
    return errs


def chain_float64(x: torch.Tensor, weights) -> torch.Tensor:
    """The SA chain after mlp0, or the FP chain, in float64 (x and every
    weight and bias widened), rounded once to float32 at its end: the exact
    chain that phase 4 measures the kernels and the plain versions
    against."""
    return csa.mlp_chain(x.double(), [(w.double(), b.double()) for w, b in weights]).float()


def point_clouds(gen: torch.Generator, b: int, n: int, scale: float, s: int = 64) -> torch.Tensor:
    """(b, n, 3) clouds on the card: a normal spread, a dense cluster of
    min(n // 2, s + 16) points around point 10 (full balls), coincident
    points (distance ties) and a far outlier (a ball of one point)."""
    x = torch.randn(b, n, 3, generator=gen, device="cuda") * scale
    k = min(n // 2, s + 16)
    x[:, 10:10 + k] = x[:, 10:11] + torch.randn(b, k, 3, generator=gen, device="cuda") * 1e-3
    x[:, 5] = x[:, 2]
    x[:, n - 1] = x[:, 7]
    x[:, 3] = 40.0
    return x.contiguous()


def ball_counts(centers, xyz, radius, s):
    """Per ball, the number of distinct points found (min(in radius, S))."""
    out = []
    for lo in range(0, xyz.shape[0], 256):
        d2 = tpoints.sqdist(centers[lo:lo + 256, :, None], xyz[lo:lo + 256, None])
        out.append((d2 < radius * radius).sum(-1).clamp_max(s))
    return torch.cat(out)


def phase_points_compare() -> dict:
    """The PointRCNN kernels at every site shape of both budgets against
    their plain versions, on clouds that hold empty, partial and full balls
    and boxes with none, fewer than 512 and more than 512 points."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    errs = {"fps": 0.0, "sa": 0.0, "fp": 0.0, "roipool3d": 0.0}
    for b, n, npoint in FPS_SITES:
        xyz = point_clouds(gen, b, n, 1.5)
        want = cfps.furthest_point_sample_plain(xyz, npoint)
        # the wrapper's route, then the other one
        route = cfps.fps_route(b, n)
        for r in (route, *(set(cfps.ROUTES) - {route})):
            got = cfps._launch(xyz, npoint, r)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"FPS ({b}, {n} -> {npoint}) on the {r} route: kernel "
                                     f"indices differ from plain in {int((got != want).sum())} "
                                     f"slots")
        if got.unique().numel() < npoint // 2:
            raise AssertionError(f"FPS ({b}, {n} -> {npoint}): the selection hardly varies")
        log(f"  fps ({b}, {n} -> {npoint}): indices equal on both routes (the wrapper's: "
            f"{route})")
    for site, b, n, m, c0, chain, radius, s in SA_SITES:
        xyz = point_clouds(gen, b, n, 1.2 * radius * n ** (1 / 3) / 4, s)
        centers = torch.cat([xyz[:, :m - 1], torch.full((b, 1, 3), 60.0, device="cuda")], 1)
        v = torch.randn(b, n, c0, generator=gen, device="cuda")
        w0x = torch.randn(3, c0, generator=gen, device="cuda") * (0.5 / radius)
        mul0 = 1 + torch.randn(c0, generator=gen, device="cuda") * 0.3
        add0 = torch.randn(c0, generator=gen, device="cuda") * 0.1
        ws, cin = [], c0
        for co in chain:
            ws.append((torch.randn(cin, co, generator=gen, device="cuda") * cin ** -0.5,
                       torch.randn(co, generator=gen, device="cuda") * 0.1))
            cin = co
        cnt = ball_counts(centers, xyz, radius, s)
        kinds = ((cnt == 0).any(), ((cnt > 0) & (cnt < s)).any(), (cnt == s).any())
        if not all(bool(k) for k in kinds):
            raise AssertionError(f"SA {site}: the clouds lack empty, partial or full balls")
        if not torch.equal(csa.pack_tf32_chain_cuda(ws), csa.pack_tf32_chain(ws)):
            raise AssertionError(f"SA {site}: the chain packing != its plain version")
        args = (xyz, centers.contiguous(), v, w0x, mul0, add0, ws, radius, s)
        got = csa.sa_ball_mlp_max_cuda(*args)
        want = csa.sa_ball_mlp_max_plain(*args)
        e = conv_err(got, want, f"SA {site}")
        errs["sa"] = max(errs["sa"], e)
        exact = csa.sa_ball_mlp_max_plain(*args, chain=chain_float64)
        scale = float(exact.abs().max())
        del v, args
        log(f"  sa {site} ({b}, {n} -> {m}, S {s}, {c0} -> {' -> '.join(map(str, chain))}): "
            f"max |diff| {e:.3g}; against the chain in float64: kernel "
            f"{float((got - exact).abs().max()) / scale:.3g}, plain "
            f"{float((want - exact).abs().max()) / scale:.3g} of max |exact|; balls empty "
            f"{int((cnt == 0).sum())}, partial {int(((cnt > 0) & (cnt < s)).sum())}, full "
            f"{int((cnt == s).sum())}")
        del got, want, exact
    for site, b, nt, ns, c, cs, chain in FP_SITES:
        unknown, known = point_clouds(gen, b, nt, 1.5), point_clouds(gen, b, ns, 1.5)
        unknown[:, 0] = known[:, 4]
        kf = torch.randn(b, ns, c, generator=gen, device="cuda")
        uf = torch.randn(b, nt, cs, generator=gen, device="cuda")
        ws, cin = [], c + cs
        for co in chain:
            ws.append((torch.randn(cin, co, generator=gen, device="cuda") * cin ** -0.5,
                       torch.randn(co, generator=gen, device="cuda") * 0.1))
            cin = co
        if not torch.equal(csa.pack_tf32_chain_cuda(ws), csa.pack_tf32_chain(ws)):
            raise AssertionError(f"FP {site}: the chain packing != its plain version")
        got = cfp.fp_fused_cuda(unknown, known, kf, uf, ws)
        want = cfp.fp_fused_plain(unknown, known, kf, uf, ws)
        e = conv_err(got, want, f"FP {site}")
        errs["fp"] = max(errs["fp"], e)
        exact = cfp.fp_fused_plain(unknown, known, kf, uf, ws, chain=chain_float64)
        scale = float(exact.abs().max())
        log(f"  fp {site} ({b}, {nt} <- {ns}, {c} + {cs} -> {' -> '.join(map(str, chain))}): "
            f"max |diff| {e:.3g}; against the chain in float64: kernel "
            f"{float((got - exact).abs().max()) / scale:.3g}, plain "
            f"{float((want - exact).abs().max()) / scale:.3g} of max |exact|")
        del got, want, exact
    kinds_of_box = torch.tensor([[0.0, 2.0, 0.0, 4.0, 4.0, 4.0, 0.4],  # ~100 points
                                 [1.0, 0.5, -1.0, 1.6, 2.0, 2.0, -0.8],  # ~15
                                 [50.0, 50.0, 50.0, 1.0, 1.0, 1.0, 0.0],  # none
                                 [0.0, 4.0, 0.0, 8.5, 9.0, 9.0, 0.3]],  # > 512
                                device="cuda")
    for b, n, m, c, s in ROI_SITES:
        pts = (torch.rand(b, n, 3, generator=gen, device="cuda") * 8 - 4).contiguous()
        feats = torch.randn(b, n, c, generator=gen, device="cuda")
        boxes = kinds_of_box[torch.arange(m, device="cuda") % 4][None].repeat(b, 1, 1)
        boxes[:, :, :3] += torch.randn(b, m, 3, generator=gen, device="cuda") * 0.3
        boxes = boxes.contiguous()
        counts = troi.pts_in_boxes3d(pts, boxes).sum(-1)
        if not ((counts == 0).any() and ((counts > 0) & (counts < s)).any()
                and (counts > s).any()):
            raise AssertionError("RoI-pool: the boxes lack ones with 0, < S and > S points")
        got, gempty = croi.roipool3d_cuda(pts, feats, boxes, s)
        want, wempty = croi.roipool3d_plain(pts, feats, boxes, s)
        torch.cuda.synchronize()
        if not (torch.equal(gempty, wempty) and torch.equal(got, want)):
            raise AssertionError(f"RoI-pool ({b}, {n}, {m} boxes): kernel differs from plain, "
                                 f"max |diff| {float((got - want).abs().max())}")
        if not (got != 0).any():
            raise AssertionError("RoI-pool: the output is all padding")
        log(f"  roipool3d ({b}, {n}, {c} ch, {m} boxes, S {s}): rows and flags equal; boxes "
            f"empty {int((counts == 0).sum())}, under S {int(((counts > 0) & (counts < s)).sum())}"
            f", over S {int((counts > s).sum())}")
        del got, want
    torch.cuda.synchronize()
    log(f"[4/{PHASES}] PointRCNN kernels match their plain versions at every site shape")
    return errs


def grouped_mlp_inputs(gen: torch.Generator, g: int, s: int, c0: int, chain,
                       negative: bool = False):
    """(x (g, s, c0), mul0, add0, [(W, b)]) on the card, seeded, with a
    non-trivial BN affine; `negative`: every input pre-activation and bias
    below 0, so that every activation is 0."""
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    x, mul0, add0 = randn(g, s, c0), 1 + randn(c0, scale=0.3), randn(c0, scale=0.1)
    if negative:
        x, mul0, add0 = -(x.abs() + 1), mul0.abs() + 0.5, -add0.abs()
    ws, cin = [], c0
    for co in chain:
        b = randn(co, scale=0.1)
        ws.append((randn(cin, co, scale=cin ** -0.5), -b.abs() if negative else b))
        cin = co
    return x, mul0, add0, ws


def phase_grouped_mlp_compare() -> dict:
    """Row 12 at the SA-off route's site shapes of a headline request, whole,
    and at its edge cases, against its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    worst = 0.0
    for site, g, s, c0, chain in GM_SITES + GM_EDGES:
        args = grouped_mlp_inputs(gen, g, s, c0, chain, negative=site == "all negative")
        nc = cgm.launch_plan([c0, *chain], s)[1]
        if not torch.equal(cgm.pack_wgmma_chain_cuda(args[3], nc),
                           cgm.pack_wgmma_chain(args[3], nc)):
            raise AssertionError(f"grouped MLP {site}: the chain packing != its plain version")
        got = cgm.grouped_mlp_max_cuda(*args)
        want = cgm.grouped_mlp_max_plain(*args)
        e = conv_err(got, want, f"grouped MLP {site}")
        if site == "all negative" and float(got.abs().max()) != 0:
            raise AssertionError("grouped MLP: all-negative pre-activations give a max above 0")
        worst = max(worst, e)
        log(f"  grouped_mlp {site} (G {g}, S {s}, {c0} -> {' -> '.join(map(str, chain))}): "
            f"max |diff| {e:.3g} (max |plain| {float(want.abs().max()):.3g})")
        del args, got, want
    torch.cuda.synchronize()
    log(f"[5/{PHASES}] row 12 matches its plain version at the SA-off route's {len(GM_SITES)} "
        f"site shapes and {len(GM_EDGES)} edge cases")
    return {"grouped_mlp": worst}


def check_outputs(out, b: int, max_det: int) -> int:
    dets, masks = out["detections"], out["masks"]
    shapes = {"left": (b, max_det, 4), "right": (b, max_det, 4), "score": (b, max_det),
              "valid": (b, max_det)}
    for name, shape in shapes.items():
        if tuple(getattr(dets, name).shape) != shape:
            raise AssertionError(f"detections.{name} {tuple(getattr(dets, name).shape)} != {shape}")
    if tuple(masks.shape) != (b, max_det, 28, 28):
        raise AssertionError(f"masks {tuple(masks.shape)}")
    for name in ("left", "right", "score"):
        if not torch.isfinite(getattr(dets, name)).all():
            raise AssertionError(f"non-finite detections.{name}")
    if not torch.isfinite(masks).all() or masks.min() < 0 or masks.max() > 1:
        raise AssertionError("masks not finite probabilities")
    n_valid = int(dets.valid.sum())
    if n_valid == 0:
        raise AssertionError("no valid detection")
    return n_valid


def check_disparity(disp: torch.Tensor, b: int, cfg: dict) -> None:
    shape = (b, cfg["max_det"], cfg["roi_size"], cfg["roi_size"])
    if tuple(disp.shape) != shape:
        raise AssertionError(f"disparity_roi {tuple(disp.shape)} != {shape}")
    if not torch.isfinite(disp).all():
        raise AssertionError("non-finite disparity_roi")
    if disp.min() < cfg["mindisp"] or disp.max() >= cfg["maxdisp"]:
        raise AssertionError(f"disparity_roi outside [{cfg['mindisp']}, {cfg['maxdisp']}): "
                             f"[{float(disp.min())}, {float(disp.max())}]")


def check_3d(out, b: int, max_det: int) -> int:
    """box3d (b, max_det, 7), score3d, random and roi_ok of one request:
    shapes, finite values, booleans. Returns the instances with points."""
    shapes = {"box3d": (b, max_det, 7), "score3d": (b, max_det), "random": (b, max_det),
              "roi_ok": (b, max_det)}
    for name, shape in shapes.items():
        if tuple(out[name].shape) != shape:
            raise AssertionError(f"{name} {tuple(out[name].shape)} != {shape}")
    if out["random"].dtype != torch.bool or out["roi_ok"].dtype != torch.bool:
        raise AssertionError("random and roi_ok must be booleans")
    if not (torch.isfinite(out["box3d"]).all() and torch.isfinite(out["score3d"]).all()):
        raise AssertionError("non-finite box3d or score3d")
    return int(out["roi_ok"].sum())


def reset_launches() -> None:
    cuda_nms.launches = 0
    csam.launches = 0
    for mod in (cfps, csa, cgm, cfp, croi):
        mod.launches = 0
    csa.train_launches = 0
    for k in cconv.launches:
        cconv.launches[k] = 0


def read_launches() -> dict:
    return {"nms_sorted": cuda_nms.launches, **cconv.launches, "softargmin": csam.launches,
            "fps": cfps.launches, "sa": csa.launches, "grouped_mlp": cgm.launches,
            "fp": cfp.launches, "roipool3d": croi.launches, "sa_train": csa.train_launches}


@contextlib.contextmanager
def proposals_counted(counts: list):
    """Record the valid proposals of every propose call (a tensor, read
    after the run, so that counting adds no host synchronisation)."""
    orig = rpn3d.propose

    def counted(*args, **kwargs):
        out = orig(*args, **kwargs)
        counts.append(out[2].sum())
        return out

    rpn3d.propose = counted
    try:
        yield
    finally:
        rpn3d.propose = orig


def run_request(model2d, model3d, req, budget: str):
    """(output, ms) of one request at a 3D budget, timed with CUDA events."""
    set_budget(model3d, budget)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = predict(model2d, model3d, *req[:4], calib=CALIB, priorities=req[4])
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_main_path(model2d, model3d, requests):
    """REQUESTS headline requests, then one reference request (the last of
    `requests`)."""
    runs = [(req, "headline") for req in requests[:REQUESTS]] + [(requests[-1], "reference")]
    outs, ms, props = [], [], []
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with proposals_counted(props):
        for req, budget in runs:
            out, t = run_request(model2d, model3d, req, budget)
            outs.append(out)
            ms.append(t)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = {k: n * REQUESTS + EXPECTED_REFERENCE[k] for k, n in EXPECTED_LAUNCHES.items()}
    expected.update(conv3d_train=0, sa_train=0, grouped_mlp=0)
    if launches != expected:
        raise AssertionError(f"kernel launches on the main path {launches}, expected {expected}")
    valid = [check_outputs(o, PAIRS, BENCH_2D["max_det"]) for o in outs]
    with_points = [check_3d(o, PAIRS, BENCH_3D["max_det"]) for o in outs]
    for o in outs:
        check_disparity(o["disparity_roi"], PAIRS, BENCH_3D)
    if not all(with_points):
        raise AssertionError(f"a request with no instance that has lifted points: {with_points}")
    proposals = [int(p) for p in props]
    randoms = [int((o["random"] & o["roi_ok"]).sum()) for o in outs]
    log(f"[6/{PHASES}] predict {BENCH_2D['body']} {PAIRS}x{IMG_HW[0]}x{IMG_HW[1]} -> "
        f"{PAIRS * BENCH_3D['max_det']} ROIs of {BENCH_3D['roi_size']}^2 -> "
        f"{BENCH_3D['npoints']}-point clouds -> PointRCNN, budgets "
        f"{[b for _, b in runs]}: request ms {[round(t, 3) for t in ms]}, valid detections "
        f"{valid}, instances with points {with_points}, valid proposals {proposals}, "
        f"fallback (random) boxes among them {randoms}, launches {launches}, "
        f"peak memory {peak_gb:.2f} GB")
    return outs, runs, ms, launches, peak_gb


def check_boxes_3d(got, want, what: str) -> tuple[float, int, int]:
    """roi_ok and random equal; box3d and score3d within BOX3D_TOL on at
    least BOX3D_AGREE of the instances with points. -> (largest difference
    among the agreeing instances, instances out of tolerance, instances)."""
    ok = want["roi_ok"]
    if not (torch.equal(got["roi_ok"], ok) and torch.equal(got["random"], want["random"])):
        raise AssertionError(f"{what}: roi_ok or random differ")
    box, score = (got[k].to(want[k].device) for k in ("box3d", "score3d"))
    diff = torch.maximum((box - want["box3d"]).abs().amax(-1), (score - want["score3d"]).abs())
    scale = torch.maximum(want["box3d"].abs().amax(-1), want["score3d"].abs())
    good = diff <= BOX3D_TOL * (1 + scale)
    n, bad = int(ok.sum()), int((ok & ~good).sum())
    if n == 0 or bad > (1 - BOX3D_AGREE) * n:
        raise AssertionError(f"{what}: {bad} of {n} instances with points off by more than "
                             f"the tolerance (largest {float(diff[ok].max())})")
    return float(diff[ok & good].max()), bad, n


def phase_plain_path(model2d, model3d, runs, kernel_outs):
    """The same requests with every launch point routed to its plain
    version. The disparity is compared with the kernel path's, then the
    3D stage runs on the kernel path's disparity (a forward hook on
    iDispNet swaps it in), so that both runs lift the same clouds."""
    worst, box_err, off = 0.0, 0.0, []
    for i, ((req, budget), ref) in enumerate(zip(runs, kernel_outs)):
        set_budget(model3d, budget)
        seen = {}

        def swap(_mod, _inp, disp, ref_disp=ref["disparity_roi"]):
            seen["disp"] = disp
            return ref_disp.reshape(disp.shape)

        hook = model3d.idispnet.register_forward_hook(swap)
        try:
            with all_plain():
                out = predict(model2d, model3d, *req[:4], calib=CALIB, priorities=req[4])
        finally:
            hook.remove()
        torch.cuda.synchronize()
        a, b = out["detections"], ref["detections"]
        same = all(torch.equal(getattr(a, f), getattr(b, f))
                   for f in ("left", "right", "score", "valid"))
        same = same and torch.equal(a.fields["labels"], b.fields["labels"])
        same = same and torch.equal(out["masks"], ref["masks"])
        if not same:
            raise AssertionError(f"request {i}: plain-path detections differ from the kernels'")
        err = float((seen["disp"].reshape(ref["disparity_roi"].shape)
                     - ref["disparity_roi"]).abs().max())
        if not err <= DISP_TOL_PX:
            raise AssertionError(f"request {i}: plain-path disparity off by {err} px")
        worst = max(worst, err)
        e, bad, n = check_boxes_3d(out, ref, f"request {i} ({budget})")
        box_err = max(box_err, e)
        off.append(f"{bad}/{n}")
    log(f"[7/{PHASES}] plain versions on the card: detections and masks equal, disparity "
        f"within {worst:.3g} px on {len(runs)} requests; on the same clouds roi_ok and random "
        f"equal, box3d/score3d within {box_err:.3g} (instances out of tolerance: {off})")
    return worst


def small_2d_reference() -> dict:
    """The small 2D configuration on the CPU (plain NMS) and on the card
    (kernel), with the same weights and inputs. The two devices sum float32
    convolutions in different orders (cuDNN may also pick Winograd or FFT
    algorithms) and the box decode exponentiates the deltas, so coordinates
    and scores are held to rtol 1e-3 + atol 1e-3 in their own units, mask
    probabilities to atol 1e-3, validity and labels exactly."""
    cpu = init_random_(DispRCNN(**SMALL_2D, device="cpu"), torch.Generator().manual_seed(2))
    card = DispRCNN(**SMALL_2D, device="cuda")
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(3)
    left, right = (torch.randn(2, 64, 128, 3, generator=gen) for _ in range(2))
    ref = predict_2d(cpu, left, right)
    got = predict_2d(card, left, right)
    torch.cuda.synchronize()
    rd, gd = ref["detections"], got["detections"]
    ok = rd.valid
    if not (torch.equal(gd.valid.cpu(), ok) and ok.any()):
        raise AssertionError("small reference: valid detections differ")
    if not torch.equal(gd.fields["labels"].cpu()[ok], rd.fields["labels"][ok]):
        raise AssertionError("small reference: labels differ")
    errs = {}
    for name, g, r, rtol in (("left", gd.left, rd.left, 1e-3), ("right", gd.right, rd.right, 1e-3),
                             ("score", gd.score, rd.score, 1e-3),
                             ("masks", got["masks"], ref["masks"], 0.0)):
        g, r = g.cpu()[ok], r[ok]
        errs[name] = float((g - r).abs().max())
        if not torch.allclose(g, r, rtol=rtol, atol=1e-3):
            raise AssertionError(f"small reference: {name} off by up to {errs[name]}")
    return errs


def small_3d_reference() -> float:
    """The small DispRCNN3D on fixed detections, CPU (plain versions)
    against the card (kernels), same weights: disparity within DISP_TOL_PX."""
    cpu = init_random_(DispRCNN3D(**SMALL_3D, device="cpu"), torch.Generator().manual_seed(5))
    card = DispRCNN3D(**SMALL_3D, device="cuda")
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(6)
    left_raw, right_raw = (torch.rand(1, 96, 160, 3, generator=gen) for _ in range(2))
    left = torch.tensor([[[10.3, 20.7, 70.2, 60.9], [80.5, 30.1, 121.4, 75.6]]])
    right = left - torch.tensor([[[6.2, 0.0, 5.1, 0.0], [9.8, 0.0, 11.3, 0.0]]])
    dets = StereoBoxes(left=left, right=right, score=torch.tensor([[0.9, 0.6]]),
                       valid=torch.tensor([[True, True]]))
    with torch.inference_mode():
        ref = cpu(left_raw, right_raw, dets)["disparity_roi"]
        got = card(left_raw.cuda(), right_raw.cuda(),
                   StereoBoxes(left=left.cuda(), right=right.cuda(), score=dets.score.cuda(),
                               valid=dets.valid.cuda()))["disparity_roi"]
    torch.cuda.synchronize()
    err = float((got.cpu() - ref).abs().max())
    if not (torch.isfinite(ref).all() and err <= DISP_TOL_PX):
        raise AssertionError(f"small 3D reference: card off the CPU by {err} px")
    return err


def small_det3d_reference() -> tuple:
    """The small DispRCNN3D with det3d_on (2 pairs, 2 detections each,
    clouds of 128 points) on the CPU (plain versions) and on the card
    (kernels), same weights and sampling priorities. The card lifts the
    CPU's disparity (a forward hook on iDispNet swaps it in), so that both
    run PointRCNN on the same clouds: roi_ok and random equal, box3d and
    score3d within BOX3D_TOL on at least BOX3D_AGREE of the instances."""
    cpu = init_random_(DispRCNN3D(**SMALL_DET3D, device="cpu"), torch.Generator().manual_seed(8))
    card = DispRCNN3D(**SMALL_DET3D, device="cuda")
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(9)
    left_raw, right_raw = (torch.rand(2, 96, 160, 3, generator=gen) for _ in range(2))
    left = torch.tensor([[[10.3, 20.7, 70.2, 60.9], [80.5, 30.1, 121.4, 75.6]],
                         [[30.1, 10.2, 90.7, 80.3], [5.5, 40.4, 60.1, 90.2]]])
    right = left - torch.tensor([[6.2, 0.0, 5.1, 0.0], [9.8, 0.0, 11.3, 0.0]])
    mask = torch.rand(2, 2, 28, 28, generator=gen)
    dets = StereoBoxes(left=left, right=right, score=torch.tensor([[0.9, 0.6], [0.8, 0.7]]),
                       valid=torch.ones(2, 2, dtype=torch.bool), fields={"mask": mask})
    calib = {k: torch.full((2,), v) for k, v in
             dict(CALIB, cu=80.0, cv=48.0).items()}
    pri = torch.rand(4, SMALL_DET3D["lift_grid"] ** 2, generator=gen)
    with torch.inference_mode():
        ref = cpu(left_raw, right_raw, dets, calib, pri)
        hook = card.idispnet.register_forward_hook(
            lambda _m, _i, disp: ref["disparity_roi"].to(disp.device))
        try:
            cdets = StereoBoxes(left=left.cuda(), right=right.cuda(), score=dets.score.cuda(),
                                valid=dets.valid.cuda(), fields={"mask": mask.cuda()})
            got = card(left_raw.cuda(), right_raw.cuda(), cdets,
                       {k: v.cuda() for k, v in calib.items()}, pri.cuda())
        finally:
            hook.remove()
    torch.cuda.synchronize()
    got = {k: v.cpu() for k, v in got.items()}
    err, bad, n = check_boxes_3d(got, ref, "small det3d reference")
    return err, bad, n


def phase_small_references() -> float:
    errs = small_2d_reference()
    err3 = small_3d_reference()
    box_err, bad, n = small_det3d_reference()
    log(f"[8/{PHASES}] small references, card vs CPU: 2D (R-50, 2x64x128) max abs error {errs}; "
        f"DispRCNN3D (2 ROIs of 64^2) disparity {err3:.3g} px; with det3d_on on the same "
        f"clouds, box3d/score3d within {box_err:.3g} ({bad} of {n} instances with points out "
        f"of tolerance)")
    return err3


def snapshot(a):
    """A launch argument as it was at the launch: tensors (and the (W, b)
    pairs of an MLP chain) cloned, the rest as given."""
    if torch.is_tensor(a):
        return a.detach().clone()
    if isinstance(a, list):
        return [tuple(map(snapshot, pair)) for pair in a]
    return a


def conv_name(args):
    if args[6] == 2:
        return "conv3d_s2"
    return "conv3d_cl1" if args[1].shape[0] == 1 else "conv3d"


# each launch point of the main path -> its kernel's name, or a function of
# the launch's arguments that names it
MAIN_PATH_POINTS = dict(
    nms_sorted_cuda="nms_sorted", conv3d_bn_cuda=conv_name,
    cost_volume_conv_bn_cuda="cost_volume_conv", deconv3d_bn_cuda="deconv3d",
    conv2d_bn_cuda="conv2d", softargmin_cuda="softargmin", furthest_point_sample_cuda="fps",
    sa_ball_mlp_max_cuda="sa", fp_fused_cuda="fp", roipool3d_cuda="roipool3d")


def capture_launches(run, points: dict) -> dict:
    """The arguments of every kernel launch during run() at the launch
    points named in `points` (as MAIN_PATH_POINTS), by kernel."""
    calls = {}

    def recorder(point, name):
        def record(*args):
            calls.setdefault(name(args) if callable(name) else name, []).append(
                tuple(map(snapshot, args)))
            return orig[point](*args)
        return record

    with launches_replaced(**{p: recorder(p, n) for p, n in points.items()}) as orig:
        run()
    torch.cuda.synchronize()
    return calls


@contextlib.contextmanager
def cudnn_free():
    """cuDNN free to pick non-deterministic algorithms (the rest of the
    script keeps it deterministic, so that kernel and plain runs of the
    cuDNN layers compare exactly): the library yardstick and phase 10's
    second timing run under it."""
    torch.backends.cudnn.deterministic = False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = True


def bound(nbytes: float, ops: float) -> tuple[float, float]:
    """(bytes ms, operations ms) at the card's peak rates."""
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3


def nms_work(args, out):
    """Inputs read once and outputs (int32 index + flag per slot) written
    once; every survivor's IoU test with each box after it in sorted order."""
    boxes, valid, k = args[:3]
    idx, ok = out
    b, n, _ = boxes.shape
    nbytes = boxes.numel() * 4 + valid.numel() + b * k * 5
    return bound(nbytes, float(((n - 1 - idx) * ok).sum()) * IOU_OPS)


def reach(n_in: int, n_out: int, stride: int = 1, transposed: bool = False) -> torch.Tensor:
    """Along one axis of a 3-tap conv with padding 1: for each input index,
    the number of (output, tap k) pairs that read it. Forward: input
    stride * o + k - 1; transposed (stride 2): input i with 2i + k - 1 = o.
    Taps that fall in the padding are in no entry."""
    r = torch.zeros(n_in, dtype=torch.float64)
    for o in range(n_out):
        for k in range(3):
            if transposed:
                if (o + 1 - k) % 2 == 0 and 0 <= (o + 1 - k) // 2 < n_in:
                    r[(o + 1 - k) // 2] += 1
            elif 0 <= stride * o + k - 1 < n_in:
                r[stride * o + k - 1] += 1
    return r


def conv_work(args, out, transposed=False):
    """Input, weights, epilogue vectors and residual read once, output
    written once; 2 operations per product of an input value and a weight
    that the conv needs: taps in the padding are not counted."""
    x, w = args[:2]
    res = args[4] if len(args) > 4 else None
    stride = args[6] if len(args) > 6 else 1
    co, ci = (w.shape[1], w.shape[0]) if transposed else (w.shape[0], w.shape[1])
    nbytes = 4 * (x.numel() + w.numel() + out.numel() + 2 * co
                  + (res.numel() if res is not None else 0))
    pairs = 1.0
    for n_in, n_out in zip(x.shape[2:], out.shape[2:]):
        pairs *= float(reach(n_in, n_out, stride, transposed).sum())
    return bound(nbytes, 2.0 * x.shape[0] * co * ci * pairs)


def cost_volume_work(args, out):
    """The dense conv's count: as conv_work over the cost volume, counting
    only its non-zero inputs: slice z (disparity i = mind4 + z) holds W -
    |i| columns."""
    left, right, w, _, _, mind4 = args[:6]
    n, c, h, wd = left.shape
    d = out.shape[2]
    nbytes = 4 * (left.numel() + right.numel() + w.numel() + out.numel() + 2 * w.shape[0])
    rd, rh, rw = reach(d, d), reach(h, h), reach(wd, wd)
    cols = torch.arange(wd)
    pairs = 0.0
    for z in range(d):
        i = mind4 + z
        valid = (cols - i >= 0) & (cols - i < wd)
        pairs += float(rd[z]) * float(rw[valid].sum())
    pairs *= float(rh.sum())
    return bound(nbytes, 2.0 * n * w.shape[0] * 2 * c * pairs)


def cost_volume_planes_work(args, out):
    """The work the cost-volume conv needs, as its tap planes compute it
    (the dense count, cost_volume_work, does each plane product again in
    every slice that reads it): bytes as cost_volume_work; 2 operations
    per product of a feature value and a weight in the planes of both
    views (rows in the padding not counted), and 2 adds per plane pair an
    output sums (PL + PR, then into the sum; at most 9 pairs)."""
    left, right, w, _, _, mind4 = args[:6]
    n, c, h, wd = left.shape
    co, d = w.shape[0], out.shape[2]
    nbytes = 4 * (left.numel() + right.numel() + w.numel() + out.numel() + 2 * co)
    products = 2.0 * n * 9 * co * c * float(reach(h, h).sum()) * wd
    z, x = torch.arange(d)[:, None], torch.arange(wd)[None]
    pairs = 0
    for kd in range(3):
        zz = z + kd - 1
        for kw in range(3):
            xp = x + kw - 1
            u = xp - (mind4 + zz)
            pairs += int(((zz >= 0) & (zz < d) & (xp >= 0) & (xp < wd) & (u >= 0)
                          & (u < wd)).sum())
    return bound(nbytes, 2.0 * products + 2.0 * n * co * h * pairs)


def softargmin_parts(args, out) -> dict:
    """The soft-argmin's bounds, ms: bytes (logits read once, the map written
    once), FP32 operations, and the exponentials the function needs at the
    SFU rate (two per non-empty segment and pixel); and, not a bound, the
    SFU time of the present design's one exponential per pixel and
    disparity (sfu_design)."""
    logits, _, mindisp, maxdisp = args
    d4, pixels, d = logits.shape[1], out.numel(), maxdisp - mindisp
    t_bytes, t_ops = bound(4 * (logits.numel() + pixels),
                           pixels * (SAM_TAP_OPS * d4 + SAM_DISP_OPS * d))
    segments = int((csam.disparity_segments(d4, d)[2] > 0).sum())
    return {"bytes": t_bytes, "fp32": t_ops,
            "sfu": pixels * SAM_SEGMENT_EXPS * segments / SFU_PER_S * 1e3,
            "sfu_design": pixels * d / SFU_PER_S * 1e3}


def softargmin_work(args, out):
    """(bytes ms, operations ms): the operations' time is the longer of the
    FP32 work and the exponentials the function needs (softargmin_parts)."""
    parts = softargmin_parts(args, out)
    return parts["bytes"], max(parts["fp32"], parts["sfu"])


def fps_work(args, out):
    """Inputs read once, int64 indices written once; FPS_OPS per point and
    step."""
    xyz, npoint = args[:2]
    b, n, _ = xyz.shape
    return bound(4 * xyz.numel() + 8 * out.numel(), float(FPS_OPS * b * n * (npoint - 1)))


def fps_chain_ms(n: int, npoint: int, route: str, repeats: int = 5) -> tuple:
    """The serial chain of one cloud of N points on `route`: t(B = 1, npoint)
    - t(B = 1, npoint = 1) in device time, the (npoint - 1) dependent steps
    that a launch of any B takes at least. The median of `repeats` and
    their (min, max); raises unless every one is positive."""
    xyz = torch.randn(1, n, 3, generator=torch.Generator(device="cuda").manual_seed(n),
                      device="cuda")
    diffs = sorted(time_ms(lambda: cfps._launch(xyz, npoint, route), 10, queued=True)
                   - time_ms(lambda: cfps._launch(xyz, 1, route), 10, queued=True)
                   for _ in range(repeats))
    if diffs[0] <= 0:
        raise AssertionError(f"FPS chain ({n} -> {npoint}, {route} route): a difference "
                             f"{diffs[0]:.4g} ms is not positive")
    return diffs[len(diffs) // 2], (diffs[0], diffs[-1])


def nms_chain_ms(args, repeats: int = 5) -> tuple:
    """One NMS launch's work for its first image alone (B = 1) in device
    time, the serial walk with the masks it needs: the median of `repeats`
    and their (min, max)."""
    one = (args[0][:1].contiguous(), args[1][:1].contiguous(), *args[2:])
    runs = sorted(time_ms(lambda: cuda_nms.nms_sorted_cuda(*one), 10, queued=True)
                  for _ in range(repeats))
    return runs[len(runs) // 2], (runs[0], runs[-1])


def nms_walk_stop(args, out) -> int:
    """The sorted position after which the launch's longest walk stopped:
    its image's k-th survivor, or N where an image keeps fewer."""
    n = args[0].shape[1]
    idx, ok = out
    return int(torch.where(ok[:, -1], idx[:, -1] + 1, torch.full_like(idx[:, -1], n)).max())


def scan_and_hits(mask: torch.Tensor, s: int):
    """For (..., N) in-ball (or in-box) masks: the points a scan in index
    order tests before it has found s, and the distinct hits (at most s)."""
    cum = mask.cumsum(-1)
    scanned = ((cum < s).sum(-1) + 1).clamp_max(mask.shape[-1])
    return float(scanned.sum()), float(cum[..., -1].clamp_max(s).sum())


def chain_ops(weights) -> float:
    """A product and a sum per weight, a bias and a ReLU per output."""
    return float(sum(2 * w.shape[0] * w.shape[1] + 2 * w.shape[1] for w, _ in weights))


def sa_work(args, out):
    """Inputs and weights read once, output written once. The distances a
    ball query in index order needs until it has S; per distinct neighbour
    (slots that repeat the first one are not counted): the centring (3),
    the xyz term, v and the BN0 affine + ReLU (9 per channel), the chain
    and the max."""
    xyz, centers, v, w0x, _, _, weights, radius, s = args
    scanned = hits = 0.0
    for lo in range(0, xyz.shape[0], 128):
        d2 = tpoints.sqdist(centers[lo:lo + 128, :, None], xyz[lo:lo + 128, None])
        a, h = scan_and_hits(d2 < radius * radius, s)
        scanned, hits = scanned + a, hits + h
    c0 = v.shape[-1]
    ops = DIST_OPS * scanned + hits * (3 + 9 * c0 + chain_ops(weights) + out.shape[-1])
    nbytes = 4 * (xyz.numel() + centers.numel() + v.numel() + w0x.numel() + 2 * c0
                  + sum(w.numel() + b.numel() for w, b in weights) + out.numel())
    return bound(nbytes, ops)


def grouped_mlp_work(args, out):
    """x, the affine and the weights read once, the output written once; per
    row of x the affine and ReLU (3 per channel), the chain and the max.
    Every row counts: the function cannot tell a ball's repeated first
    neighbour from a distinct one (sa_work counts distinct neighbours)."""
    x, mul0, _, weights = args
    g, s, c0 = x.shape
    ops = g * s * (3 * c0 + chain_ops(weights) + out.shape[-1])
    nbytes = 4 * (x.numel() + 2 * c0 + sum(w.numel() + b.numel() for w, b in weights)
                  + out.numel())
    return bound(nbytes, float(ops))


def fp_work(args, out):
    """Inputs and weights read once, output written once; per target the
    distances to every source, the three weights (~12), the interpolation
    (5 per channel) and the chain."""
    unknown, known, kf, uf, weights = args[:5]
    b, nt, _ = unknown.shape
    ops = b * nt * (DIST_OPS * known.shape[1] + 12 + 5 * kf.shape[-1] + chain_ops(weights))
    nbytes = 4 * (unknown.numel() + known.numel() + kf.numel() + uf.numel()
                  + sum(w.numel() + bb.numel() for w, bb in weights) + out.numel())
    return bound(nbytes, float(ops))


def roipool3d_work(args, out):
    """Inputs read once, the pooled rows and flags written once; the in-box
    tests a scan in index order needs until it has S points."""
    pts, feats, boxes, s = args[:4]
    scanned, _ = scan_and_hits(troi.pts_in_boxes3d(pts, boxes), s)
    nbytes = 4 * (pts.numel() + feats.numel() + boxes.numel() + out[0].numel()) + out[1].numel()
    return bound(nbytes, INBOX_OPS * scanned)


def main_path_err(name: str, got, want) -> float:
    """max |kernel - plain| of one main-path launch; the selections of NMS,
    RoI-pool 3D and FPS must be equal, the rest within its tolerance."""
    if name in ("nms_sorted", "roipool3d"):
        e = float((got[0] - want[0]).abs().max())
        if e != 0 or not torch.equal(got[1], want[1]):
            raise AssertionError(f"{name} kernel != plain on the main path's inputs")
        return e
    if name == "fps":
        e = float((got - want).abs().max())
        if e != 0:
            raise AssertionError("FPS kernel != plain on the main path's inputs")
        return e
    if name == "softargmin":
        return sam_err(got, want, "softargmin on the main path")
    return conv_err(got, want, f"{name} on the main path")


@torch.inference_mode()
def time_launches(name: str, forms, err: float, src: str, replaces: str) -> dict:
    """One row of the `kernels` line. `forms` are (label, launches' arguments,
    kernel, plain version, library call or None, work, compare): each
    launch's kernel result held against its plain version (compare(got,
    want) -> max |diff|, raising past the tolerance), then kernel, plain
    version and library call timed on its arguments, with the bound; the
    row sums them over the launches. A row of TC_ROWS also gets the bound
    at the 3xTF32 tensor-core rate, bound_tc_ms, and the time of its
    weight split and packing alone (TC_ROWS, a launch of the kernel's call),
    pack_ms. The row lists each launch's time (launch_ms), in launch order,
    and with more than one form each form's (form_ms); device_ms and
    device_launch_ms are the same launches timed with time_ms(queued=True)."""
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=None, t_bytes=0.0, t_ops=0.0, bound_ms=0.0,
               bound_tc_ms=0.0, pack_ms=0.0, device_ms=0.0)
    n = 0
    form_ms, launch_ms, device_launch_ms = {}, [], []
    for label, calls, kernel, plain, library, work, compare in forms:
        form_ms[label.strip()] = 0.0
        for args in calls:
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            err = max(err, compare(got, want))
            t_bytes, t_ops = work(args, got)
            del got, want
            ms = time_ms(lambda: kernel(*args), 5)
            dev_ms = time_ms(lambda: kernel(*args), 5, queued=True)
            plain_ms = time_ms(lambda: plain(*args), 2)
            lib_ms = None
            if library:
                with cudnn_free():
                    lib_ms = time_ms(lambda: library(args), 3)
                tot["library_ms"] = (tot["library_ms"] or 0.0) + lib_ms
            bound_tc = max(t_bytes, t_ops * FP32_OPS_PER_S / TC_3XTF32_OPS_PER_S)
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("t_bytes", t_bytes),
                         ("t_ops", t_ops), ("bound_ms", max(t_bytes, t_ops)),
                         ("bound_tc_ms", bound_tc), ("device_ms", dev_ms)):
                tot[k] += v
            n += 1
            form_ms[label.strip()] += ms
            launch_ms.append(ms)
            device_launch_ms.append(dev_ms)
            lib = "-" if lib_ms is None else f"{lib_ms:.4f} ms"
            tc = ""
            if name in TC_ROWS:
                pack_ms = time_ms(lambda: TC_ROWS[name](args), 5)
                tot["pack_ms"] += pack_ms
                tc = f", tensor-core bound {bound_tc:.4f} ms, weight packing {pack_ms:.4f} ms"
            log(f"  {name}{label} {tuple(args[0].shape)}: kernel {ms:.4f} ms (device "
                f"{dev_ms:.4f} ms), plain "
                f"{plain_ms:.4f} ms, library {lib}, bound {max(t_bytes, t_ops):.4f} ms "
                f"({'bytes' if t_bytes >= t_ops else 'operations'}){tc}")
    lib = "-" if tot["library_ms"] is None else f"{tot['library_ms']:.4f} ms"
    tc = (f", tensor-core bound {tot['bound_tc_ms']:.4f} ms, weight packing "
          f"{tot['pack_ms']:.4f} ms" if name in TC_ROWS else "")
    log(f"  {name}, summed over {n} launches: kernel {tot['ms']:.4f} ms (device "
        f"{tot['device_ms']:.4f} ms), plain "
        f"{tot['plain_ms']:.4f} ms, library {lib}, bound {tot['bound_ms']:.4f} ms{tc}")
    row = dict(name=name, route="cuda", source=f"disprcnn_tpu_torch/csrc/{src}",
               replaces=replaces, max_abs_err=err, ms=tot["ms"], plain_ms=tot["plain_ms"],
               bound_ms=tot["bound_ms"],
               bound_by="bytes" if tot["t_bytes"] > tot["t_ops"] else "operations",
               library_ms=tot["library_ms"])
    if name in TC_ROWS:
        row["bound_tc_ms"] = tot["bound_tc_ms"]
        row["pack_ms"] = tot["pack_ms"]
    row["launch_ms"] = launch_ms
    row["device_ms"] = tot["device_ms"]
    row["device_launch_ms"] = device_launch_ms
    if len(forms) > 1:
        row["form_ms"] = form_ms
    return row


def kernel_kinds() -> dict:
    """Each eval kernel row -> (kernel, plain version, library call or None,
    work, source, the TPU kernel it replaces)."""
    pc = "disprcnn_tpu/ops/pallas/packed_conv.py"
    return {
        "nms_sorted": (cuda_nms.nms_sorted_cuda, cuda_nms.nms_sorted_plain, None, nms_work,
                       "nms.cu", "disprcnn_tpu/ops/pallas/nms.py:32"),
        "conv2d": (cconv.conv2d_bn_cuda, cconv.conv2d_bn_plain,
                   lambda a: F.conv2d(a[0], a[1], padding=1), conv_work, "conv3d_tc.cu",
                   f"{pc}:147"),
        "cost_volume_conv": (cconv.cost_volume_conv_bn_cuda, cconv.cost_volume_conv_bn_plain,
                             None, cost_volume_planes_work, "cost_volume_tc.cu", f"{pc}:37"),
        "conv3d": (cconv.conv3d_bn_cuda, cconv.conv3d_bn_plain,
                   lambda a: F.conv3d(a[0], a[1], padding=1), conv_work, "conv3d_tc.cu",
                   f"{pc}:461"),
        "conv3d_cl1": (cconv.conv3d_bn_cuda, cconv.conv3d_bn_plain,
                       lambda a: F.conv3d(a[0], a[1], padding=1), conv_work, "conv3d.cu",
                       f"{pc}:461"),
        "conv3d_s2": (cconv.conv3d_bn_cuda, cconv.conv3d_bn_plain,
                      lambda a: F.conv3d(a[0], a[1], stride=2, padding=1), conv_work,
                      "conv3d_tc.cu", f"{pc}:239"),
        "deconv3d": (cconv.deconv3d_bn_cuda, cconv.deconv3d_bn_plain,
                     lambda a: F.conv_transpose3d(a[0], a[1], stride=2, padding=1,
                                                  output_padding=1),
                     lambda a, o: conv_work(a, o, transposed=True), "conv3d_tc.cu",
                     f"{pc}:342"),
        "softargmin": (csam.softargmin_cuda, csam.softargmin_plain, None, softargmin_work,
                       "softargmin.cu", "disprcnn_tpu/ops/pallas/softargmin.py:47"),
        "fps": (cfps.furthest_point_sample_cuda, cfps.furthest_point_sample_plain, None,
                fps_work, "fps.cu", "disprcnn_tpu/ops/pallas/fps.py:65"),
        "sa": (csa.sa_ball_mlp_max_cuda, csa.sa_ball_mlp_max_plain, None, sa_work, "sa.cu",
               "disprcnn_tpu/ops/pallas/sa_fused.py:1107"),
        "fp": (cfp.fp_fused_cuda, cfp.fp_fused_plain, None, fp_work, "fp.cu",
               "disprcnn_tpu/ops/pallas/fp_fused.py:76"),
        "roipool3d": (croi.roipool3d_cuda, croi.roipool3d_plain, None, roipool3d_work,
                      "roipool3d.cu", "disprcnn_tpu/ops/pallas/roipool3d_fused.py:137"),
    }


@torch.inference_mode()
def phase_timing(model2d, model3d, req, compare_errs):
    """Each kernel on one request's own inputs: kernel, plain version and
    library call summed over the request's launches, with the bound (in
    inference mode, as predict runs them)."""
    set_budget(model3d, "headline")
    calls = capture_launches(
        lambda: predict(model2d, model3d, *req[:4], calib=CALIB, priorities=req[4]),
        MAIN_PATH_POINTS)
    kinds = kernel_kinds()
    rows = {}
    for name, (kernel, plain, library, work, src, replaces) in kinds.items():
        launches = calls.get(name, [])
        if len(launches) != EXPECTED_LAUNCHES[name]:
            raise AssertionError(f"{name}: {len(launches)} launches in one request, "
                                 f"expected {EXPECTED_LAUNCHES[name]}")
        site = LAUNCH_SITE.get(name, lambda a: "")
        groups = {}
        for a in launches:
            groups.setdefault(f" {site(a)}".rstrip(), []).append(a)
        rows[name] = time_launches(
            name, [(label, group, kernel, plain, library, work, partial(main_path_err, name))
                   for label, group in groups.items()],
            compare_errs.get(name, 0.0), src, replaces)
        if name == "softargmin":
            parts = {}
            for a in launches:
                for k, v in softargmin_parts(a, torch.empty(a[0].shape[0], *a[1],
                                                            device="meta")).items():
                    parts[k] = parts.get(k, 0.0) + v
            binds = max(("bytes", "fp32", "sfu"), key=parts.get)
            rows[name].update(bound_parts_ms=parts, binds=binds)
            log(f"  softargmin bounds: bytes {parts['bytes']:.4f} ms, FP32 operations "
                f"{parts['fp32']:.4f} ms, the exponentials it needs on the SFU "
                f"{parts['sfu']:.4f} ms: {binds} binds (not a bound: the design's one "
                f"exponential a disparity on the SFU {parts['sfu_design']:.4f} ms)")
        if name == "fps":
            # each launch's serial chain: one cloud of its N on its route
            sites = [(cfps.fps_route(*a[0].shape[:2]), a[0].shape[1], a[1]) for a in launches]
            chains = {(r, n, npoint): fps_chain_ms(n, npoint, r)
                      for r, n, npoint in dict.fromkeys(sites)}
            floor = sum(chains[site][0] for site in sites)
            label = {site: "{} {} -> {}".format(*site) for site in chains}
            step_us = {label[site]: ms / (site[2] - 1) * 1e3 for site, (ms, _) in chains.items()}
            rows[name].update(chain_ms={label[k]: c[0] for k, c in chains.items()},
                              chain_spread_ms={label[k]: c[1] for k, c in chains.items()},
                              step_us=step_us, serial_floor_ms=floor)
            for site, (ms, (lo, hi)) in chains.items():
                log(f"  fps chain of one cloud, {label[site]}: {ms:.4f} ms (5 runs "
                    f"{lo:.4f}-{hi:.4f}), {step_us[label[site]]:.4f} us a step")
            log(f"  fps: serial floor {floor:.4f} ms over the {len(launches)} launches, "
                f"operations bound {rows[name]['bound_ms']:.4f} ms")
        if name == "nms_sorted":
            # each site's launch on one image: the serial floor beside the
            # operations bound
            chains, stops = {}, {}
            for a in launches:
                site = LAUNCH_SITE[name](a)
                chains[site] = nms_chain_ms(a)
                stops[site] = (nms_walk_stop(a, cuda_nms.nms_sorted_cuda(*a)), a[0].shape[1])
            floor = sum(chains[LAUNCH_SITE[name](a)][0] for a in launches)
            rows[name].update(chain_ms={k: c[0] for k, c in chains.items()},
                              chain_spread_ms={k: c[1] for k, c in chains.items()},
                              walk_stop={k: v[0] for k, v in stops.items()},
                              serial_floor_ms=floor)
            for site, (ms, (lo, hi)) in chains.items():
                log(f"  nms {site} on one image: {ms:.4f} ms (5 runs {lo:.4f}-{hi:.4f}); the "
                    f"walk stopped after sorted box {stops[site][0]} of {stops[site][1]}")
            log(f"  nms: serial floor {floor:.4f} ms over the {len(launches)} launches, "
                f"operations bound {rows[name]['bound_ms']:.4f} ms")
        if name == "cost_volume_conv":
            # the dense conv's count, the bound that earlier rows were read against
            dense = sum(max(cost_volume_work(a, torch.empty(
                (a[0].shape[0], a[2].shape[0], a[6] - a[5], *a[0].shape[2:]), device="meta")))
                for a in launches)
            rows[name]["dense_bound_ms"] = dense
            log(f"  cost_volume_conv: the dense conv's bound {dense:.4f} ms (operations)")
    log(f"[9/{PHASES}] kernels timed on one headline request's own inputs")
    return rows


@contextlib.contextmanager
def functions_marked(mark, spans):
    """Wrap functions that are not modules (spans of (owner, attribute,
    stage that ends at the call or None, stage that ends at the return))
    so that each records `mark(name)` at those points."""
    orig = {}
    for owner, fn_name, before, after in spans:
        fn = getattr(owner, fn_name)
        orig[(owner, fn_name)] = fn

        def wrapped(*args, _fn=fn, _before=before, _after=after, **kwargs):
            if _before:
                mark(_before)()
            out = _fn(*args, **kwargs)
            mark(_after)()
            return out

        setattr(owner, fn_name, wrapped)
    try:
        yield
    finally:
        for (owner, fn_name), fn in orig.items():
            setattr(owner, fn_name, fn)


def split_by_events(run, hooks, spans, last: str) -> tuple[float, dict]:
    """run() split into stages by CUDA events recorded at stage boundaries:
    `hooks` are (module, "pre" or "post", stage that ends at the module's
    entry or exit), `spans` as functions_marked takes them, and `last` the
    stage that ends when run() returns; nothing of the forward is copied.
    Stages that recur (once per proposal block) are summed. -> (total ms,
    ms by stage)."""
    marks = []  # (name of the stage that ends here, event)

    def mark(name):
        def record(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))
        return record

    handles = [(mod.register_forward_pre_hook if kind == "pre" else mod.register_forward_hook)(
        mark(name)) for mod, kind, name in hooks]
    try:
        with functions_marked(mark, spans):
            mark("start")()
            run()
            mark(last)()
            torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    stages = {}
    for (_, prev), (name, ev) in zip(marks, marks[1:]):
        stages[name] = stages.get(name, 0.0) + prev.elapsed_time(ev)
    return marks[0][1].elapsed_time(marks[-1][1]), stages


def breakdown(model2d, model3d, req, budget: str):
    """One request split into its stages (split_by_events)."""
    psm, prc = model3d.idispnet, model3d.pointrcnn
    hooks = ((model3d, "pre", "2D detector"), (psm.feature_extraction, "pre", "crops"),
             (psm.feature_extraction, "post", "feature tower"),
             (psm.dres2, "pre", "cost volume + dres"), (psm.classif1_0, "pre", "hourglasses"),
             (psm, "post", "classifiers + regression"), (prc, "pre", "lift"),
             (prc.rpn.backbone, "post", "RPN backbone"), (prc.rpn, "post", "RPN heads"),
             (prc.rcnn, "post", "RCNN"), (model3d, "post", "postprocess"))
    spans = ((rpn3d, "propose", None, "propose + NMS"),
             (rcnn3d, "pool_rcnn_inputs", None, "RoI-pool 3D"),
             (rcnn3d, "rcnn_postprocess", None, "postprocess"))
    set_budget(model3d, budget)
    return split_by_events(
        lambda: predict(model2d, model3d, *req[:4], calib=CALIB, priorities=req[4]),
        hooks, spans, "outputs")


def phase_breakdown(model2d, model3d, reqs, card: str) -> dict:
    """breakdown() of one headline and one reference request, pairs per
    second of each; then the headline request with cuDNN free to pick
    non-deterministic algorithms for the convs left to it."""
    out = {}
    for budget, req in zip(BUDGETS, reqs):
        total, stages = breakdown(model2d, model3d, req, budget)
        out[budget] = (total, stages)
        log(f"  {budget} request, {total:.3f} ms ({PAIRS * 1000.0 / total:.3f} pairs/s): "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items()))
    set_budget(model3d, "headline")
    with cudnn_free():
        free_ms = [time_ms(lambda: predict(model2d, model3d, *reqs[0][:4], calib=CALIB,
                                           priorities=reqs[0][4]), 1) for _ in range(2)]
    log(f"[10/{PHASES}] pairs/s on {card}: headline {PAIRS * 1000.0 / out['headline'][0]:.3f}, "
        f"reference {PAIRS * 1000.0 / out['reference'][0]:.3f}; the headline request with "
        f"non-deterministic cuDNN: {[round(t, 3) for t in free_ms]} ms")
    return out


def grouped_mlp_float64(x, mul0, add0, weights) -> torch.Tensor:
    """Row 12's function with the input affine, every product and sum in
    float64 and the max, rounded once to float32 at its end, 4096 groups at
    a time."""
    outs = []
    for lo in range(0, x.shape[0], 4096):
        y = torch.relu(x[lo:lo + 4096].double() * mul0.double() + add0.double())
        outs.append(chain_float64(y, weights).amax(dim=1))
    return torch.cat(outs)


@torch.inference_mode()
def grouped_mlp_exact_errs() -> dict:
    """Row 12 and its plain float32 version against the same function in
    float64 (grouped_mlp_float64) at the eight GM_SITES, whole: max |diff| /
    max |exact| of each. The kernel's 3xTF32 chain must stay within twice
    the plain float32 chain's distance."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    errs = {}
    for site, g, s, c0, chain in GM_SITES:
        args = grouped_mlp_inputs(gen, g, s, c0, chain)
        exact = grouped_mlp_float64(*args)
        scale = float(exact.abs().max())
        kernel = float((cgm.grouped_mlp_max_cuda(*args) - exact).abs().max()) / scale
        plain = float((cgm.grouped_mlp_max_plain(*args) - exact).abs().max()) / scale
        errs[site] = (kernel, plain)
        log(f"  grouped_mlp {site} against the chain in float64: kernel {kernel:.3g}, plain "
            f"{plain:.3g} of max |exact|")
        if not kernel <= 2 * plain:
            raise AssertionError(f"row 12 at {site}: {kernel:.3g} from the float64 chain, more "
                                 f"than twice the plain float32 chain's {plain:.3g}")
        del args, exact
    return errs


def phase_sa_off(model2d, model3d, req, ref, default_stages: dict, err: float,
                 card: str) -> dict:
    """The SA-off route on one headline request (`req`, whose default-route
    output phase 6 gave as `ref`): launches counted from 0, the 3D stage on
    ref's disparity (a forward hook on iDispNet swaps it in, so that both
    lift the same clouds) held to ref, the time and peak memory, the RPN
    backbone and RCNN stages beside the default route's; then row 12 timed
    on that request's own inputs. -> row 12's row of the `kernels` line."""
    set_kernels_off(model3d, {"sa"})
    try:
        hook = model3d.idispnet.register_forward_hook(
            lambda _m, _i, disp: ref["disparity_roi"].reshape(disp.shape))
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        try:
            out, ms = run_request(model2d, model3d, req, "headline")
        finally:
            hook.remove()
        launches = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        expected = dict(EXPECTED_SA_OFF, conv3d_train=0, sa_train=0)
        if launches != expected:
            raise AssertionError(f"SA-off request launches {launches}, expected {expected}")
        check_outputs(out, PAIRS, BENCH_2D["max_det"])
        a, b = out["detections"], ref["detections"]
        if not (all(torch.equal(getattr(a, f), getattr(b, f))
                    for f in ("left", "right", "score", "valid"))
                and torch.equal(out["masks"], ref["masks"])):
            raise AssertionError("SA-off request: the 2D detections differ from the default's")
        check_3d(out, PAIRS, BENCH_3D["max_det"])
        box_err, bad, n = check_boxes_3d(out, ref, "SA-off route against the default")
        del out
        total, stages = breakdown(model2d, model3d, req, "headline")
        calls = capture_launches(
            lambda: predict(model2d, model3d, *req[:4], calib=CALIB, priorities=req[4]),
            dict(grouped_mlp_max_cuda="grouped_mlp"))
        row = time_launches("grouped_mlp", [
            ("", calls["grouped_mlp"], cgm.grouped_mlp_max_cuda, cgm.grouped_mlp_max_plain, None,
             grouped_mlp_work, partial(main_path_err, "grouped_mlp"))],
            err, "grouped_mlp.cu", "disprcnn_tpu/ops/pallas/grouped_mlp.py:44")
        del calls
        exact_errs = grouped_mlp_exact_errs()
    finally:
        set_kernels_off(model3d, ())
    dtotal, dstages = default_stages
    split = ", ".join(f"{k} {stages[k]:.3f} ms (default {dstages[k]:.3f})"
                      for k in ("RPN backbone", "RCNN"))
    log(f"[11/{PHASES}] SA-off headline request on {card}: {ms:.3f} ms ({PAIRS * 1e3 / ms:.3f} "
        f"pairs/s), split {total:.3f} ms (default {dtotal:.3f}): {split}; launches {launches}; "
        f"peak memory {peak_gb:.2f} GB; on the default run's clouds roi_ok and random equal, "
        f"box3d/score3d within {box_err:.3g} ({bad} of {n} instances out of tolerance)")
    worst = max(exact_errs, key=lambda k: exact_errs[k][0])
    log(f"  grouped_mlp against float64, worst site {worst}: kernel {exact_errs[worst][0]:.3g}, "
        f"plain {exact_errs[worst][1]:.3g} of max |exact|")
    return {**row, "launches": launches["grouped_mlp"],
            "float64_err": {k: v[0] for k, v in exact_errs.items()},
            "plain_float64_err": {k: v[1] for k, v in exact_errs.items()}}


def phase_bench(model2d, model3d, card: str) -> None:
    """The bench's canary, then its time_pipeline at the headline budget on
    the models of phase 6 (default route), 3 requests after a warm-up."""
    rows = bench.canary("cuda")
    worst = max(rows, key=lambda r: r["max_abs_err"])
    res = bench.time_pipeline((model2d, model3d), PAIRS, "headline", (), iters=3)
    log(f"[12/{PHASES}] bench canary: {len(rows)} kernel rows match their plain versions "
        f"(largest max |diff| {worst['max_abs_err']:.3g}, row {worst['row']}); time_pipeline "
        f"headline on {card}: {res['pairs_per_sec']:.3f} pairs/s, ms per request median "
        f"{res['ms_median']:.3f} (min {res['ms_min']:.3f}, max {res['ms_max']:.3f}) over "
        f"{res['iters']}")


def grads_agree(got: dict, want: dict, what: str) -> float:
    """Gradients of the kernel and plain steps: each tensor finite and
    within STEP_GRAD_TOL * max |plain| of the plain step's. -> the largest
    max |diff| / max |plain| over the tensors."""
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        d, scale = float((g - w).abs().max()), float(w.abs().max())
        if not (torch.isfinite(g).all() and d <= STEP_GRAD_TOL * scale):
            raise AssertionError(f"{what}: gradient of {k} off the plain step's by max |diff| "
                                 f"{d:.3g}, max |plain| {scale:.3g}")
        worst = max(worst, d / max(scale, 1e-30))
    return worst


def exact_step_misses(got: dict, exact: dict, orders: dict) -> tuple:
    """The iDispNet step's gradient check (STEP_GRAD_TOL says why): `got`
    held to the `exact` step's gradients, beside the float32 `orders`'
    (the plain step's first). -> (what it misses, empty when it passes;
    |got - exact| / |exact| and |plain - exact| / |exact| over the whole
    gradient; the largest per-tensor distance over its bound, and its
    tensor)."""
    def dist(a, b):
        return float((a - b).double().norm())

    misses = [f"gradient of {k} is not finite" for k, g in got.items()
              if not torch.isfinite(g).all()]
    scale = math.hypot(*(float(e.double().norm()) for e in exact.values()))
    whole = [math.hypot(*(dist(g[k], e) for k, e in exact.items()))
             for g in (got, next(iter(orders.values())))]
    if not whole[0] <= whole[1] + STEP_GRAD_TOL * scale:
        misses.append(f"whole gradient off the exact step's by {whole[0] / scale:.3g} of its "
                      f"norm, the plain step's by {whole[1] / scale:.3g}")
    worst, at = 0.0, None
    for k, e in exact.items():
        d = dist(got[k], e)
        bound = (STEP_ORDER_FACTOR * max(dist(g[k], e) for g in orders.values())
                 + STEP_GRAD_TOL * float(e.double().norm()))
        ratio = d / bound if bound > 0 else (0.0 if d == 0 else math.inf)
        if ratio > worst:
            worst, at = ratio, k
    if worst > 1:
        misses.append(f"gradient of {at} off the exact step's by {worst:.3g} of its bound")
    return misses, whole[0] / scale, whole[1] / scale, worst, at


def phase_conv_train_compare() -> float:
    """Row 8 at the iDispNet step's trunk sites: the raw conv, dx through
    the kernel (flipped, channel-transposed weights) and dk, against
    F.conv3d and its autograd."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    worst = 0.0
    for n, c, d, s in TRAIN_CONV_SITES:
        x = (torch.randn(n, c, d, s, s, generator=gen, device="cuda")).requires_grad_(True)
        w = (torch.randn(c, c, 3, 3, 3, generator=gen, device="cuda") * 0.05).requires_grad_(True)
        dy = torch.randn(n, c, d, s, s, generator=gen, device="cuda")
        y = cconv.conv3d_train(x, w)
        got = (y.detach(),) + torch.autograd.grad(y, (x, w), dy)
        y = cconv.conv3d_train_plain(x, w)
        want = (y.detach(),) + torch.autograd.grad(y, (x, w), dy)
        errs = [conv_err(g, p, f"conv3d_train {what} at {tuple(x.shape)}")
                for what, g, p in zip(("y", "dx", "dk"), got, want)]
        worst = max(worst, *errs)
        log(f"  conv3d_train {tuple(x.shape)}: y, dx, dk max |diff| "
            f"{', '.join(f'{e:.3g}' for e in errs)}")
        del x, dy, y, got, want
    torch.cuda.synchronize()
    log(f"[13/{PHASES}] row 8's train form matches F.conv3d and its autograd at the iDispNet "
        f"step's trunk sites")
    return worst


def phase_sa_train_compare() -> float:
    """Row 11 at the RCNN step's SA0 and SA1: the kernel forward and every
    input and weight gradient against autograd of the plain version, on
    clouds with empty, partial and full balls."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = 0.0
    for site, b, n, m, c0, chain, radius, s in TRAIN_SA_SITES:
        xyz = point_clouds(gen, b, n, 1.2 * radius * n ** (1 / 3) / 4, s)
        centers = torch.cat([xyz[:, :m - 1], torch.full((b, 1, 3), 60.0, device="cuda")],
                            1).contiguous()
        cnt = ball_counts(centers, xyz, radius, s)
        if not ((cnt == 0).any() and ((cnt > 0) & (cnt < s)).any() and (cnt == s).any()):
            raise AssertionError(f"SA train {site}: the clouds lack empty, partial or full balls")

        def randn(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device="cuda") * scale).requires_grad_(True)

        leaves = [randn(b, n, c0), randn(3, c0, scale=0.5 / radius), 1 + randn(c0, scale=0.3),
                  randn(c0, scale=0.1)]
        leaves[2] = leaves[2].detach().requires_grad_(True)
        ws, cin = [], c0
        for co in chain:
            ws.append((randn(cin, co, scale=cin ** -0.5), randn(co, scale=0.1)))
            cin = co
        flat = [t for pair in ws for t in pair]
        dy = torch.randn(b, m, chain[-1], generator=gen, device="cuda")
        outs = []
        for fn in (csa.sa_ball_mlp_max_train, csa.sa_ball_mlp_max_plain):
            out = fn(xyz, centers, *leaves, ws, radius, s)
            outs.append((out.detach(),) + torch.autograd.grad(out, leaves + flat, dy))
        names = ["value", "v", "w0x", "mul0", "add0"] + [f"{k}{i}" for i in range(len(ws))
                                                         for k in ("W", "b")]
        errs = [conv_err(g, w, f"SA train {site} {k}") for k, g, w in zip(names, *outs)]
        worst = max(worst, *errs)
        log(f"  sa_train {site} ({b}, {n} -> {m}, S {s}): value max |diff| {errs[0]:.3g}, "
            f"gradients {max(errs[1:]):.3g} ({len(errs) - 1} tensors); balls empty "
            f"{int((cnt == 0).sum())}, partial {int(((cnt > 0) & (cnt < s)).sum())}, full "
            f"{int((cnt == s).sum())}")
        del outs, leaves, ws, flat
    torch.cuda.synchronize()
    log(f"[14/{PHASES}] row 11's train form matches autograd of its plain version at the RCNN "
        f"step's SA sites")
    return worst


def trainable(model):
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def check_grads_and_stats(model, before: dict, what: str, bn_trains: bool) -> int:
    """Every trainable parameter has a finite gradient (a ctypes output
    without grad_fn would leave it None); the BN running statistics moved
    (bn_trains) or stayed (frozen stages), and so did the parameters that
    do not train. -> the moved statistics."""
    for n, p in trainable(model).items():
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise AssertionError(f"{what}: {n} has no finite gradient")
    running = [n for n, b in model.named_buffers() if "running" in n]
    bufs = dict(model.named_buffers())
    moved = sum(not torch.equal(bufs[n], before[n]) for n in running)
    if (moved == 0) if bn_trains else moved:
        raise AssertionError(f"{what}: {moved} of {len(running)} BN statistics moved")
    for n, p in model.named_parameters():
        if not p.requires_grad and not torch.equal(p, before[n]):
            raise AssertionError(f"{what}: the frozen {n} changed")
    return moved


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms (a warning where an op has none):
    the compared steps' backward sums (the scatter-adds of gathers and
    index ops) in a fixed order, so that two runs of one step agree and a
    difference between two steps is their kernels'."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def kernel_vs_plain_step(model, opt, step, batch, what: str, share=None, others=None,
                         share_inputs=None):
    """One step on the kernels and one on the plain versions (all_plain),
    both from the same weights and optimizer state, and one more such step
    for each entry of `others` (name -> launch overrides on top of
    all_plain). `share` (a module whose rcnn_targets the plain step takes
    from the kernel step) makes them train on one frozen-stage output;
    `share_inputs` (a module that the plain step calls on the kernel
    step's inputs) on one frozen-stage input to the module. -> (loss
    relative difference, kernel-step gradients, plain-step gradients, the
    other steps' gradients by name, kernel-step metrics, what was shared)."""
    sd, osd, count = copy.deepcopy(model.state_dict()), copy.deepcopy(opt.sgd.state_dict()), \
        opt.count
    recorded = []
    if share is not None:
        orig = share.rcnn_targets
        share.rcnn_targets = lambda *a: recorded.append(orig(*a)) or recorded[-1]
    if share_inputs is not None:
        forward = share_inputs.forward
        share_inputs.forward = lambda *a: recorded.append(a) or forward(*a)

    def plain_step(**overrides):
        model.load_state_dict(sd)
        opt.sgd.load_state_dict(osd)
        opt.count = count
        reset_launches()
        with all_plain(**overrides):
            m = step(batch)
        if any(read_launches().values()):
            raise AssertionError(f"{what}: the plain step launched {read_launches()}")
        return m, {n: p.grad.clone() for n, p in trainable(model).items()}

    try:
        with deterministic():
            mk = step(batch)
            gk = {n: p.grad.clone() for n, p in trainable(model).items()}
            if share is not None:
                share.rcnn_targets = lambda *a: recorded[0]
            if share_inputs is not None:
                share_inputs.forward = lambda *a: forward(*recorded[0])
            mp, gp = plain_step()
            go = {name: plain_step(**overrides)[1] for name, overrides in (others or {}).items()}
    finally:
        if share is not None:
            del share.rcnn_targets
        if share_inputs is not None:
            del share_inputs.forward
    torch.cuda.synchronize()
    lk, lp = float(mk["loss_total"]), float(mp["loss_total"])
    rel = abs(lk - lp) / max(abs(lp), 1e-30)
    if not rel <= STEP_LOSS_RTOL:
        raise AssertionError(f"{what}: kernel step loss {lk} against plain {lp}")
    return rel, gk, gp, go, mk, recorded


def phase_psm_train(card: str) -> dict:
    st = bench_train.psm_stage(PSM_PAIRS, torch.Generator(device="cuda").manual_seed(12))
    model, opt, step, batch = st.model, st.optimizer, st.step, st.batch
    before = {n: t.detach().clone() for n, t in [*model.named_buffers(),
                                                 *model.named_parameters()]}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ms = bench_train.time_steps(st, TRAIN_STEPS)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    moved = check_grads_and_stats(model, before, "iDispNet step", bn_trains=True)
    crops = st.units
    if launches["conv3d_train"] != (1 + TRAIN_STEPS) * 24 or any(
            launches[k] for k in launches if k != "conv3d_train"):
        raise AssertionError(f"iDispNet step launches {launches}: expected 24 conv3d_train a "
                             f"step (12 trunk convs, forward and dx) and nothing else")
    rel, gk, gp, go, mk, _ = kernel_vs_plain_step(
        model, opt, step, batch, "iDispNet step",
        others={"exact": ROW8_EXACT, **STEP_ORDERS, "one TF32 product": ROW8_ONE_TF32})
    ge, g_tf32 = go.pop("exact"), go.pop("one TF32 product")
    orders = {"plain": gp, **go}
    misses, grad_err, plain_err, worst, at = exact_step_misses(gk, ge, orders)
    if misses:
        raise AssertionError(f"iDispNet step: {'; '.join(misses)}")
    smallest = min((k for k in ge if ge[k].abs().max() > 0), key=lambda k: float(ge[k].norm()))
    controls = []
    for name, g in (("row 8 as one TF32 product", g_tf32),
                    (f"{smallest} negated", {**gk, smallest: -gk[smallest]})):
        c_misses, c_err, _, c_worst, _ = exact_step_misses(g, ge, orders)
        if not c_misses:
            raise AssertionError(f"iDispNet step: the gradient check passes the control {name} "
                                 f"({c_err:.3g} of the norm, {c_worst:.3g} of a tensor's bound)")
        controls.append(f"{name}: {c_err:.3g} of the norm, {c_worst:.3g} of a tensor's bound")
    # the per-tensor form against the plain step (max |g - g_plain| / max
    # |g_plain|, the largest over the tensors) of every other row 8
    spread = {name: max(float((g[k] - gp[k]).abs().max()) / max(float(gp[k].abs().max()), 1e-30)
                        for k in gp)
              for name, g in (("kernel", gk), *go.items(), ("exact", ge))}
    mean = sum(ms) / len(ms)
    log(f"[15/{PHASES}] iDispNet train step ({PSM_PAIRS} pairs, {crops} crops of "
        f"{PSM_TRAIN['roi_size']}^2) on "
        f"{card}: ms/step {[round(t, 3) for t in ms]} (mean {mean:.3f}: "
        f"{crops * 1e3 / mean:.3f} crops/s, {PSM_PAIRS * 1e3 / mean:.3f} pairs/s), loss_psm "
        f"{float(mk['loss_psm']):.5g}, launches {launches['conv3d_train']}, "
        f"{len(trainable(model))} parameters with finite gradients, {moved} BN statistics "
        f"moved, peak memory {peak:.2f} GB; kernel vs plain step: loss {rel:.3g} relative; "
        f"gradients off the exact-row-8 step's by {grad_err:.3g} of its norm (the plain "
        f"step's by {plain_err:.3g}), per tensor at most {worst:.3g} of the bound ({at}); "
        f"controls rejected: {'; '.join(controls)}; per tensor, max |diff| / max |plain| off "
        f"the plain step at most: {', '.join(f'{n} {v:.3g}' for n, v in spread.items())}")
    return dict(model=model, step=step, batch=batch, ms=ms, launches=launches,
                unit=crops, pairs=PSM_PAIRS)


def phase_pc_train(card: str) -> dict:
    st = bench_train.pc_stage(PC_PAIRS, torch.Generator(device="cuda").manual_seed(13))
    model, opt, step, batch, with_points = st.model, st.optimizer, st.step, st.batch, \
        st.with_points
    d, prc = PC_TRAIN["max_det"], model.pointrcnn
    before = {n: t.detach().clone() for n, t in [*model.named_buffers(),
                                                 *model.named_parameters()]}
    # the kernel and plain steps below start from these seeded weights: the
    # timed steps' backward sums its scatter-adds in no fixed order, so the
    # weights they leave differ in the last bits from run to run, and with
    # them whether a ReLU or a max near a tie flips between the two steps
    start = copy.deepcopy(model.state_dict()), copy.deepcopy(opt.sgd.state_dict()), opt.count
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ms = bench_train.time_steps(st, TRAIN_STEPS)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_grads_and_stats(model, before, "RCNN step", bn_trains=False)
    model.load_state_dict(start[0])
    opt.sgd.load_state_dict(start[1])
    opt.count = start[2]
    needed = ("cost_volume_conv", "conv3d", "conv3d_cl1", "conv3d_s2", "deconv3d", "conv2d",
              "softargmin", "fps", "sa", "fp", "nms_sorted", "roipool3d", "sa_train")
    if any(launches[k] == 0 for k in needed) or launches["conv3d_train"]:
        raise AssertionError(f"RCNN step launches {launches}: rows 1-7, 9, 10, 11, 13, 14 and "
                             f"15 must each launch, row 8 not")
    rel, gk, gp, _, mk, recorded = kernel_vs_plain_step(model, opt, step, batch, "RCNN step",
                                                        share=prc)
    grad_err = grads_agree(gk, gp, "RCNN step")
    tgt = recorded[0]
    fg, labelled = int(tgt["reg_mask"].sum()), int((tgt["cls_label"] >= 0).sum())
    if fg == 0:
        raise AssertionError("RCNN step: no sampled RCNN ROI is foreground")
    mean = sum(ms) / len(ms)
    log(f"[16/{PHASES}] RCNN train step ({PC_PAIRS} pair, {d} instances, "
        f"{tgt['cls_label'].numel()} RCNN ROIs of {prc.rcnn_num_points} points) on {card}: "
        f"ms/step {[round(t, 3) for t in ms]} (mean {mean:.3f}: {PC_PAIRS * 1e3 / mean:.3f} "
        f"pairs/s), loss_box3d {float(mk['loss_box3d']):.5g}, {with_points} instances with "
        f"points in a proposal, {fg} foreground and {labelled} labelled ROIs, launches "
        f"{launches}, {len(trainable(model))} RCNN parameters with finite gradients, peak "
        f"memory {peak:.2f} GB; kernel vs plain step on one frozen-stage output: loss "
        f"{rel:.3g} relative, gradients per tensor max |diff| <= {grad_err:.3g} * max |plain|")
    return dict(model=model, step=step, batch=batch, ms=ms, launches=launches,
                unit=PC_PAIRS, pairs=PC_PAIRS)


def phase_rpn_train(card: str) -> None:
    """The 3D RPN step (stage 3): the timed steps with their launches
    counted from 0, every RPN BN statistic moved and finite, then the
    kernel step against the plain step from the seeded weights on one
    frozen-stage output (the clouds, their frame and the matched GT): FPS
    (row 9) is the one kernel inside that comparison."""
    st = bench_train.rpn_stage(RPN_PAIRS, torch.Generator(device="cuda").manual_seed(14))
    model, opt, step, batch = st.model, st.optimizer, st.step, st.batch
    d, rpn = RPN_TRAIN["max_det"], model.pointrcnn.rpn
    before = {n: t.detach().clone() for n, t in [*model.named_buffers(),
                                                 *model.named_parameters()]}
    start = copy.deepcopy(model.state_dict()), copy.deepcopy(opt.sgd.state_dict()), opt.count
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ms = bench_train.time_steps(st, TRAIN_STEPS)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    moved = check_grads_and_stats(model, before, "RPN step", bn_trains=True)
    stats = {n: b for n, b in rpn.named_buffers() if "running" in n}
    stuck = [n for n, b in stats.items()
             if torch.equal(b, before[f"pointrcnn.rpn.{n}"]) or not torch.isfinite(b).all()]
    if stuck:
        raise AssertionError(f"RPN step: {len(stuck)} of {len(stats)} RPN BN statistics did not "
                             f"move or are not finite, e.g. {stuck[:3]}")
    model.load_state_dict(start[0])
    opt.sgd.load_state_dict(start[1])
    opt.count = start[2]
    needed = ("cost_volume_conv", "conv3d", "conv3d_cl1", "conv3d_s2", "deconv3d", "conv2d",
              "softargmin", "fps")
    absent = ("nms_sorted", "conv3d_train", "sa", "sa_train", "grouped_mlp", "fp", "roipool3d")
    if any(launches[k] == 0 for k in needed) or any(launches[k] for k in absent):
        raise AssertionError(f"RPN step launches {launches}: rows 2-7, 9 and 15 must each "
                             f"launch, rows 1, 8 and 10-14 not")
    rel, gk, gp, _, mk, _ = kernel_vs_plain_step(model, opt, step, batch, "RPN step",
                                                 share_inputs=model.pointrcnn)
    grad_err = grads_agree(gk, gp, "RPN step")
    total, split = split_by_events(
        lambda: step(batch),
        [(model.idispnet, "post", "crops + frozen iDispNet"),
         (model.pointrcnn, "pre", "lift + GT match"), (rpn.backbone, "post", "RPN backbone"),
         (rpn.reg_head, "post", "RPN heads"), (model, "post", "labels + RPN loss")],
        [(opt, "step", "backward", "optimizer")], "metrics")
    mean = sum(ms) / len(ms)
    log(f"[18/{PHASES}] 3D RPN train step ({RPN_PAIRS} pairs, {RPN_PAIRS * d} clouds of "
        f"{RPN_TRAIN['npoints']} points, {st.with_points} with points) on {card}: ms/step "
        f"{[round(t, 3) for t in ms]} (mean {mean:.3f}: {RPN_PAIRS * 1e3 / mean:.3f} pairs/s), "
        f"loss_rpn_cls {float(mk['loss_rpn_cls']):.5g}, loss_rpn_reg "
        f"{float(mk['loss_rpn_reg']):.5g}, {st.positive} positive and {st.ignored} ignored "
        f"points, launches {launches}, {len(trainable(model))} RPN parameters with finite "
        f"gradients, {moved} BN statistics moved ({len(stats)} of the RPN's), peak memory "
        f"{peak:.2f} GB; kernel (row 9) vs plain step on one frozen-stage output: loss "
        f"{rel:.3g} relative, gradients per tensor max |diff| <= {grad_err:.3g} * max "
        f"|plain|; one step split, {total:.3f} ms: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()))


def phase_2d_train(card: str) -> dict:
    """The 2D train step (stage 1, mask.yaml): the timed steps with their
    launches counted from 0, what trains and what stays, the kernel step
    against the plain step, row 1 at its train site, the step's stages,
    and the bench's timing of the stage. -> row 1's numbers at the site."""
    pairs = bench_train.DET2D_PAIRS
    st = bench_train.build_stage("2d", pairs, torch.Generator(device="cuda").manual_seed(19))
    model, opt, step, batch = st.model, st.optimizer, st.step, st.batch
    before = {n: t.detach().clone() for n, t in [*model.named_buffers(),
                                                 *model.named_parameters()]}
    start = copy.deepcopy(model.state_dict()), copy.deepcopy(opt.sgd.state_dict()), opt.count
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ms = bench_train.time_steps(st, TRAIN_STEPS)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    roi_pos = st.record["roi_pos"]
    positive = int(roi_pos.sum())
    positive_proposals = int(roi_pos[:, :model.post_nms_top_n_train].sum())
    check_grads_and_stats(model, before, "2D step", bn_trains=False)
    bufs = dict(model.named_buffers())
    changed = [n for n in bufs if not torch.equal(bufs[n], before[n])]
    moved = sorted(n for n, p in model.named_parameters() if not torch.equal(p, before[n]))
    mask_head = sorted(n for n, _ in model.named_parameters() if n.startswith("mask_head."))
    if changed or moved != mask_head or sorted(trainable(model)) != mask_head:
        raise AssertionError(f"2D step: buffers changed {changed[:3]}; parameters moved "
                             f"{moved[:3]}... ({len(moved)}), the mask head has "
                             f"{len(mask_head)}")
    steps = 1 + TRAIN_STEPS
    if launches["nms_sorted"] != steps or any(v for k, v in launches.items()
                                               if k != "nms_sorted"):
        raise AssertionError(f"2D step launches {launches}: expected row 1 once a step "
                             f"({steps}) and no other kernel")
    model.load_state_dict(start[0])
    opt.sgd.load_state_dict(start[1])
    opt.count = start[2]
    metrics = []
    gen, gen_state = batch["generator"], batch["generator"].get_state()

    def same_draws_step(b):  # both steps draw the same priorities and masks
        gen.set_state(gen_state)
        metrics.append(step(b))
        return metrics[-1]

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rel, gk, gp, _, mk, _ = kernel_vs_plain_step(model, opt, same_draws_step, batch,
                                                     "2D step")
    mp = metrics[1]
    losses = [k for k in mk if k.startswith("loss")]
    bad = [k for k in losses if not math.isfinite(float(mk[k]))]
    if bad or not float(mk["loss_mask"]) > 0:
        raise AssertionError(f"2D step losses { {k: float(mk[k]) for k in losses} }")
    if all(torch.equal(mk[k], mp[k]) for k in losses) and all(
            torch.equal(gk[n], gp[n]) for n in gk):
        compared = "the five losses and every mask-head gradient bit-equal"
    else:
        ops = sorted({str(w.message).split(" does not have")[0] for w in caught
                      if "deterministic" in str(w.message)})
        for k in losses:
            if abs(float(mk[k]) - float(mp[k])) > STEP_LOSS_RTOL * abs(float(mp[k])):
                raise AssertionError(f"2D step: kernel {k} {float(mk[k])} against plain "
                                     f"{float(mp[k])}")
        compared = (f"not bit-equal (ops without a deterministic CUDA form: {ops or 'none'}); "
                    f"losses within {STEP_LOSS_RTOL:g} relative, gradients per tensor max "
                    f"|diff| <= {grads_agree(gk, gp, '2D step'):.3g} * max |plain|")
    calls = capture_launches(lambda: step(batch), dict(nms_sorted_cuda="nms_sorted"))
    site = calls["nms_sorted"]
    if len(site) != 1:
        raise AssertionError(f"2D step: {len(site)} NMS launches in one step")
    row = time_launches("nms_sorted", [(" SRPN train", site, cuda_nms.nms_sorted_cuda,
                                        cuda_nms.nms_sorted_plain, None, nms_work,
                                        lambda g, w: main_path_err("nms_sorted", g, w))],
                        0.0, "nms.cu", "disprcnn_tpu/ops/pallas/nms.py:98")
    a = site[0]
    n, k = a[0].shape[1], a[2]
    chain, (lo, hi) = nms_chain_ms(a)
    out = cuda_nms.nms_sorted_cuda(*a)
    stop, kept = nms_walk_stop(a, out), out[1].sum(1).tolist()
    routes = cuda_nms.walk_routes(n, k)
    total, split = split_by_events(
        lambda: step(batch),
        [(model.backbone, "post", "backbone"), (model.rpn_head, "post", "RPN head"),
         (model.box_extractor, "pre", "proposals + SRPN loss + ROI sampling"),
         (model.box_predictor, "post", "box head"), (model.mask_head, "post", "mask head"),
         (model, "post", "losses")],
        [(opt, "step", "backward", "optimizer")], "metrics")
    mean = sum(ms) / len(ms)
    med = sorted(ms)[len(ms) // 2]
    log(f"  2D step row 1 at ({a[0].shape[0]}, {n}) k={k}: walk {' then '.join(routes)}, "
        f"{kept} kept, the walk stopped after sorted box {stop} of {n}; one image {chain:.4f} "
        f"ms (5 runs {lo:.4f}-{hi:.4f})")
    log(f"[19/{PHASES}] 2D train step ({pairs} pairs of {IMG_HW[0]}x{IMG_HW[1]}, "
        f"{bench_train.DET2D_TRAIN['body']}-FPN, mask.yaml freezing) on {card}: ms/step "
        f"{[round(t, 3) for t in ms]} (mean {mean:.3f}, median {med:.3f}: "
        f"{pairs * 1e3 / med:.3f} pairs/s), losses "
        f"{ {k: round(float(mk[k]), 5) for k in losses} }, {positive} positive ROIs in the "
        f"last timed step ({positive_proposals} of them proposals, the rest appended GT), "
        f"launches {launches}, {len(mask_head)} mask-head parameters with finite gradients "
        f"and all of them changed, frozen weights and FrozenBN constants bit-equal, peak "
        f"memory {peak:.2f} GB; kernel vs plain step: {compared}; row 1 at its site {row['ms']:.4f} ms "
        f"(device {row['device_ms']:.4f}), plain {row['plain_ms']:.4f}, bound "
        f"{row['bound_ms']:.4f} ms; one step split, {total:.3f} ms: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()))
    del st, model, opt, step, batch, calls, site, a, out, gen, roi_pos
    torch.cuda.empty_cache()
    timed = bench.time_train_stage("2d", "cuda", iters=TRAIN_STEPS)
    log(f"  bench.time_train_stage('2d') on {card}: {json.dumps(timed)}")
    return dict(launches=launches["nms_sorted"] // steps, ms=row["ms"],
                device_ms=row["device_ms"], plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], walk=list(routes), ms_per_step=med,
                peak_gb=peak)


def phase_train_timing(psm: dict, pc: dict, errs: dict, card: str) -> dict:
    """Rows 8 and 11 on the inputs one train step gave them (time_launches),
    and the step times of phases 15 and 16 with one step of each split into
    stages (split_by_events)."""
    calls = capture_launches(lambda: psm["step"](psm["batch"]),
                             dict(conv3d_train_cuda="forward", conv3d_train_dx_cuda="dx"))
    compare = lambda what: lambda got, want: conv_err(got, want, f"{what} in the step")
    rows = {"conv3d_train": time_launches("conv3d_train", [
        (" forward", calls["forward"], cconv.conv3d_train_cuda, cconv.conv3d_train_plain,
         lambda a: F.conv3d(a[0], a[1], padding=1), conv_work, compare("conv3d_train forward")),
        (" dx", calls["dx"], cconv.conv3d_train_dx_cuda, cconv.conv3d_train_dx_plain,
         lambda a: torch.nn.grad.conv3d_input(a[0].shape, a[1], a[0], padding=1),
         lambda a, o: conv_work((a[0], cconv.flip_transpose(a[1])), o),
         compare("conv3d_train dx"))],
        errs["conv3d_train"], "conv3d_tc.cu", "disprcnn_tpu/ops/pallas/packed_conv.py:689")}
    del calls
    calls = capture_launches(lambda: pc["step"](pc["batch"]),
                             dict(sa_ball_mlp_max_train_cuda="sa_train"))
    rows["sa_train"] = time_launches("sa_train", [
        ("", calls["sa_train"], csa.sa_ball_mlp_max_train_cuda, csa.sa_ball_mlp_max_plain, None,
         sa_work, compare("sa_train"))],
        errs["sa_train"], "sa.cu", "disprcnn_tpu/ops/pallas/sa_fused.py:1073")
    del calls
    psm_model, pc_model = psm["model"], pc["model"]
    for what, r, hooks in (
            ("iDispNet", psm, ((psm_model.idispnet.feature_extraction, "feature tower"),
                               (psm_model.idispnet.dres2, "cost volume + dres + hourglass 1"),
                               (psm_model.idispnet, "hourglasses 2-3 + classifiers"))),
            ("RCNN", pc, ((pc_model.idispnet, "crops + frozen iDispNet"),
                          (pc_model.pointrcnn.rpn, "lift + frozen RPN"),
                          (pc_model.pointrcnn.rcnn.merge_down, "proposals + targets + RCNN "
                                                                "xyz_up/merge_down"),
                          (pc_model.pointrcnn.rcnn, "RCNN SA + heads")))):
        mean = sum(r["ms"]) / len(r["ms"])
        total, stages = split_by_events(
            lambda: r["step"](r["batch"]),
            [(mod, "post", name) for mod, name in hooks]
            + [(r["model"], "post", "rest of the forward")],
            [(r["step"].optimizer, "step", "backward", "optimizer")], "metrics")
        log(f"  {what} train step on {card}: {mean:.3f} ms/step, "
            f"{r['unit'] * 1e3 / mean:.3f} {'crops' if what == 'iDispNet' else 'pairs'}/s, "
            f"{r['pairs'] * 1e3 / mean:.3f} pairs/s; one step split, {total:.3f} ms: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items()))
    log(f"[17/{PHASES}] train forms timed on one step's own inputs")
    return rows


# Phase 20: the eval entry point on two shipped configs (config file,
# dataset, 384x1248 static size) and the kernel rows each must launch
EVAL_RUNS = (("configs/kitti/car/vob/mask.yaml", "synthetic_8", ("nms_sorted",)),
             ("configs/kitti/car/vob/rcnn.yaml", "synthetic3d_8",
              ("nms_sorted", "cost_volume_conv", "conv3d", "conv3d_cl1", "deconv3d",
               "conv3d_s2", "conv2d", "fps", "sa", "fp", "roipool3d", "softargmin")))
EVAL_IMAGES = 8  # synthetic_8, synthetic3d_8
EVAL_GT_SCENES = 48  # >= 41 GT instances at every difficulty for AP 100


def pred_shapes(cfg) -> dict:
    """An image's prediction shapes: TPU.MAX_DETECTIONS slots of the 2D
    detector, or the dataset's TPU.MAX_GT offline slots of the 3D model."""
    d = cfg.TPU.MAX_DETECTIONS if cfg.MODEL.META_ARCHITECTURE == "DispRCNN" else cfg.TPU.MAX_GT
    shapes = {"left_boxes": (d, 4), "right_boxes": (d, 4), "scores": (d,), "valid": (d,),
              "labels": (d,), "masks": (d, 28, 28)}
    if cfg.MODEL.DET3D_ON and cfg.MODEL.POINTRCNN.RCNN.ENABLED:
        shapes.update(box3d=(d, 7), score3d=(d,), random3d=(d,))
    return shapes


def write_kitti_gt(gt_dir: str, n: int, det_dir: str = None) -> int:
    """The synthetic scenes' GT as KITTI label files (and, in det_dir, the
    same lines scored as detections). -> GT instances."""
    ds = resolve(f"synthetic_{n}", get_default_cfg(), training=False)
    count = 0
    for d in filter(None, (gt_dir, det_dir)):
        os.makedirs(d, exist_ok=True)
    for i in range(n):
        s = ds[i]
        lines = [f"Car 0.00 0 -10 {' '.join(f'{v:.2f}' for v in b)} {h:.2f} {w:.2f} {l:.2f} "
                 f"{x:.2f} {y:.2f} {z:.2f} {ry:.2f}"
                 for b, (x, y, z, h, w, l, ry), ok in zip(s["gt_left"], s["gt_box3d"],
                                                           s["gt_valid"]) if ok]
        count += len(lines)
        for d, tail in ((gt_dir, ""), (det_dir, " 0.9")):
            if d:
                with open(os.path.join(d, f"{s['imgid']}.txt"), "w") as f:
                    f.write("".join(line + tail + "\n" for line in lines))
    return count


def check_predictions(preds: dict, shapes: dict, n_images: int) -> int:
    """Every image's prediction dict: the JAX package's keys and dtypes,
    the configs' shapes, finite values. -> valid slots."""
    if len(preds) != n_images:
        raise AssertionError(f"{len(preds)} images predicted, expected {n_images}")
    valid = 0
    for imgid, p in preds.items():
        if sorted(p) != sorted(shapes):
            raise AssertionError(f"{imgid}: keys {sorted(p)}")
        for k, v in p.items():
            if v.dtype != test_net.PRED_DTYPES[k] or v.shape != shapes[k]:
                raise AssertionError(f"{imgid} {k}: {v.dtype} {v.shape}")
            if v.dtype.kind == "f" and not np.isfinite(v).all():
                raise AssertionError(f"{imgid} {k}: not finite")
        valid += int(p["valid"].sum())
    return valid


def first_batch_plain(res: dict, cfg, name: str, model) -> str:
    """The first batch of a run again, every kernel routed to its plain
    version: the 2D predictions equal to the run's; the 3D stage on the
    kernel path's disparity (a forward hook swaps it in) held as phase 7
    holds it, against a kernel run of the batch on the same priorities."""
    batch = next(iter(test_net.make_loader(cfg, name, IMG_HW)))
    dev = model.device
    if cfg.MODEL.META_ARCHITECTURE == "DispRCNN":
        with all_plain():
            plain = test_net.Predictor(cfg, model, dev)(batch)
        for i, imgid in enumerate(batch["imgid"]):
            for k, v in res["predictions"][imgid].items():
                if not np.array_equal(plain[k][i], v):
                    raise AssertionError(f"{name} {imgid}: plain-path {k} differs")
        return f"2D predictions of {len(batch['imgid'])} pairs equal"
    convert, _ = make_batch_converter(cfg, dev)
    kw = convert(batch)
    b, d = batch["pred_valid"].shape
    kw["priorities"] = torch.rand((b * d, model.lift_grid ** 2),
                                  generator=torch.Generator(device=dev).manual_seed(20),
                                  device=dev)
    seen = {}
    with torch.inference_mode():
        hook = model.idispnet.register_forward_hook(
            lambda _m, _i, disp: seen.setdefault("disp", disp))
        try:
            ref = model(**kw)
        finally:
            hook.remove()
        hook = model.idispnet.register_forward_hook(lambda _m, _i, disp: seen["disp"])
        try:
            with all_plain():
                out = model(**kw)
        finally:
            hook.remove()
    e, bad, n = check_boxes_3d(out, ref, f"{name} first batch")
    return f"on the same clouds roi_ok and random equal, box3d within {e:.3g} ({bad}/{n} off)"


def phase_eval_entry(card: str) -> None:
    """tools/test_net.run on mask.yaml and rcnn.yaml (see the docstring)."""
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        gt_dir, det_dir = os.path.join(tmp, "gt"), os.path.join(tmp, "gt_as_dets")
        n_gt = write_kitti_gt(gt_dir, EVAL_GT_SCENES, det_dir)
        ap = evaluate_kitti(gt_dir, det_dir, os.path.join(tmp, "gt_eval"))
        for thr, res in ap.items():
            for kind in ("image", "ground", "3d"):
                if any(abs(v - 100.0) > 1e-9 for v in res[kind]):
                    raise AssertionError(f"GT as detections: AP@{thr} {kind} {res[kind]}")
        for path, name, rows in EVAL_RUNS:
            reset_launches()
            run = test_net.run(path, ["OUTPUT_DIR", os.path.join(tmp, "out")], dataset=name,
                               static_hw=IMG_HW, evaluate=True, gt_dir=gt_dir, device="cuda",
                               seed=20)
            torch.cuda.synchronize()
            launches = read_launches()
            cfg, model = run["cfg"], run["model"]
            res = run["datasets"][name]
            missing = [r for r in rows if not launches[r]]
            stray = [k for k, v in launches.items() if v and k not in rows]
            if missing or stray:
                raise AssertionError(f"{path}: rows not launched {missing}, launched off the "
                                     f"path {stray}: {launches}")
            shapes = pred_shapes(cfg)
            valid = check_predictions(res["predictions"], shapes, EVAL_IMAGES)
            with open(os.path.join(res["out_dir"], "predictions.pkl"), "rb") as f:
                check_predictions(pickle.load(f), shapes, EVAL_IMAGES)
            if len(os.listdir(res["txt_dir"])) != EVAL_IMAGES:
                raise AssertionError(f"{path}: {len(os.listdir(res['txt_dir']))} txt files")
            plain = first_batch_plain(res, cfg, name, model)
            st = res["stats"]
            ap_txt = {thr: {k: [round(v, 2) for v in a[k]] for k in ("image", "ground", "3d")}
                      for thr, a in res["ap"].items()}
            lines.append(
                f"  {path} on {name}: {res['images']} images in {st['loop_s']:.3f} s "
                f"({res['images'] / st['loop_s']:.3f} images/s; {st['batches']} batches): data "
                f"{st['data_s']:.3f} s, to card {st['to_device_s']:.3f} s, model "
                f"{st['model_s']:.3f} s, back + dicts {st['to_host_s']:.3f} s, txt + AP "
                f"{st['txt_s'] + st['ap_s']:.3f} s; valid slots {valid}; launches "
                f"{ {k: v for k, v in launches.items() if v} }; plain versions: {plain}; AP "
                f"(easy, moderate, hard) {ap_txt}")
            del run, model
            torch.cuda.empty_cache()
    log(f"[20/{PHASES}] eval entry point (tools/test_net) on {card}: the evaluator gives AP "
        f"100 on {n_gt} GT instances of {EVAL_GT_SCENES} scenes as their own detections")
    for line in lines:
        log(line)

# Phase 21: the train entry points. tools/train_net.py on the recipe's four
# stages (each (config, dataset, opts, the rows it must launch and no
# other)), rpn.yaml seeded from idispnet.yaml's checkpoint and rcnn.yaml
# from rpn.yaml's, then tools/test_net.py on rcnn.yaml's checkpoint and
# tools/train_idispnet.py
TRAIN_ENTRY_ITERS = 2
TRAIN_ENTRY_RUNS = (
    ("mask", "synthetic_8", [], ("nms_sorted",)),
    ("idispnet", "synthetic3d_4", [], ("conv3d_train",)),
    ("rpn", "synthetic3d_4", [], ("cost_volume_conv", "conv3d", "conv3d_cl1", "conv3d_s2",
                                  "deconv3d", "conv2d", "softargmin", "fps")),
    ("rcnn", "synthetic3d_4", [], ("cost_volume_conv", "conv3d", "conv3d_cl1", "conv3d_s2",
                                   "deconv3d", "conv2d", "softargmin", "fps", "sa", "fp",
                                   "nms_sorted", "roipool3d", "sa_train")))
# the stage whose checkpoint each stage starts from (MODEL.WEIGHT)
TRAIN_ENTRY_SEED_FROM = {"rpn": "idispnet", "rcnn": "rpn"}
# train_idispnet: 48 synthetic crops (4 steps of 12) and 12 validation crops
# (one full batch: with fewer, no EPE and no best model to save)
IDISPNET_CLI = ["--synthetic", "48", "--epochs", "1", "--bs", "12", "--roi-size", "224",
                "--maxdisp", "48", "--mindisp", "-48"]
PSM_ROWS = ("conv3d_train", "cost_volume_conv", "conv3d", "conv3d_cl1", "conv3d_s2",
            "deconv3d", "conv2d", "softargmin")


def check_rows(launches: dict, rows, what: str) -> dict:
    """Each of `rows` launched and no other kernel. -> the launched counts."""
    missing = [r for r in rows if not launches[r]]
    stray = [k for k, v in launches.items() if v and k not in rows]
    if missing or stray:
        raise AssertionError(f"{what}: rows not launched {missing}, launched off the path "
                             f"{stray}: {launches}")
    return {k: v for k, v in launches.items() if v}


def reloads_bit_equal(model, ckpt_dir: str, fresh) -> str:
    """The newest checkpoint of ckpt_dir, loaded into a freshly built model
    (`fresh`), equals `model` entry for entry, bit for bit."""
    unmatched = load_stage_weights(fresh, ckpt_dir)
    want, got = model.state_dict(), fresh.state_dict()
    bad = [k for k in want if not torch.equal(want[k], got[k])]
    if unmatched or bad:
        raise AssertionError(f"{ckpt_dir}: reload left {unmatched[:3]} unmatched, {bad[:3]} "
                             "differ")
    return f"{Checkpointer(ckpt_dir).path(Checkpointer(ckpt_dir).latest_step())}"


def phase_train_entry(card: str) -> dict:
    """tools/train_net.py on mask, idispnet, rpn and rcnn.yaml with the
    stage handoff, tools/test_net.py on the last checkpoint and
    tools/train_idispnet.py (see the docstring). -> the launches of each
    run by row."""
    lines, counted, runs = [], {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        # mask.yaml's MODEL.WEIGHT: the pretrained 2D detector as the
        # reference releases it (a maskrcnn-benchmark .pth), here the model
        # train_net draws from --seed 21
        cfg = train_net.load_config("configs/kitti/car/vob/mask.yaml")
        src = init_random_(build_detection_model(cfg, device="cuda"),
                           torch.Generator(device="cuda").manual_seed(21))
        mask_src = {k: v.cpu() for k, v in src.state_dict().items()}
        mask_pth = ckpt_writer.write_pth(os.path.join(tmp, "srcnn_2d_mrcnn_format.pth"),
                                         ckpt_writer.reference_2d(mask_src))
        del src
        for stage, dataset, opts, rows in TRAIN_ENTRY_RUNS:
            out = os.path.join(tmp, stage)
            if stage in TRAIN_ENTRY_SEED_FROM:
                opts = opts + ["MODEL.WEIGHT", runs[TRAIN_ENTRY_SEED_FROM[stage]]["ckpt_dir"]]
            if stage == "mask":
                opts = opts + ["MODEL.WEIGHT", mask_pth]
            reset_launches()
            res = train_net.run(["--config-file", f"configs/kitti/car/vob/{stage}.yaml",
                                 "--max-iter", str(TRAIN_ENTRY_ITERS), "--dataset", dataset,
                                 "--static-hw", ",".join(map(str, IMG_HW)), "--device", "cuda",
                                 "--seed", "21", *opts, "SOLVER.PRINT_INTERVAL", "1",
                                 "OUTPUT_DIR", out])
            torch.cuda.synchronize()
            counted[stage] = check_rows(read_launches(), rows, f"train_net {stage}.yaml")
            model = res["model"]
            if [it for it, _ in res["metrics"]] != list(range(TRAIN_ENTRY_ITERS)):
                raise AssertionError(f"{stage}.yaml: iterations {res['metrics']}")
            for it, m in res["metrics"]:
                if not all(math.isfinite(v) for k, v in m.items() if k.startswith("loss")) \
                        or m["skipped_nonfinite"] or m["params_without_grad"]:
                    raise AssertionError(f"{stage}.yaml iteration {it}: {m}")
            handoff = ""
            if stage == "mask":
                sd = model.state_dict()
                frozen = [k for k in sd if k.startswith(("backbone.", "rpn_head.", "box_"))]
                bad = [k for k in frozen if not torch.equal(sd[k].cpu(), mask_src[k])]
                if res["unmatched"] != [] or bad or not frozen:
                    raise AssertionError(f"mask.yaml from {mask_pth}: unmatched "
                                         f"{res['unmatched'][:3]}, frozen {bad[:3]} differ")
                handoff = (f"; MODEL.WEIGHT a 2D mrcnn .pth in the reference's layout: every "
                           f"entry filled, the {len(frozen)} frozen ones bit-equal to it after "
                           "training")
            if stage in TRAIN_ENTRY_SEED_FROM:
                prev = TRAIN_ENTRY_SEED_FROM[stage]
                saved = Checkpointer(runs[prev]["ckpt_dir"]).read()["model"]
                sd = model.state_dict()
                kept = ("idispnet.",) if stage == "rpn" else ("idispnet.", "pointrcnn.rpn.")
                keys = [k for k in sd if k.startswith(kept)]
                bad = [k for k in keys if not torch.equal(sd[k].cpu(), saved[k])]
                new = [k for k in sd if not k.startswith(kept)]
                if bad or sorted(res["unmatched"]) != sorted(new):
                    raise AssertionError(f"{stage}.yaml from {prev}'s checkpoint: {bad[:3]} "
                                         f"differ, unmatched {res['unmatched'][:3]}")
                handoff = (f"; from {prev}'s checkpoint {len(keys)} entries bit-equal after "
                           f"training ({'/'.join(kept)} frozen), {len(new)} at their init")
            fresh = build_detection_model(res["cfg"], device="cuda")
            path = reloads_bit_equal(model, res["ckpt_dir"], fresh)
            del fresh
            st, last = res["stats"], res["metrics"][-1][1]
            lines.append(
                f"  train_net {stage}.yaml on {dataset}: {res['iters']} iterations, "
                f"{st['s_per_iter']:.3f} s/iteration, data layer {100 * st['data_share']:.1f}% "
                f"({st['data_s']:.3f} of {st['loop_s']:.3f} s; to card {st['to_device_s']:.3f}, "
                f"steps {st['step_s']:.3f}), last losses "
                f"{ {k: round(v, 5) for k, v in last.items() if k.startswith('loss')} }, "
                f"launches {counted[stage]}, {path} reloads bit-equal{handoff}")
            runs[stage] = res
            if stage != "rcnn":
                del res, model
            torch.cuda.empty_cache()
        rcnn = runs["rcnn"]
        for stage in ("mask", "idispnet", "rpn"):
            runs[stage] = {"ckpt_dir": runs[stage]["ckpt_dir"]}
        torch.cuda.empty_cache()
        # test_net on rcnn.yaml's checkpoint, against the final model in memory
        preds = {}
        for how in ("ckpt", "memory"):
            reset_launches()
            kw = dict(ckpt=rcnn["ckpt_dir"]) if how == "ckpt" else dict(model=rcnn["model"])
            run = test_net.run("configs/kitti/car/vob/rcnn.yaml",
                               ["OUTPUT_DIR", os.path.join(tmp, f"eval_{how}")],
                               dataset="synthetic3d_4", static_hw=IMG_HW, device="cuda",
                               seed=20, **kw)
            torch.cuda.synchronize()
            rows = check_rows(read_launches(), EVAL_RUNS[1][2], f"test_net ({how})")
            preds[how] = run["datasets"]["synthetic3d_4"]["predictions"]
            if how == "ckpt":
                counted["test_net"] = rows
                check_predictions(preds[how], pred_shapes(run["cfg"]), 4)
            del run
        for imgid, p in preds["memory"].items():
            for k, v in p.items():
                if not np.array_equal(preds["ckpt"][imgid][k], v):
                    raise AssertionError(f"test_net --ckpt: {imgid} {k} differs from the "
                                         "model in memory")
        lines.append(f"  test_net --ckpt {rcnn['ckpt_dir']} on synthetic3d_4: predictions "
                     f"bit-equal to the final model's in memory, launches {counted['test_net']}")
        del rcnn, runs
        torch.cuda.empty_cache()
        # train_idispnet: its train steps and its validation, launches counted
        reset_launches()
        t0 = time.perf_counter()
        res = train_idispnet.run(IDISPNET_CLI + ["--output", os.path.join(tmp, "psm"),
                                                 "--device", "cuda", "--seed", "21"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        trainer = res["trainer"]
        counted["train_idispnet"] = check_rows(read_launches(), PSM_ROWS, "train_idispnet")
        for n, p in trainer.model.named_parameters():
            if p.grad is None or not torch.isfinite(p.grad).all():
                raise AssertionError(f"train_idispnet: {n} has no finite gradient")
        (_, loss, epe), = trainer.history
        if not (math.isfinite(loss) and math.isfinite(epe)) or trainer.ckpt.steps() != [0]:
            raise AssertionError(f"train_idispnet: history {trainer.history}, saved "
                                 f"{trainer.ckpt.steps()}")
        saved = trainer.ckpt.read()["model"]
        bad = [k for k, v in trainer.model.state_dict().items()
               if not torch.equal(v.cpu(), saved[k])]
        if bad:
            raise AssertionError(f"train_idispnet: the checkpoint differs at {bad[:3]}")
        tm = trainer.times
        lines.append(
            f"  train_idispnet {' '.join(IDISPNET_CLI)}: {tm['steps']} steps, "
            f"{tm['train_s'] / tm['steps']:.3f} s/step, data layer "
            f"{100 * tm['data_s'] / wall:.1f}% ({tm['data_s']:.3f} of {wall:.3f} s; validation "
            f"{tm['val_s']:.3f} s), loss {loss:.5g}, EPE {epe:.5g}, launches "
            f"{counted['train_idispnet']}, {trainer.ckpt.path(0)} reloads bit-equal")
        del res, trainer
        torch.cuda.empty_cache()
    log(f"[21/{PHASES}] train entry points (tools/train_net, test_net --ckpt, train_idispnet) "
        f"on {card}: finite losses, no skipped step, no parameter without a gradient, the "
        f"stage handoff exact, every checkpoint reloads bit-equal")
    for line in lines:
        log(line)
    return counted


# Phase 22: the distributed paths on the one card. Two ranks share cuda:0 on
# the gloo backend (gloo takes CUDA tensors; NCCL refuses two ranks on one
# card), each a process running this script with --dist-worker and
# torchrun's environment; no time of theirs is a scaling figure.
DIST_DEVICE = "cuda:0"
DIST_TIMEOUT_S = 240  # a rank's whole job, and every collective of the group
# the train stages at the test size (tests/torch_train_helpers.py's, with
# 64^2 ROIs as phase 8's small references), 2 pairs a global batch
DIST_TINY = ["TPU.MAX_DETECTIONS", "4", "TPU.MAX_GT", "4", "TPU.ROI_CROP_SIZE", "64",
             "MODEL.DISPNET.MAX_DISP", "16", "MODEL.DISPNET.MIN_DISP", "-16",
             "MODEL.POINTRCNN.RPN.NPOINTS", "128",
             "MODEL.POINTRCNN.RPN.SA_CONFIG.NPOINTS", "[128, 64, 32, 16]",
             "MODEL.POINTRCNN.TEST.RPN_POST_NMS_TOP_N", "8",
             "MODEL.POINTRCNN.TRAIN.RPN_POST_NMS_TOP_N", "8", "INPUT.DO_RESIZE", "False",
             "SOLVER.IMS_PER_BATCH", "2", "SOLVER.PRINT_INTERVAL", "1"]
DIST_HW = (192, 640)
DIST_ITERS = 3  # the first step, then 2 more
# (stage, extra opts, dtype): float32 on the kernels; the two stages with
# train-mode BN also in float64 on the plain versions, where the two runs'
# arithmetic differs only by its order of sums (float32's flips the odd
# ReLU, C19, and cancels in E[x^2] - E[x]^2 on a random iDispNet's deep
# clouds, C26)
DIST_RUNS = (("idispnet", [], "float32"), ("rpn", [], "float32"),
             ("rcnn", ["MODEL.POINTRCNN.RCNN.ROI_PER_IMAGE", "4"], "float32"),
             ("idispnet", [], "float64"), ("rpn", [], "float64"))
# the first step's losses, two ranks against one process: float32 1e-5
# relative (rpn.yaml 1e-4: C26's cancellation, 1.9e-5 on the CPU), float64
# 1e-9; gradients per tensor within STEP_GRAD_TOL * max |one| (phase 16's
# form) for rcnn.yaml and the float64 runs, the float32 train-BN stages
# over all tensors within DIST_F32_GRAD_L2 relative L2 (a bound that a
# gradient not summed over the ranks, ~1e-1 and more, fails); BN running
# statistics (float64) within 1e-6 relative L2 per tensor
DIST_LOSS_RTOL = {("rpn", "float32"): 1e-4, "float32": 1e-5, "float64": 1e-9}
DIST_F32_GRAD_L2 = 5e-2
DIST_EVAL = ("configs/kitti/car/vob/rcnn.yaml", "synthetic3d_8", [])  # config, dataset, opts
# the recipe: mask.yaml at the scenes' own 192x640 (no resize, so that the
# boxes are in the raw images' pixels), 8 detection slots, then the records
# (crops 2^-14, disparity 1e-5 + 1e-6 relative, masks: at most 1e-3 of
# the entries, the card's and the CPU's matrix products summing the
# bilinear taps in another order) and train_idispnet, 2 steps
RECIPE_OPTS = ["INPUT.DO_RESIZE", "False", "TPU.MAX_DETECTIONS", "8",
               "TEST.DETECTIONS_PER_IMG", "8", "MODEL.WEIGHT", ""]
RECIPE_SCENES = "synthetic_4"
RECIPE_MASK_FLIPS = 1e-3


def first_step_capture(store: dict):
    """The first TrainStep call leaves its gradients (summed over the ranks,
    clipped) and the model's buffers in `store` (on the CPU)."""
    orig = trainer_mod.TrainStep.__call__

    def call(self, batch):
        metrics = orig(self, batch)
        if not store:
            ids = {id(p) for p in self.optimizer.params}
            store["grads"] = {n: p.grad.detach().cpu().clone()
                              for n, p in self.model.named_parameters() if id(p) in ids}
            store["buffers"] = {n: b.detach().cpu().clone()
                                for n, b in self.model.named_buffers()}
        return metrics

    return attr_patched(trainer_mod.TrainStep, "__call__", call)


@contextlib.contextmanager
def attr_patched(obj, name, fn):
    orig = getattr(obj, name)
    setattr(obj, name, fn)
    try:
        yield
    finally:
        setattr(obj, name, orig)


def float64_batches():
    """The batch converter's float tensors in float64."""
    orig = batching.to_device
    return attr_patched(batching, "to_device", lambda x, device: (
        lambda t: t.double() if t.is_floating_point() else t)(orig(x, device)))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def dist_train_run(stage: str, opts, out_dir: str, dtype: str, max_iter: int,
                   device: str = None, dist_backend: str = "gloo") -> dict:
    """tools/train_net.train of a stage at DIST_TINY on cuda:0 from the
    weights drawn from seed 22, float32 on the kernels or float64 on the
    plain versions. -> the first step's metrics, gradients and buffers,
    each iteration's metrics, the final state (CPU), the launches, and the
    run's world, rank, pairs a rank, checkpoint directory and s/iteration."""
    device = device or DIST_DEVICE
    cfg = train_net.load_config(f"configs/kitti/car/vob/{stage}.yaml",
                                DIST_TINY + list(opts) + ["OUTPUT_DIR", out_dir], max_iter)
    model = init_random_(build_detection_model(cfg, device=device),
                         torch.Generator(device=device).manual_seed(22))
    store = {}
    f64 = dtype == "float64"
    reset_launches()
    with first_step_capture(store), (float64_batches() if f64 else contextlib.nullcontext()), \
            (all_plain() if f64 else contextlib.nullcontext()):
        res = train_net.train(cfg, dataset="synthetic3d_4", static_hw=DIST_HW, device=device,
                              seed=22, model=model.to(getattr(torch, dtype)),
                              dist_backend=dist_backend)
    sync(device)
    return {"metrics": res["metrics"], "grads": store["grads"], "buffers": store["buffers"],
            "state": {k: v.cpu() for k, v in res["model"].state_dict().items()},
            "launches": read_launches(), "world": res["world"],
            "rank": res["rank"], "ims": res["ims_per_rank"], "ckpt_dir": res["ckpt_dir"],
            "s_per_iter": res["stats"]["s_per_iter"]}


def dist_test_net(out_dir: str, gt_dir: str, device: str, dataset: str, hw, opts) -> dict:
    """tools/test_net.run of rcnn.yaml with `opts` on `dataset` (seed 20,
    with the AP), on the gloo group where there is one."""
    reset_launches()
    t0 = time.perf_counter()
    run = test_net.run(DIST_EVAL[0], list(opts) + ["OUTPUT_DIR", out_dir], dataset=dataset,
                       static_hw=tuple(hw), evaluate=True, gt_dir=gt_dir, device=device,
                       seed=20, dist_backend="gloo")
    sync(device)
    res = run["datasets"][dataset]
    return {"predictions": res["predictions"], "ap": res.get("ap"), "out_dir": res["out_dir"],
            "has_txt": "txt_dir" in res, "launches": read_launches(),
            "s": time.perf_counter() - t0}


def dist_worker(job_json: str, out_dir: str) -> int:
    """One rank of phase 22 (torchrun's environment): the train runs of
    DIST_RUNS, then the 2-rank eval; writes out_dir/rank<RANK>.pkl."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    job = json.loads(job_json)
    dev = job["device"]
    init_distributed("gloo", dev, timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    out = {"train": [dist_train_run(stage, opts, os.path.join(out_dir, f"{stage}_{dtype}"),
                                    dtype, DIST_ITERS if dtype == "float32" else 1, dev)
                     for stage, opts, dtype in DIST_RUNS],
           "eval": dist_test_net(os.path.join(out_dir, "eval"), job["gt_dir"], dev,
                                 *job["eval"])}
    with open(os.path.join(out_dir, f"rank{os.environ['RANK']}.pkl"), "wb") as f:
        pickle.dump(out, f)
    return 0


def spawn_ranks(job: dict, out_dir: str, world: int = 2):
    """Start `world` ranks of dist_worker on one card. -> the processes."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
               MASTER_ADDR="localhost", MASTER_PORT=str(port))
    here = os.path.abspath(__file__)
    return [subprocess.Popen([sys.executable, here, "--dist-worker", json.dumps(job), out_dir],
                             env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                             cwd=os.path.dirname(here), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
            for r in range(world)]


def join_ranks(procs, out_dir: str, timeout: float) -> list:
    """Wait for every rank (killing all at the first failure or at the
    timeout, which fails the phase). -> each rank's results."""
    deadline = time.perf_counter() + timeout
    outs = [None] * len(procs)
    try:
        for r, p in enumerate(procs):
            outs[r] = p.communicate(timeout=max(deadline - time.perf_counter(), 1))[0].decode()
            if p.returncode:
                raise AssertionError(f"rank {r} exited {p.returncode}:\n{outs[r][-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = []
    for r in range(len(procs)):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def check_dist_train(two: list, one: dict, stage: str, dtype: str) -> str:
    """Phase 22 (a): the ranks' run against the one-process run at the
    global batch. -> a log line."""
    r0, r1 = two
    what = f"{stage}.yaml {dtype}"
    if (r0["world"], r0["rank"], r1["rank"], r0["ims"], one["world"], one["ims"]) != \
            (2, 0, 1, 1, 1, 2):
        raise AssertionError(f"{what}: ranks {r0['world'], r0['rank'], r1['rank'], r0['ims']}")
    tol = DIST_LOSS_RTOL.get((stage, dtype), DIST_LOSS_RTOL[dtype])
    m0, mo = r0["metrics"][0][1], one["metrics"][0][1]
    losses = {k: rel(m0[k], mo[k]) for k in mo if k.startswith("loss")}
    if r0["metrics"] != r1["metrics"] or any(v > tol for v in losses.values()) \
            or any(m["skipped_nonfinite"] or m["params_without_grad"]
                   for _, m in r0["metrics"] + one["metrics"]):
        raise AssertionError(f"{what}: losses {m0} against {mo}, rank 1 {r1['metrics'][0]}")
    g2, g1 = r0["grads"], one["grads"]
    num = sum(float(((g2[k].double() - g1[k].double()) ** 2).sum()) for k in g1)
    together = math.sqrt(num / max(sum(float((g.double() ** 2).sum()) for g in g1.values()),
                                   1e-300))
    worst = max(float((g2[k] - g1[k]).abs().max()) / max(float(g1[k].abs().max()), 1e-30)
                for k in g1)
    if dtype == "float64" or stage == "rcnn":
        grads_agree(g2, g1, what)
    elif not together <= DIST_F32_GRAD_L2:
        raise AssertionError(f"{what}: gradients {together:.3g} apart (relative L2)")
    stats = [k for k in one["buffers"] if k.endswith(("running_mean", "running_var"))]
    bn = max([float((r0["buffers"][k].double() - one["buffers"][k].double()).norm())
              / max(float(one["buffers"][k].double().norm()), 1e-300) for k in stats] or [0.0])
    if dtype == "float64" and bn > 1e-6:
        raise AssertionError(f"{what}: BN running statistics {bn:.3g} apart")
    if any(not torch.equal(v, r1["state"][k]) for k, v in r0["state"].items()):
        raise AssertionError(f"{what}: the ranks' parameters differ after "
                             f"{len(r0['metrics'])} iterations")
    ckpt = Checkpointer(r0["ckpt_dir"])
    saved = ckpt.read()["model"]
    if ckpt.steps() != [len(r0["metrics"])] or any(not torch.equal(saved[k], v)
                                                   for k, v in r0["state"].items()):
        raise AssertionError(f"{what}: checkpoint {ckpt.steps()} differs from the ranks' state")
    with open(os.path.join(os.path.dirname(r0["ckpt_dir"]), "log.txt")) as f:
        if any(" rank1 " in line for line in f):
            raise AssertionError(f"{what}: rank 1 wrote to log.txt")
    return (f"  {what}: first-step losses {losses} relative apart; gradients {together:.3g} "
            f"relative L2 over all tensors, worst tensor max |diff| {worst:.3g} of its max; BN "
            f"running statistics {bn:.3g}; {len(r0['metrics'])} iterations, ranks bit-equal, "
            f"rank 0's checkpoint and log.txt alone; s/iteration 2 ranks {r0['s_per_iter']:.3f}, "
            f"1 process {one['s_per_iter']:.3f}")


def check_dist_eval(two: list, one: dict) -> str:
    """Phase 22 (b): the merged predictions.pkl, every imgid once, equal
    to the one-process run's, and the same AP. -> a log line."""
    with open(os.path.join(two[0]["out_dir"], "predictions.pkl"), "rb") as f:
        saved = pickle.load(f)
    want = one["predictions"]
    for got in (saved, two[0]["predictions"], two[1]["predictions"]):
        if sorted(got) != sorted(want):
            raise AssertionError(f"2-rank eval: images {sorted(got)}")
        for imgid, p in want.items():
            for k, v in p.items():
                if not np.array_equal(got[imgid][k], v) or got[imgid][k].dtype != v.dtype:
                    raise AssertionError(f"2-rank eval: {imgid} {k} differs")
    if two[0]["ap"] != one["ap"] or not two[0]["has_txt"] or two[1]["has_txt"] \
            or two[1]["ap"] is not None:
        raise AssertionError(f"2-rank eval: AP {two[0]['ap']} against {one['ap']}")
    launched = check_rows(two[0]["launches"], EVAL_RUNS[1][2], "2-rank test_net")
    return (f"  test_net {DIST_EVAL[0]} on {DIST_EVAL[1]}, 2 ranks: {len(saved)} images merged, "
            f"predictions bit-equal to one process's, AP equal; {two[0]['s']:.3f} s a rank "
            f"(one process {one['s']:.3f} s); launches a rank {launched}")


def check_nccl() -> str:
    """Phase 22 (c): NCCL refuses two ranks on one card; a world-1 NCCL
    group runs an all_reduce, and one rcnn.yaml iteration through it
    leaves the checkpoint of the run without a group, bit for bit."""
    env = {k: os.environ.get(k) for k in ("WORLD_SIZE", "LOCAL_WORLD_SIZE", "RANK",
                                          "LOCAL_RANK", "MASTER_PORT")}
    os.environ.update(WORLD_SIZE="2", LOCAL_WORLD_SIZE="2", RANK="1", LOCAL_RANK="1",
                      MASTER_PORT="1")
    try:
        init_distributed("nccl", None)
        raise AssertionError("nccl accepted two ranks on one card")
    except RuntimeError as e:
        refused = str(e).split(":")[0]
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if dist.is_initialized():
        raise AssertionError("a process group survived the refusal")
    with tempfile.TemporaryDirectory() as tmp:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                                rank=0)
        try:
            x = torch.full((4,), 3.0, device="cuda:0")
            dist.all_reduce(x)
            if x.tolist() != [3.0] * 4:
                raise AssertionError(f"nccl all_reduce at world 1: {x.tolist()}")
            grouped = dist_train_run("rcnn", DIST_RUNS[2][1], os.path.join(tmp, "nccl"),
                                     "float32", 1, dist_backend="nccl")
        finally:
            dist.destroy_process_group()
        alone = dist_train_run("rcnn", DIST_RUNS[2][1], os.path.join(tmp, "alone"), "float32",
                               1)
        a = Checkpointer(grouped["ckpt_dir"]).read()["model"]
        b = Checkpointer(alone["ckpt_dir"]).read()["model"]
        if sorted(a) != sorted(b) or any(not torch.equal(a[k], b[k]) for k in b):
            raise AssertionError("the checkpoint under a world-1 NCCL group differs")
    return (f"  NCCL: two ranks on one card refused ({refused!r}); a world-1 group's "
            f"all_reduce and one rcnn.yaml iteration through it: checkpoint bit-equal to the "
            f"run without a group")


def check_records(card_dir: str, cpu_dir: str) -> str:
    """Phase 22 (d): generate_psmnet_input's records on the card against
    the CPU's. -> a log line."""
    names = sorted(os.listdir(card_dir))
    if not names or names != sorted(os.listdir(cpu_dir)):
        raise AssertionError(f"records: {len(names)} on the card, {sorted(os.listdir(cpu_dir))}")
    err = {"crop": 0.0, "disparity": 0.0}
    flips = total = 0
    shapes = set()
    for n in names:
        a, b = np.load(os.path.join(card_dir, n)), np.load(os.path.join(cpu_dir, n))
        shapes.add(tuple((k, a[k].shape) for k in sorted(a.files)))
        for k in ("left", "right"):
            err["crop"] = max(err["crop"], float(np.abs(a[k] - b[k]).max()))
        d = np.abs(a["disparity"] - b["disparity"]) - 1e-6 * np.abs(b["disparity"])
        err["disparity"] = max(err["disparity"], float(d.max()))
        flips += int((a["mask"] != b["mask"]).sum())
        total += a["mask"].size
    if err["crop"] > 2.0 ** -14 or err["disparity"] > 1e-5 or flips > RECIPE_MASK_FLIPS * total:
        raise AssertionError(f"records, card against CPU: {err}, {flips} mask entries differ")
    return (f"{len(names)} records {sorted(shapes)}; card against CPU: crops max |diff| "
            f"{err['crop']:.3g}, disparity {err['disparity']:.3g} over 1e-6 relative, "
            f"{flips} of {total} mask entries differ")


def check_recipe(tmp: str) -> str:
    """Phase 22 (d): test_net on mask.yaml -> split_predictions ->
    generate_psmnet_input (card and CPU) -> train_idispnet, 2 steps."""
    reset_launches()
    run = test_net.run("configs/kitti/car/vob/mask.yaml",
                       RECIPE_OPTS + ["OUTPUT_DIR", os.path.join(tmp, "mask")],
                       dataset=RECIPE_SCENES, static_hw=DIST_HW, device=DIST_DEVICE, seed=22)
    preds_path = os.path.join(run["datasets"][RECIPE_SCENES]["out_dir"], "predictions.pkl")
    with open(preds_path, "rb") as f:
        preds = pickle.load(f)
    n_split = split_predictions.split(preds, os.path.join(tmp, "offline"))
    if sorted(os.listdir(os.path.join(tmp, "offline"))) != sorted(f"{i}.pkl" for i in preds):
        raise AssertionError("split_predictions: files")
    card_dir, cpu_dir = os.path.join(tmp, "rec", "train"), os.path.join(tmp, "cpu")
    n = generate_psmnet_input.generate(preds, RECIPE_SCENES, card_dir, device=DIST_DEVICE)
    generate_psmnet_input.generate(preds, RECIPE_SCENES, cpu_dir, device="cpu")
    records = check_records(card_dir, cpu_dir)
    if n < 2:
        raise AssertionError(f"generate_psmnet_input: {n} records")
    os.symlink(card_dir, os.path.join(tmp, "rec", "val"))
    bs = n // 2
    res = train_idispnet.run(["--data-dir", os.path.join(tmp, "rec"), "--epochs", "1", "--bs",
                              str(bs), "--output", os.path.join(tmp, "psm"), "--device",
                              DIST_DEVICE, "--seed", "22"])
    sync(DIST_DEVICE)
    tr = res["trainer"]
    (_, loss, epe), = tr.history
    if tr.times["steps"] != n // bs or not (math.isfinite(loss) and math.isfinite(epe)):
        raise AssertionError(f"train_idispnet on the records: {tr.times}, {tr.history}")
    launches = check_rows(read_launches(), PSM_ROWS + ("nms_sorted",), "the recipe")
    return (f"  recipe: test_net mask.yaml on {RECIPE_SCENES} -> {n_split} split pickles -> "
            f"{records} -> train_idispnet {n // bs} steps of {bs}: loss {loss:.5g}, EPE {epe:.5g}; "
            f"launches {launches}")


def csrc_kernel_names() -> set:
    """The __global__ functions of csrc/*.cu."""
    pat = r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s*)?(?:void\s+)?(\w+)"
    return {name for f in build.CSRC.glob("*.cu") for name in re.findall(pat, f.read_text())}


def check_profiling(tmp: str) -> str:
    """Phase 22 (e): a trace of one rcnn.yaml train iteration names a
    csrc kernel; StepTimer and device_memory_stats read more than 0."""
    kernels = csrc_kernel_names()
    with profiling.trace(os.path.join(tmp, "trace")) as prof:
        dist_train_run("rcnn", DIST_RUNS[2][1], os.path.join(tmp, "traced"), "float32", 1)
    named = sorted({e.key for e in prof.key_averages()
                    if any(re.search(rf"\b{k}\b", e.key) for k in kernels)})
    size = os.path.getsize(prof.trace_path)
    if not named or size == 0:
        raise AssertionError(f"trace: {size} bytes, no csrc kernel among "
                             f"{[e.key for e in prof.key_averages()][:20]}")
    cfg = train_net.load_config("configs/kitti/car/vob/rcnn.yaml", DIST_TINY, 1)
    model = init_random_(build_detection_model(cfg, device=DIST_DEVICE),
                         torch.Generator(device=DIST_DEVICE).manual_seed(22)).eval()
    convert, _ = make_batch_converter(cfg, torch.device(DIST_DEVICE))
    kw = convert(next(iter(test_net.make_loader(cfg, "synthetic3d_4", DIST_HW))))
    gen = torch.Generator(device=DIST_DEVICE).manual_seed(22)
    timer = profiling.StepTimer()
    with torch.inference_mode():
        for _ in range(3):
            _, dt = timer.timed(lambda: model(**kw, generator=gen))
    mem = profiling.device_memory_stats()
    if not (timer.median > 0 and all(v > 0 for v in mem.values()) and len(mem) == 3):
        raise AssertionError(f"StepTimer {timer.samples}, memory {mem}")
    return (f"  profiling: the trace of one rcnn.yaml iteration ({size} bytes) names "
            f"{len(named)} csrc kernels (e.g. {named[:3]}); StepTimer median of a tiny rcnn.yaml "
            f"forward {1e3 * timer.median:.3f} ms; memory {mem}")


def phase_dist(card: str) -> dict:
    """Phase 22 (see the docstring). -> the launches of each run by row."""
    lines, counted = [], {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        gt_dir = os.path.join(tmp, "gt")
        write_kitti_gt(gt_dir, EVAL_IMAGES)
        evl = (DIST_EVAL[1], IMG_HW, DIST_EVAL[2])
        procs = spawn_ranks({"gt_dir": gt_dir, "device": DIST_DEVICE, "eval": evl}, tmp)
        try:
            one = [dist_train_run(stage, opts, os.path.join(tmp, f"one_{stage}_{dtype}"), dtype,
                                  DIST_ITERS if dtype == "float32" else 1)
                   for stage, opts, dtype in DIST_RUNS]
            one_eval = dist_test_net(os.path.join(tmp, "one_eval"), gt_dir, DIST_DEVICE, *evl)
        finally:
            ranks = join_ranks(procs, tmp, DIST_TIMEOUT_S)
        rows = {s: r for s, _, _, r in TRAIN_ENTRY_RUNS}
        for i, (stage, _, dtype) in enumerate(DIST_RUNS):
            for who, run in (("2-rank", ranks[0]["train"][i]), ("one-process", one[i])):
                if dtype == "float32":
                    counted[f"{who} {stage}"] = check_rows(run["launches"], rows[stage],
                                                           f"{who} {stage}.yaml")
                elif any(run["launches"].values()):
                    raise AssertionError(f"{who} {stage}.yaml float64: a kernel launched on "
                                         f"the plain route: {run['launches']}")
            lines.append(check_dist_train([r["train"][i] for r in ranks], one[i], stage, dtype))
        lines.append(check_dist_eval([r["eval"] for r in ranks], one_eval))
        counted["2-rank test_net"] = {k: v for k, v in ranks[0]["eval"]["launches"].items()
                                      if v}
        t_ab = time.perf_counter() - t0
        del ranks, one
        lines.append(check_nccl())
        lines.append(check_recipe(tmp))
        lines.append(check_profiling(tmp))
    log(f"[22/{PHASES}] distribution on {card} (2 ranks share the one card on gloo: no "
        f"scaling figure): the 2-rank steps at 1 pair a rank equal one process's at 2 pairs, "
        f"the 2-rank eval's merged predictions and AP equal; NCCL; the recipe's handoff "
        f"tools; profiling; (a) and (b) in {t_ab:.1f} s, the phase in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in lines:
        log(line)
    return counted


# Phase 23: a user's files on the card. A mini-KITTI at KITTI's size, the
# reference's five released layouts written from random-init models of the
# shipped configs (R-101), and the recipe's eval script run on them
USER_SCENES = (4, 4)  # train, val
USER_HW = (375, 1242)
USER_SEED = 23
# mask.yaml resizes to the 600-pixel short side (600 x 1987): the static
# size holds the whole image
USER_STATIC_HW = (608, 2016)
USER_SCRIPT = "disprcnn_tpu_torch/scripts/car/vob/eval_with_trained_model.sh"
USER_MODELS = "models/kitti/car/vob"  # the script's --ckpt and outputs, under its root
STATS_ATOL = 1e-6  # the native build prints 6 significant digits, Python 6 decimals
# where the phase runs and the configs' overrides: the card at the shipped
# configs (a rehearsal on the CPU sets "cpu" and small models' opts)
USER_DEVICE = "cuda"
USER_OPTS: list = []


def user_models() -> dict:
    """The random-init models of mask.yaml and rcnn.yaml (R-101, the
    shipped widths) on the card, drawn from USER_SEED, and fresh ones drawn
    from another seed, to load into."""
    out = {}
    for name in ("mask", "rcnn"):
        cfg = train_net.load_config(f"configs/kitti/car/vob/{name}.yaml", USER_OPTS)
        for which, seed in (("src", USER_SEED), ("fresh", USER_SEED + 100)):
            out[f"{name}_{which}"] = init_random_(
                build_detection_model(cfg, device=USER_DEVICE),
                torch.Generator(device=USER_DEVICE).manual_seed(seed)).eval()
    return out


def check_mini_kitti(root: str) -> str:
    """(a): the tree read back through KittiStereoDataset (data/png.py)
    equals the synthetic scenes it was written from, after the uint8 and
    uint16 rounding. -> the line to log."""
    n = sum(USER_SCENES)
    t0 = time.perf_counter()
    make_mini_kitti.write(root, *USER_SCENES, USER_HW, seed=USER_SEED)
    t_write = time.perf_counter() - t0
    ds = SyntheticStereoDataset(n_samples=n, image_hw=USER_HW, max_gt=8, seed=USER_SEED)
    kitti = KittiStereoDataset(root, "trainval", shape_prior_base="vob", training=False,
                               max_gt=8)
    t0 = time.perf_counter()
    sizes = kitti.image_sizes()
    samples = [kitti[i] for i in range(len(kitti))]
    t_read = time.perf_counter() - t0
    if kitti.ids != [f"{i:06d}" for i in range(n)] or sizes != [USER_HW[::-1]] * n:
        raise AssertionError(f"mini-KITTI: ids {kitti.ids}, sizes {sizes}")
    for i, k in enumerate(samples):
        s = ds[i]
        for key in ("left", "right"):
            if not np.array_equal(k[key], (s[key] * 255).astype(np.uint8) / np.float32(255)):
                raise AssertionError(f"mini-KITTI {kitti.ids[i]}: {key} differs")
        disp = np.clip(s["gt_disp"] * 256, 0, 65535).astype(np.uint16) / np.float32(256)
        m = int(s["gt_valid"].sum())
        if not np.array_equal(k["gt_disp"], disp) or not np.array_equal(
                k["gt_masks"][:m], s["gt_masks"][s["gt_valid"]] != 0) or not m:
            raise AssertionError(f"mini-KITTI {kitti.ids[i]}: disparity or masks differ")
    return (f"  (a) make_mini_kitti wrote {n} scenes of {USER_HW[0]}x{USER_HW[1]} in "
            f"{t_write:.3f} s ({n / t_write:.3f} scenes/s); KittiStereoDataset read them "
            f"(image sizes from IHDR, the pair, disparity, masks) in {t_read:.3f} s "
            f"({n / t_read:.3f} samples/s), equal to the scenes after the uint8/uint16 "
            "rounding")


def released_files(models: dict, d: str) -> dict:
    """(b)'s files: {layout: (path, source state_dict, fresh model to load
    into, entries that must equal)}."""
    cpu = lambda m: {k: v.cpu() for k, v in m.state_dict().items()}
    w = ckpt_writer
    mask, rcnn = cpu(models["mask_src"]), cpu(models["rcnn_src"])
    scope = lambda sd, p: {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
    psm, pr = scope(rcnn, "idispnet."), scope(rcnn, "pointrcnn.")
    weights = [k for k in mask if k.startswith("backbone.") and "running_" not in k]
    return {
        "2D mrcnn .pth": (w.write_pth(os.path.join(d, "smrcnn.pth"), w.reference_2d(mask)),
                          mask, models["mask_fresh"], list(mask)),
        "pointrcnn.pth": (w.write_pth(os.path.join(d, "pointrcnn.pth"),
                                      w.ddp(w.reference_pointrcnn(pr)), iteration=1),
                          pr, models["rcnn_fresh"].pointrcnn, list(pr)),
        "full 3D stage .pth": (w.write_pth(os.path.join(d, "disprcnn3d.pth"),
                                           w.ddp(w.reference_disprcnn3d(rcnn))),
                               rcnn, models["rcnn_fresh"], list(rcnn)),
        "PSMNet bestmodel .tar": (w.write_pth(os.path.join(d, "bestmodel.tar"),
                                              w.ddp(w.reference_psmnet(psm)),
                                              wrapper="state_dict", epoch=1),
                                  psm, models["rcnn_fresh"].idispnet, list(psm)),
        # Caffe2 norms carry no statistics: only the backbone's weights count
        "R-101 Detectron .pkl": (w.write_pkl(os.path.join(d, "R-101.pkl"), w.c2_blobs(mask)),
                                 mask, models["mask_fresh"], weights),
    }


def check_released(files: dict) -> tuple:
    """(b): each file through load_stage_weights into a fresh model equals
    its source entry for entry. -> (log lines, {layout: load seconds})."""
    lines, secs = [], {}
    for i, (name, (path, src, fresh, keys)) in enumerate(files.items()):
        # drawn anew before each load, so that no earlier load's values pass
        init_random_(fresh, torch.Generator(device=USER_DEVICE).manual_seed(USER_SEED + 200 + i))
        same = [k for k in keys if torch.equal(fresh.state_dict()[k].cpu(), src[k])]
        if len(same) * 2 > len(keys):
            raise AssertionError(f"{name}: the fresh model already holds {len(same)} of the "
                                 f"{len(keys)} source entries")
        sync(USER_DEVICE)
        t0 = time.perf_counter()
        unmatched = load_stage_weights(fresh, path)
        sync(USER_DEVICE)
        secs[name] = time.perf_counter() - t0
        got = fresh.state_dict()
        bad = [k for k in keys if not torch.equal(got[k].cpu(), src[k])]
        left = sorted(set(got) - set(keys) - {k for k in got if "num_batches_tracked" in k})
        if bad or (name != "R-101 Detectron .pkl" and unmatched) or \
                not set(unmatched) <= set(left):
            raise AssertionError(f"{name}: {bad[:3]} differ, unmatched {unmatched[:3]}")
        lines.append(f"  (b) {name} ({os.path.getsize(path) / 1e6:.1f} MB): "
                     f"load_stage_weights {secs[name]:.3f} s, {len(keys)} entries equal to "
                     f"the source model's, {len(unmatched)} unmatched")
    return lines, secs


def run_root(tmp: str, files: dict) -> str:
    """A directory the recipe script runs from: the checkout's package and
    configs linked in, (b)'s 2D and PointRCNN files where the script's
    --ckpt points, and a `python` that is this interpreter."""
    root = os.path.join(tmp, "root")
    os.makedirs(os.path.join(root, "bin"))
    for name in ("disprcnn_tpu_torch", "configs"):
        os.symlink(os.path.join(ROOT, name), os.path.join(root, name))
    for stage, layout, fname in (("mask", "2D mrcnn .pth", "smrcnn.pth"),
                                 ("rcnn", "pointrcnn.pth", "pointrcnn.pth")):
        os.makedirs(os.path.join(root, USER_MODELS, stage))
        os.symlink(files[layout][0], os.path.join(root, USER_MODELS, stage, fname))
    with open(os.path.join(root, "bin", "python"), "w") as f:
        f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    os.chmod(os.path.join(root, "bin", "python"), 0o755)
    return root


def cli_rate(log_txt: str) -> str:
    """The images/s line test_net logged."""
    with open(log_txt) as f:
        hits = [line.split(": ", 1)[1].strip() for line in f if "images/s" in line]
    if not hits:
        raise AssertionError(f"{log_txt}: no images/s line")
    return hits[-1]


def jittered_detections(gt_dir: str, out_dir: str) -> None:
    """Each label file's objects as detections: boxes and centres moved by
    seeded noise, one in five dropped, a false positive added, scored;
    written to 6 decimals, as tools/test_net writes detections (on labels
    and detections both rounded to 2 decimals an overlap can equal the
    threshold exactly, where the two evaluators part: ROADMAP C32)."""
    rng = np.random.default_rng(USER_SEED)
    os.makedirs(out_dir)
    for name in sorted(os.listdir(gt_dir)):
        lines = []
        with open(os.path.join(gt_dir, name)) as f:
            for line in f:
                v = line.split()
                if rng.random() < 0.2:
                    continue
                box = np.asarray(v[4:8], float) + rng.normal(0, 4, 4)
                xyz = np.asarray(v[11:14], float) + rng.normal(0, 0.4, 3)
                lines.append(" ".join([v[0], "-1 -1", v[3], *(f"{b:.6f}" for b in box), *v[8:11],
                                       *(f"{c:.6f}" for c in xyz), v[14],
                                       f"{rng.uniform(0.3, 1):.6f}"]))
        x1 = rng.uniform(0, 1000)
        lines.append(f"Car -1 -1 0.1 {x1:.2f} 150.00 {x1 + 80:.2f} 210.00 1.5 1.6 3.9 "
                     f"{rng.uniform(-10, 10):.2f} 1.6 {rng.uniform(10, 40):.2f} 0.1 "
                     f"{rng.uniform(0.05, 0.95):.4f}")
        with open(os.path.join(out_dir, name), "w") as f:
            f.write("\n".join(lines) + "\n")


def check_script(root: str, data: str, rcnn_fresh, rcnn_src, tmp: str) -> tuple:
    """(c): the recipe's eval script on the mini-KITTI, then rcnn.yaml in
    this process on the same model loaded from its own state_dict. -> (log
    lines, that run's launches by row)."""
    gt = os.path.join(data, "object", "training", "label_2")
    env = dict(os.environ, DISPRCNN_DATA_DIR=data,
               PATH=os.path.join(root, "bin") + os.pathsep + os.environ.get("PATH", ""))
    env.pop("PYTHONPATH", None)
    args = ["--static-hw", ",".join(map(str, USER_STATIC_HW)), "--deterministic", "--evaluate",
            "--gt-dir", gt, "--seed", str(USER_SEED), "--device", USER_DEVICE, *USER_OPTS]
    t0 = time.perf_counter()
    proc = subprocess.run(["bash", os.path.join(root, USER_SCRIPT), *args], cwd=tmp, env=env,
                          capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{USER_SCRIPT} exit {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    lines = [f"  (c) {USER_SCRIPT} {' '.join(args)}: rc 0 in {wall:.1f} s "
             "(three test_net processes)"]
    out = {}
    for stage in ("mask", "idispnet", "rcnn"):
        res = os.path.join(root, USER_MODELS, stage, "inference", "kitti_val_vob_car")
        with open(os.path.join(res, "predictions.pkl"), "rb") as f:
            out[stage] = pickle.load(f)
        if sorted(out[stage]) != [f"{i:06d}" for i in range(USER_SCENES[0], sum(USER_SCENES))]:
            raise AssertionError(f"{stage}: predictions of {sorted(out[stage])}")
        lines.append(f"      test_net {stage}.yaml: "
                     f"{cli_rate(os.path.join(root, USER_MODELS, stage, 'log.txt'))}")
    res = os.path.join(root, USER_MODELS, "rcnn", "inference", "kitti_val_vob_car")
    # the native AP against the Python evaluator's on the same txt
    py = kitti_eval.evaluate_kitti(gt, os.path.join(res, "txt"), os.path.join(tmp, "py"),
                                   use_native=False)
    for thr, sub in ((0.7, "eval_07"), (0.5, "eval_05")):
        native = kitti_eval.read_stats(os.path.join(res, sub), "Car")
        for kind in ("detection", "detection_ground", "detection_3d", "orientation"):
            a = np.loadtxt(os.path.join(res, sub, f"stats_car_{kind}.txt"), ndmin=2)
            b = np.loadtxt(os.path.join(tmp, "py", sub, f"stats_car_{kind}.txt"), ndmin=2)
            if a.shape != b.shape or np.abs(a - b).max() > STATS_ATOL:
                raise AssertionError(f"native {sub} {kind} differs from the Python evaluator's")
        if any(abs(x - y) > 100 * STATS_ATOL for k in py[thr]
               for x, y in zip(native[k], py[thr][k])):
            raise AssertionError(f"AP@{thr}: native {native}, Python {py[thr]}")
    # and on detections that score: the mini-KITTI's GT, jittered, some dropped,
    # false positives added
    dets = os.path.join(tmp, "jittered")
    jittered_detections(gt, dets)
    nat_j = kitti_eval.evaluate_kitti(gt, dets, os.path.join(tmp, "nat_j"))
    py_j = kitti_eval.evaluate_kitti(gt, dets, os.path.join(tmp, "py_j"), use_native=False)
    for thr, sub in ((0.7, "eval_07"), (0.5, "eval_05")):
        for name in sorted(os.listdir(os.path.join(tmp, "py_j", sub))):
            a = np.loadtxt(os.path.join(tmp, "nat_j", sub, name), ndmin=2)
            b = np.loadtxt(os.path.join(tmp, "py_j", sub, name), ndmin=2)
            if a.shape != b.shape or np.abs(a - b).max() > STATS_ATOL:
                raise AssertionError(f"jittered detections: native {sub} {name} differs")
        if any(abs(x - y) > 100 * STATS_ATOL for k in py_j[thr]
               for x, y in zip(nat_j[thr][k], py_j[thr][k])) or \
                not 0 < max(nat_j[thr]["image"]) < 100:
            raise AssertionError(f"jittered AP@{thr}: native {nat_j[thr]}, Python {py_j[thr]}")
    shown = {t: {k: [(round(a, 4), round(b, 4)) for a, b in zip(nat_j[t][k], py_j[t][k])]
                 for k in ("image", "3d")} for t in nat_j}
    lines.append("      the native evaluator's stats files equal the Python evaluator's to "
                 f"{STATS_ATOL:g} (their print precision), the AP to {100 * STATS_ATOL:g}: on "
                 "rcnn.yaml's txt (AP 0: random weights) and on the GT jittered (AP easy, "
                 f"moderate, hard as (native, Python): {shown})")
    # rcnn.yaml in this process: the script's model, its pointrcnn.* loaded
    # from the source model's own state_dict instead of pointrcnn.pth
    init_random_(rcnn_fresh, torch.Generator(device=USER_DEVICE).manual_seed(USER_SEED))
    rcnn_fresh.pointrcnn.load_state_dict(rcnn_src.pointrcnn.state_dict())
    offline = os.path.join(root, USER_MODELS, "idispnet", "inference", "kitti_%s_vob_car",
                           "predictions")
    reset_launches()
    os.environ["DISPRCNN_DATA_DIR"] = data
    try:
        run = test_net.run("configs/kitti/car/vob/rcnn.yaml",
                           [*USER_OPTS, "OUTPUT_DIR", os.path.join(tmp, "inproc"),
                            "SOLVER.OFFLINE_2D_PREDICTIONS", offline],
                           dataset="kitti_val_vob_car", static_hw=USER_STATIC_HW,
                           device=USER_DEVICE, seed=USER_SEED, model=rcnn_fresh,
                           deterministic=True)
    finally:
        del os.environ["DISPRCNN_DATA_DIR"]
    sync(USER_DEVICE)
    launches = read_launches()
    if USER_DEVICE == "cuda":
        launches = check_rows(launches, EVAL_RUNS[1][2], "rcnn.yaml on the mini-KITTI")
    preds = run["datasets"]["kitti_val_vob_car"]["predictions"]
    check_predictions(preds, pred_shapes(run["cfg"]), USER_SCENES[1])
    for imgid, p in preds.items():
        for k, v in p.items():
            if not np.array_equal(out["rcnn"][imgid][k], v):
                raise AssertionError(f"rcnn.yaml fed pointrcnn.pth: {imgid} {k} differs from "
                                     "the model loaded from its own state_dict")
    valid = sum(int(p["valid"].sum()) for p in preds.values())
    lines.append(f"      rcnn.yaml fed pointrcnn.pth (the script) and the same model loaded "
                 f"from its own state_dict (this process): predictions bit-equal, {valid} valid "
                 f"slots; launches {launches}")
    return lines, launches


def phase_user_files(card: str) -> dict:
    """Phase 23 (see the docstring). -> the in-process rcnn.yaml run's
    launches by row."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "mini_kitti")
        lines = [check_mini_kitti(data)]
        models = user_models()
        files = released_files(models, tmp)
        more, secs = check_released(files)
        lines += more
        root = run_root(tmp, files)
        for k in [k for k in models if k != "rcnn_fresh" and k != "rcnn_src"]:
            del models[k]
        del files
        torch.cuda.empty_cache()
        more, launches = check_script(root, data, models["rcnn_fresh"], models["rcnn_src"], tmp)
        lines += more
        del models
        torch.cuda.empty_cache()
    log(f"[23/{PHASES}] a user's files on {card}: a {USER_HW[0]}x{USER_HW[1]} mini-KITTI "
        f"read through data/png.py, the reference's five released layouts loaded exactly, "
        f"the recipe's eval script on them with the native evaluator, in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in lines:
        log(line)
    return launches


# Phase 24: the stereo detector's last options (DISPNET_ON eval and train,
# the full-image disparity, GroupNorm, MASK_ON False), A2's proposals and
# the visualizer, on mask.yaml and rcnn.yaml
STEREO_YAML = "configs/kitti/car/vob/mask.yaml"
STEREO_DEVICE = "cuda"
STEREO_SEED = 24
STEREO_DATASET = "synthetic_8"
DISPNET_ON = ["MODEL.DISPNET_ON", "True"]
# one DISPNET_ON request (8 pairs, 32 detections each: 256 ROIs): the SRPN's
# and the box head's NMS, then DispModule's trunk as PSMNet's (no tower, so
# no row 7; its reduce_out is a 1x1 conv and CONV_LAYERS is empty)
EXPECTED_DISPNET = {"nms_sorted": 2, "cost_volume_conv": 1, "conv3d": 12, "conv3d_cl1": 3,
                    "conv3d_s2": 6, "deconv3d": 6, "softargmin": 1}
DISPNET_ROWS = ("cost_volume_conv", "conv3d", "conv3d_cl1", "conv3d_s2", "deconv3d",
                "softargmin")
# the trunk's levels at 28^2 ROIs, +-48 at stride 4: (D, H = W)
DISPNET_SITES = ((24, 28), (12, 14), (6, 7))
# full-image disparity on the card against the CPU: values within
# FULLIMAGE_TOL_PX where both cover a pixel; at most FULLIMAGE_FLIPS of the
# pixels covered by one side only (a mask sample or a box edge one ulp
# across its threshold)
FULLIMAGE_TOL_PX = 1e-3
FULLIMAGE_FLIPS = 1e-3
# disparity_roi of the kernel run, held as phase 15 holds the train step's
# gradients (ROADMAP C19): its distance from DispModule in float64 on the
# same inputs within twice the plain float32 run's, + DISP_TOL_PX
DISPNET_ORDER_FACTOR = 2
# (b): the JAX step runs DispModule on every sampled ROI: at mask.yaml's 4
# images x 512 that is 2048 ROIs, with ~100 MB of saved activations each in
# the trunk and the plain soft-argmin (one 32-channel (24, 28, 28) volume is
# 2.4 MB a ROI, one (96, 112, 112) soft-argmin volume 4.8 MB): ~200 GB.
# Cut to 2 images x 128 ROIs, every width kept
DISPNET_TRAIN_OPTS = DISPNET_ON + ["SOLVER.TRAIN_PSM", "True", "MODEL.WEIGHT", "",
                                   "SOLVER.IMS_PER_BATCH", "2",
                                   "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "128",
                                   "SOLVER.PRINT_INTERVAL", "1"]
DISPNET_TRAIN_ITERS = 2
GN_OPTS = ["MODEL.BACKBONE.USE_GN", "True", "MODEL.FPN.USE_GN", "True"]
# (e): rcnn.yaml at the headline budget (16 detections of 8 pairs, 128
# pre-NMS and 16 post-NMS proposals a cloud)
VIZ_HW = (192, 640)  # the synthetic scenes' size
A2_YAML = "configs/kitti/car/vob/rcnn.yaml"
A2_OPTS = ["TPU.MAX_DETECTIONS", "16", "MODEL.POINTRCNN.TEST.RPN_PRE_NMS_TOP_N", "128",
           "MODEL.POINTRCNN.TEST.RPN_POST_NMS_TOP_N", "16"]
A2_RUNS = (("NMS_TYPE rotate", ["MODEL.POINTRCNN.RPN.NMS_TYPE", "rotate"], 0),
           ("RPN_DISTANCE_BASED_PROPOSE", ["MODEL.POINTRCNN.TEST.RPN_DISTANCE_BASED_PROPOSE",
                                           "True"], 2))
A2_NEAR = 1e-4  # an IoU this close to the threshold, or a z this close to a band edge


def stereo_model(opts, seed: int = STEREO_SEED):
    cfg = train_net.load_config(STEREO_YAML, opts)
    model = build_detection_model(cfg, device=STEREO_DEVICE)
    return cfg, init_random_(model, torch.Generator(device=STEREO_DEVICE).manual_seed(seed))


def fullimage_check(out, i: int = 0) -> str:
    """rois_to_fullimage_disparity of image i's detections on the card
    against the CPU."""
    dets = out["detections"]
    args = (out["disparity_roi"][i], out["masks"][i], dets.left[i], dets.right[i],
            dets.valid[i])
    got = rois_to_fullimage_disparity(*args, *IMG_HW)
    want = rois_to_fullimage_disparity(*(a.cpu() for a in args), *IMG_HW)
    got = got.cpu()
    both = (got != 0) & (want != 0)
    err = float((got - want)[both].abs().max()) if both.any() else 0.0
    flips = float(((got != 0) != (want != 0)).float().mean())
    if not (err <= FULLIMAGE_TOL_PX and flips <= FULLIMAGE_FLIPS and both.any()):
        raise AssertionError(f"full-image disparity card vs CPU: max |diff| {err} px, "
                             f"{flips} of the pixels covered by one side, {int(both.sum())} "
                             "by both")
    return (f"full-image disparity of image {i} ({int(dets.valid[i].sum())} instances, "
            f"{int(both.sum())} pixels): card vs CPU max |diff| {err:.3g} px, coverage "
            f"differs on {flips:.2g} of the pixels")


def dispnet_sam_check(calls):
    """The soft-argmin launch of a DISPNET_ON request held to the same
    function in float64 on its logits: the kernel's distance within
    DISPNET_ORDER_FACTOR times the plain version's + SOFTARGMIN_TOL_PX.
    -> compare(got, want), which logs the three distances and the logits'
    range and returns max |kernel - plain|."""
    (a,) = calls
    exact = csam.softargmin_plain(a[0].double(), *a[1:])
    span = float(a[0].amax() - a[0].amin())

    def compare(got, want):
        kp = float((got - want).abs().max())
        ke, pe = (float((x.double() - exact).abs().max()) for x in (got, want))
        log(f"  softargmin at DispModule's site {tuple(a[0].shape)}, logits spanning "
            f"{span:.4g}: kernel vs plain {kp:.4g} px; from float64: kernel {ke:.4g} px, "
            f"plain {pe:.4g} px")
        if not ke <= DISPNET_ORDER_FACTOR * pe + SOFTARGMIN_TOL_PX:
            raise AssertionError(f"softargmin at DispModule's site: kernel {ke} px from "
                                 f"float64, plain {pe} px")
        return kp
    return compare


def dispnet_eval(card: str, req) -> dict:
    """(a): mask.yaml with DISPNET_ON at 8 pairs: the launches, each trunk
    site's launches held and timed against their plain versions, the
    kernel run against the plain run and both against DispModule in
    float64 on the same inputs, the request's time and peak memory, and
    the full-image disparity. -> the rows' timings and launches."""
    cfg, model = stereo_model(DISPNET_ON)
    left, right = req[:2]
    run = lambda: predict_2d(model, left, right)
    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out, ms = bench.timed(run, "cuda")
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_launches().items() if v}
    peak = torch.cuda.max_memory_allocated() / 1e9
    if launches != EXPECTED_DISPNET:
        raise AssertionError(f"DISPNET_ON request launched {launches}, expected "
                             f"{EXPECTED_DISPNET}")
    n = out["detections"].valid.sum().item()
    disp = out["disparity_roi"]
    if disp.shape != (PAIRS, cfg.TPU.MAX_DETECTIONS, 112, 112) or not torch.isfinite(disp).all():
        raise AssertionError(f"disparity_roi {tuple(disp.shape)}, finite "
                             f"{bool(torch.isfinite(disp).all())}")
    calls = capture_launches(run, MAIN_PATH_POINTS)
    kinds = kernel_kinds()
    sites, rows = {}, {}
    for name in DISPNET_ROWS:
        kernel, plainf, library, work, src, replaces = kinds[name]
        for a in calls[name]:
            x = a[0]
            key = (x.shape[2], x.shape[3]) if x.dim() == 5 else ("soft-argmin", x.shape[2])
            sites.setdefault(name, set()).add(key)
        compare = (dispnet_sam_check(calls[name]) if name == "softargmin"
                   else partial(main_path_err, name))
        rows[name] = time_launches(name, [("", calls[name], kernel, plainf, library, work,
                                           compare)], 0.0, src, replaces)
    del calls
    # every trunk level is reached: the stride-1 convs at all three, the
    # stride-2 convs from 28^2 and 14^2, the transposed convs from 7^2 and 14^2
    if sites["conv3d"] != set(DISPNET_SITES) or {s[1] for s in sites["conv3d_s2"]} != {28, 14} \
            or {s[1] for s in sites["deconv3d"]} != {7, 14}:
        raise AssertionError(f"DispModule sites {sites}")
    seen = []
    hook = model.dispnet.register_forward_pre_hook(
        lambda mod, args: seen.append([[f.clone() for f in a] if isinstance(a, list)
                                       else a.clone() for a in args]))
    with all_plain():
        plain = run()
    hook.remove()
    torch.cuda.synchronize()
    d0, d1 = out["detections"], plain["detections"]
    for f in ("left", "right", "score", "valid"):
        if not torch.equal(getattr(d0, f), getattr(d1, f)):
            raise AssertionError(f"DISPNET_ON detections' {f} differ, kernels vs plain")
    if not torch.equal(out["masks"], plain["masks"]):
        raise AssertionError("DISPNET_ON masks differ, kernels vs plain")
    # both float32 runs against DispModule in float64 on the same inputs
    exact = copy.deepcopy(model.dispnet).double()
    with torch.inference_mode(), all_plain():
        args = [[f.double() for f in a] if isinstance(a, list) else
                (a.double() if a.is_floating_point() else a) for a in seen[0]]
        ref = exact(*args).reshape(disp.shape)
    del exact, args, seen
    kd, pd = disp.double(), plain["disparity_roi"].double()
    derr = float((kd - pd).abs().max())
    k64, p64 = float((kd - ref).abs().max()), float((pd - ref).abs().max())
    q = lambda d: float(torch.quantile(d.abs().flatten()[::97].float(), 0.999))
    log(f"  disparity_roi: kernels vs plain max |diff| {derr:.4g} px (99.9% {q(kd - pd):.3g}); "
        f"from float64: kernels {k64:.4g} px (99.9% {q(kd - ref):.3g}), plain {p64:.4g} px "
        f"(99.9% {q(pd - ref):.3g})")
    if not k64 <= DISPNET_ORDER_FACTOR * p64 + DISP_TOL_PX:
        raise AssertionError(f"disparity_roi: kernels {k64} px from float64, plain {p64}")
    del kd, pd, ref, plain
    full = fullimage_check(out)
    log(f"  DISPNET_ON eval (mask.yaml, R-101-FPN, {PAIRS} pairs of {IMG_HW[0]}x{IMG_HW[1]}, "
        f"{n} of {PAIRS * cfg.TPU.MAX_DETECTIONS} detection slots valid, DispModule at 28^2 -> "
        f"112^2 over [-48, 48)): {ms:.3f} ms a request, peak {peak:.2f} GB, launches "
        f"{launches}; kernels vs plain: detections and masks equal, disparity_roi max |diff| "
        f"{derr:.3g} px, from float64 {k64:.3g} px (plain {p64:.3g}); the trunk's sites "
        f"(D, H) { {k: sorted(v, key=str) for k, v in sites.items()} }; {full}")
    return {"rows": rows, "launches": launches, "ms": ms, "peak_gb": peak,
            "disp_err_px": derr, "kernel_f64_px": k64, "plain_f64_px": p64}


def dispnet_train(card: str, tmp: str) -> dict:
    """(b): tools/train_net on mask.yaml with DISPNET_ON and TRAIN_PSM."""
    cfg = train_net.load_config(STEREO_YAML, DISPNET_TRAIN_OPTS + [
        "OUTPUT_DIR", os.path.join(tmp, "dispnet_train")], DISPNET_TRAIN_ITERS)
    model = init_random_(build_detection_model(cfg, device=STEREO_DEVICE),
                         torch.Generator(device=STEREO_DEVICE).manual_seed(STEREO_SEED))
    before = {k: v.detach().clone() for k, v in model.dispnet.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = train_net.train(cfg, dataset=STEREO_DATASET, static_hw=IMG_HW, device=STEREO_DEVICE,
                          seed=STEREO_SEED, model=model)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = check_rows(read_launches(), ("nms_sorted", "conv3d_train"),
                          "train_net mask.yaml DISPNET_ON")
    for it, m in res["metrics"]:
        if not (math.isfinite(m.get("loss_psm", math.nan)) and m["loss_psm"] > 0) \
                or m["skipped_nonfinite"] or m["params_without_grad"]:
            raise AssertionError(f"DISPNET_ON train iteration {it}: {m}")
    moved = [k for k, v in model.dispnet.named_parameters() if not torch.equal(v, before[k])]
    if len(moved) != len(before):
        raise AssertionError(f"dispnet: {len(before) - len(moved)} parameters not updated")
    st, iters, psm = res["stats"], res["iters"], [m["loss_psm"] for _, m in res["metrics"]]
    del res, model
    torch.cuda.empty_cache()
    row8 = dispnet_row8()
    log(f"  DISPNET_ON train (train_net mask.yaml, SOLVER.TRAIN_PSM, {iters} iterations "
        f"on {STEREO_DATASET}; cut to IMS_PER_BATCH 2 x BATCH_SIZE_PER_IMAGE 128 = 256 ROIs "
        f"through DispModule, from mask.yaml's 4 x 512 = 2048, whose saved trunk and "
        f"soft-argmin activations would not fit in 80 GB): {st['s_per_iter']:.3f} "
        f"s/iteration, peak {peak:.2f} GB, loss_psm "
        f"{[round(v, 5) for v in psm]}, all {len(moved)} dispnet "
        f"parameters updated, launches {launches}")
    return {"launches": launches, "s_per_iter": st["s_per_iter"], "peak_gb": peak, "row8": row8}


def dispnet_row8() -> dict:
    """Row 8 (forward and input gradient) timed at the DispModule train
    step's trunk sites, 256 ROIs (the cut step's rows), seeded inputs."""
    gen = torch.Generator(device="cuda").manual_seed(STEREO_SEED)
    n = 256
    calls = []
    for (d, s), c in zip(DISPNET_SITES, (32, 64, 64)):
        calls.append((torch.randn(n, c, d, s, s, generator=gen, device="cuda"),
                      torch.randn(c, c, 3, 3, 3, generator=gen, device="cuda") * 0.05))
    compare = lambda what: lambda got, want: conv_err(got, want, f"{what} at DispModule's sites")
    return time_launches("conv3d_train", [
        (" forward", calls, cconv.conv3d_train_cuda, cconv.conv3d_train_plain,
         lambda a: F.conv3d(a[0], a[1], padding=1), conv_work, compare("conv3d_train forward")),
        (" dx", calls, cconv.conv3d_train_dx_cuda, cconv.conv3d_train_dx_plain,
         lambda a: torch.nn.grad.conv3d_input(a[0].shape, a[1], a[0], padding=1),
         lambda a, o: conv_work((a[0], cconv.flip_transpose(a[1])), o),
         compare("conv3d_train dx"))],
        0.0, "conv3d_tc.cu", "disprcnn_tpu/ops/pallas/packed_conv.py:689")


def gn_run(card: str, req, tmp: str) -> dict:
    """(c): mask.yaml with both USE_GN: one request with kernels against the
    plain run, one train iteration."""
    cfg, model = stereo_model(GN_OPTS)
    reset_launches()
    out, ms = bench.timed(lambda: predict_2d(model, *req[:2]), "cuda")
    launches = {k: v for k, v in read_launches().items() if v}
    with all_plain():
        plain = predict_2d(model, *req[:2])
    for f in ("left", "right", "score", "valid"):
        if not torch.equal(getattr(out["detections"], f), getattr(plain["detections"], f)):
            raise AssertionError(f"GN detections' {f} differ, kernels vs plain")
    if not torch.equal(out["masks"], plain["masks"]):
        raise AssertionError("GN masks differ, kernels vs plain")
    del model
    cfg = train_net.load_config(STEREO_YAML, GN_OPTS + [
        "MODEL.WEIGHT", "", "SOLVER.PRINT_INTERVAL", "1",
        "OUTPUT_DIR", os.path.join(tmp, "gn_train")], 1)
    reset_launches()
    res = train_net.train(cfg, dataset=STEREO_DATASET, static_hw=IMG_HW, device=STEREO_DEVICE,
                          seed=STEREO_SEED)
    tl = check_rows(read_launches(), ("nms_sorted",), "train_net mask.yaml USE_GN")
    (it, m), = res["metrics"]
    if not all(math.isfinite(v) for k, v in m.items() if k.startswith("loss")) \
            or m["skipped_nonfinite"] or m["params_without_grad"]:
        raise AssertionError(f"GN train iteration: {m}")
    gn = sum(isinstance(mod, GroupNorm) for mod in res["model"].modules())
    log(f"  USE_GN (body and FPN, {gn} GroupNorms): a request {ms:.3f} ms, launches "
        f"{launches}, detections and masks equal to the plain run; one train iteration "
        f"{res['stats']['s_per_iter']:.3f} s, losses "
        f"{ {k: round(v, 5) for k, v in m.items() if k.startswith('loss')} }, launches {tl}")
    return {"launches": launches, "train_launches": tl}


def mask_off_run(card: str, tmp: str) -> dict:
    """(d): tools/test_net on mask.yaml with MODEL.MASK_ON False."""
    reset_launches()
    res = test_net.run(STEREO_YAML, ["MODEL.MASK_ON", "False", "OUTPUT_DIR",
                                     os.path.join(tmp, "mask_off")], dataset=STEREO_DATASET,
                       static_hw=IMG_HW, device=STEREO_DEVICE, seed=STEREO_SEED)
    launches = check_rows(read_launches(), ("nms_sorted",), "test_net mask.yaml MASK_ON False")
    shapes = {k: v for k, v in pred_shapes(res["cfg"]).items() if k != "masks"}
    if hasattr(res["model"], "mask_head"):
        raise AssertionError("MASK_ON False built a mask head")
    valid = check_predictions(res["datasets"][STEREO_DATASET]["predictions"], shapes,
                              EVAL_IMAGES)
    log(f"  MASK_ON False (test_net mask.yaml on {STEREO_DATASET}): predictions without masks, "
        f"{valid} valid slots, launches {launches}")
    return launches


def visualize_run(card: str, tmp: str) -> int:
    """(a)'s config through test_net at the scenes' size (without the
    resize or padding, so that the boxes are the raw images' pixels), then
    (f): tools/visualize on its predictions, the PNGs read back by
    data/png.py equal to the drawings,
    and, drawn without masks, the outline of every valid detection in its
    colour."""
    # the boxes in the raw images' pixels, which the visualizer draws on:
    # no resize, and no padding past the scenes' size to detect in
    res = test_net.run(STEREO_YAML, DISPNET_ON + ["INPUT.DO_RESIZE", "False",
                                                  "OUTPUT_DIR", os.path.join(tmp, "dispnet")],
                       dataset=STEREO_DATASET, static_hw=VIZ_HW, device=STEREO_DEVICE,
                       seed=STEREO_SEED)
    out = res["datasets"][STEREO_DATASET]
    with open(os.path.join(out["out_dir"], "predictions.pkl"), "rb") as f:
        preds = pickle.load(f)
    check_predictions(preds, pred_shapes(res["cfg"]), EVAL_IMAGES)
    del res
    t0 = time.perf_counter()
    paths = visualize.visualize(preds, STEREO_DATASET, os.path.join(tmp, "viz"),
                                limit=EVAL_IMAGES, device=STEREO_DEVICE)
    dt = time.perf_counter() - t0
    if len(paths) != EVAL_IMAGES:
        raise AssertionError(f"visualize wrote {len(paths)} images")
    ds = resolve(STEREO_DATASET, get_default_cfg(), training=False)
    samples = {ds[i]["imgid"]: ds[i] for i in range(len(ds))}
    boxes = 0
    for path in paths:
        imgid = os.path.basename(path)[:-4]
        pred, sample = preds[imgid], samples[imgid]
        if not np.array_equal(read_png(path), visualize.render(sample, pred, STEREO_DEVICE)):
            raise AssertionError(f"{path} read back differs from its drawing")
        # the outlines alone (a later mask or box may cover an earlier outline)
        img = visualize.render(sample, {k: pred[k] for k in ("left_boxes", "scores", "valid")},
                               STEREO_DEVICE)
        rng = np.random.default_rng(0)
        seen = 0
        for i in np.flatnonzero(pred["valid"]):
            color = rng.integers(100, 255, 3).astype(np.uint8)
            x1, y1, x2, y2 = (int(round(v)) for v in pred["left_boxes"][i])
            x1, x2 = max(x1, 0), min(x2, VIZ_HW[1] - 1)
            y1, y2 = max(y1, 0), min(y2, VIZ_HW[0] - 1)
            edge = np.concatenate([img[y1:y2 + 1, x1], img[y1:y2 + 1, x2], img[y1, x1:x2 + 1],
                                   img[y2, x1:x2 + 1]])
            seen += bool((edge == color).all(-1).any())
        if seen != int(pred["valid"].sum()):
            raise AssertionError(f"{path}: {seen} box outlines of {int(pred['valid'].sum())} "
                                 "valid detections")
        boxes += seen
    if not boxes:
        raise AssertionError("visualize: no valid detection to draw")
    log(f"  visualize: {len(paths)} PNGs of the DISPNET_ON predictions in {dt:.2f} s, read back "
        f"by png.py equal to their drawings; the outlines drawn alone: {boxes}, one for each "
        f"valid detection")
    return boxes


def a2_run(card: str, req) -> dict:
    """(e): rcnn.yaml at the headline budget with NMS_TYPE rotate, then with
    RPN_DISTANCE_BASED_PROPOSE: one predict each; the proposal layer's
    inputs of the run re-proposed on the CPU."""
    gen = torch.Generator(device=STEREO_DEVICE).manual_seed(0)
    model2d = init_random_(DispRCNN(**BENCH_2D, device=STEREO_DEVICE), gen)
    out = {}
    for label, opts, nms_3d in A2_RUNS:
        cfg = train_net.load_config(A2_YAML, A2_OPTS + opts)
        model3d = init_random_(build_detection_model(cfg, device=STEREO_DEVICE),
                               torch.Generator(device=STEREO_DEVICE).manual_seed(STEREO_SEED))
        pr = model3d.pointrcnn
        seen = []
        orig = pr.propose

        def propose(rpn_out, **kw):
            res = orig(rpn_out, **kw)
            seen.append(({k: rpn_out[k].detach().clone() for k in ("cls", "reg", "xyz")}, kw,
                         [r.clone() for r in res]))
            return res

        pr.propose = propose
        rotated0 = dict(port_nms.rotated_stats)
        reset_launches()
        try:
            res, ms = bench.timed(lambda: predict(model2d, model3d, *req[:4], calib=CALIB,
                                                  priorities=req[4]), "cuda")
        finally:
            del pr.propose
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_launches().items() if v}
        rot = {k: port_nms.rotated_stats[k] - rotated0[k] for k in rotated0}
        if launches.get("nms_sorted") != EXPECTED_DISPNET["nms_sorted"] + nms_3d \
                or (nms_3d == 0) != (rot["calls"] > 0):
            raise AssertionError(f"{label}: launches {launches}, rotated route {rot}")
        (rpn_out, kw, got), = seen
        fn = rpn3d.distance_propose if pr.rpn_distance_based else rpn3d.propose
        cpu = {k: v.cpu() for k, v in rpn_out.items()}
        want = fn(cpu["cls"], cpu["reg"], cpu["xyz"], pr.anchor.cpu(), pr.rpn_codec,
                  rotated=pr.rpn_nms_rotated, **kw)
        agree = ((got[2].cpu() == want[2]).all(1) & (got[1].cpu() == want[1]).all(1)
                 & ((got[0].cpu() - want[0]).abs().amax((1, 2))
                    <= BOX3D_TOL * (1 + want[0].abs().amax((1, 2)))))
        flips = torch.nonzero(~agree).flatten().tolist()
        explained = [c for c in flips if near_decision(cpu, c, pr, kw)]
        if len(explained) != len(flips) or not want[2].any():
            raise AssertionError(f"{label}: proposals of clouds {flips} differ card vs CPU, "
                                 f"{len(explained)} near a threshold; valid {int(want[2].sum())}")
        out[label] = {"launches": launches, "rotated": rot, "ms": ms, "flips": len(flips)}
        log(f"  {label} (rcnn.yaml, headline budget, {got[2].shape[0]} clouds): a request "
            f"{ms:.3f} ms, {int(got[2].sum())} valid proposals; proposals card vs CPU equal on "
            f"{int(agree.sum())} clouds, {len(flips)} differ, each with an IoU or a z within "
            f"{A2_NEAR} of a decision (C16); row 1 launches {launches['nms_sorted']} "
            f"({nms_3d} of them the proposals'); the rotated route: {rot['calls']} calls, "
            f"{rot['passes']} fixpoint passes, {rot['syncs']} host syncs")
        del model3d, res
        torch.cuda.empty_cache()
    return out


def near_decision(cpu: dict, c: int, pr, kw) -> bool:
    """Cloud c's proposal decisions lie near a threshold: some pair of its
    pre-NMS boxes at an IoU within A2_NEAR of the NMS threshold, or (the
    distance bands) a box within A2_NEAR of a band edge."""
    boxes = rpn3d._decode_bottom(cpu["cls"][c:c + 1], cpu["reg"][c:c + 1], cpu["xyz"][c:c + 1],
                                 pr.anchor.cpu(), pr.rpn_codec)[0]
    top = boxes[torch.sort(cpu["cls"][c], descending=True, stable=True).indices[
        :kw["pre_nms_top_n"]]]
    bev = boxes3d_to_bev(top)
    iou = (pairwise_bev_iou(bev, bev) if pr.rpn_nms_rotated
           else pairwise_iou(bev[:, :4], bev[:, :4], to_remove=0.0))
    near = bool(((iou - kw["nms_thresh"]).abs() < A2_NEAR).any())
    if pr.rpn_distance_based:
        z = boxes[:, 2]
        near |= bool(min((z - e).abs().min() for e in rpn3d.NMS_RANGES) < A2_NEAR)
    return near


def phase_stereo_options(card: str) -> dict:
    """Phase 24: (a) DISPNET_ON eval, (b) DISPNET_ON train, (c) GroupNorm,
    (d) MASK_ON False, (e) A2's proposals, (f) the visualizer (see the
    docstring). -> {row: its launches in these runs}."""
    t0 = time.perf_counter()
    req = bench.make_request(PAIRS, IMG_HW, PAIRS * BENCH_3D["max_det"], BENCH_3D["lift_grid"],
                             STEREO_DEVICE, STEREO_SEED)
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        ev = dispnet_eval(card, req)
        counts["dispnet_eval"] = ev["launches"]
        torch.cuda.empty_cache()
        tr = dispnet_train(card, tmp)
        counts["dispnet_train"] = tr["launches"]
        torch.cuda.empty_cache()
        gn = gn_run(card, req, tmp)
        counts["gn_eval"], counts["gn_train"] = gn["launches"], gn["train_launches"]
        torch.cuda.empty_cache()
        counts["mask_off"] = mask_off_run(card, tmp)
        torch.cuda.empty_cache()
        visualize_run(card, tmp)
        torch.cuda.empty_cache()
        a2 = a2_run(card, req)
        for label, r in a2.items():
            counts[label] = r["launches"]
    log(f"[24/{PHASES}] stereo options and A2 on {card} in {time.perf_counter() - t0:.1f} s")
    rows = dict(ev["rows"], conv3d_train=tr["row8"])
    return {"rows": rows, "counts": counts}


# Phase 25: the models off the stereo path (ROADMAP A6) and the 3D RPN's
# focal and Dice losses, at full width. The single-view models run through
# build_detection_model and their forward (the CLIs refuse them, as the JAX
# package's do), 2 images of 800x1344: INPUT.MIN_SIZE_TEST 800 and
# MAX_SIZE_TEST 1333, padded to a multiple of 32
A6_DEVICE = "cuda"
A6_SEED = 25
A6_IMAGES = 2
A6_HW = (800, 1344)
A6_GT = 4  # GT boxes an image in the train steps
# the bare default config is the mono R-50-C4 (81 classes, RPN 6000 ->
# 1000, 32 detections an image); the FPN body needs a stride a level
A6_MONO = (("R-50-C4", []),
           ("R-50-FPN", ["MODEL.BACKBONE.CONV_BODY", "R-50-FPN", "MODEL.MASK_ON", "True",
                         "MODEL.RPN.ANCHOR_STRIDE", "(4, 8, 16, 32, 64)"]),
           ("R-50-C5", ["MODEL.BACKBONE.CONV_BODY", "R-50-C5"]))
# (c): the C4 train step at the default's RPN train budget (12000 -> 2000
# an image) keeps 4 x 4000 x 28^2 x 1024 floats of ROIAlign taps for the
# backward (51 GB: the proposals keep their coordinates' gradient, as in
# the JAX package); cut to 512 proposals an image, every width kept
A6_TRAIN_OPTS = ["MODEL.RPN.POST_NMS_TOP_N_TRAIN", "512"]
A6_RETINA = ["MODEL.RETINANET_ON", "True", "MODEL.BACKBONE.CONV_BODY", "R-50-FPN-RETINANET"]
A6_FBNET = ["MODEL.BACKBONE.CONV_BODY", "FBNet-FPN"]
A6_FBNET_TRAIN = A6_FBNET + ["MODEL.WEIGHT", "", "SOLVER.PRINT_INTERVAL", "1"]
A6_FBNET_ITERS = 2
A6_RPN_LOSSES = ("SigmoidFocalLoss", "DiceLoss")
# random weights find nothing (C15): the mono box head's class scores are
# redrawn so that their logits spread A6_LOGIT_STD (about 1/3 of the
# proposals then clear SCORE_THRESH 0.05 in some class), and RetinaNet's
# class logits take bias 0 (sigmoid 0.5 against INFERENCE_TH 0.05)
A6_LOGIT_STD = 3.0


def a6_config(opts):
    cfg = get_default_cfg()
    cfg.merge_from_list(list(opts))
    cfg.freeze()
    return cfg


def a6_images(seed: int = A6_SEED):
    return bench.make_request(A6_IMAGES, A6_HW, 1, 1, A6_DEVICE, seed)[0]


def a6_gt(gen: torch.Generator, b: int = A6_IMAGES, m: int = A6_GT, classes: int = 80):
    """(boxes (b, m, 4), labels 1..classes, valid) on the card: boxes of
    80-400 x 60-300 px inside A6_HW, every slot valid."""
    h, w = A6_HW
    u = lambda *s: torch.rand(s, generator=gen, device=A6_DEVICE)
    bw, bh = 80 + 320 * u(b, m), 60 + 240 * u(b, m)
    x1, y1 = (w - bw) * u(b, m), (h - bh) * u(b, m)
    boxes = torch.stack([x1, y1, x1 + bw, y1 + bh], -1)
    labels = (u(b, m) * classes).long().clamp_max(classes - 1) + 1
    return boxes, labels, torch.ones(b, m, dtype=torch.bool, device=A6_DEVICE)


def a6_gt_on_proposals(model, images, draws, gen: torch.Generator):
    """GT boxes that the ROI sampler finds: the first A6_GT train proposals
    of each image (an untrained RPN's proposals match no box drawn at
    random at 0.5), each side moved by up to 5% of its box, labels 1..80."""
    seen = []
    orig = generalized_rcnn.rpn.postprocess_batched

    def record(*args, **kwargs):
        seen.append(orig(*args, **kwargs))
        return seen[-1]

    boxes, labels, valid = a6_gt(gen)
    generalized_rcnn.rpn.postprocess_batched = record
    try:
        with torch.no_grad():
            model(images, boxes, labels, valid, draws=draws)
    finally:
        generalized_rcnn.rpn.postprocess_batched = orig
    props = seen[0]
    p = props.xyxy[:, :A6_GT]
    wh = (p[..., 2:] - p[..., :2]).repeat(1, 1, 2)
    jitter = (torch.rand(p.shape, generator=gen, device=A6_DEVICE) - 0.5) * 0.1 * wh
    return p + jitter, labels, props.valid[:, :A6_GT].clone()


def mono_model(opts, images):
    """The mono model of the default config with `opts`, seeded random
    weights, its class scores redrawn to spread A6_LOGIT_STD on `images`."""
    model = build_detection_model(a6_config(opts), device=A6_DEVICE)
    gen = torch.Generator(device=A6_DEVICE).manual_seed(A6_SEED)
    init_random_(model, gen)
    feats = []
    hook = model.box_head.cls_score.register_forward_pre_hook(
        lambda mod, args: feats.append(args[0].norm(dim=1).mean()))
    with torch.inference_mode():
        model(images[:1])
    hook.remove()
    with torch.no_grad():
        w = model.box_head.cls_score.weight
        w.copy_(torch.randn(w.shape, generator=gen, device=A6_DEVICE) * (A6_LOGIT_STD
                                                                           / float(feats[0])))
    return model


def boxes_equal(a, b, what: str) -> None:
    for f in ("xyxy", "valid"):
        if not torch.equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"{what}: detections' {f} differ, kernels vs plain")
    for f in a.fields:
        if not torch.equal(a.fields[f], b.fields[f]):
            raise AssertionError(f"{what}: detections' {f} differ, kernels vs plain")


def nms_sites(calls, labels) -> list:
    """Row 1's launches of one request, labelled by site in launch order:
    (label, args, valid boxes in)."""
    if len(calls) != len(labels):
        raise AssertionError(f"{len(calls)} row 1 launches, expected {len(labels)} ({labels})")
    sites = []
    for label, a in zip(labels, calls):
        valid = int(a[1].sum())
        if valid == 0:
            raise AssertionError(f"row 1 at {label} {tuple(a[0].shape)}: no valid box entered")
        sites.append((label, a, valid))
    return sites


@torch.inference_mode()
def a6_eval(name: str, model, images, site_labels, run=None) -> dict:
    """One request of `model` on `images`: launches counted from 0, its ms
    and peak memory, row 1's launches captured by site, and the run with
    row 1 on its plain version: detections (and masks) equal."""
    run = run or (lambda: model(images))
    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out, ms = bench.timed(run, "cuda")
    launches = {k: v for k, v in read_launches().items() if v}
    peak = torch.cuda.max_memory_allocated() / 1e9
    if launches != {"nms_sorted": len(site_labels)}:
        raise AssertionError(f"{name}: launches {launches}, expected row 1 "
                             f"{len(site_labels)} times and no other kernel")
    sites = nms_sites(capture_launches(run, dict(nms_sorted_cuda="nms_sorted"))["nms_sorted"],
                      site_labels)
    with all_plain():
        plain = run()
    torch.cuda.synchronize()
    dets = out["detections"]
    if hasattr(dets, "xyxy"):
        boxes_equal(dets, plain["detections"], name)
    else:
        for f in ("left", "right", "score", "valid"):
            if not torch.equal(getattr(dets, f), getattr(plain["detections"], f)):
                raise AssertionError(f"{name}: detections' {f} differ, kernels vs plain")
    if "masks" in out and not torch.equal(out["masks"], plain["masks"]):
        raise AssertionError(f"{name}: masks differ, kernels vs plain")
    n = int(dets.valid.sum())
    finite = all(torch.isfinite(t).all() for t in (
        (dets.xyxy, dets.fields["scores"]) if hasattr(dets, "xyxy") else (dets.left, dets.score)))
    if n == 0 or not finite:
        raise AssertionError(f"{name}: {n} valid detections, finite {finite}")
    log(f"  {name}: a request {ms:.3f} ms, peak {peak:.2f} GB, {n} valid detections of "
        f"{dets.valid.numel()} slots, launches {launches}; row 1's sites "
        + ", ".join(f"{lb} {tuple(a[0].shape[:2])} k={a[2]} with {v} valid boxes"
                    for lb, a, v in sites)
        + "; kernels vs plain: detections" + (" and masks" if "masks" in out else "")
        + " equal")
    return {"launches": launches, "ms": ms, "peak_gb": peak, "sites": sites, "valid": n}


def a6_mono_train(card: str, images) -> dict:
    """(c): one train step of the mono R-50-C4 on 2 images with A6_GT GT
    boxes each and seeded draws, kernels against plain under deterministic
    algorithms; then the step timed."""
    model = mono_model(A6_TRAIN_OPTS, images)
    model.train()
    gen = torch.Generator(device=A6_DEVICE).manual_seed(A6_SEED + 1)
    with torch.no_grad():
        n_anchors = model.rpn_head(
            (model.backbone(images.permute(0, 3, 1, 2).contiguous())[-1],))[0][0][0].numel()
    draws = generalized_rcnn.draw_mono_draws(A6_IMAGES, n_anchors,
                                             model.post_nms_top_n_train, gen, A6_DEVICE)
    gt = a6_gt_on_proposals(model, images, draws, gen)
    params = trainable(model)

    def step():
        model.zero_grad(set_to_none=True)
        out = model(images, *gt, draws=draws)
        sum(out.values()).backward()
        return out

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ms = [bench.timed(step, "cuda")[1] for _ in range(TRAIN_STEPS)]
    launches = {k: v for k, v in read_launches().items() if v}
    peak = torch.cuda.max_memory_allocated() / 1e9
    if launches != {"nms_sorted": TRAIN_STEPS}:
        raise AssertionError(f"mono C4 train step launches {launches}: row 1 once a step")
    with deterministic(), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mk = {k: v.detach() for k, v in step().items()}
        gk = {n: p.grad.clone() for n, p in params.items() if p.grad is not None}
        with all_plain():
            mp = {k: v.detach() for k, v in step().items()}
        gp = {n: p.grad.clone() for n, p in params.items() if p.grad is not None}
    torch.cuda.synchronize()
    bad = [k for k, v in mk.items() if not (torch.isfinite(v) and v > 0)]
    if bad or set(gk) != set(gp) or not gk:
        raise AssertionError(f"mono C4 train step: losses { {k: float(v) for k, v in mk.items()} }, "
                             f"{len(gk)} gradients")
    if all(torch.equal(mk[k], mp[k]) for k in mk) and all(torch.equal(gk[n], gp[n]) for n in gk):
        compared = "the four losses and every gradient bit-equal"
    else:
        ops = sorted({str(w.message).split(" does not have")[0] for w in caught
                      if "deterministic" in str(w.message)})
        for k in mk:
            if abs(float(mk[k]) - float(mp[k])) > STEP_LOSS_RTOL * abs(float(mp[k])):
                raise AssertionError(f"mono C4 step: kernel {k} {float(mk[k])} against plain "
                                     f"{float(mp[k])}")
        compared = (f"not bit-equal (ops without a deterministic CUDA form: {ops or 'none'}); "
                    f"losses within {STEP_LOSS_RTOL:g} relative, gradients per tensor max "
                    f"|diff| <= {grads_agree(gk, gp, 'mono C4 step'):.3g} * max |plain|")
    med = sorted(ms)[len(ms) // 2]
    log(f"  mono R-50-C4 train step ({A6_IMAGES} images of {A6_HW[0]}x{A6_HW[1]}, "
        f"{A6_GT} GT boxes each on its proposals, RPN 12000 -> {model.post_nms_top_n_train} proposals an "
        f"image, {model.roi_batch_per_image} ROIs sampled): ms/step "
        f"{[round(t, 3) for t in ms]} (median {med:.3f}), peak {peak:.2f} GB, losses "
        f"{ {k: round(float(v), 5) for k, v in mk.items()} }, {len(gk)} parameters with "
        f"gradients, launches {launches}; kernel vs plain step: {compared}")
    return {"launches": launches, "ms_per_step": med, "peak_gb": peak}


def a6_retinanet(card: str, images) -> tuple:
    """(d): RetinaNet R-50-FPN (80 classes, 9 anchors a location, P3-P7):
    eval kernels against plain; one train step, losses finite and equal on
    both routes (no kernel runs in its train forward)."""
    model = build_detection_model(a6_config(A6_RETINA), device=A6_DEVICE)
    init_random_(model, torch.Generator(device=A6_DEVICE).manual_seed(A6_SEED))
    with torch.no_grad():
        model.head.cls_logits.bias.zero_()
    ev = a6_eval("RetinaNet R-50-FPN eval", model, images, ["RetinaNet"])
    model.train()
    gt = a6_gt(torch.Generator(device=A6_DEVICE).manual_seed(A6_SEED + 2))
    reset_launches()
    out, ms = bench.timed(lambda: model(images, *gt), "cuda")
    sum(out.values()).backward()
    launches = {k: v for k, v in read_launches().items() if v}
    with all_plain():
        plain = model(images, *gt)
    if launches or not all(torch.isfinite(v) and torch.equal(v, plain[k])
                           for k, v in out.items()):
        raise AssertionError(f"RetinaNet train: launches {launches}, losses "
                             f"{ {k: float(v) for k, v in out.items()} }, plain "
                             f"{ {k: float(v) for k, v in plain.items()} }")
    log(f"  RetinaNet train forward {ms:.3f} ms, losses "
        f"{ {k: round(float(v.detach()), 5) for k, v in out.items()} } (plain route equal), "
        "no kernel")
    return ev, ms


def a6_fbnet(card: str, tmp: str) -> tuple:
    """(e): mask.yaml on FBNet-FPN: a request of 8 pairs, kernels against
    plain (detections and masks); tools/train_net, 2 iterations at mask.yaml's
    batch, FBNet's running statistics unchanged."""
    cfg = train_net.load_config(STEREO_YAML, A6_FBNET)
    model = init_random_(build_detection_model(cfg, device=STEREO_DEVICE),
                         torch.Generator(device=STEREO_DEVICE).manual_seed(A6_SEED))
    req = bench.make_request(PAIRS, IMG_HW, 1, 1, STEREO_DEVICE, A6_SEED)
    ev = a6_eval("mask.yaml on FBNet-FPN eval", model, None, ["SRPN", "box head"],
                 run=lambda: predict_2d(model, req[0], req[1]))
    check_outputs(bench.timed(lambda: predict_2d(model, req[0], req[1]), "cuda")[0], PAIRS,
                  cfg.TPU.MAX_DETECTIONS)
    del model
    torch.cuda.empty_cache()
    cfg = train_net.load_config(STEREO_YAML, A6_FBNET_TRAIN + [
        "OUTPUT_DIR", os.path.join(tmp, "fbnet_train")], A6_FBNET_ITERS)
    model = init_random_(build_detection_model(cfg, device=STEREO_DEVICE),
                         torch.Generator(device=STEREO_DEVICE).manual_seed(A6_SEED))
    stats = {n: b.clone() for n, b in model.backbone.body.named_buffers()}
    reset_launches()
    res = train_net.train(cfg, dataset=STEREO_DATASET, static_hw=IMG_HW, device=STEREO_DEVICE,
                          seed=A6_SEED, model=model)
    launches = check_rows(read_launches(), ("nms_sorted",), "train_net mask.yaml FBNet-FPN")
    for it, m in res["metrics"]:
        if not all(math.isfinite(v) for k, v in m.items() if k.startswith("loss")) \
                or m["skipped_nonfinite"] or m["params_without_grad"]:
            raise AssertionError(f"FBNet train iteration {it}: {m}")
    moved = [n for n, b in model.backbone.body.named_buffers() if not torch.equal(b, stats[n])]
    if moved or res["iters"] != A6_FBNET_ITERS:
        raise AssertionError(f"FBNet train_net: {res['iters']} iterations, running statistics "
                             f"moved: {moved[:3]}")
    log(f"  train_net mask.yaml on FBNet-FPN: {res['iters']} iterations, "
        f"{res['stats']['s_per_iter']:.3f} s/iteration, launches {launches}, losses of the "
        f"last { {k: round(v, 5) for k, v in res['metrics'][-1][1].items() if k.startswith('loss')} }, "
        f"all {len(stats)} FBNet buffers bit-equal (its norms keep running statistics)")
    return ev, launches


def a6_rpn_losses(card: str) -> dict:
    """(f): phase 18's rpn.yaml step with RPN.LOSS_CLS SigmoidFocalLoss and
    DiceLoss: the launches of a step, and the kernel step against the plain
    step on one frozen-stage output."""
    out = {}
    for loss in A6_RPN_LOSSES:
        st = bench_train.rpn_stage(RPN_PAIRS, torch.Generator(device="cuda").manual_seed(14),
                                   cfg=dict(RPN_TRAIN, rpn_loss_cls=loss))
        model, opt, step, batch = st.model, st.optimizer, st.step, st.batch
        step(batch)
        torch.cuda.synchronize()
        reset_launches()
        m, ms = bench.timed(lambda: step(batch), "cuda")
        launches = read_launches()
        needed = ("cost_volume_conv", "conv3d", "conv3d_cl1", "conv3d_s2", "deconv3d", "conv2d",
                  "softargmin", "fps")
        absent = ("nms_sorted", "conv3d_train", "sa", "sa_train", "grouped_mlp", "fp",
                  "roipool3d")
        if any(launches[k] == 0 for k in needed) or any(launches[k] for k in absent):
            raise AssertionError(f"RPN step ({loss}) launches {launches}")
        rel, gk, gp, _, mk, _ = kernel_vs_plain_step(model, opt, step, batch,
                                                     f"RPN step ({loss})",
                                                     share_inputs=model.pointrcnn)
        grad_err = grads_agree(gk, gp, f"RPN step ({loss})")
        cls = float(mk["loss_rpn_cls"])
        if not (math.isfinite(cls) and cls > 0):
            raise AssertionError(f"RPN step ({loss}): loss_rpn_cls {cls}")
        log(f"  rpn.yaml step with RPN.LOSS_CLS {loss}: {ms:.3f} ms, loss_rpn_cls {cls:.5g}, "
            f"loss_rpn_reg {float(mk['loss_rpn_reg']):.5g}, launches "
            f"{ {k: v for k, v in launches.items() if v} }; kernel vs plain step: loss "
            f"{rel:.3g} relative, gradients per tensor max |diff| <= {grad_err:.3g} * max "
            f"|plain|")
        out[loss] = {k: v for k, v in launches.items() if v}
        del st, model, opt, step, batch
        torch.cuda.empty_cache()
    return out


@torch.inference_mode()
def a6_site_rows(sites) -> dict:
    """(g): row 1 at each new site on its own inputs: kernel, device and
    plain ms, bound, valid boxes in."""
    rows = {}
    for label, a, valid in sites:
        r = time_launches("nms_sorted", [(f" {label}", [a], cuda_nms.nms_sorted_cuda,
                                          cuda_nms.nms_sorted_plain, None, nms_work,
                                          lambda g, w: main_path_err("nms_sorted", g, w))],
                          0.0, "nms.cu", "disprcnn_tpu/ops/pallas/nms.py:98")
        rows[label] = {"shape": list(a[0].shape[:2]), "k": a[2], "valid_in": valid,
                       **{k: r[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                            "bound_by")}}
    return rows


def phase_single_view(card: str) -> dict:
    """Phase 25: (a) the mono R-50-C4 of the bare default config, (b) the
    mono R-50-FPN with MASK_ON and R-50-C5, (c) a mono C4 train step, (d)
    RetinaNet, (e) mask.yaml on FBNet-FPN, (f) the rpn.yaml step with the
    focal and Dice losses, (g) row 1 at each new site. -> {"sites": row 1's
    site rows, "counts": {run: launches}}."""
    t0 = time.perf_counter()
    images = a6_images()
    counts, sites = {}, []
    for name, opts in A6_MONO:
        model = mono_model(opts, images)
        ev = a6_eval(f"mono {name} eval", model, images,
                     [f"mono {name} RPN", f"mono {name} per-class"])
        counts[f"mono {name}"] = ev["launches"]
        sites += ev["sites"]
        del model, ev
        torch.cuda.empty_cache()
    tr = a6_mono_train(card, images)
    counts["mono R-50-C4 train step"] = tr["launches"]
    torch.cuda.empty_cache()
    ev, _ = a6_retinanet(card, images)
    counts["RetinaNet"] = ev["launches"]
    sites += ev["sites"]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ev, tl = a6_fbnet(card, tmp)
    counts["FBNet-FPN mask.yaml"], counts["FBNet-FPN train_net"] = ev["launches"], tl
    sites += [(f"FBNet-FPN {lb}", a, v) for lb, a, v in ev["sites"]]
    torch.cuda.empty_cache()
    for loss, launches in a6_rpn_losses(card).items():
        counts[f"rpn.yaml {loss}"] = launches
    rows = a6_site_rows(sites)
    del sites
    torch.cuda.empty_cache()
    log(f"[25/{PHASES}] single-view models and the 3D RPN's losses on {card} in "
        f"{time.perf_counter() - t0:.1f} s")
    return {"sites": rows, "counts": counts}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        t_start = time.perf_counter()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        card = card_line()
        log(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")
        build_s = phase_build()
        errs = {"nms_sorted": phase_nms_compare(), **phase_3d_compare(),
                **phase_points_compare(), **phase_grouped_mlp_compare()}

        model2d, model3d = bench.build_models("cuda")
        # REQUESTS headline requests and one reference request
        requests = [bench.make_request(PAIRS, IMG_HW, PAIRS * BENCH_3D["max_det"],
                                       BENCH_3D["lift_grid"], "cuda", seed)
                    for seed in range(REQUESTS + 1)]
        outs, runs, ms, launches, _ = phase_main_path(model2d, model3d, requests)
        phase_plain_path(model2d, model3d, runs, outs)
        ref = outs[0]  # requests[0] at the headline budget, default route
        del outs
        phase_small_references()
        rows = phase_timing(model2d, model3d, requests[0], errs)
        stages = phase_breakdown(model2d, model3d, (requests[1], requests[-1]), card)
        kernels = [{**rows[name], "launches": launches[name]} for name in EXPECTED_LAUNCHES]
        kernels.append(phase_sa_off(model2d, model3d, requests[0], ref, stages["headline"],
                                    errs["grouped_mlp"], card))
        del ref
        phase_bench(model2d, model3d, card)
        del model2d, model3d, requests, runs
        torch.cuda.empty_cache()
        train_errs = {"conv3d_train": phase_conv_train_compare(),
                      "sa_train": phase_sa_train_compare()}
        psm = phase_psm_train(card)
        pc = phase_pc_train(card)
        rows = phase_train_timing(psm, pc, train_errs, card)
        kernels += [{**rows["conv3d_train"], "launches": psm["launches"]["conv3d_train"]},
                    {**rows["sa_train"], "launches": pc["launches"]["sa_train"]}]
        del psm, pc
        torch.cuda.empty_cache()
        phase_rpn_train(card)
        torch.cuda.empty_cache()
        det2d = phase_2d_train(card)
        row1 = next(r for r in kernels if r["name"] == "nms_sorted")
        row1.update(train_2d_launches=det2d["launches"], train_2d=det2d)
        del det2d
        torch.cuda.empty_cache()
        phase_eval_entry(card)
        torch.cuda.empty_cache()
        entry = phase_train_entry(card)
        for row in kernels:
            row["train_entry_launches"] = {run: c[row["name"]] for run, c in entry.items()
                                           if c.get(row["name"])}
        torch.cuda.empty_cache()
        dist = phase_dist(card)
        for row in kernels:
            row["dist_launches"] = {run: c[row["name"]] for run, c in dist.items()
                                    if c.get(row["name"])}
        torch.cuda.empty_cache()
        user = phase_user_files(card)
        for row in kernels:
            if user.get(row["name"]):
                row["mini_kitti_launches"] = user[row["name"]]
        torch.cuda.empty_cache()
        stereo = phase_stereo_options(card)
        for row in kernels:
            row["stereo_options_launches"] = {run: c[row["name"]]
                                              for run, c in stereo["counts"].items()
                                              if c.get(row["name"])}
            if row["name"] in stereo["rows"]:
                r = stereo["rows"][row["name"]]
                row["stereo_options"] = {k: r[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err",
                    "launch_ms", "device_ms")}
        torch.cuda.empty_cache()
        a6 = phase_single_view(card)
        for row in kernels:
            row["a6_launches"] = {run: c[row["name"]] for run, c in a6["counts"].items()
                                  if c.get(row["name"])}
        row1["a6_sites"] = a6["sites"]
        log(f"done in {time.perf_counter() - t_start:.1f} s (build {build_s:.1f} s)")
    except Exception:  # report any phase's failure and exit non-zero
        traceback.print_exc()
        sys.stdout.flush()
        return 1
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        sys.exit(dist_worker(*sys.argv[2:4]))
    sys.exit(main())
