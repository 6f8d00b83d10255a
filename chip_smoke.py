#!/usr/bin/env python3
"""Smoke run of the PyTorch port (disprcnn_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each ending in torch.cuda.synchronize() and one progress line:
  1. build every CUDA kernel of the path (csrc/nms.cu, conv3d.cu,
     softargmin.cu), one nvcc per source, all at once, into
     disprcnn_tpu_torch/csrc/build/ (listed in .gitignore);
  2. the greedy-NMS kernel against its plain PyTorch version at the SRPN
     call (8, 6000) k=300 IoU 0.7 and the box head's (8, 300) k=16 IoU 0.5,
     on random, clustered, duplicate, tied-score, all-invalid-row and
     few-survivor inputs: indices and flags equal;
  3. the iDispNet kernels against their plain versions at every shape the
     main path gives them, on seeded random inputs: the tower's 2D conv
     (32 channels at 112^2, 64 at 56^2; with and without residual and
     ReLU), the cost-volume conv, the stride-1 3D conv (56^2, 28^2, 14^2;
     with and without residual and ReLU), its 32 -> 1 classifier form, the
     stride-2 and the transposed 3D convs of the hourglasses and the
     soft-argmin;
  4. the main path: predict answers 2 requests of 8 stereo pairs at
     384x1248 (R-101 2D detector, then iDispNet over 16 ROIs of 224^2 per
     pair, disparity -48..48; random weights from a seeded
     torch.Generator), timed with CUDA events, with every kernel's
     launches counted from 0 over exactly these requests;
  5. the same requests with every kernel's launch point routed to its
     plain version on the card: detections and masks equal, disparity
     within DISP_TOL_PX;
  6. small references: the R-50 2D test configuration at 64x128, and a
     small DispRCNN3D (2 ROIs of 64^2, disparity -16..16), on the CPU
     (plain versions) and on the card (kernels), to stated tolerances;
  7. each kernel timed on the inputs the main path gave it in one request,
     beside its plain version, the one PyTorch call that computes the same
     function where there is one (cuDNN free to pick non-deterministic
     algorithms), and the bound of the work (the
     operations the function needs: products with padding or with the
     cost volume's empty columns are not counted);
  8. where a request's time goes: one request split into stages (2D
     detector, crops, feature tower, cost volume + dres, hourglasses,
     classifiers + regression) by CUDA events that forward hooks record;
     then the same request timed with cuDNN (the 2D detector and the
     tower's other convs) free to pick non-deterministic algorithms.
Then it prints the card (name, power limit) from nvidia-smi, one JSON line
of per-kernel numbers (per request), and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or on any failure, it exits non-zero and prints no
result. Float32 throughout with TF32 off and deterministic cuDNN.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import traceback

import torch
import torch.nn.functional as F

from disprcnn_tpu_torch.engine.inference import predict, predict_2d
from disprcnn_tpu_torch.models.detector.disprcnn import DispRCNN
from disprcnn_tpu_torch.models.detector.disprcnn3d import DispRCNN3D
from disprcnn_tpu_torch.ops import nms as port_nms
from disprcnn_tpu_torch.ops.cuda import build
from disprcnn_tpu_torch.ops.cuda import conv3d as cconv
from disprcnn_tpu_torch.ops.cuda import nms as cuda_nms
from disprcnn_tpu_torch.ops.cuda import softargmin as csam
from disprcnn_tpu_torch.structures.stereo import StereoBoxes
from disprcnn_tpu_torch.utils.weights import init_random_

PHASES = 8
IMG_HW = (384, 1248)  # KITTI network input (bench.py:_time_pipeline)
PAIRS = 8
REQUESTS = 2
# bench.py:294-298, in float32
BENCH_2D = dict(body="R-101", pre_nms_top_n_test=6000, post_nms_top_n_test=300,
                max_det=16, detections_per_img=16)
# bench.py:299-305 and configs/kitti/car/vob/idispnet.yaml (DET3D_ON: False)
BENCH_3D = dict(max_det=16, roi_size=224, maxdisp=48, mindisp=-48)
# the tests' small configurations (tests/torch_port_helpers.py, tests/test_torch_disprcnn3d.py)
SMALL_2D = dict(body="R-50", out_channels=32, mlp_head_dim=64, pre_nms_top_n_test=200,
                post_nms_top_n_test=48, max_det=8, detections_per_img=8)
SMALL_3D = dict(max_det=2, roi_size=64, maxdisp=16, mindisp=-16)
# BGR255 mean-subtracted input of the 2D detector (bench.py, data/transforms.py)
PIXEL_MEAN_BGR = (102.9801, 115.9465, 122.7717)
NMS_CASES = ("random", "clustered", "duplicates", "ties", "invalid_rows", "few_survivors")
NMS_SHAPES = ((6000, 300, 0.7), (300, 16, 0.5))  # (N, k, IoU) of SRPN and box head
# Kernel launches per request on the main path (the kernel table of PERF.md)
# (the tower's 2D conv: ConvBN_1, ConvBN_2, layer1's 6, layer2's 31, over
# both views at once; 2 stride-2 and 2 transposed convs per hourglass)
EXPECTED_LAUNCHES = {"nms_sorted": 2, "conv2d": 39, "cost_volume_conv": 1, "conv3d": 12,
                     "conv3d_cl1": 3, "conv3d_s2": 6, "deconv3d": 6, "softargmin": 1}
# Tolerances, fixed before the first card run of these kernels:
# a conv kernel against its plain version (cuDNN, TF32 off) sums the same
# products in another order: max |diff| <= CONV_RTOL * max |plain| + CONV_ATOL;
CONV_RTOL, CONV_ATOL = 1e-4, 1e-5
# the soft-argmin kernel interpolates H and W before D and takes the
# softmax online: max |diff| <= 1e-3 px;
SOFTARGMIN_TOL_PX = 1e-3
# disparity of a whole forward, kernels against plain versions (phase 5)
# or card against CPU (phase 6): the differences above through ~20 3D conv
# layers and a softmax over 96 (32) disparities: max |diff| <= 1e-2 px.
DISP_TOL_PX = 1e-2
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
IOU_OPS = 17  # float ops of one IoU and its threshold test (nms.cu box_iou)
# soft-argmin: ops per (pixel, logit slice) of the bilinear H/W taps, and per
# (pixel, disparity) of the D interpolation, exp, running max and two sums
SAM_TAP_OPS, SAM_DISP_OPS = 8, 8


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build() -> float:
    names = ("nms", "conv3d", "softargmin")
    t0 = time.perf_counter()
    texts = build.build(*names)
    dt = time.perf_counter() - t0
    for name in names:
        for line in texts[name].splitlines():
            if "registers" in line or "bytes stack" in line:
                log(f"  ptxas {name}: {line.strip()}")
    # load them: a library that does not load fails here
    cuda_nms._lib(), cconv._lib(), csam._lib()
    torch.cuda.synchronize()
    log(f"[1/{PHASES}] build: {', '.join(n + '.cu' for n in names)} with nvcc in {dt:.1f} s")
    return dt


@contextlib.contextmanager
def launches_replaced(**fns):
    """Route the named launch points (nms_sorted_cuda, conv3d_bn_cuda,
    cost_volume_conv_bn_cuda, deconv3d_bn_cuda, conv2d_bn_cuda,
    softargmin_cuda) through the given functions; yields the original
    launches by name."""
    modules = {"nms_sorted_cuda": cuda_nms, "conv3d_bn_cuda": cconv,
               "cost_volume_conv_bn_cuda": cconv, "deconv3d_bn_cuda": cconv,
               "conv2d_bn_cuda": cconv, "softargmin_cuda": csam}
    orig = {name: getattr(modules[name], name) for name in fns}
    for name, fn in fns.items():
        setattr(modules[name], name, fn)
    try:
        yield orig
    finally:
        for name, fn in orig.items():
            setattr(modules[name], name, fn)


def all_plain():
    return launches_replaced(nms_sorted_cuda=cuda_nms.nms_sorted_plain,
                             conv3d_bn_cuda=cconv.conv3d_bn_plain,
                             cost_volume_conv_bn_cuda=cconv.cost_volume_conv_bn_plain,
                             deconv3d_bn_cuda=cconv.deconv3d_bn_plain,
                             conv2d_bn_cuda=cconv.conv2d_bn_plain,
                             softargmin_cuda=csam.softargmin_plain)


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
    for n, k, thresh in NMS_SHAPES:
        for kind in NMS_CASES:
            boxes, scores, valid = nms_case(kind, PAIRS, n, gen)
            ki, kok = port_nms.nms_topk_batched(boxes, scores, valid, thresh, k)
            with launches_replaced(nms_sorted_cuda=cuda_nms.nms_sorted_plain):
                pi, pok = port_nms.nms_topk_batched(boxes, scores, valid, thresh, k)
            torch.cuda.synchronize()
            err = float((ki - pi).abs().max())
            if not (torch.equal(kok, pok) and err == 0):
                raise AssertionError(f"NMS kernel != plain at N={n} k={k} {kind}: "
                                     f"max |idx diff| {err}, flags equal {torch.equal(kok, pok)}")
            worst = max(worst, err)
            log(f"  nms N={n} k={k} iou={thresh} {kind}: equal, {int(kok.sum())} kept")
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

    errs = {k: 0.0 for k in EXPECTED_LAUNCHES if k != "nms_sorted"}

    def check(name, what, got, want):
        e = conv_err(got, want, what)
        errs[name] = max(errs[name], e)
        log(f"  {name} {what} -> {tuple(got.shape)}: max |diff| {e:.3g} "
            f"(max |plain| {float(want.abs().max()):.3g})")

    # the tower's 3x3 stride-1 convs: (channels, side, residual, relu)
    for c, s, res, relu in ((32, 2 * q, False, True), (32, 2 * q, True, False),
                            (64, q, False, True), (64, q, True, False)):
        x = randn(2 * r, c, s, s)
        w = randn(c, c, 3, 3, scale=0.05)
        mul, add = affine(c)
        rt = randn(2 * r, c, s, s) if res else None
        check("conv2d", f"{tuple(x.shape)} residual={res} relu={relu}",
              cconv.conv2d_bn_cuda(x, w, mul, add, rt, relu),
              cconv.conv2d_bn_plain(x, w, mul, add, rt, relu))
        del x, rt
    left, right = randn(r, 32, q, q), randn(r, 32, q, q)
    w = randn(32, 64, 3, 3, 3, scale=0.05)
    mul, add = affine(32)
    check("cost_volume_conv", f"{tuple(left.shape)} x2",
          cconv.cost_volume_conv_bn_cuda(left, right, w, mul, add, -12, 12),
          cconv.cost_volume_conv_bn_plain(left, right, w, mul, add, -12, 12))
    del left, right
    # (channels, depth, side, residual, relu) of the trunk's stride-1 sites
    for c, d, s, res, relu in ((32, d4, q, False, True), (32, d4, q, True, False),
                               (64, d4 // 2, q // 2, True, True),
                               (64, d4 // 2, q // 2, False, True),
                               (64, d4 // 4, q // 4, False, True)):
        x = randn(r, c, d, s, s)
        w = randn(c, c, 3, 3, 3, scale=0.05)
        mul, add = affine(c)
        rt = randn(r, c, d, s, s) if res else None
        check("conv3d", f"{tuple(x.shape)} residual={res} relu={relu}",
              cconv.conv3d_bn_cuda(x, w, mul, add, rt, relu),
              cconv.conv3d_bn_plain(x, w, mul, add, rt, relu))
        del x, rt
    x = randn(r, 32, d4, q, q)
    w = randn(1, 32, 3, 3, 3, scale=0.05)
    check("conv3d_cl1", f"{tuple(x.shape)}", cconv.conv3d_bn_cuda(x, w),
          cconv.conv3d_bn_plain(x, w))
    # the hourglass's stride-2 convs (32 -> 64 at 56^2, 64 -> 64 at 28^2)
    for ci, d, s in ((32, d4, q), (64, d4 // 2, q // 2)):
        x = randn(r, ci, d, s, s)
        w = randn(64, ci, 3, 3, 3, scale=0.05)
        mul, add = affine(64)
        check("conv3d_s2", f"{tuple(x.shape)}",
              cconv.conv3d_bn_cuda(x, w, mul, add, None, True, 2),
              cconv.conv3d_bn_plain(x, w, mul, add, None, True, 2))
    del x
    # its transposed convs (64 -> 64 from 14^2 with residual and ReLU,
    # 64 -> 32 from 28^2 with residual)
    for co, d, s, relu in ((64, d4 // 4, q // 4, True), (32, d4 // 2, q // 2, False)):
        x = randn(r, 64, d, s, s)
        w = randn(64, co, 3, 3, 3, scale=0.05)
        mul, add = affine(co)
        rt = randn(r, co, 2 * d, 2 * s, 2 * s)
        check("deconv3d", f"{tuple(x.shape)} relu={relu}",
              cconv.deconv3d_bn_cuda(x, w, mul, add, rt, relu),
              cconv.deconv3d_bn_plain(x, w, mul, add, rt, relu))
        del x, rt
    logits = randn(r, d4, q, q, scale=3.0)
    size = (BENCH_3D["roi_size"],) * 2
    disp = BENCH_3D["mindisp"], BENCH_3D["maxdisp"]
    got = csam.softargmin_cuda(logits, size, *disp)
    errs["softargmin"] = sam_err(got, csam.softargmin_plain(logits, size, *disp), "softargmin")
    log(f"  softargmin {tuple(logits.shape)} -> {tuple(got.shape)}: max |diff| "
        f"{errs['softargmin']:.3g} px")
    torch.cuda.synchronize()
    log(f"[3/{PHASES}] iDispNet kernels match their plain versions at the main path's shapes")
    return errs


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


def reset_launches() -> None:
    cuda_nms.launches = 0
    csam.launches = 0
    for k in cconv.launches:
        cconv.launches[k] = 0


def read_launches() -> dict:
    return {"nms_sorted": cuda_nms.launches, **cconv.launches, "softargmin": csam.launches}


def phase_main_path(model2d, model3d, requests):
    outs, ms = [], []
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for req in requests:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = predict(model2d, model3d, *req)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        outs.append(out)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = {k: n * len(requests) for k, n in EXPECTED_LAUNCHES.items()}
    if launches != expected:
        raise AssertionError(f"kernel launches on the main path {launches}, expected {expected}")
    valid = [check_outputs(o, PAIRS, BENCH_2D["max_det"]) for o in outs]
    for o in outs:
        check_disparity(o["disparity_roi"], PAIRS, BENCH_3D)
    spread = [(round(float(o["disparity_roi"].min()), 3), round(float(o["disparity_roi"].max()), 3))
              for o in outs]
    log(f"[4/{PHASES}] predict {BENCH_2D['body']} {PAIRS}x{IMG_HW[0]}x{IMG_HW[1]} -> "
        f"{PAIRS * BENCH_3D['max_det']} ROIs of {BENCH_3D['roi_size']}^2: request ms "
        f"{[round(t, 3) for t in ms]}, valid detections {valid}, disparity range {spread}, "
        f"launches {launches}, peak memory {peak_gb:.2f} GB")
    return outs, ms, launches, peak_gb


def phase_plain_path(model2d, model3d, requests, kernel_outs) -> float:
    worst = 0.0
    for i, (req, ref) in enumerate(zip(requests, kernel_outs)):
        with all_plain():
            out = predict(model2d, model3d, *req)
        torch.cuda.synchronize()
        a, b = out["detections"], ref["detections"]
        same = all(torch.equal(getattr(a, f), getattr(b, f))
                   for f in ("left", "right", "score", "valid"))
        same = same and torch.equal(a.fields["labels"], b.fields["labels"])
        same = same and torch.equal(out["masks"], ref["masks"])
        if not same:
            raise AssertionError(f"request {i}: plain-path detections differ from the kernels'")
        err = float((out["disparity_roi"] - ref["disparity_roi"]).abs().max())
        if not err <= DISP_TOL_PX:
            raise AssertionError(f"request {i}: plain-path disparity off by {err} px")
        worst = max(worst, err)
    log(f"[5/{PHASES}] plain versions on the card: detections and masks equal, disparity "
        f"within {worst:.3g} px on {len(requests)} requests")
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


def phase_small_references() -> float:
    errs = small_2d_reference()
    err3 = small_3d_reference()
    log(f"[6/{PHASES}] small references, card vs CPU: 2D (R-50, 2x64x128) max abs error {errs}; "
        f"DispRCNN3D (2 ROIs of 64^2) disparity {err3:.3g} px")
    return err3


def capture_launches(model2d, model3d, req):
    """The arguments of every kernel launch of one request, by kernel."""
    calls = {k: [] for k in EXPECTED_LAUNCHES}

    def recorder(kernel, launch_name, name_of=None):
        def record(*args):
            calls[name_of(args) if name_of else kernel].append(
                tuple(a.clone() if torch.is_tensor(a) else a for a in args))
            return orig[launch_name](*args)
        return record

    def conv_name(args):
        if args[6] == 2:
            return "conv3d_s2"
        return "conv3d_cl1" if args[1].shape[0] == 1 else "conv3d"

    with launches_replaced(
            nms_sorted_cuda=recorder("nms_sorted", "nms_sorted_cuda"),
            conv3d_bn_cuda=recorder(None, "conv3d_bn_cuda", conv_name),
            cost_volume_conv_bn_cuda=recorder("cost_volume_conv", "cost_volume_conv_bn_cuda"),
            deconv3d_bn_cuda=recorder("deconv3d", "deconv3d_bn_cuda"),
            conv2d_bn_cuda=recorder("conv2d", "conv2d_bn_cuda"),
            softargmin_cuda=recorder("softargmin", "softargmin_cuda")) as orig:
        predict(model2d, model3d, *req)
    torch.cuda.synchronize()
    return calls


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def cudnn_free():
    """cuDNN free to pick non-deterministic algorithms (the rest of the
    script keeps it deterministic, so that kernel and plain runs of the
    cuDNN layers compare exactly): the library yardstick and phase 8's
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
    """As conv_work over the cost volume, counting only its non-zero
    inputs: slice z (disparity i = mind4 + z) holds W - |i| columns."""
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


def softargmin_work(args, out):
    logits, _, mindisp, maxdisp = args
    b, d4 = logits.shape[:2]
    pixels = out.numel()
    nbytes = 4 * (logits.numel() + pixels)
    return bound(nbytes, pixels * (SAM_TAP_OPS * d4 + SAM_DISP_OPS * (maxdisp - mindisp)))


def phase_timing(model2d, model3d, req, compare_errs):
    """Each kernel on one request's own inputs: kernel, plain version and
    library call summed over the request's launches, with the bound."""
    calls = capture_launches(model2d, model3d, req)
    pc = "disprcnn_tpu/ops/pallas/packed_conv.py"
    kinds = {
        "nms_sorted": (cuda_nms.nms_sorted_cuda, cuda_nms.nms_sorted_plain, None, nms_work,
                       "nms.cu", "disprcnn_tpu/ops/pallas/nms.py:32"),
        "conv2d": (cconv.conv2d_bn_cuda, cconv.conv2d_bn_plain,
                   lambda a: F.conv2d(a[0], a[1], padding=1), conv_work, "conv3d.cu",
                   f"{pc}:147"),
        "cost_volume_conv": (cconv.cost_volume_conv_bn_cuda, cconv.cost_volume_conv_bn_plain,
                             None, cost_volume_work, "conv3d.cu", f"{pc}:37"),
        "conv3d": (cconv.conv3d_bn_cuda, cconv.conv3d_bn_plain,
                   lambda a: F.conv3d(a[0], a[1], padding=1), conv_work, "conv3d.cu",
                   f"{pc}:461"),
        "conv3d_cl1": (cconv.conv3d_bn_cuda, cconv.conv3d_bn_plain,
                       lambda a: F.conv3d(a[0], a[1], padding=1), conv_work, "conv3d.cu",
                       f"{pc}:461"),
        "conv3d_s2": (cconv.conv3d_bn_cuda, cconv.conv3d_bn_plain,
                      lambda a: F.conv3d(a[0], a[1], stride=2, padding=1), conv_work,
                      "conv3d.cu", f"{pc}:239"),
        "deconv3d": (cconv.deconv3d_bn_cuda, cconv.deconv3d_bn_plain,
                     lambda a: F.conv_transpose3d(a[0], a[1], stride=2, padding=1,
                                                  output_padding=1),
                     lambda a, o: conv_work(a, o, transposed=True), "conv3d.cu", f"{pc}:342"),
        "softargmin": (csam.softargmin_cuda, csam.softargmin_plain, None, softargmin_work,
                       "softargmin.cu", "disprcnn_tpu/ops/pallas/softargmin.py:47"),
    }
    rows = {}
    for name, (kernel, plain, library, work, src, replaces) in kinds.items():
        if len(calls[name]) != EXPECTED_LAUNCHES[name]:
            raise AssertionError(f"{name}: {len(calls[name])} launches in one request, "
                                 f"expected {EXPECTED_LAUNCHES[name]}")
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0 if library else None, t_bytes=0.0,
                   t_ops=0.0, bound_ms=0.0)
        err = compare_errs.get(name, 0.0)
        for args in calls[name]:
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            if name == "nms_sorted":
                e = float((got[0] - want[0]).abs().max())
                if e != 0 or not torch.equal(got[1], want[1]):
                    raise AssertionError("NMS kernel != plain on the main path's inputs")
            elif name == "softargmin":
                e = sam_err(got, want, "softargmin on the main path")
            else:
                e = conv_err(got, want, f"{name} on the main path")
            err = max(err, e)
            t_bytes, t_ops = work(args, got)
            del got, want
            ms = time_ms(lambda: kernel(*args), 5)
            plain_ms = time_ms(lambda: plain(*args), 2)
            lib_ms = None
            if library:
                with cudnn_free():
                    lib_ms = time_ms(lambda: library(args), 3)
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            if library:
                tot["library_ms"] += lib_ms
            tot["t_bytes"] += t_bytes
            tot["t_ops"] += t_ops
            tot["bound_ms"] += max(t_bytes, t_ops)
            shape = tuple(args[0].shape)
            log(f"  {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound {max(t_bytes, t_ops):.4f} "
                f"ms ({'bytes' if t_bytes >= t_ops else 'operations'})")
        rows[name] = dict(
            name=name, route="cuda", source=f"disprcnn_tpu_torch/csrc/{src}", replaces=replaces,
            max_abs_err=err, ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
            bound_by="bytes" if tot["t_bytes"] > tot["t_ops"] else "operations",
            library_ms=tot["library_ms"])
        log(f"  {name}, per request ({len(calls[name])} launches): kernel {tot['ms']:.4f} ms, "
            f"plain {tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms")
    log(f"[7/{PHASES}] kernels timed on one request's own inputs")
    return rows


def phase_breakdown(model2d, model3d, req) -> dict:
    """One request split into stages by CUDA events recorded at stage
    boundaries (module forward hooks; nothing of the forward is copied);
    then the same request with cuDNN free to pick non-deterministic
    algorithms for the convs left to it."""
    psm = model3d.idispnet
    marks = []  # (name of the stage that ends here, event)

    def mark(name):
        def record(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))
        return record

    hooks = [model3d.register_forward_pre_hook(mark("2D detector")),
             psm.feature_extraction.register_forward_pre_hook(mark("crops")),
             psm.feature_extraction.register_forward_hook(mark("feature tower")),
             psm.dres2.register_forward_pre_hook(mark("cost volume + dres")),
             psm.classif1_0.register_forward_pre_hook(mark("hourglasses")),
             model3d.register_forward_hook(mark("classifiers + regression"))]
    try:
        mark("start")()
        predict(model2d, model3d, *req)
        mark("reshape")()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    stages = {name: prev.elapsed_time(ev) for (_, prev), (name, ev) in zip(marks, marks[1:])}
    total = marks[0][1].elapsed_time(marks[-1][1])
    with cudnn_free():
        free_ms = [time_ms(lambda: predict(model2d, model3d, *req), 1) for _ in range(2)]
    log(f"[8/{PHASES}] one request, {total:.3f} ms: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items())
        + f"; the same request with non-deterministic cuDNN: {[round(t, 3) for t in free_ms]} ms")
    return stages


def make_requests(gen: torch.Generator):
    """(left, right, left_raw, right_raw) per request: raw [0, 1] RGB for
    the 3D stage, BGR255 mean-subtracted for the 2D detector (as bench.py)."""
    h, w = IMG_HW
    mean = torch.tensor(PIXEL_MEAN_BGR, device="cuda")
    reqs = []
    for _ in range(REQUESTS):
        raw = [torch.rand(PAIRS, h, w, 3, generator=gen, device="cuda") for _ in range(2)]
        net = [r.flip(-1) * 255.0 - mean for r in raw]
        reqs.append((net[0], net[1], raw[0], raw[1]))
    return reqs


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
        errs = {"nms_sorted": phase_nms_compare(), **phase_3d_compare()}

        gen = torch.Generator(device="cuda").manual_seed(0)
        model2d = init_random_(DispRCNN(**BENCH_2D, device="cuda"), gen)
        model3d = init_random_(DispRCNN3D(**BENCH_3D, device="cuda"), gen)
        requests = make_requests(gen)
        outs, ms, launches, _ = phase_main_path(model2d, model3d, requests)
        phase_plain_path(model2d, model3d, requests, outs)
        del outs
        phase_small_references()
        rows = phase_timing(model2d, model3d, requests[0], errs)
        phase_breakdown(model2d, model3d, requests[1])
        kernels = [{**rows[name], "launches": launches[name]} for name in EXPECTED_LAUNCHES]
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
    sys.exit(main())
