"""Benchmark of the port: end-to-end stereo pipeline throughput on one
NVIDIA card (counterpart of bench.py).

    python -m disprcnn_tpu_torch.bench [--pairs 8] [--budgets headline,reference]
        [--train psm,pc] [--kernels-off sa] [--device cuda]

1. The canary: each of the 15 kernel rows of PERF.md's table at tiny
   shapes against its plain PyTorch version (bench.py:_canary_kernels). A
   crash or a mismatch raises and the bench exits non-zero: the JAX bench
   disables a failing family and carries on, which would time a path
   without its kernel.
2. The eval pipeline of bench.py:_time_pipeline through ``predict``: R-101
   DispRCNN on `pairs` stereo pairs of 384x1248, then DispRCNN3D (iDispNet
   on 16 ROIs of 224² per pair, the lift to 768 points, PointRCNN) at each
   3D budget of bench.py:268-271; random weights from a seeded generator.
   ITERS requests after one warm-up, each timed with CUDA events; the
   median and the min-max spread of ms per request, and pairs/s at the
   median.
3. The train stages (tools/bench_train.py): the iDispNet step (``psm``)
   and the RCNN step (``pc``) at bench.py's pairs a step, and on request
   (``--train 2d``) the 2D mask-stage step at 4 pairs, TRAIN_ITERS steps
   after one warm-up: ms per step, crops/s or pairs/s.

Float32 with TF32 off, as the port is held to its plain versions. Prints
one JSON line last: the metric of bench.py (pairs/s at the reference
budget, or at the first budget asked for), its ratio to the reference's
3.93 pairs/s per GPU, the card's name and power limit from nvidia-smi,
``kernels_off`` (the PointNet++ families routed off, as
DISPRCNN_PALLAS_DISABLE; a route the caller asks for, never a reaction to
a failure), and every budget's and train stage's numbers. A failed budget
or train stage exits non-zero. ``--device cpu`` runs the same on the CPU
(the plain versions), as a smoke test only: its times are host times.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from .engine.inference import predict
from .models.detector.disprcnn import DispRCNN
from .models.detector.disprcnn3d import DispRCNN3D
from .models.pointrcnn.pointnet2 import kernel_tags, set_kernels_off
from .ops.cuda import conv3d as cconv
from .ops.cuda import fp as cfp
from .ops.cuda import fps as cfps
from .ops.cuda import grouped_mlp as cgm
from .ops.cuda import nms as cnms
from .ops.cuda import roipool3d as croi
from .ops.cuda import sa as csa
from .ops.cuda import softargmin as csam
from .utils.weights import init_random_

# the reference evaluates KITTI val (3769 pairs) in ~2 min on 8 GPUs
# (bench.py:28)
BASELINE_PAIRS_PER_SEC_PER_GPU = 3769 / 120.0 / 8.0
IMG_HW = (384, 1248)  # KITTI network input (bench.py:_time_pipeline)
# bench.py:294-298, in float32
BENCH_2D = dict(body="R-101", pre_nms_top_n_test=6000, post_nms_top_n_test=300,
                max_det=16, detections_per_img=16)
# bench.py:299-305 and configs/kitti/car/vob/rcnn.yaml (DET3D_ON: True)
BENCH_3D = dict(max_det=16, roi_size=224, maxdisp=48, mindisp=-48, det3d_on=True, npoints=768,
                lift_grid=112, sa_npoints=(768, 512, 256, 64))
# the two 3D budgets of bench.py:268-271; the RCNN runs every post-NMS
# proposal at eval, so its ROIs per instance equal post_nms
BUDGETS = {"headline": dict(rpn_pre_nms_per_roi=128, proposals_per_roi=16),
           "reference": dict(rpn_pre_nms_per_roi=768, proposals_per_roi=100)}
# bench.py:312-317
CALIB = dict(fu=721.5, fv=721.5, cu=IMG_HW[1] / 2.0, cv=IMG_HW[0] / 2.0, tx=0.0, ty=0.0,
             fuxb=389.6)
# BGR255 mean-subtracted input of the 2D detector (bench.py, data/transforms.py)
PIXEL_MEAN_BGR = (102.9801, 115.9465, 122.7717)
ITERS = 20  # timed requests a budget (bench.py:377)
TRAIN_ITERS = 10  # timed steps a train stage (tools/bench_train.py's device_timeit n)
# A kernel against its plain version sums the same products in another
# order: max |diff| <= CONV_RTOL * max |plain| + CONV_ATOL; the soft-argmin
# kernel interpolates H and W before D and takes the softmax online: max
# |diff| <= SOFTARGMIN_TOL_PX; NMS, FPS and RoI-pool select, and are equal.
CONV_RTOL, CONV_ATOL = 1e-4, 1e-5
SOFTARGMIN_TOL_PX = 1e-3


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn: Callable[[], object], reps: int, queued: bool = False) -> float:
    """ms a call of fn on the card, from CUDA events around `reps` calls.
    queued: the calls first queue behind a sleeping kernel (~20 ms) and run
    back to back, so that a kernel shorter than the host's call (~25 us
    through a ctypes wrapper) is timed on the device, not at the host's
    call rate."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(4 * 10 ** 7)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(got, want, what: str, tol: float = None) -> float:
    """max |got - want|, raising past `tol` (default CONV_RTOL * max |want|
    + CONV_ATOL); tol 0 asks for equal values."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if want.numel() else 0.0
    limit = CONV_RTOL * float(want.abs().max()) + CONV_ATOL if tol is None else tol
    if not err <= limit:
        raise AssertionError(f"canary {what}: kernel off its plain version by {err} > {limit}")
    return err


def canary(device) -> List[dict]:
    """Each kernel row at tiny shapes through its wrapper (the kernel on a
    CUDA device, the plain version on the CPU) against its plain version.
    -> [{"row", "name", "max_abs_err"}]; raises on a mismatch."""
    device = torch.device(device)
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device)

    def affine(c):
        return 1 + randn(c, scale=0.3), randn(c, scale=0.1)

    def chain(cin, widths):
        ws = []
        for co in widths:
            ws.append((randn(cin, co, scale=cin ** -0.5), randn(co, scale=0.1)))
            cin = co
        return ws

    def grads(out, leaves, dy):
        return [out.detach()] + list(torch.autograd.grad(out, leaves, dy))

    rows = []

    def row(n, name, pairs, tol=None):
        err = max(max_err(g, w, name, tol) for g, w in pairs)
        rows.append(dict(row=n, name=name, max_abs_err=err))

    # 1. greedy NMS over score-sorted boxes
    xy = torch.rand(2, 96, 2, generator=gen) * 200
    boxes = torch.cat([xy, xy + 20 + torch.rand(2, 96, 2, generator=gen) * 60], -1).to(device)
    valid = (torch.rand(2, 96, generator=gen) > 0.1).to(device)
    row(1, "nms_sorted", zip(cnms.nms_sorted(boxes, valid, 16, 0.5),
                             cnms.nms_sorted_plain(boxes, valid, 16, 0.5)), tol=0.0)
    # 2. the cost volume + first 3D conv
    left, right = randn(2, 32, 7, 20), randn(2, 32, 7, 20)
    w, (mul, add) = randn(32, 64, 3, 3, 3, scale=0.05), affine(32)
    row(2, "cost_volume_conv", [(cconv.cost_volume_conv_bn(left, right, w, mul, add, -4, 4),
                                 cconv.cost_volume_conv_bn_plain(left, right, w, mul, add, -4,
                                                                 4))])
    # 3.-4. the stride-1 3D conv, with residual and ReLU, and its 32 -> 1 form
    x, w, (mul, add), res = randn(2, 32, 5, 9, 20), randn(32, 32, 3, 3, 3, scale=0.05), \
        affine(32), randn(2, 32, 5, 9, 20)
    row(3, "conv3d", [(cconv.conv3d_bn(x, w, mul, add, res, True),
                       cconv.conv3d_bn_plain(x, w, mul, add, res, True))])
    w1 = randn(1, 32, 3, 3, 3, scale=0.05)
    row(4, "conv3d_cl1", [(cconv.conv3d_bn(x, w1), cconv.conv3d_bn_plain(x, w1))])
    # 5. the transposed 3D conv
    xd, wd, (mul, add) = randn(2, 64, 3, 5, 8), randn(64, 32, 3, 3, 3, scale=0.05), affine(32)
    res = randn(2, 32, 6, 10, 16)
    row(5, "deconv3d", [(cconv.deconv3d_bn(xd, wd, mul, add, res, False),
                         cconv.deconv3d_bn_plain(xd, wd, mul, add, res, False))])
    # 6. the stride-2 3D conv
    w2, (mul, add) = randn(64, 32, 3, 3, 3, scale=0.05), affine(64)
    row(6, "conv3d_s2", [(cconv.conv3d_bn(x, w2, mul, add, None, True, 2),
                          cconv.conv3d_bn_plain(x, w2, mul, add, None, True, 2))])
    # 7. the tower's 2D conv
    x2, w7, (mul, add) = randn(2, 32, 13, 20), randn(32, 32, 3, 3, scale=0.05), affine(32)
    row(7, "conv2d", [(cconv.conv2d_bn(x2, w7, mul, add, None, True),
                       cconv.conv2d_bn_plain(x2, w7, mul, add, None, True))])
    # 8. the stride-1 conv's train form: value, dx and dk
    xt = randn(2, 32, 4, 6, 8).requires_grad_(True)
    wt = randn(32, 32, 3, 3, 3, scale=0.05).requires_grad_(True)
    dy = randn(2, 32, 4, 6, 8)
    row(8, "conv3d_train", zip(grads(cconv.conv3d_train(xt, wt), (xt, wt), dy),
                               grads(cconv.conv3d_train_plain(xt, wt), (xt, wt), dy)))
    # 9. furthest-point sampling
    xyz = randn(3, 64, 3, scale=1.5)
    xyz[:, 5] = xyz[:, 2]
    row(9, "fps", [(cfps.furthest_point_sample(xyz, 16),
                    cfps.furthest_point_sample_plain(xyz, 16))], tol=0.0)
    # 10.-11. the whole SA scale, eval and train form
    pts, centers = randn(2, 64, 3), randn(2, 16, 3)
    v, w0x, (mul0, add0) = randn(2, 64, 64), randn(3, 64, scale=0.5), affine(64)
    ws = chain(64, (64, 96))
    sa_args = (pts, centers, v, w0x, mul0, add0, ws, 1.2, 8)
    row(10, "sa", [(csa.sa_ball_mlp_max(*sa_args), csa.sa_ball_mlp_max_plain(*sa_args))])
    leaves = [t.clone().requires_grad_(True) for t in (v, w0x, mul0, add0)]
    wl = [tuple(t.clone().requires_grad_(True) for t in pair) for pair in ws]
    flat = leaves + [t for pair in wl for t in pair]
    dsa = randn(2, 16, 96)
    row(11, "sa_train", zip(
        grads(csa.sa_ball_mlp_max_train(pts, centers, *leaves, wl, 1.2, 8), flat, dsa),
        grads(csa.sa_ball_mlp_max_plain(pts, centers, *leaves, wl, 1.2, 8), flat, dsa)))
    # 12. the grouped MLP + max: a partial last tile, a width not a multiple of 4
    xg, (mul0, add0) = randn(37, 16, 64), affine(64)
    wg = chain(64, (96, 70))
    row(12, "grouped_mlp", [(cgm.grouped_mlp_max(xg, mul0, add0, wg),
                             cgm.grouped_mlp_max_plain(xg, mul0, add0, wg))])
    # 13. feature propagation
    unknown, known = randn(2, 32, 3), randn(2, 16, 3)
    kf, uf = randn(2, 16, 32), randn(2, 32, 16)
    wf = chain(48, (64, 32))
    row(13, "fp", [(cfp.fp_fused(unknown, known, kf, uf, wf),
                    cfp.fp_fused_plain(unknown, known, kf, uf, wf))])
    # 14. RoI-pool 3D: a box with many points, one with few, one with none
    rp = (torch.rand(2, 64, 3, generator=gen) * 6 - 3).to(device)
    rf = randn(2, 64, 4)
    rb = torch.tensor([[0.0, 1.5, 0.0, 3.0, 3.0, 3.0, 0.4], [1.0, 0.5, -1.0, 1.0, 1.2, 1.2, -0.8],
                       [50.0, 50.0, 50.0, 1.0, 1.0, 1.0, 0.0]]).repeat(2, 1, 1).to(device)
    row(14, "roipool3d", zip(croi.roipool3d(rp, rf, rb, 16), croi.roipool3d_plain(rp, rf, rb, 16)),
        tol=0.0)
    # 15. the soft-argmin
    logits = randn(2, 8, 7, 9, scale=3.0)
    row(15, "softargmin", [(csam.softargmin(logits, (27, 33), -16, 16),
                            csam.softargmin_plain(logits, (27, 33), -16, 16))],
        tol=SOFTARGMIN_TOL_PX)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return rows


def build_models(device, kernels_off: Sequence[str] = ()):
    """(model2d, model3d) of the bench's pipeline with random weights drawn
    from a seeded generator on `device`."""
    gen = torch.Generator(device=device).manual_seed(0)
    model2d = init_random_(DispRCNN(**BENCH_2D, device=device), gen)
    model3d = init_random_(DispRCNN3D(**BENCH_3D, kernels_off=kernels_off, device=device), gen)
    return model2d, model3d


def make_request(pairs: int, img_hw, rois: int, lift_grid: int, device, seed: int = 0):
    """(left, right, left_raw, right_raw, priorities) of one request: raw
    [0, 1] RGB for the 3D stage, BGR255 mean-subtracted for the 2D
    detector, and the lift's sampling priorities, from a seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    h, w = img_hw
    raw = [torch.rand(pairs, h, w, 3, generator=gen).to(device) for _ in range(2)]
    mean = torch.tensor(PIXEL_MEAN_BGR, device=device)
    net = [r.flip(-1) * 255.0 - mean for r in raw]
    pri = torch.rand(rois, lift_grid * lift_grid, generator=gen).to(device)
    return net[0], net[1], raw[0], raw[1], pri


def set_budget(model3d: DispRCNN3D, budget: str) -> None:
    for name, value in BUDGETS[budget].items():
        setattr(model3d.pointrcnn, name, value)


def timed(fn: Callable[[], object], device) -> Tuple[object, float]:
    """(fn(), ms of the call): CUDA events on the card, the host clock on
    the CPU."""
    if torch.device(device).type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def spread(ms: List[float], per_step: int, unit: str) -> dict:
    med = statistics.median(ms)
    return {"ms_median": med, "ms_min": min(ms), "ms_max": max(ms), "iters": len(ms),
            f"{unit}_per_sec": per_step * 1e3 / med}


def time_pipeline(models, pairs: int, budget: str, kernels_off: Sequence[str] = (),
                  iters: int = ITERS, img_hw=IMG_HW, calib: dict = CALIB) -> dict:
    """The eval pipeline through ``predict`` on built models (model2d,
    model3d with det3d_on): one warm-up request and `iters` timed ones of
    `pairs` pairs at `budget`, with the PointNet++ families in
    `kernels_off` routed off (the models keep that budget and route).
    -> ms per request (median, min, max) and pairs/s at the median."""
    model2d, model3d = models
    set_budget(model3d, budget)
    set_kernels_off(model3d, kernels_off)
    dev = model3d.device
    req = make_request(pairs, img_hw, pairs * model3d.max_det, model3d.lift_grid, dev)

    def run():
        return predict(model2d, model3d, *req[:4], calib=calib, priorities=req[4])

    out = run()
    for k in ("box3d", "score3d", "disparity_roi"):
        if not torch.isfinite(out[k]).all():
            raise AssertionError(f"{budget} budget: non-finite {k}")
    if not out["roi_ok"].any():
        raise AssertionError(f"{budget} budget: no instance has lifted points")
    del out
    ms = [timed(run, dev)[1] for _ in range(iters)]
    return {**spread(ms, pairs, "pairs"), "kernels_off": sorted(kernel_tags(kernels_off))}


def time_train_stage(stage: str, device, iters: int = TRAIN_ITERS) -> dict:
    """One train stage of tools/bench_train.py at bench.py's pairs a step:
    ms per step (median, min, max), and crops/s (psm) or pairs/s (pc)."""
    from .tools import bench_train

    pairs = bench_train.BENCH_PAIRS.get(stage, 1)
    st = bench_train.build_stage(stage, pairs, torch.Generator(device=device).manual_seed(0))
    ms = bench_train.time_steps(st, iters)
    out = {**spread(ms, pairs, "pairs"), "pairs_per_step": pairs}
    if stage == "psm":
        out.update(crops_per_step=st.units, crops_per_sec=st.units * 1e3 / out["ms_median"])
    return out


def result_line(budgets: Dict[str, dict], train: Dict[str, dict], pairs: int,
                kernels_off: Sequence[str], device_desc: str) -> dict:
    """The bench's JSON line: the metric at the reference budget, or at the
    first budget timed."""
    head = "reference" if "reference" in budgets else next(iter(budgets))
    value = budgets[head]["pairs_per_sec"]
    return {"metric": f"stereo_pairs_per_sec_full_pipeline_{head}_budget", "value": value,
            "unit": "pairs/s/card", "vs_baseline": value / BASELINE_PAIRS_PER_SEC_PER_GPU,
            "pairs_per_step": pairs, "device": device_desc,
            "kernels_off": sorted(kernel_tags(kernels_off)), "budgets": budgets, "train": train}


def split_list(text: str) -> List[str]:
    return [t.strip() for t in text.split(",") if t.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=8, help="stereo pairs per request")
    ap.add_argument("--budgets", default="headline,reference",
                    help="comma list of 3D budgets (headline: 16 proposals per instance, "
                         "reference: 100)")
    ap.add_argument("--train", default="psm,pc",
                    help="comma list of train stages (psm, pc, 2d; '' for none)")
    ap.add_argument("--kernels-off", default="",
                    help="comma list of PointNet++ kernel families to route off (sa, pool, "
                         "fp), as DISPRCNN_PALLAS_DISABLE")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for a smoke test")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    kernels_off = kernel_tags(split_list(args.kernels_off))
    budgets = split_list(args.budgets)
    unknown = [b for b in budgets if b not in BUDGETS]
    if unknown or not budgets:
        ap.error(f"budgets must be among {sorted(BUDGETS)}, got {args.budgets!r}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("bench: no CUDA device (pass --device cpu for a CPU smoke test)",
                  file=sys.stderr)
            return 2
        desc = card_line()
    else:
        desc = "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for r in canary(device):
        print(f"canary row {r['row']:2d} {r['name']}: max |diff| {r['max_abs_err']:.3g}",
              flush=True)
    models = build_models(device, kernels_off=kernels_off)
    results = {}
    for budget in budgets:
        results[budget] = time_pipeline(models, args.pairs, budget, kernels_off)
        print(f"{budget}: {json.dumps(results[budget])}", flush=True)
    del models
    if device.type == "cuda":
        torch.cuda.empty_cache()
    train = {}
    for stage in split_list(args.train):
        train[stage] = time_train_stage(stage, device)
        print(f"train {stage}: {json.dumps(train[stage])}", flush=True)
    print(json.dumps(result_line(results, train, args.pairs, kernels_off, desc)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
