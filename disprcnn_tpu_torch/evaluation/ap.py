"""KITTI AP evaluator — devkit-faithful Python implementation (a copy of
disprcnn_tpu/evaluation/ap.py).

Reimplements the official KITTI `evaluate_object` protocol (the reference
ships it only as precompiled binaries, tools/kitti_object/kitti_evaluation_lib):
- difficulty gates: min bbox height {40, 25, 25}, max occlusion {0, 1, 2},
  max truncation {0.15, 0.3, 0.5},
- class semantics: neighbouring classes (Van for Car, Person_sitting for
  Pedestrian) and too-hard GT become "ignored"; DontCare regions absorb
  stray detections,
- greedy TP assignment at the IoU threshold, 41 recall-sampled score
  thresholds, precision curves written as stats_<cls>_detection{,_ground,_3d}
  .txt (3 rows x 41 cols) — the same files the reference parses
  (kitti_eval.py:53-79), AP = mean of every 4th point x 100.

Metrics: 2D bbox IoU (image), rotated BEV IoU (ground), 3D IoU; orientation
similarity (AOS) when alpha is provided.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List

import numpy as np

N_SAMPLE_PTS = 41
MIN_HEIGHT = (40.0, 25.0, 25.0)
MAX_OCCLUSION = (0, 1, 2)
MAX_TRUNCATION = (0.15, 0.3, 0.5)
NEIGHBOR_CLASSES = {"Car": ("Van",), "Pedestrian": ("Person_sitting",), "Cyclist": ()}


@dataclass
class Obj:
    cls: str
    truncation: float
    occlusion: float
    alpha: float
    box: np.ndarray  # (4,)
    h: float
    w: float
    l: float
    xyz: np.ndarray  # (3,)
    ry: float
    score: float


def _parse(path: str) -> List[Obj]:
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            t = line.split()
            if len(t) < 15:
                continue
            out.append(
                Obj(
                    cls=t[0], truncation=float(t[1]), occlusion=float(t[2]),
                    alpha=float(t[3]),
                    box=np.asarray([float(v) for v in t[4:8]]),
                    h=float(t[8]), w=float(t[9]), l=float(t[10]),
                    xyz=np.asarray([float(v) for v in t[11:14]]),
                    ry=float(t[14]),
                    score=float(t[15]) if len(t) > 15 else -1.0,
                )
            )
    return out


def _iou2d(a: Obj, b: Obj) -> float:
    x1 = max(a.box[0], b.box[0])
    y1 = max(a.box[1], b.box[1])
    x2 = min(a.box[2], b.box[2])
    y2 = min(a.box[3], b.box[3])
    inter = max(x2 - x1, 0) * max(y2 - y1, 0)
    area = lambda o: (o.box[2] - o.box[0]) * (o.box[3] - o.box[1])
    return inter / max(area(a) + area(b) - inter, 1e-12)


def _rect_poly(o: Obj):
    c, s = np.cos(o.ry), np.sin(o.ry)
    dx = np.asarray([o.l / 2, o.l / 2, -o.l / 2, -o.l / 2])
    dz = np.asarray([o.w / 2, -o.w / 2, -o.w / 2, o.w / 2])
    x = o.xyz[0] + c * dx + s * dz
    z = o.xyz[2] - s * dx + c * dz
    return np.stack([x, z], axis=1)


def _poly_clip_area(pa, pb) -> float:
    def clip(poly, a, b):
        out = []
        n = len(poly)
        for i in range(n):
            cur, prev = poly[i], poly[i - 1]
            side_c = (b[0] - a[0]) * (cur[1] - a[1]) - (b[1] - a[1]) * (cur[0] - a[0])
            side_p = (b[0] - a[0]) * (prev[1] - a[1]) - (b[1] - a[1]) * (prev[0] - a[0])
            if side_c >= -1e-12:
                if side_p < -1e-12:
                    out.append(_isect(prev, cur, a, b))
                out.append(tuple(cur))
            elif side_p >= -1e-12:
                out.append(_isect(prev, cur, a, b))
        return out

    def _isect(p1, p2, a, b):
        d1 = (p2[0] - p1[0], p2[1] - p1[1])
        d2 = (b[0] - a[0], b[1] - a[1])
        den = d1[0] * d2[1] - d1[1] * d2[0]
        t = ((a[0] - p1[0]) * d2[1] - (a[1] - p1[1]) * d2[0]) / den
        return (p1[0] + t * d1[0], p1[1] + t * d1[1])

    # ensure CCW clip polygon
    pb = list(map(tuple, pb))
    ar2 = sum(
        pb[i][0] * pb[(i + 1) % 4][1] - pb[(i + 1) % 4][0] * pb[i][1] for i in range(4)
    )
    if ar2 < 0:
        pb = pb[::-1]
    poly = list(map(tuple, pa))
    for i in range(4):
        poly = clip(poly, pb[i], pb[(i + 1) % 4])
        if not poly:
            return 0.0
    x = np.asarray([p[0] for p in poly])
    y = np.asarray([p[1] for p in poly])
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _iou_bev(a: Obj, b: Obj) -> float:
    inter = _poly_clip_area(_rect_poly(a), _rect_poly(b))
    union = a.l * a.w + b.l * b.w - inter
    return inter / max(union, 1e-12)


def _iou3d(a: Obj, b: Obj) -> float:
    inter_bev = _poly_clip_area(_rect_poly(a), _rect_poly(b))
    ymin = max(a.xyz[1] - a.h, b.xyz[1] - b.h)
    ymax = min(a.xyz[1], b.xyz[1])
    inter = inter_bev * max(ymax - ymin, 0)
    union = a.h * a.w * a.l + b.h * b.w * b.l - inter
    return inter / max(union, 1e-12)


_METRIC_FN = {"image": _iou2d, "ground": _iou_bev, "3d": _iou3d}


def _clean(gts, dets, current_class, difficulty):
    """-> (ignored_gt, dontcare_idx, ignored_det, n_valid_gt) devkit cleanData."""
    ignored_gt, dontcare, ignored_det = [], [], []
    n_valid = 0
    for g in gts:
        too_hard = (
            g.occlusion > MAX_OCCLUSION[difficulty]
            or g.truncation > MAX_TRUNCATION[difficulty]
            or (g.box[3] - g.box[1]) < MIN_HEIGHT[difficulty]
        )
        if g.cls == current_class:
            if too_hard:
                ignored_gt.append(1)
            else:
                ignored_gt.append(0)
                n_valid += 1
        elif g.cls in NEIGHBOR_CLASSES.get(current_class, ()):
            ignored_gt.append(1)
        elif g.cls == "DontCare":
            ignored_gt.append(-1)
            dontcare.append(g)
        else:
            ignored_gt.append(-1)
    for d in dets:
        small = (d.box[3] - d.box[1]) < MIN_HEIGHT[difficulty]
        if d.cls != current_class:
            ignored_det.append(-1)
        elif small:
            ignored_det.append(1)
        else:
            ignored_det.append(0)
    return ignored_gt, dontcare, ignored_det, n_valid


def _tp_scores(gts, dets, ignored_gt, ignored_det, metric, thresh):
    """Scores of detections greedily assigned to valid GT (first pass)."""
    fn = _METRIC_FN[metric]
    assigned = [False] * len(dets)
    scores = []
    for gi, g in enumerate(gts):
        if ignored_gt[gi] != 0:
            continue
        best = -1
        for di, d in enumerate(dets):
            if ignored_det[di] == -1 or assigned[di]:
                continue
            ov = fn(d, g)
            # devkit !compute_fp pass: max score among overlap > thresh
            if ov > thresh and (best == -1 or d.score > dets[best].score):
                best = di
        if best >= 0:
            assigned[best] = True
            scores.append(dets[best].score)
    return scores


def _stats_at(gts, dets, ignored_gt, dontcare, ignored_det, metric, thresh, score_t):
    """One operating point: (tp, fp, fn, aos_sum) devkit computeStatistics."""
    fn_metric = _METRIC_FN[metric]
    assigned = [False] * len(dets)
    tp = fp = fn = 0
    deltas = []
    for gi, g in enumerate(gts):
        if ignored_gt[gi] == -1:
            continue
        best, max_ov, best_ignored = -1, 0.0, False
        for di, d in enumerate(dets):
            if ignored_det[di] == -1 or assigned[di] or d.score < score_t:
                continue
            ov = fn_metric(d, g)
            # devkit compute_fp pass: prefer non-ignored dets by MAX OVERLAP
            # (not score); fall back to an ignored det only when none chosen.
            if ov > thresh and ignored_det[di] == 0 and (ov > max_ov or best_ignored):
                best, max_ov, best_ignored = di, ov, False
            elif ov > thresh and best == -1 and ignored_det[di] == 1:
                best, best_ignored = di, True
        if best == -1 and ignored_gt[gi] == 0:
            fn += 1
        elif best >= 0 and (ignored_gt[gi] == 1 or best_ignored):
            assigned[best] = True
        elif best >= 0:
            tp += 1
            deltas.append(g.alpha - dets[best].alpha)
            assigned[best] = True
    for di, d in enumerate(dets):
        if assigned[di] or ignored_det[di] != 0 or d.score < score_t:
            continue
        # dontcare absorption (2D overlap over DET area)
        in_dc = False
        for dc in dontcare:
            x1 = max(d.box[0], dc.box[0])
            y1 = max(d.box[1], dc.box[1])
            x2 = min(d.box[2], dc.box[2])
            y2 = min(d.box[3], dc.box[3])
            inter = max(x2 - x1, 0) * max(y2 - y1, 0)
            if inter / max((d.box[2] - d.box[0]) * (d.box[3] - d.box[1]), 1e-12) > thresh:
                in_dc = True
                break
        if not in_dc:
            fp += 1
    aos = sum((1.0 + np.cos(dl)) / 2.0 for dl in deltas)
    return tp, fp, fn, aos


def _thresholds(all_scores: np.ndarray, n_gt: int) -> np.ndarray:
    """Recall-sampled score thresholds (devkit getThresholds)."""
    scores = np.sort(all_scores)[::-1]
    out = []
    current_recall = 0.0
    for i, s in enumerate(scores):
        l_recall = (i + 1) / n_gt
        r_recall = (i + 2) / n_gt if i < len(scores) - 1 else l_recall
        if (r_recall - current_recall) < (current_recall - l_recall) and i < len(scores) - 1:
            continue
        out.append(s)
        current_recall += 1.0 / (N_SAMPLE_PTS - 1.0)
    return np.asarray(out)


def eval_class(gt_all, det_all, current_class, metric, thresh):
    """-> precision (3, 41) across difficulties."""
    prec = np.zeros((3, N_SAMPLE_PTS))
    aos_out = np.zeros((3, N_SAMPLE_PTS))
    for difficulty in range(3):
        cleaned = [
            _clean(g, d, current_class, difficulty) for g, d in zip(gt_all, det_all)
        ]
        n_gt = sum(c[3] for c in cleaned)
        if n_gt == 0:
            continue
        scores = []
        for (g, d, c) in zip(gt_all, det_all, cleaned):
            scores.extend(_tp_scores(g, d, c[0], c[2], metric, thresh))
        if not scores:
            continue
        ths = _thresholds(np.asarray(scores), n_gt)
        pr = np.zeros((len(ths), 4))
        for (g, d, c) in zip(gt_all, det_all, cleaned):
            for ti, t in enumerate(ths):
                tp, fp, fn, aos = _stats_at(g, d, c[0], c[1], c[2], metric, thresh, t)
                pr[ti] += [tp, fp, fn, aos]
        for ti in range(len(ths)):
            denom = max(pr[ti, 0] + pr[ti, 1], 1e-12)
            prec[difficulty, ti] = pr[ti, 0] / denom
            aos_out[difficulty, ti] = pr[ti, 3] / denom
        # devkit: precision made monotone decreasing from the right
        for ti in range(N_SAMPLE_PTS):
            prec[difficulty, ti] = prec[difficulty, ti:].max() if ti < len(ths) else 0.0
            aos_out[difficulty, ti] = aos_out[difficulty, ti:].max() if ti < len(ths) else 0.0
    return prec, aos_out


def evaluate_ap(gt_dir, pred_dir, out_dir, current_class="Car", thresh=0.7,
                metrics=("image", "ground", "3d"), write_orientation=True):
    ids = sorted(os.path.splitext(f)[0] for f in os.listdir(pred_dir) if f.endswith(".txt"))
    gt_all = [_parse(os.path.join(gt_dir, f"{i}.txt")) for i in ids]
    det_all = [_parse(os.path.join(pred_dir, f"{i}.txt")) for i in ids]
    os.makedirs(out_dir, exist_ok=True)
    suffix = {"image": "detection", "ground": "detection_ground", "3d": "detection_3d"}
    results = {}
    for metric in metrics:
        prec, aos = eval_class(gt_all, det_all, current_class, metric, thresh)
        path = os.path.join(out_dir, f"stats_{current_class.lower()}_{suffix[metric]}.txt")
        np.savetxt(path, prec, fmt="%.6f")
        results[metric] = (prec[:, ::4].mean(axis=1) * 100).tolist()
        if metric == "image" and write_orientation:
            np.savetxt(
                os.path.join(out_dir, f"stats_{current_class.lower()}_orientation.txt"),
                aos, fmt="%.6f",
            )
            results["orientation"] = (aos[:, ::4].mean(axis=1) * 100).tolist()
    return results
