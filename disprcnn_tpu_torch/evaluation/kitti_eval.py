"""KITTI-format prediction writing + AP evaluation (counterpart of
disprcnn_tpu/evaluation/kitti_eval.py).

Reference: data/datasets/evaluation/kitti/kitti_eval.py:8-124. Predictions are
written as official KITTI txt lines
  `type -1 -1 alpha x1 y1 x2 y2 h w l x y z ry score`
with alpha = ry + atan2(-x, z), then scored by the AP evaluator of
evaluation/ap.py, the KITTI devkit's protocol in Python. The JAX package
runs its native build (csrc/kitti_ap) where one is built; this module
always runs the Python evaluator, which writes the same stats_*.txt files.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np


def write_kitti_txt(
    predictions: Dict[str, dict],
    output_dir: str,
    class_name: str = "Car",
):
    """Write one txt per image from per-image prediction dicts with keys
    left_boxes (N,4), scores (N,), box3d (N,7 xyzhwl_ry), score3d (N,),
    valid (N,)."""
    txt_dir = os.path.join(output_dir, "txt")
    os.makedirs(txt_dir, exist_ok=True)
    for imgid, pred in predictions.items():
        lines = []
        n = len(pred.get("scores", []))
        for i in range(n):
            if "valid" in pred and not pred["valid"][i]:
                continue
            b = pred["left_boxes"][i]
            score = float(pred.get("score3d", pred["scores"])[i])
            if "box3d" in pred:
                x, y, z, h, w, l, ry = (float(v) for v in pred["box3d"][i])
            else:
                x = y = z = -1000.0
                h = w = l = -1.0
                ry = -10.0
            alpha = ry + np.arctan2(-x, z) if z > 0 else -10.0
            lines.append(
                f"{class_name} -1 -1 {alpha:.6f} "
                f"{b[0]:.6f} {b[1]:.6f} {b[2]:.6f} {b[3]:.6f} "
                f"{h:.6f} {w:.6f} {l:.6f} {x:.6f} {y:.6f} {z:.6f} {ry:.6f} {score:.6f}"
            )
        with open(os.path.join(txt_dir, f"{imgid}.txt"), "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
    return txt_dir


def evaluate_kitti(
    gt_dir: str,
    pred_txt_dir: str,
    output_dir: str,
    iou_thresholds=(0.7, 0.5),
    current_class: str = "Car",
):
    """Run the AP evaluator for each IoU threshold; returns
    {thr: {"image" | "ground" | "3d" | "orientation": [easy, moderate, hard]}}."""
    from .ap import evaluate_ap

    results = {}
    for thr in iou_thresholds:
        tag = f"{thr:.1f}".replace(".", "")
        out = os.path.join(output_dir, f"eval_{tag}")
        os.makedirs(out, exist_ok=True)
        results[thr] = evaluate_ap(gt_dir, pred_txt_dir, out, current_class, thr)
    return results


def _parse_stats(out_dir: str, cls: str) -> dict:
    """Parse stats_<cls>_detection{,_ground,_3d}.txt -> AP easy/mod/hard
    (the native evaluator's output is read this way)."""
    res = {}
    for kind, fname in (
        ("bbox", f"stats_{cls.lower()}_detection.txt"),
        ("bev", f"stats_{cls.lower()}_detection_ground.txt"),
        ("3d", f"stats_{cls.lower()}_detection_3d.txt"),
    ):
        path = os.path.join(out_dir, fname)
        if not os.path.exists(path):
            continue
        curves = np.loadtxt(path)
        if curves.ndim == 1:
            curves = curves[None]
        # 41-point curves per difficulty; AP = mean over every 4th point
        # (official devkit averaging)
        res[kind] = [float(np.mean(c[::4]) * 100) for c in curves]
    return res
