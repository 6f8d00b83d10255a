"""KITTI-format prediction writing + AP evaluation (counterpart of
disprcnn_tpu/evaluation/kitti_eval.py).

Reference: data/datasets/evaluation/kitti/kitti_eval.py:8-124. Predictions are
written as official KITTI txt lines
  `type -1 -1 alpha x1 y1 x2 y2 h w l x y z ry score`
with alpha = ry + atan2(-x, z), then scored by the AP evaluator of
evaluation/ap.py, the KITTI devkit's protocol in Python, or by
its native build: ``csrc/kitti_ap.cpp`` (a copy of the repo's
csrc/kitti_ap.cpp), compiled at first use with ``g++ -O2 -std=c++17`` into
``csrc/build/kitti_ap-<hash>`` (the hash covers the source and the flags).
Both write the same stats_*.txt files. ``evaluate_kitti`` takes the native
route by default, as the JAX package's does; where there is no compiler or
the build fails it raises (the Python route runs only when the caller
passes ``use_native=False``).
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import numpy as np

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NATIVE_FLAGS = ("-O2", "-std=c++17")


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


def native_evaluator() -> str:
    """The path of the native evaluator, built first if it is not. Several
    processes may build it at once: each writes a file of its own and
    renames it into place."""
    src = CSRC / "kitti_ap.cpp"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NATIVE_FLAGS).encode()).hexdigest()
    out = CSRC / "build" / f"kitti_ap-{digest[:16]}"
    if out.is_file():
        return str(out)
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native KITTI evaluator cannot be built "
                           "(evaluate_kitti(use_native=False) runs the Python one)")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *NATIVE_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {src} failed (g++ exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return str(out)


def evaluate_kitti(
    gt_dir: str,
    pred_txt_dir: str,
    output_dir: str,
    iou_thresholds=(0.7, 0.5),
    current_class: str = "Car",
    use_native: bool = True,
):
    """Run the AP evaluator for each IoU threshold into
    output_dir/eval_<thr>; returns {thr: {"image" | "ground" | "3d" |
    "orientation": [easy, moderate, hard]}}. The native route reads the AP
    from the stats files it writes (curves to 6 decimals), the Python route
    from its curves before they are written."""
    from .ap import evaluate_ap

    native = native_evaluator() if use_native else None
    results = {}
    for thr in iou_thresholds:
        tag = f"{thr:.1f}".replace(".", "")
        out = os.path.join(output_dir, f"eval_{tag}")
        os.makedirs(out, exist_ok=True)
        if native:
            subprocess.run([native, gt_dir, pred_txt_dir, out, current_class, str(thr)],
                           check=True, capture_output=True)
            results[thr] = read_stats(out, current_class)
        else:
            results[thr] = evaluate_ap(gt_dir, pred_txt_dir, out, current_class, thr)
    return results


def read_stats(out_dir: str, cls: str) -> dict:
    """The stats files of one evaluation -> {"image" | "ground" | "3d" |
    "orientation": [easy, moderate, hard]} AP, as evaluate_ap returns them."""
    res = {}
    for kind, fname in (("image", "detection"), ("ground", "detection_ground"),
                        ("3d", "detection_3d"), ("orientation", "orientation")):
        curves = np.loadtxt(os.path.join(out_dir, f"stats_{cls.lower()}_{fname}.txt"), ndmin=2)
        # 41-point curves per difficulty; AP = the mean of every 4th point
        # (the official devkit's averaging)
        res[kind] = [float(np.mean(c[::4]) * 100) for c in curves]
    return res
