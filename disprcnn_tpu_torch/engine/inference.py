"""Inference entry points of the port (counterpart of
disprcnn_tpu/engine/inference.py, which drives the jitted eval forward).

``predict_2d`` answers one request of stereo pairs with the 2D detector;
``predict`` runs it and then iDispNet over the detections' ROI crops.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..models.detector.disprcnn import DispRCNN
from ..models.detector.disprcnn3d import DispRCNN3D
from ..structures.stereo import StereoBoxes


def predict_2d(model: DispRCNN, left, right) -> Dict[str, object]:
    """Eval forward of the 2D stereo detector on the model's device.

    left, right: (B, H, W, 3) normalized images, tensors or numpy arrays.
    Returns the JAX eval forward's dict: "detections" (StereoBoxes of
    (B, max_det) rows with "labels") and "masks" (B, max_det, 28, 28).
    """
    left, right = (torch.as_tensor(x, dtype=torch.float32, device=model.device)
                   for x in (left, right))
    with torch.inference_mode():
        return model(left, right)


def predict(model2d: DispRCNN, model3d: DispRCNN3D, left, right, left_raw,
            right_raw) -> Dict[str, object]:
    """The 2D stereo detector, then instance disparity over its detections
    (the pipeline of bench.py:_time_pipeline up to ``disparity_roi``).

    left, right: (B, H, W, 3) normalized images for the 2D detector;
    left_raw, right_raw: the same pairs as raw [0, 1] RGB, which the 3D
    stage crops. Returns "detections" and "masks" as ``predict_2d`` does,
    and "disparity_roi" (B, max_det, roi, roi): one disparity map per
    detection slot, valid or not.
    """
    out = predict_2d(model2d, left, right)
    dets = out["detections"]
    dets3 = StereoBoxes(left=dets.left, right=dets.right, score=dets.score, valid=dets.valid,
                        fields={"mask": out["masks"]})
    left_raw, right_raw = (torch.as_tensor(x, dtype=torch.float32, device=model3d.device)
                           for x in (left_raw, right_raw))
    with torch.inference_mode():
        disp = model3d(left_raw, right_raw, dets3)["disparity_roi"]
    b, d = dets.valid.shape
    return {**out, "disparity_roi": disp.reshape(b, d, *disp.shape[1:])}
