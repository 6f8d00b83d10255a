"""Loader batch -> model arguments, per meta-architecture (counterpart of
disprcnn_tpu/engine/batching.py).

The loader (data/loader.py) yields numpy batches; ``make_batch_converter``
puts the ones a model takes on its device as float32 / bool / int tensors:
the images, the offline 2D predictions as ``StereoBoxes`` (the "mask" and
"labels" fields) and the calibration dict of (B,) values. The eval
forwards' arguments only: the train batches (the GT keys) come with the
train CLIs (ROADMAP A4.3).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..structures.stereo import StereoBoxes

def to_device(x, device) -> torch.Tensor:
    """A numpy batch entry as a tensor on `device`: floats as float32,
    bools and ints as they are."""
    a = np.asarray(x)
    if a.dtype.kind == "f":
        a = a.astype(np.float32, copy=False)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, non_blocking=True)


def preds_to_stereoboxes(batch: Dict[str, np.ndarray], device) -> StereoBoxes:
    """Offline 2D predictions (pred_* keys) -> batched StereoBoxes."""
    return StereoBoxes(
        left=to_device(batch["pred_left"], device),
        right=to_device(batch["pred_right"], device),
        score=to_device(batch["pred_score"], device),
        valid=to_device(batch["pred_valid"], device),
        fields={"mask": to_device(batch["pred_mask"], device),
                "labels": to_device(batch["pred_labels"], device)},
    )


def make_batch_converter(cfg, device):
    """-> convert(batch) -> the eval forward's keyword arguments on
    `device`."""
    meta = cfg.MODEL.META_ARCHITECTURE
    if meta in ("DispRCNN", "GeneralizedRCNN"):
        def convert(batch):
            return {"left": to_device(batch["left"], device),
                    "right": to_device(batch["right"], device)}

        return convert

    if meta == "DispRCNN3D":
        def convert(batch):
            # the 3D stage crops RAW images (disprcnn3d.py:44-50): the loader
            # gives raw_left when a Normalize transform ran, else left is raw
            return {
                "left_img": to_device(batch.get("raw_left", batch["left"]), device),
                "right_img": to_device(batch.get("raw_right", batch["right"]), device),
                "dets": preds_to_stereoboxes(batch, device),
                "calib": {k: to_device(v, device) for k, v in batch["calib"].items()},
            }

        return convert

    raise NotImplementedError(meta)
