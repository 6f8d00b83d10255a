"""Loader batch -> model arguments, per meta-architecture (counterpart of
disprcnn_tpu/engine/batching.py).

The loader (data/loader.py) yields numpy batches; ``make_batch_converter``
puts the ones a model takes on its device as float32 / bool / int tensors:
the images, the offline 2D predictions as ``StereoBoxes`` (the "mask" and
"labels" fields) and the calibration dict of (B,) values, and in train the
GT the model's losses read.
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


# keys the 2D detector trains on, besides the images
_KEYS_2D = ("gt_left", "gt_right", "gt_labels", "gt_valid", "gt_masks")


def make_batch_converter(cfg, device):
    """-> (convert(batch, train=False) -> the forward's keyword arguments on
    `device`, static_kwargs): the fixed flags of a DispRCNN3D train step
    (train_psm, train_pc from SOLVER.TRAIN_PSM/TRAIN_PC), which
    make_train_step takes as its forward_kwargs; none for the 2D detector
    (the port's DispRCNN has no DISPNET_ON branch, models/build.py).

    In train, DispRCNN takes gt_left, gt_right, gt_labels, gt_valid and
    gt_masks; DispRCNN3D gt_disp (when the batch has it), gt_left,
    gt_boxes3d (the batch's gt_box3d) and gt_valid."""
    meta = cfg.MODEL.META_ARCHITECTURE
    if meta in ("DispRCNN", "GeneralizedRCNN"):
        def convert(batch, train: bool = False):
            kw = {"left": to_device(batch["left"], device),
                  "right": to_device(batch["right"], device)}
            if train:
                kw.update({k: to_device(batch[k], device) for k in _KEYS_2D if k in batch})
            return kw

        return convert, {}

    if meta == "DispRCNN3D":
        def convert(batch, train: bool = False):
            # the 3D stage crops RAW images (disprcnn3d.py:44-50): the loader
            # gives raw_left when a Normalize transform ran, else left is raw
            kw = {
                "left_img": to_device(batch.get("raw_left", batch["left"]), device),
                "right_img": to_device(batch.get("raw_right", batch["right"]), device),
                "dets": preds_to_stereoboxes(batch, device),
                "calib": {k: to_device(v, device) for k, v in batch["calib"].items()},
            }
            if train:
                if "gt_disp" in batch:
                    kw["gt_disp"] = to_device(batch["gt_disp"], device)
                kw["gt_left"] = to_device(batch["gt_left"], device)
                kw["gt_boxes3d"] = to_device(batch["gt_box3d"], device)
                kw["gt_valid"] = to_device(batch["gt_valid"], device)
            return kw

        return convert, {"train_psm": bool(cfg.SOLVER.TRAIN_PSM),
                         "train_pc": bool(cfg.SOLVER.TRAIN_PC)}

    raise NotImplementedError(meta)
