"""Precomputed 224^2 stereo ROI dataset for standalone iDispNet training
(a copy of disprcnn_tpu/data/datasets/kitti_roi.py).

Reference: data/datasets/kitti_roi_dataset.py:22-93 (KITTIRoiDataset): each
record is a width-aligned stereo crop pair, the ROI ground-truth disparity,
and the ROI mask, ImageNet-normalized. The reference stores zarr + pickle;
this implementation reads one .npz per ROI (written by
tools/generate_psmnet_input.py) and also exposes an in-memory constructor for
synthetic records.
"""
from __future__ import annotations

import os
from glob import glob
from typing import Dict, List, Optional

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


class KittiRoiDataset:
    def __init__(self, root: str, split: str = "train", normalize: bool = True):
        self.files = sorted(glob(os.path.join(root, split, "*.npz")))
        self.normalize = normalize

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rec = dict(np.load(self.files[idx]))
        return prepare_roi_record(rec, self.normalize)


def prepare_roi_record(rec: Dict[str, np.ndarray], normalize: bool = True):
    left = rec["left"].astype(np.float32)
    right = rec["right"].astype(np.float32)
    if normalize:
        left = (left - IMAGENET_MEAN) / IMAGENET_STD
        right = (right - IMAGENET_MEAN) / IMAGENET_STD
    return {
        "left": left,
        "right": right,
        "disparity": rec["disparity"].astype(np.float32),
        "mask": rec["mask"].astype(np.float32),
    }


class SyntheticRoiDataset:
    """Random textured crops with a piecewise-constant disparity plane —
    exercises the standalone iDispNet trainer without KITTI data."""

    def __init__(self, n: int = 64, size: int = 224, max_disp: int = 48, seed: int = 0):
        self.n = n
        self.size = size
        self.max_disp = max_disp
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 9176 + idx)
        s = self.size
        right = rng.uniform(0, 1, (s, s, 3)).astype(np.float32)
        d = float(rng.uniform(2, self.max_disp * 0.5))
        # left image = right shifted by +d (disparity positive)
        shift = int(round(d))
        left = np.roll(right, shift, axis=1)
        disp = np.full((s, s), float(shift), np.float32)
        mask = np.zeros((s, s), np.float32)
        mask[:, shift:] = 1.0
        return prepare_roi_record(
            {"left": left, "right": right, "disparity": disp, "mask": mask}
        )


def collate_roi(samples: List[dict]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
