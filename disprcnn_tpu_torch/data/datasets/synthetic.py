"""Synthetic stereo scenes for tests and benchmarks (no KITTI data needed;
a copy of disprcnn_tpu/data/datasets/synthetic.py, sample for sample).

Generates procedurally-textured images with rectangular "objects" at known
depths; the right view is the left view shifted by each object's disparity,
so GT boxes / disparity / masks / 3D boxes are exact by construction.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class SyntheticStereoDataset:
    def __init__(
        self,
        n_samples: int = 16,
        image_hw=(192, 640),
        max_gt: int = 8,
        n_objects=(1, 4),
        fu: float = 350.0,
        baseline: float = 0.54,
        seed: int = 0,
        transforms=None,
        with_offline_preds: bool = False,
        mask_size: int = 28,
    ):
        self.n = n_samples
        self.hw = image_hw
        self.max_gt = max_gt
        self.n_objects = n_objects
        self.fu = fu
        self.baseline = baseline
        self.seed = seed
        self.transforms = transforms
        # emit pred_* keys (jittered GT) so DispRCNN3D configs can run
        # without a prior 2D stage
        self.with_offline_preds = with_offline_preds
        self.mask_size = mask_size

    def __len__(self):
        return self.n

    def image_sizes(self):
        return [(self.hw[1], self.hw[0])] * self.n

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 10007 + idx)
        h, w = self.hw
        cu, cv = w / 2.0, h / 2.0
        fuxb = self.fu * self.baseline

        left = rng.uniform(0.2, 0.4, (h, w, 3)).astype(np.float32)
        right = left.copy()
        disp_map = np.zeros((h, w), np.float32)

        n_obj = int(rng.integers(self.n_objects[0], self.n_objects[1] + 1))
        n_obj = min(n_obj, self.max_gt)
        gt_left = np.zeros((self.max_gt, 4), np.float32)
        gt_right = np.zeros((self.max_gt, 4), np.float32)
        gt_box3d = np.zeros((self.max_gt, 7), np.float32)
        labels = np.zeros((self.max_gt,), np.int32)
        valid = np.zeros((self.max_gt,), bool)
        masks = np.zeros((self.max_gt, h, w), np.float32)

        for i in range(n_obj):
            depth = float(rng.uniform(8.0, 40.0))
            disp = fuxb / depth
            bw = int(rng.integers(40, 120))
            bh = int(rng.integers(30, 80))
            x1 = int(rng.integers(int(disp) + 5, w - bw - 5))
            y1 = int(rng.integers(5, h - bh - 5))
            color = rng.uniform(0.5, 1.0, (3,)).astype(np.float32)
            tex = (
                color[None, None]
                * rng.uniform(0.7, 1.0, (bh, bw, 1)).astype(np.float32)
            )
            left[y1 : y1 + bh, x1 : x1 + bw] = tex
            xs = int(round(x1 - disp))
            right[y1 : y1 + bh, xs : xs + bw] = tex
            disp_map[y1 : y1 + bh, x1 : x1 + bw] = disp
            masks[i, y1 : y1 + bh, x1 : x1 + bw] = 1.0

            gt_left[i] = [x1, y1, x1 + bw - 1, y1 + bh - 1]
            gt_right[i] = [xs, y1, xs + bw - 1, y1 + bh - 1]
            cx3d = (x1 + bw / 2 - cu) * depth / self.fu
            cy3d = (y1 + bh - cv) * depth / self.fu  # bottom edge
            gt_box3d[i] = [cx3d, cy3d, depth, 1.5, 1.6, 3.9, 0.0]
            labels[i] = 1
            valid[i] = True

        sample = {
            "imgid": f"synt{idx:06d}",
            "left": left,
            "right": right,
            "gt_left": gt_left,
            "gt_right": gt_right,
            "gt_box3d": gt_box3d,
            "gt_labels": labels,
            "gt_valid": valid,
            "gt_masks": masks,
            "gt_disp": disp_map,
            "calib": {
                "fu": np.float32(self.fu),
                "fv": np.float32(self.fu),
                "cu": np.float32(cu),
                "cv": np.float32(cv),
                "tx": np.float32(0.0),
                "ty": np.float32(0.0),
                "fuxb": np.float32(fuxb),
            },
            "P2": np.asarray(
                [[self.fu, 0, cu, 0], [0, self.fu, cv, 0], [0, 0, 1, 0]], np.float32
            ),
            "P3": np.asarray(
                [[self.fu, 0, cu, -fuxb], [0, self.fu, cv, 0], [0, 0, 1, 0]], np.float32
            ),
        }
        if self.with_offline_preds:
            d = self.max_gt
            m = self.mask_size
            jit = rng.uniform(-2.0, 2.0, (d, 4)).astype(np.float32)
            sample["pred_left"] = (gt_left + jit * valid[:, None]).astype(np.float32)
            sample["pred_right"] = (gt_right + jit * valid[:, None]).astype(np.float32)
            sample["pred_score"] = np.where(valid, 0.95, 0.0).astype(np.float32)
            sample["pred_labels"] = labels.copy()
            sample["pred_valid"] = valid.copy()
            pm = np.zeros((d, m, m), np.float32)
            for i in range(n_obj):
                x1, y1, x2, y2 = sample["pred_left"][i]
                ys = np.clip(
                    (y1 + (np.arange(m) + 0.5) / m * (y2 - y1)).astype(int), 0, h - 1
                )
                xs_ = np.clip(
                    (x1 + (np.arange(m) + 0.5) / m * (x2 - x1)).astype(int), 0, w - 1
                )
                pm[i] = masks[i][np.ix_(ys, xs_)]
            sample["pred_mask"] = pm
        if self.transforms is not None:
            sample = self.transforms(sample)
        return sample
