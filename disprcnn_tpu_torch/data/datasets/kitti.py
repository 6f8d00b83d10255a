"""KITTI stereo object dataset -> fixed-shape numpy samples (a copy of
disprcnn_tpu/data/datasets/kitti.py; PNGs are read with PIL, imported
where an image is read).

Reference: data/datasets/kitti_car.py:20-337 (and the pedestrian/cyclist
variants, kitti_human.py / kitti_cyclist.py — same loader parameterized by
class filter). Each sample carries:
- left/right images (HWC float32, [0,1] RGB),
- padded GT: left/right 2D boxes aligned across views
  (utils/stereo_utils.align_left_right_targets y-overlap matching), labels,
  3D boxes (xyzhwl_ry, rect frame), validity mask,
- full-image GT disparity (16-bit PNG / 256) and instance masks when the
  shape-prior pseudo-GT is available (VOB/POB dumps),
- calibration scalars.

The zarr mask store of the reference is read through a minimal local reader
(zarr is not installed here); missing aux data degrades to zeros + flags.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from ..kitti_io import KittiCalib, KittiObject, load_labels, load_split

CLASS_FILTERS = {
    "car": ("Car", "Van"),
    "pedestrian": ("Pedestrian",),
    "cyclist": ("Cyclist",),
}
LABEL_IDS = {"car": 1, "pedestrian": 1, "cyclist": 1}  # binary: fg class is 1


def _boxes_y_overlap(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4) x (M,4) vertical-interval IoU used to pair left/right objects
    (stereo_utils.align_left_right_targets)."""
    top = np.maximum(a[:, None, 1], b[None, :, 1])
    bot = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(bot - top, 0, None)
    ua = a[:, 3] - a[:, 1]
    ub = b[:, 3] - b[:, 1]
    return inter / np.maximum(ua[:, None] + ub[None, :] - inter, 1e-6)


def align_left_right(
    left: List[KittiObject], right: List[KittiObject]
) -> List[tuple]:
    """Greedy y-overlap pairing of left/right label objects."""
    if not left or not right:
        return []
    la = np.stack([o.box2d for o in left])
    ra = np.stack([o.box2d for o in right])
    ov = _boxes_y_overlap(la, ra)
    pairs = []
    used = set()
    for i in range(len(left)):
        j = int(np.argmax(ov[i]))
        if ov[i, j] > 0.5 and j not in used:
            used.add(j)
            pairs.append((left[i], right[j]))
    return pairs


class KittiStereoDataset:
    """Index-based dataset; __getitem__ returns a dict of numpy arrays."""

    def __init__(
        self,
        root: str,
        split: str,  # e.g. "train", "val"
        category: str = "car",
        max_gt: int = 32,
        max_det: int = 32,
        mask_size: int = 28,
        training: bool = True,
        transforms=None,
        shape_prior_base: Optional[str] = None,  # "vob"/"pob" pseudo-GT dir
        offline_2d_predictions: Optional[str] = None,
        filter_empty: bool = True,
    ):
        self.root = root
        self.split_dir = "training" if split in ("train", "val", "trainval") else "testing"
        self.category = category
        self.classes = CLASS_FILTERS[category]
        self.max_gt = max_gt
        self.max_det = max_det
        self.mask_size = mask_size
        self.training = training
        self.transforms = transforms
        self.shape_prior_base = shape_prior_base
        # Stage handoff (reference kitti_car.py:51-57): either a directory of
        # per-image pickles (tools/split_predictions.py output) or one
        # predictions.pkl keyed by imgid. "%s" expands to the split name.
        o2d = offline_2d_predictions
        if o2d and "%s" in o2d:
            o2d = o2d % split
        if o2d and not os.path.isdir(o2d) and not o2d.endswith(".pkl"):
            o2d = o2d + ".pkl"  # reference appends '.pth' the same way
        self.offline_2d = o2d or None
        self._o2d_cache: Optional[dict] = None
        if self.offline_2d and self.offline_2d.endswith(".pkl"):
            with open(self.offline_2d, "rb") as f:
                self._o2d_cache = pickle.load(f)
        ids = load_split(root, f"{split}_set" if not split.endswith("_set") else split)
        if filter_empty and training:
            ids = [i for i in ids if self._annotations(i)]
        if self.offline_2d and training:
            # drop images with no usable offline detections
            # (kitti_car.py:64-78 filter_empty over o2dpreds)
            ids = [i for i in ids if self._load_offline(i) is not None]
        self.ids = ids

    def __len__(self):
        return len(self.ids)

    def image_sizes(self):
        """(w, h) per sample for aspect-ratio batch grouping (reference
        GroupedBatchSampler input; KITTI images are uniformly landscape, so
        a single group results — the hook matters for mixed datasets)."""
        out = []
        for imgid in self.ids:
            path = self._path("image_2", imgid, ".png")
            try:
                from PIL import Image

                with Image.open(path) as im:
                    out.append(im.size)
            except Exception:
                out.append((1242, 375))
        return out

    # -- raw pieces --------------------------------------------------------
    def _path(self, sub: str, imgid: str, ext: str) -> str:
        return os.path.join(self.root, "object", self.split_dir, sub, f"{imgid}{ext}")

    def _annotations(self, imgid: str):
        left = [
            o
            for o in load_labels(self._path("label_2", imgid, ".txt"))
            if o.cls_name in self.classes
        ]
        right = [
            o
            for o in load_labels(self._path("label_3", imgid, ".txt"))
            if o.cls_name in self.classes
        ]
        return align_left_right(left, right)

    def _load_image(self, sub: str, imgid: str) -> np.ndarray:
        from PIL import Image

        im = Image.open(self._path(sub, imgid, ".png")).convert("RGB")
        return np.asarray(im, np.float32) / 255.0

    def _load_disparity(self, imgid: str, shape) -> np.ndarray:
        # reference layout first (kitti_car.py:290-305:
        # object/<split>/<base>/disparity_2/<id>.png, 16-bit / 256)
        candidates = []
        if self.shape_prior_base:
            candidates.append(os.path.join(
                self.root, "object", self.split_dir, self.shape_prior_base,
                "disparity_2", f"{imgid}.png",
            ))
            candidates.append(
                self._path(f"disparity_{self.shape_prior_base}", imgid, ".png")
            )
        for path in candidates:
            if os.path.exists(path):
                from PIL import Image

                arr = np.asarray(Image.open(path), np.float32)
                return arr / 256.0
        return np.zeros(shape, np.float32)

    def _load_offline(self, imgid: str) -> Optional[dict]:
        """Per-image offline 2D predictions (kitti_car.py:271-273 semantics):
        dict with left_boxes/right_boxes/scores/labels/valid/masks as written
        by engine.inference + tools/split_predictions.py. None if absent or
        empty."""
        if not self.offline_2d:
            return None
        if self._o2d_cache is not None:
            pred = self._o2d_cache.get(imgid)
        else:
            path = os.path.join(self.offline_2d, f"{imgid}.pkl")
            if not os.path.exists(path):
                return None
            with open(path, "rb") as f:
                pred = pickle.load(f)
        if pred is None:
            return None
        valid = np.asarray(
            pred.get("valid", np.ones(len(pred["scores"]), bool))
        ).astype(bool)
        if not valid.any():
            return None
        return pred

    def _offline_sample(self, imgid: str) -> Dict[str, np.ndarray]:
        """Padded (max_det, ...) arrays from the offline predictions."""
        d = self.max_det
        out = {
            "pred_left": np.zeros((d, 4), np.float32),
            "pred_right": np.zeros((d, 4), np.float32),
            "pred_score": np.zeros((d,), np.float32),
            "pred_labels": np.zeros((d,), np.int32),
            "pred_valid": np.zeros((d,), bool),
        }
        pred = self._load_offline(imgid)
        if pred is None:
            out["pred_mask"] = np.zeros((d, self.mask_size, self.mask_size), np.float32)
            return out
        valid = np.asarray(
            pred.get("valid", np.ones(len(pred["scores"]), bool))
        ).astype(bool)
        idx = np.nonzero(valid)[0][:d]
        n = len(idx)
        out["pred_left"][:n] = np.asarray(pred["left_boxes"])[idx]
        out["pred_right"][:n] = np.asarray(pred["right_boxes"])[idx]
        out["pred_score"][:n] = np.asarray(pred["scores"])[idx]
        labels = np.asarray(pred.get("labels", np.ones(len(valid))))
        out["pred_labels"][:n] = labels[idx]
        out["pred_valid"][:n] = True
        masks = np.asarray(pred.get("masks", None), np.float32)
        if masks is not None and masks.ndim >= 3 and masks.size:
            if masks.ndim == 4:  # (D, 1, M, M) class-indexed probs
                masks = masks[:, 0]
            m = masks.shape[-1]
            out["pred_mask"] = np.zeros((d, m, m), np.float32)
            out["pred_mask"][:n] = masks[idx]
        else:
            out["pred_mask"] = np.zeros((d, self.mask_size, self.mask_size), np.float32)
        return out

    def _load_masks(self, imgid: str, n: int, shape) -> np.ndarray:
        """Instance masks from the pseudo-GT dump.

        Primary source is the reference's on-disk layout
        (kitti_car.py:275-288): ``object/<split>/<base>/mask_2/<id>.zarr``
        read with the in-repo zarr-v2 reader (zarr isn't installed); a
        per-image pickle at the legacy ``mask_2_<base>/<id>.pkl`` location
        stays as fallback; absent both -> zeros.
        """
        if self.shape_prior_base:
            zpath = os.path.join(
                self.root, "object", self.split_dir, self.shape_prior_base,
                "mask_2", f"{imgid}.zarr",
            )
            if os.path.exists(zpath):
                from ..zarr_io import load_zarr

                return (load_zarr(zpath) != 0).astype(np.float32)
            path = self._path(f"mask_2_{self.shape_prior_base}", imgid, ".pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    m = pickle.load(f)
                return np.asarray(m, np.float32)
        return np.zeros((n,) + tuple(shape), np.float32)

    # -- sample assembly ---------------------------------------------------
    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        imgid = self.ids[idx]
        left_img = self._load_image("image_2", imgid)
        right_img = self._load_image("image_3", imgid)
        calib = KittiCalib.from_file(self._path("calib", imgid, ".txt"))
        pairs = self._annotations(imgid)[: self.max_gt]
        n = len(pairs)
        h, w = left_img.shape[:2]

        gt_left = np.zeros((self.max_gt, 4), np.float32)
        gt_right = np.zeros((self.max_gt, 4), np.float32)
        gt_box3d = np.zeros((self.max_gt, 7), np.float32)
        labels = np.zeros((self.max_gt,), np.int32)
        valid = np.zeros((self.max_gt,), bool)
        for i, (lo, ro) in enumerate(pairs):
            gt_left[i] = lo.box2d
            gt_right[i] = ro.box2d
            gt_box3d[i] = lo.box3d_xyzhwl_ry
            labels[i] = LABEL_IDS[self.category]
            valid[i] = True

        masks = self._load_masks(imgid, n, (h, w))
        full_masks = np.zeros((self.max_gt, h, w), np.float32)
        full_masks[: min(n, len(masks))] = masks[: min(n, len(masks))]

        sample = {
            "imgid": imgid,
            "left": left_img,
            "right": right_img,
            "gt_left": gt_left,
            "gt_right": gt_right,
            "gt_box3d": gt_box3d,
            "gt_labels": labels,
            "gt_valid": valid,
            "gt_masks": full_masks,
            "gt_disp": self._load_disparity(imgid, (h, w)),
            "calib": {
                "fu": np.float32(calib.fu),
                "fv": np.float32(calib.fv),
                "cu": np.float32(calib.cu),
                "cv": np.float32(calib.cv),
                "tx": np.float32(calib.tx),
                "ty": np.float32(calib.ty),
                "fuxb": np.float32(calib.stereo_fuxbaseline),
            },
            "P2": calib.P2.astype(np.float32),
            "P3": calib.P3.astype(np.float32),
        }
        if self.offline_2d:
            sample.update(self._offline_sample(imgid))
        if self.transforms is not None:
            sample = self.transforms(sample)
        return sample
