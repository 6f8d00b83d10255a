"""Input transforms operating on sample dicts (host-side numpy;
counterpart of disprcnn_tpu/data/transforms.py).

Reference: data/transforms/transforms.py:14-346 — every transform has a
double-view path keeping left/right consistent. Resize follows the min/max
side rule (Resize.get_size); horizontal flip swaps views AND mirrors boxes
(left/right exchange because flipping a stereo pair swaps the epipolar
direction); normalization supports the Caffe2-style BGR255 mean/std.

Two differences from the JAX package's module:
- The resize is OpenCV's INTER_LINEAR rule written in numpy (the machine
  with the card has no OpenCV), with its double-precision source
  coordinates: ``torch.nn.functional.interpolate`` computes them in
  float32 and lands up to 1e-4 off cv2 on [0, 1] images of KITTI's width.
  It agrees with ``cv2.resize`` to 4 float32 ulps
  (tests/test_torch_data.py states the bound).
- The random transforms draw from an explicit ``np.random.Generator``
  given to their constructor, not from numpy's global state. Eval draws
  nothing.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def min_max_resize_hw(h: int, w: int, min_size: int, max_size: int):
    """Target (h', w') with smallest side ~min_size capped by max_size
    (reference Resize.get_size)."""
    size = min_size
    mn, mx = min(h, w), max(h, w)
    if mx / mn * size > max_size:
        size = int(round(max_size * mn / mx))
    if (w <= h and w == size) or (h <= w and h == size):
        return h, w
    if w < h:
        return int(size * h / w), size
    return size, int(size * w / h)


def _linear_taps(n_in: int, n_out: int):
    """OpenCV's INTER_LINEAR taps along one axis: for each output index the
    two source indices and their float32 weights, from half-pixel centres
    computed in double precision and clamped at the borders."""
    f = (np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5
    s = np.floor(f).astype(np.int64)
    f = f - s
    low, high = s < 0, s >= n_in - 1
    f[low | high] = 0.0
    s[low] = 0
    s[high] = n_in - 1
    return s, np.minimum(s + 1, n_in - 1), (1.0 - f).astype(np.float32), f.astype(np.float32)


def _resize_img(img: np.ndarray, hw) -> np.ndarray:
    """(H, W) or (H, W, C) float32 -> hw, as cv2.resize(INTER_LINEAR) does
    it: along W, then along H, each a float32 sum of two products (torch
    CPU ops, one rounding each, on several threads); an exact halving of
    both sides is the mean of each 2x2 block (OpenCV takes INTER_AREA
    there)."""
    h, w = img.shape[:2]
    nh, nw = hw
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    if (nh * 2, nw * 2) == (h, w):
        a, b, c, d = x[0::2, 0::2], x[0::2, 1::2], x[1::2, 0::2], x[1::2, 1::2]
        return ((((a + b) + c) + d) * 0.25).numpy()
    trail = (1,) * (x.dim() - 2)
    sx, sx1, a0, a1 = (torch.from_numpy(v) for v in _linear_taps(w, nw))
    sy, sy1, b0, b1 = (torch.from_numpy(v) for v in _linear_taps(h, nh))
    t = x.index_select(1, sx) * a0.view(1, nw, *trail) + x.index_select(1, sx1) * a1.view(
        1, nw, *trail)
    return (t.index_select(0, sy) * b0.view(nh, 1, *trail)
            + t.index_select(0, sy1) * b1.view(nh, 1, *trail)).numpy()


class Resize:
    """With several min sizes, each sample draws one from `generator`."""

    def __init__(self, min_size: Sequence[int] | int, max_size: int,
                 generator: Optional[np.random.Generator] = None):
        self.min_size = (min_size,) if isinstance(min_size, int) else tuple(min_size)
        self.max_size = max_size
        if len(self.min_size) > 1 and generator is None:
            raise ValueError("Resize over several min sizes needs a generator")
        self.generator = generator

    def __call__(self, sample: dict) -> dict:
        h, w = sample["left"].shape[:2]
        ms = (self.min_size[0] if len(self.min_size) == 1
              else int(self.generator.choice(self.min_size)))
        nh, nw = min_max_resize_hw(h, w, ms, self.max_size)
        if (nh, nw) == (h, w):
            return sample
        ry, rx = nh / h, nw / w
        out = dict(sample)
        out["left"] = _resize_img(sample["left"], (nh, nw))
        out["right"] = _resize_img(sample["right"], (nh, nw))
        scale = np.asarray([rx, ry, rx, ry], np.float32)
        out["gt_left"] = sample["gt_left"] * scale
        out["gt_right"] = sample["gt_right"] * scale
        # offline 2D predictions follow the resize like targets
        # (reference kitti_car.py:102-106: lp.resize(targets['left'].size))
        for key in ("pred_left", "pred_right"):
            if key in sample:
                out[key] = sample[key] * scale
        if "gt_masks" in sample and sample["gt_masks"].size:
            # each mask as one channel: the same arithmetic per element
            out["gt_masks"] = np.ascontiguousarray(
                _resize_img(sample["gt_masks"].transpose(1, 2, 0), (nh, nw)).transpose(2, 0, 1)
            )
        if "gt_disp" in sample:
            # disparity values scale with width (structures/disparity.py:60)
            out["gt_disp"] = _resize_img(sample["gt_disp"], (nh, nw)) * rx
        # intrinsics scale (utils/kitti_utils.py Calibration.resize)
        for key in ("P2", "P3"):
            if key in sample:
                p = sample[key].copy()
                p[0] *= rx
                p[1] *= ry
                out[key] = p
        if "calib" in sample:
            c = dict(sample["calib"])
            c["fu"] = np.float32(c["fu"] * rx)
            c["fv"] = np.float32(c["fv"] * ry)
            c["cu"] = np.float32(c["cu"] * rx)
            c["cv"] = np.float32(c["cv"] * ry)
            c["fuxb"] = np.float32(c["fuxb"] * rx)
            out["calib"] = c
        return out


class RandomHorizontalFlip:
    """Stereo-consistent flip: mirrors both images and SWAPS views
    (reference RandomHorizontalFlip.call_double_view)."""

    def __init__(self, prob: float, generator: np.random.Generator):
        self.prob = prob
        self.generator = generator

    def __call__(self, sample: dict) -> dict:
        if self.generator.random() >= self.prob:
            return sample
        h, w = sample["left"].shape[:2]
        out = dict(sample)
        out["left"] = sample["right"][:, ::-1].copy()
        out["right"] = sample["left"][:, ::-1].copy()

        def flip_boxes(b):
            fb = b.copy()
            fb[:, 0] = w - b[:, 2] - 1
            fb[:, 2] = w - b[:, 0] - 1
            return fb

        out["gt_left"] = flip_boxes(sample["gt_right"])
        out["gt_right"] = flip_boxes(sample["gt_left"])
        if "pred_left" in sample:
            out["pred_left"] = flip_boxes(sample["pred_right"])
            out["pred_right"] = flip_boxes(sample["pred_left"])
            if "pred_mask" in sample:
                out["pred_mask"] = sample["pred_mask"][:, :, ::-1].copy()
        if "gt_masks" in sample and sample["gt_masks"].size:
            out["gt_masks"] = sample["gt_masks"][:, :, ::-1].copy()
        if "gt_disp" in sample:
            out["gt_disp"] = sample["gt_disp"][:, ::-1].copy()
        return out


class ColorJitter:
    def __init__(self, generator: np.random.Generator, brightness=0.0, contrast=0.0,
                 saturation=0.0, hue=0.0):
        self.generator = generator
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation

    def __call__(self, sample: dict) -> dict:
        if not (self.brightness or self.contrast or self.saturation):
            return sample
        out = dict(sample)
        b = 1 + self.generator.uniform(-self.brightness, self.brightness)
        c = 1 + self.generator.uniform(-self.contrast, self.contrast)
        for key in ("left", "right"):
            img = sample[key] * b
            mean = img.mean()
            out[key] = np.clip((img - mean) * c + mean, 0, 1).astype(np.float32)
        return out


class Normalize:
    """Pixel normalization; to_bgr255 reproduces the Caffe2 convention
    (mean subtract on 0-255 BGR, reference INPUT.PIXEL_MEAN/TO_BGR255)."""

    def __init__(self, mean, std, to_bgr255=True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_bgr255 = to_bgr255

    def __call__(self, sample: dict) -> dict:
        out = dict(sample)
        for key in ("left", "right"):
            img = sample[key]
            out[f"raw_{key}"] = img  # 3D stage crops RAW images
            if self.to_bgr255:
                img = img[:, :, ::-1] * 255.0
            out[key] = ((img - self.mean) / self.std).astype(np.float32)
        return out


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


def build_transforms(cfg, is_train: bool, generator: Optional[np.random.Generator] = None):
    """cfg INPUT -> Compose (reference data/transforms/build.py). Training
    draws from `generator`, which it then needs."""
    inp = cfg.INPUT
    if is_train and generator is None:
        raise ValueError("train transforms need a generator")
    ts = []
    if inp.DO_RESIZE:
        ts.append(
            Resize(
                tuple(inp.MIN_SIZE_TRAIN) if is_train else inp.MIN_SIZE_TEST,
                inp.MAX_SIZE_TRAIN if is_train else inp.MAX_SIZE_TEST,
                generator,
            )
        )
    if is_train:
        if inp.FLIP_PROB_TRAIN > 0:
            ts.append(RandomHorizontalFlip(inp.FLIP_PROB_TRAIN, generator))
        if inp.BRIGHTNESS or inp.CONTRAST or inp.SATURATION:
            ts.append(ColorJitter(generator, inp.BRIGHTNESS, inp.CONTRAST, inp.SATURATION,
                                  inp.HUE))
    ts.append(Normalize(inp.PIXEL_MEAN, inp.PIXEL_STD, inp.TO_BGR255))
    return Compose(ts)
