"""Prediction visualizer (counterpart of tools/visualize.py).

    python -m disprcnn_tpu_torch.tools.visualize --predictions predictions.pkl \\
        --dataset synthetic_8 --out viz/ [--limit 20] [--device cuda]

Draws each valid detection of a prediction dict on its left image, in a
colour drawn per image from numpy's default_rng(0) (uniform in [100,
255) a channel, as the root tool draws them): the 2D box outline, the mask
pasted into the image (structures/masks.py::paste_mask_in_image, above
0.5) blended 0.6 image + 0.4 colour, and, where the prediction has box3d
and the sample a P2 whose projected corners all lie more than 0.1 in
front of the camera, the 12 edges of the projected 3D box
(structures/boxes3d.py::corners_from_xyzhwl_ry, then the projection in
numpy) by utils/draw.py's cv2.line raster. Each image is written as
<out>/<imgid>.png by data/png.py (RGB, the order the root tool's BGR
cv2.imwrite of the flipped array gives). The first --limit predictions
whose image is among the dataset's first 4 * --limit samples are drawn.
The mask paste and the corners run on --device, which defaults to the
card and raises without one.
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import get_default_cfg
from ..data.catalog import resolve
from ..data.png import write_png
from ..structures.boxes3d import corners_from_xyzhwl_ry
from ..structures.masks import paste_mask_in_image
from ..utils.draw import draw_line

BOX_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def draw_box2d(img: np.ndarray, box, color) -> None:
    x1, y1, x2, y2 = (int(round(v)) for v in box)
    h, w = img.shape[:2]
    x1, x2 = max(x1, 0), min(x2, w - 1)
    y1, y2 = max(y1, 0), min(y2, h - 1)
    img[y1:y2 + 1, [x1, x2]] = color
    img[[y1, y2], x1:x2 + 1] = color


def render(sample: dict, pred: dict, device="cuda") -> np.ndarray:
    """The (H, W, 3) uint8 RGB drawing of `pred` on `sample`'s left image."""
    img = (sample.get("raw_left", sample["left"]) * 255).clip(0, 255).astype(np.uint8).copy()
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)  # noqa
    for i in range(len(pred.get("scores", []))):
        if "valid" in pred and not pred["valid"][i]:
            continue
        color = rng.integers(100, 255, 3).astype(np.uint8)
        draw_box2d(img, pred["left_boxes"][i], color)
        if "masks" in pred and np.ndim(pred["masks"]) == 3:
            m = paste_mask_in_image(t(pred["masks"][i]), t(pred["left_boxes"][i]),
                                    img.shape[0], img.shape[1]).cpu().numpy()
            img[m] = (0.6 * img[m] + 0.4 * color).astype(np.uint8)
        if "box3d" in pred and "P2" in sample:
            corners = corners_from_xyzhwl_ry(t(pred["box3d"][i])[None])[0].cpu().numpy()
            p2 = np.asarray(sample["P2"])
            ones = np.ones_like(corners[:, :1])
            depth = (np.concatenate([corners, ones], axis=1) @ p2.T.astype(corners.dtype))[:, 2]
            if float(depth.min()) > 0.1:
                hom = np.concatenate([corners, np.ones((8, 1))], axis=1)
                proj = hom @ p2.T
                uv = proj[:, :2] / proj[:, 2:3]
                for a, b in BOX_EDGES:
                    draw_line(img, uv[a], uv[b], color)
    return img


def visualize(predictions: dict, dataset: str, out_dir: str, limit: int = 20,
              device: str = "cuda") -> list:
    """Write the drawings of `predictions` ({imgid: prediction dict}) over
    `dataset`'s images. -> the paths written."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device (pass --device cpu to run on the CPU)")
    ds = resolve(dataset, get_default_cfg(), training=False, transforms=None)
    os.makedirs(out_dir, exist_ok=True)
    by_id = {ds[i]["imgid"]: i for i in range(min(len(ds), limit * 4))}
    paths = []
    for imgid, pred in predictions.items():
        if imgid not in by_id or len(paths) >= limit:
            continue
        path = os.path.join(out_dir, f"{imgid}.png")
        write_png(path, render(ds[by_id[imgid]], pred, device))
        paths.append(path)
    return paths


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--predictions", required=True)
    p.add_argument("--dataset", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--limit", type=int, default=20)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    with open(args.predictions, "rb") as f:
        predictions = pickle.load(f)
    paths = visualize(predictions, args.dataset, args.out, args.limit, args.device)
    print(f"rendered {len(paths)} images to {args.out}")


if __name__ == "__main__":
    main()
