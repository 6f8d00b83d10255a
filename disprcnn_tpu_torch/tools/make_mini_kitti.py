"""Write a synthetic mini-KITTI on disk, in KITTI's file layout (counterpart
of the JAX package's tools/make_mini_kitti.py, file for file).

    python -m disprcnn_tpu_torch.tools.make_mini_kitti --root data/mini_kitti \\
        [--n-train 16] [--n-val 8] [--image-hw 192,640] [--seed 0] \\
        [--cls Car|Pedestrian|Cyclist] [--base vob|pob]

writes everything the recipe reads (the reference's layout, kitti_car.py:
275-305):

  <root>/object/training/{image_2,image_3}/%06d.png        the stereo pair
  <root>/object/training/{label_2,label_3}/%06d.txt        KITTI labels
  <root>/object/training/calib/%06d.txt                    P0..P3, R0, Tr
  <root>/object/training/<base>/disparity_2/%06d.png       16-bit, disparity * 256
  <root>/object/training/<base>/mask_2/%06d.zarr           instance masks
  <root>/object/split_set/{train,val,trainval}_set.txt

The scenes are data/datasets/synthetic.py's, so the boxes, disparity and
3D boxes are exact by construction; the PNGs are written by data/png.py
(no PIL), the masks by data/zarr_io.save_zarr. Point DISPRCNN_DATA_DIR at
<root> to read it through the catalog's kitti_* datasets.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from ..data.datasets.synthetic import SyntheticStereoDataset
from ..data.png import write_png
from ..data.zarr_io import save_zarr


def write_calib(path: str, fu, cu, cv, fuxb) -> None:
    p2 = f"P2: {fu} 0 {cu} 0 0 {fu} {cv} 0 0 0 1 0"
    p3 = f"P3: {fu} 0 {cu} {-fuxb} 0 {fu} {cv} 0 0 0 1 0"
    r0 = "R0_rect: 1 0 0 0 1 0 0 0 1"
    tr = "Tr_velo_to_cam: 0 -1 0 0 0 0 -1 0 1 0 0 0"
    with open(path, "w") as f:
        f.write("\n".join([
            "P0: " + p2.split(": ")[1], "P1: " + p2.split(": ")[1],
            p2, p3, r0, tr, "Tr_imu_to_velo: " + tr.split(": ")[1],
        ]) + "\n")


def write_labels(path: str, boxes2d, boxes3d, valid, cls: str = "Car") -> None:
    lines = []
    for b, b3, v in zip(boxes2d, boxes3d, valid):
        if not v:
            continue
        x, y, z, h, w, l, ry = (float(q) for q in b3)
        alpha = ry + np.arctan2(-x, z)
        lines.append(
            f"{cls} 0.00 0 {alpha:.2f} "
            f"{b[0]:.2f} {b[1]:.2f} {b[2]:.2f} {b[3]:.2f} "
            f"{h:.2f} {w:.2f} {l:.2f} {x:.2f} {y:.2f} {z:.2f} {ry:.2f}"
        )
    with open(path, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="write a synthetic mini-KITTI")
    p.add_argument("--root", default="data/mini_kitti")
    p.add_argument("--n-train", type=int, default=16)
    p.add_argument("--n-val", type=int, default=8)
    p.add_argument("--image-hw", default="192,640")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cls", default="Car", choices=("Car", "Pedestrian", "Cyclist"),
                   help="object class written to the label files")
    p.add_argument("--base", default="vob", choices=("vob", "pob"),
                   help="shape-prior base dir (reference layout "
                        "object/training/<base>/{disparity_2,mask_2})")
    return p.parse_args(argv)


def write(root: str, n_train: int, n_val: int, image_hw, seed: int = 0, cls: str = "Car",
          base: str = "vob") -> SyntheticStereoDataset:
    """Write the tree (see the module doc). -> the dataset of its scenes,
    scene i being %06d i."""
    n = n_train + n_val
    ds = SyntheticStereoDataset(n_samples=n, image_hw=tuple(image_hw), max_gt=8, seed=seed)
    tr = os.path.join(root, "object", "training")
    for sub in ("image_2", "image_3", "label_2", "label_3", "calib",
                f"{base}/disparity_2", f"{base}/mask_2"):
        os.makedirs(os.path.join(tr, sub), exist_ok=True)
    os.makedirs(os.path.join(root, "object", "split_set"), exist_ok=True)
    for idx in range(n):
        s = ds[idx]
        imgid = f"{idx:06d}"
        for key, sub in (("left", "image_2"), ("right", "image_3")):
            write_png(os.path.join(tr, sub, f"{imgid}.png"), (s[key] * 255).astype(np.uint8))
        c = s["calib"]
        write_calib(os.path.join(tr, "calib", f"{imgid}.txt"),
                    float(c["fu"]), float(c["cu"]), float(c["cv"]), float(c["fuxb"]))
        write_labels(os.path.join(tr, "label_2", f"{imgid}.txt"),
                     s["gt_left"], s["gt_box3d"], s["gt_valid"], cls=cls)
        write_labels(os.path.join(tr, "label_3", f"{imgid}.txt"),
                     s["gt_right"], s["gt_box3d"], s["gt_valid"], cls=cls)
        disp16 = np.clip(s["gt_disp"] * 256.0, 0, 65535).astype(np.uint16)
        write_png(os.path.join(tr, base, "disparity_2", f"{imgid}.png"), disp16)
        # the reference stores masks as <base>/mask_2/<id>.zarr (kitti_car.py:275-288)
        save_zarr(os.path.join(tr, base, "mask_2", f"{imgid}.zarr"),
                  s["gt_masks"][s["gt_valid"]].astype(np.uint8))
    ids = [f"{i:06d}" for i in range(n)]
    for name, sub_ids in (("train", ids[:n_train]), ("val", ids[n_train:]), ("trainval", ids)):
        with open(os.path.join(root, "object", "split_set", f"{name}_set.txt"), "w") as f:
            f.write("\n".join(sub_ids) + "\n")
    return ds


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    hw = tuple(int(v) for v in args.image_hw.split(","))
    ds = write(args.root, args.n_train, args.n_val, hw, args.seed, args.cls, args.base)
    print(f"mini-KITTI with {len(ds)} scenes at {args.root}")


if __name__ == "__main__":
    main()
